"""StarCoder2-3B as the program runs it, in plain float32 PyTorch: the
reference that judges a prefill's logits, and the layout of the weights the
benchmark draws (the program's parameter tree, `models/model.py`).

One layer: x += Wo attn(RoPE(Wq h + bq), RoPE(Wk h + bk), Wv h + bv) with
h = RMSNorm(x) and GQA (query head j reads kv head j // (H / KV)), causal
and, where the layer's kind is 'attn_local', within ``sliding_window``
tokens (a key k is kept for query q when k <= q and q - k < window); then
x += W_down gelu_tanh(W_up RMSNorm(x) + b_up) + b_down. Logits are
RMSNorm(x) @ head. Departures from the published model are listed under
``assumed`` in starcoder2-3b.json.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from fedbench.yardstick.plain import exact_float32, linear, matrix, rms_norm, vector

#: queries per block of the attention's score matrix
Q_BLOCK = 1024


def tree_spec(m: dict) -> dict:
    """The program's tree for config ``m``: leaves stacked over the layers."""
    L, d, H, KV, ff, V = m["n_layers"], m["d_model"], m["n_heads"], m["n_kv_heads"], m["d_ff"], m["vocab"]
    hd = m.get("head_dim") or d // H
    attn = {"wq": matrix(d, (L, d, H, hd)), "wk": matrix(d, (L, d, KV, hd)),
            "wv": matrix(d, (L, d, KV, hd)), "wo": matrix(H * hd, (L, H, hd, d))}
    if m.get("qkv_bias"):
        attn.update(bq=vector((L, H, hd), std=0.02), bk=vector((L, KV, hd), std=0.02),
                    bv=vector((L, KV, hd), std=0.02))
    ffn = {"w_up": matrix(d, (L, d, ff)), "b_up": vector((L, ff), std=0.02),
           "w_down": matrix(ff, (L, ff, d)), "b_down": vector((L, d), std=0.02)}
    block = {"ln": vector((L, d), std=0.1), "attn": attn, "ffn_ln": vector((L, d), std=0.1),
             "ffn": ffn}
    return {"embed": vector((V, d)), "final_ln": vector((d,), std=0.1),
            "head": matrix(d, (d, V)), "stages": {"main": {"b0": block}}}


def _rope(x, theta: float):
    """Rotate the two halves of each head by position (S, H, hd)."""
    S, _, hd = x.shape
    freqs = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., : hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _attention(q, k, v, causal: bool, window=None):
    """softmax(q k^T / sqrt(hd)) v per head, blocks of queries at a time:
    q (S, H, hd), k/v (S, KV, hd) -> (S, H, hd); ``window``: a query sees
    no key ``window`` or more positions before it."""
    S, H, hd = q.shape
    G = H // k.shape[1]
    k = k.repeat_interleave(G, dim=1).transpose(0, 1)      # (H, S, hd)
    v = v.repeat_interleave(G, dim=1).transpose(0, 1)
    q = q.transpose(0, 1)
    out = torch.empty_like(q)
    for a in range(0, S, Q_BLOCK):
        b = min(S, a + Q_BLOCK)
        start = max(0, a - window + 1) if window else 0
        end = b if causal else S
        s = q[:, a:b] @ k[:, start:end].transpose(1, 2) / math.sqrt(hd)
        qpos = torch.arange(a, b, device=q.device)[:, None]
        kpos = torch.arange(start, end, device=q.device)[None, :]
        mask = (kpos > qpos) & causal
        if window:
            mask = mask | (qpos - kpos >= window)
        s.masked_fill_(mask, -torch.inf)
        out[:, a:b] = torch.softmax(s, dim=-1) @ v[:, start:end]
        del s
    return out.transpose(0, 1)


def window(m: dict, i: int):
    """Layer ``i``'s attention window: ``sliding_window`` where its kind
    (``block_pattern`` cycled) is 'attn_local', else none."""
    pat = m["block_pattern"]
    return m.get("sliding_window") if pat[i % len(pat)] == "attn_local" else None


@torch.no_grad()
def logits(m: dict, tree: dict, tokens: torch.Tensor, positions, fp8: bool = False):
    """Float32 logits (len(positions), V) of one prompt ``tokens`` (S,) at
    ``positions``; with ``fp8`` the control (every product in fp8)."""
    L, d, H, KV = m["n_layers"], m["d_model"], m["n_heads"], m["n_kv_heads"]
    hd = m.get("head_dim") or d // H
    eps, theta = m["norm_eps"], m["rope_theta"]
    blk = tree["stages"]["main"]["b0"]
    at, ff = blk["attn"], blk["ffn"]
    S = tokens.shape[0]
    with exact_float32():
        x = tree["embed"][tokens].float()
        for i in range(L):
            h = rms_norm(x, blk["ln"][i], eps)
            q = linear(h, at["wq"][i].reshape(d, H * hd), fp8).view(S, H, hd)
            k = linear(h, at["wk"][i].reshape(d, KV * hd), fp8).view(S, KV, hd)
            v = linear(h, at["wv"][i].reshape(d, KV * hd), fp8).view(S, KV, hd)
            if "bq" in at:
                q, k, v = q + at["bq"][i].float(), k + at["bk"][i].float(), v + at["bv"][i].float()
            o = _attention(_rope(q, theta), _rope(k, theta), v, m.get("causal", True), window(m, i))
            x = x + linear(o.reshape(S, H * hd), at["wo"][i].reshape(H * hd, d), fp8)
            del q, k, v, o
            h = rms_norm(x, blk["ffn_ln"][i], eps)
            u = F.gelu(linear(h, ff["w_up"][i], fp8) + ff["b_up"][i].float(), approximate="tanh")
            x = x + linear(u, ff["w_down"][i], fp8) + ff["b_down"][i].float()
            del u, h
        h = rms_norm(x[torch.as_tensor(positions, device=x.device)], tree["final_ln"], eps)
        return linear(h, tree["head"], fp8)

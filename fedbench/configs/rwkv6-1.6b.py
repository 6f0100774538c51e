"""RWKV-6 "Finch" 1.6B as the program runs it, in plain float32 PyTorch: the
reference that judges a prefill's logits, and the layout of the weights the
benchmark draws (the program's parameter tree).

One layer (h = RMSNorm(x), h' its previous token's, zeros first):
time mix: m_i = h + (h' - h) mu_i; r, k, v, g = m_0..3 @ W_r,k,v,g; the
decay w = exp(-exp(b_w + tanh(m_4 A) B)); per head of 64 the state
S_t = diag(w_t) S_{t-1} + k_t^T v_t and y_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
(evaluated here chunk by chunk, not step by step); y group-normed per head,
times silu(g), @ W_o, added to x. Channel mix on RMSNorm(x):
sigmoid(m_r @ C_r) * (relu(m_k @ C_k)^2 @ C_v), added to x. Logits are
RMSNorm(x) @ head. Departures from the published model are listed under
``assumed`` in rwkv6-1.6b.json.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from fedbench.yardstick.plain import exact_float32, linear, matrix, rms_norm, shift, vector

LORA = 64
#: tokens per chunk of the WKV evaluation, and chunks evaluated together
CHUNK, CHUNK_BLOCK = 64, 16


def tree_spec(m: dict) -> dict:
    """The program's tree for config ``m``: leaves stacked over the layers."""
    L, d, ff, V = m["n_layers"], m["d_model"], m["d_ff"], m["vocab"]
    hd = m.get("rwkv_head_dim", 64)
    H = d // hd
    mix = {"mu": vector((L, 5, d), 0.5, 0.2),
           "wr": matrix(d, (L, d, d)), "wk": matrix(d, (L, d, d)), "wv": matrix(d, (L, d, d)),
           "wg": matrix(d, (L, d, d)), "w_lora_a": matrix(d, (L, d, LORA)),
           "w_lora_b": {"shape": [L, LORA, d], "std": 0.01, "matmul": True},
           "w_bias": vector((L, d), -6.0, 0.5), "u": vector((L, H, hd), std=0.2),
           "ln_g": vector((L, d), 1.0, 0.1), "ln_b": vector((L, d), std=0.1),
           "wo": matrix(d, (L, d, d)),
           "mu_c": vector((L, 2, d), 0.5, 0.2),
           "ck": matrix(d, (L, d, ff)), "cv": matrix(ff, (L, ff, d)), "cr": matrix(d, (L, d, d))}
    block = {"ln": vector((L, d), std=0.1), "rwkv": mix, "ffn_ln": vector((L, d), std=0.1)}
    return {"embed": vector((V, d)), "final_ln": vector((d,), std=0.1),
            "head": matrix(d, (d, V)), "stages": {"main": {"b0": block}}}


def wkv(r, k, v, logw, u):
    """y (S, H, hd) of the WKV6 recurrence from the zero state, r/k/v/logw
    (S, H, hd) float32 (logw = log w_t), u (H, hd); chunks of `CHUNK`
    tokens: inside a chunk through the pairwise decays exp(c_{t-1} - c_s)
    (c the chunk's cumulative log decay, every exponent <= 0), across chunks
    through the carried state."""
    S, H, hd = r.shape
    n = -(-S // CHUNK)
    pad = n * CHUNK - S
    r, k, v, logw = (F.pad(t, (0, 0, 0, 0, 0, pad)).transpose(0, 1).reshape(H, n, CHUNK, hd)
                     for t in (r, k, v, logw))
    c = torch.cumsum(logw, dim=2)                                     # inclusive
    c_prev = c - logw                                                 # c_{t-1}
    tri = torch.tril(torch.ones(CHUNK, CHUNK, dtype=torch.bool, device=r.device), -1)
    y = torch.empty_like(r)
    for a in range(0, n, CHUNK_BLOCK):
        b = min(n, a + CHUNK_BLOCK)
        dec = torch.exp(torch.where(tri[..., None], c_prev[:, a:b, :, None] - c[:, a:b, None], -torch.inf))
        att = torch.einsum("hnti,hnsi,hntsi->hnts", r[:, a:b], k[:, a:b], dec)
        del dec
        bonus = torch.sum(r[:, a:b] * u[:, None, None, :] * k[:, a:b], dim=-1, keepdim=True)
        y[:, a:b] = att @ v[:, a:b] + bonus * v[:, a:b]
    state = torch.zeros((H, hd, hd), dtype=r.dtype, device=r.device)
    for j in range(n):
        y[:, j] += (r[:, j] * torch.exp(c_prev[:, j])) @ state
        last = c[:, j, -1:, :]                                        # (H, 1, hd)
        state = torch.exp(last[:, 0, :, None]) * state + (k[:, j] * torch.exp(last - c[:, j])).transpose(1, 2) @ v[:, j]
    return y.reshape(H, n * CHUNK, hd)[:, :S].transpose(0, 1)


def _group_norm(y, g, b, eps=1e-5):
    """Per head: (y - mean) / sqrt(var + eps) (population variance), then
    the gain and bias over the flattened heads: (S, H, hd) -> (S, d)."""
    mean = y.mean(-1, keepdim=True)
    var = torch.mean(torch.square(y - mean), -1, keepdim=True)
    return ((y - mean) * torch.rsqrt(var + eps)).reshape(y.shape[0], -1) * g.float() + b.float()


@torch.no_grad()
def logits(m: dict, tree: dict, tokens: torch.Tensor, positions, fp8: bool = False):
    """Float32 logits (len(positions), V) of one prompt ``tokens`` (S,) at
    ``positions``; with ``fp8`` the control (every product in fp8)."""
    L, d = m["n_layers"], m["d_model"]
    hd = m.get("rwkv_head_dim", 64)
    H = d // hd
    eps = m["norm_eps"]
    blk = tree["stages"]["main"]["b0"]
    p = blk["rwkv"]
    S = tokens.shape[0]
    with exact_float32():
        x = tree["embed"][tokens].float()
        for i in range(L):
            h = rms_norm(x, blk["ln"][i], eps)
            hs = shift(h)
            mix = lambda j: h + (hs - h) * p["mu"][i, j].float()
            r = linear(mix(0), p["wr"][i], fp8).view(S, H, hd)
            k = linear(mix(1), p["wk"][i], fp8).view(S, H, hd)
            v = linear(mix(2), p["wv"][i], fp8).view(S, H, hd)
            g = linear(mix(3), p["wg"][i], fp8)
            lora = linear(torch.tanh(linear(mix(4), p["w_lora_a"][i], fp8)), p["w_lora_b"][i], fp8)
            logw = -torch.exp(p["w_bias"][i].float() + lora).view(S, H, hd)
            y = wkv(r, k, v, logw, p["u"][i].float())
            y = _group_norm(y, p["ln_g"][i], p["ln_b"][i], ) * F.silu(g)
            x = x + linear(y, p["wo"][i], fp8)
            del r, k, v, g, lora, logw, y, h, hs
            h = rms_norm(x, blk["ffn_ln"][i], eps)
            hs = shift(h)
            xk = h + (hs - h) * p["mu_c"][i, 0].float()
            xr = h + (hs - h) * p["mu_c"][i, 1].float()
            kk = torch.square(torch.relu(linear(xk, p["ck"][i], fp8)))
            x = x + torch.sigmoid(linear(xr, p["cr"][i], fp8)) * linear(kk, p["cv"][i], fp8)
            del h, hs, xk, xr, kk
        h = rms_norm(x[torch.as_tensor(positions, device=x.device)], tree["final_ln"], eps)
        return linear(h, tree["head"], fp8)

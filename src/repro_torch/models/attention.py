"""Attention: GQA with RoPE, sliding window, softcap and QKV bias.

Counterpart of the GQA part of `repro.models.attention`. Prefill uses the
chunked flash attention below (a running log-sum-exp over kv chunks, fp32)
or, with ``use_kernel``, the CUDA kernel of `repro_torch.kernels.flash_attention`;
the chunked function is that kernel's plain version, as it is the Pallas
kernel's oracle in the reference. Decode attends one query over a KV cache;
sliding-window layers keep a ring buffer of ``window`` slots with explicit
position tags. DeepSeek's MLA is not ported yet (ROADMAP.md §1, item 12):
a config with it raises in `repro_torch.models.model`.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.flash_attention.kernel import scale_of

from .layers import apply_rope, dense_init, softcap


def init_attn_params(generator, cfg, dtype) -> dict:
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    p = {
        "wq": dense_init(generator, (d, H, hd), dtype=dtype),
        "wk": dense_init(generator, (d, KV, hd), dtype=dtype),
        "wv": dense_init(generator, (d, KV, hd), dtype=dtype),
        "wo": dense_init(generator, (H, hd, d), dtype=dtype),
    }
    if cfg.qkv_bias:
        dev = generator.device
        p["bq"] = torch.zeros((H, hd), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((KV, hd), dtype=dtype, device=dev)
        p["bv"] = torch.zeros((KV, hd), dtype=dtype, device=dev)
    return p


# ---------------------------------------------------------------------------
# chunked flash attention (the kernel's plain version)
# ---------------------------------------------------------------------------

def flash_attention(
    q, k, v, *,
    q_positions, kv_positions,
    causal: bool = True,
    window: int | None = None,
    cap: float | None = None,
    q_chunk: int = 512,
    kv_chunk: int = 1024,
):
    """q: (B,S,H,hd); k/v: (B,Skv,KV,hd) with H = G*KV. Returns (B,S,H,hd)
    in v's dtype. kv_positions < 0 marks invalid (unwritten) entries. A
    masked score is -inf; fully masked rows are guarded so they add 0."""
    B, S, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    dev = q.device
    scale = scale_of(hd)                    # 1/sqrt(hd) in float32, as the kernel's

    qp = -(-S // q_chunk) * q_chunk
    kp = -(-Skv // kv_chunk) * kv_chunk
    qpad, kpad = qp - S, kp - Skv
    q = F.pad(q, (0, 0, 0, 0, 0, qpad))
    k = F.pad(k, (0, 0, 0, 0, 0, kpad))
    v = F.pad(v, (0, 0, 0, 0, 0, kpad))
    q_pos = F.pad(q_positions, (0, qpad), value=2**30)
    kv_pos = F.pad(kv_positions, (0, kpad), value=-1)

    q = q.reshape(B, qp // q_chunk, q_chunk, KV, G, hd)
    k = k.reshape(B, kp // kv_chunk, kv_chunk, KV, hd)
    v = v.reshape(B, kp // kv_chunk, kv_chunk, KV, hd)
    q_pos = q_pos.reshape(qp // q_chunk, q_chunk)
    kv_pos = kv_pos.reshape(kp // kv_chunk, kv_chunk)

    def q_step(qc, qpos_c):
        """One query chunk (B, qc, KV, G, hd) over every kv chunk."""
        qc = qc.float()
        out = torch.zeros((B, KV, G, q_chunk, hd), dtype=torch.float32, device=dev)
        m = torch.full((B, KV, G, q_chunk), -torch.inf, device=dev)
        l = torch.zeros((B, KV, G, q_chunk), dtype=torch.float32, device=dev)
        for j in range(kp // kv_chunk):
            kc, vc, kpos_c = k[:, j].float(), v[:, j].float(), kv_pos[j]
            s = torch.einsum("bqkgh,bskh->bkgqs", qc, kc) * scale
            if cap is not None:
                s = softcap(s, cap)
            mask = kpos_c[None, :] >= 0
            if causal:
                mask = mask & (kpos_c[None, :] <= qpos_c[:, None])
            if window is not None:
                mask = mask & (qpos_c[:, None] - kpos_c[None, :] < window)
            s = torch.where(mask, s, -torch.inf)
            m_new = torch.maximum(m, torch.amax(s, dim=-1))
            # guard fully-masked rows
            m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
            p = torch.exp(s - m_safe[..., None])
            p = torch.where(torch.isfinite(s), p, 0.0)
            corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
            l = l * corr + torch.sum(p, dim=-1)
            pv = torch.einsum("bkgqs,bskh->bkgqh", p, vc)
            out = out * corr[..., None] + pv
            m = m_new
        out = out / torch.clamp_min(l[..., None], 1e-20)
        return out.permute(0, 3, 1, 2, 4).to(v.dtype)  # (B, qc, KV, G, hd)

    # under autograd each chunk is recomputed in the backward pass, as the
    # reference's jax.checkpoint does: its probability matrices are not kept
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        step = lambda qc, qpos_c: checkpoint(q_step, qc, qpos_c, use_reentrant=False,
                                             preserve_rng_state=False)
    else:
        step = q_step
    outs = [step(q[:, i], q_pos[i]) for i in range(qp // q_chunk)]
    return torch.cat(outs, dim=1).reshape(B, qp, H, hd)[:, :S]


# ---------------------------------------------------------------------------
# GQA module
# ---------------------------------------------------------------------------

def _proj(x, w):
    """einsum("bsd,dhk->bshk") as one matrix product."""
    d, h, kd = w.shape
    return (x @ w.reshape(d, h * kd)).reshape(*x.shape[:-1], h, kd)


def _out(o, wo):
    """einsum("bshk,hkd->bsd")."""
    h, kd, d = wo.shape
    return o.reshape(*o.shape[:-2], h * kd) @ wo.reshape(h * kd, d)


def _project_qkv(p, cfg, x, positions):
    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def gqa_forward(p, cfg, x, positions, *, window=None, use_kernel=False):
    """Full-sequence attention (prefill) at positions 0..S-1. ``use_kernel``
    ("auto", True or False) picks the CUDA kernel or the chunked plain
    version (at the config's chunk sizes) in `kernels.flash_attention.ops`."""
    from repro_torch.kernels.flash_attention import ops as fa_ops

    q, k, v = _project_qkv(p, cfg, x, positions)
    out = fa_ops.flash_attention(
        q, k, v, causal=cfg.causal, window=window, cap=cfg.attn_softcap,
        use_kernel=use_kernel, q_chunk=cfg.attn_q_chunk, kv_chunk=cfg.attn_kv_chunk,
    )
    return _out(out, p["wo"])


def init_kv_cache(cfg, batch, length, window, dtype, device):
    """A ring buffer of min(length, window) slots (length without a window)."""
    size = min(length, window) if window else length
    return {
        "k": torch.zeros((batch, size, cfg.n_kv_heads, cfg.hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, size, cfg.n_kv_heads, cfg.hd), dtype=dtype, device=device),
        "pos_tag": torch.full((size,), -1, dtype=torch.int32, device=device),
    }


def gqa_decode(p, cfg, x, pos: int, cache, *, window=None):
    """One-token decode. x: (B,1,d); pos: the position of every row (one for
    the whole batch, as in the reference). Writes slot pos % size of the
    ring cache in place (the reference returns an updated copy) and returns
    (out, cache)."""
    positions = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(p, cfg, x, positions)
    size = cache["k"].shape[1]
    slot = pos % size
    cache["k"][:, slot] = k[:, 0]
    cache["v"][:, slot] = v[:, 0]
    cache["pos_tag"][slot] = pos
    kc, vc, tags = cache["k"], cache["v"], cache["pos_tag"]
    B, _, KV, hd = kc.shape
    H = cfg.n_heads
    G = H // KV
    qh = q.reshape(B, KV, G, hd).float()
    s = torch.einsum("bkgh,bskh->bkgs", qh, kc.float()) / float(np.sqrt(np.float32(hd)))
    if cfg.attn_softcap:
        s = softcap(s, cfg.attn_softcap)
    mask = (tags >= 0) & (tags <= pos)
    if window is not None:
        mask = mask & (pos - tags < window)
    s = torch.where(mask[None, None, None, :], s, -torch.inf)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskh->bkgh", w, vc.float())
    out = out.reshape(B, 1, H, hd).to(x.dtype)
    return _out(out, p["wo"]), cache

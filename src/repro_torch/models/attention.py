"""Attention: GQA with RoPE, sliding window, softcap and QKV bias; MLA.

Counterpart of `repro.models.attention`. Prefill uses the
chunked flash attention below (a running log-sum-exp over kv chunks, fp32)
or, with ``use_kernel``, the CUDA kernel of `repro_torch.kernels.flash_attention`;
the chunked function is that kernel's plain version, as it is the Pallas
kernel's oracle in the reference. Decode attends one query over a KV cache;
sliding-window layers keep a ring buffer of ``window`` slots with explicit
position tags. DeepSeek's MLA: low-rank q and kv projections with a
decoupled RoPE head; its prefill builds per-head K and V from the latent and
takes the chunked plain attention (as the reference's does), its decode
caches only the latent (c_kv, k_rope) and scores in the absorbed form.

Under a mesh (``par``, `parallel.collectives.Par`) the weights are each
rank's head shard over ``model`` (`parallel.sharding`): the replicated
input enters through `collectives.copy`, q/k/v and the attention (the
kernel included, once per shard and layer) cover the local heads, and the
partial ``wo`` products are summed by `collectives.reduce`. A decode
cache holds the local kv heads (GQA) or its slice of the latent (MLA,
gathered for the step's scores).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.flash_attention.kernel import scale_of
from repro_torch.parallel import collectives as C

from .layers import apply_rope, constant, dense_init, rms_norm, softcap


def init_attn_params(generator, cfg, dtype, out=None) -> dict:
    """The GQA parameters; with ``out`` (their slots in a stacked tree, by
    name) written there (`layers.dense_init`)."""
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    o = out or {}
    normal = lambda name, shape: dense_init(generator, shape, dtype=dtype, out=o.get(name))
    p = {
        "wq": normal("wq", (d, H, hd)),
        "wk": normal("wk", (d, KV, hd)),
        "wv": normal("wv", (d, KV, hd)),
        "wo": normal("wo", (H, hd, d)),
    }
    if cfg.qkv_bias:
        for name, n in (("bq", H), ("bk", KV), ("bv", KV)):
            p[name] = constant((n, hd), 0.0, dtype, generator.device, o.get(name))
    return p


def init_mla_params(generator, cfg, dtype, out=None) -> dict:
    """DeepSeek's MLA parameters: the q and kv down-projections with their
    norms, the per-head up-projections (q: hd + rope columns; k and v: hd
    from the kv latent) and the output projection."""
    d, H, hd = cfg.d_model, cfg.n_heads, cfg.hd
    qlr, kvlr, rd = cfg.q_lora_rank, cfg.kv_lora_rank, cfg.qk_rope_dim
    o = out or {}
    normal = lambda name, shape: dense_init(generator, shape, dtype=dtype, out=o.get(name))
    zeros = lambda name, n: constant((n,), 0.0, dtype, generator.device, o.get(name))
    return {
        "w_dq": normal("w_dq", (d, qlr)),
        "q_norm": zeros("q_norm", qlr),
        "w_uq": normal("w_uq", (qlr, H, hd + rd)),
        "w_dkv": normal("w_dkv", (d, kvlr + rd)),
        "kv_norm": zeros("kv_norm", kvlr),
        "w_uk": normal("w_uk", (kvlr, H, hd)),
        "w_uv": normal("w_uv", (kvlr, H, hd)),
        "wo": normal("wo", (H, hd, d)),
    }


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


def _heads_sharded(p, cfg, par) -> bool:
    """Whether ``p`` holds this rank's head shard (else every head). The q
    and kv heads are split alike or not at all: a q shard must see its own
    kv heads (`launch.specs.mesh_adapt` makes the head counts divide)."""
    if par is None:
        return False
    q = par.sharded(p["wq"].shape[1], cfg.n_heads)
    if q != par.sharded(p["wk"].shape[1], cfg.n_kv_heads):
        raise ValueError(f"{cfg.name}: {cfg.n_heads} q and {cfg.n_kv_heads} kv heads do not split "
                         f"alike over a model axis of {par.M}; adapt the config (launch.specs.mesh_adapt)")
    return q


def _project_qkv(p, cfg, x, positions, par=None):
    if _heads_sharded(p, cfg, par):
        x = C.copy(x, par)
    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _out_reduced(p, cfg, o, par):
    """The output projection; under a head-sharded mesh its partial sums
    are reduced over ``model``."""
    out = _out(o, p["wo"])
    return C.reduce(out, par) if _heads_sharded(p, cfg, par) else out


def gqa_forward(p, cfg, x, positions, *, window=None, use_kernel=False, par=None):
    """Full-sequence attention (prefill) at positions 0..S-1. ``use_kernel``
    ("auto", True or False) picks the CUDA kernel or the chunked plain
    version (at the config's chunk sizes) in `kernels.flash_attention.ops`.
    Under a mesh ``p`` is this rank's head shard (module docstring)."""
    from repro_torch.kernels.flash_attention import ops as fa_ops

    q, k, v = _project_qkv(p, cfg, x, positions, par)
    out = fa_ops.flash_attention(
        q, k, v, causal=cfg.causal, window=window, cap=cfg.attn_softcap,
        use_kernel=use_kernel, q_chunk=cfg.attn_q_chunk, kv_chunk=cfg.attn_kv_chunk,
    )
    return _out_reduced(p, cfg, out, par)


def init_kv_cache(cfg, batch, length, window, dtype, device):
    """A ring buffer of min(length, window) slots (length without a window)."""
    size = min(length, window) if window else length
    return {
        "k": torch.zeros((batch, size, cfg.n_kv_heads, cfg.hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, size, cfg.n_kv_heads, cfg.hd), dtype=dtype, device=device),
        "pos_tag": torch.full((size,), -1, dtype=torch.int32, device=device),
    }


def gqa_decode(p, cfg, x, pos: int, cache, *, window=None, par=None):
    """One-token decode. x: (B,1,d); pos: the position of every row (one for
    the whole batch, as in the reference). Writes slot pos % size of the
    ring cache in place (the reference returns an updated copy) and returns
    (out, cache)."""
    positions = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(p, cfg, x, positions, par)
    size = cache["k"].shape[1]
    slot = pos % size
    cache["k"][:, slot] = k[:, 0]
    cache["v"][:, slot] = v[:, 0]
    cache["pos_tag"][slot] = pos
    kc, vc, tags = cache["k"], cache["v"], cache["pos_tag"]
    B, _, KV, hd = kc.shape
    H = q.shape[2]                          # the local heads under a mesh
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
    return _out_reduced(p, cfg, out, par), cache


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V3)
# ---------------------------------------------------------------------------

def _mla_heads_sharded(p, cfg, par) -> bool:
    return par is not None and par.sharded(p["w_uq"].shape[1], cfg.n_heads)


def _mla_q(p, cfg, x, positions, par=None):
    """(q_nope (B,S,H,hd), q_rope (B,S,H,rope)) from the normed q latent;
    under a mesh the latent's column shards are gathered for its norm, and
    H is the local heads."""
    if par is not None and par.sharded(p["w_dq"].shape[1], cfg.q_lora_rank):
        ql = C.gather(C.copy(x, par) @ p["w_dq"], par)
    else:
        ql = x @ p["w_dq"]
    ql = rms_norm(ql, p["q_norm"], cfg.norm_eps)
    if _mla_heads_sharded(p, cfg, par):
        ql = C.copy(ql, par)
    q = _proj(ql, p["w_uq"])
    q_nope, q_rope = q[..., : cfg.hd], q[..., cfg.hd:]
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)


def _mla_latent(p, cfg, x, positions):
    """(c_kv (B,S,kv_lora) normed, k_rope (B,S,rope)): what the cache keeps;
    k_rope is one rotated head shared by every query head."""
    dkv = x @ p["w_dkv"]
    c_kv = rms_norm(dkv[..., : cfg.kv_lora_rank], p["kv_norm"], cfg.norm_eps)
    k_rope = apply_rope(dkv[..., cfg.kv_lora_rank:][:, :, None, :], positions, cfg.rope_theta)
    return c_kv, k_rope[:, :, 0]


def _mla_out(p, cfg, o, par):
    out = _out(o, p["wo"])
    return C.reduce(out, par) if _mla_heads_sharded(p, cfg, par) else out


def mla_forward(p, cfg, x, positions, par=None):
    """Prefill at positions 0..S-1: per-head K and V built from the latent,
    q and k of width hd + rope, v zero-padded to that width for the chunked
    attention (at the config's chunks) and sliced back to hd. It takes the
    plain chunked attention, as the reference's does: no kernel. Under a
    mesh the heads are this rank's shard."""
    q_nope, q_rope = _mla_q(p, cfg, x, positions, par)
    c_kv, k_rope = _mla_latent(p, cfg, x, positions)
    if _mla_heads_sharded(p, cfg, par):     # the latent feeds this rank's heads
        c_kv, k_rope = C.copy(c_kv, par), C.copy(k_rope, par)
    k_nope = _proj(c_kv, p["w_uk"])
    v = _proj(c_kv, p["w_uv"])
    H = q_nope.shape[2]
    k_rope_h = k_rope[:, :, None, :].expand(*k_rope.shape[:2], H, cfg.qk_rope_dim)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope_h], dim=-1)
    v_pad = F.pad(v, (0, cfg.qk_rope_dim))
    out = flash_attention(
        q, k, v_pad, q_positions=positions, kv_positions=positions, causal=True,
        q_chunk=cfg.attn_q_chunk, kv_chunk=cfg.attn_kv_chunk,
    )[..., : cfg.hd]
    return _mla_out(p, cfg, out, par)


def init_mla_cache(cfg, batch, length, dtype, device):
    """The latent cache: c_kv (B, length, kv_lora), k_rope (B, length, rope)
    and the positions written (-1: none)."""
    return {
        "c_kv": torch.zeros((batch, length, cfg.kv_lora_rank), dtype=dtype, device=device),
        "k_rope": torch.zeros((batch, length, cfg.qk_rope_dim), dtype=dtype, device=device),
        "pos_tag": torch.full((length,), -1, dtype=torch.int32, device=device),
    }


def mla_decode(p, cfg, x, pos: int, cache, par=None):
    """One-token decode in the absorbed form: scores and the value sum in
    the latent space, in float32 (no per-head K or V), scaled by
    1/sqrt(hd + rope). Writes slot pos of the cache in place (the last slot
    past its end, as the reference's clamped update does) and returns
    (out, cache). Under a mesh the cache holds this rank's slice of the
    latent (`parallel.sharding.cache_specs`), gathered for the scores."""
    positions = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    q_nope, q_rope = _mla_q(p, cfg, x, positions, par)      # (B,1,H,hd), (B,1,H,rope)
    c_kv_t, k_rope_t = _mla_latent(p, cfg, x, positions)
    slot = min(pos, cache["c_kv"].shape[1] - 1)
    latent_sharded = par is not None and par.sharded(cache["c_kv"].shape[-1], cfg.kv_lora_rank)
    cache["c_kv"][:, slot] = C.split(c_kv_t[:, 0], par) if latent_sharded else c_kv_t[:, 0]
    cache["k_rope"][:, slot] = k_rope_t[:, 0]
    cache["pos_tag"][slot] = pos
    c_kv = C.gather(cache["c_kv"], par) if latent_sharded else cache["c_kv"]
    c_kv, k_rope, tags = c_kv.float(), cache["k_rope"].float(), cache["pos_tag"]
    q_eff = torch.einsum("bshk,rhk->bshr", q_nope.float(), p["w_uk"].float())   # (B,1,H,r)
    s = torch.einsum("bshr,btr->bhst", q_eff, c_kv)
    s = s + torch.einsum("bshk,btk->bhst", q_rope.float(), k_rope)
    s = s / float(np.sqrt(np.float32(cfg.hd + cfg.qk_rope_dim)))
    mask = (tags >= 0) & (tags <= pos)
    s = torch.where(mask[None, None, None, :], s, -torch.inf)
    w = torch.softmax(s, dim=-1)
    lat = torch.einsum("bhst,btr->bshr", w, c_kv)                              # (B,1,H,r)
    out = torch.einsum("bshr,rhk->bshk", lat, p["w_uv"].float()).to(x.dtype)
    return _mla_out(p, cfg, out, par), cache

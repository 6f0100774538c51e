"""Parity of the port's MLA (DeepSeek-V3's multi-head latent attention,
`repro_torch.models.attention`) with the JAX reference, on the CPU.

The reference's smoke DeepSeek-V3 (d 256, 4 heads of hd 64, q_lora 64,
kv_lora 32, rope 16, float32) is initialised by the reference and bridged
into the port; the attention of its first layer takes the same numpy
inputs in both packages. Chunks are cut to q 64 / kv 32 where a test says
so, so that a sequence spans several chunks with a ragged end. Tolerances:
float32, and the two frameworks sum in other orders: the layer at atol
1e-5, rtol 1e-5; the absorbed decode against the prefill it reorders
(scores through w_uk in the latent, the value sum before w_uv) at 1e-4
relative to its scale; logits as in `tests/test_torch_moe.py`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget_config
from repro.models import attention as Jattn, model as JM
from repro.models.config import smoke_variant as jsmoke
from repro_torch import bridge
from repro_torch.configs import registry
from repro_torch.models import attention as A, model as M
from repro_torch.models.config import smoke_variant

torch.set_num_threads(1)
ARCH = "deepseek_v3_671b"
LAYER_TOL = dict(atol=1e-5, rtol=1e-5)
LOGIT_TOL = dict(atol=4e-5, rtol=1e-4)
#: chunks that split S 100 into two query chunks and four kv chunks, the last ragged
SMALL_CHUNKS = dict(attn_q_chunk=64, attn_kv_chunk=32)


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


_MODELS = {}


def _models(**cut):
    key = tuple(sorted(cut.items()))
    if key not in _MODELS:
        jcfg = jsmoke(jget_config(ARCH)).scaled(**cut)
        cfg = smoke_variant(registry.get_config(ARCH)).scaled(**cut)
        jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
        tp = bridge.lm_params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
        _MODELS[key] = (jcfg, jp, cfg, tp)
    return _MODELS[key]


def _attn(**cut):
    """(jax cfg, the reference's layer-0 MLA params, port cfg, the port's)."""
    jcfg, jp, cfg, tp = _models(**cut)
    return jcfg, jax.tree.map(lambda a: a[0], jp["stages"]["dense_prefix"]["b0"]["attn"]), cfg, tp.layers[0].attn


def _x(cfg, seed, B, S):
    x = np.random.default_rng(seed).standard_normal((B, S, cfg.d_model)).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def test_mla_params_and_cache_are_the_references():
    """The port's own init and cache: the reference's leaves, shapes and
    types (the q up-projection of width hd + rope)."""
    jcfg, _, cfg, _ = _attn()
    want = jax.eval_shape(lambda: Jattn.init_mla_params(jax.random.PRNGKey(0), jcfg, jnp.float32))
    got = A.init_mla_params(torch.Generator().manual_seed(0), cfg, torch.float32)
    assert sorted(got) == sorted(want)
    assert {k: tuple(v.shape) for k, v in got.items()} == {k: tuple(v.shape) for k, v in want.items()}
    assert got["w_uq"].shape == (cfg.q_lora_rank, cfg.n_heads, cfg.hd + cfg.qk_rope_dim)
    jc = Jattn.init_mla_cache(jcfg, 2, 48, jnp.bfloat16)
    c = A.init_mla_cache(cfg, 2, 48, torch.bfloat16, "cpu")
    assert sorted(c) == sorted(jc)
    for k in jc:
        assert tuple(c[k].shape) == tuple(jc[k].shape) and str(c[k].dtype)[6:] == str(jc[k].dtype), k
        np.testing.assert_array_equal(_np(c[k]), np.asarray(jc[k], np.float32))


def test_mla_q_and_latent_match_reference():
    jcfg, jp, cfg, tp = _attn()
    jx, tx = _x(cfg, 1, 2, 24)
    pos = np.arange(24, dtype=np.int32)
    for jf, tf in ((Jattn._mla_q, A._mla_q), (Jattn._mla_latent, A._mla_latent)):
        want = jf(jp, jcfg, jx, jnp.asarray(pos))
        got = tf(tp, cfg, tx, torch.from_numpy(pos))
        for g, w in zip(got, want, strict=True):
            assert tuple(g.shape) == tuple(w.shape)
            np.testing.assert_allclose(_np(g), _np(w), **LAYER_TOL)


@pytest.mark.parametrize("S,cut", [(40, {}), (100, SMALL_CHUNKS)], ids=["one chunk", "ragged chunks"])
def test_mla_forward_matches_reference(S, cut):
    jcfg, jp, cfg, tp = _attn(**cut)
    jx, tx = _x(cfg, 2, 2, S)
    pos = np.arange(S, dtype=np.int32)
    want = Jattn.mla_forward(jp, jcfg, jx, jnp.asarray(pos))
    got = A.mla_forward(tp, cfg, tx, torch.from_numpy(pos))
    assert got.shape == (2, S, cfg.d_model)
    np.testing.assert_allclose(_np(got), _np(want), **LAYER_TOL)


def test_mla_decode_matches_reference_and_the_prefill():
    """40 absorbed decode steps of one layer: each output and the cache it
    writes (c_kv, k_rope, pos_tag) against the reference's; the outputs
    against `mla_forward` of the whole sequence, which builds per-head K
    and V instead. A step past the cache's end writes its last slot, as the
    reference's clamped update does."""
    jcfg, jp, cfg, tp = _attn()
    jx, tx = _x(cfg, 3, 2, 40)
    jc = Jattn.init_mla_cache(jcfg, 2, 40, jnp.float32)
    c = A.init_mla_cache(cfg, 2, 40, torch.float32, "cpu")
    step = jax.jit(lambda p, x, pos, c: Jattn.mla_decode(p, jcfg, x, pos, c))
    outs = []
    for pos in range(40):
        want, jc = step(jp, jx[:, pos:pos + 1], jnp.int32(pos), jc)
        got, c = A.mla_decode(tp, cfg, tx[:, pos:pos + 1], pos, c)
        np.testing.assert_allclose(_np(got), _np(want), err_msg=f"pos {pos}", **LAYER_TOL)
        outs.append(got)
    for k in jc:
        np.testing.assert_allclose(_np(c[k]), _np(jc[k]), err_msg=k, **LAYER_TOL)
    full = A.mla_forward(tp, cfg, tx, torch.arange(40, dtype=torch.int32))
    dec = torch.cat(outs, dim=1)
    assert float((dec - full).abs().max()) <= 1e-4 * float(full.abs().max())
    want, jc = step(jp, jx[:, :1], jnp.int32(45), jc)
    got, c = A.mla_decode(tp, cfg, tx[:, :1], 45, c)
    np.testing.assert_allclose(_np(got), _np(want), **LAYER_TOL)
    assert int(c["pos_tag"][-1]) == int(jc["pos_tag"][-1]) == 45


def test_deepseek_decode_matches_its_forward_logits():
    """The model (a dense prefix layer, then MLA + MoE layers): 32 decode
    steps of one sequence against `forward`'s logits at those positions of
    a 128-token forward. Its capacity is 80 an expert, and the first 32
    tokens come first in each expert's order with at most 32 assignments,
    so the forward drops none of theirs."""
    _, _, cfg, tp = _models()
    toks = torch.from_numpy(np.random.default_rng(5).integers(0, cfg.vocab, (1, 128)))
    full, aux = M.forward(tp, cfg, {"tokens": toks})
    full = full[:, :32]
    assert float(aux) > 0
    cache = M.init_cache(cfg, 1, 40, "cpu")
    assert sorted(cache[0]) == ["c_kv", "k_rope", "pos_tag"]
    steps = [M.decode_step(tp, cfg, toks[:, pos:pos + 1], pos, cache)[0] for pos in range(32)]
    np.testing.assert_allclose(_np(torch.cat(steps, dim=1)), _np(full), **LOGIT_TOL)

"""Parity of the port's LM serving path with the JAX reference, on the CPU.

The reference's smoke variants of Gemma-2 2B (local/global attention,
window 64, softcaps, post-norms, GeGLU, tied embeddings) and Qwen2.5-3B
(QKV bias, GQA ratio 2 at smoke width, SwiGLU) are initialised by the
reference (`repro.models.model.init_params`); the same weights reach the
port through `repro_torch.bridge.lm_params_from_numpy`. The reference runs
`prefill` on the CPU, which takes its chunked attention, the kernel's own
oracle; the port's CPU path is the same chunked algorithm.

Tolerances: float32 throughout, and the two frameworks sum in other orders,
so layers are held to 1e-5 and whole-model logits (|logit| about 1.5) to
atol 2e-5, rtol 1e-4 (measured gap about 2e-6). Greedy tokens must be
identical.
"""
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget_config
from repro.launch.serve import ServeLoop as JServeLoop
from repro.models import layers as JL, model as JM, moe as Jmoe
from repro.models.config import smoke_variant as jsmoke
from repro_torch import bridge
from repro_torch.configs import registry
from repro_torch.launch.serve import ServeLoop
from repro_torch.models import layers as L, model as M, moe
from repro_torch.models.config import smoke_variant

torch.set_num_threads(1)
ARCHS = ("gemma2_2b", "qwen2_5_3b")
LOGIT_TOL = dict(atol=2e-5, rtol=1e-4)


def _configs(arch):
    return jsmoke(jget_config(arch)), smoke_variant(registry.get_config(arch))


_MODELS = {}


def _models(arch):
    """(jax cfg, jax params, port cfg, port LM) of one smoke arch, built once."""
    if arch not in _MODELS:
        jcfg, cfg = _configs(arch)
        jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
        tp = bridge.lm_params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
        _MODELS[arch] = (jcfg, jp, cfg, tp)
    return _MODELS[arch]


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_reference(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 64)).astype(np.float32) * 3.0
    g = rng.standard_normal((64,)).astype(np.float32) * 0.1
    want = JL.rms_norm(jnp.asarray(x).astype(dtype), jnp.asarray(g).astype(dtype))
    got = L.rms_norm(torch.from_numpy(x).to(getattr(torch, dtype)),
                     torch.from_numpy(g).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    # bf16: the same rounding steps in the same order, so bit-equal results
    # up to one bf16 ulp where XLA fuses the product
    tol = 1e-5 if dtype == "float32" else 8e-3
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_rope_matches_reference(dtype):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 3, 64)).astype(np.float32)
    pos = np.array([0, 1, 2, 5, 17, 63, 64, 1000, 4095], np.int32)
    want = JL.apply_rope(jnp.asarray(x).astype(dtype), jnp.asarray(pos), 1e4)
    got = L.apply_rope(torch.from_numpy(x).to(getattr(torch, dtype)), torch.from_numpy(pos), 1e4)
    tol = 1e-5 if dtype == "float32" else 8e-3
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_dense_ffn_matches_reference(arch):
    """GeGLU (tanh GELU, Gemma-2) and SwiGLU (Qwen2.5) with the same weights."""
    jcfg, jp, cfg, tp = _models(arch)
    x = np.random.default_rng(2).standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    jffn = jax.tree.map(lambda a: a[0], jp["stages"]["main"]["b0"]["ffn"])
    want = Jmoe.dense_ffn(jffn, jcfg, jnp.asarray(x))
    got = moe.dense_ffn(tp.layers[0].ffn, cfg, torch.from_numpy(x))
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)


def test_gelu_is_the_tanh_approximation():
    x = np.linspace(-6, 6, 101, dtype=np.float32)
    np.testing.assert_allclose(L.gelu(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.nn.gelu(jnp.asarray(x))), rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def test_smoke_configs_equal_reference():
    for arch in ARCHS:
        jcfg, cfg = _configs(arch)
        assert {f: getattr(cfg, f) for f in cfg.__dataclass_fields__} == \
            {f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__}
        full = registry.get_config(arch)
        assert full.param_count() == jget_config(arch).param_count()


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_match_reference(arch):
    """S = 160: more than the smoke window (64) and not a chunk multiple."""
    jcfg, jp, cfg, tp = _models(arch)
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (2, 160))
    want = jax.jit(lambda p, t: JM.prefill(p, jcfg, {"tokens": t}))(jp, jnp.asarray(toks))
    got = M.prefill(tp, cfg, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (2, 160, cfg.vocab) and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), **LOGIT_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_logits_match_reference(arch):
    """80 cached decode steps: the local layers' 64-slot ring wraps."""
    jcfg, jp, cfg, tp = _models(arch)
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (2, 80))
    jcache = JM.init_cache(jcfg, 2, 96)
    cache = M.init_cache(cfg, 2, 96, "cpu")
    if cfg.sliding_window and "attn_local" in cfg.block_pattern:
        assert cache[0]["k"].shape[1] == cfg.sliding_window == 64
    step = jax.jit(lambda p, t, pos, c: JM.decode_step(p, jcfg, t, pos, c))
    for pos in range(80):
        t = toks[:, pos:pos + 1]
        want, jcache = step(jp, jnp.asarray(t, jnp.int32), jnp.int32(pos), jcache)
        got, cache = M.decode_step(tp, cfg, torch.from_numpy(t), pos, cache)
        np.testing.assert_allclose(_np(got), _np(want), err_msg=f"pos {pos}", **LOGIT_TOL)
    # the cache reproduces the prefill's last position
    full = M.prefill(tp, cfg, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(_np(got)[:, 0], _np(full)[:, -1], **LOGIT_TOL)


def _serving_cases():
    """The prompts and loops of tests/test_serving.py."""
    key = jax.random.PRNGKey(1)
    qwen_prompts = [
        [int(t) for t in jax.random.randint(jax.random.fold_in(key, i), (4,), 0,
                                            jsmoke(jget_config("qwen2_5_3b")).vocab)]
        for i in range(5)
    ]
    return {
        "qwen_queue": ("qwen2_5_3b", qwen_prompts, 2, 64, 6),
        "gemma_greedy": ("gemma2_2b", [[1, 2, 3, 4]], 1, 32, 5),
    }


@pytest.mark.parametrize("case", ["qwen_queue", "gemma_greedy"])
def test_serve_loop_tokens_match_reference(case):
    arch, prompts, slots, max_len, max_new = _serving_cases()[case]
    jcfg, jp, cfg, tp = _models(arch)
    want, _ = JServeLoop(jcfg, jp, slots, max_len=max_len).run([list(p) for p in prompts], max_new)
    got, stats = ServeLoop(cfg, tp, slots, max_len=max_len).run([list(p) for p in prompts], max_new)
    assert got == {k: [int(t) for t in v] for k, v in want.items()}
    assert set(got) == set(range(len(prompts)))
    assert all(len(v) == max_new for v in got.values())
    assert stats["steps"] > 0


def test_serve_loop_sampling_is_seeded_and_in_range():
    """greedy=False samples from the softmax with the caller's generator
    (the reference draws with its own PRNG keys, so only the law is
    shared): the same seed gives the same tokens, every token in range."""
    _, _, cfg, tp = _models("qwen2_5_3b")
    runs = [ServeLoop(cfg, tp, 2, max_len=32).run(
        [[1, 2, 3], [4, 5]], max_new=5, greedy=False,
        generator=torch.Generator().manual_seed(7))[0] for _ in range(2)]
    assert runs[0] == runs[1]
    assert all(len(v) == 5 and all(0 <= t < cfg.vocab for t in v) for v in runs[0].values())


def test_bridge_takes_bfloat16_pytrees_exactly():
    """bf16 leaves arrive as ml_dtypes arrays; through float32 they are exact."""
    jcfg = jsmoke(jget_config("gemma2_2b")).scaled(dtype="bfloat16")
    cfg = smoke_variant(registry.get_config("gemma2_2b")).scaled(dtype="bfloat16")
    jp = JM.init_params(jax.random.PRNGKey(5), jcfg)
    tree = jax.tree.map(np.asarray, jp)
    tp = bridge.lm_params_from_numpy(tree, cfg, device="cpu")
    assert tp.embed.dtype == torch.bfloat16
    np.testing.assert_array_equal(tp.embed.float().numpy(), np.asarray(tree["embed"], np.float32))
    pat = cfg.pattern_len
    for period in range(2):
        for j in range(pat):
            layer = tp.layers[period * pat + j]
            src = tree["stages"]["main"][f"b{j}"]
            np.testing.assert_array_equal(layer.attn["wq"].float().numpy(),
                                          np.asarray(src["attn"]["wq"][period], np.float32))
            np.testing.assert_array_equal(layer.post_ffn_ln.float().numpy(),
                                          np.asarray(src["post_ffn_ln"][period], np.float32))
    assert [blk.kind for blk in tp.layers] == list(cfg.block_pattern) * 2


def test_init_params_follows_the_reference_law():
    cfg = smoke_variant(registry.get_config("qwen2_5_3b"))
    tp = M.init_params(cfg, torch.Generator().manual_seed(0))
    assert sum(p.numel() for p in jax.tree.leaves(tp.tree)) == sum(
        np.size(x) for x in jax.tree.leaves(JM.init_params(jax.random.PRNGKey(0), jsmoke(
            jget_config("qwen2_5_3b")))))
    wq = tp.layers[0].attn["wq"]
    assert abs(float(wq.std()) * cfg.d_model ** 0.5 - 1.0) < 0.05
    assert abs(float(tp.embed.std()) / 0.02 - 1.0) < 0.05
    assert float(tp.layers[0].attn["bq"].abs().max()) == 0.0


@pytest.mark.parametrize("arch", sorted(registry.NOT_PORTED))
def test_unported_archs_raise_naming_the_roadmap_item(arch):
    """An LM config the port does not run raises from `init_params`, before
    anything is allocated (its config is plain data `get_config` returns)."""
    with pytest.raises(NotImplementedError, match=r"ROADMAP\.md §1, item \d+"):
        M.init_params(registry.get_config(arch), torch.Generator().manual_seed(0))


@pytest.mark.parametrize("arch", registry.list_archs())
def test_every_config_counts_the_references_parameters(arch):
    """All ten LM configs are the reference's: the same parameter counts,
    total and active (`hetero_classes` sorts its device classes by them)."""
    cfg, jcfg = registry.get_config(arch), jget_config(arch)
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()
    assert {f: getattr(cfg, f) for f in cfg.__dataclass_fields__} == \
        {f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__}


def test_list_archs_is_the_references():
    from repro.configs.registry import list_archs as jlist_archs

    assert registry.list_archs() == jlist_archs()


def test_unported_paths_raise():
    cfg = smoke_variant(registry.get_config("gemma2_2b"))
    tp = M.init_params(cfg, torch.Generator().manual_seed(0))
    toks = {"tokens": torch.zeros((1, 8), dtype=torch.long)}
    with pytest.raises(ValueError, match="use_kernel=True needs CUDA tensors"):
        M.prefill(tp, cfg, toks, use_kernel=True)
    with pytest.raises(NotImplementedError):
        M.prefill(tp, cfg, toks, mesh=object())
    for bad in (dict(n_experts=4, top_k=2), dict(use_mla=True), dict(frontend="audio")):
        with pytest.raises(NotImplementedError):
            M.init_params(cfg.scaled(**bad), torch.Generator().manual_seed(0))
    # mamba blocks run; the published Jamba's 16 experts do not (raised before
    # anything is allocated)
    with pytest.raises(NotImplementedError, match=r"MoE.*ROADMAP\.md §1, item 12"):
        M.init_params(registry.get_config("jamba_1_5_large_398b"), torch.Generator().manual_seed(0))


def test_port_imports_neither_jax_nor_the_reference():
    """Every module of the package, and chip_smoke.py, in a fresh interpreter."""
    code = (
        "import importlib, pkgutil, sys, runpy\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'repro' or m.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith('repro_torch')]))\n"
    )
    import os
    import pathlib

    root = pathlib.Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=f"{root / 'src'}{os.pathsep}{root}")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=root, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) > 20

"""Parity of the port's LM serving path with the JAX reference, on the CPU.

The reference's smoke variants of Gemma-2 2B (local/global attention,
window 64, softcaps, post-norms, GeGLU, tied embeddings), Qwen2.5-3B
(QKV bias, GQA ratio 2 at smoke width, SwiGLU), Gemma-2 9B, StarCoder2-3B
(GELU MLP with biases, QKV bias, rope_theta 1e5), HuBERT X-Large (the
audio frontend: projected frame embeddings, non-causal attention, 504
classes) and Pixtral-12B (the vision frontend: projected patch embeddings
over the leading positions) are initialised by the reference
(`repro.models.model.init_params`); the same weights reach the port
through `repro_torch.bridge.lm_params_from_numpy`. A narrow HuBERT
(d 160, 2 heads) keeps the published head dim 80. The reference runs
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
ARCHS = ("gemma2_2b", "qwen2_5_3b", "gemma2_9b", "starcoder2_3b", "hubert_xlarge", "pixtral_12b")
#: the archs with a decode step (HuBERT is an encoder)
DECODERS = tuple(a for a in ARCHS if a != "hubert_xlarge")
#: HuBERT narrowed to d 160 and 2 heads: its published head dim, 80
HUBERT_HD80 = dict(d_model=160, n_heads=2, n_kv_heads=2, head_dim=80)
LOGIT_TOL = dict(atol=2e-5, rtol=1e-4)


def _configs(arch, **cut):
    return (jsmoke(jget_config(arch)).scaled(**cut),
            smoke_variant(registry.get_config(arch)).scaled(**cut))


_MODELS = {}


def _models(arch, **cut):
    """(jax cfg, jax params, port cfg, port LM) of one smoke arch (and
    `ModelConfig.scaled` arguments ``cut``), built once."""
    key = (arch, tuple(sorted(cut.items())))
    if key not in _MODELS:
        jcfg, cfg = _configs(arch, **cut)
        jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
        tp = bridge.lm_params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
        _MODELS[key] = (jcfg, jp, cfg, tp)
    return _MODELS[key]


def _batch(cfg, seed, B, S, n_patch=None):
    """A prefill batch of `launch.specs.input_specs`'s layout, drawn with
    numpy: (the reference's, the port's). Frame and patch embeddings are
    bf16 on both sides, as the specs make them; vision carries S // 4
    patches unless ``n_patch`` is given."""
    rng = np.random.default_rng(seed)
    bf16 = lambda a: (jnp.asarray(a).astype(jnp.bfloat16), torch.from_numpy(a).to(torch.bfloat16))
    if cfg.frontend == "audio":
        j, t = bf16(rng.standard_normal((B, S, cfg.frontend_dim)).astype(np.float32))
        return {"frame_embeds": j}, {"frame_embeds": t}
    toks = rng.integers(0, cfg.vocab, (B, S))
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    if cfg.frontend == "vision":
        n = S // 4 if n_patch is None else n_patch
        jb["patch_embeds"], tb["patch_embeds"] = bf16(
            rng.standard_normal((B, n, cfg.frontend_dim)).astype(np.float32))
    return jb, tb


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
    """GeGLU (tanh GELU, Gemma-2), SwiGLU (Qwen2.5 and Pixtral) and the GELU
    MLP with biases (StarCoder2, HuBERT) with the same weights."""
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
    jb, tb = _batch(cfg, 3, 2, 160)
    want = jax.jit(lambda p, b: JM.prefill(p, jcfg, b))(jp, jb)
    got = M.prefill(tp, cfg, tb)
    out = cfg.n_classes if cfg.arch_type == "audio" else cfg.vocab
    assert got.shape == (2, 160, out) and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), **LOGIT_TOL)


def test_hubert_prefill_at_head_dim_80_matches_reference():
    """The published head dim 80 and bidirectional attention through the
    plain route, S = 150 (a ragged last chunk)."""
    jcfg, jp, cfg, tp = _models("hubert_xlarge", **HUBERT_HD80)
    assert cfg.hd == 80 and not cfg.causal and cfg.frontend == "audio"
    assert tp.head.shape == (160, cfg.n_classes) and tp.frontend_proj.shape == (cfg.frontend_dim, 160)
    jb, tb = _batch(cfg, 7, 2, 150)
    want = jax.jit(lambda p, b: JM.prefill(p, jcfg, b))(jp, jb)
    got = M.prefill(tp, cfg, tb)
    np.testing.assert_allclose(_np(got), _np(want), **LOGIT_TOL)
    # bidirectional: the first position sees the last one's frame
    tb2 = {"frame_embeds": tb["frame_embeds"].clone()}
    tb2["frame_embeds"][:, -1] += 1.0
    assert not torch.allclose(M.prefill(tp, cfg, tb2)[:, 0], got[:, 0])


def test_vision_patches_overwrite_the_leading_positions():
    """Positions past the patches embed their tokens; the patches' own
    tokens are never read."""
    _, _, cfg, tp = _models("pixtral_12b")
    _, tb = _batch(cfg, 8, 1, 32)
    x, _ = M._embed(tp, cfg, tb)
    n = tb["patch_embeds"].shape[1]
    assert n == 8
    torch.testing.assert_close(x[:, n:], tp.embed[tb["tokens"][:, n:]], rtol=0, atol=0)
    torch.testing.assert_close(x[:, :n], tb["patch_embeds"].float() @ tp.frontend_proj)
    other = dict(tb, tokens=tb["tokens"].clone())
    other["tokens"][:, :n] = 0
    assert torch.equal(M._embed(tp, cfg, other)[0], x)


@pytest.mark.parametrize("arch", DECODERS)
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
    # the cache reproduces the prefill's last position (no patches: decode
    # embeds tokens)
    batch = {"tokens": torch.from_numpy(toks)}
    if cfg.frontend == "vision":
        batch["patch_embeds"] = torch.zeros((2, 0, cfg.frontend_dim), dtype=torch.bfloat16)
    full = M.prefill(tp, cfg, batch)
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
    shared): the same seed gives the same tokens, with or without a
    (1, 1) mesh, every token in range."""
    _, _, cfg, tp = _models("qwen2_5_3b")
    runs = [ServeLoop(cfg, tp, 2, max_len=32).run(
        [[1, 2, 3], [4, 5]], max_new=5, greedy=False,
        generator=torch.Generator().manual_seed(7))[0] for _ in range(2)]
    assert runs[0] == runs[1]
    # one sampler with or without a mesh: a (1, 1) mesh draws the same tokens
    from repro_torch.launch.mesh import open_mesh
    from repro_torch.parallel import sharding as SH

    mesh = open_mesh(device_type="cpu")
    placed = SH.shard_tree(mesh, SH.param_specs(tp.tree), tp.tree)
    on_mesh = ServeLoop(cfg, placed, 2, max_len=32, mesh=mesh).run(
        [[1, 2, 3], [4, 5]], max_new=5, greedy=False, generator=torch.Generator().manual_seed(7))[0]
    assert on_mesh == runs[0]
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


@pytest.mark.parametrize("arch", ARCHS[2:])
def test_init_params_builds_the_reference_tree(arch):
    """The port's own init of each config this slice ports: the reference's
    leaves (``frontend_proj`` among them), shapes and types, and the head's
    width n_classes for audio."""
    jcfg, cfg = _configs(arch)
    tp = M.init_params(cfg, torch.Generator().manual_seed(0))
    want = jax.eval_shape(lambda: JM.init_params(jax.random.PRNGKey(0), jcfg))
    got = jax.tree_util.tree_flatten_with_path(bridge.lm_params_to_numpy(tp))[0]
    want = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [jax.tree_util.keystr(p) for p, _ in got] == [jax.tree_util.keystr(p) for p, _ in want]
    assert [x.shape for _, x in got] == [tuple(x.shape) for _, x in want]
    assert all(x.dtype == torch.float32 for x in jax.tree.leaves(tp.tree))
    if cfg.frontend is not None:
        assert tp.frontend_proj.shape == (cfg.frontend_dim, cfg.d_model)
    if cfg.arch_type == "audio":
        assert tp.head.shape == (cfg.d_model, cfg.n_classes)


@pytest.mark.parametrize("arch", ["arctic_480b", "deepseek_v3_671b"])
def test_unported_archs_raise_naming_the_roadmap_item(arch):
    """The two configs that raised until ROADMAP item 12 (MoE and MLA) now
    build: the registry lists nothing as unported, and the smoke variant's
    init gives the reference's tree (experts, MLA, DeepSeek's dense prefix)."""
    assert registry.NOT_PORTED == {}
    jcfg, cfg = _configs(arch)
    tp = M.init_params(cfg, torch.Generator().manual_seed(0))
    want = jax.eval_shape(lambda: JM.init_params(jax.random.PRNGKey(0), jcfg))
    got = jax.tree_util.tree_flatten_with_path(bridge.lm_params_to_numpy(tp))[0]
    want = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [jax.tree_util.keystr(p) for p, _ in got] == [jax.tree_util.keystr(p) for p, _ in want]
    assert [x.shape for _, x in got] == [tuple(x.shape) for _, x in want]
    assert any(blk.is_moe for blk in tp.layers)
    assert ("w_uk" in tp.layers[0].attn) == (arch == "deepseek_v3_671b")


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
    """The kernels on CPU tensors raise; a one-process (1, 1) mesh runs
    the mesh path of prefill and decode (dense and MoE), equal to mesh=None
    bit for bit (every collective there is the identity)."""
    from repro_torch.launch.mesh import open_mesh
    from repro_torch.parallel import sharding as SH

    cfg = smoke_variant(registry.get_config("gemma2_2b"))
    tp = M.init_params(cfg, torch.Generator().manual_seed(0))
    toks = {"tokens": torch.zeros((1, 8), dtype=torch.long)}
    with pytest.raises(ValueError, match="use_kernel=True needs CUDA tensors"):
        M.prefill(tp, cfg, toks, use_kernel=True)
    mesh = open_mesh(device_type="cpu")
    moe_cfg = smoke_variant(registry.get_config("arctic_480b"))
    moe_lm = M.init_params(moe_cfg, torch.Generator().manual_seed(0))
    for c, lm in ((cfg, tp), (moe_cfg, moe_lm)):
        placed = SH.shard_tree(mesh, SH.param_specs(lm.tree), lm.tree)
        got = M.prefill(placed, c, toks, mesh=mesh)
        assert torch.equal(got.to_local(), M.prefill(lm, c, toks))
        cache, cache_m = M.init_cache(c, 1, 8, "cpu"), M.init_cache(c, 1, 8, "cpu", mesh=mesh)
        for pos in range(3):
            tok = toks["tokens"][:, pos:pos + 1] + pos
            want, _ = M.decode_step(lm, c, tok, pos, cache)
            got, _ = M.decode_step(placed, c, tok, pos, cache_m, mesh=mesh)
            assert torch.equal(got.to_local(), want)
    x = torch.randn((1, 8, moe_cfg.d_model), generator=torch.Generator().manual_seed(1))
    out, aux = moe.moe_ffn(moe_lm.layers[0].ffn, moe_cfg, x, mesh=mesh)
    want, want_aux = moe.moe_ffn(moe_lm.layers[0].ffn, moe_cfg, x)
    assert torch.equal(out, want) and torch.equal(aux, want_aux)


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

"""Parity of the port's routed MoE (`repro_torch.models.moe`) and of the MoE
models with the JAX reference, on the CPU.

The router, the sort-based dispatch and `moe_ffn_local` take the same numpy
inputs in both packages; the models are the reference's smoke variants of
Arctic-480B (128 -> 4 experts top-2 and the dense residual), DeepSeek-V3
(MLA, a dense prefix, 256 -> 4 experts top-2 and a shared expert) and
Jamba-1.5-Large with its experts (16 -> 4, MoE on every other layer),
initialised by the reference and bridged into the port
(`bridge.lm_params_from_numpy`).

Tolerances. Routing (expert ids, the dispatch tables, the gates) must be
identical. The MoE output in float32 at rtol 1e-5 with atol 1e-6 of its
scale (|y| reaches about 1300: the 3-D expert leaves' fan-in is E, 4, as
the reference's `dense_init` takes shape[0]), since the two packages sum
the expert products in other orders; in bf16 within the reference's own
spread over one-ulp copies of ``w_down`` (one bf16 ulp of the output).
Logits as in `tests/test_torch_mamba.py` (atol 4e-5, rtol 1e-4: Jamba's
float32 logits lie about 3.5e-5 apart); losses at rtol 1e-5 and gradients
at relative L2 1e-4 (`tests/test_torch_train.py`'s); greedy tokens
identical.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget_config
from repro.launch.serve import ServeLoop as JServeLoop
from repro.models import model as JM, moe as Jmoe
from repro.models.config import smoke_variant as jsmoke
from repro_torch import bridge
from repro_torch.checkpoint import io as ckpt
from repro_torch.configs import registry
from repro_torch.core.types import tree_leaves
from repro_torch.fl.federated import topk_sparsify
from repro_torch.launch import train as T
from repro_torch.launch.serve import ServeLoop
from repro_torch.models import layers as L, model as M, moe
from repro_torch.models.config import smoke_variant
from repro_torch.optim.optimizers import value_and_grad

torch.set_num_threads(1)
ARCHS = ("arctic_480b", "deepseek_v3_671b", "jamba_1_5_large_398b")
LOGIT_TOL = dict(atol=4e-5, rtol=1e-4)
LOSS_RTOL, GRAD_REL_L2 = 1e-5, 1e-4


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _configs(arch, **cut):
    return (jsmoke(jget_config(arch)).scaled(**cut),
            smoke_variant(registry.get_config(arch)).scaled(**cut))


_MODELS = {}


def _models(arch, **cut):
    """(jax cfg, jax params, port cfg, port LM) of one smoke arch, built once."""
    key = (arch, tuple(sorted(cut.items())))
    if key not in _MODELS:
        jcfg, cfg = _configs(arch, **cut)
        jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
        tp = bridge.lm_params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
        _MODELS[key] = (jcfg, jp, cfg, tp)
    return _MODELS[key]


def _moe_layer(arch, dtype="float32"):
    """(jax cfg, the reference's first MoE FFN, port cfg, the port's) of a
    smoke arch in ``dtype``: the same weights."""
    jcfg, jp, cfg, tp = _models(arch, dtype=dtype)
    stage, j = next((name, j) for name, _n, pat in M.stage_layout(cfg)
                    for j, (_kind, is_moe) in enumerate(pat) if is_moe)
    jffn = jax.tree.map(lambda a: a[0], jp["stages"][stage][f"b{j}"]["ffn"])
    blk = next(b for b in tp.layers if b.is_moe)
    return jcfg, jffn, cfg, blk.ffn


def _bf16_one_ulp(a, seed):
    """bf16 ``a`` with every entry moved one ulp up or down in magnitude."""
    bits = np.asarray(a).view(np.uint16).astype(np.int32)
    up = np.random.default_rng(seed).uniform(size=bits.shape) < 0.5
    return (bits + np.where(up, 1, -1)).astype(np.uint16).view(ml_dtypes.bfloat16)


# ---------------------------------------------------------------------------
# the router and the dispatch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_router_topk_matches_reference(seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((50, 32)).astype(np.float32)
    w_r = (rng.standard_normal((32, 8)) / np.sqrt(32)).astype(np.float32)
    jw, jids, jaux = Jmoe.router_topk(jnp.asarray(w_r), jnp.asarray(x), 3)
    w, ids, aux = moe.router_topk(torch.from_numpy(w_r), torch.from_numpy(x), 3)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-6, atol=1e-7)
    assert float(aux) == pytest.approx(float(jaux), rel=1e-6)


def test_router_topk_breaks_ties_like_the_reference():
    """A zero router gives every expert the same probability: the reference
    (`jax.lax.top_k`) picks the lowest ids, in order. Duplicated router
    columns tie pairs of experts on every token."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((40, 16)).astype(np.float32)
    dup = rng.standard_normal((16, 4)).astype(np.float32)
    for w_r in (np.zeros((16, 8), np.float32), np.concatenate([dup, dup], axis=1)):
        jw, jids, _ = Jmoe.router_topk(jnp.asarray(w_r), jnp.asarray(x), 3)
        w, ids, _ = moe.router_topk(torch.from_numpy(w_r), torch.from_numpy(x), 3)
        np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
        np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-5, atol=1e-7)
    zero_ids = moe.router_topk(torch.zeros((16, 8)), torch.from_numpy(x), 3)[1]
    assert (zero_ids == torch.arange(3)).all()


def _assignments(seed, T, E, k):
    """(ids (T, k): k distinct experts a token, skewed towards the low ids
    so that some overflow; weights (T, k))."""
    rng = np.random.default_rng(seed)
    p = np.linspace(2.0, 1.0, E)
    ids = np.stack([rng.choice(E, k, replace=False, p=p / p.sum()) for _ in range(T)])
    return ids.astype(np.int32), rng.uniform(size=(T, k)).astype(np.float32)


@pytest.mark.parametrize("capacity_factor", [0.5, 1.25])
def test_dispatch_tables_match_reference(capacity_factor):
    """The (E, C) token and gate tables, overflow included (at capacity
    factor 0.5, as tests/test_distributed_equivalence.py drops tokens), and
    each assignment's slot (E * C: dropped) against the tables."""
    T, E, k = 48, 6, 2
    ids, w = _assignments(4, T, E, k)
    C = max(int(capacity_factor * k * T / E), k)
    jtok, jgate = Jmoe._dispatch_tables(jnp.asarray(ids), jnp.asarray(w), E, C)
    tok, gate, slot_of = moe._dispatch_tables(torch.from_numpy(ids).long(), torch.from_numpy(w), E, C)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    np.testing.assert_array_equal(gate.numpy(), np.asarray(jgate))
    slots = slot_of.numpy()
    kept = slots < E * C
    dropped = sum(max(0, int((ids == e).sum()) - C) for e in range(E))
    assert int((~kept).sum()) == dropped
    assert (dropped > 0) == (capacity_factor < 1.0)
    t_of = np.repeat(np.arange(T), k).reshape(T, k)
    np.testing.assert_array_equal(tok.numpy().reshape(-1)[slots[kept]], t_of[kept])
    np.testing.assert_array_equal(gate.numpy().reshape(-1)[slots[kept]], w[kept])


def test_capacity_follows_the_references_arithmetic():
    """capacity_factor * top_k * T / E in Python floats, at least top_k: at
    decode (T = the batch's slots) the floor applies."""
    cfg = registry.get_config("deepseek_v3_671b")
    assert moe.capacity_of(cfg, 4096, 256) == int(1.25 * 8 * 4096 / 256) == 160
    assert moe.capacity_of(cfg, 4, 256) == cfg.top_k == 8
    assert moe.capacity_of(cfg, 4096, 256, size=64) == int(1.25 * 8 * 4096 * 64 / 256)
    arctic = registry.get_config("arctic_480b")
    assert moe.capacity_of(arctic, 4096, 128) == 80 and moe.capacity_of(arctic, 4, 128) == 2


def test_combine_sums_in_the_references_scatter_order():
    """In bf16 each add rounds, so the order of a token's contributions
    shows: the combine equals a sequential scatter-add in (E, C) order
    (the CPU's `index_add_`), bit for bit, empty slots (token 0, gate 0)
    included."""
    T, E, k, d = 40, 5, 3, 16
    ids, w = _assignments(5, T, E, k)
    C = max(int(0.75 * k * T / E), k)
    tok, gate, slot_of = moe._dispatch_tables(torch.from_numpy(ids).long(), torch.from_numpy(w), E, C)
    y = (torch.randn((E, C, d), generator=torch.Generator().manual_seed(0)) * 100).bfloat16()
    y = y * gate[..., None].bfloat16()
    want = torch.zeros((T, d), dtype=torch.bfloat16)
    for i, t in enumerate(tok.reshape(-1).tolist()):
        want[t] += y.reshape(-1, d)[i]
    got = moe._combine(y, slot_of, torch.bfloat16)
    assert torch.equal(got, want)
    assert not torch.equal(got, y.float().reshape(-1, d).new_zeros((T, d)).index_add_(
        0, tok.reshape(-1).long(), y.float().reshape(-1, d)).bfloat16())


# ---------------------------------------------------------------------------
# the MoE layer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("expert_slice", [None, (1, 2)], ids=["all", "slice"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["arctic_480b", "deepseek_v3_671b"])
def test_moe_ffn_local_matches_reference(arch, dtype, expert_slice):
    """64 tokens through one MoE layer (with Arctic's dense residual or
    DeepSeek's shared expert), over every expert or as the shard that
    computes experts 1-2 of 4: the same routing, the output within the
    module's tolerances, the same aux term."""
    jcfg, jffn, cfg, ffn = _moe_layer(arch, dtype)
    x = np.random.default_rng(6).standard_normal((64, cfg.d_model)).astype(np.float32)
    jx, tx = jnp.asarray(x).astype(dtype), torch.from_numpy(x).to(getattr(torch, dtype))
    kw = {}
    if expert_slice is not None:             # a shard holds its experts' stacks only
        lo, size = expert_slice
        kw = dict(expert_slice=expert_slice, n_total_experts=cfg.n_experts)
        cut = lambda p: {k: v[lo:lo + size] if k in ("w_gate", "w_up", "w_down") else v
                         for k, v in p.items()}
        jffn, ffn = cut(jffn), cut(ffn)
    ref = jax.jit(lambda p, x: Jmoe.moe_ffn_local(p, jcfg, x, **kw))
    want, jaux = ref(jffn, jx)
    got, aux = moe.moe_ffn_local(ffn, cfg, tx, **kw)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    jids = Jmoe.router_topk(jffn["router"], jx, jcfg.top_k)[1]
    np.testing.assert_array_equal(moe.router_topk(ffn["router"], tx, cfg.top_k)[1].numpy(), np.asarray(jids))
    assert float(aux) == pytest.approx(float(jaux), rel=1e-5)
    want, got = _np(want), _np(got)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * np.abs(want).max())
        return
    spread = max(float(np.abs(_np(ref(dict(jffn, w_down=jnp.asarray(_bf16_one_ulp(jffn["w_down"], s))),
                                          jx)[0]) - want).max()) for s in range(3))
    assert 0 < np.abs(got - want).max() <= spread


def test_a_shard_computes_its_experts_kept_assignments():
    """The shard of experts 2-3 of 4 (its stacks only): the shared expert
    plus, per token, its kept assignments to those two experts (the first
    ``capacity`` of each, in token order) times their gates, summed
    directly (the per-token oracle)."""
    _, _, cfg, ffn = _moe_layer("deepseek_v3_671b")
    x = torch.from_numpy(np.random.default_rng(7).standard_normal((32, cfg.d_model)).astype(np.float32))
    shard = {k: v[2:] if k in ("w_gate", "w_up", "w_down") else v for k, v in ffn.items()}
    got, _ = moe.moe_ffn_local(shard, cfg, x, expert_slice=(2, 2), n_total_experts=4)
    w, ids, _ = moe.router_topk(ffn["router"], x, cfg.top_k)
    C = moe.capacity_of(cfg, 32, 4, 2)
    want = moe.dense_ffn(ffn["shared"], cfg, x)
    for e in (2, 3):
        rows = [(t, float(w[t, j])) for t in range(32) for j in range(cfg.top_k) if ids[t, j] == e][:C]
        for t, g in rows:
            h = x[t] @ ffn["w_gate"][e]
            want[t] += (torch.nn.functional.silu(h) * (x[t] @ ffn["w_up"][e])) @ ffn["w_down"][e] * g
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6 * float(want.abs().max()))


def test_moe_under_a_mesh_raises_naming_item_11b():
    _, _, cfg, ffn = _moe_layer("arctic_480b")
    x = torch.zeros((1, 4, cfg.d_model))
    with pytest.raises(NotImplementedError, match=r"ROADMAP\.md §1, item 11b"):
        moe.moe_ffn(ffn, cfg, x, mesh=object())
    with pytest.raises(NotImplementedError, match=r"ROADMAP\.md §1, item 11b"):
        moe.moe_ffn_2d(ffn, cfg, x, mesh=object())
    out, aux = moe.moe_ffn(ffn, cfg, x)
    assert out.shape == x.shape and aux.shape == ()


# ---------------------------------------------------------------------------
# init, the bridge, checkpoints and sparsification
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_builds_the_reference_tree_with_experts(arch, monkeypatch):
    """The port's own init: the reference's leaves, shapes and types, the
    router float32 in a bf16 model, the expert stacks of the reference's
    law (std 1/sqrt(E): fan-in shape[0]), drawn into their slots a few
    experts at a time (a small `DRAW_CHUNK` forces it) with no entry left
    unwritten."""
    jcfg, cfg = _configs(arch, dtype="bfloat16")
    monkeypatch.setattr(L, "DRAW_CHUNK", 3 * cfg.d_model * cfg.moe_d_ff)
    tp = M.init_params(cfg, torch.Generator().manual_seed(0))
    want = jax.tree_util.tree_flatten_with_path(
        jax.eval_shape(lambda: JM.init_params(jax.random.PRNGKey(0), jcfg)))[0]
    got = jax.tree_util.tree_flatten_with_path(tp.tree)[0]
    assert [jax.tree_util.keystr(p) for p, _ in got] == [jax.tree_util.keystr(p) for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape) and str(g.dtype).removeprefix("torch.") == str(w.dtype), \
            jax.tree_util.keystr(path)
    for ffn in (blk.ffn for blk in tp.layers if blk.is_moe):
        assert ffn["router"].dtype == torch.float32 and ffn["w_gate"].dtype == torch.bfloat16
        for name in ("w_gate", "w_up", "w_down"):
            leaf = ffn[name].float()
            assert (leaf != 0).float().mean() > 0.999, name
            assert abs(float(leaf.std()) * cfg.n_experts ** 0.5 - 1.0) < 0.05, name


def test_bridge_keeps_the_router_float32_in_a_bf16_model():
    jcfg, cfg = _configs("arctic_480b", dtype="bfloat16")
    tree = jax.tree.map(np.asarray, JM.init_params(jax.random.PRNGKey(1), jcfg))
    tp = bridge.lm_params_from_numpy(tree, cfg, device="cpu")
    ffn = tp.layers[0].ffn
    assert ffn["router"].dtype == torch.float32
    assert ffn["w_gate"].dtype == ffn["dense_res"]["w_gate"].dtype == torch.bfloat16
    back = jax.tree_util.tree_flatten_with_path(bridge.lm_params_to_numpy(tp))[0]
    for (p1, a), (p2, b) in zip(back, jax.tree_util.tree_flatten_with_path(tree)[0], strict=True):
        assert p1 == p2
        np.testing.assert_array_equal(a, np.asarray(b, np.float32))


def test_checkpoint_and_sparsify_take_the_moe_tree(tmp_path):
    """`checkpoint.io` restores the bf16 MoE tree exactly, the router in
    float32; `topk_sparsify` keeps every leaf's layout and type and about
    its share of each expert stack."""
    _, cfg = _configs("deepseek_v3_671b", dtype="bfloat16")
    tree = M.init_params(cfg, torch.Generator().manual_seed(2)).tree
    ckpt.save(str(tmp_path / "moe.npz"), tree)
    back = ckpt.restore(str(tmp_path / "moe.npz"), tree)
    for a, b in zip(tree_leaves(back), tree_leaves(tree), strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)
    sparse = topk_sparsify(tree, 0.25)
    for a, b in zip(tree_leaves(sparse), tree_leaves(tree), strict=True):
        assert a.dtype == b.dtype and a.shape == b.shape
    w_up = sparse["stages"]["main"]["b0"]["ffn"]["w_up"]
    assert 0.24 <= float((w_up != 0).float().mean()) <= 0.26
    assert sparse["stages"]["main"]["b0"]["ffn"]["router"].dtype == torch.float32


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_and_aux_match_reference(arch):
    """S = 160 (not a chunk multiple): logits and the summed aux term."""
    jcfg, jp, cfg, tp = _models(arch)
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (2, 160))
    want, jaux = jax.jit(lambda p, t: JM.forward(p, jcfg, {"tokens": t}))(jp, jnp.asarray(toks))
    got, aux = M.forward(tp, cfg, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(_np(got), _np(want), **LOGIT_TOL)
    assert float(aux) == pytest.approx(float(jaux), rel=1e-5)
    n_moe = sum(m for _k, m in M.layer_layout(cfg))
    assert n_moe == {"arctic_480b": 2, "deepseek_v3_671b": 2, "jamba_1_5_large_398b": 8}[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_logits_match_reference(arch):
    """40 cached decode steps (MoE routing of the batch's 2 tokens a step,
    capacity at its top_k floor); the last equals the prefill's last
    position where the prefill drops none of the sequence's assignments."""
    jcfg, jp, cfg, tp = _models(arch)
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (2, 40))
    jcache = JM.init_cache(jcfg, 2, 48)
    cache = M.init_cache(cfg, 2, 48, "cpu")
    step = jax.jit(lambda p, t, pos, c: JM.decode_step(p, jcfg, t, pos, c))
    for pos in range(40):
        t = toks[:, pos:pos + 1]
        want, jcache = step(jp, jnp.asarray(t, jnp.int32), jnp.int32(pos), jcache)
        got, cache = M.decode_step(tp, cfg, torch.from_numpy(t), pos, cache)
        np.testing.assert_allclose(_np(got), _np(want), err_msg=f"pos {pos}", **LOGIT_TOL)
    # the prefill routes all 80 tokens at once, capacity 50 an expert: the
    # second sequence's tokens come later in the flat order and may be
    # dropped, the first's 40 (at most 40 assignments an expert) never are
    full = M.prefill(tp, cfg, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(_np(got)[0, 0], _np(full)[0, -1], **LOGIT_TOL)


def _batch(cfg, seed, B=2, S=32):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab, (B, S + 1))
    return ({"tokens": jnp.asarray(toks[:, :-1], jnp.int32), "labels": jnp.asarray(toks[:, 1:], jnp.int32)},
            {"tokens": torch.from_numpy(toks[:, :-1]), "labels": torch.from_numpy(toks[:, 1:])})


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_with_the_aux_term_and_grads_match_reference(arch):
    """`loss_fn` adds 0.01 * aux / n_layers; the loss and every gradient
    leaf (the float32 router's through the aux term and the gates among
    them) against `jax.value_and_grad`."""
    jcfg, jp, cfg, tp = _models(arch)
    jb, tb = _batch(cfg, 0)
    jloss, jgrads = jax.value_and_grad(lambda p: JM.loss_fn(p, jcfg, jb))(jp)
    loss, grads = value_and_grad(lambda p: M.loss_fn(p, cfg, tb), tp.tree)
    assert float(loss) == pytest.approx(float(jloss), rel=LOSS_RTOL)
    with torch.no_grad():
        logits, aux = M.forward(tp, cfg, tb)
        ce = L.cross_entropy(logits, tb["labels"])
    assert float(aux) > 0
    assert float(loss) == pytest.approx(float(ce + 0.01 * aux / cfg.n_layers), rel=1e-6)
    want = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    got = jax.tree_util.tree_flatten_with_path(bridge.lm_params_to_numpy(grads))[0]
    assert [jax.tree_util.keystr(p) for p, _ in got] == [jax.tree_util.keystr(p) for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        w = np.asarray(w)
        rel = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)
        assert np.all(np.isfinite(g)) and rel <= GRAD_REL_L2, f"{arch} {jax.tree_util.keystr(path)}: {rel:.3g}"


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gives_identical_grads_and_the_train_step_learns(arch):
    """Recomputing each period in the backward pass changes nothing (the
    dispatch is deterministic); three AdamW steps on one batch lower the
    loss and keep the router float32 in a bf16 model."""
    _, _, cfg, tp = _models(arch)
    _, tb = _batch(cfg, 1)
    tree = bridge.lm_tree_from_numpy(bridge.lm_params_to_numpy(tp), cfg, device="cpu")
    l1, g1 = value_and_grad(lambda p: M.loss_fn(p, cfg, tb, remat=True), tree)
    l0, g0 = value_and_grad(lambda p: M.loss_fn(p, cfg, tb, remat=False), tree)
    assert torch.equal(l1, l0)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(g1), tree_leaves(g0)))
    bcfg = cfg.scaled(dtype="bfloat16")
    state = T.init_state(bcfg, torch.Generator().manual_seed(3), 1e-3)
    step = T.build_train_step(bcfg, lr=1e-3)
    losses = []
    for _ in range(3):
        state, m = step(state, tb)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]
    ffn = M.LM(bcfg, state.params).layers[-1].ffn
    assert ffn["router"].dtype == torch.float32 and ffn["w_down"].dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ["arctic_480b", "deepseek_v3_671b"])
def test_serve_loop_tokens_match_reference(arch):
    jcfg, jp, cfg, tp = _models(arch)
    prompts = [list(map(int, np.random.default_rng(i).integers(0, cfg.vocab, 4))) for i in range(5)]
    want, _ = JServeLoop(jcfg, jp, 2, max_len=64).run([list(p) for p in prompts], 6)
    got, stats = ServeLoop(cfg, tp, 2, max_len=64).run([list(p) for p in prompts], 6)
    assert got == {k: [int(t) for t in v] for k, v in want.items()}
    assert set(got) == set(range(5)) and stats["steps"] > 0

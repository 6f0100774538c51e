"""The port's meshes (`repro_torch.parallel`, the mesh paths of
`repro_torch.models`, `launch.train`, `launch.serve`, `launch.op_cost`)
against the JAX reference's, on the CPU.

Specs: the port's `param_specs` equals the reference's leaf for leaf, for
all ten configs at smoke width; sanitize, batch, cache and optimizer specs
match on the reference's own cases (`tests/test_parallel.py`).

Cost: `OpCost` counts the reference's seven-matmul loop exactly and within
5% of `hlo_cost` on the reference's lowering; on a fake process group
(`tests/torch_mesh_worker.py --fake`, its own process) it counts the
reference's 65,536 collective bytes for the 4-way sharded product, and a
smoke Qwen2.5 train step's per-device dot FLOPs on a (2, 2) mesh within 5%
of `hlo_cost` on the reference's (2, 2) lowering.

The mesh paths: one spawn of four gloo processes on a (2, 2) ("data",
"model") mesh (`tests/torch_mesh_worker.py`) runs every case from the same
numpy inputs as the reference on its four host devices, and is held to the
reference's distributed result: the vocab-sharded cross-entropy (value
rtol 1e-5, gradient atol 1e-5 / rtol 1e-4, the reference's own test's;
no all-gather of the logits), expert-parallel MoE in the ``ep`` and ``2d``
layouts with drops (rtol 2e-4, the reference's, and atol 1e-6 of the
output's scale, the single-device MoE parity law; aux rtol 1e-5), prefill logits of five
archs (atol 4e-5, rtol 1e-4, as the single-device parity tests), greedy
`ServeLoop` tokens (identical), and one train step of Qwen2.5-3B and
Jamba-1.5-Large (the reference's `test_mini_pjit_train_step` archs and
variants), as placed by `param_specs` and again with the layers' leaves
FSDP-sharded on 'data': loss rtol 1e-5, grad_norm rtol 1e-4, each leaf's
gradient (from AdamW's first moment) entry by entry at atol 1e-5 / rtol
1e-4 (Jamba's at relative L2 1e-4 a leaf), parameters finite, moved, and
within 2 lr of the reference's entry by entry.
"""
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from repro.configs.registry import get_config as jget_config, list_archs
from repro.launch import hlo_cost
from repro.launch import train as JT
from repro.launch.serve import ServeLoop as JServeLoop
from repro.models import model as JM, moe as Jmoe
from repro.models.config import smoke_variant as jsmoke
from repro.models.layers import cross_entropy as jcross_entropy
from repro.parallel import sharding as JSH
from repro_torch.configs import registry
from repro_torch.launch import op_cost
from repro_torch.models import model as M
from repro_torch.models.config import smoke_variant
from repro_torch.models.layers import ShapesOnly
from repro_torch.optim.optimizers import OptState
from repro_torch.parallel import sharding as SH

torch.set_num_threads(1)
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_mesh_worker.py")
LR = 1e-3
LOGIT_TOL = dict(atol=4e-5, rtol=1e-4)
#: the archs whose prefill and decode run on the (2, 2) mesh, and their cuts
#: (Jamba's Mamba and MoE layers run in its train step below)
PREFILL = {"gemma2_2b": {}, "rwkv6_1_6b": {}, "deepseek_v3_671b": {}, "hubert_xlarge": {},
           "pixtral_12b": {}}
SERVE = ("gemma2_2b", "rwkv6_1_6b", "deepseek_v3_671b")
#: the reference's `test_mini_pjit_train_step` archs and variants
TRAIN = {"qwen2_5_3b": {}, "jamba_1_5_large_398b": dict(n_experts=4, top_k=2)}
#: the train steps run again with the layers' leaves FSDP-sharded on 'data'
FSDP = tuple(TRAIN)
#: each leaf's gradient against the reference's: entry by entry, except
#: Jamba's, whose step-0 gradients agree to 1.5e-5 relative L2 (ROADMAP.md
#: §3) and so are held leaf by leaf at `tests/test_torch_train.py`'s
#: relative L2 1e-4
GRAD_ATOL, GRAD_RTOL, GRAD_REL_L2 = 1e-5, 1e-4, 1e-4
GRAD_BY_NORM = ("jamba_1_5_large_398b",)


class _Shape:
    """A mesh's axis names and sizes: all that the spec functions read."""

    def __init__(self, sizes: dict):
        self.mesh_dim_names = tuple(sizes)
        self._sizes = list(sizes.values())

    def size(self, i=None):
        return self._sizes[i]


def _jmesh():
    if len(jax.devices()) < 4:
        pytest.skip("need 4 host devices")
    return jax.sharding.Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("data", "model"))


def _jspecs(tree) -> dict:
    """{path of dict keys: spec tuple} of a reference spec pytree."""
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, P))[0]
    return {tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path): tuple(spec)
            for path, spec in flat}


def _specs(tree) -> dict:
    out = {}
    SH._map_with_path(lambda path, spec: out.__setitem__(path, tuple(spec)), tree)
    return out


def _configs(arch, **cut):
    return jsmoke(jget_config(arch)).scaled(**cut), smoke_variant(registry.get_config(arch)).scaled(**cut)


# ---------------------------------------------------------------------------
# sharding rules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", list_archs())
def test_param_specs_match_reference(arch):
    jcfg, cfg = _configs(arch)
    jparams = jax.eval_shape(lambda: JM.init_params(jax.random.PRNGKey(0), jcfg))
    want = _jspecs(JSH.param_specs(jparams))
    got = {}
    SH._map_with_path(lambda path, x, spec: got.__setitem__(path, spec),
                      M.init_params(cfg, ShapesOnly()).tree,
                      SH.param_specs(M.init_params(cfg, ShapesOnly()).tree))
    assert got == want


def test_sanitize_batch_and_opt_specs_match_reference():
    jmesh, mesh = _jmesh(), _Shape({"data": 2, "model": 2})
    for shape in ((4, 7), (4, 8), (3, 8), (6, 6)):
        for spec in ((None, "model"), ("data", "model"), (("data", "model"), None)):
            tree = {"w": jax.ShapeDtypeStruct(shape, jnp.float32)}
            want = tuple(JSH.sanitize_specs(jmesh, {"w": P(*spec)}, tree)["w"])
            assert SH.sanitize_specs(mesh, {"w": spec}, {"w": torch.empty(shape, device="meta")})["w"] == want
    batch = {"tokens": (4, 16), "one": (1, 16), "embeds": (4, 16, 8), "scalar": ()}
    want = JSH.batch_specs(jmesh, {k: jax.ShapeDtypeStruct(s, jnp.float32) for k, s in batch.items()})
    got = SH.batch_specs(mesh, {k: torch.empty(s, device="meta") for k, s in batch.items()})
    assert {k: tuple(v) for k, v in want.items()} == got
    jcfg, cfg = _configs("qwen2_5_3b")
    jparams = jax.eval_shape(lambda: JM.init_params(jax.random.PRNGKey(0), jcfg))
    jopt = JT.init_state(jax.random.PRNGKey(0), jcfg).opt
    jo = JSH.opt_state_specs(jopt, jparams)
    tree = M.init_params(cfg, ShapesOnly()).tree
    o = SH.opt_state_specs(OptState(torch.zeros(()), tree, tree), tree)
    assert o.step == tuple(jo.step) == ()
    assert _specs(o.mu) == _jspecs(jo.mu) and _specs(o.nu) == _jspecs(jo.nu)


@pytest.mark.parametrize("arch", ["gemma2_2b", "rwkv6_1_6b", "jamba_1_5_large_398b", "deepseek_v3_671b"])
@pytest.mark.parametrize("batch", [4, 1])
def test_cache_specs_match_reference(arch, batch):
    """The port's per-layer cache against the reference's period-stacked
    one: each layer's spec is the reference's without its period axis."""
    jmesh, mesh = _jmesh(), _Shape({"data": 2, "model": 2})
    jcfg, cfg = _configs(arch)
    jcache = jax.eval_shape(lambda: JM.init_cache(jcfg, batch, 32))
    want = _jspecs(JSH.cache_specs(jmesh, jcache))
    got = SH.cache_specs(mesh, M.init_cache(cfg, batch, 32, "meta"))
    layer = 0
    for name, n_periods, pat in M.stage_layout(cfg):
        for _ in range(n_periods):
            for j in range(len(pat)):
                for leaf, spec in got[layer].items():
                    assert (None,) + spec == want[(name, f"b{j}", leaf)], (layer, leaf)
                layer += 1


# ---------------------------------------------------------------------------
# cost counters
# ---------------------------------------------------------------------------

def test_op_cost_counts_loop_flops_exactly_and_as_hlo_cost():
    def f(a, ws):
        return jax.lax.scan(lambda c, w: (c @ w, ()), a, ws)[0]

    txt = jax.jit(f).lower(jax.ShapeDtypeStruct((256, 256), jnp.float32),
                           jax.ShapeDtypeStruct((7, 256, 256), jnp.float32)).compile().as_text()
    a, ws = torch.randn(256, 256), torch.randn(7, 256, 256)
    with op_cost.OpCost() as c:
        for w in ws:
            a = a @ w
    assert c.flops == 7 * 2 * 256**3
    np.testing.assert_allclose(c.flops, hlo_cost.analyze(txt)["flops"], rtol=0.05)


def _run_worker(tmp_path, cases, *flags, timeout=600):
    with open(tmp_path / "cases.pkl", "wb") as f:
        pickle.dump(cases, f)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, WORKER, *flags, str(tmp_path)], capture_output=True,
                       text=True, timeout=timeout, env=env)
    assert r.returncode == 0, r.stderr[-4000:]
    with open(tmp_path / "out.pkl", "rb") as f:
        out = pickle.load(f)
    for name, o in out.items():
        assert "error" not in o, f"{name}: {o['error']}"
    return out


def _reference_train(jcfg, jmesh, batch):
    """The reference's (2, 2) train step, as its `test_mini_pjit_train_step`
    runs it: (the initial state, the step's jitted function)."""
    state = JT.init_state(jax.random.PRNGKey(0), jcfg, lr=LR)
    pspecs = JSH.sanitize_specs(jmesh, JSH.param_specs(state.params), state.params)
    ospecs = JSH.opt_state_specs(state.opt, state.params)
    ospecs = type(ospecs)(step=ospecs.step, mu=JSH.sanitize_specs(jmesh, ospecs.mu, state.params),
                          nu=JSH.sanitize_specs(jmesh, ospecs.nu, state.params))
    ns = lambda t: jax.tree.map(lambda s: NamedSharding(jmesh, s), t)
    step = jax.jit(JT.build_train_step(jcfg, mesh=jmesh, lr=LR),
                   in_shardings=(JT.TrainState(ns(pspecs), ns(ospecs)), ns(JSH.batch_specs(jmesh, batch))))
    return state, step


def test_op_cost_on_a_fake_mesh_matches_the_reference(tmp_path):
    """The 4-way sharded product's all-reduce, 2 x (64, 128) float32; and
    a smoke Qwen2.5 train step's per-device dot FLOPs on (2, 2)."""
    jmesh = _jmesh()
    xs, ws = jax.ShapeDtypeStruct((64, 256), jnp.float32), jax.ShapeDtypeStruct((256, 128), jnp.float32)
    mesh4 = jax.sharding.Mesh(np.asarray(jax.devices()[:4]), ("d",))
    ns = lambda s: NamedSharding(mesh4, s)
    txt = jax.jit(lambda x, w: x @ w, in_shardings=(ns(P(None, "d")), ns(P("d", None)))).lower(
        xs, ws).compile().as_text()
    want_bytes = hlo_cost.analyze(txt)["collective_bytes"]
    jcfg, _ = _configs("qwen2_5_3b")
    toks = jax.random.randint(jax.random.PRNGKey(1), (4, 17), 0, jcfg.vocab)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    state, step = _reference_train(jcfg, jmesh, batch)
    with jmesh:
        want_flops = hlo_cost.analyze(step.lower(state, batch).compile().as_text())["flops"]
    out = _run_worker(tmp_path, {"product": dict(kind="product"),
                                 "train": dict(kind="train_cost", arch="qwen2_5_3b", batch=4, seq=16)},
                      "--fake")
    assert out["product"]["collective_bytes"] == want_bytes == 65536
    assert out["product"]["collective_counts"] == {"all_reduce": 1}
    np.testing.assert_allclose(out["train"]["flops"], want_flops, rtol=0.05)


# ---------------------------------------------------------------------------
# the mesh paths on a spawned (2, 2) gloo mesh
# ---------------------------------------------------------------------------

def _np_tree(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


def _jleaves(tree) -> dict:
    """{path of dict keys: float32 array} of a reference pytree."""
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {tuple(k.key for k in path): np.asarray(x, np.float32) for path, x in flat}


def _prefill_batch(cfg, rng, B=4, S=16):
    if cfg.frontend == "audio":
        return {"frame_embeds": rng.standard_normal((B, S, cfg.frontend_dim)).astype(np.float32)}
    out = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.frontend == "vision":
        out["patch_embeds"] = rng.standard_normal((B, S // 4, cfg.frontend_dim)).astype(np.float32)
    return out


def _jbatch(batch):
    bf16 = ("frame_embeds", "patch_embeds")
    return {k: jnp.asarray(v).astype(jnp.bfloat16) if k in bf16 else jnp.asarray(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    """Every (2, 2) case, its reference result and the port's, from one
    spawn: {name: (want, got)}."""
    jmesh = _jmesh()
    cases, want = {}, {}
    rng = np.random.default_rng(0)

    # the vocab-sharded cross-entropy
    logits = rng.standard_normal((4, 8, 64)).astype(np.float32)
    labels = rng.integers(0, 64, (4, 8)).astype(np.int64)
    labels[0, 0] = -1
    ce = lambda lg: JM._sharded_cross_entropy(lg, jnp.asarray(labels), jmesh)
    with jmesh:
        value, grad = jax.value_and_grad(ce)(jnp.asarray(logits))
    cases["ce"] = dict(kind="ce", logits=logits, labels=labels)
    want["ce"] = dict(loss=float(value), grad=np.asarray(grad),
                      plain=float(jcross_entropy(jnp.asarray(logits), jnp.asarray(labels))))

    # expert-parallel MoE, both layouts, with the default capacity (drops)
    for layout in ("ep", "2d"):
        cut = dict(n_experts=4, top_k=2, n_shared_experts=1, moe_2d=layout == "2d")
        jcfg, _ = _configs("deepseek_v3_671b", **cut)
        p = Jmoe.init_moe_params(jax.random.PRNGKey(0), jcfg, jnp.float32)
        x = rng.standard_normal((4, 8, jcfg.d_model)).astype(np.float32)
        with jmesh:
            out, aux = jax.jit(lambda p, x: Jmoe.moe_ffn(p, jcfg, x, mesh=jmesh))(p, jnp.asarray(x))
        cases[f"moe_{layout}"] = dict(kind="moe", arch="deepseek_v3_671b", cut=cut, params=_np_tree(p), x=x)
        want[f"moe_{layout}"] = dict(out=np.asarray(out), aux=float(aux))

    # prefill and greedy decode
    for arch, cut in PREFILL.items():
        jcfg, cfg = _configs(arch, **cut)
        jp = jax.jit(JM.init_params, static_argnums=1)(jax.random.PRNGKey(0), jcfg)   # one compile
        batch = _prefill_batch(cfg, rng)
        with jmesh:
            logits = jax.jit(lambda p, b: JM.prefill(p, jcfg, b, mesh=jmesh))(jp, _jbatch(batch))
        cases[f"prefill_{arch}"] = dict(kind="prefill", arch=arch, cut=cut, params=_np_tree(jp), batch=batch)
        want[f"prefill_{arch}"] = dict(logits=np.asarray(logits, np.float32))
        if arch in SERVE:
            requests = rng.integers(0, cfg.vocab, (4, 3)).tolist()
            with jmesh:
                results, _ = JServeLoop(jcfg, jp, 4, 16, mesh=jmesh).run(requests, 4)
            cases[f"serve_{arch}"] = dict(kind="serve", arch=arch, cut=cut, params=_np_tree(jp), slots=4,
                                          max_len=16, requests=requests, max_new=4)
            want[f"serve_{arch}"] = dict(results={k: [int(t) for t in v] for k, v in results.items()})

    # one train step
    for arch, cut in TRAIN.items():
        jcfg, _ = _configs(arch, **cut)
        toks = jax.random.randint(jax.random.PRNGKey(1), (4, 17), 0, jcfg.vocab)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        state, step = _reference_train(jcfg, jmesh, batch)
        with jmesh:
            state2, metrics = step(state, batch)
        cases[f"train_{arch}"] = dict(kind="train", arch=arch, cut=cut, params=_np_tree(state.params),
                                      batch={k: np.asarray(v) for k, v in batch.items()}, lr=LR)
        want[f"train_{arch}"] = dict(loss=float(metrics["loss"]), grad_norm=float(metrics["grad_norm"]),
                                     before=_jleaves(state.params), params=_jleaves(state2.params),
                                     mu=_jleaves(state2.opt.mu))
        if arch in FSDP:
            cases[f"train_{arch}_fsdp"] = dict(cases[f"train_{arch}"], fsdp=True)
            want[f"train_{arch}_fsdp"] = want[f"train_{arch}"]

    got = _run_worker(tmp_path_factory.mktemp("mesh"), cases)
    return {name: (want[name], got[name]) for name in cases}


def test_sharded_cross_entropy_matches_reference(mesh_run):
    want, got = mesh_run["ce"]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["loss"], want["plain"], rtol=1e-5)
    np.testing.assert_allclose(got["grad"], want["grad"], atol=1e-5, rtol=1e-4)
    # only (B, S) statistics cross ranks: all-reduces, no gather of the logits
    assert got["comm"] and all("all_reduce" in k for k in got["comm"]), got["comm"]


@pytest.mark.parametrize("layout", ["ep", "2d"])
def test_moe_on_a_mesh_matches_reference(mesh_run, layout):
    want, got = mesh_run[f"moe_{layout}"]
    # atol: 1e-6 of the output's scale, the single-device MoE parity law
    # (tests/test_torch_moe.py): the two frameworks sum these ~1e3 products
    # in other orders, by a few ulps
    scale = float(np.abs(want["out"]).max())
    np.testing.assert_allclose(got["out"], want["out"], atol=1e-6 * scale, rtol=2e-4)
    np.testing.assert_allclose(got["aux"], want["aux"], rtol=1e-5)


@pytest.mark.parametrize("arch", list(PREFILL))
def test_prefill_on_a_mesh_matches_reference(mesh_run, arch):
    want, got = mesh_run[f"prefill_{arch}"]
    np.testing.assert_allclose(got["logits"], want["logits"], **LOGIT_TOL)


@pytest.mark.parametrize("arch", SERVE)
def test_serve_on_a_mesh_matches_reference(mesh_run, arch):
    want, got = mesh_run[f"serve_{arch}"]
    assert got["results"] == want["results"]
    # sampled tokens: every rank draws the same, each in the vocabulary
    vocab = _configs(arch)[1].vocab
    assert got["sampled_alike"] and sorted(got["sampled"]) == sorted(want["results"])
    assert all(0 <= t < vocab and len(v) == 4 for v in got["sampled"].values() for t in v)


def _gradient(mu, grad_norm):
    """The unclipped gradient from the first moment after one step from
    zero: mu = (1 - b1) x the gradient clipped to norm 1."""
    return mu / (0.1 * min(1.0, 1.0 / max(grad_norm, 1e-9)))


@pytest.mark.parametrize("arch", list(TRAIN) + [f"{a}_fsdp" for a in FSDP])
def test_train_step_on_a_mesh_matches_reference(mesh_run, arch):
    """Loss and grad_norm; each leaf's gradient (from the step's first
    moment) against the reference's, so that a leaf's shards assembled in
    the wrong order or with the wrong sum show; and the parameters finite,
    moved, and within 2 lr of the reference's (AdamW's first step moves
    every entry by about lr whatever the gradient)."""
    want, got = mesh_run[f"train_{arch}"]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=1e-4)
    assert set(got["params"]) == set(want["params"]) == set(got["mu"])
    if arch.endswith("_fsdp"):
        assert got["fsdp_leaves"] > 0
    moved = 0.0
    for path, new in got["params"].items():
        assert np.isfinite(new).all(), path
        g = _gradient(got["mu"][path], got["grad_norm"])
        w = _gradient(want["mu"][path], want["grad_norm"])
        if arch.removesuffix("_fsdp") in GRAD_BY_NORM:
            rel = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)
            assert rel <= GRAD_REL_L2, f"{path}: relative L2 {rel:.3g}"
        else:
            np.testing.assert_allclose(g, w, atol=GRAD_ATOL, rtol=GRAD_RTOL, err_msg=str(path))
        np.testing.assert_allclose(new, want["params"][path], atol=2 * LR, rtol=0, err_msg=str(path))
        moved += float(np.abs(new - want["before"][path]).sum())
    assert moved > 0

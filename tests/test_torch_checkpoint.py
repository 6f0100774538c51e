"""The port's tree checkpoints (`repro_torch.checkpoint.io`) and their
interchange with the reference's (`repro.checkpoint.io`), on the CPU.

A round trip restores every leaf bit for bit, in its type (bfloat16 goes
through float32, which holds it exactly) and on its device, for dict, list
and NamedTuple trees, a `TrainState` among them. Keys follow the
reference's key paths, so a dict tree written by either package restores in
the other. A missing leaf raises `KeyError`, a shape mismatch `ValueError`.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import io as jio
from repro_torch.checkpoint import io
from repro_torch.configs import registry
from repro_torch.launch import train as T
from repro_torch.models.config import smoke_variant

torch.set_num_threads(1)


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "embed": torch.randn((5, 4), generator=g).bfloat16(),
        "final_ln": torch.randn((4,), generator=g),
        "layers": [{"ln": torch.randn((4,), generator=g), "attn": {"wq": torch.randn((4, 2, 2), generator=g)}},
                   {"ln": torch.randn((4,), generator=g).half(), "attn": {"wq": torch.randn((4, 2, 2), generator=g)}}],
        "step": torch.tensor(7, dtype=torch.int32),
    }


def _assert_same(got, want):
    """The same leaves under the same key paths (dict order aside), bit for
    bit, in the same types, on the same devices."""
    got, want = dict(io._flatten(got)), dict(io._flatten(want))
    assert got.keys() == want.keys()
    for k, a in got.items():
        b = want[k]
        assert a.dtype == b.dtype and a.device == b.device and torch.equal(a, b), k


def test_round_trip_keeps_values_types_and_structure(tmp_path):
    path = str(tmp_path / "sub" / "ckpt.npz")
    tree = _tree()
    io.save(path, tree)
    assert sorted(np.load(path).files) == sorted(k for k, _ in io._flatten(tree))
    like = _tree(seed=1)
    _assert_same(io.restore(path, like), tree)


def test_train_state_round_trips(tmp_path):
    """A `TrainState` of the smoke Qwen2.5-3B in bfloat16 (parameters in
    bfloat16, AdamW's moments float32, the step int32) after one step."""
    cfg = smoke_variant(registry.get_config("qwen2_5_3b")).scaled(dtype="bfloat16")
    state = T.init_state(cfg, torch.Generator().manual_seed(0), lr=1e-3)
    toks = torch.randint(0, cfg.vocab, (2, 9), generator=torch.Generator().manual_seed(1))
    state, _ = T.build_train_step(cfg, lr=1e-3)(state, {"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    path = str(tmp_path / "state.npz")
    io.save(path, state)
    keys = np.load(path).files
    assert ".opt/.step" in keys and ".params/['stages']/['main']/['b0']/['attn']/['wq']" in keys
    fresh = T.init_state(cfg, torch.Generator().manual_seed(2), lr=1e-3)
    back = io.restore(path, fresh)
    assert isinstance(back, T.TrainState) and int(back.opt.step) == 1
    _assert_same(back, state)


def test_missing_leaf_and_shape_mismatch_raise(tmp_path):
    path = str(tmp_path / "ckpt.npz")
    io.save(path, _tree())
    bigger = _tree()
    bigger["layers"][1]["extra"] = torch.zeros(3)
    with pytest.raises(KeyError, match=r"missing leaf .*layers.*/\[1\]/.*extra"):
        io.restore(path, bigger)
    wrong = _tree()
    wrong["final_ln"] = torch.zeros(5)
    with pytest.raises(ValueError, match=r"\['final_ln'\]: shape"):
        io.restore(path, wrong)


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    tree = _tree()
    jtree = {"embed": jnp.asarray(tree["embed"].float().numpy()).astype(jnp.bfloat16),
             "final_ln": jnp.asarray(tree["final_ln"].numpy()),
             "layers": [{"ln": jnp.asarray(l["ln"].float().numpy()),
                         "attn": {"wq": jnp.asarray(l["attn"]["wq"].numpy())}} for l in tree["layers"]],
             "step": jnp.asarray(7, jnp.int32)}
    jtree["layers"][1]["ln"] = jtree["layers"][1]["ln"].astype(jnp.float16)
    path = str(tmp_path / "ref.npz")
    jio.save(path, jtree)
    _assert_same(io.restore(path, _tree(seed=3)), tree)


def test_reference_train_state_restores_in_the_port(tmp_path):
    """The port's LM tree is laid out as the reference's pytree, and
    `TrainState`/`OptState` have the reference's fields, so a reference
    train state's checkpoint restores into the port's state: the
    parameters and moments the bridge gives."""
    import jax
    from repro.configs.registry import get_config as jget_config
    from repro.launch import train as JT
    from repro.models.config import smoke_variant as jsmoke
    from repro_torch import bridge

    jcfg, cfg = jsmoke(jget_config("qwen2_5_3b")), smoke_variant(registry.get_config("qwen2_5_3b"))
    jstate = JT.init_state(jax.random.PRNGKey(0), jcfg, 1e-3)
    jstate = jstate._replace(opt=jstate.opt._replace(
        step=jnp.asarray(3, jnp.int32), mu=jax.tree.map(lambda x: x + 0.25, jstate.opt.mu)))
    path = str(tmp_path / "ref_state.npz")
    jio.save(path, jstate)
    back = io.restore(path, T.init_state(cfg, torch.Generator().manual_seed(5), lr=1e-3))
    arrays = jax.tree.map(np.asarray, jstate)
    want = T.TrainState(bridge.lm_tree_from_numpy(arrays.params, cfg, device="cpu"),
                        bridge.opt_state_from_numpy(arrays.opt, cfg, device="cpu"))
    _assert_same(back, want)


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    tree = _tree()
    path = str(tmp_path / "port.npz")
    io.save(path, tree)
    like = {"embed": jnp.zeros((5, 4), jnp.bfloat16), "final_ln": jnp.zeros((4,)),
            "layers": [{"ln": jnp.zeros((4,)), "attn": {"wq": jnp.zeros((4, 2, 2))}},
                       {"ln": jnp.zeros((4,), jnp.float16), "attn": {"wq": jnp.zeros((4, 2, 2))}}],
            "step": jnp.zeros((), jnp.int32)}
    back = jio.restore(path, like)
    assert back["embed"].dtype == jnp.bfloat16 and back["layers"][1]["ln"].dtype == jnp.float16
    want = {k: io._to_numpy(a) for k, a in io._flatten(tree)}
    got = {k: np.asarray(b).astype(want[k].dtype) for k, b in io._flatten(_numpy(back))}
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def _numpy(jtree):
    """A reference tree with numpy leaves (the reference sorts dict keys)."""
    if isinstance(jtree, dict):
        return {k: _numpy(v) for k, v in jtree.items()}
    if isinstance(jtree, list):
        return [_numpy(v) for v in jtree]
    return np.asarray(jtree)

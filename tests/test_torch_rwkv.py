"""Parity of the port's RWKV-6 serving path with the JAX reference, on the CPU.

The WKV6 recurrence: the port's plain version (`kernels.rwkv6_scan.ref`,
which `ops.rwkv6_scan` takes for CPU tensors and which is the CUDA kernel's
plain version) is held to the reference's `lax.scan` oracle and to its
Pallas kernel in interpret mode (``ops.rwkv6_scan(use_pallas=True,
interpret=True, ct=32)``, as `tests/test_kernels.py` runs it), at the
reference's test shapes and a ragged S. Tolerances: float32 the JAX tests'
1e-4; bfloat16 one bf16 ulp of the output (rtol 2^-7; the JAX tests' 5e-2 is
looser), since both sides do float32 math on the same inputs and differ only
in the order of the sum over the key index before the output is rounded.

The model: the reference's smoke `rwkv6_1_6b` (2 layers, d_model 256, 4
heads of 64, float32) is initialised by the reference; the same weights reach
the port through `repro_torch.bridge.lm_params_from_numpy`. Time mix and
channel mix are held to 1e-5 and whole-model logits (|logit| up to about 4.7)
to atol 4e-5, rtol 1e-4: the reference's own float32 logits lie up to 3.6e-5
from the same model run in float64 (the port's float64 `prefill`), and the
two packages' float32 logits 2.9e-5 from each other. Greedy tokens must be
identical. The CUDA kernel itself is held to the plain version on the card
(`tests/test_torch_kernels_cuda.py`, `chip_smoke.py`).
"""
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget_config
from repro.kernels.rwkv6_scan import ops as jops, ref as jref
from repro.launch.serve import ServeLoop as JServeLoop
from repro.models import model as JM, rwkv as JR
from repro.models.config import smoke_variant as jsmoke
from repro_torch import bridge
from repro_torch.configs import registry
from repro_torch.kernels.rwkv6_scan import kernel, ops, ref
from repro_torch.launch.serve import ServeLoop
from repro_torch.models import model as M, rwkv as R
from repro_torch.models.config import smoke_variant

torch.set_num_threads(1)
ARCH = "rwkv6_1_6b"
#: (atol, rtol): float32 the JAX tests' 1e-4, bfloat16 one ulp of the output
SCAN_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (1e-5, 2**-7)}
#: the reference's own float32 rounding reaches 3.6e-5 (module docstring)
LOGIT_TOL = dict(atol=4e-5, rtol=1e-4)
LAYER_TOL = dict(atol=1e-5, rtol=1e-5)

# the shapes of tests/test_kernels.py:75 and a ragged S (not a multiple of
# the Pallas chunk, 32, nor of the CUDA kernel's)
SCAN_SHAPES = [(1, 2, 128, 64), (2, 4, 96, 32), (2, 3, 77, 64)]


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _scan_inputs(seed, B, H, S, hd, dtype):
    """r, k, v, w, u of the reference test's law, the same values for both
    packages (rounded to bfloat16 once, by torch): (jax arrays, tensors)."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, H, S, hd)).astype(np.float32) for _ in range(3))
    w = (0.5 / (1.0 + np.exp(-rng.standard_normal((B, H, S, hd)))) + 0.45).astype(np.float32)
    u = rng.standard_normal((H, hd)).astype(np.float32)
    t = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in (r, k, v, w, u)]
    j = [jnp.asarray(x.float().numpy()).astype(getattr(jnp, dtype)) for x in t]
    return j, t


def _close(got, want, dtype):
    atol, rtol = SCAN_TOL[dtype]
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=rtol)


# ---------------------------------------------------------------------------
# the WKV6 recurrence
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,H,S,hd", SCAN_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_scan_matches_reference_oracle(B, H, S, hd, dtype):
    (jr, jk, jv, jw, ju), (r, k, v, w, u) = _scan_inputs(0, B, H, S, hd, dtype)
    want_y, want_state = jref.rwkv6_scan_ref(jr, jk, jv, jw, ju)
    got_y, got_state = ref.rwkv6_scan(r, k, v, w, u)
    assert got_y.dtype == r.dtype and got_y.shape == r.shape
    assert got_state.dtype == torch.float32 and got_state.shape == (B, H, hd, hd)
    _close(got_y, want_y, dtype)
    np.testing.assert_allclose(_np(got_state), _np(want_state), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("B,H,S,hd", SCAN_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scan_op_matches_pallas_interpret(B, H, S, hd, dtype):
    """`ops.rwkv6_scan` on CPU tensors (the plain version) against the TPU
    kernel in interpret mode, which pads time to its chunk with w = 1."""
    (jr, jk, jv, jw, ju), (r, k, v, w, u) = _scan_inputs(1, B, H, S, hd, dtype)
    want = jops.rwkv6_scan(jr, jk, jv, jw, ju, use_pallas=True, interpret=True, ct=32)
    before = kernel.launches
    got, final = ops.rwkv6_scan(r, k, v, w, u)
    assert kernel.launches == before
    assert got.dtype == r.dtype and got.shape == r.shape and final is None
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_scan_carries_a_state(dtype):
    """From a nonzero state (the decode path), and split in two: the state
    after the first part carries the second part exactly."""
    (jr, jk, jv, jw, ju), (r, k, v, w, u) = _scan_inputs(2, 2, 3, 40, 32, dtype)
    s0 = np.random.default_rng(3).standard_normal((2, 3, 32, 32)).astype(np.float32)
    want_y, want_state = jref.rwkv6_scan_ref(jr, jk, jv, jw, ju, state=jnp.asarray(s0))
    got_y, got_state = ref.rwkv6_scan(r, k, v, w, u, torch.from_numpy(s0))
    _close(got_y, want_y, dtype)
    np.testing.assert_allclose(_np(got_state), _np(want_state), atol=1e-4, rtol=1e-4)
    y1, mid = ref.rwkv6_scan(*(x[:, :, :25] for x in (r, k, v, w)), u, torch.from_numpy(s0))
    y2, end = ref.rwkv6_scan(*(x[:, :, 25:] for x in (r, k, v, w)), u, mid)
    assert torch.equal(torch.cat([y1, y2], dim=2), got_y)
    assert torch.equal(end, got_state)


def test_scan_dispatch_on_cpu_tensors():
    _, (r, k, v, w, u) = _scan_inputs(4, 1, 2, 16, 32, "float32")
    with pytest.raises(ValueError, match="use_kernel=True needs CUDA tensors"):
        ops.rwkv6_scan(r, k, v, w, u, use_kernel=True)
    with pytest.raises(ValueError, match="CUDA device"):
        kernel.rwkv6_scan(r, k, v, w, u)
    before = kernel.launches
    plain = ref.rwkv6_scan(r, k, v, w, u)[0]
    assert torch.equal(ops.rwkv6_scan(r, k, v, w, u)[0], plain)
    assert torch.equal(ops.rwkv6_scan(r, k, v, w, u, use_kernel=False)[0], plain)
    assert kernel.launches == before


def test_scan_op_with_a_carried_state():
    """A carried state takes the plain recurrence under "auto" and False and
    returns its final state; asked for the kernel, it raises (before the CPU
    tensors would), whatever the state's values."""
    _, (r, k, v, w, u) = _scan_inputs(15, 1, 2, 16, 32, "float32")
    s0 = torch.from_numpy(np.random.default_rng(16).standard_normal((1, 2, 32, 32)).astype(np.float32))
    want_y, want_state = ref.rwkv6_scan(r, k, v, w, u, s0)
    for use_kernel in ("auto", False):
        y, state = ops.rwkv6_scan(r, k, v, w, u, s0, use_kernel=use_kernel)
        assert torch.equal(y, want_y) and torch.equal(state, want_state)
    for s in (s0, torch.zeros_like(s0)):
        with pytest.raises(ValueError, match="carried state"):
            ops.rwkv6_scan(r, k, v, w, u, s, use_kernel=True)


def test_plain_scan_takes_the_models_types():
    """bfloat16 r/k/v, float32 w, y asked for in float32 (what the model
    hands over): the float32 recurrence on the same values, exactly."""
    _, (r, k, v, w, u) = _scan_inputs(17, 2, 3, 40, 64, "bfloat16")
    w32 = torch.from_numpy(
        (0.5 / (1.0 + np.exp(-np.random.default_rng(18).standard_normal((2, 3, 40, 64)))) + 0.45)
        .astype(np.float32))
    y, _ = ops.rwkv6_scan(r, k, v, w32, u, out_dtype=torch.float32)
    want = ref.rwkv6_scan(r.float(), k.float(), v.float(), w32, u.float())[0]
    assert y.dtype == torch.float32 and torch.equal(y, want)
    y16, _ = ops.rwkv6_scan(r, k, v, w32, u)
    assert y16.dtype == torch.bfloat16 and torch.equal(y16, want.to(torch.bfloat16))
    empty = ref.rwkv6_scan(r[:, :, :0], k[:, :, :0], v[:, :, :0], w32[:, :, :0], u,
                           out_dtype=torch.float32)[0]
    assert empty.dtype == torch.float32 and empty.shape == (2, 3, 0, 64)


def test_plain_scan_reads_strided_views():
    """The model hands the scan (B, H, S, hd) views of (B, S, H, hd) tensors."""
    _, (r, k, v, w, u) = _scan_inputs(5, 2, 3, 24, 32, "float32")
    views = [x.transpose(1, 2).contiguous().transpose(1, 2) for x in (r, k, v, w)]
    assert not views[0].is_contiguous()
    assert torch.equal(ref.rwkv6_scan(*views, u)[0], ref.rwkv6_scan(r, k, v, w, u)[0])


def test_empty_sequence():
    _, (r, k, v, w, u) = _scan_inputs(6, 1, 2, 0, 32, "float32")
    y, state = ref.rwkv6_scan(r, k, v, w, u)
    assert y.shape == (1, 2, 0, 32) and torch.equal(state, torch.zeros((1, 2, 32, 32)))


# ---------------------------------------------------------------------------
# the CUDA kernel's arithmetic, emulated
# ---------------------------------------------------------------------------


def _model_law(seed, S, hd, dtype=torch.float32):
    """r, k, v (rounded to bf16, the model's types) and u of one head, with
    w of the model's decay law exp(-exp(-6 + 0.5 z)) (near 0.9975), as
    (1, 1, S, hd) tensors in ``dtype``."""
    rng = np.random.default_rng(seed)
    r, k, v = (torch.from_numpy(rng.standard_normal((1, 1, S, hd)).astype(np.float32))
               .to(torch.bfloat16).to(dtype) for _ in range(3))
    w = torch.from_numpy(np.exp(-np.exp(-6.0 + 0.5 * rng.standard_normal((1, 1, S, hd))))
                         .astype(np.float32)).to(dtype)
    u = torch.from_numpy(rng.standard_normal((1, hd)).astype(np.float32)).to(dtype)
    return r, k, v, w, u


def _gate_share(got, want, dtype="float32"):
    """max |got - want| / (atol + rtol |want|) at the kernel gate's tolerance"""
    atol, rtol = SCAN_TOL[dtype]
    want = want.double()
    return float(((got.double() - want).abs() / (atol + rtol * want.abs())).max())


def _fma(a, b, c):
    """a * b + c rounded once to float32 (the float64 product of two float32
    values is exact)"""
    return (a.double() * b.double() + c.double()).float()


def _recurrence64(r, k, v, w, u):
    """The plain recurrence of one (b, h), every operation in float64."""
    r, k, v, w = (x[0, 0].double() for x in (r, k, v, w))
    uf = u[0].double()[:, None]
    state = torch.zeros((r.shape[1], r.shape[1]), dtype=torch.float64)
    ys = []
    for t in range(r.shape[0]):
        kv = k[t][:, None] * v[t][None, :]
        ys.append(r[t] @ (state + uf * kv))
        state = w[t][:, None] * state + kv
    return torch.stack(ys)


def _tree(x):
    """the sum over the last dim (a power of 2) as the kernel's transposing
    shuffle pass takes it: lanes l and l ^ (n / 2) first, then l ^ (n / 4), ..."""
    while x.shape[-1] > 1:
        x = x[..., : x.shape[-1] // 2] + x[..., x.shape[-1] // 2:]
    return x[..., 0]


def _kernel_y(r, k, v, w, u, parts=4):
    """The CUDA kernel's y for one (b, h) of hd 64, in plain torch: the state
    S <- (w S) + (k v) rounded as the plain version rounds it; y_j = sum_i
    r_i S_ij (S before the step's update; each lane's 2 keys by an FMA, the
    32 lanes by the transposing pass) + v_j c_t, with the bonus sum c_t =
    sum_i r_i u_i k_i taken by ``parts`` threads of hd / parts keys each
    (FMAs in key order) and a butterfly. Returns (y (S, hd), final state)."""
    r, k, v, w, u = (x[0, 0].float() if x.ndim == 4 else x[0].float() for x in (r, k, v, w, u))
    S, hd = r.shape
    ru, kk = (r * u).reshape(S, parts, -1), k.reshape(S, parts, -1)
    c = torch.zeros((S, parts))
    for m in range(hd // parts):
        c = _fma(ru[..., m], kk[..., m], c)
    state = torch.zeros((hd, hd))
    ysum = []
    for t in range(S):
        lane = _fma(r[t, 1::2, None], state[1::2], r[t, 0::2, None] * state[0::2])  # (hd/2, hd)
        ysum.append(_tree(lane.T))
        state = w[t][:, None] * state + k[t][:, None] * v[t][None, :]
    return _fma(v, _tree(c)[:, None], torch.stack(ysum)), state


def test_float32_gate_pins_the_wkv_states_rounding():
    """The fact that pins the kernel's state to the plain version's rounding
    (no chunked form, no reordered sums): at S 4096 under the model's decay
    law, the plain float32 recurrence itself lies beyond the float32 gate
    (1e-4 absolute and relative) from the same recurrence in float64."""
    args = _model_law(40, 4096, 64)
    y32 = ref.rwkv6_scan(*args)[0]
    assert _gate_share(y32[0, 0], _recurrence64(*args)) > 1.0


def test_kernels_factored_y_holds_the_gate():
    """The kernel's y (the bonus term factored out of the entry loop, its
    own sum order) against the plain version at S 4096 under the model's
    decay law: within the float32 gate, with the state bit for bit the
    plain version's."""
    args = _model_law(41, 4096, 64)
    want, want_state = ref.rwkv6_scan(*args)
    got, state = _kernel_y(*args)
    assert torch.equal(state, want_state[0, 0])
    assert _gate_share(got, want[0, 0]) < 1.0


# ---------------------------------------------------------------------------
# the blocks
# ---------------------------------------------------------------------------

_MODEL = {}


def _model():
    """(jax cfg, jax params, port cfg, port LM) of the smoke config, built once."""
    if not _MODEL:
        jcfg, cfg = jsmoke(jget_config(ARCH)), smoke_variant(registry.get_config(ARCH))
        jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
        tp = bridge.lm_params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
        _MODEL.update(v=(jcfg, jp, cfg, tp))
    return _MODEL["v"]


def _states(kind, cfg, B):
    """A zero or a nonzero carried state, as numpy arrays."""
    d, hd = cfg.d_model, cfg.rwkv_head_dim
    shapes = {"shift": (B, d), "wkv": (B, d // hd, hd, hd), "shift_c": (B, d)}
    if kind == "zero":
        return {n: np.zeros(s, np.float32) for n, s in shapes.items()}
    rng = np.random.default_rng(7)
    return {n: rng.standard_normal(s).astype(np.float32) * (3.0 if n == "wkv" else 1.0)
            for n, s in shapes.items()}


def _block_params(layer=0):
    jcfg, jp, cfg, tp = _model()
    return jax.tree.map(lambda a: a[layer], jp["stages"]["main"]["b0"]["rwkv"]), tp.layers[layer].rwkv


@pytest.mark.parametrize("kind", ["zero", "nonzero"])
def test_time_mix_matches_reference(kind):
    jcfg, _, cfg, _ = _model()
    jparams, params = _block_params(1)
    x = np.random.default_rng(8).standard_normal((2, 37, cfg.d_model)).astype(np.float32)
    st = _states(kind, cfg, 2)
    want, jnew = JR.time_mix(jparams, jcfg, jnp.asarray(x), {n: jnp.asarray(a) for n, a in st.items()})
    got, new = R.time_mix(params, cfg, torch.from_numpy(x), {n: torch.from_numpy(a) for n, a in st.items()})
    np.testing.assert_allclose(_np(got), _np(want), **LAYER_TOL)
    np.testing.assert_allclose(_np(new["wkv"]), _np(jnew["wkv"]), atol=1e-4, rtol=1e-5)
    np.testing.assert_array_equal(_np(new["shift"]), _np(jnew["shift"]))
    assert new["wkv"].dtype == torch.float32


def test_time_mix_of_a_fresh_sequence():
    """``state=None`` (the forward path) is the zero state, through
    `ops.rwkv6_scan`; the kernel writes no final state, so this returns no
    state."""
    jcfg, _, cfg, _ = _model()
    jparams, params = _block_params(0)
    x = np.random.default_rng(9).standard_normal((2, 21, cfg.d_model)).astype(np.float32)
    st = _states("zero", cfg, 2)
    want, _ = JR.time_mix(jparams, jcfg, jnp.asarray(x), {n: jnp.asarray(a) for n, a in st.items()})
    got, new = R.time_mix(params, cfg, torch.from_numpy(x), None)
    np.testing.assert_allclose(_np(got), _np(want), **LAYER_TOL)
    assert new is None
    carried, _ = R.time_mix(params, cfg, torch.from_numpy(x), {n: torch.from_numpy(a) for n, a in st.items()})
    assert torch.equal(got, carried)


@pytest.mark.parametrize("kind", ["zero", "nonzero"])
def test_channel_mix_matches_reference(kind):
    jcfg, _, cfg, _ = _model()
    jparams, params = _block_params(1)
    x = np.random.default_rng(10).standard_normal((2, 19, cfg.d_model)).astype(np.float32)
    st = _states(kind, cfg, 2)
    want, jnew = JR.channel_mix(jparams, jcfg, jnp.asarray(x), {"shift_c": jnp.asarray(st["shift_c"])})
    got, new = R.channel_mix(params, cfg, torch.from_numpy(x), {"shift_c": torch.from_numpy(st["shift_c"])})
    np.testing.assert_allclose(_np(got), _np(want), **LAYER_TOL)
    np.testing.assert_array_equal(_np(new["shift_c"]), _np(jnew["shift_c"]))
    if kind == "zero":
        assert torch.equal(R.channel_mix(params, cfg, torch.from_numpy(x))[0], got)


def test_decay_and_group_norm_match_reference():
    jcfg, _, cfg, _ = _model()
    jparams, params = _block_params(0)
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    want = JR._decay(jparams, jnp.asarray(x))
    got = R._decay(params, torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-6, rtol=1e-6)
    y = rng.standard_normal((2, 9, cfg.d_model)).astype(np.float32) * 5.0 + 1.0
    g, b = (rng.standard_normal(cfg.d_model).astype(np.float32) for _ in range(2))
    want = JR._group_norm(jnp.asarray(y), jnp.asarray(g), jnp.asarray(b), 4)
    got = R._group_norm(torch.from_numpy(y), torch.from_numpy(g), torch.from_numpy(b), 4)
    np.testing.assert_allclose(_np(got), _np(want), **LAYER_TOL)


def test_time_mix_refuses_the_kernel_with_a_carried_state():
    """Asked for the kernel, a carried state raises (here before the CPU
    tensors would); it is never swapped for the plain recurrence."""
    _, _, cfg, _ = _model()
    _, params = _block_params(0)
    x = torch.zeros((1, 4, cfg.d_model))
    for kind in ("zero", "nonzero"):
        st = {n: torch.from_numpy(a) for n, a in _states(kind, cfg, 1).items()}
        with pytest.raises(ValueError, match="carried state"):
            R.time_mix(params, cfg, x, st, use_kernel=True)
    with pytest.raises(ValueError, match="use_kernel=True needs CUDA tensors"):
        R.time_mix(params, cfg, x, None, use_kernel=True)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def test_rwkv_config_equals_reference():
    jcfg, cfg = jsmoke(jget_config(ARCH)), smoke_variant(registry.get_config(ARCH))
    assert {f: getattr(cfg, f) for f in cfg.__dataclass_fields__} == \
        {f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__}
    full = registry.get_config(ARCH)
    assert full == registry.get_config("rwkv6-1-6b")
    assert full.param_count() == jget_config(ARCH).param_count()
    assert M.layer_kinds(full) == ["rwkv"] * 24


def test_prefill_logits_match_reference():
    """S = 160: five chunks of the CUDA kernel's 32 steps. Beside the
    reference, the port's float32 logits lie no farther than 1.25x the
    reference's own from the same weights run in float64."""
    jcfg, jp, cfg, tp = _model()
    toks = np.random.default_rng(12).integers(0, cfg.vocab, (2, 160))
    want = jax.jit(lambda p, t: JM.prefill(p, jcfg, {"tokens": t}))(jp, jnp.asarray(toks))
    got = M.prefill(tp, cfg, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (2, 160, cfg.vocab) and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), **LOGIT_TOL)
    cfg64 = cfg.scaled(dtype="float64")
    tp64 = bridge.lm_params_from_numpy(jax.tree.map(np.asarray, jp), cfg64, device="cpu")
    exact = M.prefill(tp64, cfg64, {"tokens": torch.from_numpy(toks)}).numpy()
    assert np.abs(_np(got) - exact).max() <= 1.25 * np.abs(_np(want) - exact).max()
    assert torch.equal(M.prefill(tp, cfg, {"tokens": torch.from_numpy(toks)}, use_kernel=False), got)


def test_bf16_prefill_rounds_like_the_reference():
    """The bfloat16 model (the chip's configuration) against the same weights
    in float32: the port's bf16 logits lie no farther from the float32 ones
    than 1.25x the reference's bf16 logits do. Measure: the RMS gap over all
    logits of a batch, per model, and its median over five models (seeds
    0-4: ratios 0.95-1.01). The median, because at rare positions both sides'
    bf16 logits move far from float32 (position 0 of one sequence in one of
    ten models: 0.75 reference, 1.85 port, max abs), where the group norm of
    the zero state's rank-one y, c v with a small c, divides by about
    sqrt(eps); one such position sets a single model's RMS.
    """
    jcfg32, cfg32 = jsmoke(jget_config(ARCH)), smoke_variant(registry.get_config(ARCH))
    jcfg16, cfg16 = jcfg32.scaled(dtype="bfloat16"), cfg32.scaled(dtype="bfloat16")
    rms = lambda a: float(np.sqrt(np.mean(np.square(a))))
    ratios = []
    for seed in range(5):
        jp16 = JM.init_params(jax.random.PRNGKey(seed), jcfg16)
        jp32 = jax.tree.map(lambda a: a.astype(jnp.float32), jp16)
        toks = np.random.default_rng(100 + seed).integers(0, cfg32.vocab, (2, 160))
        prefill = lambda p, c: np.asarray(JM.prefill(p, c, {"tokens": jnp.asarray(toks)}), np.float32)
        want16, want32 = prefill(jp16, jcfg16), prefill(jp32, jcfg32)
        tp16 = bridge.lm_params_from_numpy(jax.tree.map(np.asarray, jp16), cfg16, device="cpu")
        got16 = M.prefill(tp16, cfg16, {"tokens": torch.from_numpy(toks)})
        assert got16.dtype == torch.bfloat16
        ratios.append(rms(_np(got16) - want32) / rms(want16 - want32))
    assert float(np.median(ratios)) <= 1.25, ratios


def test_decode_steps_match_reference():
    """Three cached decode steps after a 12-token prompt fed step by step;
    the carried state reproduces the prefill's last position."""
    jcfg, jp, cfg, tp = _model()
    toks = np.random.default_rng(13).integers(0, cfg.vocab, (2, 15))
    jcache = JM.init_cache(jcfg, 2, 32)
    cache = M.init_cache(cfg, 2, 32, "cpu")
    assert set(cache[0]) == {"shift", "wkv", "shift_c"}
    step = jax.jit(lambda p, t, pos, c: JM.decode_step(p, jcfg, t, pos, c))
    for pos in range(15):
        t = toks[:, pos:pos + 1]
        want, jcache = step(jp, jnp.asarray(t, jnp.int32), jnp.int32(pos), jcache)
        got, cache = M.decode_step(tp, cfg, torch.from_numpy(t), pos, cache)
        if pos >= 12:
            np.testing.assert_allclose(_np(got), _np(want), err_msg=f"pos {pos}", **LOGIT_TOL)
    for layer in range(cfg.n_layers):
        for name in ("shift", "wkv", "shift_c"):
            np.testing.assert_allclose(_np(cache[layer][name]),
                                       _np(jcache["main"]["b0"][name][layer]),
                                       atol=1e-4, rtol=1e-5, err_msg=f"layer {layer} {name}")
    full = M.prefill(tp, cfg, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(_np(got)[:, 0], _np(full)[:, -1], **LOGIT_TOL)


@pytest.mark.parametrize("slots,n_req,max_new", [(2, 5, 6), (1, 1, 5)])
def test_serve_loop_tokens_match_reference(slots, n_req, max_new):
    """Greedy tokens identical to the JAX loop's; with 5 requests on 2 slots
    a refilled slot inherits the old slot's state in both."""
    jcfg, jp, cfg, tp = _model()
    rng = np.random.default_rng(14)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab, 4)] for _ in range(n_req)]
    want, _ = JServeLoop(jcfg, jp, slots, max_len=64).run([list(p) for p in prompts], max_new)
    got, stats = ServeLoop(cfg, tp, slots, max_len=64).run([list(p) for p in prompts], max_new)
    assert got == {k: [int(t) for t in v] for k, v in want.items()}
    assert set(got) == set(range(n_req)) and all(len(v) == max_new for v in got.values())
    assert stats["steps"] > 0


def test_bridge_and_init_follow_the_reference_layout():
    """The reference's rwkv pytree (stages.main.b0.rwkv) arrives leaf by
    leaf; the port's own init has the same leaves, shapes and law."""
    jcfg, jp, cfg, tp = _model()
    src = jp["stages"]["main"]["b0"]
    assert set(src) == {"ln", "ffn_ln", "rwkv"}
    for layer, blk in enumerate(tp.layers):
        assert blk.kind == "rwkv" and not hasattr(blk, "ffn")
        for name, leaf in src["rwkv"].items():
            np.testing.assert_array_equal(blk.rwkv[name].numpy(), np.asarray(leaf[layer]))
    own = M.init_params(cfg, torch.Generator().manual_seed(0))
    leaves = lambda lm: {jax.tree_util.keystr(k): tuple(p.shape)
                         for k, p in jax.tree_util.tree_flatten_with_path(lm.tree)[0]}
    assert leaves(own) == leaves(tp)
    blk = own.layers[0].rwkv
    assert abs(float(blk["wr"].std()) * cfg.d_model ** 0.5 - 1.0) < 0.05
    assert float(blk["w_bias"].max()) == float(blk["w_bias"].min()) == -6.0
    assert float(blk["mu"].min()) == 0.5 and tuple(blk["u"].shape) == (4, 64)


def test_serve_main_runs_the_smoke_rwkv_on_the_cpu():
    import os
    import pathlib

    root = pathlib.Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH, "--smoke",
         "--device", "cpu", "--requests", "3", "--max-new", "4"],
        capture_output=True, text=True, env=env, cwd=root, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("served 3 requests, 12 tokens")

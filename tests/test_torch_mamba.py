"""Parity of the port's Jamba Mamba serving path with the JAX reference, on the CPU.

The selective scan: the port's plain version (`kernels.mamba_scan.ref`,
which `ops.mamba_scan` takes for CPU tensors and which is the CUDA kernel's
plain version) is held to the reference's `lax.scan` oracle and to its Pallas
kernel in interpret mode (``ops.mamba_scan(use_pallas=True, interpret=True,
ct=32, bd=32)``, as `tests/test_kernels.py` runs it), at the reference's test
shapes and a ragged S. Tolerances: float32 the JAX tests' 1e-4; bfloat16 one
bf16 ulp of the output (rtol 2^-7; the JAX tests' 5e-2 is looser), since
both sides do float32 math on the same inputs and differ only in the order
of the sum over the state before the output is rounded.

The model: the reference's smoke Jamba with its MoE FFNs made dense
(``smoke_variant(cfg).scaled(n_experts=0, top_k=0)``: two periods of
4 Mamba + 1 attention + 3 Mamba blocks, d_model 256, d_inner 512, state 16,
float32), the cut the card runs at full width. The reference initialises
it; the same weights reach the port through
`repro_torch.bridge.lm_params_from_numpy`. Blocks are held to 1e-5 and
whole-model logits (|logit| up to about 4.5) to atol 4e-5, rtol 1e-4 (the
RWKV test's): the two packages' float32 logits lie about 1.6e-5 apart on
these inputs, summing in other orders. Greedy tokens must be identical. The
CUDA kernel itself is held to the plain version on the card
(`tests/test_torch_kernels_cuda.py`, `chip_smoke.py`).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget_config
from repro.kernels.mamba_scan import ops as jops, ref as jref
from repro.launch.serve import ServeLoop as JServeLoop
from repro.models import mamba as JMa, model as JM
from repro.models.config import smoke_variant as jsmoke
from repro_torch import bridge
from repro_torch.configs import registry
from repro_torch.kernels.mamba_scan import kernel, ops, ref
from repro_torch.launch.serve import ServeLoop
from repro_torch.models import mamba as Ma, model as M
from repro_torch.models.config import smoke_variant

torch.set_num_threads(1)
ARCH = "jamba_1_5_large_398b"
#: the dense cut the port runs (the published config has 16 experts)
DENSE = dict(n_experts=0, top_k=0)
#: (atol, rtol): float32 the JAX tests' 1e-4, bfloat16 one ulp of the output
SCAN_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (1e-5, 2**-7)}
#: the two packages' float32 logits lie about 1.6e-5 apart (module docstring)
LOGIT_TOL = dict(atol=4e-5, rtol=1e-4)
LAYER_TOL = dict(atol=1e-5, rtol=1e-5)

# the shapes of tests/test_kernels.py:122 (B, S, di, N) and a ragged S (not a
# multiple of the Pallas chunk, 32, nor of the CUDA kernel's)
SCAN_SHAPES = [(1, 64, 128, 8), (2, 96, 64, 16), (2, 77, 96, 16)]


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


_JAX_TYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _scan_inputs(seed, B, S, di, N, dtype):
    """x, dt, Bm, Cm, A, D of the reference test's law (x and dt in
    ``dtype``, the rest float32; D away from 1 so that D x counts), the same
    values for both packages: (jax arrays, tensors)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, di)).astype(np.float32)
    dt = (np.log1p(np.exp(rng.standard_normal((B, S, di)))) * 0.1).astype(np.float32)
    Bm, Cm = (rng.standard_normal((B, S, N)).astype(np.float32) for _ in range(2))
    A = -np.abs(rng.standard_normal((di, N))).astype(np.float32)
    D = (1.0 + 0.5 * rng.standard_normal(di)).astype(np.float32)
    dt_ = getattr(torch, dtype)
    t = [torch.from_numpy(x).to(dt_), torch.from_numpy(dt).to(dt_)] + \
        [torch.from_numpy(a) for a in (Bm, Cm, A, D)]
    j = [jnp.asarray(v.float().numpy()).astype(_JAX_TYPES[v.dtype]) for v in t]
    return j, t


def _close(got, want, dtype):
    atol, rtol = SCAN_TOL[dtype]
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=rtol)


def _h0(seed, B, di, N):
    return np.random.default_rng(seed).standard_normal((B, di, N)).astype(np.float32)


# ---------------------------------------------------------------------------
# the selective scan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,S,di,N", SCAN_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("carried", [False, True], ids=["zero", "h0"])
def test_plain_scan_matches_reference_oracle(B, S, di, N, dtype, carried):
    j, t = _scan_inputs(0, B, S, di, N, dtype)
    h0 = _h0(1, B, di, N) if carried else None
    want_y, want_h = jref.mamba_scan_ref(*j, h0=None if h0 is None else jnp.asarray(h0))
    got_y, got_h = ref.mamba_scan(*t, None if h0 is None else torch.from_numpy(h0))
    assert got_y.dtype == t[0].dtype and got_y.shape == (B, S, di)
    assert got_h.dtype == torch.float32 and got_h.shape == (B, di, N)
    _close(got_y, want_y, dtype)
    np.testing.assert_allclose(_np(got_h), _np(want_h), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("B,S,di,N", SCAN_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scan_op_matches_pallas_interpret(B, S, di, N, dtype):
    """`ops.mamba_scan` on CPU tensors (the plain version) against the TPU
    kernel in interpret mode, which pads time to its chunk with dt = 0."""
    j, t = _scan_inputs(2, B, S, di, N, dtype)
    want = jops.mamba_scan(*j, use_pallas=True, interpret=True, ct=32, bd=32)
    before = kernel.launches
    got, final = ops.mamba_scan(*t)
    assert kernel.launches == before
    assert got.dtype == t[0].dtype and got.shape == (B, S, di) and final is None
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_scan_carries_a_state(dtype):
    """Split in two, the state after the first part carries the second part
    exactly (the decode path's step-by-step scan is the prefill's)."""
    _, (x, dt, Bm, Cm, A, D) = _scan_inputs(3, 2, 40, 64, 16, dtype)
    h0 = torch.from_numpy(_h0(4, 2, 64, 16))
    y, h = ref.mamba_scan(x, dt, Bm, Cm, A, D, h0)
    y1, mid = ref.mamba_scan(*(v[:, :25] for v in (x, dt, Bm, Cm)), A, D, h0)
    y2, end = ref.mamba_scan(*(v[:, 25:] for v in (x, dt, Bm, Cm)), A, D, mid)
    assert torch.equal(torch.cat([y1, y2], dim=1), y)
    assert torch.equal(end, h)


def test_scan_dispatch_on_cpu_tensors():
    _, t = _scan_inputs(5, 1, 16, 32, 8, "float32")
    with pytest.raises(ValueError, match="use_kernel=True needs CUDA tensors"):
        ops.mamba_scan(*t, use_kernel=True)
    with pytest.raises(ValueError, match="CUDA device"):
        kernel.mamba_scan(*t)
    before = kernel.launches
    plain = ref.mamba_scan(*t)[0]
    assert torch.equal(ops.mamba_scan(*t)[0], plain)
    assert torch.equal(ops.mamba_scan(*t, use_kernel=False)[0], plain)
    assert kernel.launches == before


def test_scan_op_with_a_carried_state():
    """A carried state takes the plain recurrence under "auto" and False and
    returns its final state; asked for the kernel, it raises (before the CPU
    tensors would), whatever the state's values."""
    _, t = _scan_inputs(6, 1, 16, 32, 8, "float32")
    h0 = torch.from_numpy(_h0(7, 1, 32, 8))
    want_y, want_h = ref.mamba_scan(*t, h0)
    for use_kernel in ("auto", False):
        y, h = ops.mamba_scan(*t, h0, use_kernel=use_kernel)
        assert torch.equal(y, want_y) and torch.equal(h, want_h)
    for h in (h0, torch.zeros_like(h0)):
        with pytest.raises(ValueError, match="carried state"):
            ops.mamba_scan(*t, h, use_kernel=True)


def test_plain_scan_takes_the_models_types():
    """bfloat16 x, float32 dt, B and C as bfloat16 column views of one
    projection (what the model hands over): y in bf16, the float32
    recurrence on the same values rounded once."""
    (_, _, _, _, _, _), (x, dt, _, _, A, D) = _scan_inputs(8, 2, 40, 64, 16, "float32")
    x16 = x.to(torch.bfloat16)
    proj = torch.from_numpy(np.random.default_rng(9).standard_normal((2, 40, 4 + 32))
                            .astype(np.float32)).to(torch.bfloat16)
    Bm, Cm = proj[..., 4:20], proj[..., 20:]
    assert not Bm.is_contiguous()
    want = ref.mamba_scan(x16.float(), dt, Bm.float(), Cm.float(), A, D)[0]
    y16, _ = ops.mamba_scan(x16, dt, Bm, Cm, A, D)
    assert y16.dtype == torch.bfloat16 and torch.equal(y16, want.to(torch.bfloat16))


def test_empty_sequence():
    _, t = _scan_inputs(10, 2, 0, 32, 8, "float32")
    y, h = ref.mamba_scan(*t)
    assert y.shape == (2, 0, 32) and torch.equal(h, torch.zeros((2, 32, 8)))


def _jamba_law(seed, S, di, N, dtype):
    """x, dt, Bm, Cm, A, D as the initialised Jamba has them (dt =
    softplus(-4.6 + 0.5 z), near 0.01; A = -(1..N)), x and B/C in ``dtype``
    (B and C column views of one projection), dt float32."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((1, S, di)).astype(np.float32)).to(dtype)
    dt = torch.from_numpy(np.log1p(np.exp(-4.6 + 0.5 * rng.standard_normal((1, S, di))))
                          .astype(np.float32))
    proj = torch.from_numpy(rng.standard_normal((1, S, 2 * N)).astype(np.float32)).to(dtype)
    A = -torch.arange(1, N + 1, dtype=torch.float32).repeat(di, 1)
    D = torch.from_numpy((1.0 + 0.5 * rng.standard_normal(di)).astype(np.float32))
    return x, dt, proj[..., :N], proj[..., N:], A, D


def _scan_with_kernels_exp(x, dt, Bm, Cm, A, D, ulps, seed):
    """`ref.mamba_scan` with exp(dt A) taken as the CUDA kernel takes it:
    2^(dt a2) with a2 = A log2(e) rounded to float32 and dt a2 rounded, the
    power rounded correctly to float32 and then moved by a random whole
    number of ulps in [-ulps, ulps] (what `ex2.approx` may err by)."""
    rng = np.random.default_rng(seed)
    a2 = A.float() * np.float32(1.4426950408889634)
    h = torch.zeros((x.shape[0], x.shape[2], Bm.shape[-1]))
    ys = []
    for t in range(x.shape[1]):
        x_t, dt_t, B_t, C_t = (v[:, t].float() for v in (x, dt, Bm, Cm))
        da = torch.exp2((dt_t[..., None] * a2).double()).float()
        da = (da.view(torch.int32) + torch.from_numpy(
            rng.integers(-ulps, ulps + 1, da.shape, dtype=np.int32))).view(torch.float32)
        h = da * h + (dt_t * x_t)[..., None] * B_t[:, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, C_t) + D.float() * x_t)
    return torch.stack(ys, dim=1).to(x.dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernels_exponential_holds_the_gates(dtype):
    """The CUDA kernel's exponential (2^(dt a2) on the exponential unit, a
    few ulp from exp(dt A)) against the plain scan's, every other operation
    as the plain version rounds it, at S 4096 under Jamba's law: y within
    phase 10's gate, float32 at 1e-4 and the model's bf16 types at one ulp
    (the state in float32 either way)."""
    args = _jamba_law(50, 4096, 32, 16, getattr(torch, dtype))
    want = ref.mamba_scan(*args)[0]
    got = _scan_with_kernels_exp(*args, ulps=4, seed=51)
    assert got.dtype == want.dtype
    atol, rtol = SCAN_TOL[dtype]
    want = want.double()
    assert float(((got.double() - want).abs() / (atol + rtol * want.abs())).max()) < 1.0


# ---------------------------------------------------------------------------
# the block
# ---------------------------------------------------------------------------

_MODEL = {}


def _configs():
    return (jsmoke(jget_config(ARCH)).scaled(**DENSE),
            smoke_variant(registry.get_config(ARCH)).scaled(**DENSE))


def _model():
    """(jax cfg, jax params, port cfg, port LM) of the smoke cut, built once."""
    if not _MODEL:
        jcfg, cfg = _configs()
        jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
        tp = bridge.lm_params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
        _MODEL.update(v=(jcfg, jp, cfg, tp))
    return _MODEL["v"]


def _block_params(j=1, period=1):
    """The ``mamba`` leaves of pattern position j in period ``period``."""
    jcfg, jp, cfg, tp = _model()
    jparams = jax.tree.map(lambda a: a[period], jp["stages"]["main"][f"b{j}"]["mamba"])
    return jparams, tp.layers[period * cfg.pattern_len + j].mamba


def _state(kind, cfg, B):
    di = cfg.ssm_expand * cfg.d_model
    shapes = {"conv": (B, cfg.ssm_conv - 1, di), "h": (B, di, cfg.ssm_state)}
    if kind == "zero":
        return {n: np.zeros(s, np.float32) for n, s in shapes.items()}
    rng = np.random.default_rng(11)
    return {n: rng.standard_normal(s).astype(np.float32) for n, s in shapes.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("carried", [False, True], ids=["fresh", "carry"])
def test_causal_conv_matches_reference(dtype, carried):
    """The K shifted products summed in the reference's order: bit-equal in
    float32, within one ulp in bfloat16 (where XLA may fuse a product)."""
    rng = np.random.default_rng(12)
    x, w, b = (rng.standard_normal(s).astype(np.float32) for s in ((2, 9, 48), (4, 48), (48,)))
    carry = rng.standard_normal((2, 3, 48)).astype(np.float32) if carried else None
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want, jc = JMa._causal_conv(*(jnp.asarray(a).astype(jd) for a in (x, w, b)),
                                None if carry is None else jnp.asarray(carry).astype(jd))
    got, c = Ma._causal_conv(*(torch.from_numpy(a).to(td) for a in (x, w, b)),
                             None if carry is None else torch.from_numpy(carry).to(td))
    assert got.dtype == td and c.shape == (2, 3, 48)
    tol = dict(atol=0, rtol=0) if dtype == "float32" else dict(atol=1e-6, rtol=2**-7)
    np.testing.assert_allclose(_np(got), _np(want), **tol)
    np.testing.assert_array_equal(_np(c), _np(jc))


def test_ssm_inputs_match_reference():
    jcfg, _, cfg, _ = _model()
    jparams, params = _block_params(0, 0)
    di = cfg.ssm_expand * cfg.d_model
    rng = np.random.default_rng(13)
    x, z = (rng.standard_normal((2, 11, di)).astype(np.float32) for _ in range(2))
    _, _, jdt, jB, jC = JMa._ssm_inputs(jparams, jcfg, jnp.concatenate([jnp.asarray(x), jnp.asarray(z)], -1))
    dt, Bm, Cm = Ma._ssm_inputs(params, cfg, torch.from_numpy(x))
    assert dt.dtype == torch.float32 and Bm.shape == Cm.shape == (2, 11, cfg.ssm_state)
    for got, want in ((dt, jdt), (Bm, jB), (Cm, jC)):
        np.testing.assert_allclose(_np(got), _np(want), **LAYER_TOL)


@pytest.mark.parametrize("kind", ["zero", "nonzero"])
def test_mamba_forward_from_a_carried_state(kind):
    jcfg, _, cfg, _ = _model()
    jparams, params = _block_params()
    x = np.random.default_rng(14).standard_normal((2, 23, cfg.d_model)).astype(np.float32)
    st = _state(kind, cfg, 2)
    want, jnew = JMa.mamba_forward(jparams, jcfg, jnp.asarray(x), {n: jnp.asarray(a) for n, a in st.items()})
    got, new = Ma.mamba_forward(params, cfg, torch.from_numpy(x), {n: torch.from_numpy(a) for n, a in st.items()})
    np.testing.assert_allclose(_np(got), _np(want), **LAYER_TOL)
    np.testing.assert_allclose(_np(new["conv"]), _np(jnew["conv"]), **LAYER_TOL)   # in_proj's sums
    np.testing.assert_allclose(_np(new["h"]), _np(jnew["h"]), atol=1e-4, rtol=1e-5)
    assert new["h"].dtype == torch.float32


def test_mamba_forward_of_a_fresh_sequence():
    """``state=None`` (the forward path) is the zero state, through
    `ops.mamba_scan` with D x inside the scan (the reference adds it after):
    the same values; the kernel writes no final state, so this returns none."""
    jcfg, _, cfg, _ = _model()
    jparams, params = _block_params(2, 0)
    x = np.random.default_rng(15).standard_normal((2, 21, cfg.d_model)).astype(np.float32)
    st = _state("zero", cfg, 2)
    want, _ = JMa.mamba_forward(jparams, jcfg, jnp.asarray(x), {n: jnp.asarray(a) for n, a in st.items()})
    got, new = Ma.mamba_forward(params, cfg, torch.from_numpy(x), None)
    np.testing.assert_allclose(_np(got), _np(want), **LAYER_TOL)
    assert new is None
    carried, _ = Ma.mamba_forward(params, cfg, torch.from_numpy(x),
                                  {n: torch.from_numpy(a) for n, a in st.items()})
    assert torch.equal(got, carried)


def test_mamba_forward_refuses_the_kernel_on_the_cpu_and_with_a_state():
    _, _, cfg, _ = _model()
    _, params = _block_params()
    x = torch.zeros((1, 4, cfg.d_model))
    for kind in ("zero", "nonzero"):
        st = {n: torch.from_numpy(a) for n, a in _state(kind, cfg, 1).items()}
        with pytest.raises(ValueError, match="carried state"):
            Ma.mamba_forward(params, cfg, x, st, use_kernel=True)
    with pytest.raises(ValueError, match="use_kernel=True needs CUDA tensors"):
        Ma.mamba_forward(params, cfg, x, None, use_kernel=True)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def test_jamba_config_equals_reference():
    """The published config field by field (and its cut's); it keeps its 16
    experts, so building it raises naming ROADMAP item 12, and the cut runs
    Mamba and attention blocks in the reference's order."""
    full, jfull = registry.get_config(ARCH), jget_config(ARCH)
    for ours, theirs in ((full, jfull), (full.scaled(n_layers=8, **DENSE), jfull.scaled(n_layers=8, **DENSE)),
                         _configs()[::-1]):
        assert {f: getattr(ours, f) for f in ours.__dataclass_fields__} == \
            {f: getattr(theirs, f) for f in theirs.__dataclass_fields__}
    assert full == registry.get_config("jamba-1-5-large-398b")
    assert (full.n_layers, full.d_model, full.n_experts, full.ssm_state) == (72, 8192, 16, 16)
    assert full.param_count() == jfull.param_count()
    with pytest.raises(NotImplementedError, match=r"ROADMAP\.md §1, item 12"):
        M.init_params(full.scaled(n_layers=8), torch.Generator().manual_seed(0))
    cut = full.scaled(n_layers=8, **DENSE)
    assert M.layer_kinds(cut) == ["mamba"] * 4 + ["attn"] + ["mamba"] * 3


_BF16 = {}


def _bf16_reference():
    """(jax cfg, port cfg, tokens, the reference's prefill logits, its
    spread) of the smoke Jamba cut with ``ssm_io_bf16`` on, built once. The
    spread is the largest gap one-ulp copies of the embedding table make in
    the reference's own prefill."""
    if not _BF16:
        jcfg, jp, cfg, tp = _model()
        jcfg, cfg = jcfg.scaled(ssm_io_bf16=True), cfg.scaled(ssm_io_bf16=True)
        toks = np.random.default_rng(18).integers(0, cfg.vocab, (2, 48))
        prefill = jax.jit(lambda p, t: JM.prefill(p, jcfg, {"tokens": t}))
        want = _np(prefill(jp, jnp.asarray(toks)))
        embed = np.asarray(jp["embed"])
        spread = 0.0
        for seed in range(3):
            up = np.random.default_rng(seed).uniform(size=embed.shape) < 0.5
            moved = np.where(up, np.nextafter(embed, np.inf), np.nextafter(embed, -np.inf))
            spread = max(spread, float(np.abs(_np(prefill(dict(jp, embed=jnp.asarray(moved)),
                                                          jnp.asarray(toks))) - want).max()))
        _BF16.update(v=(jcfg, cfg, toks, want, spread))
    return _BF16["v"]


def test_bf16_scan_inputs_match_reference():
    """``ssm_io_bf16``: the reference streams x, dt, B and C through bf16
    (the state's math stays float32, and y comes back in the model's type).
    The smoke Jamba cut with the flag on: prefill logits and three decode
    steps against the reference. Rounding to bf16 turns the two packages'
    float32 summation-order gaps into whole bf16 ulps here and there, so the
    gate is the reference's own spread: 2x the largest gap one-ulp copies of
    the embedding table make in its prefill (about 2.4e-3; the port lies
    about 2.6e-3 away). The flag moves the logits 10x that spread, and
    rounding only some of the inputs misses the gate
    (`test_bf16_scan_inputs_partly_rounded_miss_the_gate`)."""
    _, jp, _, tp = _model()
    jcfg, cfg, toks, want, spread = _bf16_reference()
    got = M.prefill(tp, cfg, {"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.float32
    assert float(np.abs(_np(got) - want).max()) <= 2 * spread
    off = M.prefill(tp, cfg.scaled(ssm_io_bf16=False), {"tokens": torch.from_numpy(toks)})
    assert float((off - got).abs().max()) > 10 * spread
    jcache, cache = JM.init_cache(jcfg, 2, 8), M.init_cache(cfg, 2, 8, "cpu")
    step = jax.jit(lambda p, t, pos, c: JM.decode_step(p, jcfg, t, pos, c))
    for pos in range(3):
        t = toks[:, pos:pos + 1]
        want, jcache = step(jp, jnp.asarray(t, jnp.int32), jnp.int32(pos), jcache)
        got, cache = M.decode_step(tp, cfg, torch.from_numpy(t), pos, cache)
        assert float(np.abs(_np(got) - _np(want)).max()) <= 2 * spread, f"pos {pos}"


@pytest.mark.parametrize("rounded", ["x", "dt", "B", "C", "all but D x"])
def test_bf16_scan_inputs_partly_rounded_miss_the_gate(rounded, monkeypatch):
    """What `test_bf16_scan_inputs_match_reference`'s gate rules out: a
    prefill that rounds only one of x, dt, B and C to bf16, or all four but
    adds D x on the unrounded x, lies beyond 2x the reference's spread."""
    _, _, _, tp = _model()
    _, cfg, toks, want, spread = _bf16_reference()
    scan = Ma.scan_ops.mamba_scan

    def partly(x, dt, Bm, Cm, A, D, h0=None, **kw):
        r = lambda t, name: t.to(torch.bfloat16) if rounded in (name, "all but D x") else t
        xs, dt, Bm, Cm = r(x, "x").to(x.dtype), r(dt, "dt"), r(Bm, "B"), r(Cm, "C")
        y, h = scan(xs, dt, Bm, Cm, A, D, h0, **kw)
        return (y + D * (x - xs) if rounded == "all but D x" else y), h

    monkeypatch.setattr(Ma.scan_ops, "mamba_scan", partly)
    got = M.prefill(tp, cfg.scaled(ssm_io_bf16=False), {"tokens": torch.from_numpy(toks)})
    assert float(np.abs(_np(got) - want).max()) > 2 * spread


def test_bridge_keeps_the_float32_leaves_of_a_bf16_model():
    """The reference's mamba pytree (stages.main.b{j}.mamba) arrives leaf by
    leaf, exactly; dt_bias, A_log and D stay float32 in a bf16 model, as the
    reference keeps them; the port's own init has the same leaves, types and
    shapes."""
    jcfg, cfg = (c.scaled(dtype="bfloat16") for c in _configs())
    jp = JM.init_params(jax.random.PRNGKey(3), jcfg)
    tree = jax.tree.map(np.asarray, jp)
    tp = bridge.lm_params_from_numpy(tree, cfg, device="cpu")
    kinds = [blk.kind for blk in tp.layers]
    assert kinds == list(cfg.block_pattern) * 2
    for layer, blk in enumerate(tp.layers):
        if blk.kind != "mamba":
            assert blk.attn["wq"].dtype == torch.bfloat16
            continue
        src = tree["stages"]["main"][f"b{layer % cfg.pattern_len}"]["mamba"]
        for name, leaf in src.items():
            want = torch.float32 if name in Ma.FLOAT32_LEAVES else torch.bfloat16
            assert blk.mamba[name].dtype == want, name
            assert np.asarray(leaf).dtype == (np.float32 if want == torch.float32 else jnp.bfloat16)
            np.testing.assert_array_equal(blk.mamba[name].float().numpy(),
                                          np.asarray(leaf[layer // cfg.pattern_len], np.float32))
    own = M.init_params(cfg, torch.Generator().manual_seed(0))
    leaves = lambda lm: {jax.tree_util.keystr(k): (tuple(p.shape), p.dtype)
                         for k, p in jax.tree_util.tree_flatten_with_path(lm.tree)[0]}
    assert leaves(own) == leaves(tp)
    blk, src = own.layers[0].mamba, tree["stages"]["main"]["b0"]["mamba"]
    for name in ("A_log", "dt_bias", "D"):   # the same law, computed by each library's log
        np.testing.assert_allclose(blk[name].numpy(), np.asarray(src[name][0]), rtol=1e-6)
    assert abs(float(blk["in_proj"].float().std()) * cfg.d_model ** 0.5 - 1.0) < 0.05


def test_prefill_logits_match_reference():
    """S = 160: ten chunks of the CUDA kernel's 16 steps."""
    jcfg, jp, cfg, tp = _model()
    toks = np.random.default_rng(16).integers(0, cfg.vocab, (2, 160))
    want = jax.jit(lambda p, t: JM.prefill(p, jcfg, {"tokens": t}))(jp, jnp.asarray(toks))
    got = M.prefill(tp, cfg, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (2, 160, cfg.vocab) and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), **LOGIT_TOL)
    assert torch.equal(M.prefill(tp, cfg, {"tokens": torch.from_numpy(toks)}, use_kernel=False), got)


def test_bf16_prefill_rounds_like_the_reference():
    """The bfloat16 model (the chip's configuration) against the same weights
    in float32: the port's bf16 logits lie no farther from the float32 ones
    than 1.25x the reference's bf16 logits do. Measure: the RMS gap over all
    logits of a batch, per model, and its median over five models (seeds 0-4),
    one period each, as in the RWKV test."""
    jcfg32, cfg32 = (c.scaled(n_layers=8) for c in _configs())
    jcfg16, cfg16 = jcfg32.scaled(dtype="bfloat16"), cfg32.scaled(dtype="bfloat16")
    rms = lambda a: float(np.sqrt(np.mean(np.square(a))))
    prefill32 = jax.jit(lambda p, t: JM.prefill(p, jcfg32, {"tokens": t}))
    prefill16 = jax.jit(lambda p, t: JM.prefill(p, jcfg16, {"tokens": t}))
    ratios = []
    for seed in range(5):
        jp16 = JM.init_params(jax.random.PRNGKey(seed), jcfg16)
        jp32 = jax.tree.map(lambda a: a.astype(jnp.float32), jp16)
        toks = np.random.default_rng(100 + seed).integers(0, cfg32.vocab, (2, 96))
        want16 = _np(prefill16(jp16, jnp.asarray(toks)))
        want32 = _np(prefill32(jp32, jnp.asarray(toks)))
        tp16 = bridge.lm_params_from_numpy(jax.tree.map(np.asarray, jp16), cfg16, device="cpu")
        got16 = M.prefill(tp16, cfg16, {"tokens": torch.from_numpy(toks)})
        assert got16.dtype == torch.bfloat16
        ratios.append(rms(_np(got16) - want32) / rms(want16 - want32))
    assert float(np.median(ratios)) <= 1.25, ratios


def test_decode_steps_match_reference():
    """Three cached decode steps after a 12-token prompt fed step by step;
    the carried (conv window, h) reproduces the prefill's last position."""
    jcfg, jp, cfg, tp = _model()
    toks = np.random.default_rng(17).integers(0, cfg.vocab, (2, 15))
    jcache = JM.init_cache(jcfg, 2, 32)
    cache = M.init_cache(cfg, 2, 32, "cpu")
    assert set(cache[0]) == {"conv", "h"} and set(cache[4]) == {"k", "v", "pos_tag"}
    step = jax.jit(lambda p, t, pos, c: JM.decode_step(p, jcfg, t, pos, c))
    for pos in range(15):
        t = toks[:, pos:pos + 1]
        want, jcache = step(jp, jnp.asarray(t, jnp.int32), jnp.int32(pos), jcache)
        got, cache = M.decode_step(tp, cfg, torch.from_numpy(t), pos, cache)
        if pos >= 12:
            np.testing.assert_allclose(_np(got), _np(want), err_msg=f"pos {pos}", **LOGIT_TOL)
    for layer, kind in enumerate(M.layer_kinds(cfg)):
        if kind != "mamba":
            continue
        period, j = divmod(layer, cfg.pattern_len)
        for name in ("conv", "h"):
            np.testing.assert_allclose(_np(cache[layer][name]), _np(jcache["main"][f"b{j}"][name][period]),
                                       atol=1e-4, rtol=1e-5, err_msg=f"layer {layer} {name}")
    full = M.prefill(tp, cfg, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(_np(got)[:, 0], _np(full)[:, -1], **LOGIT_TOL)


@pytest.mark.parametrize("slots,n_req,max_new", [(2, 5, 6), (1, 1, 5)])
def test_serve_loop_tokens_match_reference(slots, n_req, max_new):
    """Greedy tokens identical to the JAX loop's; with 5 requests on 2 slots
    a refilled slot inherits the old slot's state in both."""
    jcfg, jp, cfg, tp = _model()
    rng = np.random.default_rng(18)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab, 4)] for _ in range(n_req)]
    want, _ = JServeLoop(jcfg, jp, slots, max_len=64).run([list(p) for p in prompts], max_new)
    got, stats = ServeLoop(cfg, tp, slots, max_len=64).run([list(p) for p in prompts], max_new)
    assert got == {k: [int(t) for t in v] for k, v in want.items()}
    assert set(got) == set(range(n_req)) and all(len(v) == max_new for v in got.values())
    assert stats["steps"] > 0

"""Parity of the port's flash attention with the JAX reference, on the CPU.

On the CPU, `repro_torch.kernels.flash_attention.ops.flash_attention` takes
the chunked plain version (`repro_torch.models.attention.flash_attention`),
which is the CUDA kernel's plain version. It is held to the reference's
Pallas kernel run in interpret mode (`ops.flash_attention(use_pallas=True,
interpret=True)`) and to the reference's naive oracle, at the JAX tests'
own tolerance (`tests/test_kernels.py`): 2e-5 for float32 and 2e-2 for
bfloat16, absolute and relative. The inputs are drawn with numpy and
rounded to bfloat16 the same way on both sides. The CUDA kernel itself is
held to the same plain version on the card (`tests/test_torch_kernels_cuda.py`,
`chip_smoke.py`).
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as jops, ref as jref
from repro.models.attention import flash_attention as jflash
from repro_torch.kernels.flash_attention import kernel, ops, ref
from repro_torch.models.attention import flash_attention as plain_flash
from torch_port_util import tf32

jax.config.update("jax_default_matmul_precision", "highest")
torch.set_num_threads(1)

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _qkv(seed, B, S, H, KV, hd, dtype):
    """The same q, k, v for both packages: (jax arrays, torch tensors)."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((B, S, n, hd)).astype(np.float32) for n in (H, KV, KV)]
    j = [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrs]
    t = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    return j, t


def _close(got, want, dtype):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=TOL[dtype], rtol=TOL[dtype])


# the cases of tests/test_kernels.py:23-69, and an hd = 256 Gemma-2-like case
CAUSAL_SHAPES = [
    (1, 128, 4, 4, 64),      # MHA
    (2, 256, 4, 2, 64),      # GQA
    (1, 256, 8, 1, 32),      # MQA, small head
    (1, 192, 2, 2, 128),     # S not a block multiple
]


@pytest.mark.parametrize("B,S,H,KV,hd", CAUSAL_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_causal_matches_pallas_interpret(B, S, H, KV, hd, dtype):
    (jq, jk, jv), (q, k, v) = _qkv(0, B, S, H, KV, hd, dtype)
    want = jops.flash_attention(jq, jk, jv, causal=True, use_pallas=True,
                                interpret=True, bq=64, bk=64)
    got = ops.flash_attention(q, k, v, causal=True)
    assert got.dtype == q.dtype and got.shape == q.shape
    _close(got, want, dtype)
    _close(got, jref.naive_attention(jq, jk, jv, causal=True), dtype)


@pytest.mark.parametrize("window,cap,causal,shape", [
    (64, None, True, (2, 256, 4, 2, 64)),        # sliding window
    (None, 50.0, True, (2, 256, 4, 2, 64)),      # gemma softcap
    (None, None, False, (2, 256, 4, 2, 64)),     # encoder (bidirectional)
    (64, 50.0, True, (1, 160, 2, 1, 256)),       # hd 256, window and softcap
])
def test_flash_attention_variants_match_pallas_interpret(window, cap, causal, shape):
    (jq, jk, jv), (q, k, v) = _qkv(1, *shape, "float32")
    want = jops.flash_attention(jq, jk, jv, causal=causal, window=window, cap=cap,
                                use_pallas=True, interpret=True, bq=64, bk=64)
    got = ops.flash_attention(q, k, v, causal=causal, window=window, cap=cap)
    _close(got, want, "float32")
    _close(got, jref.naive_attention(jq, jk, jv, causal=causal, window=window, cap=cap), "float32")


@pytest.mark.parametrize("causal", [False, True], ids=["bidirectional", "causal"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_head_dim_80_matches_pallas_interpret(causal, dtype):
    """HuBERT's head dim 80, MHA, S = 150: not a multiple of the Pallas
    blocks (64) nor of the plain version's chunks (64 here), so the last
    block is ragged."""
    (jq, jk, jv), (q, k, v) = _qkv(7, 2, 150, 2, 2, 80, dtype)
    want = jops.flash_attention(jq, jk, jv, causal=causal, use_pallas=True,
                                interpret=True, bq=64, bk=64)
    got = ops.flash_attention(q, k, v, causal=causal, q_chunk=64, kv_chunk=64)
    assert got.dtype == q.dtype and got.shape == q.shape
    _close(got, want, dtype)
    _close(got, jref.naive_attention(jq, jk, jv, causal=causal), dtype)


@pytest.mark.parametrize("dtype, width", [("bfloat16", 128)])
def test_head_dim_80_at_a_greater_width_is_exact(dtype, width):
    """The bf16 CUDA kernel runs hd 80 at width 128, the columns past 80
    zero, at hd 80's scale: in plain PyTorch that padding leaves the scores
    and the first 80 output columns bit for bit as they are, and the padded
    columns zero. (The float32 kernel runs hd 80 at its own width.)"""
    assert kernel.instantiated_hd(80, getattr(torch, dtype)) == width
    _, (q, k, v) = _qkv(8, 1, 150, 2, 2, 80, dtype)
    pad = lambda x: torch.nn.functional.pad(x.float().transpose(1, 2), (0, width - 80))

    def attend(q, k, v):
        """Scores summed over the head dim, and P V over the keys, one term
        after another in a fixed order (as a kernel's loop adds them)."""
        s = torch.zeros(q.shape[:-1] + (k.shape[-2],))
        for d in range(q.shape[-1]):
            s = s + q[..., :, None, d] * k[..., None, :, d]
        p = torch.softmax(s * kernel.scale_of(80), -1)
        out = torch.zeros(p.shape[:-1] + (v.shape[-1],))
        for key in range(v.shape[-2]):
            out = out + p[..., key, None] * v[..., key, None, :]
        return s, out

    s, out = attend(*(x.float().transpose(1, 2) for x in (q, k, v)))
    s_pad, out_pad = attend(pad(q), pad(k), pad(v))
    assert torch.equal(s, s_pad)
    assert torch.equal(out_pad[..., :80], out)
    assert not out_pad[..., 80:].any()


@pytest.mark.parametrize("dtype, source", [("bfloat16", "flash_fwd_sm90.cuh"),
                                           ("float32", "flash_attention.cu")])
def test_widths_are_the_librarys_dispatch(dtype, source):
    """`HEAD_DIMS` and `instantiated_hd` say what the library's `dispatch_hd`
    for that type instantiates: each case's head dim and the width of the
    `launch` it returns (a change to one table fails here)."""
    text = (kernel.SOURCE.parent / source).read_text()
    switch = text[text.index("switch (hd) {"):]
    switch = switch[:switch.index("default:")]
    cases = {int(hd): int(width) for hd, width in
             re.findall(r"case (\d+): return launch<(?:T, )?(\d+)[,>]", switch)}
    assert tuple(cases) == kernel.HEAD_DIMS
    assert cases == {hd: kernel.instantiated_hd(hd, getattr(torch, dtype)) for hd in cases}


def test_float32_runs_head_dim_80_at_its_own_width():
    assert kernel.instantiated_hd(80, torch.float32) == 80


def test_chunked_flash_matches_reference_chunked():
    """The chunked plain version against the reference's own chunked path,
    with chunks smaller than S and a window (tests/test_kernels.py:60)."""
    (jq, jk, jv), (q, k, v) = _qkv(2, 2, 200, 4, 2, 64, "float32")
    jpos = jnp.arange(200, dtype=jnp.int32)
    pos = torch.arange(200, dtype=torch.int32)
    want = jflash(jq, jk, jv, q_positions=jpos, kv_positions=jpos,
                  causal=True, window=64, q_chunk=64, kv_chunk=64)
    got = plain_flash(q, k, v, q_positions=pos, kv_positions=pos,
                      causal=True, window=64, q_chunk=64, kv_chunk=64)
    _close(got, want, "float32")


def test_chunked_flash_masks_invalid_kv_positions():
    """kv positions < 0 (unwritten ring-buffer slots) add nothing, and a
    query row with no valid key comes out 0, as in the reference."""
    (jq, jk, jv), (q, k, v) = _qkv(3, 1, 96, 2, 1, 32, "float32")
    kvp = np.arange(96, dtype=np.int32)
    kvp[10:40] = -1
    qp = np.arange(96, dtype=np.int32)
    want = jflash(jq, jk, jv, q_positions=jnp.asarray(qp), kv_positions=jnp.asarray(kvp),
                  causal=True, q_chunk=32, kv_chunk=32)
    got = plain_flash(q, k, v, q_positions=torch.from_numpy(qp), kv_positions=torch.from_numpy(kvp),
                      causal=True, q_chunk=32, kv_chunk=32)
    _close(got, want, "float32")
    # row 20 sees keys 0..9 and 20 only; a row whose keys are all invalid is 0
    kvp[:] = -1
    none = plain_flash(q, k, v, q_positions=torch.from_numpy(qp), kv_positions=torch.from_numpy(kvp),
                       causal=True, q_chunk=32, kv_chunk=32)
    assert torch.equal(none, torch.zeros_like(none))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_naive_attention_matches_reference(dtype):
    (jq, jk, jv), (q, k, v) = _qkv(4, 2, 96, 4, 2, 32, dtype)
    want = jref.naive_attention(jq, jk, jv, causal=True, window=40, cap=20.0)
    got = ref.naive_attention(q, k, v, causal=True, window=40, cap=20.0)
    assert got.dtype == q.dtype
    _close(got, want, dtype)


def test_kernel_on_cpu_tensors_raises():
    _, (q, k, v) = _qkv(5, 1, 64, 2, 1, 64, "float32")
    with pytest.raises(ValueError, match="use_kernel=True needs CUDA tensors"):
        ops.flash_attention(q, k, v, use_kernel=True)
    with pytest.raises(ValueError, match="CUDA device"):
        kernel.flash_attention(q, k, v)
    before = kernel.launches
    ops.flash_attention(q, k, v)                 # "auto" on the CPU: the plain version
    assert kernel.launches == before


def test_kernel_scale_is_the_plain_versions():
    for hd in kernel.HEAD_DIMS:
        plain = 1.0 / torch.sqrt(torch.tensor(float(hd), dtype=torch.float32))
        assert kernel.scale_of(hd) == float(plain)


#: the bf16 gate the CUDA kernel is held to on the card (`FLASH_TOL` in
#: chip_smoke.py and tests/test_torch_kernels_cuda.py): one bf16 ulp of the
#: plain version's output
BF16_GATE = (1e-4, 2**-7)


def _p_rounded(q, k, v, *, cap, split):
    """The bf16 tensor-core kernel's rounding of P, in plain PyTorch: causal
    scores and softmax in float32 from bf16 q and k, then P V with P rounded
    once to bf16 (P_hi) or split into two bf16 terms, P_hi + bf16(P - P_hi)
    (``split``); V is bf16, so the products are exact and only the sums are
    float32, as on the tensor cores. Out in bf16."""
    S, H, hd = q.shape[1], q.shape[2], q.shape[3]
    G = H // k.shape[2]
    qf = q.float().transpose(1, 2)
    kf, vf = (x.float().transpose(1, 2).repeat_interleave(G, 1) for x in (k, v))
    s = cap * torch.tanh((qf @ kf.transpose(-1, -2)) * kernel.scale_of(hd) / cap)
    s = s.masked_fill(torch.ones(S, S, dtype=torch.bool).triu(1), -torch.inf)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    hi = p.to(torch.bfloat16).float()
    pv = hi @ vf
    if split:
        pv = pv + (p - hi).to(torch.bfloat16).float() @ vf
    return (pv / p.sum(-1, keepdim=True)).transpose(1, 2).to(torch.bfloat16)


@pytest.mark.parametrize("hd", [64, 256])
def test_bf16_kernel_needs_p_split_into_two_bf16_terms(hd):
    """Why the bf16 kernel computes P V as P_hi V + P_lo V (6 hd tensor-core
    operations a pair instead of 4 hd): with P rounded once to bf16, as
    FlashAttention-2/3 and SDPA round it, the output misses the one-ulp gate
    against the float32 plain version; with the split it stays inside."""
    _, (q, k, v) = _qkv(6, 1, 512, 4, 2, hd, "bfloat16")
    pos = torch.arange(512, dtype=torch.int32)
    want = plain_flash(q, k, v, q_positions=pos, kv_positions=pos, causal=True, cap=50.0).float()
    atol, rtol = BF16_GATE
    lim = atol + rtol * want.abs()
    split = (_p_rounded(q, k, v, cap=50.0, split=True).float() - want).abs() / lim
    once = (_p_rounded(q, k, v, cap=50.0, split=False).float() - want).abs() / lim
    assert float(split.max()) <= 1.0
    assert float(once.max()) > 4.0


#: the float32 gate the CUDA kernel is held to on the card (`FLASH_TOL` in
#: chip_smoke.py and tests/test_torch_kernels_cuda.py)
F32_GATE = (2e-5, 2e-5)


def _tf32_products(q, k, v, *, cap, three):
    """The float32 kernel's products in plain PyTorch: causal scores and
    softmax in float32, with Q K^T and P V each one TF32 product of the
    operands rounded to tf32 or (``three``) three, A_hi B_hi + (A_hi B_lo +
    A_lo B_hi) with A_lo = tf32(A - A_hi); tf32 products are exact in
    float32, so only the sums are float32, as on the tensor cores."""
    S, H, hd = q.shape[1], q.shape[2], q.shape[3]
    G = H // k.shape[2]
    qf = q.transpose(1, 2)
    kf, vf = (x.transpose(1, 2).repeat_interleave(G, 1) for x in (k, v))

    def mm(a, b):
        a_hi, b_hi = tf32(a), tf32(b)
        if not three:
            return a_hi @ b_hi
        return a_hi @ b_hi + (a_hi @ tf32(b - b_hi) + tf32(a - a_hi) @ b_hi)

    s = cap * torch.tanh(mm(qf, kf.transpose(-1, -2)) * kernel.scale_of(hd) / cap)
    s = s.masked_fill(torch.ones(S, S, dtype=torch.bool).triu(1), -torch.inf)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    return (mm(p, vf) / p.sum(-1, keepdim=True)).transpose(1, 2)


@pytest.mark.parametrize("hd", [80, 128, 256])
def test_f32_kernel_needs_three_tf32_products(hd):
    """Why the float32 kernel computes each product as three TF32 products
    (12 hd tensor-core operations a pair instead of 4 hd): with the operands
    rounded once to tf32 the output misses the float32 gate against the
    plain version; split into hi and lo it stays far inside."""
    _, (q, k, v) = _qkv(9, 1, 512, 4, 2, hd, "float32")
    pos = torch.arange(512, dtype=torch.int32)
    want = plain_flash(q, k, v, q_positions=pos, kv_positions=pos, causal=True, cap=50.0)
    atol, rtol = F32_GATE
    lim = atol + rtol * want.abs()
    three = (_tf32_products(q, k, v, cap=50.0, three=True) - want).abs() / lim
    once = (_tf32_products(q, k, v, cap=50.0, three=False) - want).abs() / lim
    assert float(three.max()) <= 0.25
    assert float(once.max()) > 1.0

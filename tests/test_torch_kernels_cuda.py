"""The port's CUDA kernels against their plain versions, on the card.

A CUDA kernel has no CPU mode, so every test here carries the ``cuda``
marker and skips without a card. This file imports neither JAX nor the
reference package, so it runs where only the port is installed:

    python -m pytest -m cuda tests/test_torch_kernels_cuda.py
"""
import pytest
import torch

from repro_torch.kernels.fedsem_objective import kernel, ops, ref
from repro_torch.kernels.flash_attention import kernel as flash_kernel, ops as flash_ops
from repro_torch.kernels.mamba_scan import kernel as scan_kernel, ops as scan_ops, ref as scan_ref
from repro_torch.kernels.rwkv6_scan import kernel as wkv_kernel, ops as wkv_ops, ref as wkv_ref
from repro_torch.models.attention import flash_attention as plain_flash
import p4_adam_checks
from torch_port_util import assert_scores, grid_inputs, tf32

XI, ETA, AB = 1e-28, 10, (0.6356, 0.4025)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("B,G,N", [(16, 3, 10), (48, 1, 10), (3, 700, 4), (64, 8192, 8)])
@pytest.mark.parametrize("feasible_mask", [True, False], ids=["feas", "raw"])
def test_objective_batch_kernel_matches_plain_version(card, B, G, N, feasible_mask):
    args, mask = grid_inputs(14, B, G, N)
    t = [torch.from_numpy(a).to(card) for a in args]
    kap = [torch.linspace(0.5, 2.0, B, device=card), 1.0, torch.full((B,), 1.3, device=card)]
    kw = dict(xi=XI, eta=ETA, accuracy_ab=AB, dev_mask=torch.from_numpy(mask).to(card),
              check_feasible=feasible_mask)
    before = kernel.launches
    got = ops.objective_grid_batch(*t, *kap, **kw)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    want = ref.objective_grid_batch(*t, *kap, **kw)
    assert_scores(got.cpu().numpy(), want.cpu().numpy())


@pytest.mark.cuda
def test_objective_grid_kernel_matches_plain_version(card):
    args, _ = grid_inputs(15, 1, 1024, 10)
    t = [torch.from_numpy(a[0]).to(card) for a in args]
    mask = torch.tensor([1.0] * 5 + [0.0] * 5, device=card)
    got = ops.objective_grid(*t, XI, ETA, 0.8, 1.0, 1.2, AB, dev_mask=mask)
    want = ref.objective_grid(*t, XI, ETA, 0.8, 1.0, 1.2, AB, mask)
    assert_scores(got.cpu().numpy(), want.cpu().numpy())


@pytest.mark.cuda
def test_wrapper_refuses_what_the_kernel_does_not_take(card):
    args, mask = grid_inputs(16, 2, 5, 4)
    t = [torch.from_numpy(a).to(card) for a in args]
    with pytest.raises(ValueError, match="shape"):
        kernel.objective_batch(t[0], t[1][:, :4], *t[2:], None, 1.0, 1.0, 1.0, *AB, xi=XI, eta=ETA)
    with pytest.raises(ValueError, match="is on"):
        kernel.objective_batch(t[0], t[1].cpu(), *t[2:], None, 1.0, 1.0, 1.0, *AB, xi=XI, eta=ETA)


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

#: (atol, rtol) per dtype: float32 the JAX tests' 2e-5 (tests/test_kernels.py);
#: bfloat16 one ulp of the output, since kernel and plain version both work in
#: float32 on the same inputs and differ only in the output's rounding
FLASH_TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (1e-4, 2**-7)}


def _qkv(card, seed, B, S, H, KV, hd, dtype):
    gen = torch.Generator(device=card).manual_seed(seed)
    return [torch.randn((B, S, n, hd), generator=gen, device=card).to(dtype) for n in (H, KV, KV)]


def _plain(q, k, v, **kw):
    pos = torch.arange(q.shape[1], dtype=torch.int32, device=q.device)
    return plain_flash(q, k, v, q_positions=pos, kv_positions=pos, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,KV,hd", [
    (1, 128, 4, 4, 64),      # MHA
    (2, 256, 4, 2, 64),      # GQA
    (1, 256, 8, 1, 32),      # MQA, small head
    (1, 192, 2, 2, 128),     # S not a block multiple
    (2, 300, 8, 4, 256),     # Gemma-2's head dim and GQA ratio
    (1, 2048, 4, 2, 256),    # long S: the late rows' outputs are small
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_flash_kernel_matches_plain_version(card, B, S, H, KV, hd, dtype):
    q, k, v = _qkv(card, 21, B, S, H, KV, hd, dtype)
    before = flash_kernel.launches
    got = flash_ops.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert flash_kernel.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = _plain(q, k, v, causal=True)
    atol, rtol = FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("causal,window,cap", [
    (True, 64, None), (True, None, 50.0), (False, None, None), (False, 48, None),
    (True, 64, 50.0), (True, 1, None),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_flash_kernel_masks_and_softcap(card, causal, window, cap, dtype):
    q, k, v = _qkv(card, 22, 2, 257, 4, 2, 64, dtype)
    got = flash_kernel.flash_attention(q, k, v, causal=causal, window=window, cap=cap)
    want = _plain(q, k, v, causal=causal, window=window, cap=cap)
    atol, rtol = FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_flash_kernel_reads_strided_inputs(card, dtype):
    """q, k, v as views of one fused projection (the head dim contiguous)."""
    gen = torch.Generator(device=card).manual_seed(23)
    fused = torch.randn((2, 200, 4 + 2 + 2, 64), generator=gen, device=card).to(dtype)
    q, k, v = fused[:, :, :4], fused[:, :, 4:6], fused[:, :, 6:]
    assert not q.is_contiguous()
    got = flash_kernel.flash_attention(q, k, v, causal=True, window=50)
    want = _plain(q.contiguous(), k.contiguous(), v.contiguous(), causal=True, window=50)
    atol, rtol = FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [200, 1000])
@pytest.mark.parametrize("hd", [32, 64, 128, 256])
def test_flash_kernel_bf16_ragged_tiles(card, S, hd):
    """S not a multiple of the tensor-core kernel's 128 query rows or its kv
    tiles (128 keys, 64 at hd 256), with GQA, at every head dim."""
    q, k, v = _qkv(card, 25, 2, S, 4, 2, hd, torch.bfloat16)
    got = flash_kernel.flash_attention(q, k, v, causal=True)
    want = _plain(q, k, v, causal=True)
    atol, rtol = FLASH_TOL[torch.bfloat16]
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [200, 1000])
@pytest.mark.parametrize("hd", [32, 64, 80, 128, 256])
def test_flash_kernel_f32_ragged_tiles(card, S, hd):
    """S not a multiple of the float32 kernel's query rows (128; 64 at hd
    256) or its kv tiles (64 keys; 32 at hd 256), with GQA, at every head
    dim: 3xTF32 on the tensor cores against the float32 gate."""
    q, k, v = _qkv(card, 29, 2, S, 4, 2, hd, torch.float32)
    got = flash_kernel.flash_attention(q, k, v, causal=True)
    want = _plain(q, k, v, causal=True)
    atol, rtol = FLASH_TOL[torch.float32]
    torch.testing.assert_close(got, want, atol=atol, rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True], ids=["bidirectional", "causal"])
@pytest.mark.parametrize("S", [77, 200, 1000])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_flash_kernel_head_dim_80(card, causal, S, dtype):
    """HuBERT's head dim, at width 128 in the bf16 kernel (TMA zero-fills
    columns 80-127) and at its own width in the float32 kernel, with GQA
    and S ragged against every block size."""
    q, k, v = _qkv(card, 27, 2, S, 4, 2, 80, dtype)
    before = flash_kernel.launches
    got = flash_ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_kernel.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = _plain(q, k, v, causal=causal)
    atol, rtol = FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_flash_kernel_hubert_layer(card, dtype):
    """HuBERT X-Large's attention: B 4, S 1500 (30 s of 50 Hz frames: the
    last 128-row block ragged), 16 heads of 80, bidirectional; q, k, v as
    views of one fused projection, so the columns past 80 of a head are the
    next head's (the kernel must not read them)."""
    gen = torch.Generator(device=card).manual_seed(28)
    fused = torch.randn((4, 1500, 3 * 16, 80), generator=gen, device=card).to(dtype)
    q, k, v = fused[:, :, :16], fused[:, :, 16:32], fused[:, :, 32:]
    got = flash_kernel.flash_attention(q, k, v, causal=False)
    want = _plain(q.contiguous(), k.contiguous(), v.contiguous(), causal=False)
    atol, rtol = FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


@pytest.mark.cuda
def test_flash_wrapper_refuses_what_the_kernel_does_not_take(card):
    q, k, v = _qkv(card, 24, 1, 64, 4, 2, 64, torch.float32)
    with pytest.raises(ValueError, match="head dim"):
        flash_kernel.flash_attention(q[..., :48], k[..., :48], v[..., :48])
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        flash_kernel.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="do not match"):
        flash_kernel.flash_attention(q[:, :, :3], k, v)
    with pytest.raises(ValueError, match="one CUDA device"):
        flash_kernel.flash_attention(q, k.cpu(), v)
    with pytest.raises(ValueError, match="not contiguous"):
        flash_kernel.flash_attention(q, k.transpose(-1, -2).contiguous().transpose(-1, -2), v)


@pytest.mark.cuda
def test_flash_wrapper_refuses_bf16_views_tma_cannot_load(card):
    """The tensor-core kernel's TMA loads want 16-byte starts and strides;
    other bf16 views raise instead of falling back."""
    gen = torch.Generator(device=card).manual_seed(26)
    fused = torch.randn((1, 64, 4, 72), generator=gen, device=card).to(torch.bfloat16)
    q = fused[..., 1:65]                                  # starts 2 bytes in
    k = v = fused[:, :, :2, 8:72]
    with pytest.raises(ValueError, match="16 bytes"):
        flash_kernel.flash_attention(q, k, v)
    flat = torch.randn((1, 64, 68), generator=gen, device=card).to(torch.bfloat16)
    odd = flat[..., :64].unsqueeze(2)                     # seq stride 68 elements
    with pytest.raises(ValueError, match="16 bytes"):
        flash_kernel.flash_attention(odd, odd, odd)
    before = flash_kernel.launches
    got = flash_kernel.flash_attention(fused[..., 8:72], k, v)   # aligned views run
    torch.cuda.synchronize()
    assert flash_kernel.launches == before + 1
    want = _plain(fused[..., 8:72].contiguous(), k.contiguous(), v.contiguous(), causal=True)
    atol, rtol = FLASH_TOL[torch.bfloat16]
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


@pytest.mark.cuda
def test_flash_wrapper_refuses_f32_views_tma_cannot_load(card):
    """The float32 kernel's TMA loads want 16-byte starts and strides too:
    float32 views that break that raise instead of falling back."""
    gen = torch.Generator(device=card).manual_seed(30)
    fused = torch.randn((1, 64, 4, 68), generator=gen, device=card)
    q = fused[..., 1:65]                                  # starts 4 bytes in
    k = v = fused[:, :, :2, 4:68]
    with pytest.raises(ValueError, match="16 bytes"):
        flash_kernel.flash_attention(q, k, v)
    flat = torch.randn((1, 64, 66), generator=gen, device=card)
    odd = flat[..., :64].unsqueeze(2)                     # seq stride 66 elements
    with pytest.raises(ValueError, match="16 bytes"):
        flash_kernel.flash_attention(odd, odd, odd)
    before = flash_kernel.launches
    got = flash_kernel.flash_attention(fused[..., 4:68], k, v)   # aligned views run
    torch.cuda.synchronize()
    assert flash_kernel.launches == before + 1
    want = _plain(fused[..., 4:68].contiguous(), k.contiguous(), v.contiguous(), causal=True)
    atol, rtol = FLASH_TOL[torch.float32]
    torch.testing.assert_close(got, want, atol=atol, rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_flash_launcher_refuses_more_than_65535_row_blocks(card, dtype):
    """Both launchers know their blocks' query rows (128 at hd 32) and
    refuse a grid of more than 65535 of them, before anything runs."""
    q = torch.empty((1, 65535 * 128 + 1, 1, 32), dtype=dtype, device=card)
    before = flash_kernel.launches
    with pytest.raises(RuntimeError, match="CUDA error 9"):
        flash_kernel.flash_attention(q, q, q)
    assert flash_kernel.launches == before


@pytest.mark.cuda
def test_tf32_tensor_core_sums_truncate(card):
    """Why the float32 flash kernel sums Q K^T's small terms in their own
    accumulator and P V a half tile at a time, adding each partial to its
    float32 sum with FMAs: the TF32 tensor cores' float32 adds truncate.
    Products of tf32 values are exact in float32, so only the sums round;
    over 256 positive terms the tensor cores' sums fall more than 5 ulp
    short of float64's on average, the CUDA cores' are unbiased."""
    gen = torch.Generator(device=card).manual_seed(0)
    a = tf32(torch.rand((512, 256), generator=gen, device=card))
    b = tf32(torch.rand((256, 512), generator=gen, device=card))
    exact = a.double() @ b.double()
    ulp = torch.finfo(torch.float32).eps * exact
    flag = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        tensor_cores = a @ b
        torch.backends.cuda.matmul.allow_tf32 = False
        cuda_cores = a @ b
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag
    assert float(((tensor_cores.double() - exact) / ulp).mean()) < -5.0
    assert abs(float(((cuda_cores.double() - exact) / ulp).mean())) < 0.1


# ---------------------------------------------------------------------------
# the WKV6 recurrence
# ---------------------------------------------------------------------------

#: (atol, rtol) per dtype: float32 the JAX tests' 1e-4; bfloat16 one ulp of
#: the output, since kernel and plain version evolve the same float32 state
#: and differ only in the order of the sum over the key index
WKV_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-5, 2**-7)}


def _rkvwu(card, seed, B, H, S, hd, dtype, model_layout=False):
    """r, k, v, w, u of the reference test's law; with ``model_layout`` as
    (B, H, S, hd) views of (B, S, H, hd) tensors and w near the model's
    exp(-exp(-6))."""
    gen = torch.Generator(device=card).manual_seed(seed)
    if model_layout:
        draw = lambda: torch.randn((B, S, H, hd), generator=gen, device=card).transpose(1, 2)
    else:
        draw = lambda: torch.randn((B, H, S, hd), generator=gen, device=card)
    r, k, v = draw(), draw(), draw()
    w = torch.exp(-torch.exp(-6.0 + 0.5 * draw())) if model_layout else torch.sigmoid(draw()) * 0.5 + 0.45
    u = torch.randn((H, hd), generator=gen, device=card)
    return [x.to(dtype) for x in (r, k, v, w, u)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,S,hd", [
    (1, 2, 128, 64), (2, 4, 96, 32),      # the reference's test shapes
    (2, 3, 77, 64),                       # S not a chunk multiple
    (1, 4, 300, 64),                      # several chunks, the last one ragged
    (3, 2, 5, 32),                        # S shorter than one chunk
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_wkv_kernel_matches_plain_version(card, B, H, S, hd, dtype):
    r, k, v, w, u = _rkvwu(card, 31, B, H, S, hd, dtype)
    before = wkv_kernel.launches
    got, final = wkv_ops.rwkv6_scan(r, k, v, w, u)
    torch.cuda.synchronize()
    assert wkv_kernel.launches == before + 1
    assert got.dtype == dtype and got.shape == r.shape and final is None
    want = wkv_ref.rwkv6_scan(r, k, v, w, u)[0]
    atol, rtol = WKV_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("w_dtype,out_dtype", [
    (torch.float32, torch.float32),       # the model's: bf16 projections, float32 decay and y
    (torch.float32, torch.bfloat16),
    (torch.bfloat16, torch.float32),
], ids=["w32-y32", "w32-y16", "w16-y32"])
def test_wkv_kernel_takes_mixed_types(card, w_dtype, out_dtype):
    """bfloat16 r, k, v with w and y in their own types: the float32
    recurrence on the same values, y rounded once to its type."""
    r, k, v, w, u = _rkvwu(card, 34, 2, 3, 77, 64, torch.bfloat16)
    w = (torch.sigmoid(torch.randn(w.shape, generator=torch.Generator(device=card).manual_seed(35),
                                   device=card)) * 0.5 + 0.45).to(w_dtype)
    got = wkv_kernel.rwkv6_scan(r, k, v, w, u, out_dtype)
    assert got.dtype == out_dtype
    want = wkv_ref.rwkv6_scan(r, k, v, w, u, out_dtype=out_dtype)[0]
    atol, rtol = WKV_TOL[out_dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


@pytest.mark.cuda
def test_wkv_kernel_reads_the_models_layout(card):
    """(B, H, S, hd) views of (B, S, H, hd) tensors, w near 0.9975 over 2048
    steps: read by stride, y written in r's layout."""
    r, k, v, w, u = _rkvwu(card, 32, 1, 8, 2048, 64, torch.float32, model_layout=True)
    assert not r.is_contiguous()
    got = wkv_kernel.rwkv6_scan(r, k, v, w, u)
    assert got.stride() == r.stride()
    want = wkv_ref.rwkv6_scan(r, k, v, w, u)[0]
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


def _wkv_models_types(card, seed, B, H, S, hd, decay=-6.0):
    """What the bf16 model hands the kernel: bf16 r/k/v and float32 w as
    (B, H, S, hd) views of (B, S, H, hd) tensors, w = exp(-exp(decay + 0.5 z))
    (the model's law near 0.9975 at decay -6, a strong decay at 1)."""
    gen = torch.Generator(device=card).manual_seed(seed)
    draw = lambda: torch.randn((B, S, H, hd), generator=gen, device=card).transpose(1, 2)
    r, k, v = (draw().to(torch.bfloat16) for _ in range(3))
    w = torch.exp(-torch.exp(decay + 0.5 * draw()))
    return r, k, v, w, torch.randn((H, hd), generator=gen, device=card)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [5, 77, 300, 1025])
@pytest.mark.parametrize("hd", [32, 64])
def test_wkv_kernel_ragged_chunks(card, S, hd):
    """S not a multiple of the kernel's chunk (hd / 2 steps, the run its
    transposing shuffle pass sums over) in the model's types: the steps of
    the last chunk past S load zeros and store nothing."""
    args = _wkv_models_types(card, 36, 2, 3, S, hd)
    got = wkv_kernel.rwkv6_scan(*args, torch.float32)
    want = wkv_ref.rwkv6_scan(*args, out_dtype=torch.float32)[0]
    atol, rtol = WKV_TOL[torch.float32]
    torch.testing.assert_close(got, want, atol=atol, rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [32, 64])
def test_wkv_kernel_strong_decay(card, hd):
    """w = exp(-exp(1 + 0.5 z)), near 0.07: the state forgets within a few
    steps, so y is about r (k v) u + r k_{t-1} v_{t-1} w and small."""
    args = _wkv_models_types(card, 37, 2, 4, 1024, hd, decay=1.0)
    got = wkv_kernel.rwkv6_scan(*args, torch.float32)
    want = wkv_ref.rwkv6_scan(*args, out_dtype=torch.float32)[0]
    atol, rtol = WKV_TOL[torch.float32]
    torch.testing.assert_close(got, want, atol=atol, rtol=rtol)


@pytest.mark.cuda
def test_wkv_kernel_reads_views_cp_async_cannot(card):
    """bf16 rows that start 2 bytes past a 16-byte boundary: the kernel
    stages them with plain loads, not cp.async."""
    gen = torch.Generator(device=card).manual_seed(38)
    B, S, H, hd = 2, 100, 3, 64
    base = [torch.randn((B, S, H * hd + 1), generator=gen, device=card).to(torch.bfloat16)
            for _ in range(3)]
    r, k, v = (x[:, :, 1:].view(B, S, H, hd).transpose(1, 2) for x in base)
    assert r.data_ptr() % 16 and r.stride(2) % 8
    w = torch.exp(-torch.exp(-6.0 + 0.5 * torch.randn((B, H, S, hd), generator=gen, device=card)))
    u = torch.randn((H, hd), generator=gen, device=card)
    got = wkv_kernel.rwkv6_scan(r, k, v, w, u, torch.float32)
    want = wkv_ref.rwkv6_scan(r, k, v, w, u, out_dtype=torch.float32)[0]
    atol, rtol = WKV_TOL[torch.float32]
    torch.testing.assert_close(got, want, atol=atol, rtol=rtol)


@pytest.mark.cuda
def test_wkv_wrapper_refuses_what_the_kernel_does_not_take(card):
    r, k, v, w, u = _rkvwu(card, 33, 1, 2, 16, 64, torch.float32)
    with pytest.raises(ValueError, match="head dim"):
        wkv_kernel.rwkv6_scan(*(x[..., :48] for x in (r, k, v, w)), u[:, :48])
    with pytest.raises(ValueError, match="float32 or all bfloat16"):
        wkv_kernel.rwkv6_scan(r, k, v.half(), w, u)
    with pytest.raises(ValueError, match="must be float32 or bfloat16"):
        wkv_kernel.rwkv6_scan(r, k, v, w.half(), u)
    with pytest.raises(ValueError, match="must be float32 or bfloat16"):
        wkv_kernel.rwkv6_scan(r, k, v, w, u, torch.float16)
    with pytest.raises(ValueError, match="one shape"):
        wkv_kernel.rwkv6_scan(r, k[:, :, :8], v, w, u)
    with pytest.raises(ValueError, match=r"want \(H, hd\)"):
        wkv_kernel.rwkv6_scan(r, k, v, w, u[:1])
    with pytest.raises(ValueError, match="one CUDA device"):
        wkv_kernel.rwkv6_scan(r, k, v, w.cpu(), u)
    with pytest.raises(ValueError, match="not contiguous"):
        wkv_kernel.rwkv6_scan(r, k, v, w.transpose(-1, -2).contiguous().transpose(-1, -2), u)


@pytest.mark.cuda
def test_rwkv_prefill_goes_through_the_kernel(card):
    """The smoke RWKV model on the card: one launch per layer, logits within
    float32 round-off of the plain recurrence's; decode launches nothing, and
    the kernel refuses a carried state rather than handing it to the plain
    recurrence."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import model as M, rwkv as R
    from repro_torch.models.config import smoke_variant

    cfg = smoke_variant(get_config("rwkv6_1_6b"))
    params = M.init_params(cfg, torch.Generator(device=card).manual_seed(0))
    toks = torch.randint(0, cfg.vocab, (2, 100), generator=torch.Generator(device=card).manual_seed(1),
                         device=card)
    before = wkv_kernel.launches
    got = M.prefill(params, cfg, {"tokens": toks}, use_kernel=True)
    torch.cuda.synchronize()
    assert wkv_kernel.launches == before + cfg.n_layers
    want = M.prefill(params, cfg, {"tokens": toks}, use_kernel=False)
    torch.testing.assert_close(got, want, atol=4e-5, rtol=1e-4)
    cache = M.init_cache(cfg, 2, 16, card)
    M.decode_step(params, cfg, toks[:, :1], 0, cache)
    assert wkv_kernel.launches == before + cfg.n_layers
    x = torch.zeros((2, 3, cfg.d_model), device=card)
    with pytest.raises(ValueError, match="carried state"):
        R.time_mix(params.layers[0].rwkv, cfg, x, cache[0], use_kernel=True)


# ---------------------------------------------------------------------------
# the selective scan
# ---------------------------------------------------------------------------

#: (atol, rtol) by y's type: float32 the JAX tests' 1e-4; bfloat16 one ulp of
#: the output, since kernel and plain version evolve the same float32 state
#: and differ only in the order of the sum over the state
SCAN_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-5, 2**-7)}


def _scan_inputs(card, seed, B, S, di, N, dtype, model_law=False):
    """x, dt, Bm, Cm, A, D of the reference test's law (x and dt in
    ``dtype``, the rest float32); with ``model_law`` dt near the model's
    softplus(log(expm1(0.01))) and A = -(1..N), as the initialised Jamba
    has them."""
    gen = torch.Generator(device=card).manual_seed(seed)
    draw = lambda *shape: torch.randn(shape, generator=gen, device=card)
    x = draw(B, S, di)
    if model_law:
        dt = torch.nn.functional.softplus(-4.6 + 0.5 * draw(B, S, di))
        A = -torch.arange(1, N + 1, dtype=torch.float32, device=card).repeat(di, 1)
    else:
        dt = torch.nn.functional.softplus(draw(B, S, di)) * 0.1
        A = -draw(di, N).abs()
    Bm, Cm = draw(B, S, N), draw(B, S, N)
    D = 1.0 + 0.5 * draw(di)
    return x.to(dtype), dt.to(dtype), Bm, Cm, A, D


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,di,N", [
    (1, 64, 128, 8), (2, 96, 64, 16),     # the reference's test shapes
    (2, 77, 96, 16),                      # S not a chunk multiple, di not a block multiple
    (1, 300, 200, 16),                    # several chunks, the last one ragged
    (3, 5, 64, 8),                        # S shorter than one chunk
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_scan_kernel_matches_plain_version(card, B, S, di, N, dtype):
    x, dt, Bm, Cm, A, D = _scan_inputs(card, 41, B, S, di, N, dtype)
    before = scan_kernel.launches
    got, final = scan_ops.mamba_scan(x, dt, Bm, Cm, A, D)
    torch.cuda.synchronize()
    assert scan_kernel.launches == before + 1
    assert got.dtype == dtype and got.shape == x.shape and final is None
    want = scan_ref.mamba_scan(x, dt, Bm, Cm, A, D)[0]
    atol, rtol = SCAN_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


@pytest.mark.cuda
def test_scan_kernel_takes_the_models_types(card):
    """bfloat16 x, float32 dt, B and C as bfloat16 column views of one
    projection (the model's), at the model's law over 1024 steps: read by
    stride, the float32 recurrence on the same values, y rounded once to
    x's type."""
    x, dt, _, _, A, D = _scan_inputs(card, 42, 2, 1024, 256, 16, torch.float32, model_law=True)
    gen = torch.Generator(device=card).manual_seed(43)
    proj = torch.randn((2, 1024, 16 + 32), generator=gen, device=card).to(torch.bfloat16)
    Bm, Cm = proj[..., 16:32], proj[..., 32:]
    assert not Bm.is_contiguous()
    x = x.to(torch.bfloat16)
    got = scan_kernel.mamba_scan(x, dt, Bm, Cm, A, D)
    assert got.dtype == torch.bfloat16 and got.is_contiguous()
    want = scan_ref.mamba_scan(x, dt, Bm, Cm, A, D)[0]
    atol, rtol = SCAN_TOL[torch.bfloat16]
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16], ids=["f32_x", "bf16_x"])
def test_scan_kernel_takes_bf16_scan_inputs(card, x_dtype):
    """``ssm_io_bf16``: dt, B and C in bf16 (a bf16 model's x is bf16; a
    float32 model's x holds bf16-rounded values in float32), at the model's
    law over 1024 steps."""
    x, dt, Bm, Cm, A, D = _scan_inputs(card, 48, 2, 1024, 256, 16, torch.float32, model_law=True)
    x = x.to(torch.bfloat16).to(x_dtype)
    dt, Bm, Cm = dt.to(torch.bfloat16), Bm.to(torch.bfloat16), Cm.to(torch.bfloat16)
    before = scan_kernel.launches
    got, _ = scan_ops.mamba_scan(x, dt, Bm, Cm, A, D)
    torch.cuda.synchronize()
    assert scan_kernel.launches == before + 1 and got.dtype == x_dtype
    want = scan_ref.mamba_scan(x, dt, Bm, Cm, A, D)[0]
    atol, rtol = SCAN_TOL[x_dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


@pytest.mark.cuda
def test_scan_kernel_exponential_underflows(card):
    """dt = softplus(z + 2) with A = -(1..16): dt A reaches about -100, past
    the -87.3 below which exp(dt A) is subnormal (the kernel's ex2.approx.ftz
    flushes it to 0); the model's types."""
    x, dt, _, _, A, D = _scan_inputs(card, 45, 1, 1024, 256, 16, torch.float32, model_law=True)
    dt = torch.nn.functional.softplus(
        torch.randn(dt.shape, generator=torch.Generator(device=card).manual_seed(46), device=card) + 2.0)
    assert float(dt.max() * A.min()) < -87.3
    gen = torch.Generator(device=card).manual_seed(47)
    proj = torch.randn((1, 1024, 16 + 32), generator=gen, device=card).to(torch.bfloat16)
    Bm, Cm, x = proj[..., 16:32], proj[..., 32:], x.to(torch.bfloat16)
    got = scan_kernel.mamba_scan(x, dt, Bm, Cm, A, D)
    want = scan_ref.mamba_scan(x, dt, Bm, Cm, A, D)[0]
    assert bool(torch.isfinite(got.float()).all())
    atol, rtol = SCAN_TOL[torch.bfloat16]
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("di", [100, 200, 1000])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_scan_kernel_ragged_channel_tiles(card, di, dtype):
    """di not a multiple of the kernel's 64-channel tile: the last block's
    channels past di load zeros and store nothing (at di 100 the bf16 rows
    are not 16-byte multiples, and x and dt take plain loads)."""
    x, dt, Bm, Cm, A, D = _scan_inputs(card, 48, 2, 131, di, 16, dtype, model_law=True)
    got = scan_kernel.mamba_scan(x, dt, Bm, Cm, A, D)
    want = scan_ref.mamba_scan(x, dt, Bm, Cm, A, D)[0]
    atol, rtol = SCAN_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


@pytest.mark.cuda
def test_scan_wrapper_refuses_what_the_kernel_does_not_take(card):
    x, dt, Bm, Cm, A, D = _scan_inputs(card, 44, 1, 16, 64, 16, torch.float32)
    with pytest.raises(ValueError, match="state size"):
        scan_kernel.mamba_scan(x, dt, Bm[..., :4], Cm[..., :4], A[:, :4], D)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        scan_kernel.mamba_scan(x.half(), dt, Bm, Cm, A, D)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        scan_kernel.mamba_scan(x, dt.half(), Bm, Cm, A, D)
    with pytest.raises(ValueError, match="differ in type"):
        scan_kernel.mamba_scan(x, dt, Bm, Cm.to(torch.bfloat16), A, D)
    with pytest.raises(ValueError, match="one shape"):
        scan_kernel.mamba_scan(x, dt[:, :8], Bm, Cm, A, D)
    with pytest.raises(ValueError, match="want Bm and Cm"):
        scan_kernel.mamba_scan(x, dt, Bm[:, :8], Cm, A, D)
    with pytest.raises(ValueError, match=r"want \(di, N\)"):
        scan_kernel.mamba_scan(x, dt, Bm, Cm, A[:8], D)
    with pytest.raises(ValueError, match="one CUDA device"):
        scan_kernel.mamba_scan(x, dt, Bm, Cm, A.cpu(), D)
    with pytest.raises(ValueError, match="not contiguous"):
        scan_kernel.mamba_scan(x.transpose(1, 2).contiguous().transpose(1, 2), dt, Bm, Cm, A, D)


@pytest.mark.cuda
def test_jamba_prefill_goes_through_the_kernels(card):
    """The smoke Jamba cut (two periods, dense FFNs) on the card: one
    selective-scan launch per Mamba layer and one flash launch per attention
    layer, logits within float32 round-off of the plain routes'; decode
    launches neither, and the scan kernel refuses a carried state rather than
    handing it to the plain recurrence."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import mamba as Ma, model as M
    from repro_torch.models.config import smoke_variant

    cfg = smoke_variant(get_config("jamba_1_5_large_398b")).scaled(n_experts=0, top_k=0)
    kinds = M.layer_kinds(cfg)
    params = M.init_params(cfg, torch.Generator(device=card).manual_seed(0))
    toks = torch.randint(0, cfg.vocab, (2, 100), generator=torch.Generator(device=card).manual_seed(1),
                         device=card)
    before = scan_kernel.launches, flash_kernel.launches
    got = M.prefill(params, cfg, {"tokens": toks}, use_kernel=True)
    torch.cuda.synchronize()
    assert scan_kernel.launches == before[0] + kinds.count("mamba")
    assert flash_kernel.launches == before[1] + kinds.count("attn")
    want = M.prefill(params, cfg, {"tokens": toks}, use_kernel=False)
    torch.testing.assert_close(got, want, atol=4e-5, rtol=1e-4)
    cache = M.init_cache(cfg, 2, 16, card)
    M.decode_step(params, cfg, toks[:, :1], 0, cache)
    assert (scan_kernel.launches, flash_kernel.launches) == \
        (before[0] + kinds.count("mamba"), before[1] + kinds.count("attn"))
    x = torch.zeros((2, 3, cfg.d_model), device=card)
    with pytest.raises(ValueError, match="carried state"):
        Ma.mamba_forward(params.layers[0].mamba, cfg, x, cache[0], use_kernel=True)


@pytest.mark.cuda
def test_moe_layer_on_the_card_is_deterministic_and_matches_its_oracle(card):
    """The smoke Arctic MoE layer (4 experts top-2, the dense residual) on
    the card: in bf16 the combine gives the CPU's sequential scatter-add in
    (E, C) order bit for bit, and two runs are equal (no atomics); in
    float32, at capacity factor 0.5 (assignments dropped), each token's
    output is its kept assignments' gated expert SwiGLUs plus the residual,
    computed token by token."""
    import torch.nn.functional as F

    from repro_torch.configs.registry import get_config
    from repro_torch.models import model as M, moe
    from repro_torch.models.config import smoke_variant

    base = smoke_variant(get_config("arctic_480b")).scaled(capacity_factor=0.5)
    for dtype in ("bfloat16", "float32"):
        cfg = base.scaled(dtype=dtype)
        params = M.init_params(cfg, torch.Generator(device=card).manual_seed(0))
        ffn = params.layers[0].ffn
        x = torch.randn((96, cfg.d_model), generator=torch.Generator(device=card).manual_seed(1),
                        device=card).to(getattr(torch, dtype))
        got, _ = moe.moe_ffn_local(ffn, cfg, x)
        w, ids, _ = moe.router_topk(ffn["router"], x, cfg.top_k)
        C = moe.capacity_of(cfg, 96, cfg.n_experts)
        tok, gate, slots = moe._dispatch_tables(ids, w, cfg.n_experts, C)
        assert int((slots == cfg.n_experts * C).sum()) > 0
        if dtype == "bfloat16":
            assert torch.equal(moe.moe_ffn_local(ffn, cfg, x)[0], got)
            y = (moe._expert_compute(ffn, x[tok]) * gate[..., None].to(x.dtype)).cpu()
            want = torch.zeros((96, cfg.d_model), dtype=torch.bfloat16)
            for i, t in enumerate(tok.reshape(-1).tolist()):
                want[t] += y.reshape(-1, cfg.d_model)[i]
            assert torch.equal(moe._combine(y.to(card), slots, x.dtype).cpu(), want)
            continue
        want, load = moe.dense_ffn(ffn["dense_res"], cfg, x), [0] * cfg.n_experts
        for t, (experts, gates) in enumerate(zip(ids.tolist(), w.tolist())):
            for e, g in zip(experts, gates):
                load[e] += 1
                if load[e] <= C:
                    h = F.silu(x[t] @ ffn["w_gate"][e]) * (x[t] @ ffn["w_up"][e])
                    want[t] += g * (h @ ffn["w_down"][e])
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))


# ---------------------------------------------------------------------------
# the device guard
# ---------------------------------------------------------------------------


@pytest.fixture
def second_card():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards: a launch on cuda:1 while cuda:0 is current")
    return torch.device("cuda", 1)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["fedsem_objective", "flash_attention", "rwkv6_scan", "mamba_scan"])
def test_kernels_launch_on_their_inputs_card(second_card, name):
    """Each wrapper makes its inputs' card current for the launch (and flash
    for its TMA descriptors): with cuda:0 current, inputs on cuda:1 give the
    plain version's answer there, and cuda:0 stays current."""
    dev = second_card
    torch.cuda.set_device(0)
    if name == "fedsem_objective":
        args, mask = grid_inputs(14, 16, 3, 10)
        t = [torch.from_numpy(a).to(dev) for a in args]
        kw = dict(xi=XI, eta=ETA, accuracy_ab=AB, dev_mask=torch.from_numpy(mask).to(dev))
        kap = [torch.linspace(0.5, 2.0, 16, device=dev), 1.0, torch.full((16,), 1.3, device=dev)]
        got = ops.objective_grid_batch(*t, *kap, **kw)
        want = ref.objective_grid_batch(*t, *kap, **kw)
        torch.cuda.synchronize(dev)
        assert_scores(got.cpu().numpy(), want.cpu().numpy())
    elif name == "flash_attention":
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = _qkv(dev, 21, 1, 256, 4, 2, 64, dtype)
            got = flash_kernel.flash_attention(q, k, v, causal=True)
            want = _plain(q, k, v, causal=True)
            atol, rtol = FLASH_TOL[dtype]
            torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)
    elif name == "rwkv6_scan":
        args = _wkv_models_types(dev, 39, 1, 4, 300, 64)
        got = wkv_kernel.rwkv6_scan(*args, torch.float32)
        want = wkv_ref.rwkv6_scan(*args, out_dtype=torch.float32)[0]
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    else:
        x, dt, Bm, Cm, A, D = _scan_inputs(dev, 49, 1, 300, 256, 16, torch.bfloat16, model_law=True)
        got = scan_kernel.mamba_scan(x, dt, Bm, Cm, A, D)
        want = scan_ref.mamba_scan(x, dt, Bm, Cm, A, D)[0]
        atol, rtol = SCAN_TOL[torch.bfloat16]
        torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)
    assert got.device == dev and torch.cuda.current_device() == 0


# ---------------------------------------------------------------------------
# the exhaustive oracle's sweep through the objective kernel
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("name,padded", [("gauss_markov", False), ("hetero_classes", False),
                                         ("iid_rayleigh", False), ("ris_geometry", False),
                                         ("iid_rayleigh", True)])
def test_exhaustive_sweep_kernel_matches_plain_version(card, name, padded):
    """The oracle gate's sweep (N 3, K 4; padded into (4, 5) on smaller
    grids) with the kernel, one launch per chunk, against the same sweep
    through the plain version on the card: the same allocation, or on a
    tie values within the kernel's tolerance."""
    import numpy as np

    from repro_torch.core import Weights, pad_params, unpad_alloc
    from repro_torch.core.exhaustive import default_chunk, solve_exhaustive
    from repro_torch.core.system import feasible
    from repro_torch.scenarios import get_family

    exact = get_family(name).sample(2, N=3, K=4, device=card)
    n = 3 if padded else 4
    p_hi_dbm = 10.0 * np.log10(float(exact.p_max.min())) + 30.0
    levels = dict(f_levels=np.linspace(0.25e9, float(exact.f_max.min()), n),
                  p_levels_dbm=np.linspace(4.0, p_hi_dbm, n - 1), rho_levels=np.linspace(0.2, 1.0, n))
    p = pad_params(exact, 4, 5) if padded else exact
    w = Weights.ones(card)
    before = kernel.launches
    got = solve_exhaustive(p, w, **levels)
    G = (n * (n - 1)) ** p.N * n
    assert kernel.launches - before == -(-p.N ** p.K // default_chunk(G, p.N))
    want = solve_exhaustive(p, w, **levels, use_kernel=False)
    assert kernel.launches - before == -(-p.N ** p.K // default_chunk(G, p.N))
    assert got.n_evaluated == want.n_evaluated == p.N ** p.K * G
    # a different candidate is a tie: its value within the kernel's tolerance
    vk, vp = float(got.value), float(want.value)
    assert abs(vk - vp) <= 1e-5 + 5e-7 * abs(vp)
    # a real subcarrier a padded device owns is one left unassigned
    assert bool(feasible(exact, unpad_alloc(got.alloc, 3, 4)))


# ---------------------------------------------------------------------------
# serving: every flush solved and scored through the objective kernel
# ---------------------------------------------------------------------------


def _serve_cfg(outer_iters=2, **allocator):
    from repro_torch.core import AllocatorConfig
    from repro_torch.core.pgd import PGDConfig
    from repro_torch.serve import BatchPolicy, ServeConfig

    alloc = AllocatorConfig(inner="pgd", outer_iters=outer_iters, pgd=PGDConfig(steps=40), **allocator)
    return ServeConfig(policy=BatchPolicy(max_batch=2, max_wait_s=0.01), allocator=alloc)


def _serve(svc, requests, **submit):
    for p in requests:
        svc.submit(p, **submit)
    return {c.req_id: c for c in svc.drain(now=0.0)[0]}


@pytest.mark.cuda
def test_service_flush_launches_the_kernel_8_then_15_times(card):
    """At the default 6 outer iterations a cold flush launches the kernel 8
    times (6 trace entries, the multi-start selection, the flush's scoring)
    and a flush with a warm-start hit 15 (+ the refine pass's 7)."""
    from repro_torch.core import sample_request_stream
    from repro_torch.serve import AllocService, WarmStartConfig

    requests = sample_request_stream(3, 2, sizes=((3, 8),), device=card)
    svc = AllocService(_serve_cfg(6)._replace(warmstart=WarmStartConfig()), device=card)
    before = kernel.launches
    cold = _serve(svc, requests)
    assert kernel.launches - before == 8
    assert not any(c.warm_hit for c in cold.values())
    before = kernel.launches
    warm = _serve(svc, requests)
    assert kernel.launches - before == 15
    assert all(c.warm_hit for c in warm.values())


@pytest.mark.cuda
def test_service_flush_on_the_card_equals_the_cpu_flush(card):
    """The same requests flushed on the card and on the CPU: the same X."""
    from repro_torch.core import sample_request_stream
    from repro_torch.core.types import tree_map
    from repro_torch.serve import AllocService

    cpu_reqs = sample_request_stream(4, 4, sizes=((3, 8), (4, 12)), device="cpu")
    on_cpu = _serve(AllocService(_serve_cfg(), device="cpu"), cpu_reqs)
    on_card = _serve(AllocService(_serve_cfg(), device=card),
                     [tree_map(lambda x: x.to(card), p) for p in cpu_reqs])
    for i, c in on_cpu.items():
        assert torch.equal(on_card[i].alloc.X.cpu(), c.alloc.X)


@pytest.mark.cuda
def test_completion_objective_kernel_equals_the_plain_path(card):
    """Kernel scoring and the plain path (``use_kernel_objective=False``,
    no launch) give the same allocations, and `Completion.objective`s
    within the kernel's tolerance (rtol 5e-7, atol 1e-5)."""
    from repro_torch.core import sample_request_stream
    from repro_torch.serve import AllocService

    requests = sample_request_stream(5, 4, sizes=((3, 8), (4, 8)), device=card)
    with_kernel = _serve(AllocService(_serve_cfg(), device=card), requests)
    before = kernel.launches
    plain = _serve(AllocService(_serve_cfg(use_kernel_objective=False), device=card), requests)
    assert kernel.launches == before
    for i, c in plain.items():
        for leaf in ("f", "P", "X", "rho"):
            assert torch.equal(getattr(c.alloc, leaf), getattr(with_kernel[i].alloc, leaf)), leaf
    ids = sorted(plain)
    assert_scores([with_kernel[i].objective for i in ids], [plain[i].objective for i in ids])


@pytest.mark.cuda
def test_real_clock_driver_on_the_card_equals_its_virtual_replay(card):
    """Paced arrivals through the real-clock driver on the card and the same
    stream on the virtual clock: the same req_id -> X."""
    from repro_torch.core import sample_request_stream
    from repro_torch.serve import (
        AllocService, RealClockDriver, pace_stream, run_load, same_hardened_assignments,
    )

    requests = sample_request_stream(6, 6, sizes=((3, 8), (4, 8)), device=card)
    svc = AllocService(_serve_cfg(), device=card)
    driver = RealClockDriver(svc)
    futures, _ = pace_stream(driver, requests, [0.003 * i for i in range(len(requests))])
    driver.close(timeout=600)
    real = [f.result(timeout=0.0) for f in futures]
    replay = run_load(AllocService(_serve_cfg(), svc.executables, device=card), requests,
                      [0.0] * len(requests))
    assert same_hardened_assignments(real, replay.completions)


# ---------------------------------------------------------------------------
# the FedSem closed loop and scenario sharding on the card
# ---------------------------------------------------------------------------


def _fl_setup(card):
    from repro_torch.fl import FLConfig, sample_round_scenarios, serve_config_for
    from repro_torch.launch.fedsem_e2e import SMOKE_ALLOCATOR
    from repro_torch.serve import BatchPolicy

    fl = FLConfig(n_clients=4, n_subcarriers=12, rounds=3, local_steps=2, scenario="hetero_classes")
    serve = serve_config_for(SMOKE_ALLOCATOR, policy=BatchPolicy(max_batch=4, max_wait_s=0.02))
    return SMOKE_ALLOCATOR, serve, sample_round_scenarios(3, fl, 1e4, device=card)


@pytest.mark.cuda
def test_service_backend_equals_planned_on_the_card(card):
    """Each round padded into the (4, 16) bucket and 4 slots by the service
    against all rounds as one unpadded batch: the same X on the card, and
    every solve scored through the kernel (3 launches a solve, 4 a flush)."""
    from repro_torch.core import Weights
    from repro_torch.fl import PlannedBackend, ServiceBackend
    from repro_torch.serve import AllocService

    alloc, serve, scen = _fl_setup(card)
    planned = PlannedBackend(alloc)
    before = kernel.launches
    planned.open(scen, Weights.ones(card))
    assert kernel.launches - before == alloc.outer_iters + 1
    served = ServiceBackend(AllocService(serve, device=card))
    served.open(scen, Weights.ones(card))
    for rnd in range(len(scen)):
        a, b = planned.allocate(rnd), served.allocate(rnd)
        assert torch.equal(a.X, b.X)
        assert abs(float(a.rho) - float(b.rho)) <= 1e-6
    assert kernel.launches - before == (alloc.outer_iters + 1) + len(scen) * (alloc.outer_iters + 2)


@pytest.mark.cuda
def test_semcom_jobs_cotenanted_equal_their_solo_runs_on_the_card(card):
    """Two jobs in threads over one real-clock driver, each re-run alone on
    a fresh virtual-clock service: the same losses, rhos, energies,
    objectives and measurements, exactly."""
    from repro_torch.launch import fedsem_e2e as e2e

    _, serve, specs, rounds, ae, batch, eval_batch = e2e.harness_config(smoke=True)
    jobs = [e2e.make_job(s, rounds, ae, batch, eval_batch, device=card) for s in specs]
    co, _ = e2e.run_multijob(11, jobs, serve, {})
    report = e2e.check_noninterference(11, jobs, co, serve, {})
    assert report["ok"], report


@pytest.fixture
def two_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards: a scenario mesh of two devices")
    return (torch.device("cuda", 0), torch.device("cuda", 1))


@pytest.mark.cuda
def test_sharded_solve_over_two_cards(two_cards):
    """A batch of 5 on a two-card mesh (padded to 6, 3 a card): the
    single-card X, the result back on the first card, and each card's
    kernel launched for its own chunk."""
    from repro_torch.core import Weights, solve_batch
    from repro_torch.launch.fedsem_e2e import SMOKE_ALLOCATOR as alloc
    from repro_torch.scenarios import get_family

    pb = get_family("iid_rayleigh").sample_batch(2, 5, N=4, K=12, device=two_cards[0])
    w = Weights.ones(two_cards[0])
    single = solve_batch(pb, w, alloc)
    before = kernel.launches
    sharded = solve_batch(pb, w, alloc, mesh=two_cards)
    assert kernel.launches - before == 2 * (alloc.outer_iters + 1)
    assert sharded.alloc.X.device == two_cards[0]
    assert torch.equal(sharded.alloc.X, single.alloc.X)


# ---------------------------------------------------------------------------
# training: the kernels refuse autograd; the train step and the FL
# sparsification on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_kernel_wrappers_refuse_autograd_on_the_card(card):
    """Each wrapper, given CUDA inputs it takes, raises under grad mode when
    one requires grad (naming the plain route), and launches without it."""
    g = torch.Generator(card).manual_seed(0)
    rand = lambda *shape: torch.randn(shape, generator=g, device=card)
    q, k = rand(1, 64, 4, 64), rand(1, 64, 2, 64)
    r = rand(1, 2, 64, 64)
    w = torch.rand((1, 2, 64, 64), generator=g, device=card) * 0.5 + 0.4
    x, dt, Bm = rand(1, 32, 64), torch.rand((1, 32, 64), generator=g, device=card) * 0.1, rand(1, 32, 16)
    A, D = -torch.rand((64, 16), generator=g, device=card), rand(64)
    (f, p, rr, rho, *rows), mask = grid_inputs(3, 2, 5, 4)
    obj = [torch.from_numpy(a).to(card) for a in (f, p, rr, rho, *rows)]
    calls = {
        "flash_attention": (lambda t: flash_kernel.flash_attention(q, t, k), k),
        "rwkv6_scan": (lambda t: wkv_kernel.rwkv6_scan(r, r, r, w, t), rand(2, 64)),
        "mamba_scan": (lambda t: scan_kernel.mamba_scan(x, t, Bm, Bm, A, D), dt),
        "fedsem_objective": (lambda t: kernel.objective_batch(
            obj[0], t, *obj[2:], torch.from_numpy(mask).to(card), 1.0, 1.0, 1.0, *AB,
            xi=XI, eta=ETA), obj[1]),
    }
    for name, (call, arg) in calls.items():
        with pytest.raises(RuntimeError, match=r"use_kernel=False"):
            call(arg.clone().requires_grad_(True))
        with torch.no_grad():
            assert torch.all(torch.isfinite(call(arg.clone().requires_grad_(True)))), name


@pytest.mark.cuda
def test_smoke_train_step_on_the_card_matches_the_cpu(card):
    """One `build_train_step` step of the smoke Qwen2.5-3B (float32) from the
    same state and batch on the card and on the CPU: the same loss and
    grad norm (rtol 1e-4), and no kernel launched on the card."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core.types import tree_map
    from repro_torch.launch import train as T
    from repro_torch.models.config import smoke_variant

    cfg = smoke_variant(get_config("qwen2_5_3b"))
    toks = torch.randint(0, cfg.vocab, (4, 65), generator=torch.Generator().manual_seed(1))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    out = {}
    for dev in (torch.device("cpu"), card):
        state = T.init_state(cfg, torch.Generator().manual_seed(0), 1e-3)
        state = tree_map(lambda x: x.to(dev), state)
        before = (flash_kernel.launches, kernel.launches)
        _, metrics = T.build_train_step(cfg, lr=1e-3)(state, tree_map(lambda x: x.to(dev), batch))
        assert (flash_kernel.launches, kernel.launches) == before
        out[dev.type] = (float(metrics["loss"]), float(metrics["grad_norm"]))
    assert out["cuda"] == pytest.approx(out["cpu"], rel=1e-4)


@pytest.mark.cuda
def test_topk_sparsify_on_the_card_equals_the_cpu(card):
    """A leaf of 2^24 + 1 entries (past `torch.quantile`'s limit): the
    card's kept set is the CPU's."""
    from repro_torch.fl import topk_sparsify

    u = torch.randn(2**24 + 1, generator=torch.Generator().manual_seed(2))
    got = topk_sparsify({"w": u.to(card)}, 0.3)["w"].cpu()
    assert torch.equal(got, topk_sparsify({"w": u}, 0.3)["w"])


@pytest.mark.cuda
def test_expert_parallel_moe_on_two_cards(card, tmp_path):
    """`moe_ffn` on a (1, 2) NCCL mesh, two processes, one card each:
    each rank's two experts of four, the partial outputs summed over
    ``model``, against the reference's composition on one card (each
    shard's `moe_ffn_local` expert slice, summed, then the dense residual),
    float32, within 1e-6 of the output's scale (the MoE parity law)."""
    import os
    import pickle
    import subprocess
    import sys

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards (a (1, 2) NCCL mesh)")
    worker = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_mesh_worker.py")
    r = subprocess.run([sys.executable, worker, "--cuda-ep", str(tmp_path)], capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    with open(tmp_path / "out.pkl", "rb") as f:
        out = pickle.load(f)
    assert out["max_abs_err"] <= 1e-6 * out["scale"], out


# ---------------------------------------------------------------------------
# the program's spans on the profiler's clock
# ---------------------------------------------------------------------------

#: how far a kernel's record may lie outside the device interval of the span
#: that launched it, on the host clock: the anchor's host reading and the
#: profiler's own conversion of the card's clock both add to it
CLOCK_SLACK_NS = 20_000
#: how far a solver span's device interval may lie from the events recorded
#: directly around its call: on a card that waits for the host, two events
#: with no work between them are stamped apart by the host's time between
#: the two record calls (40-110 us under the trace on an H100)
EDGE_NS = 1_000_000


def _traced(fn):
    """(kernel records (name, start ns, end ns), spans) of ``fn()`` under the
    benchmark's CUDA-only device trace, which the spans record under."""
    from fedbench.yardstick import trace
    from repro_torch import spans

    tracer = trace.DeviceTrace()
    tracer.start()
    try:
        assert torch._C._autograd._profiler_enabled()
        spans.clear()
        fn()
        torch.cuda.synchronize()
    finally:
        rows = tracer.stop()
    return rows, spans.snapshot()["spans"]


def _excess_ns(rows, symbol, intervals):
    """For each record of the kernel ``symbol``: (the interval that holds it
    best, how far it lies outside that one; 0 inside)."""
    out = []
    for name, s, e in rows:
        if symbol in name:
            out.append(min(((max(d0 - s, e - d1, 0), i) for i, (d0, d1) in enumerate(intervals)))[::-1])
    return out


@pytest.mark.cuda
def test_spans_hold_their_kernels_on_the_profilers_clock(card, monkeypatch):
    """Under the benchmark's device trace, every flash record of a
    StarCoder2-shaped prefill and every WKV6 record of an RWKV-6 one lies
    inside its layer's ``mixer`` span's device interval on the host clock,
    within `CLOCK_SLACK_NS`. In a smoke-depth solve each ``pgd`` and
    ``power_given_x`` span's device interval is, within `EDGE_NS`, the one
    of two events recorded directly around its call, and each ``score``
    and ``select`` span carries one objective launch. The solve's trace
    records are not held to its spans: over a profile of seconds the
    profiler places kernels tens of milliseconds off the events around
    them on their own stream, more the longer it has run
    (``tools/span_clock_probe.py`` measures it)."""
    from fedbench.yardstick.names import PORT_KERNELS
    from repro_torch import spans
    from repro_torch.configs.registry import get_config
    from repro_torch.core import AllocatorConfig, Weights, allocator, batch_objectives, sample_params_batch, solve_batch
    from repro_torch.core.pgd import PGDConfig
    from repro_torch.models import model as M

    for arch, symbol in (("starcoder2_3b", PORT_KERNELS["flash"]), ("rwkv6_1_6b", PORT_KERNELS["wkv6"])):
        cfg = get_config(arch).scaled(n_layers=2, dtype="bfloat16")
        params = M.init_params(cfg, torch.Generator(device=card).manual_seed(0))
        batch = {"tokens": torch.randint(0, cfg.vocab, (1, 2048), device=card,
                                         generator=torch.Generator(device=card).manual_seed(1))}
        M.prefill(params, cfg, batch)                    # builds and warms the kernels
        rows, snap = _traced(lambda: M.prefill(params, cfg, batch))
        mixers = [s["device"] for s in snap if s["name"] == "mixer"]
        hits = _excess_ns(rows, symbol, mixers)
        assert [i for i, _ in hits] == list(range(cfg.n_layers)) and len(mixers) == cfg.n_layers, arch
        assert max(x for _, x in hits) <= CLOCK_SLACK_NS, (arch, hits)
        del params

    params = sample_params_batch(3, 8, device="cuda")
    cfg = AllocatorConfig(inner="pgd", outer_iters=2, pgd=PGDConfig(steps=60))
    one = torch.tensor(1.0, device=card)
    w = Weights(one, one, one)
    brackets = []

    def bracketed(fn):
        def call(*args, **kwargs):
            e0 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = fn(*args, **kwargs)
            e1 = torch.cuda.Event(enable_timing=True)
            e1.record()
            brackets.append((e0, e1))
            return out
        return call

    for name in ("solve_p4_pgd", "power_given_x"):
        monkeypatch.setattr(allocator, name, bracketed(getattr(allocator, name)))

    def solve():
        batch_objectives(params, w, solve_batch(params, w, cfg).alloc)

    solve()
    brackets.clear()
    rows, snap = _traced(solve)
    clock = spans.CudaClock()
    now, anchor = clock.anchor(torch.cuda.current_stream())
    placed = [tuple(now - round(clock.elapsed_ns(e, anchor)) for e in pair) for pair in brackets]
    solver = [s for s in snap if s["name"] in ("pgd", "power_given_x")]
    assert [s["name"] for s in solver] == ["pgd"] * (cfg.outer_iters + 1) + ["power_given_x"]
    gaps = [(s["device"][0] - b0, s["device"][1] - b1) for s, (b0, b1) in zip(solver, placed)]
    assert len(placed) == len(solver) and max(abs(g) for pair in gaps for g in pair) <= EDGE_NS, gaps
    assert all(s["attrs"]["p4_adam_launches"] == 1 for s in solver)     # one launch a loop

    scoring = [s for s in snap if s["name"] in ("score", "select")]
    assert [s["name"] for s in scoring] == ["score"] * cfg.outer_iters + ["select", "score"]
    assert all(s["attrs"]["objective_launches"] == 1 for s in scoring)
    (request,) = [s for s in snap if s["name"] == "solve_batch"]
    lo, hi = request["device"]
    assert all(lo <= s["device"][0] <= s["device"][1] <= hi for s in scoring[:-1] + solver)
    assert len([r for r in rows if PORT_KERNELS["objective"] in r[0]]) <= len(scoring)


# ---------------------------------------------------------------------------
# Alg. A2's Adam loops (kernels/p4_adam) against the eager loop on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("shape,pad,rows", [
    ((10, 50), None, 64), ((4, 5), None, 64), ((16, 64), None, 64), ((6, 12), (8, 16), 64),
    ((20, 100), (32, 128), 64), ((40, 200), (64, 256), 16)],
    ids=["table1", "table2", "alg_analysis", "padded", "bucket_32_128", "bucket_64_256"])
@pytest.mark.parametrize("mode", ["pgd", "power"])
def test_p4_adam_one_step_matches_the_eager_loop(card, shape, pad, rows, mode):
    """One Adam step, kernel against the eager loop on the same CUDA tensors
    and in float64 (`p4_adam_checks.one_step_check` states the gates); the
    serving ladder's two widest buckets, padded, take the wide kernel."""
    p4_adam_checks.one_step_check(card, shape, pad, mode, rows=rows)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,pad,rows", [((10, 50), None, 1024), ((20, 100), (32, 128), 128)],
                         ids=["table1", "bucket_32_128"])
def test_p4_adam_800_steps_hold_the_eager_loops_loss(card, shape, pad, rows):
    """`solve_p4_pgd`'s 800 steps from the full-payload start, kernel
    against the eager loop on the same CUDA tensors: on every row the
    final decode's P4 loss within `P4_ROW_GAP` of the plain loop's, relative,
    their median within 1e-3, and at least a share `P4_SAME_X` of the rows
    with the same hardened X (`p4_adam_checks` says why)."""
    gaps, finite, same = p4_adam_checks.loss_gaps(card, *shape, rows=rows, pad=pad)
    assert finite
    print(f"p4_adam 800 steps, {rows} rows at {shape} (pad {pad}): rel loss gap median "
          f"{float(gaps.median()):.3e}, max |gap| {float(gaps.abs().max()):.3e}, "
          f"identical hardened X {same:.4f}")
    assert float(gaps.median()) <= 1e-3
    assert float(gaps.abs().max()) <= p4_adam_checks.P4_ROW_GAP
    assert same >= p4_adam_checks.P4_SAME_X


@pytest.mark.cuda
@pytest.mark.parametrize("shape,pad,B", [((10, 50), None, 64), ((20, 100), (32, 128), 8),
                                         ((40, 200), (64, 256), 4)],
                         ids=["table1", "bucket_32_128", "bucket_64_256"])
def test_solve_batch_pgd_on_the_card_is_feasible_through_the_kernel(card, shape, pad, B):
    """A default-depth `solve_batch(inner="pgd")` on the card, at Table I's
    width and in the serving ladder's two widest buckets (padded, as the
    serving layer pads): every scenario feasible, one kernel launch for
    each of its seven PGD calls and its power re-solve."""
    from repro_torch.core import (AllocatorConfig, Weights, pad_params, sample_params_batch,
                                  solve_batch)
    from repro_torch.core.system import feasible
    from repro_torch.kernels.p4_adam import kernel as p4_kernel

    params = sample_params_batch(11, B, N=shape[0], K=shape[1], device=card)
    if pad is not None:
        params = pad_params(params, *pad)
    before = p4_kernel.launches
    res = solve_batch(params, Weights.ones(card), AllocatorConfig(inner="pgd"))
    torch.cuda.synchronize()
    assert p4_kernel.launches - before == AllocatorConfig().outer_iters + 2
    assert bool(feasible(params, res.alloc).all())
    X = res.alloc.X
    assert bool(((X == 0) | (X == 1)).all()) and bool((X.sum(dim=-2) == params.sc_mask).all())
    assert not bool(X[params.dev_mask == 0].any())


@pytest.mark.cuda
def test_p4_adam_schedule_on_the_card_is_the_eager_loops(card):
    """On the card the table's temperature and bias corrections are, bit for
    bit, what the eager loop computes from its 0-dim step counter."""
    from repro_torch.core.pgd import PGDConfig
    from repro_torch.kernels.p4_adam import kernel as p4_kernel

    cfg = PGDConfig()
    sched = p4_kernel.schedule(cfg.steps, cfg.temp_end, card)
    want = []
    for i in torch.arange(cfg.steps, dtype=torch.float32, device=card):
        t = i + 1
        temp = 1.0 + (cfg.temp_end - 1.0) * (i / max(cfg.steps - 1, 1))
        want.append(torch.stack([temp, 1 - 0.9**t, 1 - 0.999**t]))
    assert torch.equal(sched, torch.stack(want))


@pytest.mark.cuda
def test_p4_adam_wrapper_refuses_what_the_kernel_does_not_take(card):
    from repro_torch.core import pgd
    from repro_torch.core.pgd import PGDConfig
    from repro_torch.core.types import tree_map
    from repro_torch.kernels.p4_adam import kernel as p4_kernel, ops as p4_ops

    params, kappa1, payload, rmin, P0, X0 = p4_adam_checks.p4_rows(card, 4, 8, rows=4)
    z, w, w_tot = pgd._pgd_start(params, P0, X0)
    cfg = PGDConfig(steps=2)
    on_cpu = tree_map(lambda t: t.cpu(), (params, kappa1, payload, rmin, z, w, w_tot))
    with pytest.raises(ValueError, match="CUDA"):
        p4_ops.pgd_loop(*on_cpu, cfg)
    kw = dict(steps=2, q=2, lr=0.08, penalty_rate=10.0, penalty_binary=0.3, temp_end=0.25,
              bbar=params.bbar, noise_sc=params.noise_sc)
    rows = (params.g, params.p_max, params.dev_mask, params.sc_mask, payload, rmin, kappa1)
    before = p4_kernel.launches
    p4_kernel.pgd_loop(*rows, z, w, w_tot, **kw)
    assert p4_kernel.launches == before + 1
    for n, k in ((65, 80), (4, 257)):          # beyond MAX_N devices, MAX_K subcarriers
        g = torch.rand((1, n, k), device=card)
        wide = (g, torch.ones(1, n, device=card), torch.ones(1, n, device=card),
                torch.ones(1, k, device=card), torch.ones(1, n, device=card),
                torch.ones(1, n, device=card), torch.ones(1, device=card))
        with pytest.raises(ValueError, match="takes 1 <= N"):
            p4_kernel.pgd_loop(*wide, torch.zeros(1, n + 1, k, device=card), g, wide[1], **kw)
    with pytest.raises(ValueError, match="not contiguous"):
        p4_kernel.pgd_loop(*rows, z, w.transpose(-1, -2).contiguous().transpose(-1, -2), w_tot, **kw)
    with pytest.raises(ValueError, match="shape"):
        p4_kernel.pgd_loop(*rows, z, w[:, :, :4], w_tot, **kw)
    with pytest.raises(RuntimeError, match="use_kernel=False"):
        p4_kernel.pgd_loop(*rows, z, w.clone().requires_grad_(True), w_tot, **kw)
    with torch.no_grad():
        p4_kernel.pgd_loop(*rows, z, w.clone().requires_grad_(True), w_tot, **kw)
    assert p4_kernel.launches == before + 2

// Flash attention, forward, for Hopper (sm_90a).
//
// Replaces src/repro/kernels/flash_attention/kernel.py:flash_attention_pallas
// (the Pallas TPU kernel `_kernel`). It computes what that kernel computes:
//   s = (q . k^T in fp32) * scale, scale = 1/sqrt(hd), then the softcap
//   cap * tanh(s / cap); keys masked where kpos >= S (the ragged end),
//   kpos > qpos (causal) or qpos - kpos >= window (sliding window);
//   an fp32 online softmax over kv tiles; out = acc / max(l, 1e-20), cast to
//   q's type. GQA: query head h reads kv head h / (H / KV).
// A masked score is -inf and adds exactly 0 (a row masked so far keeps
// acc = 0 and l = 0), as in the chunked plain version
// (repro_torch/models/attention.py:flash_attention).
//
// Layout: q (B, S, H, hd), k/v (B, S, KV, hd), out (B, S, H, hd), read and
// written by stride (the head dim must be contiguous), so the model's layout
// needs no transpose and no padding: the kernel masks the ragged end of S.
//
// Two kernels behind one entry point, chosen by dtype:
//
// bfloat16: flash_fwd_kernel_sm90 (flash_fwd_sm90.cuh), on the tensor cores.
//   What bounds it: the causal (or band) work, 4 * hd operations per
//   unmasked (q, k) pair, is far above the ridge point, so the bound is the
//   bf16 tensor-core rate. But the plain version (and the TPU kernel) keeps
//   the probabilities P in float32 for P V, and the kernel is held to one
//   bf16 ulp of it: P rounded once to bf16, as FlashAttention-2/3 and SDPA
//   do, misses that gate by about 10x (tests/test_torch_flash_attention.py:
//   test_bf16_kernel_needs_p_split_into_two_bf16_terms). So P V is computed as
//   P_hi V + P_lo V, P_hi = bf16(P), P_lo = bf16(P - P_hi), two bf16
//   products that keep P to about 2^-17: 6 * hd tensor-core operations a
//   pair instead of 4 * hd, 1.5x the function's bound.
//   Design: one block of 2 warpgroups (256 threads) per (128 query rows,
//   head, batch); each warpgroup owns 64 query rows.
//   * One thread issues TMA loads of the Q tile and of K/V tiles into a ring
//     of 2 shared-memory stages, each completing on an mbarrier. A stage is
//     refilled by the second warpgroup to be done with it, so neither waits
//     for the other (a producer warpgroup with setmaxnreg was tried: ptxas
//     then capped every thread at 168 registers and spilled).
//   * Per kv tile of BK keys (128; 64 at hd 256): S = Q K^T by wgmma
//     m64nBKk16 from shared memory (float32 accumulators: bf16 products are
//     exact, so S differs from the plain version's only in summation
//     order); scale, softcap (tanhf: tanh.approx would move a score near
//     cap 50 by 0.02), masks only on tiles that cross the band's edge;
//     online softmax in float32 registers, exp(s - m) as 2^x on the
//     exponential unit of one FFMA'd argument (2 instructions to expf's
//     about 8; about 2 ulp, far inside the gate); P_hi and P_lo
//     packed from the accumulators, which already have the A-fragment
//     layout; O = O corr + P_hi V + P_lo V by wgmma m64n(hd)k16, A from
//     registers, V (MN-major) from shared memory. The O accumulator is
//     hd / 2 floats a thread (128 at hd 256, which sets BK = 64 there);
//     169 (hd 32) to 245 (hd 256) registers a thread, no spills.
//   * Tiles are 128-byte-swizzled slabs of 64 hd columns (64-byte at
//     hd 32), as TMA writes them and the wgmma descriptors read them.
//   * Kv tiles wholly outside the block's causal/window band are never
//     loaded; a tile outside one warpgroup's band is skipped by it.
//   * Shared memory: 41 KB (hd 32) to 193 KB (hd 256).
//   * hd 80 (HuBERT's) runs at width 128 (its own instantiation, HD_IN 80):
//     the TMA maps span the true hd, so TMA fills columns 80-127 with zeros,
//     Q K^T gains only exact zeros, and the stores stop at hd. It does
//     128/80 of hd 80's tensor-core work.
//   Blocks are launched longest rows first (grid y reversed).
//
// float32: flash_fwd_kernel_f32_sm90 (flash_fwd_f32_sm90.cuh), on the tensor
//   cores as 3xTF32. What bounds it: the function's 4 * hd float32
//   operations a pair. Its gate (2e-5 atol + rtol against the plain version)
//   rules out one TF32 product (10 mantissa bits: 27x to 38x outside it,
//   tests/test_torch_flash_attention.py:test_f32_kernel_needs_three_tf32_products),
//   but each float32 operand x splits into two tf32, hi = cvt.rna.tf32(x) and
//   lo = tf32(x - hi), and A B = A_hi B_hi + A_hi B_lo + A_lo B_hi keeps the
//   product to about 2^-21: 3 tensor-core products, 12 * hd TF32 operations a
//   pair at 495 TFLOP/s, 2.5x less time than 4 * hd on the CUDA cores' 67.
//   The threads form the split, so no product depends on how the tensor core
//   reads a float32's low 13 bits.
//   The tensor core's float32 sums truncate: an exact 256-deep sum of
//   positive tf32 products comes out more than 5 ulp low on average, where
//   the CUDA cores' sums are unbiased (tests/test_torch_kernels_cuda.py::
//   test_tf32_tensor_core_sums_truncate, on an H100). So no long
//   chain is left to it: Q K^T's small terms (Q_hi K_lo + Q_lo K_hi) have an
//   accumulator of their own, added to Q_hi K_hi's at the end, and each
//   half of a kv tile's P V (12 steps) is summed apart and then added to o
//   on the CUDA cores (o corr + P V by fmaf, rounded to nearest), as the
//   first float32 kernel of this port learned to: one chain over all 8192
//   keys of StarCoder2-3B's layers strayed from the plain version's chunked
//   sums by 1.1x chip_smoke.py's per-layer float32 gate even in float32
//   FMAs (whole 64-key tiles in the tensor core: 0.67 of it; half tiles:
//   0.53).
//   Design: one block of 2 warpgroups (256 threads) per (128 query rows,
//   head, batch), each warpgroup 64 rows; at hd 256, per 64 rows, each
//   warpgroup with half of hd (its half of Q K^T's steps, the partial sums
//   swapped through shared memory, and its half of the output columns), so
//   that the output accumulator, hd / 2 floats a thread otherwise, fits.
//   * One thread issues TMA loads: the Q tile once, each kv tile's raw K and
//     V, all in 128-byte-swizzled slabs of 32 hd columns. Tile j + 1's V
//     is loaded as soon as tile j's is split, and its K as soon as both
//     warpgroups are done with tile j's Q K^T, under the rest of the tile.
//   * The threads split K into K_hi (in place) and K_lo in K's own layout
//     (K-major, as Q K^T's B operand), and V into V^T_hi and V^T_lo: tf32
//     wgmma takes only K-major operands (transposes exist for 16-bit types
//     only), so each key's row of V becomes a column, with the 8 keys of
//     each step permuted so that P's accumulator registers are P V's A
//     fragment as they stand (no shuffles).
//   * Per kv tile of BK keys (64; 32 at hd 256, so that 227 KB hold it): S
//     by wgmma m64nBKk8, A = Q's split fragments from registers (loaded once
//     up to hd 80, 8 steps at a time from Q's tile above), B = K_hi/K_lo from
//     shared memory; scale, softcap (tanhf), masks only on tiles that cross
//     the band's edge; online softmax in float32 registers (expf, the row max
//     over the quad by shuffles); P_hi and P_lo in registers; P V by wgmma
//     m64n(hd)k8 (n128 a warpgroup at hd 256) from V^T_hi/V^T_lo, a half
//     tile at a time; o = o corr + P V in registers.
//   * Two block-wide barriers a tile and one in each warpgroup (four
//     block-wide at hd 256); the scores and the row statistics stay in
//     registers.
//   * Kv tiles wholly outside the block's causal/window band are never
//     loaded; a tile outside one warpgroup's band is skipped by it. Blocks
//     are launched longest rows first.
//   * hd 80 runs at its own width: 10 steps of Q K^T and wgmma n80 for P V.
//     Only the TMA slabs are 96 columns wide (columns 80-95 read as zeros and
//     are never multiplied).
//   * Shared memory: 57 KB (hd 32) to 225 KB (hd 128, 256); the launcher
//     raises the block's dynamic limit on every launch.
//   Against the first float32 kernel of this port (CUDA-core FMAs, 2 x 4
//   score tiles and P V loops bound by shared-memory loads, four
//   __syncthreads a 32-key tile with the scores and row statistics round-
//   tripping through shared memory, synchronous scalar K/V loads, hd 80 at
//   width 96): the products are on the tensor cores, their operands reach
//   them by descriptor or from registers, the statistics stay in registers,
//   the loads are asynchronous, and hd 80 does no padded work.

#include <cuda_runtime.h>

#include "flash_fwd_f32_sm90.cuh"
#include "flash_fwd_sm90.cuh"

namespace sm90_f32 {

inline int dispatch_hd(const void* q, const void* k, const void* v, const long long* sq,
                       const long long* sk, const long long* sv, const Params& p, int B, int hd,
                       cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<32>(q, k, v, sq, sk, sv, p, B, stream);
    case 64: return launch<64>(q, k, v, sq, sk, sv, p, B, stream);
    case 80: return launch<80>(q, k, v, sq, sk, sv, p, B, stream);
    case 128: return launch<128>(q, k, v, sq, sk, sv, p, B, stream);
    case 256: return launch<256>(q, k, v, sq, sk, sv, p, B, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace sm90_f32

// dtype: 0 float32 (3xTF32), 1 bfloat16; both on the tensor cores, both fed
// by TMA. Strides are in elements, for the (batch, seq, head) axes; the head
// dim is contiguous, base pointers and strides 16-byte aligned, as TMA
// wants. Returns 0 or the CUDA error of the launch (a refused launch never
// runs).
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype,
    int B, int S, int H, int KV, int hd,
    long long sqb, long long sqs, long long sqh,
    long long skb, long long sks, long long skh,
    long long svb, long long svs, long long svh,
    long long sob, long long sos, long long soh,
    float scale, int causal, int window, float cap, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long sq[3] = {sqb, sqs, sqh}, sk[3] = {skb, sks, skh}, sv[3] = {svb, svs, svh};
  if (dtype == 1) {
    const sm90::Params p{o, S, H, KV, {sob, sos, soh}, scale, causal, window, cap};
    return sm90::dispatch_hd(q, k, v, sq, sk, sv, p, B, hd, s);
  }
  if (dtype == 0) {
    const sm90_f32::Params p{o, S, H, KV, {sob, sos, soh}, scale, causal, window, cap};
    return sm90_f32::dispatch_hd(q, k, v, sq, sk, sv, p, B, hd, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

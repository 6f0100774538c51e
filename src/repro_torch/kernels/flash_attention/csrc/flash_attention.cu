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
// float32: flash_fwd_kernel, the first kernel of this port, on the CUDA
//   cores. Its gates (2e-5 against the plain version) need full float32
//   products, which no tensor-core type gives (TF32 keeps 10 bits), so it
//   stays a simple fp32 kernel whose loops are bound by shared-memory
//   loads, far from the float32 rate.
//   Design: one block of 256 threads per (64 query rows, head, batch).
//   * The Q tile is staged once in shared memory as fp32, transposed
//     ([d][row], one float of padding per row against bank conflicts).
//   * Kv tiles of 32 keys walk only the band the block can see: [q0 - window
//     + 1, last qpos] for a causal window, so tiles wholly outside the
//     causal/window band are skipped. K is staged transposed, V row-major.
//   * Scores: each thread computes a 2 x 4 tile of q . k over hd.
//   * Online softmax: 4 threads per row (shuffles), running max m, sum l and
//     the correction factor in shared memory.
//   * P V: warp w owns rows 8w..8w+7, lane owns columns lane + 32 i; the
//     output accumulator (8 x hd/32 floats a thread) lives in registers.
//     A tile's P V is summed apart and then added, acc corr + part: one
//     chain over all 8192 keys of StarCoder2-3B's layers strayed from the
//     plain version's chunked sums by 1.1x chip_smoke.py's per-layer float32
//     gate; two short chains stay near half of it.
//   * hd 80 runs at width 96 (3 output columns a lane): columns 80-95 load
//     as zeros and are never stored.
//   * Shared memory: 26 KB (hd 32) to 142 KB (hd 256): above the 48 KB
//     default, the launcher raises the block's dynamic shared memory limit
//     (on every launch, so it holds on whichever device runs it).

#include <cuda_runtime.h>
#include <math.h>

#include "flash_fwd_sm90.cuh"

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 32;        // keys per kv tile
constexpr int THREADS = 256;  // 8 warps

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int S, H, KV;
  long long sq[3], sk[3], sv[3], so[3];  // element strides of (batch, seq, head)
  float scale;
  int causal;
  int window;  // <= 0: no window
  float cap;   // <= 0: no softcap
};

__device__ __forceinline__ float to_f(float x) { return x; }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }

template <int HD>
struct Smem {  // sizes in floats
  static constexpr int Q = HD * (BQ + 1);  // Q tile, transposed: [d][row]
  static constexpr int K = HD * (BK + 1);  // K tile, transposed: [d][key]
  static constexpr int V = BK * HD;        // V tile: [key][d]
  static constexpr int P = BQ * (BK + 1);  // scores, then probabilities: [row][key]
  static constexpr int TOTAL = Q + K + V + P + 3 * BQ;  // + m, l, correction
  static constexpr size_t BYTES = sizeof(float) * TOTAL;
};

// HD: the width the tiles are built for; HD_IN <= HD: the head dim of the
// tensors (hd 80 at width 96: columns 80-95 load as zeros, exact zeros in
// q . k, and are never stored)
template <typename T, int HD, int HD_IN>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(Params p) {
  constexpr int CPT = HD / 32;  // output columns per thread
  constexpr int hd = HD_IN;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + Smem<HD>::Q;
  float* Vs = Ks + Smem<HD>::K;
  float* Ps = Vs + Smem<HD>::V;
  float* m_s = Ps + Smem<HD>::P;
  float* l_s = m_s + BQ;
  float* c_s = l_s + BQ;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int S = p.S;
  const int kvh = h / (p.H / p.KV);

  const T* qg = static_cast<const T*>(p.q) + b * p.sq[0] + h * p.sq[2];
  const T* kg = static_cast<const T*>(p.k) + b * p.sk[0] + kvh * p.sk[2];
  const T* vg = static_cast<const T*>(p.v) + b * p.sv[0] + kvh * p.sv[2];
  T* og = static_cast<T*>(p.o) + b * p.so[0] + h * p.so[2];

  for (int i = tid; i < BQ * HD; i += THREADS) {
    const int r = i / HD, d = i % HD;
    const int qpos = q0 + r;
    Qs[d * (BQ + 1) + r] = qpos < S && d < hd ? to_f(qg[qpos * p.sq[1] + d]) : 0.f;
  }
  if (tid < BQ) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }

  float acc[8][CPT];
#pragma unroll
  for (int rr = 0; rr < 8; ++rr)
#pragma unroll
    for (int i = 0; i < CPT; ++i) acc[rr][i] = 0.f;

  // the band of keys this block's rows can see
  const int q_last = min(q0 + BQ, S) - 1;
  const int k_end = p.causal ? q_last + 1 : S;
  int k_begin = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  k_begin = (k_begin / BK) * BK;

  const int r0 = 2 * (tid / 8);  // score rows r0, r0 + 1
  const int c0 = 4 * (tid % 8);  // score columns c0 .. c0 + 3

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < BK * HD; i += THREADS) {
      const int c = i / HD, d = i % HD;
      const int kpos = k0 + c;
      float kx = 0.f, vx = 0.f;
      if (kpos < S && d < hd) {
        kx = to_f(kg[kpos * p.sk[1] + d]);
        vx = to_f(vg[kpos * p.sv[1] + d]);
      }
      Ks[d * (BK + 1) + c] = kx;
      Vs[c * HD + d] = vx;
    }
    __syncthreads();

    {  // scores of a 2 x 4 tile, masked
      float s[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
      for (int d = 0; d < HD; ++d) {
        const float qa = Qs[d * (BQ + 1) + r0];
        const float qb = Qs[d * (BQ + 1) + r0 + 1];
        const float* kr = Ks + d * (BK + 1) + c0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[0][j] += qa * kr[j];
          s[1][j] += qb * kr[j];
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int qpos = q0 + r0 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int kpos = k0 + c0 + j;
          float x = s[i][j] * p.scale;
          if (p.cap > 0.f) x = p.cap * tanhf(x / p.cap);
          bool ok = kpos < S;
          if (p.causal) ok = ok && kpos <= qpos;
          if (p.window > 0) ok = ok && qpos - kpos < p.window;
          Ps[(r0 + i) * (BK + 1) + c0 + j] = ok ? x : -INFINITY;
        }
      }
    }
    __syncthreads();

    {  // online softmax: 4 threads per row, 8 keys each
      const int r = tid / 4, sub = tid % 4;
      float* prow = Ps + r * (BK + 1) + sub * 8;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) mx = fmaxf(mx, prow[j]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      const float m_safe = m_new == -INFINITY ? 0.f : m_new;  // a row masked so far
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float e = prow[j] == -INFINITY ? 0.f : expf(prow[j] - m_safe);
        prow[j] = e;
        sum += e;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      __syncwarp();  // every lane has read m_s[r] before it is written
      if (sub == 0) {
        const float corr = m_old == -INFINITY ? 0.f : expf(m_old - m_safe);
        m_s[r] = m_new;
        l_s[r] = l_s[r] * corr + sum;
        c_s[r] = corr;
      }
    }
    __syncthreads();

    // acc = acc * corr + P V, the tile's P V summed on its own first: two
    // short chains (32 keys, then one term a tile) instead of one chain over
    // every key, as the plain version's chunked products sum
    float part[8][CPT];
#pragma unroll
    for (int rr = 0; rr < 8; ++rr)
#pragma unroll
      for (int i = 0; i < CPT; ++i) part[rr][i] = 0.f;
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float vv[CPT];
#pragma unroll
      for (int i = 0; i < CPT; ++i) vv[i] = Vs[c * HD + lane + 32 * i];
#pragma unroll
      for (int rr = 0; rr < 8; ++rr) {
        const float pr = Ps[(warp * 8 + rr) * (BK + 1) + c];
#pragma unroll
        for (int i = 0; i < CPT; ++i) part[rr][i] += pr * vv[i];
      }
    }
#pragma unroll
    for (int rr = 0; rr < 8; ++rr) {
      const float corr = c_s[warp * 8 + rr];
#pragma unroll
      for (int i = 0; i < CPT; ++i) acc[rr][i] = fmaf(acc[rr][i], corr, part[rr][i]);
    }
  }
  __syncthreads();

#pragma unroll
  for (int rr = 0; rr < 8; ++rr) {
    const int r = warp * 8 + rr;
    const int qpos = q0 + r;
    if (qpos >= S) continue;
    const float denom = fmaxf(l_s[r], 1e-20f);
#pragma unroll
    for (int i = 0; i < CPT; ++i)
      if (lane + 32 * i < hd) og[qpos * p.so[1] + lane + 32 * i] = from_f<T>(acc[rr][i] / denom);
  }
}

template <typename T, int HD, int HD_IN = HD>
int launch(const Params& p, int B, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<T, HD, HD_IN>;
  constexpr size_t bytes = Smem<HD>::BYTES;
  // on every launch: the limit is held per device, and the call is cheap and
  // allowed while a graph is being captured
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((p.S + BQ - 1) / BQ, p.H, B);
  kernel<<<grid, THREADS, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_hd(const Params& p, int B, int hd, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<T, 32>(p, B, stream);
    case 64: return launch<T, 64>(p, B, stream);
    case 80: return launch<T, 96, 80>(p, B, stream);
    case 128: return launch<T, 128>(p, B, stream);
    case 256: return launch<T, 256>(p, B, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 float32 (the CUDA-core kernel), 1 bfloat16 (the tensor-core
// kernel). Strides are in elements, for the (batch, seq, head) axes; the head
// dim is contiguous (bf16: base pointers and strides 16-byte aligned, as TMA
// wants). Returns 0 or the CUDA error of the launch (a refused launch never
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
  if (dtype == 1) {
    sm90::Params p{o, S, H, KV, {sob, sos, soh}, scale, causal, window, cap};
    const long long sq[3] = {sqb, sqs, sqh}, sk[3] = {skb, sks, skh}, sv[3] = {svb, svs, svh};
    return sm90::dispatch_hd(q, k, v, sq, sk, sv, p, B, hd, s);
  }
  if (dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.S = S;
  p.H = H;
  p.KV = KV;
  p.sq[0] = sqb; p.sq[1] = sqs; p.sq[2] = sqh;
  p.sk[0] = skb; p.sk[1] = sks; p.sk[2] = skh;
  p.sv[0] = svb; p.sv[1] = svs; p.sv[2] = svh;
  p.so[0] = sob; p.so[1] = sos; p.so[2] = soh;
  p.scale = scale;
  p.causal = causal;
  p.window = window;
  p.cap = cap;
  return dispatch_hd<float>(p, B, hd, s);
}

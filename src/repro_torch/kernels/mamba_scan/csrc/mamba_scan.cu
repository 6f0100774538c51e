// Selective scan (the S6 recurrence of Mamba), forward, for Hopper (sm_90a).
//
// Replaces src/repro/kernels/mamba_scan/kernel.py:48, mamba_scan_pallas (the
// Pallas TPU kernel `_kernel`). It computes what that kernel computes, for
// every (batch b, channel d), from the zero state h (N values, float32):
//   da  = exp(dt_t A[d, :])
//   h  <- da h + (dt_t x_t) B_t        carried in registers, never written
//   y_t = sum_n h C_t + D[d] x_t
// x, dt and y are (B, S, di); B_t and C_t are (B, S, N), shared by every
// channel of a batch row. x, dt and B/C (one type for both) each are
// float32 or bfloat16, and y is written in x's type, as the TPU kernel
// writes it (the bf16 model hands over bf16 x, column views of its bf16
// projection for B/C and a float32 dt, and takes y in bf16). Every input
// is cast to float32 on load, which is exact; all the math is float32.
//
// Arithmetic: dt A, dt x, da h, (dt x) B, da h + (dt x) B, D x and the final
// add are rounded one by one, as the plain version (ref.py) rounds them
// (__fmul_rn / __fadd_rn, which nvcc never contracts into an FMA), and the
// exponential is `expf`, the CUDA math library's accurate one (at most 2 ulp),
// which PyTorch's own exp on the card also calls, so the state evolves as the
// plain version's does on the card. `__expf` (ex2.approx of a rescaled
// argument) would save about 6 float32 instructions per state and step but
// errs by a few ulp more each step, and those errors compound over the
// hundreds of steps a slow-decaying state remembers. The one order that
// differs is the sum over n in y: each lane sums its 4 states with FMAs, then
// the lanes of one channel add their partial sums in a butterfly; the plain
// version's einsum sums in its library's order.
//
// What bounds it on this card: per (t, d, n) the function needs one
// exponential and 6 float32 operations (dt A, da h, (dt x) B, their add, and
// the FMA of h C into y), and per (t, d) the reads of x and dt and the write
// of y. At the full-width Jamba-1.5-Large layer (B 1, S 4096, di 16384,
// N 16) that is 1.07e9 exponentials: at 16 a clock on each of 132 SMs
// (about 4.2e12 a second) 0.26 ms if the exponential unit computes them all.
// The float32 operations take 0.10 ms at 67 TFLOP/s, and the bytes (x and y
// in bf16, dt in float32: 0.54 GB) 0.16 ms. A third of the exponentials can
// run instead as a degree-5 polynomial on the float32 pipe (13 operations
// each, as FlashAttention-3 splits its exponentials), which levels the two
// units at 0.17 ms: the operations bind. With `expf` (about 8 instructions,
// one of them on the exponential unit) this kernel executes about 65
// instructions per lane and step, 260 per channel and step, which puts its
// own floor near 0.5 ms.
//
// Design: the TPU kernel walks a (B, di/bd, S/ct) grid in order and carries h
// in VMEM across the time chunks. Here blocks run in no order, so time is a
// loop inside each block, and a block owns CH = 64 channels of one batch row
// for the whole sequence: grid (di / CH, B), 256 blocks at B 1. One thread per
// channel would give only 16,384 threads at B 1, one warp per scheduler, as
// the WKV6 kernel that ended latency-bound; so G = N / 4 neighbouring lanes
// share a channel, 4 of its states each in registers (256 threads a block at
// N 16), and y is 4 FMAs and a butterfly of log2(G) shuffles. x, dt, B and
// C stream through shared memory in chunks of CT = 16 steps (float32); each
// thread loads its share of the next chunk into registers before it computes
// the current one, so the loads overlap the compute. Registers decide how
// many warps an SM holds: with 32-step chunks and the time loop unrolled
// twice, ptxas took 160 registers a thread, so one block (8 warps) fitted an
// SM and the layer took 1.43 ms on an H100 SXM; 16-step chunks, not
// unrolled, leave room for two blocks (16 warps) an SM without spilling. y
// is staged in shared memory and written a chunk at a time, so its stores
// are coalesced. A ragged S, or a di that is not a multiple of CH, is
// handled in the kernel (the TPU op pads time with dt = 0): a missing step
// or channel loads zeros and stores nothing. Strided x, dt, B and C are read
// by stride, the state dim of B and C and the channel dim of x and dt
// contiguous. A simple first kernel: no cp.async or TMA, and no chunked
// (parallel-in-time) form of the scan.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int SPL = 4;   // states per lane
constexpr int CH = 64;   // channels per block
constexpr int CT = 16;   // time steps per chunk

struct Params {
  const void* x;
  const void* dt;
  const void* b;
  const void* c;
  const float* A;  // (di, N), contiguous
  const float* D;  // (di,)
  void* y;         // (B, S, di), contiguous
  int S, di;
  long long sx[2], sdt[2], sb[2], sc[2];  // element strides of (batch, time)
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <int N>
struct Shape {
  static constexpr int G = N / SPL;             // lanes per channel
  static constexpr int THREADS = CH * G;
  static constexpr int NX = CT * CH / THREADS;  // x, dt (and y) elements a thread moves per chunk
  static constexpr int NB = CT * N / THREADS;   // B, C elements a thread stages per chunk
  static_assert(N % SPL == 0 && 32 % G == 0, "a channel's lanes lie in one warp");
  static_assert(NX * THREADS == CT * CH && NB * THREADS == CT * N, "chunk split");
};

// TX: x and y; TD: dt; TB: B and C
template <typename TX, typename TD, typename TB, int N>
__global__ void __launch_bounds__(Shape<N>::THREADS) mamba_scan_fwd_kernel(Params p) {
  using Sh = Shape<N>;
  constexpr int G = Sh::G, THREADS = Sh::THREADS, NX = Sh::NX, NB = Sh::NB;
  __shared__ float xs[CT * CH];
  __shared__ float dts[CT * CH];
  __shared__ float ys[CT * CH];
  __shared__ __align__(16) float bs[CT * N];
  __shared__ __align__(16) float cs[CT * N];

  const int tid = threadIdx.x;
  const int sub = tid % G;   // this lane's states: sub * SPL .. sub * SPL + SPL - 1
  const int ch = tid / G;    // this lane's channel in the block's tile
  const int c0 = blockIdx.x * CH;
  const int bb = blockIdx.y;
  const int S = p.S, di = p.di;

  const TX* xg = static_cast<const TX*>(p.x) + bb * p.sx[0] + c0;
  const TD* dtg = static_cast<const TD*>(p.dt) + bb * p.sdt[0] + c0;
  const TB* bg = static_cast<const TB*>(p.b) + bb * p.sb[0];
  const TB* cg = static_cast<const TB*>(p.c) + bb * p.sc[0];
  TX* yg = static_cast<TX*>(p.y) + static_cast<long long>(bb) * S * di + c0;

  const int d = min(c0 + ch, di - 1);  // a lane past di computes on a clamped
  float a[SPL], h[SPL];                // channel's A and stores nothing
#pragma unroll
  for (int m = 0; m < SPL; ++m) {
    a[m] = p.A[static_cast<long long>(d) * N + sub * SPL + m];
    h[m] = 0.f;
  }
  const float dd = p.D[d];

  // this thread's share of a chunk, in flight in registers: element e of a
  // chunk is step e / CH, channel e % CH (x, dt) or step e / N, state e % N
  // (B, C), so neighbouring threads read neighbouring addresses
  TX rx[NX];
  TD rd[NX];
  TB rb[NB], rc[NB];
  auto load = [&](int t0) {
#pragma unroll
    for (int m = 0; m < NX; ++m) {
      const int e = tid + THREADS * m;
      const int t = t0 + e / CH, k = e % CH;
      const bool ok = t < S && c0 + k < di;
      rx[m] = ok ? xg[t * p.sx[1] + k] : from_f<TX>(0.f);
      rd[m] = ok ? dtg[t * p.sdt[1] + k] : from_f<TD>(0.f);
    }
#pragma unroll
    for (int m = 0; m < NB; ++m) {
      const int e = tid + THREADS * m;
      const int t = t0 + e / N, n = e % N;
      const bool ok = t < S;
      rb[m] = ok ? bg[t * p.sb[1] + n] : from_f<TB>(0.f);
      rc[m] = ok ? cg[t * p.sc[1] + n] : from_f<TB>(0.f);
    }
  };

  load(0);
  for (int t0 = 0; t0 < S; t0 += CT) {
    __syncthreads();  // the previous chunk's readers and writers are done
#pragma unroll
    for (int m = 0; m < NX; ++m) {
      xs[tid + THREADS * m] = to_f(rx[m]);
      dts[tid + THREADS * m] = to_f(rd[m]);
    }
#pragma unroll
    for (int m = 0; m < NB; ++m) {
      bs[tid + THREADS * m] = to_f(rb[m]);
      cs[tid + THREADS * m] = to_f(rc[m]);
    }
    __syncthreads();
    if (t0 + CT < S) load(t0 + CT);  // the next chunk loads while this one runs

    const int n_steps = min(CT, S - t0);
#pragma unroll 1
    for (int t = 0; t < n_steps; ++t) {
      const float xv = xs[t * CH + ch];
      const float dtv = dts[t * CH + ch];
      const float4 bv = *reinterpret_cast<const float4*>(bs + t * N + sub * SPL);
      const float4 cv = *reinterpret_cast<const float4*>(cs + t * N + sub * SPL);
      const float bm[SPL] = {bv.x, bv.y, bv.z, bv.w};
      const float cm[SPL] = {cv.x, cv.y, cv.z, cv.w};
      const float dtx = __fmul_rn(dtv, xv);
      float y = 0.f;
#pragma unroll
      for (int m = 0; m < SPL; ++m) {
        const float da = expf(__fmul_rn(dtv, a[m]));
        h[m] = __fadd_rn(__fmul_rn(da, h[m]), __fmul_rn(dtx, bm[m]));
        y = fmaf(h[m], cm[m], y);
      }
#pragma unroll
      for (int o = G / 2; o > 0; o /= 2) y += __shfl_xor_sync(0xffffffffu, y, o);
      if (sub == 0) ys[t * CH + ch] = __fadd_rn(y, __fmul_rn(dd, xv));
    }
    __syncthreads();
#pragma unroll
    for (int m = 0; m < NX; ++m) {
      const int e = tid + THREADS * m;
      const int t = t0 + e / CH, k = e % CH;
      if (t < S && c0 + k < di) yg[static_cast<long long>(t) * di + k] = from_f<TX>(ys[e]);
    }
  }
}

template <typename TX, typename TD, typename TB, int N>
int launch(const Params& p, int B, cudaStream_t stream) {
  dim3 grid((p.di + CH - 1) / CH, B);
  mamba_scan_fwd_kernel<TX, TD, TB, N><<<grid, Shape<N>::THREADS, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename TX, typename TD, typename TB>
int dispatch_n(const Params& p, int N, int B, cudaStream_t stream) {
  switch (N) {
    case 8: return launch<TX, TD, TB, 8>(p, B, stream);
    case 16: return launch<TX, TD, TB, 16>(p, B, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename TX, typename TD>
int dispatch_b(const Params& p, int b_dtype, int N, int B, cudaStream_t stream) {
  if (b_dtype == 0) return dispatch_n<TX, TD, float>(p, N, B, stream);
  if (b_dtype == 1) return dispatch_n<TX, TD, __nv_bfloat16>(p, N, B, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename TX>
int dispatch_dt(const Params& p, int dt_dtype, int b_dtype, int N, int B, cudaStream_t stream) {
  if (dt_dtype == 0) return dispatch_b<TX, float>(p, b_dtype, N, B, stream);
  if (dt_dtype == 1) return dispatch_b<TX, __nv_bfloat16>(p, b_dtype, N, B, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x_dtype (x and y), dt_dtype, b_dtype (B and C): 0 float32, 1 bfloat16. A
// (di, N) and D (di,) are float32 and contiguous; y (B, S, di) is contiguous.
// Strides are in elements, for the (batch, time) axes; the channel dim of x
// and dt and the state dim of B and C are contiguous. Returns 0 or the CUDA
// error of the launch (a refused launch never runs).
extern "C" int mamba_scan_fwd(
    const void* x, const void* dt, const void* b, const void* c, const float* A,
    const float* D, void* y,
    int x_dtype, int dt_dtype, int b_dtype, int B, int S, int di, int N,
    long long sxb, long long sxt, long long sdtb, long long sdtt,
    long long sbb, long long sbt, long long scb, long long sct,
    void* stream) {
  Params p;
  p.x = x;
  p.dt = dt;
  p.b = b;
  p.c = c;
  p.A = A;
  p.D = D;
  p.y = y;
  p.S = S;
  p.di = di;
  p.sx[0] = sxb; p.sx[1] = sxt;
  p.sdt[0] = sdtb; p.sdt[1] = sdtt;
  p.sb[0] = sbb; p.sb[1] = sbt;
  p.sc[0] = scb; p.sc[1] = sct;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0) return dispatch_dt<float>(p, dt_dtype, b_dtype, N, B, s);
  if (x_dtype == 1) return dispatch_dt<__nv_bfloat16>(p, dt_dtype, b_dtype, N, B, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// WKV6 recurrence (the time mix of RWKV-6), forward, for Hopper (sm_90a).
//
// Replaces src/repro/kernels/rwkv6_scan/kernel.py:47, rwkv6_scan_pallas (the
// Pallas TPU kernel `_kernel`). It computes what that kernel computes, for
// every (batch b, head h), from the zero state S (hd x hd, float32):
//   kv  = k_t^T v_t
//   y_t = r_t (S + diag(u) kv)
//   S  <- diag(w_t) S + kv           carried in registers, never written
// r, k and v share one type, float32 or bfloat16; w and y each are float32
// or bfloat16 on their own (the model hands over its bf16 projections, a
// float32 decay, and takes y in float32); u is float32. Every input is cast
// to float32 on load, which is exact; all the math is float32.
//
// Arithmetic: kv, u * kv, S + u * kv, w * S and w * S + kv are rounded one by
// one, as the plain version (ref.py) rounds them (__fmul_rn / __fadd_rn, which
// nvcc never contracts into an FMA), so the state evolves bit for bit as the
// plain version's. The one order that differs is the sum over the key index i
// in y: each lane sums its 8 keys in order with FMAs, then the lanes of one
// column add their partial sums in a butterfly; the plain version's einsum
// sums in its library's order.
//
// Layout: r, k, v, w and y are (B, H, S, hd) read and written by stride (the
// head dim contiguous), so the model's (B, S, H, hd) projections, seen as
// (B, H, S, hd) views, need no transposed copy. The kernel handles a ragged S
// itself: the last chunk loads and runs only its valid steps; nothing is padded.
//
// What bounds it on this card: per (b, h, t) it reads 4 hd inputs and writes
// hd outputs. The function needs 5 float32 operations on each of the hd x hd
// state entries: y_j = sum_i r_i S_ij + v_j (sum_i r_i u_i k_i), whose second
// sum is O(hd) a step, and S <- fma(w, S, k v_j). At the full-width RWKV-6
// 1.6B layer (B 1, S 4096, H 32, hd 64) in float32 that is 168 MB against
// 2.7 GFLOP: 0.050 ms of memory time against 0.040 ms at the float32 peak, so
// the bytes bind (with the model's bf16 r, k, v: 117 MB, 0.035 ms, and the
// operations bind). This kernel evaluates the unfactored form, 7 operations
// an entry (kv, u * kv, the add, the FMA into y, w * S, the add), to keep the
// plain version's rounding. What stands in the way is that the recurrence is
// sequential in t, and at B = 1 there are only B * H = 32 (b, h) pairs for
// 132 SMs.
//
// Design: each value column j of the state evolves on its own,
//   S[:, j] <- w (.) S[:, j] + k v_j,   y_j = sum_i r_i (S[i, j] + u_i k_i v_j),
// so the grid is (column tiles, H, B): a block owns COLS = 16 columns of one
// (b, h) (128 blocks of 128 threads at B 1, H 32, hd 64). G = hd / 8
// neighbouring lanes share one column, each holding 8 of its keys in
// registers, so the state never leaves registers. A step costs a lane 8 x 6
// float32 instructions and a butterfly of log2(G) shuffles; the sum for y is
// off the recurrence's critical path (S needs one multiply and one add a
// step). The inputs stream through shared memory in chunks of CT steps (r, k,
// w: CT x hd; v: CT x COLS; float32); each thread loads its share of the next
// chunk into registers before it computes the current one, so the loads
// overlap the compute. A simple first kernel: no cp.async or TMA, and no
// chunked (parallel-in-time) form of the recurrence.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int KPL = 8;    // keys per lane
constexpr int COLS = 16;  // value columns per block
constexpr int CT = 32;    // time steps per chunk

struct Params {
  const void* r;
  const void* k;
  const void* v;
  const void* w;
  const float* u;  // (H, hd), contiguous
  void* y;
  int S;
  long long sr[3], sk[3], sv[3], sw[3], sy[3];  // element strides of (batch, head, time)
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <int HD>
struct Shape {
  static constexpr int G = HD / KPL;              // lanes per column
  static constexpr int THREADS = COLS * G;
  static constexpr int NK = CT * HD / THREADS;    // r, k, w elements a thread stages per chunk
  static constexpr int NV = CT * COLS / THREADS;  // v elements a thread stages per chunk
  static_assert(32 % G == 0 && THREADS % 32 == 0, "a column's lanes lie in one warp");
  static_assert(NK * THREADS == CT * HD && NV * THREADS == CT * COLS, "chunk split");
};

// T: r, k, v; TW: w; TY: y
template <typename T, typename TW, typename TY, int HD>
__global__ void __launch_bounds__(Shape<HD>::THREADS) wkv6_fwd_kernel(Params p) {
  using Sh = Shape<HD>;
  constexpr int G = Sh::G, THREADS = Sh::THREADS, NK = Sh::NK, NV = Sh::NV;
  __shared__ __align__(16) float rs[CT * HD];
  __shared__ __align__(16) float ks[CT * HD];
  __shared__ __align__(16) float ws[CT * HD];
  __shared__ float vs[CT * COLS];

  const int tid = threadIdx.x;
  const int sub = tid % G;   // this lane's keys: sub * KPL .. sub * KPL + KPL - 1
  const int col = tid / G;   // this lane's column in the block's tile
  const int j0 = blockIdx.x * COLS;
  const int h = blockIdx.y, b = blockIdx.z;
  const int S = p.S;

  const T* rg = static_cast<const T*>(p.r) + b * p.sr[0] + h * p.sr[1];
  const T* kg = static_cast<const T*>(p.k) + b * p.sk[0] + h * p.sk[1];
  const T* vg = static_cast<const T*>(p.v) + b * p.sv[0] + h * p.sv[1] + j0;
  const TW* wg = static_cast<const TW*>(p.w) + b * p.sw[0] + h * p.sw[1];
  TY* yg = static_cast<TY*>(p.y) + b * p.sy[0] + h * p.sy[1] + j0 + col;

  float u[KPL], st[KPL];
#pragma unroll
  for (int m = 0; m < KPL; ++m) {
    u[m] = p.u[h * HD + sub * KPL + m];
    st[m] = 0.f;
  }

  // this thread's share of a chunk, in flight in registers: element e of a
  // chunk is step e / HD, key e % HD (r, k, w) or step e / COLS, column
  // e % COLS (v), so neighbouring threads read neighbouring addresses
  T cr[NK], ck[NK], cv[NV];
  TW cw[NK];
  auto load = [&](int t0) {
#pragma unroll
    for (int m = 0; m < NK; ++m) {
      const int e = tid + THREADS * m;
      const int t = t0 + e / HD, i = e % HD;
      const bool ok = t < S;
      cr[m] = ok ? rg[t * p.sr[2] + i] : from_f<T>(0.f);
      ck[m] = ok ? kg[t * p.sk[2] + i] : from_f<T>(0.f);
      cw[m] = ok ? wg[t * p.sw[2] + i] : from_f<TW>(0.f);
    }
#pragma unroll
    for (int m = 0; m < NV; ++m) {
      const int e = tid + THREADS * m;
      const int t = t0 + e / COLS, c = e % COLS;
      cv[m] = t < S ? vg[t * p.sv[2] + c] : from_f<T>(0.f);
    }
  };

  load(0);
  for (int t0 = 0; t0 < S; t0 += CT) {
    __syncthreads();  // the previous chunk's readers are done
#pragma unroll
    for (int m = 0; m < NK; ++m) {
      const int e = tid + THREADS * m;
      rs[e] = to_f(cr[m]);
      ks[e] = to_f(ck[m]);
      ws[e] = to_f(cw[m]);
    }
#pragma unroll
    for (int m = 0; m < NV; ++m) vs[tid + THREADS * m] = to_f(cv[m]);
    __syncthreads();
    if (t0 + CT < S) load(t0 + CT);  // the next chunk loads while this one runs

    const int n = min(CT, S - t0);
#pragma unroll 2
    for (int t = 0; t < n; ++t) {
      float rr[KPL], kk[KPL], ww[KPL];
      const float4* r4 = reinterpret_cast<const float4*>(rs + t * HD + sub * KPL);
      const float4* k4 = reinterpret_cast<const float4*>(ks + t * HD + sub * KPL);
      const float4* w4 = reinterpret_cast<const float4*>(ws + t * HD + sub * KPL);
#pragma unroll
      for (int q = 0; q < KPL / 4; ++q) {
        const float4 a = r4[q], c = k4[q], d = w4[q];
        rr[4 * q] = a.x; rr[4 * q + 1] = a.y; rr[4 * q + 2] = a.z; rr[4 * q + 3] = a.w;
        kk[4 * q] = c.x; kk[4 * q + 1] = c.y; kk[4 * q + 2] = c.z; kk[4 * q + 3] = c.w;
        ww[4 * q] = d.x; ww[4 * q + 1] = d.y; ww[4 * q + 2] = d.z; ww[4 * q + 3] = d.w;
      }
      const float vj = vs[t * COLS + col];
      float y = 0.f;
#pragma unroll
      for (int m = 0; m < KPL; ++m) {
        const float kv = __fmul_rn(kk[m], vj);
        y = fmaf(rr[m], __fadd_rn(st[m], __fmul_rn(u[m], kv)), y);
        st[m] = __fadd_rn(__fmul_rn(ww[m], st[m]), kv);
      }
#pragma unroll
      for (int o = G / 2; o > 0; o /= 2) y += __shfl_xor_sync(0xffffffffu, y, o);
      if (sub == 0) yg[(t0 + t) * p.sy[2]] = from_f<TY>(y);
    }
  }
}

template <typename T, typename TW, typename TY, int HD>
int launch(const Params& p, int B, int H, cudaStream_t stream) {
  dim3 grid(HD / COLS, H, B);
  wkv6_fwd_kernel<T, TW, TY, HD><<<grid, Shape<HD>::THREADS, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename TW, typename TY>
int dispatch_hd(const Params& p, int B, int H, int hd, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<T, TW, TY, 32>(p, B, H, stream);
    case 64: return launch<T, TW, TY, 64>(p, B, H, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, typename TW>
int dispatch_y(const Params& p, int y_dtype, int B, int H, int hd, cudaStream_t stream) {
  if (y_dtype == 0) return dispatch_hd<T, TW, float>(p, B, H, hd, stream);
  if (y_dtype == 1) return dispatch_hd<T, TW, __nv_bfloat16>(p, B, H, hd, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int dispatch_w(const Params& p, int w_dtype, int y_dtype, int B, int H, int hd,
               cudaStream_t stream) {
  if (w_dtype == 0) return dispatch_y<T, float>(p, y_dtype, B, H, hd, stream);
  if (w_dtype == 1) return dispatch_y<T, __nv_bfloat16>(p, y_dtype, B, H, hd, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype (r, k, v), w_dtype, y_dtype: 0 float32, 1 bfloat16; u is float32
// (H, hd), contiguous. Strides are in elements, for the (batch, head, time)
// axes; the head dim is contiguous. Returns 0 or the CUDA error of the launch
// (a refused launch never runs).
extern "C" int rwkv6_scan_fwd(
    const void* r, const void* k, const void* v, const void* w, const float* u, void* y,
    int dtype, int w_dtype, int y_dtype, int B, int H, int S, int hd,
    long long srb, long long srh, long long srt,
    long long skb, long long skh, long long skt,
    long long svb, long long svh, long long svt,
    long long swb, long long swh, long long swt,
    long long syb, long long syh, long long syt,
    void* stream) {
  Params p;
  p.r = r;
  p.k = k;
  p.v = v;
  p.w = w;
  p.u = u;
  p.y = y;
  p.S = S;
  p.sr[0] = srb; p.sr[1] = srh; p.sr[2] = srt;
  p.sk[0] = skb; p.sk[1] = skh; p.sk[2] = skt;
  p.sv[0] = svb; p.sv[1] = svh; p.sv[2] = svt;
  p.sw[0] = swb; p.sw[1] = swh; p.sw[2] = swt;
  p.sy[0] = syb; p.sy[1] = syh; p.sy[2] = syt;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_w<float>(p, w_dtype, y_dtype, B, H, hd, s);
  if (dtype == 1) return dispatch_w<__nv_bfloat16>(p, w_dtype, y_dtype, B, H, hd, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

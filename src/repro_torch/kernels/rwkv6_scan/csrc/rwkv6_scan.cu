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
// to float32 on use, which is exact; all the math is float32.
//
// What bounds it on this card: per (b, h, t) it reads 4 hd inputs and writes
// hd outputs. The function needs 5 float32 operations on each of the hd x hd
// state entries: y_j = sum_i r_i S_ij + v_j (sum_i r_i u_i k_i), whose second
// sum is O(hd) a step, and S <- fma(w, S, k v_j). At the full-width RWKV-6
// 1.6B layer (B 1, S 4096, H 32, hd 64) with the model's bf16 r, k, v that is
// 117 MB (0.035 ms) against 2.7 GFLOP (0.0407 ms at the float32 peak): the
// operations bind. All in float32 it is 168 MB, 0.050 ms, and the bytes bind.
//
// The state's rounding is pinned. Each entry evolves as the plain version
// (ref.py) rounds it, S <- (w * S) + (k * v) with every op rounded on its own
// (__fmul_rn / __fadd_rn, never contracted into an FMA), so S is bit for bit
// the plain version's. The float32 gate (1e-4 absolute and relative) allows
// nothing else at S 4096: on the CPU, at (1, 2, 4096, 64) under the model's
// decay law (w = exp(-exp(-6 + 0.5 z)), bf16-rounded r/k/v), the plain
// float32 recurrence itself lies 1.55 times the gate from the float64 one,
// and the chunked (parallel-in-time) form, computed in float32 with its decay
// taken in log space about each chunk's middle, lies 1.75, 1.69 and 1.52
// times the gate from the plain float32 recurrence at chunk lengths 16, 32
// and 64 (under a strong decay, w = exp(-exp(1 + 0.5 z)), it also went
// non-finite at 32 and 64). So there is no chunked form and no tensor-core
// product of the state here: the recurrence stays sequential in t, and the
// speed comes from occupancy and instruction count. With the state pinned,
// the design's own floor is 4 issue slots per entry and step (k v, w S, the
// add, and the FMA of r S into y): 5.37e8 entry-steps at (1, 32, 4096, 64),
// 6.7e7 warp instructions over the 528 schedulers at 1.98 GHz, 0.064 ms.
//
// Only y's rounding moves, and y is not carried: y_j = sum_i r_i S_ij, with
// S taken before the step's update, plus v_j c_t, where the bonus sum
// c_t = sum_i r_i u_i k_i is computed once per step for the whole block (not
// once per entry, as the unfactored r_i (S_ij + u_i k_i v_j) would).
//
// Design: each value column j evolves on its own,
//   S[:, j] <- w (.) S[:, j] + k v_j,   y_j = sum_i r_i S_ij + v_j c_t,
// so the grid is (column tiles, H, B) and a block of 8 warps owns COLS value
// columns of one (b, h): 16 at hd 64, 4 blocks a head, 128 blocks at B 1,
// H 32 (one an SM, 8 warps). A lane holds KPL = 2 keys of CPL = 2 columns
// (4 state entries); G = hd / 2 lanes (a column group: a warp at hd 64,
// half a warp at hd 32) hold a pair of columns whole. (8 keys of one column
// a lane leave 3.9 warps an SM at over 200 registers, one warp a scheduler,
// waiting on latency.) Every block of a head reads all of the head's r, k
// and w, so fewer, wider blocks read less from L2: 8 warps a block ran
// faster than 4 or 2. r, k, w and v stay
// in their own types: each chunk of CT = G steps (r, k, w: CT x hd; v:
// CT x COLS) streams into shared memory with cp.async in 16-byte pieces,
// double-buffered, so chunk n + 1 loads while chunk n runs, and bf16 is
// converted where it is used. Each thread's pieces and their addresses are
// worked out once, before the time loop (worked out each chunk, they cost
// more than the copies). Views whose starts or strides are not 16-byte
// multiples take synchronous loads into the same buffers. Within a chunk a
// lane keeps its partial y_j of every step in registers; at the chunk's end
// one transposing shuffle pass sums them over the group's G lanes (G - 1
// shuffles and adds for G steps, where a butterfly every step would take
// G log2(G)), after which lane s holds step s's sum. Lane s adds v_j c_t and
// stores its two columns at once at the next chunk's barrier, once the
// block's bonus sums are visible, so a chunk needs one barrier. Steps past a
// ragged S load zeros, run, and store nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int KPL = 2;    // keys per lane
constexpr int CPL = 2;    // value columns per lane
constexpr int WARPS = 8;  // warps per block

template <int HD>
struct Shape {
  static constexpr int G = HD / KPL;              // lanes of a column group
  static constexpr int CT = G;                    // time steps per chunk
  static constexpr int GPW = 32 / G;              // column groups per warp
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int COLS = WARPS * GPW * CPL;  // value columns per block
  static constexpr int PARTS = THREADS / CT;      // threads per step of the bonus sums
  static constexpr int KPP = HD / PARTS;          // keys per such thread
  static_assert(HD % COLS == 0 && THREADS % CT == 0 && 32 % PARTS == 0, "tiling");
};

struct Params {
  const void* r;
  const void* k;
  const void* v;
  const void* w;
  const float* u;  // (H, hd), contiguous
  void* y;
  int S;
  int aligned;     // r, k, v, w start on 16 bytes, strides 16-byte multiples: cp.async
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

// K consecutive elements of shared memory (aligned to their total size, up
// to 16 bytes) into float32
template <int K>
__device__ __forceinline__ void lds(const float* src, float (&d)[K]) {
  if constexpr (K % 4 == 0) {
#pragma unroll
    for (int q = 0; q < K / 4; ++q) {
      const float4 a = reinterpret_cast<const float4*>(src)[q];
      d[4 * q] = a.x; d[4 * q + 1] = a.y; d[4 * q + 2] = a.z; d[4 * q + 3] = a.w;
    }
  } else if constexpr (K == 2) {
    const float2 a = *reinterpret_cast<const float2*>(src);
    d[0] = a.x; d[1] = a.y;
  } else {
#pragma unroll
    for (int q = 0; q < K; ++q) d[q] = src[q];
  }
}
template <int K>
__device__ __forceinline__ void lds(const __nv_bfloat16* src, float (&d)[K]) {
  if constexpr (K % 8 == 0) {
#pragma unroll
    for (int q = 0; q < K / 8; ++q) {
      const uint4 a = reinterpret_cast<const uint4*>(src)[q];
      const unsigned w4[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        d[8 * q + 2 * e] = __uint_as_float(w4[e] << 16);
        d[8 * q + 2 * e + 1] = __uint_as_float(w4[e] & 0xffff0000u);
      }
    }
  } else if constexpr (K % 2 == 0) {
#pragma unroll
    for (int q = 0; q < K / 2; ++q) {
      const unsigned a = reinterpret_cast<const unsigned*>(src)[q];
      d[2 * q] = __uint_as_float(a << 16);
      d[2 * q + 1] = __uint_as_float(a & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int q = 0; q < K; ++q) d[q] = __bfloat162float(src[q]);
  }
}

// a lane's CPL consecutive columns of y, stored at once
template <typename T>
struct __align__(CPL * sizeof(T)) Cols {
  T v[CPL];
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// One thread's share of staging a (time, E) slab of global memory (row
// stride `st` elements, 16-byte aligned rows) chunk by chunk: pieces tid,
// tid + THREADS, ... of 16 bytes of the CT x E chunk, kept dense in shared
// memory; rows past S are zero-filled. All but the chunk's start is worked
// out once, so a piece costs a compare, an address and its cp.async.
template <typename T, int E, int CT, int THREADS>
struct SlabCopy {
  static constexpr int EPP = 16 / static_cast<int>(sizeof(T));  // elements a piece
  static constexpr int PER_ROW = E / EPP;
  static constexpr int PIECES = CT * PER_ROW;
  static constexpr int M = (PIECES + THREADS - 1) / THREADS;    // pieces a thread
  static constexpr int RSTEP = THREADS / PER_ROW;                // rows from one piece to the next
  static_assert(E % EPP == 0 && THREADS % PER_ROW == 0, "whole 16-byte pieces, whole rows a pass");
  const T* base;  // row 0 of the slab
  const T* src;   // this thread's first piece in the next chunk
  long long st;
  int row;        // that piece's row within a chunk
  int tid;

  __device__ SlabCopy(const T* g, long long stride, int t) : base(g), st(stride), tid(t) {
    row = t / PER_ROW;
    src = g + row * st + (t % PER_ROW) * EPP;
  }
  // the chunk at t0 (the one after the last issued) into `slab`
  __device__ __forceinline__ void issue(T* slab, int t0, int S) {
    const int rem = S - t0 - row;  // this thread's pieces at rows < rem are in the sequence
#pragma unroll
    for (int m = 0; m < M; ++m) {
      if (PIECES % THREADS == 0 || tid + m * THREADS < PIECES) {
        const bool ok = m * RSTEP < rem;
        cp_async16(slab + (tid + m * THREADS) * EPP, ok ? src + m * RSTEP * st : base, ok ? 16 : 0);
      }
    }
    src += CT * st;
  }
};

// rows [t0, t0 + CT) of a (time, E) slab of `g` (row stride `st`, rows past
// S read as zeros) into `dst` (CT x E, dense), by every thread: the path for
// views whose rows cp.async cannot move in 16-byte pieces
template <typename T, int E, int CT, int THREADS>
__device__ __forceinline__ void load_rows(T* dst, const T* g, long long st, int t0, int S, int tid) {
  for (int e = tid; e < CT * E; e += THREADS) {
    const int t = e / E, i = e % E;
    dst[e] = t0 + t < S ? g[(t0 + t) * st + i] : from_f<T>(0.f);
  }
}

// Sums v[i] over the G lanes of a group for every i, transposed: on return
// lane s of the group holds the sum of the group's v[s] in v[0]. Stage O
// pairs lane s with lane s ^ O: each keeps the half of v[0 .. 2 O) its bit
// O selects and adds the partner's copy of it. G - 1 shuffles in all.
template <int O, int G>
__device__ __forceinline__ void transpose_sum(float (&v)[G], int s) {
  if constexpr (O > 0) {
    const bool up = s & O;
#pragma unroll
    for (int i = 0; i < O; ++i) {
      const float send = up ? v[i] : v[i + O];
      const float keep = up ? v[i + O] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
    }
    transpose_sum<O / 2>(v, s);
  }
}

template <typename T, typename TW, int HD>
struct Smem {
  using Sh = Shape<HD>;
  static constexpr int RK = Sh::CT * HD * static_cast<int>(sizeof(T));    // r or k, one stage
  static constexpr int W = Sh::CT * HD * static_cast<int>(sizeof(TW));
  static constexpr int V = Sh::CT * Sh::COLS * static_cast<int>(sizeof(T));
  static constexpr int STAGE = 2 * RK + W + V;
  static constexpr int BYTES = 2 * STAGE + 2 * Sh::CT * static_cast<int>(sizeof(float));
  static_assert(RK % 16 == 0 && W % 16 == 0 && V % 16 == 0, "16-byte aligned parts");
};

// T: r, k, v; TW: w; TY: y
template <typename T, typename TW, typename TY, int HD>
__global__ void __launch_bounds__(Shape<HD>::THREADS) wkv6_fwd_kernel(Params p) {
  using Sh = Shape<HD>;
  using Sm = Smem<T, TW, HD>;
  constexpr int G = Sh::G, CT = Sh::CT, THREADS = Sh::THREADS, COLS = Sh::COLS;
  constexpr int PARTS = Sh::PARTS, KPP = Sh::KPP;
  extern __shared__ __align__(16) unsigned char smem[];
  auto rs = [&](int buf) { return reinterpret_cast<T*>(smem + buf * Sm::STAGE); };
  auto ks = [&](int buf) { return reinterpret_cast<T*>(smem + buf * Sm::STAGE + Sm::RK); };
  auto ws = [&](int buf) { return reinterpret_cast<TW*>(smem + buf * Sm::STAGE + 2 * Sm::RK); };
  auto vs = [&](int buf) {
    return reinterpret_cast<T*>(smem + buf * Sm::STAGE + 2 * Sm::RK + Sm::W);
  };
  float* cs = reinterpret_cast<float*>(smem + 2 * Sm::STAGE);  // bonus sums c_t, 2 x CT

  const int tid = threadIdx.x, lane = tid % 32;
  const int s = lane % G;                              // keys 2s, 2s + 1; step s of a chunk's y
  const int jb = ((tid / 32) * Sh::GPW + lane / G) * CPL;  // first column in the block's tile
  const int j0 = blockIdx.x * COLS;
  const int h = blockIdx.y, b = blockIdx.z;
  const int S = p.S;
  const bool aligned = p.aligned != 0;

  const T* rg = static_cast<const T*>(p.r) + b * p.sr[0] + h * p.sr[1];
  const T* kg = static_cast<const T*>(p.k) + b * p.sk[0] + h * p.sk[1];
  const T* vg = static_cast<const T*>(p.v) + b * p.sv[0] + h * p.sv[1] + j0;
  const TW* wg = static_cast<const TW*>(p.w) + b * p.sw[0] + h * p.sw[1];
  TY* yg = static_cast<TY*>(p.y) + b * p.sy[0] + h * p.sy[1] + j0 + jb;

  // this thread's share of the bonus sums: step bt of a chunk, keys
  // bp * KPP .. bp * KPP + KPP - 1
  const int bt = tid / PARTS, bp = tid % PARTS;
  float ub[KPP];
#pragma unroll
  for (int m = 0; m < KPP; ++m) ub[m] = p.u[h * HD + bp * KPP + m];

  float st[KPL][CPL];
#pragma unroll
  for (int m = 0; m < KPL; ++m)
#pragma unroll
    for (int c = 0; c < CPL; ++c) st[m][c] = 0.f;
  float ysum[CPL], vlast[CPL];  // the last chunk's sum and v of step s, held for its store

  SlabCopy<T, HD, CT, THREADS> r_copy(rg, p.sr[2], tid), k_copy(kg, p.sk[2], tid);
  SlabCopy<TW, HD, CT, THREADS> w_copy(wg, p.sw[2], tid);
  SlabCopy<T, COLS, CT, THREADS> v_copy(vg, p.sv[2], tid);
  auto stage = [&](int t0, int buf) {  // chunk t0 into stage buf
    if (aligned) {
      r_copy.issue(rs(buf), t0, S);
      k_copy.issue(ks(buf), t0, S);
      w_copy.issue(ws(buf), t0, S);
      v_copy.issue(vs(buf), t0, S);
      cp_async_commit();
    } else {
      load_rows<T, HD, CT, THREADS>(rs(buf), rg, p.sr[2], t0, S, tid);
      load_rows<T, HD, CT, THREADS>(ks(buf), kg, p.sk[2], t0, S, tid);
      load_rows<TW, HD, CT, THREADS>(ws(buf), wg, p.sw[2], t0, S, tid);
      load_rows<T, COLS, CT, THREADS>(vs(buf), vg, p.sv[2], t0, S, tid);
    }
  };
  auto store = [&](int t0, const float* c) {  // y of step t0 + s, columns jb .. jb + CPL - 1
    const int t = t0 + s;
    Cols<TY> out;
#pragma unroll
    for (int q = 0; q < CPL; ++q) out.v[q] = from_f<TY>(fmaf(vlast[q], c[s], ysum[q]));
    if (t < S) *reinterpret_cast<Cols<TY>*>(yg + t * p.sy[2]) = out;  // one store of CPL columns
  };

  const int n_chunks = (S + CT - 1) / CT;
  stage(0, 0);
  for (int n = 0; n < n_chunks; ++n) {
    const int buf = n & 1, t0 = n * CT;
    cp_async_wait_all();
    __syncthreads();  // chunk n is in; chunk n - 1's readers are done
    if (n > 0) store(t0 - CT, cs + (buf ^ 1) * CT);
    if (n + 1 < n_chunks) stage(t0 + CT, buf ^ 1);

    {  // c_t = sum_i r_i u_i k_i for the chunk's steps
      float rr[KPP], kk[KPP];
      lds<KPP>(rs(buf) + bt * HD + bp * KPP, rr);
      lds<KPP>(ks(buf) + bt * HD + bp * KPP, kk);
      float c = 0.f;
#pragma unroll
      for (int m = 0; m < KPP; ++m) c = fmaf(rr[m] * ub[m], kk[m], c);
#pragma unroll
      for (int o = PARTS / 2; o > 0; o /= 2) c += __shfl_xor_sync(0xffffffffu, c, o);
      if (bp == 0) cs[buf * CT + bt] = c;
    }

    float part[CPL][CT];  // this lane's share of sum_i r_i S_ij, step by step
    const T* r_s = rs(buf) + KPL * s;
    const T* k_s = ks(buf) + KPL * s;
    const TW* w_s = ws(buf) + KPL * s;
    const T* v_s = vs(buf) + jb;
#pragma unroll
    for (int t = 0; t < CT; ++t) {
      float rr[KPL], kk[KPL], ww[KPL], vv[CPL];
      lds<KPL>(r_s + t * HD, rr);
      lds<KPL>(k_s + t * HD, kk);
      lds<KPL>(w_s + t * HD, ww);
      lds<CPL>(v_s + t * COLS, vv);
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        float y = __fmul_rn(rr[0], st[0][c]);
#pragma unroll
        for (int m = 1; m < KPL; ++m) y = fmaf(rr[m], st[m][c], y);
        part[c][t] = y;
#pragma unroll
        for (int m = 0; m < KPL; ++m)
          st[m][c] = __fadd_rn(__fmul_rn(ww[m], st[m][c]), __fmul_rn(kk[m], vv[c]));
      }
    }
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      transpose_sum<G / 2>(part[c], s);
      ysum[c] = part[c][0];
    }
    lds<CPL>(v_s + s * COLS, vlast);
  }
  __syncthreads();  // the last chunk's bonus sums are visible
  if (n_chunks > 0) store((n_chunks - 1) * CT, cs + ((n_chunks - 1) & 1) * CT);
}

template <typename T, typename TW, typename TY, int HD>
int launch(const Params& p, int B, int H, cudaStream_t stream) {
  auto kernel = wkv6_fwd_kernel<T, TW, TY, HD>;
  constexpr int bytes = Smem<T, TW, HD>::BYTES;
  // on every launch: the limit is held per device, and the call is cheap and
  // allowed while a graph is being captured
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(HD / Shape<HD>::COLS, H, B);
  kernel<<<grid, Shape<HD>::THREADS, bytes, stream>>>(p);
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
// axes; the head dim is contiguous. `aligned`: r, k, v, w start on 16 bytes
// and their strides are 16-byte multiples (the cp.async path; else
// synchronous loads). Returns 0 or the CUDA error of the launch (a refused
// launch never runs).
extern "C" int rwkv6_scan_fwd(
    const void* r, const void* k, const void* v, const void* w, const float* u, void* y,
    int dtype, int w_dtype, int y_dtype, int B, int H, int S, int hd, int aligned,
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
  p.aligned = aligned;
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

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
// is cast to float32 on use, which is exact; all the math is float32.
//
// What bounds it on this card: per (t, d, n) the function needs one
// exponential and 6 float32 operations (dt A, da h, (dt x) B, their add, and
// the FMA of h C into y), and per (t, d) the reads of x and dt and the write
// of y. At the full-width Jamba-1.5-Large layer (B 1, S 4096, di 16384,
// N 16) that is 1.07e9 exponentials: at 16 a clock on each of 132 SMs
// (about 4.2e12 a second) 0.256 ms if the exponential unit computes them
// all. The float32 operations take 0.10 ms at 67 TFLOP/s, and the bytes (x
// and y in bf16, dt in float32: 0.54 GB) 0.16 ms. A third of the
// exponentials can run instead as a degree-5 polynomial on the float32 pipe
// (13 operations each, as FlashAttention-3 splits its exponentials), which
// levels the two units at 0.17 ms: the operations bind (0.1697 ms). This
// kernel puts every exponential on the unit, so its own floor is that
// unit's 0.256 ms. It issues about 9 instructions per state and step (the
// update's 5, the exponential, and the loads, the shuffle and the store
// shared out), which alone take 0.29 ms at one warp instruction a clock per
// scheduler, so a polynomial share would add issue slots where there are
// none to spare.
//
// Arithmetic: dt x, da h, (dt x) B, da h + (dt x) B, D x and the final add
// are rounded one by one, as the plain version (ref.py) rounds them
// (__fmul_rn / __fadd_rn, which nvcc never contracts into an FMA). The
// exponential is 2^(dt a2), a2 = A log2(e) rounded once per (d, n) when A is
// loaded: one multiply and `ex2.approx.ftz` on the exponential unit. The
// accurate `expf` (about 8 instructions) would keep h bit for bit as the
// plain version's on the card; the gates do not need that. On the CPU, at
// (1, 4096, 256, 16) under Jamba's law (dt = softplus(-4.6 + 0.5 z),
// A = -(1..16)), every exponential perturbed by up to 1, 2 or 4 ulp moves y
// to 0.0063, 0.0080 and 0.0146 of the float32 gate (1e-4 absolute and
// relative) from the plain scan, and the correctly rounded 2^(dt a2) to
// 0.0023: about 70x headroom; in bf16 y the worst case is one
// rounding-boundary flip, inside the one-ulp gate. Subnormal results: dt A below about -87.3 gives exp(dt A) < 2^-126,
// which the plain version keeps as a subnormal and `.ftz` flushes to 0; da h
// then differs by less than 2^-126 |h|, far below any gate. The other
// operations keep subnormals (no -ftz flag). The one order that differs
// besides is the sum over n in y: each lane sums its 8 states with FMAs,
// then the lanes of one channel add their partial sums; the plain version's
// einsum sums in its library's order.
//
// Design: the TPU kernel walks a (B, di/bd, S/ct) grid in order and carries h
// in VMEM across the time chunks. Here blocks run in no order, so time is a
// loop inside each block, and a block owns CH = 64 channels of one batch row
// for the whole sequence: grid (di / CH, B), 256 blocks at B 1. G = N / 8
// neighbouring lanes share a channel, 8 of its states each (128 threads a
// block at N 16, 8 warps an SM at B 1). No time-parallel form: at B 1,
// di 16384 the scan already runs 32,768 lanes of 8 independent states each.
// x and dt stream into shared memory in their own types in chunks of CT =
// 32 steps with cp.async in 16-byte pieces, double-buffered, so chunk n + 1
// loads while chunk n runs; each thread's pieces and their addresses are
// worked out once, before the time loop (views whose starts or strides are
// not 16-byte multiples take synchronous loads into the same buffers). Each
// thread loads its share of the next chunk's B and C (a few elements, read
// by stride) into registers and writes them to shared memory as float32
// after the current chunk, so the lanes never convert them. The lanes of a
// channel keep their partial y of G steps, then one transposing shuffle pass
// (G - 1 shuffles) leaves lane sub with the whole of step sub, which it
// finishes and stores. A ragged S, or a di that is not a multiple of CH, is
// handled in the kernel (the TPU op pads time with dt = 0): a missing step
// or channel loads zeros and stores nothing. Strided x, dt, B and C are read
// by stride, the state dim of B and C and the channel dim of x and dt
// contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int SPL_MAX = 8;  // states per lane, at most
constexpr int CH = 64;   // channels per block
constexpr int CT = 32;   // time steps per chunk
constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  const void* x;
  const void* dt;
  const void* b;
  const void* c;
  const float* A;  // (di, N), contiguous
  const float* D;  // (di,)
  void* y;         // (B, S, di), contiguous
  int S, di;
  int aligned;     // x and dt start on 16 bytes, strides 16-byte multiples: cp.async
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

__device__ __forceinline__ float ex2(float x) {  // 2^x on the exponential unit
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Sums v[i] over the G lanes of a channel for every i, transposed: on
// return lane s of the channel holds the sum of the lanes' v[s] in v[0].
// Stage O pairs lane s with lane s ^ O: each keeps the half of v[0 .. 2 O)
// its bit O selects and adds the partner's copy of it.
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

// One thread's share of staging CH channels of a (time, channel) array
// (row stride `st` elements, 16-byte aligned rows) chunk by chunk: pieces
// tid, tid + THREADS, ... of 16 bytes of the CT x CH chunk, kept dense in
// shared memory; rows past S and channels past `cols` are zero-filled. All
// but the chunk's start is worked out once, so a piece costs a compare, an
// address and its cp.async.
template <typename T, int THREADS>
struct SlabCopy {
  static constexpr int EPP = 16 / static_cast<int>(sizeof(T));  // elements a piece
  static constexpr int PER_ROW = CH / EPP;
  static constexpr int M = CT * PER_ROW / THREADS;              // pieces a thread
  static constexpr int RSTEP = THREADS / PER_ROW;                // rows from one piece to the next
  static_assert(M * THREADS == CT * PER_ROW && THREADS % PER_ROW == 0, "whole rows a pass");
  const T* base;  // row 0 of the block's channels
  const T* src;   // this thread's first piece in the next chunk
  long long st;
  int row;        // that piece's row within a chunk
  int bytes;      // 16, fewer at the ragged channel edge, 0 past it
  int tid;

  __device__ SlabCopy(const T* g, long long stride, int cols, int t) : base(g), st(stride), tid(t) {
    const int q = t % PER_ROW;
    row = t / PER_ROW;
    src = g + row * st + q * EPP;
    bytes = min(EPP, max(0, cols - q * EPP)) * static_cast<int>(sizeof(T));
  }
  // the chunk at t0 (the one after the last issued) into `slab`
  __device__ __forceinline__ void issue(T* slab, int t0, int S) {
    const int rem = S - t0 - row;  // this thread's pieces at rows < rem are in the sequence
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const bool ok = m * RSTEP < rem && bytes > 0;
      cp_async16(slab + (tid + m * THREADS) * EPP, ok ? src + m * RSTEP * st : base, ok ? bytes : 0);
    }
    src += CT * st;
  }
};

// steps [t0, t0 + CT) of CH channels from `g` (row stride `st`; `cols`
// channels valid, rows past S and channels past `cols` read as zeros) into
// `dst` (CT x CH, dense), by every thread: the path for views whose rows
// cp.async cannot move in 16-byte pieces
template <typename T, int THREADS>
__device__ __forceinline__ void load_rows(T* dst, const T* g, long long st, int t0, int S, int cols,
                                          int tid) {
  for (int e = tid; e < CT * CH; e += THREADS) {
    const int t = e / CH, k = e % CH;
    dst[e] = t0 + t < S && k < cols ? g[(t0 + t) * st + k] : from_f<T>(0.f);
  }
}

template <int N>
struct Shape {
  static constexpr int SPL = N < SPL_MAX ? N : SPL_MAX;  // states per lane
  static constexpr int G = N / SPL;             // lanes per channel
  static constexpr int THREADS = CH * G;
  static constexpr int NB = CT * N / THREADS;   // B, C elements a thread stages per chunk
  static_assert(N % SPL == 0 && 32 % G == 0 && SPL % 4 == 0, "a channel's lanes lie in one warp");
  static_assert(NB * THREADS == CT * N && THREADS % N == 0, "chunk split");
};

template <typename TX, typename TD, int N>
struct Smem {
  static constexpr int X = CT * CH * static_cast<int>(sizeof(TX));
  static constexpr int DT = CT * CH * static_cast<int>(sizeof(TD));
  static constexpr int BC = CT * 2 * N * static_cast<int>(sizeof(float));  // B | C, float32
  static constexpr int STAGE = X + DT + BC;
  static constexpr int BYTES = 2 * STAGE;
  static_assert(X % 16 == 0 && DT % 16 == 0, "16-byte aligned parts");
};

// TX: x and y; TD: dt; TB: B and C
template <typename TX, typename TD, typename TB, int N>
__global__ void __launch_bounds__(Shape<N>::THREADS) mamba_scan_fwd_kernel(Params p) {
  using Sh = Shape<N>;
  using Sm = Smem<TX, TD, N>;
  constexpr int SPL = Sh::SPL, G = Sh::G, THREADS = Sh::THREADS, NB = Sh::NB;
  extern __shared__ __align__(16) unsigned char smem[];
  auto xs = [&](int buf) { return reinterpret_cast<TX*>(smem + buf * Sm::STAGE); };
  auto dts = [&](int buf) { return reinterpret_cast<TD*>(smem + buf * Sm::STAGE + Sm::X); };
  auto bcs = [&](int buf) {
    return reinterpret_cast<float*>(smem + buf * Sm::STAGE + Sm::X + Sm::DT);
  };

  const int tid = threadIdx.x;
  const int sub = tid % G;   // this lane's states: sub * SPL .. sub * SPL + SPL - 1
  const int ch = tid / G;    // this lane's channel in the block's tile
  const int c0 = blockIdx.x * CH;
  const int bb = blockIdx.y;
  const int S = p.S, di = p.di;
  const bool aligned = p.aligned != 0;

  const TX* xg = static_cast<const TX*>(p.x) + bb * p.sx[0] + c0;
  const TD* dtg = static_cast<const TD*>(p.dt) + bb * p.sdt[0] + c0;
  const TB* bg = static_cast<const TB*>(p.b) + bb * p.sb[0];
  const TB* cg = static_cast<const TB*>(p.c) + bb * p.sc[0];
  TX* yg = static_cast<TX*>(p.y) + static_cast<long long>(bb) * S * di + c0 + ch;

  const bool stores = c0 + ch < di;
  const int d = min(c0 + ch, di - 1);  // a lane past di computes on a clamped
  float a2[SPL], h[SPL];               // channel's A and stores nothing
#pragma unroll
  for (int m = 0; m < SPL; ++m) {
    a2[m] = __fmul_rn(p.A[static_cast<long long>(d) * N + sub * SPL + m], LOG2E);
    h[m] = 0.f;
  }
  const float dd = p.D[d];

  // this thread's share of a chunk's B and C, in flight in registers:
  // element tid + THREADS m is step bt0 + m BSTEP, state bn
  constexpr int BSTEP = THREADS / N;
  const int bt0 = tid / N, bn = tid % N;
  const TB* b_next = bg + bt0 * p.sb[1] + bn;  // the next chunk's first element
  const TB* c_next = cg + bt0 * p.sc[1] + bn;
  TB rb[NB], rc[NB];
  auto load_bc = [&](int t0) {
    const int rem = S - t0 - bt0;
#pragma unroll
    for (int m = 0; m < NB; ++m) {
      const bool ok = m * BSTEP < rem;
      rb[m] = ok ? b_next[m * BSTEP * p.sb[1]] : from_f<TB>(0.f);
      rc[m] = ok ? c_next[m * BSTEP * p.sc[1]] : from_f<TB>(0.f);
    }
    b_next += CT * p.sb[1];
    c_next += CT * p.sc[1];
  };
  auto store_bc = [&](int buf) {
    float* dst = bcs(buf) + bt0 * 2 * N + bn;
#pragma unroll
    for (int m = 0; m < NB; ++m) {
      dst[m * BSTEP * 2 * N] = to_f(rb[m]);
      dst[m * BSTEP * 2 * N + N] = to_f(rc[m]);
    }
  };
  SlabCopy<TX, THREADS> x_copy(xg, p.sx[1], di - c0, tid);
  SlabCopy<TD, THREADS> dt_copy(dtg, p.sdt[1], di - c0, tid);
  auto stage_xdt = [&](int t0, int buf) {  // chunk t0 into stage buf
    if (aligned) {
      x_copy.issue(xs(buf), t0, S);
      dt_copy.issue(dts(buf), t0, S);
      cp_async_commit();
    } else {
      load_rows<TX, THREADS>(xs(buf), xg, p.sx[1], t0, S, di - c0, tid);
      load_rows<TD, THREADS>(dts(buf), dtg, p.sdt[1], t0, S, di - c0, tid);
    }
  };

  const int n_chunks = (S + CT - 1) / CT;
  stage_xdt(0, 0);
  load_bc(0);
  store_bc(0);
  for (int n = 0; n < n_chunks; ++n) {
    const int buf = n & 1, t0 = n * CT;
    cp_async_wait_all();
    __syncthreads();  // chunk n is in; chunk n - 1's readers are done
    if (n + 1 < n_chunks) {
      stage_xdt(t0 + CT, buf ^ 1);
      load_bc(t0 + CT);  // lands while this chunk runs
    }

    const TX* x_c = xs(buf) + ch;
    const TD* d_c = dts(buf) + ch;
    const float* bc_c = bcs(buf) + sub * SPL;
    // G steps at a time: each lane's share of sum_n h C for the G steps, then
    // lane sub of a channel finishes step sub of them
#pragma unroll 8
    for (int t0g = 0; t0g < CT; t0g += G) {
      float yp[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {  // steps past S run on zeros
        const int t = t0g + g;
        const float xv = to_f(x_c[t * CH]);
        const float dtv = to_f(d_c[t * CH]);
        float bm[SPL], cm[SPL];
#pragma unroll
        for (int q = 0; q < SPL / 4; ++q) {
          const float4 bv = reinterpret_cast<const float4*>(bc_c + t * 2 * N)[q];
          const float4 cv = reinterpret_cast<const float4*>(bc_c + t * 2 * N + N)[q];
          bm[4 * q] = bv.x; bm[4 * q + 1] = bv.y; bm[4 * q + 2] = bv.z; bm[4 * q + 3] = bv.w;
          cm[4 * q] = cv.x; cm[4 * q + 1] = cv.y; cm[4 * q + 2] = cv.z; cm[4 * q + 3] = cv.w;
        }
        const float dtx = __fmul_rn(dtv, xv);
        float y = 0.f;
#pragma unroll
        for (int m = 0; m < SPL; ++m) {
          const float da = ex2(__fmul_rn(dtv, a2[m]));
          h[m] = __fadd_rn(__fmul_rn(da, h[m]), __fmul_rn(dtx, bm[m]));
          y = fmaf(h[m], cm[m], y);
        }
        yp[g] = y;
      }
      transpose_sum<G / 2>(yp, sub);
      const int t = t0g + sub;
      const TX out = from_f<TX>(__fadd_rn(yp[0], __fmul_rn(dd, to_f(x_c[t * CH]))));
      if (stores && t0 + t < S) yg[static_cast<long long>(t0 + t) * di] = out;
    }
    if (n + 1 < n_chunks) store_bc(buf ^ 1);  // its readers finished before this chunk's barrier
  }
}

template <typename TX, typename TD, typename TB, int N>
int launch(const Params& p, int B, cudaStream_t stream) {
  auto kernel = mamba_scan_fwd_kernel<TX, TD, TB, N>;
  constexpr int bytes = Smem<TX, TD, N>::BYTES;
  // on every launch: the limit is held per device, and the call is cheap and
  // allowed while a graph is being captured
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((p.di + CH - 1) / CH, B);
  kernel<<<grid, Shape<N>::THREADS, bytes, stream>>>(p);
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
// and dt and the state dim of B and C are contiguous. `aligned`: x and dt
// start on 16 bytes and their strides are 16-byte multiples (the cp.async
// path; else synchronous loads). Returns 0 or the CUDA error of the launch
// (a refused launch never runs).
extern "C" int mamba_scan_fwd(
    const void* x, const void* dt, const void* b, const void* c, const float* A,
    const float* D, void* y,
    int x_dtype, int dt_dtype, int b_dtype, int B, int S, int di, int N, int aligned,
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
  p.aligned = aligned;
  p.sx[0] = sxb; p.sx[1] = sxt;
  p.sdt[0] = sdtb; p.sdt[1] = sdtt;
  p.sb[0] = sbb; p.sb[1] = sbt;
  p.sc[0] = scb; p.sc[1] = sct;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0) return dispatch_dt<float>(p, dt_dtype, b_dtype, N, B, s);
  if (x_dtype == 1) return dispatch_dt<__nv_bfloat16>(p, dt_dtype, b_dtype, N, B, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The bf16 path of the flash-attention kernel: Hopper tensor cores (wgmma)
// fed by TMA loads into a ring of shared-memory stages. flash_attention.cu's
// header says what it computes and why it is built so.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <math.h>
#include <stdint.h>

#include "wgmma_sm90.cuh"

namespace sm90 {

constexpr int BQ = 128;          // query rows a block: two warpgroups of 64
constexpr int THREADS = 256;
constexpr int STAGES = 2;        // kv tiles in flight

template <int HD>
struct Cfg {
  static constexpr int BK = HD == 256 ? 64 : 128;     // keys a kv tile
  static constexpr int SLAB = HD < 64 ? HD : 64;      // hd columns of one swizzled slab
  static constexpr int SLABS = HD / SLAB;
  static constexpr int ROW = SLAB * 2;                // bytes a slab row: 128 (64 at hd 32)
  static constexpr int STEPS_PER_SLAB = SLAB / 16;    // 16-deep steps in one slab row
  static constexpr uint64_t LAYOUT = ROW == 128 ? 1 : 2;
  static constexpr int Q_BYTES = BQ * HD * 2;
  static constexpr int KV_BYTES = BK * HD * 2;        // one of K, V
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  static constexpr int BAR_OFFSET = Q_BYTES + STAGES * STAGE_BYTES;
  // mbarriers (Q, one a stage), release counts (one a stage); + 1024: the
  // dynamic base is aligned up to the swizzle atom
  static constexpr size_t SMEM = BAR_OFFSET + 8 * (1 + STAGES) + 4 * STAGES + 1024;
};

struct Params {
  void* o;
  int S, H, KV;
  long long so[3];  // element strides of out's (batch, seq, head)
  float scale;
  int causal;
  int window;  // <= 0: no window
  float cap;   // <= 0: no softcap
};

template <int BK>
__device__ __forceinline__ void wgmma_ss(float (&d)[BK / 2], uint64_t a, uint64_t b, int acc) {
  if constexpr (BK == 64) wgmma_ss_n64(d, a, b, acc);
  else wgmma_ss_n128(d, a, b, acc);
}
template <int HD>
__device__ __forceinline__ void wgmma_rs(float (&d)[HD / 2], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (HD == 32) wgmma_rs_n32(d, a, b);
  else if constexpr (HD == 64) wgmma_rs_n64(d, a, b);
  else if constexpr (HD == 128) wgmma_rs_n128(d, a, b);
  else wgmma_rs_n256(d, a, b);
}

constexpr float LOG2E = 1.4426950408889634f;
// 2^x on the exponential unit (about 2 ulp; 2^-inf = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// HD: the width the tiles and products are built for; HD_IN <= HD: the head
// dim of the tensors (TMA fills the columns past HD_IN with zeros, and the
// stores stop there)
template <int HD, int HD_IN>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_kernel_sm90(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv, const Params p) {
  using C = Cfg<HD>;
  constexpr int BK = C::BK;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* Qs = smem;                                   // [slab][BQ rows]
  auto Ks = [&](int st) { return smem + C::Q_BYTES + st * C::STAGE_BYTES; };  // [slab][BK rows]
  auto Vs = [&](int st) { return Ks(st) + C::KV_BYTES; };
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + C::BAR_OFFSET);
  uint64_t* full = q_full + 1;                    // a stage's K and V tiles have landed
  int* released = reinterpret_cast<int*>(full + STAGES);  // warpgroups done with a stage

  const int tid = threadIdx.x;
  const int h = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // the longest rows first
  const int b = blockIdx.z;
  const int S = p.S;
  const int kvh = h / (p.H / p.KV);

  // the band of keys this block's rows can see, in whole kv tiles
  const int q_last = min(q0 + BQ, S) - 1;
  const int k_end = p.causal ? q_last + 1 : S;
  const int k_begin = (p.window > 0 ? max(0, q0 - p.window + 1) : 0) / BK * BK;
  const int n_tiles = (k_end - k_begin + BK - 1) / BK;

  // one thread issues every TMA load: kv tile j into stage j % STAGES
  auto load_tile = [&](int j) {
    const int st = j % STAGES;
    const int k0 = k_begin + j * BK;
    mbar_expect_tx(&full[st], C::STAGE_BYTES);
    for (int s = 0; s < C::SLABS; ++s) {
      tma_load_4d(Ks(st) + s * BK * C::ROW, &tk, &full[st], s * C::SLAB, k0, kvh, b);
      tma_load_4d(Vs(st) + s * BK * C::ROW, &tv, &full[st], s * C::SLAB, k0, kvh, b);
    }
  };
  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      released[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_expect_tx(q_full, C::Q_BYTES);
    for (int s = 0; s < C::SLABS; ++s)
      tma_load_4d(Qs + s * BQ * C::ROW, &tq, q_full, s * C::SLAB, q0, h, b);
    for (int j = 0; j < STAGES && j < n_tiles; ++j) load_tile(j);
  }
  __syncthreads();

  // each warpgroup owns 64 query rows
  const int c = tid / 128;
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int qw = q0 + 64 * c;                     // this warpgroup's first row
  const int qw_last = min(qw + 63, S - 1);
  const int row[2] = {qw + 16 * warp + lane / 4, qw + 16 * warp + lane / 4 + 8};
  const int col0 = 2 * (lane % 4);                // + 8 j (+ 1) within a tile

  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  const uint32_t q_base = smem_addr(Qs) + 64 * c * C::ROW;
  mbar_wait(q_full, 0);

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % STAGES;
    const int k0 = k_begin + j * BK;
    mbar_wait(&full[st], (j / STAGES) & 1);
    // a tile wholly outside this warpgroup's band adds nothing
    const bool skip = qw >= S || (p.causal && k0 > qw_last) ||
                      (p.window > 0 && qw - (k0 + BK - 1) >= p.window);
    if (!skip) {
      // S = Q K^T over hd, float32 accumulators
      float s[BK / 2];
      const uint32_t k_base = smem_addr(Ks(st));
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < HD / 16; ++ks) {
        const int slab = ks / C::STEPS_PER_SLAB, off = (ks % C::STEPS_PER_SLAB) * 32;
        const uint64_t da = make_desc(q_base + slab * BQ * C::ROW + off, 16, 8 * C::ROW, C::LAYOUT);
        const uint64_t db = make_desc(k_base + slab * BK * C::ROW + off, 16, 8 * C::ROW, C::LAYOUT);
        wgmma_ss<BK>(s, da, db, ks > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);

      // scale, softcap and masks, as the plain version applies them
      const bool masked = k0 + BK > S || (p.causal && k0 + BK - 1 > qw) ||
                          (p.window > 0 && qw_last - k0 >= p.window);
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        float x = s[i] * p.scale;
        if (p.cap > 0.f) x = p.cap * tanhf(x / p.cap);
        if (masked) {
          const int qpos = row[(i % 4) / 2];
          const int kpos = k0 + 8 * (i / 4) + col0 + i % 2;
          bool ok = kpos < S;
          if (p.causal) ok = ok && kpos <= qpos;
          if (p.window > 0) ok = ok && qpos - kpos < p.window;
          if (!ok) x = -INFINITY;
        }
        s[i] = x;
      }

      // online softmax in float32; the 4 lanes of a row share its max
      float corr[2], m_safe[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -INFINITY;
#pragma unroll
        for (int i = 0; i < BK / 8; ++i) mx = fmaxf(mx, fmaxf(s[4 * i + 2 * r], s[4 * i + 2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[r], mx);
        m_safe[r] = m_new == -INFINITY ? 0.f : m_new;  // a row masked so far
        corr[r] = ex2((m[r] - m_safe[r]) * LOG2E);   // 0 while the row was masked
        m_safe[r] *= -LOG2E;
        m[r] = m_new;
      }
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int r = (i % 4) / 2;
        const float e = ex2(fmaf(s[i], LOG2E, m_safe[r]));  // exp(s - m); 0 if masked
        s[i] = e;
        sum[r] += e;
      }
      l[0] = l[0] * corr[0] + sum[0];
      l[1] = l[1] * corr[1] + sum[1];

      // P = P_hi + P_lo, two bf16 terms, so that P V keeps P's float32
      // precision: the accumulator layout of columns 16 kk .. 16 kk + 15
      // is the A fragment of the kk-th 16-key step
      uint32_t ph[BK / 4], pl[BK / 4];
#pragma unroll
      for (int i = 0; i < BK / 4; ++i) {
        const float x0 = s[2 * i], x1 = s[2 * i + 1];
        const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
        ph[i] = as_u32(hi);
        pl[i] = as_u32(__floats2bfloat162_rn(x0 - __low2float(hi), x1 - __high2float(hi)));
      }

      // O = O corr + P_hi V + P_lo V
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) o[i] *= corr[(i % 4) / 2];
      const uint32_t v_base = smem_addr(Vs(st));
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t dv = make_desc(v_base + kk * 16 * C::ROW, BK * C::ROW, 8 * C::ROW, C::LAYOUT);
        const uint32_t a_hi[4] = {ph[4 * kk], ph[4 * kk + 1], ph[4 * kk + 2], ph[4 * kk + 3]};
        const uint32_t a_lo[4] = {pl[4 * kk], pl[4 * kk + 1], pl[4 * kk + 2], pl[4 * kk + 3]};
        wgmma_rs<HD>(o, a_hi, dv);
        wgmma_rs<HD>(o, a_lo, dv);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o);
    }
    // the warpgroup is done with this stage; the second to be done loads
    // tile j + STAGES into it, so no thread waits for the other warpgroup
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c) : "memory");
    if (tid % 128 == 0 && atomicAdd(&released[st], 1) == 1) {
      released[st] = 0;
      if (j + STAGES < n_tiles) load_tile(j + STAGES);
    }
  }

  // out = acc / max(l, 1e-20), in bf16
  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o) + b * p.so[0] + h * p.so[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= S) continue;
    const float denom = fmaxf(l[r], 1e-20f);
    __nv_bfloat16* orow = og + row[r] * p.so[1] + col0;
#pragma unroll
    for (int jj = 0; jj < HD / 8; ++jj) {
      if (8 * jj >= HD_IN) break;  // the padded columns of a narrower head
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * jj) =
          __floats2bfloat162_rn(o[4 * jj + 2 * r] / denom, o[4 * jj + 2 * r + 1] / denom);
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up in libcuda.so.1, which the CUDA runtime
// has already loaded (so the library needs no link against libcuda).
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_LAZY | RTLD_LOCAL);
    return lib ? reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled")) : nullptr;
  }();
  return fn;
}

// A 4-D map over (hd, seq, head, batch) of a bf16 tensor read by stride
// (strides in elements; the head dim contiguous), boxes of (slab, rows).
// Rows past the end of seq, and columns past hd, read as zeros.
inline bool make_map(CUtensorMap* map, const void* base, int hd, int S, int heads, int B,
                     const long long* stride_bsh, int slab, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)S, (cuuint64_t)heads, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)stride_bsh[1] * 2, (cuuint64_t)stride_bsh[2] * 2,
                                 (cuuint64_t)stride_bsh[0] * 2};
  const cuuint32_t box[4] = {(cuuint32_t)slab, (cuuint32_t)rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                        strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        slab * 2 == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD, int HD_IN = HD>
int launch(const void* q, const void* k, const void* v, const long long* sq, const long long* sk,
           const long long* sv, const Params& p, int B, cudaStream_t stream) {
  using C = Cfg<HD>;
  if (encode_tiled() == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, HD_IN, p.S, p.H, B, sq, C::SLAB, BQ) ||
      !make_map(&tk, k, HD_IN, p.S, p.KV, B, sk, C::SLAB, C::BK) ||
      !make_map(&tv, v, HD_IN, p.S, p.KV, B, sv, C::SLAB, C::BK))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = flash_fwd_kernel_sm90<HD, HD_IN>;
  // on every launch: the limit is held per device, and the call is cheap and
  // allowed while a graph is being captured
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(C::SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(p.H, (p.S + BQ - 1) / BQ, B);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  kernel<<<grid, THREADS, C::SMEM, stream>>>(tq, tk, tv, p);
  return static_cast<int>(cudaGetLastError());
}

// hd 80 (HuBERT's) runs at width 128: TMA fills Q, K and V's columns 80-127
// with zeros, so Q K^T gains exact zeros and P V's padded columns, zero, are
// never stored.
inline int dispatch_hd(const void* q, const void* k, const void* v, const long long* sq,
                       const long long* sk, const long long* sv, const Params& p, int B, int hd,
                       cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<32>(q, k, v, sq, sk, sv, p, B, stream);
    case 64: return launch<64>(q, k, v, sq, sk, sv, p, B, stream);
    case 80: return launch<128, 80>(q, k, v, sq, sk, sv, p, B, stream);
    case 128: return launch<128>(q, k, v, sq, sk, sv, p, B, stream);
    case 256: return launch<256>(q, k, v, sq, sk, sv, p, B, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace sm90

// The float32 path of the flash-attention kernel: 3xTF32 products on the
// Hopper tensor cores (wgmma), fed by TMA loads. flash_attention.cu's header
// says what it computes and why it is built so.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_fwd_sm90.cuh"
#include "wgmma_sm90.cuh"

namespace sm90_f32 {

using sm90::fence_regs;
using sm90::make_desc;
using sm90::mbar_expect_tx;
using sm90::mbar_init;
using sm90::mbar_wait;
using sm90::smem_addr;
using sm90::tma_load_4d;
using sm90::wgmma_commit;
using sm90::wgmma_fence;
using sm90::wgmma_wait_all;

struct Params {
  void* o;
  int S, H, KV;
  long long so[3];  // element strides of out's (batch, seq, head)
  float scale;
  int causal;
  int window;  // <= 0: no window
  float cap;   // <= 0: no softcap
};

// m64nNk8 tf32 -> float32 products, A from registers. The accumulator of a
// 64 x N tile lives in N / 2 floats a thread: d[4j + e] is row 16 warp +
// lane / 4 (+ 8 for e >= 2) and column 8 j + 2 (lane % 4) + e % 2 of the
// warpgroup's tile. The A fragment of a 64 x 8 step: a[0] row 16 warp +
// lane / 4, column lane % 4; a[1] 8 rows down; a[2], a[3] the same rows 4
// columns on. tf32 operands in shared memory must be K-major (no transpose
// exists for 32-bit types). accumulate = 0 overwrites D.

// D (64 x 32, float32) (+)= A (64 x 8, tf32 in registers) B, B K-major in shared memory
__device__ __forceinline__ void wgmma_tf32_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t db,
                                               int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15},"
      " {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// D (64 x 64, float32) (+)= A (64 x 8, tf32 in registers) B, B K-major in shared memory
__device__ __forceinline__ void wgmma_tf32_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                               int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// D (64 x 80, float32) (+)= A (64 x 8, tf32 in registers) B, B K-major in shared memory
__device__ __forceinline__ void wgmma_tf32_n80(float (&d)[40], const uint32_t (&a)[4], uint64_t db,
                                               int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39},"
      " {%40, %41, %42, %43}, %44, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// D (64 x 128, float32) (+)= A (64 x 8, tf32 in registers) B, B K-major in shared memory
__device__ __forceinline__ void wgmma_tf32_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                               int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b,
                                           int accumulate) {
  static_assert(N == 32 || N == 64 || N == 80 || N == 128, "a kv tile's or a warpgroup's width");
  if constexpr (N == 32) wgmma_tf32_n32(d, a, b, accumulate);
  else if constexpr (N == 64) wgmma_tf32_n64(d, a, b, accumulate);
  else if constexpr (N == 80) wgmma_tf32_n80(d, a, b, accumulate);
  else wgmma_tf32_n128(d, a, b, accumulate);
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e])::"memory");
}

// x = hi + lo, each a tf32 (cvt.rna: 10 mantissa bits, the low 13 bits
// zero): hi + lo keeps x to about 2^-22, and the tensor core never reads a
// bit it would drop
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
}

// x, opaque to the compiler: what is computed from it inside a loop stays
// there instead of being hoisted into registers held across the loop
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  asm volatile("mov.b32 %0, %0;\n" : "+r"(x));
  return x;
}

// Byte offset of (row, col) in a tile of 128-byte-swizzled slabs of 32
// float columns, [slab][rows][32], as TMA writes it (16-byte chunk index
// XOR row % 8).
__device__ __forceinline__ int sw128(int rows, int r, int c) {
  return (c / 32) * rows * 128 + r * 128 + ((((c % 32) / 4) ^ (r % 8)) << 4) + (c % 4) * 4;
}

template <int HD>
struct Cfg {
  static constexpr int THREADS = 256;                    // two warpgroups
  // hd 256: both warpgroups on the same 64 query rows, each with half of hd
  // (its half of Q K^T, whose partial sums they swap, and its half of the
  // output columns), so that the output accumulator fits the registers
  static constexpr int NSPLIT = HD == 256 ? 2 : 1;
  static constexpr int BQ = 128 / NSPLIT;                // query rows a block
  static constexpr int OW = HD / NSPLIT;                 // output columns a warpgroup
  static constexpr int BK = HD == 256 ? 32 : 64;         // keys a kv tile
  static constexpr int HDP = (HD + 31) / 32 * 32;        // hd in whole slabs (80 -> 96)
  static constexpr int SLABS = HDP / 32;
  static constexpr int KSTEPS = HD / 8 / NSPLIT;         // 8-deep steps of Q K^T a warpgroup
  // Q's split fragments of a warpgroup's steps in registers: all of them,
  // loaded once, up to hd 80; 8 steps at a time, loaded each tile, above
  static constexpr bool QKEEP = KSTEPS <= 10;
  static constexpr int QCHUNK = QKEEP ? KSTEPS : 8;
  // P V's key steps in two groups, each summed on its own and waited for
  // before the next is split (P_hi and P_lo of half a tile in registers at
  // a time, and half a tile's chain of the tensor core's truncating adds)
  static constexpr int PVG = 2;
  static constexpr int Q_BYTES = BQ * HDP * 4;
  static constexpr int KV_BYTES = BK * HDP * 4;          // a raw K (then K_hi) or V tile, K_lo
  static constexpr int VT_BYTES = HD * BK * 4;           // V^T_hi or V^T_lo
  // shared memory, from a 1024-byte-aligned base
  static constexpr int K_RAW = Q_BYTES;
  static constexpr int K_LO = K_RAW + KV_BYTES;          // also the swap of hd 256's partial S
  static constexpr int V_RAW = K_LO + KV_BYTES;
  static constexpr int VT_HI = V_RAW + KV_BYTES;
  static constexpr int VT_LO = VT_HI + VT_BYTES;
  static constexpr int BAR = VT_LO + VT_BYTES;           // mbarriers: Q, K, V landed
  static constexpr size_t SMEM = BAR + 3 * 8 + 8 + 1024;  // + the release count, alignment
  static_assert(SMEM <= 232448, "a block's shared memory");
  static_assert(BK % 32 == 0 && HD % 8 == 0 && KSTEPS % QCHUNK == 0, "tile shapes");
  static_assert(NSPLIT == 1 || 2 * 64 * BK * 4 <= KV_BYTES, "the partial S swap fits K_lo");
};

// Byte offset of V^T's (d, logical key kl) in its 128-byte-swizzled slabs
// of 32 keys, [kl / 32][HD rows][32]
template <int HD>
__device__ __forceinline__ int vt_offset(int d, int kl) {
  return ((kl / 32) * HD + d) * 128 + ((((kl % 32) / 4) ^ (d % 8)) << 4) + (kl % 4) * 4;
}

template <int HD>
__global__ void __launch_bounds__(Cfg<HD>::THREADS, 1)
flash_fwd_kernel_f32_sm90(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv, const Params p) {
  using C = Cfg<HD>;
  constexpr int BK = C::BK, BQ = C::BQ, OW = C::OW, THREADS = C::THREADS;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + C::BAR);
  int* released = reinterpret_cast<int*>(bar + 3);  // warpgroups done with a tile's K_hi

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

  // one thread issues every TMA load, one slab of 32 hd columns a box
  auto load = [&](int j, int which) {  // raw K (which 1) or V (2) of tile j
    mbar_expect_tx(&bar[which], C::KV_BYTES);
    for (int s = 0; s < C::SLABS; ++s)
      tma_load_4d(smem + (which == 1 ? C::K_RAW : C::V_RAW) + s * BK * 128,
                  which == 1 ? &tk : &tv, &bar[which], 32 * s, k_begin + j * BK, kvh, b);
  };
  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(&bar[i], 1);
    *released = 0;
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_expect_tx(&bar[0], C::Q_BYTES);
    for (int s = 0; s < C::SLABS; ++s)
      tma_load_4d(smem + s * BQ * 128, &tq, &bar[0], 32 * s, q0, h, b);
    load(0, 1);
    load(0, 2);
  }
  __syncthreads();

  // a warpgroup owns 64 query rows (and hd's half c of them at hd 256); a
  // thread holds two rows
  const int wg = tid / 128, wt = tid % 128;
  const int c = C::NSPLIT == 2 ? wg : 0;
  const int rb = C::NSPLIT == 2 ? 0 : 64 * wg;     // the warpgroup's first row in the block
  const int warp = wt / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int qw = q0 + rb;
  const int qw_last = min(qw + 63, S - 1);
  const int rq = rb + 16 * warp + g;               // and rq + 8
  const int row[2] = {q0 + rq, q0 + rq + 8};
  const float* q_rows = reinterpret_cast<const float*>(smem) + rq * 32 + t;  // Q's row rq, slab 0
  float o[OW / 2];
#pragma unroll
  for (int i = 0; i < OW / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  // the B operands, K-major and 128-byte swizzled: K_hi, K_lo from this
  // warpgroup's first step of Q K^T; V^T_hi, V^T_lo from its output
  // columns' rows c OW ..
  const uint32_t k_hi0 = smem_addr(smem + C::K_RAW) + c * C::KSTEPS / 4 * BK * 128;
  const uint32_t k_lo0 = smem_addr(smem + C::K_LO) + c * C::KSTEPS / 4 * BK * 128;
  const uint32_t vt_hi0 = smem_addr(smem + C::VT_HI) + c * OW * 128;
  const uint32_t vt_lo0 = smem_addr(smem + C::VT_LO) + c * OW * 128;
  auto k_desc = [](uint32_t base, int i) {      // step i of 8 hd columns
    return make_desc(base + (i / 4) * BK * 128 + (i % 4) * 32, 16, 1024, 1);
  };
  auto vt_desc = [](uint32_t base, int kk) {    // step kk of 8 keys
    return make_desc(base + (kk / 4) * HD * 128 + (kk % 4) * 32, 16, 1024, 1);
  };
  mbar_wait(&bar[0], 0);
  // Q_hi and Q_lo in the A fragments of this warpgroup's steps c0 ..
  auto load_q = [&](int c0, uint32_t (&qh)[C::QCHUNK][4], uint32_t (&ql)[C::QCHUNK][4]) {
#pragma unroll
    for (int i = 0; i < C::QCHUNK; ++i) {
      // Q's (row, column 8 ks + t (+ 4)) in its swizzled slabs: rows rq and
      // rq + 8 share the swizzle (row % 8 = g)
      const int ks = c * C::KSTEPS + c0 + i;
      const float* slab = q_rows + (ks / 4) * BQ * 32;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = slab[(e % 2) * 8 * 32 + (((2 * (ks % 4) + e / 2) ^ g) << 2)];
        split_tf32(x, qh[i][e], ql[i][e]);
      }
    }
  };
  uint32_t qh_keep[C::QKEEP ? C::QCHUNK : 1][4], ql_keep[C::QKEEP ? C::QCHUNK : 1][4];
  if constexpr (C::QKEEP) load_q(0, qh_keep, ql_keep);

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = k_begin + j * BK;
    mbar_wait(&bar[1], j & 1);
    mbar_wait(&bar[2], j & 1);
    const int me = opaque(tid);  // the split's addresses, computed afresh each tile
    // K = K_hi + K_lo, in K's own swizzled layout, K_hi in place
#pragma unroll
    for (int i = me; i < C::KV_BYTES / 16; i += THREADS) {
      uint4* raw = reinterpret_cast<uint4*>(smem + C::K_RAW) + i;
      const float4 x = *reinterpret_cast<const float4*>(raw);
      uint4 hi, lo;
      split_tf32(x.x, hi.x, lo.x);
      split_tf32(x.y, hi.y, lo.y);
      split_tf32(x.z, hi.z, lo.z);
      split_tf32(x.w, hi.w, lo.w);
      *raw = hi;
      reinterpret_cast<uint4*>(smem + C::K_LO)[i] = lo;
    }
    // V^T = V^T_hi + V^T_lo: each key's row becomes a column, K-major as tf32
    // wgmma wants it. Within each 8 keys the columns are permuted (key p to
    // column 4 (p % 2) + p / 2), so that P's accumulator registers are the A
    // fragment of P V as they are. A warp writes 32 keys of one row: no bank
    // conflicts.
#pragma unroll
    for (int it = me; it < BK * HD / 4; it += THREADS) {
      const int key = it % BK, d0 = 4 * (it / BK);
      const float4 x4 = *reinterpret_cast<const float4*>(smem + C::V_RAW + sw128(BK, key, d0));
      const float x[4] = {x4.x, x4.y, x4.z, x4.w};
      const int kl = (key & ~7) | ((key & 1) << 2) | ((key & 7) >> 1);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int off = vt_offset<HD>(d0 + e, kl);
        uint32_t hi, lo;
        split_tf32(x[e], hi, lo);
        *reinterpret_cast<uint32_t*>(smem + C::VT_HI + off) = hi;
        *reinterpret_cast<uint32_t*>(smem + C::VT_LO + off) = lo;
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // for wgmma's reads
    __syncthreads();
    // raw V is free: load the next tile's under this tile's products
    if (tid == 0 && j + 1 < n_tiles) load(j + 1, 2);

    // this tile's descriptors. At hd 256 they depend on the thread's
    // warpgroup, so they are not uniform registers: computed here, they are
    // not held across tiles
    constexpr bool HIDE = C::NSPLIT == 2;
    const uint32_t k_hi = HIDE ? opaque(k_hi0) : k_hi0, k_lo = HIDE ? opaque(k_lo0) : k_lo0;
    const uint32_t vt_hi = HIDE ? opaque(vt_hi0) : vt_hi0, vt_lo = HIDE ? opaque(vt_lo0) : vt_lo0;
    // a tile wholly outside this warpgroup's band adds nothing
    const bool skip = qw >= S || (p.causal && k0 > qw_last) ||
                      (p.window > 0 && qw - (k0 + BK - 1) >= p.window);
    // S = Q_hi K_hi + (Q_hi K_lo + Q_lo K_hi) over this warpgroup's steps:
    // the small terms in an accumulator of their own, so that the tensor
    // core's truncating adds work at their scale
    float s[BK / 2];
    if (!skip) {
      float sb[BK / 2], ss[BK / 2];
#pragma unroll
      for (int c0 = 0; c0 < C::KSTEPS; c0 += C::QCHUNK) {
        uint32_t qh[C::QCHUNK][4], ql[C::QCHUNK][4];
        if constexpr (C::QKEEP) {
#pragma unroll
          for (int i = 0; i < C::QCHUNK; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              qh[i][e] = qh_keep[i][e];
              ql[i][e] = ql_keep[i][e];
            }
        } else {
          load_q(c0, qh, ql);
        }
        fence_regs(sb);
        fence_regs(ss);
        wgmma_fence();
#pragma unroll
        for (int i = 0; i < C::QCHUNK; ++i) {
          const uint64_t dh = k_desc(k_hi, c0 + i), dl = k_desc(k_lo, c0 + i);
          wgmma_tf32<BK>(ss, qh[i], dl, c0 + i > 0);
          wgmma_tf32<BK>(ss, ql[i], dh, 1);
          wgmma_tf32<BK>(sb, qh[i], dh, c0 + i > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(qh);
        fence_regs(ql);
        fence_regs(sb);
        fence_regs(ss);
      }
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) s[i] = sb[i] + ss[i];
    }
    if constexpr (C::NSPLIT == 1) {
      // K_hi is free once both warpgroups are done with Q K^T: the second
      // to be done loads the next tile's raw K into it
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
      if (wt == 0 && atomicAdd(released, 1) == 1) {
        *released = 0;
        if (j + 1 < n_tiles) load(j + 1, 1);
      }
    } else {
      // both halves of Q K^T are done: swap the partial sums through K_lo
      __syncthreads();
      if (tid == 0 && j + 1 < n_tiles) load(j + 1, 1);
      // (both warpgroups hold the same rows: each adds the other's half to
      // its own, so both hold the same sums)
      float* swap = reinterpret_cast<float*>(smem + C::K_LO);
      if (!skip) {
#pragma unroll
        for (int g = 0; g < BK / 8; ++g)
          *reinterpret_cast<float4*>(swap + c * 64 * BK + 512 * g + 4 * wt) =
              make_float4(s[4 * g], s[4 * g + 1], s[4 * g + 2], s[4 * g + 3]);
      }
      __syncthreads();
      if (!skip) {
#pragma unroll
        for (int g = 0; g < BK / 8; ++g) {
          const float4 x =
              *reinterpret_cast<const float4*>(swap + (1 - c) * 64 * BK + 512 * g + 4 * wt);
          s[4 * g] += x.x;
          s[4 * g + 1] += x.y;
          s[4 * g + 2] += x.z;
          s[4 * g + 3] += x.w;
        }
      }
    }

    if (!skip) {
      // scale, softcap and masks, as the plain version applies them
      const bool masked = k0 + BK > S || (p.causal && k0 + BK - 1 > qw) ||
                          (p.window > 0 && qw_last - k0 >= p.window);
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        float x = s[i] * p.scale;
        if (p.cap > 0.f) x = p.cap * tanhf(x / p.cap);
        if (masked) {
          const int qpos = row[(i % 4) / 2];
          const int kpos = k0 + 8 * (i / 4) + 2 * t + i % 2;
          bool ok = kpos < S;
          if (p.causal) ok = ok && kpos <= qpos;
          if (p.window > 0) ok = ok && qpos - kpos < p.window;
          if (!ok) x = -INFINITY;
        }
        s[i] = x;
      }

      // online softmax in float32 registers; the 4 lanes of a row share its max
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
        corr[r] = expf(m[r] - m_safe[r]);              // 0 while the row was masked
        m[r] = m_new;
      }
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const float e = expf(s[i] - m_safe[(i % 4) / 2]);  // 0 if masked
        s[i] = e;
        sum[(i % 4) / 2] += e;
      }
      l[0] = l[0] * corr[0] + sum[0];
      l[1] = l[1] * corr[1] + sum[1];

      // this tile's P V, each group of key steps on its own (small terms
      // first), then o = o corr + P V, a group at a time. P = P_hi + P_lo;
      // the A fragment of key step kk is the accumulator's {s[4kk],
      // s[4kk + 2], s[4kk + 1], s[4kk + 3]} (V^T's permuted columns)
      constexpr int KG = BK / 8 / C::PVG;
      float pv[OW / 2];
#pragma unroll
      for (int g0 = 0; g0 < BK / 8; g0 += KG) {
        uint32_t ph[KG][4], pl[KG][4];
#pragma unroll
        for (int i = 0; i < KG; ++i) {
          const int kk = g0 + i;
          split_tf32(s[4 * kk], ph[i][0], pl[i][0]);
          split_tf32(s[4 * kk + 2], ph[i][1], pl[i][1]);
          split_tf32(s[4 * kk + 1], ph[i][2], pl[i][2]);
          split_tf32(s[4 * kk + 3], ph[i][3], pl[i][3]);
        }
        fence_regs(pv);
        wgmma_fence();
#pragma unroll
        for (int i = 0; i < KG; ++i) {
          wgmma_tf32<OW>(pv, pl[i], vt_desc(vt_hi, g0 + i), i > 0);
          wgmma_tf32<OW>(pv, ph[i], vt_desc(vt_lo, g0 + i), 1);
        }
#pragma unroll
        for (int i = 0; i < KG; ++i) wgmma_tf32<OW>(pv, ph[i], vt_desc(vt_hi, g0 + i), 1);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(ph);
        fence_regs(pl);
        fence_regs(pv);
#pragma unroll
        for (int i = 0; i < OW / 2; ++i)
          o[i] = g0 == 0 ? fmaf(o[i], corr[(i % 4) / 2], pv[i]) : o[i] + pv[i];
      }
    }
    __syncthreads();  // every warpgroup is done with this tile's K_lo and V^T
  }

  // out = o / max(l, 1e-20)
  float* og = static_cast<float*>(p.o) + b * p.so[0] + h * p.so[2] + c * OW + 2 * t;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    if (row[r] >= S) continue;
    const float denom = fmaxf(l[r], 1e-20f);
    float* orow = og + row[r] * p.so[1];
#pragma unroll
    for (int g = 0; g < OW / 8; ++g)
      *reinterpret_cast<float2*>(orow + 8 * g) =
          make_float2(o[4 * g + 2 * r] / denom, o[4 * g + 2 * r + 1] / denom);
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// A 4-D map over (hd, seq, head, batch) of a float32 tensor read by stride
// (strides in elements; the head dim contiguous), boxes of (32 columns,
// rows) written 128-byte swizzled. Rows past the end of seq, and columns
// past hd, read as zeros.
inline bool make_map(CUtensorMap* map, const void* base, int hd, int S, int heads, int B,
                     const long long* stride_bsh, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)S, (cuuint64_t)heads, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)stride_bsh[1] * 4, (cuuint64_t)stride_bsh[2] * 4,
                                 (cuuint64_t)stride_bsh[0] * 4};
  const cuuint32_t box[4] = {32, (cuuint32_t)rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return sm90::encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(base),
                              dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const long long* sq, const long long* sk,
           const long long* sv, const Params& p, int B, cudaStream_t stream) {
  using C = Cfg<HD>;
  if (sm90::encode_tiled() == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, HD, p.S, p.H, B, sq, C::BQ) ||
      !make_map(&tk, k, HD, p.S, p.KV, B, sk, C::BK) ||
      !make_map(&tv, v, HD, p.S, p.KV, B, sv, C::BK))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = flash_fwd_kernel_f32_sm90<HD>;
  // on every launch: the limit is held per device, and the call is cheap and
  // allowed while a graph is being captured
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(C::SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(p.H, (p.S + C::BQ - 1) / C::BQ, B);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  kernel<<<grid, C::THREADS, C::SMEM, stream>>>(tq, tk, tv, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sm90_f32

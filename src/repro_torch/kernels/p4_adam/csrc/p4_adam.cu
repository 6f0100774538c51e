// Alg. A2's Adam loops (core/pgd.py: solve_p4_pgd and power_given_x) as one
// launch a call: each row's logits, Adam moments and channel stay on the SM
// for every step of the loop.
//
// Replaces no TPU kernel. The reference runs these loops as an XLA-fused
// `lax.scan` (src/repro/core/pgd.py: solve_p4_pgd, power_given_x); the port
// ran them as eager autograd, about 190 kernels a step, each reading and
// writing a (rows, N+1, K) float32 tensor from device memory: at the
// allocation benchmark's 64,512 rows (N 10, K 50) about 30 GB a step for
// state of 16 KB a row.
//
// One launch runs, for every row and each step i < steps, with t = i + 1:
//   * the decode (core/pgd.py:_decode) at the temperature T_i: X = softmax
//     over the N+1 logits z / T_i (padded devices out), times the subcarrier
//     mask; P_raw = p_max X^q sigmoid(w); P = P_raw min(1, B_n / max(sum_k
//     P_raw, 1e-12)) with B_n = p_max sigmoid(w_tot). In power mode X is
//     given (binary) and P_raw = p_max X sigmoid(w), with no z;
//   * r_n = sum_k X Bbar log2(1 + P g / (N0 Bbar)) (eq. 2);
//   * the loss kappa1 sum_n (sum_k P) payload / max(r, 1e-12) + penalty_rate
//     sum_n (max(rmin - r, 0) / max(rmin, 1))^2 + penalty_binary sum X (1 - X)
//     (the last term not in power mode);
//   * its gradient, written out by hand: max and min split a tie 0.5/0.5 as
//     JAX's do, and padded devices and subcarriers get exactly zero;
//   * Adam (b1 0.9, b2 0.999, eps 1e-8) on z, w and w_tot.
// Then it writes the decode at temp_end (P, and X in PGD mode), the final
// logits and, when asked, the moments. T_i and the bias corrections 1 - b^t
// come from a (steps, 3) table the wrapper computes as the plain loop does,
// in float32 on the card. Everything is float32.
//
// Bound on an H100: instruction issue and the special-function unit, not
// bytes. A step is about 150 float32 instructions an entry (n, k), with
// five or six exponentials, a log1p and three or four reciprocals or square
// roots, over N K + N + K entries a row. A solve of the benchmark
// (4,800 steps on 64,512 rows, 800 on 21,504, 600 in power mode on 64,512)
// is about 1.1e12 warp instructions, about 1.2 s of the card's issue; device
// memory moves each row's inputs in once and its outputs out once, about 1 GB
// a call.
//
// Layout of a row of at most 16 devices: one lane a subcarrier, so a
// column's N+1 logits, its softmax and the N entries of w sit in the lane's
// registers (unrolled over NM >= N devices, NM 4 or 16); a row is W =
// max(next_pow2(K), NM) lanes: a slice of a warp (several rows a warp) up
// to W = 32, W / 32 whole warps above. The Adam moments and the gains live
// in shared memory, one slot a lane, read and written once a step. The
// three sums over subcarriers a step needs (sum_k P_raw, r_n, and the
// budget's backward sum_k gP P_raw) are transposing butterflies over the
// warp (NM - 1 + log2(32 / NM) shuffles for NM sums), after which each lane
// holds one device's total; rows of two or more warps add the warps'
// partials through shared memory. That lane then does its device's scalar
// work (the budget, the frac and hinge gradients, w_tot's Adam) and the
// results reach the row's lanes by shuffles. Rows are independent, so
// blocks never meet; a block holds 128 threads, or one row of W > 128.
//
// A row of 17 to 64 devices (the serving ladder's (32, 128) and (64, 256)
// buckets) does not fit one SM's registers: its logits and moments alone
// are up to 130 K floats. Such a row takes the wide kernel: one block of
// kWideThreads threads a row, its state in the output and moment buffers in device
// memory (a serving batch's few hundred rows stay in L2), and three passes a
// step. Pass 1, a thread a subcarrier: the softmax over devices, sigmoid(w)
// and P_raw, into a per-row scratch. Pass 2, a warp a device: its three sums
// over subcarriers (each lane's partial, then a warp butterfly), the
// device's scalar work, w's and w_tot's Adam, and d loss / d x. Pass 3 (PGD),
// a thread a subcarrier: the softmax's backward and z's Adam. The
// arithmetic is the register kernel's, term for term.
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kMinThreads = 128;
constexpr int kMaxThreads = 256;
// rows of at most kLaneMaxN devices hold them in a lane's registers; wider
// rows, up to kWideMaxN devices and kWideMaxK subcarriers, take the wide
// kernel's blocks of kWideThreads
constexpr int kLaneMaxN = 16;
constexpr int kWideMaxN = 64;
constexpr int kWideMaxK = 256;
constexpr int kWideThreads = 256;
constexpr int kKPerLane = kWideMaxK / 32;
constexpr float kEps = 1e-12f;
constexpr float kB1 = 0.9f;
constexpr float kB2 = 0.999f;
// 1 - b1 and 1 - b2 rounded to float32 as the plain version rounds the
// python doubles
constexpr float kC1 = static_cast<float>(1.0 - 0.9);
constexpr float kC2 = static_cast<float>(1.0 - 0.999);
constexpr float kAdamEps = 1e-8f;

struct Args {
  const float* __restrict__ g;         // (R, N, K)
  const float* __restrict__ p_max;     // (R, N)
  const float* __restrict__ dev_mask;  // (R, N)
  const float* __restrict__ sc_mask;   // (R, K)
  const float* __restrict__ payload;   // (R, N)
  const float* __restrict__ rmin;      // (R, N)
  const float* __restrict__ kappa1;    // (R,)
  const float* __restrict__ x_fixed;   // (R, N, K), power mode
  const float* __restrict__ sched;     // (steps, 3): T_i, 1 - b1^t, 1 - b2^t
  const float* __restrict__ z_in;      // (R, N+1, K), PGD mode
  const float* __restrict__ w_in;      // (R, N, K)
  const float* __restrict__ wt_in;     // (R, N)
  float* z_out;
  float* w_out;
  float* wt_out;
  float* mz;  // the moments, each shaped as its logits; null: not written
  float* vz;
  float* mw;
  float* vw;
  float* mt;
  float* vt;
  float* P;  // (R, N, K)
  float* X;  // (R, N, K), PGD mode
  float* work;  // the wide kernel's scratch: (R, (N+1) K + 3 N K)
  int R, N, K, W, steps, q, pgd;  // pgd: 1 PGD mode, 0 power mode
  float lr, penalty_rate, penalty_binary, temp_end, bbar, inv_noise, inv_ln2;
};

// the derivative of max(x, c) and of min(x, c) in x: a tie splits 0.5/0.5
__device__ __forceinline__ float d_max(float x, float c) {
  return x > c ? 1.0f : (x == c ? 0.5f : 0.0f);
}
__device__ __forceinline__ float d_min(float x, float c) {
  return x < c ? 1.0f : (x == c ? 0.5f : 0.0f);
}

__device__ __forceinline__ float sigmoid(float x) { return __frcp_rn(1.0f + expf(-x)); }

// one Adam step of x; r1 = 1 / (1 - b1^t), r2 = 1 / (1 - b2^t)
__device__ __forceinline__ void adam(float& x, float& m, float& v, float g, float r1, float r2,
                                     float lr) {
  m = kB1 * m + kC1 * g;
  v = kB2 * v + kC2 * (g * g);
  x += (-lr * (m * r1)) / (sqrtf(v * r2) + kAdamEps);
}

// An entry's X and the X^q its power takes, with q X^(q-1): PGD's decoded
// x times the subcarrier mask, X^q as products from the left (torch's pow
// for q 2 and 3); power mode's given X, taken as it is (q is not applied)
template <bool PGD>
__device__ __forceinline__ float entry_x(float x, float xf, float scm, int q, float& xq,
                                         float& dxq) {
  if (!PGD) {
    xq = xf;
    dxq = 1.0f;
    return xf;
  }
  const float X = x * scm;
  float p = 1.0f;
  for (int j = 1; j < q; ++j) p *= X;
  xq = p * X;
  dxq = static_cast<float>(q) * p;
  return X;
}

// entry_x for a mode known only at run time (the wide kernel)
__device__ __forceinline__ float entry_x_of(bool pgd, float x, float xf, float scm, int q,
                                            float& xq, float& dxq) {
  return pgd ? entry_x<true>(x, xf, scm, q, xq, dxq) : entry_x<false>(x, xf, scm, q, xq, dxq);
}

// Sums v[0..NM) over the L lanes of the caller's slice of the warp (L a
// power of two, NM <= L): each butterfly step hands half of the remaining
// values to the partner lane, so the caller ends with one device's total,
// that of d = lane / (L / NM). v is overwritten.
template <int NM>
__device__ __forceinline__ float transpose_sum(float (&v)[NM], int L, int lane) {
  int off = L >> 1;
#pragma unroll
  for (int half = NM / 2; half >= 1; half /= 2) {
    const bool upper = (lane & off) != 0;
#pragma unroll
    for (int j = 0; j < half; ++j) {
      const float send = upper ? v[j] : v[j + half];
      const float keep = upper ? v[j + half] : v[j];
      v[j] = keep + __shfl_xor_sync(0xffffffffu, send, off);
    }
    off >>= 1;
  }
  float s = v[0];
  for (; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}

// The row's total of v[d] for the caller's device d: the warp's butterfly,
// then, for a row of several warps, their partials in shared memory, added
// in the same order by every warp of the row.
template <int NM>
__device__ __forceinline__ float row_sum(float (&v)[NM], int W, int L, int lane, int d_own,
                                         int spread, float* part) {
  float s = transpose_sum<NM>(v, L, lane);
  if (W > 32) {  // the same for every thread of the block
    const int warp = threadIdx.x >> 5;
    const int first = (threadIdx.x / W) * (W >> 5);
    if (lane % spread == 0) part[warp * NM + d_own] = s;
    __syncthreads();
    s = 0.0f;
    for (int j = 0; j < (W >> 5); ++j) s += part[(first + j) * NM + d_own];
  }
  return s;
}

template <int NM, bool PGD>
__global__ void __launch_bounds__(kMaxThreads) p4_adam_kernel(const Args a) {
  extern __shared__ float smem[];
  const int N = a.N, K = a.K, W = a.W;
  const int L = W < 32 ? W : 32;   // a row's lanes in one warp
  const int spread = L / NM;       // lanes that hold one device's total
  const int nt = blockDim.x, tid = threadIdx.x;
  const int k = tid % W;           // the lane's subcarrier
  const long long row = static_cast<long long>(blockIdx.x) * (nt / W) + tid / W;
  const bool live_row = row < a.R;
  // a block's spare rows run the last row's numbers and write nothing
  const long long rc = live_row ? row : a.R - 1;
  const bool col = k < K;          // the lane holds a subcarrier
  const bool live = live_row && col;
  const int lane = tid % L;
  const int d_own = lane / spread;  // the device whose total the lane holds
  const bool own_dev = d_own < N;

  // shared memory: the lane's moments and gains, one slot a lane; partials
  const int n_slots = PGD ? 4 * N + 2 : 2 * N;
  float* mom = smem;
  float* gain = smem + static_cast<size_t>(n_slots) * nt;
  float* part = gain + static_cast<size_t>(N) * nt;
  float* part_s = part;
  float* part_r = part + (nt >> 5) * NM;
  float* part_c = part + 2 * (nt >> 5) * NM;
#define MOM(slot) mom[(slot) * nt + tid]
#define GAIN(n) gain[(n) * nt + tid]

  const float* pm_row = a.p_max + rc * N;
  const float kap = a.kappa1[rc];
  // the lane's device: its constants and w_tot's Adam state
  float pm_o = 1.0f, pay_o = 0.0f, rmin_o = 0.0f, wt = 0.0f, mt = 0.0f, vt = 0.0f;
  if (own_dev) {
    pm_o = pm_row[d_own];
    pay_o = a.payload[rc * N + d_own];
    rmin_o = a.rmin[rc * N + d_own];
    wt = a.wt_in[rc * N + d_own];
  }
  unsigned on = 0u;  // bit n: device n is real
  float z[NM], w[NM], xf[NM];
  float zu = 0.0f;
  const float scm = col ? a.sc_mask[rc * K + k] : 0.0f;
#pragma unroll
  for (int n = 0; n < NM; ++n) {
    z[n] = w[n] = xf[n] = 0.0f;
    if (n < N) {
      if (a.dev_mask[rc * N + n] > 0.0f) on |= 1u << n;
      const size_t e = (static_cast<size_t>(rc) * N + n) * K + k;
      if (col) {
        w[n] = a.w_in[e];
        GAIN(n) = a.g[e];
        if (PGD) z[n] = a.z_in[(static_cast<size_t>(rc) * (N + 1) + n) * K + k];
        else xf[n] = a.x_fixed[e];
      } else {
        GAIN(n) = 0.0f;
      }
    }
  }
  if (PGD && col) zu = a.z_in[(static_cast<size_t>(rc) * (N + 1) + N) * K + k];
  for (int s = 0; s < n_slots; ++s) MOM(s) = 0.0f;

  float x[NM] = {}, s[NM], v[NM], rsc[NM], ds[NM], gP[NM];  // x: PGD's softmax
  float xu = 0.0f, invT = 1.0f;
  for (int i = 0;; ++i) {
    const bool last = i == a.steps;  // the decode at temp_end
    float r1 = 1.0f, r2 = 1.0f;
    if (!last) {
      invT = __frcp_rn(__ldg(a.sched + 3 * i));
      r1 = __frcp_rn(__ldg(a.sched + 3 * i + 1));
      r2 = __frcp_rn(__ldg(a.sched + 3 * i + 2));
    } else {
      invT = __frcp_rn(a.temp_end);
    }

    // ---- the decode: X, sigmoid(w), P_raw; sum_k P_raw ----
    if (PGD) {
      float mx = zu * invT;
#pragma unroll
      for (int n = 0; n < NM; ++n)
        if (n < N && (on >> n & 1u)) mx = fmaxf(mx, z[n] * invT);
      float sum = 0.0f;
#pragma unroll
      for (int n = 0; n < NM; ++n) {
        x[n] = 0.0f;
        if (n < N && (on >> n & 1u)) x[n] = expf(z[n] * invT - mx);
        sum += x[n];
      }
      xu = expf(zu * invT - mx);
      const float inv = __frcp_rn(sum + xu);
#pragma unroll
      for (int n = 0; n < NM; ++n) x[n] *= inv;
      xu *= inv;
    }
#pragma unroll
    for (int n = 0; n < NM; ++n) {
      v[n] = 0.0f;
      s[n] = 0.0f;
      if (n < N) {
        s[n] = sigmoid(w[n]);
        float xq, dxq;
        entry_x<PGD>(x[n], xf[n], scm, a.q, xq, dxq);
        v[n] = (__ldg(pm_row + n) * xq) * s[n];
      }
    }
    const float S = row_sum<NM>(v, W, L, lane, d_own, spread, part_s);
    // the lane's device: P = P_raw min(1, B_n / max(S, eps))
    const float st = sigmoid(wt);
    const float budget = pm_o * st;
    const float tot = fmaxf(S, kEps);
    const float ratio = budget / tot;
    const float c_o = fminf(ratio, 1.0f);

    if (last) {
#pragma unroll
      for (int n = 0; n < NM; ++n) {
        if (n < N) {
          const float c_n = __shfl_sync(0xffffffffu, c_o, n * spread, L);
          float xq, dxq;
          const float X = entry_x<PGD>(x[n], xf[n], scm, a.q, xq, dxq);
          const float P_raw = (__ldg(pm_row + n) * xq) * s[n];
          if (live) {
            const size_t e = (static_cast<size_t>(row) * N + n) * K + k;
            a.P[e] = P_raw * c_n;
            if (PGD) a.X[e] = X;
          }
        }
      }
      break;
    }

    // ---- the rates: r_n = sum_k X r_{n,k} ----
#pragma unroll
    for (int n = 0; n < NM; ++n) {
      v[n] = rsc[n] = ds[n] = 0.0f;
      if (n < N) {
        const float c_n = __shfl_sync(0xffffffffu, c_o, n * spread, L);
        float xq, dxq;
        const float X = entry_x<PGD>(x[n], xf[n], scm, a.q, xq, dxq);
        const float P = ((__ldg(pm_row + n) * xq) * s[n]) * c_n;
        const float snr = (P * GAIN(n)) * a.inv_noise;
        rsc[n] = (a.bbar * log1pf(snr)) * a.inv_ln2;
        ds[n] = __frcp_rn(1.0f + snr);
        v[n] = X * rsc[n];
      }
    }
    const float r = row_sum<NM>(v, W, L, lane, d_own, spread, part_r);
    // the lane's device: d loss / d r and d loss / d sum_k P
    const float Psum = c_o * S;
    const float rcl = fmaxf(r, kEps);
    const float gPs_o = (kap / rcl) * pay_o;
    float gr_o = -(kap * (Psum * pay_o)) / (rcl * rcl) * d_max(r, kEps);
    const float dm = rmin_o - r;
    const float rmc = fmaxf(rmin_o, 1.0f);
    const float h = fmaxf(dm, 0.0f) / rmc;
    gr_o -= ((a.penalty_rate * 2.0f) * h) / rmc * d_max(dm, 0.0f);

    // ---- backward to P; the budget's sum_k gP P_raw ----
#pragma unroll
    for (int n = 0; n < NM; ++n) {
      v[n] = gP[n] = 0.0f;
      if (n < N) {
        const float gr_n = __shfl_sync(0xffffffffu, gr_o, n * spread, L);
        const float gPs_n = __shfl_sync(0xffffffffu, gPs_o, n * spread, L);
        float xq, dxq;
        const float X = entry_x<PGD>(x[n], xf[n], scm, a.q, xq, dxq);
        const float grsc = gr_n * X;
        rsc[n] *= gr_n;  // from here on d loss / d X through r
        const float gsnr = ((grsc * a.inv_ln2) * a.bbar) * ds[n];
        gP[n] = (gsnr * a.inv_noise) * GAIN(n) + gPs_n;
        v[n] = gP[n] * ((__ldg(pm_row + n) * xq) * s[n]);
      }
    }
    const float gc = row_sum<NM>(v, W, L, lane, d_own, spread, part_c);
    // the lane's device: back through min(1, B / max(S, eps)); w_tot's Adam
    const float gratio = gc * d_min(ratio, 1.0f);
    const float gS_o = (-(gratio * budget) / (tot * tot)) * d_max(S, kEps);
    const float gwt = ((gratio / tot) * pm_o) * (st * (1.0f - st));
    adam(wt, mt, vt, gwt, r1, r2, a.lr);

    // ---- backward to w and X; w's Adam; the softmax's backward; z's Adam ----
    float dot = 0.0f;
#pragma unroll
    for (int n = 0; n < NM; ++n) {
      if (n < N) {
        const float c_n = __shfl_sync(0xffffffffu, c_o, n * spread, L);
        const float gS_n = __shfl_sync(0xffffffffu, gS_o, n * spread, L);
        const float pmn = __ldg(pm_row + n);
        float xq, dxq;
        const float X = entry_x<PGD>(x[n], xf[n], scm, a.q, xq, dxq);
        const float gPr = gP[n] * c_n + gS_n;
        const float gw = (gPr * (pmn * xq)) * (s[n] * (1.0f - s[n]));
        adam(w[n], MOM((PGD ? 2 * N + 2 : 0) + n), MOM((PGD ? 3 * N + 2 : N) + n), gw, r1, r2,
             a.lr);
        if (PGD) {
          const float gX = rsc[n] + ((gPr * s[n]) * pmn) * dxq +
                           a.penalty_binary * (1.0f - 2.0f * X);
          gP[n] = gX * scm;  // d loss / d x, the softmax's output
          dot += x[n] * gP[n];
        }
      }
    }
    if (PGD) {
#pragma unroll
      for (int n = 0; n < NM; ++n) {
        if (n < N) {
          const float gz = (on >> n & 1u) ? (x[n] * (gP[n] - dot)) * invT : 0.0f;
          adam(z[n], MOM(n), MOM(N + 1 + n), gz, r1, r2, a.lr);
        }
      }
      adam(zu, MOM(N), MOM(2 * N + 1), (xu * (0.0f - dot)) * invT, r1, r2, a.lr);
    }
  }

  // ---- the final logits and, when asked, the moments ----
  if (live) {
#pragma unroll
    for (int n = 0; n < NM; ++n) {
      if (n < N) {
        const size_t e = (static_cast<size_t>(row) * N + n) * K + k;
        a.w_out[e] = w[n];
        if (a.mw) {
          a.mw[e] = MOM((PGD ? 2 * N + 2 : 0) + n);
          a.vw[e] = MOM((PGD ? 3 * N + 2 : N) + n);
        }
        if (PGD) {
          const size_t ez = (static_cast<size_t>(row) * (N + 1) + n) * K + k;
          a.z_out[ez] = z[n];
          if (a.mz) {
            a.mz[ez] = MOM(n);
            a.vz[ez] = MOM(N + 1 + n);
          }
        }
      }
    }
    if (PGD) {
      const size_t ez = (static_cast<size_t>(row) * (N + 1) + N) * K + k;
      a.z_out[ez] = zu;
      if (a.mz) {
        a.mz[ez] = MOM(N);
        a.vz[ez] = MOM(2 * N + 1);
      }
    }
  }
  // one lane of the row's first warp writes each device's w_tot
  if (live_row && own_dev && lane % spread == 0 && k < 32) {
    a.wt_out[row * N + d_own] = wt;
    if (a.mt) {
      a.mt[row * N + d_own] = mt;
      a.vt[row * N + d_own] = vt;
    }
  }
#undef MOM
#undef GAIN
}

// The sum of s over the warp's 32 lanes, in every lane.
__device__ __forceinline__ float warp_total(float s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}

// A row of more than kLaneMaxN devices a block (see the header): the state
// in device memory, three passes a step. One instantiation takes both
// modes (`a.pgd`, the same for every thread). A register cap rather than
// launch bounds: under `__launch_bounds__` ptxas (CUDA 12.8, H100) held
// this kernel at 128 registers and spilled 12 bytes at blocks of 256, 128
// and 64 threads alike; capped at 255 it takes 141 and spills none.
__global__ void __maxnreg__(255) p4_adam_wide_kernel(const Args a) {
  extern __shared__ float smem[];
  const bool pgd = a.pgd != 0;
  const int N = a.N, K = a.K, tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, nw = nt >> 5;
  const long long row = blockIdx.x;
  const size_t NK = static_cast<size_t>(N) * K, ZK = NK + K;
  // shared memory: w_tot and its moments, the row's p_max and device mask
  float* wt_s = smem;
  float* mt_s = smem + N;
  float* vt_s = smem + 2 * N;
  float* pm_s = smem + 3 * N;
  float* on_s = smem + 4 * N;
  // the state: the logits in the outputs, their moments in the moment buffers
  float* z = pgd ? a.z_out + row * ZK : nullptr;
  float* mz = pgd ? a.mz + row * ZK : nullptr;
  float* vz = pgd ? a.vz + row * ZK : nullptr;
  float* w = a.w_out + row * NK;
  float* mw = a.mw + row * NK;
  float* vw = a.vw + row * NK;
  // a step's scratch: the softmax x (N+1, K); P_raw, sigmoid(w), d loss / d x (N, K)
  float* xs = a.work + row * (ZK + 3 * NK);
  float* pr = xs + ZK;
  float* sg = pr + NK;
  float* gx = sg + NK;
  const float* g = a.g + row * NK;
  const float* xf = pgd ? nullptr : a.x_fixed + row * NK;
  const float* scm_row = a.sc_mask + row * K;
  const float kap = a.kappa1[row];

  for (size_t e = tid; e < NK; e += nt) {
    w[e] = a.w_in[row * NK + e];
    mw[e] = vw[e] = 0.0f;
  }
  if (pgd) {
    for (size_t e = tid; e < ZK; e += nt) {
      z[e] = a.z_in[row * ZK + e];
      mz[e] = vz[e] = 0.0f;
    }
  }
  for (int n = tid; n < N; n += nt) {
    wt_s[n] = a.wt_in[row * N + n];
    mt_s[n] = vt_s[n] = 0.0f;
    pm_s[n] = a.p_max[row * N + n];
    on_s[n] = a.dev_mask[row * N + n] > 0.0f ? 1.0f : 0.0f;
  }
  __syncthreads();

  for (int i = 0;; ++i) {
    const bool last = i == a.steps;  // the decode at temp_end
    float r1 = 1.0f, r2 = 1.0f, invT;
    if (!last) {
      invT = __frcp_rn(__ldg(a.sched + 3 * i));
      r1 = __frcp_rn(__ldg(a.sched + 3 * i + 1));
      r2 = __frcp_rn(__ldg(a.sched + 3 * i + 2));
    } else {
      invT = __frcp_rn(a.temp_end);
    }

    // ---- pass 1, a thread a subcarrier: the softmax, sigmoid(w), P_raw ----
    for (int k = tid; k < K; k += nt) {
      const float scm = scm_row[k];
      if (pgd) {
        float mx = z[NK + k] * invT;
        for (int n = 0; n < N; ++n)
          if (on_s[n] > 0.0f) mx = fmaxf(mx, z[n * K + k] * invT);
        float sum = 0.0f;
        for (int n = 0; n < N; ++n) {
          const float e = on_s[n] > 0.0f ? expf(z[n * K + k] * invT - mx) : 0.0f;
          xs[n * K + k] = e;
          sum += e;
        }
        const float xu = expf(z[NK + k] * invT - mx);
        const float inv = __frcp_rn(sum + xu);
        for (int n = 0; n < N; ++n) xs[n * K + k] *= inv;
        xs[NK + k] = xu * inv;
      }
      for (int n = 0; n < N; ++n) {
        const size_t e = static_cast<size_t>(n) * K + k;
        const float s = sigmoid(w[e]);
        float xq, dxq;
        entry_x_of(pgd, pgd ? xs[e] : 0.0f, pgd ? 0.0f : xf[e], scm, a.q, xq, dxq);
        sg[e] = s;
        pr[e] = (pm_s[n] * xq) * s;
      }
    }
    __syncthreads();

    // ---- pass 2, a warp a device: its sums, its scalar work, w's Adam ----
    for (int n = tid >> 5; n < N; n += nw) {
      const float pmn = pm_s[n];
      float prv[kKPerLane], rsc[kKPerLane], ds[kKPerLane], gP[kKPerLane];
      float S = 0.0f;
#pragma unroll
      for (int j = 0; j < kKPerLane; ++j) {
        const int k = lane + 32 * j;
        prv[j] = k < K ? pr[n * K + k] : 0.0f;
        S += prv[j];
      }
      S = warp_total(S);
      const float wt = wt_s[n];
      const float st = sigmoid(wt);
      const float budget = pmn * st;
      const float tot = fmaxf(S, kEps);
      const float ratio = budget / tot;
      const float c = fminf(ratio, 1.0f);
      if (last) {
#pragma unroll
        for (int j = 0; j < kKPerLane; ++j) {
          const int k = lane + 32 * j;
          if (k < K) {
            const size_t e = static_cast<size_t>(n) * K + k;
            a.P[row * NK + e] = prv[j] * c;
            if (pgd) a.X[row * NK + e] = xs[e] * scm_row[k];
          }
        }
        continue;
      }

      // the rates: r_n = sum_k X r_{n,k}
      float r = 0.0f;
#pragma unroll
      for (int j = 0; j < kKPerLane; ++j) {
        const int k = lane + 32 * j;
        rsc[j] = ds[j] = 0.0f;
        if (k < K) {
          const size_t e = static_cast<size_t>(n) * K + k;
          const float X = pgd ? xs[e] * scm_row[k] : xf[e];
          const float snr = ((prv[j] * c) * g[e]) * a.inv_noise;
          rsc[j] = (a.bbar * log1pf(snr)) * a.inv_ln2;
          ds[j] = __frcp_rn(1.0f + snr);
          r += X * rsc[j];
        }
      }
      r = warp_total(r);
      // d loss / d r and d loss / d sum_k P
      const float pay = a.payload[row * N + n], rmn = a.rmin[row * N + n];
      const float Psum = c * S;
      const float rcl = fmaxf(r, kEps);
      const float gPs = (kap / rcl) * pay;
      float gr = -(kap * (Psum * pay)) / (rcl * rcl) * d_max(r, kEps);
      const float dm = rmn - r;
      const float rmc = fmaxf(rmn, 1.0f);
      const float h = fmaxf(dm, 0.0f) / rmc;
      gr -= ((a.penalty_rate * 2.0f) * h) / rmc * d_max(dm, 0.0f);

      // backward to P; the budget's sum_k gP P_raw
      float gc = 0.0f;
#pragma unroll
      for (int j = 0; j < kKPerLane; ++j) {
        const int k = lane + 32 * j;
        gP[j] = 0.0f;
        if (k < K) {
          const size_t e = static_cast<size_t>(n) * K + k;
          const float X = pgd ? xs[e] * scm_row[k] : xf[e];
          rsc[j] *= gr;  // from here on d loss / d X through r
          const float gsnr = (((gr * X) * a.inv_ln2) * a.bbar) * ds[j];
          gP[j] = (gsnr * a.inv_noise) * g[e] + gPs;
          gc += gP[j] * prv[j];
        }
      }
      gc = warp_total(gc);
      // back through min(1, B / max(S, eps)); w_tot's Adam
      const float gratio = gc * d_min(ratio, 1.0f);
      const float gS = (-(gratio * budget) / (tot * tot)) * d_max(S, kEps);
      if (lane == 0) {
        const float gwt = ((gratio / tot) * pmn) * (st * (1.0f - st));
        float wt_new = wt, mt = mt_s[n], vt = vt_s[n];
        adam(wt_new, mt, vt, gwt, r1, r2, a.lr);
        wt_s[n] = wt_new;
        mt_s[n] = mt;
        vt_s[n] = vt;
      }

      // backward to w and X; w's Adam
#pragma unroll
      for (int j = 0; j < kKPerLane; ++j) {
        const int k = lane + 32 * j;
        if (k < K) {
          const size_t e = static_cast<size_t>(n) * K + k;
          const float scm = scm_row[k];
          const float s = sg[e];
          float xq, dxq;
          const float X =
              entry_x_of(pgd, pgd ? xs[e] : 0.0f, pgd ? 0.0f : xf[e], scm, a.q, xq, dxq);
          const float gPr = gP[j] * c + gS;
          const float gw = (gPr * (pmn * xq)) * (s * (1.0f - s));
          adam(w[e], mw[e], vw[e], gw, r1, r2, a.lr);
          if (pgd) {
            const float gX = rsc[j] + ((gPr * s) * pmn) * dxq +
                             a.penalty_binary * (1.0f - 2.0f * X);
            gx[e] = gX * scm;  // d loss / d x, the softmax's output
          }
        }
      }
    }
    if (last) break;
    __syncthreads();

    // ---- pass 3 (PGD mode), a thread a subcarrier: the softmax's backward, z's Adam ----
    if (pgd) {
      for (int k = tid; k < K; k += nt) {
        float dot = 0.0f;
        for (int n = 0; n < N; ++n) dot += xs[n * K + k] * gx[n * K + k];
        for (int n = 0; n < N; ++n) {
          const size_t e = static_cast<size_t>(n) * K + k;
          const float gz = on_s[n] > 0.0f ? (xs[e] * (gx[e] - dot)) * invT : 0.0f;
          adam(z[e], mz[e], vz[e], gz, r1, r2, a.lr);
        }
        adam(z[NK + k], mz[NK + k], vz[NK + k], (xs[NK + k] * (0.0f - dot)) * invT, r1, r2,
             a.lr);
      }
    }
    // pass 3 reads and writes only its own subcarriers, which pass 1 reads next
  }
  __syncthreads();
  for (int n = tid; n < N; n += nt) {
    a.wt_out[row * N + n] = wt_s[n];
    if (a.mt) {
      a.mt[row * N + n] = mt_s[n];
      a.vt[row * N + n] = vt_s[n];
    }
  }
}

// One launch of `kernel` with `bytes` of dynamic shared memory.
int launch(void (*kernel)(const Args), long long blocks, int threads, size_t bytes,
           const Args& a, cudaStream_t stream) {
  // on every launch: the limit is held per device, and the call is cheap
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(blocks), threads, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int NM, bool PGD>
int launch_lanes(const Args& a, cudaStream_t stream) {
  const int threads = a.W > kMinThreads ? a.W : kMinThreads;
  const int rows = threads / a.W;
  const int n_slots = PGD ? 4 * a.N + 2 : 2 * a.N;
  const size_t bytes = sizeof(float) * (static_cast<size_t>(n_slots + a.N) * threads +
                                        3 * (threads / 32) * NM);
  const long long blocks = (static_cast<long long>(a.R) + rows - 1) / rows;
  return launch(p4_adam_kernel<NM, PGD>, blocks, threads, bytes, a, stream);
}

template <bool PGD>
int dispatch(Args a, cudaStream_t stream) {
  if (a.N < 1 || a.K < 1 || a.q < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (a.N > kLaneMaxN) {
    if (a.N > kWideMaxN || a.K > kWideMaxK || !a.work || !a.mw || !a.vw ||
        (PGD && (!a.mz || !a.vz)))
      return static_cast<int>(cudaErrorInvalidValue);
    return launch(p4_adam_wide_kernel, a.R, kWideThreads, sizeof(float) * 5 * a.N, a, stream);
  }
  const int nm = a.N <= 4 ? 4 : 16;
  int w = 1;
  while (w < a.K) w <<= 1;
  a.W = w > nm ? w : nm;
  if (a.W > kMaxThreads) return static_cast<int>(cudaErrorInvalidValue);
  return nm == 4 ? launch_lanes<4, PGD>(a, stream) : launch_lanes<16, PGD>(a, stream);
}

}  // namespace

// Runs `steps` Adam steps of every row and writes the decode at temp_end.
// power_mode 0: PGD (z_in, X written, x_fixed unread); 1: power_given_x
// (x_fixed read, z and X unread). Every pointer is a contiguous float32
// device buffer of the shape in `Args`; the six moment pointers are all null
// (not written) or all set, and set, with `work`, for a row of more than 16
// devices (the wide kernel keeps its state there). inv_noise is
// 1 / (N0 Bbar) and inv_ln2 1 / ln 2, each rounded to float32. Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a shape
// the kernel does not take (1 <= N <= 64, 1 <= K <= 256, q >= 1).
extern "C" int p4_adam_run(
    int power_mode,
    const void* g, const void* p_max, const void* dev_mask, const void* sc_mask,
    const void* payload, const void* rmin, const void* kappa1, const void* x_fixed,
    const void* sched, const void* z_in, const void* w_in, const void* wt_in,
    void* z_out, void* w_out, void* wt_out,
    void* mz, void* vz, void* mw, void* vw, void* mt, void* vt,
    void* P, void* X, void* work,
    int R, int N, int K, int steps, int q,
    float lr, float penalty_rate, float penalty_binary, float temp_end,
    float bbar, float inv_noise, float inv_ln2, void* stream) {
  auto C = [](const void* p) { return static_cast<const float*>(p); };
  auto F = [](void* p) { return static_cast<float*>(p); };
  Args a{C(g), C(p_max), C(dev_mask), C(sc_mask), C(payload), C(rmin), C(kappa1), C(x_fixed),
         C(sched), C(z_in), C(w_in), C(wt_in), F(z_out), F(w_out), F(wt_out),
         F(mz), F(vz), F(mw), F(vw), F(mt), F(vt), F(P), F(X), F(work),
         R, N, K, 0, steps, q, power_mode ? 0 : 1,
         lr, penalty_rate, penalty_binary, temp_end, bbar, inv_noise, inv_ln2};
  const auto st = static_cast<cudaStream_t>(stream);
  return power_mode ? dispatch<false>(a, st) : dispatch<true>(a, st);
}

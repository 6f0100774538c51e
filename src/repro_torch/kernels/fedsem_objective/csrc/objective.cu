// FedSem objective (paper eq. 13) for B scenarios x G candidate allocations.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/fedsem_objective/kernel.py:
//   * objective_batch_pallas: per-scenario parameter rows, runtime weights and
//     accuracy fit, optional feasibility mask;
//   * objective_grid_pallas: one scenario, feasibility always on. It is this
//     kernel at B = 1 (kernel.py:objective_grid).
//
// score[b, g] = k1 * sum_real (p D/r + xi eta c d f^2 + p rho C/r)
//             + k2 * max_real (D/r + eta c d/f)
//             - k3 * n_real * a * exp(b * log(max(rho, 1e-9)))
// with r clamped at 1e-12; with check_feasible, +inf if a real device has
// rho C / r > t_sc_max or f > f_max * (1 + 1e-6).
//
// Bound on an H100: memory. Every candidate is read once (f, p, r: N floats
// each, rho: one float) and written once (one float), for a handful of flops
// per byte; the limit rows t_sc_max and f_max are read only with
// check_feasible. The exhaustive sweep (core/exhaustive.py) launches it with
// the feasibility mask at (B=1, G=800000, N=4), once for each of Table II's
// 1024 assignments: about 44.8 MB, about 13.4 us at 3.35 TB/s; and at
// (B=64, G=6912, N=3) for the oracle gate, about 19.5 MB. A large-G case
// (B=64, G=8192, N=8) moves about 54.5 MB, about 16 us. At the solver's
// shapes (B*3 rows, G = 1 or 3, N = 10) it moves 10-17 KB, and launch latency
// bounds it.
//
// Design: one thread per (b, g) candidate, grid (ceil(G / 256), B). A block
// stages its scenario's per-device rows (c*d, D, C, mask, and t_sc_max and
// f_max with check_feasible) and its five scalars in shared memory, then
// each thread loops over the N devices of its candidate, reading the
// (B, G, N) layout of the plain version directly. The ragged edge of G is
// masked, so no padding is needed.
//
// Numerics: the operation order is that of ref.py, built with -fmad=false and
// the precise expf/logf, so kernel and plain version differ only in the order
// of the sum over devices.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr float kEps = 1e-12f;
constexpr float kRhoFloor = 1e-9f;
// the plain version's f_max tolerance, rounded to float as torch rounds the
// python double 1.0 + 1e-6
constexpr float kFmaxTol = static_cast<float>(1.0 + 1e-6);

__global__ void __launch_bounds__(kThreads) fedsem_objective_kernel(
    const float* __restrict__ f, const float* __restrict__ p,
    const float* __restrict__ r, const float* __restrict__ rho,
    const float* __restrict__ c, const float* __restrict__ d,
    const float* __restrict__ D, const float* __restrict__ C,
    const float* __restrict__ t_sc_max, const float* __restrict__ f_max,
    const float* __restrict__ dev_mask,
    const float* __restrict__ kappa1, const float* __restrict__ kappa2,
    const float* __restrict__ kappa3, const float* __restrict__ acc_a,
    const float* __restrict__ acc_b,
    float* __restrict__ out,
    int G, int N, float eta, float xi_eta, int check_feasible) {
  extern __shared__ float rows[];  // 6 * N floats
  float* s_cd = rows;
  float* s_D = rows + N;
  float* s_C = rows + 2 * N;
  float* s_tsc = rows + 3 * N;
  float* s_fmax = rows + 4 * N;
  float* s_mask = rows + 5 * N;
  __shared__ float s_scal[5];

  const int b = blockIdx.y;
  const long long row0 = static_cast<long long>(b) * N;
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    s_cd[n] = c[row0 + n] * d[row0 + n];
    s_D[n] = D[row0 + n];
    s_C[n] = C[row0 + n];
    s_mask[n] = dev_mask[row0 + n];
    if (check_feasible) {  // the limits are read only for the +inf mask
      s_tsc[n] = t_sc_max[row0 + n];
      s_fmax[n] = f_max[row0 + n];
    }
  }
  if (threadIdx.x == 0) {
    s_scal[0] = kappa1[b];
    s_scal[1] = kappa2[b];
    s_scal[2] = kappa3[b];
    s_scal[3] = acc_a[b];
    s_scal[4] = acc_b[b];
  }
  __syncthreads();

  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= G) return;
  const long long cand = static_cast<long long>(b) * G + g;
  const float* fr = f + cand * N;
  const float* pr = p + cand * N;
  const float* rr = r + cand * N;
  const float rh = rho[cand];

  float e_sum = 0.0f;
  float t_max = -INFINITY;
  float n_dev = 0.0f;
  bool bad = false;
  for (int n = 0; n < N; ++n) {
    const float fn = fr[n];
    const float pn = pr[n];
    const float rn = fmaxf(rr[n], kEps);
    const float cd = s_cd[n];
    const float tau = s_D[n] / rn;
    const float t_c = eta * cd / fmaxf(fn, kEps);
    const float e_t = pn * tau;
    const float e_c = xi_eta * cd * (fn * fn);
    const float e_sc = pn * rh * s_C[n] / rn;
    n_dev += s_mask[n];
    // padded devices (mask 0) are skipped, never multiplied by 0: their
    // terms may be inf and inf * 0 is nan
    if (s_mask[n] > 0.0f) {
      e_sum += e_t + e_c + e_sc;
      t_max = fmaxf(t_max, tau + t_c);
      if (check_feasible) {
        const float t_sc = rh * s_C[n] / rn;
        bad = bad || (t_sc > s_tsc[n]) || (fn > s_fmax[n] * kFmaxTol);
      }
    }
  }
  const float acc = s_scal[3] * expf(s_scal[4] * logf(fmaxf(rh, kRhoFloor)));
  const float obj = s_scal[0] * e_sum + s_scal[1] * t_max - s_scal[2] * n_dev * acc;
  out[cand] = bad ? INFINITY : obj;
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError(). Every
// pointer is a contiguous float32 device buffer: f, p, r (B, G, N); rho and
// out (B, G); c ... dev_mask (B, N); kappa1 ... acc_b (B,). xi_eta is xi * eta
// rounded once, as the plain version rounds the python product.
extern "C" int fedsem_objective_batch(
    const void* f, const void* p, const void* r, const void* rho,
    const void* c, const void* d, const void* D, const void* C,
    const void* t_sc_max, const void* f_max, const void* dev_mask,
    const void* kappa1, const void* kappa2, const void* kappa3,
    const void* acc_a, const void* acc_b,
    void* out, int B, int G, int N, float eta, float xi_eta,
    int check_feasible, void* stream) {
  const dim3 grid((G + kThreads - 1) / kThreads, B);
  const size_t smem = 6 * static_cast<size_t>(N) * sizeof(float);
  auto F = [](const void* x) { return static_cast<const float*>(x); };
  fedsem_objective_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      F(f), F(p), F(r), F(rho), F(c), F(d), F(D), F(C), F(t_sc_max), F(f_max),
      F(dev_mask), F(kappa1), F(kappa2), F(kappa3), F(acc_a), F(acc_b),
      static_cast<float*>(out), G, N, eta, xi_eta, check_feasible);
  return static_cast<int>(cudaGetLastError());
}

// A CPU stand-in for the few CUDA runtime pieces `kernels/p4_adam/csrc/p4_adam.cu`
// uses, so that its source builds with g++ and runs on the CPU in the tests
// (`tests/test_torch_p4_adam.py`): each CUDA thread of a block is a
// std::thread, a shuffle is an exchange between two barriers of the warp,
// __syncthreads a barrier of the block, and blocks run one after another.
// The test replaces the source's launch by `emulate(...)` and its dynamic
// shared memory by `g_smem`.
#pragma once
#include <math.h>
#include <stddef.h>

#include <barrier>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __maxnreg__(...)

struct Dim3 {
  unsigned x, y, z;
};
inline thread_local Dim3 threadIdx, blockIdx;
inline Dim3 blockDim;

typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <class T>
cudaError_t cudaFuncSetAttribute(T*, cudaFuncAttribute, int) { return cudaSuccess; }
inline cudaError_t cudaGetLastError() { return cudaSuccess; }

struct Warp {
  float val[32];
  std::unique_ptr<std::barrier<>> bar;
};
inline std::vector<Warp>* g_warps;
inline std::barrier<>* g_block;
inline float* g_smem;

// every lane of the warp hands in v and reads the value of lane src
inline float exchange(float v, int src) {
  Warp& w = (*g_warps)[threadIdx.x / 32];
  w.val[threadIdx.x % 32] = v;
  w.bar->arrive_and_wait();
  const float r = w.val[src];
  w.bar->arrive_and_wait();
  return r;
}
inline float __shfl_xor_sync(unsigned, float v, int off, int = 32) {
  return exchange(v, (threadIdx.x % 32) ^ off);
}
inline float __shfl_sync(unsigned, float v, int src, int width = 32) {
  return exchange(v, (threadIdx.x % 32) / width * width + src);
}
inline void __syncthreads() { g_block->arrive_and_wait(); }
inline float __ldg(const float* p) { return *p; }
inline float __frcp_rn(float x) { return 1.0f / x; }

template <class F, class A>
void emulate(F kernel, unsigned blocks, unsigned threads, size_t bytes, const A& a) {
  std::vector<float> smem(bytes / sizeof(float) + 1);
  blockDim = {threads, 1, 1};
  for (unsigned b = 0; b < blocks; ++b) {
    std::vector<Warp> warps(threads / 32);
    for (auto& w : warps) w.bar = std::make_unique<std::barrier<>>(32);
    std::barrier<> block(threads);
    g_warps = &warps;
    g_block = &block;
    g_smem = smem.data();
    std::vector<std::thread> lanes;
    for (unsigned t = 0; t < threads; ++t)
      lanes.emplace_back([&, b, t] {
        blockIdx = {b, 0, 0};
        threadIdx = {t, 0, 0};
        kernel(a);
      });
    for (auto& t : lanes) t.join();
  }
}

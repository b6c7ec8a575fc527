// A g++ emulation of the CUDA runtime that csrc/segment_sum.cu (K2) and
// csrc/unproject_slots.cu (the geometry tail) use,
// for rehearsing it on a machine without a card or nvcc: rehearse.py
// includes this header before the source (its own includes stubbed) and
// drives the real wrappers through the library. One std::thread per CUDA
// thread. A launch runs its CTAs one after another. Shuffles go through a
// per-warp buffer between two barriers; __shared__ arrays (rewritten by
// rehearse.py) live in a per-CTA buffer that starts NaN-poisoned;
// atomicAdd takes a mutex; cache hints are plain loads and stores. The
// card is 2 SMs of 1 resident CTA each, so persistent grids are short and
// their loops wrap.
#pragma once
#include <barrier>
#include <climits>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct uint3v { unsigned x, y, z; };
inline thread_local uint3v threadIdx, blockIdx;
inline thread_local dim3 gridDim, blockDim;
struct int4 { int x, y, z, w; };
struct float4 { float x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
inline int4 make_int4(int a, int b, int c, int d) { return {a, b, c, d}; }
using std::isfinite;
using std::isnan;

// f32 arithmetic with one rounding an operation (g++ contracts nothing into
// an FMA without -mfma), and the saturating truncation of cvt.rzi.s32.f32
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __fmaf_rn(float a, float b, float c) { return std::fma(a, b, c); }
inline int __float2int_rz(float f) {
  if (std::isnan(f)) return 0;
  if (f >= 2147483648.f) return INT_MAX;
  if (f <= -2147483648.f) return INT_MIN;
  return (int)f;
}

typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaDevAttrMultiProcessorCount = 16 };
inline cudaError_t cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(cudaError_t) { return "emulated CUDA error"; }
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return 0; }
inline cudaError_t cudaDeviceGetAttribute(int* v, int, int) { *v = 2; return 0; }
template <class K> cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, K, int, size_t) {
  *n = 1;
  return 0;
}
inline cudaError_t cudaMemsetAsync(void* p, int v, size_t n, cudaStream_t) {
  memset(p, v, n);
  return 0;
}

struct Cta {
  std::vector<std::unique_ptr<std::barrier<>>> warp_bar;
  std::vector<uint64_t> shfl;
  std::vector<unsigned char> statics;
};
inline thread_local Cta* cta = nullptr;
inline unsigned char* emu_static_smem() { return cta->statics.data(); }
inline void __syncwarp() { cta->warp_bar[threadIdx.x / 32]->arrive_and_wait(); }
inline std::mutex atomic_mu;

inline float atomicAdd(float* p, float v) {
  std::lock_guard<std::mutex> g(atomic_mu);
  const float old = *p;
  *p = old + v;
  return old;
}
template <class T> T __ldcs(const T* p) { return *p; }
template <class T> void __stcs(T* p, T v) { *p = v; }

// csrc/cache_hints.cuh without its hints
namespace hints {
inline unsigned long long keep_in_l2() { return 0; }
inline void red_add(float* p, float v, unsigned long long) { atomicAdd(p, v); }
}  // namespace hints

template <class T> T emu_shfl(T x, int src) {
  const int t = threadIdx.x, w = t / 32;
  uint64_t bits = 0;
  memcpy(&bits, &x, sizeof(T));
  cta->shfl[t] = bits;
  cta->warp_bar[w]->arrive_and_wait();
  bits = cta->shfl[32 * w + src];
  cta->warp_bar[w]->arrive_and_wait();
  T y;
  memcpy(&y, &bits, sizeof(T));
  return y;
}
template <class T> T __shfl_sync(unsigned, T x, int src) { return emu_shfl(x, src); }
template <class T> T __shfl_up_sync(unsigned, T x, int d) {
  const int l = threadIdx.x % 32;
  return emu_shfl(x, l >= d ? l - d : l);
}
template <class T> T __shfl_down_sync(unsigned, T x, int d) {
  const int l = threadIdx.x % 32;
  return emu_shfl(x, l + d < 32 ? l + d : l);
}

// A launch: the CTAs one after another, all threads of a CTA at once.
template <class K, class... A>
void emu_launch(K kernel, dim3 grid, int threads, int, A... args) {
  for (unsigned i = 0; i < grid.x * grid.y; ++i) {
    const unsigned b = i % grid.x, by = i / grid.x;
    Cta c;
    for (int w = 0; w < threads / 32; ++w) c.warp_bar.push_back(std::make_unique<std::barrier<>>(32));
    c.shfl.assign(threads, 0);
    c.statics.assign(48 * 1024, 0xff);  // NaN-poisoned shared memory
    std::vector<std::thread> ts;
    for (int t = 0; t < threads; ++t)
      ts.emplace_back([=, &c] {
        cta = &c;
        threadIdx = {(unsigned)t, 0, 0};
        blockIdx = {b, by, 0};
        gridDim = grid;
        blockDim = dim3(threads);
        kernel(args...);
      });
    for (auto& t : ts) t.join();
  }
}

// A g++ emulation of csrc/wgmma_common.cuh, for rehearsing the bf16 routes
// of window attention (K1), the depth-head tail (K5) and global attention
// (K6, K7) on a machine without a card or nvcc: rehearse.py compiles the
// kernels' code against this header instead of the real one and drives the
// real wrappers through it. Same names and API; one std::thread per CUDA
// thread, CTAs one after another.
//
// * an mbarrier: {pending arrivals, tx bytes, phase} under the CTA's mutex;
//   a wait on a phase that never completes aborts after 20 s;
// * a TMA load: a synchronous box copy with zero fill outside the tensor,
//   byte a of the box written to a ^ (((a >> 7) & 7) << 4) (the 128-byte
//   swizzle), then its bytes completed on the barrier;
// * wgmma: each thread computes its own sums (rows 16 w + l / 4 (+ 8),
//   columns 8 j + 2 (l % 4) (+ 1)) from the descriptors' start, LBO and
//   SBO through the same swizzle; an A operand in registers is exchanged
//   through a buffer of the warpgroup; a warpgroup barrier stands for the
//   collective issue;
// * shuffles and named barriers: per-warp buffers and std::barrier;
//   __shared__ arrays of a kernel (rewritten by rehearse.py) live in a
//   per-CTA buffer; the vector types, cache-hinted loads and stores and
//   fences the decoder kernels use are plain C++.
// Shared memory starts NaN-poisoned and 16 bytes off a 1 KB boundary.
#pragma once
#include <cstdint>
#include <cstring>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <thread>
#include <barrier>
#include <mutex>
#include <condition_variable>
#include <map>
#include <vector>
#include <memory>
#include <chrono>
#include <algorithm>
#include <atomic>
using std::min;
using std::max;

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __grid_constant__
#define __restrict__

typedef uint64_t cuuint64_t;
typedef uint32_t cuuint32_t;

struct dim3 { unsigned x, y, z; dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {} };
struct uint3v { unsigned x, y, z; };
inline thread_local uint3v threadIdx, blockIdx;
inline thread_local dim3 gridDim, blockDim;

struct __nv_bfloat16 { uint16_t x; };
struct __nv_bfloat162 { __nv_bfloat16 x, y; };
struct float2 { float x, y; };
struct float4 { float x, y, z, w; };
inline float2 make_float2(float a, float b) { return {a, b}; }
struct uint4 { uint32_t x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
inline uint4 make_uint4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) { return {a, b, c, d}; }
inline float __uint_as_float(uint32_t u) { float f; memcpy(&f, &u, 4); return f; }
inline uint32_t __vmaxs2(uint32_t a, uint32_t b) {
  uint32_t r = 0;
  for (int i = 0; i < 2; ++i) {
    const int16_t x = (int16_t)(a >> (16 * i)), y = (int16_t)(b >> (16 * i));
    r |= (uint32_t)(uint16_t)std::max(x, y) << (16 * i);
  }
  return r;
}
template <class T> inline void __stcg(T* p, T v) { *p = v; }
template <class T> inline T __ldcg(const T* p) { return *p; }
inline void __threadfence() { std::atomic_thread_fence(std::memory_order_seq_cst); }
inline float __bfloat162float(__nv_bfloat16 b) { uint32_t u = (uint32_t)b.x << 16; float f; memcpy(&f, &u, 4); return f; }
inline __nv_bfloat16 __float2bfloat16(float f) {
  uint32_t u; memcpy(&u, &f, 4);
  if (std::isnan(f)) return {0x7fc0};
  u += 0x7fff + ((u >> 16) & 1);
  return {(uint16_t)(u >> 16)};
}
inline __nv_bfloat16 __float2bfloat16_rn(float f) { return __float2bfloat16(f); }
inline __nv_bfloat162 __floats2bfloat162_rn(float a, float b) { return {__float2bfloat16(a), __float2bfloat16(b)}; }
inline float __fmaf_rn(float a, float b, float c) { return std::fma(a, b, c); }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float2 __bfloat1622float2(__nv_bfloat162 v) { return {__bfloat162float(v.x), __bfloat162float(v.y)}; }
template <class T> inline T __ldg(const T* p) { return *p; }

typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorNotSupported = 801 };
typedef void* cudaStream_t;
inline cudaError_t cudaGetLastError() { return 0; }
#define cudaFuncAttributeMaxDynamicSharedMemorySize 0
template <class F> inline cudaError_t cudaFuncSetAttribute(F, int, int) { return 0; }
inline const char* cudaGetErrorString(cudaError_t) { return "emulated CUDA error"; }

struct CUtensorMap { const unsigned char* base; uint64_t dims[5]; uint64_t strides[5]; uint32_t box[5]; int rank; };

// ---- per-CTA state ----------------------------------------------------------
constexpr uint32_t SMEM_BASE = 16;  // the dynamic buffer's shared address (not 1 KB aligned)
struct Bar { uint32_t expected = 0, pending = 0; int64_t tx = 0; uint32_t phase = 0; };
struct Cta {
  std::vector<unsigned char> smem;
  std::mutex mu;
  std::condition_variable cv;
  std::map<uint32_t, Bar> bars;
  std::unique_ptr<std::barrier<>> all;
  std::vector<std::unique_ptr<std::barrier<>>> warp_bar, wg_bar;
  std::vector<float> shfl;
  std::vector<uint32_t> afrag;
  std::vector<unsigned char> statics;
  std::map<int, std::unique_ptr<std::barrier<>>> named;
};
inline thread_local Cta* cta = nullptr;
inline unsigned char* emu_smem() { return cta->smem.data(); }
inline unsigned char* emu_static_smem() { return cta->statics.data(); }
inline void __syncthreads() { cta->all->arrive_and_wait(); }
inline float __shfl_xor_sync(unsigned, float x, int m) {
  const int t = threadIdx.x, w = t / 32, l = t % 32;
  cta->shfl[t] = x;
  cta->warp_bar[w]->arrive_and_wait();
  const float y = cta->shfl[32 * w + (l ^ m)];
  cta->warp_bar[w]->arrive_and_wait();
  return y;
}

template <class K, class... A>
void emu_launch(K kernel, dim3 grid, int threads, int smem, A... args) {
  for (unsigned z = 0; z < grid.z; ++z)
    for (unsigned y = 0; y < grid.y; ++y)
      for (unsigned x = 0; x < grid.x; ++x) {
        Cta c;
        c.smem.assign(smem + 4096, 0xff);  // NaN in bf16 and f32
        c.all = std::make_unique<std::barrier<>>(threads);
        for (int w = 0; w < (threads + 31) / 32; ++w) c.warp_bar.push_back(std::make_unique<std::barrier<>>(std::min(32, threads - 32 * w)));
        for (int w = 0; w < threads / 128; ++w) c.wg_bar.push_back(std::make_unique<std::barrier<>>(128));
        c.shfl.assign(threads + 32, 0.f);
        c.afrag.assign(4 * threads + 128, 0u);
        c.statics.assign(48 * 1024, 0xff);
        std::vector<std::thread> ts;
        for (int t = 0; t < threads; ++t)
          ts.emplace_back([&, t] {
            cta = &c;
            threadIdx = {(unsigned)t, 0, 0};
            blockIdx = {x, y, z};
            gridDim = grid;
            blockDim = dim3(threads);
            kernel(args...);
          });
        for (auto& th : ts) th.join();
      }
}

namespace hopper {

constexpr int MAX_SMEM_BYTES = 232448;
constexpr int TMAP_ERROR = 100000;

inline uint32_t smem_u32(const void* p) {
  return (uint32_t)((const unsigned char*)p - cta->smem.data()) + SMEM_BASE;
}
inline unsigned char* gen(uint32_t a) { return cta->smem.data() + (a - SMEM_BASE); }
inline uint32_t swz(uint32_t a) { return a ^ (((a >> 7) & 7) << 4); }

inline void check_done(Bar& b) {
  if (b.pending == 0 && b.tx == 0) {
    b.phase ^= 1;
    b.pending = b.expected;
    cta->cv.notify_all();
  }
}
inline void mbar_init(uint32_t bar, uint32_t count) {
  std::lock_guard<std::mutex> g(cta->mu);
  Bar b; b.expected = b.pending = count;
  cta->bars[bar] = b;
}
inline void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  std::lock_guard<std::mutex> g(cta->mu);
  Bar& b = cta->bars.at(bar);
  b.tx += bytes;
  if (b.pending == 0) { fprintf(stderr, "EMU: arrival on a complete barrier\n"); abort(); }
  b.pending -= 1;
  check_done(b);
}
inline void mbar_arrive(uint32_t bar) {
  std::lock_guard<std::mutex> g(cta->mu);
  Bar& b = cta->bars.at(bar);
  if (b.pending == 0) { fprintf(stderr, "EMU: arrival on a complete barrier\n"); abort(); }
  b.pending -= 1;
  check_done(b);
}
inline void complete_tx(uint32_t bar, uint32_t bytes) {
  std::lock_guard<std::mutex> g(cta->mu);
  Bar& b = cta->bars.at(bar);
  b.tx -= bytes;
  check_done(b);
}
inline void mbar_wait(uint32_t bar, uint32_t parity) {
  std::unique_lock<std::mutex> g(cta->mu);
  if (!cta->cv.wait_for(g, std::chrono::seconds(20), [&] { return cta->bars.at(bar).phase != parity; })) {
    fprintf(stderr, "EMU: barrier %u wait on parity %u timed out (thread %u block %u %u %u)\n", bar, parity,
            threadIdx.x, blockIdx.x, blockIdx.y, blockIdx.z);
    abort();
  }
}
inline void prefetch_map(const CUtensorMap*) {}
inline void fence_barrier_init() {}
inline void fence_proxy_async() {}
inline int add_one_acq_rel(int* p) { return __atomic_fetch_add(p, 1, __ATOMIC_ACQ_REL); }

inline void tma_load(uint32_t dst, const CUtensorMap* m, uint32_t bar, const int* c) {
  if (dst % 1024) { fprintf(stderr, "EMU: TMA destination %u not 1 KB aligned\n", dst); abort(); }
  uint32_t n = 1;
  for (int i = 0; i < m->rank; ++i) n *= m->box[i];
  const uint32_t bytes = n * 2;
  for (uint32_t e = 0; e < n; ++e) {
    uint32_t rem = e;
    bool in = true;
    uint64_t off = 0;
    for (int i = 0; i < m->rank; ++i) {
      const int64_t coord = (int64_t)c[i] + rem % m->box[i];
      rem /= m->box[i];
      if (coord < 0 || (uint64_t)coord >= m->dims[i]) in = false;
      else off += (uint64_t)coord * (i == 0 ? 2 : m->strides[i - 1]);
    }
    uint16_t v = 0;
    if (in) memcpy(&v, m->base + off, 2);
    memcpy(gen(swz(dst + 2 * e)), &v, 2);
  }
  complete_tx(bar, bytes);
}
inline void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1, int c2, int c3) {
  const int c[4] = {c0, c1, c2, c3};
  tma_load(dst, map, bar, c);
}
inline void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1, int c2) {
  const int c[3] = {c0, c1, c2};
  tma_load(dst, map, bar, c);
}

inline uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}
inline uint32_t d_start(uint64_t d) { return (uint32_t)(d & 0x3FFF) << 4; }
inline uint32_t d_lbo(uint64_t d) { return (uint32_t)((d >> 16) & 0x3FFF) << 4; }
inline uint32_t d_sbo(uint64_t d) { return (uint32_t)((d >> 32) & 0x3FFF) << 4; }
inline float bf_at(uint32_t a) { __nv_bfloat16 b; memcpy(&b, gen(swz(a)), 2); return __bfloat162float(b); }
// K-major: element (r, k) of a 64 x 16 (or N x 16) operand
inline float kmaj(uint64_t d, int r, int k) { return bf_at(d_start(d) + (r / 8) * d_sbo(d) + (r % 8) * 128 + 2 * k); }
// MN-major: element (k, n)
inline float mnmaj(uint64_t d, int k, int n) {
  return bf_at(d_start(d) + (k / 8) * d_sbo(d) + (k % 8) * 128 + (n / 64) * d_lbo(d) + 2 * (n % 64));
}

inline void wg_sync() { cta->wg_bar[threadIdx.x / 128]->arrive_and_wait(); }
inline void wgmma_fence() { wg_sync(); }
inline void wgmma_commit() {}
template <int N> inline void wgmma_wait() {}
template <int R> inline void fence_sums(float (&)[R]) {}
inline void named_sync(int id, int count) {
  std::barrier<>* b;
  {
    std::lock_guard<std::mutex> g(cta->mu);
    auto& slot = cta->named[id];
    if (!slot) slot = std::make_unique<std::barrier<>>(count);
    b = slot.get();
  }
  b->arrive_and_wait();
}

template <int N>
struct Wgmma {
  template <int TB>
  static void ss(float (&d)[N / 2], uint64_t a, uint64_t b) {
    const int t = threadIdx.x % 128, w = t / 32, l = t % 32;
    for (int j = 0; j < N / 8; ++j)
      for (int hh = 0; hh < 2; ++hh)
        for (int v = 0; v < 2; ++v) {
          const int row = 16 * w + l / 4 + 8 * hh, col = 8 * j + 2 * (l % 4) + v;
          float acc = d[4 * j + 2 * hh + v];
          for (int k = 0; k < 16; ++k)
            acc += kmaj(a, row, k) * (TB == 0 ? kmaj(b, col, k) : mnmaj(b, k, col));
          d[4 * j + 2 * hh + v] = acc;
        }
  }
  static void rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b) {
    const int t = threadIdx.x % 128, w = t / 32, l = t % 32, wg = threadIdx.x / 128;
    uint32_t* buf = cta->afrag.data() + 512 * wg;
    for (int r = 0; r < 4; ++r) buf[4 * t + r] = a[r];
    wg_sync();
    auto A = [&](int row, int k) {
      const int rr = row % 16, owner = 32 * (row / 16) + 4 * (rr % 8) + (k % 8) / 2;
      const uint32_t word = buf[4 * owner + (rr / 8) + 2 * (k / 8)];
      __nv_bfloat16 h = {(uint16_t)((k % 2) ? word >> 16 : word & 0xffff)};
      return __bfloat162float(h);
    };
    for (int j = 0; j < N / 8; ++j)
      for (int hh = 0; hh < 2; ++hh)
        for (int v = 0; v < 2; ++v) {
          const int row = 16 * w + l / 4 + 8 * hh, col = 8 * j + 2 * (l % 4) + v;
          float acc = d[4 * j + 2 * hh + v];
          for (int k = 0; k < 16; ++k) acc += A(row, k) * mnmaj(b, k, col);
          d[4 * j + 2 * hh + v] = acc;
        }
    wg_sync();
  }
};
template <int N>
inline void wgmma_bf16(float (&d)[N / 2], uint64_t a, uint64_t b) { Wgmma<N>::template ss<1>(d, a, b); }

inline int encode(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
                  const cuuint64_t* strides, const cuuint32_t* box) {
  if ((uintptr_t)base % 16) return TMAP_ERROR + 1;
  map->base = (const unsigned char*)base;
  map->rank = rank;
  for (int i = 0; i < rank; ++i) {
    map->dims[i] = dims[i];
    map->box[i] = box[i];
    if (box[i] < 1 || box[i] > 256) return TMAP_ERROR + 2;
    if (i > 0) {
      map->strides[i - 1] = strides[i - 1];
      if (strides[i - 1] % 16 || strides[i - 1] >= (1ull << 40)) return TMAP_ERROR + 3;
    }
  }
  if (box[0] * 2 > 128) return TMAP_ERROR + 4;
  return 0;
}
inline const char* error_string(int code) {
  if (code >= TMAP_ERROR) return "cuTensorMapEncodeTiled refused the tensor map";
  return cudaGetErrorString((cudaError_t)code);
}

}  // namespace hopper

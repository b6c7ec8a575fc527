// Hopper building blocks shared by the port's tensor-core kernels: the
// bf16 route of the decoder convolutions (conv_wgmma.cuh, K3 and K4) and
// of global attention (attention_wgmma.cuh, K6 and K7).
//
// * mbarriers for a ring of stages that a producer fills by TMA and
//   consumers release;
// * TMA loads of 3-D and 4-D boxes (cp.async.bulk.tensor) that complete
//   their bytes on a barrier;
// * shared-memory matrix descriptors with the 128-byte swizzle;
// * wgmma m64nNk16 (N = 32, 64, 128), bf16 operands and f32 sums: A from
//   shared memory (K-major) or from registers, B from shared memory
//   K-major (trans-b 0) or MN-major (trans-b 1);
// * cuTensorMapEncodeTiled through the runtime's entry-point query, so a
//   library links no -lcuda.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

constexpr int MAX_SMEM_BYTES = 232448;  // a block's shared memory on sm_90
constexpr int TMAP_ERROR = 100000;      // + the CUresult of a failed tensor-map encode

// --- PTX -------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed. A
// wait that outlasts any load by far (2^26 tries, seconds) traps: a fault
// in the ring shows as a launch error, not as a card that never returns.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t tries = 0; !done; ++tries) {
    if (tries == (1u << 26)) __trap();
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// Fetch a tensor map into the cache before its first load.
__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// Order this thread's generic-proxy writes to shared memory before later
// async-proxy reads (wgmma, TMA) of the same bytes.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// atomicAdd(p, 1) with acquire and release semantics at the scope of the card.
__device__ __forceinline__ int add_one_acq_rel(int* p) {
  int old;
  asm volatile("atom.add.acq_rel.gpu.global.s32 %0, [%1], 1;" : "=r"(old) : "l"(p) : "memory");
  return old;
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// A shared-memory matrix descriptor with the 128-byte swizzle: start
// address, leading and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of the sums across an
// asynchronous wgmma.
template <int R>
__device__ __forceinline__ void fence_sums(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define WG_F4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define WG_F16(i) WG_F4(i), WG_F4(i + 4), WG_F4(i + 8), WG_F4(i + 12)

// One m64nNk16 product of the warpgroup with f32 sums in d: N / 2 sums a
// thread. wgmma's accumulator layout: thread (warp w, lane l) of the
// warpgroup holds rows 16 w + l / 4 and that + 8, columns 8 j + 2 (l % 4)
// + {0, 1}, as d[4 j + {0, 1}] and d[4 j + {2, 3}]. An A fragment in
// registers has the same layout over its 16 columns: a[0] the bf16 pair of
// row 16 w + l / 4 at columns 2 (l % 4) + {0, 1}, a[1] the row 8 below,
// a[2] and a[3] the same at columns + 8; so the sums of a product with
// N = 16 t + 16 are, pair by pair, the A operand of the next product's
// k-step t.
template <int N>
struct Wgmma;

template <>
struct Wgmma<32> {
  // A (64 x 16, K-major) and B from shared memory; trans-b TB: 0 = B K-major, 1 = MN-major
  template <int TB>
  static __device__ __forceinline__ void ss(float (&d)[16], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, 0, %19;\n}\n"
        : WG_F16(0)
        : "l"(a), "l"(b), "r"(1), "n"(TB));
  }
  // A (64 x 16) from registers, four bf16 pairs a thread; B MN-major from shared memory
  static __device__ __forceinline__ void rs(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : WG_F16(0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<64> {
  // A (64 x 16, K-major) and B from shared memory; trans-b TB: 0 = B K-major, 1 = MN-major
  template <int TB>
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, %35;\n}\n"
        : WG_F16(0), WG_F16(16)
        : "l"(a), "l"(b), "r"(1), "n"(TB));
  }
  // A (64 x 16) from registers, four bf16 pairs a thread; B MN-major from shared memory
  static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : WG_F16(0), WG_F16(16)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  // A (64 x 16, K-major) and B from shared memory; trans-b TB: 0 = B K-major, 1 = MN-major
  template <int TB>
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, %67;\n}\n"
        : WG_F16(0), WG_F16(16), WG_F16(32), WG_F16(48)
        : "l"(a), "l"(b), "r"(1), "n"(TB));
  }
  // A (64 x 16) from registers, four bf16 pairs a thread; B MN-major from shared memory
  static __device__ __forceinline__ void rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : WG_F16(0), WG_F16(16), WG_F16(32), WG_F16(48)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};


#undef WG_F16
#undef WG_F4

// d += A (64 x 16, K-major, from a) * B (16 x N, MN-major, from b).
template <int N>
__device__ __forceinline__ void wgmma_bf16(float (&d)[N / 2], uint64_t a, uint64_t b) {
  Wgmma<N>::template ss<1>(d, a, b);
}

// --- tensor maps ---------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of libcuda, fetched through the runtime's entry-point
// query: the library links no -lcuda.
inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault,
                                              &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = (EncodeTiled)ptr;
  }
  return fn;
}

// A bf16 tensor map with the 128-byte swizzle; dims and box innermost first,
// strides in bytes for dims 1 and up. Returns 0 or TMAP_ERROR + CUresult.
inline int encode(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
                  const cuuint64_t* strides, const cuuint32_t* box) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, (cuuint32_t)rank, const_cast<void*>(base),
                  dims, strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                  CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : TMAP_ERROR + (int)r;
}

inline const char* error_string(int code) {
  if (code >= TMAP_ERROR) return "cuTensorMapEncodeTiled refused the tensor map";
  return cudaGetErrorString((cudaError_t)code);
}

}  // namespace hopper

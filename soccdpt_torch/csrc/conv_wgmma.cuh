// The bf16 route of the decoder convolutions K3 (fused_rcu.cu) and K4
// (fused_fusion.cu): a 3x3 or 1x1 convolution as an implicit GEMM on
// Hopper's tensor cores (wgmma), its operands staged by TMA.
//
// The GEMM of one launch, over an NHWC bf16 source (B, H, W, C) and HWIO
// bf16 weights flattened to [tap][Ci][Co]:
//   M: the output pixels of a BOX_H x BOX_W box of one image (64 or 128),
//      64 rows for each consumer warpgroup;
//   N: a tile of BN output channels (64 or 128);
//   K: taps x C, walked in K-steps of one tap times 64 input channels.
// The A tile of a K-step is one 4-D TMA box [1, BOX_H, BOX_W, 64] of the
// source at (b, y0 + dy - 1, x0 + dx - 1, c0). TMA fills what lies outside
// the tensor with zeros, negative coordinates included: that is the
// convolution's zero padding, and channels past C are zeros the same way
// (C = 8 or 16 runs one K-step a tap). The B tile is BN / 64 TMA boxes
// [tap][c0, c0 + 64)[n0 + 64j, n0 + 64j + 64) of the weights: rows of K,
// N contiguous, an MN-major B, which wgmma takes for 16-bit types. Both
// land with the 128-byte swizzle that the wgmma descriptors name.
//
// A CTA is NWG consumer warpgroups and one producer warp. The producer's
// lane 0 keeps a ring of STAGES stages in flight (full/empty mbarriers);
// each consumer warpgroup issues m64nBNk16 products on its 64 rows and
// keeps f32 sums in registers. The epilogue adds the bias (f32, rounded to
// bf16 as the served modules round it) and then, by
// EPI: applies a ReLU (conv1 of a residual conv unit), adds a residual
// (conv2), or nothing (the 1x1 conv); rounds once to bf16 and stores the
// pixels inside the image. conv1 of a residual conv unit also takes the
// ReLU of its input: the consumers apply it in place in shared memory
// (a signed 16-bit max per bf16, then fence.proxy.async so that wgmma's
// async proxy sees it), since TMA copies bytes as they are.
//
// Split-K: with gridDim.z > 1 each CTA sums a contiguous run of K-steps
// and writes its f32 partial to a workspace; the last CTA of an output
// tile (a counter per tile, zeroed by the caller, taken with an acq_rel
// atomic) adds the partials in split order and applies the epilogue. No
// float atomics: a result does not change from run to run.
//
// What bounds it: at C = 256 a 3x3 conv does 2 * 9 * 256 flops per output
// value and per input channel: the operations, on the tensor cores (989
// TFLOP/s in bf16). At the decoder's small maps a conv is 0.07-5 GFLOP, so
// what a launch waits for is filling 132 SMs and the ring's first loads:
// the planner in kernels/_conv.py picks the box, BN and the split of K.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace wgconv {

constexpr int KSTEP = 64;                  // input channels a K-step: one 128-byte row
constexpr int ROW_BYTES = KSTEP * 2;       // the swizzle span
constexpr int CHUNK_BYTES = 64 * ROW_BYTES;  // 64 rows of 128 bytes: one B box
constexpr int STAGES = 6;  // five K-steps' loads in flight while one is multiplied
constexpr int PRODUCER_THREADS = 32;
constexpr int MAX_SMEM_BYTES = 232448;
constexpr int TMAP_ERROR = 100000;  // + the CUresult of a failed tensor-map encode

enum Epilogue : int {
  EPI_CONV1 = 0,     // relu(src) in, relu(acc + bias) out
  EPI_RESIDUAL = 1,  // acc + bias + residual
  EPI_BIAS = 2,      // acc + bias
};

struct ConvParams {
  const float* bias;              // (C,)
  const __nv_bfloat16* residual;  // (B, H, W, C), EPI_RESIDUAL only
  __nv_bfloat16* out;             // (B, H, W, C)
  float* partials;                // split-K partial sums
  int* counters;                  // one per output tile, zero at launch
  int H, W, C;
  int tiles_x, tiles_y;  // boxes along W and H
  int kchunks;           // K-steps a tap: ceil(C / 64)
  int ksteps;            // K-steps of one split
};

__host__ __device__ constexpr int smem_bytes(int box_h, int box_w, int bn) {
  // 1 KB of slack to align the ring to the swizzle atom, the ring, the
  // barriers and the last-CTA flag
  return 1024 + STAGES * (box_h * box_w + bn) * ROW_BYTES + 2 * STAGES * 8 + 16;
}

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

// d += A (64 x 16, K-major, from a) * B (16 x N, MN-major, from b): one
// m64nNk16 product of the warpgroup, f32 sums. Operand 3 of the tail is
// trans-b = 1: B is stored N-contiguous.
template <int N>
__device__ __forceinline__ void wgmma_bf16(float (&d)[N / 2], uint64_t a, uint64_t b);

template <>
__device__ __forceinline__ void wgmma_bf16<64>(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : WG_F16(0), WG_F16(16)
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<128>(float (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : WG_F16(0), WG_F16(16), WG_F16(32), WG_F16(48)
      : "l"(a), "l"(b), "r"(1));
}

#undef WG_F16
#undef WG_F4

// --- the kernel --------------------------------------------------------------

template <int BOX_H, int BOX_W, int BN, int TAPS, int EPI>
__global__ void __launch_bounds__(BOX_H* BOX_W * 2 + PRODUCER_THREADS, 1)
    conv_wgmma_kernel(const __grid_constant__ CUtensorMap src_map,
                      const __grid_constant__ CUtensorMap w_map, const ConvParams p) {
  constexpr int NWG = BOX_H * BOX_W / 64;
  constexpr int CONSUMERS = NWG * 128;
  constexpr int A_BYTES = BOX_H * BOX_W * ROW_BYTES;
  constexpr int STAGE_BYTES = A_BYTES + BN * ROW_BYTES;
  constexpr int SUMS = BN / 2;  // f32 sums a thread: two rows x BN / 4 columns
  static_assert(BOX_H * BOX_W % 64 == 0 && BN % 64 == 0, "whole warpgroups and B boxes");

  extern __shared__ unsigned char wg_smem_raw[];
  const uint32_t raw = smem_u32(wg_smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;  // the swizzle atom is 1 KB
  unsigned char* ring_ptr = wg_smem_raw + (ring - raw);
  const uint32_t bars = ring + STAGES * STAGE_BYTES;
  int* last_flag = reinterpret_cast<int*>(ring_ptr + STAGES * STAGE_BYTES + 2 * STAGES * 8);
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bars + 8 * s, 1);                  // full: the producer's expect_tx
      mbar_init(bars + 8 * (STAGES + s), NWG);    // empty: one arrival a warpgroup
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int tx = blockIdx.x % p.tiles_x;
  const int ty = (blockIdx.x / p.tiles_x) % p.tiles_y;
  const int b = blockIdx.x / (p.tiles_x * p.tiles_y);
  const int x0 = tx * BOX_W, y0 = ty * BOX_H, n0 = blockIdx.y * BN;
  const int k_begin = blockIdx.z * p.ksteps;

  if (tid >= CONSUMERS) {
    // the producer: one lane issues every load of the CTA
    if (tid == CONSUMERS) {
      prefetch_map(&src_map);
      prefetch_map(&w_map);
      int s = 0;
      uint32_t ph = 0;
      for (int it = 0; it < p.ksteps; ++it) {
        const int k = k_begin + it;
        const int tap = k / p.kchunks, c0 = (k % p.kchunks) * KSTEP;
        const int dy = TAPS == 9 ? tap / 3 - 1 : 0, dx = TAPS == 9 ? tap % 3 - 1 : 0;
        mbar_wait(bars + 8 * (STAGES + s), ph ^ 1);
        const uint32_t full = bars + 8 * s, a = ring + s * STAGE_BYTES;
        mbar_expect_tx(full, STAGE_BYTES);
        tma_load_4d(a, &src_map, full, c0, x0 + dx, y0 + dy, b);
#pragma unroll
        for (int j = 0; j < BN / 64; ++j)
          tma_load_3d(a + A_BYTES + j * CHUNK_BYTES, &w_map, full, n0 + 64 * j, c0, tap);
        if (++s == STAGES) {
          s = 0;
          ph ^= 1;
        }
      }
    }
    return;
  }

  // the consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of the box
  const int wg = tid / 128;
  float d[SUMS];
#pragma unroll
  for (int i = 0; i < SUMS; ++i) d[i] = 0.f;
  int s = 0, prev = 0;
  uint32_t ph = 0;
  for (int it = 0; it < p.ksteps; ++it) {
    mbar_wait(bars + 8 * s, ph);
    const uint32_t a = ring + s * STAGE_BYTES + wg * 64 * ROW_BYTES;
    const uint32_t bt = ring + s * STAGE_BYTES + A_BYTES;
    if (EPI == EPI_CONV1) {
      // relu(src) in place: 64 rows x 128 bytes, four 16-byte words a thread
      uint4* rows = reinterpret_cast<uint4*>(ring_ptr + s * STAGE_BYTES + wg * 64 * ROW_BYTES);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        uint4 v = rows[tid % 128 + 128 * i];
        v.x = __vmaxs2(v.x, 0u);
        v.y = __vmaxs2(v.y, 0u);
        v.z = __vmaxs2(v.z, 0u);
        v.w = __vmaxs2(v.w, 0u);
        rows[tid % 128 + 128 * i] = v;
      }
      fence_proxy_async();
      named_sync(1 + wg, 128);
    }
    wgmma_fence();
    fence_sums(d);
#pragma unroll
    for (int kk = 0; kk < KSTEP / 16; ++kk)
      // A: K-major, 32 bytes a k16 step along the swizzled row, 8-row
      // groups 1 KB apart. B: MN-major, 16 rows of 128 bytes a k16 step,
      // 8-row groups of K 1 KB apart, 64-column boxes CHUNK_BYTES apart.
      wgmma_bf16<BN>(d, sw128_desc(a + 32 * kk, 16, 1024),
                     sw128_desc(bt + 2048 * kk, CHUNK_BYTES, 1024));
    wgmma_commit();
    fence_sums(d);
    // the previous K-step's products have finished: release its stage
    wgmma_wait<1>();
    fence_sums(d);
    if (it > 0 && tid % 128 == 0) mbar_arrive(bars + 8 * (STAGES + prev));
    prev = s;
    if (++s == STAGES) {
      s = 0;
      ph ^= 1;
    }
  }
  wgmma_wait<0>();
  fence_sums(d);

  if (gridDim.z > 1) {
    // split-K: store this split's sums, then the last CTA of the tile adds
    // all splits in order. Layout [tile][split][SUMS / 4][CONSUMERS] float4,
    // so a warp's stores are contiguous.
    const size_t tile = (size_t)blockIdx.x * gridDim.y + blockIdx.y;
    float4* part = reinterpret_cast<float4*>(p.partials) + tile * gridDim.z * (SUMS / 4) * CONSUMERS;
#pragma unroll
    for (int q = 0; q < SUMS / 4; ++q)
      __stcg(part + ((size_t)blockIdx.z * (SUMS / 4) + q) * CONSUMERS + tid,
             make_float4(d[4 * q], d[4 * q + 1], d[4 * q + 2], d[4 * q + 3]));
    __threadfence();
    named_sync(15, CONSUMERS);
    if (tid == 0) *last_flag = add_one_acq_rel(p.counters + tile) == (int)gridDim.z - 1;
    named_sync(15, CONSUMERS);
    if (!*last_flag) return;
    __threadfence();
#pragma unroll
    for (int i = 0; i < SUMS; ++i) d[i] = 0.f;
    // split by split, in order: the SUMS / 4 loads of a split are in flight together
    for (int z = 0; z < (int)gridDim.z; ++z) {
#pragma unroll
      for (int q = 0; q < SUMS / 4; ++q) {
        const float4 v = __ldcg(part + ((size_t)z * (SUMS / 4) + q) * CONSUMERS + tid);
        d[4 * q] += v.x;
        d[4 * q + 1] += v.y;
        d[4 * q + 2] += v.z;
        d[4 * q + 3] += v.w;
      }
    }
  }

  // the epilogue. wgmma's accumulator layout: thread (warp w, lane l) of
  // the warpgroup holds rows 16 w + l / 4 and that + 8, columns
  // 8 j + 2 (l % 4) + {0, 1}, as d[4 j + {0, 1}] and d[4 j + {2, 3}].
  const int warp = (tid % 128) / 32, lane = tid % 32;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = wg * 64 + warp * 16 + lane / 4 + 8 * h;
    const int py = y0 + r / BOX_W, px = x0 + r % BOX_W;
    if (py >= p.H || px >= p.W) continue;
    const size_t pix = (((size_t)b * p.H + py) * p.W + px) * p.C;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int co = n0 + 8 * j + 2 * (lane % 4);
      if (co >= p.C) continue;
      const float2 bias = *reinterpret_cast<const float2*>(p.bias + co);
      float v0 = d[4 * j + 2 * h] + __bfloat162float(__float2bfloat16(bias.x));
      float v1 = d[4 * j + 2 * h + 1] + __bfloat162float(__float2bfloat16(bias.y));
      if (EPI == EPI_CONV1) {
        v0 = fmaxf(v0, 0.f);
        v1 = fmaxf(v1, 0.f);
      } else if (EPI == EPI_RESIDUAL) {
        const float2 res =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p.residual + pix + co));
        v0 += res.x;
        v1 += res.y;
      }
      *reinterpret_cast<__nv_bfloat162*>(p.out + pix + co) = __floats2bfloat162_rn(v0, v1);
    }
  }
}

// --- a call's preparation ------------------------------------------------------

constexpr int MAX_WEIGHTS = 3;  // K4: conv1, conv2 and the 1x1 conv
constexpr int PREP_CO = 32, PREP_CI = 8, PREP_THREADS = 256;  // a block: PREP_CI x PREP_CO

// A weight as the caller holds it: an HWIO view (kh, kw, C, C) of f32 or
// bf16 with any element strides (a port module's OIHW weight seen as HWIO
// is one); out is its bf16 copy as the kernel reads it, [tap][C][C].
struct WeightView {
  const void* w;
  int stride[4];  // in elements: kh, kw, Ci, Co
  int taps, is_bf16;  // taps: 9 (3x3) or 1 (1x1)
  __nv_bfloat16* out;
};

struct Prepare {
  WeightView weights[MAX_WEIGHTS];
  int* counters;  // split-K counters to zero, or null
  int n_counters, C;
};

// One weight's (Ci, Co) tile of all its taps through shared memory: read in
// the order of the view's fastest dimension (Co for an HWIO tensor, else
// the taps and Ci of an OIHW one), every load issued before any store,
// written Co-contiguous as bf16.
template <int TAPS>
__device__ __forceinline__ void prepare_weight(const WeightView& v, int C, float* tile) {
  constexpr int KW = TAPS == 9 ? 3 : 1;
  constexpr int N = TAPS * PREP_CI * PREP_CO, PER_THREAD = N / PREP_THREADS;
  constexpr int ROW = PREP_CO + 1, TAP_STRIDE = PREP_CI * ROW + 1;  // odd: no bank conflicts
  static_assert(N % PREP_THREADS == 0, "whole rounds of loads");
  const int co0 = blockIdx.x * PREP_CO, ci0 = blockIdx.y * PREP_CI;
  const bool co_fastest = v.stride[3] == 1;
  float x[PER_THREAD];
  int at[PER_THREAD];
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    const int i = threadIdx.x + k * PREP_THREADS;
    int t, ci, co;
    if (co_fastest) {
      co = i % PREP_CO;
      ci = (i / PREP_CO) % PREP_CI;
      t = i / (PREP_CO * PREP_CI);
    } else {
      t = i % TAPS;
      ci = (i / TAPS) % PREP_CI;
      co = i / (TAPS * PREP_CI);
    }
    at[k] = t * TAP_STRIDE + ci * ROW + co;
    x[k] = 0.f;
    if (ci0 + ci < C && co0 + co < C) {
      const int src = (t / KW) * v.stride[0] + (t % KW) * v.stride[1] + (ci0 + ci) * v.stride[2] +
                      (co0 + co) * v.stride[3];
      x[k] = v.is_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(v.w)[src])
                       : static_cast<const float*>(v.w)[src];
    }
  }
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) tile[at[k]] = x[k];
  __syncthreads();
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    const int i = threadIdx.x + k * PREP_THREADS;
    const int co = i % PREP_CO, ci = (i / PREP_CO) % PREP_CI, t = i / (PREP_CO * PREP_CI);
    if (ci0 + ci < C && co0 + co < C)
      v.out[((size_t)t * C + ci0 + ci) * C + co0 + co] =
          __float2bfloat16(tile[t * TAP_STRIDE + ci * ROW + co]);
  }
}

// One launch before a call's convolutions: every weight to bf16 [tap][C][C]
// (grid.z picks the weight) and the split-K counters to zero.
__global__ void __launch_bounds__(PREP_THREADS) prepare_kernel(const Prepare p) {
  __shared__ float tile[9 * (PREP_CI * (PREP_CO + 1) + 1)];
  if (blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0)
    for (int i = threadIdx.x; i < p.n_counters; i += PREP_THREADS) p.counters[i] = 0;
  const WeightView& v = p.weights[blockIdx.z];
  if (v.taps == 9)
    prepare_weight<9>(v, p.C, tile);
  else
    prepare_weight<1>(v, p.C, tile);
}

// --- the host side -------------------------------------------------------------

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

// Launch one convolution: src (B, H, W, C) and weights [TAPS][C][C], both
// bf16 and 16-byte aligned, C a multiple of 8; splits divides the K-steps.
template <int BOX_H, int BOX_W, int BN, int TAPS, int EPI>
int launch_conv(const void* src, const void* w, const void* bias, const void* residual, void* out,
                void* partials, void* counters, int B, int H, int W, int C, int splits,
                cudaStream_t stream) {
  const int kchunks = (C + KSTEP - 1) / KSTEP;
  if (C % 8 || splits < 1 || (TAPS * kchunks) % splits) return (int)cudaErrorInvalidValue;
  CUtensorMap src_map, w_map;
  const cuuint64_t sdims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t sstrides[3] = {(cuuint64_t)C * 2, (cuuint64_t)W * C * 2,
                                  (cuuint64_t)H * W * C * 2};
  const cuuint32_t sbox[4] = {KSTEP, BOX_W, BOX_H, 1};
  int err = encode(&src_map, src, 4, sdims, sstrides, sbox);
  if (err) return err;
  const cuuint64_t wdims[3] = {(cuuint64_t)C, (cuuint64_t)C, (cuuint64_t)TAPS};
  const cuuint64_t wstrides[2] = {(cuuint64_t)C * 2, (cuuint64_t)C * C * 2};
  const cuuint32_t wbox[3] = {64, KSTEP, 1};
  err = encode(&w_map, w, 3, wdims, wstrides, wbox);
  if (err) return err;

  ConvParams p;
  p.bias = (const float*)bias;
  p.residual = (const __nv_bfloat16*)residual;
  p.out = (__nv_bfloat16*)out;
  p.partials = (float*)partials;
  p.counters = (int*)counters;
  p.H = H;
  p.W = W;
  p.C = C;
  p.tiles_x = (W + BOX_W - 1) / BOX_W;
  p.tiles_y = (H + BOX_H - 1) / BOX_H;
  p.kchunks = kchunks;
  p.ksteps = TAPS * kchunks / splits;

  constexpr int smem = smem_bytes(BOX_H, BOX_W, BN);
  static_assert(smem <= MAX_SMEM_BYTES, "the ring must fit a block's shared memory");
  cudaError_t e = cudaFuncSetAttribute(conv_wgmma_kernel<BOX_H, BOX_W, BN, TAPS, EPI>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)(B * p.tiles_x * p.tiles_y), (unsigned)((C + BN - 1) / BN),
                  (unsigned)splits);
  conv_wgmma_kernel<BOX_H, BOX_W, BN, TAPS, EPI>
      <<<grid, BOX_H * BOX_W * 2 + PRODUCER_THREADS, smem, stream>>>(src_map, w_map, p);
  return (int)cudaGetLastError();
}

// The tiles the planner (kernels/_conv.py, WGMMA_TILES) picks from, by index:
// (box_h, box_w, bn).
template <int TAPS, int EPI>
int dispatch_conv(int config, const void* src, const void* w, const void* bias,
                  const void* residual, void* out, void* partials, void* counters, int B, int H,
                  int W, int C, int splits, cudaStream_t stream) {
  switch (config) {
    case 0:
      return launch_conv<16, 8, 128, TAPS, EPI>(src, w, bias, residual, out, partials, counters,
                                                B, H, W, C, splits, stream);
    case 1:
      return launch_conv<8, 8, 128, TAPS, EPI>(src, w, bias, residual, out, partials, counters, B,
                                               H, W, C, splits, stream);
    case 2:
      return launch_conv<8, 8, 64, TAPS, EPI>(src, w, bias, residual, out, partials, counters, B,
                                              H, W, C, splits, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Launch prepare_kernel for n weights: w[i] with element strides
// strides[4 i .. 4 i + 3] (kh, kw, Ci, Co), taps[i] of 9 (3x3) or 1 (1x1),
// is_bf16[i]; out[i] bf16 [taps[i]][C][C]; counters: n_counters ints to zero
// (or null).
inline int prepare(int n, const void* const* w, const long long* strides, const int* taps,
                   const int* is_bf16, void* const* out, void* counters, int n_counters, int C,
                   cudaStream_t stream) {
  if (n < 1 || n > MAX_WEIGHTS || C < 1) return (int)cudaErrorInvalidValue;
  Prepare p;
  for (int i = 0; i < n; ++i) {
    if (taps[i] != 9 && taps[i] != 1) return (int)cudaErrorInvalidValue;
    const int kw = taps[i] == 9 ? 3 : 1;
    const long long extent[4] = {kw, kw, C, C};
    long long last = 0;  // the largest element offset the view reaches
    for (int d = 0; d < 4; ++d) {
      if (strides[4 * i + d] < 0) return (int)cudaErrorInvalidValue;
      last += strides[4 * i + d] * (extent[d] - 1);
      p.weights[i].stride[d] = (int)strides[4 * i + d];
    }
    if (last > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    p.weights[i].w = w[i];
    p.weights[i].taps = taps[i];
    p.weights[i].is_bf16 = is_bf16[i];
    p.weights[i].out = (__nv_bfloat16*)out[i];
  }
  p.counters = (int*)counters;
  p.n_counters = counters ? n_counters : 0;
  p.C = C;
  const dim3 grid((unsigned)((C + PREP_CO - 1) / PREP_CO), (unsigned)((C + PREP_CI - 1) / PREP_CI),
                  (unsigned)n);
  prepare_kernel<<<grid, PREP_THREADS, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

inline const char* error_string(int code) {
  if (code >= TMAP_ERROR) return "cuTensorMapEncodeTiled refused the tensor map";
  return cudaGetErrorString((cudaError_t)code);
}

}  // namespace wgconv

// --- the bf16 route's C entries, in each library that includes this header ---

extern "C" {

// One convolution: taps 9 with epilogue 0 (conv1 of a residual conv unit)
// or 1 (conv2, with the residual), taps 1 with epilogue 2 (K4's 1x1 conv
// and its bias). src, residual, out: (B, H, W, C) bf16, C a multiple of 8;
// w: bf16 [taps][C][C]; bias: (C,) f32; config: the tile
// (kernels/_conv.py, WGMMA_TILES); splits divides taps * ceil(C / 64);
// partials and counters as the planner sizes them when splits > 1.
int soccdpt_conv_bf16(const void* src, const void* w, const void* bias, const void* residual,
                      void* out, void* partials, void* counters, int B, int H, int W, int C,
                      int taps, int epilogue, int config, int splits, void* stream) {
  if (B == 0 || H == 0 || W == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (taps == 9 && epilogue == wgconv::EPI_CONV1)
    return wgconv::dispatch_conv<9, wgconv::EPI_CONV1>(config, src, w, bias, residual, out,
                                                       partials, counters, B, H, W, C, splits, s);
  if (taps == 9 && epilogue == wgconv::EPI_RESIDUAL)
    return wgconv::dispatch_conv<9, wgconv::EPI_RESIDUAL>(config, src, w, bias, residual, out,
                                                          partials, counters, B, H, W, C, splits,
                                                          s);
  if (taps == 1 && epilogue == wgconv::EPI_BIAS)
    return wgconv::dispatch_conv<1, wgconv::EPI_BIAS>(config, src, w, bias, residual, out,
                                                      partials, counters, B, H, W, C, splits, s);
  return (int)cudaErrorInvalidValue;
}

// A call's preparation, one launch: n <= 3 weights, each an HWIO view
// (kh, kw, C, C) of f32 or bf16 with element strides strides[4 i .. 4 i + 3]
// and taps[i] of 9 or 1, to bf16 [tap][C][C] in out[i]; and n_counters
// split-K counters to zero (counters may be null).
int soccdpt_prepare_bf16(int n, const void* const* w, const long long* strides, const int* taps,
                         const int* is_bf16, void* const* out, void* counters, int n_counters,
                         int C, void* stream) {
  return wgconv::prepare(n, w, strides, taps, is_bf16, out, counters, n_counters, C,
                         (cudaStream_t)stream);
}

}  // extern "C"

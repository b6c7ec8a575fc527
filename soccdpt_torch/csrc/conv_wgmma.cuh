// The bf16 route of the decoder convolutions K3 (fused_rcu.cu), K4
// (fused_fusion.cu) and K5 (fused_head.cu): a 3x3 or 1x1 convolution as an
// implicit GEMM on Hopper's tensor cores (wgmma), its operands staged by
// TMA.
//
// The GEMM of one launch, over an NHWC bf16 source (B, H, W, Ci) and HWIO
// bf16 weights flattened to [tap][Ci][Cw] (Cw: Co, or Co padded to a
// multiple of 8 with zero columns, so that a row is whole 16 bytes):
//   M: the output pixels of a BOX_H x BOX_W box of one image (64 or 128),
//      64 rows for each consumer warpgroup;
//   N: a tile of BN output channels (64 or 128);
//   K: taps x Ci, walked in K-steps of one tap times 64 input channels.
// The A tile of a K-step is one 4-D TMA box [1, BOX_H, BOX_W, 64] of the
// source at (b, y0 + dy - 1, x0 + dx - 1, c0). TMA fills what lies outside
// the tensor with zeros, negative coordinates included: that is the
// convolution's zero padding, and channels past Ci are zeros the same way
// (Ci = 8 or 16 runs one K-step a tap). The B tile is BN / 64 TMA boxes
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
// pixels inside the image. EPI_HEAD (K5, the depth head's tail) stores one
// value a pixel instead: y = relu(bf16(acc + b2)) per channel, z = sum of
// y w3 over the channels (the four threads of a quad by shuffles, and the
// N tiles, which its CTA walks one after another: the ring runs on from
// one tile's K-steps to the next's), then bf16(relu(z + b3)). conv1 of a residual conv unit also takes the
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

#include "wgmma_common.cuh"

namespace wgconv {

using namespace hopper;

constexpr int KSTEP = 64;                  // input channels a K-step: one 128-byte row
constexpr int ROW_BYTES = KSTEP * 2;       // the swizzle span
constexpr int CHUNK_BYTES = 64 * ROW_BYTES;  // 64 rows of 128 bytes: one B box
constexpr int STAGES = 6;  // five K-steps' loads in flight while one is multiplied
constexpr int PRODUCER_THREADS = 32;

enum Epilogue : int {
  EPI_CONV1 = 0,     // relu(src) in, relu(acc + bias) out
  EPI_RESIDUAL = 1,  // acc + bias + residual
  EPI_BIAS = 2,      // acc + bias
  EPI_HEAD = 3,      // relu(sum_c relu(acc_c + b2_c) w3_c + b3): one channel out
};

struct ConvParams {
  const float* bias;              // (Co,); EPI_HEAD: b2 rounded to bf16
  const __nv_bfloat16* residual;  // (B, H, W, Co), EPI_RESIDUAL only
  __nv_bfloat16* out;             // (B, H, W, Co); EPI_HEAD (B, H, W)
  float* partials;                // split-K partial sums
  int* counters;                  // one per output tile, zero at launch
  const float* w3;                // EPI_HEAD: (Co,) and (1,), rounded to bf16
  const float* b3;
  int H, W, Ci, Co;
  int tiles_x, tiles_y;  // boxes along W and H
  int kchunks;           // K-steps a tap: ceil(Ci / 64)
  int ksteps;            // K-steps of one split
  int walk;              // EPI_HEAD: the N tiles a CTA walks, ceil(Co / BN)
};

__host__ __device__ constexpr int smem_bytes(int box_h, int box_w, int bn) {
  // 1 KB of slack to align the ring to the swizzle atom, the ring, the
  // barriers and the last-CTA flag
  return 1024 + STAGES * (box_h * box_w + bn) * ROW_BYTES + 2 * STAGES * 8 + 16;
}

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
  const int walk = EPI == EPI_HEAD ? p.walk : 1;

  if (tid >= CONSUMERS) {
    // the producer: one lane issues every load of the CTA
    if (tid == CONSUMERS) {
      prefetch_map(&src_map);
      prefetch_map(&w_map);
      int s = 0;
      uint32_t ph = 0;
      for (int nt = 0; nt < walk; ++nt) {
        const int nb = n0 + nt * BN;
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
            tma_load_3d(a + A_BYTES + j * CHUNK_BYTES, &w_map, full, nb + 64 * j, c0, tap);
          if (++s == STAGES) {
            s = 0;
            ph ^= 1;
          }
        }
      }
    }
    return;
  }

  // the consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of the box
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32, lane = tid % 32;
  float d[SUMS];
  float z[2] = {0.f, 0.f};  // EPI_HEAD: the 1x1 conv's sums of rows r and r + 8
  int s = 0, prev = 0, step = 0;
  uint32_t ph = 0;
  for (int nt = 0; nt < walk; ++nt) {
#pragma unroll
    for (int i = 0; i < SUMS; ++i) d[i] = 0.f;
    for (int it = 0; it < p.ksteps; ++it, ++step) {
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
      if (step > 0 && tid % 128 == 0) mbar_arrive(bars + 8 * (STAGES + prev));
      prev = s;
      if (++s == STAGES) {
        s = 0;
        ph ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_sums(d);

    if constexpr (EPI == EPI_HEAD) {
      // y = relu(bf16(acc + b2)) of this N tile's channels, summed into z
      // with the weights of the 1x1 conv; channels past Co weigh nothing
      const int nb = n0 + nt * BN;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int co = nb + 8 * j + 2 * (lane % 4);
        if (co >= p.Co) continue;
        const float2 b2 = *reinterpret_cast<const float2*>(p.bias + co);
        const float2 w3 = *reinterpret_cast<const float2*>(p.w3 + co);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float ya = fmaxf(__bfloat162float(__float2bfloat16(d[4 * j + 2 * h] + b2.x)), 0.f);
          const float yb =
              fmaxf(__bfloat162float(__float2bfloat16(d[4 * j + 2 * h + 1] + b2.y)), 0.f);
          z[h] = fmaf(yb, w3.y, fmaf(ya, w3.x, z[h]));
        }
      }
    }
  }

  if constexpr (EPI == EPI_HEAD) {
    // a row's channels lie on the four lanes of a quad
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      z[h] += __shfl_xor_sync(0xffffffffu, z[h], 1);
      z[h] += __shfl_xor_sync(0xffffffffu, z[h], 2);
    }
    if (lane % 4 != 0) return;
    const float b3 = p.b3[0];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wg * 64 + warp * 16 + lane / 4 + 8 * h;
      const int py = y0 + r / BOX_W, px = x0 + r % BOX_W;
      if (py < p.H && px < p.W)
        p.out[((size_t)b * p.H + py) * p.W + px] = __float2bfloat16(fmaxf(z[h] + b3, 0.f));
    }
    return;
  }

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
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = wg * 64 + warp * 16 + lane / 4 + 8 * h;
    const int py = y0 + r / BOX_W, px = x0 + r % BOX_W;
    if (py >= p.H || px >= p.W) continue;
    const size_t pix = (((size_t)b * p.H + py) * p.W + px) * p.Co;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int co = n0 + 8 * j + 2 * (lane % 4);
      if (co >= p.Co) continue;
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
constexpr int MAX_VECTORS = 3;  // K5: b2, w3 and b3
constexpr int PREP_CO = 32, PREP_CI = 8, PREP_THREADS = 256;  // a block: PREP_CI x PREP_CO

// A weight as the caller holds it: an HWIO view (kh, kw, Ci, Co) of f32 or
// bf16 with any element strides (a port module's OIHW weight seen as HWIO
// is one); out is its bf16 copy as the kernel reads it, [tap][Ci][Cw],
// columns Co..Cw zero.
struct WeightView {
  const void* w;
  int stride[4];  // in elements: kh, kw, Ci, Co
  int taps, is_bf16;  // taps: 9 (3x3) or 1 (1x1)
  __nv_bfloat16* out;
};

// A vector (K5's b2, w3, b3) of n elements of f32 or bf16 at an element
// stride, written rounded to bf16 (as the served modules round them) into
// an f32 row of Cw values, zeros past n.
struct VectorView {
  const void* v;
  int stride, n, is_bf16;
};

struct Prepare {
  WeightView weights[MAX_WEIGHTS];
  VectorView vectors[MAX_VECTORS];
  float* vector_out;  // n_vectors rows of Cw floats
  int* counters;      // split-K counters to zero, or null
  int n_counters, n_vectors, Ci, Co, Cw;
};

// One weight's (Ci, Co) tile of all its taps through shared memory: read in
// the order of the view's fastest dimension (Co for an HWIO tensor, else
// the taps and Ci of an OIHW one), every load issued before any store,
// written Co-contiguous as bf16 in rows of Cw (zeros past Co).
template <int TAPS>
__device__ __forceinline__ void prepare_weight(const WeightView& v, int Ci, int Co, int Cw,
                                               float* tile) {
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
    if (ci0 + ci < Ci && co0 + co < Co) {
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
    if (ci0 + ci < Ci && co0 + co < Cw)
      v.out[((size_t)t * Ci + ci0 + ci) * Cw + co0 + co] =
          __float2bfloat16(tile[t * TAP_STRIDE + ci * ROW + co]);
  }
}

// One launch before a call's convolutions: every weight to bf16
// [tap][Ci][Cw] (grid.z picks the weight), and in block (0, 0, 0) the
// split-K counters to zero and the vectors to their rows.
__global__ void __launch_bounds__(PREP_THREADS) prepare_kernel(const Prepare p) {
  __shared__ float tile[9 * (PREP_CI * (PREP_CO + 1) + 1)];
  if (blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0) {
    for (int i = threadIdx.x; i < p.n_counters; i += PREP_THREADS) p.counters[i] = 0;
    for (int i = threadIdx.x; i < p.n_vectors * p.Cw; i += PREP_THREADS) {
      const VectorView& v = p.vectors[i / p.Cw];
      const int e = i % p.Cw;
      float x = 0.f;
      if (e < v.n) {
        const size_t at = (size_t)e * v.stride;
        x = v.is_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(v.v)[at])
                      : __bfloat162float(__float2bfloat16(static_cast<const float*>(v.v)[at]));
      }
      p.vector_out[i] = x;
    }
  }
  const WeightView& v = p.weights[blockIdx.z];
  if (v.taps == 9)
    prepare_weight<9>(v, p.Ci, p.Co, p.Cw, tile);
  else
    prepare_weight<1>(v, p.Ci, p.Co, p.Cw, tile);
}

// --- the host side -------------------------------------------------------------

// Launch one convolution: src (B, H, W, Ci) and weights [TAPS][Ci][Cw], both
// bf16 and 16-byte aligned, Ci and Cw multiples of 8; splits divides the
// K-steps; EPI_HEAD walks `walk` N tiles a CTA, with w3 and b3.
template <int BOX_H, int BOX_W, int BN, int TAPS, int EPI>
int launch_conv(const void* src, const void* w, const void* bias, const void* residual, void* out,
                void* partials, void* counters, const void* w3, const void* b3, int B, int H,
                int W, int Ci, int Co, int Cw, int splits, int walk, cudaStream_t stream) {
  const int kchunks = (Ci + KSTEP - 1) / KSTEP;
  if (Ci % 8 || Cw % 8 || Cw < Co || splits < 1 || (TAPS * kchunks) % splits || walk < 1 ||
      (EPI == EPI_HEAD && (splits != 1 || walk * BN < Co)))
    return (int)cudaErrorInvalidValue;
  CUtensorMap src_map, w_map;
  const cuuint64_t sdims[4] = {(cuuint64_t)Ci, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t sstrides[3] = {(cuuint64_t)Ci * 2, (cuuint64_t)W * Ci * 2,
                                  (cuuint64_t)H * W * Ci * 2};
  const cuuint32_t sbox[4] = {KSTEP, BOX_W, BOX_H, 1};
  int err = encode(&src_map, src, 4, sdims, sstrides, sbox);
  if (err) return err;
  const cuuint64_t wdims[3] = {(cuuint64_t)Cw, (cuuint64_t)Ci, (cuuint64_t)TAPS};
  const cuuint64_t wstrides[2] = {(cuuint64_t)Cw * 2, (cuuint64_t)Ci * Cw * 2};
  const cuuint32_t wbox[3] = {64, KSTEP, 1};
  err = encode(&w_map, w, 3, wdims, wstrides, wbox);
  if (err) return err;

  ConvParams p;
  p.bias = (const float*)bias;
  p.residual = (const __nv_bfloat16*)residual;
  p.out = (__nv_bfloat16*)out;
  p.partials = (float*)partials;
  p.counters = (int*)counters;
  p.w3 = (const float*)w3;
  p.b3 = (const float*)b3;
  p.H = H;
  p.W = W;
  p.Ci = Ci;
  p.Co = Co;
  p.tiles_x = (W + BOX_W - 1) / BOX_W;
  p.tiles_y = (H + BOX_H - 1) / BOX_H;
  p.kchunks = kchunks;
  p.ksteps = TAPS * kchunks / splits;
  p.walk = walk;

  constexpr int smem = smem_bytes(BOX_H, BOX_W, BN);
  static_assert(smem <= MAX_SMEM_BYTES, "the ring must fit a block's shared memory");
  cudaError_t e = cudaFuncSetAttribute(conv_wgmma_kernel<BOX_H, BOX_W, BN, TAPS, EPI>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)(B * p.tiles_x * p.tiles_y),
                  EPI == EPI_HEAD ? 1u : (unsigned)((Co + BN - 1) / BN), (unsigned)splits);
  conv_wgmma_kernel<BOX_H, BOX_W, BN, TAPS, EPI>
      <<<grid, BOX_H * BOX_W * 2 + PRODUCER_THREADS, smem, stream>>>(src_map, w_map, p);
  return (int)cudaGetLastError();
}

// The tiles the planner (kernels/_conv.py, WGMMA_TILES) picks from for K3
// and K4, by index: (box_h, box_w, bn); Ci = Co = C.
template <int TAPS, int EPI>
int dispatch_conv(int config, const void* src, const void* w, const void* bias,
                  const void* residual, void* out, void* partials, void* counters, int B, int H,
                  int W, int C, int splits, cudaStream_t stream) {
  switch (config) {
    case 0:
      return launch_conv<16, 8, 128, TAPS, EPI>(src, w, bias, residual, out, partials, counters,
                                                nullptr, nullptr, B, H, W, C, C, C, splits, 1,
                                                stream);
    case 1:
      return launch_conv<8, 8, 128, TAPS, EPI>(src, w, bias, residual, out, partials, counters,
                                               nullptr, nullptr, B, H, W, C, C, C, splits, 1,
                                               stream);
    case 2:
      return launch_conv<8, 8, 64, TAPS, EPI>(src, w, bias, residual, out, partials, counters,
                                              nullptr, nullptr, B, H, W, C, C, C, splits, 1,
                                              stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Fill weight i of p: w with element strides strides[0..3] (kh, kw, Ci, Co)
// and taps of 9 (3x3) or 1 (1x1), to out bf16 [taps][Ci][Cw].
inline int weight_view(Prepare& p, int i, const void* w, const long long* strides, int taps,
                       int is_bf16, void* out) {
  if (taps != 9 && taps != 1) return (int)cudaErrorInvalidValue;
  const int kw = taps == 9 ? 3 : 1;
  const long long extent[4] = {kw, kw, p.Ci, p.Co};
  long long last = 0;  // the largest element offset the view reaches
  for (int d = 0; d < 4; ++d) {
    if (strides[d] < 0) return (int)cudaErrorInvalidValue;
    last += strides[d] * (extent[d] - 1);
    p.weights[i].stride[d] = (int)strides[d];
  }
  if (last > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  p.weights[i].w = w;
  p.weights[i].taps = taps;
  p.weights[i].is_bf16 = is_bf16;
  p.weights[i].out = (__nv_bfloat16*)out;
  return 0;
}

// Launch prepare_kernel for p's first n weights.
inline int launch_prepare(const Prepare& p, int n, cudaStream_t stream) {
  const dim3 grid((unsigned)((p.Cw + PREP_CO - 1) / PREP_CO),
                  (unsigned)((p.Ci + PREP_CI - 1) / PREP_CI), (unsigned)n);
  prepare_kernel<<<grid, PREP_THREADS, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

// K3's and K4's preparation: n weights, w[i] with element strides
// strides[4 i .. 4 i + 3] (kh, kw, Ci, Co), taps[i] of 9 (3x3) or 1 (1x1),
// is_bf16[i]; out[i] bf16 [taps[i]][C][C]; counters: n_counters ints to zero
// (or null).
inline int prepare(int n, const void* const* w, const long long* strides, const int* taps,
                   const int* is_bf16, void* const* out, void* counters, int n_counters, int C,
                   cudaStream_t stream) {
  if (n < 1 || n > MAX_WEIGHTS || C < 1) return (int)cudaErrorInvalidValue;
  Prepare p = {};
  p.Ci = p.Co = p.Cw = C;
  for (int i = 0; i < n; ++i) {
    const int err = weight_view(p, i, w[i], strides + 4 * i, taps[i], is_bf16[i], out[i]);
    if (err) return err;
  }
  p.counters = (int*)counters;
  p.n_counters = counters ? n_counters : 0;
  return launch_prepare(p, n, stream);
}

}  // namespace wgconv


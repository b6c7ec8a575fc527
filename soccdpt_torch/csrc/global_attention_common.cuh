// Helpers shared by the global-attention kernels: the forward
// (global_attention.cu) and the backward (global_attention_bwd.cu).
//
// Both work on one block of 128 threads, 8 rows (ty) of 16 lanes (tx),
// with tiles staged in shared memory as f32 rows padded to D+4 floats, and
// 4 x 4 register tiles per thread: rows ty + 8 r, columns tx + 16 e.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TY = 8;             // rows of 16 threads: ty picks rows, tx keys / columns
constexpr int THREADS = 16 * TY;
constexpr int RPT = 4;            // query rows per thread
constexpr int BQ = TY * RPT;      // query rows per block
constexpr int BK = 64;            // keys per tile
constexpr int LDP = BK + 4;       // padded row of the weight tile

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// One 16-byte load of a row (4 f32 or 8 bf16 values), widened to f32.
template <typename T> struct Chunk;
template <> struct Chunk<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void load(const float* src, float* f) {
    const float4 t = *reinterpret_cast<const float4*>(src);
    f[0] = t.x; f[1] = t.y; f[2] = t.z; f[3] = t.w;
  }
};
template <> struct Chunk<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void load(const __nv_bfloat16* src, float* f) {
    const uint4 raw = *reinterpret_cast<const uint4*>(src);
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) f[i] = __bfloat162float(h[i]);
  }
};

// ROWS rows of D values from device memory (16-byte aligned) to shared
// memory as f32, rows padded to D+4; rows from live_rows on become zeros.
// All of a thread's loads are issued before its first store.
template <typename T, int D, int ROWS>
__device__ __forceinline__ void stage_rows(const T* __restrict__ src, int live_rows,
                                           float* __restrict__ dst) {
  constexpr int N = Chunk<T>::N;
  constexpr int CPR = D / N;  // chunks per row
  constexpr int CHUNKS = ROWS * CPR;
  constexpr int PER_THREAD = (CHUNKS + THREADS - 1) / THREADS;
  float f[PER_THREAD][N];
#pragma unroll
  for (int t = 0; t < PER_THREAD; ++t) {
    const int i = t * THREADS + threadIdx.x;
    const int r = i / CPR;
    const int c = (i - r * CPR) * N;
    if (i < CHUNKS && r < live_rows) {
      Chunk<T>::load(src + (size_t)r * D + c, f[t]);
    } else {
#pragma unroll
      for (int e = 0; e < N; ++e) f[t][e] = 0.f;
    }
  }
#pragma unroll
  for (int t = 0; t < PER_THREAD; ++t) {
    const int i = t * THREADS + threadIdx.x;
    const int r = i / CPR;
    const int c = (i - r * CPR) * N;
    if (i < CHUNKS) {
#pragma unroll
      for (int g = 0; g < N / 4; ++g)
        *reinterpret_cast<float4*>(dst + r * (D + 4) + c + 4 * g) =
            make_float4(f[t][4 * g], f[t][4 * g + 1], f[t][4 * g + 2], f[t][4 * g + 3]);
    }
  }
}

// reduce over the 16 lanes that share a row (a half-warp)
__device__ __forceinline__ float row_max(float x) {
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// bias_kind: 1 = f32, 2 = bf16
__device__ __forceinline__ float load_bias(const void* bias, int bias_kind, size_t i) {
  if (bias_kind == 1) return static_cast<const float*>(bias)[i];
  return __bfloat162float(static_cast<const __nv_bfloat16*>(bias)[i]);
}

// the DC = D/16 output columns of lane tx: one run of DC below 4, else
// runs of 4 that lie 64 apart (so a half-warp reads 256 contiguous bytes)
template <int DC> __device__ __forceinline__ int col_of(int tx, int cc) {
  if constexpr (DC < 4) return DC * tx + cc;
  else return (cc >> 2) * 64 + 4 * tx + (cc & 3);
}

template <int DC>
__device__ __forceinline__ void load_cols(const float* row, int tx, float* vv) {
  if constexpr (DC == 1) {
    vv[0] = row[tx];
  } else if constexpr (DC == 2) {
    const float2 t = *reinterpret_cast<const float2*>(row + 2 * tx);
    vv[0] = t.x;
    vv[1] = t.y;
  } else {
#pragma unroll
    for (int g = 0; g < DC / 4; ++g) {
      const float4 t = *reinterpret_cast<const float4*>(row + 64 * g + 4 * tx);
      vv[4 * g + 0] = t.x;
      vv[4 * g + 1] = t.y;
      vv[4 * g + 2] = t.z;
      vv[4 * g + 3] = t.w;
    }
  }
}

}  // namespace

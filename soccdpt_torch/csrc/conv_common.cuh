// Helpers of the decoder convolutions on CUDA cores: the f32 routes of the
// fused residual conv unit (fused_rcu.cu, K3), the fusion-block tail
// (fused_fusion.cu, K4) and the depth-head tail (fused_head.cu, K5). Their
// bf16 routes run on the tensor cores (conv_wgmma.cuh); the upsample's
// Lerp and blend come from upsample.cuh.
//
// One block of 256 threads computes a spatial tile of a 3x3 (or 1x1)
// convolution as an implicit GEMM on CUDA cores. The source tile (pixels
// x channels, channel-minor, in the activation type T) lies in shared
// memory; the weights are staged KC input channels at a time as f32
// [tap][KC][CO] for a chunk of CO output channels; each thread keeps a
// P x 4 tile of f32 sums in registers: pixels pg + PG * j of the region
// and output channels 4 * cg .. 4 * cg + 3 of the chunk, where
// cg = tid % (CO / 4) and pg = tid / (CO / 4). Channel counts are
// multiples of 8, so every staged chunk is whole and every 4-channel
// access is aligned (16 bytes of f32, 8 of bf16).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "upsample.cuh"

extern __shared__ __align__(16) unsigned char conv_smem[];

namespace {

constexpr int THREADS = 256;
constexpr int KC = 8;  // input channels per staged chunk
constexpr int MAX_SMEM = 232448;  // bytes a block may use on sm_90

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Four consecutive channels, widened to f32 on load and rounded to T on
// store (round to nearest even for bf16).
template <typename T> struct Quad;
template <> struct Quad<float> {
  static __device__ __forceinline__ void load(const float* p, float* f) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    f[0] = t.x;
    f[1] = t.y;
    f[2] = t.z;
    f[3] = t.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* f) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  }
};
template <> struct Quad<__nv_bfloat16> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float* f) {
    const uint2 t = *reinterpret_cast<const uint2*>(p);
    f[0] = __uint_as_float(t.x << 16);
    f[1] = __uint_as_float(t.x & 0xffff0000u);
    f[2] = __uint_as_float(t.y << 16);
    f[3] = __uint_as_float(t.y & 0xffff0000u);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float* f) {
    unsigned int h[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __bfloat16_as_ushort(__float2bfloat16(f[i]));
    uint2 t;
    t.x = h[0] | (h[1] << 16);
    t.y = h[2] | (h[3] << 16);
    *reinterpret_cast<uint2*>(p) = t;
  }
};

// Stage the weights of input channels [ci0, ci0 + KC) and output channels
// [co0, co0 + CO) from w ([TAPS][Ci][Co] f32, Co a multiple of 4) to
// ws ([TAPS][KC][CO]); channels past Ci or Co become zeros.
template <int TAPS, int CO>
__device__ __forceinline__ void stage_weights(const float* __restrict__ w, int Ci, int Co,
                                              int ci0, int co0, float* __restrict__ ws) {
  constexpr int Q4 = CO / 4;
  for (int i = threadIdx.x; i < TAPS * KC * Q4; i += THREADS) {
    const int q = i % Q4;
    const int r = i / Q4;  // tap * KC + c
    const int ci = ci0 + r % KC;
    const int co = co0 + 4 * q;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (ci < Ci && co < Co)
      v = *reinterpret_cast<const float4*>(w + ((size_t)(r / KC) * Ci + ci) * Co + co);
    *reinterpret_cast<float4*>(ws + r * CO + 4 * q) = v;
  }
}

// Stage channels [ci0, ci0 + KC) of an SH x SW pixel tile of one NHWC
// image (H, W, C) whose local (0, 0) lies at image row gy0, column gx0,
// as dst[pixel * KC + c]. Pixels outside the image become zeros (the
// convolution's zero padding); with RELU the values pass a ReLU first.
template <typename T, bool RELU>
__device__ __forceinline__ void stage_tile(const T* __restrict__ img, int H, int W, int C,
                                           int gy0, int gx0, int SH, int SW, int ci0,
                                           T* __restrict__ dst) {
  constexpr int Q4 = KC / 4;
  for (int i = threadIdx.x; i < SH * SW * Q4; i += THREADS) {
    const int pix = i / Q4;
    const int c = 4 * (i % Q4);
    const int gy = gy0 + pix / SW, gx = gx0 + pix % SW;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      Quad<T>::load(img + ((size_t)gy * W + gx) * C + ci0 + c, v);
      if (RELU) {
#pragma unroll
        for (int k = 0; k < 4; ++k) v[k] = fmaxf(v[k], 0.f);
      }
    }
    Quad<T>::store(dst + pix * KC + c, v);
  }
}

// Source offsets (in pixels of a source of width src_w) of this thread's
// P pixel slots in a region of width out_w holding npix pixels; slots
// past npix point at pixel 0, so their sums are computed on real data
// and never stored.
template <int CO, int P>
__device__ __forceinline__ void pixel_bases(int out_w, int npix, int src_w, int (&base)[P]) {
  constexpr int PG = THREADS / (CO / 4);
  const int pg = threadIdx.x / (CO / 4);
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const int p = pg + PG * j;
    base[j] = p < npix ? (p / out_w) * src_w + p % out_w : 0;
  }
}

// acc[j][q] += sum over the KW x KW taps and the KC staged channels of
// src[(base[j] + tap offset) * pstride + c] * ws[tap][c][4 * cg + q].
template <typename T, int CO, int P, int KW>
__device__ __forceinline__ void mac_chunk(const T* __restrict__ src, int pstride, int src_w,
                                          const int (&base)[P], const float* __restrict__ ws,
                                          float (&acc)[P][4]) {
  const int cg = threadIdx.x % (CO / 4);
#pragma unroll 1
  for (int tap = 0; tap < KW * KW; ++tap) {
    const int toff = (tap / KW) * src_w + tap % KW;
#pragma unroll
    for (int c = 0; c < KC; c += 4) {
      float w[4][4];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float4 v = *reinterpret_cast<const float4*>(ws + (tap * KC + c + t) * CO + 4 * cg);
        w[t][0] = v.x;
        w[t][1] = v.y;
        w[t][2] = v.z;
        w[t][3] = v.w;
      }
#pragma unroll
      for (int j = 0; j < P; ++j) {
        float v[4];
        Quad<T>::load(src + (size_t)(base[j] + toff) * pstride + c, v);
#pragma unroll
        for (int q = 0; q < 4; ++q)
          acc[j][q] = fmaf(v[3], w[3][q],
                           fmaf(v[2], w[2][q], fmaf(v[1], w[1][q], fmaf(v[0], w[0][q], acc[j][q]))));
      }
    }
  }
}

template <int P>
__device__ __forceinline__ void zero(float (&acc)[P][4]) {
#pragma unroll
  for (int j = 0; j < P; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[j][q] = 0.f;
}

// Set the block's dynamic shared memory and launch; a request above what
// a block may hold is refused here rather than by the launch.
template <typename Kernel>
__host__ cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes > (size_t)MAX_SMEM) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

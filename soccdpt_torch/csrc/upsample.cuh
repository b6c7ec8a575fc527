// The bilinear 2x upsample with align_corners=True that the decoder
// kernels share: Lerp and blend for the f32 routes on CUDA cores
// (conv_common.cuh, K4 and K5), and the bf16 upsample pass of the
// tensor-core routes of K4 (fused_fusion.cu, after its 1x1 conv) and K5
// (fused_head.cu, before its 3x3 conv), with its C entry
// soccdpt_upsample2x_bf16 in each library that includes this header.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// One pixel's bilinear 2x upsample with align_corners=True along one
// axis, as torch computes it: source coordinate scale * o with
// scale = (n - 1) / (2n - 1) in f32, the lower neighbour i0 = floor, the
// upper one i0 + 1 clamped to the image, and the weight of the upper one.
struct Lerp {
  int i0, i1;
  float t;
};
__device__ __forceinline__ Lerp lerp_2x(int o, int n, float scale) {
  const float src = scale * (float)o;
  Lerp l;
  l.i0 = (int)src;
  l.i1 = l.i0 + (l.i0 < n - 1 ? 1 : 0);
  l.t = src - (float)l.i0;
  return l;
}

// torch's blend of four neighbours: (1-ty)((1-tx) a + tx b) + ty((1-tx) c + tx d)
__device__ __forceinline__ float blend(const Lerp& ly, const Lerp& lx, float a, float b,
                                       float c, float d) {
  const float wx0 = 1.f - lx.t;
  return (1.f - ly.t) * (wx0 * a + lx.t * b) + ly.t * (wx0 * c + lx.t * d);
}

// Eight bf16 channels (16 bytes) widened to f32.
__device__ __forceinline__ void load8_bf16(const __nv_bfloat16* p, float* f) {
  const uint4 w = *reinterpret_cast<const uint4*>(p);
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(u[i] << 16);
    f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint32_t pack2_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// y (B, H, W, C) -> out (B, 2H, 2W, C), bf16: one thread a pixel and 8
// channels (16 bytes), each output blended in f32 from four neighbours
// with the clamped indices of Lerp (nothing outside the image is read),
// rounded once.
__global__ void upsample2x_bf16(const __nv_bfloat16* __restrict__ y,
                                __nv_bfloat16* __restrict__ out, int B, int H, int W, int C) {
  const int C8 = C / 8, H2 = 2 * H, W2 = 2 * W;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)B * H2 * W2 * C8) return;
  const int c = 8 * (int)(i % C8);
  const size_t pix = i / C8;
  const int gx = (int)(pix % W2), gy = (int)(pix / W2 % H2), b = (int)(pix / ((size_t)W2 * H2));
  const float scale_h = H > 1 ? (float)(H - 1) / (float)(H2 - 1) : 0.f;
  const float scale_w = W > 1 ? (float)(W - 1) / (float)(W2 - 1) : 0.f;
  const Lerp ly = lerp_2x(gy, H, scale_h), lx = lerp_2x(gx, W, scale_w);
  const __nv_bfloat16* yb = y + (size_t)b * H * W * C + c;
  float a[8], bb[8], cc[8], dd[8];
  load8_bf16(yb + ((size_t)ly.i0 * W + lx.i0) * C, a);
  load8_bf16(yb + ((size_t)ly.i0 * W + lx.i1) * C, bb);
  load8_bf16(yb + ((size_t)ly.i1 * W + lx.i0) * C, cc);
  load8_bf16(yb + ((size_t)ly.i1 * W + lx.i1) * C, dd);
  uint32_t v[4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
    v[q] = pack2_bf16(blend(ly, lx, a[2 * q], bb[2 * q], cc[2 * q], dd[2 * q]),
                      blend(ly, lx, a[2 * q + 1], bb[2 * q + 1], cc[2 * q + 1], dd[2 * q + 1]));
  *reinterpret_cast<uint4*>(out + (pix * C + c)) = make_uint4(v[0], v[1], v[2], v[3]);
}

}  // namespace

extern "C" {

// y: (B, H, W, C), out: (B, 2H, 2W, C), bf16, contiguous and 16-byte
// aligned, C a multiple of 8.
int soccdpt_upsample2x_bf16(const void* y, void* out, int B, int H, int W, int C, void* stream) {
  const size_t n = (size_t)B * 4 * H * W * (C / 8);
  if (n == 0) return (int)cudaGetLastError();
  if (C % 8) return (int)cudaErrorInvalidValue;
  upsample2x_bf16<<<(unsigned)((n + 255) / 256), 256, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)y, (__nv_bfloat16*)out, B, H, W, C);
  return (int)cudaGetLastError();
}

}  // extern "C"

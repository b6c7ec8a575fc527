// The bilinear 2x upsample with align_corners=True, as the port's
// decoder computes it on the card.
//
// Which call goes where. Every 2x bilinear align_corners=True upsample of an
// NHWC bf16 tensor on the card that no autograd graph records (made
// contiguous first where it is strided) runs upsample2x_bf16 below: the
// four refinenets of the DPT decoder, the DepthHead after conv1 and the
// SegHead after conv2 (ops/resize.py decides, kernels/upsample.py launches
// it through the C entry of upsample.cu), and
// the bf16 routes of K4 (fused_fusion.cu, after its 1x1 conv) and K5
// (fused_head.cu, before its 3x3 conv). Everything else stays on
// F.interpolate: f32 (the training path and its f32 bounds), the CPU,
// calls that autograd records (the kernel has no backward), other sizes and
// align_corners=False. Lerp and blend below are also the upsample of the
// f32 routes of K4 and K5 on CUDA cores (conv_common.cuh).
//
// What bounds it: bytes. Each input value is read once and each output
// value (four times as many) written once, with no arithmetic to speak of:
// at the BEiT-L/512 decoder's refinenet1 at batch 6 (128x128 -> 256x256,
// 256 channels) 50 MB in and 201 MB out, 75 us at 3.35 TB/s. The design:
// - a CTA owns a band of output rows of one image and 256 chunks of a row
//   (a chunk is 8 channels, 16 bytes, where C % 8 == 0 and the tensors are
//   16-byte aligned; else one channel); a thread owns one chunk, so a warp
//   stores 512 contiguous bytes a row (C >= 8) and loads 16 bytes a pixel;
// - the column's Lerp and both source offsets are computed once, in 32-bit
//   integers (the host keeps an image below 2^31 values);
// - a thread walks its band top to bottom keeping the horizontal blends of
//   its two source rows in f32 registers; each step down loads one new
//   source row (two 16-byte loads) or none, issued one output row ahead,
//   so every source value is read once from HBM for each band that needs
//   it and the row weights are computed once per output row;
// - the band's height comes from the host (kernels/upsample.py plans it
//   from a sweep on the H100): short bands, so that many threads wait on
//   their loads at once, halved where a small map would leave SMs idle.
//
// Arithmetic as torch's upsample_bilinear2d (CUDA): scale (n - 1) / (2n - 1)
// in f32, source index scale * o, i0 = (int)src, i1 = i0 + 1 clamped, the
// blend (1 - ty)((1 - tx) a + tx b) + ty((1 - tx) c + tx d) in f32 and one
// rounding to bf16 (nearest even). The blend's products are fused as nvcc
// fuses aten's, lerp(w0, a, w1, b) = fma(w0, a, w1 * b) at both levels, and
// written with intrinsics so that no instantiation fuses them otherwise:
// with any other fusion an output near zero, where a and b cancel, lands
// up to hundreds of bf16 steps from aten's (measured on the H100, against
// aten's NHWC kernel at C >= 16 and its NCHW kernel below).

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
  const float src = __fmul_rn(scale, (float)o);
  Lerp l;
  l.i0 = (int)src;
  l.i1 = l.i0 + (l.i0 < n - 1 ? 1 : 0);
  l.t = __fsub_rn(src, (float)l.i0);
  return l;
}

// w0 a + w1 b, fused as aten's: fma(w0, a, w1 * b)
__device__ __forceinline__ float lerp(float w0, float a, float w1, float b) {
  return __fmaf_rn(w0, a, __fmul_rn(w1, b));
}

// torch's blend of four neighbours: (1-ty)((1-tx) a + tx b) + ty((1-tx) c + tx d)
__device__ __forceinline__ float blend(const Lerp& ly, const Lerp& lx, float a, float b,
                                       float c, float d) {
  const float wx0 = 1.f - lx.t;
  return lerp(1.f - ly.t, lerp(wx0, a, lx.t, b), ly.t, lerp(wx0, c, lx.t, d));
}

// The scale of an axis of n source pixels, as torch's area_pixel_compute_scale
// with align_corners=True gives it for an output of 2n.
__host__ __device__ __forceinline__ float scale_2x(int n) {
  return n > 1 ? (float)(n - 1) / (float)(2 * n - 1) : 0.f;
}

constexpr int UP_THREADS = 256;

// VEC consecutive bf16 channels of a pixel: loaded raw, widened to f32,
// stored rounded to nearest even.
template <int VEC> struct Chunk;
template <> struct Chunk<8> {
  using Raw = uint4;
  static __device__ __forceinline__ Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  static __device__ __forceinline__ void widen(const Raw& w, float* f) {
    const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(u[i] << 16);
      f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float* f) {
    uint32_t u[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 v = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
      u[i] = *reinterpret_cast<const uint32_t*>(&v);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(u[0], u[1], u[2], u[3]);
  }
};
template <> struct Chunk<1> {
  using Raw = unsigned short;
  static __device__ __forceinline__ Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const unsigned short*>(p));
  }
  static __device__ __forceinline__ void widen(const Raw& w, float* f) {
    f[0] = __uint_as_float((uint32_t)w << 16);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float* f) {
    *p = __float2bfloat16_rn(f[0]);
  }
};

// The horizontal blend (1 - tx) a + tx b of one chunk of a source row.
template <int VEC>
__device__ __forceinline__ void hblend(const typename Chunk<VEC>::Raw& ra,
                                       const typename Chunk<VEC>::Raw& rb, float tx, float* h) {
  float a[VEC], b[VEC];
  Chunk<VEC>::widen(ra, a);
  Chunk<VEC>::widen(rb, b);
  const float wx0 = 1.f - tx;
#pragma unroll
  for (int i = 0; i < VEC; ++i) h[i] = lerp(wx0, a[i], tx, b[i]);
}

// y (B, H, W, C) -> out (B, 2H, 2W, C), bf16. Grid: (chunks of an output
// row / UP_THREADS, bands of `rows` output rows, B).
template <int VEC>
__global__ void __launch_bounds__(UP_THREADS)
upsample2x_bf16(const __nv_bfloat16* __restrict__ y, __nv_bfloat16* __restrict__ out, int H,
                int W, int C, int rows, float scale_h, float scale_w) {
  using Ch = Chunk<VEC>;
  const int W2 = 2 * W, H2 = 2 * H, CV = C / VEC;
  const int e = blockIdx.x * UP_THREADS + threadIdx.x;  // the thread's chunk of a row
  if (e >= W2 * CV) return;
  const int ox = e / CV, c = (e - ox * CV) * VEC;
  const Lerp lx = lerp_2x(ox, W, scale_w);
  const int col0 = lx.i0 * C + c, col1 = lx.i1 * C + c, WC = W * C, W2C = W2 * C;
  const __nv_bfloat16* yb = y + (size_t)blockIdx.z * H * WC;
  __nv_bfloat16* ob = out + (size_t)blockIdx.z * H2 * W2C + e * VEC;

  const int oy0 = blockIdx.y * rows, oy1 = min(oy0 + rows, H2);
  Lerp ly = lerp_2x(oy0, H, scale_h);
  float ha[VEC], hb[VEC];  // the horizontal blends of source rows ly.i0 and ly.i1
  hblend<VEC>(Ch::load(yb + ly.i0 * WC + col0), Ch::load(yb + ly.i0 * WC + col1), lx.t, ha);
  hblend<VEC>(Ch::load(yb + ly.i1 * WC + col0), Ch::load(yb + ly.i1 * WC + col1), lx.t, hb);
  for (int oy = oy0; oy < oy1; ++oy) {
    // the next output row's source rows: the same, or one down (scale < 1/2)
    const Lerp ln = lerp_2x(oy + 1, H, scale_h);
    const bool step = oy + 1 < oy1 && ln.i0 != ly.i0;
    typename Ch::Raw na{}, nb{};
    if (step) {
      na = Ch::load(yb + ln.i1 * WC + col0);
      nb = Ch::load(yb + ln.i1 * WC + col1);
    }
    float v[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = lerp(1.f - ly.t, ha[i], ly.t, hb[i]);
    Ch::store(ob + oy * W2C, v);
    if (step) {  // ln.i0 is ly.i1: its blend moves up, ln.i1's is new
#pragma unroll
      for (int i = 0; i < VEC; ++i) ha[i] = hb[i];
      hblend<VEC>(na, nb, lx.t, hb);
    }
    ly = ln;
  }
}

}  // namespace

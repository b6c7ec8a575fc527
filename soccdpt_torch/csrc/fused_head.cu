// K5: the tail of the DPT depth head, for Hopper (sm_90a).
//
// Replaces the Pallas kernel of soccdpt_tpu/ops/fused_head.py
// (_fused_head_tail_fwd, _head_tail_kernel). Computes, over an NHWC
// tensor x (B, H, W, Ci) (the output of the head's conv1),
//
//   u   = upsample2x(x)                       bilinear, align_corners=True
//   y   = relu(conv3x3(u) + b2)               Ci -> Cm, zero padding at 2H x 2W
//   out = relu(sum_c y[c] * w3[c] + b3)       (B, 2H, 2W)
//
// the tail of a non_negative DepthHead (the final ReLU is part of it).
// Weights f32 already rounded to x's type; sums f32; u and y are rounded
// to x's type where the plain version rounds them.
//
// Design (simple and right first). One block of 256 threads per (image,
// 16 x 16 tile of the output). It never writes u: for each chunk of 8
// input channels it blends the (16+2) x (16+2) pixels of u the tile's
// 3x3 conv reads straight from x into shared memory, zeros for pixels
// outside [0, 2H) x [0, 2W) (the conv's zero padding at output
// resolution). The blend's neighbour indices are clamped to the image as
// torch's are, so nothing outside x is read. Each thread holds 8 pixels
// x 4 of the Cm channels; the 1x1 conv to one channel is a sum over the
// 8 lanes that share a pixel (warp shuffles). Any H and W.
//
// What bounds it: at the flagship's head (Ci = 128, Cm = 32, 256 x 256
// outputs) 9 * Ci * Cm multiply-adds per output pixel against 2 * Ci
// input bytes per 4 output pixels: the operations. CUDA cores in f32.
//
// Gradient: the Pallas kernel's custom VJP recomputes through XLA; the
// port's wrapper recomputes through the plain version (no kernel).

#include "conv_common.cuh"

namespace {

constexpr int OT = 16;  // output tile, rows and columns
constexpr int CO = 32;  // output channels of the 3x3 conv per chunk
constexpr int CG = CO / 4;
constexpr int PG = THREADS / CG;
constexpr int P = OT * OT / PG;
constexpr int UT = OT + 2;  // the upsampled tile with a 1-pixel halo

// Channels [ci0, ci0 + KC) of the UT x UT pixels of u = upsample2x(x)
// whose local (0, 0) lies at output row gy0, column gx0, rounded to T.
template <typename T>
__device__ __forceinline__ void stage_upsampled(const T* __restrict__ xb, int H, int W, int C,
                                                int gy0, int gx0, int ci0, float scale_h,
                                                float scale_w, T* __restrict__ dst) {
  constexpr int Q4 = KC / 4;
  for (int i = threadIdx.x; i < UT * UT * Q4; i += THREADS) {
    const int pix = i / Q4;
    const int c = ci0 + 4 * (i % Q4);
    const int gy = gy0 + pix / UT, gx = gx0 + pix % UT;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (gy >= 0 && gy < 2 * H && gx >= 0 && gx < 2 * W) {
      const Lerp ly = lerp_2x(gy, H, scale_h), lx = lerp_2x(gx, W, scale_w);
      float a[4], b[4], cc[4], d[4];
      Quad<T>::load(xb + ((size_t)ly.i0 * W + lx.i0) * C + c, a);
      Quad<T>::load(xb + ((size_t)ly.i0 * W + lx.i1) * C + c, b);
      Quad<T>::load(xb + ((size_t)ly.i1 * W + lx.i0) * C + c, cc);
      Quad<T>::load(xb + ((size_t)ly.i1 * W + lx.i1) * C + c, d);
#pragma unroll
      for (int q = 0; q < 4; ++q) v[q] = blend(ly, lx, a[q], b[q], cc[q], d[q]);
    }
    Quad<T>::store(dst + pix * KC + 4 * (i % Q4), v);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
fused_head_kernel(const T* __restrict__ x, const float* __restrict__ w2,
                  const float* __restrict__ b2, const float* __restrict__ w3,
                  const float* __restrict__ b3, T* __restrict__ out, int H, int W, int Ci,
                  int Cm) {
  float* ws = reinterpret_cast<float*>(conv_smem);
  T* us = reinterpret_cast<T*>(ws + 9 * KC * CO);
  const int oy0 = blockIdx.y * OT, ox0 = blockIdx.x * OT;
  const int H2 = 2 * H, W2 = 2 * W;
  const T* xb = x + (size_t)blockIdx.z * H * W * Ci;
  const float scale_h = H > 1 ? (float)(H - 1) / (float)(H2 - 1) : 0.f;
  const float scale_w = W > 1 ? (float)(W - 1) / (float)(W2 - 1) : 0.f;
  const int cg = threadIdx.x % CG, pg = threadIdx.x / CG;

  int base[P];
  pixel_bases<CO, P>(OT, OT * OT, UT, base);
  float z[P];
#pragma unroll
  for (int j = 0; j < P; ++j) z[j] = 0.f;
  for (int co0 = 0; co0 < Cm; co0 += CO) {
    float acc[P][4];
    zero(acc);
    for (int ci0 = 0; ci0 < Ci; ci0 += KC) {
      stage_weights<9, CO>(w2, Ci, Cm, ci0, co0, ws);
      stage_upsampled<T>(xb, H, W, Ci, oy0 - 1, ox0 - 1, ci0, scale_h, scale_w, us);
      __syncthreads();
      mac_chunk<T, CO, P, 3>(us, KC, UT, base, ws, acc);
      __syncthreads();
    }
    const int co = co0 + 4 * cg;
    if (co < Cm) {
#pragma unroll
      for (int j = 0; j < P; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float y = fmaxf(to_f(from_f<T>(acc[j][q] + b2[co + q])), 0.f);
          z[j] = fmaf(y, w3[co + q], z[j]);
        }
    }
  }
  // the 8 lanes of a pixel are consecutive lanes of one warp
#pragma unroll
  for (int j = 0; j < P; ++j)
    for (int off = CG / 2; off > 0; off >>= 1) z[j] += __shfl_xor_sync(0xffffffffu, z[j], off);
  if (cg != 0) return;
  T* ob = out + (size_t)blockIdx.z * H2 * W2;
  const float bias = b3[0];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const int p = pg + PG * j;
    const int gy = oy0 + p / OT, gx = ox0 + p % OT;
    if (gy < H2 && gx < W2) ob[(size_t)gy * W2 + gx] = from_f<T>(fmaxf(z[j] + bias, 0.f));
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w2, const void* b2, const void* w3, const void* b3,
                   void* out, int B, int H, int W, int Ci, int Cm, cudaStream_t stream) {
  const size_t smem = 9 * KC * CO * sizeof(float) + (size_t)UT * UT * KC * sizeof(T);
  cudaError_t err = allow_smem(fused_head_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)((2 * W + OT - 1) / OT), (unsigned)((2 * H + OT - 1) / OT), (unsigned)B);
  fused_head_kernel<T><<<grid, THREADS, smem, stream>>>(
      (const T*)x, (const float*)w2, (const float*)b2, (const float*)w3, (const float*)b3,
      (T*)out, H, W, Ci, Cm);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* soccdpt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// x: (B, H, W, Ci), out: (B, 2H, 2W), contiguous, f32 or bf16 (is_bf16);
// Ci a multiple of 8, Cm of 4; w2: (3, 3, Ci, Cm) f32; b2, w3: (Cm,) f32;
// b3: (1,) f32.
int soccdpt_fused_head(const void* x, const void* w2, const void* b2, const void* w3,
                       const void* b3, void* out, int B, int H, int W, int Ci, int Cm,
                       int is_bf16, void* stream) {
  if (B == 0 || H == 0 || W == 0) return (int)cudaGetLastError();
  if (Ci % KC || Cm % 4) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = is_bf16
      ? launch<__nv_bfloat16>(x, w2, b2, w3, b3, out, B, H, W, Ci, Cm, s)
      : launch<float>(x, w2, b2, w3, b3, out, B, H, W, Ci, Cm, s);
  return (int)err;
}

}  // extern "C"

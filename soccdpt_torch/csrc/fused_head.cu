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
// Sums f32; u and y are rounded to x's type where the plain version rounds
// them, and the weights and biases are rounded to it as its convolutions
// round them. Two routes, by dtype:
//
// bf16, on the tensor cores: three launches. The preparation
// (conv_wgmma.cuh, prepare_kernel: w2 to bf16 [tap][Ci][Cw], Cw = Cm
// rounded up to a multiple of 8 with zero columns, and b2, w3, b3 to
// bf16-rounded f32 rows); the upsample pass (upsample.cuh), u to bf16 in a
// scratch tensor; then the 3x3 conv Ci -> Cm as conv_wgmma.cuh's implicit
// GEMM over u, whose TMA boxes' zero fill is the padding at 2H x 2W, with
// the head epilogue (EPI_HEAD): relu(bf16(acc + b2)), the 1x1 conv as a
// sum over the four threads of a quad and over the N tiles the CTA walks
// (Cm > BN), relu(z + b3), one bf16 value a pixel. The tile comes from
// kernels/_conv.py::plan_head (HEAD_TILES below). Entries
// soccdpt_prepare_head_bf16, soccdpt_upsample2x_bf16 (upsample.cuh) and
// soccdpt_head_conv_bf16.
//
// f32, on CUDA cores (conv_common.cuh): one block of 256 threads per
// (image, 16 x 16 tile of the output). It never writes u: for each chunk of
// 8 input channels it blends the (16+2) x (16+2) pixels of u the tile's
// 3x3 conv reads straight from x into shared memory, zeros for pixels
// outside [0, 2H) x [0, 2W) (the conv's zero padding at output
// resolution). The blend's neighbour indices are clamped to the image as
// torch's are, so nothing outside x is read. Each thread holds 8 pixels
// x 4 of the Cm channels; the 1x1 conv to one channel is a sum over the
// 8 lanes that share a pixel (warp shuffles). Any H and W. Entry
// soccdpt_fused_head_f32; weights f32, which the f32 bound (2e-5) needs.
//
// What bounds it: at the flagship's head (Ci = 128, Cm = 32, 256 x 256
// outputs) 9 * Ci * Cm multiply-adds per output pixel against 2 * Ci
// input bytes per 4 output pixels: the operations (4.9 GFLOP, 5 us in
// bf16 on the tensor cores). The bf16 route writes and reads u (16.8 MB at
// the flagship, mostly through the 50 MB L2) where the f32 route blends
// it on chip; blending the A tile straight from x into swizzled shared
// memory would save that pass.
//
// Gradient: the Pallas kernel's custom VJP recomputes through XLA; the
// port's wrapper recomputes through the plain version (no kernel).

#include "conv_common.cuh"
#include "conv_wgmma.cuh"

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

// --- the bf16 route: the head's conv on wgmma fed by TMA -----------------------

namespace wghead {

using namespace wgconv;

// The tiles kernels/_conv.py::plan_head picks from, by index: (box_h,
// box_w, bn).
int dispatch_head(int config, const void* u, const void* w, const float* vec, void* out, int B,
                  int H, int W, int Ci, int Cm, int Cw, int walk, cudaStream_t s) {
  const float *b2 = vec, *w3 = vec + Cw, *b3 = vec + 2 * Cw;
  switch (config) {
    case 0:
      return launch_conv<16, 8, 64, 9, EPI_HEAD>(u, w, b2, nullptr, out, nullptr, nullptr, w3, b3,
                                                 B, H, W, Ci, Cm, Cw, 1, walk, s);
    case 1:
      return launch_conv<16, 8, 128, 9, EPI_HEAD>(u, w, b2, nullptr, out, nullptr, nullptr, w3,
                                                  b3, B, H, W, Ci, Cm, Cw, 1, walk, s);
    case 2:
      return launch_conv<8, 8, 64, 9, EPI_HEAD>(u, w, b2, nullptr, out, nullptr, nullptr, w3, b3,
                                                B, H, W, Ci, Cm, Cw, 1, walk, s);
    case 3:
      return launch_conv<8, 8, 128, 9, EPI_HEAD>(u, w, b2, nullptr, out, nullptr, nullptr, w3, b3,
                                                 B, H, W, Ci, Cm, Cw, 1, walk, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace wghead

extern "C" {

// The bf16 route's preparation, one launch: w2, an HWIO view (3, 3, Ci, Cm)
// of f32 or bf16 with element strides strides[0..3], to w_out bf16
// [9][Ci][Cw] (zero columns past Cm); the vectors b2 (Cm), w3 (Cm) and b3
// (1), vec[i] with element stride vec_strides[i], n vec_n[i] and
// vec_bf16[i], rounded to bf16, to vec_out f32 rows of Cw at 0, Cw, 2 Cw.
int soccdpt_prepare_head_bf16(const void* w2, const long long* strides, int is_bf16, void* w_out,
                              const void* const* vec, const long long* vec_strides,
                              const int* vec_n, const int* vec_bf16, void* vec_out, int Ci,
                              int Cm, int Cw, void* stream) {
  if (Ci < 1 || Cm < 1 || Cw < Cm || Cw % 8) return (int)cudaErrorInvalidValue;
  wgconv::Prepare p = {};
  p.Ci = Ci;
  p.Co = Cm;
  p.Cw = Cw;
  const int err = wgconv::weight_view(p, 0, w2, strides, 9, is_bf16, w_out);
  if (err) return err;
  for (int i = 0; i < wgconv::MAX_VECTORS; ++i) {
    if (vec_n[i] < 1 || vec_n[i] > Cw || vec_strides[i] < 0 ||
        vec_strides[i] * (vec_n[i] - 1) > 0x7fffffffLL)
      return (int)cudaErrorInvalidValue;
    p.vectors[i].v = vec[i];
    p.vectors[i].stride = (int)vec_strides[i];
    p.vectors[i].n = vec_n[i];
    p.vectors[i].is_bf16 = vec_bf16[i];
  }
  p.n_vectors = wgconv::MAX_VECTORS;
  p.vector_out = (float*)vec_out;
  return wgconv::launch_prepare(p, 1, (cudaStream_t)stream);
}

// The head's conv: u (B, H, W, Ci) bf16 (H, W the output's: twice x's), Ci
// a multiple of 8; w bf16 [9][Ci][Cw]; vec the prepared rows of b2, w3, b3;
// out (B, H, W) bf16; config: the tile (kernels/_conv.py, HEAD_TILES);
// walk: the N tiles a CTA walks, ceil(Cm / bn).
int soccdpt_head_conv_bf16(const void* u, const void* w, const void* vec, void* out, int B, int H,
                           int W, int Ci, int Cm, int Cw, int config, int walk, void* stream) {
  if (B == 0 || H == 0 || W == 0) return (int)cudaGetLastError();
  return wghead::dispatch_head(config, u, w, (const float*)vec, out, B, H, W, Ci, Cm, Cw, walk,
                               (cudaStream_t)stream);
}

}  // extern "C"

extern "C" {

const char* soccdpt_error_string(int code) { return hopper::error_string(code); }

// The f32 route. x: (B, H, W, Ci), out: (B, 2H, 2W), contiguous f32; Ci a
// multiple of 8, Cm of 4; w2: (3, 3, Ci, Cm) f32; b2, w3: (Cm,) f32; b3:
// (1,) f32.
int soccdpt_fused_head_f32(const void* x, const void* w2, const void* b2, const void* w3,
                           const void* b3, void* out, int B, int H, int W, int Ci, int Cm,
                           void* stream) {
  if (B == 0 || H == 0 || W == 0) return (int)cudaGetLastError();
  if (Ci % KC || Cm % 4) return (int)cudaErrorInvalidValue;
  return (int)launch<float>(x, w2, b2, w3, b3, out, B, H, W, Ci, Cm, (cudaStream_t)stream);
}

}  // extern "C"

// Swin-V2 scaled-cosine window attention for Hopper (sm_90a).
//
// Replaces the Pallas kernels of soccdpt_tpu/ops/window_attention.py
// (cosine_window_attention, cosine_window_attention_batched, wrapped by
// pallas_window_attention). Computes, for each window b and head h,
//
//   out = softmax(tau[h] * q k^T + bias[h] + mask[b % nW]) v
//
// over (Bw, H, N, D) tensors, q and k already L2-normalised, tau already
// exp'd and clamped, bias already 16*sigmoid, mask optional. Inputs are
// bf16 or f32; all arithmetic is f32; the output has the input's type.
//
// Design (simple and right first): one block per (window, head, tile of
// q_tile query rows; the wrapper picks 32, 16 or 8 so that small stages
// still fill the card). The block stages K and V of its window-head in
// shared memory as f32, rows padded to D+1 floats so that lanes reading
// consecutive keys hit distinct banks. Each warp takes one query row at
// a time: lanes split the keys for the scores, the row's scores stay in
// a per-warp shared row, the softmax is a full-row f32 max/exp/sum with
// warp shuffles, and lanes split the head dimension for P.V. The (N, N)
// score matrix never reaches device memory.
//
// What bounds it: at the flagship (N = 256 or 64, D = 32) the work is
// about 4*N*N*D flops per window-head against (4*N*D) q/k/v/out values
// plus the f32 bias and mask rows, so device memory bounds the ideal
// kernel; this one runs the products on CUDA cores from shared memory
// and re-reads K/V once per query tile (from L2). wgmma and TMA are a
// later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int WARPS = 8;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T, int D>
__global__ void __launch_bounds__(WARPS * 32)
window_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const float* __restrict__ scale,
                        const float* __restrict__ bias, const float* __restrict__ mask,
                        T* __restrict__ out, int H, int N, int nW, int q_tile) {
  constexpr int DP = D + 1;                  // padded shared row
  constexpr int G = D < 32 ? 32 / D : 1;     // key groups across lanes in P.V
  constexpr int DPL = D > 32 ? D / 32 : 1;   // head dims per lane in P.V
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + N * DP;
  float* prows = vs + N * DP;

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const size_t base = (size_t)bh * N * D;

  for (int i = threadIdx.x; i < N * D; i += blockDim.x) {
    const int j = i / D;
    const int c = i - j * D;
    ks[j * DP + c] = to_f(k[base + i]);
    vs[j * DP + c] = to_f(v[base + i]);
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* prow = prows + warp * N;
  const float tau = scale[h];
  const float* bias_h = bias + (size_t)h * N * N;
  const float* mask_w = mask ? mask + (size_t)(b % nW) * N * N : nullptr;
  const int q0 = blockIdx.y * q_tile;
  const int q1 = min(q0 + q_tile, N);

  for (int i = q0 + warp; i < q1; i += WARPS) {
    float qr[D];
    const T* qp = q + base + (size_t)i * D;
#pragma unroll
    for (int c = 0; c < D; ++c) qr[c] = to_f(qp[c]);
    const float* brow = bias_h + (size_t)i * N;
    const float* mrow = mask_w ? mask_w + (size_t)i * N : nullptr;

    float m = -INFINITY;
    for (int j = lane; j < N; j += 32) {
      const float* kr = ks + j * DP;
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < D; ++c) dot = fmaf(qr[c], kr[c], dot);
      float s = dot * tau + brow[j];
      if (mrow) s += mrow[j];
      prow[j] = s;
      m = fmaxf(m, s);
    }
    m = warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < N; j += 32) {
      const float p = expf(prow[j] - m);
      prow[j] = p;
      sum += p;
    }
    sum = warp_sum(sum);
    __syncwarp();
    const float inv = 1.f / sum;
    T* op = out + base + (size_t)i * D;

    if constexpr (D >= 32) {
      float acc[DPL];
#pragma unroll
      for (int t = 0; t < DPL; ++t) acc[t] = 0.f;
      for (int j = 0; j < N; ++j) {
        const float p = prow[j];
#pragma unroll
        for (int t = 0; t < DPL; ++t) acc[t] = fmaf(p, vs[j * DP + lane + 32 * t], acc[t]);
      }
#pragma unroll
      for (int t = 0; t < DPL; ++t) op[lane + 32 * t] = from_f<T>(acc[t] * inv);
    } else {
      const int g = lane / D;
      const int c = lane - g * D;
      float acc = 0.f;
      for (int j = g; j < N; j += G) acc = fmaf(prow[j], vs[j * DP + c], acc);
      for (int off = D; off < 32; off <<= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (g == 0) op[c] = from_f<T>(acc * inv);
    }
    __syncwarp();
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* scale,
                   const void* bias, const void* mask, void* out, int Bw, int H, int N,
                   int nW, int q_tile, cudaStream_t stream) {
  const size_t smem = (size_t)(2 * N * (D + 1) + WARPS * N) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(window_attention_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)(Bw * H), (unsigned)((N + q_tile - 1) / q_tile));
  window_attention_kernel<T, D><<<grid, WARPS * 32, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const float*)scale, (const float*)bias,
      (const float*)mask, (T*)out, H, N, nW, q_tile);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int D, const void* q, const void* k, const void* v, const void* scale,
                     const void* bias, const void* mask, void* out, int Bw, int H, int N,
                     int nW, int q_tile, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, scale, bias, mask, out, Bw, H, N, nW, q_tile, stream);
    case 32: return launch<T, 32>(q, k, v, scale, bias, mask, out, Bw, H, N, nW, q_tile, stream);
    case 64: return launch<T, 64>(q, k, v, scale, bias, mask, out, Bw, H, N, nW, q_tile, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* soccdpt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// q, k, v, out: (Bw, H, N, D) contiguous, f32 or bf16 (is_bf16);
// scale: (H,) f32; bias: (H, N, N) f32; mask: (nW, N, N) f32 or NULL;
// q_tile: query rows per block.
int soccdpt_window_attention(const void* q, const void* k, const void* v, const void* scale,
                             const void* bias, const void* mask, void* out, int Bw, int H,
                             int N, int D, int nW, int is_bf16, int q_tile, void* stream) {
  if (Bw == 0) return (int)cudaGetLastError();
  if (q_tile < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = is_bf16
      ? dispatch<__nv_bfloat16>(D, q, k, v, scale, bias, mask, out, Bw, H, N, nW, q_tile, s)
      : dispatch<float>(D, q, k, v, scale, bias, mask, out, Bw, H, N, nW, q_tile, s);
  return (int)err;
}

}  // extern "C"

// K3: the fused residual conv unit of the DPT decoder, for Hopper (sm_90a).
//
// Replaces the Pallas kernel of soccdpt_tpu/ops/fused_rcu.py (fused_rcu,
// _rcu_kernel). Computes, over an NHWC tensor x (B, H, W, C),
//
//   out = x + conv3x3(relu(conv3x3(relu(x)) + b1)) + b2
//
// both convolutions with zero padding 1, weights HWIO (3, 3, C, C). The
// intermediate is rounded to x's type, as the Pallas kernel rounds it; sums
// are f32. Two routes, one per dtype:
//
// bf16, on the tensor cores (conv_wgmma.cuh): a preparation launch (the
// weights to bf16 [tap][Ci][Co], the split-K counters to zero), then two
// launches of one implicit-GEMM convolution on wgmma fed by TMA. conv1
// takes relu(x) in shared memory and stores mid = bf16(relu(conv + b1))
// for the pixels of the image; conv2 reads mid through the same
// zero-filling TMA box, which is exactly its zero padding, and stores
// bf16(conv + b2 + x). mid (8 MB at 128x128x256) stays in the 50 MB L2
// between the two; no halo is recomputed. Entries soccdpt_prepare_bf16 and
// soccdpt_conv_bf16, defined in conv_wgmma.cuh.
//
// f32, on CUDA cores (conv_common.cuh): one block of 256 threads per
// (image, TH x TW output tile). Phase 1 computes the intermediate over the
// tile and a 1-pixel halo, (TH+2) x (TW+2) pixels x C channels, from an
// input tile with a 2-pixel halo staged 8 channels at a time, and keeps it
// in shared memory. Halo values whose pixel lies outside the image are set
// to zero there, which is conv2's zero padding (relu(b1 + conv of the
// padded input) is not zero). Phase 2 convolves the intermediate into the
// output tile and adds b2 and x. Any H and W: the last tiles are ragged and
// masked. Entry soccdpt_fused_rcu; weights f32. TF32 would keep about
// three digits, too few for the f32 bound of the Pallas tests (2e-4).
//
// What bounds it: at the flagship's widths (C = 256) a 3x3 conv does
// 9 * C = 2,304 multiply-adds per output value: the operations, not the
// bytes.

#include "conv_common.cuh"
#include "conv_wgmma.cuh"

namespace {

constexpr int CO = 64;  // output channels per chunk
constexpr int CG = CO / 4;
constexpr int PG = THREADS / CG;

template <typename T, int TH, int TW>
__global__ void __launch_bounds__(THREADS)
fused_rcu_kernel(const T* __restrict__ x, const float* __restrict__ w1,
                 const float* __restrict__ b1, const float* __restrict__ w2,
                 const float* __restrict__ b2, T* __restrict__ out, int H, int W, int C) {
  constexpr int MH = TH + 2, MW = TW + 2;  // intermediate: the tile and a 1-pixel halo
  constexpr int SH = TH + 4, SW = TW + 4;  // input: the tile and a 2-pixel halo
  constexpr int PA = (MH * MW + PG - 1) / PG;
  constexpr int PB = (TH * TW + PG - 1) / PG;
  const int CP = C + 8;  // padded pixel stride of the intermediate
  float* ws = reinterpret_cast<float*>(conv_smem);
  T* xs = reinterpret_cast<T*>(ws + 9 * KC * CO);
  T* mid = xs + SH * SW * KC;

  const int ty0 = blockIdx.y * TH, tx0 = blockIdx.x * TW;
  const T* xb = x + (size_t)blockIdx.z * H * W * C;
  T* ob = out + (size_t)blockIdx.z * H * W * C;
  const int cg = threadIdx.x % CG, pg = threadIdx.x / CG;

  // phase 1: mid = relu(conv1(relu(x)) + b1), zero outside the image
  int base[PA];
  pixel_bases<CO, PA>(MW, MH * MW, SW, base);
  for (int co0 = 0; co0 < C; co0 += CO) {
    float acc[PA][4];
    zero(acc);
    for (int ci0 = 0; ci0 < C; ci0 += KC) {
      stage_weights<9, CO>(w1, C, C, ci0, co0, ws);
      stage_tile<T, true>(xb, H, W, C, ty0 - 2, tx0 - 2, SH, SW, ci0, xs);
      __syncthreads();
      mac_chunk<T, CO, PA, 3>(xs, KC, SW, base, ws, acc);
      __syncthreads();
    }
    const int co = co0 + 4 * cg;
    if (co < C) {
#pragma unroll
      for (int j = 0; j < PA; ++j) {
        const int p = pg + PG * j;
        if (p >= MH * MW) continue;
        const int gy = ty0 - 1 + p / MW, gx = tx0 - 1 + p % MW;
        const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
        float v[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) v[q] = inside ? fmaxf(acc[j][q] + b1[co + q], 0.f) : 0.f;
        Quad<T>::store(mid + p * CP + co, v);
      }
    }
  }
  __syncthreads();

  // phase 2: out = conv2(mid) + b2 + x
  int base2[PB];
  pixel_bases<CO, PB>(TW, TH * TW, MW, base2);
  for (int co0 = 0; co0 < C; co0 += CO) {
    float acc[PB][4];
    zero(acc);
    for (int ci0 = 0; ci0 < C; ci0 += KC) {
      stage_weights<9, CO>(w2, C, C, ci0, co0, ws);
      __syncthreads();
      mac_chunk<T, CO, PB, 3>(mid + ci0, CP, MW, base2, ws, acc);
      __syncthreads();
    }
    const int co = co0 + 4 * cg;
    if (co >= C) continue;
#pragma unroll
    for (int j = 0; j < PB; ++j) {
      const int p = pg + PG * j;
      if (p >= TH * TW) continue;
      const int gy = ty0 + p / TW, gx = tx0 + p % TW;
      if (gy >= H || gx >= W) continue;
      const size_t at = ((size_t)gy * W + gx) * C + co;
      float skip[4], v[4];
      Quad<T>::load(xb + at, skip);
#pragma unroll
      for (int q = 0; q < 4; ++q) v[q] = acc[j][q] + b2[co + q] + skip[q];
      Quad<T>::store(ob + at, v);
    }
  }
}

template <typename T, int TH, int TW>
cudaError_t launch(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
                   void* out, int B, int H, int W, int C, cudaStream_t stream) {
  const size_t smem = 9 * KC * CO * sizeof(float) + (size_t)(TH + 4) * (TW + 4) * KC * sizeof(T) +
                      (size_t)(TH + 2) * (TW + 2) * (C + 8) * sizeof(T);
  cudaError_t err = allow_smem(fused_rcu_kernel<T, TH, TW>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)((W + TW - 1) / TW), (unsigned)((H + TH - 1) / TH), (unsigned)B);
  fused_rcu_kernel<T, TH, TW><<<grid, THREADS, smem, stream>>>(
      (const T*)x, (const float*)w1, (const float*)b1, (const float*)w2, (const float*)b2,
      (T*)out, H, W, C);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* soccdpt_error_string(int code) { return wgconv::error_string(code); }

// The f32 route. x, out: (B, H, W, C) contiguous f32, C a multiple of 8;
// w1, w2: (3, 3, C, C) f32; b1, b2: (C,) f32; tile: 8 or 4 (square tiles).
int soccdpt_fused_rcu(const void* x, const void* w1, const void* b1, const void* w2,
                      const void* b2, void* out, int B, int H, int W, int C, int tile,
                      void* stream) {
  if (B == 0 || H == 0 || W == 0) return (int)cudaGetLastError();
  if (C % KC) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (tile) {
    case 8: return (int)launch<float, 8, 8>(x, w1, b1, w2, b2, out, B, H, W, C, s);
    case 4: return (int)launch<float, 4, 4>(x, w1, b1, w2, b2, out, B, H, W, C, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"

// K4: the tail of a DPT fusion block, for Hopper (sm_90a).
//
// Replaces the Pallas kernel of soccdpt_tpu/ops/fused_fusion.py
// (fused_rcu_tail, _rcu_tail_kernel). Computes, over an NHWC tensor
// s (B, H, W, C),
//
//   m   = s + conv3x3(relu(conv3x3(relu(s)) + b1)) + b2   (a residual conv unit)
//   out = upsample2x(conv1x1(m) + bo)                    (B, 2H, 2W, C)
//
// with zero padding, the upsample bilinear with align_corners=True as
// torch computes it. The 1x1 conv runs before the upsample, as the JAX
// model's FeatureFusionBlock runs it: both are linear, one per pixel and
// one per channel, so they commute, and the conv then does a quarter of
// the work (the Pallas kernel applies it after the upsample). Sums f32; the
// intermediates rounded to s's type where the plain version rounds them
// (mid, m, the 1x1 output). Two routes, one per dtype:
//
// bf16, on the tensor cores (conv_wgmma.cuh): five launches. The
// preparation, conv1 and conv2 as in K3 (fused_rcu.cu), conv2's epilogue
// storing
// m = bf16(s + conv + b2); the 1x1 conv, the same kernel with one tap and
// + bo in its epilogue; then upsample2x_bf16 (upsample.cuh), each output
// pixel blended from four neighbours with the clamped indices of Lerp, so
// nothing outside the image is read. Entries soccdpt_prepare_bf16 and
// soccdpt_conv_bf16 (conv_wgmma_entries.cuh), and soccdpt_upsample2x_bf16
// (upsample.cuh).
//
// f32, on CUDA cores (conv_common.cuh): one block of 256 threads per
// (image, TH x TW tile of m). It computes, all in shared memory: mid over
// the tile and a 2-pixel halo from an s tile with a 3-pixel halo staged 8
// channels at a time; m over the tile and a 1-pixel halo (what the
// upsample reads); the 1x1 conv of m over the same pixels, written over
// mid; then the 2TH x 2TW output pixels, each blended from four
// neighbours. Only s, the weights and the output touch device memory.
// Halo values outside the image are zeros in mid (conv2's padding); the
// upsample's neighbour indices are clamped to the image, as torch's are,
// so it never reads a halo value outside the image (on a GPU a zero
// weight times an unset value can still be NaN). Any H and W. Entry
// soccdpt_fused_fusion.
//
// What bounds it: the two 3x3 convs, 2 * 9 * C multiply-adds per value of
// m at C = 256: the operations.

#include "conv_common.cuh"
#include "conv_wgmma_entries.cuh"

namespace {

constexpr int CO = 64;
constexpr int CG = CO / 4;
constexpr int PG = THREADS / CG;

template <typename T, int TH, int TW>
__global__ void __launch_bounds__(THREADS)
fused_fusion_kernel(const T* __restrict__ s, const float* __restrict__ w1,
                    const float* __restrict__ b1, const float* __restrict__ w2,
                    const float* __restrict__ b2, const float* __restrict__ wo,
                    const float* __restrict__ bo, T* __restrict__ out, int H, int W, int C) {
  constexpr int AH = TH + 4, AW = TW + 4;  // mid: the tile and a 2-pixel halo
  constexpr int SH = TH + 6, SW = TW + 6;  // s: the tile and a 3-pixel halo
  constexpr int MH = TH + 2, MW = TW + 2;  // m: the tile and a 1-pixel halo
  constexpr int PA = (AH * AW + PG - 1) / PG;
  constexpr int PB = (MH * MW + PG - 1) / PG;
  const int CP = C + 8;  // padded pixel stride of mid and m
  float* ws = reinterpret_cast<float*>(conv_smem);
  T* ss = reinterpret_cast<T*>(ws + 9 * KC * CO);
  T* mid = ss + SH * SW * KC;  // later the 1x1 conv's output
  T* m = mid + AH * AW * CP;

  const int ty0 = blockIdx.y * TH, tx0 = blockIdx.x * TW;
  const T* sb = s + (size_t)blockIdx.z * H * W * C;
  const int cg = threadIdx.x % CG, pg = threadIdx.x / CG;

  // (a) mid = relu(conv1(relu(s)) + b1) over the 2-pixel halo, zero outside the image
  int base_a[PA];
  pixel_bases<CO, PA>(AW, AH * AW, SW, base_a);
  for (int co0 = 0; co0 < C; co0 += CO) {
    float acc[PA][4];
    zero(acc);
    for (int ci0 = 0; ci0 < C; ci0 += KC) {
      stage_weights<9, CO>(w1, C, C, ci0, co0, ws);
      stage_tile<T, true>(sb, H, W, C, ty0 - 3, tx0 - 3, SH, SW, ci0, ss);
      __syncthreads();
      mac_chunk<T, CO, PA, 3>(ss, KC, SW, base_a, ws, acc);
      __syncthreads();
    }
    const int co = co0 + 4 * cg;
    if (co >= C) continue;
#pragma unroll
    for (int j = 0; j < PA; ++j) {
      const int p = pg + PG * j;
      if (p >= AH * AW) continue;
      const int gy = ty0 - 2 + p / AW, gx = tx0 - 2 + p % AW;
      const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
      float v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) v[q] = inside ? fmaxf(acc[j][q] + b1[co + q], 0.f) : 0.f;
      Quad<T>::store(mid + p * CP + co, v);
    }
  }
  __syncthreads();

  // (b) m = conv2(mid) + b2 + s over the 1-pixel halo (zero outside the image)
  int base_b[PB];
  pixel_bases<CO, PB>(MW, MH * MW, AW, base_b);
  for (int co0 = 0; co0 < C; co0 += CO) {
    float acc[PB][4];
    zero(acc);
    for (int ci0 = 0; ci0 < C; ci0 += KC) {
      stage_weights<9, CO>(w2, C, C, ci0, co0, ws);
      __syncthreads();
      mac_chunk<T, CO, PB, 3>(mid + ci0, CP, AW, base_b, ws, acc);
      __syncthreads();
    }
    const int co = co0 + 4 * cg;
    if (co >= C) continue;
#pragma unroll
    for (int j = 0; j < PB; ++j) {
      const int p = pg + PG * j;
      if (p >= MH * MW) continue;
      const int gy = ty0 - 1 + p / MW, gx = tx0 - 1 + p % MW;
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
        float skip[4];
        Quad<T>::load(sb + ((size_t)gy * W + gx) * C + co, skip);
#pragma unroll
        for (int q = 0; q < 4; ++q) v[q] = acc[j][q] + b2[co + q] + skip[q];
      }
      Quad<T>::store(m + p * CP + co, v);
    }
  }
  __syncthreads();

  // (c) the 1x1 conv, m @ wo + bo, over the same pixels, into mid's space
  T* mo = mid;
  pixel_bases<CO, PB>(MW, MH * MW, MW, base_b);
  for (int co0 = 0; co0 < C; co0 += CO) {
    float acc[PB][4];
    zero(acc);
    for (int ci0 = 0; ci0 < C; ci0 += KC) {
      stage_weights<1, CO>(wo, C, C, ci0, co0, ws);
      __syncthreads();
      mac_chunk<T, CO, PB, 1>(m + ci0, CP, MW, base_b, ws, acc);
      __syncthreads();
    }
    const int co = co0 + 4 * cg;
    if (co >= C) continue;
#pragma unroll
    for (int j = 0; j < PB; ++j) {
      const int p = pg + PG * j;
      if (p >= MH * MW) continue;
      float v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) v[q] = acc[j][q] + bo[co + q];
      Quad<T>::store(mo + p * CP + co, v);
    }
  }
  __syncthreads();

  // (d) the 2x upsample of the tile, each output blended from four
  // neighbours at rows/columns within [tile - 1, tile + TH] of the image
  const int H2 = 2 * H, W2 = 2 * W, C4 = C / 4;
  const float scale_h = H > 1 ? (float)(H - 1) / (float)(H2 - 1) : 0.f;
  const float scale_w = W > 1 ? (float)(W - 1) / (float)(W2 - 1) : 0.f;
  T* ob = out + (size_t)blockIdx.z * H2 * W2 * C;
  for (int i = threadIdx.x; i < 4 * TH * TW * C4; i += THREADS) {
    const int c = 4 * (i % C4);
    const int pix = i / C4;
    const int gy = 2 * ty0 + pix / (2 * TW), gx = 2 * tx0 + pix % (2 * TW);
    if (gy >= H2 || gx >= W2) continue;
    const Lerp ly = lerp_2x(gy, H, scale_h), lx = lerp_2x(gx, W, scale_w);
    const int r0 = ly.i0 - (ty0 - 1), r1 = ly.i1 - (ty0 - 1);
    const int c0 = lx.i0 - (tx0 - 1), c1 = lx.i1 - (tx0 - 1);
    float a[4], b[4], cc[4], d[4], v[4];
    Quad<T>::load(mo + (r0 * MW + c0) * CP + c, a);
    Quad<T>::load(mo + (r0 * MW + c1) * CP + c, b);
    Quad<T>::load(mo + (r1 * MW + c0) * CP + c, cc);
    Quad<T>::load(mo + (r1 * MW + c1) * CP + c, d);
#pragma unroll
    for (int q = 0; q < 4; ++q) v[q] = blend(ly, lx, a[q], b[q], cc[q], d[q]);
    Quad<T>::store(ob + ((size_t)gy * W2 + gx) * C + c, v);
  }
}

template <typename T, int TH, int TW>
cudaError_t launch(const void* s, const void* w1, const void* b1, const void* w2, const void* b2,
                   const void* wo, const void* bo, void* out, int B, int H, int W, int C,
                   cudaStream_t stream) {
  const size_t smem = 9 * KC * CO * sizeof(float) + (size_t)(TH + 6) * (TW + 6) * KC * sizeof(T) +
                      ((size_t)(TH + 4) * (TW + 4) + (size_t)(TH + 2) * (TW + 2)) * (C + 8) *
                          sizeof(T);
  cudaError_t err = allow_smem(fused_fusion_kernel<T, TH, TW>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)((W + TW - 1) / TW), (unsigned)((H + TH - 1) / TH), (unsigned)B);
  fused_fusion_kernel<T, TH, TW><<<grid, THREADS, smem, stream>>>(
      (const T*)s, (const float*)w1, (const float*)b1, (const float*)w2, (const float*)b2,
      (const float*)wo, (const float*)bo, (T*)out, H, W, C);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* soccdpt_error_string(int code) { return wgconv::error_string(code); }

// The f32 route. s: (B, H, W, C), out: (B, 2H, 2W, C), contiguous f32, C a
// multiple of 8; w1, w2: (3, 3, C, C) f32; wo: (C, C) f32 [in][out];
// b1, b2, bo: (C,) f32; tile: 8 or 4 (square tiles of s).
int soccdpt_fused_fusion(const void* s, const void* w1, const void* b1, const void* w2,
                         const void* b2, const void* wo, const void* bo, void* out, int B, int H,
                         int W, int C, int tile, void* stream) {
  if (B == 0 || H == 0 || W == 0) return (int)cudaGetLastError();
  if (C % KC) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (tile) {
    case 8: return (int)launch<float, 8, 8>(s, w1, b1, w2, b2, wo, bo, out, B, H, W, C, st);
    case 4: return (int)launch<float, 4, 4>(s, w1, b1, w2, b2, wo, bo, out, B, H, W, C, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"

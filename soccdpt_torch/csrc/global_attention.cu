// Global (ViT / BEiT) multi-head attention for Hopper (sm_90a).
//
// Replaces the Pallas kernels of soccdpt_tpu/ops/global_attention.py
// (_flash_kernel and _flash_kernel_bias, launched by _flash_forward and
// wrapped by flash_mha). Computes, for each image b and head h,
//
//   out = softmax(scale * q k^T + bias[h]) v
//
// over (B, H, T, D) tensors, bias (H, T, T) optional. Inputs are bf16 or
// f32, the bias f32 or bf16 whatever the inputs are; scores, softmax and
// both sums are f32; the probabilities are rounded to the input type
// before P.V; the output has the input's type.
// On request it also writes each row's log-sum-exp of its scores, (B, H, T)
// f32, which the backward (global_attention_bwd.cu) starts from; serving
// passes no pointer and nothing is written.
//
// Design (simple and right first, on CUDA cores). The TPU kernel holds a
// head's whole K and V in fast memory and takes one full-row softmax. At
// T = 1025, D = 64 that is 533 KB as f32 and a block here has 227 KB, so
// this kernel walks the keys in tiles of 64 with a running row maximum
// and row sum (online softmax). One block of 128 threads (8 rows of 16)
// owns one (image, head, tile of 32 query rows). Per key tile:
//
//   1. K and V rows go from device memory by 16-byte loads to shared
//      memory as f32, rows padded to D+4 floats so float4 reads of 16
//      different rows spread over all banks; rows past T are zeros.
//   2. S = Q K^T as a register tile: thread (ty, tx) holds rows ty+8r and
//      keys tx+16e (4 x 4), and reads Q and K as float4 along D: 8 loads
//      feed 64 fused multiply-adds.
//   3. scale, bias and the running softmax in registers; the row maximum
//      crosses the 16 lanes of a row by shuffles, the row sum stays a
//      per-lane partial until the end. A key past T gets the weight 0,
//      never exp() of memory that was not loaded.
//   4. the weights go to shared memory, rounded to the input type, and
//      O += P V runs as a second register tile (rows ty+8r, D/16 columns
//      per thread), rescaled by exp(m_old - m_new) per tile.
//
// No padded copies: T is taken as it is, and the last query tile and the
// last key tile are bounds-checked. Bias rows are T elements long and so
// not 16-byte aligned (T = 1025 or 577); the bias is read by scalar
// loads, 16 consecutive elements per half-warp, in its own type.
//
// The block shape was measured on the card: 32 rows on 128 threads beat
// 64 and 32 rows on 256 threads and 64 rows on 128 threads at every shape
// tried. It keeps four blocks on an SM (52 KB of shared memory and about
// 120 registers a thread at D = 64) and gives 528 blocks at beitl16_512,
// batch 1, for 132 SMs; 272 blocks of 64 rows left a second, nearly empty
// wave.
//
// What bounds it: with a bias, device memory. At beitl16_512 (T = 1025,
// H = 16, D = 64, bf16) q, k, v and out are 8.4 MB and the f32 bias is
// 67 MB per launch, each bias element needed by one query row per image.
// The grid's fastest index is the image, so at batch > 1 the blocks that
// share a bias tile run together and the second finds it in L2. Without
// a bias (plain ViT) the products bound it. This kernel runs the products
// on CUDA cores from shared memory and is far from either bound; wgmma
// and TMA are a later change.

#include "global_attention_common.cuh"

namespace {

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
global_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const void* __restrict__ bias,
                        int bias_kind, T* __restrict__ out, float* __restrict__ lse, int H,
                        int n, float scale) {
  constexpr int LD = D + 4;
  constexpr int DC = D / 16;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;           // BQ x LD
  float* ks = qs + BQ * LD;   // BK x LD
  float* vs = ks + BK * LD;   // BK x LD
  float* ps = vs + BK * LD;   // BQ x LDP

  const int b = blockIdx.x;
  const int h = blockIdx.z;
  const int q0 = blockIdx.y * BQ;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const size_t base = ((size_t)b * H + h) * (size_t)n * D;

  stage_rows<T, D, BQ>(q + base + (size_t)q0 * D, n - q0, qs);

  float m[RPT], l[RPT], o[RPT][DC];
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int cc = 0; cc < DC; ++cc) o[r][cc] = 0.f;
  }

  for (int j0 = 0; j0 < n; j0 += BK) {
    __syncthreads();  // the last tile's readers are done; Q is staged
    stage_rows<T, D, BK>(k + base + (size_t)j0 * D, n - j0, ks);
    stage_rows<T, D, BK>(v + base + (size_t)j0 * D, n - j0, vs);
    __syncthreads();

    // S = Q K^T for rows ty + TY r and keys tx + 16 e
    float s[RPT][4];
#pragma unroll
    for (int r = 0; r < RPT; ++r)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[r][e] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; c += 4) {
      float4 kv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        kv[e] = *reinterpret_cast<const float4*>(ks + (tx + 16 * e) * LD + c);
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(qs + (ty + TY * r) * LD + c);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[r][e] = fmaf(qv.x, kv[e].x, s[r][e]);
          s[r][e] = fmaf(qv.y, kv[e].y, s[r][e]);
          s[r][e] = fmaf(qv.z, kv[e].z, s[r][e]);
          s[r][e] = fmaf(qv.w, kv[e].w, s[r][e]);
        }
      }
    }

    // scale, bias, running softmax; un-normalised weights to shared memory
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int row = q0 + ty + TY * r;
      float tile_max = -INFINITY;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = j0 + tx + 16 * e;
        float x = -INFINITY;
        if (key < n) {
          x = s[r][e] * scale;
          if (bias_kind != 0 && row < n)
            x += load_bias(bias, bias_kind, ((size_t)h * n + row) * (size_t)n + key);
        }
        s[r][e] = x;
        tile_max = fmaxf(tile_max, x);
      }
      // key j0 is always live, so the maximum is finite from the first tile on
      const float m_new = fmaxf(m[r], row_max(tile_max));
      const float alpha = expf(m[r] - m_new);
      m[r] = m_new;
      float part = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[r][e] - m_new);  // exactly 0 for a key past n
        part += p;
        ps[(ty + TY * r) * LDP + tx + 16 * e] = to_f(from_f<T>(p));
      }
      l[r] = l[r] * alpha + part;
#pragma unroll
      for (int cc = 0; cc < DC; ++cc) o[r][cc] *= alpha;
    }
    __syncthreads();

    // O += P V for rows ty + 16 r and this lane's DC columns
#pragma unroll 2
    for (int j = 0; j < BK; j += 4) {
      float pa[RPT][4];
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const float4 t = *reinterpret_cast<const float4*>(ps + (ty + TY * r) * LDP + j);
        pa[r][0] = t.x;
        pa[r][1] = t.y;
        pa[r][2] = t.z;
        pa[r][3] = t.w;
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float vv[DC];
        load_cols<DC>(vs + (j + jj) * LD, tx, vv);
#pragma unroll
        for (int r = 0; r < RPT; ++r)
#pragma unroll
          for (int cc = 0; cc < DC; ++cc) o[r][cc] = fmaf(pa[r][jj], vv[cc], o[r][cc]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const float sum = row_sum(l[r]);
    const float inv = 1.f / sum;
    const int row = q0 + ty + TY * r;
    if (row < n) {
      T* op = out + base + (size_t)row * D;
#pragma unroll
      for (int cc = 0; cc < DC; ++cc) op[col_of<DC>(tx, cc)] = from_f<T>(o[r][cc] * inv);
      // the row's log-sum-exp, for the backward; asked for only when a
      // gradient will be
      if (lse != nullptr && tx == 0) lse[((size_t)b * H + h) * (size_t)n + row] = m[r] + logf(sum);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* bias,
                   int bias_kind, void* out, float* lse, int B, int H, int n, float scale,
                   cudaStream_t stream) {
  const size_t smem = (size_t)(BQ * (D + 4) + 2 * BK * (D + 4) + BQ * LDP) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(global_attention_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  // the image index varies fastest, so blocks that share a bias tile run together
  dim3 grid((unsigned)B, (unsigned)((n + BQ - 1) / BQ), (unsigned)H);
  global_attention_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, bias, bias_kind, (T*)out, lse, H, n, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int D, const void* q, const void* k, const void* v, const void* bias,
                     int bias_kind, void* out, float* lse, int B, int H, int n, float scale,
                     cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, bias, bias_kind, out, lse, B, H, n, scale, stream);
    case 32: return launch<T, 32>(q, k, v, bias, bias_kind, out, lse, B, H, n, scale, stream);
    case 64: return launch<T, 64>(q, k, v, bias, bias_kind, out, lse, B, H, n, scale, stream);
    case 128: return launch<T, 128>(q, k, v, bias, bias_kind, out, lse, B, H, n, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* soccdpt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// q, k, v, out: (B, H, n, D) contiguous, 16-byte aligned, f32 or bf16 (is_bf16);
// bias: (H, n, n) contiguous, NULL (bias_kind 0), f32 (1) or bf16 (2);
// lse: (B, H, n) f32 for each row's log-sum-exp of its scores, or NULL.
int soccdpt_global_attention(const void* q, const void* k, const void* v, const void* bias,
                             void* out, void* lse, int B, int H, int n, int D, int is_bf16,
                             int bias_kind, float scale, void* stream) {
  if (B == 0 || H == 0 || n == 0) return (int)cudaGetLastError();
  if (bias_kind < 0 || bias_kind > 2 || (bias_kind != 0 && bias == nullptr))
    return (int)cudaErrorInvalidValue;
  if (H > 65535 || (n + BQ - 1) / BQ > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = is_bf16
      ? dispatch<__nv_bfloat16>(D, q, k, v, bias, bias_kind, out, (float*)lse, B, H, n, scale, s)
      : dispatch<float>(D, q, k, v, bias, bias_kind, out, (float*)lse, B, H, n, scale, s);
  return (int)err;
}

}  // extern "C"

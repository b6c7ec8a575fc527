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

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
global_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const void* __restrict__ bias,
                        int bias_kind, T* __restrict__ out, int H, int n, float scale) {
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
    const float inv = 1.f / row_sum(l[r]);
    const int row = q0 + ty + TY * r;
    if (row < n) {
      T* op = out + base + (size_t)row * D;
#pragma unroll
      for (int cc = 0; cc < DC; ++cc) op[col_of<DC>(tx, cc)] = from_f<T>(o[r][cc] * inv);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* bias,
                   int bias_kind, void* out, int B, int H, int n, float scale,
                   cudaStream_t stream) {
  const size_t smem = (size_t)(BQ * (D + 4) + 2 * BK * (D + 4) + BQ * LDP) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(global_attention_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  // the image index varies fastest, so blocks that share a bias tile run together
  dim3 grid((unsigned)B, (unsigned)((n + BQ - 1) / BQ), (unsigned)H);
  global_attention_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, bias, bias_kind, (T*)out, H, n, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int D, const void* q, const void* k, const void* v, const void* bias,
                     int bias_kind, void* out, int B, int H, int n, float scale,
                     cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, bias, bias_kind, out, B, H, n, scale, stream);
    case 32: return launch<T, 32>(q, k, v, bias, bias_kind, out, B, H, n, scale, stream);
    case 64: return launch<T, 64>(q, k, v, bias, bias_kind, out, B, H, n, scale, stream);
    case 128: return launch<T, 128>(q, k, v, bias, bias_kind, out, B, H, n, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* soccdpt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// q, k, v, out: (B, H, n, D) contiguous, 16-byte aligned, f32 or bf16 (is_bf16);
// bias: (H, n, n) contiguous, NULL (bias_kind 0), f32 (1) or bf16 (2).
int soccdpt_global_attention(const void* q, const void* k, const void* v, const void* bias,
                             void* out, int B, int H, int n, int D, int is_bf16,
                             int bias_kind, float scale, void* stream) {
  if (B == 0 || H == 0 || n == 0) return (int)cudaGetLastError();
  if (bias_kind < 0 || bias_kind > 2 || (bias_kind != 0 && bias == nullptr))
    return (int)cudaErrorInvalidValue;
  if (H > 65535 || (n + BQ - 1) / BQ > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = is_bf16
      ? dispatch<__nv_bfloat16>(D, q, k, v, bias, bias_kind, out, B, H, n, scale, s)
      : dispatch<float>(D, q, k, v, bias, bias_kind, out, B, H, n, scale, s);
  return (int)err;
}

}  // extern "C"

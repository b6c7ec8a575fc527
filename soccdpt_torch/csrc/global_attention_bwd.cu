// Backward of global (ViT / BEiT) multi-head attention for Hopper (sm_90a).
//
// Replaces the Pallas kernels of soccdpt_tpu/ops/global_attention.py that
// _flash_backward launches (_flash_bwd_kernel for dq, dk, dv and
// _flash_dbias_kernel for dbias). With P = softmax(scale * q k^T + bias[h])
// in f32 and g the cotangent of out = P v, for each image b and head h:
//
//   dP = g v^T        delta = rowsum(dP * P) = rowsum(g * out)
//   dS = P * (dP - delta)
//   dq = scale * dS k     dk = scale * dS^T q     dv = P^T g
//   dbias[h] = sum over b of dS[b, h]
//
// over (B, H, T, D) tensors, bf16 or f32; the bias is f32 or bf16 and is
// read in its own type; dbias is f32. P stays f32 in all five products, as
// in the Pallas kernel; every sum is f32 and is rounded to the input type
// once, when dq, dk and dv are written.
//
// Design (simple and right first, on CUDA cores, no atomics: the result
// does not depend on the order blocks run in).
//
// * The softmax statistics. The TPU kernel holds a whole (256, T) row block
//   of scores in fast memory and takes a plain softmax. Here scores exist
//   one 32 x 64 tile at a time, so each row's log-sum-exp comes from the
//   forward kernel (global_attention.cu writes it when a gradient will be
//   asked for) and P = exp(s - lse) is exact per tile, with no second pass.
// * Who sums what. dq is a sum over keys and belongs to a block of query
//   rows; dk and dv are sums over queries and belong to a block of keys.
//   The TPU kernel keeps dk and dv resident across consecutive grid steps,
//   which a CUDA grid cannot do. So there are two kernels, each recomputing
//   the S and dP tiles it needs (seven tile products for the five of the
//   formulas):
//     - the dq kernel: one block owns (head, 32 query rows) and walks the
//       keys in tiles of 64; it loops over the images inside the block, so
//       it also owns its rows of dbias and sums them over the batch with
//       plain read-add-write by the thread that wrote them (no atomics, no
//       second recompute pass as on the TPU). Its prologue computes delta
//       from g and out and leaves it in device memory for the other kernel.
//     - the dk/dv kernel: one block owns (image, head, 32 keys) and walks
//       the queries in tiles of 64. It computes the transposed tiles
//       S^T = K_own Q_tile^T and dP^T = V_own g_tile^T with the same
//       register tiling, so that its own keys are its rows and dk, dv
//       accumulate in registers as the forward's output does. The price is
//       that its bias reads run down a column (32 consecutive keys of 64
//       rows); the block uses every byte of each sector it touches, so the
//       device-memory traffic is that of one pass.
// * dbias is the traffic. At beitl16_512 one call reads 67 MB of bias twice
//   (once per kernel) and writes 67 MB of dbias against 15 MB for q, k, v,
//   g, dq, dk, dv. dS is written in the pass that needs it for dq.
// * T = 1025 and 577: no padded copies. Last tiles are bounds-checked; a
//   dead key or query row has weight exactly 0; bias and dbias rows are
//   never 16-byte aligned and go by scalar loads and stores, 16 consecutive
//   elements per half-warp.
//
// What bounds it: with a bias, device memory (bias in, dbias out); without,
// the products. On CUDA cores from shared memory it is far from either;
// wgmma and TMA are a later change.

#include "global_attention_common.cuh"

namespace {

// acc[r][e] += sum over c of a[ty + TY r][c] * b[tx + 16 e][c]: rows of one
// staged tile against rows of another, read as float4 along D
template <int D>
__device__ __forceinline__ void rows_dot_rows(const float* __restrict__ a,
                                              const float* __restrict__ b, int ty, int tx,
                                              float (&acc)[RPT][4]) {
  constexpr int LD = D + 4;
#pragma unroll 4
  for (int c = 0; c < D; c += 4) {
    float4 bv[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      bv[e] = *reinterpret_cast<const float4*>(b + (tx + 16 * e) * LD + c);
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const float4 av = *reinterpret_cast<const float4*>(a + (ty + TY * r) * LD + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[r][e] = fmaf(av.x, bv[e].x, acc[r][e]);
        acc[r][e] = fmaf(av.y, bv[e].y, acc[r][e]);
        acc[r][e] = fmaf(av.z, bv[e].z, acc[r][e]);
        acc[r][e] = fmaf(av.w, bv[e].w, acc[r][e]);
      }
    }
  }
}

// o[r][cc] += sum over j < BK of w[ty + TY r][j] * rows[j][column cc of lane tx]
template <int D>
__device__ __forceinline__ void tile_times_rows(const float* __restrict__ w,
                                                const float* __restrict__ rows, int ty, int tx,
                                                float (&o)[RPT][D / 16]) {
  constexpr int LD = D + 4;
  constexpr int DC = D / 16;
#pragma unroll 2
  for (int j = 0; j < BK; j += 4) {
    float wa[RPT][4];
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const float4 t = *reinterpret_cast<const float4*>(w + (ty + TY * r) * LDP + j);
      wa[r][0] = t.x;
      wa[r][1] = t.y;
      wa[r][2] = t.z;
      wa[r][3] = t.w;
    }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      float vv[DC];
      load_cols<DC>(rows + (j + jj) * LD, tx, vv);
#pragma unroll
      for (int r = 0; r < RPT; ++r)
#pragma unroll
        for (int cc = 0; cc < DC; ++cc) o[r][cc] = fmaf(wa[r][jj], vv[cc], o[r][cc]);
    }
  }
}

template <int N> __device__ __forceinline__ void zero_tile(float (&t)[RPT][N]) {
#pragma unroll
  for (int r = 0; r < RPT; ++r)
#pragma unroll
    for (int e = 0; e < N; ++e) t[r][e] = 0.f;
}

// dq, dbias and delta: one block per (head, BQ query rows), all images.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
global_attention_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                               const T* __restrict__ v, const T* __restrict__ g,
                               const T* __restrict__ out, const void* __restrict__ bias,
                               int bias_kind, const float* __restrict__ lse,
                               float* __restrict__ delta, T* __restrict__ dq,
                               float* __restrict__ dbias, int B, int H, int n, float scale) {
  constexpr int LD = D + 4;
  constexpr int DC = D / 16;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;           // BQ x LD: out rows for delta, then Q
  float* gs = qs + BQ * LD;   // BQ x LD
  float* ks = gs + BQ * LD;   // BK x LD
  float* vs = ks + BK * LD;   // BK x LD
  float* ps = vs + BK * LD;   // BQ x LDP: the dS tile

  const int h = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  for (int b = 0; b < B; ++b) {
    const size_t stat = ((size_t)b * H + h) * (size_t)n;  // into lse and delta
    const size_t base = stat * D;
    __syncthreads();  // the last image's readers are done
    stage_rows<T, D, BQ>(g + base + (size_t)q0 * D, n - q0, gs);
    stage_rows<T, D, BQ>(out + base + (size_t)q0 * D, n - q0, qs);
    __syncthreads();

    float dl[RPT], ls[RPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int lr = ty + TY * r;
      float part = 0.f;
#pragma unroll
      for (int cc = 0; cc < DC; ++cc) {
        const int c = col_of<DC>(tx, cc);
        part = fmaf(gs[lr * LD + c], qs[lr * LD + c], part);
      }
      dl[r] = row_sum(part);
      const int row = q0 + lr;
      ls[r] = row < n ? lse[stat + row] : 0.f;
      if (row < n && tx == 0) delta[stat + row] = dl[r];
    }
    __syncthreads();  // out rows are read; Q takes their place
    stage_rows<T, D, BQ>(q + base + (size_t)q0 * D, n - q0, qs);

    float acc[RPT][DC];
    zero_tile<DC>(acc);

    for (int j0 = 0; j0 < n; j0 += BK) {
      __syncthreads();  // the last tile's readers are done; Q is staged
      stage_rows<T, D, BK>(k + base + (size_t)j0 * D, n - j0, ks);
      stage_rows<T, D, BK>(v + base + (size_t)j0 * D, n - j0, vs);
      __syncthreads();

      float s[RPT][4], dp[RPT][4];
      zero_tile<4>(s);
      zero_tile<4>(dp);
      rows_dot_rows<D>(qs, ks, ty, tx, s);
      rows_dot_rows<D>(gs, vs, ty, tx, dp);

#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const int row = q0 + ty + TY * r;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = j0 + tx + 16 * e;
          float ds = 0.f;  // a dead row or key has weight 0
          if (row < n && key < n) {
            const size_t at = ((size_t)h * n + row) * (size_t)n + key;
            float x = s[r][e] * scale;
            if (bias_kind != 0) x += load_bias(bias, bias_kind, at);
            ds = expf(x - ls[r]) * (dp[r][e] - dl[r]);
            // this thread owns the element for every image: no atomics
            if (dbias != nullptr) dbias[at] = b == 0 ? ds : dbias[at] + ds;
          }
          ps[(ty + TY * r) * LDP + tx + 16 * e] = ds;
        }
      }
      __syncthreads();
      tile_times_rows<D>(ps, ks, ty, tx, acc);
    }

#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int row = q0 + ty + TY * r;
      if (row < n) {
        T* op = dq + base + (size_t)row * D;
#pragma unroll
        for (int cc = 0; cc < DC; ++cc) op[col_of<DC>(tx, cc)] = from_f<T>(acc[r][cc] * scale);
      }
    }
  }
}

// dk and dv: one block per (image, head, BQ keys), walking the queries.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
global_attention_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                const T* __restrict__ v, const T* __restrict__ g,
                                const void* __restrict__ bias, int bias_kind,
                                const float* __restrict__ lse, const float* __restrict__ delta,
                                T* __restrict__ dk, T* __restrict__ dv, int H, int n,
                                float scale) {
  constexpr int LD = D + 4;
  constexpr int DC = D / 16;
  extern __shared__ __align__(16) float smem[];
  float* ko = smem;           // BQ x LD: this block's keys
  float* vo = ko + BQ * LD;   // BQ x LD: and their values
  float* qt = vo + BQ * LD;   // BK x LD: a tile of queries
  float* gt = qt + BK * LD;   // BK x LD: and their cotangents
  float* pt = gt + BK * LD;   // BQ x LDP: P^T
  float* dst = pt + BQ * LDP; // BQ x LDP: dS^T

  const int b = blockIdx.x;
  const int h = blockIdx.z;
  const int k0 = blockIdx.y * BQ;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const size_t stat = ((size_t)b * H + h) * (size_t)n;
  const size_t base = stat * D;

  stage_rows<T, D, BQ>(k + base + (size_t)k0 * D, n - k0, ko);
  stage_rows<T, D, BQ>(v + base + (size_t)k0 * D, n - k0, vo);

  float dka[RPT][DC], dva[RPT][DC];
  zero_tile<DC>(dka);
  zero_tile<DC>(dva);

  for (int i0 = 0; i0 < n; i0 += BK) {
    __syncthreads();  // the last tile's readers are done; K and V are staged
    stage_rows<T, D, BK>(q + base + (size_t)i0 * D, n - i0, qt);
    stage_rows<T, D, BK>(g + base + (size_t)i0 * D, n - i0, gt);
    __syncthreads();

    // the transposed tiles: rows are this block's keys, columns the queries
    float st[RPT][4], dpt[RPT][4];
    zero_tile<4>(st);
    zero_tile<4>(dpt);
    rows_dot_rows<D>(ko, qt, ty, tx, st);
    rows_dot_rows<D>(vo, gt, ty, tx, dpt);

    float ls[4], dl[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = i0 + tx + 16 * e;
      ls[e] = row < n ? lse[stat + row] : 0.f;
      dl[e] = row < n ? delta[stat + row] : 0.f;
    }
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int key = k0 + ty + TY * r;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = i0 + tx + 16 * e;
        float p = 0.f, ds = 0.f;  // a dead row or key has weight 0
        if (row < n && key < n) {
          float x = st[r][e] * scale;
          if (bias_kind != 0)
            x += load_bias(bias, bias_kind, ((size_t)h * n + row) * (size_t)n + key);
          p = expf(x - ls[e]);
          ds = p * (dpt[r][e] - dl[e]);
        }
        pt[(ty + TY * r) * LDP + tx + 16 * e] = p;
        dst[(ty + TY * r) * LDP + tx + 16 * e] = ds;
      }
    }
    __syncthreads();
    tile_times_rows<D>(pt, gt, ty, tx, dva);
    tile_times_rows<D>(dst, qt, ty, tx, dka);
  }

#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int key = k0 + ty + TY * r;
    if (key < n) {
      T* kp = dk + base + (size_t)key * D;
      T* vp = dv + base + (size_t)key * D;
#pragma unroll
      for (int cc = 0; cc < DC; ++cc) {
        kp[col_of<DC>(tx, cc)] = from_f<T>(dka[r][cc] * scale);
        vp[col_of<DC>(tx, cc)] = from_f<T>(dva[r][cc]);
      }
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* g, const void* out,
                   const void* bias, int bias_kind, const float* lse, float* delta, void* dq,
                   void* dk, void* dv, float* dbias, int B, int H, int n, float scale,
                   cudaStream_t stream) {
  constexpr int LD = D + 4;
  const unsigned tiles = (unsigned)((n + BQ - 1) / BQ);
  const size_t smem_dq = (size_t)(2 * BQ * LD + 2 * BK * LD + BQ * LDP) * sizeof(float);
  const size_t smem_dkv = (size_t)(2 * BQ * LD + 2 * BK * LD + 2 * BQ * LDP) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(global_attention_bwd_dq_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_dq);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(global_attention_bwd_dkv_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_dkv);
  if (err != cudaSuccess) return err;
  // delta is written by the first kernel and read by the second: stream order
  global_attention_bwd_dq_kernel<T, D><<<dim3(tiles, (unsigned)H), THREADS, smem_dq, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)g, (const T*)out, bias, bias_kind, lse,
      delta, (T*)dq, dbias, B, H, n, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // the image index varies fastest, so blocks that share a bias tile run together
  global_attention_bwd_dkv_kernel<T, D>
      <<<dim3((unsigned)B, tiles, (unsigned)H), THREADS, smem_dkv, stream>>>(
          (const T*)q, (const T*)k, (const T*)v, (const T*)g, bias, bias_kind, lse, delta,
          (T*)dk, (T*)dv, H, n, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int D, const void* q, const void* k, const void* v, const void* g,
                     const void* out, const void* bias, int bias_kind, const float* lse,
                     float* delta, void* dq, void* dk, void* dv, float* dbias, int B, int H,
                     int n, float scale, cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, g, out, bias, bias_kind, lse, delta, dq, dk, dv, dbias, B, H,
                           n, scale, stream);
    case 32:
      return launch<T, 32>(q, k, v, g, out, bias, bias_kind, lse, delta, dq, dk, dv, dbias, B, H,
                           n, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, g, out, bias, bias_kind, lse, delta, dq, dk, dv, dbias, B, H,
                           n, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, g, out, bias, bias_kind, lse, delta, dq, dk, dv, dbias, B,
                            H, n, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* soccdpt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// q, k, v, g, out, dq, dk, dv: (B, H, n, D) contiguous, 16-byte aligned, f32
// or bf16 (is_bf16); bias: (H, n, n) contiguous, NULL (bias_kind 0), f32 (1)
// or bf16 (2); lse: (B, H, n) f32 from the forward; delta: (B, H, n) f32
// scratch; dbias: (H, n, n) f32, or NULL when the bias needs no gradient.
int soccdpt_global_attention_bwd(const void* q, const void* k, const void* v, const void* g,
                                 const void* out, const void* bias, const void* lse,
                                 void* delta, void* dq, void* dk, void* dv, void* dbias, int B,
                                 int H, int n, int D, int is_bf16, int bias_kind, float scale,
                                 void* stream) {
  if (B == 0 || H == 0 || n == 0) return (int)cudaGetLastError();
  if (bias_kind < 0 || bias_kind > 2 || (bias_kind != 0 && bias == nullptr))
    return (int)cudaErrorInvalidValue;
  if (bias_kind == 0 && dbias != nullptr) return (int)cudaErrorInvalidValue;
  if (H > 65535 || (n + BQ - 1) / BQ > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = is_bf16
      ? dispatch<__nv_bfloat16>(D, q, k, v, g, out, bias, bias_kind, (const float*)lse,
                                (float*)delta, dq, dk, dv, (float*)dbias, B, H, n, scale, s)
      : dispatch<float>(D, q, k, v, g, out, bias, bias_kind, (const float*)lse, (float*)delta,
                        dq, dk, dv, (float*)dbias, B, H, n, scale, s);
  return (int)err;
}

}  // extern "C"

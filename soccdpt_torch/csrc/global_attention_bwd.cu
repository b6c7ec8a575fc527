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
// read in its own type; dbias is f32. Every sum is f32 and is rounded to the
// input type once, when dq, dk and dv are written.
//
// Who sums what. dq is a sum over keys and belongs to a CTA of query rows;
// dk and dv are sums over queries and belong to a CTA of keys. The TPU
// kernel keeps dk and dv resident across consecutive grid steps, which a
// CUDA grid cannot do. So there are two kernels, each recomputing the S and
// dP tiles it needs (seven tile products for the five of the formulas), and
// no atomics: the result does not depend on the order CTAs run in, and two
// calls give the same bits. The softmax statistics come from the forward
// (each row's log-sum-exp), so P = exp(s - lse) is exact per tile.
//   - the dq kernel owns (head, query rows) for every image and loops over
//     the images inside the CTA, so it also owns its rows of dbias and sums
//     them over the batch without atomics. Its prologue computes delta from
//     g and out and leaves it in device memory for the other kernel, which
//     runs after it on the same stream.
//   - the dk/dv kernel owns (image, head, keys) and walks the queries. It
//     computes the transposed tiles S^T = K q^T and dP^T = V g^T, so that
//     its own keys are the rows of the sums and dk, dv accumulate as the
//     forward's output does; its bias reads run down a column (a quad reads
//     8 consecutive keys of one query row), every byte of each sector used.
//
// Two routes, by dtype.
//
// bf16: the tensor cores (global_attention_bwd_dq_wgmma and
// global_attention_bwd_dkv_wgmma below, with attention_wgmma.cuh). Each CTA
// has consumer warpgroups of 64 rows (one in the dq kernel, two in the
// dk/dv kernel) and one producer warp that loads their own rows once by
// TMA and keeps a ring of the other side's tiles full (32 keys of K and V
// for the dq kernel; 32 queries of q and g, with their lse and delta, for
// the dk/dv kernel). All five products run on wgmma: S and dP with both
// operands K-major from shared memory; dq += dS K, dV += P^T g and dK +=
// dS^T q with the weights rounded to bf16 straight from the sums'
// registers as the A operand and K, g, q as MN-major B. At batch 2 the dq
// kernel holds both images' dq in registers, so each bias tile is read
// once and each dbias tile written once for the pair, through a tile in
// shared memory so that a warp stores whole rows. The bias is loaded into
// the sums' layout a tile ahead of its use.
//
// f32: CUDA cores (the two kernels below the helpers), kept for the f32
// bound (3e-5), which needs f32 products: one block of 128 threads owns
// 32 query rows (dq) or 32 keys (dk/dv) and walks the other side in tiles
// of 64 with 4 x 4 register tiles from shared memory; P stays f32 in all
// five products, as in the Pallas kernel.
//
// T = 1025 and 577: no padded copies. Last tiles are masked; a dead key or
// query row has weight exactly 0; bias and dbias rows are never 16-byte
// aligned and go by scalar loads and stores.
//
// What bounds it: with a bias, device memory: at beitl16_512 one call reads
// 67 MB of f32 bias (once in each kernel) and writes 67 MB of dbias against
// 15 MB for q, k, v, g, dq, dk, dv. Without a bias, the products.

#include "attention_wgmma.cuh"
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

// --- the bf16 route: wgmma fed by TMA ------------------------------------------

namespace wgattn {

constexpr int BWD_STAGES = 2;  // key (or query) tiles in flight: one loads while one is multiplied
constexpr int STATS_BYTES = 1024;  // lse and delta of a query tile, room kept to the swizzle atom

// Keys a tile of the dq kernel and queries a tile of the dk/dv kernel: 32.
// Measured on the card (PERF.md §6): dq tiles of 64 and of 16 were
// slower; a dk/dv CTA of two warpgroups fits its 168 registers a thread
// only at 32 queries (at 64 it spilled), and beat one warpgroup with tiles
// of 64, and tiles of 16. kernels/global_attention.py restates these.
constexpr int DQ_KT = 32, DKV_QT = 32, DKV_NWG = 2;

// Q and g of IMG images (64 rows each), the ring of K and V tiles of IMG
// images, two dbias tiles (64 rows of KT + 1 floats), barriers (qg_full,
// qg_empty, full[STAGES], empty[STAGES])
__host__ __device__ constexpr int dq_smem_bytes(int D, int img) {
  return 1024 + (img * 2 * 64 + BWD_STAGES * img * 2 * DQ_KT) * padded(D) * 2 +
         2 * 64 * (DQ_KT + 1) * 4 + (2 + 2 * BWD_STAGES) * 8;
}
// this CTA's K and V (64 rows a warpgroup each), the ring of q and g tiles
// with their rows' statistics, barriers (kv_full, full[STAGES], empty[STAGES])
__host__ __device__ constexpr int dkv_smem_bytes(int D) {
  return 1024 + 2 * DKV_NWG * 64 * padded(D) * 2 +
         BWD_STAGES * (2 * DKV_QT * padded(D) * 2 + STATS_BYTES) + (1 + 2 * BWD_STAGES) * 8;
}

struct BwdParams {
  const void* bias;  // (H, T, T) f32 or bf16, or null
  const __nv_bfloat16* g;    // (B, H, T, D) contiguous: the output's cotangent
  const __nv_bfloat16* out;  // (B, H, T, D) contiguous: the forward's output
  const float* lse;          // (B, H, T) from the forward
  float* delta;              // (B, H, T): written by the dq kernel, read by the dk/dv kernel
  __nv_bfloat16 *dq, *dk, *dv;  // (B, H, T, D) contiguous
  float* dbias;                 // (H, T, T), or null
  int bias_kind, B, H, T;
  float scale, scale_log2;
};

// dq, dbias and delta. One CTA: one consumer warpgroup owns 64 query rows
// of one head for every image, IMG images at a time, and one producer warp
// whose lane 0 loads their Q and g rows and keeps a ring of their K and V
// tiles full. Per key tile and image: S = Q K^T and dP = g V^T (A and B
// K-major), dS = P (dP - delta) in registers, dq += dS K (dS as bf16
// fragments, K as an MN-major B). The dS of the IMG images are summed in
// registers and written to dbias once, through a tile in shared memory so
// that each warp stores whole rows; a later group of images (B > IMG) adds
// to what the same thread wrote.
template <int D, int IMG>
__global__ void __launch_bounds__(128 + PRODUCER_THREADS, 2)
    global_attention_bwd_dq_wgmma(const __grid_constant__ CUtensorMap qmap,
                                  const __grid_constant__ CUtensorMap kmap,
                                  const __grid_constant__ CUtensorMap vmap,
                                  const __grid_constant__ CUtensorMap gmap, const BwdParams p) {
  constexpr int DP = padded(D), KT = DQ_KT, STAGES = BWD_STAGES;
  constexpr int TILE = 64 * DP * 2, KV_TILE = KT * DP * 2, STAGE_BYTES = IMG * 2 * KV_TILE;

  extern __shared__ unsigned char smem_raw_dq[];
  const uint32_t raw = smem_u32(smem_raw_dq);
  const uint32_t qg = (raw + 1023u) & ~1023u;  // image i: Q at qg + 2 i TILE, g after it
  const uint32_t ring = qg + IMG * 2 * TILE;    // stage s, image i: K, then V
  const uint32_t dbias_tiles = ring + STAGES * STAGE_BYTES;  // two of 64 x (KT + 1) floats
  const uint32_t qg_full = dbias_tiles + 2 * 64 * (KT + 1) * 4, qg_empty = qg_full + 8;
  const uint32_t full = qg_empty + 8, empty = full + 8 * STAGES;  // + 8 s
  const int tid = threadIdx.x, T = p.T, H = p.H;
  const int q0 = blockIdx.x * 64, h = blockIdx.y;
  const int ntiles = (T + KT - 1) / KT;

  if (tid == 0) {
    mbar_init(qg_full, 1);
    mbar_init(qg_empty, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 1);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid >= 128) {
    if (tid == 128) {
      prefetch_map(&qmap);
      prefetch_map(&kmap);
      prefetch_map(&vmap);
      prefetch_map(&gmap);
      int s = 0;
      uint32_t ph = 0, gph = 0;
      for (int g0 = 0; g0 < p.B; g0 += IMG, gph ^= 1) {
        const int nb = min(IMG, p.B - g0);
        mbar_wait(qg_empty, gph ^ 1);
        mbar_expect_tx(qg_full, nb * 2 * TILE);
        for (int i = 0; i < nb; ++i) {
          load_rows<DP>(qg + 2 * i * TILE, &qmap, qg_full, 64, q0, h, g0 + i);
          load_rows<DP>(qg + 2 * i * TILE + TILE, &gmap, qg_full, 64, q0, h, g0 + i);
        }
        for (int j = 0; j < ntiles; ++j) {
          mbar_wait(empty + 8 * s, ph ^ 1);
          const uint32_t st = ring + s * STAGE_BYTES;
          mbar_expect_tx(full + 8 * s, nb * 2 * KV_TILE);
          for (int i = 0; i < nb; ++i) {
            load_rows<DP>(st + 2 * i * KV_TILE, &kmap, full + 8 * s, KT, j * KT, h, g0 + i);
            load_rows<DP>(st + (2 * i + 1) * KV_TILE, &vmap, full + 8 * s, KT, j * KT, h, g0 + i);
          }
          if (++s == STAGES) {
            s = 0;
            ph ^= 1;
          }
        }
      }
    }
    return;
  }

  // this thread's rows: `row` and `row` + 8 (trow in the CTA's tile)
  const int warp = tid / 32, lane = tid % 32;
  const int trow = warp * 16 + lane / 4, row = q0 + trow;
  float bb[KT / 2];
  bias_fragment<KT, false>(bb, p.bias, p.bias_kind, h, T, row, 0, lane);
  int s = 0;
  uint32_t ph = 0, gph = 0;
  for (int g0 = 0; g0 < p.B; g0 += IMG, gph ^= 1) {
    const int nb = min(IMG, p.B - g0);

    // delta = rowsum(g * out) (a quarter row a lane, summed over the quad)
    // and the rows' log-sum-exp in log2 units
    float dl[IMG][2], ls[IMG][2];
#pragma unroll
    for (int i = 0; i < IMG; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = row + 8 * hh;
        const size_t at = ((size_t)(g0 + i) * H + h) * T + r;
        float part = 0.f;
        if (i < nb && r < T) {
          const __nv_bfloat162* gr = reinterpret_cast<const __nv_bfloat162*>(p.g + at * D);
          const __nv_bfloat162* orow = reinterpret_cast<const __nv_bfloat162*>(p.out + at * D);
#pragma unroll
          for (int c = 0; c < D / 8; ++c) {
            const int at2 = (lane % 4) * (D / 8) + c;
            const float2 x = __bfloat1622float2(gr[at2]), y = __bfloat1622float2(orow[at2]);
            part = fmaf(x.x, y.x, fmaf(x.y, y.y, part));
          }
        }
        dl[i][hh] = quad_sum(part);
        ls[i][hh] = (i < nb && r < T) ? p.lse[at] * LOG2E : 0.f;
        if (i < nb && r < T && lane % 4 == 0) p.delta[at] = dl[i][hh];
      }

    float dq[IMG][DP / 2];
#pragma unroll
    for (int i = 0; i < IMG; ++i)
#pragma unroll
      for (int e = 0; e < DP / 2; ++e) dq[i][e] = 0.f;
    mbar_wait(qg_full, gph);

    for (int j = 0; j < ntiles; ++j) {
      mbar_wait(full + 8 * s, ph);
      const uint32_t st = ring + s * STAGE_BYTES;
      float dbs[KT / 2];
#pragma unroll
      for (int i = 0; i < IMG; ++i) {
        if (i >= nb) break;
        const uint32_t qa = qg + 2 * i * TILE, ga = qa + TILE;
        const uint32_t kt = st + 2 * i * KV_TILE, vt = kt + KV_TILE;
        float sc[KT / 2], dp[KT / 2];
#pragma unroll
        for (int e = 0; e < KT / 2; ++e) sc[e] = dp[e] = 0.f;
        fence_sums(sc);
        fence_sums(dp);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          Wgmma<KT>::template ss<0>(sc, kmajor<64>(qa, kk), kmajor<KT>(kt, kk));
          Wgmma<KT>::template ss<0>(dp, kmajor<64>(ga, kk), kmajor<KT>(vt, kk));
        }
        wgmma_commit();
        fence_sums(sc);
        fence_sums(dp);
        wgmma_wait<0>();
        fence_sums(sc);
        fence_sums(dp);

        // P from the forward's log-sum-exp; a dead row or key weighs 0
#pragma unroll
        for (int e = 0; e < KT / 2; ++e) {
          const int hh = (e & 2) ? 1 : 0;
          const bool live = row + 8 * hh < T && j * KT + frag_col(e, lane) < T;
          const float pr =
              live ? exp2f(fmaf(sc[e], p.scale_log2, fmaf(bb[e], LOG2E, -ls[i][hh]))) : 0.f;
          const float ds = pr * (dp[e] - dl[i][hh]);
          dbs[e] = i == 0 ? ds : dbs[e] + ds;
          dp[e] = ds;
        }
        if (i == nb - 1 && (j + 1 < ntiles || g0 + IMG < p.B))
          bias_fragment<KT, false>(bb, p.bias, p.bias_kind, h, T, row,
                                   j + 1 < ntiles ? (j + 1) * KT : 0, lane);

        // dq += dS K: dS rounded to bf16 as the A operand, K rows MN-major
        uint32_t fa[KT / 16][4];
        to_fragments<KT>(dp, fa);
        fence_regs(fa);
        fence_sums(dq[i]);
        wgmma_fence();
#pragma unroll
        for (int t = 0; t < KT / 16; ++t) Wgmma<DP>::rs(dq[i], fa[t], mnmajor<KT>(kt, t));
        wgmma_commit();
        fence_sums(dq[i]);
        wgmma_wait<0>();
        fence_sums(dq[i]);
      }
      if (tid == 0) mbar_arrive(empty + 8 * s);
      if (++s == STAGES) {
        s = 0;
        ph ^= 1;
      }

      // dbias from the f32 dS, summed over the images: the sums go to one
      // of two tiles in shared memory (the other may still be read), then
      // each warp stores 16 whole rows of it. The same thread owns the same
      // elements for every group of images: no atomics
      if (p.dbias != nullptr) {
        constexpr int PITCH = KT + 1;
        float* tile = reinterpret_cast<float*>(smem_raw_dq + (dbias_tiles - raw)) +
                      (j & 1) * 64 * PITCH;
#pragma unroll
        for (int e = 0; e < KT / 2; ++e)
          tile[(trow + frag_row(e)) * PITCH + frag_col(e, lane)] = dbs[e];
        named_sync(1, 128);
        for (int r = warp * 16; r < warp * 16 + 16 && q0 + r < T; ++r) {
          float* out_row = p.dbias + ((size_t)h * T + q0 + r) * T + j * KT;
#pragma unroll
          for (int c = lane; c < KT; c += 32)
            if (j * KT + c < T)
              out_row[c] = g0 == 0 ? tile[r * PITCH + c] : out_row[c] + tile[r * PITCH + c];
        }
      }
    }
    if (tid == 0) mbar_arrive(qg_empty);
#pragma unroll
    for (int i = 0; i < IMG; ++i)
      if (i < nb)
        store_rows<D, DP>(p.dq + ((size_t)(g0 + i) * H + h) * T * D, dq[i], row, T, lane,
                          p.scale, p.scale);
  }
}

// dk and dv. One CTA: two consumer warpgroups own 64 keys each of one
// (image, head) and walk the queries in tiles of 32; one producer warp loads this
// CTA's K and V rows once and keeps a ring of q and g tiles full, its lanes
// writing each tile's lse and delta beside it. The products are transposed,
// so that the CTA's keys are the rows of the sums: S^T = K q^T, dP^T = V
// g^T (A and B K-major), then dV += P^T g and dK += dS^T q (P^T and dS^T as
// bf16 fragments, q and g as MN-major B). The bias under S^T is read down
// its columns: a quad's loads cover 8 consecutive keys of one query row.
template <int D>
__global__ void __launch_bounds__(DKV_NWG * 128 + PRODUCER_THREADS, 1)
    global_attention_bwd_dkv_wgmma(const __grid_constant__ CUtensorMap qmap,
                                   const __grid_constant__ CUtensorMap kmap,
                                   const __grid_constant__ CUtensorMap vmap,
                                   const __grid_constant__ CUtensorMap gmap, const BwdParams p) {
  constexpr int DP = padded(D), QT = DKV_QT, STAGES = BWD_STAGES, NWG = DKV_NWG;
  constexpr int OWN = NWG * 64 * DP * 2, Q_TILE = QT * DP * 2, CONSUMERS = NWG * 128;
  constexpr int STAGE_BYTES = 2 * Q_TILE + STATS_BYTES;
  static_assert(2 * QT * 4 <= STATS_BYTES, "a tile's statistics fit their room");

  extern __shared__ unsigned char smem_raw_dkv[];
  const uint32_t raw = smem_u32(smem_raw_dkv);
  const uint32_t kown = (raw + 1023u) & ~1023u, vown = kown + OWN;
  const uint32_t ring = vown + OWN;  // stage s: q, g, then lse and delta (f32, log2 units for lse)
  const uint32_t kv_full = ring + STAGES * STAGE_BYTES;
  const uint32_t full = kv_full + 8, empty = full + 8 * STAGES;  // + 8 s
  const int tid = threadIdx.x, T = p.T;
  const int b = blockIdx.x, k0 = blockIdx.y * NWG * 64, h = blockIdx.z;
  const size_t bh = (size_t)b * p.H + h;
  const int ntiles = (T + QT - 1) / QT;

  if (tid == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1 + PRODUCER_THREADS);  // the expect_tx, then every lane's stores
      mbar_init(empty + 8 * s, NWG);                  // one arrival a warpgroup
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    const int lane = tid - CONSUMERS;
    if (lane == 0) {
      prefetch_map(&qmap);
      prefetch_map(&kmap);
      prefetch_map(&vmap);
      prefetch_map(&gmap);
      mbar_expect_tx(kv_full, 2 * OWN);
      load_rows<DP>(kown, &kmap, kv_full, NWG * 64, k0, h, b);
      load_rows<DP>(vown, &vmap, kv_full, NWG * 64, k0, h, b);
    }
    int s = 0;
    uint32_t ph = 0;
    for (int i = 0; i < ntiles; ++i) {
      mbar_wait(empty + 8 * s, ph ^ 1);
      const uint32_t st = ring + s * STAGE_BYTES;
      if (lane == 0) {
        mbar_expect_tx(full + 8 * s, 2 * Q_TILE);
        load_rows<DP>(st, &qmap, full + 8 * s, QT, i * QT, h, b);
        load_rows<DP>(st + Q_TILE, &gmap, full + 8 * s, QT, i * QT, h, b);
      }
      float* stats = reinterpret_cast<float*>(smem_raw_dkv + (st + 2 * Q_TILE - raw));
      for (int c = lane; c < QT; c += PRODUCER_THREADS) {
        const int qi = i * QT + c;
        stats[c] = qi < T ? p.lse[bh * T + qi] * LOG2E : 0.f;
        stats[QT + c] = qi < T ? p.delta[bh * T + qi] : 0.f;
      }
      mbar_arrive(full + 8 * s);
      if (++s == STAGES) {
        s = 0;
        ph ^= 1;
      }
    }
    return;
  }

  // warpgroup wg owns keys k0 + 64 wg .. + 63; this thread `key` and `key` + 8
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int key = k0 + wg * 64 + warp * 16 + lane / 4;
  const uint32_t ka = kown + wg * 64 * ROW_BYTES, va = vown + wg * 64 * ROW_BYTES;
  float dk[DP / 2], dv[DP / 2];
#pragma unroll
  for (int e = 0; e < DP / 2; ++e) dk[e] = dv[e] = 0.f;
  float bb[QT / 2];
  bias_fragment<QT, true>(bb, p.bias, p.bias_kind, h, T, key, 0, lane);
  mbar_wait(kv_full, 0);

  int s = 0;
  uint32_t ph = 0;
  for (int i = 0; i < ntiles; ++i) {
    mbar_wait(full + 8 * s, ph);
    const uint32_t qt = ring + s * STAGE_BYTES, gt = qt + Q_TILE;
    const float* stats = reinterpret_cast<const float*>(smem_raw_dkv + (qt + 2 * Q_TILE - raw));
    float sc[QT / 2], dp[QT / 2];
#pragma unroll
    for (int e = 0; e < QT / 2; ++e) sc[e] = dp[e] = 0.f;
    fence_sums(sc);
    fence_sums(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      Wgmma<QT>::template ss<0>(sc, kmajor<NWG * 64>(ka, kk), kmajor<QT>(qt, kk));
      Wgmma<QT>::template ss<0>(dp, kmajor<NWG * 64>(va, kk), kmajor<QT>(gt, kk));
    }
    wgmma_commit();
    fence_sums(sc);
    fence_sums(dp);
    wgmma_wait<0>();
    fence_sums(sc);
    fence_sums(dp);

#pragma unroll
    for (int e = 0; e < QT / 2; ++e) {
      const bool live = key + frag_row(e) < T && i * QT + frag_col(e, lane) < T;
      sc[e] = live ? exp2f(fmaf(sc[e], p.scale_log2, fmaf(bb[e], LOG2E, -stats[frag_col(e, lane)])))
                   : 0.f;
    }
    if (i + 1 < ntiles) bias_fragment<QT, true>(bb, p.bias, p.bias_kind, h, T, key, (i + 1) * QT, lane);

    // dV += P^T g (P^T rounded to bf16 as the A operand) runs while dS^T is
    // computed; then dK += dS^T q
    uint32_t pa[QT / 16][4], sa[QT / 16][4];
    to_fragments<QT>(sc, pa);
    fence_regs(pa);
    fence_sums(dv);
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < QT / 16; ++t) Wgmma<DP>::rs(dv, pa[t], mnmajor<QT>(gt, t));
    wgmma_commit();
#pragma unroll
    for (int e = 0; e < QT / 2; ++e) dp[e] = sc[e] * (dp[e] - stats[QT + frag_col(e, lane)]);
    to_fragments<QT>(dp, sa);
    fence_regs(sa);
    fence_sums(dk);
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < QT / 16; ++t) Wgmma<DP>::rs(dk, sa[t], mnmajor<QT>(qt, t));
    wgmma_commit();
    fence_sums(dv);
    fence_sums(dk);
    wgmma_wait<0>();
    fence_sums(dv);
    fence_sums(dk);
    if (tid % 128 == 0) mbar_arrive(empty + 8 * s);
    if (++s == STAGES) {
      s = 0;
      ph ^= 1;
    }
  }
  store_rows<D, DP>(p.dk + bh * T * D, dk, key, T, lane, p.scale, p.scale);
  store_rows<D, DP>(p.dv + bh * T * D, dv, key, T, lane, 1.f, 1.f);
}

template <int D, int IMG>
int launch_dq(const long long* geom, const void* q, const void* k, const void* v, const void* g,
              const BwdParams& p, cudaStream_t stream) {
  constexpr int KT = DQ_KT, smem = dq_smem_bytes(D, IMG);
  static_assert(smem <= MAX_SMEM_BYTES, "the tiles and rings must fit a block's shared memory");
  // q and g in boxes of 64 rows, k and v of KT
  CUtensorMap qm, km, vm, gm;
  int err = make_map(&qm, q, geom, 64);
  if (!err) err = make_map(&km, k, geom + GEOM, KT);
  if (!err) err = make_map(&vm, v, geom + 2 * GEOM, KT);
  if (!err) err = make_map(&gm, g, geom + 3 * GEOM, 64);
  if (err) return err;
  cudaError_t e = cudaFuncSetAttribute(global_attention_bwd_dq_wgmma<D, IMG>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  global_attention_bwd_dq_wgmma<D, IMG>
      <<<dim3((unsigned)((p.T + 63) / 64), (unsigned)p.H), 128 + PRODUCER_THREADS, smem, stream>>>(
          qm, km, vm, gm, p);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const long long* geom, const void* q, const void* k, const void* v, const void* g,
               const BwdParams& p, cudaStream_t stream) {
  constexpr int smem = dkv_smem_bytes(D);
  static_assert(smem <= MAX_SMEM_BYTES, "the tiles and rings must fit a block's shared memory");
  // k and v in boxes of 128 rows (two warpgroups' keys), q and g of 32
  CUtensorMap qm, km, vm, gm;
  int err = make_map(&qm, q, geom, DKV_QT);
  if (!err) err = make_map(&km, k, geom + GEOM, DKV_NWG * 64);
  if (!err) err = make_map(&vm, v, geom + 2 * GEOM, DKV_NWG * 64);
  if (!err) err = make_map(&gm, g, geom + 3 * GEOM, DKV_QT);
  if (err) return err;
  cudaError_t e = cudaFuncSetAttribute(global_attention_bwd_dkv_wgmma<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  // the image index varies fastest, so CTAs that share a bias tile run together
  const dim3 grid((unsigned)p.B, (unsigned)((p.T + DKV_NWG * 64 - 1) / (DKV_NWG * 64)),
                  (unsigned)p.H);
  global_attention_bwd_dkv_wgmma<D>
      <<<grid, DKV_NWG * 128 + PRODUCER_THREADS, smem, stream>>>(qm, km, vm, gm, p);
  return (int)cudaGetLastError();
}

// delta is written by the dq kernel and read by the dk/dv kernel: stream order
template <int D>
int launch_bwd(int img, const long long* geom, const void* q, const void* k, const void* v,
               const void* g, const BwdParams& p, cudaStream_t stream) {
  int err = (int)cudaErrorInvalidValue;
  if (img == 1) err = launch_dq<D, 1>(geom, q, k, v, g, p, stream);
  if constexpr (D <= 64) {
    if (img == 2) err = launch_dq<D, 2>(geom, q, k, v, g, p, stream);
  }
  return err ? err : launch_dkv<D>(geom, q, k, v, g, p, stream);
}

}  // namespace wgattn

extern "C" {

const char* soccdpt_error_string(int code) { return hopper::error_string(code); }

// The f32 route, on CUDA cores: q, k, v, g, out, dq, dk, dv (B, H, n, D)
// f32 contiguous, 16-byte aligned; bias: (H, n, n) contiguous, NULL
// (bias_kind 0), f32 (1) or bf16 (2); lse: (B, H, n) f32 from the forward;
// delta: (B, H, n) f32 scratch; dbias: (H, n, n) f32, or NULL when the bias
// needs no gradient.
int soccdpt_global_attention_bwd_f32(const void* q, const void* k, const void* v, const void* g,
                                     const void* out, const void* bias, const void* lse,
                                     void* delta, void* dq, void* dk, void* dv, void* dbias,
                                     int B, int H, int n, int D, int bias_kind, float scale,
                                     void* stream) {
  if (B == 0 || H == 0 || n == 0) return (int)cudaGetLastError();
  if (bias_kind < 0 || bias_kind > 2 || (bias_kind != 0 && bias == nullptr))
    return (int)cudaErrorInvalidValue;
  if (bias_kind == 0 && dbias != nullptr) return (int)cudaErrorInvalidValue;
  if (H > 65535 || (n + BQ - 1) / BQ > 65535) return (int)cudaErrorInvalidValue;
  return (int)dispatch<float>(D, q, k, v, g, out, bias, bias_kind, (const float*)lse,
                              (float*)delta, dq, dk, dv, (float*)dbias, B, H, n, scale,
                              (cudaStream_t)stream);
}

// The bf16 route: q, k, v, g bf16 views (B, H, n, D) read through tensor
// maps of geometry geom[7 i .. 7 i + 6] (dims D, n, H, B; byte strides of
// n, H, B) for q, k, v, g in turn, each base and stride a multiple of 16
// bytes; g and out (B, H, n, D) bf16 contiguous as well (the dq kernel
// reads both rows for delta); dq, dk, dv (B, H, n, D) bf16 contiguous;
// bias, lse, delta, dbias as above; img: images whose dq the dq kernel
// holds at once, 1 or 2 (2 only for D <= 64).
int soccdpt_global_attention_bwd_bf16(const void* q, const void* k, const void* v, const void* g,
                                      const long long* geom, const void* out, const void* bias,
                                      const void* lse, void* delta, void* dq, void* dk, void* dv,
                                      void* dbias, int B, int H, int n, int D, int bias_kind,
                                      float scale, int img, void* stream) {
  if (B == 0 || H == 0 || n == 0) return (int)cudaGetLastError();
  if (bias_kind < 0 || bias_kind > 2 || (bias_kind != 0 && bias == nullptr))
    return (int)cudaErrorInvalidValue;
  if (bias_kind == 0 && dbias != nullptr) return (int)cudaErrorInvalidValue;
  if (B > 65535 || H > 65535 || (n + 63) / 64 > 65535) return (int)cudaErrorInvalidValue;
  wgattn::BwdParams p;
  p.bias = bias;
  p.g = (const __nv_bfloat16*)g;
  p.out = (const __nv_bfloat16*)out;
  p.lse = (const float*)lse;
  p.delta = (float*)delta;
  p.dq = (__nv_bfloat16*)dq;
  p.dk = (__nv_bfloat16*)dk;
  p.dv = (__nv_bfloat16*)dv;
  p.dbias = (float*)dbias;
  p.bias_kind = bias_kind;
  p.B = B;
  p.H = H;
  p.T = n;
  p.scale = scale;
  p.scale_log2 = scale * wgattn::LOG2E;
  cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 16: return wgattn::launch_bwd<16>(img, geom, q, k, v, g, p, s);
    case 32: return wgattn::launch_bwd<32>(img, geom, q, k, v, g, p, s);
    case 64: return wgattn::launch_bwd<64>(img, geom, q, k, v, g, p, s);
    case 128: return wgattn::launch_bwd<128>(img, geom, q, k, v, g, p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"

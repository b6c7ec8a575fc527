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
// Two routes, by dtype.
//
// bf16: the tensor cores (global_attention_kernel_wgmma below, with
// attention_wgmma.cuh and wgmma_common.cuh). A CTA owns 64 or 128 query
// rows of one (image, head): one consumer warpgroup per 64 rows and one
// producer warp whose lane 0 loads Q once by TMA and keeps a ring of three
// stages of K and V tiles (64 keys each) full. Per key tile each warpgroup
//   1. runs S = Q K^T on wgmma (A = Q and B = K rows, both K-major, with
//      the 128-byte swizzle the TMA boxes land in), f32 sums in registers;
//   2. scales and adds the bias in log2 units, masks keys past T to -inf,
//      and takes the running softmax in registers: a row's maximum crosses
//      the four lanes of a quad by shuffles;
//   3. runs O += P V on wgmma: P rounded to bf16 straight from the sums'
//      registers as the A operand, B = V rows (keys x D, D contiguous: an
//      MN-major B).
// The bias is read from device memory into the sums' layout, a tile ahead
// of its use, so its loads fly during the softmax, P V and the next S.
// D = 16 and 32 run as D = 64 with zero columns (TMA fills them); q, k and
// v are read through 4-D tensor maps of the caller's strides, so the
// strided q, k, v views of one qkv tensor are read in place.
//
// f32: CUDA cores (global_attention_kernel below), kept for the f32 bound
// (2e-5), which needs f32 products. One block of 128 threads (8 rows of 16)
// owns one (image, head, tile of 32 query rows) and walks the keys in
// tiles of 64: K and V staged to shared memory as f32 (rows padded to D+4
// floats), S = Q K^T as 4 x 4 register tiles read as float4 along D, the
// running softmax with the row maximum crossing 16 lanes by shuffles, the
// weights through shared memory, O += P V as a second register tile.
// Measured on the card: 32 rows on 128 threads beat 64 and 32 rows on 256
// threads and 64 rows on 128 threads at every shape tried.
//
// No padded copies in either route: T is taken as it is (1025 or 577 at
// the BEiT/ViT configurations), the last query and key tiles are masked,
// and the bias (rows of T elements, never 16-byte aligned) is read by
// scalar loads in its own type.
//
// What bounds it: with a bias, device memory. At beitl16_512 (T = 1025,
// H = 16, D = 64, bf16) q, k, v and out are 8.4 MB and the f32 bias is
// 67 MB per launch, each bias element needed by one query row per image;
// the grid's fastest index is the image, so at batch > 1 the CTAs that
// share a bias tile run together and the second finds it in L2. Without a
// bias (plain ViT) the products bound it: 4.3 GFLOP at beitl16_512, 1.4
// at vitl16_384, per launch and image.

#include "attention_wgmma.cuh"
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

// --- the bf16 route: wgmma fed by TMA ------------------------------------------

namespace wgattn {

constexpr int FWD_KT = 64;     // keys a tile
constexpr int FWD_STAGES = 3;  // key tiles in flight: two load while one is multiplied

// 1 KB of slack to align the tiles to the swizzle atom, Q (64 rows), the
// ring of K and V tiles, the barriers (q_full, full[STAGES], empty[STAGES])
__host__ __device__ constexpr int fwd_smem_bytes(int D) {
  return 1024 + (64 + FWD_STAGES * 2 * FWD_KT) * padded(D) * 2 + (1 + 2 * FWD_STAGES) * 8;
}

struct FwdParams {
  const void* bias;    // (H, T, T) f32 or bf16, or null
  __nv_bfloat16* out;  // (B, H, T, D) contiguous
  float* lse;          // (B, H, T) f32, or null
  int bias_kind, H, T;
  float scale_log2;  // scale * log2(e): the scores are kept in log2 units
};

// One CTA: a consumer warpgroup of 64 query rows of one (image, head) and a
// producer warp whose lane 0 loads Q once and keeps a ring of K and V
// tiles full; two CTAs an SM. Measured on the card (PERF.md §6): 128
// rows on two warpgroups (one CTA an SM) and three CTAs an SM (128
// registers) were slower at beitl16_512 and vitl16_384; key tiles of 32
// were faster with a bias and slower without one, 16 slower with both.
template <int D>
__global__ void __launch_bounds__(128 + PRODUCER_THREADS, 2)
    global_attention_kernel_wgmma(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
               const __grid_constant__ CUtensorMap vmap, const FwdParams p) {
  constexpr int DP = padded(D), KT = FWD_KT, STAGES = FWD_STAGES, BM = 64;
  constexpr int Q_BYTES = BM * DP * 2, TILE_BYTES = KT * DP * 2, STAGE_BYTES = 2 * TILE_BYTES;
  constexpr int CONSUMERS = 128;

  extern __shared__ unsigned char smem_raw_wg[];
  const uint32_t raw = smem_u32(smem_raw_wg);
  const uint32_t qs = (raw + 1023u) & ~1023u;  // the swizzle atom is 1 KB
  const uint32_t ring = qs + Q_BYTES;
  const uint32_t q_full = ring + STAGES * STAGE_BYTES;
  const uint32_t full = q_full + 8, empty = full + 8 * STAGES;  // + 8 s
  const int tid = threadIdx.x, T = p.T;
  const int b = blockIdx.x, q0 = blockIdx.y * BM, h = blockIdx.z;
  const int ntiles = (T + KT - 1) / KT;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);      // the producer's expect_tx
      mbar_init(empty + 8 * s, 1);    // the consumers' arrival
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    if (tid == CONSUMERS) {
      prefetch_map(&qmap);
      prefetch_map(&kmap);
      prefetch_map(&vmap);
      mbar_expect_tx(q_full, Q_BYTES);
      load_rows<DP>(qs, &qmap, q_full, BM, q0, h, b);
      int s = 0;
      uint32_t ph = 0;
      for (int j = 0; j < ntiles; ++j) {
        mbar_wait(empty + 8 * s, ph ^ 1);
        const uint32_t st = ring + s * STAGE_BYTES;
        mbar_expect_tx(full + 8 * s, STAGE_BYTES);
        load_rows<DP>(st, &kmap, full + 8 * s, KT, j * KT, h, b);
        load_rows<DP>(st + TILE_BYTES, &vmap, full + 8 * s, KT, j * KT, h, b);
        if (++s == STAGES) {
          s = 0;
          ph ^= 1;
        }
      }
    }
    return;
  }

  // this thread's rows: `row` and `row` + 8 (wgmma's accumulator layout)
  const int warp = tid / 32, lane = tid % 32;
  const int row = q0 + warp * 16 + lane / 4;
  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float bb[KT / 2];
  bias_fragment<KT, false>(bb, p.bias, p.bias_kind, h, T, row, 0, lane);
  mbar_wait(q_full, 0);

  int s = 0;
  uint32_t ph = 0;
  for (int j = 0; j < ntiles; ++j) {
    mbar_wait(full + 8 * s, ph);
    const uint32_t kt = ring + s * STAGE_BYTES, vt = kt + TILE_BYTES;

    // S = Q K^T: A = Q and B = K rows, both K-major
    float sc[KT / 2];
#pragma unroll
    for (int i = 0; i < KT / 2; ++i) sc[i] = 0.f;
    fence_sums(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      Wgmma<KT>::template ss<0>(sc, kmajor<BM>(qs, kk), kmajor<KT>(kt, kk));
    wgmma_commit();
    fence_sums(sc);
    wgmma_wait<0>();
    fence_sums(sc);

    // scale and bias in log2 units; a key past T weighs exactly 0
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int i = 0; i < KT / 2; ++i) {
      const int key = j * KT + frag_col(i, lane);
      const float x = key < T ? fmaf(sc[i], p.scale_log2, bb[i] * LOG2E) : -INFINITY;
      sc[i] = x;
      if (i & 2)
        mx1 = fmaxf(mx1, x);
      else
        mx0 = fmaxf(mx0, x);
    }
    // the next tile's bias loads fly during the softmax, P V and the next S
    if (j + 1 < ntiles) bias_fragment<KT, false>(bb, p.bias, p.bias_kind, h, T, row, (j + 1) * KT, lane);

    // the running softmax; key j * KT is live, so the maximum is finite
    const float n0 = fmaxf(m0, quad_max(mx0)), n1 = fmaxf(m1, quad_max(mx1));
    const float a0 = exp2f(m0 - n0), a1 = exp2f(m1 - n1);
    m0 = n0;
    m1 = n1;
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int i = 0; i < KT / 2; ++i) {
      const float e = exp2f(sc[i] - ((i & 2) ? n1 : n0));
      sc[i] = e;
      if (i & 2)
        s1 += e;
      else
        s0 += e;
    }
    l0 = l0 * a0 + s0;
    l1 = l1 * a1 + s1;
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] *= (i & 2) ? a1 : a0;

    // O += P V: P rounded to bf16 as the A operand from registers, B = V
    // rows (keys x D, D contiguous: MN-major)
    uint32_t pa[KT / 16][4];
    to_fragments<KT>(sc, pa);
    fence_regs(pa);
    fence_sums(o);
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < KT / 16; ++t) Wgmma<DP>::rs(o, pa[t], mnmajor<KT>(vt, t));
    wgmma_commit();
    fence_sums(o);
    wgmma_wait<0>();
    fence_sums(o);
    if (tid == 0) mbar_arrive(empty + 8 * s);
    if (++s == STAGES) {
      s = 0;
      ph ^= 1;
    }
  }

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const size_t bh = (size_t)b * p.H + h;
  store_rows<D, DP>(p.out + bh * T * D, o, row, T, lane, 1.f / l0, 1.f / l1);
  // the rows' log-sum-exp, asked for only when a gradient will be
  if (p.lse != nullptr && lane % 4 == 0) {
    if (row < T) p.lse[bh * T + row] = (m0 + log2f(l0)) * LN2;
    if (row + 8 < T) p.lse[bh * T + row + 8] = (m1 + log2f(l1)) * LN2;
  }
}

template <int D>
int launch_fwd(const long long* geom, const void* q, const void* k, const void* v,
               const FwdParams& p, int B, cudaStream_t stream) {
  CUtensorMap qm, km, vm;
  int err = make_map(&qm, q, geom, 64);
  if (!err) err = make_map(&km, k, geom + GEOM, FWD_KT);
  if (!err) err = make_map(&vm, v, geom + 2 * GEOM, FWD_KT);
  if (err) return err;
  constexpr int smem = fwd_smem_bytes(D);
  static_assert(smem <= MAX_SMEM_BYTES, "Q and the ring must fit a block's shared memory");
  cudaError_t e = cudaFuncSetAttribute(global_attention_kernel_wgmma<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)B, (unsigned)((p.T + 63) / 64), (unsigned)p.H);
  global_attention_kernel_wgmma<D><<<grid, 128 + PRODUCER_THREADS, smem, stream>>>(qm, km, vm, p);
  return (int)cudaGetLastError();
}

}  // namespace wgattn

extern "C" {

const char* soccdpt_error_string(int code) { return hopper::error_string(code); }

// The f32 route, on CUDA cores: q, k, v, out (B, H, n, D) f32 contiguous,
// 16-byte aligned; bias: (H, n, n) contiguous, NULL (bias_kind 0), f32 (1)
// or bf16 (2); lse: (B, H, n) f32 for each row's log-sum-exp of its
// scores, or NULL.
int soccdpt_global_attention_f32(const void* q, const void* k, const void* v, const void* bias,
                                 void* out, void* lse, int B, int H, int n, int D, int bias_kind,
                                 float scale, void* stream) {
  if (B == 0 || H == 0 || n == 0) return (int)cudaGetLastError();
  if (bias_kind < 0 || bias_kind > 2 || (bias_kind != 0 && bias == nullptr))
    return (int)cudaErrorInvalidValue;
  if (H > 65535 || (n + BQ - 1) / BQ > 65535) return (int)cudaErrorInvalidValue;
  return (int)dispatch<float>(D, q, k, v, bias, bias_kind, out, (float*)lse, B, H, n, scale,
                              (cudaStream_t)stream);
}

// The bf16 route: q, k, v bf16 views (B, H, n, D) read through tensor maps
// of geometry geom[7 i .. 7 i + 6] (dims D, n, H, B; byte strides of n, H,
// B) for q, k, v in turn, each base and stride a multiple of 16 bytes; out
// (B, H, n, D) bf16 contiguous; bias, lse as above.
int soccdpt_global_attention_bf16(const void* q, const void* k, const void* v,
                                  const long long* geom, const void* bias, void* out, void* lse,
                                  int B, int H, int n, int D, int bias_kind, float scale,
                                  void* stream) {
  if (B == 0 || H == 0 || n == 0) return (int)cudaGetLastError();
  if (bias_kind < 0 || bias_kind > 2 || (bias_kind != 0 && bias == nullptr))
    return (int)cudaErrorInvalidValue;
  if (H > 65535 || (n + 63) / 64 > 65535) return (int)cudaErrorInvalidValue;
  wgattn::FwdParams p;
  p.bias = bias;
  p.out = (__nv_bfloat16*)out;
  p.lse = (float*)lse;
  p.bias_kind = bias_kind;
  p.H = H;
  p.T = n;
  p.scale_log2 = scale * wgattn::LOG2E;
  cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 16: return wgattn::launch_fwd<16>(geom, q, k, v, p, B, s);
    case 32: return wgattn::launch_fwd<32>(geom, q, k, v, p, B, s);
    case 64: return wgattn::launch_fwd<64>(geom, q, k, v, p, B, s);
    case 128: return wgattn::launch_fwd<128>(geom, q, k, v, p, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"

// Swin-V2 scaled-cosine window attention for Hopper (sm_90a).
//
// Replaces the Pallas kernels of soccdpt_tpu/ops/window_attention.py
// (cosine_window_attention, cosine_window_attention_batched, wrapped by
// pallas_window_attention). Computes, for each window b and head h,
//
//   out = softmax(tau[h] * q k^T + bias[h] + mask[b % nW]) v
//
// over (Bw, H, N, D) tensors, q and k already L2-normalised, tau already
// exp'd and clamped, bias already 16*sigmoid, mask optional. Scores,
// softmax and both sums are f32; the output has the input's type.
//
// Two routes, by dtype.
//
// bf16: the tensor cores (window_attention_kernel_wgmma below, on
// attention_wgmma.cuh, the machinery of K6's forward). A CTA of one
// consumer warpgroup owns 64 query rows of one (window, head); a producer
// warp's lane 0 loads those rows of Q once by TMA and streams 64-key K and
// V tiles through a ring whose depth the wrapper plans
// (kernels/window_attention.py, plan_window_attention): at N <= 256 the
// ring holds the window-head's whole K and V, so every load is issued at
// once. q, k and v are read through 4-D tensor maps of the caller's
// strides, so the strided views of one qkv tensor are read in place; D =
// 16 and 32 come back padded to 64 columns, rows past N as zeros, and
// keys past N are masked to -inf. Per key tile the warpgroup runs S = Q K^T
// on wgmma, adds tau[h] s + bias[h, i, j] + mask[b % nW, i, j] to the sums
// it holds (tau read in its own dtype from device memory; bias and mask
// by plain guarded loads into the sums' layout, issued a tile ahead), takes
// the running softmax in log2 units in f32, rounds P to bf16 in registers
// and runs O += P V on wgmma with P as the A operand.
//
// f32: CUDA cores (window_attention_kernel below), kept for the f32 bound
// (2e-5), which needs f32 products. One block per (window, head, tile of
// q_tile query rows; the wrapper picks 32, 16 or 8 so that small stages
// still fill the card). The block stages K and V of its window-head in
// shared memory, rows padded to D+1 floats so that lanes reading
// consecutive keys hit distinct banks. Each warp takes one query row at a
// time: lanes split the keys for the scores, the row's scores stay in a
// per-warp shared row, the softmax is a full-row max/exp/sum with warp
// shuffles, and lanes split the head dimension for P.V. The (N, N) score
// matrix never reaches device memory.
//
// What bounds it: at the flagship (N = 256 or 64, D = 32) the work is
// about 4*N*N*D flops per window-head against (4*N*D) q/k/v/out values
// plus the f32 bias and mask rows, so device memory bounds the ideal
// kernel, about 13 us for the 12 launches of a batch-1 forward; one
// launch moves 0.2-2.4 us of bytes, so what a launch waits for is its
// own start and the ring's first loads.

#include <math.h>

#include "attention_wgmma.cuh"

namespace {

constexpr int WARPS = 8;

__device__ __forceinline__ float to_f(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }

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

cudaError_t dispatch_f32(int D, const void* q, const void* k, const void* v, const void* scale,
                         const void* bias, const void* mask, void* out, int Bw, int H, int N,
                         int nW, int q_tile, cudaStream_t s) {
  switch (D) {
    case 16: return launch<float, 16>(q, k, v, scale, bias, mask, out, Bw, H, N, nW, q_tile, s);
    case 32: return launch<float, 32>(q, k, v, scale, bias, mask, out, Bw, H, N, nW, q_tile, s);
    case 64: return launch<float, 64>(q, k, v, scale, bias, mask, out, Bw, H, N, nW, q_tile, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// --- the bf16 route: wgmma fed by TMA ------------------------------------------

namespace wgattn {

constexpr int WIN_BM = 64;          // query rows a CTA: one warpgroup
constexpr int WIN_KT = 64;          // keys a tile
constexpr int WIN_MAX_STAGES = 4;   // the ring's depth at most

// 1 KB of slack to align the tiles to the swizzle atom, Q (64 rows), the
// ring of K and V tiles, the barriers (q_full, full[stages], empty[stages])
__host__ __device__ constexpr int win_smem_bytes(int D, int stages) {
  return 1024 + (WIN_BM + stages * 2 * WIN_KT) * padded(D) * 2 + (1 + 2 * stages) * 8;
}

struct WinParams {
  const void* tau;     // (H,) f32 or bf16: exp'd and clamped
  const void* bias;    // (H, N, N) f32 or bf16
  const void* mask;    // (nW, N, N) f32 or bf16, or null
  __nv_bfloat16* out;  // (Bw, H, N, D) contiguous
  int tau_kind, bias_kind, mask_kind;  // 1 f32, 2 bf16; mask_kind 0: no mask
  int H, N, nW, stages;
};

__device__ __forceinline__ float load_scalar(const void* p, int kind, int i) {
  return kind == 1 ? static_cast<const float*>(p)[i]
                   : __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
}

__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// The (N, N) slice `m` of a bias or mask under a thread's sums, 0 outside
// the square: rows `row` and `row` + 8, columns col0 + frag_col. Columns
// 8 j + 2 (l % 4) and that + 1 are neighbours, so where N is even (every
// window the port runs) each pair is one aligned 8-byte (f32) or 4-byte
// (bf16) load; an odd N takes attention_wgmma.cuh's scalar loads.
template <int KT, typename B>
__device__ __forceinline__ void pairs_of(float (&bb)[KT / 2], const B* t, int m, int N, int row,
                                         int col0, int lane) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = row + 8 * hh;
    const B* rp = t + ((size_t)m * N + r) * N + col0 + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < KT / 8; ++j) {
      // plain loads behind the guard, as bias_fragment_of's
      float2 x = make_float2(0.f, 0.f);
      if (r < N && col0 + 8 * j + 2 * (lane % 4) < N) x = load_pair(rp + 8 * j);
      bb[4 * j + 2 * hh] = x.x;
      bb[4 * j + 2 * hh + 1] = x.y;
    }
  }
}

template <int KT>
__device__ __forceinline__ void window_fragment(float (&bb)[KT / 2], const void* t, int kind,
                                                int m, int N, int row, int col0, int lane) {
  if (N % 2)
    bias_fragment<KT, false>(bb, t, kind, m, N, row, col0, lane);
  else if (kind == 1)
    pairs_of<KT>(bb, static_cast<const float*>(t), m, N, row, col0, lane);
  else
    pairs_of<KT>(bb, static_cast<const __nv_bfloat16*>(t), m, N, row, col0, lane);
}

// One CTA: a consumer warpgroup of 64 query rows of one (window, head) and
// a producer warp whose lane 0 loads Q once and keeps the ring of K and V
// tiles full. MASK instantiates the shift mask's loads; their registers do
// not fit the 168 a thread that two CTAs an SM allow, so a masked call
// runs one CTA an SM (measured on an H100, PERF.md §6: the spilling
// two-CTA build took 19.7 us at the flagship's stage 0, one CTA 17.5).
template <int D, bool MASK>
__global__ void __launch_bounds__(128 + PRODUCER_THREADS, MASK ? 1 : 2)
    window_attention_kernel_wgmma(const __grid_constant__ CUtensorMap qmap,
                                  const __grid_constant__ CUtensorMap kmap,
                                  const __grid_constant__ CUtensorMap vmap, const WinParams p) {
  constexpr int DP = padded(D), KT = WIN_KT, BM = WIN_BM;
  constexpr int Q_BYTES = BM * DP * 2, TILE_BYTES = KT * DP * 2, STAGE_BYTES = 2 * TILE_BYTES;
  constexpr int CONSUMERS = 128;

  extern __shared__ unsigned char smem_raw_win[];
  const uint32_t raw = smem_u32(smem_raw_win);
  const uint32_t qs = (raw + 1023u) & ~1023u;  // the swizzle atom is 1 KB
  const int stages = p.stages;
  const uint32_t ring = qs + Q_BYTES;
  const uint32_t q_full = ring + stages * STAGE_BYTES;
  const uint32_t full = q_full + 8, empty = full + 8 * stages;
  const int tid = threadIdx.x, N = p.N;
  const int b = blockIdx.x, q0 = blockIdx.y * BM, h = blockIdx.z;
  const int ntiles = (N + KT - 1) / KT;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + 8 * s, 1);   // the producer's expect_tx
      mbar_init(empty + 8 * s, 1);  // the consumers' arrival
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
        if (++s == stages) {
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
  const int w = b % p.nW;
  const float tau_log2 = load_scalar(p.tau, p.tau_kind, h) * LOG2E;
  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float bb[KT / 2], mm[MASK ? KT / 2 : 1];
  window_fragment<KT>(bb, p.bias, p.bias_kind, h, N, row, 0, lane);
  if constexpr (MASK) window_fragment<KT>(mm, p.mask, p.mask_kind, w, N, row, 0, lane);
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

    // tau s + bias + mask in log2 units; a key past N weighs exactly 0
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int i = 0; i < KT / 2; ++i) {
      const int key = j * KT + frag_col(i, lane);
      float add = bb[i];
      if constexpr (MASK) add += mm[i];
      const float x = key < N ? fmaf(sc[i], tau_log2, add * LOG2E) : -INFINITY;
      sc[i] = x;
      if (i & 2)
        mx1 = fmaxf(mx1, x);
      else
        mx0 = fmaxf(mx0, x);
    }
    // the next tile's bias and mask loads fly during the softmax, P V and the next S
    if (j + 1 < ntiles) {
      window_fragment<KT>(bb, p.bias, p.bias_kind, h, N, row, (j + 1) * KT, lane);
      if constexpr (MASK)
        window_fragment<KT>(mm, p.mask, p.mask_kind, w, N, row, (j + 1) * KT, lane);
    }

    // the running softmax; a row whose scores are all -inf so far (a mask
    // of -inf) subtracts 0, so that it weighs 0 and never NaN
    const float n0 = fmaxf(m0, quad_max(mx0)), n1 = fmaxf(m1, quad_max(mx1));
    const float z0 = n0 == -INFINITY ? 0.f : n0, z1 = n1 == -INFINITY ? 0.f : n1;
    const float a0 = exp2f(m0 - z0), a1 = exp2f(m1 - z1);
    m0 = n0;
    m1 = n1;
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int i = 0; i < KT / 2; ++i) {
      const float e = exp2f(sc[i] - ((i & 2) ? z1 : z0));
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
    if (++s == stages) {
      s = 0;
      ph ^= 1;
    }
  }

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const size_t bh = (size_t)b * p.H + h;
  store_rows<D, DP>(p.out + bh * N * D, o, row, N, lane, 1.f / l0, 1.f / l1);
}

template <int D, bool MASK>
int launch_win(const long long* geom, const void* q, const void* k, const void* v,
               const WinParams& p, int Bw, cudaStream_t stream) {
  CUtensorMap qm, km, vm;
  int err = make_map(&qm, q, geom, WIN_BM);
  if (!err) err = make_map(&km, k, geom + GEOM, WIN_KT);
  if (!err) err = make_map(&vm, v, geom + 2 * GEOM, WIN_KT);
  if (err) return err;
  const int smem = win_smem_bytes(D, p.stages);
  if (smem > MAX_SMEM_BYTES) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(window_attention_kernel_wgmma<D, MASK>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)Bw, (unsigned)((p.N + WIN_BM - 1) / WIN_BM), (unsigned)p.H);
  window_attention_kernel_wgmma<D, MASK><<<grid, 128 + PRODUCER_THREADS, smem, stream>>>(
      qm, km, vm, p);
  return (int)cudaGetLastError();
}

template <bool MASK>
int dispatch_win(int D, const long long* geom, const void* q, const void* k, const void* v,
                 const WinParams& p, int Bw, cudaStream_t s) {
  switch (D) {
    case 16: return launch_win<16, MASK>(geom, q, k, v, p, Bw, s);
    case 32: return launch_win<32, MASK>(geom, q, k, v, p, Bw, s);
    case 64: return launch_win<64, MASK>(geom, q, k, v, p, Bw, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace wgattn

extern "C" {

const char* soccdpt_error_string(int code) { return hopper::error_string(code); }

// The f32 route, on CUDA cores. q, k, v, out: (Bw, H, N, D) f32
// contiguous; scale: (H,) f32; bias: (H, N, N) f32; mask: (nW, N, N) f32
// or NULL; q_tile: query rows per block.
int soccdpt_window_attention_f32(const void* q, const void* k, const void* v, const void* scale,
                                 const void* bias, const void* mask, void* out, int Bw, int H,
                                 int N, int D, int nW, int q_tile, void* stream) {
  if (Bw == 0) return (int)cudaGetLastError();
  if (q_tile < 1) return (int)cudaErrorInvalidValue;
  return (int)dispatch_f32(D, q, k, v, scale, bias, mask, out, Bw, H, N, nW, q_tile,
                           (cudaStream_t)stream);
}

// The bf16 route: q, k, v bf16 views (Bw, H, N, D) read through tensor maps
// of geometry geom[7 i .. 7 i + 6] (dims D, N, H, Bw; byte strides of N, H,
// Bw) for q, k, v in turn, each base and stride a multiple of 16 bytes;
// tau (H,), bias (H, N, N) and mask (nW, N, N) contiguous, each of kind 1
// (f32) or 2 (bf16), mask NULL with kind 0; out (Bw, H, N, D) bf16
// contiguous; stages: the ring's depth, 1 to 4.
int soccdpt_window_attention_bf16(const void* q, const void* k, const void* v,
                                  const long long* geom, const void* tau, int tau_kind,
                                  const void* bias, int bias_kind, const void* mask,
                                  int mask_kind, void* out, int Bw, int H, int N, int D, int nW,
                                  int stages, void* stream) {
  if (Bw == 0 || H == 0 || N == 0) return (int)cudaGetLastError();
  if (tau_kind < 1 || tau_kind > 2 || bias_kind < 1 || bias_kind > 2 || mask_kind < 0 ||
      mask_kind > 2 || (mask_kind != 0) != (mask != nullptr) || nW < 1 || stages < 1 ||
      stages > wgattn::WIN_MAX_STAGES || H > 65535 || (N + 63) / 64 > 65535)
    return (int)cudaErrorInvalidValue;
  wgattn::WinParams p;
  p.tau = tau;
  p.bias = bias;
  p.mask = mask;
  p.out = (__nv_bfloat16*)out;
  p.tau_kind = tau_kind;
  p.bias_kind = bias_kind;
  p.mask_kind = mask_kind;
  p.H = H;
  p.N = N;
  p.nW = nW;
  p.stages = stages;
  cudaStream_t s = (cudaStream_t)stream;
  return mask ? wgattn::dispatch_win<true>(D, geom, q, k, v, p, Bw, s)
              : wgattn::dispatch_win<false>(D, geom, q, k, v, p, Bw, s);
}

}  // extern "C"

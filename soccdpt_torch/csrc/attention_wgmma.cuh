// What the bf16 route of global attention shares between its forward
// (global_attention.cu, K6) and its backward (global_attention_bwd.cu,
// K7): the tensor maps of q, k, v, g, the bias in wgmma's accumulator
// layout, and the register fragments that carry a tile of weights from one
// product to the next.
//
// Every (B, H, T, D) bf16 operand is read by TMA through a 4-D tensor map
// (D, T, H, B) with the strides the caller's view has (so q, k and v may be
// the strided views of one qkv tensor), in boxes of 64 columns by `rows`
// rows of one head, with the 128-byte swizzle. A row past T lies outside
// the map and comes back as zeros, never as the next head's row; D = 16 and
// 32 come back padded to 64 columns with zeros the same way. A zero key
// still scores 0, so the kernels mask keys past T themselves.
//
// The bias (H, T, T), f32 or bf16, cannot go through TMA: a row is T
// elements, and T = 1025 or 577 makes its stride no multiple of 16 bytes.
// Each thread loads the elements its accumulator holds with plain loads
// (a quad reads 8 consecutive keys of a row, or 8 consecutive keys of 4
// query rows where the accumulator is transposed), issued a tile ahead of
// their use so they overlap the products.

#pragma once

#include "wgmma_common.cuh"

namespace wgattn {

using namespace hopper;

constexpr int ROW_BYTES = 128;  // a swizzled row: 64 bf16 columns
constexpr int PRODUCER_THREADS = 32;
constexpr int GEOM = 7;  // a tensor's geometry from the caller: dims[4], byte strides[3]
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// The padded head width the tiles hold: 64 columns, or 128 at D = 128.
__host__ __device__ constexpr int padded(int D) { return D < 64 ? 64 : D; }

// A bf16 tensor map of one (B, H, T, D) operand from its geometry (dims D,
// T, H, B; byte strides of T, H, B), with boxes of 64 columns x `rows`.
inline int make_map(CUtensorMap* map, const void* base, const long long* geom, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)geom[0], (cuuint64_t)geom[1], (cuuint64_t)geom[2],
                              (cuuint64_t)geom[3]};
  const cuuint64_t strides[3] = {(cuuint64_t)geom[4], (cuuint64_t)geom[5], (cuuint64_t)geom[6]};
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  return encode(map, base, 4, dims, strides, box);
}

// Load the DP / 64 column chunks of one box of `rows` rows of map at
// (row0, h, b) to dst, chunk c at dst + c * rows * ROW_BYTES.
template <int DP>
__device__ __forceinline__ void load_rows(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                          int rows, int row0, int h, int b) {
#pragma unroll
  for (int c = 0; c < DP / 64; ++c)
    tma_load_4d(dst + c * rows * ROW_BYTES, map, bar, 64 * c, row0, h, b);
}

// Descriptors of a tile of R rows stored as DP / 64 chunks of R x 128 bytes.
// As a K-major operand (A, or B with trans-b 0): k-step kk covers columns
// 16 kk .. 16 kk + 15, 32 bytes along the swizzled row, 8-row groups 1 KB
// apart. As an MN-major B (trans-b 1): k-step t covers rows 16 t .. 16 t +
// 15 (2 KB), chunks of 64 columns R x 128 bytes apart.
template <int R>
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int kk) {
  return sw128_desc(tile + (kk / 4) * R * ROW_BYTES + 32 * (kk % 4), 16, 1024);
}
template <int R>
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int t) {
  return sw128_desc(tile + 2048 * t, R * ROW_BYTES, 1024);
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The sums of an m64nN product (N / 2 a thread) as the bf16 A fragments of
// N / 16 k-steps of the next product (wgmma_common.cuh, Wgmma).
template <int N>
__device__ __forceinline__ void to_fragments(const float (&s)[N / 2], uint32_t (&a)[N / 16][4]) {
#pragma unroll
  for (int t = 0; t < N / 16; ++t)
#pragma unroll
    for (int r = 0; r < 4; ++r) a[t][r] = pack_bf16(s[8 * t + 2 * r], s[8 * t + 2 * r + 1]);
}

// Keep the compiler from moving the writes of A fragments past wgmma.fence.
template <int NT, int R>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[NT][R]) {
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int r = 0; r < R; ++r) asm volatile("" : "+r"(a[t][r])::"memory");
}

// The accumulator position of sum i of a thread: row offset 0 or 8 (from
// the thread's first row) and column offset within the tile.
__device__ __forceinline__ int frag_row(int i) { return (i & 2) ? 8 : 0; }
__device__ __forceinline__ int frag_col(int i, int lane) {
  return 8 * (i / 4) + 2 * (lane % 4) + (i & 1);
}

// The bias under a thread's N / 2 sums, 0 outside the (T, T) square: rows `row` and `row` + 8 of bias[h] at columns col0 +
// frag_col. With TRANSPOSED the accumulator's rows are keys and its
// columns queries, so the element is bias[h][column][row]. kind: 1 f32,
// 2 bf16.
template <int N, bool TRANSPOSED, typename B>
__device__ __forceinline__ void bias_fragment_of(float (&bb)[N / 2], const B* bias, int h, int T,
                                                 int row, int col0, int lane) {
  const size_t head = (size_t)h * T * T;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const int r = row + frag_row(i), c = col0 + frag_col(i, lane);
    // plain loads behind the guard: the compiler may not issue them
    // speculatively, as it may an asm load, past the end of the bias
    float x = 0.f;
    if (r < T && c < T)
      x = to_float(bias[TRANSPOSED ? head + (size_t)c * T + r : head + (size_t)r * T + c]);
    bb[i] = x;
  }
}

template <int N, bool TRANSPOSED>
__device__ __forceinline__ void bias_fragment(float (&bb)[N / 2], const void* bias, int kind,
                                              int h, int T, int row, int col0, int lane) {
  if (kind == 1) {
    bias_fragment_of<N, TRANSPOSED>(bb, static_cast<const float*>(bias), h, T, row, col0, lane);
  } else if (kind == 2) {
    bias_fragment_of<N, TRANSPOSED>(bb, static_cast<const __nv_bfloat16*>(bias), h, T, row, col0,
                                    lane);
  } else {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) bb[i] = 0.f;
  }
}

// reduce over the four lanes of a quad, which share a row of the accumulator
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Write rows `row` and `row` + 8 (those below T) of a thread's sums of an
// m64nDP product, columns below D, times `mul`, as bf16 to a contiguous
// (.., T, D) tensor whose row 0 is at `base`.
template <int D, int DP>
__device__ __forceinline__ void store_rows(__nv_bfloat16* base, const float (&o)[DP / 2], int row,
                                           int T, int lane, float mul0, float mul1) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = row + 8 * hh;
    if (r >= T) continue;
    const float mul = hh ? mul1 : mul0;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int c = 8 * j + 2 * (lane % 4);
      if (c >= D) continue;
      *reinterpret_cast<__nv_bfloat162*>(base + (size_t)r * D + c) =
          __floats2bfloat162_rn(o[4 * j + 2 * hh] * mul, o[4 * j + 2 * hh + 1] * mul);
    }
  }
}

}  // namespace wgattn

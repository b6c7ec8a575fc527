// Dense segment sum (the occupancy voxelizer's accumulation) for Hopper,
// and its backward.
//
// Replaces the Pallas kernel of soccdpt_tpu/ops/sorted_segment_sum.py
// (sorted_segment_sum_tpu: _kernel with its on-device _schedule, used by
// segment_sum_sorted_pallas and ops/geometry.py::_accumulate_sort).
// Computes out[s, c] = sum of vals[b, n, c] over the rows with
// lin[b * N + n] == s, for 0 <= s < S; other rows are dropped and their
// values never read. The backward (JAX's _accumulate_sort_bwd, an XLA
// take there) gathers the cotangent at each kept row's slot.
//
// The TPU needed a sort and one-hot matmuls because its scatter is a
// serial loop. Hopper has f32 reductions in the L2, so the forward is a
// direct scatter with no sort:
//
// * The output's zero fill belongs to the call: a cudaMemsetAsync before
//   the kernel, two CUDA launches a call. (A persistent cooperative
//   kernel that zeroed the grid itself behind a grid-wide barrier, one
//   launch, was slower on the H100: PERF.md section 6.)
// * A warp takes a tile of 128 consecutive rows of one image, 4 rows a
//   lane: the keys come as one int4 load, the values through the
//   caller's strides (as float4 loads for the served channel-major view),
//   no 64-bit division.
// * Reductions before the atomics. The rows come in pixel order and
//   neighbouring pixels often share a voxel, so runs of equal slots are
//   summed first: inside a lane over its 4 rows, then across the warp by
//   a segmented scan of the lanes' tail sums (five shuffle steps).
// * Few L2 requests. Each run of the tile sends one fire-and-forget
//   reduction (RED) a channel. The runs are compacted into a list in
//   shared memory first, so that consecutive lanes add consecutive
//   channels of one run: a run's C channels share their sector and go to
//   the L2 in one request, where one lane a run would send C: the rate
//   of the L2's reduction requests, not bytes, bounds the scatter.
// * The grid stays in the L2: keys and values are read as streaming
//   (evict-first) loads, the reductions mark the grid's lines last to
//   evict (csrc/cache_hints.cuh), so a reduction finds its
//   line in the L2 instead of device memory.
//
// What bounds it: each key and kept value is read once and each cell
// written once, so device memory bounds the ideal kernel (about 55 MB per
// 1080p frame into a 256x256x32x3 grid, 16 us at 3.35 TB/s); at batch 1 the
// 25 MB grid fits in the 50 MB L2, at batch 2 it does not. Atomic order
// changes the add order, so results match a serial sum to f32 rounding,
// not to bits. The backward is a gather, exact.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cache_hints.cuh"

namespace segsum {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileRows = 128;  // a warp's rows a step, 4 a lane
constexpr unsigned kFull = 0xffffffffu;

enum ValueLayout { kStrided = 0, kChannelMajor = 1 };

struct Problem {
  const int* lin;     // (B * N,) int32
  const float* vals;  // (b, n, c) at b * sb + n * sn + c * sc
  float* out;         // (S, C) f32
  long long sb, sn, sc;
  int B, N, C, S;
  int tiles_per_image;  // ceil(N / 128)
  int vector_keys;      // lin 16-byte aligned and N % 4 == 0
  int layout;           // ValueLayout of vals
};

// The 4 keys of a lane's rows of a tile; -1 for a row that is dropped (out
// of range, negative, or past N).
__device__ __forceinline__ void load_keys(const Problem& p, int tile, int lane, int key[4]) {
  const int b = tile / p.tiles_per_image;
  const int n0 = (tile - b * p.tiles_per_image) * kTileRows + 4 * lane;
  const long long row0 = (long long)b * p.N + n0;
  if (p.vector_keys && n0 + 3 < p.N) {
    const int4 k = __ldcs(reinterpret_cast<const int4*>(p.lin + row0));
    key[0] = k.x;
    key[1] = k.y;
    key[2] = k.z;
    key[3] = k.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) key[j] = n0 + j < p.N ? __ldcs(p.lin + row0 + j) : -1;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (key[j] < 0 || key[j] >= p.S) key[j] = -1;
}

// Channels c0 .. c0 + CB - 1 of the 4 rows; 0 for a dropped row or a
// channel past C. Vector loads only when all 4 rows are kept, so a dropped
// row's values are never read.
template <int CB>
__device__ __forceinline__ void load_values(const Problem& p, const float* base, int c0,
                                            const int key[4], float v[4][CB]) {
  const bool kept = key[0] >= 0 && key[1] >= 0 && key[2] >= 0 && key[3] >= 0;
  if (kept && p.layout == kChannelMajor) {
#pragma unroll
    for (int c = 0; c < CB; ++c) {
      float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
      if (c0 + c < p.C) f = __ldcs(reinterpret_cast<const float4*>(base + c * p.sc));
      v[0][c] = f.x;
      v[1][c] = f.y;
      v[2][c] = f.z;
      v[3][c] = f.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < CB; ++c)
        v[j][c] = key[j] >= 0 && c0 + c < p.C ? __ldcs(base + j * p.sn + c * p.sc) : 0.f;
  }
}

// A warp's runs of one tile (at most one a row): slot and channel sums.
template <int CB>
struct Runs {
  int key[kTileRows];
  float sum[kTileRows][CB];
};

// One warp's tile: 128 rows of image b, each run of equal slots summed in
// registers and added to the output once a channel.
template <int CB>
__device__ __forceinline__ void scatter_tile(const Problem& p, int tile, int lane,
                                             const int key[4], Runs<CB>& runs,
                                             unsigned long long keep) {
  const int b = tile / p.tiles_per_image;
  const int n0 = (tile - b * p.tiles_per_image) * kTileRows + 4 * lane;
  // runs inside the lane: same[j] says row j continues row j - 1's run
  bool same[4];
  same[0] = false;
#pragma unroll
  for (int j = 1; j < 4; ++j) same[j] = key[j] == key[j - 1];
  const bool full = same[1] && same[2] && same[3];
  // across lanes: the head run continues the left lane's tail run, and the
  // tail run goes on into the right lane's head run
  const int left = __shfl_up_sync(kFull, key[3], 1);
  const int right = __shfl_down_sync(kFull, key[0], 1);
  const bool joins = lane > 0 && key[0] >= 0 && key[0] == left;
  const bool goes_on = lane < 31 && key[3] >= 0 && key[3] == right;

  const float* base = p.vals + b * p.sb + n0 * p.sn;
  for (int c0 = 0; c0 < p.C; c0 += CB) {
    float v[4][CB];
    load_values<CB>(p, base + c0 * p.sc, c0, key, v);
    // v[j] becomes the sum of row j's run from its start inside the lane
#pragma unroll
    for (int j = 1; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < CB; ++c) v[j][c] += same[j] ? v[j - 1][c] : 0.f;
    // segmented inclusive scan of the tail sums over the lanes: a full
    // lane that joins links its segment to the left one
    float tail[CB];
#pragma unroll
    for (int c = 0; c < CB; ++c) tail[c] = v[3][c];
    int link = full && joins;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int up_link = __shfl_up_sync(kFull, link, d);
#pragma unroll
      for (int c = 0; c < CB; ++c) {
        const float up = __shfl_up_sync(kFull, tail[c], d);
        if (lane >= d && link) tail[c] += up;
      }
      if (lane >= d) link = link && up_link;
    }
    // what the left lanes hold of this lane's head run
    float carry[CB];
#pragma unroll
    for (int c = 0; c < CB; ++c) {
      const float up = __shfl_up_sync(kFull, tail[c], 1);
      carry[c] = joins ? up : 0.f;
    }
    // the runs that end in this lane, into the warp's list in row order
    bool emit[4];
    int count = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      emit[j] = key[j] >= 0 && (j < 3 ? !same[j + 1] : !goes_on);
      count += emit[j];
    }
    int offset = count;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int up = __shfl_up_sync(kFull, offset, d);
      if (lane >= d) offset += up;
    }
    const int total = __shfl_sync(kFull, offset, 31);
    offset -= count;
    bool head = true;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      head = head && (j == 0 || same[j]);
      if (!emit[j]) continue;
      runs.key[offset] = key[j];
#pragma unroll
      for (int c = 0; c < CB; ++c)
        runs.sum[offset][c] = j == 3 ? tail[c] : v[j][c] + (head ? carry[c] : 0.f);
      ++offset;
    }
    __syncwarp();
    // one reduction a run and channel, consecutive lanes on consecutive
    // channels of a run: an instruction covers 32 / CB runs, and a run's
    // channels share their sector of the L2
    for (int i = lane; i < total * CB; i += 32) {
      const int r = i / CB, c = i - r * CB;
      if (c0 + c < p.C)
        hints::red_add(p.out + (long long)runs.key[r] * p.C + c0 + c, runs.sum[r][c], keep);
    }
    __syncwarp();
  }
}

template <int CB>
__global__ void __launch_bounds__(kThreads) segment_sum_kernel(const Problem p) {
  const unsigned long long keep = hints::keep_in_l2();
  using Stage = Runs<CB>;
  __shared__ Stage runs[kWarps];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int warps = gridDim.x * kWarps;
  const int tiles = p.B * p.tiles_per_image;
  int t = blockIdx.x * kWarps + warp;
  int key[4];
  if (t < tiles) load_keys(p, t, lane, key);
  for (; t < tiles; t += warps) {
    int next[4] = {-1, -1, -1, -1};
    if (t + warps < tiles) load_keys(p, t + warps, lane, next);  // in flight meanwhile
    scatter_tile<CB>(p, t, lane, key, runs[warp], keep);
#pragma unroll
    for (int j = 0; j < 4; ++j) key[j] = next[j];
  }
}

// The backward: grad[r, c] = cot[lin[r], c] for a kept row, 0 for a
// dropped one; 4 rows a thread, keys as one int4 load, the 4 rows' C
// values written as float4 stores where C <= 4 (CT = C; CT = 0 takes any C
// with scalar stores).
template <int CT>
__global__ void __launch_bounds__(kThreads)
    gather_kernel(const int* __restrict__ lin, const float* __restrict__ cot,
                  float* __restrict__ grad, long long rows, int C, int S, int vector) {
  const long long r0 = 4 * ((long long)blockIdx.x * blockDim.x + threadIdx.x);
  if (r0 >= rows) return;
  int key[4];
  if (vector && r0 + 3 < rows) {
    const int4 k = __ldcs(reinterpret_cast<const int4*>(lin + r0));
    key[0] = k.x;
    key[1] = k.y;
    key[2] = k.z;
    key[3] = k.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) key[j] = r0 + j < rows ? __ldcs(lin + r0 + j) : -1;
  }
  if (CT > 0 && vector && r0 + 3 < rows) {
    float f[4 * (CT > 0 ? CT : 1)];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < CT; ++c)
        f[j * CT + c] = key[j] >= 0 && key[j] < S ? cot[(long long)key[j] * CT + c] : 0.f;
    float4* dst = reinterpret_cast<float4*>(grad + r0 * CT);
#pragma unroll
    for (int q = 0; q < CT; ++q)
      __stcs(dst + q, make_float4(f[4 * q], f[4 * q + 1], f[4 * q + 2], f[4 * q + 3]));
  } else {
    for (int j = 0; j < 4 && r0 + j < rows; ++j) {
      const bool kept = key[j] >= 0 && key[j] < S;
      for (int c = 0; c < C; ++c)
        __stcs(grad + (r0 + j) * C + c, kept ? cot[(long long)key[j] * C + c] : 0.f);
    }
  }
}

// Blocks of a persistent grid: as many as stay resident on the card.
template <class K>
int resident_blocks(K kernel) {
  int device = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  return sms * per_sm;
}

template <int CB>
int launch(const Problem& p, cudaStream_t stream) {
  const int tiles = p.B * p.tiles_per_image;
  cudaError_t rc = cudaMemsetAsync(p.out, 0, sizeof(float) * (size_t)p.S * p.C, stream);
  if (rc != cudaSuccess || tiles == 0) return (int)rc;
  static int resident = resident_blocks(segment_sum_kernel<CB>);
  const int needed = (tiles + kWarps - 1) / kWarps;
  segment_sum_kernel<CB><<<needed < resident ? needed : resident, kThreads, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace segsum

extern "C" {

const char* soccdpt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// lin: (B * N,) int32; vals: (B, N, C) f32 at any strides (elements);
// out: (S, C) f32, zeroed here by a memset before the kernel.
int soccdpt_segment_sum(const void* lin, const void* vals, void* out, int B, int N, int C,
                        long long sb, long long sn, long long sc, int S, void* stream) {
  using namespace segsum;
  Problem p{(const int*)lin, (const float*)vals, (float*)out, sb, sn, sc, B, N, C, S,
            (N + kTileRows - 1) / kTileRows, 0, kStrided};
  p.vector_keys = (uintptr_t)lin % 16 == 0 && N % 4 == 0;
  const bool aligned = (uintptr_t)vals % 16 == 0 && (B == 1 || sb % 4 == 0);
  if (aligned && sn == 1 && sc % 4 == 0) p.layout = kChannelMajor;
  if (S == 0 || C == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (C) {
    case 1: return launch<1>(p, s);
    case 2: return launch<2>(p, s);
    case 3: return launch<3>(p, s);
    default: return launch<4>(p, s);
  }
}

// lin: (rows,) int32; cot: (S, C) f32 contiguous; grad: (rows, C) f32.
int soccdpt_segment_sum_backward(const void* lin, const void* cot, void* grad, long long rows,
                                 int C, int S, void* stream) {
  using namespace segsum;
  if (rows == 0 || C == 0) return 0;
  const int vector = (uintptr_t)lin % 16 == 0 && (uintptr_t)grad % 16 == 0;
  const long long blocks = ((rows + 3) / 4 + kThreads - 1) / kThreads;
  cudaStream_t s = (cudaStream_t)stream;
  const int* l = (const int*)lin;
  const float* c = (const float*)cot;
  float* g = (float*)grad;
  switch (C) {
    case 1: gather_kernel<1><<<(unsigned)blocks, kThreads, 0, s>>>(l, c, g, rows, C, S, vector); break;
    case 2: gather_kernel<2><<<(unsigned)blocks, kThreads, 0, s>>>(l, c, g, rows, C, S, vector); break;
    case 3: gather_kernel<3><<<(unsigned)blocks, kThreads, 0, s>>>(l, c, g, rows, C, S, vector); break;
    case 4: gather_kernel<4><<<(unsigned)blocks, kThreads, 0, s>>>(l, c, g, rows, C, S, vector); break;
    default: gather_kernel<0><<<(unsigned)blocks, kThreads, 0, s>>>(l, c, g, rows, C, S, vector);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"

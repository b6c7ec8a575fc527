// Dense segment-sum (the occupancy voxelizer's accumulation) for Hopper.
//
// Replaces the Pallas kernel of soccdpt_tpu/ops/sorted_segment_sum.py
// (sorted_segment_sum_tpu: _kernel with its on-device _schedule, used by
// segment_sum_sorted_pallas and ops/geometry.py::_accumulate_sort).
// Computes out[s, c] += vals[n, c] for every row n with 0 <= lin[n] < S;
// other rows are dropped and their values never read.
//
// The TPU needed a sort and one-hot matmuls because its scatter is a
// serial loop. Hopper has f32 atomics in L2, so the design is a direct
// scatter: one thread per (row, channel), a grid-stride loop, and an
// atomicAdd whose result is unused (a fire-and-forget reduction). The
// caller hands in a zeroed output. No sort is needed.
//
// What bounds it: each key and value is read once and each cell written
// once, so device memory bounds the ideal kernel (about 58 MB per 1080p
// frame into a 256x256x32x3 grid, 17 us at 3.35 TB/s). Atomic order
// changes the add order, so results match a serial sum to f32 rounding,
// not to bits.

#include <cuda_runtime.h>

namespace {

__global__ void segment_sum_kernel(const int* __restrict__ lin, const float* __restrict__ vals,
                                   float* __restrict__ out, long long n_rows, int C,
                                   long long S) {
  const long long total = n_rows * C;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x; idx < total;
       idx += stride) {
    const long long row = idx / C;
    const int c = (int)(idx - row * C);
    const long long s = lin[row];
    if (s >= 0 && s < S) atomicAdd(out + s * C + c, vals[idx]);
  }
}

}  // namespace

extern "C" {

const char* soccdpt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// lin: (N,) int32; vals: (N, C) f32 contiguous; out: (S, C) f32, zeroed.
int soccdpt_segment_sum(const void* lin, const void* vals, void* out, long long n_rows, int C,
                        long long S, void* stream) {
  const long long total = n_rows * C;
  if (total > 0) {
    const int threads = 256;
    long long blocks = (total + threads - 1) / threads;
    if (blocks > 132LL * 64) blocks = 132LL * 64;
    segment_sum_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const int*)lin, (const float*)vals, (float*)out, n_rows, C, S);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"

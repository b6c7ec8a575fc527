// The 1080p geometry tail in one pass: inverse depth at camera resolution
// to the served camera-frame points and the occupancy voxelizer's slot
// keys, which K2 (segment_sum.cu) then sums the segmentation into.
//
// Replaces no TPU kernel: the JAX package leaves this tail to XLA
// (soccdpt_tpu/ops/geometry.py, get_semantic_occupancy: unproject_depth,
// then the scale, shift and rotation and _voxel_slots), which fuses it. In
// the port it was some 30 aten passes over the 12.4 M points of a batch-6
// request at 1080x1920 (clamp, reciprocal, the broadcasts, a stack, an f32
// GEMM of 12.4 M x 3 by 3 x 3, isfinite, the cast, the bounds reductions,
// the linear cell), about 4.9 GB of traffic and 2 ms on the H100.
//
// What bounds it: bytes. A pixel reads its inverse depth (4 bytes) and
// writes its point (12) and its slot (4): 249 MB a batch-6 request, 74 us
// at 3.35 TB/s, with a few divisions a pixel beside it. The design:
// - a CTA takes 1024 pixels of one image (blockIdx.y), a thread 4
//   consecutive ones: one float4 load of inverse depth, one int4 store of
//   slots (where H W % 4 == 0, else one pixel at a time);
// - a warp's 128 points (1536 bytes) are staged in shared memory and
//   stored as 16-byte chunks, 512 contiguous bytes a store instruction
//   (a thread's own 48 bytes would leave each store a third dense); the
//   points are stored evict-first, so that the slots K2 reads next stay
//   in the L2 longer;
// - the last warp of a ragged image walks its pixels one at a time;
// - 32-bit indices inside an image (3 H W below 2^31), one 64-bit offset
//   to the image.
//
// Arithmetic: exactly the plain path's on the card, op by op, so that the
// points equal it bit for bit (kernels/unproject_slots.py holds it):
//   depth = 1 / clamp(inv, min=1e-8)  (a NaN stays NaN, as torch.clamp keeps
//                                      it; IEEE division, as aten's reciprocal)
//   x = ((v - cx) * depth) * (1 / fx) (aten divides a tensor by a Python
//   y = ((u - cy) * depth) * (1 / fy)  scalar as a product by the scalar's
//                                      f32 reciprocal: rfx, rfy from the host)
// then for the slots: p * scale, + shift; the rotation p @ R as cuBLAS's
// f32 GEMM sums a row, fma(p2, R2j, fma(p1, R1j, p0 * R0j)); a point with
// a non-finite coordinate becomes 0; ijk = (int)((p / extent) * grid),
// truncated (and saturated) as static_cast; kept where 0 < ijk < grid;
// slot = ((i gy + j) gz + k) + b cells, or -1. Every product and sum is an
// intrinsic with its rounding, so nvcc contracts nothing into an FMA but
// the rotation's.

#include <cuda_runtime.h>
#include <stdint.h>

namespace unproject {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPixels = 4;  // a thread's consecutive pixels
constexpr int kMaxImages = 65535;  // images a launch: gridDim.y
constexpr float kMinInverseDepth = 1e-8f;

// The launch arguments: the camera, the occupancy frame and the grid
struct Tail {
  float cx, cy, rfx, rfy;  // rfx = 1 / fx in f32
  float scale[3], shift[3];
  float rot[9];  // R row-major: p @ R
  float extent[3], gridf[3];
  int grid[3];
  int H, W, cells;
};

__device__ __forceinline__ float clamp_min(float a) {
  return isnan(a) ? a : fmaxf(a, kMinInverseDepth);
}

// one pixel (u, v) of an image with inverse depth a: its point, and if
// SLOTS its slot (boff = b cells, the image's first slot)
template <bool SLOTS>
__device__ __forceinline__ void pixel(const Tail& t, float a, int boff, int u, int v, float* p,
                                      int* slot) {
  const float depth = __fdiv_rn(1.f, clamp_min(a));
  p[0] = __fmul_rn(__fmul_rn(__fsub_rn((float)v, t.cx), depth), t.rfx);
  p[1] = __fmul_rn(__fmul_rn(__fsub_rn((float)u, t.cy), depth), t.rfy);
  p[2] = depth;
  if (!SLOTS) return;
  float s[3], q[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) s[k] = __fadd_rn(__fmul_rn(p[k], t.scale[k]), t.shift[k]);
#pragma unroll
  for (int j = 0; j < 3; ++j)
    q[j] = __fmaf_rn(s[2], t.rot[6 + j], __fmaf_rn(s[1], t.rot[3 + j], __fmul_rn(s[0], t.rot[j])));
  const bool finite = isfinite(q[0]) && isfinite(q[1]) && isfinite(q[2]);
  int ijk[3];
  bool inside = finite;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    ijk[k] = __float2int_rz(__fmul_rn(__fdiv_rn(finite ? q[k] : 0.f, t.extent[k]), t.gridf[k]));
    inside = inside && ijk[k] > 0 && ijk[k] < t.grid[k];
  }
  *slot = inside ? ((ijk[0] * t.grid[1] + ijk[1]) * t.grid[2] + ijk[2]) + boff : -1;
}

// image b0 + blockIdx.y, pixels from the warp's first: inv (H W,) ->
// points (H W, 3), slot (H W,) [SLOTS]. VEC: H W % 4 == 0, so every image
// starts 16-byte aligned and whole warps take vector loads and stores.
template <bool SLOTS, bool VEC>
__global__ void __launch_bounds__(kThreads)
    unproject_slots_kernel(const float* __restrict__ inv, float* __restrict__ points,
                           int* __restrict__ slot, const Tail t, const int b0) {
  __shared__ float4 staged[kWarps * 3 * 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int hw = t.H * t.W;
  const int warp_first = (blockIdx.x * kWarps + warp) * 32 * kPixels;
  if (warp_first >= hw) return;
  const int b = b0 + blockIdx.y;
  const size_t image = (size_t)b * hw;
  inv += image;
  points += 3 * image;
  if (SLOTS) slot += image;
  const int boff = b * t.cells;
  const int first = warp_first + lane * kPixels;
  int u = first / t.W, v = first - u * t.W;
  if (VEC && warp_first + 32 * kPixels <= hw) {  // a whole warp of pixels
    const float4 a4 = *reinterpret_cast<const float4*>(inv + first);
    const float a[kPixels] = {a4.x, a4.y, a4.z, a4.w};
    float p[3 * kPixels];
    int s[kPixels];
#pragma unroll
    for (int i = 0; i < kPixels; ++i) {
      pixel<SLOTS>(t, a[i], boff, u, v, p + 3 * i, s + i);
      if (++v == t.W) v = 0, ++u;
    }
    float4* mine = staged + warp * 3 * 32;  // the warp's 128 points
#pragma unroll
    for (int c = 0; c < 3; ++c)
      mine[3 * lane + c] = make_float4(p[4 * c], p[4 * c + 1], p[4 * c + 2], p[4 * c + 3]);
    __syncwarp();
    float4* out = reinterpret_cast<float4*>(points + 3 * warp_first);
#pragma unroll
    for (int c = 0; c < 3; ++c) __stcs(out + 32 * c + lane, mine[32 * c + lane]);
    if (SLOTS) *reinterpret_cast<int4*>(slot + first) = make_int4(s[0], s[1], s[2], s[3]);
    return;
  }
  for (int i = 0; i < kPixels && first + i < hw; ++i) {  // one pixel at a time
    float p[3];
    int s = -1;
    pixel<SLOTS>(t, inv[first + i], boff, u, v, p, &s);
    points[3 * (first + i)] = p[0];
    points[3 * (first + i) + 1] = p[1];
    points[3 * (first + i) + 2] = p[2];
    if (SLOTS) slot[first + i] = s;
    if (++v == t.W) v = 0, ++u;
  }
}

template <bool SLOTS>
int launch_all(const float* inv, float* points, int* slot, const Tail& t, int B,
               cudaStream_t stream) {
  const int per_block = kThreads * kPixels;
  const unsigned blocks = (unsigned)((t.H * t.W + per_block - 1) / per_block);
  const bool vec = (t.H * t.W) % 4 == 0;
  for (int b0 = 0; b0 < B; b0 += kMaxImages) {  // gridDim.y is at most 65535
    const dim3 grid(blocks, (unsigned)(B - b0 < kMaxImages ? B - b0 : kMaxImages));
    if (vec)
      unproject_slots_kernel<SLOTS, true><<<grid, kThreads, 0, stream>>>(inv, points, slot, t, b0);
    else
      unproject_slots_kernel<SLOTS, false><<<grid, kThreads, 0, stream>>>(inv, points, slot, t,
                                                                          b0);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace unproject

extern "C" {

const char* soccdpt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// inv: (B, H, W) f32, contiguous, 16-byte aligned; points: (B, H, W, 3) f32
// and slot: (B H W,) int32, both new (16-byte aligned); slot null: points
// only. params (host memory, read here): cx, cy, 1/fx, 1/fy (f32), the
// point scale (3) and shift (3), R row-major (9), the grid's extent in
// meters (3); grid (host): the grid's cells along x, y, z. 3 H W, and with
// slots B (cells + 1), must stay below 2^31. One launch for each 65535
// images.
int soccdpt_unproject_slots(const void* inv, void* points, void* slot, int B, int H, int W,
                            const float* params, const int* grid, void* stream) {
  using namespace unproject;
  if (B == 0 || H == 0 || W == 0) return (int)cudaGetLastError();
  const long long cells = (long long)grid[0] * grid[1] * grid[2];
  if (B < 0 || H < 0 || W < 0 || 3LL * H * W >= (1LL << 31) || grid[0] < 1 || grid[1] < 1 ||
      grid[2] < 1 || (slot && (long long)B * (cells + 1) >= (1LL << 31)) ||
      ((uintptr_t)inv | (uintptr_t)points | (uintptr_t)slot) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  Tail t;
  t.cx = params[0];
  t.cy = params[1];
  t.rfx = params[2];
  t.rfy = params[3];
  for (int k = 0; k < 3; ++k) {
    t.scale[k] = params[4 + k];
    t.shift[k] = params[7 + k];
    t.extent[k] = params[19 + k];
    t.grid[k] = grid[k];
    t.gridf[k] = (float)grid[k];
  }
  for (int k = 0; k < 9; ++k) t.rot[k] = params[10 + k];
  t.H = H;
  t.W = W;
  t.cells = slot ? (int)cells : 0;
  const cudaStream_t s = (cudaStream_t)stream;
  if (slot) return launch_all<true>((const float*)inv, (float*)points, (int*)slot, t, B, s);
  return launch_all<false>((const float*)inv, (float*)points, nullptr, t, B, s);
}

}  // extern "C"

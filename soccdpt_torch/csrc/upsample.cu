// The C entry of the bf16 2x upsample (upsample.cuh, where its design is
// described), launched by kernels/upsample.py for the DPT decoder and for
// the bf16 routes of K4 and K5. Replaces no TPU kernel: the JAX package
// upsamples through interpolation matrices that XLA multiplies. aten's
// upsample_bilinear2d, which the decoder calls otherwise, reaches about 8 %
// of the bytes bound at the served shapes on the H100.

#include "upsample.cuh"

extern "C" {

const char* soccdpt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// y: (B, H, W, C), out: (B, 2H, 2W, C), bf16, contiguous; 16-byte chunks of
// 8 channels when C % 8 == 0 and both pointers are 16-byte aligned, single
// channels otherwise. rows: output rows a CTA walks (>= 1). An image of the
// output must hold fewer than 2^31 values, B at most 65535.
int soccdpt_upsample2x_bf16(const void* y, void* out, int B, int H, int W, int C, int rows,
                            void* stream) {
  if (B == 0 || H == 0 || W == 0 || C == 0) return (int)cudaGetLastError();
  if (B < 0 || H < 0 || W < 0 || C < 0 || rows < 1 || B > 65535 ||
      4LL * H * W * C >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const bool wide = C % 8 == 0 && ((uintptr_t)y | (uintptr_t)out) % 16 == 0;
  const int chunks = 2 * W * (wide ? C / 8 : C);
  const dim3 grid((unsigned)((chunks + UP_THREADS - 1) / UP_THREADS),
                  (unsigned)((2 * H + rows - 1) / rows), (unsigned)B);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  const float sh = scale_2x(H), sw = scale_2x(W);
  const cudaStream_t s = (cudaStream_t)stream;
  if (wide)
    upsample2x_bf16<8><<<grid, UP_THREADS, 0, s>>>((const __nv_bfloat16*)y, (__nv_bfloat16*)out,
                                                   H, W, C, rows, sh, sw);
  else
    upsample2x_bf16<1><<<grid, UP_THREADS, 0, s>>>((const __nv_bfloat16*)y, (__nv_bfloat16*)out,
                                                   H, W, C, rows, sh, sw);
  return (int)cudaGetLastError();
}

}  // extern "C"

// The C entries of K3's and K4's bf16 route (fused_rcu.cu, fused_fusion.cu):
// one tensor-core convolution, and a call's preparation, in each library
// that includes this header.

#pragma once

#include "conv_wgmma.cuh"

extern "C" {

// One convolution: taps 9 with epilogue 0 (conv1 of a residual conv unit)
// or 1 (conv2, with the residual), taps 1 with epilogue 2 (K4's 1x1 conv
// and its bias). src, residual, out: (B, H, W, C) bf16, C a multiple of 8;
// w: bf16 [taps][C][C]; bias: (C,) f32; config: the tile
// (kernels/_conv.py, WGMMA_TILES); splits divides taps * ceil(C / 64);
// partials and counters as the planner sizes them when splits > 1.
int soccdpt_conv_bf16(const void* src, const void* w, const void* bias, const void* residual,
                      void* out, void* partials, void* counters, int B, int H, int W, int C,
                      int taps, int epilogue, int config, int splits, void* stream) {
  if (B == 0 || H == 0 || W == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (taps == 9 && epilogue == wgconv::EPI_CONV1)
    return wgconv::dispatch_conv<9, wgconv::EPI_CONV1>(config, src, w, bias, residual, out,
                                                       partials, counters, B, H, W, C, splits, s);
  if (taps == 9 && epilogue == wgconv::EPI_RESIDUAL)
    return wgconv::dispatch_conv<9, wgconv::EPI_RESIDUAL>(config, src, w, bias, residual, out,
                                                          partials, counters, B, H, W, C, splits,
                                                          s);
  if (taps == 1 && epilogue == wgconv::EPI_BIAS)
    return wgconv::dispatch_conv<1, wgconv::EPI_BIAS>(config, src, w, bias, residual, out,
                                                      partials, counters, B, H, W, C, splits, s);
  return (int)cudaErrorInvalidValue;
}

// A call's preparation, one launch: n <= 3 weights, each an HWIO view
// (kh, kw, C, C) of f32 or bf16 with element strides strides[4 i .. 4 i + 3]
// and taps[i] of 9 or 1, to bf16 [tap][C][C] in out[i]; and n_counters
// split-K counters to zero (counters may be null).
int soccdpt_prepare_bf16(int n, const void* const* w, const long long* strides, const int* taps,
                         const int* is_bf16, void* const* out, void* counters, int n_counters,
                         int C, void* stream) {
  return wgconv::prepare(n, w, strides, taps, is_bf16, out, counters, n_counters, C,
                         (cudaStream_t)stream);
}

}  // extern "C"

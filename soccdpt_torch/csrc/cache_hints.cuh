// L2 eviction hints for kernels whose output should stay in the L2 while
// their inputs stream past it (K2's grid: segment_sum.cu).
#pragma once
#include <cuda_runtime.h>

namespace hints {

// A policy that marks the lines an access touches as last to evict.
__device__ __forceinline__ unsigned long long keep_in_l2() {
  unsigned long long policy;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(policy));
  return policy;
}

// *p += v in the L2, no value returned (a RED), under ``policy``.
__device__ __forceinline__ void red_add(float* p, float v, unsigned long long policy) {
  asm volatile("red.global.add.L2::cache_hint.f32 [%0], %1, %2;" ::"l"(p), "f"(v), "l"(policy)
               : "memory");
}

}  // namespace hints

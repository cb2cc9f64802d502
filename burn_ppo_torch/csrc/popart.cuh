// PopArt's std and denormalisation, shared by K15/K16 (csrc/popart.cu)
// and K2's value epilogue (csrc/masked_gumbel_sample.cu), so that both
// round as the plain version does (burn_ppo_torch/ppo/normalization.py
// PopArtState.std, popart_denormalize_plain): each operation rounded on
// its own (__fdiv_rn, __fadd_rn, __fmul_rn: no contraction into an fma).

#pragma once

#include <cuda_runtime.h>

namespace popart {

constexpr float EPS = 1e-4f;

// 1 before two samples, else sqrt(m2 / max(count, 1) + eps).
__device__ __forceinline__ float std_of(float m2, float count) {
  if (count < 2.0f) return 1.0f;
  return sqrtf(__fadd_rn(__fdiv_rn(m2, fmaxf(count, 1.0f)), EPS));
}

// v * std + mean once the count is >= 2, else v.
__device__ __forceinline__ float denormalize(float v, float mean, float m2, float count) {
  return count < 2.0f ? v : __fadd_rn(__fmul_rn(v, std_of(m2, count)), mean);
}

}  // namespace popart

// K14's row code: action mask, per-row temperature, and a Gumbel-max
// sample (temperature > 0) or the greedy action (temperature <= 0), for the
// standalone sampler (csrc/temperature_sample.cu) and for the sampling
// front of the env step kernels (cartpole_step.cu, connect_four_step.cu,
// skull_step.cu, liars_dice_step.cu), which eval's stats engine launches
// once a step in place of the sampler and the step apart.
//
// K2's row layout (csrc/masked_gumbel_sample.cu): G lanes a row, each lane
// every G-th entry, rows read where they lie; G = 16 for A > 8 and G = 2
// for A <= 8; a warp takes 32 / G consecutive rows; the argmax is a warp
// shuffle inside the row's G lanes. A row's temperature picks its branch,
// the same for all its lanes. Greedy rows read no uniforms.
//
// Semantics, each operation as the plain version
// (burn_ppo_torch/ops/categorical.py sample_with_temperature_plain) does
// it, so that the actions are the plain version's bit for bit:
//   * masked = logits + (mask != 0 ? 0 : -1e9)  (additive, finite);
//     without a mask, masked = logits;
//   * t > 0: action = argmax(masked / max(t, 1e-8) + (-log(-log(u)))),
//     a true division (no reciprocal product), u in [tiny, 1) supplied by
//     the caller; the FIRST maximum wins a tie (jax.random.categorical's
//     argmax): a lane keeps its first maximum, and across lanes the lower
//     index wins a tie;
//   * t <= 0: action = the LAST maximal index of masked (the reference's
//     Iterator::max_by): a lane keeps its last maximum (>=), and across
//     lanes the higher index wins a tie.
// Compiled without --use_fast_math: logf and the division are the
// accurate ones.

#pragma once

#include <cuda_runtime.h>

#include <cmath>

namespace temp_sample {

constexpr float MASK_NEG = -1.0e9f;
constexpr float MIN_TEMP = 1.0e-8f;
constexpr int MAX_ACTIONS = 64;

// What the sampling front reads and writes: logits, mask (nullable) and
// uniforms [E, A], the temperatures [E] (nullable: every row takes
// ``temp``), and the actions [E] it stores beside the ones it hands to the
// step.
struct Front {
  const float* logits;
  const float* mask;
  const float* temps;
  float temp;
  const float* uniforms;
  int* actions;
};

// The front of a C entry's arguments.
inline Front front_of(const void* logits, const void* mask, const void* temps, float temp,
                      const void* uniforms, int* actions) {
  return Front{static_cast<const float*>(logits), static_cast<const float*>(mask),
               static_cast<const float*>(temps), temp, static_cast<const float*>(uniforms),
               actions};
}

// (value, index) of the better of two candidates; index -1 is no
// candidate. A tie goes to the lower index (first) or the higher (last).
template <bool FIRST>
__device__ __forceinline__ void better(float& v, int& j, float v2, int j2) {
  if (j2 >= 0 && (j < 0 || v2 > v || (v2 == v && (FIRST ? j2 < j : j2 > j)))) {
    v = v2;
    j = j2;
  }
}

// One warp's rows [row0, row0 + nrows), nrows <= 32 / G: the action of
// row row0 + lane / G, valid in the lanes of a live row (lane / G < nrows).
// Every lane of the warp must call it.
template <int G>
__device__ __forceinline__ int sample_rows(const Front& f, long row0, int nrows, int A,
                                           int lane) {
  constexpr int EPL = G >= 8 ? MAX_ACTIONS / G : 8 / G;  // entries per lane, at most
  const int rr = lane / G, sub = lane % G;
  const bool live = rr < nrows;
  const long base = (row0 + rr) * A;
  const float t = live ? (f.temps != nullptr ? f.temps[row0 + rr] : f.temp) : 0.0f;
  const bool greedy = t <= 0.0f;
  const float safe_t = fmaxf(t, MIN_TEMP);

  float best = -INFINITY;
  int best_j = -1;
#pragma unroll
  for (int k = 0; k < EPL; ++k) {
    const int j = sub + k * G;
    if (live && j < A) {
      float x = f.logits[base + j];
      if (f.mask != nullptr) x += (f.mask[base + j] != 0.0f) ? 0.0f : MASK_NEG;
      if (greedy) {
        if (best_j < 0 || x >= best) {  // '>=' keeps the last maximum
          best = x;
          best_j = j;
        }
      } else {
        const float y = x / safe_t + (-logf(-logf(f.uniforms[base + j])));
        if (best_j < 0 || y > best) {  // '>' keeps the first maximum
          best = y;
          best_j = j;
        }
      }
    }
  }
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) {
    const float v2 = __shfl_xor_sync(0xffffffffu, best, o);
    const int j2 = __shfl_xor_sync(0xffffffffu, best_j, o);
    if (greedy) {
      better<false>(best, best_j, v2, j2);
    } else {
      better<true>(best, best_j, v2, j2);
    }
  }
  return best_j;
}

// The sampling front of an env step block: the actions of the block's
// envs [e0, e0 + count) into ``act`` (shared memory, one an env) and
// f.actions, the block's NW warps taking 32 / G rows at a time. Every
// thread of the block calls it; the caller's __syncthreads() makes ``act``
// visible to the stepping threads.
template <int A, int NW>
__device__ __forceinline__ void sample_block(const Front& f, long e0, int count, int* act) {
  constexpr int G = A > 8 ? 16 : 2;  // lanes a row
  constexpr int RW = 32 / G;
  static_assert(A >= 1 && A <= MAX_ACTIONS, "the row code takes 1-64 actions");
  const int warp = static_cast<int>(threadIdx.x) >> 5, lane = static_cast<int>(threadIdx.x) & 31;
  for (int r0 = warp * RW; r0 < count; r0 += NW * RW) {  // warp-uniform bounds
    const int nrows = min(RW, count - r0);
    const int a = sample_rows<G>(f, e0 + r0, nrows, A, lane);
    if (lane % G == 0 && lane / G < nrows) {
      act[r0 + lane / G] = a;
      f.actions[e0 + r0 + lane / G] = a;
    }
  }
}

}  // namespace temp_sample

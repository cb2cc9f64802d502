// K14 temperature_sample — action mask, per-row temperature, and a
// Gumbel-max sample (temperature > 0) or the greedy action (temperature
// <= 0) for one step of eval's stats engine, one launch.
//
// Replaces the XLA fusion of burn_ppo_tpu/ops/categorical.py
// sample_with_temperature (84-111) after apply_action_mask, as used at
// burn_ppo_tpu/eval.py:577-579 (ROADMAP queue B, item B16). Plain PyTorch
// twin: burn_ppo_torch/ops/categorical.py sample_with_temperature_plain.
//
// What bounds it on an H100: launch latency, then bytes. Eval steps 64
// envs by default (a tournament pod at most num_envs), so a launch reads
// [64, A <= 49] logits, mask and uniforms (~38 KB) and writes 256 bytes;
// watch mode and human play step one env. The eager version is ~12
// kernels (mask add, clamp, divide, two logs, add, argmax, flip, argmax,
// compare, select).
//
// The design is K2's (csrc/masked_gumbel_sample.cu): G lanes a row, each
// lane every G-th entry, rows read where they lie; G = 16 for A > 8 and
// G = 2 for A <= 8; a warp takes 32 / G consecutive rows and a block two
// warps; the argmax is a warp shuffle inside the row's G lanes. A row's
// temperature picks its branch, the same for all its lanes. Greedy rows
// read no uniforms.
//
// Semantics, each operation as the plain version does it, so that the
// actions are the plain version's bit for bit:
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

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr float MASK_NEG = -1.0e9f;
constexpr float MIN_TEMP = 1.0e-8f;
constexpr int MAX_ACTIONS = 64;
constexpr int WARPS = 2;  // per block

// (value, index) of the better of two candidates; index -1 is no
// candidate. A tie goes to the lower index (first) or the higher (last).
template <bool FIRST>
__device__ __forceinline__ void better(float& v, int& j, float v2, int j2) {
  if (j2 >= 0 && (j < 0 || v2 > v || (v2 == v && (FIRST ? j2 < j : j2 > j)))) {
    v = v2;
    j = j2;
  }
}

template <int G>
__global__ void __launch_bounds__(32 * WARPS) temperature_sample_kernel(
    const float* __restrict__ logits, const float* __restrict__ mask,
    const float* __restrict__ temps, float temp, const float* __restrict__ uniforms,
    int* __restrict__ actions, int rows, int A) {
  constexpr int RW = 32 / G;                             // rows per warp
  constexpr int EPL = G >= 8 ? MAX_ACTIONS / G : 8 / G;  // entries per lane, at most
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long row0 = (static_cast<long>(blockIdx.x) * WARPS + warp) * RW;
  if (row0 >= rows) return;
  const int nrows = static_cast<int>(min(static_cast<long>(RW), rows - row0));
  const int rr = lane / G, sub = lane % G;
  const bool live = rr < nrows;
  const long base = (row0 + rr) * A;
  const float t = live ? (temps != nullptr ? temps[row0 + rr] : temp) : 0.0f;
  const bool greedy = t <= 0.0f;
  const float safe_t = fmaxf(t, MIN_TEMP);

  float best = -INFINITY;
  int best_j = -1;
#pragma unroll
  for (int k = 0; k < EPL; ++k) {
    const int j = sub + k * G;
    if (live && j < A) {
      float x = logits[base + j];
      if (mask != nullptr) x += (mask[base + j] != 0.0f) ? 0.0f : MASK_NEG;
      if (greedy) {
        if (best_j < 0 || x >= best) {  // '>=' keeps the last maximum
          best = x;
          best_j = j;
        }
      } else {
        const float y = x / safe_t + (-logf(-logf(uniforms[base + j])));
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
  if (live && sub == 0) actions[row0 + rr] = best_j;
}

template <int G>
cudaError_t launch(const float* logits, const float* mask, const float* temps, float temp,
                   const float* uniforms, int* actions, int rows, int A, cudaStream_t stream) {
  const long warps = (static_cast<long>(rows) + 32 / G - 1) / (32 / G);
  const int blocks = static_cast<int>((warps + WARPS - 1) / WARPS);
  temperature_sample_kernel<G><<<blocks, 32 * WARPS, 0, stream>>>(
      logits, mask, temps, temp, uniforms, actions, rows, A);
  return cudaGetLastError();
}

}  // namespace

// temps may be null: then every row takes ``temp``.
extern "C" int temperature_sample(const void* logits, const void* mask, const void* temps,
                                  float temp, const void* uniforms, void* actions, int rows,
                                  int num_actions, void* stream) {
  if (num_actions < 1 || num_actions > MAX_ACTIONS) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows <= 0) return 0;
  const auto* l = static_cast<const float*>(logits);
  const auto* m = static_cast<const float*>(mask);
  const auto* tp = static_cast<const float*>(temps);
  const auto* u = static_cast<const float*>(uniforms);
  auto* a = static_cast<int*>(actions);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = num_actions > 8
                              ? launch<16>(l, m, tp, temp, u, a, rows, num_actions, s)
                              : launch<2>(l, m, tp, temp, u, a, rows, num_actions, s);
  return static_cast<int>(err);
}

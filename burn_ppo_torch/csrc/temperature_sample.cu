// K14 temperature_sample — action mask, per-row temperature, and a
// Gumbel-max sample (temperature > 0) or the greedy action (temperature
// <= 0), one launch: the sampler of the callers that step one env and need
// the action on the host (watch mode, human play, the Skull assistant).
// Eval's stats engine samples in the env step's launch instead (the same
// row code, csrc/temperature_sample.cuh, as the step kernels' sampling
// front).
//
// Replaces the XLA fusion of burn_ppo_tpu/ops/categorical.py
// sample_with_temperature (84-111) after apply_action_mask, as used at
// burn_ppo_tpu/eval.py:577-579 and 692-693 (ROADMAP queue B, item B16).
// Plain PyTorch twin: burn_ppo_torch/ops/categorical.py
// sample_with_temperature_plain.
//
// What bounds it on an H100: launch latency, then bytes: one env's row of
// logits, mask and uniforms (a few hundred bytes) and one action. The
// eager version is ~12 kernels (mask add, clamp, divide, two logs, add,
// argmax, flip, argmax, compare, select).
//
// The design and the semantics are the row code's (temperature_sample.cuh):
// a warp takes 32 / G consecutive rows and a block two warps.

#include <cuda_runtime.h>

#include "temperature_sample.cuh"

namespace {

using temp_sample::Front;
using temp_sample::MAX_ACTIONS;
constexpr int WARPS = 2;  // per block

template <int G>
__global__ void __launch_bounds__(32 * WARPS) temperature_sample_kernel(Front f, int rows, int A) {
  constexpr int RW = 32 / G;  // rows per warp
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long row0 = (static_cast<long>(blockIdx.x) * WARPS + warp) * RW;
  if (row0 >= rows) return;
  const int nrows = static_cast<int>(min(static_cast<long>(RW), rows - row0));
  const int a = temp_sample::sample_rows<G>(f, row0, nrows, A, lane);
  if (lane % G == 0 && lane / G < nrows) f.actions[row0 + lane / G] = a;
}

template <int G>
cudaError_t launch(const Front& f, int rows, int A, cudaStream_t stream) {
  const long warps = (static_cast<long>(rows) + 32 / G - 1) / (32 / G);
  const int blocks = static_cast<int>((warps + WARPS - 1) / WARPS);
  temperature_sample_kernel<G><<<blocks, 32 * WARPS, 0, stream>>>(f, rows, A);
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
  const Front f = temp_sample::front_of(logits, mask, temps, temp, uniforms,
                                        static_cast<int*>(actions));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = num_actions > 8 ? launch<16>(f, rows, num_actions, s)
                                          : launch<2>(f, rows, num_actions, s);
  return static_cast<int>(err);
}

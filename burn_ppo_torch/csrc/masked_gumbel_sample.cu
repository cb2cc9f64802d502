// K2 masked_gumbel_sample — action mask, Gumbel-max sample and log pi(a)
// for one rollout step, one launch.
//
// Replaces the XLA fusion of burn_ppo_tpu/ops/categorical.py
// apply_action_mask + sample_categorical (jax.random.categorical) +
// log_prob_categorical (27-81) as used at burn_ppo_tpu/ppo/rollout.py:249-252
// (ROADMAP queue B, item B2). Plain PyTorch twin:
// burn_ppo_torch/ops/categorical.py masked_sample_plain.
//
// What bounds it on an H100: launch latency. At E = 4096, A = 2 a launch
// reads 3 x 32 KB (logits, mask, uniforms) and writes 32 KB; the eager
// version is ~15 kernels (mask add, two logs, add, argmax, log_softmax's
// max/sub/exp/sum/log, gather). The design: one thread per row, the row
// (A <= 64) held in registers/local memory, one launch for all of it.
//
// Semantics:
//   * masked = logits + (mask != 0 ? 0 : -1e9)  (additive mask, finite);
//   * Gumbel noise -log(-log(u)) with u in [tiny, 1) supplied by the caller
//     (the port's explicit random source, so tests can replay JAX's draws);
//   * action = argmax(masked + noise), FIRST maximum on ties (jnp.argmax);
//   * log pi(a) = (masked[a] - max) - log(sum exp(masked - max)), the
//     order of jax.nn.log_softmax.
// Compiled without --use_fast_math: logf/expf are the accurate ones.

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr float MASK_NEG = -1.0e9f;
constexpr int MAX_ACTIONS = 64;

__global__ void masked_gumbel_sample_kernel(
    const float* __restrict__ logits, const float* __restrict__ mask,
    const float* __restrict__ uniforms, int* __restrict__ actions,
    float* __restrict__ log_probs, int rows, int num_actions) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const float* lrow = logits + static_cast<long>(r) * num_actions;
  const float* urow = uniforms + static_cast<long>(r) * num_actions;
  const float* mrow =
      mask == nullptr ? nullptr : mask + static_cast<long>(r) * num_actions;

  float masked[MAX_ACTIONS];
  float row_max = -INFINITY;
  float best = -INFINITY;
  int best_a = 0;
  for (int a = 0; a < num_actions; ++a) {
    float m = lrow[a];
    if (mrow != nullptr) m += (mrow[a] != 0.0f) ? 0.0f : MASK_NEG;
    masked[a] = m;
    row_max = fmaxf(row_max, m);
    const float noisy = m + (-logf(-logf(urow[a])));
    if (a == 0 || noisy > best) {  // strict '>' keeps the first maximum
      best = noisy;
      best_a = a;
    }
  }
  float sum = 0.0f;
  for (int a = 0; a < num_actions; ++a) sum += expf(masked[a] - row_max);
  actions[r] = best_a;
  log_probs[r] = (masked[best_a] - row_max) - logf(sum);
}

}  // namespace

extern "C" int masked_gumbel_sample(const void* logits, const void* mask,
                                    const void* uniforms, void* actions,
                                    void* log_probs, int rows, int num_actions,
                                    void* stream) {
  if (num_actions < 1 || num_actions > MAX_ACTIONS) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows <= 0) return 0;
  const int threads = 256;
  const int blocks = (rows + threads - 1) / threads;
  masked_gumbel_sample_kernel<<<blocks, threads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logits), static_cast<const float*>(mask),
      static_cast<const float*>(uniforms), static_cast<int*>(actions),
      static_cast<float*>(log_probs), rows, num_actions);
  return static_cast<int>(cudaGetLastError());
}

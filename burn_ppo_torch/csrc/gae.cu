// K3 gae_reverse_scan — single-player GAE(gamma, lambda) over a [T, E]
// rollout, one launch.
//
// Replaces the XLA reverse lax.scan of burn_ppo_tpu/ops/gae.py compute_gae
// (30-53) (ROADMAP queue B, item B4). Plain PyTorch twin:
// burn_ppo_torch/ops/gae.py compute_gae_plain.
//
// What bounds it on an H100: launch latency, then bytes. At [128, 4096]
// it reads 3 x 2 MB and writes 2 x 2 MB (~10 MB, ~3 us of HBM time); the
// eager version is a Python loop of T steps x ~8 elementwise kernels,
// ~1000 launches. The design: one thread per env walks t = T-1 ... 0 with
// the (next_value, gae) carry in registers; at each t a warp touches 32
// contiguous envs, so every load and store is coalesced.
//
// Recurrence (gae.py:41-53), in the reference's operation order:
//   not_done = 1 - done
//   delta    = reward + gamma * next_value * not_done - value
//   gae      = delta + gamma_lambda * not_done * gae
//   next_value = value; returns = gae + value
// gamma_lambda is gamma * lambda formed on the host in double, as the
// reference forms it from two Python floats.

#include <cuda_runtime.h>

namespace {

__global__ void gae_reverse_scan_kernel(
    const float* __restrict__ rewards, const float* __restrict__ values,
    const float* __restrict__ dones, const float* __restrict__ last_values,
    float* __restrict__ advantages, float* __restrict__ returns, int T, int E,
    float gamma, float gamma_lambda) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  float next_value = last_values[e];
  float gae = 0.0f;
  for (int t = T - 1; t >= 0; --t) {
    const long i = static_cast<long>(t) * E + e;
    const float value = values[i];
    const float not_done = 1.0f - dones[i];
    const float delta = rewards[i] + gamma * next_value * not_done - value;
    gae = delta + gamma_lambda * not_done * gae;
    advantages[i] = gae;
    returns[i] = gae + value;
    next_value = value;
  }
}

}  // namespace

extern "C" int gae_reverse_scan(const void* rewards, const void* values,
                                const void* dones, const void* last_values,
                                void* advantages, void* returns, int T, int E,
                                float gamma, float gamma_lambda, void* stream) {
  if (T <= 0 || E <= 0) return 0;
  const int threads = 128;
  const int blocks = (E + threads - 1) / threads;
  gae_reverse_scan_kernel<<<blocks, threads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rewards), static_cast<const float*>(values),
      static_cast<const float*>(dones), static_cast<const float*>(last_values),
      static_cast<float*>(advantages), static_cast<float*>(returns), T, E,
      gamma, gamma_lambda);
  return static_cast<int>(cudaGetLastError());
}

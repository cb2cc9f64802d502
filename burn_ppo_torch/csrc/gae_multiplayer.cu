// K5 gae_multiplayer_reverse_scan — turn-based multiplayer GAE(gamma,
// lambda) with reward attribution over a [T, E, P] rollout, one launch.
//
// Replaces the XLA reverse lax.scan of burn_ppo_tpu/ops/gae.py
// compute_gae_multiplayer (56-127) (ROADMAP queue B, item B9). Plain
// PyTorch twin: burn_ppo_torch/ops/gae.py compute_gae_multiplayer_plain.
//
// What bounds it on an H100: launch latency, then bytes. At [64, 4096, 2]
// it reads the rewards (2 MB), values, dones and acting players (1 MB
// each) and writes advantages and returns (1 MB each): ~7 MB, a few
// microseconds of HBM time. The eager version is a Python loop of T steps
// x ~25 elementwise kernels. The design: one thread per env walks
// t = T-1 ... 0 with the three [P] carries (reward attribution, per-player
// GAE, per-player next value) in registers; P is a template parameter
// (1..8) and every seat access is an unrolled compare with the acting
// player, so no carry spills to local memory. A thread reads its P
// rewards as one contiguous run, so a warp reads 32 * P neighbouring
// floats.
//
// Recurrence, per step in the reference's order (gae.py:85-117), with
// a = acting player and onehot(p) = (p == a):
//   reward_carry *= 1 - done          (before attribution: no credit
//                                      crosses an episode boundary)
//   attributed = reward[a] + reward_carry[a]
//   reward_carry[p] = p == a ? 0 : reward_carry[p] + reward[p]
//   gae_carry *= 1 - done
//   if done > 0.5: next_value[p] = p == a ? next_value[p] : 0
//   delta = attributed + gamma * next_value[a] * (1 - done) - value
//   adv = delta + gamma_lambda * (1 - done) * gae_carry[a]
//   gae_carry[a] = adv; next_value[a] = value; returns = adv + value
// An acting index outside [0, P) selects no seat, as a one-hot of it would.
// gamma_lambda is gamma * lambda formed on the host in double, as the
// reference forms it from two Python floats.

#include <cuda_runtime.h>

namespace {

constexpr int MAX_PLAYERS = 8;

template <int P>
__global__ void gae_multiplayer_kernel(
    const float* __restrict__ all_rewards, const float* __restrict__ values,
    const float* __restrict__ dones, const int* __restrict__ acting,
    const float* __restrict__ last_vpp, float* __restrict__ advantages,
    float* __restrict__ returns, int T, int E, float gamma,
    float gamma_lambda) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  float reward_carry[P], gae_carry[P], next_value[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    reward_carry[p] = 0.0f;
    gae_carry[p] = 0.0f;
    next_value[p] = last_vpp[static_cast<long>(e) * P + p];
  }
  for (int t = T - 1; t >= 0; --t) {
    const long i = static_cast<long>(t) * E + e;
    const float* r = all_rewards + i * P;
    const float done = dones[i];
    const float value = values[i];
    const int a = acting[i];
    const float keep = 1.0f - done;

    float attributed = 0.0f, nv_acting = 0.0f, gae_acting = 0.0f;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const float rp = r[p];
      reward_carry[p] *= keep;
      gae_carry[p] *= keep;
      if (done > 0.5f && p != a) next_value[p] = 0.0f;
      if (p == a) {
        attributed = rp + reward_carry[p];
        reward_carry[p] = 0.0f;
        nv_acting = next_value[p];
        gae_acting = gae_carry[p];
      } else {
        reward_carry[p] += rp;
      }
    }
    const float delta = attributed + gamma * nv_acting * keep - value;
    const float adv = delta + gamma_lambda * keep * gae_acting;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      if (p == a) {
        gae_carry[p] = adv;
        next_value[p] = value;
      }
    }
    advantages[i] = adv;
    returns[i] = adv + value;
  }
}

template <int P>
cudaError_t launch(const void* all_rewards, const void* values,
                   const void* dones, const void* acting, const void* last_vpp,
                   void* advantages, void* returns, int T, int E, float gamma,
                   float gamma_lambda, cudaStream_t stream) {
  const int threads = 128;
  const int blocks = (E + threads - 1) / threads;
  gae_multiplayer_kernel<P><<<blocks, threads, 0, stream>>>(
      static_cast<const float*>(all_rewards), static_cast<const float*>(values),
      static_cast<const float*>(dones), static_cast<const int*>(acting),
      static_cast<const float*>(last_vpp), static_cast<float*>(advantages),
      static_cast<float*>(returns), T, E, gamma, gamma_lambda);
  return cudaGetLastError();
}

}  // namespace

extern "C" int gae_multiplayer_reverse_scan(
    const void* all_rewards, const void* values, const void* dones,
    const void* acting, const void* last_vpp, void* advantages, void* returns,
    int T, int E, int P, float gamma, float gamma_lambda, void* stream) {
  if (P < 1 || P > MAX_PLAYERS) return static_cast<int>(cudaErrorInvalidValue);
  if (T <= 0 || E <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  switch (P) {
#define CASE(n)                                                                \
  case n:                                                                      \
    err = launch<n>(all_rewards, values, dones, acting, last_vpp, advantages,  \
                    returns, T, E, gamma, gamma_lambda, s);                    \
    break;
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
#undef CASE
  }
  return static_cast<int>(err);
}

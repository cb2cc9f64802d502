// K1 cartpole_step_autoreset — CartPole step + auto-reset + obs, one launch
// per env step.
//
// Replaces the XLA fusion of burn_ppo_tpu/envs/cartpole.py CartPole.step
// (69-112), CartPole.obs and CartPole.reset (55-67) under
// burn_ppo_tpu/envs/base.py autoreset_step (234-274), vmapped over envs
// (ROADMAP queue B, item B1). Plain PyTorch twin:
// burn_ppo_torch/envs/base.py autoreset_step, used for CPU tensors.
//
// What bounds it on an H100: bytes and launch latency, not arithmetic.
// Per env it reads 4 physics floats, step_idx, the two episode
// accumulators, the action and 4 reset values (40 B) and writes the next
// state and accumulators, reward, done, the episode log (3 values) and the
// 5-wide obs (~68 B): about 110 B per env step. At E = 4096 that is
// ~0.45 MB per launch, under a microsecond of HBM time, so the launch
// itself (a few microseconds) dominates. Eager PyTorch runs the same step
// as ~30-40 separate elementwise kernels; the design answer is one launch,
// one thread per env, coalesced struct-of-arrays loads and stores.
//
// Semantics (must match the reference bit-for-bit in control flow):
//   * semi-implicit Euler with the f32 constants of cartpole.py:19-29;
//   * a failure terminal pays 0, a timeout (step 500) pays 1;
//   * the episode log is captured from the stepped state BEFORE the reset
//     replaces it; on done the state becomes the reset values with step 0
//     and the accumulators restart at 0;
//   * obs = (x, x_dot, theta, theta_dot, step_idx / 500) of the post-reset
//     state;
//   * one player: the outcome is place 1, one active player, and the
//     action mask of the post-reset state is all ones.
// Compiled without --use_fast_math: sinf/cosf are the accurate ones.

#include <cuda_runtime.h>

namespace {

constexpr float GRAVITY = 9.8f;
constexpr float POLE_MASS = 0.1f;
constexpr float TOTAL_MASS = 1.1f;           // 1.0 + 0.1 in double, then f32
constexpr float POLE_HALF_LENGTH = 0.5f;
constexpr float POLE_MASS_LENGTH = 0.05f;    // 0.1 * 0.5 in double, then f32
constexpr float FORCE_MAG = 10.0f;
constexpr float TAU = 0.02f;
constexpr float X_THRESHOLD = 2.4f;
constexpr float THETA_THRESHOLD = 0.20943951023931953f;  // 12 * pi / 180
constexpr float FOUR_THIRDS = 1.3333333333333333f;
constexpr int MAX_STEPS = 500;

__global__ void cartpole_step_autoreset_kernel(
    const float* __restrict__ x_in, const float* __restrict__ x_dot_in,
    const float* __restrict__ theta_in, const float* __restrict__ theta_dot_in,
    const int* __restrict__ step_in, const float* __restrict__ reward_sum_in,
    const int* __restrict__ length_in, const int* __restrict__ action,
    const float* __restrict__ reset_vals,  // [E, 4]
    float* __restrict__ x_out, float* __restrict__ x_dot_out,
    float* __restrict__ theta_out, float* __restrict__ theta_dot_out,
    int* __restrict__ step_out, float* __restrict__ reward_sum_out,
    int* __restrict__ length_out, float* __restrict__ reward_out,
    float* __restrict__ done_out, float* __restrict__ ep_return_out,
    int* __restrict__ ep_length_out, int* __restrict__ outcome_out,
    int* __restrict__ active_out,
    float* __restrict__ obs_out,   // [E, 5]
    float* __restrict__ mask_out,  // [E, 2]
    int num_envs) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= num_envs) return;

  const float theta0 = theta_in[e];
  const float theta_dot0 = theta_dot_in[e];
  const float force = action[e] == 0 ? -FORCE_MAG : FORCE_MAG;
  const float cos_t = cosf(theta0);
  const float sin_t = sinf(theta0);

  const float temp =
      (force + POLE_MASS_LENGTH * (theta_dot0 * theta_dot0) * sin_t) / TOTAL_MASS;
  const float theta_acc =
      (GRAVITY * sin_t - cos_t * temp) /
      (POLE_HALF_LENGTH *
       (FOUR_THIRDS - POLE_MASS * (cos_t * cos_t) / TOTAL_MASS));
  const float x_acc = temp - POLE_MASS_LENGTH * theta_acc * cos_t / TOTAL_MASS;

  const float x_dot = x_dot_in[e] + TAU * x_acc;
  const float x = x_in[e] + TAU * x_dot;
  const float theta_dot = theta_dot0 + TAU * theta_acc;
  const float theta = theta0 + TAU * theta_dot;
  const int steps = step_in[e] + 1;

  const bool failed = fabsf(x) > X_THRESHOLD || fabsf(theta) > THETA_THRESHOLD;
  const bool done = failed || steps >= MAX_STEPS;
  const float reward = (failed && steps < MAX_STEPS) ? 0.0f : 1.0f;

  const float new_sum = reward_sum_in[e] + reward;
  const int new_len = length_in[e] + 1;
  reward_out[e] = reward;
  done_out[e] = done ? 1.0f : 0.0f;
  ep_return_out[e] = new_sum;
  ep_length_out[e] = new_len;
  outcome_out[e] = 1;
  active_out[e] = 1;

  float nx = x, nx_dot = x_dot, ntheta = theta, ntheta_dot = theta_dot;
  int nstep = steps;
  if (done) {
    const float* r = reset_vals + 4 * e;
    nx = r[0];
    nx_dot = r[1];
    ntheta = r[2];
    ntheta_dot = r[3];
    nstep = 0;
  }
  x_out[e] = nx;
  x_dot_out[e] = nx_dot;
  theta_out[e] = ntheta;
  theta_dot_out[e] = ntheta_dot;
  step_out[e] = nstep;
  reward_sum_out[e] = done ? 0.0f : new_sum;
  length_out[e] = done ? 0 : new_len;

  float* o = obs_out + 5 * e;
  o[0] = nx;
  o[1] = nx_dot;
  o[2] = ntheta;
  o[3] = ntheta_dot;
  o[4] = static_cast<float>(nstep) / static_cast<float>(MAX_STEPS);
  mask_out[2 * e] = 1.0f;
  mask_out[2 * e + 1] = 1.0f;
}

}  // namespace

extern "C" int cartpole_step_autoreset(
    const void* x, const void* x_dot, const void* theta, const void* theta_dot,
    const void* step_idx, const void* reward_sum, const void* length,
    const void* action, const void* reset_vals, void* x_out, void* x_dot_out,
    void* theta_out, void* theta_dot_out, void* step_out, void* reward_sum_out,
    void* length_out, void* reward_out, void* done_out, void* ep_return_out,
    void* ep_length_out, void* outcome_out, void* active_out, void* obs_out,
    void* mask_out, int num_envs, void* stream) {
  if (num_envs <= 0) return 0;
  const int threads = 256;
  const int blocks = (num_envs + threads - 1) / threads;
  cartpole_step_autoreset_kernel<<<blocks, threads, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(x_dot),
      static_cast<const float*>(theta), static_cast<const float*>(theta_dot),
      static_cast<const int*>(step_idx), static_cast<const float*>(reward_sum),
      static_cast<const int*>(length), static_cast<const int*>(action),
      static_cast<const float*>(reset_vals), static_cast<float*>(x_out),
      static_cast<float*>(x_dot_out), static_cast<float*>(theta_out),
      static_cast<float*>(theta_dot_out), static_cast<int*>(step_out),
      static_cast<float*>(reward_sum_out), static_cast<int*>(length_out),
      static_cast<float*>(reward_out), static_cast<float*>(done_out),
      static_cast<float*>(ep_return_out), static_cast<int*>(ep_length_out),
      static_cast<int*>(outcome_out), static_cast<int*>(active_out),
      static_cast<float*>(obs_out), static_cast<float*>(mask_out), num_envs);
  return static_cast<int>(cudaGetLastError());
}

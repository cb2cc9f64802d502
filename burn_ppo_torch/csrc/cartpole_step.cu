// K1 cartpole_step_autoreset — CartPole step, auto-reset, obs, mask and
// episode log, with the return normaliser's per-step roll as an optional
// epilogue: one launch per env step. With the reset flag off, a finished
// env keeps its stepped (terminal) physics row, and the obs is that row's:
// a watched game's last move. With the sampling front
// (cartpole_sample_step_kernel, eval's stats engine), the block first
// samples its envs' actions with K14's row code (temperature_sample.cuh)
// from the logits, mask, temperatures and uniforms, then steps with them:
// K14's launch folded into the step's.
//
// Replaces the XLA fusion of burn_ppo_tpu/envs/cartpole.py CartPole.step
// (69-112), CartPole.obs and CartPole.reset (55-67) under
// burn_ppo_tpu/envs/base.py autoreset_step (234-274), vmapped over envs
// (ROADMAP queue B, item B1), and, where the return normaliser is on, the
// per-step half of burn_ppo_tpu/ppo/normalization.py return_norm_roll
// (105-133) for the one player. Plain PyTorch twin:
// burn_ppo_torch/envs/base.py autoreset_step over
// burn_ppo_torch/envs/cartpole.py CartPole, then
// burn_ppo_torch/ppo/normalization.py return_norm_roll_plain, used for
// CPU tensors.
//
// What bounds it on an H100: launch latency, then bytes. Per env it needs
// the 16-byte physics row, step_idx, the two accumulators, the action (and
// the rolling return), a 16-byte reset row only where the episode ends,
// and writes ~84 B (~92 with the roll): ~0.5 MB at E = 4096, a fraction
// of a microsecond of HBM time. So the design cuts launches, round trips
// and host work: the roll that followed every step as a gather and a
// launch of its own is folded in here, every env's reset row is loaded
// with its other inputs (no load waits on the step), and the host
// crossing is a few pointers. The state is the [E, 4] f32 physics rows
// plus step_idx [E] i32 (envs/cartpole.py CartPoleState), and the outputs
// are carved from one i32 and one f32 buffer (I32_OUT, F32_OUT and
// ROLL_OUT there), each block E x columns starting on a 64-element
// boundary (packed_rows.cuh block_len).
//
// A block takes EB envs, one thread each, so that E = 4096 spreads over 64
// SMs: the physics row comes in as one 16-byte load, the step runs in
// registers, the one-column outputs go out as coalesced 4-byte stores and
// the physics row as one 16-byte store; the obs rows (5 floats, 20 bytes)
// are staged in shared memory and leave as 16-byte stores over the
// block's contiguous span, and the all-ones mask rows as 16-byte stores.
//
// Semantics (the reference's step order):
//   * semi-implicit Euler with the f32 constants of cartpole.py:19-29;
//   * a failure terminal pays 0, a timeout (step 500) pays 1;
//   * the episode log is captured from the stepped state BEFORE the reset
//     replaces it; on done the state becomes the reset values with step 0
//     and the accumulators restart at 0;
//   * obs = (x, x_dot, theta, theta_dot, step_idx / 500) of the post-reset
//     state;
//   * one player: the outcome is place 1, one active player, and the
//     action mask of the post-reset state is all ones;
//   * reset 0: a finished env keeps the stepped row and step count (the
//     accumulators restart at 0 all the same, as the plain step's);
//   * the sampling front: the block's two warps sample its 64 envs'
//     actions (2 lanes a row, 16 rows a warp at a time) into shared memory
//     and the actions output, then __syncthreads(), then the step above
//     with those actions. The step kernel without the front is unchanged.
//   * the roll, as return_norm.cu's roll at P = 1 and acting slot 0:
//     v = returns * gamma + reward, rounded twice (__fmul_rn, __fadd_rn: no
//     contraction into one fma), the sample is v, and the new return is 0
//     where the episode ended, else v.
// Compiled without --use_fast_math: sinf/cosf are the accurate ones.

#include <cuda_runtime.h>

#include <cstdint>

#include "packed_rows.cuh"
#include "temperature_sample.cuh"

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
constexpr int OBS_DIM = 5;
constexpr int A = 2;
constexpr int EB = 64;  // envs (threads) per block
static_assert(EB % 4 == 0, "a block's obs and mask spans must be whole 16-byte runs");

struct Args {
  const float4* phys;  // [E, 4] x, x_dot, theta, theta_dot
  const int* step;
  const float* acc_sum;
  const int* acc_len;
  const int* action;
  const float4* reset;    // [E, 4], taken where the episode ends
  const float* returns;   // [E, 1] rolling returns, or null: no roll
  float gamma;
  // i32 outputs
  int* step_out;
  int* acc_len_out;
  int* log_len;
  int* outcome;
  int* active;
  // f32 outputs
  float4* phys_out;
  float* acc_sum_out;
  float* reward;
  float* done;
  float* log_total;
  float* obs;
  float* mask;
  float* returns_out;  // with the roll
  float* samples;
  int num_envs;
  int do_reset;  // 0: a finished env keeps its terminal row
};

using temp_sample::Front;

// One block's envs; SAMPLE prepends the sampling front (f), else the
// actions are g.action.
template <bool SAMPLE>
__device__ __forceinline__ void step_block(const Args& g, const Front& f) {
  __shared__ float obs_rows[EB * OBS_DIM];
  const long e0 = static_cast<long>(blockIdx.x) * EB;
  const int count = static_cast<int>(min(static_cast<long>(EB), g.num_envs - e0));
  const int t = threadIdx.x;
  const long e = e0 + t;
  int sampled = 0;
  if constexpr (SAMPLE) {
    __shared__ int acts[EB];
    temp_sample::sample_block<A, EB / 32>(f, e0, count, acts);
    __syncthreads();
    if (t < count) sampled = acts[t];
  }

  if (t < count) {
    const float4 s = g.phys[e];
    const int steps0 = g.step[e];
    const float sum0 = g.acc_sum[e];
    const int len0 = g.acc_len[e];
    const int act = SAMPLE ? sampled : g.action[e];
    const float ret0 = g.returns != nullptr ? g.returns[e] : 0.0f;
    // Loaded with the rest, before it is known whether the episode ends:
    // 16 bytes more than the data needs, one dependent round trip less.
    const float4 reset = g.reset[e];

    const float theta0 = s.z;
    const float theta_dot0 = s.w;
    const float force = act == 0 ? -FORCE_MAG : FORCE_MAG;
    const float cos_t = cosf(theta0);
    const float sin_t = sinf(theta0);

    const float temp =
        (force + POLE_MASS_LENGTH * (theta_dot0 * theta_dot0) * sin_t) / TOTAL_MASS;
    const float theta_acc =
        (GRAVITY * sin_t - cos_t * temp) /
        (POLE_HALF_LENGTH *
         (FOUR_THIRDS - POLE_MASS * (cos_t * cos_t) / TOTAL_MASS));
    const float x_acc = temp - POLE_MASS_LENGTH * theta_acc * cos_t / TOTAL_MASS;

    const float x_dot = s.y + TAU * x_acc;
    const float x = s.x + TAU * x_dot;
    const float theta_dot = theta_dot0 + TAU * theta_acc;
    const float theta = theta0 + TAU * theta_dot;
    const int steps = steps0 + 1;

    const bool failed = fabsf(x) > X_THRESHOLD || fabsf(theta) > THETA_THRESHOLD;
    const bool done = failed || steps >= MAX_STEPS;
    const float reward = (failed && steps < MAX_STEPS) ? 0.0f : 1.0f;

    const float new_sum = sum0 + reward;
    const int new_len = len0 + 1;
    float4 n = make_float4(x, x_dot, theta, theta_dot);
    int nstep = steps;
    if (done && g.do_reset) {
      n = reset;
      nstep = 0;
    }
    g.phys_out[e] = n;
    g.step_out[e] = nstep;
    g.acc_len_out[e] = done ? 0 : new_len;
    g.log_len[e] = new_len;
    g.outcome[e] = 1;
    g.active[e] = 1;
    g.acc_sum_out[e] = done ? 0.0f : new_sum;
    g.reward[e] = reward;
    g.done[e] = done ? 1.0f : 0.0f;
    g.log_total[e] = new_sum;
    if (g.returns != nullptr) {
      const float v = __fadd_rn(__fmul_rn(ret0, g.gamma), reward);
      g.samples[e] = v;
      g.returns_out[e] = done ? 0.0f : v;
    }
    float* o = obs_rows + t * OBS_DIM;
    o[0] = n.x;
    o[1] = n.y;
    o[2] = n.z;
    o[3] = n.w;
    o[4] = static_cast<float>(nstep) / static_cast<float>(MAX_STEPS);
  }
  __syncthreads();

  // The block's obs span, count x 5 floats starting 16-byte aligned (e0 is
  // a multiple of 4), 4 at a time; a last block of count % 4 != 0 ends on
  // a partial run.
  {
    constexpr int RUNS = EB * OBS_DIM / 4;
    float* obs = g.obs + e0 * OBS_DIM;
    const int len = count * OBS_DIM;
    for (int k = t; k < RUNS; k += EB) {
      const int j = 4 * k;
      if (j + 3 < len) {
        reinterpret_cast<float4*>(obs)[k] =
            make_float4(obs_rows[j], obs_rows[j + 1], obs_rows[j + 2], obs_rows[j + 3]);
      } else {
        for (int q = j; q < len; ++q) obs[q] = obs_rows[q];
      }
    }
  }
  // The mask span, count x 2 ones.
  if (t < EB * A / 4) {
    float* mask = g.mask + e0 * A;
    const int j = 4 * t;
    const int len = count * A;
    if (j + 3 < len) {
      reinterpret_cast<float4*>(mask)[t] = make_float4(1.0f, 1.0f, 1.0f, 1.0f);
    } else {
      for (int q = j; q < len; ++q) mask[q] = 1.0f;
    }
  }
}

__global__ void __launch_bounds__(EB) cartpole_step_autoreset_kernel(Args g) {
  step_block<false>(g, Front{});
}

__global__ void __launch_bounds__(EB) cartpole_sample_step_kernel(Args g, Front f) {
  step_block<true>(g, f);
}

}  // namespace

// in: the physics rows [E, 4] and reset rows [E, 4] (both 16-byte
// aligned), step_idx [E], reward_sum [E, 1], length [E], action [E], and
// with the roll the rolling returns [E, 1] (else null); out: the i32 and
// the f32 buffer of envs/cartpole.py I32_OUT and F32_OUT (+ ROLL_OUT).
// reset 0 keeps a finished env's terminal row. With the sampling front
// (logits not null; action null) the block samples its envs' actions from
// logits, mask (nullable) and uniforms [E, 2] at the temperatures [E]
// (nullable: ``temp`` for every row) into actions [E], then steps with
// them (eval's step).
extern "C" int cartpole_step_autoreset(const void* phys, const int* step_idx,
                                       const float* acc_sum, const int* acc_len,
                                       const int* action, const void* reset,
                                       const float* returns, int* out_i32, float* out_f32,
                                       int num_envs, float gamma, int reset_flag,
                                       const void* logits, const void* mask, const void* temps,
                                       float temp, const void* uniforms, int* actions,
                                       void* stream) {
  if (num_envs <= 0) return 0;
  const auto addr = [](const void* b) { return reinterpret_cast<std::uintptr_t>(b); };
  if ((addr(phys) | addr(reset) | addr(out_f32)) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  using packed_rows::block_len;
  const long E = num_envs;
  Args g;
  g.phys = static_cast<const float4*>(phys);
  g.step = step_idx;
  g.acc_sum = acc_sum;
  g.acc_len = acc_len;
  g.action = action;
  g.reset = static_cast<const float4*>(reset);
  g.returns = returns;
  g.gamma = gamma;
  int* i = out_i32;
  g.step_out = i;
  i += block_len(E, 1);
  g.acc_len_out = i;
  i += block_len(E, 1);
  g.log_len = i;
  i += block_len(E, 1);
  g.outcome = i;
  i += block_len(E, 1);
  g.active = i;
  float* f = out_f32;
  g.phys_out = reinterpret_cast<float4*>(f);
  f += block_len(E, 4);
  g.acc_sum_out = f;
  f += block_len(E, 1);
  g.reward = f;
  f += block_len(E, 1);
  g.done = f;
  f += block_len(E, 1);
  g.log_total = f;
  f += block_len(E, 1);
  g.obs = f;
  f += block_len(E, OBS_DIM);
  g.mask = f;
  f += block_len(E, A);
  g.returns_out = f;
  f += block_len(E, 1);
  g.samples = f;
  g.num_envs = num_envs;
  g.do_reset = reset_flag;
  const int blocks = static_cast<int>((E + EB - 1) / EB);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (logits != nullptr) {
    cartpole_sample_step_kernel<<<blocks, EB, 0, s>>>(
        g, temp_sample::front_of(logits, mask, temps, temp, uniforms, actions));
  } else {
    cartpole_step_autoreset_kernel<<<blocks, EB, 0, s>>>(g);
  }
  return static_cast<int>(cudaGetLastError());
}

// K17 sample_seats / record_step — the eval stats engine's bookkeeping
// around the sampler and the env step, two launches a step.
//
// Replaces what XLA fuses around the env step and the sampler in the body
// of the stats chunk's lax.scan, burn_ppo_tpu/eval.py step_fn (569-594),
// ROADMAP queue B, item B17:
//   * seats, before the logits: the acting source perm_table[perm_idx,
//     player] (575), its unique model unique_idx[acting_source]
//     (make_acting_logits_fn, 366-498; -1 for Random) and
//     temp.get_temp(move_count) (578, TempSchedule.get_temp 146-156);
//   * records, after the env step: the step's episode log and the
//     permutation BEFORE the advance into row t of the chunk's outputs
//     (585-586), then the advance of move_count and perm_idx where the env
//     is done (587-592), in place.
// Plain PyTorch twins: burn_ppo_torch/eval.py sample_seats_plain and
// record_step_plain, used for CPU tensors.
//
// What bounds it on an H100: the launch. A step of 256 envs moves ~5 KB;
// the two launches replace the ~10 small kernels of the eager step (two
// casts and the perm gather, the slot gather, the schedule's 3-6 ops, four
// copies into the chunk's log, the compare, add, modulo and two selects of
// the advance). One thread an env, 256 threads a block; both launches sit
// inside the chunk's CUDA graph, the row t of the log a pointer fixed at
// capture.
//
// The player is read from the state's own column (pointer and stride, no
// copy of the strided view); a null column is player 0 (one player).
//
// The temperature is the plain version's bit for bit (which rounds as
// XLA compiles JAX's jitted get_temp): move * (1 / cutoff) an f32 product with the f32
// reciprocal (__fmul_rn, never contracted), clamped to [0, 1]; the ramp
// initial + t * (final - initial) in f64, where the product of two f32
// values is exact, rounded once to f32; final where move >= cutoff.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

// TempSchedule's kinds: no cutoff, a step at the cutoff, a linear decay to it.
constexpr int CONSTANT = 0;
constexpr int CUTOFF = 1;
constexpr int DECAY = 2;

struct Schedule {
  int mode;
  float initial, final_temp, span, cutoff, inv_cutoff;
};

__device__ __forceinline__ float temperature(const Schedule& s, int move_count) {
  const float move = static_cast<float>(move_count);
  if (s.mode == CONSTANT) return s.initial;
  float ramp = s.initial;
  if (s.mode == DECAY) {
    const float t = fminf(fmaxf(__fmul_rn(move, s.inv_cutoff), 0.0f), 1.0f);
    const double product = __dmul_rn(static_cast<double>(t), static_cast<double>(s.span));
    ramp = __double2float_rn(__dadd_rn(product, static_cast<double>(s.initial)));
  }
  return move >= s.cutoff ? s.final_temp : ramp;
}

__global__ void __launch_bounds__(THREADS) sample_seats_kernel(
    const int* __restrict__ perm_table, int P, const int* __restrict__ perm_idx,
    const int* __restrict__ player, long player_stride, const int* __restrict__ slot_of_source,
    const int* __restrict__ move_count, Schedule s, int* __restrict__ slot,
    float* __restrict__ temp, int E) {
  const int e = blockIdx.x * THREADS + threadIdx.x;
  if (e >= E) return;
  const int seat = player != nullptr ? player[static_cast<long>(e) * player_stride] : 0;
  slot[e] = slot_of_source[perm_table[perm_idx[e] * P + seat]];
  temp[e] = temperature(s, move_count[e]);
}

__global__ void __launch_bounds__(THREADS) record_step_kernel(
    const float* __restrict__ completed, const int* __restrict__ outcome,
    const float* __restrict__ total_rewards, int* __restrict__ perm_idx,
    int* __restrict__ move_count, int n_perms,
    float* __restrict__ log_completed, int* __restrict__ log_outcome,
    float* __restrict__ log_total_rewards, int* __restrict__ log_perm, int E, int P) {
  const int e = blockIdx.x * THREADS + threadIdx.x;
  if (e >= E) return;
  const float ended = completed[e];
  log_completed[e] = ended;
  const long row = static_cast<long>(e) * P;
  for (int p = 0; p < P; ++p) {
    log_outcome[row + p] = outcome[row + p];
    log_total_rewards[row + p] = total_rewards[row + p];
  }
  const int pi = perm_idx[e];
  log_perm[e] = pi;
  move_count[e] = ended > 0.0f ? 0 : move_count[e] + 1;
  perm_idx[e] = ended > 0.0f ? (pi + 1) % n_perms : pi;
}

unsigned blocks(int E) { return static_cast<unsigned>((E + THREADS - 1) / THREADS); }

}  // namespace

// perm_table [n_perms, P], perm_idx [E], slot_of_source [S], move_count
// [E]: i32; player: E i32 at the given stride (null: player 0); outputs
// slot [E] i32 and temp [E] f32. mode: 0 constant, 1 cutoff, 2 decay.
extern "C" int eval_sample_seats(const void* perm_table, int n_perms, int P, const void* perm_idx,
                                 const void* player, long player_stride,
                                 const void* slot_of_source, const void* move_count, int mode,
                                 float initial, float final_temp, float span, float cutoff,
                                 float inv_cutoff, void* slot, void* temp, int E, void* stream) {
  if (n_perms < 1 || P < 1 || mode < CONSTANT || mode > DECAY) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (E <= 0) return 0;
  const Schedule s{mode, initial, final_temp, span, cutoff, inv_cutoff};
  sample_seats_kernel<<<blocks(E), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(perm_table), P, static_cast<const int*>(perm_idx),
      static_cast<const int*>(player), player_stride, static_cast<const int*>(slot_of_source),
      static_cast<const int*>(move_count), s, static_cast<int*>(slot), static_cast<float*>(temp),
      E);
  return static_cast<int>(cudaGetLastError());
}

// completed [E] (the step's done), total_rewards [E, P]: f32; outcome
// [E, P] i32: the env step's log; perm_idx, move_count [E] i32, advanced
// in place; the log row: completed [E] f32, outcome [E, P] i32,
// total_rewards [E, P] f32, perm [E] i32.
extern "C" int eval_record_step(const void* completed, const void* outcome,
                                const void* total_rewards, void* perm_idx, void* move_count,
                                int n_perms, void* log_completed,
                                void* log_outcome, void* log_total_rewards, void* log_perm, int E,
                                int P, void* stream) {
  if (n_perms < 1 || P < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (E <= 0) return 0;
  record_step_kernel<<<blocks(E), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(completed), static_cast<const int*>(outcome),
      static_cast<const float*>(total_rewards), static_cast<int*>(perm_idx),
      static_cast<int*>(move_count), n_perms,
      static_cast<float*>(log_completed), static_cast<int*>(log_outcome),
      static_cast<float*>(log_total_rewards), static_cast<int*>(log_perm), E, P);
  return static_cast<int>(cudaGetLastError());
}

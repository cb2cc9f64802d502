// K17 step_books — the eval stats engine's bookkeeping around the sampler
// and the env step, one launch a step.
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
// Plain PyTorch twin: burn_ppo_torch/eval.py step_books_plain (the record
// half record_step_plain, the seat half sample_seats_plain), used for CPU
// tensors.
//
// One C entry, eval_step_books; a null record or seat output leaves that
// half out. A chunk of T steps launches T + 1 times: the seats of step 0
// (sample_seats_kernel), then after each env step t < T - 1 the records of
// t fused with the seats of t + 1 (record_and_seat_kernel: both halves
// depend only on the env step of t), and the records of step T - 1 alone
// (record_step_kernel). One thread an env, 256 threads a block; every
// launch sits inside the chunk's CUDA graph, row t of the log a pointer
// fixed at capture.
//
// What bounds it on an H100: the launch and a chain of dependent loads. A
// step of 256 envs moves ~5 KB. The fused launch keeps the advanced move
// count and permutation in registers (the seats read them from there, not
// again from memory); at P = 4 the outcome and total-reward rows move in
// one 16-byte load and store each.
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

struct Records {  // the record half: the step's log in, row t of the chunk's log out
  const float* completed;
  const int* outcome;
  const float* total_rewards;
  float* log_completed;
  int* log_outcome;
  float* log_total_rewards;
  int* log_perm;
  bool vec4;  // P == 4 and every [E, 4] row 16-byte aligned
};

struct Seats {  // the seat half: each env's acting slot and temperature
  const int* perm_table;
  const int* player;  // null: player 0
  long player_stride;
  const int* slot_of_source;
  Schedule s;
  int* slot;
  float* temp;
};

// One env's step bookkeeping: the records (RECORD), then the seats of the
// next step (SEATS) from the advanced move count and permutation, kept in
// registers.
template <bool RECORD, bool SEATS>
__device__ __forceinline__ void step_books(const Records& r, const Seats& q, int* perm_idx,
                                           int* move_count, int n_perms, int P, int E) {
  const int e = blockIdx.x * THREADS + threadIdx.x;
  if (e >= E) return;
  int pi = perm_idx[e], mc = move_count[e], seat = 0;
  const float ended = RECORD ? r.completed[e] : 0.0f;
  if (SEATS && q.player != nullptr) seat = q.player[static_cast<long>(e) * q.player_stride];
  if (RECORD) {
    r.log_completed[e] = ended;
    if (r.vec4) {
      reinterpret_cast<int4*>(r.log_outcome)[e] = reinterpret_cast<const int4*>(r.outcome)[e];
      reinterpret_cast<float4*>(r.log_total_rewards)[e] =
          reinterpret_cast<const float4*>(r.total_rewards)[e];
    } else {
      const long row = static_cast<long>(e) * P;
      for (int p = 0; p < P; ++p) {
        r.log_outcome[row + p] = r.outcome[row + p];
        r.log_total_rewards[row + p] = r.total_rewards[row + p];
      }
    }
    r.log_perm[e] = pi;
    if (ended > 0.0f) {
      mc = 0;
      pi = (pi + 1) % n_perms;
    } else {
      mc += 1;
    }
    move_count[e] = mc;
    perm_idx[e] = pi;
  }
  if (SEATS) {
    q.slot[e] = q.slot_of_source[q.perm_table[pi * P + seat]];
    q.temp[e] = temperature(q.s, mc);
  }
}

// One name a half (the profiler tells a chunk's launches apart by them).
__global__ void __launch_bounds__(THREADS) sample_seats_kernel(Seats q, int* perm_idx,
                                                                int* move_count, int n_perms,
                                                                int P, int E) {
  step_books<false, true>(Records{}, q, perm_idx, move_count, n_perms, P, E);
}

__global__ void __launch_bounds__(THREADS) record_step_kernel(Records r, int* perm_idx,
                                                               int* move_count, int n_perms,
                                                               int P, int E) {
  step_books<true, false>(r, Seats{}, perm_idx, move_count, n_perms, P, E);
}

__global__ void __launch_bounds__(THREADS) record_and_seat_kernel(Records r, Seats q,
                                                                   int* perm_idx, int* move_count,
                                                                   int n_perms, int P, int E) {
  step_books<true, true>(r, q, perm_idx, move_count, n_perms, P, E);
}

unsigned blocks(int E) { return static_cast<unsigned>((E + THREADS - 1) / THREADS); }

bool aligned16(const void* p) { return reinterpret_cast<unsigned long>(p) % 16 == 0; }

Records records(const void* completed, const void* outcome, const void* total_rewards,
                void* log_completed, void* log_outcome, void* log_total_rewards, void* log_perm,
                int P) {
  Records r{static_cast<const float*>(completed), static_cast<const int*>(outcome),
            static_cast<const float*>(total_rewards), static_cast<float*>(log_completed),
            static_cast<int*>(log_outcome), static_cast<float*>(log_total_rewards),
            static_cast<int*>(log_perm), false};
  r.vec4 = P == 4 && aligned16(outcome) && aligned16(total_rewards) && aligned16(log_outcome) &&
           aligned16(log_total_rewards);
  return r;
}

Seats seats(const void* perm_table, const void* player, long player_stride,
            const void* slot_of_source, int mode, float initial, float final_temp, float span,
            float cutoff, float inv_cutoff, void* slot, void* temp) {
  return Seats{static_cast<const int*>(perm_table), static_cast<const int*>(player),
               player_stride, static_cast<const int*>(slot_of_source),
               Schedule{mode, initial, final_temp, span, cutoff, inv_cutoff},
               static_cast<int*>(slot), static_cast<float*>(temp)};
}

}  // namespace

// perm_idx, move_count [E] i32 (advanced in place by the records);
// perm_table [n_perms, P] i32. The records (left out when log_completed is
// null): the env step's log, completed [E] (its done) and total_rewards
// [E, P] f32, outcome [E, P] i32, into the log row: completed [E] f32,
// outcome [E, P] i32, total_rewards [E, P] f32, perm [E] i32. The seats
// (left out when slot is null), after the records: player, E i32 at the
// given stride (null: player 0), slot_of_source [S] i32, the schedule
// (mode 0 constant, 1 cutoff, 2 decay), into slot [E] i32 and temp [E] f32.
extern "C" int eval_step_books(void* perm_idx, void* move_count, const void* perm_table,
                               int n_perms, int P, const void* completed, const void* outcome,
                               const void* total_rewards, void* log_completed,
                               void* log_outcome, void* log_total_rewards, void* log_perm,
                               const void* player, long player_stride,
                               const void* slot_of_source, int mode, float initial,
                               float final_temp, float span, float cutoff, float inv_cutoff,
                               void* slot, void* temp, int E, void* stream) {
  const bool record = log_completed != nullptr, seat = slot != nullptr;
  if (n_perms < 1 || P < 1 || !(record || seat) || mode < CONSTANT || mode > DECAY) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (E <= 0) return 0;
  const Records r = records(completed, outcome, total_rewards, log_completed, log_outcome,
                            log_total_rewards, log_perm, P);
  const Seats q = seats(perm_table, player, player_stride, slot_of_source, mode, initial,
                        final_temp, span, cutoff, inv_cutoff, slot, temp);
  int* pi = static_cast<int*>(perm_idx);
  int* mc = static_cast<int*>(move_count);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (record && seat) {
    record_and_seat_kernel<<<blocks(E), THREADS, 0, s>>>(r, q, pi, mc, n_perms, P, E);
  } else if (record) {
    record_step_kernel<<<blocks(E), THREADS, 0, s>>>(r, pi, mc, n_perms, P, E);
  } else {
    sample_seats_kernel<<<blocks(E), THREADS, 0, s>>>(q, pi, mc, n_perms, P, E);
  }
  return static_cast<int>(cudaGetLastError());
}

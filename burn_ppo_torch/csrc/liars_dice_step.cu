// K13 liars_dice_step_autoreset — the Liar's Dice step with rewards, done,
// episode log, auto-reset, accumulators, and the obs, action mask and
// privileged obs of the post-reset state, one launch per env step.
//
// Replaces the XLA fusion of burn_ppo_tpu/envs/liars_dice.py LiarsDice.step
// (133-257), obs (260-309), action_mask (312-324), privileged_obs (333-382)
// and reset under burn_ppo_tpu/envs/base.py autoreset_step (234-274),
// vmapped over envs (ROADMAP queue B, item B12). Plain PyTorch twin:
// burn_ppo_torch/envs/base.py autoreset_step over
// burn_ppo_torch/envs/liars_dice.py LiarsDice, used for CPU tensors.
//
// What bounds it on an H100: launch latency, then bytes. Per env it reads
// the packed state (73 i32), the shaping coefficient, the accumulators, the
// action and 16 uniforms, and writes the next state, the 270-wide obs, the
// 49-wide mask, the 120-wide privileged obs, rewards, log and accumulators:
// ~2.5 KB per env, ~10 MB per launch at E = 4096 (~3 us of HBM time). The
// design is K11's (csrc/skull_step.cu): one thread per env, the state in
// registers and local memory, the branch that applies taken with real
// control flow (the branches are pure, so taking one equals selecting it),
// one warp per block so that 4096 envs spread over 128 SMs. A block's 32
// state rows and its 32 obs, privileged-obs and mask rows are contiguous in
// memory; the warp loads and stores them through shared memory (64 KB,
// dynamic) with consecutive threads on consecutive addresses.
//
// The host crossing is a few pointers: the integer state is ONE packed
// [E, 73] i32 buffer (envs/liars_dice.py LAYOUT), and the outputs are
// carved from one i32 and one f32 buffer (I32_OUT, F32_OUT there), each
// block E x columns starting on a 64-element boundary.
//
// Bit-exact with the plain version (integers, and f32 in the reference's
// operation order; built without fast math). The traps:
//   * an out-of-range action (< 0 or >= 49) is invalid before the clip:
//     55 must not become CALL;
//   * wild 1s count toward faces 2-6, a bid of 1s counts only 1s;
//   * XLA divides by a constant as a product with its f32 reciprocal:
//     bid_count / 20, bid_count / 12 and face / 6 are x * (1.0f / d);
//   * the placement rewards are the f32 constants 0.33f and -0.33f, and
//     they REPLACE the survival shaping at game end;
//   * the terminal state keeps its bid, history, dice and current player;
//   * floor-mod for seats, the lowest alive seat as the winner, and a
//     loser seat out of range read as 0 (JAX's one-hot reads);
//   * the dice: min(floor(u * 6), 5) + 1 from the uniforms, the reset's
//     for a fresh game, the step's for the reroll of a new round.

#include <cuda_runtime.h>

namespace {

constexpr int P = 4;
constexpr int DICE = 2;
constexpr int FACES = 6;
constexpr int MAX_DICE = P * DICE;
constexpr int A = MAX_DICE * FACES + 1;
constexpr int CALL = A - 1;
constexpr int HIST = 16;
constexpr int OBS_DIM = 270;
constexpr int PRIV_DIM = 120;
constexpr int THREADS = 32;  // one warp per block
constexpr long ALIGN = 64;

// The packed state row, in the column order of envs/liars_dice.py LAYOUT.
struct S {
  int dice[P * DICE];
  int dice_count[P];
  int current, bid_qty, bid_face, last_bidder, bid_count;
  int hist[HIST * 3];
  int hist_len;
  int placements[P];
  int num_eliminated;
  int game_over;
  int step_idx;
};
constexpr int W = sizeof(S) / sizeof(int);
static_assert(W == 73, "LAYOUT of envs/liars_dice.py");

// Shared memory of a block: its rows of every wide output and of the state.
constexpr int SMEM_FLOATS = THREADS * (OBS_DIM + PRIV_DIM + A + W);
constexpr int SMEM_BYTES = SMEM_FLOATS * 4;  // 65,536

struct Args {
  const int* ints;
  const float* shaping;
  const float* acc_sum;
  const int* acc_len;
  const int* action;
  const float* u_reset;
  const float* u_step;
  // i32 outputs
  int* ints_out;
  int* acc_len_out;
  int* log_len;
  int* outcome;
  int* active;
  // f32 outputs
  float* shaping_out;
  float* acc_sum_out;
  float* rewards;
  float* done;
  float* log_total;
  float* obs;
  float* mask;
  float* priv;
  int num_envs;
};

__host__ __device__ long block_len(long num_envs, int cols) {
  return (num_envs * cols + ALIGN - 1) / ALIGN * ALIGN;
}

__device__ __forceinline__ int fmod_p(int x) { return ((x % P) + P) % P; }
__device__ __forceinline__ bool seat(int i) { return i >= 0 && i < P; }

// First seat with dice clockwise after frm (frm itself last); (frm+1) mod P
// when none has (burn_ppo_tpu/envs/base.py:73-88).
__device__ int next_alive(const int* dice_count, int frm) {
  int best = -1, best_d = P + 1;
  for (int i = 0; i < P; ++i) {
    if (dice_count[i] <= 0) continue;
    const int d = fmod_p(i - frm - 1);
    if (d < best_d) {
      best_d = d;
      best = i;
    }
  }
  return best >= 0 ? best : fmod_p(frm + 1);
}

// The f32 placement rewards (1.0, 0.33, -0.33, -1.0) of places 1-4.
__device__ __forceinline__ float placement_reward(int place) {
  switch (place) {
    case 1: return 1.0f;
    case 2: return 0.33f;
    case 3: return -0.33f;
    default: return -1.0f;
  }
}

__device__ __forceinline__ int face_of(float u) {
  return min(static_cast<int>(floorf(u * 6.0f)), FACES - 1) + 1;
}

__device__ void reset_state(S& s, const float* u) {
  for (int i = 0; i < P * DICE; ++i) s.dice[i] = face_of(u[i]);
  for (int p = 0; p < P; ++p) {
    s.dice_count[p] = DICE;
    s.placements[p] = 0;
  }
  s.current = s.bid_qty = s.bid_face = s.bid_count = 0;
  s.last_bidder = -1;
  for (int i = 0; i < HIST * 3; ++i) s.hist[i] = 0;
  s.hist_len = s.num_eliminated = s.game_over = s.step_idx = 0;
}

// liars_dice.py:133-257. `t` starts as a copy of `s`; returns done.
__device__ bool step(const S& s, int action, const float* u, float shaping, S& t,
                     float* rewards) {
  t.step_idx = s.step_idx + 1;
  for (int p = 0; p < P; ++p) rewards[p] = 0.0f;
  const bool in_range = action >= 0 && action < A;
  const int a = min(max(action, 0), A - 1);
  const bool is_call = a == CALL;
  const int qty = a / FACES + 1, face = a % FACES + 1;
  int total = 0;
  for (int p = 0; p < P; ++p) total += s.dice_count[p];
  const bool no_bid = s.bid_qty == 0;
  const bool higher = qty > s.bid_qty || (qty == s.bid_qty && face > s.bid_face);
  const bool bid_valid = !is_call && qty <= total && (no_bid || higher);
  const bool call_valid = is_call && !no_bid;
  if (s.game_over || !in_range || !(bid_valid || call_valid)) {
    t.game_over = 1;
    return true;
  }
  const int cur = s.current;
  if (!is_call) {
    // Bid: push (cur, qty, face) onto the ring, shifting when it is full.
    int at = s.hist_len;
    if (s.hist_len >= HIST) {
      for (int i = 0; i < (HIST - 1) * 3; ++i) t.hist[i] = s.hist[i + 3];
      at = HIST - 1;
    }
    t.hist[at * 3] = cur;
    t.hist[at * 3 + 1] = qty;
    t.hist[at * 3 + 2] = face;
    t.hist_len = min(s.hist_len + 1, HIST);
    t.bid_qty = qty;
    t.bid_face = face;
    t.last_bidder = cur;
    t.bid_count = s.bid_count + 1;
    t.current = next_alive(s.dice_count, cur);
    return false;
  }
  // Call (liars_dice.py:173-244).
  const int bf = s.bid_face;
  int actual = 0;
  for (int p = 0; p < P; ++p)
    for (int d = 0; d < DICE; ++d) {
      const int v = s.dice[p * DICE + d];
      actual += (d < s.dice_count[p] && (v == bf || (v == 1 && bf != 1))) ? 1 : 0;
    }
  const int loser = actual < s.bid_qty ? s.last_bidder : cur;
  if (seat(loser)) t.dice_count[loser] = s.dice_count[loser] - 1;
  const int left = seat(loser) ? t.dice_count[loser] : 0;
  const bool eliminated = left == 0;
  if (eliminated && seat(loser)) t.placements[loser] = P - s.num_eliminated;
  t.num_eliminated = s.num_eliminated + (eliminated ? 1 : 0);
  int alive = 0, winner = -1;
  for (int p = 0; p < P; ++p) {
    if (t.dice_count[p] > 0) {
      ++alive;
      if (winner < 0) winner = p;
    }
  }
  const bool over = alive <= 1;
  if (over) t.placements[winner < 0 ? 0 : winner] = 1;
  for (int p = 0; p < P; ++p) {
    rewards[p] = over ? placement_reward(min(max(t.placements[p], 1), P))
                      : (t.dice_count[p] > 0 ? shaping : 0.0f);
  }
  t.game_over = over ? 1 : 0;
  if (!over) {
    // A new round: every die rerolled, the round cleared, the loser (or
    // the next seat alive after it) opens.
    for (int i = 0; i < P * DICE; ++i) t.dice[i] = face_of(u[i]);
    t.current = left > 0 ? loser : next_alive(t.dice_count, loser);
    t.bid_qty = t.bid_face = t.bid_count = t.hist_len = 0;
    t.last_bidder = -1;
    for (int i = 0; i < HIST * 3; ++i) t.hist[i] = 0;
  }
  return over;
}

// Player-relative obs (liars_dice.py:260-309).
__device__ void write_obs(const S& s, float* o) {
  const int cur = s.current;
  const int own_count = seat(cur) ? s.dice_count[cur] : 0;
  for (int d = 0; d < DICE; ++d) {
    const int v = seat(cur) ? s.dice[cur * DICE + d] : 0;
    for (int f = 0; f < FACES; ++f) o[d * FACES + f] = (d < own_count && v == f + 1) ? 1.0f : 0.0f;
  }
  for (int r = 0; r < P; ++r) {
    const int dc = s.dice_count[fmod_p(r + cur)];
    o[12 + r] = static_cast<float>(dc) * 0.5f;
    o[16 + r] = dc > 0 ? 1.0f : 0.0f;
    o[20 + r] = cur == r ? 1.0f : 0.0f;
  }
  const bool has_bid = s.bid_qty > 0;
  const int bid_idx = (s.bid_qty - 1) * FACES + (s.bid_face - 1);
  for (int i = 0; i < MAX_DICE * FACES; ++i) o[24 + i] = (has_bid && i == bid_idx) ? 1.0f : 0.0f;
  o[72] = has_bid ? 1.0f : 0.0f;
  o[73] = fminf(static_cast<float>(s.bid_count) * (1.0f / 20.0f), 1.0f);
  const int rel_bidder = fmod_p(s.last_bidder + P - cur);
  for (int r = 0; r < P; ++r) o[74 + r] = (s.last_bidder >= 0 && r == rel_bidder) ? 1.0f : 0.0f;
  for (int h = 0; h < HIST; ++h) {
    float* row = o + 78 + h * (P + 1 + FACES + 1);
    const bool valid = h < s.hist_len;
    const int rel = fmod_p(s.hist[h * 3] + P - cur);
    const int q = s.hist[h * 3 + 1], f = s.hist[h * 3 + 2];
    for (int r = 0; r < P; ++r) row[r] = (valid && rel == r) ? 1.0f : 0.0f;
    row[P] = valid ? static_cast<float>(q) * 0.125f : 0.0f;
    for (int i = 0; i < FACES; ++i) row[P + 1 + i] = (valid && f == i + 1) ? 1.0f : 0.0f;
    row[P + 1 + FACES] = valid ? 1.0f : 0.0f;
  }
}

// liars_dice.py:312-324.
__device__ void write_mask(const S& s, float* m) {
  int total = 0;
  for (int p = 0; p < P; ++p) total += s.dice_count[p];
  const bool playable = (seat(s.current) ? s.dice_count[s.current] : 0) > 0 && !s.game_over;
  const bool no_bid = s.bid_qty == 0;
  for (int q = 1; q <= MAX_DICE; ++q)
    for (int f = 1; f <= FACES; ++f) {
      const bool higher = q > s.bid_qty || (q == s.bid_qty && f > s.bid_face);
      m[(q - 1) * FACES + f - 1] = (playable && q <= total && (no_bid || higher)) ? 1.0f : 0.0f;
    }
  m[CALL] = (playable && !no_bid) ? 1.0f : 0.0f;
}

// CTDE privileged obs (liars_dice.py:333-382): 110 floats, zero padded to 120.
__device__ void write_priv(const S& s, float* o) {
  const bool has_bid = s.bid_qty > 0;
  o[0] = static_cast<float>(s.current) * 0.25f;
  o[1] = has_bid ? static_cast<float>(s.bid_qty) * 0.125f : 0.0f;
  o[2] = has_bid ? static_cast<float>(s.bid_face) * (1.0f / FACES) : 0.0f;
  o[3] = s.last_bidder >= 0 ? static_cast<float>(s.last_bidder) * 0.25f : -1.0f;
  o[4] = static_cast<float>(s.bid_count) * (1.0f / (P * 3));
  for (int h = 0; h < HIST; ++h) {  // newest first
    const int src = s.hist_len - 1 - h;
    const bool valid = src >= 0;
    const int row = min(max(src, 0), HIST - 1);
    o[5 + 3 * h] = valid ? static_cast<float>(s.hist[row * 3]) * 0.25f : 0.0f;
    o[6 + 3 * h] = valid ? static_cast<float>(s.hist[row * 3 + 1]) * 0.125f : 0.0f;
    o[7 + 3 * h] = valid ? static_cast<float>(s.hist[row * 3 + 2]) * (1.0f / FACES) : 0.0f;
  }
  o[53] = s.game_over ? 1.0f : 0.0f;
  for (int p = 0; p < P; ++p) {
    float* q = o + 54 + 14 * p;
    const int dc = s.dice_count[p];
    q[0] = static_cast<float>(dc) * 0.5f;
    q[1] = dc > 0 ? 1.0f : 0.0f;
    for (int d = 0; d < DICE; ++d)
      for (int f = 0; f < FACES; ++f)
        q[2 + d * FACES + f] = (d < dc && s.dice[p * DICE + d] == f + 1) ? 1.0f : 0.0f;
  }
  for (int i = 110; i < PRIV_DIM; ++i) o[i] = 0.0f;
}

// Copy `count` rows of `width` elements between global and shared memory,
// consecutive threads on consecutive addresses.
template <typename T>
__device__ __forceinline__ void copy_rows(const T* src, T* dst, int count, int width) {
  for (int i = threadIdx.x; i < count * width; i += THREADS) dst[i] = src[i];
}

__global__ void __launch_bounds__(THREADS) liars_dice_step_autoreset_kernel(Args g) {
  extern __shared__ float smem[];
  float* obs_rows = smem;
  float* priv_rows = obs_rows + THREADS * OBS_DIM;
  float* mask_rows = priv_rows + THREADS * PRIV_DIM;
  int* state_rows = reinterpret_cast<int*>(mask_rows + THREADS * A);
  const long e0 = static_cast<long>(blockIdx.x) * THREADS;
  const int count = static_cast<int>(min(static_cast<long>(THREADS), g.num_envs - e0));
  copy_rows(g.ints + e0 * W, state_rows, count, W);
  __syncwarp();
  if (threadIdx.x < count) {
    const long e = e0 + threadIdx.x;
    int* row = state_rows + threadIdx.x * W;
    S s;
    int* sp = reinterpret_cast<int*>(&s);
    for (int i = 0; i < W; ++i) sp[i] = row[i];
    const float shaping = g.shaping[e];
    S t = s;
    float rewards[P];
    const bool done = step(s, g.action[e], g.u_step + e * P * DICE, shaping, t, rewards);
    const int len = g.acc_len[e] + 1;
    for (int p = 0; p < P; ++p) {
      const float total = g.acc_sum[e * P + p] + rewards[p];
      g.rewards[e * P + p] = rewards[p];
      g.log_total[e * P + p] = total;
      g.acc_sum_out[e * P + p] = done ? 0.0f : total;
      g.outcome[e * P + p] = t.placements[p];  // read from the stepped (terminal) state
    }
    g.acc_len_out[e] = done ? 0 : len;
    g.log_len[e] = len;
    g.active[e] = P;
    g.done[e] = done ? 1.0f : 0.0f;
    g.shaping_out[e] = shaping;  // the shaping coefficient survives the reset
    if (done) reset_state(t, g.u_reset + e * P * DICE);
    const int* tp = reinterpret_cast<const int*>(&t);
    for (int i = 0; i < W; ++i) row[i] = tp[i];
    write_obs(t, obs_rows + threadIdx.x * OBS_DIM);
    write_mask(t, mask_rows + threadIdx.x * A);
    write_priv(t, priv_rows + threadIdx.x * PRIV_DIM);
  }
  __syncwarp();
  copy_rows(state_rows, g.ints_out + e0 * W, count, W);
  copy_rows(obs_rows, g.obs + e0 * OBS_DIM, count, OBS_DIM);
  copy_rows(mask_rows, g.mask + e0 * A, count, A);
  copy_rows(priv_rows, g.priv + e0 * PRIV_DIM, count, PRIV_DIM);
}

}  // namespace

// in: the packed state [E, 73] i32, shaping [E], reward_sum [E, 4],
// length [E], action [E], reset and step uniforms [E, 8]; out: the i32 and
// the f32 buffer of envs/liars_dice.py I32_OUT and F32_OUT.
extern "C" int liars_dice_step_autoreset(const int* ints, const float* shaping,
                                         const float* acc_sum, const int* acc_len,
                                         const int* action, const float* u_reset,
                                         const float* u_step, int* out_i32, float* out_f32,
                                         int num_envs, void* stream) {
  if (num_envs <= 0) return 0;
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        liars_dice_step_autoreset_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = true;
  }
  const long E = num_envs;
  Args g;
  g.ints = ints;
  g.shaping = shaping;
  g.acc_sum = acc_sum;
  g.acc_len = acc_len;
  g.action = action;
  g.u_reset = u_reset;
  g.u_step = u_step;
  int* i = out_i32;
  g.ints_out = i;
  i += block_len(E, W);
  g.acc_len_out = i;
  i += block_len(E, 1);
  g.log_len = i;
  i += block_len(E, 1);
  g.outcome = i;
  i += block_len(E, P);
  g.active = i;
  float* f = out_f32;
  g.shaping_out = f;
  f += block_len(E, 1);
  g.acc_sum_out = f;
  f += block_len(E, P);
  g.rewards = f;
  f += block_len(E, P);
  g.done = f;
  f += block_len(E, 1);
  g.log_total = f;
  f += block_len(E, P);
  g.obs = f;
  f += block_len(E, OBS_DIM);
  g.mask = f;
  f += block_len(E, A);
  g.priv = f;
  g.num_envs = num_envs;
  const int blocks = static_cast<int>((E + THREADS - 1) / THREADS);
  liars_dice_step_autoreset_kernel<<<blocks, THREADS, SMEM_BYTES,
                                     static_cast<cudaStream_t>(stream)>>>(g);
  return static_cast<int>(cudaGetLastError());
}

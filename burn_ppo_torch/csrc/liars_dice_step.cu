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
// the packed state (76 i32), the shaping coefficient, the accumulators, the
// action and 16 uniforms, and writes the next state, the 270-wide obs, the
// 49-wide mask, the 120-wide privileged obs, rewards, log and accumulators:
// ~2.5 KB per env, ~10 MB per launch at E = 4096 (~3 us of HBM time).
//
// The host crossing is a few pointers: the integer state is ONE packed
// [E, 76] i32 buffer (envs/liars_dice.py LAYOUT, then three zero pad
// columns so that rows start 16-byte aligned), and the outputs are carved
// from one i32 and one f32 buffer (I32_OUT, F32_OUT there), each block
// E x columns starting on a 64-element boundary.
//
// A block takes EB envs with NT threads, in three phases (the design of
// csrc/skull_step.cu):
//   1. every thread: the block's state rows, one contiguous span, come in
//      with 16-byte loads and go to shared memory at an odd row stride
//      (77; packed_rows.cuh); before that, each stepping thread loads its env's action,
//      shaping coefficient, accumulators and both rows of uniforms, so that
//      every load is in flight before the barrier;
//   2. one thread per env, the block's first EB threads, so that their
//      per-env loads and stores coalesce, in place on its staged row
//      (validity is decided before anything changes, so one copy of the
//      state serves; the bid history is pushed in place): the step,
//      rewards, accumulators and episode log; a finished env's row becomes
//      the fresh game's; then the 49 mask bits of the post-reset row;
//   3. every thread: the rows go out with 16-byte stores; the obs,
//      privileged obs and mask are computed into shared memory by groups
//      of columns (per env 16 history rows, 8 bid quantities, 4 seats and
//      one head, each a few loads and straight-line stores, consecutive
//      threads on groups of one kind), then leave as the block's three
//      contiguous spans with 16-byte stores.
// Shared memory is static (~16.5 KB at 8 envs a block), so no function
// attribute needs setting before a launch. Latency, not bandwidth, bounds
// each phase, and instructions the output phase: a group decodes its env
// and columns once, where a loop over single columns decodes each and
// runs every branch of a divergent column kind. 8 envs x 8 warps a block
// was the fastest of the 12 tilings tried on an H100 (PERF.md).
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
//   * floor-mod for seats (x & 3 for four seats, in two's complement), the
//     lowest alive seat as the winner, and a loser seat out of range read
//     as 0 (JAX's one-hot reads);
//   * the dice: min(floor(u * 6), 5) + 1 from the uniforms, the reset's
//     for a fresh game, the step's for the reroll of a new round.

#include <cuda_runtime.h>

#include "packed_rows.cuh"

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
constexpr int PRIV_EXACT = 110;

// Column offsets of the packed row, in the order of envs/liars_dice.py LAYOUT.
constexpr int O_DICE = 0;
constexpr int O_DC = O_DICE + P * DICE;
constexpr int O_CUR = O_DC + P;
constexpr int O_QTY = O_CUR + 1;
constexpr int O_FACE = O_QTY + 1;
constexpr int O_BIDDER = O_FACE + 1;
constexpr int O_COUNT = O_BIDDER + 1;
constexpr int O_HIST = O_COUNT + 1;
constexpr int O_HLEN = O_HIST + HIST * 3;
constexpr int O_PLACE = O_HLEN + 1;
constexpr int O_NELIM = O_PLACE + P;
constexpr int O_OVER = O_NELIM + 1;
constexpr int O_STEP = O_OVER + 1;
constexpr int O_PAD = O_STEP + 1;
constexpr int W = 76;
static_assert(O_PAD == 73, "LAYOUT of envs/liars_dice.py");
constexpr int EB = 8;      // envs per block
constexpr int NT = 256;    // threads per block
using Rows = packed_rows::Rows<W, EB, NT>;
constexpr int WS = Rows::WS;  // shared-memory row stride, odd
static_assert(EB <= NT, "one stepping thread per env");

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

using packed_rows::block_len;

// Floor-mod by the four seats.
__device__ __forceinline__ int fmod_p(int x) { return x & (P - 1); }
static_assert(P == 4, "fmod_p is a mask for four seats");
__device__ __forceinline__ bool seat(int i) { return i >= 0 && i < P; }

// First seat with dice clockwise after frm (frm itself last); (frm+1) mod P
// when none has (burn_ppo_tpu/envs/base.py:73-88).
__device__ __forceinline__ int next_alive(const int* r, int frm) {
  int best = -1, best_d = P + 1;
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const int d = fmod_p(i - frm - 1);
    if (r[O_DC + i] > 0 && d < best_d) {
      best_d = d;
      best = i;
    }
  }
  return best >= 0 ? best : fmod_p(frm + 1);
}

// The f32 placement rewards (1.0, 0.33, -0.33, -1.0) of places 1-4.
__device__ __forceinline__ float placement_reward(int place) {
  return place <= 1 ? 1.0f : (place == 2 ? 0.33f : (place == 3 ? -0.33f : -1.0f));
}

__device__ __forceinline__ int face_of(float u) {
  return min(static_cast<int>(floorf(u * 6.0f)), FACES - 1) + 1;
}

// One step of one env in place (liars_dice.py:133-257); returns done.
__device__ __forceinline__ bool step(int* r, int action, const float* u, float shaping,
                                     float* rewards) {
  r[O_STEP] += 1;
#pragma unroll
  for (int p = 0; p < P; ++p) rewards[p] = 0.0f;
  const bool in_range = action >= 0 && action < A;
  const int a = min(max(action, 0), A - 1);
  const bool is_call = a == CALL;
  const int qty = a / FACES + 1, face = a % FACES + 1;
  int total = 0;
#pragma unroll
  for (int p = 0; p < P; ++p) total += r[O_DC + p];
  const int bq = r[O_QTY], bf = r[O_FACE];
  const bool no_bid = bq == 0;
  const bool higher = qty > bq || (qty == bq && face > bf);
  const bool bid_valid = !is_call && qty <= total && (no_bid || higher);
  const bool call_valid = is_call && !no_bid;
  if (r[O_OVER] != 0 || !in_range || !(bid_valid || call_valid)) {
    r[O_OVER] = 1;
    return true;
  }
  const int cur = r[O_CUR];
  if (!is_call) {
    // Bid: push (cur, qty, face) onto the ring, shifting when it is full.
    const int len = r[O_HLEN];
    int at = len;
    if (len >= HIST) {
#pragma unroll
      for (int i = 0; i < (HIST - 1) * 3; ++i) r[O_HIST + i] = r[O_HIST + i + 3];
      at = HIST - 1;
    }
    r[O_HIST + at * 3] = cur;
    r[O_HIST + at * 3 + 1] = qty;
    r[O_HIST + at * 3 + 2] = face;
    r[O_HLEN] = min(len + 1, HIST);
    r[O_QTY] = qty;
    r[O_FACE] = face;
    r[O_BIDDER] = cur;
    r[O_COUNT] += 1;
    r[O_CUR] = next_alive(r, cur);
    return false;
  }
  // Call (liars_dice.py:173-244), on the dice before any reroll.
  int actual = 0;
#pragma unroll
  for (int p = 0; p < P; ++p) {
#pragma unroll
    for (int d = 0; d < DICE; ++d) {
      const int v = r[O_DICE + p * DICE + d];
      actual += (d < r[O_DC + p] && (v == bf || (v == 1 && bf != 1))) ? 1 : 0;
    }
  }
  const int loser = actual < bq ? r[O_BIDDER] : cur;
  const int nelim = r[O_NELIM];
  int left = 0;
  if (seat(loser)) {
    left = r[O_DC + loser] - 1;
    r[O_DC + loser] = left;
  }
  const bool eliminated = left == 0;
  if (eliminated && seat(loser)) r[O_PLACE + loser] = P - nelim;
  r[O_NELIM] = nelim + (eliminated ? 1 : 0);
  int alive = 0, winner = -1;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    if (r[O_DC + p] > 0) {
      ++alive;
      if (winner < 0) winner = p;
    }
  }
  const bool over = alive <= 1;
  if (over) r[O_PLACE + (winner < 0 ? 0 : winner)] = 1;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    rewards[p] = over ? placement_reward(min(max(r[O_PLACE + p], 1), P))
                      : (r[O_DC + p] > 0 ? shaping : 0.0f);
  }
  r[O_OVER] = over ? 1 : 0;
  if (!over) {
    // A new round: every die rerolled, the round cleared, the loser (or
    // the next seat alive after it) opens.
#pragma unroll
    for (int i = 0; i < P * DICE; ++i) r[O_DICE + i] = face_of(u[i]);
    r[O_CUR] = left > 0 ? loser : next_alive(r, loser);
    r[O_QTY] = r[O_FACE] = r[O_COUNT] = r[O_HLEN] = 0;
    r[O_BIDDER] = -1;
#pragma unroll
    for (int i = 0; i < HIST * 3; ++i) r[O_HIST + i] = 0;
  }
  return over;
}

__device__ __forceinline__ void reset_row(int* r, const float* u) {
#pragma unroll
  for (int i = 0; i < P * DICE; ++i) r[O_DICE + i] = face_of(u[i]);
#pragma unroll
  for (int c = O_DC; c < W; ++c) r[c] = c < O_DC + P ? DICE : (c == O_BIDDER ? -1 : 0);
}

// The 49 mask bits of a post-reset row (liars_dice.py:312-324): bid
// (q, f) at bit (q - 1) * 6 + f - 1, CALL at bit 48.
__device__ unsigned long long mask_bits(const int* r) {
  int total = 0;
#pragma unroll
  for (int p = 0; p < P; ++p) total += r[O_DC + p];
  const int cur = r[O_CUR];
  const bool playable = (seat(cur) ? r[O_DC + cur] : 0) > 0 && r[O_OVER] == 0;
  if (!playable) return 0;
  const int bq = r[O_QTY], bf = r[O_FACE];
  const bool no_bid = bq == 0;
  // faces f > bf of a bid of quantity bq: bits f - 1 >= bf of six
  const unsigned same_qty = bf < 0 ? 0x3fu : (bf >= FACES ? 0u : (0x3fu << bf) & 0x3fu);
  unsigned long long m = 0;
#pragma unroll
  for (int q = 1; q <= MAX_DICE; ++q) {
    const unsigned faces = q > total ? 0u : ((no_bid || q > bq) ? 0x3fu : (q == bq ? same_qty : 0u));
    m |= static_cast<unsigned long long>(faces) << ((q - 1) * FACES);
  }
  if (!no_bid) m |= 1ull << CALL;
  return m;
}

__device__ __forceinline__ float f01(bool b) { return b ? 1.0f : 0.0f; }

// Phase 3 computes an env's obs, privileged obs and mask into its
// shared-memory rows by groups of columns, each a few loads and
// straight-line stores: per env HIST history groups, MAX_DICE quantity
// groups, P seat groups and one head group; consecutive threads take
// groups of one kind.
constexpr int GROUPS = HIST + MAX_DICE + P + 1;

// History row h: obs columns 78 + 12 h .. 89 + 12 h (oldest first), and
// privileged obs columns 5 + 3 h .. 7 + 3 h (newest first).
__device__ __forceinline__ void hist_group(const int* r, int h, float* obs, float* priv) {
  const int cur = r[O_CUR], len = r[O_HLEN];
  const bool valid = h < len;
  const int* hr = r + O_HIST + h * 3;
  const int rel = fmod_p(hr[0] + P - cur), q = hr[1], f = hr[2];
  float* o = obs + 78 + h * (P + 1 + FACES + 1);
#pragma unroll
  for (int k = 0; k < P; ++k) o[k] = f01(valid && rel == k);
  o[P] = valid ? static_cast<float>(q) * 0.125f : 0.0f;
#pragma unroll
  for (int i = 0; i < FACES; ++i) o[P + 1 + i] = f01(valid && f == i + 1);
  o[P + 1 + FACES] = f01(valid);
  const int src = len - 1 - h;
  const int* sr = r + O_HIST + min(max(src, 0), HIST - 1) * 3;
  float* v = priv + 5 + 3 * h;
  v[0] = src >= 0 ? static_cast<float>(sr[0]) * 0.25f : 0.0f;
  v[1] = src >= 0 ? static_cast<float>(sr[1]) * 0.125f : 0.0f;
  v[2] = src >= 0 ? static_cast<float>(sr[2]) * (1.0f / FACES) : 0.0f;
}

// Quantity qi + 1: its six faces of the bid one-hot (obs columns 24 +) and
// of the mask.
__device__ __forceinline__ void quantity_group(const int* r, unsigned long long m, int qi,
                                               float* obs, float* mask) {
  const int bq = r[O_QTY];
  const int bid_idx = bq > 0 ? (bq - 1) * FACES + (r[O_FACE] - 1) : -1;
#pragma unroll
  for (int f = 0; f < FACES; ++f) {
    const int c = qi * FACES + f;
    obs[24 + c] = f01(c == bid_idx);
    mask[c] = f01((m >> c) & 1ull);
  }
}

// Seat p: relative seat p's dice count, alive flag, turn flag and
// last-bidder flag in the obs; player p's 14 privileged columns.
__device__ __forceinline__ void seat_group(const int* r, int p, float* obs, float* priv) {
  const int cur = r[O_CUR], bidder = r[O_BIDDER];
  const int dc_rel = r[O_DC + fmod_p(p + cur)];
  obs[12 + p] = static_cast<float>(dc_rel) * 0.5f;
  obs[16 + p] = f01(dc_rel > 0);
  obs[20 + p] = f01(cur == p);
  obs[74 + p] = f01(bidder >= 0 && p == fmod_p(bidder + P - cur));
  const int dc = r[O_DC + p];
  float* q = priv + 54 + 14 * p;
  q[0] = static_cast<float>(dc) * 0.5f;
  q[1] = f01(dc > 0);
#pragma unroll
  for (int d = 0; d < DICE; ++d) {
    const int v = r[O_DICE + p * DICE + d];
#pragma unroll
    for (int f = 0; f < FACES; ++f) q[2 + d * FACES + f] = f01(d < dc && v == f + 1);
  }
}

// The rest: own dice, the bid flag and count, CALL, the privileged header,
// game over and the zero padding.
__device__ __forceinline__ void head_group(const int* r, unsigned long long m, float* obs,
                                           float* priv, float* mask) {
  const int cur = r[O_CUR], bq = r[O_QTY], bidder = r[O_BIDDER];
  const int own_count = seat(cur) ? r[O_DC + cur] : 0;
#pragma unroll
  for (int d = 0; d < DICE; ++d) {
    const int v = seat(cur) ? r[O_DICE + cur * DICE + d] : 0;
#pragma unroll
    for (int f = 0; f < FACES; ++f) obs[d * FACES + f] = f01(d < own_count && v == f + 1);
  }
  const bool has_bid = bq > 0;
  obs[72] = f01(has_bid);
  obs[73] = fminf(static_cast<float>(r[O_COUNT]) * (1.0f / 20.0f), 1.0f);
  mask[CALL] = f01((m >> CALL) & 1ull);
  priv[0] = static_cast<float>(cur) * 0.25f;
  priv[1] = has_bid ? static_cast<float>(bq) * 0.125f : 0.0f;
  priv[2] = has_bid ? static_cast<float>(r[O_FACE]) * (1.0f / FACES) : 0.0f;
  priv[3] = bidder >= 0 ? static_cast<float>(bidder) * 0.25f : -1.0f;
  priv[4] = static_cast<float>(r[O_COUNT]) * (1.0f / (P * 3));
  priv[53] = f01(r[O_OVER] != 0);
#pragma unroll
  for (int c = PRIV_EXACT; c < PRIV_DIM; ++c) priv[c] = 0.0f;
}

// Copy the block's count rows of WIDTH floats, one contiguous span, from
// shared to global memory: 16 bytes a thread where every block's span
// starts 16-byte aligned (EB * WIDTH a multiple of 4), the ragged end of a
// last block one float at a time.
template <int WIDTH>
__device__ __forceinline__ void copy_out(const float* src, float* dst, int count) {
  const int n = count * WIDTH;
  const int t = threadIdx.x;
  if constexpr (EB * WIDTH % 4 == 0) {
    constexpr int ITERS = (EB * WIDTH / 4 + NT - 1) / NT;
#pragma unroll
    for (int k = 0; k < ITERS; ++k) {
      const int i = t + k * NT;
      if (4 * i + 3 < n) {
        reinterpret_cast<float4*>(dst)[i] = reinterpret_cast<const float4*>(src)[i];
      } else {
        for (int q = 4 * i; q < n; ++q) dst[q] = src[q];
      }
    }
  } else {
    constexpr int ITERS = (EB * WIDTH + NT - 1) / NT;
#pragma unroll
    for (int k = 0; k < ITERS; ++k) {
      const int i = t + k * NT;
      if (i < n) dst[i] = src[i];
    }
  }
}

__global__ void __launch_bounds__(NT) liars_dice_step_autoreset_kernel(Args g) {
  __shared__ int rows[EB * WS];
  __shared__ unsigned long long mbits[EB];
  __shared__ __align__(16) float obs_s[EB * OBS_DIM];
  __shared__ __align__(16) float priv_s[EB * PRIV_DIM];
  __shared__ __align__(16) float mask_s[EB * A];
  const long e0 = static_cast<long>(blockIdx.x) * EB;
  const int count = static_cast<int>(min(static_cast<long>(EB), g.num_envs - e0));
  const int t = threadIdx.x;
  const long e = e0 + t;
  const bool stepper = t < count;

  // 1. The stepping threads' per-env inputs (both rows of uniforms, before
  // the step knows which it needs), then the rows: every load of a thread
  // in flight before its first shared-memory store.
  int action = 0, len = 0;
  float shaping = 0.0f, sum_in[P], u_reset[P * DICE], u_step[P * DICE];
  if (stepper) {
    action = g.action[e];
    shaping = g.shaping[e];
    len = g.acc_len[e] + 1;
#pragma unroll
    for (int p = 0; p < P; ++p) sum_in[p] = g.acc_sum[e * P + p];
#pragma unroll
    for (int i = 0; i < P * DICE; ++i) {
      u_reset[i] = g.u_reset[e * P * DICE + i];
      u_step[i] = g.u_step[e * P * DICE + i];
    }
  }
  Rows::stage(rows, g.ints + e0 * W, count, t);
  __syncthreads();

  // 2. The step, the reset and the mask bits, one thread per env.
  if (stepper) {
    int* r = rows + t * WS;
    float rewards[P];
    const bool done = step(r, action, u_step, shaping, rewards);
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const float total = sum_in[p] + rewards[p];
      g.rewards[e * P + p] = rewards[p];
      g.log_total[e * P + p] = total;
      g.acc_sum_out[e * P + p] = done ? 0.0f : total;
      g.outcome[e * P + p] = r[O_PLACE + p];  // read from the stepped (terminal) state
    }
    g.acc_len_out[e] = done ? 0 : len;
    g.log_len[e] = len;
    g.active[e] = P;
    g.done[e] = done ? 1.0f : 0.0f;
    g.shaping_out[e] = shaping;  // the shaping coefficient survives the reset
    if (done) reset_row(r, u_reset);
#pragma unroll
    for (int c = O_PAD; c < W; ++c) r[c] = 0;
    mbits[t] = mask_bits(r);
  }
  __syncthreads();

  // 3. The next state out; the obs, mask and privileged obs computed by
  // groups into shared memory, then out.
  Rows::store(g.ints_out + e0 * W, rows, count, t);
  constexpr int ITEMS = EB * GROUPS;
#pragma unroll
  for (int k = 0; k < (ITEMS + NT - 1) / NT; ++k) {
    int i = t + k * NT;
    if (i < EB * HIST) {
      const int ee = i / HIST;
      if (ee < count) {
        hist_group(rows + ee * WS, i - ee * HIST, obs_s + ee * OBS_DIM, priv_s + ee * PRIV_DIM);
      }
    } else if ((i -= EB * HIST) < EB * MAX_DICE) {
      const int ee = i / MAX_DICE;
      if (ee < count) {
        quantity_group(rows + ee * WS, mbits[ee], i - ee * MAX_DICE, obs_s + ee * OBS_DIM,
                       mask_s + ee * A);
      }
    } else if ((i -= EB * MAX_DICE) < EB * P) {
      const int ee = i / P;
      if (ee < count) {
        seat_group(rows + ee * WS, i - ee * P, obs_s + ee * OBS_DIM, priv_s + ee * PRIV_DIM);
      }
    } else if ((i -= EB * P) < count) {
      head_group(rows + i * WS, mbits[i], obs_s + i * OBS_DIM, priv_s + i * PRIV_DIM,
                 mask_s + i * A);
    }
  }
  __syncthreads();
  copy_out<OBS_DIM>(obs_s, g.obs + e0 * OBS_DIM, count);
  copy_out<PRIV_DIM>(priv_s, g.priv + e0 * PRIV_DIM, count);
  copy_out<A>(mask_s, g.mask + e0 * A, count);
}

}  // namespace

// in: the packed state [E, 76] i32, shaping [E], reward_sum [E, 4],
// length [E], action [E], reset and step uniforms [E, 8]; out: the i32 and
// the f32 buffer of envs/liars_dice.py I32_OUT and F32_OUT.
extern "C" int liars_dice_step_autoreset(const int* ints, const float* shaping,
                                         const float* acc_sum, const int* acc_len,
                                         const int* action, const float* u_reset,
                                         const float* u_step, int* out_i32, float* out_f32,
                                         int num_envs, void* stream) {
  if (num_envs <= 0) return 0;
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
  const int blocks = static_cast<int>((E + EB - 1) / EB);
  liars_dice_step_autoreset_kernel<<<blocks, NT, 0, static_cast<cudaStream_t>(stream)>>>(g);
  return static_cast<int>(cudaGetLastError());
}

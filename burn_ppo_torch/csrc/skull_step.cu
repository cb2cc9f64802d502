// K11 skull_step_autoreset — the Skull phase machine with rewards, done,
// episode log, auto-reset, accumulators, and the obs, action mask and
// privileged obs of the post-reset state, one launch per env step.
//
// Replaces the XLA fusion of burn_ppo_tpu/envs/skull.py Skull.step (280-526),
// obs (529-616), action_mask (619-678), privileged_obs (690-746),
// _placements/_final_rewards (200-226) and reset under
// burn_ppo_tpu/envs/base.py autoreset_step (234-274), vmapped over envs
// (ROADMAP queue B, item B13). Plain PyTorch twin:
// burn_ppo_torch/envs/base.py autoreset_step over
// burn_ppo_torch/envs/skull.py Skull, used for CPU tensors.
//
// What bounds it on an H100: the phase machine's dependent chain, then
// bytes. Per env it reads the packed state (108 i32), the shaping
// coefficient, the accumulators, the action and one uniform, and writes the
// next state, the 135-wide obs, the 33-wide mask, the 200-wide privileged
// obs, rewards, log and accumulators: ~2.4 KB per env, ~9.7 MB per launch
// at E = 4096 (~2.9 us of HBM time).
//
// The host crossing is a few pointers: the integer state is ONE packed
// [E, 108] i32 buffer (envs/skull.py LAYOUT, bools as 0 / 1, a zero pad
// column so that rows start 16-byte aligned), and the outputs are carved
// from one i32 and one f32 buffer (_outputs there), each block
// E x columns starting on a 64-element boundary.
//
// A block takes EB = 4 envs with NT = 128 threads (4 warps), in three
// phases:
//   1. every thread: the block's state rows, one contiguous span, come in
//      with 16-byte loads (all of a thread's loads issued before its first
//      shared-memory store) and go to shared memory at an odd row stride
//      (109; packed_rows.cuh), so that threads reading the same field of their rows hit
//      distinct banks; meanwhile each stepping thread loads its env's
//      action, uniform, shaping coefficient and accumulators;
//   2. one thread per env (its branches are serial): the step, in place on
//      its staged row (validity is decided before anything changes, so one
//      copy of the state serves), the placements of the stepped state, the
//      rewards, accumulators and episode log; a finished env's row becomes
//      the fresh game's; then a few derived words of the row (the current
//      player's hand, the relative seat maps, the 33 mask bits). Seat
//      searches are bit operations on a mask of the seats alive;
//   3. every thread: the rows go out with 16-byte stores, and the obs,
//      privileged obs and mask of the block's envs go straight to global
//      memory. Each output segment (a run of columns of one kind) is a loop
//      over its EB x width items, consecutive threads on consecutive
//      columns, so every warp runs one segment's code and its stores fall
//      on runs of consecutive addresses; the trip counts are compile-time,
//      so the loops unroll and a thread's shared-memory reads overlap.
// Latency, not bandwidth, bounds each phase: the envs per block and the
// warps per block trade the step's parallelism (EB lanes a block) against
// the output phase's (NT / EB threads an env); 4 x 4 was the fastest of the
// tilings tried on an H100 (PERF.md).

// Bit-exact with the plain version (integers, and f32 in the reference's
// operation order; built without fast math). The traps:
//   * floor-mod: (rel + cur) % n, (bidder + n - cur) % n and
//     (idx - frm - 1) % n are floor-mod in JAX, not C's truncating %;
//   * argmax ties take the lowest seat (the last bidder standing, the
//     winner when one player is left);
//   * a finished game or an unmasked / out-of-range action (validity from
//     the raw action, before the clip) returns the INPUT state, ended, with
//     zero rewards and step_idx + 1;
//   * the bid == total-cards shortcut applies to an opening bid and to a
//     raise;
//   * the lost coaster: choice = min(floor(u * c), c - 1) for
//     c = max(coasters, 1); choice 0 loses the skull if held, unless
//     forced_discard says otherwise; no rose goes with the skull or when
//     coasters == 0;
//   * XLA divides by a constant as a product with its f32 reciprocal, and
//     the final reward 1 - 2 eff / (n - 1) is one fused multiply-add; the
//     kernel writes both out the same way (fmaf, and x * (1.0f / 24.0f)).

#include <cuda_runtime.h>

#include <cstdint>

#include "packed_rows.cuh"

namespace {

constexpr int MAXP = 6;
constexpr int CARDS = 4;
constexpr int ROSES = 3;
constexpr int MAX_BID = MAXP * CARDS;
constexpr int WINS_TO_WIN = 2;
constexpr int BID_BASE = 2;
constexpr int PASS = BID_BASE + MAX_BID;
constexpr int REVEAL_BASE = PASS + 1;
constexpr int A = REVEAL_BASE + MAXP;
constexpr int HIST = 8;
constexpr int OBS_DIM = 135;
constexpr int PRIV_DIM = 200;
constexpr int PRIV_HIST = 10;
constexpr int SKULL_C = 2;
constexpr float INV_MAX_BID = 1.0f / MAX_BID;
constexpr float INV_MAXP = 1.0f / MAXP;
constexpr float INV_ROSES = 1.0f / ROSES;

// Column offsets of the packed row, in the order of envs/skull.py LAYOUT.
constexpr int O_TRAP = 0;
constexpr int O_ROSE = O_TRAP + MAXP;
constexpr int O_WINS = O_ROSE + MAXP;
constexpr int O_STACK = O_WINS + MAXP;
constexpr int O_SKIN = O_STACK + MAXP * CARDS;
constexpr int O_RSIN = O_SKIN + MAXP;
constexpr int O_LEN = O_RSIN + MAXP;
constexpr int O_PASSED = O_LEN + MAXP;
constexpr int O_PHASE = O_PASSED + MAXP;
constexpr int O_CUR = O_PHASE + 1;
constexpr int O_STARTER = O_CUR + 1;
constexpr int O_BID = O_STARTER + 1;
constexpr int O_BIDDER = O_BID + 1;
constexpr int O_HIST = O_BIDDER + 1;
constexpr int O_HLEN = O_HIST + HIST * 2;
constexpr int O_REV = O_HLEN + 1;
constexpr int O_FOUND = O_REV + MAXP;
constexpr int O_MUST = O_FOUND + 1;
constexpr int O_ELIM = O_MUST + 1;
constexpr int O_NELIM = O_ELIM + MAXP;
constexpr int O_OVER = O_NELIM + 1;
constexpr int O_WINNER = O_OVER + 1;
constexpr int O_STEP = O_WINNER + 1;
constexpr int O_FORCED = O_STEP + 1;
constexpr int O_PAD = O_FORCED + 1;
constexpr int W = O_PAD + 1;
static_assert(W == 108, "LAYOUT of envs/skull.py");
constexpr int EB = 4;      // envs per block
constexpr int NT = 128;    // threads per block
using Rows = packed_rows::Rows<W, EB, NT>;
constexpr int WS = Rows::WS;  // shared-memory row stride, odd

// Derived words of a post-reset row (the end of phase 2), per env.
enum Derived {
  D_HAND,       // bit 0 trap in hand, bits 1-3 roses in hand, bits 4-7 own skulls shown
  D_RELQ,       // 3 bits per relative seat r: the absolute seat (r + cur) mod n
  D_HREL,       // 3 bits per history row: (player + n - cur) mod n
  D_ALIVE,      // bit p: seat p alive
  D_BIDDER_OH,  // bit r: the bidder's relative seat (0 without a bidder)
  D_MASK_LO,    // mask bits 0-31
  D_MASK_HI,    // mask bit 32
  DW
};

struct Args {
  const int* ints;
  const float* shaping;
  const float* acc_sum;
  const int* acc_len;
  const int* action;
  const float* u;
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
  int n;
};

using packed_rows::block_len;

// Floor-mod by the player count; the seat arithmetic's x lies in [0, 2n)
// almost always, where a subtraction does.
__device__ __forceinline__ int fmod_n(int x, int n) {
  if (static_cast<unsigned>(x) < static_cast<unsigned>(2 * n)) return x >= n ? x - n : x;
  const int r = x % n;
  return r < 0 ? r + n : r;
}
__device__ __forceinline__ bool in_seats(int i) { return i >= 0 && i < MAXP; }
// A seat read that gives 0 out of range (JAX's one-hot reads).
__device__ __forceinline__ int rd(const int* r, int off, int i) { return in_seats(i) ? r[off + i] : 0; }

__device__ __forceinline__ bool alive(const int* r, int p, int n) {
  return p < n && (r[O_TRAP + p] != 0 || r[O_ROSE + p] > 0);
}
__device__ __forceinline__ int coasters(const int* r, int p) { return r[O_TRAP + p] + r[O_ROSE + p]; }

// Bit p: seat p alive (and, with skip_passed, not passed). Seats >= n
// are never alive.
__device__ __forceinline__ int seat_mask(const int* r, int n, bool skip_passed) {
  int m = 0;
#pragma unroll
  for (int p = 0; p < MAXP; ++p) {
    if (alive(r, p, n) && !(skip_passed && r[O_PASSED + p] != 0)) m |= 1 << p;
  }
  return m;
}

// First seat of the mask clockwise after frm (frm itself last); (frm + 1)
// mod n when the mask is empty (burn_ppo_tpu/envs/base.py:73-88): the
// lowest seat above f = frm mod n, else the lowest seat at all.
__device__ __forceinline__ int next_seat(int mask, int frm, int n) {
  const int f = fmod_n(frm, n);
  const int above = mask >> (f + 1);
  if (above != 0) return f + __ffs(above);
  if (mask != 0) return __ffs(mask) - 1;
  return f + 1 == n ? 0 : f + 1;
}

__device__ void start_new_round(int* r, int starter, int n) {
  const int cur = (in_seats(starter) && alive(r, starter, n)) ? starter
                                                              : next_seat(seat_mask(r, n, false), starter, n);
#pragma unroll
  for (int i = 0; i < MAXP * CARDS; ++i) r[O_STACK + i] = 0;
#pragma unroll
  for (int p = 0; p < MAXP; ++p) {
    r[O_SKIN + p] = r[O_RSIN + p] = r[O_LEN + p] = r[O_REV + p] = r[O_PASSED + p] = 0;
  }
#pragma unroll
  for (int i = 0; i < HIST * 2; ++i) r[O_HIST + i] = 0;
  r[O_PHASE] = 0;
  r[O_BID] = 0;
  r[O_BIDDER] = -1;
  r[O_HLEN] = 0;
  r[O_FOUND] = 0;
  r[O_MUST] = 0;
  r[O_CUR] = cur;
  r[O_STARTER] = cur;
}

// Shift-on-full ring append (burn_ppo_tpu/envs/base.py:91-105).
__device__ void push_hist(int* r, int player, int bid) {
  const int len = r[O_HLEN];
  const bool full = len >= HIST;
  if (full) {
#pragma unroll
    for (int i = 0; i < 2 * (HIST - 1); ++i) r[O_HIST + i] = r[O_HIST + i + 2];
  }
  const int at = full ? HIST - 1 : len;
  if (at >= 0 && at < HIST) {
    r[O_HIST + 2 * at] = player;
    r[O_HIST + 2 * at + 1] = bid;
  }
  r[O_HLEN] = min(len + 1, HIST);
}

__device__ void to_revealing(int* r) {
  r[O_PHASE] = 2;
  r[O_CUR] = r[O_BIDDER];
  r[O_MUST] = 1;
  r[O_FOUND] = 0;
#pragma unroll
  for (int p = 0; p < MAXP; ++p) r[O_REV + p] = 0;
}

__device__ void check_bidding_end(int* r, int n) {
  const int left = seat_mask(r, n, true);
  if (__popc(left) == 1) {
    r[O_BIDDER] = __ffs(left) - 1;  // argmax: the lowest seat
    to_revealing(r);
  } else if (left != 0) {
    r[O_CUR] = next_seat(left, r[O_CUR], n);
  }
}

// An opening bid from placing or a raise while bidding.
__device__ void make_bid(int* r, int cur, int bid_value, int total_cards, int n) {
  r[O_PHASE] = 1;
  r[O_BID] = bid_value;
  r[O_BIDDER] = cur;
  push_hist(r, cur, bid_value);
  const int left = seat_mask(r, n, true);
  if (bid_value == total_cards) {
    to_revealing(r);
  } else if (left != 0) {
    r[O_CUR] = next_seat(left, cur, n);
  } else {
    check_bidding_end(r, n);
  }
}

// The 33 mask bits of a row (skull.py:619-678): bits 0-31 in lo, 32 in hi.
__device__ void mask_bits(const int* r, int n, unsigned* lo, unsigned* hi) {
  const int cur = r[O_CUR];
  const int phase = r[O_PHASE];
  int total_cards = 0;
#pragma unroll
  for (int p = 0; p < MAXP; ++p) total_cards += r[O_LEN + p];
  const int non_passed = __popc(seat_mask(r, n, true));
  const bool placing = phase == 0, bidding = phase == 1, revealing = phase == 2;
  const bool trap_hand = rd(r, O_TRAP, cur) != 0 && rd(r, O_SKIN, cur) == 0;
  const int roses_hand = rd(r, O_ROSE, cur) - rd(r, O_RSIN, cur);
  unsigned long long m = 0;
  if (placing && trap_hand) m |= 1ull;
  if (placing && roses_hand > 0) m |= 2ull;
  const bool can_open = placing && rd(r, O_LEN, cur) > 0;
  if (can_open || bidding) {
    // bids b in [max(current_bid + 1, 1), total_cards], bit BID_BASE + b - 1
    const int b0 = max(r[O_BID] + 1, 1), b1 = min(total_cards, MAX_BID);
    if (b1 >= b0) m |= ((1ull << (b1 - b0 + 1)) - 1ull) << (BID_BASE + b0 - 1);
  }
  if (bidding && rd(r, O_PASSED, cur) == 0 && non_passed > 1) m |= 1ull << PASS;
  const int bidder = r[O_BIDDER];
  if (revealing && cur == bidder) {
    const int own_unrevealed = in_seats(bidder) ? r[O_LEN + bidder] - r[O_REV + bidder] : 0;
    const bool must_own = r[O_MUST] != 0 && own_unrevealed > 0;
#pragma unroll
    for (int p = 0; p < MAXP; ++p) {
      const int unrevealed = r[O_LEN + p] - r[O_REV + p];
      const bool pick = must_own ? p == bidder : (unrevealed > 0 && p < n);
      if (pick && unrevealed > 0) m |= 1ull << (REVEAL_BASE + p);
    }
  }
  if (r[O_OVER] != 0) m = 0;
  *lo = static_cast<unsigned>(m);
  *hi = static_cast<unsigned>(m >> 32);
}

// Bit a of mask_bits alone: whether action a is legal in row r.
__device__ bool legal(const int* r, int n, int a) {
  if (a < 0 || a >= A || r[O_OVER] != 0) return false;
  const int cur = r[O_CUR], phase = r[O_PHASE];
  if (a < BID_BASE) {
    if (phase != 0) return false;
    return a == 0 ? rd(r, O_TRAP, cur) != 0 && rd(r, O_SKIN, cur) == 0
                  : rd(r, O_ROSE, cur) - rd(r, O_RSIN, cur) > 0;
  }
  if (a < PASS) {
    if (!(phase == 1 || (phase == 0 && rd(r, O_LEN, cur) > 0))) return false;
    int total_cards = 0;
#pragma unroll
    for (int p = 0; p < MAXP; ++p) total_cards += r[O_LEN + p];
    const int b = a - BID_BASE + 1;
    return b >= max(r[O_BID] + 1, 1) && b <= total_cards;
  }
  if (a == PASS) return phase == 1 && rd(r, O_PASSED, cur) == 0 && __popc(seat_mask(r, n, true)) > 1;
  const int bidder = r[O_BIDDER];
  if (phase != 2 || cur != bidder) return false;
  const int p = a - REVEAL_BASE;
  const int own_unrevealed = in_seats(bidder) ? r[O_LEN + bidder] - r[O_REV + bidder] : 0;
  const bool must_own = r[O_MUST] != 0 && own_unrevealed > 0;
  const int unrevealed = r[O_LEN + p] - r[O_REV + p];
  return (must_own ? p == bidder : p < n) && unrevealed > 0;
}

// Reward events of a step: none, the bidder's shaping, or the final rewards.
enum Event { EV_NONE, EV_SHAPED, EV_FINAL };

// One step of one env in place (skull.py:280-526); returns done.
__device__ bool step(int* r, int action, float u, float rsc, int n, int* event, int* who,
                     float* shaped) {
  *event = EV_NONE;
  const bool valid = legal(r, n, action);
  r[O_STEP] += 1;
  if (r[O_OVER] != 0 || !valid) {
    r[O_OVER] = 1;
    return true;
  }
  const int a = action;
  const int cur = r[O_CUR];
  int total_cards = 0;
#pragma unroll
  for (int p = 0; p < MAXP; ++p) total_cards += r[O_LEN + p];
  const int bid_value = min(max(a - BID_BASE + 1, 1), MAX_BID);
  const int phase = min(max(r[O_PHASE], 0), 2);  // lax.switch clamps its index

  if (phase == 0 && a < BID_BASE) {  // place a card
    if (in_seats(cur)) {
      const int len = r[O_LEN + cur];
      const int cell = cur * CARDS + len;
      if (cell >= 0 && cell < MAXP * CARDS) r[O_STACK + cell] = a == 0 ? SKULL_C : 1;
      r[O_LEN + cur] = len + 1;
      r[(a == 0 ? O_SKIN : O_RSIN) + cur] += 1;
    }
    r[O_CUR] = next_seat(seat_mask(r, n, false), cur, n);
    return false;
  }
  if (phase == 1 && a == PASS) {
    if (in_seats(cur)) r[O_PASSED + cur] = 1;
    push_hist(r, cur, 0);
    check_bidding_end(r, n);
    return false;
  }
  if (phase < 2) {
    make_bid(r, cur, bid_value, total_cards, n);
    return false;
  }
  // Reveal a card.
  const int bidder = r[O_BIDDER];
  const int target = min(max(a - REVEAL_BASE, 0), MAXP - 1);
  const int card_idx = r[O_LEN + target] - 1 - r[O_REV + target];
  const bool is_skull = r[O_STACK + target * CARDS + min(max(card_idx, 0), CARDS - 1)] == SKULL_C;
  r[O_REV + target] += 1;
  r[O_FOUND] += is_skull ? 0 : 1;
  const bool own_done = target == bidder && rd(r, O_LEN, bidder) - rd(r, O_REV, bidder) <= 0;
  if (own_done) r[O_MUST] = 0;
  const bool b_in = in_seats(bidder);
  if (is_skull) {
    const int coasters_b = b_in ? coasters(r, bidder) : 0;
    const bool trap_b = rd(r, O_TRAP, bidder) != 0;
    const int roses_b = rd(r, O_ROSE, bidder);
    const int c = max(coasters_b, 1);
    const int choice = min(static_cast<int>(floorf(u * static_cast<float>(c))), c - 1);
    bool lose_skull = trap_b && choice == 0;
    const int forced = r[O_FORCED];
    if (forced == 0) {
      lose_skull = trap_b;
    } else if (forced == 1) {
      lose_skull = trap_b && roses_b == 0;
    }
    if (b_in) {
      if (lose_skull) r[O_TRAP + bidder] = 0;
      r[O_ROSE + bidder] += (lose_skull || coasters_b == 0) ? 0 : -1;
      if (coasters(r, bidder) == 0 && r[O_ELIM + bidder] < 0) {
        r[O_ELIM + bidder] = r[O_NELIM];
        r[O_NELIM] += 1;
      }
    }
    const int alive_now = seat_mask(r, n, false);
    if (__popc(alive_now) <= 1) {
      r[O_OVER] = 1;
      r[O_WINNER] = __ffs(alive_now) - 1;  // the lowest seat alive, -1 for none
      *event = EV_FINAL;
      return true;
    }
    if (b_in && bidder < n) {
      *event = EV_SHAPED;
      *who = bidder;
      *shaped = rsc > 0.0f ? -rsc / CARDS : 0.0f;
    }
    int starter;
    if (b_in && alive(r, bidder, n)) {
      starter = bidder;
    } else if (alive(r, target, n)) {
      starter = target;
    } else {
      starter = next_seat(alive_now, target, n);
    }
    start_new_round(r, starter, n);
    return false;
  }
  if (r[O_FOUND] >= r[O_BID]) {
    if (b_in) r[O_WINS + bidder] += 1;
    if (rd(r, O_WINS, bidder) >= WINS_TO_WIN || __popc(seat_mask(r, n, false)) == 1) {
      r[O_OVER] = 1;
      r[O_WINNER] = bidder;
      *event = EV_FINAL;
      return true;
    }
    if (b_in && bidder < n) {
      *event = EV_SHAPED;
      *who = bidder;
      *shaped = rsc > 0.0f ? rsc : 0.0f;
    }
    start_new_round(r, bidder, n);
  }
  return false;
}

// The fresh game's value of column c (Skull.reset).
__device__ __forceinline__ int reset_value(int c, int n) {
  if (c < O_TRAP + MAXP) return c - O_TRAP < n ? 1 : 0;
  if (c < O_ROSE + MAXP) return c - O_ROSE < n ? ROSES : 0;
  if ((c >= O_ELIM && c < O_ELIM + MAXP) || c == O_BIDDER || c == O_WINNER || c == O_FORCED) return -1;
  return 0;
}

// The derived words of a post-reset row (phase 2's end).
__device__ void derive(const int* r, int n, int* d) {
  const int cur = r[O_CUR];
  const bool in_cur = in_seats(cur);
  const int roses = min(max(rd(r, O_ROSE, cur) - rd(r, O_RSIN, cur), 0), ROSES);
  const int len_cur = rd(r, O_LEN, cur);
  int hand = (rd(r, O_TRAP, cur) != 0 && rd(r, O_SKIN, cur) == 0) ? 1 : 0;
#pragma unroll
  for (int i = 0; i < ROSES; ++i) hand |= (i < roses ? 1 : 0) << (1 + i);
#pragma unroll
  for (int i = 0; i < CARDS; ++i) {
    const int cell = in_cur ? r[O_STACK + cur * CARDS + i] : 0;
    hand |= (cell == SKULL_C && i < len_cur ? 1 : 0) << (4 + i);
  }
  int relq = 0, hrel = 0;
#pragma unroll
  for (int s = 0; s < MAXP; ++s) relq |= fmod_n(s + cur, n) << (3 * s);
#pragma unroll
  for (int h = 0; h < HIST; ++h) hrel |= fmod_n(r[O_HIST + 2 * h] + n - cur, n) << (3 * h);
  const int bidder = r[O_BIDDER];
  unsigned lo, hi;
  mask_bits(r, n, &lo, &hi);
  d[D_HAND] = hand;
  d[D_RELQ] = relq;
  d[D_HREL] = hrel;
  d[D_ALIVE] = seat_mask(r, n, false);
  d[D_BIDDER_OH] = bidder >= 0 ? 1 << fmod_n(bidder + n - cur, n) : 0;
  d[D_MASK_LO] = static_cast<int>(lo);
  d[D_MASK_HI] = static_cast<int>(hi);
}

// Phase 3 helper: f(env, column) for the EB x WIDTH items of one output
// segment, written to out[env * stride + column * STEP] (out at the
// segment's first column of the block's first env). The trip count is a
// compile-time constant, so the loop unrolls.
template <int WIDTH, int STEP = 1, typename F>
__device__ __forceinline__ void segment(float* out, int stride, int count, F f) {
  constexpr int ITERS = (EB * WIDTH + NT - 1) / NT;
#pragma unroll
  for (int k = 0; k < ITERS; ++k) {
    const int i = static_cast<int>(threadIdx.x) + k * NT;
    if (i < count * WIDTH) {
      const int e = i / WIDTH, c = i - e * WIDTH;
      out[static_cast<long>(e) * stride + c * STEP] = f(e, c);
    }
  }
}

__device__ __forceinline__ float f01(bool b) { return b ? 1.0f : 0.0f; }

// Privileged obs column 43 + 10 p + K of every player p (skull.py:731-742):
// the field at offset OFF, times SCALE (the reference's f32 reciprocal
// product, or an exact power of two).
template <int K, int OFF>
__device__ __forceinline__ void per_player(float* priv, const int* rows, int count, float scale) {
  segment<MAXP, 10>(priv + 43 + K, PRIV_DIM, count, [&](int e, int p) {
    return static_cast<float>(rows[e * WS + OFF + p]) * scale;
  });
}

__device__ void write_outputs(const Args& g, const int* rows, const int* der, long e0, int count) {
  const int n = g.n;
  auto row = [&](int e) { return rows + e * WS; };
  auto dv = [&](int e, int k) { return der[e * DW + k]; };
  // Absolute seat of relative seat c, or -1 past the n seats.
  auto seat = [&](int e, int c) { return c < n ? (dv(e, D_RELQ) >> (3 * c)) & 7 : -1; };
  float* obs = g.obs + e0 * OBS_DIM;
  float* priv = g.priv + e0 * PRIV_DIM;

  // -- obs (skull.py:529-616) ------------------------------------------------
  segment<8>(obs, OBS_DIM, count, [&](int e, int c) { return f01((dv(e, D_HAND) >> c) & 1); });
  segment<6>(obs + 8, OBS_DIM, count, [&](int e, int c) {
    const int q = seat(e, c);
    return q < 0 ? 0.0f : static_cast<float>(row(e)[O_LEN + q]) * (1.0f / CARDS);
  });
  segment<6>(obs + 14, OBS_DIM, count, [&](int e, int c) {
    const int q = seat(e, c);
    return q < 0 ? 0.0f : static_cast<float>(coasters(row(e), q)) * (1.0f / CARDS);
  });
  segment<6>(obs + 20, OBS_DIM, count, [&](int e, int c) {
    const int q = seat(e, c);
    return f01(q >= 0 && ((dv(e, D_ALIVE) >> q) & 1));
  });
  segment<6>(obs + 26, OBS_DIM, count, [&](int, int c) { return f01(c < n); });
  segment<6>(obs + 32, OBS_DIM, count, [&](int e, int c) { return f01(row(e)[O_CUR] == c); });
  segment<3>(obs + 38, OBS_DIM, count, [&](int e, int c) { return f01(row(e)[O_PHASE] == c); });
  segment<1>(obs + 41, OBS_DIM, count, [&](int e, int) {
    return static_cast<float>(row(e)[O_BID]) * INV_MAX_BID;
  });
  segment<6>(obs + 42, OBS_DIM, count, [&](int e, int c) {
    return f01((dv(e, D_BIDDER_OH) >> c) & 1);
  });
  segment<6>(obs + 48, OBS_DIM, count, [&](int e, int c) {
    const int q = seat(e, c);
    return f01(q >= 0 && row(e)[O_PASSED + q] != 0);
  });
  segment<6>(obs + 54, OBS_DIM, count, [&](int e, int c) {
    const int q = seat(e, c);
    return q < 0 ? 0.0f : static_cast<float>(row(e)[O_WINS + q]) * (1.0f / WINS_TO_WIN);
  });
  segment<6>(obs + 60, OBS_DIM, count, [&](int e, int c) {
    const int q = seat(e, c);
    return q < 0 ? 0.0f : static_cast<float>(row(e)[O_REV + q]) * (1.0f / CARDS);
  });
  segment<MAXP - 1>(obs + 66, OBS_DIM, count, [&](int, int c) { return f01(n - 2 == c); });
  segment<HIST*(MAXP + 2)>(obs + 71, OBS_DIM, count, [&](int e, int c) {
    const int h = c >> 3, k = c & 7;
    const int* r = row(e);
    const bool hv = h < r[O_HLEN];
    const int bid = r[O_HIST + 2 * h + 1];
    if (k < MAXP) return f01(hv && ((dv(e, D_HREL) >> (3 * h)) & 7) == k);
    if (k == MAXP) return hv ? static_cast<float>(bid) * INV_MAX_BID : 0.0f;
    return f01(hv && bid == 0);
  });

  // -- mask (skull.py:619-678) -----------------------------------------------
  segment<A>(g.mask + e0 * A, A, count, [&](int e, int c) {
    return f01(((c < 32 ? dv(e, D_MASK_LO) >> c : dv(e, D_MASK_HI)) & 1) != 0);
  });

  // -- privileged obs (skull.py:690-746) ---------------------------------------
  segment<7>(priv, PRIV_DIM, count, [&](int e, int c) {
    const int* r = row(e);
    if (c < 3) return f01(r[O_PHASE] == c);
    if (c == 3) return static_cast<float>(r[O_CUR]) * INV_MAXP;
    if (c == 4) return static_cast<float>(r[O_STARTER]) * INV_MAXP;
    const bool bid_on = r[O_BID] > 0;
    if (c == 5) return bid_on ? static_cast<float>(r[O_BID]) * INV_MAX_BID : 0.0f;
    return (bid_on && r[O_BIDDER] >= 0) ? static_cast<float>(r[O_BIDDER]) * INV_MAXP : -1.0f;
  });
  segment<3 * PRIV_HIST>(priv + 7, PRIV_DIM, count, [&](int e, int c) {
    const int* r = row(e);
    const int h = c / 3, k = c - 3 * h;
    const int src = r[O_HLEN] - 1 - h;
    const int at = min(max(src, 0), HIST - 1);
    const int player = r[O_HIST + 2 * at], bid = r[O_HIST + 2 * at + 1];
    if (src < 0) return 0.0f;
    if (k == 0) return static_cast<float>(player) * INV_MAXP;
    if (k == 1) return static_cast<float>(bid) * INV_MAX_BID;
    return f01(bid == 0);
  });
  segment<6>(priv + 37, PRIV_DIM, count, [&](int e, int c) {
    return c == 0 ? f01(row(e)[O_OVER] != 0) : f01(n - 2 == c - 1);
  });
  // Per player, one uniform segment per column of its 10 (bools are 0 / 1).
  segment<MAXP, 10>(priv + 43, PRIV_DIM, count, [&](int, int p) { return f01(p < n); });
  per_player<1, O_WINS>(priv, rows, count, 1.0f / WINS_TO_WIN);
  segment<MAXP, 10>(priv + 45, PRIV_DIM, count, [&](int e, int p) {
    return f01((dv(e, D_ALIVE) >> p) & 1);
  });
  per_player<3, O_TRAP>(priv, rows, count, 1.0f);
  per_player<4, O_ROSE>(priv, rows, count, INV_ROSES);
  per_player<5, O_LEN>(priv, rows, count, 1.0f / CARDS);
  per_player<6, O_SKIN>(priv, rows, count, 1.0f / CARDS);
  per_player<7, O_RSIN>(priv, rows, count, 1.0f / CARDS);
  per_player<8, O_PASSED>(priv, rows, count, 1.0f);
  per_player<9, O_REV>(priv, rows, count, 1.0f / CARDS);
  // The zero padding, columns 103-199: one float, then 24 float4 (a row is
  // 800 bytes, so column 104 of every row is 16-byte aligned).
  constexpr int Z4 = (PRIV_DIM - 104) / 4;
  constexpr int ZITERS = (EB * (Z4 + 1) + NT - 1) / NT;
#pragma unroll
  for (int k = 0; k < ZITERS; ++k) {
    const int i = static_cast<int>(threadIdx.x) + k * NT;
    if (i < count * (Z4 + 1)) {
      const int e = i / (Z4 + 1), c = i - e * (Z4 + 1);
      float* rowp = priv + static_cast<long>(e) * PRIV_DIM;
      if (c == 0) {
        rowp[103] = 0.0f;
      } else {
        reinterpret_cast<float4*>(rowp + 104)[c - 1] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
    }
  }
}

__global__ void __launch_bounds__(NT) skull_step_autoreset_kernel(Args g) {
  __shared__ int rows[EB * WS];
  __shared__ int der[EB * DW];
  const int n = g.n;
  const long e0 = static_cast<long>(blockIdx.x) * EB;
  const int count = static_cast<int>(min(static_cast<long>(EB), g.num_envs - e0));
  const int t = threadIdx.x;
  const long e = e0 + t;
  const bool stepper = t < count;

  // 1. The stepping threads' per-env inputs, then the rows: every load
  // of a thread in flight before its first shared-memory store.
  int action = 0, len = 0;
  float u = 0.0f, rsc = 0.0f, sum_in[MAXP];
  if (stepper) {
    action = g.action[e];
    u = g.u[e];
    rsc = g.shaping[e];
    len = g.acc_len[e] + 1;
#pragma unroll
    for (int p = 0; p < MAXP; ++p) sum_in[p] = p < n ? g.acc_sum[e * n + p] : 0.0f;
  }
  Rows::stage(rows, g.ints + e0 * W, count, t);
  __syncthreads();

  // 2. The step, the reset and the derived words, one thread per env.
  if (stepper) {
    int* r = rows + t * WS;
    int event, who = -1;
    float shaped = 0.0f;
    const bool done = step(r, action, u, rsc, n, &event, &who, &shaped);
    // Competition-ranked placements of the stepped state (skull.py:200-215).
    int key[MAXP], place[MAXP];
#pragma unroll
    for (int p = 0; p < MAXP; ++p) {
      const int ep = r[O_ELIM + p];
      key[p] = static_cast<int>(r[O_WINNER] == p) * (1 << 24) + r[O_WINS + p] * (1 << 16) +
               coasters(r, p) * (1 << 8) + (ep >= 0 ? ep : r[O_NELIM]);
    }
#pragma unroll
    for (int p = 0; p < MAXP; ++p) {
      int better = 0;
#pragma unroll
      for (int q = 0; q < MAXP; ++q) better += (q < n && key[q] > key[p]) ? 1 : 0;
      place[p] = better + 1;
    }
    const float inv = 1.0f / static_cast<float>(n - 1);
#pragma unroll
    for (int p = 0; p < MAXP; ++p) {
      if (p < n) {
        float rew = 0.0f;
        if (event == EV_FINAL) {
          float ties = 0.0f;
#pragma unroll
          for (int q = 0; q < MAXP; ++q) ties += (q < n && place[q] == place[p]) ? 1.0f : 0.0f;
          const float eff = (static_cast<float>(place[p]) - 1.0f) + (ties - 1.0f) * 0.5f;
          rew = fmaf(-(2.0f * eff), inv, 1.0f);
        } else if (event == EV_SHAPED && p == who) {
          rew = shaped;
        }
        const long k = e * n + p;
        const float total = sum_in[p] + rew;
        g.rewards[k] = rew;
        g.log_total[k] = total;
        g.acc_sum_out[k] = done ? 0.0f : total;
        g.outcome[k] = place[p];  // read from the stepped (terminal) state
      }
    }
    g.acc_len_out[e] = done ? 0 : len;
    g.log_len[e] = len;
    g.active[e] = n;
    g.done[e] = done ? 1.0f : 0.0f;
    g.shaping_out[e] = rsc;  // the shaping coefficient survives the reset
    if (done) {
#pragma unroll
      for (int c = 0; c < W; ++c) r[c] = reset_value(c, n);
    }
    derive(r, n, der + t * DW);
  }
  __syncthreads();

  // 3. The next state, obs, mask and privileged obs.
  Rows::store(g.ints_out + e0 * W, rows, count, t);
  write_outputs(g, rows, der, e0, count);
}

}  // namespace

// in: the packed state [E, 108] i32, shaping [E], reward_sum [E, n],
// length [E], action [E], u [E]; out: the i32 and the f32 buffer of
// envs/skull.py _outputs.
extern "C" int skull_step_autoreset(const int* ints, const float* shaping, const float* acc_sum,
                                    const int* acc_len, const int* action, const float* u,
                                    int* out_i32, float* out_f32, int num_envs, int num_players,
                                    void* stream) {
  if (num_players < 2 || num_players > MAXP) return static_cast<int>(cudaErrorInvalidValue);
  if (num_envs <= 0) return 0;
  const long E = num_envs;
  const int n = num_players;
  Args g;
  g.ints = ints;
  g.shaping = shaping;
  g.acc_sum = acc_sum;
  g.acc_len = acc_len;
  g.action = action;
  g.u = u;
  int* i = out_i32;
  g.ints_out = i;
  i += block_len(E, W);
  g.acc_len_out = i;
  i += block_len(E, 1);
  g.log_len = i;
  i += block_len(E, 1);
  g.outcome = i;
  i += block_len(E, n);
  g.active = i;
  float* f = out_f32;
  g.shaping_out = f;
  f += block_len(E, 1);
  g.acc_sum_out = f;
  f += block_len(E, n);
  g.rewards = f;
  f += block_len(E, n);
  g.done = f;
  f += block_len(E, 1);
  g.log_total = f;
  f += block_len(E, n);
  g.obs = f;
  f += block_len(E, OBS_DIM);
  g.mask = f;
  f += block_len(E, A);
  g.priv = f;
  g.num_envs = num_envs;
  g.n = n;
  const int blocks = static_cast<int>((E + EB - 1) / EB);
  skull_step_autoreset_kernel<<<blocks, NT, 0, static_cast<cudaStream_t>(stream)>>>(g);
  return static_cast<int>(cudaGetLastError());
}

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
// What bounds it on an H100: launch latency, then bytes. Per env it reads
// ~420 B of state and writes the next state, the 135-wide obs, the 33-wide
// mask, the 200-wide privileged obs, rewards, log and accumulators: ~2 KB
// per env, ~8.5 MB per launch at E = 4096 (~2.5 us of HBM time). Eager
// PyTorch runs the same step as a few thousand small kernels (every branch
// computed and selected). The design: one thread per env, the state in
// local memory, the branch that applies taken with real control flow (the
// branches are pure, so taking one equals selecting it). Each thread's work
// is a long dependent chain, so the grid is spread thin: one warp per
// block, 128 blocks at E = 4096, one or two per SM. The obs, privileged
// obs and mask rows of a block's 32 envs are contiguous in the outputs;
// each thread writes its rows into shared memory and the warp then copies
// the block's rows out with consecutive threads on consecutive addresses.
//
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
constexpr int ROSE_C = 1;
constexpr int SKULL_C = 2;
constexpr int THREADS = 32;  // one warp per block
constexpr float INV_MAX_BID = 1.0f / MAX_BID;
constexpr float INV_MAXP = 1.0f / MAXP;
constexpr float INV_ROSES = 1.0f / ROSES;

// The fields of burn_ppo_torch/envs/skull.py SkullState, in its order.
enum Field {
  F_HAS_TRAP, F_ROSE_COUNT, F_WINS, F_STACK, F_SKULLS_IN, F_ROSES_IN, F_STACK_LEN,
  F_PASSED, F_PHASE, F_CURRENT, F_ROUND_STARTER, F_CURRENT_BID, F_CURRENT_BIDDER,
  F_HIST, F_HIST_LEN, F_REVEALED, F_ROSES_FOUND, F_MUST_REVEAL_OWN, F_ELIM_POS,
  F_NUM_ELIMINATED, F_GAME_OVER, F_WINNER, F_STEP_IDX, F_SHAPING_COEF,
  F_FORCED_DISCARD, NUM_FIELDS
};
// Inputs after the fields: reward_sum [E, n], length [E], action [E], u [E].
constexpr int NUM_IN = NUM_FIELDS + 4;
// Outputs after the fields: reward_sum, length, rewards, done, log total
// rewards, log length, outcome, active players, obs, mask, privileged obs.
constexpr int NUM_OUT = NUM_FIELDS + 11;

struct InPtrs {
  const void* p[NUM_IN];
};
struct OutPtrs {
  void* p[NUM_OUT];
};

struct S {
  bool has_trap[MAXP];
  int rose_count[MAXP];
  int wins[MAXP];
  int stack[MAXP * CARDS];
  int skulls_in[MAXP];
  int roses_in[MAXP];
  int stack_len[MAXP];
  bool passed[MAXP];
  int phase, current, round_starter, current_bid, current_bidder;
  int hist[HIST * 2];
  int hist_len;
  int revealed[MAXP];
  int roses_found;
  bool must_reveal_own;
  int elim_pos[MAXP];
  int num_eliminated;
  bool game_over;
  int winner;
  int step_idx;
  float shaping_coef;
  int forced_discard;
};

__device__ __forceinline__ int fmod_n(int x, int n) { return ((x % n) + n) % n; }
__device__ __forceinline__ bool in_seats(int i) { return i >= 0 && i < MAXP; }
__device__ __forceinline__ int rd(const int* a, int i) { return in_seats(i) ? a[i] : 0; }
__device__ __forceinline__ bool rdb(const bool* a, int i) { return in_seats(i) && a[i]; }

__device__ __forceinline__ bool alive(const S& s, int p, int n) {
  return p < n && (s.has_trap[p] || s.rose_count[p] > 0);
}
__device__ __forceinline__ int coasters(const S& s, int p) {
  return static_cast<int>(s.has_trap[p]) + s.rose_count[p];
}

// First seat with ok[] clockwise after frm (frm itself last); (frm+1) mod n
// when there is none (burn_ppo_tpu/envs/base.py:73-88).
__device__ int first_clockwise(const bool* ok, int frm, int n) {
  int best = -1, best_d = MAXP + 1;
  for (int i = 0; i < MAXP; ++i) {
    if (!ok[i]) continue;
    const int d = fmod_n(i - frm - 1, n);
    if (d < best_d) {
      best_d = d;
      best = i;
    }
  }
  return best >= 0 ? best : fmod_n(frm + 1, n);
}

__device__ int next_alive(const S& s, int frm, int n) {
  bool ok[MAXP];
  for (int p = 0; p < MAXP; ++p) ok[p] = alive(s, p, n);
  return first_clockwise(ok, frm, n);
}

__device__ int next_non_passed(const S& s, int frm, int n, bool* found) {
  bool ok[MAXP];
  bool any = false;
  for (int p = 0; p < MAXP; ++p) {
    ok[p] = alive(s, p, n) && !s.passed[p];
    any = any || ok[p];
  }
  *found = any;
  return first_clockwise(ok, frm, n);
}

__device__ void reset_state(S& s, int n, float shaping_coef) {
  for (int p = 0; p < MAXP; ++p) {
    s.has_trap[p] = p < n;
    s.rose_count[p] = p < n ? ROSES : 0;
    s.wins[p] = s.skulls_in[p] = s.roses_in[p] = s.stack_len[p] = s.revealed[p] = 0;
    s.passed[p] = false;
    s.elim_pos[p] = -1;
  }
  for (int i = 0; i < MAXP * CARDS; ++i) s.stack[i] = 0;
  for (int i = 0; i < HIST * 2; ++i) s.hist[i] = 0;
  s.phase = s.current = s.round_starter = s.current_bid = 0;
  s.current_bidder = -1;
  s.hist_len = s.roses_found = s.num_eliminated = s.step_idx = 0;
  s.must_reveal_own = s.game_over = false;
  s.winner = -1;
  s.shaping_coef = shaping_coef;
  s.forced_discard = -1;
}

__device__ void start_new_round(S& s, int starter, int n) {
  const bool starter_alive = in_seats(starter) && alive(s, starter, n);
  const int cur = starter_alive ? starter : next_alive(s, starter, n);
  for (int i = 0; i < MAXP * CARDS; ++i) s.stack[i] = 0;
  for (int p = 0; p < MAXP; ++p) {
    s.skulls_in[p] = s.roses_in[p] = s.stack_len[p] = s.revealed[p] = 0;
    s.passed[p] = false;
  }
  for (int i = 0; i < HIST * 2; ++i) s.hist[i] = 0;
  s.phase = 0;
  s.current_bid = 0;
  s.current_bidder = -1;
  s.hist_len = 0;
  s.roses_found = 0;
  s.must_reveal_own = false;
  s.current = cur;
  s.round_starter = cur;
}

// Shift-on-full ring append (burn_ppo_tpu/envs/base.py:91-105).
__device__ void push_hist(S& s, int player, int bid) {
  const bool full = s.hist_len >= HIST;
  if (full) {
    for (int i = 0; i < HIST - 1; ++i) {
      s.hist[2 * i] = s.hist[2 * i + 2];
      s.hist[2 * i + 1] = s.hist[2 * i + 3];
    }
  }
  const int at = full ? HIST - 1 : s.hist_len;
  if (at >= 0 && at < HIST) {
    s.hist[2 * at] = player;
    s.hist[2 * at + 1] = bid;
  }
  s.hist_len = min(s.hist_len + 1, HIST);
}

__device__ void to_revealing(S& s) {
  s.phase = 2;
  s.current = s.current_bidder;
  s.must_reveal_own = true;
  s.roses_found = 0;
  for (int p = 0; p < MAXP; ++p) s.revealed[p] = 0;
}

__device__ void check_bidding_end(S& s, int n) {
  int count = 0, last = -1;
  for (int p = 0; p < MAXP; ++p) {
    if (alive(s, p, n) && !s.passed[p]) {
      ++count;
      if (last < 0) last = p;  // argmax: the lowest seat
    }
  }
  bool found;
  const int nxt = next_non_passed(s, s.current, n, &found);
  if (count == 1) {
    s.current_bidder = last;
    to_revealing(s);
  } else if (found) {
    s.current = nxt;
  }
}

// An opening bid from placing or a raise while bidding.
__device__ void make_bid(S& s, int cur, int bid_value, int total_cards, int n) {
  s.phase = 1;
  s.current_bid = bid_value;
  s.current_bidder = cur;
  push_hist(s, cur, bid_value);
  bool found;
  const int nxt = next_non_passed(s, cur, n, &found);
  if (bid_value == total_cards) {
    to_revealing(s);
  } else if (found) {
    s.current = nxt;
  } else {
    check_bidding_end(s, n);
  }
}

__device__ void action_mask(const S& s, int n, bool* m) {
  const int cur = s.current;
  int total_cards = 0;
  for (int p = 0; p < MAXP; ++p) total_cards += s.stack_len[p];
  const bool placing = s.phase == 0, bidding = s.phase == 1, revealing = s.phase == 2;
  const bool trap_hand = rdb(s.has_trap, cur) && rd(s.skulls_in, cur) == 0;
  const int roses_hand = rd(s.rose_count, cur) - rd(s.roses_in, cur);
  m[0] = placing && trap_hand;
  m[1] = placing && roses_hand > 0;
  const bool can_open = placing && rd(s.stack_len, cur) > 0;
  const int min_bid = max(s.current_bid + 1, 1);
  for (int b = 1; b <= MAX_BID; ++b) {
    m[BID_BASE + b - 1] = (can_open || bidding) && b >= min_bid && b <= total_cards;
  }
  int non_passed = 0;
  for (int p = 0; p < MAXP; ++p) non_passed += alive(s, p, n) && !s.passed[p];
  m[PASS] = bidding && !rdb(s.passed, cur) && non_passed > 1;
  const int bidder = s.current_bidder;
  const bool is_bidder = revealing && cur == bidder;
  const int own_unrevealed =
      bidder >= 0 ? (in_seats(bidder) ? s.stack_len[bidder] - s.revealed[bidder] : 0) : 0;
  const bool must_own = s.must_reveal_own && own_unrevealed > 0;
  for (int p = 0; p < MAXP; ++p) {
    const int unrevealed = s.stack_len[p] - s.revealed[p];
    const bool pick = must_own ? p == bidder : (unrevealed > 0 && p < n);
    m[REVEAL_BASE + p] = is_bidder && pick && unrevealed > 0;
  }
  if (s.game_over) {
    for (int a = 0; a < A; ++a) m[a] = false;
  }
}

// Competition-ranked placements (skull.py:200-215).
__device__ void placements(const S& s, int n, int* place) {
  int key[MAXP];
  for (int p = 0; p < n; ++p) {
    const int elim_rank = s.elim_pos[p] >= 0 ? s.elim_pos[p] : s.num_eliminated;
    key[p] = static_cast<int>(s.winner == p) * (1 << 24) + s.wins[p] * (1 << 16) +
             coasters(s, p) * (1 << 8) + elim_rank;
  }
  for (int p = 0; p < n; ++p) {
    int better = 0;
    for (int q = 0; q < n; ++q) better += key[q] > key[p];
    place[p] = better + 1;
  }
}

__device__ void final_rewards(const S& s, int n, float* r) {
  int place[MAXP];
  placements(s, n, place);
  const float inv = 1.0f / static_cast<float>(n - 1);
  for (int p = 0; p < n; ++p) {
    float ties = 0.0f;
    for (int q = 0; q < n; ++q) ties += place[q] == place[p] ? 1.0f : 0.0f;
    const float eff = (static_cast<float>(place[p]) - 1.0f) + (ties - 1.0f) * 0.5f;
    r[p] = fmaf(-(2.0f * eff), inv, 1.0f);
  }
}

// One step of one env (skull.py:280-526). rewards[0, n) and done out.
__device__ void step(const S& in, int action, float u, int n, S& s, float* rewards, bool* done) {
  bool m[A];
  action_mask(in, n, m);
  const bool valid = action >= 0 && action < A && m[action];
  s = in;
  for (int p = 0; p < MAXP; ++p) rewards[p] = 0.0f;
  *done = false;
  if (in.game_over || !valid) {
    s.game_over = true;
    *done = true;
    s.step_idx = in.step_idx + 1;
    return;
  }
  const int a = min(max(action, 0), A - 1);
  const int cur = s.current;
  int total_cards = 0;
  for (int p = 0; p < MAXP; ++p) total_cards += s.stack_len[p];
  const int bid_value = min(max(a - BID_BASE + 1, 1), MAX_BID);
  const int phase = min(max(s.phase, 0), 2);  // lax.switch clamps its index

  if (phase == 0 && a < BID_BASE) {  // place a card
    const int card = a == 0 ? SKULL_C : ROSE_C;
    if (in_seats(cur)) {
      const int cell = cur * CARDS + s.stack_len[cur];
      if (cell >= 0 && cell < MAXP * CARDS) s.stack[cell] = card;
      s.stack_len[cur] += 1;
      if (card == SKULL_C) {
        s.skulls_in[cur] += 1;
      } else {
        s.roses_in[cur] += 1;
      }
    }
    s.current = next_alive(s, cur, n);
  } else if (phase == 1 && a == PASS) {
    if (in_seats(cur)) s.passed[cur] = true;
    push_hist(s, cur, 0);
    check_bidding_end(s, n);
  } else if (phase < 2) {
    make_bid(s, cur, bid_value, total_cards, n);
  } else {  // reveal a card
    const int bidder = s.current_bidder;
    const int target = min(max(a - REVEAL_BASE, 0), MAXP - 1);
    const int card_idx = s.stack_len[target] - 1 - s.revealed[target];
    const int card = s.stack[target * CARDS + min(max(card_idx, 0), CARDS - 1)];
    const bool is_skull = card == SKULL_C;
    s.revealed[target] += 1;
    s.roses_found += is_skull ? 0 : 1;
    const bool own_done = target == bidder && rd(s.stack_len, bidder) - rd(s.revealed, bidder) <= 0;
    s.must_reveal_own = s.must_reveal_own && !own_done;
    const float rsc = s.shaping_coef;
    const bool b_in = in_seats(bidder);
    if (is_skull) {
      const int coasters_b = b_in ? coasters(s, bidder) : 0;
      const bool trap_b = rdb(s.has_trap, bidder);
      const int roses_b = rd(s.rose_count, bidder);
      const int c = max(coasters_b, 1);
      const int choice = min(static_cast<int>(floorf(u * static_cast<float>(c))), c - 1);
      bool lose_skull = trap_b && choice == 0;
      if (s.forced_discard == 0) {
        lose_skull = trap_b;
      } else if (s.forced_discard == 1) {
        lose_skull = trap_b && roses_b == 0;
      }
      if (b_in) {
        s.has_trap[bidder] = s.has_trap[bidder] && !lose_skull;
        s.rose_count[bidder] += (lose_skull || coasters_b == 0) ? 0 : -1;
        if (coasters(s, bidder) == 0 && s.elim_pos[bidder] < 0) {
          s.elim_pos[bidder] = s.num_eliminated;
          s.num_eliminated += 1;
        }
      }
      int alive_cnt = 0, first = -1;
      for (int p = 0; p < MAXP; ++p) {
        if (alive(s, p, n)) {
          ++alive_cnt;
          if (first < 0) first = p;
        }
      }
      if (alive_cnt <= 1) {
        s.game_over = true;
        s.winner = alive_cnt >= 1 ? first : -1;
        final_rewards(s, n, rewards);
        *done = true;
      } else {
        if (b_in && bidder < n) rewards[bidder] = rsc > 0.0f ? -rsc / CARDS : 0.0f;
        int starter;
        if (b_in && alive(s, bidder, n)) {
          starter = bidder;
        } else if (alive(s, target, n)) {
          starter = target;
        } else {
          starter = next_alive(s, target, n);
        }
        start_new_round(s, starter, n);
      }
    } else if (s.roses_found >= s.current_bid) {
      if (b_in) s.wins[bidder] += 1;
      int alive_cnt = 0;
      for (int p = 0; p < MAXP; ++p) alive_cnt += alive(s, p, n);
      if (rd(s.wins, bidder) >= WINS_TO_WIN || alive_cnt == 1) {
        s.game_over = true;
        s.winner = bidder;
        final_rewards(s, n, rewards);
        *done = true;
      } else {
        if (b_in && bidder < n) rewards[bidder] = rsc > 0.0f ? rsc : 0.0f;
        start_new_round(s, bidder, n);
      }
    }
  }
  s.step_idx = in.step_idx + 1;
}

// Player-relative obs (skull.py:529-616).
__device__ void write_obs(const S& s, int n, float* o) {
  const int cur = s.current;
  const bool trap_hand = rdb(s.has_trap, cur) && rd(s.skulls_in, cur) == 0;
  const int roses_hand = min(max(rd(s.rose_count, cur) - rd(s.roses_in, cur), 0), ROSES);
  o[0] = trap_hand ? 1.0f : 0.0f;
  for (int i = 0; i < ROSES; ++i) o[1 + i] = i < roses_hand ? 1.0f : 0.0f;
  const int len_cur = rd(s.stack_len, cur);
  for (int i = 0; i < CARDS; ++i) {
    const int cell = in_seats(cur) ? s.stack[cur * CARDS + i] : 0;
    o[4 + i] = (cell == SKULL_C && i < len_cur) ? 1.0f : 0.0f;
  }
  for (int r = 0; r < MAXP; ++r) {
    const bool v = r < n;
    const int q = fmod_n(r + cur, n);
    o[8 + r] = v ? static_cast<float>(s.stack_len[q]) * (1.0f / CARDS) : 0.0f;
    o[14 + r] = v ? static_cast<float>(coasters(s, q)) * (1.0f / CARDS) : 0.0f;
    o[20 + r] = (v && alive(s, q, n)) ? 1.0f : 0.0f;
    o[26 + r] = v ? 1.0f : 0.0f;
    o[32 + r] = cur == r ? 1.0f : 0.0f;
    o[48 + r] = (v && s.passed[q]) ? 1.0f : 0.0f;
    o[54 + r] = v ? static_cast<float>(s.wins[q]) * (1.0f / WINS_TO_WIN) : 0.0f;
    o[60 + r] = v ? static_cast<float>(s.revealed[q]) * (1.0f / CARDS) : 0.0f;
  }
  for (int i = 0; i < 3; ++i) o[38 + i] = s.phase == i ? 1.0f : 0.0f;
  o[41] = static_cast<float>(s.current_bid) * INV_MAX_BID;
  const int bidder_rel = fmod_n(s.current_bidder + n - cur, n);
  for (int r = 0; r < MAXP; ++r) o[42 + r] = (s.current_bidder >= 0 && bidder_rel == r) ? 1.0f : 0.0f;
  for (int i = 0; i < MAXP - 1; ++i) o[66 + i] = n - 2 == i ? 1.0f : 0.0f;
  for (int h = 0; h < HIST; ++h) {
    float* row = o + 71 + h * (MAXP + 2);
    const bool hv = h < s.hist_len;
    const int rel = fmod_n(s.hist[2 * h] + n - cur, n);
    const int bid = s.hist[2 * h + 1];
    for (int r = 0; r < MAXP; ++r) row[r] = (hv && rel == r) ? 1.0f : 0.0f;
    row[MAXP] = hv ? static_cast<float>(bid) * INV_MAX_BID : 0.0f;
    row[MAXP + 1] = (hv && bid == 0) ? 1.0f : 0.0f;
  }
}

// CTDE privileged obs (skull.py:690-746): 103 floats, zero padded to 200.
__device__ void write_priv(const S& s, int n, float* o) {
  for (int i = 0; i < 3; ++i) o[i] = s.phase == i ? 1.0f : 0.0f;
  o[3] = static_cast<float>(s.current) * INV_MAXP;
  o[4] = static_cast<float>(s.round_starter) * INV_MAXP;
  const bool bid_on = s.current_bid > 0;
  o[5] = bid_on ? static_cast<float>(s.current_bid) * INV_MAX_BID : 0.0f;
  o[6] = (bid_on && s.current_bidder >= 0) ? static_cast<float>(s.current_bidder) * INV_MAXP : -1.0f;
  for (int h = 0; h < PRIV_HIST; ++h) {
    const int src = s.hist_len - 1 - h;
    const bool hv = src >= 0;
    const int row = min(max(src, 0), HIST - 1);
    const int player = s.hist[2 * row], bid = s.hist[2 * row + 1];
    o[7 + 3 * h] = hv ? static_cast<float>(player) * INV_MAXP : 0.0f;
    o[8 + 3 * h] = hv ? static_cast<float>(bid) * INV_MAX_BID : 0.0f;
    o[9 + 3 * h] = (hv && bid == 0) ? 1.0f : 0.0f;
  }
  o[37] = s.game_over ? 1.0f : 0.0f;
  for (int i = 0; i < MAXP - 1; ++i) o[38 + i] = n - 2 == i ? 1.0f : 0.0f;
  for (int p = 0; p < MAXP; ++p) {
    float* q = o + 43 + 10 * p;
    q[0] = p < n ? 1.0f : 0.0f;
    q[1] = static_cast<float>(s.wins[p]) * (1.0f / WINS_TO_WIN);
    q[2] = alive(s, p, n) ? 1.0f : 0.0f;
    q[3] = s.has_trap[p] ? 1.0f : 0.0f;
    q[4] = static_cast<float>(s.rose_count[p]) * INV_ROSES;
    q[5] = static_cast<float>(s.stack_len[p]) * (1.0f / CARDS);
    q[6] = static_cast<float>(s.skulls_in[p]) * (1.0f / CARDS);
    q[7] = static_cast<float>(s.roses_in[p]) * (1.0f / CARDS);
    q[8] = s.passed[p] ? 1.0f : 0.0f;
    q[9] = static_cast<float>(s.revealed[p]) * (1.0f / CARDS);
  }
  for (int i = 103; i < PRIV_DIM; ++i) o[i] = 0.0f;
}

template <typename T>
__device__ __forceinline__ void load(const InPtrs& in, int f, long e, int width, T* dst) {
  const T* src = static_cast<const T*>(in.p[f]) + e * width;
  for (int i = 0; i < width; ++i) dst[i] = src[i];
}

template <typename T>
__device__ __forceinline__ void store(const OutPtrs& out, int f, long e, int width, const T* src) {
  T* dst = static_cast<T*>(out.p[f]) + e * width;
  for (int i = 0; i < width; ++i) dst[i] = src[i];
}

__device__ void load_state(const InPtrs& in, long e, S& s) {
  load(in, F_HAS_TRAP, e, MAXP, s.has_trap);
  load(in, F_ROSE_COUNT, e, MAXP, s.rose_count);
  load(in, F_WINS, e, MAXP, s.wins);
  load(in, F_STACK, e, MAXP * CARDS, s.stack);
  load(in, F_SKULLS_IN, e, MAXP, s.skulls_in);
  load(in, F_ROSES_IN, e, MAXP, s.roses_in);
  load(in, F_STACK_LEN, e, MAXP, s.stack_len);
  load(in, F_PASSED, e, MAXP, s.passed);
  load(in, F_PHASE, e, 1, &s.phase);
  load(in, F_CURRENT, e, 1, &s.current);
  load(in, F_ROUND_STARTER, e, 1, &s.round_starter);
  load(in, F_CURRENT_BID, e, 1, &s.current_bid);
  load(in, F_CURRENT_BIDDER, e, 1, &s.current_bidder);
  load(in, F_HIST, e, HIST * 2, s.hist);
  load(in, F_HIST_LEN, e, 1, &s.hist_len);
  load(in, F_REVEALED, e, MAXP, s.revealed);
  load(in, F_ROSES_FOUND, e, 1, &s.roses_found);
  load(in, F_MUST_REVEAL_OWN, e, 1, &s.must_reveal_own);
  load(in, F_ELIM_POS, e, MAXP, s.elim_pos);
  load(in, F_NUM_ELIMINATED, e, 1, &s.num_eliminated);
  load(in, F_GAME_OVER, e, 1, &s.game_over);
  load(in, F_WINNER, e, 1, &s.winner);
  load(in, F_STEP_IDX, e, 1, &s.step_idx);
  load(in, F_SHAPING_COEF, e, 1, &s.shaping_coef);
  load(in, F_FORCED_DISCARD, e, 1, &s.forced_discard);
}

__device__ void store_state(const OutPtrs& out, long e, const S& s) {
  store(out, F_HAS_TRAP, e, MAXP, s.has_trap);
  store(out, F_ROSE_COUNT, e, MAXP, s.rose_count);
  store(out, F_WINS, e, MAXP, s.wins);
  store(out, F_STACK, e, MAXP * CARDS, s.stack);
  store(out, F_SKULLS_IN, e, MAXP, s.skulls_in);
  store(out, F_ROSES_IN, e, MAXP, s.roses_in);
  store(out, F_STACK_LEN, e, MAXP, s.stack_len);
  store(out, F_PASSED, e, MAXP, s.passed);
  store(out, F_PHASE, e, 1, &s.phase);
  store(out, F_CURRENT, e, 1, &s.current);
  store(out, F_ROUND_STARTER, e, 1, &s.round_starter);
  store(out, F_CURRENT_BID, e, 1, &s.current_bid);
  store(out, F_CURRENT_BIDDER, e, 1, &s.current_bidder);
  store(out, F_HIST, e, HIST * 2, s.hist);
  store(out, F_HIST_LEN, e, 1, &s.hist_len);
  store(out, F_REVEALED, e, MAXP, s.revealed);
  store(out, F_ROSES_FOUND, e, 1, &s.roses_found);
  store(out, F_MUST_REVEAL_OWN, e, 1, &s.must_reveal_own);
  store(out, F_ELIM_POS, e, MAXP, s.elim_pos);
  store(out, F_NUM_ELIMINATED, e, 1, &s.num_eliminated);
  store(out, F_GAME_OVER, e, 1, &s.game_over);
  store(out, F_WINNER, e, 1, &s.winner);
  store(out, F_STEP_IDX, e, 1, &s.step_idx);
  store(out, F_SHAPING_COEF, e, 1, &s.shaping_coef);
  store(out, F_FORCED_DISCARD, e, 1, &s.forced_discard);
}

// Everything of env e but the obs, privileged obs and mask rows, which go
// to the given (shared-memory) rows.
__device__ void step_env(const InPtrs& in, const OutPtrs& out, long e, int n, float* obs_row,
                         float* priv_row, float* mask_row) {
  S s, stepped;
  load_state(in, e, s);
  const int action = static_cast<const int*>(in.p[NUM_FIELDS + 2])[e];
  const float u = static_cast<const float*>(in.p[NUM_FIELDS + 3])[e];
  float rewards[MAXP];
  bool done;
  step(s, action, u, n, stepped, rewards, &done);

  const float* sum_in = static_cast<const float*>(in.p[NUM_FIELDS]) + e * n;
  const int len = static_cast<const int*>(in.p[NUM_FIELDS + 1])[e] + 1;
  float* sum_out = static_cast<float*>(out.p[NUM_FIELDS]) + e * n;
  float* rew_out = static_cast<float*>(out.p[NUM_FIELDS + 2]) + e * n;
  float* ret_out = static_cast<float*>(out.p[NUM_FIELDS + 4]) + e * n;
  int* outcome_out = static_cast<int*>(out.p[NUM_FIELDS + 6]) + e * n;
  int place[MAXP];
  placements(stepped, n, place);  // read from the stepped (terminal) state
  for (int p = 0; p < n; ++p) {
    const float total = sum_in[p] + rewards[p];
    rew_out[p] = rewards[p];
    ret_out[p] = total;
    sum_out[p] = done ? 0.0f : total;
    outcome_out[p] = place[p];
  }
  static_cast<int*>(out.p[NUM_FIELDS + 1])[e] = done ? 0 : len;
  static_cast<float*>(out.p[NUM_FIELDS + 3])[e] = done ? 1.0f : 0.0f;
  static_cast<int*>(out.p[NUM_FIELDS + 5])[e] = len;
  static_cast<int*>(out.p[NUM_FIELDS + 7])[e] = n;

  if (done) reset_state(s, n, stepped.shaping_coef);  // the shaping coefficient survives
  const S& next = done ? s : stepped;
  store_state(out, e, next);
  write_obs(next, n, obs_row);
  bool m[A];
  action_mask(next, n, m);
  for (int a = 0; a < A; ++a) mask_row[a] = m[a] ? 1.0f : 0.0f;
  write_priv(next, n, priv_row);
}


// The block's rows, staged so that their stores coalesce (47,104 bytes).
struct Rows {
  float obs[THREADS * OBS_DIM];
  float priv[THREADS * PRIV_DIM];
  float mask[THREADS * A];
};

// Copy the first `count` rows of `width` floats from shared memory to
// dst, consecutive threads on consecutive addresses.
__device__ __forceinline__ void copy_rows(const float* src, float* dst, int count, int width) {
  for (int i = threadIdx.x; i < count * width; i += THREADS) dst[i] = src[i];
}

__global__ void __launch_bounds__(THREADS) skull_step_autoreset_kernel(InPtrs in, OutPtrs out,
                                                                      int num_envs, int n) {
  __shared__ Rows rows;
  const long e0 = static_cast<long>(blockIdx.x) * THREADS;
  const long e = e0 + threadIdx.x;
  if (e < num_envs) step_env(in, out, e, n, rows.obs + threadIdx.x * OBS_DIM,
                             rows.priv + threadIdx.x * PRIV_DIM, rows.mask + threadIdx.x * A);
  __syncwarp();
  const int count = static_cast<int>(min(static_cast<long>(THREADS), num_envs - e0));
  copy_rows(rows.obs, static_cast<float*>(out.p[NUM_FIELDS + 8]) + e0 * OBS_DIM, count, OBS_DIM);
  copy_rows(rows.mask, static_cast<float*>(out.p[NUM_FIELDS + 9]) + e0 * A, count, A);
  copy_rows(rows.priv, static_cast<float*>(out.p[NUM_FIELDS + 10]) + e0 * PRIV_DIM, count,
            PRIV_DIM);
}

}  // namespace

extern "C" int skull_step_autoreset(const void* const* in, void* const* out, int num_envs,
                                    int num_players, void* stream) {
  if (num_envs <= 0) return 0;
  if (num_players < 2 || num_players > MAXP) return static_cast<int>(cudaErrorInvalidValue);
  InPtrs ip;
  OutPtrs op;
  for (int i = 0; i < NUM_IN; ++i) ip.p[i] = in[i];
  for (int i = 0; i < NUM_OUT; ++i) op.p[i] = out[i];
  const int blocks = (num_envs + THREADS - 1) / THREADS;
  skull_step_autoreset_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      ip, op, num_envs, num_players);
  return static_cast<int>(cudaGetLastError());
}

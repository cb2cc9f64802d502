// K4 connect_four_step_autoreset — Connect Four move, win check, rewards,
// outcome, episode log, auto-reset, obs and action mask, one launch per
// env step. With the reset flag off, a finished env keeps its stepped
// (terminal) row, and the obs and mask are that row's: a watched game's
// last move. With the sampling front (connect_four_sample_step_kernel,
// eval's stats engine), the block first samples its envs' actions with
// K14's row code (temperature_sample.cuh), then steps with them: K14's
// launch folded into the step's.
//
// Replaces the XLA fusion of burn_ppo_tpu/envs/connect_four.py
// ConnectFour.step/_has_win/obs/action_mask/game_outcome/reset (35-156)
// under burn_ppo_tpu/envs/base.py autoreset_step (234-274), vmapped over
// envs (ROADMAP queue B, item B10). Plain PyTorch twin:
// burn_ppo_torch/envs/base.py autoreset_step over
// burn_ppo_torch/envs/connect_four.py ConnectFour, used for CPU tensors.
//
// What bounds it on an H100: launch latency, then bytes. Per env it reads
// the packed state (48 i32), the accumulators and the action, and writes
// the next state, the 86-wide obs, the 7-wide mask, rewards, log and
// accumulators: ~0.9 KB per env, ~3.6 MB per launch at E = 4096 (about a
// microsecond of HBM time).
//
// The host crossing is a few pointers: the state is ONE packed [E, 48] i32
// buffer (envs/connect_four.py LAYOUT: the 42 cells, current, winner,
// done as 0 / 1, step_idx, two zero pad columns so that rows start 16-byte
// aligned), and the outputs are carved from one i32 and one f32 buffer
// (I32_OUT, F32_OUT there), each block E x columns starting on a
// 64-element boundary.
//
// A block takes EB envs with NT threads, in three phases (the design of
// csrc/skull_step.cu):
//   1. every thread: the block's state rows, one contiguous span, come in
//      with 16-byte loads and go to shared memory at an odd row stride
//      (49; packed_rows.cuh); before that, each stepping thread loads its env's action and
//      accumulators, so that every load is in flight before the barrier;
//   2. one thread per env, the block's first EB threads, so that their
//      per-env loads and stores coalesce, in place on its staged row: the
//      occupancy and the mover's 49-bit bitboards (7 bits per column, the
//      7th a zero guard, so no window wraps from one column into the next)
//      from one pass over the 42 cells, the drop, the 69-window win check
//      as four shift-and-AND tests, rewards, outcome, accumulators and log;
//      a finished env's row becomes the fresh game's;
//   3. every thread: the rows go out with 16-byte stores, the obs with
//      16-byte stores over the block's contiguous obs span (EB x 86 floats,
//      a whole number of 16-byte runs for even EB), the mask by one loop
//      over EB x 7 columns; consecutive threads on consecutive addresses,
//      compile-time trip counts.
// Latency, not bandwidth, bounds each phase: 8 envs x 8 warps a block was
// the fastest of the 12 tilings tried on an H100, 10% ahead of K11's
// 4 x 4 (PERF.md).
//
// Semantics, exactly those of the reference step (integers and the 0/+-1
// rewards compare bit for bit):
//   * an action out of [0, 7), a full column or an already-done state is
//     invalid (decided from the raw action, before the clip): the board
//     stays, the episode ends, rewards are 0 and the winner is carried
//     over (connect_four.py:82-88, 105);
//   * otherwise the piece drops to row 5 - (cells filled in the column);
//   * a four-in-a-row of the mover wins (+1 mover, -1 other) even when the
//     move also fills the board; a full board without a win is a draw
//     (winner 2);
//   * on done the current player stays (connect_four.py:110), then the
//     reset replaces the state: empty board, current 0, winner -1;
//   * the outcome is read from the STEPPED state: [1,2] P0 won, [2,1] P1
//     won, [1,1] full board, [0,0] no result (an invalid move);
//   * obs of the post-reset state: channels-last planes [row, col,
//     player] (84 floats), then the one-hot of the player to move; mask
//     1.0 where the top cell of a column is empty;
//   * reset 0: a finished env keeps the stepped row (the board, the mover
//     as current, the winner, done, step_idx + 1);
//   * the sampling front: the block's first warp samples its 8 envs'
//     actions (2 lanes a row) into shared memory and the actions output,
//     then __syncthreads(), then the step above with those actions. The
//     step kernel without the front is unchanged.

#include <cuda_runtime.h>

#include <cstdint>

#include "packed_rows.cuh"
#include "temperature_sample.cuh"

namespace {

constexpr int ROWS = 6;
constexpr int COLS = 7;
constexpr int CELLS = ROWS * COLS;
constexpr int OBS_DIM = CELLS * 2 + 2;

// Column offsets of the packed row, in the order of envs/connect_four.py LAYOUT.
constexpr int O_CUR = CELLS;
constexpr int O_WINNER = O_CUR + 1;
constexpr int O_DONE = O_WINNER + 1;
constexpr int O_STEP = O_DONE + 1;
constexpr int O_PAD = O_STEP + 1;
constexpr int W = 48;
static_assert(O_PAD == 46, "LAYOUT of envs/connect_four.py");
constexpr int EB = 8;      // envs per block
constexpr int NT = 256;    // threads per block
using Rows = packed_rows::Rows<W, EB, NT>;
constexpr int WS = Rows::WS;  // shared-memory row stride, odd
static_assert(EB <= NT && EB % 2 == 0, "a block's obs span must be whole 16-byte runs");

struct Args {
  const int* ints;
  const float* acc_sum;
  const int* acc_len;
  const int* action;
  // i32 outputs
  int* ints_out;
  int* acc_len_out;
  int* log_len;
  int* outcome;
  int* active;
  // f32 outputs
  float* acc_sum_out;
  float* rewards;
  float* done;
  float* log_total;
  float* obs;
  float* mask;
  int num_envs;
  int reset;  // 0: a finished env keeps its terminal row
};

using packed_rows::block_len;

// Bit c * 7 + r holds cell (row r from the top, column c).
__device__ __forceinline__ bool has_four(uint64_t b) {
  uint64_t m = b & (b >> 1);  // vertical
  if (m & (m >> 2)) return true;
  m = b & (b >> 7);  // horizontal
  if (m & (m >> 14)) return true;
  m = b & (b >> 6);  // diagonal (c + 1, r - 1)
  if (m & (m >> 12)) return true;
  m = b & (b >> 8);  // diagonal (c + 1, r + 1)
  return (m & (m >> 16)) != 0;
}

// Bit 0 of every column: the top row, full when all seven are set.
constexpr uint64_t TOP_ROW = 0x40810204081ull;
static_assert(TOP_ROW == (1ull | 1ull << 7 | 1ull << 14 | 1ull << 21 | 1ull << 28 | 1ull << 35 |
                          1ull << 42), "bit c * 7 of every column c");

using temp_sample::Front;

// One block's envs; SAMPLE prepends the sampling front (f), else the
// actions are g.action.
template <bool SAMPLE>
__device__ __forceinline__ void step_block(const Args& g, const Front& f) {
  __shared__ int rows[EB * WS];
  const long e0 = static_cast<long>(blockIdx.x) * EB;
  const int count = static_cast<int>(min(static_cast<long>(EB), g.num_envs - e0));
  const int t = threadIdx.x;
  const long e = e0 + t;
  const bool stepper = t < count;
  int sampled = 0;
  if constexpr (SAMPLE) {
    __shared__ int acts[EB];
    temp_sample::sample_block<COLS, NT / 32>(f, e0, count, acts);
    __syncthreads();
    if (stepper) sampled = acts[t];
  }

  // 1. The stepping threads' per-env inputs, then the rows: every load
  // of a thread in flight before its first shared-memory store.
  int action = 0, len = 0;
  float2 sum_in = make_float2(0.0f, 0.0f);
  if (stepper) {
    action = SAMPLE ? sampled : g.action[e];
    len = g.acc_len[e] + 1;
    sum_in = make_float2(g.acc_sum[2 * e], g.acc_sum[2 * e + 1]);
  }
  Rows::stage(rows, g.ints + e0 * W, count, t);
  __syncthreads();

  // 2. The step and the reset, one thread per env.
  if (stepper) {
    int* r = rows + t * WS;
    const int cur = r[O_CUR];
    const int piece = cur + 1;
    uint64_t occ = 0, mine = 0;
#pragma unroll
    for (int rr = 0; rr < ROWS; ++rr) {
#pragma unroll
      for (int c = 0; c < COLS; ++c) {
        const int v = r[rr * COLS + c];
        const uint64_t bit = uint64_t{1} << (c * 7 + rr);
        occ |= v != 0 ? bit : 0;
        mine |= v == piece ? bit : 0;
      }
    }
    const bool out_of_range = action < 0 || action >= COLS;
    const int col = min(max(action, 0), COLS - 1);
    const int filled = __popcll((occ >> (col * 7)) & 0x3f);
    const bool invalid = filled >= ROWS || r[O_DONE] != 0 || out_of_range;
    if (!invalid) {
      const int row = ROWS - 1 - filled;
      r[row * COLS + col] = piece;
      const uint64_t bit = uint64_t{1} << (col * 7 + row);
      occ |= bit;
      mine |= bit;
    }
    const bool full = (occ & TOP_ROW) == TOP_ROW;
    const bool won = !invalid && has_four(mine);
    const bool done = won || full || invalid;
    const int winner = won ? cur : (full ? 2 : (invalid ? r[O_WINNER] : -1));

    const float r0 = won ? (cur == 0 ? 1.0f : -1.0f) : 0.0f;
    const float r1 = won ? (cur == 1 ? 1.0f : -1.0f) : 0.0f;
    const float2 total = make_float2(sum_in.x + r0, sum_in.y + r1);
    reinterpret_cast<float2*>(g.rewards)[e] = make_float2(r0, r1);
    reinterpret_cast<float2*>(g.log_total)[e] = total;
    reinterpret_cast<float2*>(g.acc_sum_out)[e] = done ? make_float2(0.0f, 0.0f) : total;
    g.done[e] = done ? 1.0f : 0.0f;
    g.log_len[e] = len;
    g.acc_len_out[e] = done ? 0 : len;
    g.active[e] = 2;
    // Placements of the stepped state (connect_four.py:134-156).
    int2 o = make_int2(0, 0);
    if (winner == 0) {
      o = make_int2(1, 2);
    } else if (winner == 1) {
      o = make_int2(2, 1);
    } else if (full) {
      o = make_int2(1, 1);
    }
    reinterpret_cast<int2*>(g.outcome)[e] = o;

    // The post-reset row: the fresh game where the episode ended (with
    // the reset flag on), else the stepped row. A row that goes on has
    // winner -1 (no win, no full board, a valid move).
    if (done && g.reset) {
#pragma unroll
      for (int i = 0; i < CELLS; ++i) r[i] = 0;
      r[O_CUR] = 0;
      r[O_STEP] = 0;
      r[O_WINNER] = -1;
      r[O_DONE] = 0;
    } else {
      r[O_CUR] = done ? cur : 1 - cur;
      r[O_STEP] += 1;
      r[O_WINNER] = winner;
      r[O_DONE] = done ? 1 : 0;
    }
#pragma unroll
    for (int i = O_PAD; i < W; ++i) r[i] = 0;
  }
  __syncthreads();

  // 3. The next state, obs and mask.
  Rows::store(g.ints_out + e0 * W, rows, count, t);
  // obs: the block's span of count x 86 floats, 4 at a time. Column j of
  // a row is cell j / 2 == player j % 2 + 1 below 84, then the one-hot
  // of the player to move. A last block of odd count ends on half a run.
  {
    constexpr int RUNS = EB * OBS_DIM / 4;
    constexpr int ITERS = (RUNS + NT - 1) / NT;
    float* obs = g.obs + e0 * OBS_DIM;
    const int n = count * OBS_DIM;
    auto value = [&](int j) {
      const int ee = j / OBS_DIM, c = j - ee * OBS_DIM;
      const int* r = rows + ee * WS;
      const int v = c < 2 * CELLS ? r[c >> 1] : r[O_CUR] + 1;
      return v == (c & 1) + 1 ? 1.0f : 0.0f;
    };
#pragma unroll
    for (int k = 0; k < ITERS; ++k) {
      const int j = 4 * (t + k * NT);
      if (j + 3 < n) {
        reinterpret_cast<float4*>(obs)[j / 4] =
            make_float4(value(j), value(j + 1), value(j + 2), value(j + 3));
      } else if (j < n) {
        for (int q = j; q < n; ++q) obs[q] = value(q);
      }
    }
  }
  {
    constexpr int ITERS = (EB * COLS + NT - 1) / NT;
    float* mask = g.mask + e0 * COLS;
#pragma unroll
    for (int k = 0; k < ITERS; ++k) {
      const int i = t + k * NT;
      if (i < count * COLS) {
        const int ee = i / COLS, c = i - ee * COLS;
        mask[i] = rows[ee * WS + c] == 0 ? 1.0f : 0.0f;
      }
    }
  }
}

__global__ void __launch_bounds__(NT) connect_four_step_autoreset_kernel(Args g) {
  step_block<false>(g, Front{});
}

__global__ void __launch_bounds__(NT) connect_four_sample_step_kernel(Args g, Front f) {
  step_block<true>(g, f);
}

}  // namespace

// in: the packed state [E, 48] i32, reward_sum [E, 2], length [E],
// action [E]; out: the i32 and the f32 buffer of envs/connect_four.py
// I32_OUT and F32_OUT. reset 0 keeps a finished env's terminal row.
// With the sampling front (logits not null; action null) the block samples
// its envs' actions from logits, mask (nullable) and uniforms [E, 7] at the
// temperatures [E] (nullable: ``temp`` for every row) into actions [E],
// then steps with them (eval's step).
extern "C" int connect_four_step_autoreset(const int* ints, const float* acc_sum,
                                           const int* acc_len, const int* action, int* out_i32,
                                           float* out_f32, int num_envs, int reset,
                                           const void* logits, const void* mask,
                                           const void* temps, float temp, const void* uniforms,
                                           int* actions, void* stream) {
  if (num_envs <= 0) return 0;
  const long E = num_envs;
  Args g;
  g.ints = ints;
  g.acc_sum = acc_sum;
  g.acc_len = acc_len;
  g.action = action;
  int* i = out_i32;
  g.ints_out = i;
  i += block_len(E, W);
  g.acc_len_out = i;
  i += block_len(E, 1);
  g.log_len = i;
  i += block_len(E, 1);
  g.outcome = i;
  i += block_len(E, 2);
  g.active = i;
  float* f = out_f32;
  g.acc_sum_out = f;
  f += block_len(E, 2);
  g.rewards = f;
  f += block_len(E, 2);
  g.done = f;
  f += block_len(E, 1);
  g.log_total = f;
  f += block_len(E, 2);
  g.obs = f;
  f += block_len(E, OBS_DIM);
  g.mask = f;
  g.num_envs = num_envs;
  g.reset = reset;
  const int blocks = static_cast<int>((E + EB - 1) / EB);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (logits != nullptr) {
    connect_four_sample_step_kernel<<<blocks, NT, 0, s>>>(
        g, temp_sample::front_of(logits, mask, temps, temp, uniforms, actions));
  } else {
    connect_four_step_autoreset_kernel<<<blocks, NT, 0, s>>>(g);
  }
  return static_cast<int>(cudaGetLastError());
}

// K4 connect_four_step_autoreset — Connect Four move, win check, rewards,
// outcome, episode log, auto-reset, obs and action mask, one launch per
// env step.
//
// Replaces the XLA fusion of burn_ppo_tpu/envs/connect_four.py
// ConnectFour.step/_has_win/obs/action_mask/game_outcome/reset (35-156)
// under burn_ppo_tpu/envs/base.py autoreset_step (234-274), vmapped over
// envs (ROADMAP queue B, item B10). Plain PyTorch twin:
// burn_ppo_torch/envs/base.py autoreset_step over
// burn_ppo_torch/envs/connect_four.py ConnectFour, used for CPU tensors.
//
// What bounds it on an H100: launch latency, then bytes. Per env it reads
// the 42-cell i32 board and ~30 B of state and writes the next board, the
// 86-wide obs, the 7-wide mask and ~60 B of rewards, log and state:
// ~0.9 KB per env, ~3.7 MB per launch at E = 4096 (about a microsecond of
// HBM time). Eager PyTorch runs the same step as ~90 small kernels. The
// design: one launch, one thread per env, the board in registers/local
// memory, and the 69-window win check as four shift-and-AND tests on a
// 49-bit bitboard (7 bits per column, the 7th a zero guard, so no window
// wraps from one column into the next).
//
// Semantics, exactly those of the reference step (integers and the 0/+-1
// rewards compare bit for bit):
//   * an action out of [0, 7), a full column or an already-done state is
//     invalid: the board stays, the episode ends, rewards are 0 and the
//     winner is carried over (connect_four.py:82-88, 105);
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
//     1.0 where the top cell of a column is empty.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int ROWS = 6;
constexpr int COLS = 7;
constexpr int CELLS = ROWS * COLS;
constexpr int OBS_DIM = CELLS * 2 + 2;

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

__global__ void connect_four_step_autoreset_kernel(
    const int* __restrict__ board_in, const int* __restrict__ current_in,
    const int* __restrict__ winner_in, const bool* __restrict__ done_in,
    const int* __restrict__ step_in, const float* __restrict__ reward_sum_in,
    const int* __restrict__ length_in, const int* __restrict__ action,
    int* __restrict__ board_out, int* __restrict__ current_out,
    int* __restrict__ winner_out, bool* __restrict__ done_out,
    int* __restrict__ step_out, float* __restrict__ reward_sum_out,
    int* __restrict__ length_out, float* __restrict__ rewards_out,
    float* __restrict__ done_f_out, float* __restrict__ ep_return_out,
    int* __restrict__ ep_length_out, int* __restrict__ outcome_out,
    int* __restrict__ active_out, float* __restrict__ obs_out,
    float* __restrict__ mask_out, int num_envs) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= num_envs) return;

  int board[CELLS];
  const int* bin = board_in + static_cast<long>(e) * CELLS;
  for (int i = 0; i < CELLS; ++i) board[i] = bin[i];

  const int cur = current_in[e];
  const int a = action[e];
  const bool out_of_range = a < 0 || a >= COLS;
  const int col = min(max(a, 0), COLS - 1);
  int filled = 0;
  for (int r = 0; r < ROWS; ++r) filled += board[r * COLS + col] != 0;
  const bool invalid = filled >= ROWS || done_in[e] || out_of_range;
  const int piece = cur + 1;
  if (!invalid) board[(ROWS - 1 - filled) * COLS + col] = piece;

  uint64_t mine = 0;
  bool full = true;
  for (int r = 0; r < ROWS; ++r) {
    for (int c = 0; c < COLS; ++c) {
      if (board[r * COLS + c] == piece) mine |= uint64_t{1} << (c * 7 + r);
    }
  }
  for (int c = 0; c < COLS; ++c) full = full && board[c] != 0;
  const bool won = !invalid && has_four(mine);
  const bool done = won || full || invalid;
  const int winner = won ? cur : (full ? 2 : (invalid ? winner_in[e] : -1));

  const float r0 = won ? (cur == 0 ? 1.0f : -1.0f) : 0.0f;
  const float r1 = won ? (cur == 1 ? 1.0f : -1.0f) : 0.0f;
  const float s0 = reward_sum_in[2 * e] + r0;
  const float s1 = reward_sum_in[2 * e + 1] + r1;
  const int len = length_in[e] + 1;
  rewards_out[2 * e] = r0;
  rewards_out[2 * e + 1] = r1;
  done_f_out[e] = done ? 1.0f : 0.0f;
  ep_return_out[2 * e] = s0;
  ep_return_out[2 * e + 1] = s1;
  ep_length_out[e] = len;
  int o0 = 0, o1 = 0;
  if (winner == 0) {
    o0 = 1;
    o1 = 2;
  } else if (winner == 1) {
    o0 = 2;
    o1 = 1;
  } else if (full) {
    o0 = 1;
    o1 = 1;
  }
  outcome_out[2 * e] = o0;
  outcome_out[2 * e + 1] = o1;
  active_out[e] = 2;

  // The post-reset state: the fresh one where the episode ended.
  const int next_cur = done ? 0 : 1 - cur;
  current_out[e] = next_cur;
  winner_out[e] = done ? -1 : winner;
  done_out[e] = false;  // a fresh state, or a stepped one that did not end
  step_out[e] = done ? 0 : step_in[e] + 1;
  reward_sum_out[2 * e] = done ? 0.0f : s0;
  reward_sum_out[2 * e + 1] = done ? 0.0f : s1;
  length_out[e] = done ? 0 : len;

  int* bout = board_out + static_cast<long>(e) * CELLS;
  float* o = obs_out + static_cast<long>(e) * OBS_DIM;
  for (int i = 0; i < CELLS; ++i) {
    const int v = done ? 0 : board[i];
    bout[i] = v;
    o[2 * i] = v == 1 ? 1.0f : 0.0f;
    o[2 * i + 1] = v == 2 ? 1.0f : 0.0f;
  }
  o[2 * CELLS] = next_cur == 0 ? 1.0f : 0.0f;
  o[2 * CELLS + 1] = next_cur == 1 ? 1.0f : 0.0f;
  float* m = mask_out + static_cast<long>(e) * COLS;
  for (int c = 0; c < COLS; ++c) m[c] = (done || board[c] == 0) ? 1.0f : 0.0f;
}

}  // namespace

extern "C" int connect_four_step_autoreset(
    const void* board, const void* current, const void* winner,
    const void* done, const void* step_idx, const void* reward_sum,
    const void* length, const void* action, void* board_out, void* current_out,
    void* winner_out, void* done_out, void* step_out, void* reward_sum_out,
    void* length_out, void* rewards_out, void* done_f_out, void* ep_return_out,
    void* ep_length_out, void* outcome_out, void* active_out, void* obs_out,
    void* mask_out, int num_envs, void* stream) {
  if (num_envs <= 0) return 0;
  const int threads = 128;
  const int blocks = (num_envs + threads - 1) / threads;
  connect_four_step_autoreset_kernel<<<blocks, threads, 0,
                                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(board), static_cast<const int*>(current),
      static_cast<const int*>(winner), static_cast<const bool*>(done),
      static_cast<const int*>(step_idx), static_cast<const float*>(reward_sum),
      static_cast<const int*>(length), static_cast<const int*>(action),
      static_cast<int*>(board_out), static_cast<int*>(current_out),
      static_cast<int*>(winner_out), static_cast<bool*>(done_out),
      static_cast<int*>(step_out), static_cast<float*>(reward_sum_out),
      static_cast<int*>(length_out), static_cast<float*>(rewards_out),
      static_cast<float*>(done_f_out), static_cast<float*>(ep_return_out),
      static_cast<int*>(ep_length_out), static_cast<int*>(outcome_out),
      static_cast<int*>(active_out), static_cast<float*>(obs_out),
      static_cast<float*>(mask_out), num_envs);
  return static_cast<int>(cudaGetLastError());
}

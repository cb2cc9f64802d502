"""Connect Four as batched tensors, with the fused step kernel K4.

Counterpart of burn_ppo_tpu/envs/connect_four.py: a 6x7 board (row 0 at
the top), two players taking turns in one env, +1/-1 for a win, 0 for a
draw, an 86-wide obs of channels-last planes [row, col, player] and the
one-hot of the player to move, a column mask, and placements [1,2] /
[2,1] / [1,1], or the no-outcome sentinel [0,0] after an invalid move.

The integer state is ONE packed ``[E, 48]`` i32 tensor (``LAYOUT``, the
done flag as 0 / 1, two zero pad columns) with the fields as views, so the
kernel takes one state pointer in and writes one i32 and one f32 buffer
out.

``step_autoreset`` is the rollout's env step. For CPU tensors it runs the
plain PyTorch composition (``envs/base.py autoreset_step`` over ``step``,
``reset``, ``obs``, ``action_mask`` and ``game_outcome`` below); for CUDA
tensors it launches the hand-written kernel ``csrc/connect_four_step.cu``
(ROADMAP B10), or raises. The reset draws no randoms.
"""

from __future__ import annotations

import torch

from burn_ppo_torch import kernels
from burn_ppo_torch.envs.base import (
    EnvSpec,
    Environment,
    EpisodeAccumulator,
    EpisodeLog,
    PackedState,
    StepOutput,
    arena_size,
    autoreset_step,
    carve_arena,
    env_row,
)

ROWS, COLS = 6, 7
OBS_DIM = ROWS * COLS * 2 + 2

# The packed integer state: (field, per-env shape), in the order of the
# JAX ``ConnectFourState`` (its rewards, which the step returns, and its
# key, which nothing reads, left out), then two zero pad columns.
LAYOUT = (
    ("board", (ROWS, COLS)),  # 0 empty, 1 P0, 2 P1
    ("current", ()),  # player to move
    ("winner", ()),  # -1 none, 0/1 winner, 2 draw
    ("done", ()),  # bool
    ("step_idx", ()),
)


class ConnectFourState(PackedState):
    """E envs: ``ints`` [E, 48] i32 with the fields of ``LAYOUT`` as views,
    ``state.board`` [E, 6, 7], ``state.done`` as bool (envs/base.py
    PackedState)."""

    LAYOUT = LAYOUT
    BOOL_FIELDS = frozenset(("done",))
    W = 48  # 46 columns, then 2 zero pad columns: every row starts 16-byte aligned


W = ConnectFourState.W


def has_win(plane: torch.Tensor) -> torch.Tensor:
    """[E] True where a bool [E, 6, 7] plane holds four in a row (the 69
    windows of connect_four.py:35-41)."""
    p = plane
    h = p[:, :, 0:4] & p[:, :, 1:5] & p[:, :, 2:6] & p[:, :, 3:7]
    v = p[:, 0:3, :] & p[:, 1:4, :] & p[:, 2:5, :] & p[:, 3:6, :]
    d1 = p[:, 0:3, 0:4] & p[:, 1:4, 1:5] & p[:, 2:5, 2:6] & p[:, 3:6, 3:7]
    d2 = p[:, 0:3, 3:7] & p[:, 1:4, 2:6] & p[:, 2:5, 1:5] & p[:, 3:6, 0:4]
    return torch.stack([x.flatten(1).any(1) for x in (h, v, d1, d2)]).any(0)


class ConnectFour(Environment):
    spec = EnvSpec(
        name="connect_four",
        obs_dim=OBS_DIM,
        num_actions=COLS,
        num_players=2,
        obs_shape=(ROWS, COLS, 2),
        eval_temp=0.4,
        eval_temp_cutoff=(10, 0.0),
    )

    def draw_reset(self, rng, num_envs: int) -> torch.Tensor:
        """Nothing to draw: [E, 0]."""
        return torch.empty(num_envs, 0, device=rng.device)

    def reset(self, reset_values: torch.Tensor) -> ConnectFourState:
        E, dev = reset_values.shape[0], reset_values.device
        ints = torch.zeros(E, W, dtype=torch.int32, device=dev)
        ints[:, ConnectFourState.SLICES["winner"][0]] = -1
        return ConnectFourState(ints)

    def step(self, state: ConnectFourState, action: torch.Tensor):
        board, cur = state.board, state.current
        out_of_range = (action < 0) | (action >= COLS)
        col = torch.clamp(action, 0, COLS - 1).long()
        filled = (board.gather(2, col[:, None, None].expand(-1, ROWS, 1))[:, :, 0] != 0).sum(1)
        invalid = (filled >= ROWS) | state.done | out_of_range
        piece = (cur + 1)[:, None, None]
        dev = board.device
        cell = (torch.arange(ROWS, device=dev)[None, :, None] == (ROWS - 1 - filled)[:, None, None]) & (
            torch.arange(COLS, device=dev)[None, None, :] == col[:, None, None]
        )
        board = torch.where(cell & ~invalid[:, None, None], piece, board)

        won = has_win(board == piece) & ~invalid
        full = (board[:, 0, :] != 0).all(1)
        done = won | full | invalid
        mover = torch.arange(2, device=dev)[None, :] == cur[:, None]
        rewards = torch.where(won[:, None], torch.where(mover, 1.0, -1.0), 0.0)
        winner = torch.where(won, cur, torch.where(full, 2, torch.where(invalid, state.winner, -1)))
        stepped = ConnectFourState.of(
            board=board,
            current=torch.where(done, cur, 1 - cur),
            winner=winner,
            done=done,
            step_idx=state.step_idx + 1,
        )
        return stepped, rewards.to(torch.float32), done

    def obs(self, state: ConnectFourState) -> torch.Tensor:
        E = state.ints.shape[0]
        planes = torch.stack([state.board == 1, state.board == 2], dim=-1)  # [E, 6, 7, 2]
        turn = state.current[:, None] == torch.arange(2, device=state.ints.device)[None, :]
        return torch.cat([planes.reshape(E, -1), turn], dim=1).to(torch.float32)

    def action_mask(self, state: ConnectFourState) -> torch.Tensor:
        return (state.board[:, 0, :] == 0).to(torch.float32)

    def current_player(self, state: ConnectFourState) -> torch.Tensor:
        return state.current.contiguous()

    def game_outcome(self, state: ConnectFourState) -> torch.Tensor:
        """[1,2] P0 won / [2,1] P1 won / [1,1] full board / [0,0] no result
        (connect_four.py:134-156)."""
        dev = state.ints.device
        full = (state.board[:, 0, :] != 0).all(1)
        placements = torch.tensor([[1, 2], [2, 1], [1, 1], [0, 0]], dtype=torch.int32, device=dev)
        which = torch.where(state.winner == 0, 0,
                            torch.where(state.winner == 1, 1, torch.where(full, 2, 3)))
        return placements[which]

    def step_autoreset(self, state, acc, action, reset_values, step_values=None) -> StepOutput:
        return connect_four_step_autoreset(self, state, acc, action, reset_values)

    # -- human-facing helpers (connect_four.py:158-185) -----------------------
    def render(self, state: ConnectFourState, index: int = 0) -> str:
        s = env_row(state, index)
        board = s.board[0].tolist()
        sym = {0: ".", 1: "X", 2: "O"}
        lines = ["  1 2 3 4 5 6 7", " ---------------"]
        for r in range(ROWS):
            lines.append("| " + " ".join(sym[c] for c in board[r]) + " |")
        lines.append(" ---------------")
        if bool(s.done[0]):
            msg = {0: "X (Player 0) wins!", 1: "O (Player 1) wins!"}.get(int(s.winner[0]), "Draw!")
            lines.append(msg)
        else:
            lines.append(f"Turn: {'X (Player 0)' if int(s.current[0]) == 0 else 'O (Player 1)'}")
        return "\n".join(lines)

    def describe_action(self, action: int) -> str:
        return f"Column {action + 1}"

    def parse_action(self, text: str) -> int:
        col = int(text.strip())
        if 1 <= col <= 7:
            return col - 1
        raise ValueError("Enter column 1-7")


def connect_four_step_autoreset(
    env: ConnectFour,
    state: ConnectFourState,
    acc: EpisodeAccumulator,
    action: torch.Tensor,
    reset_values: torch.Tensor,
) -> StepOutput:
    """One auto-reset step of every env: plain PyTorch on the CPU, kernel
    K4 on a CUDA device."""
    if kernels.on_cpu(state.ints, action, reset_values):
        return autoreset_step(env, state, acc, action, reset_values)
    return _launch(state, acc, action)


kernels.counted(connect_four_step_autoreset)

# The kernel's outputs, carved from one i32 and one f32 buffer (envs/base.py
# carve_arena); csrc/connect_four_step.cu computes the same offsets.
I32_OUT = (("ints", W), ("acc_length", 1), ("log_length", 1), ("outcome", 2),
           ("active_players", 1))
F32_OUT = (("acc_reward_sum", 2), ("rewards", 2), ("done", 1), ("log_total_rewards", 2),
           ("obs", OBS_DIM), ("mask", COLS))


def _launch(state: ConnectFourState, acc: EpisodeAccumulator, action: torch.Tensor) -> StepOutput:
    E, dev = state.ints.shape[0], state.ints.device
    kernels.expect(state.ints, "state.ints", torch.int32, (E, W))
    kernels.expect_rows16(state.ints, "state.ints")
    kernels.expect(acc.reward_sum, "reward_sum", torch.float32, (E, 2))
    kernels.expect(acc.length, "length", torch.int32, (E,))
    kernels.expect(action, "action", torch.int32, (E,))
    i32 = torch.empty(arena_size(E, I32_OUT), dtype=torch.int32, device=dev)
    f32 = torch.empty(arena_size(E, F32_OUT), dtype=torch.float32, device=dev)
    err = kernels.library().connect_four_step_autoreset(
        state.ints.data_ptr(), acc.reward_sum.data_ptr(), acc.length.data_ptr(),
        action.data_ptr(), i32.data_ptr(), f32.data_ptr(), E, kernels.stream(dev))
    kernels.check(err, "connect_four_step_autoreset")
    connect_four_step_autoreset.launches += 1
    oi, of = carve_arena(i32, E, I32_OUT), carve_arena(f32, E, F32_OUT)
    done = of["done"]
    log = EpisodeLog(completed=done, total_rewards=of["log_total_rewards"],
                     length=oi["log_length"], outcome=oi["outcome"],
                     active_players=oi["active_players"])
    return StepOutput(ConnectFourState(oi["ints"]),
                      EpisodeAccumulator(of["acc_reward_sum"], oi["acc_length"]),
                      of["rewards"], done, log, of["obs"], of["mask"])

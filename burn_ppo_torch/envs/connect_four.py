"""Connect Four as batched tensors, with the fused step kernel K4.

Counterpart of burn_ppo_tpu/envs/connect_four.py: a 6x7 board (row 0 at
the top), two players taking turns in one env, +1/-1 for a win, 0 for a
draw, an 86-wide obs of channels-last planes [row, col, player] and the
one-hot of the player to move, a column mask, and placements [1,2] /
[2,1] / [1,1], or the no-outcome sentinel [0,0] after an invalid move.

``step_autoreset`` is the rollout's env step. For CPU tensors it runs the
plain PyTorch composition (``envs/base.py autoreset_step`` over ``step``,
``reset``, ``obs``, ``action_mask`` and ``game_outcome`` below); for CUDA
tensors it launches the hand-written kernel ``csrc/connect_four_step.cu``
(ROADMAP B10), or raises. The reset draws no randoms.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from burn_ppo_torch import kernels
from burn_ppo_torch.envs.base import (
    EnvSpec,
    Environment,
    EpisodeAccumulator,
    EpisodeLog,
    StepOutput,
    autoreset_step,
)

ROWS, COLS = 6, 7
OBS_DIM = ROWS * COLS * 2 + 2


@dataclass
class ConnectFourState:
    """Struct of arrays over E envs."""

    board: torch.Tensor  # [E, 6, 7] i32: 0 empty, 1 P0, 2 P1
    current: torch.Tensor  # [E] i32 player to move
    winner: torch.Tensor  # [E] i32: -1 none, 0/1 winner, 2 draw
    done: torch.Tensor  # [E] bool
    step_idx: torch.Tensor  # [E] i32


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
        E, dev, i32 = reset_values.shape[0], reset_values.device, torch.int32
        return ConnectFourState(
            board=torch.zeros(E, ROWS, COLS, dtype=i32, device=dev),
            current=torch.zeros(E, dtype=i32, device=dev),
            winner=torch.full((E,), -1, dtype=i32, device=dev),
            done=torch.zeros(E, dtype=torch.bool, device=dev),
            step_idx=torch.zeros(E, dtype=i32, device=dev),
        )

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
        stepped = ConnectFourState(
            board=board,
            current=torch.where(done, cur, 1 - cur),
            winner=winner.to(torch.int32),
            done=done,
            step_idx=state.step_idx + 1,
        )
        return stepped, rewards.to(torch.float32), done

    def obs(self, state: ConnectFourState) -> torch.Tensor:
        E = state.board.shape[0]
        planes = torch.stack([state.board == 1, state.board == 2], dim=-1)  # [E, 6, 7, 2]
        turn = state.current[:, None] == torch.arange(2, device=state.board.device)[None, :]
        return torch.cat([planes.reshape(E, -1), turn], dim=1).to(torch.float32)

    def action_mask(self, state: ConnectFourState) -> torch.Tensor:
        return (state.board[:, 0, :] == 0).to(torch.float32)

    def current_player(self, state: ConnectFourState) -> torch.Tensor:
        return state.current

    def game_outcome(self, state: ConnectFourState) -> torch.Tensor:
        """[1,2] P0 won / [2,1] P1 won / [1,1] full board / [0,0] no result
        (connect_four.py:134-156)."""
        dev = state.board.device
        full = (state.board[:, 0, :] != 0).all(1)
        placements = torch.tensor([[1, 2], [2, 1], [1, 1], [0, 0]], dtype=torch.int32, device=dev)
        which = torch.where(state.winner == 0, 0,
                            torch.where(state.winner == 1, 1, torch.where(full, 2, 3)))
        return placements[which]

    def step_autoreset(self, state, acc, action, reset_values) -> StepOutput:
        return connect_four_step_autoreset(self, state, acc, action, reset_values)


def connect_four_step_autoreset(
    env: ConnectFour,
    state: ConnectFourState,
    acc: EpisodeAccumulator,
    action: torch.Tensor,
    reset_values: torch.Tensor,
) -> StepOutput:
    """One auto-reset step of every env: plain PyTorch on the CPU, kernel
    K4 on a CUDA device."""
    if kernels.on_cpu(state.board, action, reset_values):
        return autoreset_step(env, state, acc, action, reset_values)
    return _launch(state, acc, action)


connect_four_step_autoreset.launches = 0


def _launch(state: ConnectFourState, acc: EpisodeAccumulator, action: torch.Tensor) -> StepOutput:
    E = state.board.shape[0]
    f32, i32 = torch.float32, torch.int32
    for name, t, dt, shape in (
        ("board", state.board, i32, (E, ROWS, COLS)),
        ("current", state.current, i32, (E,)),
        ("winner", state.winner, i32, (E,)),
        ("done", state.done, torch.bool, (E,)),
        ("step_idx", state.step_idx, i32, (E,)),
        ("reward_sum", acc.reward_sum, f32, (E, 2)),
        ("length", acc.length, i32, (E,)),
        ("action", action, i32, (E,)),
    ):
        kernels.expect(t, name, dt, shape)
    dev = state.board.device

    def new(*shape, dtype=f32):
        return torch.empty(*shape, dtype=dtype, device=dev)

    nxt = ConnectFourState(board=new(E, ROWS, COLS, dtype=i32), current=new(E, dtype=i32),
                           winner=new(E, dtype=i32), done=new(E, dtype=torch.bool),
                           step_idx=new(E, dtype=i32))
    nacc = EpisodeAccumulator(reward_sum=new(E, 2), length=new(E, dtype=i32))
    rewards, done = new(E, 2), new(E)
    log = EpisodeLog(completed=done, total_rewards=new(E, 2), length=new(E, dtype=i32),
                     outcome=new(E, 2, dtype=i32), active_players=new(E, dtype=i32))
    obs, mask = new(E, OBS_DIM), new(E, COLS)
    p = kernels.ptr
    err = kernels.library().connect_four_step_autoreset(
        p(state.board), p(state.current), p(state.winner), p(state.done), p(state.step_idx),
        p(acc.reward_sum), p(acc.length), p(action),
        p(nxt.board), p(nxt.current), p(nxt.winner), p(nxt.done), p(nxt.step_idx),
        p(nacc.reward_sum), p(nacc.length), p(rewards), p(done), p(log.total_rewards),
        p(log.length), p(log.outcome), p(log.active_players), p(obs), p(mask),
        E, kernels.stream(dev),
    )
    kernels.check(err, "connect_four_step_autoreset")
    connect_four_step_autoreset.launches += 1
    return StepOutput(nxt, nacc, rewards, done, log, obs, mask)

"""Connect Four of the port (plain path of kernel K4) against
``jax.vmap(autoreset_step)`` over the JAX package's ``ConnectFour`` and
against the plain-Python rules oracle. Every output compares exactly. The
state is packed (``envs/base.py PackedState``): one [E, 48] i32 buffer
with the fields as views."""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from burn_ppo_tpu.envs.base import EpisodeAccumulator as JaxAcc  # noqa: E402
from burn_ppo_tpu.envs.base import autoreset_step as jax_autoreset_step  # noqa: E402
from burn_ppo_tpu.envs.connect_four import ConnectFour as JaxConnectFour  # noqa: E402
from burn_ppo_tpu.envs.connect_four import ConnectFourState as JaxState  # noqa: E402
from burn_ppo_tpu.envs.connect_four import _has_win as _jax_has_win  # noqa: E402
from burn_ppo_torch import kernels  # noqa: E402
from burn_ppo_torch.envs.base import EpisodeAccumulator  # noqa: E402
from burn_ppo_torch.envs.connect_four import ConnectFour, ConnectFourState, has_win  # noqa: E402
from burn_ppo_torch.envs.liars_dice import LiarsDiceState  # noqa: E402
from burn_ppo_torch.envs.skull import SkullState  # noqa: E402
from burn_ppo_torch.ppo.rollout import RandomSource  # noqa: E402
from tests.oracles.connect_four_oracle import ConnectFourOracle  # noqa: E402

JENV = JaxConnectFour()
ENV = ConnectFour()
CPU = torch.device("cpu")


@jax.jit
def _jax_step(state, acc, action, keys):
    out = jax.vmap(lambda s, a, act, k: jax_autoreset_step(JENV, s, a, act, k))(
        state, acc, action, keys
    )
    nxt = out[0]
    return out, jax.vmap(JENV.obs)(nxt), jax.vmap(JENV.action_mask)(nxt)


def _jax_state(board, current, winner, done, step_idx):
    E = board.shape[0]
    return JaxState(
        board=jnp.asarray(board, jnp.int32), current=jnp.asarray(current, jnp.int32),
        winner=jnp.asarray(winner, jnp.int32), rewards=jnp.zeros((E, 2), jnp.float32),
        done=jnp.asarray(done, bool), step_idx=jnp.asarray(step_idx, jnp.int32),
        key=jax.random.split(jax.random.PRNGKey(0), E),
    )


def _torch_state(js) -> ConnectFourState:
    return ConnectFourState.of(**{f: torch.from_numpy(np.array(getattr(js, f)))
                                  for f in ("board", "current", "winner", "done", "step_idx")})


def _compare(j, t_out):
    (j_next, j_acc, j_term, j_log), j_obs, j_mask = j
    eq = np.testing.assert_array_equal
    for f in ("board", "current", "winner", "done", "step_idx"):
        eq(getattr(t_out.state, f).numpy(), np.asarray(getattr(j_next, f)), err_msg=f)
    eq(t_out.rewards.numpy(), np.asarray(j_term.rewards))
    eq(t_out.done.numpy(), np.asarray(j_term.done, np.float32))
    eq(t_out.log.completed.numpy(), np.asarray(j_log.completed, np.float32))
    eq(t_out.log.total_rewards.numpy(), np.asarray(j_log.total_rewards))
    eq(t_out.log.length.numpy(), np.asarray(j_log.length))
    eq(t_out.log.outcome.numpy(), np.asarray(j_log.outcome))
    eq(t_out.log.active_players.numpy(), np.asarray(j_log.active_players))
    eq(t_out.acc.reward_sum.numpy(), np.asarray(j_acc.reward_sum))
    eq(t_out.acc.length.numpy(), np.asarray(j_acc.length))
    eq(t_out.obs.numpy(), np.asarray(j_obs))
    eq(t_out.mask.numpy(), np.asarray(j_mask, np.float32))


def _pick_actions(rng, mask):
    """Mostly legal columns; some full columns and out-of-range actions."""
    E = mask.shape[0]
    actions = np.empty(E, np.int32)
    for e in range(E):
        legal = np.flatnonzero(mask[e])
        full = np.flatnonzero(mask[e] == 0)
        u = rng.random()
        if u < 0.04:
            actions[e] = rng.choice([-1, 7, 9])
        elif u < 0.08 and full.size:
            actions[e] = rng.choice(full)
        else:
            actions[e] = rng.choice(legal)
    return actions


def test_random_playouts_match_jax_exactly():
    rng = np.random.default_rng(0)
    E, T = 16, 160
    key = jax.random.PRNGKey(1)
    key, sub = jax.random.split(key)
    js = jax.vmap(JENV.reset)(jax.random.split(sub, E))
    j_acc = JaxAcc(reward_sum=jnp.zeros((E, 2)), length=jnp.zeros(E, jnp.int32))
    ts = ENV.reset(torch.empty(E, 0))
    t_acc = EpisodeAccumulator.zero(E, 2, CPU)
    mask = ENV.action_mask(ts).numpy()
    seen = {"win": 0, "draw": 0, "sentinel": 0}
    for _ in range(T):
        actions = _pick_actions(rng, mask)
        key, sub = jax.random.split(key)
        j = _jax_step(js, j_acc, jnp.asarray(actions), jax.random.split(sub, E))
        t_out = ENV.step_autoreset(ts, t_acc, torch.from_numpy(actions), torch.empty(E, 0))
        _compare(j, t_out)
        done = t_out.done.numpy() > 0
        out = t_out.log.outcome.numpy()
        seen["win"] += int((done & (out.max(1) == 2)).sum())
        seen["draw"] += int((done & (out.min(1) == 1) & (out.max(1) == 1)).sum())
        seen["sentinel"] += int((done & (out.max(1) == 0)).sum())
        js, j_acc = j[0][0], j[0][1]
        ts, t_acc, mask = t_out.state, t_out.acc, t_out.mask.numpy()
    assert seen["win"] > 0 and seen["sentinel"] > 0


def _replay_moves(moves):
    """A board from a move list, with the oracle; returns (board, current)."""
    o = ConnectFourOracle()
    for m in moves:
        _, done = o.step(m)
        assert not done
    return np.array(o.board, np.int32), o.current


def _edge_states():
    """(board, current, winner, done, action) rows for the branches a
    random playout rarely reaches."""
    rows = []
    # A move that wins AND fills the board: the mover wins, not a draw.
    board = np.array([[1, 2, 1, 2, 1, 2, 0],
                      [1, 2, 1, 2, 1, 2, 1],
                      [2, 1, 2, 1, 2, 1, 1],
                      [2, 1, 2, 1, 2, 1, 1],
                      [1, 2, 1, 2, 1, 2, 2],
                      [1, 2, 1, 2, 1, 2, 2]], np.int32)
    rows.append((board, 0, -1, False, 6))
    # The same board filled by a non-winning move: a draw.
    draw = board.copy()
    draw[1:4, 6] = [2, 1, 2]
    rows.append((draw, 0, -1, False, 6))
    # Horizontal, vertical and both diagonal wins, bottom-left to top-right.
    for moves, action in (([0, 0, 1, 1, 2, 2], 3), ([0, 1, 0, 1, 0, 1], 0),
                          ([0, 1, 1, 2, 2, 3, 2, 3, 3, 6], 3),
                          ([6, 5, 5, 4, 4, 3, 4, 3, 3, 0], 3)):
        b, cur = _replay_moves(moves)
        rows.append((b, cur, -1, False, action))
    # Already done (winner carried), a full column and out-of-range actions.
    b, cur = _replay_moves([0, 1, 0, 1, 0, 1])
    rows.append((b, cur, 1, True, 2))
    full_col, cur = _replay_moves([3, 3, 3, 3, 3, 3])
    rows += [(full_col, cur, -1, False, 3), (full_col, cur, -1, False, -1),
             (full_col, cur, -1, False, 7)]
    return rows


def test_edge_branches_match_jax_and_oracle():
    rows = _edge_states()
    E = len(rows)
    board = np.stack([r[0] for r in rows])
    current, winner, done, actions = (np.array([r[i] for r in rows]) for i in (1, 2, 3, 4))
    step_idx = np.arange(E, dtype=np.int32)
    js = _jax_state(board, current, winner, done, step_idx)
    acc = np.random.default_rng(3).integers(-2, 3, (E, 2)).astype(np.float32)
    j_acc = JaxAcc(reward_sum=jnp.asarray(acc), length=jnp.asarray(step_idx))
    j = _jax_step(js, j_acc, jnp.asarray(actions, jnp.int32), jax.random.split(jax.random.PRNGKey(2), E))
    t_out = ENV.step_autoreset(_torch_state(js), EpisodeAccumulator(torch.from_numpy(acc), torch.from_numpy(step_idx)),
                               torch.from_numpy(actions.astype(np.int32)), torch.empty(E, 0))
    _compare(j, t_out)
    # The winning move that fills the board pays the mover; its twin draws.
    np.testing.assert_array_equal(t_out.log.outcome.numpy()[:2], [[1, 2], [1, 1]])
    np.testing.assert_array_equal(t_out.rewards.numpy()[:2], [[1, -1], [0, 0]])
    assert (t_out.rewards.numpy()[2:6] != 0).all()  # four winning directions
    np.testing.assert_array_equal(t_out.log.outcome.numpy()[6], [2, 1])  # done: winner carried
    np.testing.assert_array_equal(t_out.log.outcome.numpy()[7:], np.zeros((3, 2)))  # invalid: [0, 0]
    assert (t_out.done.numpy() == 1.0).all()


def test_oracle_agrees_on_live_games():
    """The rules engine written from the reference, not from the JAX env."""
    rng = np.random.default_rng(5)
    E = 8
    oracles = [ConnectFourOracle() for _ in range(E)]
    ts = ENV.reset(torch.empty(E, 0))
    acc = EpisodeAccumulator.zero(E, 2, CPU)
    games = 0
    for _ in range(200):
        mask = ENV.action_mask(ts).numpy()
        for e, o in enumerate(oracles):
            np.testing.assert_array_equal(mask[e], np.array(o.action_mask(), np.float32))
            np.testing.assert_array_equal(ENV.obs(ts)[e].numpy(), o.observation_channels_last())
        actions = _pick_actions(rng, mask)
        actions = np.where(actions < 0, 7, actions).astype(np.int32)  # the oracle reads -1 as column 6
        out = ENV.step_autoreset(ts, acc, torch.from_numpy(actions), torch.empty(E, 0))
        for e, o in enumerate(oracles):
            rewards, done = o.step(int(actions[e]))
            assert bool(out.done[e]) == done
            np.testing.assert_array_equal(out.rewards[e].numpy(), rewards)
            if done:
                games += 1
                if o.winner is not None:
                    np.testing.assert_array_equal(out.log.outcome[e].numpy(), o.placements())
                else:
                    np.testing.assert_array_equal(out.log.outcome[e].numpy(), [0, 0])
                o.reset()
        ts, acc = out.state, out.acc
    assert games > 10


def test_has_win_finds_exactly_the_69_windows():
    windows = []
    for r in range(6):
        for c in range(7):
            for dr, dc in ((0, 1), (1, 0), (1, 1), (1, -1)):
                cells = [(r + i * dr, c + i * dc) for i in range(4)]
                if all(0 <= a < 6 and 0 <= b < 7 for a, b in cells):
                    windows.append(cells)
    assert len(windows) == 69
    planes = torch.zeros(len(windows), 6, 7, dtype=torch.bool)
    for i, w in enumerate(windows):
        for a, b in w:
            planes[i, a, b] = True
    assert has_win(planes).all()
    # Random planes, most without a four, against the JAX windows.
    rand = np.random.default_rng(6).random((300, 6, 7)) < 0.35
    expect = np.asarray(jax.vmap(_jax_has_win)(jnp.asarray(rand)))
    assert 0 < expect.sum() < 300
    np.testing.assert_array_equal(has_win(torch.from_numpy(rand)).numpy(), expect)


@pytest.mark.parametrize("E", [1, 5])
def test_reset_draws_nothing(E):
    class NoDraws(RandomSource):
        def uniform(self, shape, low, high):
            raise AssertionError("Connect Four's reset draws no randoms")

    vals = ENV.draw_reset(NoDraws(), E)
    assert vals.shape == (E, 0)
    s = ENV.reset(vals)
    assert s.board.shape == (E, 6, 7) and (s.winner == -1).all() and not s.done.any()


def test_packed_state_round_trips_and_reads_its_fields_as_views():
    """``ConnectFourState.of(**fields).fields()`` gives the fields back; the
    views share ``ints``'s memory (``done`` reads as bool); the two pad
    columns are zero; the state has no shaping coefficient."""
    rng = np.random.default_rng(8)
    E = 11
    fields = {"board": torch.from_numpy(rng.integers(0, 3, (E, 6, 7)).astype(np.int32)),
              "current": torch.from_numpy(rng.integers(0, 2, E).astype(np.int32)),
              "winner": torch.from_numpy(rng.integers(-1, 3, E).astype(np.int32)),
              "done": torch.from_numpy(rng.random(E) < 0.5),
              "step_idx": torch.from_numpy(rng.integers(0, 42, E).astype(np.int32))}
    state = ConnectFourState.of(**fields)
    assert state.ints.shape == (E, 48) and state.ints.dtype == torch.int32
    assert (ConnectFourState.PAD_COL, ConnectFourState.W) == (46, 48)
    assert not state.ints[:, 46:].any()
    assert [f.name for f in dataclasses.fields(state)] == ["ints"]
    back = state.fields()
    assert list(back) == list(fields)
    for name, x in fields.items():
        assert back[name].dtype == x.dtype and torch.equal(back[name], x), name
        if name != "done":
            lo = ConnectFourState.SLICES[name][0]
            assert back[name].data_ptr() == state.ints[:, lo].data_ptr(), name
    assert torch.equal(ConnectFourState.of(**back).ints, state.ints)
    fresh = ENV.reset(torch.empty(E, 0))
    assert not fresh.ints[:, :42].any() and (fresh.winner == -1).all() and not fresh.done.any()


@pytest.mark.parametrize("cls", [ConnectFourState, SkullState, LiarsDiceState])
def test_packed_rows_start_16_byte_aligned(cls):
    """Every step kernel loads and stores whole rows 16 bytes at a time."""
    assert cls.W * 4 % 16 == 0 and cls.W >= cls.PAD_COL
    assert (cls.W, cls.PAD_COL) in {(48, 46), (108, 107), (76, 73)}


@pytest.mark.parametrize("cls, src", [(ConnectFourState, "connect_four_step.cu"),
                                      (SkullState, "skull_step.cu"),
                                      (LiarsDiceState, "liars_dice_step.cu")])
def test_step_kernels_stage_the_packed_rows_through_one_header(cls, src):
    """Each step kernel's row width is its state's, and its rows come in
    and go out through csrc/packed_rows.cuh alone."""
    text = (kernels.CSRC / src).read_text()
    width = re.search(r"(?:constexpr int W = |static_assert\(W == )(\d+)", text)
    assert int(width.group(1)) == cls.W
    assert '#include "packed_rows.cuh"' in text
    assert "packed_rows::Rows<W, EB, NT>" in text
    assert "int4" not in text.replace("float4", "")

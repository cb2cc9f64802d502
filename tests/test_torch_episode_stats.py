"""Episode summaries of the port against ``summarize_episode_logs`` of the
JAX package: wins, draws and the [0, 0] no-outcome sentinel, and the host
tracker's per-player points."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from burn_ppo_tpu.ppo.episode_stats import summarize_episode_logs as jax_summarize  # noqa: E402
from burn_ppo_torch.envs.base import EpisodeLog  # noqa: E402
from burn_ppo_torch.ppo.episode_stats import (  # noqa: E402
    WindowedEpisodeTracker,
    summarize_episode_logs,
    summarize_episode_logs_plain,
)


class _JaxLog:
    def __init__(self, **kw):
        self.__dict__.update(kw)


def _logs(P: int, seed: int):
    rng = np.random.default_rng(seed)
    T, E = 12, 8
    completed = rng.random((T, E)) < 0.3
    if P == 1:
        outcome = np.ones((T, E, 1), np.int32)
    else:
        kinds = rng.integers(0, 4, (T, E))  # P0 wins, P1 wins, draw, sentinel
        table = {2: np.array([[1, 2], [2, 1], [1, 1], [0, 0]]),
                 3: np.array([[1, 2, 3], [2, 1, 2], [1, 1, 1], [0, 0, 0]])}[P]
        outcome = table[kinds].astype(np.int32)
    return dict(
        completed=completed,
        total_rewards=rng.normal(size=(T, E, P)).astype(np.float32),
        length=rng.integers(1, 43, (T, E)).astype(np.int32),
        outcome=outcome,
        active_players=np.full((T, E), P, np.int32),
    )


@pytest.mark.parametrize("P", [1, 2, 3])
def test_summaries_match_jax(P):
    raw = _logs(P, seed=P)
    j = jax_summarize(_JaxLog(**{k: jnp.asarray(v) for k, v in raw.items()}), P)
    t = summarize_episode_logs(EpisodeLog(**{
        k: torch.from_numpy(v.astype(np.float32) if k == "completed" else v)
        for k, v in raw.items()}), P)
    assert set(t) == set(j)
    for k in j:
        np.testing.assert_allclose(t[k].numpy(), np.asarray(j[k]), rtol=1e-6, atol=1e-5, err_msg=k)


def test_sentinel_counts_but_scores_nothing():
    # Three finished games: P0 won, a draw, an invalid move ([0, 0]).
    outcome = torch.tensor([[[1, 2], [1, 1], [0, 0]]], dtype=torch.int32)
    logs = EpisodeLog(completed=torch.ones(1, 3), total_rewards=torch.zeros(1, 3, 2),
                      length=torch.full((1, 3), 9, dtype=torch.int32), outcome=outcome,
                      active_players=torch.full((1, 3), 2, dtype=torch.int32))
    s = summarize_episode_logs(logs, 2)
    assert float(s["count"]) == 3 and float(s["draws"]) == 1
    np.testing.assert_allclose(s["pts_sum"].numpy(), [1.5, 0.5])
    tr = WindowedEpisodeTracker(2)
    tr.ingest({k: v.numpy() for k, v in s.items()})
    np.testing.assert_allclose(tr.avg_points(), [0.5, 1 / 6])
    assert tr.draw_rate == pytest.approx(1 / 3)


@pytest.mark.parametrize("L", [1, 5, 8])
def test_learner_block_summary_matches_jax_on_the_sliced_logs(L):
    """The vs-pool path summarizes the learner block [:, :L] only
    (burn_ppo_tpu/train.py:416-421)."""
    raw = _logs(2, seed=10 + L)
    j = jax_summarize(_JaxLog(**{k: jnp.asarray(v[:, :L]) for k, v in raw.items()}), 2)
    t = summarize_episode_logs(EpisodeLog(**{
        k: torch.from_numpy(v.astype(np.float32) if k == "completed" else v)
        for k, v in raw.items()}), 2, num_envs=L)
    for k in j:
        np.testing.assert_allclose(t[k].numpy(), np.asarray(j[k]), rtol=1e-6, atol=1e-5, err_msg=k)


def test_four_player_ties_use_the_1224_rule_like_jax():
    """Placements with shared ranks (1, 2, 2, 4), (1, 1, 3, 4), all tied
    and the sentinel, plus rows that did not complete."""
    outcome = np.array([[[1, 2, 2, 4], [1, 1, 3, 4], [1, 1, 1, 1], [0, 0, 0, 0],
                         [4, 3, 2, 1], [2, 2, 1, 4]]], np.int32)
    raw = dict(completed=np.array([[1, 1, 1, 1, 0, 1]], bool),
               total_rewards=np.arange(24, dtype=np.float32).reshape(1, 6, 4) - 10.0,
               length=np.array([[5, 6, 7, 8, 9, 10]], np.int32), outcome=outcome,
               active_players=np.full((1, 6), 4, np.int32))
    j = jax_summarize(_JaxLog(**{k: jnp.asarray(v) for k, v in raw.items()}), 4)
    t = summarize_episode_logs_plain(EpisodeLog(**{
        k: torch.from_numpy(v.astype(np.float32) if k == "completed" else v)
        for k, v in raw.items()}), 4)
    for k in j:
        np.testing.assert_allclose(t[k].numpy(), np.asarray(j[k]), rtol=1e-6, atol=1e-6, err_msg=k)
    assert float(t["count"]) == 5 and float(t["draws"]) == 1


def test_skull_placements_award_six_points_a_game_like_jax():
    """Four-player Skull outcomes, ties included, from the port's own
    ``game_outcome``: every game hands out P (P - 1) / 2 = 6 Swiss points."""
    from burn_ppo_torch.envs.skull import Skull

    rng = np.random.default_rng(4)
    env = Skull(4)
    E = 64
    s = env.reset(torch.empty(E, 0))
    s.wins[:, :4] = torch.from_numpy(rng.integers(0, 2, (E, 4)).astype(np.int32))
    s.rose_count[:, :4] = torch.from_numpy(rng.integers(0, 2, (E, 4)).astype(np.int32))
    s.winner[:] = torch.from_numpy(rng.integers(-1, 4, E).astype(np.int32))
    outcome = env.game_outcome(s).numpy()[None]
    tied = np.array([len(set(row)) < 4 for row in outcome[0]])
    assert tied.sum() > 10 and (~tied).sum() > 0
    raw = dict(completed=np.ones((1, E), bool), total_rewards=np.zeros((1, E, 4), np.float32),
               length=np.full((1, E), 30, np.int32), outcome=outcome,
               active_players=np.full((1, E), 4, np.int32))
    j = jax_summarize(_JaxLog(**{k: jnp.asarray(v) for k, v in raw.items()}), 4)
    t = summarize_episode_logs(EpisodeLog(**{
        k: torch.from_numpy(v.astype(np.float32) if k == "completed" else v)
        for k, v in raw.items()}), 4)
    for k in j:
        np.testing.assert_allclose(t[k].numpy(), np.asarray(j[k]), rtol=1e-6, atol=1e-5, err_msg=k)
    assert float(t["pts_sum"].sum()) == pytest.approx(6.0 * E)


def _summaries(raw: dict, P: int, L=None):
    """The JAX summary of columns [:L] and the port's of the whole logs
    with ``num_envs=L``."""
    j = jax_summarize(_JaxLog(**{k: jnp.asarray(v[:, :L]) for k, v in raw.items()}), P)
    t = summarize_episode_logs(EpisodeLog(**{
        k: torch.from_numpy(v.astype(np.float32) if k == "completed" else v)
        for k, v in raw.items()}), P, num_envs=L)
    assert set(t) == set(j)
    return j, t


@pytest.mark.parametrize("P", [1, 2, 4])
def test_an_update_without_a_completed_episode_matches_jax(P):
    """Count 0 and the extrema of no episode: -inf and +inf, as JAX gives
    them; every sum 0."""
    raw = _logs(min(P, 3), seed=20 + P) if P < 4 else _four_player_logs(4, 16, seed=24)
    raw["completed"][:] = False
    j, t = _summaries(raw, P)
    for k in j:
        np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]), err_msg=k)
    assert float(t["count"]) == 0.0
    assert float(t["ret0_max"]) == -np.inf and float(t["ret0_min"]) == np.inf


@pytest.mark.parametrize("P", [1, 2, 3, 4])
def test_every_entry_completed_matches_jax(P):
    raw = _logs(P, seed=30 + P) if P < 4 else _four_player_logs(4, 16, seed=34)
    raw["completed"][:] = True
    j, t = _summaries(raw, P)
    for k in j:
        np.testing.assert_allclose(t[k].numpy(), np.asarray(j[k]), rtol=1e-6, atol=1e-4, err_msg=k)
    assert float(t["count"]) == raw["completed"].size


def _four_player_logs(T: int, E: int, seed: int) -> dict:
    """Four-player logs: wins, shared places, all tied and the sentinel."""
    rng = np.random.default_rng(seed)
    kinds = rng.integers(0, 4, (T, E))
    outcome = rng.integers(1, 5, (T, E, 4)).astype(np.int32)
    outcome[kinds == 1] = 1
    outcome[kinds == 2] = 0
    return dict(
        completed=rng.random((T, E)) < 0.05,
        total_rewards=rng.normal(size=(T, E, 4)).astype(np.float32),
        length=rng.integers(1, 43, (T, E)).astype(np.int32),
        outcome=outcome,
        active_players=np.full((T, E), 4, np.int32),
    )


@pytest.mark.parametrize("T", [1, 2])
def test_four_player_learner_block_with_a_ragged_width_matches_jax(T):
    """Skull's learner block: L = 2867 of E = 4096 columns, a width that
    leaves a ragged float4 tail in K10's rows."""
    raw = _four_player_logs(T, 4096, seed=40 + T)
    assert raw["completed"][:, :2867].any() and raw["completed"][:, 2867:].any()
    j, t = _summaries(raw, 4, L=2867)
    for k in j:
        np.testing.assert_allclose(t[k].numpy(), np.asarray(j[k]), rtol=1e-6, atol=1e-4, err_msg=k)
    assert float(t["count"]) == raw["completed"][:, :2867].sum()

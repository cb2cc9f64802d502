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
from burn_ppo_torch.ppo.episode_stats import WindowedEpisodeTracker, summarize_episode_logs  # noqa: E402


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

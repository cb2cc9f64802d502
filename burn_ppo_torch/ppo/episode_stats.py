"""Episode statistics (burn_ppo_tpu/ppo/episode_stats.py:25-166).

The train step reduces the [T, E] episode logs to a handful of scalars
on the device; the host tracker keeps a trailing window of >= 100
episodes over those per-update summaries. ``WindowedEpisodeTracker`` is a
copy of the JAX package's host-side class, whose module imports JAX.
"""

from __future__ import annotations

from collections import deque
from typing import Dict

import numpy as np
import torch

from burn_ppo_torch.envs.base import EpisodeLog


def summarize_episode_logs(logs: EpisodeLog, num_players: int) -> Dict[str, torch.Tensor]:
    """Reduce stacked logs ([T, E] / [T, E, P] leaves) to window scalars
    on the device (episode_stats.py:25-61).

    Swiss points use the reference's fractional-tie formula
    ``points = P - (place + (tied - 1) / 2)``. A completed episode with a
    zero placement (the no-outcome sentinel of an invalid move) counts in
    ``count`` but not in the points or ``draws``. Single-player outcomes
    are all first place, so their points are 0 and every episode counts
    in ``draws``, as in the reference reduction."""
    donef = logs.completed
    done = donef > 0
    count = torch.sum(donef)
    totals = logs.total_rewards
    mask3 = donef[..., None]
    ret0 = totals[..., 0]
    inf = torch.tensor(float("inf"), device=totals.device)

    place = logs.outcome
    has_outcome = torch.all(place >= 1, dim=-1).to(torch.float32)
    tied = torch.sum((place[..., :, None] == place[..., None, :]).to(torch.float32), dim=-1)
    pts = float(num_players) - (place.to(torch.float32) + (tied - 1.0) / 2.0)
    return {
        "count": count,
        "ret_sum": torch.sum(totals * mask3, dim=(0, 1)),
        "ret0_max": torch.max(torch.where(done, ret0, -inf)),
        "ret0_min": torch.min(torch.where(done, ret0, inf)),
        "len_sum": torch.sum(logs.length.to(torch.float32) * donef),
        "pts_sum": torch.sum(pts * mask3 * has_outcome[..., None], dim=(0, 1)),
        "draws": torch.sum(donef * torch.all(place == 1, dim=-1).to(torch.float32)),
    }


class WindowedEpisodeTracker:
    """Trailing >=100-episode window over per-update summaries (host)."""

    def __init__(self, num_players: int, window: int = 100):
        self.num_players = num_players
        self.window = window
        self.updates: deque = deque()
        self.total_episodes = 0
        self._seed_avg: float = 0.0
        self._seed_count: int = 0

    def seed(self, avg_return: float, count: int) -> None:
        self._seed_avg = float(avg_return)
        self._seed_count = int(count)

    @property
    def seed_count(self) -> int:
        return self._seed_count

    def ingest(self, stats: Dict[str, np.ndarray]) -> None:
        s = {k: np.asarray(v) for k, v in stats.items()}
        cnt = float(s["count"])
        if cnt <= 0:
            return
        self.total_episodes += int(cnt)
        self.updates.append(s)
        total = sum(float(u["count"]) for u in self.updates)
        while (
            len(self.updates) > 1
            and total - float(self.updates[0]["count"]) >= self.window
        ):
            total -= float(self.updates[0]["count"])
            self.updates.popleft()

    @property
    def window_count(self) -> float:
        return sum(float(u["count"]) for u in self.updates)

    @property
    def has_data(self) -> bool:
        return bool(self.updates)

    @property
    def avg_return(self) -> float:
        c = self.window_count
        if c <= 0:
            return self._seed_avg if self._seed_count else 0.0
        return sum(float(u["ret_sum"][0]) for u in self.updates) / c

    @property
    def return_max(self) -> float:
        if not self.updates:
            return 0.0
        return max(float(u["ret0_max"]) for u in self.updates)

    @property
    def return_min(self) -> float:
        if not self.updates:
            return 0.0
        return min(float(u["ret0_min"]) for u in self.updates)

    @property
    def mean_length(self) -> float:
        c = self.window_count
        return sum(float(u["len_sum"]) for u in self.updates) / c if c else 0.0

    def per_player_returns(self) -> np.ndarray:
        c = self.window_count
        if c <= 0:
            return np.zeros(self.num_players)
        return sum(np.asarray(u["ret_sum"], dtype=np.float64) for u in self.updates) / c

    def avg_points(self) -> np.ndarray:
        c = self.window_count
        if c <= 0:
            return np.zeros(self.num_players)
        return sum(np.asarray(u["pts_sum"], dtype=np.float64) for u in self.updates) / c

    @property
    def draw_rate(self) -> float:
        c = self.window_count
        return sum(float(u["draws"]) for u in self.updates) / c if c else 0.0

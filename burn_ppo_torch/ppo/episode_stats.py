"""Episode statistics (burn_ppo_tpu/ppo/episode_stats.py:25-166), with kernel K10.

The train step reduces the [T, E] episode logs to a handful of scalars
on the device: ``summarize_episode_logs`` runs its plain PyTorch version
for CPU tensors and launches the hand-written kernel K10
(``csrc/episode_stats.cu``, ROADMAP B14) for CUDA tensors, or raises. The
host tracker keeps a trailing window of >= 100 episodes over those
per-update summaries. ``WindowedEpisodeTracker`` is a copy of the JAX
package's host-side class, whose module imports JAX.
"""

from __future__ import annotations

from collections import deque
from typing import Dict, Optional

import numpy as np
import torch

from burn_ppo_torch import kernels
from burn_ppo_torch.envs.base import EpisodeLog

MAX_KERNEL_PLAYERS = 8


def summarize_episode_logs_plain(logs: EpisodeLog, num_players: int) -> Dict[str, torch.Tensor]:
    """Plain PyTorch K10: reduce stacked logs ([T, E] / [T, E, P] leaves)
    to window scalars on the device (episode_stats.py:25-61).

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


def summarize_episode_logs(logs: EpisodeLog, num_players: int,
                           num_envs: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """Window scalars of the first ``num_envs`` env columns of the logs
    (all of them by default; the vs-pool path reads its learner block
    only, burn_ppo_tpu/train.py:416-421)."""
    ts = (logs.completed, logs.total_rewards, logs.length, logs.outcome)
    if kernels.on_cpu(*ts):
        if num_envs is not None:
            logs = EpisodeLog(**{k: getattr(logs, k)[:, :num_envs]
                                 for k in ("completed", "total_rewards", "length", "outcome",
                                           "active_players")})
        return summarize_episode_logs_plain(logs, num_players)
    T, E = logs.completed.shape
    P = num_players
    L = E if num_envs is None else num_envs
    if not 1 <= P <= MAX_KERNEL_PLAYERS:
        raise ValueError(f"episode_stats kernel takes 1..{MAX_KERNEL_PLAYERS} players, got {P}")
    kernels.expect(logs.completed, "completed", torch.float32, (T, E))
    kernels.expect(logs.total_rewards, "total_rewards", torch.float32, (T, E, P))
    kernels.expect(logs.length, "length", torch.int32, (T, E))
    kernels.expect(logs.outcome, "outcome", torch.int32, (T, E, P))
    dev = logs.completed.device
    G = max(1, min(132, -(-T * L // 1024)))
    sums = torch.empty(G, 3 + 2 * P, dtype=torch.float64, device=dev)
    extrema = torch.empty(G, 2, dtype=torch.float32, device=dev)
    out = torch.empty(5 + 2 * P, dtype=torch.float32, device=dev)
    p = kernels.ptr
    err = kernels.library().episode_stats(
        p(logs.completed), p(logs.total_rewards), p(logs.length), p(logs.outcome),
        T, E, L, P, G, p(sums), p(extrema), p(out), kernels.stream(dev),
    )
    kernels.check(err, "episode_stats")
    summarize_episode_logs.launches += 1
    return {
        "count": out[0], "ret_sum": out[1:1 + P], "ret0_max": out[P + 1], "ret0_min": out[P + 2],
        "len_sum": out[P + 3], "pts_sum": out[P + 4:2 * P + 4], "draws": out[2 * P + 4],
    }


summarize_episode_logs.launches = 0


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

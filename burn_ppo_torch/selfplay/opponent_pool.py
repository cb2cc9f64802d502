"""Historical-checkpoint opponent pool.

A copy of burn_ppo_tpu/selfplay/opponent_pool.py:52-461 for one process:
checkpoints join the pool as they are saved (scan on startup); each
update ("rotation") samples active opponents with probability
proportional to (1 - win_rate)^exponent, weighted without replacement,
from a ``random.Random(seed)``; game results queue per rotation and fold
into an EMA win rate once per rotation; stats persist atomically to
``opponent_stats.json``; a selection-probability PNG renders per
checkpoint where matplotlib is installed; pool performance vs the best
checkpoint gives the exploitability metric.

The rotation's K opponents are stacked on the device once per rotation
(``OpponentStack``: weights ``[K, in, out]``, biases ``[K, out]``, obs
normalisers ``[K, D]`` / ``[K]``; a CNN's conv layers as stacked OIHW
weights ``[K * C_out, C_in, kh, kw]`` and biases ``[K * C_out]``) for the
slot-grouped forward of kernel K7 (ppo/pool_rollout.py; a CNN's behind
K20, its conv front). An LRU cache keeps recently used checkpoints'
actor towers on the device; ``seed_device_cache`` snapshots the live
learner with a clone, since the update writes its parameters in place.
"""

from __future__ import annotations

import json
import random
from collections import OrderedDict
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from burn_ppo_torch.checkpoint import load_model, load_obs_normalizer
from burn_ppo_torch.ppo.normalization import ObsNormState
from burn_ppo_torch.ppo.pool_rollout import ActorParams, OpponentStack, actor_params


def _fill_missing_norms(norms: List[Optional[ObsNormState]]) -> List[Optional[ObsNormState]]:
    """Substitute identity normalizer states for opponents saved without
    one, so a rotation mixing normalized and unnormalized checkpoints
    stacks cleanly: a zeroed state has count 0, and the normalizer is the
    identity until count >= 2 (opponent_pool.py:52-67)."""
    if all(n is None for n in norms) or all(n is not None for n in norms):
        return norms
    t = next(n for n in norms if n is not None)
    identity = ObsNormState(mean=torch.zeros_like(t.mean), m2=torch.zeros_like(t.m2),
                            count=torch.zeros_like(t.count))
    return [identity if n is None else n for n in norms]


def _clone_norm(norm: Optional[ObsNormState]) -> Optional[ObsNormState]:
    if norm is None:
        return None
    return ObsNormState(mean=norm.mean.clone(), m2=norm.m2.clone(), count=norm.count.clone())


@dataclass
class OpponentStats:
    """EMA record per pool checkpoint (opponent_pool.rs:33-61).

    ``win_rate`` is the LEARNER's strict-win rate against this opponent
    (opponent_pool.rs:40: "Learner's win rate against this opponent");
    0.5 is the neutral prior for a fresh checkpoint."""

    name: str
    step: int
    win_rate: float = 0.5
    games_played: int = 0

    def to_dict(self):
        return {
            "name": self.name,
            "step": self.step,
            "win_rate": self.win_rate,
            "games_played": self.games_played,
        }

    @staticmethod
    def from_dict(d):
        return OpponentStats(
            name=d["name"],
            step=int(d.get("step", 0)),
            win_rate=float(d.get("win_rate", 0.5)),
            games_played=int(d.get("games_played", 0)),
        )


class OpponentPool:
    def __init__(
        self,
        run_dir: str | Path,
        *,
        select_alpha: float = 0.1,
        select_exponent: float = 2.0,
        max_active: int = 8,
        cache_size: int = 32,
        seed: int = 0,
        device: str | torch.device = "cpu",
        compute_dtype: Optional[str] = None,
    ):
        self.device = torch.device(device)
        # the learner's: each opponent's tower stored rounded to bf16 once
        # with "bfloat16" (pool_rollout.py:126-139 runs the learner's network)
        self.compute_dtype = compute_dtype
        self.run_dir = Path(run_dir)
        self.ckpt_dir = self.run_dir / "checkpoints"
        self.stats_path = self.run_dir / "opponent_stats.json"
        self.select_alpha = select_alpha
        self.select_exponent = select_exponent
        self.max_active = max_active
        self.stats: Dict[str, OpponentStats] = {}
        self.active: List[str] = []  # current rotation's opponents (slot order)
        # name -> (ActorParams, ObsNormState or None) on the device
        self._device_cache: OrderedDict = OrderedDict()
        self._cache_size = cache_size
        self._pending: Dict[str, Tuple[float, int]] = {}  # name -> (score_sum, n)
        self._recent_vs: Dict[str, List[float]] = {}  # pairwise swiss scores
        self._rng = random.Random(seed)

        if self.stats_path.exists():
            data = json.loads(self.stats_path.read_text())
            dropped = []
            for d in data.get("opponents", []):
                s = OpponentStats.from_dict(d)
                # Reconcile against disk: users delete old step_* dirs to
                # free space; a stale stats entry would let sample_active
                # pick an unloadable checkpoint and kill training at the
                # first rotation.
                if not (self.ckpt_dir / s.name).is_dir():
                    dropped.append(s.name)
                    continue
                self.stats[s.name] = s
            if dropped:
                print(
                    f"opponent pool: dropped {len(dropped)} stats entr"
                    f"{'y' if len(dropped) == 1 else 'ies'} whose "
                    f"checkpoints are gone from disk: "
                    + ", ".join(dropped[:5])
                    + ("..." if len(dropped) > 5 else "")
                )
        self.scan_checkpoints()

    # ------------------------------------------------------------------
    def scan_checkpoints(self) -> None:
        """Register any checkpoint dirs not yet in the pool (356-405)."""
        if not self.ckpt_dir.exists():
            return
        for p in sorted(self.ckpt_dir.iterdir()):
            if p.is_dir() and p.name.startswith("step_") and p.name[5:].isdigit():
                self.add_checkpoint(p.name, int(p.name[5:]))

    def add_checkpoint(self, name: str, step: int) -> None:
        if name not in self.stats:
            self.stats[name] = OpponentStats(name=name, step=step)

    def __len__(self) -> int:
        return len(self.stats)

    # ------------------------------------------------------------------
    def selection_weights(self) -> Dict[str, float]:
        """(1 - win_rate)^exponent with numerical floors (432-482)."""
        weights = {}
        for name, s in self.stats.items():
            base = min(max(1.0 - s.win_rate, 1e-6), 1.0)
            weights[name] = base ** self.select_exponent
        return weights

    def sample_active(self) -> List[str]:
        """Weighted sample WITHOUT replacement of this rotation's opponents."""
        weights = self.selection_weights()
        names = list(weights)
        k = min(self.max_active, len(names))
        chosen: List[str] = []
        pool = dict(weights)
        for _ in range(k):
            total = sum(pool.values())
            if total <= 0:
                remaining = [n for n in names if n not in chosen]
                chosen.extend(remaining[: k - len(chosen)])
                break
            r = self._rng.random() * total
            acc = 0.0
            pick = None
            for n, w in pool.items():
                acc += w
                if r <= acc:
                    pick = n
                    break
            pick = pick if pick is not None else next(iter(pool))
            chosen.append(pick)
            del pool[pick]
        return chosen

    # ------------------------------------------------------------------
    def _load_params_device(self, name: str) -> Tuple[ActorParams, Optional[ObsNormState]]:
        """A checkpoint's actor tower and obs normalizer, loaded onto the
        device once and kept in the LRU cache."""
        entry = self._device_cache.get(name)
        if entry is not None:
            self._device_cache.move_to_end(name)
            return entry
        path = self.ckpt_dir / name
        network, _meta = load_model(path, self.device)
        entry = (actor_params(network, self.compute_dtype),
                 load_obs_normalizer(path, self.device))
        self._put(name, entry)
        return entry

    def _put(self, name: str, entry) -> None:
        self._device_cache[name] = entry
        self._device_cache.move_to_end(name)
        while len(self._device_cache) > self._cache_size:
            self._device_cache.popitem(last=False)

    def seed_device_cache(self, name: str, network: torch.nn.Module,
                          obs_norm: Optional[ObsNormState]) -> None:
        """Populate the device cache for a just-saved checkpoint straight
        from the live training state, so the first rotation that samples
        it skips the disk read. A clone: the update writes the live
        parameters in place."""
        self._put(name, (actor_params(network, self.compute_dtype), _clone_norm(obs_norm)))

    def refresh_rotation(
        self, pad_to: Optional[int] = None
    ) -> Optional[Tuple[OpponentStack, List[str]]]:
        """Sample this rotation's opponents and stack them on the device.

        Returns (stack, names), or None if the pool is empty. ``pad_to``:
        pad the stacked axis to this many slots by repeating the first
        opponent (the trainer bounds slot sampling by len(names), so
        padded slots are never seated and never produce records)."""
        if not self.stats:
            return None
        self.active = self.sample_active()
        names = tuple(self.active)
        load_names = names
        if pad_to is not None and len(names) < pad_to:
            load_names = names + (names[0],) * (pad_to - len(names))
        loaded = [self._load_params_device(n) for n in load_names]
        norms = _fill_missing_norms([n for _, n in loaded])
        stack = OpponentStack.of([p for p, _ in loaded],
                                 None if norms[0] is None else norms)
        return stack, list(names)

    # ------------------------------------------------------------------
    def queue_game_result(
        self, opponent_names: Sequence[str], learner_placement: int,
        opponent_placements: Sequence[int],
    ) -> None:
        """Queue pairwise learner-vs-opponent outcomes (578-616).

        ``win_rate`` tracks the LEARNER's strict-win rate vs each
        opponent (reference opponent_pool.rs:39-41, 603: learner_won =
        learner_placement < placement, so a tie counts as a loss). The
        selection weight (1 - win_rate)^p then prioritizes opponents the
        learner loses to. ``_recent_vs`` keeps the learner's pairwise
        score with ties at 0.5 for the pool-performance proxy."""
        for name, opp_place in zip(opponent_names, opponent_placements):
            if learner_placement < opp_place:
                win, pair = 1.0, 1.0
            elif learner_placement == opp_place:
                win, pair = 0.0, 0.5
            else:
                win, pair = 0.0, 0.0
            acc, n = self._pending.get(name, (0.0, 0))
            self._pending[name] = (acc + win, n + 1)
            self._recent_vs.setdefault(name, []).append(pair)
            if len(self._recent_vs[name]) > 200:
                self._recent_vs[name] = self._recent_vs[name][-200:]

    def queue_game_results_batch(
        self,
        active_names: Sequence[str],
        learner_places: np.ndarray,  # [n]
        opp_slots: np.ndarray,  # [n, P-1] rotation slot per opponent seat
        opp_places: np.ndarray,  # [n, P-1]
    ) -> None:
        """Vectorized ``queue_game_result`` over n completed games.

        Scores are computed with one numpy comparison and folded per
        rotation slot (K <= max_active iterations), replacing a Python
        loop over every completed episode — the reference batches this
        once per rotation too (opponent_pool.rs:628-653). Slot entries
        outside [0, K) are ignored (stale slots after a rotation shrink).
        """
        learner_places = np.asarray(learner_places).reshape(-1)
        if learner_places.size == 0:
            # reshape(0, -1) below cannot infer the -1 dimension.
            return
        opp_slots = np.asarray(opp_slots).reshape(len(learner_places), -1)
        opp_places = np.asarray(opp_places).reshape(len(learner_places), -1)
        lp = learner_places[:, None]
        # Learner's perspective (reference opponent_pool.rs:603): strict
        # win for win_rate (ties = losses); ties at 0.5 for the pairwise
        # pool-performance log.
        win = np.where(lp < opp_places, 1.0, 0.0)
        pair = np.where(
            lp < opp_places, 1.0, np.where(lp == opp_places, 0.5, 0.0)
        )
        K = len(active_names)
        valid = (opp_slots >= 0) & (opp_slots < K)
        for k, name in enumerate(active_names):
            m = valid & (opp_slots == k)
            n = int(m.sum())
            if n == 0:
                continue
            acc, n0 = self._pending.get(name, (0.0, 0))
            self._pending[name] = (acc + float(win[m].sum()), n0 + n)
            lst = self._recent_vs.setdefault(name, [])
            lst.extend(pair[m].tolist())
            if len(lst) > 200:
                self._recent_vs[name] = lst[-200:]

    def apply_pending_updates(self) -> None:
        """EMA-fold queued results once per rotation (628-653)."""
        for name, (acc, n) in self._pending.items():
            if n == 0 or name not in self.stats:
                continue
            batch_rate = acc / n
            s = self.stats[name]
            s.win_rate = s.win_rate * (1 - self.select_alpha) + batch_rate * self.select_alpha
            s.games_played += n
        self._pending.clear()
        self.save_stats()

    # ------------------------------------------------------------------
    def get_pool_performance(self, best_name: Optional[str] = None) -> Optional[float]:
        """Learner's average score in [0, 1] vs the best historical
        checkpoint (rating-driven when ``best_name`` is given) —
        exploitability proxy (opponent_pool.rs:921-948)."""
        if not self._recent_vs:
            return None
        # No identified best, or no recent games against it: None, as in
        # the reference (opponent_pool.rs:921-934). Averaging over the
        # whole pool instead would compute the proxy mostly against weak
        # historical opponents and overstate it.
        candidates = self._recent_vs.get(best_name) if best_name else None
        if not candidates:
            return None
        return float(np.mean(candidates))

    # ------------------------------------------------------------------
    def save_stats(self) -> None:
        tmp = self.stats_path.with_suffix(".json.tmp")
        tmp.write_text(
            json.dumps(
                {"opponents": [s.to_dict() for s in self.stats.values()]}, indent=2
            )
        )
        tmp.rename(self.stats_path)

    def generate_selection_graph(self, output_path: str | Path) -> bool:
        """Selection-probability bar chart (plotters in the reference,
        opponent_pool.rs:741-891)."""
        if not self.stats:
            return False
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            return False
        weights = self.selection_weights()
        total = sum(weights.values()) or 1.0
        items = sorted(self.stats.values(), key=lambda s: s.step)
        steps = [s.step for s in items]
        probs = [weights[s.name] / total for s in items]
        # Display the OPPONENT's win rate (1 - learner win_rate) like the
        # reference graph (opponent_pool.rs:757-766 flips for display).
        wrs = [1.0 - s.win_rate for s in items]
        fig, ax1 = plt.subplots(figsize=(8, 5))
        ax1.bar(range(len(steps)), probs, color="#4477aa", label="selection prob")
        ax1.set_xticks(range(len(steps)))
        ax1.set_xticklabels([str(s) for s in steps], rotation=60, fontsize=7)
        ax1.set_ylabel("selection probability")
        ax2 = ax1.twinx()
        ax2.plot(range(len(steps)), wrs, color="#cc3311", marker="o", ms=3,
                 label="opponent win rate")
        ax2.set_ylabel("win rate vs learner")
        ax2.set_ylim(0, 1)
        ax1.set_xlabel("checkpoint step")
        fig.tight_layout()
        fig.savefig(output_path, dpi=110)
        plt.close(fig)
        return True

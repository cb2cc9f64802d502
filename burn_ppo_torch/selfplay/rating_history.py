"""During-training Elo tracking from vs-pool games.

A copy of burn_ppo_tpu/selfplay/rating_history.py (records, the
comparison cache, ``compute`` and ``best_step``), on the port's NumPy
Plackett-Luce solver.

Parity with the reference (src/rating_history.rs): every game played
against a pool opponent is appended to ``rating_games.jsonl``
(+`rating_metadata.json`); full Plackett-Luce ratings are recomputed at
each checkpoint; the first checkpoint anchors at 1000; the reported
"current" Elo is the second-to-last checkpoint (the latest hasn't played
rating games yet, rating_history.rs:313-319); ratings drive the ``best``
symlink and an ``elo_graph.png`` (matplotlib instead of plotters).
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from burn_ppo_torch.selfplay.plackett_luce import (
    ComparisonArrays,
    GameResult,
    PlackettLuceConfig,
    aggregate_comparison_arrays,
    compute_ratings_from_comparisons,
    comparisons_to_arrays,
    concat_comparison_arrays,
    expand_games_to_comparisons,
)


@dataclass
class RatingSnapshot:
    current_elo: float = 1000.0
    best_elo: float = 1000.0
    best_step: int = 0
    total_games: int = 0
    computation_time_ms: float = 0.0


def _expand_placements_vectorized(
    players: np.ndarray, places: np.ndarray, present: np.ndarray
) -> ComparisonArrays:
    """Placements -> weighted comparisons for a batch of games at once —
    the array twin of expand_games_to_comparisons (same math: each player
    with at least one strictly-lower opponent wins one comparison whose
    losers are ALL strictly-lower players, weight 1/|tie group|,
    plackett_luce.rs:195-254).

    ``players``/``places``: [N, M]; ``present``: [N, M] bool (False =
    seat absent from this game). Comparison order differs from the
    per-game expansion (row-major by seat, not by placement rank) — the
    PL likelihood is order-free, and downstream aggregation canonicalizes
    anyway."""
    N, M = players.shape
    # Absent seats must never compare: give them a placement below
    # everyone (never a loser) and mask them as winners explicitly.
    p = np.where(present, places, np.iinfo(np.int64).min)
    lower = p[:, None, :] > p[:, :, None]  # [N, i, j]: j strictly worse than i
    n_lower = lower.sum(axis=2)  # [N, M]
    tie_cnt = ((p[:, None, :] == p[:, :, None]).sum(axis=2))  # [N, M]
    is_winner = present & (n_lower > 0)
    w_rows, w_cols = np.nonzero(is_winner)
    if len(w_rows) == 0:
        return comparisons_to_arrays([])
    winners = players[w_rows, w_cols].astype(np.int32)
    counts = n_lower[w_rows, w_cols].astype(np.int32)
    weights = 1.0 / tie_cnt[w_rows, w_cols].astype(np.float64)
    loser_mask = lower[w_rows, w_cols]  # [W, M]
    loser_rows = np.broadcast_to(players[w_rows], loser_mask.shape)
    losers = loser_rows[loser_mask].astype(np.int32)
    return ComparisonArrays(winners, counts, losers, weights)


class RatingHistory:
    def __init__(self, run_dir: str | Path):
        self.run_dir = Path(run_dir)
        self.games_path = self.run_dir / "rating_games.jsonl"
        self.metadata_path = self.run_dir / "rating_metadata.json"
        # Host memory is bounded by DISTINCT matchups, not games played:
        # every recorded game lives on disk (rating_games.jsonl, reference
        # parity), but in memory only the not-yet-expanded tail of the log
        # (_pending) plus weight-aggregated comparison arrays are kept —
        # raw game dicts are dropped the moment they are folded into the
        # arrays. num_games is the total count (disk lines).
        self.num_games: int = 0
        self._pending: List[dict] = []
        self.checkpoint_to_idx: Dict[str, int] = {}
        self.idx_to_checkpoint: List[str] = []
        self.idx_to_step: List[int] = []
        self.first_checkpoint_idx: Optional[int] = None
        self.current_checkpoint: Optional[str] = None
        self._cached_ratings: Optional[List[float]] = None
        # Incremental-comparison cache: the game log is append-only, so
        # expanded comparisons are cached as flat-array chunks and only
        # the tail of the log (_pending) is expanded at each checkpoint.
        # Player indices are append-only too (_register), so cached
        # chunks never go stale.
        self._expanded_upto: int = 0
        self._chunks: List[ComparisonArrays] = []
        self._games_played = np.zeros(0, dtype=np.int64)
        # Warm start for the MM solve: previous gammas, used only when
        # the previous solve CONVERGED (unique fixed point -> identical
        # ratings within threshold; a diverging never-won player keeps
        # the reference's from-zero trajectory instead).
        self._warm_gammas: Optional[np.ndarray] = None
        self._cache_saved_upto: int = 0

    # ------------------------------------------------------------------
    @staticmethod
    def load(run_dir: str | Path) -> "RatingHistory":
        h = RatingHistory._load_attempt(run_dir, use_cache=True)
        if h is None:
            # jsonl shrank under the cache (e.g. a crash lost a tail
            # write) — the cache's player indices no longer match the
            # log.  Rebuild from scratch with the cache discarded, so the
            # index space (cache players first, then metadata, then tail
            # games) reassembles consistently.
            h = RatingHistory._load_attempt(run_dir, use_cache=False)
            assert h is not None
        return h

    @staticmethod
    def _load_attempt(
        run_dir: str | Path, use_cache: bool
    ) -> Optional["RatingHistory"]:
        """One streaming pass over the game log (it can be hundreds of MB
        in the million-game regime — never read_text/splitlines it, and
        don't stream it twice just to count lines: shrink detection
        happens at EOF of the same tail-parse pass).  Returns None when
        the log turns out shorter than the cache covers."""
        h = RatingHistory(run_dir)
        cached_upto = 0
        if use_cache:
            cached_upto = h._load_cache()  # registers cached player indices
        if h.metadata_path.exists():
            meta = json.loads(h.metadata_path.read_text())
            for name, step in meta.get("checkpoint_steps", {}).items():
                idx = h._register(name, int(step))
                h.idx_to_step[idx] = int(step)
            first = meta.get("first_checkpoint")
            if first in h.checkpoint_to_idx:
                h.first_checkpoint_idx = h.checkpoint_to_idx[first]
            h.current_checkpoint = meta.get("current_checkpoint")
        # Games the cache already covers never need re-parsing; only the
        # tail past the cache is parsed. A huge tail (cache-less cold
        # load of a long run) folds into comparison arrays every 200k
        # games so resident memory never scales with the log.
        h.num_games = cached_upto
        h._expanded_upto = cached_upto
        seen = 0
        if h.games_path.exists():
            with open(h.games_path) as f:
                for line in f:
                    if not line.strip():
                        continue
                    seen += 1
                    if seen <= cached_upto:
                        continue
                    game = json.loads(line)
                    h._pending.append(game)
                    h.num_games += 1
                    h._register(game["current"], 0)
                    for o in game["opponents"]:
                        h._register(o, 0)
                    if len(h._pending) >= 200_000:
                        h._expand_pending()
                        h._compact_chunks()
        if seen < cached_upto:
            # Fewer log lines than the cache covers: shrink detected at
            # EOF of the same pass (no separate counting stream).
            return None
        # Metadata lost/incomplete but games survive: anchor the earliest
        # registered player (rating_history.rs:145-146). Without this the
        # next on_checkpoint_saved would anchor 1000 at the NEWEST
        # checkpoint, rewriting every historical rating.
        if h.first_checkpoint_idx is None and h.idx_to_checkpoint:
            h.first_checkpoint_idx = 0
        return h

    # ------------------------------------------------------------------
    @property
    def cache_path(self) -> Path:
        return self.run_dir / "rating_cache.npz"

    def _reset_cache(self) -> None:
        self.num_games = 0
        self._pending = []
        self.checkpoint_to_idx = {}
        self.idx_to_checkpoint = []
        self.idx_to_step = []
        self._expanded_upto = 0
        self._chunks = []
        self._games_played = np.zeros(0, dtype=np.int64)
        self._warm_gammas = None
        self._cache_saved_upto = 0

    def _load_cache(self) -> int:
        """Restore the expanded-comparison cache written by _save_cache;
        returns the number of games it covers (0 = no/invalid cache)."""
        if not self.cache_path.exists():
            return 0
        try:
            with np.load(self.cache_path, allow_pickle=False) as z:
                names = [str(s) for s in z["names"]]
                steps = z["steps"]
                for name, step in zip(names, steps):
                    self._register(name, int(step))
                self._chunks = [
                    ComparisonArrays(
                        z["winners"], z["counts"], z["losers"], z["weights"]
                    )
                ]
                self._games_played = z["games_played"].astype(np.int64)
                # "warm_gammas_raw" holds solver gammas; the legacy
                # "warm_gammas" key held rating-reconstructed values
                # (poisoned for zero-game players) and is ignored — a
                # cold MM start just costs a few extra iterations.
                if "warm_gammas_raw" in z.files:
                    self._warm_gammas = z["warm_gammas_raw"]
                self._cache_saved_upto = int(z["num_games"])
                return int(z["num_games"])
        except Exception:
            self._reset_cache()
            return 0

    def _save_cache(self) -> None:
        """Persist the expanded comparisons + per-player game counts so a
        new process (supervisor child, resume) skips re-parsing and
        re-expanding the full jsonl (tens of seconds at 1M+ games)."""
        if not self._chunks or self._expanded_upto == 0:
            return
        arrays = (
            self._chunks[0]
            if len(self._chunks) == 1
            else concat_comparison_arrays(self._chunks)
        )
        self._chunks = [arrays]
        tmp = self.cache_path.with_suffix(".npz.tmp")
        payload = dict(
            names=np.asarray(self.idx_to_checkpoint),
            steps=np.asarray(self.idx_to_step, np.int64),
            winners=arrays.winners,
            counts=arrays.counts,
            losers=arrays.losers,
            weights=arrays.weights,
            games_played=self._games_played,
            num_games=np.int64(self._expanded_upto),
        )
        if self._warm_gammas is not None:
            payload["warm_gammas_raw"] = self._warm_gammas
        with open(tmp, "wb") as f:
            np.savez(f, **payload)
        tmp.rename(self.cache_path)

    def _register(self, name: str, step: int) -> int:
        if name in self.checkpoint_to_idx:
            return self.checkpoint_to_idx[name]
        idx = len(self.idx_to_checkpoint)
        self.checkpoint_to_idx[name] = idx
        self.idx_to_checkpoint.append(name)
        self.idx_to_step.append(step)
        return idx

    def _save_metadata(self) -> None:
        meta = {
            "checkpoint_steps": {
                name: self.idx_to_step[i]
                for name, i in self.checkpoint_to_idx.items()
            },
            "first_checkpoint": (
                self.idx_to_checkpoint[self.first_checkpoint_idx]
                if self.first_checkpoint_idx is not None
                else None
            ),
            "current_checkpoint": self.current_checkpoint,
        }
        tmp = self.metadata_path.with_suffix(".json.tmp")
        tmp.write_text(json.dumps(meta, indent=2))
        tmp.rename(self.metadata_path)

    # ------------------------------------------------------------------
    def record_game(
        self, current: str, opponents: Sequence[str], placements: Sequence[int]
    ) -> None:
        """Append one vs-pool game: placements = [current, *opponents]."""
        self.record_games_batch(current, [(opponents, placements)])

    def record_games_batch(
        self, current: str, games: Sequence[tuple]
    ) -> None:
        """Append many vs-pool games with ONE file write.

        ``games``: [(opponent_names, placements), ...] with placements =
        [current, *opponents]. Per-update batching keeps the pool path's
        host bookkeeping off the per-episode critical path."""
        if not games:
            return
        lines = []
        self._register(current, 0)
        for opponents, placements in games:
            for o in opponents:
                self._register(o, 0)
            game = {
                "current": current,
                "opponents": list(opponents),
                "placements": [int(p) for p in placements],
            }
            self._pending.append(game)
            self.num_games += 1
            lines.append(json.dumps(game))
        self._cached_ratings = None
        with open(self.games_path, "a") as f:
            f.write("\n".join(lines) + "\n")

    def record_games_arrays(
        self,
        current: str,
        active_names: Sequence[str],
        learner_place: np.ndarray,
        opp_slots: np.ndarray,
        opp_places: np.ndarray,
    ) -> None:
        """Array-native batch record: the pool training path's zero-
        per-game-Python entry (the reference's record_game is called in a
        per-episode loop, rating_history.rs; here a whole K-update window
        of games lands as three numpy arrays).

        ``learner_place``: [N] learner placements; ``opp_slots``: [N, P-1]
        rotation-slot indices into ``active_names`` (entries outside
        [0, len(active_names)) mean "seat not faced a pool opponent" and
        are dropped); ``opp_places``: [N, P-1] those opponents'
        placements. Rows with no valid opponent slot are skipped.

        Writes jsonl lines byte-identical to record_games_batch (distinct
        rows are serialized once and reused — placements and slots live
        in a tiny value space) and folds comparisons in with one
        vectorized expansion instead of per-game dicts."""
        learner_place = np.asarray(learner_place, np.int64)
        opp_slots = np.asarray(opp_slots, np.int64)
        opp_places = np.asarray(opp_places, np.int64)
        K = len(active_names)
        valid = (opp_slots >= 0) & (opp_slots < K)
        keep = valid.any(axis=1)
        if not keep.any():
            return
        learner_place = learner_place[keep]
        opp_slots = opp_slots[keep]
        opp_places = opp_places[keep]
        valid = valid[keep]
        N, S = opp_slots.shape

        self._register(current, 0)
        for name in active_names:
            self._register(name, 0)

        # --- jsonl append: serialize each DISTINCT row once ------------
        # Canonicalize invalid slots so they can't split identical rows.
        rows = np.concatenate(
            [
                learner_place[:, None],
                np.where(valid, opp_slots, -1),
                np.where(valid, opp_places, 0),
            ],
            axis=1,
        )
        uniq, inv = np.unique(rows, axis=0, return_inverse=True)
        # Manual formatting, byte-identical to json.dumps with default
        # separators (tests assert parity with the dict path): json.dumps
        # itself measured 3x the cost of everything else at window scale.
        qnames = [json.dumps(n) for n in active_names]
        head = '{"current": ' + json.dumps(current) + ', "opponents": ['
        uniq_lines = []
        for row in uniq.tolist():
            lp = row[0]
            slots = row[1 : 1 + S]
            places = row[1 + S :]
            opp = ", ".join(qnames[s] for s in slots if s >= 0)
            pl = ", ".join(
                [str(lp)] + [str(p) for s, p in zip(slots, places) if s >= 0]
            )
            uniq_lines.append(
                f'{head}{opp}], "placements": [{pl}]}}'
            )
        with open(self.games_path, "a") as f:
            f.write("\n".join(uniq_lines[i] for i in inv.ravel()) + "\n")

        # --- vectorized comparison expansion ---------------------------
        # Prefix bookkeeping: anything recorded through the dict path
        # must fold in first so _expanded_upto stays a jsonl prefix.
        self._expand_pending()
        slot_to_idx = np.asarray(
            [self.checkpoint_to_idx[n] for n in active_names], np.int64
        )
        cur_idx = self.checkpoint_to_idx[current]
        players = np.concatenate(
            [
                np.full((N, 1), cur_idx, np.int64),
                np.where(valid, slot_to_idx[np.where(valid, opp_slots, 0)], -1),
            ],
            axis=1,
        )  # [N, S+1]; -1 = absent seat
        places = np.concatenate(
            [learner_place[:, None], opp_places], axis=1
        )  # [N, S+1]
        present = np.concatenate(
            [np.ones((N, 1), bool), valid], axis=1
        )
        chunk = _expand_placements_vectorized(players, places, present)
        if len(chunk):
            self._chunks.append(chunk)
        counts = np.bincount(
            players[present].ravel(), minlength=len(self.idx_to_checkpoint)
        )
        if len(self._games_played) < len(counts):
            self._games_played = np.concatenate(
                [
                    self._games_played,
                    np.zeros(
                        len(counts) - len(self._games_played), np.int64
                    ),
                ]
            )
        self._games_played[: len(counts)] += counts
        self.num_games += N
        self._expanded_upto = self.num_games
        self._cached_ratings = None

    def _expand_pending(self) -> None:
        """Fold dict-path games into the comparison arrays and drop the
        raw dicts (memory is bounded by distinct matchups, not games)."""
        if not self._pending:
            return
        n = len(self.idx_to_checkpoint)
        pl_games = []
        for game in self._pending:
            players = [self.checkpoint_to_idx[game["current"]]] + [
                self.checkpoint_to_idx[o] for o in game["opponents"]
            ]
            pl_games.append(GameResult.of(players, game["placements"]))
        chunk = comparisons_to_arrays(expand_games_to_comparisons(pl_games))
        if len(chunk):
            self._chunks.append(chunk)
        if len(self._games_played) < n:
            self._games_played = np.concatenate(
                [
                    self._games_played,
                    np.zeros(n - len(self._games_played), dtype=np.int64),
                ]
            )
        for g in pl_games:
            for p in g.players:
                self._games_played[p] += 1
        self._pending = []
        self._expanded_upto = self.num_games

    def _compact_chunks(self) -> None:
        """Concat AND weight-aggregate the chunk list: identical matchups
        merge, so the resident array is O(distinct matchups) — the
        million-game regime carries MBs, not GBs, per host."""
        if self._chunks:
            self._chunks = [
                aggregate_comparison_arrays(
                    concat_comparison_arrays(self._chunks)
                )
            ]

    def on_checkpoint_saved(self, checkpoint_name: str, step: int) -> None:
        idx = self._register(checkpoint_name, step)
        if self.first_checkpoint_idx is None:
            self.first_checkpoint_idx = idx
        self.idx_to_step[idx] = step
        self.current_checkpoint = checkpoint_name
        self._cached_ratings = None
        self._save_metadata()
        # Persist the comparison cache once it has grown enough to make
        # the write (tens of MB at 1M+ games) worth the cold-load save;
        # a new process re-parses only the jsonl tail past the cache.
        grown = self._expanded_upto - self._cache_saved_upto
        if grown >= max(100_000, self._cache_saved_upto // 4):
            self._save_cache()
            self._cache_saved_upto = self._expanded_upto

    # ------------------------------------------------------------------
    def compute(self) -> RatingSnapshot:
        n = len(self.idx_to_checkpoint)
        if n == 0 or self.num_games == 0:
            self._cached_ratings = []
            return RatingSnapshot()

        self._expand_pending()

        games_played = self._games_played
        if len(games_played) < n:
            games_played = np.concatenate(
                [games_played, np.zeros(n - len(games_played), dtype=np.int64)]
            )
        if self._chunks:
            self._compact_chunks()
            arrays = self._chunks[0]
        else:
            arrays = comparisons_to_arrays([])

        init = None
        if self._warm_gammas is not None and len(self._warm_gammas) <= n:
            init = np.zeros(n)
            init[: len(self._warm_gammas)] = self._warm_gammas
        result = compute_ratings_from_comparisons(
            n, arrays, games_played[:n], 0, PlackettLuceConfig(), init_gammas=init
        )
        # Warm-start from the solver's RAW centered gammas. Reported
        # ratings are not invertible back to gammas: a zero-game player
        # reports the anchor placeholder (1000), and reconstructing from
        # that would hand it elo_to_gamma(1000) ≈ -2.88 as its next init
        # — which sticks forever if its only games are draws (zero
        # comparisons -> the MM "keep current" branch), reporting ~500
        # Elo below the reference's from-zero trajectory.
        #
        # Guard against the epsilon-freeze pathology: a player the MM
        # can't place finitely (never won, or never lost, any comparison
        # — realistic when one checkpoint sweeps another early in
        # training) runs off until comparison denominators underflow
        # epsilon (|gamma| ≈ ln(weight/eps) ≈ 25), where updates freeze
        # and the solve reports "converged". That frozen point is
        # init-dependent, so warm-starting from it breaks parity with
        # the reference's always-from-zero solve (observed: 4000+ Elo on
        # the WINNING player via centering drag). Healthy competitive
        # pools stay within single-digit |gamma| (Elo 1000->3000 is a
        # spread of ~11.5 total), so 15 cleanly separates the regimes.
        self._warm_gammas = (
            np.asarray(result.gammas)
            if (
                result.stats.converged
                and result.gammas is not None
                and bool(np.all(np.abs(result.gammas) < 15.0))
            )
            else None
        )
        raw = [r.rating for r in result.ratings]
        first = self.first_checkpoint_idx or 0
        shift = 1000.0 - raw[first]
        adjusted = [r + shift for r in raw]
        self._cached_ratings = adjusted

        best_idx = max(range(n), key=lambda i: adjusted[i])
        current_idx = max(n - 2, 0)
        return RatingSnapshot(
            current_elo=adjusted[current_idx],
            best_elo=adjusted[best_idx],
            best_step=self.idx_to_step[best_idx],
            total_games=self.num_games,
            computation_time_ms=result.stats.computation_time_ms,
        )

    # ------------------------------------------------------------------
    def generate_graph(self, output_path: str | Path) -> bool:
        """Elo-over-steps PNG (reference uses plotters; we use matplotlib
        if available, silently skipping otherwise)."""
        if self._cached_ratings is None:
            self.compute()
        if not self._cached_ratings:
            return False
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            return False
        pairs = sorted(zip(self.idx_to_step, self._cached_ratings))
        steps = [p[0] for p in pairs]
        elos = [p[1] for p in pairs]
        fig, ax = plt.subplots(figsize=(8, 5))
        ax.plot(steps, elos, marker="o", ms=3)
        ax.set_xlabel("training step")
        ax.set_ylabel("Elo (PL, first checkpoint = 1000)")
        ax.set_title("Self-play rating over training")
        ax.grid(alpha=0.3)
        fig.tight_layout()
        fig.savefig(output_path, dpi=110)
        plt.close(fig)
        return True

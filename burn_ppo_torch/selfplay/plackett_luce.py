"""Plackett-Luce maximum-likelihood skill ratings.

Behavioral parity with the reference rating engine
(src/plackett_luce.rs): multi-player placements expand into weighted
winner-vs-losers comparisons with fractional tie weights
(plackett_luce.rs:195-254); gammas fit by the MM algorithm with
per-iteration centering (271-316, 437-535); uncertainties from the
reduced Fisher information (anchor excluded) inverted with partial-pivot
Gaussian elimination (320-425); Elo scale 400/ln10 with the anchor player
pinned to anchor_elo and CI inflation 1.3 (102-146, 540-607).

A copy of the NumPy path of burn_ppo_tpu/selfplay/plackett_luce.py: the
MM loop, the Hessian, the anchor and the CI. The JAX package's C++ fast
path (native/plackett_luce.cpp) is not carried over yet (ROADMAP A12d);
rating computation is a small host-side problem (dozens of players).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

ELO_SCALE = 400.0 / np.log(10.0)  # ~173.72


def gamma_to_elo(gamma: float) -> float:
    return 1500.0 + ELO_SCALE * gamma


def elo_to_gamma(elo: float) -> float:
    return (elo - 1500.0) / ELO_SCALE


@dataclass(frozen=True)
class GameResult:
    players: Tuple[int, ...]  # global player indices
    placements: Tuple[int, ...]  # 1-indexed, ties share

    def __post_init__(self):
        assert len(self.players) == len(self.placements)

    @staticmethod
    def of(players: Sequence[int], placements: Sequence[int]) -> "GameResult":
        return GameResult(tuple(players), tuple(placements))


@dataclass
class PlayerRating:
    rating: float = 1000.0
    uncertainty: float = 350.0

    def confidence_interval(self) -> Tuple[float, float]:
        return (self.rating - 2 * self.uncertainty, self.rating + 2 * self.uncertainty)


@dataclass
class RatingStats:
    converged: bool = True
    iterations_used: int = 0
    final_delta: float = 0.0
    computation_time_ms: float = 0.0


@dataclass
class RatingResult:
    ratings: List[PlayerRating]
    stats: RatingStats
    # Raw centered MM gammas — the correct warm start for an incremental
    # re-solve. Reported ratings are NOT invertible back to gammas:
    # zero-game players report the anchor placeholder (rating_history.rs
    # reported-rating semantics), so reconstructing from ratings poisons
    # any player whose games are all draws (it keeps its init forever).
    gammas: Optional[np.ndarray] = None


@dataclass(frozen=True)
class PlackettLuceConfig:
    max_iterations: int = 100
    convergence_threshold: float = 1e-6
    epsilon: float = 1e-10
    anchor_elo: float = 1000.0
    ci_inflation_factor: float = 1.3


@dataclass
class _Comparison:
    winner: int
    losers: List[int]
    weight: float


def expand_games_to_comparisons(games: Sequence[GameResult]) -> List[_Comparison]:
    """Placements -> weighted winner-beats-losers comparisons; ties share
    wins fractionally (plackett_luce.rs:195-254)."""
    comparisons: List[_Comparison] = []
    for game in games:
        if len(game.players) <= 1:
            continue
        groups: Dict[int, List[int]] = {}
        for local, placement in enumerate(game.placements):
            groups.setdefault(placement, []).append(game.players[local])
        sorted_places = sorted(groups)
        for pos, place in enumerate(sorted_places):
            current = groups[place]
            lower: List[int] = []
            for later in sorted_places[pos + 1:]:
                lower.extend(groups[later])
            if not lower:
                continue
            if len(current) == 1:
                comparisons.append(_Comparison(current[0], lower, 1.0))
            else:
                w = 1.0 / len(current)
                for tied in current:
                    comparisons.append(_Comparison(tied, list(lower), w))
    return comparisons


@dataclass(frozen=True)
class ComparisonArrays:
    """Flat array form of a comparison list — the incremental-rating
    cache unit (RatingHistory appends games, so expanded comparisons can
    be cached as chunks and concatenated instead of re-expanding the
    full game log at every checkpoint)."""

    winners: np.ndarray  # i32 [C]
    counts: np.ndarray  # i32 [C] losers per comparison
    losers: np.ndarray  # i32 [sum(counts)] flattened
    weights: np.ndarray  # f64 [C]

    def __len__(self) -> int:
        return len(self.winners)


def comparisons_to_arrays(comparisons: Sequence[_Comparison]) -> ComparisonArrays:
    C = len(comparisons)
    winners = np.fromiter((c.winner for c in comparisons), np.int32, count=C)
    counts = np.fromiter(
        (len(c.losers) for c in comparisons), np.int32, count=C
    )
    losers = np.fromiter(
        (p for c in comparisons for p in c.losers), np.int32,
        count=int(counts.sum()),
    )
    weights = np.fromiter((c.weight for c in comparisons), np.float64, count=C)
    return ComparisonArrays(winners, counts, losers, weights)


def arrays_to_comparisons(arrays: ComparisonArrays) -> List[_Comparison]:
    offsets = np.concatenate([[0], np.cumsum(arrays.counts)])
    return [
        _Comparison(
            int(arrays.winners[i]),
            arrays.losers[offsets[i] : offsets[i + 1]].tolist(),
            float(arrays.weights[i]),
        )
        for i in range(len(arrays))
    ]


def concat_comparison_arrays(
    chunks: Sequence[ComparisonArrays],
) -> ComparisonArrays:
    if len(chunks) == 1:
        return chunks[0]
    return ComparisonArrays(
        np.concatenate([c.winners for c in chunks]) if chunks else np.zeros(0, np.int32),
        np.concatenate([c.counts for c in chunks]) if chunks else np.zeros(0, np.int32),
        np.concatenate([c.losers for c in chunks]) if chunks else np.zeros(0, np.int32),
        np.concatenate([c.weights for c in chunks]) if chunks else np.zeros(0, np.float64),
    )


def aggregate_comparison_arrays(arrays: ComparisonArrays) -> ComparisonArrays:
    """Merge identical comparisons by summing weights.

    The PL likelihood is a product over comparisons, so two comparisons
    with the same winner and the same loser MULTISET are mathematically
    one comparison of summed weight — every term the MM update and the
    Fisher information read (wins[winner] += w, denom[p] += w/sum_exp,
    w * (diag(p) - p p^T)) is linear in the weight. Aggregating bounds
    rating-history memory by the number of DISTINCT matchups (≤ a few
    thousand for a pool of checkpoints) instead of the number of games
    played (millions over a long run, rating_history.rs recomputes from
    the full log every checkpoint). Loser order within a comparison is
    canonicalized (sorted) — the math never reads it.

    Fully vectorized: rows are grouped by loser count, losers sorted
    within each row via one lexsort, then np.unique over [winner, losers]
    key rows with bincount-summed weights. Deterministic output order
    (ascending count, then lexicographic key)."""
    C = len(arrays)
    if C == 0:
        return arrays
    row_ids = np.repeat(np.arange(C, dtype=np.int64), arrays.counts)
    # Sort losers within each row: stable sort by (row, loser value).
    order = np.lexsort((arrays.losers, row_ids))
    sorted_losers = arrays.losers[order]
    offsets = np.concatenate([[0], np.cumsum(arrays.counts)])

    out_w, out_c, out_l, out_wt = [], [], [], []
    for c in np.unique(arrays.counts):
        rows = np.nonzero(arrays.counts == c)[0]
        c = int(c)
        if c == 0:
            # Degenerate (never produced by expand_games_to_comparisons);
            # merge by winner alone.
            uniq, inv = np.unique(arrays.winners[rows], return_inverse=True)
            out_w.append(uniq.astype(np.int32))
            out_c.append(np.zeros(len(uniq), np.int32))
            out_l.append(np.zeros(0, np.int32))
            out_wt.append(np.bincount(inv, weights=arrays.weights[rows]))
            continue
        gather = offsets[rows][:, None] + np.arange(c)[None, :]
        keys = np.concatenate(
            [arrays.winners[rows][:, None], sorted_losers.take(gather.ravel()).reshape(-1, c)],
            axis=1,
        )
        uniq, inv = np.unique(keys, axis=0, return_inverse=True)
        out_w.append(uniq[:, 0].astype(np.int32))
        out_c.append(np.full(len(uniq), c, np.int32))
        out_l.append(uniq[:, 1:].astype(np.int32).ravel())
        out_wt.append(np.bincount(inv.ravel(), weights=arrays.weights[rows]))
    return ComparisonArrays(
        np.concatenate(out_w),
        np.concatenate(out_c),
        np.concatenate(out_l),
        np.concatenate(out_wt),
    )


def _mm_update(
    comparisons: List[_Comparison], gammas: np.ndarray, epsilon: float
) -> np.ndarray:
    n = len(gammas)
    wins = np.zeros(n)
    denom = np.zeros(n)
    exp_g = np.exp(gammas)
    for comp in comparisons:
        wins[comp.winner] += comp.weight
        participants = [comp.winner] + comp.losers
        sum_exp = float(exp_g[participants].sum())
        if sum_exp > epsilon:
            contribution = comp.weight / sum_exp
            for p in participants:
                denom[p] += contribution
    new = np.array(gammas)
    for i in range(n):
        if wins[i] > epsilon and denom[i] > epsilon:
            new[i] = np.log(wins[i] / denom[i])
        elif denom[i] > epsilon:
            new[i] = gammas[i] - 1.0  # participated, never won
        # else: keep current
    return new


def _compute_hessian(
    comparisons: List[_Comparison], gammas: np.ndarray
) -> np.ndarray:
    n = len(gammas)
    hess = np.zeros((n, n))
    for comp in comparisons:
        participants = np.array([comp.winner] + comp.losers)
        g = gammas[participants]
        e = np.exp(g - g.max())
        probs = e / e.sum()
        outer = np.outer(probs, probs)
        local = comp.weight * (np.diag(probs) - outer)
        hess[np.ix_(participants, participants)] += local
    return hess


def _invert(matrix: np.ndarray, epsilon: float) -> np.ndarray:
    """Partial-pivot inversion with a high-variance fallback for singular
    matrices (plackett_luce.rs:361-425)."""
    n = matrix.shape[0]
    if n == 0:
        return matrix
    aug = np.hstack([matrix.astype(np.float64), np.eye(n)])
    for col in range(n):
        pivot_row = col + int(np.argmax(np.abs(aug[col:, col])))
        aug[[col, pivot_row]] = aug[[pivot_row, col]]
        if abs(aug[col, col]) < epsilon:
            return np.eye(n) * 100.0  # near-singular: high-variance fallback
        aug[col] /= aug[col, col]
        for row in range(n):
            if row != col:
                aug[row] -= aug[row, col] * aug[col]
    return aug[:, n:]


def compute_ratings(
    num_players: int,
    games: Sequence[GameResult],
    anchor_player_idx: int,
    config: PlackettLuceConfig = PlackettLuceConfig(),
) -> RatingResult:
    games = list(games)
    games_played = np.zeros(num_players, dtype=np.int64)
    for g in games:
        for p in g.players:
            if p < num_players:
                games_played[p] += 1
    comparisons = expand_games_to_comparisons(games) if games else []
    return compute_ratings_from_comparisons(
        num_players, comparisons, games_played, anchor_player_idx, config
    )


def compute_ratings_from_comparisons(
    num_players: int,
    comparisons,  # List[_Comparison] | ComparisonArrays
    games_played: np.ndarray,
    anchor_player_idx: int,
    config: PlackettLuceConfig = PlackettLuceConfig(),
    init_gammas: Optional[np.ndarray] = None,
) -> RatingResult:
    """Rate from pre-expanded comparisons (list or flat-array form).

    This is the incremental-rating entry: RatingHistory caches expanded
    comparisons across checkpoints (the game log is append-only) and
    passes ComparisonArrays, skipping the per-checkpoint re-expansion of
    the full log.

    ``init_gammas`` warm-starts the MM iteration. The PL MLE (centered)
    is the unique fixed point, so a warm start converges to the same
    ratings within convergence_threshold — callers should only pass it
    when the PREVIOUS solve converged (a non-converged solve means a
    participated-never-won player is running off to -inf, where the
    reference's from-zero trajectory is the defined behavior)."""
    t0 = time.perf_counter()

    def _done(ratings, converged=True, iters=0, delta=0.0, gammas=None):
        return RatingResult(
            ratings,
            RatingStats(
                converged=converged,
                iterations_used=iters,
                final_delta=delta,
                computation_time_ms=(time.perf_counter() - t0) * 1000.0,
            ),
            gammas=gammas,
        )

    if num_players == 0:
        return _done([], gammas=np.zeros(0))
    if len(comparisons) == 0:
        return _done(
            [PlayerRating(config.anchor_elo, 350.0) for _ in range(num_players)],
            gammas=np.zeros(num_players),
        )

    if isinstance(comparisons, ComparisonArrays):
        comparisons = arrays_to_comparisons(comparisons)

    gammas = np.zeros(num_players)
    if init_gammas is not None and len(init_gammas) == num_players:
        gammas = np.where(
            np.isfinite(init_gammas), np.asarray(init_gammas, np.float64), 0.0
        )
    converged, iters, delta = False, 0, float("inf")
    for it in range(config.max_iterations):
        iters = it + 1
        new = _mm_update(comparisons, gammas, config.epsilon)
        new -= new.mean()  # center to prevent drift
        delta = float(np.max(np.abs(new - gammas)))
        gammas = new
        if delta < config.convergence_threshold:
            converged = True
            break
        if not np.all(np.isfinite(gammas)):
            gammas = np.zeros(num_players)
            break

    anchor = anchor_player_idx
    hess = _compute_hessian(comparisons, gammas)
    active = [i for i in range(num_players) if games_played[i] > 0 and i != anchor]
    reduced = hess[np.ix_(active, active)] + np.eye(len(active)) * 1e-6
    cov = _invert(reduced, config.epsilon)

    uncertainties = np.full(num_players, 2.0)
    uncertainties[anchor] = 0.0
    for ri, orig in enumerate(active):
        if cov[ri, ri] > 0:
            uncertainties[orig] = np.sqrt(cov[ri, ri])

    shift = elo_to_gamma(config.anchor_elo) - gammas[anchor]
    ratings = []
    for i in range(num_players):
        if games_played[i] > 0:
            ratings.append(
                PlayerRating(
                    rating=gamma_to_elo(gammas[i] + shift),
                    uncertainty=ELO_SCALE * uncertainties[i] * config.ci_inflation_factor,
                )
            )
        else:
            ratings.append(PlayerRating(config.anchor_elo, 350.0))
    return _done(ratings, converged, iters, delta, gammas=gammas)


def print_rating_guide() -> None:
    print()
    print("Rating Guide (Plackett-Luce / Elo scale):")
    print("  Win probability: +100 pts -> 64% | +200 -> 76% | +400 -> 91% | +800 -> 99%")
    print("  Uncertainty (sigma): high = few games, may shift. Low = stable rating.")
    print("  Comparing: if 95% CIs (rating +/- 2*sigma) overlap, difference may not be significant.")
    print("  Lowest-rated player anchored at 1000.")

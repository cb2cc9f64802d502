"""Tournament: Swiss / round-robin across checkpoints with Plackett-Luce ratings.

Counterpart of burn_ppo_tpu/tournament.py (the reference's ``tournament``
subcommand, src/tournament.rs), function by function:
  * contestant discovery from checkpoint paths or run directories with
    best / latest / evenly-spaced selection and --limit-per-run
    (tournament.rs:239-430), display names with the common prefix stripped
    and common middles collapsed (440-558);
  * the format: Swiss when C(n, players) > 50 matchups, else round robin
    (2024-2035);
  * Swiss: Dutch pairing within score brackets, floaters carried down, a
    greedy swap against repeat opponents, byes worth a match win for the
    lowest-ranked contestants without one (771-910, 2085-2117);
    match-level Swiss points with fractional tie ranking (715-751,
    929-1010);
  * final ratings over all games, anchored at "Random" or the lowest step
    (1035-1055); the results JSON and the rating and points graphs
    (1285-1693), which need matplotlib (without it they return False).

Each pod is played by eval's stats engine (``eval.run_stats_mode``) on
the device the contestants were loaded on; its JSON entry in ``pods``
also says how the engine computed the logits (``"logits"``:
``ActingLogits.path``). Pods of one shape (``eval.engine_key``: env,
envs, logits path, architectures, schedule) share one engine
(``eval.EngineCache``): its buffers take each pod's models and seed, and
on a card its chunk's CUDA graph, captured once, replays for all of them.
The pods' seeds come from ``random.Random(seed)`` as in the JAX package.
"""

from __future__ import annotations

import itertools
import json
import math
import random
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Set, Tuple

import torch

from burn_ppo_torch.checkpoint import load_metadata
from burn_ppo_torch.envs import make_env
from burn_ppo_torch.eval import EngineCache, PlayerSource, TempSchedule, run_stats_mode
from burn_ppo_torch.selfplay.plackett_luce import (
    GameResult,
    PlackettLuceConfig,
    compute_ratings as pl_compute_ratings,
    print_rating_guide,
)


# ---------------------------------------------------------------------------
# Discovery helpers (tournament.rs:239-430)
# ---------------------------------------------------------------------------
def is_checkpoint_dir(path: Path) -> bool:
    return path.is_dir() and (path / "metadata.json").exists()


def is_run_dir(path: Path) -> bool:
    return path.is_dir() and (path / "checkpoints").is_dir()


def enumerate_checkpoints(ckpt_dir: Path) -> List[Path]:
    out = [
        p
        for p in ckpt_dir.iterdir()
        if p.name.startswith("step_") and p.name[5:].isdigit() and p.is_dir()
    ]
    return sorted(out, key=lambda p: int(p.name[5:]))


def select_evenly_spaced(checkpoints: Sequence[Path], n: int) -> List[Path]:
    """Interior positions k/(n+1) (tournament.rs:297-318)."""
    if n >= len(checkpoints):
        return list(checkpoints)
    if n == 0:
        return []
    length = len(checkpoints)
    return [checkpoints[min(length * k // (n + 1), length - 1)] for k in range(1, n + 1)]


def get_best_checkpoint(ckpt_dir: Path) -> Optional[Path]:
    best = ckpt_dir / "best"
    if best.exists() and is_checkpoint_dir(best.resolve()):
        return best.resolve()
    checkpoints = enumerate_checkpoints(ckpt_dir)
    if not checkpoints:
        return None
    meta = load_metadata(checkpoints[0])
    if meta.get("num_players", 1) > 1:
        return checkpoints[-1].resolve()  # latest (avg_return meaningless)
    return max(
        checkpoints,
        key=lambda p: load_metadata(p).get("avg_return", 0.0),
    ).resolve()


def select_checkpoints_with_priority(
    ckpt_dir: Path, checkpoints: Sequence[Path], limit: int
) -> List[Path]:
    """best > latest > evenly spaced (tournament.rs:383-430)."""
    if limit == 0 or not checkpoints:
        return []
    # Compare RESOLVED paths throughout: get_best_checkpoint resolves the
    # best symlink, while enumerate_checkpoints yields caller-relative
    # paths — mixing the two would select best==latest twice, and the
    # later contestant dedup would silently shrink the field below limit.
    checkpoints = [c.resolve() for c in checkpoints]
    best = get_best_checkpoint(ckpt_dir)
    latest = checkpoints[-1]
    if limit == 1:
        return [best or latest]
    result: List[Path] = []
    seen: Set[Path] = set()
    for cand in (best, latest):
        if cand is not None and cand not in seen:
            result.append(cand)
            seen.add(cand)
    remaining = [c for c in checkpoints if c not in seen]
    result.extend(select_evenly_spaced(remaining, max(limit - len(result), 0)))
    return result


# ---------------------------------------------------------------------------
# Display names (tournament.rs:440-558)
# ---------------------------------------------------------------------------
def compute_display_names(paths: Sequence[Path]) -> List[str]:
    if not paths:
        return []
    if len(paths) == 1:
        return [paths[0].name]
    components = [list(p.parts) for p in paths]
    min_len = min(len(c) for c in components)
    max_prefix = max(min_len - 1, 0)  # never strip the filename
    prefix_len = 0
    for i in range(max_prefix):
        if all(c[i] == components[0][i] for c in components):
            prefix_len = i + 1
        else:
            break
    stripped = [c[prefix_len:] for c in components]

    # Common middle offsets (from the end; last component excluded)
    min_len2 = min(len(c) for c in stripped)
    common_offsets = set()
    for off in range(2, min_len2 + 1):
        first = stripped[0][len(stripped[0]) - off]
        if all(c[len(c) - off] == first for c in stripped):
            common_offsets.add(off)

    names = []
    for comps in stripped:
        out, in_run = [], False
        for i, comp in enumerate(comps):
            off = len(comps) - i
            if off in common_offsets:
                if not in_run:
                    out.append("...")
                    in_run = True
            else:
                out.append(comp)
                in_run = False
        names.append("/".join(out))
    return names


# ---------------------------------------------------------------------------
# Contestants
# ---------------------------------------------------------------------------
@dataclass
class Contestant:
    name: str
    source: PlayerSource
    path: Optional[Path] = None
    step: int = 0
    initial_seed: float = 0.0
    swiss_points: float = 0.0
    games_played: int = 0
    draw_count: int = 0
    placement_counts: List[int] = field(default_factory=list)
    opponents_faced: Set[int] = field(default_factory=set)
    has_bye: bool = False


def discover_contestants(
    sources: Sequence[str | Path],
    limit_per_run: Optional[int] = None,
    include_random: bool = False,
    shuffle_seed: Optional[int] = None,
    device: str | torch.device = "cuda",
) -> List[Contestant]:
    """Resolve paths to checkpoints, build contestants with display names
    and initial seeding (tournament.rs:560-700).

    Seeding follows the reference exactly: training ``avg_return`` seeds
    only a SINGLE-training-run tournament (one source that is a run or
    checkpoints dir, tournament.rs:563-578, 607-640); with multiple
    sources the field ratings are incomparable, so contestants shuffle
    (``shuffle_seed`` -> deterministic; the reference uses entropy) and
    take their shuffled position as the seed (681-699). Random always
    seeds lowest (-inf)."""
    src_paths = [Path(s) for s in sources]
    single_training_run = len(src_paths) == 1 and not is_checkpoint_dir(
        src_paths[0]
    )
    paths: List[Path] = []
    for src in sources:
        p = Path(src)
        if is_checkpoint_dir(p):
            paths.append(p.resolve())
        elif is_run_dir(p) or (p / "metadata.json").exists():
            ckpt_dir = p / "checkpoints" if is_run_dir(p) else p
            checkpoints = enumerate_checkpoints(ckpt_dir)
            limit = limit_per_run if limit_per_run is not None else len(checkpoints)
            paths.extend(
                select_checkpoints_with_priority(ckpt_dir, checkpoints, limit)
            )
        elif p.is_dir() and any(c.name.startswith("step_") for c in p.iterdir()):
            checkpoints = enumerate_checkpoints(p)
            limit = limit_per_run if limit_per_run is not None else len(checkpoints)
            paths.extend(select_checkpoints_with_priority(p, checkpoints, limit))
        else:
            raise FileNotFoundError(f"Not a checkpoint or run directory: {src}")

    # Dedup preserving order
    seen: Set[Path] = set()
    unique = []
    for p in paths:
        rp = p.resolve()
        if rp not in seen:
            seen.add(rp)
            unique.append(rp)

    names = compute_display_names(unique)
    contestants = []
    for path, name in zip(unique, names):
        meta = load_metadata(path)
        if single_training_run:
            ar = meta.get("avg_return")
            # 25.0 = the reference's fallback when metadata is unreadable.
            seed_val = float(ar) if ar is not None else 25.0
        else:
            seed_val = 0.0
        contestants.append(
            Contestant(
                name=name,
                source=PlayerSource.checkpoint(path, device),
                path=path,
                step=int(meta.get("step", 0)),
                initial_seed=seed_val,
            )
        )
    if include_random:
        contestants.append(
            Contestant(
                name="Random",
                source=PlayerSource.random(),
                initial_seed=float("-inf"),
            )
        )
    if not single_training_run and len(contestants) > 1:
        rng = random.Random(shuffle_seed)
        if include_random:
            body = contestants[:-1]  # keep Random at the end
            rng.shuffle(body)
            contestants = body + contestants[-1:]
        else:
            rng.shuffle(contestants)
        for i, c in enumerate(contestants):
            if c.source.kind != "random":
                c.initial_seed = float(i)
    return contestants


# ---------------------------------------------------------------------------
# Swiss machinery (tournament.rs:715-910)
# ---------------------------------------------------------------------------
def calculate_swiss_points(placements: Sequence[int]) -> List[float]:
    """points = N - avg_position with fractional tie ranking."""
    n = len(placements)
    if n == 0:
        return []
    counts: Dict[int, int] = {}
    for p in placements:
        counts[p] = counts.get(p, 0) + 1
    avg_pos: Dict[int, float] = {}
    pos = 1
    for p in sorted(counts):
        c = counts[p]
        avg_pos[p] = (pos + (pos + c - 1)) / 2.0
        pos += c
    return [n - avg_pos[p] for p in placements]


def _has_repeat(pod: Sequence[int], contestants: Sequence[Contestant]) -> bool:
    return any(
        pod[j] in contestants[pod[i]].opponents_faced
        for i in range(len(pod))
        for j in range(i + 1, len(pod))
    )


def form_dutch_pods_with_floaters(
    ranked: Sequence[int], pod_size: int, contestants: Sequence[Contestant]
) -> Tuple[List[List[int]], List[int]]:
    """Pod i takes ranked[i + g*num_pods] for each tier g; greedy swap in
    the last tier to avoid repeat opponents (tournament.rs:836-910)."""
    ranked = list(ranked)
    if len(ranked) < pod_size:
        return [], ranked
    num_pods = len(ranked) // pod_size
    pods = []
    for pod_idx in range(num_pods):
        pod = [
            ranked[pod_idx + g * num_pods]
            for g in range(pod_size)
            if pod_idx + g * num_pods < len(ranked)
        ]
        if len(pod) == pod_size and _has_repeat(pod, contestants):
            last_start = (pod_size - 1) * num_pods
            cur = pod_idx + last_start
            for off in range(1, num_pods - pod_idx):
                swap = cur + off
                if swap < len(ranked):
                    test = pod[:-1] + [ranked[swap]]
                    if not _has_repeat(test, contestants):
                        ranked[cur], ranked[swap] = ranked[swap], ranked[cur]
                        pod = test
                        break
        if len(pod) == pod_size:
            pods.append(pod)
    return pods, ranked[num_pods * pod_size:]


def swiss_pods(
    contestants: Sequence[Contestant],
    pod_size: int,
    indices: Optional[Sequence[int]] = None,
) -> List[List[int]]:
    """Swiss pairing over ``indices`` (default: all contestants).

    Returned pods hold indices INTO ``contestants`` — the same space
    ``opponents_faced`` records — so repeat-opponent avoidance works when
    pairing a bye-reduced subset. (The reference clones the subset and
    pairs with subset-local indices, tournament.rs:2123-2136, so its
    repeat check at :756 compares local against global indices and the
    swap machinery operates on garbage whenever byes exist; deliberate
    divergence.)"""
    idxs = list(range(len(contestants))) if indices is None else list(indices)
    if len(idxs) < pod_size:
        return []
    is_round_1 = all(contestants[i].swiss_points == 0.0 for i in idxs)
    if is_round_1:
        ranked = sorted(
            idxs,
            key=lambda i: -contestants[i].initial_seed,
        )
        pods, _ = form_dutch_pods_with_floaters(ranked, pod_size, contestants)
        return pods

    ranked = sorted(
        idxs,
        key=lambda i: (-contestants[i].swiss_points, -contestants[i].initial_seed),
    )
    # Score brackets
    brackets: List[List[int]] = []
    cur_score = None
    for idx in ranked:
        pts = contestants[idx].swiss_points
        if cur_score is None or abs(pts - cur_score) > 1e-3:
            brackets.append([])
            cur_score = pts
        brackets[-1].append(idx)

    all_pods: List[List[int]] = []
    floaters: List[int] = []
    for bracket in brackets:
        pool = floaters + bracket
        floaters = []
        pods, floaters = form_dutch_pods_with_floaters(pool, pod_size, contestants)
        all_pods.extend(pods)
    return all_pods


def round_robin_pods(n: int, pod_size: int) -> List[List[int]]:
    return [list(c) for c in itertools.combinations(range(n), pod_size)]


def update_stats_from_games(
    contestants: List[Contestant],
    pod: Sequence[int],
    games: Sequence[Sequence[int]],  # per game: placements aligned to pod order
) -> None:
    """Match-level Swiss scoring (tournament.rs:929-1010)."""
    if not games:
        return
    n = len(pod)
    raw = [0.0] * n
    for placements in games:
        is_draw = all(p == placements[0] for p in placements)
        for i, ci in enumerate(pod):
            c = contestants[ci]
            if len(c.placement_counts) < n:
                c.placement_counts.extend([0] * (n - len(c.placement_counts)))
            p = placements[i]
            if 1 <= p <= n:
                c.placement_counts[p - 1] += 1
            if is_draw:
                c.draw_count += 1
            c.games_played += 1
        for i, pts in enumerate(calculate_swiss_points(placements)):
            raw[i] += pts

    order = sorted(range(n), key=lambda i: -raw[i])
    match_placements = [0] * n
    pos = 1
    i = 0
    while i < n:
        j = i
        while j < n and abs(raw[order[j]] - raw[order[i]]) < 1e-12:
            j += 1
        for k in range(i, j):
            match_placements[order[k]] = pos
        pos = j + 1
        i = j
    for i, pts in enumerate(calculate_swiss_points(match_placements)):
        contestants[pod[i]].swiss_points += pts
    for ci in pod:
        contestants[ci].opponents_faced.update(x for x in pod if x != ci)


def find_anchor_index(contestants: Sequence[Contestant]) -> int:
    for i, c in enumerate(contestants):
        if c.name == "Random":
            return i
    steps = [
        (i, c.step) for i, c in enumerate(contestants) if c.path is not None
    ]
    if steps:
        return min(steps, key=lambda t: t[1])[0]
    return max(len(contestants) - 1, 0)


# ---------------------------------------------------------------------------
# Tournament runner
# ---------------------------------------------------------------------------
def run_tournament(
    sources: Sequence[str | Path],
    *,
    num_games: int = 100,
    num_envs: int = 64,
    rounds: Optional[int] = None,
    limit_per_run: Optional[int] = None,
    include_random: bool = False,
    players: Optional[int] = None,
    force_round_robin: bool = False,
    temp: Optional[float] = None,
    temp_final: Optional[float] = None,
    temp_cutoff: Optional[int] = None,
    no_temp_cutoff: bool = False,
    seed: Optional[int] = None,
    output: Optional[str | Path] = None,
    graph: bool = False,
    quiet: bool = False,
    device: str | torch.device = "cuda",
) -> Dict:
    contestants = discover_contestants(
        sources, limit_per_run=limit_per_run, include_random=include_random,
        shuffle_seed=seed, device=device,
    )
    if len(contestants) < 2:
        raise ValueError("Tournament needs at least 2 contestants")

    # Environment from first checkpoint metadata (tournament.rs:1946-1956)
    first = next(c for c in contestants if c.path is not None)
    meta = load_metadata(first.path)
    # Reject mixed-environment fields up front: a Skull checkpoint in a
    # Connect Four tournament would otherwise die mid-run on a shape
    # mismatch (or rate garbage if the widths coincide).
    for c in contestants:
        if c.path is None:
            continue
        c_env = load_metadata(c.path).get("env_name")
        if c_env != meta["env_name"]:
            raise ValueError(
                f"mixed environments in tournament field: {first.path} is "
                f"{meta['env_name']} but {c.path} is {c_env}"
            )
    env = make_env(meta["env_name"])
    if env.spec.variable_player_count:
        if players is None:
            raise ValueError(
                f"{meta['env_name']} has variable player count; pass --players N"
            )
        env = env.with_num_players(players)
    pod_size = env.spec.num_players

    n = len(contestants)
    matchups = math.comb(n, pod_size) if n >= pod_size else 0
    use_swiss = matchups > 50 and not force_round_robin
    if use_swiss:
        num_rounds = rounds if rounds is not None else int(math.ceil(math.log2(n))) + 1
    else:
        num_rounds = 1

    class _TempArgs:
        pass

    targs = _TempArgs()
    targs.temp = temp
    targs.temp_final = temp_final
    targs.temp_cutoff = temp_cutoff
    targs.no_temp_cutoff = no_temp_cutoff
    targs.temp_decay = False
    temp_schedule = TempSchedule.from_args(env, targs)

    if not quiet:
        fmt = "Swiss" if use_swiss else "Round-Robin"
        print(f"Tournament: {n} contestants, {fmt} ({num_rounds} round(s)), "
              f"{pod_size}-player {meta['env_name']}, {temp_schedule.describe()}")

    rng = random.Random(seed)
    all_games: List[GameResult] = []
    pods_log = []
    engines = EngineCache()

    def run_pod(pod: List[int], round_idx: int) -> None:
        pod_sources = [contestants[ci].source for ci in pod]
        stats = run_stats_mode(
            env,
            pod_sources,
            num_games=num_games,
            num_envs=min(num_envs, max(num_games, 1)),
            temp=temp_schedule,
            seed=rng.randrange(2**31),
            quiet=True,
            device=device,
            engines=engines,
        )
        # Map per-game records (source-in-pod, placement) to pod order.
        games = []
        for rec in stats.game_records:
            placements_by_source = {}
            for src_idx, place in rec:
                placements_by_source.setdefault(src_idx, []).append(place)
            if any(len(v) != 1 for v in placements_by_source.values()):
                # a source occupied multiple seats (shouldn't happen: S == P)
                continue
            games.append(
                [placements_by_source[i][0] for i in range(len(pod))]
            )
            all_games.append(
                GameResult.of(list(pod), games[-1])
            )
        update_stats_from_games(contestants, pod, games)
        pods_log.append(
            {
                "round": round_idx,
                "contestants": [contestants[ci].name for ci in pod],
                "games": len(games),
                "logits": stats.logits_path,
            }
        )

    points_history: List[List[float]] = [[0.0] * n]  # per-round snapshots
    for round_idx in range(1, num_rounds + 1):
        if use_swiss:
            # Byes (tournament.rs:2085-2117): points are awarded BEFORE
            # pairing, and recipients sit the round out — pods form from
            # the active (non-bye) contestants only (active_indices in
            # the reference), which also keeps round-1 detection intact
            # (the excluded bye recipient holds the only nonzero score).
            num_byes = n % pod_size
            bye_recipients: List[int] = []
            if num_byes > 0:
                candidates = sorted(
                    (i for i in range(n) if not contestants[i].has_bye),
                    key=lambda i: (
                        contestants[i].swiss_points,
                        contestants[i].initial_seed,
                    ),
                )
                for bye_idx in candidates[:num_byes]:
                    contestants[bye_idx].swiss_points += float(pod_size - 1)
                    contestants[bye_idx].has_bye = True
                    bye_recipients.append(bye_idx)
                    if not quiet:
                        print(f"  {contestants[bye_idx].name} receives bye "
                              f"(+{pod_size - 1:.1f} points)")
            # When every active contestant already had a bye, fewer byes
            # than n % pod_size are awarded and the unpaired leftovers
            # sit the round out unscored — reference parity
            # (tournament.rs:2093-2119 take()s only never-bye'd
            # candidates; its swiss_pods drops terminal floaters).
            active = [i for i in range(n) if i not in bye_recipients]
            pods = swiss_pods(contestants, pod_size, indices=active)
            if not pods and not bye_recipients:
                if not quiet:
                    print("  No pods possible")
                break
        else:
            pods = round_robin_pods(n, pod_size)
        if not quiet:
            print(f"Round {round_idx}: {len(pods)} pods")
        for pod in pods:
            run_pod(pod, round_idx)
        points_history.append([c.swiss_points for c in contestants])

    # Final ratings over ALL games (tournament.rs:1035)
    anchor = find_anchor_index(contestants)
    result = pl_compute_ratings(n, all_games, anchor, PlackettLuceConfig())

    # Reference tiebreaker for equal Swiss points: initial_seed
    # (tournament.rs:1704-1715), not rating.
    standings = sorted(
        range(n),
        key=lambda i: (
            -contestants[i].swiss_points,
            -contestants[i].initial_seed,
        ),
    )
    # RankingEntry field names match the reference's serialized schema
    # (tournament.rs:186-201, build_results 1695-1740) so consumers of
    # the reference's JSON find the same keys; "step"/"games" are extras.
    rows = []
    for rank, i in enumerate(standings, 1):
        c = contestants[i]
        r = result.ratings[i]
        rows.append(
            {
                "rank": rank,
                "name": c.name,
                # reference omits the key for non-checkpoint sources
                # (serde skip_serializing_if, tournament.rs:189-190)
                **({"source": str(c.path)} if c.path is not None else {}),
                "step": c.step,
                "swiss_points": round(c.swiss_points, 2),
                "games": c.games_played,
                "games_played": c.games_played,
                "rating": round(r.rating, 1),
                "uncertainty": round(r.uncertainty, 1),
                "rating_low": round(r.rating - 2.0 * r.uncertainty, 1),
                "rating_high": round(r.rating + 2.0 * r.uncertainty, 1),
                "placement_counts": c.placement_counts,
                "draw_count": c.draw_count,
            }
        )

    if not quiet:
        print(f"\nStats engines: {engines.built} built, reused for {engines.reused} pods")
        print(f"\nFinal standings ({len(all_games)} games):")
        hdr = f"{'#':>3} {'Contestant':<44} {'Swiss':>7} {'Rating':>8} {'±':>6} {'Games':>6}"
        print(hdr)
        print("-" * len(hdr))
        for row in rows:
            print(
                f"{row['rank']:>3} {row['name']:<44} {row['swiss_points']:>7.2f} "
                f"{row['rating']:>8.1f} {row['uncertainty']:>6.1f} {row['games']:>6}"
            )
        print_rating_guide()

    import datetime

    results = {
        "env": meta["env_name"],
        "environment": meta["env_name"],  # reference key (tournament.rs:223)
        "num_players": pod_size,
        "format": "swiss" if use_swiss else "round_robin",
        "rounds": num_rounds,
        "total_games": len(all_games),
        "rankings": rows,  # reference key (tournament.rs:220)
        "standings": rows,
        "pods": pods_log,
        "converged": result.stats.converged,
        "config": {
            "num_games_per_matchup": num_games,
            "num_rounds": num_rounds,
            "format": "swiss" if use_swiss else "round_robin",
            **({"temp": temp} if temp is not None else {}),
            **({"seed": seed} if seed is not None else {}),
        },
        "timestamp": datetime.datetime.now().isoformat(timespec="seconds"),
    }
    if output:
        Path(output).write_text(json.dumps(results, indent=2))
        if not quiet:
            print(f"Results written to {output}")
    if graph:
        base = Path(output or "tournament")
        _generate_rating_graph(contestants, result, base.with_suffix(".png"))
        _generate_points_graph(
            contestants, points_history,
            base.with_name(base.stem + "_points").with_suffix(".png"),
        )
    return results


def _generate_points_graph(
    contestants, points_history: List[List[float]], out_path: Path
) -> bool:
    """Swiss points per contestant over rounds (tournament.rs:1533)."""
    if len(points_history) < 2:
        return False
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return False
    rounds = list(range(len(points_history)))
    fig, ax = plt.subplots(figsize=(9, 6))
    final = points_history[-1]
    order = sorted(range(len(contestants)), key=lambda i: -final[i])
    for rank, i in enumerate(order):
        series = [snap[i] for snap in points_history]
        label = contestants[i].name if rank < 12 else None
        ax.plot(rounds, series, marker="o", ms=3, label=label)
    ax.set_xlabel("round")
    ax.set_ylabel("Swiss points")
    ax.set_title("Swiss points by round")
    ax.legend(fontsize=7, loc="upper left")
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
    return True


def _generate_rating_graph(contestants, result, out_path: Path) -> bool:
    """Rating vs training step with CI bars (tournament.rs:1285-1533)."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return False
    pts = [
        (c.step, result.ratings[i].rating, result.ratings[i].uncertainty, c.name)
        for i, c in enumerate(contestants)
        if c.path is not None
    ]
    if not pts:
        return False
    pts.sort()
    steps = [p[0] for p in pts]
    ratings = [p[1] for p in pts]
    errs = [2 * p[2] for p in pts]
    fig, ax = plt.subplots(figsize=(9, 5.5))
    ax.errorbar(steps, ratings, yerr=errs, marker="o", ms=4, capsize=3, lw=1.2)
    ax.set_xlabel("training step")
    ax.set_ylabel("PL rating (Elo scale, 95% CI)")
    ax.set_title("Tournament ratings over training")
    ax.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
    return True


def run_tournament_cli(args, device: str | torch.device = "cuda") -> int:
    run_tournament(
        args.sources,
        num_games=args.num_games,
        num_envs=args.num_envs,
        rounds=args.rounds,
        limit_per_run=args.limit_per_run,
        include_random=args.random,
        players=args.players,
        force_round_robin=args.round_robin,
        temp=args.temp,
        temp_final=args.temp_final,
        temp_cutoff=args.temp_cutoff,
        no_temp_cutoff=args.no_temp_cutoff,
        seed=args.seed,
        output=args.output,
        graph=args.graph,
        device=device,
    )
    return 0

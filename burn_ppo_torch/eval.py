"""Evaluation: stats mode, watch mode and human play, on the device.

Counterpart of burn_ppo_tpu/eval.py (the reference's ``eval`` subcommand,
src/eval.rs):
  * ``PlayerSource``: checkpoint, random and human players, checkpoints
    loaded once per path (an LRU cache keyed by the path, the mtime of its
    ``metadata.json`` and the device);
  * ``TempSchedule``: constant, cutoff or decay temperatures by move
    number, with the env's defaults;
  * ``EvalStats``: per-source placements, rewards, draws and Plackett-Luce
    ratings;
  * ``run_stats_mode``: parallel envs, seat permutations rotated between
    games, each env's acting model's logits (``make_acting_logits_fn``),
    the temperature sampler K14 and the env step kernel (K1, K4, K11,
    K13), chunks of 64 steps run eagerly, the host reading each chunk's
    episode records once;
  * ``run_watch_mode`` and ``run_interactive_evaluation``: one env at a
    time, its text rendered, human moves read from the terminal
    (``human.py``).

The JAX engine is one jitted ``lax.scan`` a chunk; here each step is a
handful of launches (ROADMAP B17 would capture a chunk as one CUDA
graph). Randomness comes from a ``ppo/rollout.py RandomSource``: one
``torch.Generator`` on the device, seeded from ``seed``, or in the parity
tests a source replaying JAX's draws. Per step it draws the sampler's
uniforms [E, A], then the env's reset values and its step values.
"""

from __future__ import annotations

import itertools
import math
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, ClassVar, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from burn_ppo_torch.checkpoint import load_metadata, load_model, load_obs_normalizer
from burn_ppo_torch.envs import make_env
from burn_ppo_torch.envs.base import Environment, EpisodeAccumulator, env_row
from burn_ppo_torch.ops.categorical import TINY, sample_with_temperature
from burn_ppo_torch.ppo.normalization import ObsNormState, obs_norm_apply
from burn_ppo_torch.ppo.pool_rollout import (
    OpponentStack,
    actor_params,
    actor_widths,
    opponent_actor_forward,
    opponent_tower_problems,
)
from burn_ppo_torch.ppo.rollout import RandomSource, TorchRandomSource
from burn_ppo_torch.utils import rewards_to_placements

LOAD_CACHE_SIZE = 64


# ---------------------------------------------------------------------------
# Player sources (eval.py:50-102)
# ---------------------------------------------------------------------------
@dataclass
class PlayerSource:
    kind: str  # "checkpoint" | "human" | "random"
    name: str
    path: Optional[Path] = None
    network: Any = None
    obs_norm: Optional[ObsNormState] = None

    # Sources of one checkpoint (self-play seats, tournament rematches)
    # share one network object, so the logits function forwards it once.
    _load_cache: ClassVar["OrderedDict[tuple, tuple]"] = OrderedDict()

    @staticmethod
    def checkpoint(path: str | Path, device: str | torch.device = "cuda") -> "PlayerSource":
        path = Path(path)
        device = torch.device(device)
        # The metadata's mtime is in the key, so that a checkpoint rewritten
        # at the same path is never served stale.
        try:
            mtime = (path / "metadata.json").stat().st_mtime_ns
        except OSError:
            mtime = 0
        key = (str(path.resolve()), mtime, str(device))
        cache = PlayerSource._load_cache
        if key in cache:
            cache.move_to_end(key)
            network, obs_norm = cache[key]
        else:
            network, _meta = load_model(path, device)
            network.requires_grad_(False)
            obs_norm = load_obs_normalizer(path, device)
            cache[key] = (network, obs_norm)
            while len(cache) > LOAD_CACHE_SIZE:
                cache.popitem(last=False)
        # runs/<run>/checkpoints/step_X -> "<run>/step_X"
        name = (f"{path.parent.parent.name}/{path.name}" if path.name.startswith("step_")
                else str(path))
        return PlayerSource(kind="checkpoint", name=name, path=path, network=network,
                            obs_norm=obs_norm)

    @staticmethod
    def random() -> "PlayerSource":
        return PlayerSource(kind="random", name="Random")

    @staticmethod
    def human(name: str) -> "PlayerSource":
        return PlayerSource(kind="human", name=name)


def sources_device(sources: Sequence[PlayerSource], default: str | torch.device = "cuda"
                   ) -> torch.device:
    """The device the checkpoint sources' networks live on (``default``
    when there is none); sources on two devices raise."""
    devices = {next(s.network.parameters()).device for s in sources if s.kind == "checkpoint"}
    if len(devices) > 1:
        raise ValueError(f"player sources on several devices: {sorted(map(str, devices))}")
    return devices.pop() if devices else torch.device(default)


def random_source(seed: Optional[int], device: torch.device) -> RandomSource:
    """One generator on ``device``, seeded from ``seed`` (the clock when
    None, as the JAX package's PRNGKey is)."""
    seed = seed if seed is not None else int(time.time()) % 2**31
    return TorchRandomSource(torch.Generator(device=device).manual_seed(seed))


# ---------------------------------------------------------------------------
# Temperature schedule (eval.py:108-162)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class TempSchedule:
    """Eval-time sampling temperature by move number (eval.rs:76-217)."""

    initial: float
    final_temp: float = 0.0
    cutoff: Optional[int] = None
    decay: bool = False

    @staticmethod
    def from_args(env: Environment, args) -> "TempSchedule":
        if getattr(args, "no_temp_cutoff", False):
            return TempSchedule(initial=args.temp if args.temp is not None else env.spec.eval_temp)
        env_cutoff = env.spec.eval_temp_cutoff
        cutoff = (args.temp_cutoff if args.temp_cutoff is not None
                  else (env_cutoff[0] if env_cutoff else None))
        if cutoff is None:
            if args.temp_final is not None:
                raise ValueError("--temp-final requires --temp-cutoff (or env default)")
            if getattr(args, "temp_decay", False):
                raise ValueError("--temp-decay requires --temp-cutoff (or env default)")
        final = (args.temp_final if args.temp_final is not None
                 else (env_cutoff[1] if env_cutoff else 0.0))
        return TempSchedule(
            initial=args.temp if args.temp is not None else env.spec.eval_temp,
            final_temp=final,
            cutoff=cutoff,
            decay=getattr(args, "temp_decay", False),
        )

    def get_temp(self, move_num) -> torch.Tensor:
        """f32 temperatures of a tensor (or number) of move numbers. The
        decay rounds as XLA compiles it in JAX's jitted engine: ``move /
        cutoff`` a product with the f32 reciprocal, and ``initial + t *
        (final - initial)`` one fused multiply-add (in f64 here, where the
        product of two f32 values is exact, then rounded once to f32)."""
        move = torch.as_tensor(move_num).to(torch.float32)
        if self.cutoff is None:
            return torch.full_like(move, self.initial)
        if self.decay:
            t = torch.clamp(move * (1.0 / self.cutoff), 0.0, 1.0)
            span = float(np.float32(self.final_temp - self.initial))
            ramp = (t.double() * span + float(np.float32(self.initial))).float()
        else:
            ramp = torch.full_like(move, self.initial)
        return torch.where(move >= self.cutoff, torch.full_like(move, self.final_temp), ramp)

    def describe(self) -> str:
        if self.cutoff is None:
            return f"temp={self.initial:.2f} (constant)"
        kind = "decay over" if self.decay else "cutoff at move"
        return f"temp={self.initial:.2f}->{self.final_temp:.2f} ({kind} {self.cutoff})"


def default_temp(env: Environment) -> TempSchedule:
    """The env's own schedule (eval.py:514-516)."""
    spec = env.spec
    return TempSchedule(initial=spec.eval_temp, final_temp=(spec.eval_temp_cutoff or (0, 0.0))[1],
                        cutoff=(spec.eval_temp_cutoff or (None,))[0])


# ---------------------------------------------------------------------------
# Stats accumulation (eval.py:168-346)
# ---------------------------------------------------------------------------
@dataclass
class EvalStats:
    """Per-source aggregates (reference EvalStats, eval.rs:315-718).
    ``logits_path`` is how the engine computed the logits
    (``ActingLogits.path``)."""

    source_names: List[str]
    num_players: int
    placements: List[List[int]] = field(default_factory=list)  # [S][P] counts
    rewards: List[float] = field(default_factory=list)
    games: List[int] = field(default_factory=list)
    outcomes_by_source: List[List[List[int]]] = field(default_factory=list)
    game_records: List[List[Tuple[int, int]]] = field(default_factory=list)
    draws: int = 0
    total_games: int = 0
    logits_path: Optional[str] = None

    def __post_init__(self):
        S = len(self.source_names)
        self.placements = [[0] * self.num_players for _ in range(S)]
        self.rewards = [0.0] * S
        self.games = [0] * S
        self.outcomes_by_source = [[] for _ in range(S)]

    def record_game(self, seat_sources: Sequence[int], placements: Sequence[int],
                    seat_rewards: Sequence[float]) -> None:
        self.total_games += 1
        # A single-player episode has no draw (its one player places first).
        if self.num_players > 1 and all(p == 1 for p in placements):
            self.draws += 1
        record = []
        for seat, source in enumerate(seat_sources):
            place = int(placements[seat])
            self.placements[source][min(place - 1, self.num_players - 1)] += 1
            self.rewards[source] += float(seat_rewards[seat])
            self.games[source] += 1
            record.append((int(source), place))
        self.game_records.append(record)

    def summary_rows(self) -> List[Dict[str, Any]]:
        rows = []
        for s, name in enumerate(self.source_names):
            games = max(self.games[s], 1)
            avg_place = sum((i + 1) * c for i, c in enumerate(self.placements[s])) / games
            rows.append({
                "name": name,
                "games": self.games[s],
                "avg_placement": avg_place,
                "avg_reward": self.rewards[s] / games,
                "win_rate": self.placements[s][0] / games,
                "placements": list(self.placements[s]),
            })
        return rows

    def compute_ratings(self):
        """Plackett-Luce ratings over the recorded games, anchored at
        'Random' if present, else the first source; games where one source
        holds several seats are skipped (the JAX package's divergences
        from the reference, eval.py:224-259)."""
        from burn_ppo_torch.selfplay.plackett_luce import GameResult, compute_ratings

        games = []
        for rec in self.game_records:
            srcs = [src for src, _ in rec]
            if len(rec) < 2 or len(set(srcs)) != len(srcs):
                continue
            games.append(GameResult.of(srcs, [pl for _, pl in rec]))
        anchor = next((i for i, name in enumerate(self.source_names) if name == "Random"), 0)
        return compute_ratings(len(self.source_names), games, anchor), len(games)

    def compute_parity_ratings(self):
        """The reference's stats-mode ratings (eval.rs:591-607): one per
        lineup slot, over all games, anchored at slot 0; a seat maps to
        the slot of its first seat; games where some slot never sat are
        skipped."""
        from burn_ppo_torch.selfplay.plackett_luce import GameResult, compute_ratings

        S = len(self.source_names)
        games = []
        for rec in self.game_records:
            places = []
            for slot in range(S):
                seat = next((i for i, (src, _) in enumerate(rec) if src == slot), None)
                if seat is None:
                    break
                places.append(rec[seat][1])
            else:
                games.append(GameResult.of(list(range(S)), places))
        return compute_ratings(S, games, 0), len(games)

    def print_parity_ratings(self) -> None:
        """The reference's ratings block (eval.rs:591-644)."""
        from burn_ppo_torch.selfplay.plackett_luce import print_rating_guide

        result, n_rated = self.compute_parity_ratings()
        if n_rated == 0:
            print("\nNo rateable games recorded.")
            return
        st = result.stats
        status = "converged" if st.converged else "did not converge"
        print(f"\nRating computation: {status} in {st.iterations_used} "
              f"iterations ({st.computation_time_ms:.1f}ms), final delta: {st.final_delta:.2e}")
        print_rating_guide()
        print("\nRatings:")
        ratings = result.ratings
        strongest = max(range(len(ratings)), key=lambda i: ratings[i].rating)
        for i, (name, pr) in enumerate(zip(self.source_names, ratings)):
            marker = " <- strongest" if i == strongest else ""
            print(f"  {name}: {pr.rating:.0f}±{pr.uncertainty:.0f}{marker}")

    def print_table(self, parity_ratings: bool = False) -> None:
        if self.num_players > 1:
            print(f"\nResults over {self.total_games} games "
                  f"(draw rate {self.draws / max(self.total_games, 1):.1%}):")
        else:
            print(f"\nResults over {self.total_games} episodes:")
        header = f"{'Player':<40} {'Games':>6} {'Win%':>7} {'AvgPlace':>9} {'AvgReward':>10}"
        print(header)
        print("-" * len(header))
        for row in self.summary_rows():
            print(f"{row['name']:<40} {row['games']:>6} {row['win_rate']:>6.1%} "
                  f"{row['avg_placement']:>9.2f} {row['avg_reward']:>10.3f}")
        if parity_ratings:
            self.print_parity_ratings()
            return
        if len(set(self.source_names)) > 1 and self.game_records:
            result, n_rated = self.compute_ratings()
            if n_rated > 0:
                print(f"\n{'Player':<40} {'Rating':>8} {'±2σ':>8}   ({n_rated} rated games)")
                print("-" * 58)
                for name, pr in zip(self.source_names, result.ratings):
                    print(f"{name:<40} {pr.rating:>8.0f} {2 * pr.uncertainty:>8.0f}")


# ---------------------------------------------------------------------------
# The stats engine (eval.py:360-624)
# ---------------------------------------------------------------------------
def generate_permutations(n: int) -> np.ndarray:
    """All n! seat permutations, itertools' order (eval.py:360-363)."""
    return np.array(list(itertools.permutations(range(n))), dtype=np.int32)


def seat_maps(num_sources: int, num_players: int) -> np.ndarray:
    """[n_perms, P] i32 source of each seat, game after game
    (eval.py:521-547): S == 1 broadcasts (self-play); S == P every
    permutation; S > P every ordered arrangement of P distinct sources;
    1 < S < P the sources cycled over the seats."""
    S, P = num_sources, num_players
    if S == 1:
        return np.zeros((1, P), dtype=np.int32)
    if S == P:
        return generate_permutations(P)
    if S > P:
        n_arr = math.perm(S, P)
        if n_arr > 1_000_000:
            raise ValueError(
                f"stats mode with {S} sources in {P} seats needs {n_arr} seat arrangements "
                "for fair coverage; use tournament mode for fields this large")
        return np.array(list(itertools.permutations(range(S), P)), dtype=np.int32)
    return np.array([[(i + r) % S for i in range(P)] for r in range(S)], dtype=np.int32)


class ActingLogits:
    """``logits(obs_raw [E, D], acting_source [E]) -> [E, A]``: each env's
    policy logits under its acting source, zeros for a random source.

    Sources that hold one network object (one checkpoint path, through
    the load cache) collapse to one unique model, never forwarded twice.
    ``path`` says how the logits are computed, chosen from the unique
    models' architectures before any launch:

      * ``"random"``: no model, zeros;
      * ``"single"``: one unique model, one forward (cuBLAS);
      * ``"stacked"``: every unique model an actor tower that K7 takes
        (MLP or CTDE actor of the same widths and activation, within
        ``opponent_tower_problems``' limits, obs normalisation on all or on
        none): the models stacked as K7's slots (``OpponentStack``), each
        row run through its acting model's slot, a random source's row
        through slot -1, which K7 gives zeros (``opponent_actor_forward``);
      * ``"per_model"``: anything else (the CNN, mixed towers): one forward
        per unique model, each row taking its model's logits by
        ``torch.where`` (JAX's ``hetero``, eval.py:482-498).

    The JAX package also drops from its stacked path to the per-model one
    when ``n_params * num_envs`` passes 64M (eval.py:442-447): that guards
    the per-env parameter copies of its one-hot contraction in TPU
    memory, which K7 does not make, so the port has no such switch."""

    def __init__(self, env: Environment, sources: Sequence[PlayerSource],
                 device: torch.device):
        self.num_actions = env.spec.num_actions
        self.device = device
        uniques: List[PlayerSource] = []
        src_map: List[int] = []
        for s in sources:
            if s.kind == "random":
                src_map.append(-1)
                continue
            j = next((j for j, u in enumerate(uniques)
                      if u.network is s.network and u.obs_norm is s.obs_norm), None)
            if j is None:
                uniques.append(s)
                j = len(uniques) - 1
            src_map.append(j)
        self.uniques = uniques
        # acting source -> unique model (-1: random), on the device
        self.slot_of_source = torch.tensor(src_map, dtype=torch.int32, device=device)
        self.is_random = self.slot_of_source < 0
        self.stack: Optional[OpponentStack] = None
        U = len(uniques)
        if U == 0:
            self.path = "random"
        elif U == 1:
            self.path = "single"
        elif self._k7_takes(uniques):
            self.path = "stacked"
            norms = None if uniques[0].obs_norm is None else [u.obs_norm for u in uniques]
            self.stack = OpponentStack.of([actor_params(u.network) for u in uniques], norms)
        else:
            self.path = "per_model"

    @staticmethod
    def _k7_takes(uniques: Sequence[PlayerSource]) -> bool:
        widths = [actor_widths(u.network) for u in uniques]
        if widths[0] is None or any(w != widths[0] for w in widths):
            return False
        if len({u.network.activation for u in uniques}) != 1:
            return False
        if len({u.obs_norm is None for u in uniques}) != 1:
            return False
        return not opponent_tower_problems(widths[0], len(uniques))

    @staticmethod
    def _forward(u: PlayerSource, obs_raw: torch.Tensor) -> torch.Tensor:
        obs = obs_norm_apply(u.obs_norm, obs_raw) if u.obs_norm is not None else obs_raw
        return u.network.forward_actor(obs)

    def __call__(self, obs_raw: torch.Tensor, acting_source: torch.Tensor) -> torch.Tensor:
        E = obs_raw.shape[0]
        if self.path == "random":
            return torch.zeros(E, self.num_actions, device=obs_raw.device)
        slot = self.slot_of_source[acting_source.long()]  # [E] i32, -1 = random
        if self.path == "stacked":
            return opponent_actor_forward(obs_raw, slot, self.stack)
        rand = (slot < 0)[:, None]
        if self.path == "single":
            return torch.where(rand, 0.0, self._forward(self.uniques[0], obs_raw))
        logits_all = torch.stack([self._forward(u, obs_raw) for u in self.uniques])  # [U, E, A]
        U = len(self.uniques)
        sel = (torch.arange(U, device=slot.device)[:, None] == slot[None, :])[:, :, None]
        logits = torch.sum(torch.where(sel, logits_all, 0.0), dim=0)
        return torch.where(rand, 0.0, logits)


def make_acting_logits_fn(env: Environment, sources: Sequence[PlayerSource], num_envs: int,
                          device: Optional[torch.device] = None) -> ActingLogits:
    """The acting-logits function of ``sources`` (eval.py:366-498); see
    ``ActingLogits``. ``num_envs`` is kept for the JAX signature."""
    return ActingLogits(env, sources, device if device is not None else sources_device(sources))


@dataclass
class ChunkLog:
    """One chunk's records on the device, [T, E, ...]: what the host reads
    once a chunk. ``perm`` is each env's permutation BEFORE the step's
    advance, which maps its seats to sources."""

    completed: torch.Tensor  # [T, E] f32
    outcome: torch.Tensor  # [T, E, P] i32
    total_rewards: torch.Tensor  # [T, E, P] f32
    perm: torch.Tensor  # [T, E] i32

    def fetch(self) -> Dict[str, np.ndarray]:
        return {k: getattr(self, k).cpu().numpy()
                for k in ("completed", "outcome", "total_rewards", "perm")}


class StatsEngine:
    """The stats engine's carry and its chunk of steps (eval.py:551-598):
    envs, episode accumulators, each env's move count and permutation,
    and the obs and mask of the current states."""

    def __init__(self, env: Environment, sources: Sequence[PlayerSource], num_envs: int,
                 temp: TempSchedule, rng: RandomSource, device: torch.device,
                 chunk_steps: int = 64):
        P = env.spec.num_players
        self.env, self.temp, self.rng, self.device = env, temp, rng, device
        self.num_envs, self.chunk_steps = num_envs, chunk_steps
        self.perms = seat_maps(len(sources), P)
        self.perm_table = torch.from_numpy(self.perms).to(device=device, dtype=torch.long)
        self.n_perms = self.perms.shape[0]
        self.logits = ActingLogits(env, sources, device)
        with torch.no_grad():
            self.states = env.reset(env.draw_reset(rng, num_envs).to(device))
            self.acc = EpisodeAccumulator.zero(num_envs, P, device)
            self.obs = env.obs(self.states)
            self.mask = env.action_mask(self.states)
        self.move_count = torch.zeros(num_envs, dtype=torch.int32, device=device)
        # Starting permutations staggered across envs for coverage.
        self.perm_idx = torch.arange(num_envs, dtype=torch.int32, device=device) % self.n_perms

    def step(self, log: ChunkLog, t: int) -> None:
        """One step of every env, its records written into slice ``t``."""
        env, E, rng = self.env, self.num_envs, self.rng
        players = env.current_player(self.states)
        acting = self.perm_table[self.perm_idx.long(), players.long()]  # [E]
        logits = self.logits(self.obs, acting)
        temps = self.temp.get_temp(self.move_count)
        actions = sample_with_temperature(
            logits, self.mask, temps, rng.uniform((E, env.spec.num_actions), TINY, 1.0))
        out = env.step_autoreset(self.states, self.acc, actions, env.draw_reset(rng, E),
                                 env.draw_step(rng, E))
        log.completed[t] = out.log.completed
        log.outcome[t] = out.log.outcome
        log.total_rewards[t] = out.log.total_rewards
        log.perm[t] = self.perm_idx
        done = out.done > 0
        self.move_count = torch.where(done, 0, self.move_count + 1).to(torch.int32)
        self.perm_idx = torch.where(done, (self.perm_idx + 1) % self.n_perms,
                                    self.perm_idx).to(torch.int32)
        self.states, self.acc, self.obs, self.mask = out.state, out.acc, out.obs, out.mask

    def run_chunk(self) -> ChunkLog:
        T, E, P, dev = self.chunk_steps, self.num_envs, self.env.spec.num_players, self.device
        log = ChunkLog(completed=torch.empty(T, E, device=dev),
                       outcome=torch.empty(T, E, P, dtype=torch.int32, device=dev),
                       total_rewards=torch.empty(T, E, P, device=dev),
                       perm=torch.empty(T, E, dtype=torch.int32, device=dev))
        with torch.no_grad():
            for t in range(T):
                self.step(log, t)
        return log


def run_stats_mode(
    env: Environment,
    sources: List[PlayerSource],
    num_games: int,
    num_envs: int = 64,
    temp: Optional[TempSchedule] = None,
    seed: Optional[int] = None,
    chunk_steps: int = 64,
    quiet: bool = False,
    *,
    device: Optional[str | torch.device] = None,
    rng: Optional[RandomSource] = None,
) -> EvalStats:
    """Play ``num_games`` with seat rotation; returns per-source stats.
    Runs on the device the checkpoint sources live on (``device`` when
    every source is random); ``rng`` replaces the generator seeded from
    ``seed``."""
    P = env.spec.num_players
    temp = temp or default_temp(env)
    if not all(s.kind in ("checkpoint", "random") for s in sources):
        raise ValueError("human players use the interactive path")
    dev = sources_device(sources, device if device is not None else "cuda")
    engine = StatsEngine(env, sources, num_envs, temp, rng or random_source(seed, dev), dev,
                         chunk_steps)
    stats = EvalStats([s.name for s in sources], P, logits_path=engine.logits.path)
    while stats.total_games < num_games:
        got = engine.run_chunk().fetch()
        # t-major, as np.nonzero over [T, E] orders them: the games that a
        # truncation at num_games keeps are JAX's.
        for t, e in zip(*np.nonzero(got["completed"])):
            if stats.total_games >= num_games:
                break
            if np.any(got["outcome"][t, e] < 1):
                # The no-outcome sentinel (an invalid move ended the game):
                # the reference keeps such games out of the stats.
                continue
            stats.record_game(engine.perms[got["perm"][t, e]], got["outcome"][t, e],
                              got["total_rewards"][t, e])
        if not quiet:
            print(f"\r  games: {stats.total_games}/{num_games}", end="", flush=True)
    if not quiet:
        print()
    return stats


# ---------------------------------------------------------------------------
# One env at a time: watch mode and human play (eval.py:630-742)
# ---------------------------------------------------------------------------
class SingleGame:
    """One env (a batch of one) stepped through the env's step kernel, with
    the text helpers' view of it. When a move ends the game, ``terminal``
    holds the stepped state before the auto-reset replaced it (the plain
    step of the same move on the host, for the final render)."""

    def __init__(self, env: Environment, rng: RandomSource, device: torch.device):
        self.env, self.rng, self.device = env, rng, device
        with torch.no_grad():
            self.state = env.reset(env.draw_reset(rng, 1).to(device))
            self.obs = env.obs(self.state)
            self.mask = env.action_mask(self.state)
        self.acc = EpisodeAccumulator.zero(1, env.spec.num_players, device)
        self.terminal = None
        self.rewards: Optional[np.ndarray] = None

    @property
    def done(self) -> bool:
        return self.terminal is not None

    def play(self, action: int) -> None:
        env, rng = self.env, self.rng
        a = torch.tensor([action], dtype=torch.int32, device=self.device)
        reset_values = env.draw_reset(rng, 1)
        u = env.draw_step(rng, 1)
        with torch.no_grad():
            out = env.step_autoreset(self.state, self.acc, a, reset_values, u)
        self.rewards = out.rewards[0].cpu().numpy()
        if bool(out.done[0]):
            args = (env_row(self.state), a.cpu()) + (() if u is None else (u.cpu(),))
            self.terminal = env.step(*args)[0]
        self.state, self.acc, self.obs, self.mask = out.state, out.acc, out.obs, out.mask

    def view(self):
        """The state the text helpers read: the terminal one once done."""
        return self.terminal if self.done else self.state


def _select_action(env: Environment, game: SingleGame, source: PlayerSource,
                   temperature: torch.Tensor) -> int:
    """One move of ``source`` (eval.py:679-693): its masked logits through
    K14 at ``temperature`` [1]; a human is prompted."""
    if source.kind == "human":
        from burn_ppo_torch.human import prompt_human_action

        return prompt_human_action(env, game.state, hint_source=None)
    A = env.spec.num_actions
    u = game.rng.uniform((1, A), TINY, 1.0)
    with torch.no_grad():
        if source.kind == "random":
            logits = torch.zeros(1, A, device=game.device)
        else:
            logits = ActingLogits._forward(source, game.obs)
        return int(sample_with_temperature(logits, game.mask, temperature, u)[0])


def run_watch_mode(
    env: Environment,
    sources: List[PlayerSource],
    num_games: int,
    temp: TempSchedule,
    seed: Optional[int],
    step_mode: bool = False,
    fps: int = 10,
    animate: bool = False,
    *,
    device: Optional[str | torch.device] = None,
) -> None:
    P = env.spec.num_players
    dev = sources_device(sources, device if device is not None else "cuda")
    rng = random_source(seed, dev)
    for game_no in range(num_games):
        game = SingleGame(env, rng, dev)
        move = 0
        print(f"\n=== Game {game_no + 1}/{num_games} ===")
        # Seats rotate between watched games (eval.rs:1068-1279).
        seat_of = [(p + game_no) % len(sources) for p in range(P)]
        if len(sources) > 1:
            print("Seats: " + ", ".join(f"P{p}={sources[seat_of[p]].name}" for p in range(P)))
        while not game.done:
            rendered = env.render(game.state)
            if rendered:
                print(rendered)
            player = int(env.current_player(game.state)[0])
            source = sources[seat_of[player]]
            action = _select_action(env, game, source,
                                    temp.get_temp(torch.tensor([move], device=dev)))
            print(f"{source.name} (P{player}): {env.describe_action(action)}")
            game.play(action)
            move += 1
            if step_mode:
                input("  [Enter to continue]")
            elif animate:
                time.sleep(1.0 / max(fps, 1))
        rendered = env.render(game.view())
        if rendered:
            print(rendered)
        print(f"Final rewards: {game.rewards}")


def run_interactive_evaluation(
    env: Environment,
    sources: List[PlayerSource],
    num_games: int,
    temp: TempSchedule,
    seed: Optional[int],
    *,
    device: Optional[str | torch.device] = None,
) -> None:
    from burn_ppo_torch.human import prompt_human_action

    P = env.spec.num_players
    if len(sources) != P:
        raise ValueError(f"need {P} players for {env.spec.name}, got {len(sources)}")
    dev = sources_device(sources, device if device is not None else "cuda")
    rng = random_source(seed, dev)
    model_sources = [s for s in sources if s.kind == "checkpoint"]
    hint = model_sources[0] if model_sources else None
    wins = [0] * len(sources)
    for game_no in range(num_games):
        game = SingleGame(env, rng, dev)
        move = 0
        print(f"\n=== Game {game_no + 1}/{num_games} ===")
        while not game.done:
            player = int(env.current_player(game.state)[0])
            source = sources[player]
            rendered = env.render(game.state)
            if rendered and source.kind == "human":
                print(rendered)
            if source.kind == "human":
                action = prompt_human_action(env, game.state, hint_source=hint)
            else:
                action = _select_action(env, game, source,
                                        temp.get_temp(torch.tensor([move], device=dev)))
                print(f"{source.name}: {env.describe_action(action)}")
            game.play(action)
            move += 1
        rendered = env.render(game.view())
        if rendered:
            print(rendered)
        placements = rewards_to_placements([float(r) for r in game.rewards])
        for i, pl in enumerate(placements):
            if pl == 1:
                wins[i] += 1
        print(f"Final rewards: {game.rewards}")
    print("\nWins:", {sources[i].name: wins[i] for i in range(len(sources))})


# ---------------------------------------------------------------------------
# CLI entry (eval.py:748-838)
# ---------------------------------------------------------------------------
def _resolve_checkpoint(path: str | Path) -> Path:
    """A checkpoint dir, a run dir (best, then latest) or a checkpoints dir."""
    p = Path(path)
    if (p / "metadata.json").exists():
        return p
    for sub in ("checkpoints/best", "checkpoints/latest", "best", "latest"):
        cand = p / sub
        if (cand / "metadata.json").exists():
            return cand.resolve()
    raise FileNotFoundError(f"No checkpoint found at {path}")


def build_sources(args, env_name_hint: Optional[str] = None,
                  device: str | torch.device = "cuda"):
    sources: List[PlayerSource] = []
    env_name = env_name_hint
    for path in args.checkpoints:
        src = PlayerSource.checkpoint(_resolve_checkpoint(path), device)
        sources.append(src)
        env_name = env_name or load_metadata(src.path)["env_name"]
    for name in getattr(args, "humans", []):
        sources.append(PlayerSource.human(name))
    if getattr(args, "random", False):
        sources.append(PlayerSource.random())
    return sources, env_name


def run_evaluation_cli(args, device: str | torch.device = "cuda") -> int:
    sources, env_name = build_sources(args, getattr(args, "env_name", None), device)
    if env_name is None:
        print("error: no checkpoint given and no --env specified")
        return 1
    env = make_env(env_name)
    if env.spec.variable_player_count and getattr(args, "players", None):
        env = env.with_num_players(args.players)
    P = env.spec.num_players

    temp = TempSchedule.from_args(env, args)
    print(f"Evaluating {env_name} with {temp.describe()}")

    humans = [s for s in sources if s.kind == "human"]
    if humans:
        if len(humans) > P:
            print(f"error: {len(humans)} humans requested but {env_name} seats only {P} players")
            return 1
        # Humans always keep their seats: excess NON-human sources drop
        # from the end, and a shortfall is filled by cycling the
        # non-human sources.
        seats = list(sources)
        dropped = 0
        while len(seats) > P:
            for j in range(len(seats) - 1, -1, -1):
                if seats[j].kind != "human":
                    del seats[j]
                    dropped += 1
                    break
        if dropped:
            print(f"note: only {P} seats; dropping {dropped} extra non-human source(s)")
        non_human = [s for s in sources if s.kind != "human"] or [PlayerSource.random()]
        i = 0
        while len(seats) < P:
            seats.append(non_human[i % len(non_human)])
            i += 1
        run_interactive_evaluation(env, seats, args.num_games, temp, args.seed, device=device)
        return 0

    if not sources:
        print("error: need at least one --checkpoint / --random player")
        return 1

    if args.watch or args.step or args.animate:
        seats = [sources[i % len(sources)] for i in range(P)]
        run_watch_mode(env, seats, args.num_games, temp, args.seed, step_mode=args.step,
                       fps=args.fps, animate=args.animate, device=device)
        return 0

    stats = run_stats_mode(env, sources, args.num_games, num_envs=args.num_envs, temp=temp,
                           seed=args.seed, device=device)
    stats.print_table(parity_ratings=getattr(args, "parity_ratings", False))
    return 0

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
    games, each env's acting model's logits (``ActingLogits``), the
    env step kernel (K1, K4, K11, K13) with the temperature sampler K14's
    row code as its sampling front (one launch a step), and
    the step's seating and records (K17, ``step_books``, once a step: the
    seats before a chunk's first step, the records of each step fused with
    the next step's seats, the last step's records alone), chunks of 64
    steps (``StatsEngine``),
    the host reading each chunk's episode records once; ``EngineCache``
    keeps one engine per shape for a tournament's pods;
  * ``run_watch_mode`` and ``run_interactive_evaluation``: one env at a
    time (K14 alone, then the env step with its reset off), its text
    rendered, human moves read from the terminal (``human.py``).

The JAX engine is one jitted ``lax.scan`` a chunk; here a chunk is one
CUDA graph replay on a card (``EvalGraph``), the same steps run eagerly
on the CPU. Randomness comes from a ``ppo/rollout.py RandomSource``: one
``torch.Generator`` on the device, seeded from ``seed`` and registered
with the graph, or in the parity tests a source replaying JAX's draws.
Per step it draws the sampler's uniforms [E, A], then the env's reset
values and its step values.
"""

from __future__ import annotations

import copy
import dataclasses
import itertools
import math
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, ClassVar, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from burn_ppo_torch import kernels
from burn_ppo_torch.checkpoint import load_metadata, load_model, load_obs_normalizer
from burn_ppo_torch.envs import make_env
from burn_ppo_torch.envs.base import Environment, EpisodeAccumulator
from burn_ppo_torch.ops.categorical import TINY, TemperatureFront, sample_with_temperature
from burn_ppo_torch.ppo.normalization import ObsNormState, obs_norm_apply
from burn_ppo_torch.ppo.pool_rollout import (
    OpponentStack,
    actor_params,
    actor_widths,
    opponent_actor_forward,
    opponent_tower_problems,
)
from burn_ppo_torch.ppo.rollout import RandomSource, TorchRandomSource
from burn_ppo_torch.ppo.rollout_graph import CapturedGraph, copy_into, state_leaves
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


def resolve_seed(seed: Optional[int]) -> int:
    """``seed``, or the clock when None (as the JAX package's PRNGKey is)."""
    return seed if seed is not None else int(time.time()) % 2**31


def random_source(seed: Optional[int], device: torch.device) -> RandomSource:
    """One generator on ``device``, seeded from ``seed`` (``resolve_seed``)."""
    return TorchRandomSource(torch.Generator(device=device).manual_seed(resolve_seed(seed)))


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

    def kernel_args(self) -> tuple:
        """K17's schedule, the f32 constants ``get_temp`` rounds to: (mode
        (0 constant, 1 cutoff, 2 decay), initial, final, final - initial,
        cutoff, 1 / cutoff)."""
        f32 = lambda x: float(np.float32(x))  # noqa: E731
        if self.cutoff is None:
            return 0, f32(self.initial), 0.0, 0.0, 0.0, 0.0
        return (2 if self.decay else 1, f32(self.initial), f32(self.final_temp),
                f32(self.final_temp - self.initial), float(self.cutoff), f32(1.0 / self.cutoff))

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


def _unique_models(sources: Sequence[PlayerSource]) -> Tuple[List[PlayerSource], List[int]]:
    """The sources' unique models (one network object and obs normaliser
    each, as the load cache shares them) and each source's index among
    them (-1: random)."""
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
    return uniques, src_map


def network_arch(network) -> tuple:
    """What fixes a network's forward: its kind, activation, obs layout
    and every parameter's name and shape."""
    return (network.network_type, network.activation, network.split_networks, network.obs_shape,
            tuple((n, tuple(p.shape)) for n, p in network.named_parameters()))


class ActingLogits:
    """``logits(obs_raw [E, D], acting_source [E]) -> [E, A]``: each env's
    policy logits under its acting source, zeros for a random source;
    ``forward_slots(obs_raw, slot)`` the same from each env's unique
    model (``slot_of_source`` of its acting source, -1 random).

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

    With ``own`` (the stats engine's), the networks, obs normalisers and
    stack are copies of the object's own, at fixed addresses: a CUDA graph
    reads them, and ``load`` copies another lineup of the same ``key``
    into them. The stack then has a slot for every source, so that lineups
    with fewer unique models share its shape. Without ``own`` the shared
    load-cache networks are forwarded as they are.

    The JAX package also drops from its stacked path to the per-model one
    when ``n_params * num_envs`` passes 64M (eval.py:442-447): that guards
    the per-env parameter copies of its one-hot contraction in TPU
    memory, which K7 does not make, so the port has no such switch."""

    def __init__(self, env: Environment, sources: Sequence[PlayerSource],
                 device: torch.device, *, own: bool = False):
        self.num_actions = env.spec.num_actions
        self.device = device
        uniques, src_map = _unique_models(sources)
        self.path = self._path(uniques)
        self.key = self.lineup_key(sources)
        # acting source -> unique model (-1: random), on the device
        self.slot_of_source = torch.tensor(src_map, dtype=torch.int32, device=device)
        if own and self.path in ("single", "per_model"):
            uniques = [dataclasses.replace(u, network=copy.deepcopy(u.network),
                                           obs_norm=copy.deepcopy(u.obs_norm)) for u in uniques]
        self.uniques = uniques
        self.stack: Optional[OpponentStack] = None
        if self.path == "stacked":
            self.stack = self._stack_of(uniques, len(sources) if own else len(uniques))

    @staticmethod
    def _path(uniques: Sequence[PlayerSource]) -> str:
        if not uniques:
            return "random"
        if len(uniques) == 1:
            return "single"
        return "stacked" if ActingLogits._k7_takes(uniques) else "per_model"

    @staticmethod
    def lineup_key(sources: Sequence[PlayerSource]) -> tuple:
        """What an engine's static logits fix of a lineup: the path, the
        source count and the unique models' architectures and obs-norm
        presence (per model, except on the stacked path, whose models
        share one tower)."""
        uniques, _ = _unique_models(sources)
        path = ActingLogits._path(uniques)
        archs = [(network_arch(u.network), u.obs_norm is None) for u in uniques]
        return path, len(sources), tuple(archs[:1] if path == "stacked" else archs)

    @staticmethod
    def _stack_of(uniques: Sequence[PlayerSource], slots: int) -> OpponentStack:
        """The unique models' actor towers as K7's first slots of a stack of
        ``slots``, the rest zeros (no row reads them)."""
        norms = None if uniques[0].obs_norm is None else [u.obs_norm for u in uniques]
        stack = OpponentStack.of([actor_params(u.network) for u in uniques], norms)
        pad = slots - len(uniques)
        if pad == 0:
            return stack

        def padded(x: torch.Tensor) -> torch.Tensor:
            return torch.cat([x, x.new_zeros(pad, *x.shape[1:])])

        norm = stack.norm
        return OpponentStack(
            weights=[padded(w) for w in stack.weights], biases=[padded(b) for b in stack.biases],
            activation=stack.activation,
            norm=None if norm is None else ObsNormState(padded(norm.mean), padded(norm.m2),
                                                        padded(norm.count)))

    def load(self, sources: Sequence[PlayerSource]) -> None:
        """Copy another lineup of this ``key`` into the own buffers: the
        seat map, and the networks, obs normalisers or stack."""
        if self.lineup_key(sources) != self.key:
            raise ValueError("a lineup of another key: its logits need other static buffers")
        uniques, src_map = _unique_models(sources)
        self.slot_of_source.copy_(torch.tensor(src_map, dtype=torch.int32))
        if self.stack is not None:
            copy_into(self.stack, self._stack_of(uniques, self.stack.num_slots))
            return
        for mine, u in zip(self.uniques, uniques):
            mine.network.load_state_dict(u.network.state_dict())
            copy_into(mine.obs_norm, u.obs_norm)

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
        return self.forward_slots(obs_raw, self.slot_of_source[acting_source.long()])

    def forward_slots(self, obs_raw: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
        E = obs_raw.shape[0]
        if self.path == "random":
            return torch.zeros(E, self.num_actions, device=obs_raw.device)
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

    @staticmethod
    def create(T: int, E: int, P: int, device: torch.device) -> "ChunkLog":
        return ChunkLog(completed=torch.zeros(T, E, device=device),
                        outcome=torch.zeros(T, E, P, dtype=torch.int32, device=device),
                        total_rewards=torch.zeros(T, E, P, device=device),
                        perm=torch.zeros(T, E, dtype=torch.int32, device=device))

    def fetch(self) -> Dict[str, np.ndarray]:
        """The records copied to the host (a copy on the CPU too: the
        engine's next chunk overwrites its log)."""
        return {k: getattr(self, k).to("cpu", copy=True).numpy()
                for k in ("completed", "outcome", "total_rewards", "perm")}


# ---------------------------------------------------------------------------
# K17: the step's seating and records (eval.py:569-592), one launch a step:
# the seats of a chunk's first step, then after each env step its records
# fused with the next step's seats, the last step's records alone
# ---------------------------------------------------------------------------
class Records(NamedTuple):
    """K17's record half: the env step's ``step_log`` into row ``t`` of
    ``log``."""

    log: ChunkLog
    t: int
    step_log: Any


class Seats(NamedTuple):
    """K17's seat half: each env's acting model into ``slot`` [E] i32 and
    its temperature into ``temps`` [E] f32. ``player`` is the state's
    player column (a strided view, read in place; None is player 0)."""

    player: Optional[torch.Tensor]
    slot_of_source: torch.Tensor
    temp: TempSchedule
    slot: torch.Tensor
    temps: torch.Tensor


def sample_seats_plain(perm_table: torch.Tensor, perm_idx: torch.Tensor,
                       player: Optional[torch.Tensor], slot_of_source: torch.Tensor,
                       move_count: torch.Tensor, temp: TempSchedule, slot: torch.Tensor,
                       temps: torch.Tensor) -> None:
    """Plain PyTorch seat half: each env's acting model ``slot`` [E] i32
    (``slot_of_source[perm_table[perm_idx, player]]``, -1 random) and its
    temperature ``temps`` [E] f32 (``temp.get_temp(move_count)``), written
    into the caller's buffers. ``player`` None is player 0."""
    seat = torch.zeros_like(perm_idx) if player is None else player
    source = perm_table[perm_idx.long(), seat.long()]
    slot.copy_(slot_of_source[source.long()])
    temps.copy_(temp.get_temp(move_count))


def record_step_plain(log: ChunkLog, t: int, step_log, perm_idx: torch.Tensor,
                      move_count: torch.Tensor, n_perms: int) -> None:
    """Plain PyTorch record half: the step's episode log and each env's
    permutation before the advance into row ``t`` of ``log``, then, in
    place, ``move_count`` to 0 and ``perm_idx`` to the next permutation
    where the env is done (``step_log.completed``, the step's done),
    ``move_count + 1`` elsewhere."""
    log.completed[t] = step_log.completed
    log.outcome[t] = step_log.outcome
    log.total_rewards[t] = step_log.total_rewards
    log.perm[t] = perm_idx
    ended = step_log.completed > 0
    move_count.copy_(torch.where(ended, 0, move_count + 1))
    perm_idx.copy_(torch.where(ended, (perm_idx + 1) % n_perms, perm_idx))


def step_books_plain(perm_table: torch.Tensor, perm_idx: torch.Tensor, move_count: torch.Tensor,
                     records: Optional[Records] = None, seats: Optional[Seats] = None) -> None:
    """Plain PyTorch K17: the records (if given), then the seats (if given)
    from the advanced move counts and permutations."""
    if records is not None:
        record_step_plain(*records, perm_idx, move_count, perm_table.shape[0])
    if seats is not None:
        sample_seats_plain(perm_table, perm_idx, seats.player, seats.slot_of_source, move_count,
                           seats.temp, seats.slot, seats.temps)


def step_books(perm_table: torch.Tensor, perm_idx: torch.Tensor, move_count: torch.Tensor,
               records: Optional[Records] = None, seats: Optional[Seats] = None) -> None:
    """K17, the step's bookkeeping in one launch: plain PyTorch on the
    CPU, the kernel (``csrc/eval_step.cu``) on a CUDA device. ``records``
    writes row ``t`` where it lies (inside a chunk's graph, a pointer fixed
    at capture) and advances ``move_count`` and ``perm_idx`` in place;
    ``seats`` then reads the advanced ones. A chunk gives the first step
    the seats alone, each step but the last both, the last the records
    alone."""
    if records is None and seats is None:
        raise ValueError("step_books: neither records nor seats")
    ts = [perm_table, perm_idx, move_count]
    if records is not None:
        ts += [records.step_log.completed, records.step_log.outcome,
               records.step_log.total_rewards, records.log.completed]
    if seats is not None:
        ts += [x for x in (seats.player, seats.slot_of_source, seats.slot, seats.temps)
               if x is not None]
    if kernels.on_cpu(*ts):
        return step_books_plain(perm_table, perm_idx, move_count, records, seats)
    n_perms, P = perm_table.shape
    E = perm_idx.shape[0]
    kernels.expect(perm_table, "perm_table", torch.int32, (n_perms, P))
    kernels.expect(perm_idx, "perm_idx", torch.int32, (E,))
    kernels.expect(move_count, "move_count", torch.int32, (E,))
    p = kernels.ptr
    rec = [None] * 7
    if records is not None:
        log, t, step_log = records
        outcome = step_log.outcome.reshape(E, P)
        totals = step_log.total_rewards.reshape(E, P)
        kernels.expect(log.outcome, "log.outcome", torch.int32, (log.outcome.shape[0], E, P))
        kernels.expect(step_log.completed, "completed", torch.float32, (E,))
        kernels.expect(outcome, "outcome", torch.int32, (E, P))
        kernels.expect(totals, "total_rewards", torch.float32, (E, P))
        rec = [p(step_log.completed), p(outcome), p(totals), p(log.completed[t]),
               p(log.outcome[t]), p(log.total_rewards[t]), p(log.perm[t])]
    seat = [None, 0, None, 0, 0.0, 0.0, 0.0, 0.0, 0.0, None, None]
    if seats is not None:
        player = seats.player
        kernels.expect(seats.slot, "slot", torch.int32, (E,))
        kernels.expect(seats.slot_of_source, "slot_of_source", torch.int32,
                       (seats.slot_of_source.shape[0],))
        kernels.expect(seats.temps, "temps", torch.float32, (E,))
        if player is not None and (player.dtype != torch.int32 or tuple(player.shape) != (E,)):
            raise ValueError(f"player: expected an [{E}] i32 view, got {player.dtype} "
                             f"{tuple(player.shape)}")
        seat = [p(player), 0 if player is None else player.stride(0), p(seats.slot_of_source),
                *seats.temp.kernel_args(), p(seats.slot), p(seats.temps)]
    err = kernels.library().eval_step_books(
        p(perm_idx), p(move_count), p(perm_table), n_perms, P, *rec, *seat, E,
        kernels.stream(perm_idx.device))
    kernels.check(err, "eval_step_books")
    step_books.launches += 1


kernels.counted(step_books)


# ---------------------------------------------------------------------------
# The chunk: static buffers, one CUDA graph on a card (eval.py:551-598)
# ---------------------------------------------------------------------------
@dataclass
class EvalCarry:
    """The stats engine's carry, at fixed addresses: envs, episode
    accumulators, the obs and mask of the current states, each env's move
    count and permutation."""

    states: Any
    acc: EpisodeAccumulator
    obs: torch.Tensor  # [E, D]
    mask: torch.Tensor  # [E, A] f32
    move_count: torch.Tensor  # [E] i32
    perm_idx: torch.Tensor  # [E] i32


class EvalGraph(CapturedGraph):
    """One stats chunk captured into a CUDA graph (``CapturedGraph``: a
    warm-up on a side stream, the carry and the generator put back, the
    generator registered), with counts of its own over all its
    instances."""

    replays = 0
    captures = 0
    skipped = 0
    launches: Dict[Any, int] = {}
    warmup_launches: Dict[Any, int] = {}

    def __init__(self, fn, state: List[torch.Tensor], generator: torch.Generator) -> None:
        super().__init__([fn], state, generator)


def engine_key(env: Environment, sources: Sequence[PlayerSource], num_envs: int,
               temp: TempSchedule, device: torch.device, chunk_steps: int = 64) -> tuple:
    """What a stats engine's buffers and graph fix: the env and its player
    count, E, T, the lineup's logits (``ActingLogits.lineup_key``: path,
    source count, architectures, obs-norm presence; the source and player
    counts fix the permutation table), the schedule and the device."""
    return (env.spec, num_envs, chunk_steps, ActingLogits.lineup_key(sources), temp, str(device))


class StatsEngine:
    """The stats engine's carry and its chunk of steps (eval.py:551-598),
    on static buffers: the carry (``EvalCarry``), the seat and temperature
    scratch, one ``ChunkLog`` that every chunk overwrites (fetch it before
    the next), and the logits' own networks or stack (``ActingLogits``
    with ``own``). A step writes its records into row t of the log and
    advances the move counts and permutations in place, in the launch that
    seats the next step (K17: T + 1 launches a chunk of T steps); the
    chunk's last states are copied back into the carry.

    ``run_chunk`` replays one CUDA graph of the chunk on a card, captured
    at the first chunk (the random source must be a ``TorchRandomSource``),
    and runs the same steps eagerly on the CPU; ``eager_chunk`` runs them
    eagerly anywhere. A failed capture raises; nothing falls back to the
    eager loop. ``load`` puts another lineup of the same ``engine_key``
    and a new seed into the buffers (``EngineCache``)."""

    def __init__(self, env: Environment, sources: Sequence[PlayerSource], num_envs: int,
                 temp: TempSchedule, rng: RandomSource, device: torch.device,
                 chunk_steps: int = 64):
        P = env.spec.num_players
        self.env, self.temp, self.rng, self.device = env, temp, rng, device
        self.num_envs, self.chunk_steps = num_envs, chunk_steps
        self.key = engine_key(env, sources, num_envs, temp, device, chunk_steps)
        self.perms = seat_maps(len(sources), P)
        self.perm_table = torch.from_numpy(self.perms).to(device)
        self.n_perms = self.perms.shape[0]
        self.logits = ActingLogits(env, sources, device, own=True)
        self.slot = torch.zeros(num_envs, dtype=torch.int32, device=device)
        self.temps = torch.zeros(num_envs, dtype=torch.float32, device=device)
        self.log = ChunkLog.create(chunk_steps, num_envs, P, device)
        self.graph: Optional[EvalGraph] = None
        self.carry: Optional[EvalCarry] = None
        self.chunks = 0
        self._reset()

    def _reset(self) -> None:
        """A fresh carry from the random source, written into the static one."""
        env, E, dev = self.env, self.num_envs, self.device
        with torch.no_grad():
            states = env.reset(env.draw_reset(self.rng, E).to(dev))
            fresh = EvalCarry(
                states=states, acc=EpisodeAccumulator.zero(E, env.spec.num_players, dev),
                obs=env.obs(states), mask=env.action_mask(states),
                move_count=torch.zeros(E, dtype=torch.int32, device=dev),
                # Starting permutations staggered across envs for coverage.
                perm_idx=torch.arange(E, dtype=torch.int32, device=dev) % self.n_perms)
        if self.carry is None:
            self.carry = fresh
        else:
            copy_into(self.carry, fresh)

    def load(self, sources: Sequence[PlayerSource], seed: int) -> None:
        """Play another lineup of this ``key`` from ``seed``: its models
        copied into the own buffers, the generator re-seeded, the fresh
        reset drawn eagerly into the carry (what a new engine seeded so
        draws)."""
        if not isinstance(self.rng, TorchRandomSource):
            raise TypeError("an engine reloads by re-seeding a TorchRandomSource's generator")
        self.logits.load(sources)
        self.rng.generator.manual_seed(seed)
        self._reset()

    def seats(self, states) -> Seats:
        """K17's seat half for the step from ``states``: into the engine's
        slot and temperature scratch."""
        return Seats(self.env.current_player_view(states), self.logits.slot_of_source,
                     self.temp, self.slot, self.temps)

    def seat(self, c: EvalCarry) -> None:
        """The seats and temperatures of carry ``c``'s step into the
        engine's scratch (K17's seat half alone): a chunk's first step."""
        step_books(self.perm_table, c.perm_idx, c.move_count, seats=self.seats(c.states))

    def step(self, c: EvalCarry, t: int, last: bool = False) -> EvalCarry:
        """One step of every env from carry ``c``, whose seats are in the
        scratch; its records written into row ``t`` of the log and, unless
        ``last``, the next step's seats in the same launch (K17). Returns
        the next carry (move counts and permutations advanced in place)."""
        env, E, rng = self.env, self.num_envs, self.rng
        logits = self.logits.forward_slots(c.obs, self.slot)
        # K14's sample in the env step's launch; the uniforms drawn first,
        # as the sampler and the step apart drew them.
        front = TemperatureFront(logits, c.mask, self.temps,
                                 rng.uniform((E, env.spec.num_actions), TINY, 1.0))
        out = env.sample_step_autoreset(c.states, c.acc, front, env.draw_reset(rng, E),
                                        env.draw_step(rng, E))
        step_books(self.perm_table, c.perm_idx, c.move_count, Records(self.log, t, out.log),
                   None if last else self.seats(out.state))
        return dataclasses.replace(c, states=out.state, acc=out.acc, obs=out.obs, mask=out.mask)

    def _chunk(self) -> None:
        c = self.carry
        T = self.chunk_steps
        with torch.no_grad():
            self.seat(c)
            for t in range(T):
                c = self.step(c, t, last=t == T - 1)
            copy_into(self.carry, c)

    def eager_chunk(self) -> ChunkLog:
        """The chunk's steps run one by one (on a card, every wrapper
        launching), into the same buffers as ``run_chunk``."""
        self._chunk()
        self.chunks += 1
        return self.log

    def run_chunk(self) -> ChunkLog:
        """One chunk: a graph replay on a card, the eager steps on the CPU.
        Returns the engine's log, which the next chunk overwrites."""
        if self.device.type != "cuda":
            return self.eager_chunk()
        if self.graph is None:
            if not isinstance(self.rng, TorchRandomSource):
                raise TypeError("a graphed chunk draws from a TorchRandomSource's generator")
            self.graph = EvalGraph(self._chunk, state_leaves(self.carry), self.rng.generator)
        self.graph.replay()
        self.chunks += 1
        return self.log


class EngineCache:
    """One ``StatsEngine`` per ``engine_key``, reused across a tournament's
    pods: a lineup of a key seen before is copied into that engine's
    buffers (``StatsEngine.load``), so its graph, captured once, replays
    for every pod. ``built`` and ``reused`` count the pods of each kind."""

    def __init__(self):
        self.engines: Dict[tuple, StatsEngine] = {}
        self.built = self.reused = 0

    def engine(self, env: Environment, sources: Sequence[PlayerSource], num_envs: int,
               temp: TempSchedule, seed: Optional[int], device: torch.device,
               chunk_steps: int = 64) -> StatsEngine:
        seed = resolve_seed(seed)
        key = engine_key(env, sources, num_envs, temp, device, chunk_steps)
        engine = self.engines.get(key)
        if engine is None:
            engine = StatsEngine(env, sources, num_envs, temp, random_source(seed, device),
                                 device, chunk_steps)
            self.engines[key] = engine
            self.built += 1
        else:
            engine.load(sources, seed)
            self.reused += 1
        return engine


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
    engines: Optional[EngineCache] = None,
) -> EvalStats:
    """Play ``num_games`` with seat rotation; returns per-source stats.
    Runs on the device the checkpoint sources live on (``device`` when
    every source is random); ``rng`` replaces the generator seeded from
    ``seed``; ``engines`` reuses an engine of the same shape."""
    P = env.spec.num_players
    temp = temp or default_temp(env)
    if not all(s.kind in ("checkpoint", "random") for s in sources):
        raise ValueError("human players use the interactive path")
    dev = sources_device(sources, device if device is not None else "cuda")
    if engines is not None:
        if rng is not None:
            raise ValueError("an engine cache re-seeds its engines' own generators: pass a seed")
        engine = engines.engine(env, sources, num_envs, temp, seed, dev, chunk_steps)
    else:
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
    the text helpers' view of it. The step runs with its reset off, so the
    move that ends the game leaves its terminal state, which ``terminal``
    holds (for the final render)."""

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
            out = env.step_autoreset(self.state, self.acc, a, reset_values, u, reset=False)
        self.rewards = out.rewards[0].cpu().numpy()
        if bool(out.done[0]):
            self.terminal = out.state
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

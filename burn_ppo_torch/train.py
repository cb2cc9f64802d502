"""Training: the fused PPO train steps and the ``Trainer``.

Counterpart of burn_ppo_tpu/train.py:110-288 (``make_train_step``),
363-431 and 519-546 (``make_pool_train_step``, ``extract_pool_records``)
and 549-1302+ (``Trainer``). One update runs the rollout, the
obs-normalizer merge, the bootstrap value, GAE (multiplayer GAE with the
per-player last values for ``num_players > 1``), the return-normalizer
prefix pass and the PPO epochs; the host loop evaluates the schedules,
logs ``metrics.jsonl`` at ``log_freq`` boundaries and writes checkpoints.
The device work of an update is enqueued without waiting for the device;
the host reads the metrics (and on the vs-pool path the pool block's game
records) once per update, in one transfer. On a card a train step is two
CUDA graph replays: the rollout (``ppo/rollout_graph.py``) and the rest
of the update, every epoch and minibatch included, with the KL stop and
the empty-minibatch skip decided on the device
(``ppo/update_graph.py``); on the CPU both run eagerly on the same static
buffers.

The ``Trainer`` supports single-player runs, pure self-play, and
self-play against the opponent pool (``opponent_pool_fraction > 0``,
the MLP or CTDE, one opponent rotation per update), on CartPole, Connect
Four, Liar's Dice and Skull (a fixed player count, ``player_count``; the
scheduled ``reward_shaping_coef`` is written into the env states before
every rollout): the pool and the rating
history start with the run (or, on a resume, continue from its run dir's
files), every update samples a rotation and folds
its game records into the win rates and the rating log, and every
checkpoint joins the pool, recomputes the Plackett-Luce ratings and moves
the rating-driven ``best`` link. Each may normalize its values with
PopArt (``normalize_values``: the state in the rollout and update graphs,
kernels K15 and K16 and K8's loss) and steer its entropy coefficient with
the adaptive controller (``adaptive_entropy``: the host writes the
scheduled target, K8 steps and records the controller on the device).
Each runs fresh, resumed or forked from a checkpoint (``resume_from``):
the model, the optimizer, the normalizers (PopArt's too), the counters
and the device generator are restored (the entropy controller restarts,
as in the reference);
the env states are not (nor are they in the JAX package), so a resumed
run is deterministic, two resumes of one checkpoint equal bit for bit,
but not the uninterrupted run. Everything else raises
``NotImplementedError`` naming the ROADMAP item that ports it.
"""

from __future__ import annotations

import math
import signal
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from burn_ppo_torch.checkpoint import (
    GENERATOR_STATE,
    CheckpointManager,
    _atomic_symlink,
    build_metadata,
    load_component,
    load_generator_state,
    load_metadata,
    load_optimizer,
    load_params,
    model_leaves,
    optimizer_leaves,
)
from burn_ppo_torch.config import Config
from burn_ppo_torch.metrics import MetricsLogger
from burn_ppo_torch.progress import TrainingProgress
from burn_ppo_torch.device import resolve_device
from burn_ppo_torch.envs import make_env, registered_envs
from burn_ppo_torch.envs.base import Environment
from burn_ppo_torch.models.network import ActorCriticNetwork, make_network
from burn_ppo_torch.ppo.episode_stats import WindowedEpisodeTracker
from burn_ppo_torch.ppo.entropy import AdaptiveEntropyState
from burn_ppo_torch.ppo.normalization import ObsNormState, PopArtState
from burn_ppo_torch.ppo.pool_rollout import OpponentStack, PoolSeating
from burn_ppo_torch.ppo.rollout import (
    RandomSource,
    RolloutCarry,
    TorchRandomSource,
    init_rollout_carry,
)
from burn_ppo_torch.ppo.rollout_graph import RolloutRunner
from burn_ppo_torch.ppo.update import AdamState, resolve_shuffle_block
from burn_ppo_torch.ppo.update_graph import UpdateRunner
from burn_ppo_torch.selfplay.opponent_pool import OpponentPool
from burn_ppo_torch.selfplay.rating_history import RatingHistory


@dataclass
class TrainState:
    network: ActorCriticNetwork  # parameters, updated in place
    opt_state: AdamState
    carry: RolloutCarry
    obs_norm: Optional[ObsNormState]
    popart: Optional[PopArtState] = None  # normalize_values
    ent_state: Optional[AdaptiveEntropyState] = None  # adaptive_entropy


def build_network_for_env(env: Environment, cfg: Config, generator: torch.Generator):
    return make_network(
        env.spec,
        network_type=cfg.network_type,
        hidden_size=cfg.hidden_size,
        num_hidden=cfg.num_hidden,
        activation=cfg.activation,
        split_networks=cfg.split_networks,
        critic_hidden_size=cfg.critic_hidden_size,
        critic_num_hidden=cfg.critic_num_hidden,
        num_conv_layers=cfg.num_conv_layers,
        conv_channels=cfg.conv_channels,
        kernel_size=cfg.kernel_size,
        cnn_fc_hidden_size=cfg.cnn_fc_hidden_size,
        cnn_num_fc_layers=cfg.cnn_num_fc_layers,
        generator=generator,
    )


GUARD_METRIC_KEYS = ("invalid_mask_count", "nonfinite_count")

# (series name, metrics key): the JAX trainer's names (train.py:1758-1778).
METRIC_SERIES = (
    ("train/policy_loss", "policy_loss"),
    ("train/value_loss", "value_loss"),
    ("train/entropy", "entropy"),
    ("train/approx_kl", "approx_kl"),
    ("train/clip_fraction", "clip_fraction"),
    ("train/total_loss", "total_loss"),
    ("train/explained_variance", "explained_variance"),
    ("train/value_mean", "value_mean"),
    ("train/returns_mean", "returns_mean"),
    ("train/advantage_mean_raw", "adv_mean_raw"),
    ("train/advantage_std_raw", "adv_std_raw"),
    ("train/value_error_mean", "value_error_mean"),
    ("train/value_error_std", "value_error_std"),
    ("train/minibatch_updates", "num_minibatch_updates"),
)


def rollout_runner(env: Environment, cfg: Config,
                   num_learner_envs: Optional[int] = None) -> RolloutRunner:
    """The rollout of a train step on static buffers: a captured CUDA graph
    replayed once an update on a card, the eager loop on the CPU
    (``ppo/rollout_graph.py``). The scheduled shaping coefficient reaches
    the envs that read one (train.py:266-275)."""
    return RolloutRunner(env, num_steps=cfg.num_steps, gamma=cfg.gamma,
                         normalize_returns=cfg.effective_normalize_returns(env.spec.num_players),
                         return_clip=cfg.return_clip, num_learner_envs=num_learner_envs)


def make_train_step(env: Environment, cfg: Config):
    """Fused rollout -> GAE -> PPO update. ``train_step(state, lr, ent_coef,
    rng, shaping_coef=0.0)`` returns (state, metrics, episode logs [T, E]).
    The state's carry, obs-norm stats, the metrics and the logs are the
    step's own buffers, which its next call overwrites; with the adaptive
    entropy controller (``state.ent_state``) ``ent_coef`` is the scheduled
    target entropy (train.py:215-247); ``train_step.runner`` is its
    ``RolloutRunner`` and
    ``train_step.updater`` its ``UpdateRunner`` (whose ``outputs["stats"]``
    are the step's episode summaries)."""
    runner = rollout_runner(env, cfg)
    updater = UpdateRunner(env, cfg)

    def train_step(state: TrainState, lr: float, ent_coef: float, rng: RandomSource,
                   shaping_coef: float = 0.0):
        carry, _, logs = runner.run(state.network, state.carry, state.obs_norm, rng,
                                    shaping_coef, popart=state.popart)
        out = updater.run(state.network, state.opt_state, runner, rng, lr, ent_coef,
                          entropy=state.ent_state)
        return _stepped(state, runner, updater), out["metrics"], logs

    train_step.runner, train_step.updater = runner, updater
    return train_step


def _stepped(state: TrainState, runner: RolloutRunner, updater: UpdateRunner) -> TrainState:
    """The state after a train step: the runner's carry, obs-norm and
    PopArt stats, which the update merged the batch into, and the
    updater's entropy controller."""
    return TrainState(network=state.network, opt_state=state.opt_state, carry=runner.carry,
                      obs_norm=runner.obs_norm, popart=runner.popart,
                      ent_state=updater.entropy)


@dataclass
class PoolRecordLog:
    """The pool-env columns of the per-step logs that the win-rate and
    rating bookkeeping reads (train.py:363-374), [T, Ep(, P)]."""

    completed: torch.Tensor  # f32 1.0 where an episode ended
    outcome: torch.Tensor  # i32 placements (1-indexed)
    learner_seat: torch.Tensor  # i32 seat BEFORE the reseat (-1 = self-play)
    seat_opp: torch.Tensor  # i32 rotation slots BEFORE the resample


def make_pool_train_step(env: Environment, cfg: Config, num_learner_envs: int):
    """Vs-pool variant (train.py:377-431): the stacked opponents act on
    the pool-env block. ``train_step(state, seating, opponents, num_active,
    lr, ent_coef, rng, shaping_coef=0.0)`` returns (state, seating,
    metrics, the learner block's episode summaries, the pool block's
    ``PoolRecordLog``). The carry, the seating and the records are the
    step's own buffers, which its next call overwrites; every rotation's
    stack must have the same slot count (``refresh_rotation(pad_to=)``).
    ``train_step.runner`` is its ``RolloutRunner``, ``train_step.updater``
    its ``UpdateRunner``."""
    L = num_learner_envs
    runner = rollout_runner(env, cfg, num_learner_envs=L)
    # Only learner turns are valid: a minibatch can be all-invalid.
    updater = UpdateRunner(env, cfg, num_learner_envs=L)

    def train_step(state: TrainState, seating: PoolSeating, opponents: OpponentStack,
                   num_active: int, lr: float, ent_coef: float, rng: RandomSource,
                   shaping_coef: float = 0.0):
        _, seating, _, pool_logs = runner.run(
            state.network, state.carry, state.obs_norm, rng, shaping_coef, seating=seating,
            opponents=opponents, num_active=num_active, popart=state.popart)
        out = updater.run(state.network, state.opt_state, runner, rng, lr, ent_coef,
                          entropy=state.ent_state)
        ep = pool_logs.episode
        records = PoolRecordLog(completed=ep.completed[:, L:], outcome=ep.outcome[:, L:],
                                learner_seat=pool_logs.learner_seat[:, L:],
                                seat_opp=pool_logs.seat_opp[:, L:])
        return (_stepped(state, runner, updater), seating, out["metrics"], out["stats"],
                records)

    train_step.runner, train_step.updater = runner, updater
    return train_step


def extract_pool_records(pool_records, num_players: int) -> np.ndarray:
    """Completed pool-env episodes -> record rows [learner_place | opp_slot
    x (P-1) | opp_place x (P-1)], int32 (train.py:519-546); the fields are
    host arrays [T, Ep(, P)]."""
    P = num_players
    width = 2 * P - 1
    completed = np.asarray(pool_records.completed) > 0
    seats = np.asarray(pool_records.learner_seat, dtype=np.int32)
    sel = completed & (seats >= 0)
    if completed.size == 0 or not sel.any():
        return np.zeros((0, width), np.int32)
    outcomes = np.asarray(pool_records.outcome, dtype=np.int32)
    slots = np.asarray(pool_records.seat_opp, dtype=np.int32)
    t_idx, e_idx = np.nonzero(sel)
    place = outcomes[t_idx, e_idx]
    seat = seats[t_idx, e_idx]
    slot = slots[t_idx, e_idx]
    opp_mask = np.arange(P)[None, :] != seat[:, None]
    opp_slots = slot[opp_mask].reshape(-1, P - 1)
    opp_places = place[opp_mask].reshape(-1, P - 1)
    learner_place = place[np.arange(len(seat)), seat]
    return np.concatenate(
        [learner_place[:, None], opp_slots, opp_places], axis=1
    ).astype(np.int32)


def unsupported_config(cfg: Config) -> Optional[str]:
    """Why this config cannot run on the port yet, naming the ROADMAP item;
    None when it can."""
    if cfg.env not in registered_envs():
        return f"env {cfg.env!r}: not an env of the JAX package either"
    if cfg.env != "cartpole" and cfg.opponent_pool_fraction > 0.0:
        if cfg.network_type == "cnn":
            return ("network_type 'cnn' with the opponent pool (opponent_pool_fraction "
                    f"{cfg.opponent_pool_fraction}): ROADMAP A12b; pass "
                    "--opponent-pool-fraction 0 for pure self-play with the CNN")
        if cfg.pool_rotation_interval > 1:
            return (f"pool_rotation_interval {cfg.pool_rotation_interval} (several vs-pool "
                    "updates per rotation): ROADMAP A12c; the port rotates every update")
    if cfg.network_type == "ctde" and make_env(cfg.env).spec.privileged_obs_dim is None:
        return (f"network_type 'ctde' needs an env with privileged observations (liars_dice, "
                f"skull), not {cfg.env!r}; the JAX package cannot build it either")
    if cfg.compute_dtype is not None:
        return (f"compute_dtype {cfg.compute_dtype!r}: mixed precision, ROADMAP A18; the port "
                "trains in f32")
    if cfg.mesh_data not in (0, 1):
        return f"mesh_data {cfg.mesh_data}: multi-device training, ROADMAP A16"
    return None


def validate_config(cfg: Config) -> None:
    """Refuse what the port cannot run yet, then the reference's checks
    (``Config.validate``, on the port's env registry), then the network's
    own: a CNN needs an env with an obs shape."""
    reason = unsupported_config(cfg)
    if reason is not None:
        raise NotImplementedError(f"not supported by burn_ppo_torch yet: {reason}")
    Config.validate(cfg)
    if cfg.network_type == "cnn" and make_env(cfg.env).spec.obs_shape is None:
        raise ValueError("Invalid config:\n  network_type cnn needs an env with an obs_shape, "
                         f"not '{cfg.env}'")


# The high word that sets a resumed run's generator seed apart from a fresh
# run's where the checkpoint holds no generator state (JAX folds the same
# constant into its carry key, train.py:907-911).
RESUME_STREAM = 0x5EED << 32


class Trainer:
    """Owns the device state and the host bookkeeping of one training run:
    single-player, pure self-play, or self-play against the pool; fresh,
    or resumed or forked from a checkpoint (``resume_from``, a step dir;
    ``forked_from_run``, the parent run's name, recorded in every
    checkpoint's metadata).

    ``device`` defaults to ``"cuda"``; the CPU tests pass ``"cpu"``, where
    every kernel wrapper runs its plain PyTorch version."""

    def __init__(self, cfg: Config, run_dir: str | Path, *, device: str = "cuda",
                 quiet: bool = False, resume_from: Optional[str | Path] = None,
                 forked_from_run: Optional[str] = None):
        validate_config(cfg)
        self.cfg = cfg
        self.run_dir = Path(run_dir)
        self.run_dir.mkdir(parents=True, exist_ok=True)
        self.quiet = quiet
        self.device = resolve_device(device)
        self.num_envs = cfg.resolve_num_envs(1)
        self.env = make_env(cfg.env)
        if self.env.spec.variable_player_count:
            self.env = self.env.with_num_players(cfg.player_count.get_fixed_count())
        self.num_players = self.env.spec.num_players
        self.seed = cfg.seed if cfg.seed is not None else int(time.time()) % (2**31)
        # Two explicit generators: the parameter init draws on the CPU (the
        # same seed gives the same initial network on every device), every
        # rollout and update draw comes from one generator on the device.
        init_gen = torch.Generator().manual_seed(self.seed)
        self.generator = torch.Generator(device=self.device).manual_seed(self.seed + 1)
        self.rng = TorchRandomSource(self.generator)

        network = build_network_for_env(self.env, cfg, init_gen).to(self.device)
        self.state = TrainState(
            network=network,
            opt_state=AdamState.create(network),
            carry=init_rollout_carry(self.env, self.num_envs, self.rng, self.device),
            obs_norm=(
                ObsNormState.create(self.env.spec.obs_dim, self.device)
                if cfg.normalize_obs
                else None
            ),
            popart=PopArtState.create(self.device) if cfg.normalize_values else None,
            # A fresh controller on every start, resumes included (the
            # reference's is in memory, train.py:650-659).
            ent_state=(AdaptiveEntropyState.create(cfg.entropy_coef.get(0), self.device)
                       if cfg.adaptive_entropy is not None else None),
        )
        self.max_entropy = math.log(self.env.spec.num_actions)
        self.train_step = make_train_step(self.env, cfg)
        self.global_step = 0
        self.best_avg_return = float("-inf")
        self.ckpt = CheckpointManager(self.run_dir)
        self.metrics = MetricsLogger(self.run_dir)
        self.tracker = WindowedEpisodeTracker(self.num_players)

        # ---- opponent pool (multiplayer only, train.py:774-842) ----------
        self.pool: Optional[OpponentPool] = None
        self.rating_history: Optional[RatingHistory] = None
        self.seating: Optional[PoolSeating] = None
        self._last_num_slots: Optional[int] = None
        self._last_elo: Dict[str, float] = {}
        # Host timings logged once, at the next log, then cleared.
        self._perf_extra: Dict[str, float] = {}
        self.num_learner_envs = self.num_envs
        if cfg.opponent_pool_fraction > 0.0 and self.num_players > 1:
            pool_envs = int(round(self.num_envs * cfg.opponent_pool_fraction))
            pool_envs = (min(max(pool_envs, 1), self.num_envs - 1) if self.num_envs > 1 else 0)
            self.num_learner_envs = self.num_envs - pool_envs
            self.pool = OpponentPool(
                self.run_dir, select_alpha=cfg.opponent_select_alpha,
                select_exponent=cfg.opponent_select_exponent,
                max_active=cfg.max_active_opponents, seed=self.seed, device=self.device,
            )
            self.rating_history = RatingHistory.load(self.run_dir)
            self.seating = PoolSeating.create(self.num_envs, self.num_learner_envs,
                                              self.num_players, 1, self.rng)
            self.pool_step = make_pool_train_step(self.env, cfg, self.num_learner_envs)

        n = cfg.num_steps * self.num_envs
        block = resolve_shuffle_block(n, -(-n // cfg.num_minibatches), cfg.shuffle_block_rows)
        if block > 1 and not self.quiet:
            print(
                f"epoch shuffle: tiled, {block} rows/tile ({n} samples/update; "
                "set shuffle_block_rows = 1 for exact per-sample shuffling)"
            )
        self.forked_from = forked_from_run or cfg.forked_from
        # After the fresh carry and the seating have drawn from the
        # generator (JAX replaces the carry key after init_rollout_carry),
        # before any graph is captured.
        if resume_from is not None:
            self._restore(Path(resume_from))

    def _restore(self, ckpt_dir: Path) -> None:
        """Resume or fork (train.py:865-919): the model, the optimizer, both
        normalizers, the counters and the device generator. Every tensor is
        loaded into the buffer the fresh state made: the rollout and update
        graphs read them where they are captured, and the runners refuse
        parameters that moved."""
        meta = load_metadata(ckpt_dir)
        state = self.state
        load_params(ckpt_dir, state.network)
        load_optimizer(ckpt_dir, state.opt_state, state.network)
        on = state.obs_norm
        if on is not None and not load_component(ckpt_dir, "obs_norm", [on.mean, on.m2, on.count]):
            # A fork that turns obs normalization on from a run without it.
            if not self.quiet:
                print(f"warning: {ckpt_dir} has no obs_norm.npz; normalize_obs starts from "
                      "fresh statistics")
        rn = state.carry.return_norm  # its finalize scratch stays
        load_component(ckpt_dir, "return_norm", [rn.returns, rn.mean, rn.m2, rn.count])
        pa = state.popart
        if pa is not None and not load_component(ckpt_dir, "popart", [pa.mean, pa.m2, pa.count]):
            # A fork that turns PopArt on from a run without it (train.py:888-897).
            if not self.quiet:
                print(f"warning: {ckpt_dir} has no popart.npz; normalize_values starts from "
                      "fresh statistics")
        saved = load_generator_state(ckpt_dir)
        if saved is not None and saved.numel() == self.generator.get_state().numel():
            self.generator.set_state(saved)
        else:
            # A checkpoint JAX wrote (no generator state), or one from
            # another device type's generator: a stream distinct from the
            # fresh run's.
            self.generator.manual_seed((self.seed + 1) ^ RESUME_STREAM)
        self.global_step = int(meta["step"])
        if meta.get("best_avg_return") is not None:
            self.best_avg_return = float(meta["best_avg_return"])
        recent = meta.get("recent_returns", [])
        if recent:
            # Display only: avg_return stays continuous across the resume.
            self.tracker.seed(float(np.mean(recent)), len(recent))

    def checkpoint_leaves(self) -> Dict[str, Optional[list]]:
        """What a checkpoint holds, file by file (``<name>.npz``), in the
        saved layout; None for a feature that is off."""
        state = self.state
        on, rn, pa = state.obs_norm, state.carry.return_norm, state.popart
        return {
            "model": model_leaves(state.network),
            "optimizer": optimizer_leaves(state.opt_state),
            "obs_norm": None if on is None else [on.mean, on.m2, on.count],
            "return_norm": [rn.returns, rn.mean, rn.m2, rn.count],
            # PopArtState's leaf order (normalization.py:247-250).
            "popart": None if pa is None else [pa.mean, pa.m2, pa.count],
            GENERATOR_STATE: [self.generator.get_state()],
        }

    # ------------------------------------------------------------------
    def save_checkpoint(self) -> Path:
        state = self.state
        tr = self.tracker
        exploitability = None
        if self.pool is not None:
            perf = self.pool.get_pool_performance(self._best_ckpt_name())
            exploitability = None if perf is None else 1.0 - perf
        meta = build_metadata(
            step=self.global_step,
            env_name=self.cfg.env,
            network=state.network,
            num_players=self.num_players,
            avg_return=tr.avg_return,
            best_avg_return=None if self.best_avg_return == float("-inf") else self.best_avg_return,
            # The windowed average, repeated for its episode count; before
            # any episode of a resumed run ends, the resume seed's count
            # (train.py:979-983).
            recent_returns=[tr.avg_return] * min(100, int(tr.window_count) or tr.seed_count),
            forked_from=self.forked_from,
            rng_seed=self.seed,
            normalize_obs=self.cfg.normalize_obs,
            normalize_values=self.cfg.normalize_values,
            exploitability_vs_pool=exploitability,
        )
        leaves = self.checkpoint_leaves()
        path = self.ckpt.save(self.global_step, leaves.pop("model"), leaves.pop("optimizer"),
                              leaves, meta)
        # Single-player best follows the average return (train.py:994-998);
        # the multiplayer best is rating-driven (vs-pool runs only).
        if self.num_players == 1 and tr.avg_return > self.best_avg_return:
            self.best_avg_return = tr.avg_return
            self.ckpt.set_best(self.global_step)
        if self.pool is not None:
            self._pool_checkpoint(path)
        return path

    def _pool_checkpoint(self, path: Path) -> None:
        """The new checkpoint joins the pool (its device entry snapshotted
        from the live state), the ratings are recomputed, and the best
        rating moves the ``best`` link (train.py:999-1043)."""
        name = path.name
        self.pool.add_checkpoint(name, self.global_step)
        self.pool.seed_device_cache(name, self.state.network, self.state.obs_norm)
        t0 = time.time()
        self.rating_history.on_checkpoint_saved(name, self.global_step)
        snap = self.rating_history.compute()
        self._last_elo = {
            "train/current_elo": snap.current_elo,
            "train/best_elo": snap.best_elo,
            "train/best_step": float(snap.best_step),
            "train/rating_games": float(snap.total_games),
            "train/elo_compute_ms": snap.computation_time_ms,
        }
        self._perf_extra["perf/checkpoint_rating_time"] = time.time() - t0
        if snap.total_games > 0 and self.ckpt.step_dir(snap.best_step).exists():
            self.ckpt.set_best(snap.best_step)
        self.rating_history.generate_graph(self.run_dir / "elo_graph.png")
        if self.pool.generate_selection_graph(path / "selection_probability.png"):
            _atomic_symlink(self.run_dir / "selection_probability.png",
                            str(Path("checkpoints") / name / "selection_probability.png"))

    def _best_ckpt_name(self) -> Optional[str]:
        best = self.ckpt.dir / "best"
        return best.resolve().name if best.exists() else None

    def _apply_pool_records(self, rows: np.ndarray, active_names: Sequence[str]) -> None:
        """Fold a rotation's game records into the win-rate queues and the
        rating log (train.py:1239-1260)."""
        if rows.shape[0] == 0:
            return
        P = self.num_players
        learner_place, opp_slots, opp_places = rows[:, 0], rows[:, 1:P], rows[:, P:2 * P - 1]
        self.pool.queue_game_results_batch(active_names, learner_place, opp_slots, opp_places)
        current = self.rating_history.current_checkpoint
        if current is not None:
            self.rating_history.record_games_arrays(current, active_names, learner_place,
                                                    opp_slots, opp_places)

    # ------------------------------------------------------------------
    def _enforce_guards(self, metrics: Dict[str, float]) -> None:
        if self.cfg.runtime_guards == "off":
            return
        problems = []
        if metrics.get("invalid_mask_count", 0.0) > 0:
            problems.append(
                f"{int(metrics['invalid_mask_count'])} rollout step(s) had an EMPTY "
                "action mask (no legal action)"
            )
        if metrics.get("nonfinite_count", 0.0) > 0:
            problems.append(
                f"{int(metrics['nonfinite_count'])} non-finite log-prob/value "
                "output(s) — NaN/Inf in the forward pass"
            )
        if not problems:
            return
        msg = f"runtime guard tripped at step {self.global_step}:\n  " + "\n  ".join(problems)
        if self.cfg.runtime_guards == "raise":
            raise RuntimeError(msg + "\n(set runtime_guards = 'warn' to continue anyway)")
        print(f"WARNING: {msg}", file=sys.stderr)

    @staticmethod
    def _fetch(groups: Dict[str, Dict[str, torch.Tensor]]) -> Dict[str, dict]:
        """Every tensor of ``groups`` to the host in one transfer: 0-dim
        tensors come back as floats, the others as arrays of their shape."""
        items = [(g, k, v) for g, d in groups.items() for k, v in d.items()]
        flat = torch.cat([v.reshape(-1).to(torch.float32) for _, _, v in items]).cpu().numpy()
        out: Dict[str, dict] = {g: {} for g in groups}
        off = 0
        for g, k, v in items:
            n = v.numel()
            out[g][k] = flat[off:off + n].reshape(v.shape).copy() if v.dim() else float(flat[off])
            off += n
        return out

    def _pool_update(self, lr: float, ent_coef: float, shaping: float):
        """One vs-pool update (train.py:1425-1536): sample the rotation,
        run the pool step, fold its game records. None while the pool is
        empty (the update is then plain self-play on every env)."""
        if self.pool is None or not len(self.pool):
            return None
        stack, names = self.pool.refresh_rotation(pad_to=max(self.cfg.max_active_opponents, 1))
        if self.cfg.debug_opponents and not self.quiet:
            weights = self.pool.selection_weights()
            total_w = sum(weights.values()) or 1.0
            print(f"[opponents @ step {self.global_step}] " + " ".join(
                f"{n}(wr={self.pool.stats[n].win_rate:.2f}, p={weights[n] / total_w:.2f})"
                for n in names))
        K = len(names)
        if self._last_num_slots is not None and K < self._last_num_slots:
            # Remap stale slots into range after K shrank.
            self.seating = PoolSeating(self.seating.learner_seat, self.seating.seat_opp % K)
        self._last_num_slots = K
        self.state, self.seating, metrics_t, stats_t, records = self.pool_step(
            self.state, self.seating, stack, K, lr, ent_coef, self.rng, shaping)
        fetched = self._fetch({"metrics": metrics_t, "stats": stats_t,
                               "rec": records.__dict__})
        rec = fetched["rec"]
        rows = extract_pool_records(PoolRecordLog(**rec), self.num_players)
        self._apply_pool_records(rows, names)
        self.pool.apply_pending_updates()
        return fetched["metrics"], fetched["stats"]

    def update(self, lr: float, ent_coef: float, shaping: float):
        """One update, against the pool once it holds a checkpoint: (the
        metrics, the episode summaries), fetched to the host."""
        fetched = self._pool_update(lr, ent_coef, shaping)
        if fetched is not None:
            return fetched
        self.state, metrics_t, _ = self.train_step(self.state, lr, ent_coef, self.rng, shaping)
        fetched = self._fetch({"metrics": metrics_t,
                               "stats": self.train_step.updater.outputs["stats"]})
        return fetched["metrics"], fetched["stats"]

    # ------------------------------------------------------------------
    def train(self) -> Dict[str, float]:
        cfg = self.cfg
        steps_per_update = cfg.num_steps * self.num_envs
        max_seconds = cfg.max_training_seconds()
        start_time = time.time()
        start_step = self.global_step
        self.metrics.log_hparams(cfg.to_dict())
        cfg.save_toml(self.run_dir / "config.toml")
        progress = TrainingProgress(cfg.total_steps, start_step=self.global_step, quiet=self.quiet)

        interrupted = {"flag": False}
        prev_handlers = {}

        def _on_interrupt(sig, frame):
            interrupted["flag"] = True

        for sig in (signal.SIGINT, signal.SIGTERM):
            try:
                prev_handlers[sig] = signal.signal(sig, _on_interrupt)
            except ValueError:
                pass  # not the main thread

        last_metrics: Dict[str, float] = {}
        next_log = self.global_step + cfg.log_freq
        next_ckpt = self.global_step + cfg.checkpoint_freq
        try:
            while self.global_step < cfg.total_steps:
                if interrupted["flag"] or (
                    max_seconds is not None and time.time() - start_time > max_seconds
                ):
                    break
                lr = cfg.learning_rate.get(self.global_step)
                # With the adaptive controller the update takes the
                # scheduled target; the coefficient it used comes back in
                # the metrics (train.py:1373-1386, 1611-1620).
                ent_target = self.entropy_target(self.global_step)
                ent_coef = (cfg.entropy_coef.get(self.global_step) if ent_target is None
                            else ent_target)
                t0 = time.time()
                metrics, stats = self.update(lr, ent_coef,
                                             cfg.reward_shaping_coef.get(self.global_step))
                if ent_target is not None:
                    ent_coef = metrics["adaptive_ent_coef"]
                self.tracker.ingest(stats)
                self._enforce_guards(metrics)
                step_time = time.time() - t0
                self.global_step += steps_per_update
                last_metrics = metrics
                if self.global_step >= next_log:
                    next_log = self.global_step + cfg.log_freq
                    sps = steps_per_update / max(step_time, 1e-9)
                    self._log_metrics(metrics, lr, ent_coef, sps, ent_target)
                    self._print_progress(progress, metrics, sps)
                if self.global_step >= next_ckpt:
                    next_ckpt = self.global_step + cfg.checkpoint_freq
                    self.save_checkpoint()
            self.save_checkpoint()
            if interrupted["flag"]:
                progress.finish_interrupted()
            else:
                progress.finish("training complete")
        finally:
            for sig, handler in prev_handlers.items():
                if handler is not None:
                    signal.signal(sig, handler)
            self.metrics.flush()

        elapsed = time.time() - start_time
        return {
            "final_step": self.global_step,
            "avg_return": self.tracker.avg_return,
            "elapsed_seconds": elapsed,
            "sps": (self.global_step - start_step) / max(elapsed, 1e-9),
            **{f"train/{k}": v for k, v in last_metrics.items()},
        }

    def entropy_target(self, step: int) -> Optional[float]:
        """The adaptive controller's scheduled target entropy at ``step``,
        ``adaptive_entropy.get(step) * ln(A)``; None with it off."""
        if self.cfg.adaptive_entropy is None:
            return None
        return self.cfg.adaptive_entropy.get(step) * self.max_entropy

    def _log_metrics(self, m, lr, ent_coef, sps, ent_target: Optional[float] = None) -> None:
        """The JAX trainer's series names (train.py:1752-1841) for the
        keys the slice produces; with the adaptive controller also the
        coefficient as ``train/adaptive_ent_coef`` (the key of JAX's run
        summary)."""
        step = self.global_step
        log = self.metrics.log_scalar
        log("train/entropy_coef", ent_coef, step)
        if ent_target is not None:
            log("train/entropy_target", ent_target, step)
            log("train/adaptive_ent_coef", m["adaptive_ent_coef"], step)
        log("train/learning_rate", lr, step)
        for name, key in METRIC_SERIES:
            log(name, m[key], step)
        if m.get("avg_valid_actions", 0.0):
            log("train/avg_valid_actions", m["avg_valid_actions"], step)
            log("train/entropy_valid_pct", m["entropy_valid_pct"], step)
        for gk in GUARD_METRIC_KEYS:
            if gk in m:
                log(f"train/{gk}", m[gk], step)
        if "value_norm/mean" in m:
            log("value_norm/mean", m["value_norm/mean"], step)
            log("value_norm/std", m["value_norm/std"], step)
        if "learner_valid_fraction" in m:
            log("train/learner_valid_fraction", m["learner_valid_fraction"], step)
        log("perf/sps", sps, step)
        # Once per event (a checkpoint's rating time), as JAX's _perf_extra.
        for name, value in self._perf_extra.items():
            log(name, value, step)
        self._perf_extra = {}
        if self.device.type == "cuda":
            log("perf/device_mb_in_use", torch.cuda.memory_allocated(self.device) / 2**20, step)
            log("perf/device_mb_peak", torch.cuda.max_memory_allocated(self.device) / 2**20, step)
        tr = self.tracker
        if tr.has_data:
            log("episode/return_mean", tr.avg_return, step)
            log("episode/return_max", tr.return_max, step)
            log("episode/return_min", tr.return_min, step)
            log("episode/length_mean", tr.mean_length, step)
            log("episode/count", float(tr.total_episodes), step)
        if self.num_players > 1 and tr.has_data:
            avg_points = tr.avg_points()
            per_player = tr.per_player_returns()
            for p in range(self.num_players):
                log(f"episode/player_{p}_points", float(avg_points[p]), step)
                log(f"episode/player_{p}_return_mean", float(per_player[p]), step)
            log("episode/draw_rate", tr.draw_rate, step)
        for name, value in self._last_elo.items():
            log(name, value, step)
        if self.pool is not None:
            perf = self.pool.get_pool_performance(self._best_ckpt_name())
            if perf is not None:
                log("eval/pool_performance", perf, step)
        self.metrics.flush()

    def _print_progress(self, progress, m, sps) -> None:
        extra = (f"kl {m['approx_kl']:.4f} ent {m['entropy']:.3f} "
                 f"ev {m['explained_variance']:.2f}")
        tr = self.tracker
        if self.num_players > 1 and tr.has_data:
            progress.update_multiplayer(self.global_step, sps, list(tr.avg_points()),
                                        tr.draw_rate, elo=self._last_elo.get("train/current_elo"),
                                        extra=extra)
        else:
            progress.update(self.global_step, sps, tr.avg_return, extra=extra)

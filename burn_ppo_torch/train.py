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
records) once per update, in one transfer.

The ``Trainer`` supports fresh single-player runs, pure self-play, and
self-play against the opponent pool (``opponent_pool_fraction > 0``,
the MLP or CTDE, one opponent rotation per update), on CartPole, Connect
Four and Skull (a fixed player count, ``player_count``; the scheduled
``reward_shaping_coef`` is written into the env states before every
rollout): the pool and the rating
history start with the run, every update samples a rotation and folds
its game records into the win rates and the rating log, and every
checkpoint joins the pool, recomputes the Plackett-Luce ratings and moves
the rating-driven ``best`` link. Everything else raises
``NotImplementedError`` naming the ROADMAP item that ports it.
"""

from __future__ import annotations

import signal
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from burn_ppo_torch.checkpoint import (
    CheckpointManager,
    _atomic_symlink,
    build_metadata,
    model_leaves,
    optimizer_leaves,
)
from burn_ppo_torch.config import Config
from burn_ppo_torch.metrics import MetricsLogger
from burn_ppo_torch.progress import TrainingProgress
from burn_ppo_torch.device import resolve_device
from burn_ppo_torch.envs import make_env
from burn_ppo_torch.envs.base import Environment
from burn_ppo_torch.models.network import ActorCriticNetwork, make_network
from burn_ppo_torch.ops.gae import compute_gae, compute_gae_multiplayer
from burn_ppo_torch.ppo.episode_stats import WindowedEpisodeTracker, summarize_episode_logs
from burn_ppo_torch.ppo.normalization import ObsNormState, obs_norm_apply, obs_norm_update
from burn_ppo_torch.ppo.pool_rollout import (
    OpponentStack,
    PoolSeating,
    collect_rollouts_with_opponents,
)
from burn_ppo_torch.ppo.rollout import (
    RandomSource,
    RolloutCarry,
    TorchRandomSource,
    bootstrap_values,
    collect_rollouts,
    init_rollout_carry,
)
from burn_ppo_torch.ppo.update import AdamState, PPOUpdateConfig, ppo_update, resolve_shuffle_block
from burn_ppo_torch.selfplay.opponent_pool import OpponentPool
from burn_ppo_torch.selfplay.rating_history import RatingHistory


@dataclass
class TrainState:
    network: ActorCriticNetwork  # parameters, updated in place
    opt_state: AdamState
    carry: RolloutCarry
    obs_norm: Optional[ObsNormState]


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


def update_config(cfg: Config) -> PPOUpdateConfig:
    return PPOUpdateConfig(
        clip_epsilon=cfg.clip_epsilon,
        clip_value=cfg.clip_value,
        value_coef=cfg.value_coef,
        max_grad_norm=cfg.max_grad_norm,
        num_epochs=cfg.num_epochs,
        num_minibatches=cfg.num_minibatches,
        target_kl=cfg.target_kl,
        adam_epsilon=cfg.adam_epsilon,
        shuffle_block_rows=cfg.shuffle_block_rows,
    )


def guard_counts(batch) -> Dict[str, torch.Tensor]:
    """Runtime-guard counts over a rollout (burn_ppo_tpu/train.py:185-204):
    rows with an empty action mask, and non-finite log-probs or values."""
    return {
        "invalid_mask_count": torch.sum(
            (torch.sum(batch.action_masks, dim=-1) == 0.0).to(torch.float32)
        ),
        "nonfinite_count": torch.sum((~torch.isfinite(batch.log_probs)).to(torch.float32))
        + torch.sum((~torch.isfinite(batch.values)).to(torch.float32)),
    }


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


def _finish_step(env: Environment, cfg: Config, state: TrainState, carry: RolloutCarry,
                 batch, rng: RandomSource, lr: float, ent_coef: float,
                 may_have_invalid: bool = False):
    """Obs-normalizer merge, bootstrap, GAE, flatten and the PPO update
    after a rollout (train.py:110-249). Returns (state', metrics)."""
    net = state.network
    # Lagged obs normalization: the stats absorb this rollout's raw
    # batch AFTER it; the bootstrap uses the new stats, the update
    # re-normalizes the batch with the stats the rollout used.
    obs_norm_new = (
        obs_norm_update(state.obs_norm, batch.obs) if state.obs_norm is not None else None
    )
    last_values, last_vpp = bootstrap_values(net, env, carry, obs_norm_new)
    if env.spec.num_players > 1:
        advantages, returns = compute_gae_multiplayer(
            batch.all_rewards, batch.values, batch.dones, batch.acting_players, last_vpp,
            cfg.gamma, cfg.gae_lambda,
        )
    else:
        advantages, returns = compute_gae(
            batch.rewards, batch.values, batch.dones, last_values, cfg.gamma, cfg.gae_lambda
        )
    T, E = batch.actions.shape
    N = T * E
    obs_u = obs_norm_apply(state.obs_norm, batch.obs) if state.obs_norm is not None else batch.obs
    data = {
        "obs": obs_u.reshape(N, -1),
        "actions": batch.actions.reshape(N),
        "old_log_probs": batch.log_probs.reshape(N),
        "advantages": advantages.reshape(N),
        "returns": returns.reshape(N),
        "old_values": batch.values.reshape(N),
        "valid": batch.valid_mask.reshape(N),
        "action_masks": batch.action_masks.reshape(N, env.spec.num_actions),
    }
    if batch.privileged_obs is not None:
        data["privileged_obs"] = batch.privileged_obs.reshape(N, -1)
    metrics = ppo_update(net, state.opt_state, data, rng, lr, ent_coef, update_config(cfg),
                         may_have_invalid=may_have_invalid)
    if cfg.runtime_guards != "off":
        metrics.update(guard_counts(batch))
    return TrainState(network=net, opt_state=state.opt_state, carry=carry,
                      obs_norm=obs_norm_new), metrics


def _env_context(env: Environment, shaping_coef: float) -> Optional[dict]:
    """The scheduled shaping coefficient for envs that read one
    (train.py:266-275)."""
    return {"shaping_coef": shaping_coef} if "shaping_coef" in env.context_fields else None


def make_train_step(env: Environment, cfg: Config):
    """Fused rollout -> GAE -> PPO update. ``train_step(state, lr, ent_coef,
    rng, shaping_coef=0.0)`` returns (state, metrics, episode logs [T, E])."""
    normalize_returns = cfg.effective_normalize_returns(env.spec.num_players)

    def train_step(state: TrainState, lr: float, ent_coef: float, rng: RandomSource,
                   shaping_coef: float = 0.0):
        carry, batch, logs = collect_rollouts(
            state.network, env, state.carry, state.obs_norm, rng,
            num_steps=cfg.num_steps, gamma=cfg.gamma,
            normalize_returns=normalize_returns, return_clip=cfg.return_clip,
            env_context=_env_context(env, shaping_coef),
        )
        new_state, metrics = _finish_step(env, cfg, state, carry, batch, rng, lr, ent_coef)
        return new_state, metrics, logs

    return train_step


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
    ``PoolRecordLog``)."""
    normalize_returns = cfg.effective_normalize_returns(env.spec.num_players)
    L = num_learner_envs

    def train_step(state: TrainState, seating: PoolSeating, opponents: OpponentStack,
                   num_active: int, lr: float, ent_coef: float, rng: RandomSource,
                   shaping_coef: float = 0.0):
        carry, seating, batch, pool_logs = collect_rollouts_with_opponents(
            state.network, env, opponents, state.carry, seating, state.obs_norm, rng,
            num_steps=cfg.num_steps, num_learner_envs=L, num_active=num_active,
            gamma=cfg.gamma, normalize_returns=normalize_returns, return_clip=cfg.return_clip,
            env_context=_env_context(env, shaping_coef),
        )
        # Only learner turns are valid: a minibatch can be all-invalid.
        new_state, metrics = _finish_step(env, cfg, state, carry, batch, rng, lr, ent_coef,
                                          may_have_invalid=True)
        metrics["learner_valid_fraction"] = torch.mean(batch.valid_mask)
        learner_stats = summarize_episode_logs(pool_logs.episode, env.spec.num_players,
                                               num_envs=L)
        ep = pool_logs.episode
        records = PoolRecordLog(completed=ep.completed[:, L:], outcome=ep.outcome[:, L:],
                                learner_seat=pool_logs.learner_seat[:, L:],
                                seat_opp=pool_logs.seat_opp[:, L:])
        return new_state, seating, metrics, learner_stats, records

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
    if cfg.env == "liars_dice":
        return f"env {cfg.env!r}: ROADMAP A13/B12"
    if cfg.env not in ("cartpole", "connect_four", "skull"):
        return f"env {cfg.env!r}: not an env of the JAX package either"
    if cfg.env != "cartpole" and cfg.opponent_pool_fraction > 0.0:
        if cfg.network_type == "cnn":
            return ("network_type 'cnn' with the opponent pool (opponent_pool_fraction "
                    f"{cfg.opponent_pool_fraction}): ROADMAP A12b; pass "
                    "--opponent-pool-fraction 0 for pure self-play with the CNN")
        if cfg.pool_rotation_interval > 1:
            return (f"pool_rotation_interval {cfg.pool_rotation_interval} (several vs-pool "
                    "updates per rotation): ROADMAP A12c; the port rotates every update")
    if cfg.network_type == "ctde" and cfg.env != "skull":
        return (f"network_type 'ctde' needs an env with privileged observations (skull), "
                f"not {cfg.env!r}; the JAX package cannot build it either")
    if cfg.normalize_values:
        return "normalize_values (PopArt): ROADMAP A14"
    if cfg.adaptive_entropy is not None:
        return "adaptive_entropy: ROADMAP A11"
    if cfg.compute_dtype is not None:
        return f"compute_dtype {cfg.compute_dtype!r}: not on the port's f32 path"
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


class Trainer:
    """Owns the device state and the host bookkeeping of one fresh training
    run: single-player, pure self-play, or self-play against the pool.

    ``device`` defaults to ``"cuda"``; the CPU tests pass ``"cpu"``, where
    every kernel wrapper runs its plain PyTorch version."""

    def __init__(self, cfg: Config, run_dir: str | Path, *, device: str = "cuda",
                 quiet: bool = False):
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
        )
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

    # ------------------------------------------------------------------
    def save_checkpoint(self) -> Path:
        state = self.state
        tr = self.tracker
        rn = state.carry.return_norm
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
            recent_returns=[tr.avg_return] * min(100, int(tr.window_count)),
            rng_seed=self.seed,
            normalize_obs=self.cfg.normalize_obs,
            exploitability_vs_pool=exploitability,
        )
        on = state.obs_norm
        path = self.ckpt.save(
            self.global_step,
            model_leaves(state.network),
            optimizer_leaves(state.opt_state),
            {
                "obs_norm": None if on is None else [on.mean, on.m2, on.count],
                "return_norm": [rn.returns, rn.mean, rn.m2, rn.count],
            },
            meta,
        )
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
            "perf/checkpoint_rating_time": time.time() - t0,
        }
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
                ent_coef = cfg.entropy_coef.get(self.global_step)
                shaping = cfg.reward_shaping_coef.get(self.global_step)
                t0 = time.time()
                fetched = self._pool_update(lr, ent_coef, shaping)
                if fetched is None:
                    self.state, metrics_t, logs = self.train_step(self.state, lr, ent_coef,
                                                                  self.rng, shaping)
                    fetched = self._fetch({
                        "metrics": metrics_t,
                        "stats": summarize_episode_logs(logs, self.num_players),
                    })
                    fetched = fetched["metrics"], fetched["stats"]
                metrics, stats = fetched
                self.tracker.ingest(stats)
                self._enforce_guards(metrics)
                step_time = time.time() - t0
                self.global_step += steps_per_update
                last_metrics = metrics
                if self.global_step >= next_log:
                    next_log = self.global_step + cfg.log_freq
                    sps = steps_per_update / max(step_time, 1e-9)
                    self._log_metrics(metrics, lr, ent_coef, sps)
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

    def _log_metrics(self, m, lr, ent_coef, sps) -> None:
        """The JAX trainer's series names (train.py:1752-1841) for the
        keys the slice produces."""
        step = self.global_step
        log = self.metrics.log_scalar
        log("train/entropy_coef", ent_coef, step)
        log("train/learning_rate", lr, step)
        for name, key in METRIC_SERIES:
            log(name, m[key], step)
        if m.get("avg_valid_actions", 0.0):
            log("train/avg_valid_actions", m["avg_valid_actions"], step)
            log("train/entropy_valid_pct", m["entropy_valid_pct"], step)
        for gk in GUARD_METRIC_KEYS:
            if gk in m:
                log(f"train/{gk}", m[gk], step)
        if "learner_valid_fraction" in m:
            log("train/learner_valid_fraction", m["learner_valid_fraction"], step)
        log("perf/sps", sps, step)
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

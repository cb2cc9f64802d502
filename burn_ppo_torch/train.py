"""Training: the fused PPO train step and the ``Trainer``.

Counterpart of burn_ppo_tpu/train.py:110-288 (``make_train_step``) and
549-704, 1303+ (``Trainer``). One update runs the rollout, the
obs-normalizer merge, the bootstrap value, GAE (multiplayer GAE with the
per-player last values for ``num_players > 1``), the return-normalizer
prefix pass and the PPO epochs; the host loop evaluates the schedules,
logs ``metrics.jsonl`` at ``log_freq`` boundaries and writes checkpoints.
The device work of an update is enqueued without waiting for the device;
the host reads the metrics once per update, in one transfer.

The ``Trainer`` supports fresh single-player runs and pure self-play (one
learner in every seat, ``opponent_pool_fraction = 0``). Everything else
raises ``NotImplementedError`` naming the ROADMAP item that ports it.
"""

from __future__ import annotations

import signal
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Optional

import torch

from burn_ppo_tpu.config import Config
from burn_ppo_tpu.metrics import MetricsLogger
from burn_ppo_tpu.progress import TrainingProgress
from burn_ppo_torch.checkpoint import (
    CheckpointManager,
    build_metadata,
    model_leaves,
    optimizer_leaves,
)
from burn_ppo_torch.device import resolve_device
from burn_ppo_torch.envs import make_env
from burn_ppo_torch.envs.base import Environment
from burn_ppo_torch.models.network import ActorCriticNetwork, make_network
from burn_ppo_torch.ops.gae import compute_gae, compute_gae_multiplayer
from burn_ppo_torch.ppo.episode_stats import WindowedEpisodeTracker, summarize_episode_logs
from burn_ppo_torch.ppo.normalization import ObsNormState, obs_norm_apply, obs_norm_update
from burn_ppo_torch.ppo.rollout import (
    RandomSource,
    RolloutCarry,
    TorchRandomSource,
    bootstrap_values,
    collect_rollouts,
    init_rollout_carry,
)
from burn_ppo_torch.ppo.update import AdamState, PPOUpdateConfig, ppo_update, resolve_shuffle_block


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


def make_train_step(env: Environment, cfg: Config):
    """Fused rollout -> GAE -> PPO update. ``train_step(state, lr, ent_coef,
    rng)`` returns (state, metrics, episode logs [T, E])."""
    multiplayer = env.spec.num_players > 1
    normalize_returns = cfg.effective_normalize_returns(env.spec.num_players)
    ucfg = update_config(cfg)

    def train_step(state: TrainState, lr: float, ent_coef: float, rng: RandomSource):
        net = state.network
        carry, batch, logs = collect_rollouts(
            net, env, state.carry, state.obs_norm, rng,
            num_steps=cfg.num_steps, gamma=cfg.gamma,
            normalize_returns=normalize_returns, return_clip=cfg.return_clip,
        )
        # Lagged obs normalization: the stats absorb this rollout's raw
        # batch AFTER it; the bootstrap uses the new stats, the update
        # re-normalizes the batch with the stats the rollout used.
        obs_norm_new = (
            obs_norm_update(state.obs_norm, batch.obs) if state.obs_norm is not None else None
        )
        last_values, last_vpp = bootstrap_values(net, env, carry, obs_norm_new)
        if multiplayer:
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
        metrics = ppo_update(net, state.opt_state, data, rng, lr, ent_coef, ucfg)
        if cfg.runtime_guards != "off":
            metrics.update(guard_counts(batch))
        new_state = TrainState(
            network=net, opt_state=state.opt_state, carry=carry, obs_norm=obs_norm_new
        )
        return new_state, metrics, logs

    return train_step


def unsupported_config(cfg: Config) -> Optional[str]:
    """Why this config cannot run on the port yet, naming the ROADMAP item;
    None when it can."""
    if cfg.env in ("liars_dice", "skull"):
        return f"env {cfg.env!r}: ROADMAP A13"
    if cfg.env not in ("cartpole", "connect_four"):
        return f"env {cfg.env!r}: not an env of the JAX package either"
    if cfg.env == "connect_four" and cfg.opponent_pool_fraction > 0.0:
        return (f"opponent_pool_fraction {cfg.opponent_pool_fraction} (the opponent pool): "
                "ROADMAP A12; pass --opponent-pool-fraction 0 for pure self-play")
    if cfg.network_type == "ctde":
        return "network_type 'ctde': ROADMAP A14"
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
    """The reference's config checks that apply to the slice.

    ``Config.validate`` also checks the env name against the JAX env
    registry, which imports JAX; the port checks its own env instead."""
    reason = unsupported_config(cfg)
    if reason is not None:
        raise NotImplementedError(f"not supported by burn_ppo_torch yet: {reason}")
    errors = []
    if cfg.num_steps <= 0:
        errors.append("num_steps must be > 0")
    if not 0.0 < cfg.gamma <= 1.0:
        errors.append("gamma must be in (0, 1]")
    if not 0.0 <= cfg.gae_lambda <= 1.0:
        errors.append("gae_lambda must be in [0, 1]")
    if not 0.0 < cfg.clip_epsilon < 1.0:
        errors.append("clip_epsilon must be in (0, 1)")
    if cfg.activation not in ("relu", "tanh"):
        errors.append(f"activation must be relu|tanh, got '{cfg.activation}'")
    if cfg.network_type not in ("mlp", "cnn"):
        errors.append(f"network_type must be mlp|cnn|ctde, got '{cfg.network_type}'")
    if cfg.network_type == "cnn" and make_env(cfg.env).spec.obs_shape is None:
        errors.append(f"network_type cnn needs an env with an obs_shape, not '{cfg.env}'")
    if cfg.network_type == "cnn" and cfg.num_conv_layers < 1:
        errors.append("num_conv_layers must be >= 1 for network_type=cnn")
    if cfg.num_epochs <= 0 or cfg.num_minibatches <= 0:
        errors.append("num_epochs and num_minibatches must be > 0")
    if cfg.learning_rate.initial_value() <= 0:
        errors.append("learning_rate must be > 0")
    if cfg.entropy_coef.initial_value() < 0:
        errors.append("entropy_coef must be >= 0")
    if cfg.runtime_guards not in ("raise", "warn", "off"):
        errors.append("runtime_guards must be raise|warn|off")
    if cfg.max_training_time is not None:
        try:
            cfg.max_training_seconds()
        except ValueError as e:
            errors.append(str(e))
    if errors:
        raise ValueError("Invalid config:\n  " + "\n  ".join(errors))


class Trainer:
    """Owns the device state and the host bookkeeping of one fresh training
    run, single-player or pure self-play.

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
        # the multiplayer best is rating-driven and arrives with the pool (A12).
        if self.num_players == 1 and tr.avg_return > self.best_avg_return:
            self.best_avg_return = tr.avg_return
            self.ckpt.set_best(self.global_step)
        return path

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

    def _fetch(self, metrics: Dict[str, torch.Tensor], stats: Dict[str, torch.Tensor]):
        """Metrics and episode summaries to the host in one transfer."""
        items = list(metrics.items()) + list(stats.items())
        flat = torch.cat([v.reshape(-1).to(torch.float32) for _, v in items]).cpu().numpy()
        out, off = {}, 0
        for k, v in items:
            n = v.numel()
            out[k] = flat[off:off + n].copy() if v.dim() else float(flat[off])
            off += n
        return {k: out[k] for k in metrics}, {k: out[k] for k in stats}

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
                t0 = time.time()
                self.state, metrics_t, logs = self.train_step(self.state, lr, ent_coef, self.rng)
                metrics, stats = self._fetch(metrics_t,
                                             summarize_episode_logs(logs, self.num_players))
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
        self.metrics.flush()

    def _print_progress(self, progress, m, sps) -> None:
        extra = (f"kl {m['approx_kl']:.4f} ent {m['entropy']:.3f} "
                 f"ev {m['explained_variance']:.2f}")
        tr = self.tracker
        if self.num_players > 1 and tr.has_data:
            progress.update_multiplayer(self.global_step, sps, list(tr.avg_points()),
                                        tr.draw_rate, extra=extra)
        else:
            progress.update(self.global_step, sps, tr.avg_return, extra=extra)

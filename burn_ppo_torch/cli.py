"""Command line of the port: the ``train``, ``eval``, ``tournament`` and ``interactive`` subcommands.

The parser and the override collection are copies of
burn_ppo_tpu/cli.py:31-231, so the flags, the subcommands and the TOML
grammar are the same as the JAX CLI's, and so are ``--resume``,
``--fork`` (burn_ppo_tpu/cli.py:300-356) and the supervisor mode,
``--reload-every-n-checkpoints N`` (234-278: ``supervisor.py`` respawns
the training as a child process every N checkpoints). The port runs on
CUDA. Flags and inputs the port does not have yet (a Burn ``.mpk``
checkpoint) are refused with exit 2 and an error naming the ROADMAP item,
never ignored.

    python -m burn_ppo_torch train --config configs/cartpole.toml
    python -m burn_ppo_torch train --config configs/cartpole.toml --reload-every-n-checkpoints 1
    python -m burn_ppo_torch train --resume runs/<name> --total-steps N
    python -m burn_ppo_torch train --fork runs/<name>/checkpoints/step_X [overrides]
    python -m burn_ppo_torch eval -c gauntlet/connect_four/r4 --random
    python -m burn_ppo_torch tournament gauntlet/skull/r4 gauntlet/skull/r4_mid --random --players 4
    python -m burn_ppo_torch interactive gauntlet/skull   # the Skull assistant on localhost:3000
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional

from burn_ppo_torch.config import Config, generate_run_name


def _add_train_parser(sub):
    p = sub.add_parser("train", help="Train a model (default subcommand)")
    p.add_argument("-c", "--config", default="configs/cartpole.toml",
                   help="Path to TOML config file")
    p.add_argument("--resume", metavar="RUN_DIR",
                   help="Resume an existing run (same config)")
    p.add_argument("--fork", metavar="CHECKPOINT",
                   help="Fork from a checkpoint (new run, config changes allowed)")
    p.add_argument("--run-name", help="Run name (under the runs base dir)")
    p.add_argument("--run-dir", help="Explicit run directory")
    p.add_argument("--runs-base", default="runs", help="Base directory for runs")
    p.add_argument("--quiet", action="store_true", help="Suppress progress output")
    p.add_argument("--platform", choices=["tpu", "cpu"], default=None,
                   help="Force a JAX platform (default: ambient)")
    p.add_argument("--reload-every-n-checkpoints", type=int, default=0,
                   help="Supervisor mode: respawn training as a subprocess "
                        "every N checkpoints (0 = off; reference default 10)")
    p.add_argument("--max-checkpoints-this-run", type=int, default=0,
                   help=argparse.SUPPRESS)  # internal (supervisor child)
    p.add_argument("--multihost", action="store_true",
                   help="Initialize jax.distributed (TPU pod auto-detect, or "
                        "BURN_PPO_COORDINATOR/NUM_PROCESSES/PROCESS_ID env vars)")
    p.add_argument("--profile-dir", default=None,
                   help="Capture a jax.profiler trace into this directory")
    p.add_argument("--profile-start", type=int, default=1,
                   help="Update index at which the trace starts")
    p.add_argument("--profile-updates", type=int, default=2,
                   help="Number of updates to trace")
    p.add_argument("--checkify", action="store_true",
                   help="Debug mode: functionalized NaN/div checks through "
                        "the train step (reference runtime asserts, "
                        "ppo.rs:363-366); ~2x slower")
    p.add_argument("--profile-phases", action="store_true",
                   help="Unfused diagnostic mode: time rollout/GAE/update "
                        "separately (logs perf/rollout_time etc.)")
    p.add_argument("--compilation-cache", default="auto", metavar="DIR|auto|off",
                   help="Persistent XLA compilation cache directory "
                        "('auto' = ~/.cache/burn_ppo_tpu/xla_cache or "
                        "$BURN_PPO_COMPILE_CACHE; 'off' disables). "
                        "Supervisor children and resumed runs hit the "
                        "cache instead of recompiling")
    p.add_argument("--elapsed-time-offset-ms", type=int, default=0,
                   help=argparse.SUPPRESS)  # internal (supervisor child)

    # --- config overrides (names match TOML keys) ---
    p.add_argument("--env")
    p.add_argument("--num-envs")
    p.add_argument("--num-steps", type=int)
    p.add_argument("--learning-rate", help="e.g. '0.0003' or '0.001@0,0.0001@30M'")
    p.add_argument("--entropy-coef")
    p.add_argument("--adaptive-entropy")
    p.add_argument("--reward-shaping-coef")
    p.add_argument("--gamma", type=float)
    p.add_argument("--gae-lambda", type=float)
    p.add_argument("--clip-epsilon", type=float)
    p.add_argument("--value-coef", type=float)
    p.add_argument("--max-grad-norm", type=float)
    p.add_argument("--target-kl", type=float)
    p.add_argument("--total-steps", type=int)
    p.add_argument("--max-training-time")
    p.add_argument("--num-epochs", type=int)
    p.add_argument("--num-minibatches", type=int)
    p.add_argument("--adam-epsilon", type=float)
    p.add_argument("--seed", type=int)
    p.add_argument("--hidden-size", type=int)
    p.add_argument("--num-hidden", type=int)
    p.add_argument("--activation", choices=["relu", "tanh"])
    p.add_argument("--network-type", choices=["mlp", "cnn", "ctde"])
    p.add_argument("--critic-hidden-size", type=int)
    p.add_argument("--critic-num-hidden", type=int)
    p.add_argument("--num-conv-layers", type=int)
    p.add_argument("--kernel-size", type=int)
    p.add_argument("--cnn-fc-hidden-size", type=int)
    p.add_argument("--cnn-num-fc-layers", type=int)
    p.add_argument("--adaptive-entropy-min-coef", type=float)
    p.add_argument("--adaptive-entropy-max-coef", type=float)
    p.add_argument("--adaptive-entropy-delta", type=float)
    p.add_argument("--checkpoint-freq", type=int)
    p.add_argument("--log-freq", type=int)
    p.add_argument("--opponent-pool-fraction", type=float)
    p.add_argument("--opponent-select-alpha", type=float)
    p.add_argument("--opponent-select-exponent", type=float)
    p.add_argument("--pool-rotation-interval", type=int,
                   help="PPO updates per opponent rotation (1 = reference "
                        "per-update cadence; >1 fuses that many vs-pool "
                        "updates into one device window)")
    p.add_argument("--max-active-opponents", type=int)
    p.add_argument("--players", type=int, help="Fixed player count (variable-count games)")
    p.add_argument("--compute-dtype", choices=["bfloat16"])
    p.add_argument("--mesh-data", type=int, help="Data-parallel mesh size (0 = all devices)")
    p.add_argument("--shuffle-block-rows", type=int,
                   help="Epoch-shuffle tile size (0 = auto, 1 = exact)")
    # --x / --no-x tri-state booleans (config.rs:142-257)
    for flag in ("normalize-obs", "normalize-returns", "normalize-values",
                 "clip-value", "split-networks", "debug-opponents"):
        p.add_argument(f"--{flag}", action=argparse.BooleanOptionalAction, default=None)
    return p


def _add_eval_parser(sub):
    p = sub.add_parser("eval", help="Evaluate trained models")
    p.add_argument("-c", "--checkpoint", action="append", default=[],
                   dest="checkpoints", help="Checkpoint path (repeatable, one per player)")
    p.add_argument("--human", action="append", default=[], dest="humans",
                   help="Human player name (repeatable)")
    p.add_argument("--random", action="store_true", help="Add a random baseline player")
    p.add_argument("-e", "--env", dest="env_name", help="Environment (if no checkpoint)")
    p.add_argument("-n", "--num-games", type=int, default=100)
    p.add_argument("--num-envs", type=int, default=64)
    p.add_argument("--watch", action="store_true", help="Render games step by step")
    p.add_argument("--step", action="store_true", help="Press Enter to advance")
    p.add_argument("--animate", action="store_true")
    p.add_argument("--fps", type=int, default=10)
    p.add_argument("--seed", type=int)
    p.add_argument("--temp", type=float, help="Initial softmax temperature")
    p.add_argument("--temp-final", type=float)
    p.add_argument("--temp-cutoff", type=int)
    p.add_argument("--no-temp-cutoff", action="store_true")
    p.add_argument("--temp-decay", action="store_true")
    p.add_argument("--players", type=int)
    p.add_argument("--parity-ratings", action="store_true",
                   help="Print the reference's exact stats-mode rating "
                        "table (per seat-slot over all games, anchor "
                        "slot 0, +/- 1 sigma; eval.rs:591-644) instead "
                        "of the merged-by-source table")
    return p


def _add_tournament_parser(sub):
    p = sub.add_parser("tournament", help="Swiss/round-robin tournament with ratings")
    p.add_argument("sources", nargs="+", help="Checkpoint paths or run directories")
    p.add_argument("-n", "--num-games", type=int, default=100,
                   help="Games per matchup")
    p.add_argument("--num-envs", type=int, default=64)
    p.add_argument("--rounds", type=int, help="Swiss rounds (default auto)")
    p.add_argument("--limit-per-run", type=int)
    p.add_argument("--random", action="store_true")
    p.add_argument("--temp", type=float)
    p.add_argument("--temp-final", type=float)
    p.add_argument("--temp-cutoff", type=int)
    p.add_argument("--no-temp-cutoff", action="store_true")
    p.add_argument("--seed", type=int)
    p.add_argument("-o", "--output", help="Save results JSON")
    p.add_argument("--graph", action="store_true", help="Rating-over-steps graph")
    p.add_argument("--round-robin", action="store_true")
    p.add_argument("--players", type=int)
    return p


def _add_interactive_parser(sub):
    p = sub.add_parser("interactive", help="Web UI game assistant")
    p.add_argument("sources", nargs="+", help="Checkpoint paths or run directories")
    p.add_argument("--limit-per-run", type=int, default=1)
    p.add_argument("-p", "--port", type=int, default=3000)
    p.add_argument("--host", default="127.0.0.1",
                   help="Bind address (loopback by default; the API has "
                        "no auth, so widen deliberately)")
    return p


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="burn-ppo-torch",
        description="PPO self-play framework, PyTorch/CUDA port",
    )
    parser.add_argument("--version", action="version", version="burn-ppo-torch 0.1.0")
    sub = parser.add_subparsers(dest="command")
    _add_train_parser(sub)
    _add_eval_parser(sub)
    _add_tournament_parser(sub)
    _add_interactive_parser(sub)
    return parser


TRAIN_OVERRIDE_KEYS = [
    "env", "num_envs", "num_steps", "learning_rate", "entropy_coef",
    "adaptive_entropy", "reward_shaping_coef", "gamma", "gae_lambda",
    "clip_epsilon", "value_coef", "max_grad_norm", "target_kl",
    "total_steps", "max_training_time", "num_epochs", "num_minibatches",
    "adam_epsilon", "seed", "hidden_size", "num_hidden", "activation",
    "network_type", "critic_hidden_size", "critic_num_hidden",
    "num_conv_layers", "kernel_size", "cnn_fc_hidden_size",
    "cnn_num_fc_layers", "adaptive_entropy_min_coef",
    "adaptive_entropy_max_coef", "adaptive_entropy_delta",
    "checkpoint_freq", "log_freq", "opponent_pool_fraction",
    "opponent_select_alpha", "opponent_select_exponent",
    "pool_rotation_interval", "max_active_opponents", "compute_dtype",
    "mesh_data", "shuffle_block_rows", "normalize_obs", "normalize_returns",
    "normalize_values", "clip_value", "split_networks", "debug_opponents",
]


def collect_overrides(args) -> Dict[str, Any]:
    overrides: Dict[str, Any] = {}
    for key in TRAIN_OVERRIDE_KEYS:
        v = getattr(args, key, None)
        if v is not None:
            overrides[key] = v
    if getattr(args, "players", None) is not None:
        overrides["player_count"] = args.players
    return overrides



def refused_flags(args) -> List[str]:
    """The flags of ``args`` that the port does not support yet. Config
    values it cannot run (env, network type, compute dtype, ...), from a
    flag or from the TOML, are refused by ``train.unsupported_config``."""
    refused = []
    checks = (
        (args.multihost, "--multihost (ROADMAP A16)"),
        (args.profile_dir is not None or args.profile_phases
         or args.profile_start != 1 or args.profile_updates != 2,
         "--profile-* (ROADMAP A17: profiling tools)"),
        (args.checkify, "--checkify (JAX-only debug mode)"),
        (args.platform is not None, "--platform (the port runs on CUDA)"),
        (args.compilation_cache != "auto", "--compilation-cache (XLA-only)"),
    )
    for bad, what in checks:
        if bad:
            refused.append(what)
    return refused


def _train_config(args, runs_base: Path):
    """(config, run dir, Trainer keywords) of a fresh run, a ``--resume``
    or a ``--fork`` (burn_ppo_tpu/cli.py:300-356); an int is the exit
    code of a refusal, its error printed."""
    overrides = collect_overrides(args)
    if args.resume:
        run_dir = Path(args.resume)
        if not (run_dir / "config.toml").exists():
            print(f"error: no config.toml in {run_dir}", file=sys.stderr)
            return 1
        try:
            cfg = Config.load(run_dir / "config.toml").apply_overrides(overrides, resume=True)
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        latest = run_dir / "checkpoints" / "latest"
        if not latest.exists():
            print(f"error: no checkpoints/latest in {run_dir}", file=sys.stderr)
            return 1
        return cfg, run_dir, {"resume_from": latest.resolve()}
    if args.fork:
        ckpt = Path(args.fork)
        if not (ckpt / "metadata.json").exists():
            print(f"error: {ckpt} is not a checkpoint directory", file=sys.stderr)
            return 1
        parent_run = ckpt.resolve().parent.parent  # runs/<name>/checkpoints/step_X
        parent_cfg = parent_run / "config.toml"
        cfg = Config.load(parent_cfg if parent_cfg.exists() else args.config)
        cfg = cfg.apply_overrides(overrides)
        cfg.forked_from = parent_run.name
        cfg.run_name = args.run_name or generate_run_name(runs_base, cfg.env,
                                                          parent=parent_run.name)
        run_dir = Path(args.run_dir) if args.run_dir else runs_base / cfg.run_name
        return cfg, run_dir, {"resume_from": ckpt.resolve(), "forked_from_run": parent_run.name}
    cfg = Config.load(args.config).apply_overrides(overrides)
    cfg.run_name = args.run_name or cfg.run_name or generate_run_name(runs_base, cfg.env)
    run_dir = Path(args.run_dir) if args.run_dir else runs_base / cfg.run_name
    if (run_dir / "checkpoints" / "latest").exists():
        print(f"error: run dir {run_dir} already has checkpoints; use --resume or --fork",
              file=sys.stderr)
        return 1
    return cfg, run_dir, {}


def without_reload_flag(argv: List[str]) -> List[str]:
    """``argv`` without ``--reload-every-n-checkpoints`` and its value
    (both the ``--flag value`` and the ``--flag=value`` form)."""
    out, skip = [], False
    for a in argv:
        if skip:
            skip = False
        elif a == "--reload-every-n-checkpoints":
            skip = True
        elif not a.startswith("--reload-every-n-checkpoints="):
            out.append(a)
    return out


def supervise(args, argv: List[str]) -> int:
    """Supervisor mode (burn_ppo_tpu/cli.py:234-278, the reference's
    main.rs:1700-1784): the run respawned as a child process, ``python -m
    burn_ppo_torch train``, every ``--reload-every-n-checkpoints``
    checkpoints; ``argv`` is the train subcommand's arguments. A fresh run
    gets its run dir fixed here (``--run-dir``), so that every child
    trains into it."""
    from burn_ppo_torch.supervisor import TrainingSupervisor
    from burn_ppo_torch.train import unsupported_config

    runs_base = Path(args.runs_base)
    if args.resume:
        run_dir = Path(args.resume)
        cfg = Config.load(run_dir / "config.toml")
    else:
        cfg = Config.load(args.config).apply_overrides(collect_overrides(args))
        run_name = args.run_name or cfg.run_name or generate_run_name(runs_base, cfg.env)
        run_dir = Path(args.run_dir) if args.run_dir else runs_base / run_name
    reason = unsupported_config(cfg)
    if reason is not None:
        print(f"error: config {args.resume or args.config} is not supported by burn_ppo_torch "
              f"yet: {reason}", file=sys.stderr)
        return 2
    child_args = without_reload_flag(argv)
    if "--run-dir" not in child_args and not args.resume:
        child_args += ["--run-dir", str(run_dir)]
    return TrainingSupervisor(
        run_dir, child_args, reload_every_n_checkpoints=args.reload_every_n_checkpoints,
        total_steps=args.total_steps or cfg.total_steps, quiet=args.quiet,
    ).run()


def run_train(args, device: str = "cuda", argv: Optional[List[str]] = None) -> int:
    """``train``: a supervised run (its children on the command line's
    device, CUDA), or one Trainer on ``device``. ``argv`` is the
    subcommand's arguments, which a supervisor hands its children."""
    from burn_ppo_torch.train import Trainer, unsupported_config

    refused = refused_flags(args)
    if refused:
        print("error: not supported by burn_ppo_torch yet: " + "; ".join(refused),
              file=sys.stderr)
        return 2
    # Children are marked by --max-checkpoints-this-run; a fork is never
    # supervised (as in JAX).
    if args.reload_every_n_checkpoints > 0 and args.max_checkpoints_this_run == 0 \
            and not args.fork:
        return supervise(args, list(argv or []))
    setup = _train_config(args, Path(args.runs_base))
    if isinstance(setup, int):
        return setup
    cfg, run_dir, resume = setup
    reason = unsupported_config(cfg)
    if reason is not None:
        source = args.resume or args.fork or args.config
        print(f"error: config {source} is not supported by burn_ppo_torch yet: {reason}",
              file=sys.stderr)
        return 2
    trainer = Trainer(cfg, run_dir, device=device, quiet=args.quiet,
                      max_checkpoints_this_run=args.max_checkpoints_this_run,
                      elapsed_time_offset=args.elapsed_time_offset_ms / 1000.0, **resume)
    summary = trainer.train()
    if not args.quiet:
        print(
            f"Training complete: step={summary['final_step']:,} "
            f"avg_return={summary['avg_return']:.2f} sps={summary['sps']:,.0f}"
        )
    return 0


def run_front_end(args, device: str = "cuda") -> int:
    """``eval`` or ``tournament`` on ``device`` (a CUDA request without a
    card raises in ``resolve_device``); a reference checkpoint whose record
    does not import exits 2."""
    from burn_ppo_torch.checkpoint import ReferenceImportError
    from burn_ppo_torch.device import resolve_device

    dev = resolve_device(device)
    try:
        if args.command == "eval":
            from burn_ppo_torch.eval import run_evaluation_cli

            return run_evaluation_cli(args, device=dev)
        from burn_ppo_torch.tournament import run_tournament_cli

        return run_tournament_cli(args, device=dev)
    except ReferenceImportError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


def run_interactive(args, device: str = "cuda") -> int:
    """The Skull assistant's web server on ``device`` (a CUDA request
    without a card raises in ``resolve_device``); sources without a Skull
    checkpoint, or a reference checkpoint whose record does not import,
    exit 2."""
    from burn_ppo_torch.device import resolve_device
    from burn_ppo_torch.interactive import run_interactive_cli

    dev = resolve_device(device)
    try:
        return run_interactive_cli(args, device=dev)
    except ValueError as e:  # ReferenceImportError among them
        print(f"error: {e}", file=sys.stderr)
        return 2


def main(argv: Optional[List[str]] = None, *, device: str = "cuda") -> int:
    """``device`` is the hook the CPU tests use; the command line always
    runs on CUDA."""
    argv = list(sys.argv[1:] if argv is None else argv)
    parser = build_parser()
    known = {"train", "eval", "tournament", "interactive", "-h", "--help", "--version"}
    if not argv or argv[0] not in known:
        argv = ["train"] + argv
    args = parser.parse_args(argv)
    if args.command == "train":
        return run_train(args, device=device, argv=argv[1:])
    if args.command in ("eval", "tournament"):
        return run_front_end(args, device=device)
    return run_interactive(args, device=device)


if __name__ == "__main__":
    raise SystemExit(main())

"""Command line of the port: the ``train`` subcommand.

Reuses the JAX package's parser (``burn_ppo_tpu.cli.build_parser``) and
override collection, so the flags and the TOML grammar are the same. The
port trains on CUDA. Flags for what the port does not have yet are
refused with an error naming the ROADMAP item, never ignored.

    python -m burn_ppo_torch train --config configs/cartpole.toml
"""

from __future__ import annotations

import sys
from pathlib import Path
from typing import List, Optional

from burn_ppo_tpu.cli import build_parser, collect_overrides
from burn_ppo_tpu.config import Config, generate_run_name


def refused_flags(args) -> List[str]:
    """The flags of ``args`` that the port does not support yet. Config
    values it cannot run (env, network type, compute dtype, ...), from a
    flag or from the TOML, are refused by ``train.unsupported_config``."""
    refused = []
    checks = (
        (args.resume, "--resume (ROADMAP A9: checkpoint load and resume)"),
        (args.fork, "--fork (ROADMAP A9: checkpoint load and fork)"),
        (args.multihost, "--multihost (ROADMAP A16)"),
        (args.profile_dir is not None or args.profile_phases
         or args.profile_start != 1 or args.profile_updates != 2,
         "--profile-* (ROADMAP A17: profiling tools)"),
        (args.checkify, "--checkify (JAX-only debug mode)"),
        (args.reload_every_n_checkpoints or args.max_checkpoints_this_run
         or args.elapsed_time_offset_ms,
         "--reload-every-n-checkpoints (ROADMAP A15: supervisor)"),
        (args.platform is not None, "--platform (the port runs on CUDA)"),
        (args.compilation_cache != "auto", "--compilation-cache (XLA-only)"),
    )
    for bad, what in checks:
        if bad:
            refused.append(what)
    return refused


def run_train(args, device: str = "cuda") -> int:
    from burn_ppo_torch.train import Trainer, unsupported_config

    refused = refused_flags(args)
    if refused:
        print("error: not supported by burn_ppo_torch yet: " + "; ".join(refused),
              file=sys.stderr)
        return 2
    cfg = Config.load(args.config).apply_overrides(collect_overrides(args))
    reason = unsupported_config(cfg)
    if reason is not None:
        print(f"error: config {args.config} is not supported by burn_ppo_torch yet: {reason}",
              file=sys.stderr)
        return 2
    runs_base = Path(args.runs_base)
    run_name = args.run_name or cfg.run_name or generate_run_name(runs_base, cfg.env)
    cfg.run_name = run_name
    run_dir = Path(args.run_dir) if args.run_dir else runs_base / run_name
    if (run_dir / "checkpoints" / "latest").exists():
        print(f"error: run dir {run_dir} already has checkpoints (resume is "
              "not ported yet, ROADMAP A9)", file=sys.stderr)
        return 1
    trainer = Trainer(cfg, run_dir, device=device, quiet=args.quiet)
    summary = trainer.train()
    if not args.quiet:
        print(
            f"Training complete: step={summary['final_step']:,} "
            f"avg_return={summary['avg_return']:.2f} sps={summary['sps']:,.0f}"
        )
    return 0


def main(argv: Optional[List[str]] = None, *, device: str = "cuda") -> int:
    """``device`` is the hook the CPU tests use; the command line always
    trains on CUDA."""
    argv = list(sys.argv[1:] if argv is None else argv)
    parser = build_parser()
    parser.prog = "burn-ppo-torch"
    known = {"train", "eval", "tournament", "interactive", "-h", "--help", "--version"}
    if not argv or argv[0] not in known:
        argv = ["train"] + argv
    args = parser.parse_args(argv)
    if args.command == "train":
        return run_train(args, device=device)
    print(f"error: '{args.command}' is not ported to burn_ppo_torch yet "
          "(ROADMAP A15: front ends)", file=sys.stderr)
    return 2


if __name__ == "__main__":
    raise SystemExit(main())

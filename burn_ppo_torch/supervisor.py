"""Training supervisor: subprocess respawn every N checkpoints.

A copy of burn_ppo_tpu/supervisor.py (the reference's src/supervisor.rs)
for the port: the parent respawns the training run as a child process,
``python -m burn_ppo_torch train``, every ``reload_every_n_checkpoints``
checkpoint saves (the reference's mitigation for long-run memory
growth). The first child starts fresh (or resumes what the user asked
for); each later child passes ``--resume`` on the run directory with an
``--elapsed-time-offset-ms`` carry-over; completion is read from the
latest checkpoint's metadata step (supervisor.rs:102-260). Any child exit
short of completion resumes from ``checkpoints/latest``, so the loop also
recovers from a crash or a preemption.
"""

from __future__ import annotations

import json
import signal
import subprocess
import sys
import time
from pathlib import Path
from typing import List, Optional

# Flags a resumed child may keep (value count follows each flag), each one
# the port's parser accepts. All config overrides were baked into the run's
# config.toml snapshot by the first child; passing them again would trip
# the resume-override policy (the reference instead rebuilds child args,
# config.rs:343-465). The port refuses the JAX-only runtime flags among
# them before a supervisor starts, so they only ever pass through as their
# defaults.
_RESUME_SAFE_FLAGS = {
    "--quiet": 0,
    "--multihost": 0,
    "--profile-phases": 0,
    "--checkify": 0,
    "--compilation-cache": 1,
    "--platform": 1,
    "--runs-base": 1,
    "--total-steps": 1,
    "--max-training-time": 1,
    "--profile-dir": 1,
    "--profile-start": 1,
    "--profile-updates": 1,
}


def resume_safe_args(child_args: List[str]) -> List[str]:
    """Filter original CLI args down to those legal on a --resume child."""
    out: List[str] = []
    i = 0
    while i < len(child_args):
        a = child_args[i]
        base = a.split("=", 1)[0]
        if base in _RESUME_SAFE_FLAGS:
            out.append(a)
            nvals = _RESUME_SAFE_FLAGS[base] if "=" not in a else 0
            for j in range(nvals):
                if i + 1 + j < len(child_args):
                    out.append(child_args[i + 1 + j])
            i += 1 + nvals
        else:
            # skip the flag and its value (if the next token isn't a flag)
            i += 1
            if not a.startswith("--") or "=" in a:
                continue
            if i < len(child_args) and not child_args[i].startswith("--"):
                i += 1
    return out


class TrainingSupervisor:
    def __init__(
        self,
        run_dir: str | Path,
        child_args: List[str],
        *,
        reload_every_n_checkpoints: int,
        total_steps: int,
        max_restarts: int = 1000,
        quiet: bool = False,
    ):
        self.run_dir = Path(run_dir)
        self.child_args = child_args
        self.n = reload_every_n_checkpoints
        self.total_steps = total_steps
        self.max_restarts = max_restarts
        self.quiet = quiet

    def latest_step(self) -> Optional[int]:
        meta = self.run_dir / "checkpoints" / "latest" / "metadata.json"
        if not meta.exists():
            return None
        try:
            return int(json.loads(meta.read_text())["step"])
        except (ValueError, KeyError, json.JSONDecodeError):
            return None

    def is_training_complete(self) -> bool:
        step = self.latest_step()
        return step is not None and step >= self.total_steps

    def run(self) -> int:
        """Spawn-and-wait loop (supervisor.rs:102-153).

        SIGTERM (a preemption) forwards to the child and STOPS the respawn
        loop: the child checkpoints and exits 0, and without the stop flag
        the loop would respawn it at once, so that SIGTERM could never stop
        a supervised run."""
        terminated = {"flag": False}

        def _on_term(sig, frame):
            terminated["flag"] = True

        prev_term = None
        try:
            prev_term = signal.signal(signal.SIGTERM, _on_term)
        except ValueError:
            pass  # not the main thread
        try:
            return self._run_loop(time.time(), terminated)
        finally:
            if prev_term is not None:
                try:
                    signal.signal(signal.SIGTERM, prev_term)
                except ValueError:
                    pass

    def _count_checkpoints(self) -> int:
        d = self.run_dir / "checkpoints"
        if not d.exists():
            return 0
        # A parked step_N.old overwrite backup (checkpoint.py save) is no
        # checkpoint progress: it would make a no-op child look productive
        # (or hide a real new checkpoint) and break the completion check.
        return sum(1 for p in d.iterdir()
                   if p.is_dir() and p.name.startswith("step_") and p.name[5:].isdigit())

    def _run_loop(self, start: float, terminated: dict) -> int:
        first = True
        for restart in range(self.max_restarts):
            if terminated["flag"]:
                return 0
            if self.is_training_complete():
                if not self.quiet:
                    print(f"supervisor: training complete at step {self.latest_step()}")
                return 0

            ckpt_baseline = self._count_checkpoints()
            elapsed_ms = int((time.time() - start) * 1000)
            if not first or self.latest_step() is not None:
                # Resume from the run dir: the first invocation's config
                # overrides are frozen in its config.toml; only resume-safe
                # flags pass through.
                args = resume_safe_args(self.child_args) + ["--resume", str(self.run_dir)]
            else:
                args = list(self.child_args)
            args += ["--max-checkpoints-this-run", str(self.n),
                     "--elapsed-time-offset-ms", str(elapsed_ms)]
            cmd = [sys.executable, "-m", "burn_ppo_torch", "train", *args]
            if not self.quiet:
                print(f"supervisor: spawn #{restart + 1}: {' '.join(cmd)}", flush=True)
            proc = subprocess.Popen(cmd)
            try:
                while True:
                    try:
                        rc = proc.wait(timeout=1)
                        break
                    except subprocess.TimeoutExpired:
                        if terminated["flag"]:
                            # Forward the preemption notice; the child writes
                            # a final checkpoint and exits 0.
                            proc.send_signal(signal.SIGTERM)
                            try:
                                rc = proc.wait(timeout=120)
                            except subprocess.TimeoutExpired:
                                proc.kill()
                                rc = -signal.SIGKILL
                            if not self.quiet:
                                print(f"supervisor: SIGTERM - child checkpointed and exited "
                                      f"rc={rc}")
                            return 0 if rc == 0 else 1
            except KeyboardInterrupt:
                proc.send_signal(signal.SIGINT)
                try:
                    proc.wait(timeout=60)
                except subprocess.TimeoutExpired:
                    proc.kill()
                return 130
            if rc != 0:
                # A failed child is fatal (supervisor.rs:128-138): it would
                # fail the same way on an immediate respawn.
                print(f"supervisor: child failed rc={rc}; aborting")
                return 1
            if self._count_checkpoints() == ckpt_baseline:
                # A successful child that saved no checkpoint: the end is
                # reached, or the step or time budget left fits no further
                # checkpoint. Without this the loop would respawn no-op
                # children until max_restarts (supervisor.rs:146-149).
                if not self.quiet:
                    print("supervisor: child made no checkpoint progress; treating training "
                          "as complete")
                return 0
            first = False
        print("supervisor: max restarts exceeded")
        return 1

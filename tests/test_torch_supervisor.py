"""The port's training supervisor (``burn_ppo_torch/supervisor.py``): every
case of tests/test_supervisor.py against it (arg assembly, completion
detection, the respawn loop), the respawn command naming the port's
package; the Trainer's checkpoint cap and elapsed offset; and a supervised
CartPole run through ``cli.main(device="cpu")``, each child run in
process, three children that resume one another, twice, to the same
bits."""

import json
import sys
from pathlib import Path

import torch

torch.set_num_threads(1)

import burn_ppo_torch.supervisor as sup_mod  # noqa: E402
from burn_ppo_torch import cli  # noqa: E402
from burn_ppo_torch.config import Config  # noqa: E402
from burn_ppo_torch.supervisor import TrainingSupervisor, resume_safe_args  # noqa: E402
from burn_ppo_torch.train import Trainer  # noqa: E402


def write_latest(run_dir: Path, step: int):
    ckpt = run_dir / "checkpoints" / f"step_{step:08d}"
    ckpt.mkdir(parents=True, exist_ok=True)
    (ckpt / "metadata.json").write_text(json.dumps({"step": step}))
    latest = run_dir / "checkpoints" / "latest"
    if latest.is_symlink():
        latest.unlink()
    latest.symlink_to(ckpt.name)


def test_latest_step_none_without_checkpoint(tmp_path):
    sup = TrainingSupervisor(tmp_path, [], reload_every_n_checkpoints=2, total_steps=100)
    assert sup.latest_step() is None
    assert not sup.is_training_complete()


def test_latest_step_reads_metadata(tmp_path):
    write_latest(tmp_path, 64)
    sup = TrainingSupervisor(tmp_path, [], reload_every_n_checkpoints=2, total_steps=100)
    assert sup.latest_step() == 64
    assert not sup.is_training_complete()


def test_completion_at_total_steps(tmp_path):
    write_latest(tmp_path, 100)
    sup = TrainingSupervisor(tmp_path, [], reload_every_n_checkpoints=2, total_steps=100)
    assert sup.is_training_complete()


def test_completion_past_total_steps(tmp_path):
    write_latest(tmp_path, 150)
    sup = TrainingSupervisor(tmp_path, [], reload_every_n_checkpoints=2, total_steps=100)
    assert sup.is_training_complete()


def test_corrupt_metadata_is_not_complete(tmp_path):
    ckpt = tmp_path / "checkpoints" / "step_00000001"
    ckpt.mkdir(parents=True)
    (ckpt / "metadata.json").write_text("not json")
    (tmp_path / "checkpoints" / "latest").symlink_to(ckpt.name)
    sup = TrainingSupervisor(tmp_path, [], reload_every_n_checkpoints=2, total_steps=100)
    assert sup.latest_step() is None


def test_run_returns_immediately_when_complete(tmp_path):
    write_latest(tmp_path, 100)
    sup = TrainingSupervisor(tmp_path, [], reload_every_n_checkpoints=2, total_steps=100,
                             quiet=True)
    assert sup.run() == 0


# ------------------------------------------------------ resume arg filter
def test_resume_safe_args_drops_config_overrides():
    args = ["-c", "configs/skull.toml", "--learning-rate", "1e-3", "--num-envs", "128", "--quiet",
            "--total-steps", "5000"]
    assert resume_safe_args(args) == ["--quiet", "--total-steps", "5000"]


def test_resume_safe_args_keeps_runtime_flags():
    args = ["--platform", "cpu", "--profile-dir", "/tmp/x", "--seed", "3"]
    assert resume_safe_args(args) == ["--platform", "cpu", "--profile-dir", "/tmp/x"]


def test_resume_safe_args_handles_equals_form():
    args = ["--total-steps=900", "--gamma=0.9", "--quiet"]
    assert resume_safe_args(args) == ["--total-steps=900", "--quiet"]


def test_resume_safe_args_drops_existing_resume():
    assert resume_safe_args(["--resume", "runs/old", "--quiet"]) == ["--quiet"]


def test_resume_safe_args_boolean_flags_not_greedy():
    # --normalize-obs (no value) followed by a safe flag must not eat it
    assert resume_safe_args(["--normalize-obs", "--quiet"]) == ["--quiet"]


def test_every_resume_safe_flag_is_one_the_ports_parser_takes():
    train = next(a for a in cli.build_parser()._subparsers._group_actions[0].choices.items()
                 if a[0] == "train")[1]
    known = {s for action in train._actions for s in action.option_strings}
    assert set(sup_mod._RESUME_SAFE_FLAGS) <= known


def test_respawn_uses_resume_and_offsets(tmp_path, monkeypatch):
    """Second spawn adds --resume with only resume-safe flags; both run the
    port's package."""
    spawned = []

    class FakeProc:
        def __init__(self, cmd):
            spawned.append(cmd)
            # first child writes a checkpoint short of total; second completes
            write_latest(tmp_path, 50 if len(spawned) == 1 else 100)

        def wait(self, timeout=None):
            return 0

    monkeypatch.setattr(sup_mod.subprocess, "Popen", lambda cmd: FakeProc(cmd))
    sup = TrainingSupervisor(tmp_path, ["-c", "x.toml", "--learning-rate", "1e-3", "--quiet"],
                             reload_every_n_checkpoints=1, total_steps=100, quiet=True)
    assert sup.run() == 0
    assert len(spawned) == 2
    first, second = spawned
    assert first[:4] == second[:4] == [sys.executable, "-m", "burn_ppo_torch", "train"]
    assert "--resume" not in first
    assert "-c" in first and "--learning-rate" in first
    assert "--resume" in second
    assert "-c" not in second and "--learning-rate" not in second
    assert "--quiet" in second
    assert "--max-checkpoints-this-run" in first
    assert "--elapsed-time-offset-ms" in second


def test_no_progress_child_ends_loop(tmp_path, monkeypatch):
    """A successful child that saves NO new checkpoint ends the loop
    (supervisor.rs:146-149): e.g. the time budget is spent, so every
    respawn would exit at once."""
    spawned = []
    write_latest(tmp_path, 50)  # resume point exists, short of total

    class FakeProc:
        def __init__(self, cmd):
            spawned.append(cmd)  # exits without writing a checkpoint

        def wait(self, timeout=None):
            return 0

    monkeypatch.setattr(sup_mod.subprocess, "Popen", lambda cmd: FakeProc(cmd))
    sup = TrainingSupervisor(tmp_path, [], reload_every_n_checkpoints=1, total_steps=100,
                             quiet=True)
    assert sup.run() == 0
    assert len(spawned) == 1


def test_failed_child_aborts(tmp_path, monkeypatch):
    """A child that exits nonzero is fatal (supervisor.rs:128-138)."""
    spawned = []

    class FakeProc:
        def __init__(self, cmd):
            spawned.append(cmd)

        def wait(self, timeout=None):
            return 3

    monkeypatch.setattr(sup_mod.subprocess, "Popen", lambda cmd: FakeProc(cmd))
    sup = TrainingSupervisor(tmp_path, [], reload_every_n_checkpoints=1, total_steps=100,
                             quiet=True)
    assert sup.run() == 1
    assert len(spawned) == 1


def test_resume_safe_args_keeps_checkify_and_cache():
    args = ["--checkify", "--compilation-cache", "/fast/cache", "--seed", "3"]
    assert resume_safe_args(args) == ["--checkify", "--compilation-cache", "/fast/cache"]


def test_count_checkpoints_ignores_parked_old_dirs(tmp_path):
    """step_N.old overwrite backups must not count as checkpoint progress."""
    d = tmp_path / "checkpoints"
    (d / "step_00000100").mkdir(parents=True)
    (d / "step_00000100.old").mkdir()
    (d / "step_abc").mkdir()
    sup = TrainingSupervisor.__new__(TrainingSupervisor)
    sup.run_dir = tmp_path
    assert sup._count_checkpoints() == 1


# ---------------------------------------------------------- the trainer
def tiny(**kw) -> Config:
    base = dict(env="cartpole", num_envs=2, num_steps=8, total_steps=128, hidden_size=16,
                num_hidden=1, checkpoint_freq=32, log_freq=16, seed=5, num_minibatches=2,
                num_epochs=1)
    base.update(kw)
    return Config(**base)


def checkpoint_steps(run: Path) -> list:
    return sorted(int(p.name[5:]) for p in (run / "checkpoints").glob("step_*"))


def test_trainer_stops_after_its_checkpoint_cap_and_counts_the_offset(tmp_path, capsys):
    """Two checkpoints this run: the loop stops at the second (step 64 of
    128), with no final save; the elapsed offset shows in the progress
    line's time and stops a run whose time limit it already passed."""
    summary = Trainer(tiny(), tmp_path / "cap", device="cpu", quiet=True,
                      max_checkpoints_this_run=2).train()
    assert summary["final_step"] == 64
    assert checkpoint_steps(tmp_path / "cap") == [32, 64]

    Trainer(tiny(total_steps=16), tmp_path / "offset", device="cpu",
            elapsed_time_offset=3725.0).train()
    assert "training complete (1h02m05s)" in capsys.readouterr().out

    summary = Trainer(tiny(max_training_time="1h"), tmp_path / "limit", device="cpu", quiet=True,
                      elapsed_time_offset=3601.0).train()
    assert summary["final_step"] == 0  # the parent's hour already spent
    summary = Trainer(tiny(max_training_time="1h", total_steps=32), tmp_path / "room",
                      device="cpu", quiet=True, elapsed_time_offset=3000.0).train()
    assert summary["final_step"] == 32


# ------------------------------------------------------ a supervised run
def in_process_children(monkeypatch) -> list:
    """Run each child the supervisor spawns through ``cli.main(device="cpu")``
    in this process; returns the commands."""
    spawned = []

    class Child:
        def __init__(self, cmd):
            spawned.append(cmd)
            assert cmd[:4] == [sys.executable, "-m", "burn_ppo_torch", "train"]
            self.rc = cli.main(cmd[3:], device="cpu")

        def wait(self, timeout=None):
            return self.rc

    monkeypatch.setattr(sup_mod.subprocess, "Popen", Child)
    return spawned


def supervised_run(tmp_path: Path, monkeypatch, name: str) -> tuple:
    cfg = tmp_path / "tiny.toml"
    cfg.write_text('env = "cartpole"\nnum_envs = 2\nnum_steps = 8\ntotal_steps = 96\n'
                   "hidden_size = 16\nnum_hidden = 1\ncheckpoint_freq = 32\nlog_freq = 16\n"
                   "seed = 3\nnum_minibatches = 2\nnum_epochs = 1\n")
    spawned = in_process_children(monkeypatch)
    run = tmp_path / name
    assert cli.main(["train", "-c", str(cfg), "--run-dir", str(run), "--quiet",
                     "--reload-every-n-checkpoints", "1"], device="cpu") == 0
    return run, spawned


def test_supervised_cartpole_resumes_three_children_to_the_same_bits(tmp_path, monkeypatch):
    run, spawned = supervised_run(tmp_path, monkeypatch, "a")
    assert len(spawned) == 3
    first, *later = [cmd[4:] for cmd in spawned]
    assert "--resume" not in first and "--reload-every-n-checkpoints" not in first
    assert all(c[c.index("--resume") + 1] == str(run) and "-c" not in c for c in later)
    assert all(c[c.index("--max-checkpoints-this-run") + 1] == "1" for c in [first, *later])
    offsets = [int(c[c.index("--elapsed-time-offset-ms") + 1]) for c in [first, *later]]
    assert offsets == sorted(offsets) and offsets[2] > offsets[1] > 0
    assert checkpoint_steps(run) == [32, 64, 96]
    steps = [json.loads(ln)["step"] for ln in (run / "metrics.jsonl").read_text().splitlines()
             if json.loads(ln).get("name") == "perf/sps"]
    assert steps == list(range(16, 97, 16))  # no gap, no repeat
    again, _ = supervised_run(tmp_path, monkeypatch, "b")
    for f in ("model.npz", "optimizer.npz", "generator_state.npz"):
        assert ((run / "checkpoints" / "latest" / f).read_bytes()
                == (again / "checkpoints" / "latest" / f).read_bytes()), f


def test_a_fork_and_a_refused_config_are_never_supervised(tmp_path, monkeypatch, capsys):
    spawned = in_process_children(monkeypatch)
    cfg = tmp_path / "bad.toml"
    cfg.write_text('env = "cartpole"\ncompute_dtype = "bfloat16"\nmesh_data = 2\n')
    assert cli.main(["train", "-c", str(cfg), "--reload-every-n-checkpoints", "1",
                     "--run-dir", str(tmp_path / "r")], device="cpu") == 2
    assert "not supported by burn_ppo_torch" in capsys.readouterr().err
    assert not (tmp_path / "r").exists()
    Trainer(tiny(total_steps=32), tmp_path / "parent", device="cpu", quiet=True).train()
    ckpt = tmp_path / "parent" / "checkpoints" / "step_00000032"
    assert cli.main(["train", "--fork", str(ckpt), "--run-dir", str(tmp_path / "child"),
                     "--total-steps", "64", "--reload-every-n-checkpoints", "1", "--quiet"],
                    device="cpu") == 0
    assert not spawned and checkpoint_steps(tmp_path / "child") == [64]

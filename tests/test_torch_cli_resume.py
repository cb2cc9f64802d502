"""``train --resume`` and ``--fork`` through the port's command line
(``cli.main(device="cpu")``): the cases of tests/test_cli_e2e.py for
resume, fork and their errors, on CartPole, the Connect Four CNN and
Liar's Dice CTDE against the pool."""

import json
import shutil
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)

from burn_ppo_torch import cli  # noqa: E402


def write_tiny_config(path: Path, **kw) -> Path:
    lines = {
        "env": '"cartpole"', "num_envs": 2, "num_steps": 8, "total_steps": 64,
        "hidden_size": 16, "num_hidden": 1, "learning_rate": 1e-3, "checkpoint_freq": 32,
        "log_freq": 16, "seed": 7, "opponent_pool_fraction": 0.0,
    }
    lines.update(kw)
    path.write_text("\n".join(f"{k} = {v}" for k, v in lines.items()) + "\n")
    return path


def train(*args) -> int:
    return cli.main(["train", *map(str, args), "--quiet"], device="cpu")


def latest_meta(run: Path) -> dict:
    return json.loads(((run / "checkpoints" / "latest").resolve() / "metadata.json").read_text())


def trained(base: Path, name: str, **kw) -> Path:
    run = base / name
    assert train("-c", write_tiny_config(base / f"{name}.toml", **kw), "--run-dir", run) == 0
    return run


@pytest.fixture(scope="module")
def trained_run(tmp_path_factory):
    """One tiny CartPole run (two checkpoints) that the tests copy or read."""
    return trained(tmp_path_factory.mktemp("cli"), "run")


@pytest.fixture
def run_copy(trained_run, tmp_path):
    dst = tmp_path / trained_run.name
    shutil.copytree(trained_run, dst, symlinks=True)
    return dst


def test_resume_extends_run(run_copy):
    assert train("--resume", run_copy, "--total-steps", "128") == 0
    meta = latest_meta(run_copy)
    assert meta["step"] >= 128 and meta["forked_from"] is None
    steps = sorted(p.name for p in (run_copy / "checkpoints").glob("step_*"))
    assert steps[:2] == ["step_00000032", "step_00000064"] and steps[-1] == "step_00000128"


def test_resume_rejects_config_overrides_and_names_fork(trained_run, capsys):
    rc = cli.main(["train", "--resume", str(trained_run), "--learning-rate", "1e-4"],
                  device="cpu")
    assert rc != 0
    assert "--fork" in capsys.readouterr().err
    assert latest_meta(trained_run)["step"] == 64


def test_resume_missing_run_errors(tmp_path, capsys):
    assert train("--resume", tmp_path / "ghost") == 1
    assert "no config.toml" in capsys.readouterr().err


def test_resume_without_checkpoints_errors(run_copy, capsys):
    shutil.rmtree(run_copy / "checkpoints")
    assert train("--resume", run_copy) == 1
    assert "no checkpoints/latest" in capsys.readouterr().err


def test_fresh_run_into_a_dir_with_checkpoints_errors(trained_run, tmp_path, capsys):
    cfgp = write_tiny_config(tmp_path / "tiny.toml")
    assert train("-c", cfgp, "--run-dir", trained_run) == 1
    assert "use --resume or --fork" in capsys.readouterr().err


def test_fork_creates_child_with_lineage(trained_run, tmp_path):
    ckpt = (trained_run / "checkpoints" / "latest").resolve()
    child = tmp_path / "child"
    assert train("--fork", ckpt, "--run-dir", child, "--runs-base", tmp_path,
                 "--learning-rate", "5e-4", "--total-steps", "128") == 0
    meta = latest_meta(child)
    assert meta["forked_from"] == trained_run.name and meta["step"] >= 128
    for step in (96, 128):  # every checkpoint of the child records it
        d = child / "checkpoints" / f"step_{step:08d}"
        assert json.loads((d / "metadata.json").read_text())["forked_from"] == trained_run.name
    cfg_text = (child / "config.toml").read_text()
    assert "0.0005" in cfg_text and f'forked_from = "{trained_run.name}"' in cfg_text
    assert latest_meta(trained_run)["step"] == 64  # the parent is untouched


def test_fork_names_the_child_after_its_parent(trained_run, tmp_path):
    ckpt = trained_run / "checkpoints" / "step_00000032"
    assert train("--fork", ckpt, "--runs-base", tmp_path, "--total-steps", "64") == 0
    child = tmp_path / f"{trained_run.name}_child_001"
    assert latest_meta(child)["step"] == 64
    assert latest_meta(child)["forked_from"] == trained_run.name


def test_fork_invalid_checkpoint_errors(tmp_path, capsys):
    assert train("--fork", tmp_path / "nothing") == 1
    assert "not a checkpoint directory" in capsys.readouterr().err


@pytest.mark.parametrize("flags", [["--max-checkpoints-this-run", "2"],
                                   ["--elapsed-time-offset-ms", "5"]])
def test_the_supervisors_flags_stay_refused_on_resume(run_copy, flags, capsys):
    """A supervisor's child flags (supervisor.py), once refused, are taken
    on a resume: at most two more checkpoints (96 and 128, no final save
    after the cap), or the elapsed offset, which changes no step."""
    rc = cli.main(["train", "--resume", str(run_copy), "--total-steps", "256", *flags, "--quiet"],
                  device="cpu")
    assert rc == 0
    assert "not supported" not in capsys.readouterr().err
    steps = sorted(p.name for p in (run_copy / "checkpoints").glob("step_*"))
    if flags[0] == "--max-checkpoints-this-run":
        assert latest_meta(run_copy)["step"] == 128 and steps[-1] == "step_00000128"
    else:
        assert latest_meta(run_copy)["step"] == 256 and steps[-1] == "step_00000256"


def test_cnn_resume_cli(tmp_path):
    run = trained(tmp_path, "cnn", env='"connect_four"', network_type='"cnn"',
                  num_conv_layers=1, conv_channels=[4], cnn_fc_hidden_size=16)
    assert latest_meta(run)["network_type"] == "cnn"
    assert train("--resume", run, "--total-steps", "128") == 0
    meta = latest_meta(run)
    assert meta["step"] >= 128 and meta["network_type"] == "cnn"


def test_ctde_resume_cli(tmp_path):
    """Liar's Dice CTDE against the pool (liars_dice_ctde.toml's pool
    fraction), 8 envs: the resumed run plays the first run's checkpoints."""
    run = trained(tmp_path, "ctde", env='"liars_dice"', network_type='"ctde"', num_envs=8,
                  critic_hidden_size=16, critic_num_hidden=1, opponent_pool_fraction=0.25,
                  num_minibatches=2, num_epochs=1, total_steps=128)
    assert latest_meta(run)["privileged_obs_dim"] == 120
    assert train("--resume", run, "--total-steps", "256") == 0
    assert latest_meta(run)["step"] >= 256
    names = {s["name"] for s in json.loads((run / "opponent_stats.json").read_text())["opponents"]}
    assert {"step_00000064", "step_00000128", "step_00000192"} <= names

"""The port's checkpoint writer and its host series against the reference's
behaviour: an overwrite parks the old step dir and restores it when the
new one cannot be renamed into place (burn_ppo_tpu/checkpoint.py:405-432,
tests/test_checkpoint.py::test_overwrite_save_failure_restores_old), and
``perf/checkpoint_rating_time`` is logged once per checkpoint, as JAX's
``_perf_extra`` (burn_ppo_tpu/train.py:1010-1012, 1791-1793)."""

import json
import pathlib

import numpy as np
import pytest
import torch

from burn_ppo_torch import cli
from burn_ppo_torch.checkpoint import CheckpointManager, load_leaves
from burn_ppo_torch.selfplay.opponent_pool import OpponentPool


def _save(mgr: CheckpointManager, step: int, fill: float):
    model = [np.full((3, 2), fill, np.float32), np.full((2,), fill, np.float32)]
    return mgr.save(step, model, [np.zeros((), np.int32)], {"obs_norm": None},
                    {"step": step, "fill": fill})


def _leftovers(mgr: CheckpointManager) -> list:
    return sorted(p.name for p in mgr.dir.iterdir()
                  if p.name.endswith(".old") or p.name.startswith(".tmp_"))


def test_overwrite_save_failure_restores_old(tmp_path, monkeypatch):
    """The second rename (new dir into place) fails after the old dir was
    parked: the old step dir and its model.npz are back and ``latest``
    resolves to it."""
    mgr = CheckpointManager(tmp_path)
    _save(mgr, 9, 1.0)
    final_name = mgr.step_dir(9).name
    real_rename = pathlib.Path.rename

    def boom(self, target):
        if self.name.startswith(".tmp_") and pathlib.Path(target).name == final_name:
            raise OSError("injected failure")
        return real_rename(self, target)

    monkeypatch.setattr(pathlib.Path, "rename", boom)
    with pytest.raises(OSError, match="injected"):
        _save(mgr, 9, 2.0)
    monkeypatch.undo()

    assert (mgr.step_dir(9) / "model.npz").exists()
    np.testing.assert_array_equal(load_leaves(mgr.step_dir(9) / "model.npz")[0],
                                  np.full((3, 2), 1.0, np.float32))
    latest = mgr.dir / "latest"
    assert latest.exists() and latest.resolve().name == final_name
    assert json.loads((latest / "metadata.json").read_text())["fill"] == 1.0
    assert _leftovers(mgr) == []


def test_overwrite_save_replaces_the_step(tmp_path):
    """A plain overwrite: the newer contents win, ``latest`` points at the
    step, and no parked or temporary dir is left behind."""
    mgr = CheckpointManager(tmp_path)
    _save(mgr, 9, 1.0)
    _save(mgr, 9, 2.0)
    np.testing.assert_array_equal(load_leaves(mgr.step_dir(9) / "model.npz")[1],
                                  np.full((2,), 2.0, np.float32))
    assert json.loads((mgr.dir / "latest" / "metadata.json").read_text())["fill"] == 2.0
    assert _leftovers(mgr) == []
    assert sorted(p.name for p in mgr.dir.iterdir()) == ["latest", mgr.step_dir(9).name]


def test_pool_scan_ignores_a_parked_step_dir(tmp_path):
    """A ``<step>.old`` left by a crash between the two renames fails the
    pool's step-dir digit check, as the reference's scans ignore it."""
    mgr = CheckpointManager(tmp_path)
    _save(mgr, 9, 1.0)
    _save(mgr, 12, 1.0)
    parked = mgr.step_dir(12).with_name(mgr.step_dir(12).name + ".old")
    mgr.step_dir(12).rename(parked)
    pool = OpponentPool(tmp_path, device="cpu")
    assert sorted(pool.stats) == [mgr.step_dir(9).name]


def test_rating_time_is_logged_once_per_checkpoint(tmp_path):
    """Connect Four against the pool, 16 envs x 16 steps, a log every
    update and a checkpoint every second one: the rating time appears at
    the log step after each checkpoint and nowhere else (the last
    checkpoint's is never logged), while ``perf/sps`` appears at every
    log step."""
    torch.manual_seed(0)
    run = tmp_path / "run"
    per_update = 16 * 16
    rc = cli.main(
        ["train", "--config", "configs/connect_four.toml", "--num-envs", "16", "--num-steps",
         "16", "--total-steps", str(6 * per_update), "--hidden-size", "16", "--num-hidden", "1",
         "--log-freq", str(per_update), "--checkpoint-freq", str(2 * per_update),
         "--seed", "3", "--run-dir", str(run), "--quiet"],
        device="cpu",
    )
    assert rc == 0
    steps: dict = {}
    for line in (run / "metrics.jsonl").read_text().splitlines():
        rec = json.loads(line)
        if rec["type"] == "scalar":
            steps.setdefault(rec["name"], []).append(rec["step"])
    assert steps["perf/sps"] == [u * per_update for u in range(1, 7)]
    # Checkpoints after updates 2, 4 and 6 (6 twice: in the loop and at the end).
    assert steps["perf/checkpoint_rating_time"] == [3 * per_update, 5 * per_update]
    assert steps["train/current_elo"] == [u * per_update for u in range(3, 7)]
    assert sorted(p.name for p in (run / "checkpoints").iterdir()) == [
        "best", "latest", "step_00000512", "step_00001024", "step_00001536"]

"""Resume and fork of the port (``Trainer(resume_from=...)``): the
counterparts of tests/test_resume_determinism.py (two resumes of one
checkpoint are bit-identical, the resume continues the generator chain,
the resumed run trains), the restore into the buffers that exist, and
checkpoints that cross between the port and the JAX package both ways.

The guarantee is JAX's: a resumed run is deterministic, not equal to the
uninterrupted run, since env states are not checkpointed."""

import json
import shutil
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from burn_ppo_tpu.config import Config as JaxConfig  # noqa: E402
from burn_ppo_tpu.train import Trainer as JaxTrainer  # noqa: E402
from burn_ppo_torch import cli  # noqa: E402
from burn_ppo_torch.checkpoint import (  # noqa: E402
    GENERATOR_STATE,
    CheckpointManager,
    load_generator_state,
    load_leaves,
    load_optimizer,
)
from burn_ppo_torch.config import Config  # noqa: E402
from burn_ppo_torch.train import RESUME_STREAM, Trainer  # noqa: E402

CARTPOLE = """
env = "cartpole"
num_envs = {envs}
num_steps = 8
total_steps = {total}
hidden_size = 8
num_hidden = 1
num_minibatches = 2
num_epochs = 2
learning_rate = 0.001
checkpoint_freq = {ckpt}
log_freq = {ckpt}
seed = 123
opponent_pool_fraction = 0.0
normalize_obs = {obs}
"""


def cfg_file(path: Path, total: int, envs: int = 4, obs: bool = True) -> Path:
    """The JAX determinism test's CartPole run, 4 envs x 8 steps, hidden 8,
    obs and return normalization on; a TOML both packages load."""
    path.write_text(CARTPOLE.format(envs=envs, total=total, ckpt=envs * 8,
                                    obs="true" if obs else "false"))
    return path


def trainer(tmp: Path, total: int, run: str, **kw) -> Trainer:
    return Trainer(Config.load(cfg_file(tmp / f"{run}.toml", total)), tmp / run, device="cpu",
                   quiet=True, **kw)


def saved(ckpt: Path) -> dict:
    return {f.stem: load_leaves(f) for f in sorted(ckpt.glob("*.npz"))}


def live(t: Trainer) -> dict:
    """The trainer's state in the checkpoint's layout, as numpy."""
    return {k: [np.asarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x)
                for x in v]
            for k, v in t.checkpoint_leaves().items() if v is not None}


def assert_leaves_equal(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        assert len(a[k]) == len(b[k]), k
        for x, y in zip(a[k], b[k]):
            np.testing.assert_array_equal(x, y, err_msg=k)


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    """Two updates of 32 steps, a checkpoint after each."""
    tmp = tmp_path_factory.mktemp("resume")
    t = trainer(tmp, 64, "base")
    before = t.generator.get_state().clone()
    t.train()
    ckpt = (tmp / "base" / "checkpoints" / "latest").resolve()
    assert ckpt.name == "step_00000064"
    return tmp, ckpt, before, t


def test_every_restored_leaf_equals_the_saved_one(base):
    tmp, ckpt, _, _ = base
    t = trainer(tmp, 128, "restored", resume_from=ckpt)
    files = saved(ckpt)
    assert set(files) == {"model", "optimizer", "obs_norm", "return_norm", GENERATOR_STATE}
    assert not (ckpt / "rng_state.npz").exists()  # JAX's file, with two JAX keys
    assert_leaves_equal(live(t), files)
    meta = json.loads((ckpt / "metadata.json").read_text())
    assert t.global_step == meta["step"] == 64
    assert t.best_avg_return == meta["best_avg_return"]
    assert t.tracker.seed_count == len(meta["recent_returns"])


def test_two_resumes_are_bit_identical_and_trained(base):
    tmp, ckpt, _, _ = base
    results = []
    for tag in ("r1", "r2"):
        t = trainer(tmp, 128, tag, resume_from=ckpt)
        assert t.global_step == 64
        t.train()
        assert t.global_step == 128
        results.append(live(t))
    assert_leaves_equal(results[0], results[1])
    restored = live(trainer(tmp, 128, "r3", resume_from=ckpt))
    assert any(not np.array_equal(a, b)
               for a, b in zip(results[0]["model"], restored["model"]))
    assert not np.array_equal(results[0]["optimizer"][0], restored["optimizer"][0])


def test_resume_continues_the_generator_chain(base):
    tmp, ckpt, before, done = base
    after = done.generator.get_state()
    assert not torch.equal(before, after)  # the chain advanced
    t = trainer(tmp, 128, "chain", resume_from=ckpt)
    # The fresh carry drew first; then the generator took the saved state.
    assert torch.equal(t.generator.get_state(), after)
    assert torch.equal(load_generator_state(ckpt), after)


def test_restore_loads_into_the_buffers_that_exist(tmp_path, base):
    _, ckpt, _, _ = base
    t = trainer(tmp_path, 128, "fresh")
    opt, on, rn = t.state.opt_state, t.state.obs_norm, t.state.carry.return_norm
    ptrs = [x.data_ptr() for x in (opt.flat_params, opt.flat_mu, opt.flat_nu, opt.count_tensor,
                                   on.mean, on.m2, on.count, rn.returns, rn.mean, rn.m2,
                                   rn.count)]
    ptrs += [p.data_ptr() for p in t.state.network.parameters()]
    t._restore(ckpt)
    after = [x.data_ptr() for x in (opt.flat_params, opt.flat_mu, opt.flat_nu,
                                    opt.count_tensor, on.mean, on.m2, on.count, rn.returns,
                                    rn.mean, rn.m2, rn.count)]
    after += [p.data_ptr() for p in t.state.network.parameters()]
    assert ptrs == after
    assert t.state.opt_state is opt and t.state.carry.return_norm is rn
    assert_leaves_equal(live(t), saved(ckpt))


def test_a_mismatched_optimizer_changes_nothing(tmp_path, base):
    _, ckpt, _, _ = base
    cfg = Config.load(cfg_file(tmp_path / "wide.toml", 128)).apply_overrides({"hidden_size": 16})
    t = Trainer(cfg, tmp_path / "wide", device="cpu", quiet=True)
    before = t.state.opt_state.flat_mu.clone()
    with pytest.raises(ValueError):
        load_optimizer(ckpt, t.state.opt_state, t.state.network)
    assert torch.equal(t.state.opt_state.flat_mu, before)
    assert int(t.state.opt_state.count_tensor) == 0


def test_a_checkpoint_without_generator_state_takes_a_stream_of_its_own(tmp_path, base):
    _, ckpt, _, _ = base
    bare = tmp_path / "bare"
    shutil.copytree(ckpt, bare)
    (bare / f"{GENERATOR_STATE}.npz").unlink()
    t = trainer(tmp_path, 128, "derived", resume_from=bare)
    fresh = torch.Generator().manual_seed(124)
    derived = torch.Generator().manual_seed(124 ^ RESUME_STREAM)
    assert torch.equal(t.generator.get_state(), derived.get_state())
    assert not torch.equal(t.generator.get_state(), fresh.get_state())


def test_a_resume_that_checkpoints_before_an_episode_ends_keeps_its_average(tmp_path, base):
    _, ckpt, _, _ = base
    seeded = tmp_path / "seeded"
    shutil.copytree(ckpt, seeded)
    meta = json.loads((seeded / "metadata.json").read_text())
    meta["recent_returns"] = [21.5] * 7
    (seeded / "metadata.json").write_text(json.dumps(meta))
    t = trainer(tmp_path, 128, "early", resume_from=seeded)
    assert t.tracker.window_count == 0 and t.tracker.avg_return == 21.5
    out = json.loads((t.save_checkpoint() / "metadata.json").read_text())
    assert out["recent_returns"] == [21.5] * 7
    assert out["forked_from"] is None


def test_a_fork_that_turns_obs_norm_on_keeps_it_fresh(tmp_path, capsys):
    src = Trainer(Config.load(cfg_file(tmp_path / "plain.toml", 32, obs=False)),
                  tmp_path / "plain", device="cpu", quiet=True)
    src.train()
    ckpt = (tmp_path / "plain" / "checkpoints" / "latest").resolve()
    assert not (ckpt / "obs_norm.npz").exists()
    cfg = Config.load(cfg_file(tmp_path / "on.toml", 64))
    child = Trainer(cfg, tmp_path / "child", device="cpu", resume_from=ckpt,
                    forked_from_run="plain")
    assert "has no obs_norm.npz" in capsys.readouterr().out
    assert float(child.state.obs_norm.count) == 0.0
    child.train()
    meta = json.loads(((tmp_path / "child" / "checkpoints" / "latest") / "metadata.json")
                      .read_text())
    assert meta["forked_from"] == "plain" and meta["step"] == 64


def test_resolve_finds_latest_best_and_steps(base):
    _, ckpt, _, _ = base
    mgr = CheckpointManager(ckpt.parent.parent)
    assert mgr.resolve("latest") == ckpt
    assert mgr.resolve("best").name.startswith("step_")
    assert mgr.resolve("32") == mgr.step_dir(32) and mgr.resolve("step_00000064") == ckpt
    assert mgr.resolve("7") is None and mgr.resolve("nothing") is None


def jax_leaves(t: JaxTrainer) -> dict:
    s = jax.device_get(t.state)
    leaves = jax.tree_util.tree_leaves
    return {"model": leaves(s.params), "optimizer": leaves(s.opt_state),
            "obs_norm": leaves(s.obs_norm), "return_norm": leaves(s.carry.return_norm)}


def test_the_port_resumes_a_checkpoint_the_jax_trainer_wrote(tmp_path):
    jt = JaxTrainer(JaxConfig.load(cfg_file(tmp_path / "j.toml", 64, envs=8)), tmp_path / "jax",
                    quiet=True)
    jt.train()
    ckpt = (tmp_path / "jax" / "checkpoints" / "latest").resolve()
    assert (ckpt / "rng_state.npz").exists() and not (ckpt / f"{GENERATOR_STATE}.npz").exists()
    want = jax_leaves(JaxTrainer(JaxConfig.load(tmp_path / "j.toml"), tmp_path / "jr",
                                 resume_from=ckpt, quiet=True))
    cfg = Config.load(tmp_path / "j.toml").apply_overrides({"total_steps": 128}, resume=True)
    t = Trainer(cfg, tmp_path / "pr", device="cpu", quiet=True, resume_from=ckpt)
    got = live(t)
    got.pop(GENERATOR_STATE)
    assert_leaves_equal(got, {k: [np.asarray(x) for x in v] for k, v in want.items()})
    meta = json.loads((ckpt / "metadata.json").read_text())
    assert t.global_step == jt.global_step == meta["step"] == 64
    assert t.best_avg_return == pytest.approx(jt.best_avg_return)
    t.train()  # and trains on from it
    assert t.global_step == 128


def test_the_jax_trainer_resumes_a_checkpoint_the_port_wrote(tmp_path):
    t = Trainer(Config.load(cfg_file(tmp_path / "p.toml", 64, envs=8)), tmp_path / "port",
                device="cpu", quiet=True)
    t.train()
    ckpt = (tmp_path / "port" / "checkpoints" / "latest").resolve()
    assert not (ckpt / "rng_state.npz").exists()
    jt = JaxTrainer(JaxConfig.load(tmp_path / "p.toml"), tmp_path / "jr", resume_from=ckpt,
                    quiet=True)
    assert jt.global_step == t.global_step == 64
    got = jax_leaves(jt)
    want = live(t)
    want.pop(GENERATOR_STATE)
    assert_leaves_equal({k: [np.asarray(x) for x in v] for k, v in got.items()}, want)


def test_a_vs_pool_resume_keeps_its_pool_stats_and_rating_history(tmp_path, capsys):
    """Connect Four against the pool, 8 envs x 32 steps: three updates with a
    checkpoint each, then two more from a copy of the run dir; the pool
    and the rating log carry the first leg's checkpoints into the second."""
    run = tmp_path / "pool"
    flags = ["--num-envs", "8", "--num-steps", "32", "--hidden-size", "16", "--num-hidden",
             "1", "--debug-opponents"]
    assert cli.main(["train", "--config", "configs/connect_four.toml", *flags,
                     "--total-steps", "768", "--checkpoint-freq", "256", "--log-freq", "256",
                     "--seed", "5", "--run-dir", str(run)], device="cpu") == 0
    first = [s["name"] for s in json.loads((run / "opponent_stats.json").read_text())["opponents"]]
    games = (run / "rating_games.jsonl").read_text().splitlines()
    assert first == ["step_00000256", "step_00000512"] and games
    capsys.readouterr()
    leg = tmp_path / "leg"
    shutil.copytree(run, leg, symlinks=True)
    assert cli.main(["train", "--resume", str(leg), "--total-steps", "1280"], device="cpu") == 0
    out = capsys.readouterr().out
    # The pool is full from the first resumed update on: a rotation each.
    assert out.count("[opponents @ step") == 2 and "[opponents @ step 768]" in out
    stats = {s["name"]: s for s in
             json.loads((leg / "opponent_stats.json").read_text())["opponents"]}
    before = {s["name"]: s for s in
              json.loads((run / "opponent_stats.json").read_text())["opponents"]}
    assert set(first) < set(stats) and "step_00000768" in stats
    assert all(stats[n]["games_played"] >= before[n]["games_played"] for n in first)
    assert sum(s["games_played"] for s in stats.values()) > sum(
        s["games_played"] for s in before.values())
    resumed = (leg / "rating_games.jsonl").read_text().splitlines()
    assert resumed[:len(games)] == games and len(resumed) > len(games)
    assert {json.loads(g)["current"] for g in resumed[len(games):]} >= {"step_00000768"}
    meta = json.loads((leg / "rating_metadata.json").read_text())
    assert meta["current_checkpoint"] == "step_00001280"
    assert json.loads((leg / "checkpoints" / "latest" / "metadata.json").read_text())[
        "step"] == 1280

"""The adaptive entropy controller (``adaptive_entropy``) in the port
against the JAX package: the device state's step and record over a
trajectory (no step before the first record, the exact-target nudge, both
clamps), the host class, the controller inside K8's plain version (the
first minibatch steps it, every minibatch records the mean entropy so
far, an update that runs no minibatch records 0 as JAX does), the
trainer's target, logging and fresh start on a resume, and the CLI."""

import json
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from burn_ppo_tpu.ppo import entropy as je  # noqa: E402
from burn_ppo_tpu.schedule import Schedule as JaxSchedule  # noqa: E402
from burn_ppo_torch import cli  # noqa: E402
from burn_ppo_torch.config import Config  # noqa: E402
from burn_ppo_torch.ppo import entropy as te  # noqa: E402
from burn_ppo_torch.ppo.update import LossBook, PPOUpdateConfig, ppo_loss_plain  # noqa: E402
from burn_ppo_torch.schedule import Schedule  # noqa: E402
from burn_ppo_torch.train import Trainer  # noqa: E402

MIN, MAX, DELTA = 0.002, 0.03, 0.004


def trajectory(target: float) -> np.ndarray:
    rng = np.random.default_rng(3)
    return np.concatenate([
        rng.uniform(0.0, 3.0, size=30),  # a random walk
        np.zeros(10),  # into the max clamp
        np.full(10, 50.0),  # into the min clamp
        np.full(5, target, np.float32),  # exactly on target: Rust's signum(+0) = +1
    ]).astype(np.float32)


def test_device_controller_matches_jax_and_the_host_class_over_a_trajectory():
    """Both device states give the same coefficient at every update, and
    both host classes too; device and host agree (f32 against double:
    within 1e-7) up to the entropies exactly on the f32 target, where the
    device steps up (its error is +0) and the host's double error has the
    sign of the target's rounding. No step before the first record."""
    sched = Schedule.parse([[0.8, 0], [0.1, 900]])
    host = te.AdaptiveEntropyController(sched, 16, 0.01, min_coef=MIN, max_coef=MAX, delta=DELTA)
    jhost = je.AdaptiveEntropyController(JaxSchedule.parse([[0.8, 0], [0.1, 900]]), 16, 0.01,
                                         min_coef=MIN, max_coef=MAX, delta=DELTA)
    dev = te.AdaptiveEntropyState.create(0.01, torch.device("cpu"))
    jdev = je.AdaptiveEntropyState.create(0.01)
    seen = set()
    for i, e in enumerate(trajectory(host.target_entropy(900))):
        step = i * 20
        h_coef, h_target = host.get_coefficient(step)
        assert (h_coef, h_target) == jhost.get_coefficient(step)
        target = torch.tensor(h_target, dtype=torch.float32)
        d_coef = te.adaptive_entropy_step(dev, target, MIN, MAX, DELTA)
        j_coef, jdev = je.adaptive_entropy_step(jdev, jnp.float32(h_target), MIN, MAX, DELTA)
        assert float(d_coef) == float(j_coef) == float(dev.coef) == float(jdev.coef), i
        if i <= 50:  # the first exact-target record is read at update 51
            assert float(d_coef) == pytest.approx(h_coef, abs=1e-7)
        else:
            assert float(d_coef) == pytest.approx(min(MAX, prev + DELTA), abs=1e-7)
        prev = float(d_coef)
        if i == 0:
            assert float(d_coef) == np.float32(0.01)  # nothing recorded yet
        seen.add(round(float(d_coef), 6))
        host.record_entropy(float(e))
        jhost.record_entropy(float(e))
        te.adaptive_entropy_record(dev, torch.tensor(e))
        jdev = je.adaptive_entropy_record(jdev, jnp.float32(e))
        assert float(dev.last_entropy) == float(jdev.last_entropy)
        assert bool(dev.has_entropy) and bool(jdev.has_entropy)
    assert {round(MIN, 6), round(MAX, 6)} <= seen  # both clamps reached


@pytest.mark.parametrize("last,target,want", [
    (1.0, 1.0, 1.0),  # on target: up by delta
    (1.0, 1.5, 1.0),  # entropy low: up
    (2.0, 1.5, -1.0),  # entropy high: down
    (2.0, 1.5, None),  # nothing recorded: held
])
def test_one_step_is_rusts_signum(last, target, want):
    dev = te.AdaptiveEntropyState.create(0.01, torch.device("cpu"))
    jdev = je.AdaptiveEntropyState.create(0.01)
    if want is not None:
        te.adaptive_entropy_record(dev, torch.tensor(last))
        jdev = je.adaptive_entropy_record(jdev, jnp.float32(last))
    coef = te.adaptive_entropy_step(dev, torch.tensor(target), 0.001, 0.1, DELTA)
    j_coef, _ = je.adaptive_entropy_step(jdev, jnp.float32(target), 0.001, 0.1, DELTA)
    moved = np.float32(0.01) if want is None else np.float32(0.01) + np.float32(want * DELTA)
    assert float(coef) == float(j_coef) == moved


def loss_inputs(M=64, A=5, seed=0, valid=0.8):
    g = torch.Generator().manual_seed(seed)
    logits = torch.randn(M, A, generator=g)
    actions = torch.randint(0, A, (M,), generator=g, dtype=torch.int32)
    logp = torch.log_softmax(logits, -1).gather(1, actions.long()[:, None])[:, 0]
    mb = {"actions": actions, "old_log_probs": logp + 0.1 * torch.randn(M, generator=g),
          "advantages": torch.randn(M, generator=g), "returns": torch.randn(M, generator=g),
          "old_values": torch.randn(M, generator=g),
          "valid": (torch.rand(M, generator=g) < valid).float(),
          "action_masks": torch.ones(M, A)}
    return logits, torch.randn(M, generator=g), mb


def test_k8s_plain_version_steps_on_the_first_minibatch_and_records_every_one():
    """Three minibatches of one update: the first steps the controller
    (``ent_coef`` its target) and uses the stepped coefficient, the others
    use it as it is; after each, the state holds sums[entropy] /
    count, the metric the update reports."""
    cfg = PPOUpdateConfig(ent_min_coef=0.001, ent_max_coef=0.1, ent_delta=DELTA)
    ctrl = te.AdaptiveEntropyState.create(0.02, torch.device("cpu"))
    te.adaptive_entropy_record(ctrl, torch.tensor(0.1))  # the last update's: below target
    book = LossBook.create(torch.device("cpu"))
    target = torch.tensor(0.8)
    entropies = []
    for m in range(3):
        logits, values, mb = loss_inputs(seed=m)
        loss, metrics, _, _ = ppo_loss_plain(logits, values, mb, target, cfg, book,
                                             controller=ctrl, ent_step=m == 0)
        entropies.append(float(metrics[2]))
        assert float(ctrl.coef) == np.float32(0.02 + DELTA)
        # The loss's entropy term used the stepped coefficient.
        ref, _, _, _ = ppo_loss_plain(logits, values, mb, ctrl.coef.clone(), cfg,
                                      LossBook.create(torch.device("cpu")))
        assert float(loss) == float(ref)
        assert float(ctrl.last_entropy) == float(book.sums[2] / book.count)
        np.testing.assert_allclose(float(ctrl.last_entropy), np.mean(entropies), rtol=1e-6)


def test_an_update_that_runs_no_minibatch_records_zero():
    """JAX records metrics["entropy"] = 0 / max(0, 1) when every minibatch
    was skipped (all invalid rows), and has_entropy turns on."""
    cfg = PPOUpdateConfig()
    ctrl = te.AdaptiveEntropyState.create(0.02, torch.device("cpu"))
    book = LossBook.create(torch.device("cpu"))
    logits, values, mb = loss_inputs(valid=0.0)
    ppo_loss_plain(logits, values, mb, torch.tensor(0.5), cfg, book, can_be_empty=True,
                   controller=ctrl, ent_step=True)
    assert int(book.run) == 0 and float(book.count) == 0.0
    assert float(ctrl.last_entropy) == 0.0 and bool(ctrl.has_entropy)
    assert float(ctrl.coef) == np.float32(0.02)  # nothing was recorded before


def cartpole_cfg(**kw) -> Config:
    base = dict(env="cartpole", num_envs=4, num_steps=8, total_steps=4 * 8 * 4, hidden_size=8,
                num_hidden=1, num_minibatches=2, num_epochs=1, seed=0, opponent_pool_fraction=0.0,
                log_freq=32, checkpoint_freq=64, adaptive_entropy=0.5,
                adaptive_entropy_delta=0.002)
    return Config(**{**base, **kw})


def test_the_trainer_writes_the_target_and_logs_the_coefficient(tmp_path):
    t = Trainer(cartpole_cfg(), tmp_path / "r", device="cpu", quiet=True)
    assert t.entropy_target(0) == 0.5 * math.log(2)
    summary = t.train()
    assert 0.001 <= summary["train/adaptive_ent_coef"] <= 0.1
    series = {}
    for line in (tmp_path / "r" / "metrics.jsonl").read_text().splitlines():
        d = json.loads(line)
        if d.get("type") == "scalar":
            series.setdefault(d["name"], []).append(d["value"])
    assert series["train/entropy_target"] == [pytest.approx(0.5 * math.log(2))] * 4
    # The coefficient the update used: held at the first, then a delta each.
    coefs = series["train/entropy_coef"]
    assert coefs == series["train/adaptive_ent_coef"] and coefs[0] == pytest.approx(0.01)
    assert all(abs(abs(b - a) - 0.002) < 1e-6 for a, b in zip(coefs, coefs[1:]))
    # Not checkpointed: a resume restarts from entropy_coef.get(0).
    ckpt = (tmp_path / "r" / "checkpoints" / "latest").resolve()
    assert sorted(p.stem for p in ckpt.glob("*.npz")) == [
        "generator_state", "model", "optimizer", "return_norm"]
    r = Trainer(cartpole_cfg(total_steps=4 * 8 * 6), tmp_path / "r2", device="cpu", quiet=True,
                resume_from=ckpt)
    assert float(r.state.ent_state.coef) == np.float32(0.01)
    assert not bool(r.state.ent_state.has_entropy)


def test_liars_dice_ctde_against_the_pool_trains_with_both_flags(tmp_path):
    """``configs/liars_dice_ctde.toml`` (pool 0.25, target_kl) with PopArt
    and the controller through the CLI on the CPU, in miniature."""
    run = tmp_path / "r"
    rc = cli.main(["train", "--config", "configs/liars_dice_ctde.toml", "--num-envs", "8",
                   "--num-steps", "8", "--total-steps", str(3 * 64), "--hidden-size", "16",
                   "--critic-hidden-size", "16", "--log-freq", "64", "--checkpoint-freq", "64",
                   "--normalize-values", "--adaptive-entropy", "0.5", "--seed", "2",
                   "--run-dir", str(run), "--quiet"], device="cpu")
    assert rc == 0
    names = {json.loads(x).get("name") for x in (run / "metrics.jsonl").read_text().splitlines()}
    assert {"value_norm/mean", "value_norm/std", "train/adaptive_ent_coef",
            "train/entropy_target", "train/entropy_coef"} <= names
    latest = (run / "checkpoints" / "latest").resolve()
    assert (latest / "popart.npz").exists()
    assert json.loads((latest / "metadata.json").read_text())["normalize_values"] is True

"""Connect Four against the opponent pool, the slice as a whole: two fused
vs-pool train steps of the port against the JAX package's from the same
start state, JAX's own random draws replayed; the ``train`` command with
the pool end to end; and the pool configurations the port refuses."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from burn_ppo_tpu.ppo.pool_rollout import PoolSeating as JaxSeating  # noqa: E402
from burn_ppo_tpu.ppo.rollout import init_rollout_carry as jax_init_carry  # noqa: E402
from burn_ppo_tpu.ppo.update import make_optimizer  # noqa: E402
from burn_ppo_tpu.train import TrainState as JaxTrainState  # noqa: E402
from burn_ppo_tpu.train import _update_cfg  # noqa: E402
from burn_ppo_tpu.train import make_pool_train_step as jax_make_pool_step  # noqa: E402
from burn_ppo_torch import cli  # noqa: E402
from burn_ppo_torch.convert import params_to_jax, tree_leaves  # noqa: E402
from burn_ppo_torch.ppo.pool_rollout import PoolSeating  # noqa: E402
from burn_ppo_torch.ppo.rollout import init_rollout_carry  # noqa: E402
from burn_ppo_torch.ppo.update import AdamState  # noqa: E402
from burn_ppo_torch.train import TrainState, make_pool_train_step  # noqa: E402
from tests.test_torch_pool_rollout import (  # noqa: E402
    ACTIVE,
    CPU,
    JENV,
    K,
    L,
    T,
    E,
    ReplaySource,
    opponents,
    replay_pool_rollout,
    replay_seating,
    start,
)

LR, ENT = 1e-3, 0.01


def _replay_update(src, update_key, epochs):
    """train.py:168 then update.py:402-409 (one-row shuffle tiles)."""
    update_key, sub = jax.random.split(update_key)
    for k in jax.random.split(sub, epochs):
        src.perms.append(np.asarray(jax.random.permutation(k, T * E)))
    return update_key


def test_two_pool_train_steps_match_jax():
    cfg, network, params, tnet, env, j_norm, t_norm = start(seed=3)
    cfg.num_epochs, cfg.num_minibatches = 2, 4
    tx = make_optimizer(_update_cfg(cfg))
    j_opp, j_opp_norm, t_stack = opponents(network, ACTIVE, seed=5)
    k_carry, k_seat, k_update = jax.random.split(jax.random.PRNGKey(11), 3)
    src = ReplaySource()
    replay_seating(src, k_seat, ACTIVE)
    j_seat = JaxSeating.create(E, L, 2, ACTIVE, k_seat)
    t_seat = PoolSeating.create(E, L, 2, ACTIVE, src)
    jstate = JaxTrainState(params=params, opt_state=tx.init(params),
                           carry=jax_init_carry(JENV, E, k_carry), obs_norm=j_norm, popart=None,
                           update_key=k_update)
    tstate = TrainState(network=tnet, opt_state=AdamState.create(tnet),
                        carry=init_rollout_carry(env, E, src, CPU), obs_norm=t_norm)
    j_step = jax.jit(jax_make_pool_step(network, JENV, cfg, tx, L, K))
    t_step = make_pool_train_step(env, cfg, L)
    carry_key, update_key = jstate.carry.key, jstate.update_key
    for _ in range(2):
        carry_key = replay_pool_rollout(src, carry_key, ACTIVE)
        update_key = _replay_update(src, update_key, cfg.num_epochs)
        jstate, j_seat, j_m, j_stats, j_rec = j_step(
            jstate, j_seat, j_opp, j_opp_norm, jnp.float32(LR), jnp.float32(ENT),
            jnp.float32(0.0), jnp.int32(ACTIVE))
        tstate, t_seat, t_m, t_stats, t_rec = t_step(tstate, t_seat, t_stack, ACTIVE, LR, ENT,
                                                     src)
        assert not src.uniforms and not src.ints and not src.perms  # every draw, in order
        # Reductions over minibatches and Adam steps in another order:
        # metrics and parameters rtol 1e-4 / atol 1e-5.
        assert set(j_m) <= set(t_m)
        for k, v in j_m.items():
            np.testing.assert_allclose(float(t_m[k]), float(v), rtol=1e-4, atol=1e-5, err_msg=k)
        for a, b in zip(tree_leaves(params_to_jax(tstate.network.state_dict())),
                        jax.tree_util.tree_leaves(jstate.params)):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-5)
        for f in ("mean", "m2", "count"):
            np.testing.assert_allclose(getattr(tstate.obs_norm, f).numpy(),
                                       np.asarray(getattr(jstate.obs_norm, f)), rtol=1e-4,
                                       atol=1e-5)
        np.testing.assert_allclose(tstate.carry.last_value_per_player.numpy(),
                                   np.asarray(jstate.carry.last_value_per_player), rtol=1e-4,
                                   atol=1e-5)
        # The learner block's episode summaries and the pool block's records.
        assert set(t_stats) == set(j_stats)
        for k in j_stats:
            np.testing.assert_allclose(t_stats[k].numpy(), np.asarray(j_stats[k]), rtol=1e-4,
                                       atol=1e-5, err_msg=k)
        for f in ("completed", "outcome", "learner_seat", "seat_opp"):
            np.testing.assert_array_equal(getattr(t_rec, f).numpy().astype(np.int32),
                                          np.asarray(getattr(j_rec, f)).astype(np.int32), err_msg=f)
        np.testing.assert_array_equal(t_seat.seat_opp.numpy(), np.asarray(j_seat.seat_opp))
        np.testing.assert_array_equal(t_seat.learner_seat.numpy(), np.asarray(j_seat.learner_seat))
        assert L / E < float(t_m["learner_valid_fraction"]) < 1.0


def _scalars(run):
    out: dict = {}
    for line in (run / "metrics.jsonl").read_text().splitlines():
        rec = json.loads(line)
        if rec["type"] == "scalar":
            out.setdefault(rec["name"], []).append(rec["value"])
    return out


def test_train_command_trains_against_the_pool_on_cpu(tmp_path, capsys):
    """configs/connect_four.toml as users run it (pool fraction 0.25), cut
    to 16 envs x 16 steps and a 16-wide MLP, a checkpoint every update."""
    run = tmp_path / "run"
    rc = cli.main(
        ["train", "--config", "configs/connect_four.toml", "--num-envs", "16", "--num-steps",
         "16", "--total-steps", str(4 * 256), "--hidden-size", "16", "--num-hidden", "1",
         "--normalize-obs", "--log-freq", "256", "--checkpoint-freq", "256", "--seed", "5",
         "--debug-opponents", "--run-dir", str(run)],
        device="cpu",
    )
    assert rc == 0
    out = capsys.readouterr().out
    assert out.count("[opponents @ step") == 3  # one rotation per update after the first
    stats = json.loads((run / "opponent_stats.json").read_text())["opponents"]
    # Written at each rotation's fold: the last checkpoint joined after it.
    assert [s["name"] for s in stats] == [f"step_{256 * i:08d}" for i in (1, 2, 3)]
    assert sum(s["games_played"] for s in stats) > 0
    games = (run / "rating_games.jsonl").read_text().splitlines()
    assert games and all(json.loads(g)["current"].startswith("step_") for g in games)
    meta = json.loads((run / "rating_metadata.json").read_text())
    assert meta["current_checkpoint"] == "step_00001024"
    best = (run / "checkpoints" / "best").resolve()
    assert best.parent == (run / "checkpoints").resolve() and best.name.startswith("step_")
    series = _scalars(run)
    assert len(series["train/policy_loss"]) == 4
    assert all(np.isfinite(v) for vs in series.values() for v in vs)
    # 4 of 16 envs are pool envs: about half their turns are the learner's.
    share = series["train/learner_valid_fraction"]
    assert len(share) == 3 and all(0.8 < s < 0.95 for s in share)
    assert {"train/current_elo", "train/best_elo", "train/rating_games"} <= set(series)
    ckpt = json.loads((run / "checkpoints" / "latest" / "metadata.json").read_text())
    assert ckpt["step"] == 1024 and ckpt["num_players"] == 2


@pytest.mark.parametrize("flags,item", [
    (["--network-type", "cnn"], "A12b"),
    (["--pool-rotation-interval", "4"], "A12c"),
])
def test_pool_configs_the_port_lacks_are_refused(flags, item, tmp_path, capsys):
    rc = cli.main(["train", "--config", "configs/connect_four.toml", *flags,
                   "--run-dir", str(tmp_path / "r")], device="cpu")
    assert rc == 2
    assert f"ROADMAP {item}" in capsys.readouterr().err
    assert not (tmp_path / "r").exists()

"""Connect Four self-play, the slice as a whole: the rollout and two fused
train steps of the port against the JAX package's from the same start
state, JAX's own random draws replayed, with the MLP and with the CNN;
the ``train`` command end to end; and the configs the port refuses."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from burn_ppo_tpu.config import Config  # noqa: E402
from burn_ppo_tpu.envs import make_env as jax_make_env  # noqa: E402
from burn_ppo_tpu.ppo.normalization import ObsNormState as JaxObsNorm  # noqa: E402
from burn_ppo_tpu.ppo.rollout import bootstrap_values as jax_bootstrap  # noqa: E402
from burn_ppo_tpu.ppo.rollout import collect_rollouts as jax_collect  # noqa: E402
from burn_ppo_tpu.ppo.rollout import init_rollout_carry as jax_init_carry  # noqa: E402
from burn_ppo_tpu.ppo.update import make_optimizer  # noqa: E402
from burn_ppo_tpu.train import TrainState as JaxTrainState  # noqa: E402
from burn_ppo_tpu.train import _update_cfg, build_network_for_env  # noqa: E402
from burn_ppo_tpu.train import make_train_step as jax_make_train_step  # noqa: E402
from burn_ppo_torch import cli  # noqa: E402
from burn_ppo_torch.convert import params_from_jax, params_to_jax, tree_leaves  # noqa: E402
from burn_ppo_torch.envs.connect_four import ConnectFour  # noqa: E402
from burn_ppo_torch.ppo.normalization import ObsNormState  # noqa: E402
from burn_ppo_torch.ppo.rollout import (  # noqa: E402
    RandomSource,
    bootstrap_values,
    collect_rollouts,
    init_rollout_carry,
)
from burn_ppo_torch.ppo.update import AdamState  # noqa: E402
from burn_ppo_torch.train import Trainer, TrainState, make_train_step, unsupported_config  # noqa: E402
from burn_ppo_torch.train import build_network_for_env as torch_build_network  # noqa: E402

E, T, EPOCHS, NMB = 16, 16, 2, 2
TINY = float(jnp.finfo(jnp.float32).tiny)
CPU = torch.device("cpu")
JENV = jax_make_env("connect_four")
LR, ENT = 1e-3, 0.01


def _cfg(network_type: str) -> Config:
    return Config(env="connect_four", num_envs=E, num_steps=T, num_epochs=EPOCHS,
                  num_minibatches=NMB, normalize_obs=True, hidden_size=64, num_hidden=2,
                  activation="relu", network_type=network_type, learning_rate=LR,
                  entropy_coef=ENT, seed=0, opponent_pool_fraction=0.0)


class ReplaySource(RandomSource):
    """Hands the port the JAX side's uniforms and permutations in the
    order the port draws them, checking each shape."""

    def __init__(self):
        self.uniforms, self.perms = [], []

    def uniform(self, shape, low, high):
        u = self.uniforms.pop(0)
        assert u.shape == tuple(shape), (u.shape, shape)
        assert u.min() >= low and u.max() < high
        return torch.from_numpy(u)

    def permutation(self, n):
        p = self.perms.pop(0)
        assert p.shape == (n,)
        return torch.from_numpy(p.astype(np.int64))


def _replay_rollout(src: ReplaySource, key):
    """Per step (key, k_sample, k_reset) = split(key, 3) (rollout.py:236):
    the Gumbel uniforms of jax.random.categorical; Connect Four's reset
    draws nothing the port needs. Returns the carry key after T steps."""
    for _ in range(T):
        key, k_sample, _ = jax.random.split(key, 3)
        src.uniforms.append(np.array(jax.random.uniform(k_sample, (E, 7), minval=TINY, maxval=1.0)))
    return key


def _replay_update(src: ReplaySource, update_key):
    """train.py:168 then update.py:402-409 (one-row shuffle tiles)."""
    update_key, sub = jax.random.split(update_key)
    for k in jax.random.split(sub, EPOCHS):
        src.perms.append(np.array(jax.random.permutation(k, T * E)))
    return update_key


def _start(network_type: str):
    cfg = _cfg(network_type)
    network = build_network_for_env(JENV, cfg)
    tx = make_optimizer(_update_cfg(cfg))
    k_params, k_carry, k_update = jax.random.split(jax.random.PRNGKey(0), 3)
    params = network.init(k_params)
    jstate = JaxTrainState(
        params=params, opt_state=tx.init(params), carry=jax_init_carry(JENV, E, k_carry),
        obs_norm=JaxObsNorm.create(86), popart=None, update_key=k_update,
    )
    env = ConnectFour()
    tnet = torch_build_network(env, cfg, torch.Generator().manual_seed(0))
    tnet.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    tstate = TrainState(
        network=tnet, opt_state=AdamState.create(tnet),
        carry=init_rollout_carry(env, E, ReplaySource(), CPU), obs_norm=ObsNormState.create(86, CPU),
    )
    return cfg, network, tx, jstate, tstate, env


@pytest.fixture(scope="module")
def mlp_start():
    return _start("mlp")


def _assert_close(mine, ref, **tol):
    np.testing.assert_allclose(np.asarray(mine), np.asarray(ref), **tol)


def test_rollout_and_bootstrap_match_jax(mlp_start):
    cfg, network, _, jstate, tstate, env = mlp_start
    # Non-zero per-player last values going in, and normalized returns on:
    # both must come out of the rollout as the reference's do.
    vpp = np.random.default_rng(0).normal(size=(E, 2)).astype(np.float32)
    j_carry0 = jstate.carry.replace(last_value_per_player=jnp.asarray(vpp))
    t_carry0 = dataclasses.replace(tstate.carry, last_value_per_player=torch.from_numpy(vpp.copy()))
    src = ReplaySource()
    _replay_rollout(src, j_carry0.key)
    j_carry, j_batch, j_logs = jax.jit(
        lambda p, c, o: jax_collect(network, JENV, p, c, o, None, num_steps=T, gamma=cfg.gamma,
                                    normalize_returns=True)
    )(jstate.params, j_carry0, jstate.obs_norm)
    t_carry, t_batch, t_logs = collect_rollouts(
        tstate.network, env, t_carry0, tstate.obs_norm, src,
        num_steps=T, gamma=cfg.gamma, normalize_returns=True,
    )
    assert not src.uniforms
    eq = np.testing.assert_array_equal
    eq(t_batch.actions.numpy(), np.asarray(j_batch.actions))
    eq(t_batch.acting_players.numpy(), np.asarray(j_batch.acting_players))
    eq(t_batch.action_masks.numpy(), np.asarray(j_batch.action_masks))
    eq(t_batch.dones.numpy(), np.asarray(j_batch.dones))
    eq(t_batch.obs.numpy(), np.asarray(j_batch.obs))
    for f in ("completed", "total_rewards", "length", "outcome", "active_players"):
        eq(getattr(t_logs, f).numpy(), np.asarray(getattr(j_logs, f), getattr(t_logs, f).numpy().dtype))
    assert t_batch.dones.sum() > 0 and (t_batch.action_masks.numpy() == 0).any()
    # f32 forward passes on both sides (only matmul summation order differs).
    for mine, ref in ((t_batch.values, j_batch.values), (t_batch.log_probs, j_batch.log_probs),
                      (t_carry.last_value_per_player, j_carry.last_value_per_player),
                      (t_carry.return_norm.returns, j_carry.return_norm.returns)):
        _assert_close(mine.numpy(), ref, rtol=0, atol=1e-5)
    # Normalized rewards: the reference's f32 prefix pass cancels early in
    # a fresh run (ROADMAP C); the port runs it in f64. rtol 1e-3, as for
    # CartPole. The other seats' rewards stay raw and exact.
    _assert_close(t_batch.rewards.numpy(), j_batch.rewards, rtol=1e-3, atol=1e-5)
    _assert_close(t_batch.all_rewards.numpy(), j_batch.all_rewards, rtol=1e-3, atol=1e-5)
    other = np.arange(2) != t_batch.acting_players.numpy()[..., None]
    eq(t_batch.all_rewards.numpy()[other], np.asarray(j_batch.all_rewards)[other])
    # The bootstrap refreshes the players-to-move slots only.
    j_vals, j_vpp = jax_bootstrap(network, JENV, jstate.params, j_carry, jstate.obs_norm, None)
    t_vals, t_vpp = bootstrap_values(tstate.network, env, t_carry, tstate.obs_norm)
    _assert_close(t_vals.numpy(), j_vals, rtol=0, atol=1e-5)
    _assert_close(t_vpp.numpy(), j_vpp, rtol=0, atol=1e-5)


def _two_train_steps(start):
    cfg, network, tx, jstate, tstate, env = start
    j_step = jax.jit(jax_make_train_step(network, JENV, cfg, tx))
    t_step = make_train_step(env, cfg)
    src = ReplaySource()
    carry_key, update_key = jstate.carry.key, jstate.update_key
    for _ in range(2):
        carry_key = _replay_rollout(src, carry_key)
        update_key = _replay_update(src, update_key)
        jstate, j_m, j_logs = j_step(jstate, jnp.float32(LR), jnp.float32(ENT), jnp.float32(0.0))
        tstate, t_m, t_logs = t_step(tstate, LR, ENT, src)
        assert not src.uniforms and not src.perms  # every draw consumed, in order
        for f in ("completed", "length", "outcome"):
            np.testing.assert_array_equal(getattr(t_logs, f).numpy(),
                                          np.asarray(getattr(j_logs, f), getattr(t_logs, f).numpy().dtype))
        # Reductions over minibatches and Adam steps in another order:
        # parameters and metrics rtol 1e-4 / atol 1e-5.
        for k, v in j_m.items():
            np.testing.assert_allclose(float(t_m[k]), float(v), rtol=1e-4, atol=1e-5, err_msg=k)
        for a, b in zip(tree_leaves(params_to_jax(tstate.network.state_dict())),
                        jax.tree_util.tree_leaves(jstate.params)):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-5)
        for f in ("mean", "m2", "count"):
            np.testing.assert_allclose(getattr(tstate.obs_norm, f).numpy(),
                                       np.asarray(getattr(jstate.obs_norm, f)), rtol=1e-5, atol=1e-6)
        # The per-player last values persist across updates.
        np.testing.assert_allclose(tstate.carry.last_value_per_player.numpy(),
                                   np.asarray(jstate.carry.last_value_per_player), rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_array_equal(tstate.carry.env_states.board.numpy(),
                                      np.asarray(jstate.carry.env_states.board))
    assert set(j_m) == set(t_m)
    assert (tstate.carry.last_value_per_player.numpy() != 0).all()


def test_two_train_steps_match_jax_mlp(mlp_start):
    _two_train_steps(mlp_start)


def test_two_train_steps_match_jax_cnn():
    _two_train_steps(_start("cnn"))


def _metrics(run):
    return [json.loads(x) for x in (run / "metrics.jsonl").read_text().splitlines()]


@pytest.mark.parametrize("network", ["mlp", "cnn"])
def test_train_command_trains_selfplay_on_cpu(network, tmp_path):
    run = tmp_path / "run"
    rc = cli.main(
        ["train", "--config", "configs/connect_four.toml", "--opponent-pool-fraction", "0",
         "--num-envs", "4", "--num-steps", "16", "--total-steps", "256", "--hidden-size", "32",
         "--num-hidden", "1", "--network-type", network, "--normalize-obs", "--log-freq", "64",
         "--checkpoint-freq", "128", "--seed", "7", "--run-dir", str(run), "--quiet"],
        device="cpu",
    )
    assert rc == 0
    lines = [x for x in _metrics(run) if x["type"] == "scalar"]
    names = {x["name"] for x in lines}
    assert {"episode/player_0_points", "episode/player_1_points", "episode/player_0_return_mean",
            "episode/draw_rate", "train/policy_loss", "train/avg_valid_actions"} <= names
    assert all(np.isfinite(x["value"]) for x in lines)
    by_step: dict = {}
    for x in lines:
        by_step.setdefault(x["step"], {})[x["name"]] = x["value"]
    for m in by_step.values():
        if "episode/player_0_points" in m:
            # Two-player Swiss points: each game awards 1 in total.
            assert abs(m["episode/player_0_points"] + m["episode/player_1_points"] - 1.0) < 1e-6
            assert 0.0 <= m["episode/draw_rate"] <= 1.0
    ckpt = run / "checkpoints"
    assert (ckpt / "latest").resolve().name == "step_00000256"
    assert not (ckpt / "best").exists()  # multiplayer best is rating-driven (A12)
    meta = json.loads((ckpt / "latest" / "metadata.json").read_text())
    assert meta["network_type"] == network and meta["obs_shape"] == [6, 7, 2]
    assert meta["num_players"] == 2

    # The JAX package loads the port's checkpoint leaf for leaf.
    from burn_ppo_tpu.checkpoint import CheckpointManager

    jnet, params, _ = CheckpointManager.load_model(ckpt / "latest")
    template = jnet.init(jax.random.PRNGKey(0))
    for a, b in zip(jax.tree_util.tree_leaves(params), jax.tree_util.tree_leaves(template)):
        assert a.shape == b.shape


def test_plain_connect_four_config_is_refused_with_the_flag_to_pass(tmp_path, capsys):
    """connect_four.toml runs against the opponent pool (0.25); with the CNN
    that is not ported yet, and the refusal names the flag that runs the
    CNN in pure self-play."""
    rc = cli.main(["train", "--config", "configs/connect_four.toml", "--network-type", "cnn",
                   "--run-dir", str(tmp_path / "r")], device="cpu")
    assert rc == 2
    err = capsys.readouterr().err
    assert "ROADMAP A12b" in err and "--opponent-pool-fraction 0" in err
    assert not (tmp_path / "r").exists()


@pytest.mark.parametrize("overrides,item", [
    ({"opponent_pool_fraction": 0.25, "network_type": "cnn"}, "A12"),
    ({"env": "liars_dice", "compute_dtype": "bfloat16"}, "A18"),
    ({"env": "liars_dice", "network_type": "ctde", "opponent_pool_fraction": 0.25,
      "pool_rotation_interval": 2}, "A12c"),
    ({"env": "skull", "network_type": "ctde", "mesh_data": 2}, "A16"),
    ({"opponent_pool_fraction": 0.25, "pool_rotation_interval": 8}, "A12c"),
    ({"env": "liars_dice", "opponent_pool_fraction": 0.25, "network_type": "cnn"}, "A12b"),
    ({"opponent_pool_fraction": 0.25, "pool_rotation_interval": 2}, "A12c"),
])
def test_unsupported_config_names_the_roadmap_item(overrides, item):
    base = dict(env="connect_four", opponent_pool_fraction=0.0)
    reason = unsupported_config(Config(**{**base, **overrides}))
    assert reason is not None and f"ROADMAP {item}" in reason
    assert unsupported_config(Config(**base)) is None
    assert unsupported_config(Config(**base, network_type="cnn")) is None
    # CartPole has one seat: the pool fraction does not apply to it; the
    # MLP against the pool is the port's vs-pool path.
    assert unsupported_config(Config(env="cartpole", opponent_pool_fraction=0.25)) is None
    assert unsupported_config(Config(env="connect_four", opponent_pool_fraction=0.25)) is None


def test_trainer_rejects_cnn_without_an_obs_shape(tmp_path):
    with pytest.raises(ValueError, match="obs_shape"):
        Trainer(Config(env="cartpole", network_type="cnn"), tmp_path, device="cpu")

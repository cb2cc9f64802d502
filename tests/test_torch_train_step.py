"""The slice as a whole: two fused train steps of the port against
``make_train_step`` of the JAX package from the same start state, with
JAX's own random draws replayed; and the ``train`` command end to end."""

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
from burn_ppo_tpu.ppo.rollout import collect_rollouts as jax_collect  # noqa: E402
from burn_ppo_tpu.ppo.rollout import init_rollout_carry as jax_init_carry  # noqa: E402
from burn_ppo_tpu.ppo.update import make_optimizer  # noqa: E402
from burn_ppo_tpu.train import TrainState as JaxTrainState  # noqa: E402
from burn_ppo_tpu.train import _update_cfg, build_network_for_env  # noqa: E402
from burn_ppo_tpu.train import make_train_step as jax_make_train_step  # noqa: E402
from burn_ppo_torch import cli  # noqa: E402
from burn_ppo_torch.convert import params_from_jax, params_to_jax, tree_leaves  # noqa: E402
from burn_ppo_torch.envs.cartpole import CartPole  # noqa: E402
from burn_ppo_torch.models.network import ActorCriticNetwork  # noqa: E402
from burn_ppo_torch.ppo.normalization import ObsNormState  # noqa: E402
from burn_ppo_torch.ppo.rollout import RandomSource, collect_rollouts, init_rollout_carry  # noqa: E402
from burn_ppo_torch.ppo.update import AdamState  # noqa: E402
from burn_ppo_torch.train import Trainer, TrainState, make_train_step  # noqa: E402

E, T, EPOCHS, NMB = 16, 32, 2, 2
TINY = float(jnp.finfo(jnp.float32).tiny)
CPU = torch.device("cpu")
JENV = jax_make_env("cartpole")
CFG = Config(
    env="cartpole", num_envs=E, num_steps=T, num_epochs=EPOCHS, num_minibatches=NMB,
    normalize_obs=True, hidden_size=64, num_hidden=2, activation="relu",
    learning_rate=1e-3, entropy_coef=0.01, seed=0, opponent_pool_fraction=0.0,
)
LR, ENT = 1e-3, 0.01


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


@jax.jit
def _reset_values(key):
    """[E, 4] reset draws of split(key, E) (cartpole.py:55-57)."""
    fresh = jax.vmap(JENV.reset)(jax.random.split(key, E))
    return jnp.stack([fresh.x, fresh.x_dot, fresh.theta, fresh.theta_dot], axis=1)


def _replay_rollout(src: ReplaySource, key):
    """The key chain of rollout.py:236,256: per step (key, k_sample,
    k_reset) = split(key, 3). Returns the carry key after T steps."""
    for _ in range(T):
        key, k_sample, k_reset = jax.random.split(key, 3)
        src.uniforms.append(np.array(jax.random.uniform(k_sample, (E, 2), minval=TINY, maxval=1.0)))
        src.uniforms.append(np.array(_reset_values(k_reset)))
    return key


def _replay_update(src: ReplaySource, update_key):
    """train.py:168 then update.py:402-409."""
    update_key, sub = jax.random.split(update_key)
    for k in jax.random.split(sub, EPOCHS):
        src.perms.append(np.array(jax.random.permutation(k, T * E)))  # tile 1
    return update_key


@pytest.fixture(scope="module")
def start():
    network = build_network_for_env(JENV, CFG)
    tx = make_optimizer(_update_cfg(CFG))
    k_params, k_carry, k_update = jax.random.split(jax.random.PRNGKey(0), 3)
    params = network.init(k_params)
    jstate = JaxTrainState(
        params=params, opt_state=tx.init(params), carry=jax_init_carry(JENV, E, k_carry),
        obs_norm=JaxObsNorm.create(5), popart=None, update_key=k_update,
    )
    src = ReplaySource()
    _, sub = jax.random.split(k_carry)  # init_rollout_carry's reset draw
    src.uniforms.append(np.array(_reset_values(sub)))
    tnet = ActorCriticNetwork(5, 2, hidden_size=64, num_hidden=2, activation="relu",
                              generator=torch.Generator().manual_seed(0))
    tnet.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    env = CartPole()
    tstate = TrainState(
        network=tnet, opt_state=AdamState.create(tnet),
        carry=init_rollout_carry(env, E, src, CPU), obs_norm=ObsNormState.create(5, CPU),
    )
    assert not src.uniforms
    return network, tx, jstate, tstate, env, src


def test_initial_carry_matches_jax(start):
    _, _, jstate, tstate, env, _ = start
    j_obs = jax.vmap(JENV.obs)(jstate.carry.env_states)
    np.testing.assert_array_equal(tstate.carry.obs.numpy(), np.asarray(j_obs))


def test_first_rollout_matches_jax(start):
    network, _, jstate, tstate, env, _ = start
    src = ReplaySource()
    _replay_rollout(src, jstate.carry.key)
    j_carry, j_batch, j_logs = jax.jit(
        lambda p, c, o: jax_collect(network, JENV, p, c, o, None, num_steps=T, gamma=CFG.gamma,
                                    normalize_returns=True)
    )(jstate.params, jstate.carry, jstate.obs_norm)
    t_carry, t_batch, t_logs = collect_rollouts(
        tstate.network, env, tstate.carry, tstate.obs_norm, src,
        num_steps=T, gamma=CFG.gamma, normalize_returns=True,
    )
    np.testing.assert_array_equal(t_batch.actions.numpy(), np.asarray(j_batch.actions))
    np.testing.assert_array_equal(t_batch.dones.numpy(), np.asarray(j_batch.dones))
    np.testing.assert_array_equal(t_logs.completed.numpy(), np.asarray(j_logs.completed, np.float32))
    assert t_batch.dones.sum() > 0  # episodes ended inside the rollout
    # f32 physics and forward passes on both sides (ulp-level differences
    # from transcendental and matmul kernels): atol 1e-5.
    for mine, ref in ((t_batch.obs, j_batch.obs), (t_batch.values, j_batch.values),
                      (t_batch.log_probs, j_batch.log_probs),
                      (t_carry.return_norm.returns, j_carry.return_norm.returns)):
        np.testing.assert_allclose(mine.numpy(), np.asarray(ref), rtol=0, atol=1e-5)
    # Normalized rewards: the reference's f32 prefix pass cancels while the
    # count is small (a fresh run's first rollout) and is off by up to
    # ~1.5e-4 relative from an f64 evaluation; the port runs it in f64
    # (test_torch_normalization holds the port to f64 at 1e-6). rtol 1e-3.
    np.testing.assert_allclose(t_batch.rewards.numpy(), np.asarray(j_batch.rewards),
                               rtol=1e-3, atol=1e-5)


def test_two_train_steps_match_jax(start):
    network, tx, jstate, tstate, env, _ = start
    j_step = jax.jit(jax_make_train_step(network, JENV, CFG, tx))
    t_step = make_train_step(env, CFG)
    src = ReplaySource()
    carry_key, update_key = jstate.carry.key, jstate.update_key
    for _ in range(2):
        carry_key = _replay_rollout(src, carry_key)
        update_key = _replay_update(src, update_key)
        jstate, j_m, j_logs = j_step(jstate, jnp.float32(LR), jnp.float32(ENT), jnp.float32(0.0))
        tstate, t_m, t_logs = t_step(tstate, LR, ENT, src)
        assert not src.uniforms and not src.perms  # every draw consumed, in order

        np.testing.assert_array_equal(t_logs.completed.numpy(), np.asarray(j_logs.completed, np.float32))
        np.testing.assert_array_equal(t_logs.length.numpy(), np.asarray(j_logs.length))
        # Reductions over minibatches and Adam steps in another order:
        # parameters and metrics rtol 1e-4 / atol 1e-5.
        for k, v in j_m.items():
            np.testing.assert_allclose(float(t_m[k]), float(v), rtol=1e-4, atol=1e-5, err_msg=k)
        for a, b in zip(tree_leaves(params_to_jax(tstate.network.state_dict())),
                        jax.tree_util.tree_leaves(jstate.params)):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-5)
        for f in ("mean", "m2", "count"):
            np.testing.assert_allclose(getattr(tstate.obs_norm, f).numpy(),
                                       np.asarray(getattr(jstate.obs_norm, f)), rtol=1e-5)
        j_obs = jax.vmap(JENV.obs)(jstate.carry.env_states)
        np.testing.assert_allclose(tstate.carry.obs.numpy(), np.asarray(j_obs), rtol=0, atol=1e-5)
    assert set(j_m) == set(t_m)


def test_train_command_end_to_end_on_cpu(tmp_path):
    run = tmp_path / "run"
    rc = cli.main(
        ["train", "--config", "configs/cartpole.toml", "--num-envs", "8", "--num-steps", "16",
         "--total-steps", str(2 * 8 * 16), "--log-freq", "128", "--checkpoint-freq", "128",
         "--seed", "5", "--run-dir", str(run), "--quiet"],
        device="cpu",
    )
    assert rc == 0
    assert (run / "config.toml").exists()
    assert (run / "checkpoints" / "latest").resolve().name == "step_00000256"
    lines = [json.loads(x) for x in (run / "metrics.jsonl").read_text().splitlines()]
    names = {x["name"] for x in lines if x["type"] == "scalar"}
    assert {"train/policy_loss", "train/approx_kl", "train/explained_variance",
            "episode/return_mean", "perf/sps"} <= names
    assert all(np.isfinite(x["value"]) for x in lines if x["type"] == "scalar")

    # The checkpoint loads into the JAX package's templates, leaf for leaf.
    from burn_ppo_tpu.checkpoint import CheckpointManager, load_pytree

    ckpt = run / "checkpoints" / "latest"
    network, params, meta = CheckpointManager.load_model(ckpt)
    assert meta["network_type"] == "mlp" and meta["step"] == 256
    template = network.init(jax.random.PRNGKey(0))
    for a, b in zip(jax.tree_util.tree_leaves(params), jax.tree_util.tree_leaves(template)):
        assert a.shape == b.shape and a.dtype == b.dtype
    tx = make_optimizer(_update_cfg(Config.load(run / "config.toml")))
    opt = load_pytree(ckpt / "optimizer.npz", tx.init(template))
    assert int(opt[1].count) == 2 * 4 * 4  # 2 updates x 4 epochs x 4 minibatches
    norm = load_pytree(ckpt / "obs_norm.npz", JaxObsNorm.create(5))
    assert float(norm.count) == 2 * 8 * 16


@pytest.mark.parametrize("flags", [["--multihost"],
                                   ["--env", "liars_dice", "--mesh-data", "2"],
                                   ["--network-type", "ctde"], ["--platform", "cpu"],
                                   ["--profile-dir", "p"], ["--checkify"],
                                   ["--compute-dtype", "bfloat16", "--mesh-data", "2"]])
def test_train_command_refuses_unported_flags(flags, tmp_path, capsys):
    rc = cli.main(["train", "--run-dir", str(tmp_path / "r"), *flags], device="cpu")
    assert rc == 2
    assert "not supported by burn_ppo_torch" in capsys.readouterr().err
    assert not (tmp_path / "r").exists()


def test_trainer_refuses_unported_config(tmp_path):
    cfg = Config(env="cartpole", compute_dtype="bfloat16", mesh_data=2)
    with pytest.raises(NotImplementedError, match="ROADMAP A16"):
        Trainer(cfg, tmp_path, device="cpu")


def test_runtime_guard_raises_on_nonfinite_outputs(tmp_path):
    cfg = Config(env="cartpole", num_envs=4, num_steps=8, total_steps=64, seed=0,
                 num_minibatches=2, num_epochs=1)
    trainer = Trainer(cfg, tmp_path, device="cpu", quiet=True)
    with torch.no_grad():
        trainer.state.network.value_head.bias.fill_(float("nan"))
    with pytest.raises(RuntimeError, match="non-finite"):
        trainer.train()

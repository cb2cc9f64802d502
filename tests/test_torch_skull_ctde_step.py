"""Skull (four players) with the CTDE critic, the slice as a whole: two
fused self-play train steps of the port against the JAX package's from the
same start state with a reward-shaping coefficient above 0, JAX's own
random draws replayed; and the configurations the port still refuses.

The lost coaster is drawn from a key in each JAX env state. ``ShadowSkull``
steps JAX's Skull beside the port's, on the same actions and JAX's reset
keys, and hands the port each step ``u = (choice + 0.5) / c`` for JAX's
own ``choice = randint(0, c)``; it also checks the two states agree at
every step."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from burn_ppo_tpu.config import Config  # noqa: E402
from burn_ppo_tpu.envs.base import EpisodeAccumulator as JaxAcc  # noqa: E402
from burn_ppo_tpu.ppo.normalization import ObsNormState as JaxObsNorm  # noqa: E402
from burn_ppo_tpu.ppo.rollout import init_rollout_carry as jax_init_carry  # noqa: E402
from burn_ppo_tpu.ppo.update import make_optimizer  # noqa: E402
from burn_ppo_tpu.train import TrainState as JaxTrainState  # noqa: E402
from burn_ppo_tpu.train import _update_cfg, build_network_for_env  # noqa: E402
from burn_ppo_tpu.train import make_train_step as jax_make_train_step  # noqa: E402
from burn_ppo_torch import cli  # noqa: E402
from burn_ppo_torch.convert import params_from_jax, params_to_jax, tree_leaves  # noqa: E402
from burn_ppo_torch.envs.skull import FIELDS, Skull, SkullState  # noqa: E402
from burn_ppo_torch.ppo.normalization import ObsNormState  # noqa: E402
from burn_ppo_torch.ppo.rollout import RandomSource, init_rollout_carry  # noqa: E402
from burn_ppo_torch.ppo.update import AdamState  # noqa: E402
from burn_ppo_torch.train import TrainState, make_train_step  # noqa: E402
from burn_ppo_torch.train import build_network_for_env as torch_build_network  # noqa: E402
from tests.test_torch_skull import jax_fns, replay_u  # noqa: E402

E, T, P, A = 16, 16, 4, 33
TINY = float(jnp.finfo(jnp.float32).tiny)
CPU = torch.device("cpu")
LR, ENT, SHAPING = 1e-3, 0.01, 0.05


class ReplaySource(RandomSource):
    """Hands the port JAX's uniforms, integers and epoch permutations in
    the port's draw order, checking each shape and range."""

    def __init__(self):
        self.uniforms, self.ints, self.perms = [], [], []

    def uniform(self, shape, low, high):
        u = self.uniforms.pop(0)
        assert u.shape == tuple(shape), (u.shape, shape)
        assert u.min() >= low and u.max() < high
        return torch.from_numpy(np.array(u))

    def permutation(self, n):
        p = self.perms.pop(0)
        assert p.shape == (n,)
        return torch.from_numpy(p.astype(np.int64))

    def integers(self, shape, low, high):
        x, lo, hi = self.ints.pop(0)
        assert x.shape == tuple(shape) and (lo, hi) == (low, high), (x.shape, shape, lo, hi)
        return torch.from_numpy(x.astype(np.int32))


class ShadowSkull(Skull):
    """The port's Skull, with JAX's Skull stepped alongside (see the module
    docstring). ``begin`` hands it JAX's env states at the start of a
    rollout and the reset keys of each of its steps."""

    def __init__(self, n=P):
        super().__init__(n)
        _, self._jstep, self._jchoice = jax_fns(n)
        self.js, self.keys, self.steps = None, [], 0

    def begin(self, js, keys):
        self.js, self.keys = js, list(keys)

    def step_autoreset(self, state, acc, action, reset_values, step_values=None):
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(state, f).numpy(), np.asarray(getattr(self.js, f)),
                                          err_msg=f"shadow diverged at step {self.steps}: {f}")
        u = torch.from_numpy(replay_u(self._jchoice, self.js))
        out = super().step_autoreset(state, acc, action, reset_values, u)
        n = self.n
        dummy = JaxAcc(reward_sum=jnp.zeros((len(u), n)), length=jnp.zeros(len(u), jnp.int32))
        self.js = self._jstep(self.js, dummy, jnp.asarray(action.numpy()), self.keys.pop(0))[0]
        self.steps += 1
        return out


def replay_rollout(src, key, steps=T, E=E):
    """Per step (key, k_sample, k_reset) = split(key, 3) (rollout.py:236):
    the Gumbel uniforms, a placeholder for the port's step draw (the
    shadow replaces it), and the reset keys. Returns (key, reset keys)."""
    keys = []
    for _ in range(steps):
        key, k_sample, k_reset = jax.random.split(key, 3)
        src.uniforms.append(np.asarray(jax.random.uniform(k_sample, (E, A), minval=TINY, maxval=1.0)))
        src.uniforms.append(np.zeros(E, np.float32))
        keys.append(jax.random.split(k_reset, E))
    return key, keys


def replay_update(src, update_key, epochs):
    """train.py:168 then update.py:402-409 (one-row shuffle tiles)."""
    update_key, sub = jax.random.split(update_key)
    for k in jax.random.split(sub, epochs):
        src.perms.append(np.asarray(jax.random.permutation(k, T * E)))
    return update_key


def skull_cfg(**kw) -> Config:
    base = dict(env="skull", num_envs=E, num_steps=T, num_epochs=2, num_minibatches=4,
                network_type="ctde", hidden_size=32, num_hidden=2, critic_hidden_size=48,
                critic_num_hidden=1, activation="relu", normalize_obs=True, learning_rate=LR,
                entropy_coef=ENT, seed=0, opponent_pool_fraction=0.0)
    return Config(**{**base, **kw})


def midgame(jstate, tstate, env, steps=40, seed=0):
    """Both carries moved to the JAX states after a random legal walk of
    ``steps`` steps, so that games end within a short rollout."""
    _, jstep, _ = jax_fns(env.n)
    jenv = jax_fns(env.n)[0]
    rng = np.random.default_rng(seed)
    js = jstate.carry.env_states
    mask = np.asarray(jax.vmap(jenv.action_mask)(js))
    acc = JaxAcc(reward_sum=jnp.zeros((E, env.n)), length=jnp.zeros(E, jnp.int32))
    key = jax.random.PRNGKey(seed + 99)
    for _ in range(steps):
        actions = np.array([rng.choice(np.flatnonzero(m)) for m in mask], np.int32)
        key, sub = jax.random.split(key)
        js, acc, _, _, _, mask, _ = jstep(js, acc, jnp.asarray(actions), jax.random.split(sub, E))
        mask = np.asarray(mask)
    jstate = jstate.replace(carry=jstate.carry.replace(env_states=js))
    ts = SkullState.of(**{f: torch.from_numpy(np.array(getattr(js, f))) for f in FIELDS})
    carry = dataclasses.replace(tstate.carry, env_states=ts, obs=env.obs(ts),
                                mask=env.action_mask(ts), priv=env.privileged_obs(ts))
    return jstate, dataclasses.replace(tstate, carry=carry)


def start(cfg, jenv, seed=0, walk=40):
    """JAX and port train states from one JAX init, ``walk`` steps into
    their games."""
    network = build_network_for_env(jenv, cfg)
    tx = make_optimizer(_update_cfg(cfg))
    k_params, k_carry, k_update = jax.random.split(jax.random.PRNGKey(seed), 3)
    params = network.init(k_params)
    jstate = JaxTrainState(params=params, opt_state=tx.init(params),
                           carry=jax_init_carry(jenv, E, k_carry), obs_norm=JaxObsNorm.create(135),
                           popart=None, update_key=k_update)
    env = ShadowSkull()
    tnet = torch_build_network(env, cfg, torch.Generator().manual_seed(0))
    tnet.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    tstate = TrainState(network=tnet, opt_state=AdamState.create(tnet),
                        carry=init_rollout_carry(env, E, ReplaySource(), CPU),
                        obs_norm=ObsNormState.create(135, CPU))
    jstate, tstate = midgame(jstate, tstate, env, steps=walk, seed=seed)
    return network, tx, jstate, tstate, env


def compare_states(tstate, jstate, metrics=None, j_metrics=None, fields=FIELDS):
    # Reductions over minibatches and Adam steps in another order:
    # parameters and metrics rtol 1e-4 / atol 1e-5.
    if j_metrics is not None:
        assert set(j_metrics) <= set(metrics)
        for k, v in j_metrics.items():
            np.testing.assert_allclose(float(metrics[k]), float(v), rtol=1e-4, atol=1e-5, err_msg=k)
    for a, b in zip(tree_leaves(params_to_jax(tstate.network.state_dict())),
                    jax.tree_util.tree_leaves(jstate.params)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-5)
    for f in ("mean", "m2", "count"):
        np.testing.assert_allclose(getattr(tstate.obs_norm, f).numpy(),
                                   np.asarray(getattr(jstate.obs_norm, f)), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tstate.carry.last_value_per_player.numpy(),
                               np.asarray(jstate.carry.last_value_per_player), rtol=1e-4, atol=1e-5)
    for f in fields:
        np.testing.assert_array_equal(getattr(tstate.carry.env_states, f).numpy(),
                                      np.asarray(getattr(jstate.carry.env_states, f)), err_msg=f)


def test_two_ctde_train_steps_match_jax():
    cfg = skull_cfg()
    jenv = jax_fns(P)[0]
    network, tx, jstate, tstate, env = start(cfg, jenv)
    assert network.is_ctde and tstate.network.is_ctde
    j_step = jax.jit(jax_make_train_step(network, jenv, cfg, tx))
    t_step = make_train_step(env, cfg)
    src = ReplaySource()
    carry_key, update_key = jstate.carry.key, jstate.update_key
    ended = shaped = 0
    for _ in range(2):
        carry_key, keys = replay_rollout(src, carry_key)
        update_key = replay_update(src, update_key, cfg.num_epochs)
        js0 = jstate.carry.env_states
        env.begin(js0.replace(shaping_coef=jnp.full_like(js0.shaping_coef, SHAPING)), keys)
        jstate, j_m, j_logs = j_step(jstate, jnp.float32(LR), jnp.float32(ENT), jnp.float32(SHAPING))
        tstate, t_m, t_logs = t_step(tstate, LR, ENT, src, SHAPING)
        assert not src.uniforms and not src.perms  # every draw consumed, in order
        for f in ("completed", "total_rewards", "length", "outcome"):
            np.testing.assert_array_equal(getattr(t_logs, f).numpy(),
                                          np.asarray(getattr(j_logs, f), getattr(t_logs, f).numpy().dtype))
        compare_states(tstate, jstate, t_m, j_m)
        ended += int(t_logs.completed.sum())
        shaped += int((t_logs.total_rewards.abs().sum(-1) > 0).sum())
    assert set(j_m) == set(t_m)
    assert ended > 0 and shaped > ended  # games ended, and rounds paid the shaping
    assert float(tstate.carry.env_states.shaping_coef[0]) == np.float32(SHAPING)
    assert (tstate.carry.last_value_per_player.numpy() != 0).any()


@pytest.mark.parametrize("flags,item", [
    (["--config", "configs/liars_dice.toml", "--compute-dtype", "bfloat16", "--mesh-data", "2"],
     "A16"),
    (["--config", "configs/skull_ctde.toml", "--mesh-data", "2"], "A16"),
    (["--config", "configs/skull_ctde.toml", "--network-type", "cnn"], "A12b"),
])
def test_what_skull_still_lacks_is_refused(flags, item, tmp_path, capsys):
    """Multi-device runs exit 2 naming A16. The CNN, whose opponents A12b
    ported, needs an env with an obs shape, which Skull has not: refused
    by ``validate_config`` before a run dir is made, as JAX's network
    refuses it."""
    if item == "A12b":
        with pytest.raises(ValueError, match="obs_shape"):
            cli.main(["train", *flags, "--run-dir", str(tmp_path / "r")], device="cpu")
        assert not (tmp_path / "r").exists()
        return
    rc = cli.main(["train", *flags, "--run-dir", str(tmp_path / "r")], device="cpu")
    assert rc == 2
    assert f"ROADMAP {item}" in capsys.readouterr().err
    assert not (tmp_path / "r").exists()


@pytest.mark.parametrize("config,interval", [
    ("configs/liars_dice_ctde.toml", 2),
    ("configs/skull_ctde.toml", 8),
    ("configs/skull_ctde.toml", 2),
])
def test_the_ctde_configs_train_several_updates_a_rotation(config, interval, tmp_path, capsys):
    """The CTDE configs against the pool with ``--pool-rotation-interval``
    (A12c) through the CLI, cut to 8 envs x 8 steps and 16-wide towers:
    the rotations fall every W updates once the pool holds a checkpoint."""
    from tests.test_torch_selfplay_pool_step import cadence_run, rotation_steps

    want = cadence_run(config, interval, tmp_path / "r",
                       extra=("--critic-hidden-size", "16", "--critic-num-hidden", "1"))
    assert rotation_steps(capsys.readouterr().out) == want
    meta = json.loads((tmp_path / "r" / "checkpoints" / "latest" / "metadata.json").read_text())
    assert meta["step"] == 4 * interval * 64 and meta["network_type"] == "ctde"


def test_ctde_needs_privileged_observations(tmp_path, capsys):
    rc = cli.main(["train", "--config", "configs/connect_four.toml", "--network-type", "ctde",
                   "--opponent-pool-fraction", "0", "--run-dir", str(tmp_path / "r")], device="cpu")
    assert rc == 2
    assert "privileged observations" in capsys.readouterr().err


def test_trainer_uses_the_configured_player_count(tmp_path):
    from burn_ppo_torch.train import Trainer

    cfg = skull_cfg(num_envs=4, num_steps=4, total_steps=16, player_count={"type": "Fixed",
                                                                             "count": 3})
    trainer = Trainer(cfg, tmp_path, device="cpu", quiet=True)
    assert trainer.num_players == 3 and trainer.env.spec.num_players == 3
    assert trainer.state.carry.priv.shape == (4, 200)
    assert trainer.env.spec.privileged_obs_dim == 200

"""Liar's Dice (four players) with the CTDE critic, the slice as a whole: two
fused self-play train steps of the port against the JAX package's, and one
vs-pool step with CTDE opponents, from the same start state with a
reward-shaping coefficient above 0, JAX's own random draws replayed; the
``train`` command with both Liar's Dice configs on the CPU, whose
checkpoints the JAX package loads to the same logits and values.

JAX draws the dice from keys: a fresh game's from the reset key, a new
round's from a key in each env state. ``ShadowLiarsDice`` steps JAX's env
beside the port's, on the same actions and JAX's reset keys, and hands the
port each step the uniforms ``(face - 0.5) / 6`` of JAX's own dice (the
reset's and the reroll's); it also checks the two states agree at every
step."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from burn_ppo_tpu.checkpoint import CheckpointManager as JaxCheckpoints  # noqa: E402
from burn_ppo_tpu.config import Config  # noqa: E402
from burn_ppo_tpu.envs.base import EpisodeAccumulator as JaxAcc  # noqa: E402
from burn_ppo_tpu.ppo.normalization import ObsNormState as JaxObsNorm  # noqa: E402
from burn_ppo_tpu.ppo.pool_rollout import PoolSeating as JaxSeating  # noqa: E402
from burn_ppo_tpu.ppo.rollout import init_rollout_carry as jax_init_carry  # noqa: E402
from burn_ppo_tpu.ppo.update import make_optimizer  # noqa: E402
from burn_ppo_tpu.train import TrainState as JaxTrainState  # noqa: E402
from burn_ppo_tpu.train import _update_cfg, build_network_for_env  # noqa: E402
from burn_ppo_tpu.train import make_pool_train_step as jax_make_pool_step  # noqa: E402
from burn_ppo_tpu.train import make_train_step as jax_make_train_step  # noqa: E402
from burn_ppo_torch import cli  # noqa: E402
from burn_ppo_torch.checkpoint import load_model, load_obs_normalizer  # noqa: E402
from burn_ppo_torch.convert import params_from_jax  # noqa: E402
from burn_ppo_torch.envs.liars_dice import FIELDS, LiarsDice  # noqa: E402
from burn_ppo_torch.ppo.normalization import ObsNormState, obs_norm_apply  # noqa: E402
from burn_ppo_torch.ppo.pool_rollout import PoolSeating  # noqa: E402
from burn_ppo_torch.ppo.rollout import init_rollout_carry  # noqa: E402
from burn_ppo_torch.ppo.update import AdamState  # noqa: E402
from burn_ppo_torch.train import TrainState, make_pool_train_step, make_train_step  # noqa: E402
from burn_ppo_torch.train import build_network_for_env as torch_build_network  # noqa: E402
from tests.test_torch_checkpoint_load import _liars_dice_states  # noqa: E402
from tests.test_torch_liars_dice import jax_fns, to_port, u_of  # noqa: E402
from tests.test_torch_skull_ctde_pool import ctde_opponents  # noqa: E402
from tests.test_torch_skull_ctde_step import ReplaySource, replay_update  # noqa: E402
from tests.test_torch_skull_ctde_step import compare_states as compare_skull_states  # noqa: E402

E, T, P, A = 16, 16, 4, 49
OBS, PRIV = 270, 120
TINY = float(jnp.finfo(jnp.float32).tiny)
CPU = torch.device("cpu")
LR, ENT, SHAPING = 1e-3, 0.01, 0.05


class ShadowLiarsDice(LiarsDice):
    """The port's Liar's Dice, with JAX's stepped alongside (see the module
    docstring). ``begin`` hands it JAX's env states at the start of a
    rollout and the reset keys of each of its steps."""

    def __init__(self):
        self.js, self.keys, self.steps = None, [], 0

    def begin(self, js, keys):
        self.js, self.keys = js, list(keys)

    def step_autoreset(self, state, acc, action, reset_values, step_values=None):
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(state, f).numpy(), np.asarray(getattr(self.js, f)),
                                          err_msg=f"shadow diverged at step {self.steps}: {f}")
        fns = jax_fns()
        keys = self.keys.pop(0)
        n = len(action)
        dummy = JaxAcc(reward_sum=jnp.zeros((n, P)), length=jnp.zeros(n, jnp.int32))
        j = fns["step"](self.js, dummy, jnp.asarray(action.numpy()), keys)
        u_reset = torch.from_numpy(u_of(fns["reset"](keys).dice))
        u_step = torch.from_numpy(u_of(j[2].dice))
        self.js = j[0]
        self.steps += 1
        return super().step_autoreset(state, acc, action, u_reset, u_step)


def placeholder_dice(src, n=E):
    """The port's reset and reroll draws, replaced by the shadow."""
    src.uniforms += [np.zeros((n, 8), np.float32), np.zeros((n, 8), np.float32)]


def replay_rollout(src, key):
    """Per step (key, k_sample, k_reset) = split(key, 3) (rollout.py:236):
    the Gumbel uniforms, placeholders for the dice draws, the reset keys.
    Returns (key, reset keys)."""
    keys = []
    for _ in range(T):
        key, k_sample, k_reset = jax.random.split(key, 3)
        src.uniforms.append(np.asarray(jax.random.uniform(k_sample, (E, A), minval=TINY, maxval=1.0)))
        placeholder_dice(src)
        keys.append(jax.random.split(k_reset, E))
    return key, keys


def liars_cfg(**kw) -> Config:
    base = dict(env="liars_dice", num_envs=E, num_steps=T, num_epochs=2, num_minibatches=4,
                network_type="ctde", hidden_size=32, num_hidden=2, critic_hidden_size=48,
                critic_num_hidden=1, activation="relu", normalize_obs=True, learning_rate=LR,
                entropy_coef=ENT, seed=0, opponent_pool_fraction=0.0)
    return Config(**{**base, **kw})


def start(cfg, seed=0, walk=30):
    """JAX and port train states from one JAX init, ``walk`` random legal
    steps into their games (so that games end within a short rollout)."""
    jenv = jax_fns()["env"]
    network = build_network_for_env(jenv, cfg)
    tx = make_optimizer(_update_cfg(cfg))
    k_params, k_carry, k_update = jax.random.split(jax.random.PRNGKey(seed), 3)
    params = network.init(k_params)
    carry = jax_init_carry(jenv, E, k_carry)
    js = carry.env_states
    rng = np.random.default_rng(seed)
    acc = JaxAcc(reward_sum=jnp.zeros((E, P)), length=jnp.zeros(E, jnp.int32))
    mask = np.asarray(jax_fns()["views"](js)[1])
    key = jax.random.PRNGKey(seed + 99)
    for _ in range(walk):
        actions = np.array([rng.choice(np.flatnonzero(m)) for m in mask], np.int32)
        key, sub = jax.random.split(key)
        js, acc, _, _, _, mask, _ = jax_fns()["step"](js, acc, jnp.asarray(actions),
                                                      jax.random.split(sub, E))
        mask = np.asarray(mask)
    jstate = JaxTrainState(params=params, opt_state=tx.init(params),
                           carry=carry.replace(env_states=js), obs_norm=JaxObsNorm.create(OBS),
                           popart=None, update_key=k_update)
    env = ShadowLiarsDice()
    tnet = torch_build_network(env, cfg, torch.Generator().manual_seed(0))
    tnet.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    src = ReplaySource()
    src.uniforms.append(np.zeros((E, 8), np.float32))  # the reset's dice, replaced below
    tcarry = init_rollout_carry(env, E, src, CPU)
    ts = to_port(js)
    tcarry.env_states, tcarry.obs, tcarry.mask, tcarry.priv = (
        ts, env.obs(ts), env.action_mask(ts), env.privileged_obs(ts))
    tstate = TrainState(network=tnet, opt_state=AdamState.create(tnet), carry=tcarry,
                        obs_norm=ObsNormState.create(OBS, CPU))
    return network, tx, jstate, tstate, env


def compare_states(tstate, jstate, metrics=None, j_metrics=None):
    """Parameters, metrics and normalisers as for Skull (rtol 1e-4 / atol
    1e-5: reductions in another order); the env states exactly."""
    compare_skull_states(tstate, jstate, metrics, j_metrics, fields=FIELDS + ("shaping_coef",))


def with_shaping(js):
    return js.replace(shaping_coef=jnp.full_like(js.shaping_coef, SHAPING))


def test_two_ctde_train_steps_match_jax():
    cfg = liars_cfg()
    network, tx, jstate, tstate, env = start(cfg)
    assert network.is_ctde and tstate.network.is_ctde
    j_step = jax.jit(jax_make_train_step(network, jax_fns()["env"], cfg, tx))
    t_step = make_train_step(env, cfg)
    src = ReplaySource()
    carry_key, update_key = jstate.carry.key, jstate.update_key
    ended = shaped = 0
    for _ in range(2):
        carry_key, keys = replay_rollout(src, carry_key)
        update_key = replay_update(src, update_key, cfg.num_epochs)
        env.begin(with_shaping(jstate.carry.env_states), keys)
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


L, K, ACTIVE = 10, 4, 3  # 6 pool envs; a rotation of 3 opponents padded to 4 slots


def replay_pool_rollout(src, key, num_active):
    """Per step (key, k_sample, k_opp, k_reset, k_seat, k_slot) =
    split(key, 6) (pool_rollout.py:143): the learner's and the opponents'
    Gumbel uniforms, placeholders for the dice, the new seats and slots.
    Returns (key, reset keys)."""
    keys = []
    hi = max(num_active, 1)
    for _ in range(T):
        key, k_sample, k_opp, k_reset, k_seat, k_slot = jax.random.split(key, 6)
        src.uniforms.append(np.asarray(jax.random.uniform(k_sample, (E, A), minval=TINY, maxval=1.0)))
        src.uniforms.append(np.asarray(jax.random.uniform(k_opp, (E - L, A), minval=TINY,
                                                          maxval=1.0)))
        placeholder_dice(src)
        keys.append(jax.random.split(k_reset, E))
        src.ints.append((np.asarray(jax.random.randint(k_seat, (E,), 0, P)), 0, P))
        src.ints.append((np.asarray(jax.random.randint(k_slot, (E, P), 0, hi)), 0, hi))
    return key, keys


def test_ctde_pool_train_step_matches_jax():
    cfg = liars_cfg(opponent_pool_fraction=0.25)
    network, tx, jstate, tstate, env = start(cfg, seed=1, walk=45)
    j_opp, j_opp_norm, t_stack = ctde_opponents(network, env, cfg, ACTIVE, obs_dim=OBS)
    assert t_stack.weights[0].shape == (K, OBS, 32) and len(t_stack.weights) == 3
    k_seat = jax.random.PRNGKey(21)
    src = ReplaySource()
    k1, k2 = jax.random.split(k_seat)
    src.ints.append((np.asarray(jax.random.randint(k1, (E,), 0, P)), 0, P))
    src.ints.append((np.asarray(jax.random.randint(k2, (E, P), 0, ACTIVE)), 0, ACTIVE))
    j_seat = JaxSeating.create(E, L, P, ACTIVE, k_seat)
    t_seat = PoolSeating.create(E, L, P, ACTIVE, src)
    j_step = jax.jit(jax_make_pool_step(network, jax_fns()["env"], cfg, tx, L, K))
    t_step = make_pool_train_step(env, cfg, L)
    _, keys = replay_pool_rollout(src, jstate.carry.key, ACTIVE)
    replay_update(src, jstate.update_key, cfg.num_epochs)
    env.begin(with_shaping(jstate.carry.env_states), keys)
    jstate, j_seat, j_m, j_stats, j_rec = j_step(
        jstate, j_seat, j_opp, j_opp_norm, jnp.float32(LR), jnp.float32(ENT), jnp.float32(SHAPING),
        jnp.int32(ACTIVE))
    tstate, t_seat, t_m, t_stats, t_rec = t_step(tstate, t_seat, t_stack, ACTIVE, LR, ENT, src,
                                                 SHAPING)
    assert not src.uniforms and not src.ints and not src.perms  # every draw, in order
    compare_states(tstate, jstate, t_m, j_m)
    assert set(t_stats) == set(j_stats)
    for k in j_stats:
        np.testing.assert_allclose(t_stats[k].numpy(), np.asarray(j_stats[k]), rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    for f in ("completed", "outcome", "learner_seat", "seat_opp"):
        np.testing.assert_array_equal(getattr(t_rec, f).numpy().astype(np.int32),
                                      np.asarray(getattr(j_rec, f)).astype(np.int32), err_msg=f)
    np.testing.assert_array_equal(t_seat.seat_opp.numpy(), np.asarray(j_seat.seat_opp))
    np.testing.assert_array_equal(t_seat.learner_seat.numpy(), np.asarray(j_seat.learner_seat))
    # Three of the four seats of a pool env are the opponents'.
    assert L / E < float(t_m["learner_valid_fraction"]) < (L + (E - L) / 2) / E
    assert t_rec.completed.numpy().sum() > 0


@pytest.mark.parametrize("config,ctde", [("configs/liars_dice_ctde.toml", True),
                                         ("configs/liars_dice.toml", False)])
def test_train_command_trains_liars_dice_on_cpu(config, ctde, tmp_path):
    """Both Liar's Dice configs as users run them (four players, pool
    fraction 0.25; CTDE, or the MLP with --normalize-obs), cut to 8 envs x
    16 steps and 16-wide towers, a checkpoint every update; the JAX package
    loads the last one to the same logits and values."""
    run = tmp_path / "run"
    extra = (["--critic-hidden-size", "24", "--critic-num-hidden", "1"] if ctde
             else ["--normalize-obs"])
    rc = cli.main(
        ["train", "--config", config, "--num-envs", "8", "--num-steps", "16",
         "--total-steps", str(3 * 128), "--hidden-size", "16", "--num-hidden", "1", *extra,
         "--log-freq", "128", "--checkpoint-freq", "128", "--seed", "5", "--run-dir", str(run),
         "--quiet"],
        device="cpu",
    )
    assert rc == 0
    lines = [json.loads(x) for x in (run / "metrics.jsonl").read_text().splitlines()]
    scalars = [x for x in lines if x["type"] == "scalar"]
    assert all(np.isfinite(x["value"]) for x in scalars)
    names = {x["name"] for x in scalars}
    assert {"train/policy_loss", "train/value_loss", "train/learner_valid_fraction"} <= names
    ckpt = run / "checkpoints" / "latest"
    meta = json.loads((ckpt / "metadata.json").read_text())
    assert (meta["env_name"], meta["num_players"], meta["obs_dim"], meta["action_count"],
            meta["hidden_size"]) == ("liars_dice", 4, OBS, A, 16)
    assert meta["network_type"] == ("ctde" if ctde else "mlp")
    if ctde:
        assert (meta["privileged_obs_dim"], meta["critic_hidden_size"]) == (PRIV, 24)
    assert (run / "opponent_stats.json").exists()
    net, _ = load_model(ckpt)
    norm = load_obs_normalizer(ckpt)
    assert (norm is not None) == (not ctde)
    jnet, jparams, _ = JaxCheckpoints.load_model(ckpt)
    jnorm = JaxCheckpoints.load_obs_normalizer(ckpt)
    obs, priv = _liars_dice_states(64, seed=4)
    t_obs = torch.from_numpy(obs)
    if norm is not None:
        from burn_ppo_tpu.ppo.normalization import obs_norm_apply as jax_obs_norm_apply

        t_obs = obs_norm_apply(norm, t_obs)
        obs = np.asarray(jax_obs_norm_apply(jnorm, obs))
    with torch.no_grad():
        t_logits, t_values = net(t_obs, torch.from_numpy(priv))
    if ctde:
        j_logits, j_values = jnet.forward_actor(jparams, obs), jnet.forward_critic(jparams, priv, obs)
    else:
        j_logits, j_values = jnet.forward(jparams, obs)
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), rtol=0, atol=1e-5)
    np.testing.assert_allclose(t_values.numpy(), np.asarray(j_values), rtol=0, atol=1e-5)

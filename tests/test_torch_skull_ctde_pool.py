"""Skull (four players, CTDE) against the opponent pool: one fused vs-pool
train step of the port against the JAX package's, with CTDE opponents on
three of the four seats of every pool env, JAX's own random draws
replayed; and the ``train`` command with ``configs/skull_ctde.toml`` on the
CPU, whose checkpoint the JAX package loads to the same logits and values."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

torch.set_num_threads(1)

from burn_ppo_tpu.checkpoint import CheckpointManager as JaxCheckpoints  # noqa: E402
from burn_ppo_tpu.ppo.pool_rollout import PoolSeating as JaxSeating  # noqa: E402
from burn_ppo_tpu.train import make_pool_train_step as jax_make_pool_step  # noqa: E402
from burn_ppo_torch import cli  # noqa: E402
from burn_ppo_torch.checkpoint import load_model  # noqa: E402
from burn_ppo_torch.convert import params_from_jax  # noqa: E402
from burn_ppo_torch.ppo.normalization import ObsNormState  # noqa: E402
from burn_ppo_torch.ppo.pool_rollout import OpponentStack, PoolSeating, actor_params  # noqa: E402
from burn_ppo_torch.train import make_pool_train_step  # noqa: E402
from burn_ppo_torch.train import build_network_for_env as torch_build_network  # noqa: E402
from tests.test_torch_checkpoint_load import _skull_states  # noqa: E402
from tests.test_torch_skull import jax_fns  # noqa: E402
from tests.test_torch_skull_ctde_step import (  # noqa: E402
    ENT,
    LR,
    SHAPING,
    TINY,
    A,
    E,
    P,
    ReplaySource,
    compare_states,
    replay_update,
    skull_cfg,
    start,
)

L, K, ACTIVE = 10, 4, 3  # 6 pool envs; a rotation of 3 opponents padded to 4 slots
T = 16


def replay_pool_rollout(src, key, num_active):
    """Per step (key, k_sample, k_opp, k_reset, k_seat, k_slot) =
    split(key, 6) (pool_rollout.py:143): the learner's and the opponents'
    Gumbel uniforms, a placeholder for the step draw (the shadow replaces
    it), the new seats and slots. Returns (key, reset keys)."""
    keys = []
    hi = max(num_active, 1)
    for _ in range(T):
        key, k_sample, k_opp, k_reset, k_seat, k_slot = jax.random.split(key, 6)
        src.uniforms.append(np.asarray(jax.random.uniform(k_sample, (E, A), minval=TINY, maxval=1.0)))
        src.uniforms.append(np.asarray(jax.random.uniform(k_opp, (E - L, A), minval=TINY,
                                                          maxval=1.0)))
        src.uniforms.append(np.zeros(E, np.float32))
        keys.append(jax.random.split(k_reset, E))
        src.ints.append((np.asarray(jax.random.randint(k_seat, (E,), 0, P)), 0, P))
        src.ints.append((np.asarray(jax.random.randint(k_slot, (E, P), 0, hi)), 0, hi))
    return key, keys


def ctde_opponents(network, env, cfg, n):
    """n JAX-initialised CTDE nets and obs normalisers, stacked both ways
    and padded to K by repeating the first (refresh_rotation)."""
    rng = np.random.default_rng(7)
    jparams, tparams, jnorms, tnorms = [], [], [], []
    from burn_ppo_tpu.ppo.normalization import ObsNormState as JaxObsNorm

    for i in range(n):
        p = network.init(jax.random.PRNGKey(200 + i))
        net = torch_build_network(env, cfg, torch.Generator().manual_seed(0))
        net.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, p)))
        jparams.append(p)
        tparams.append(actor_params(net))
        mean, m2 = rng.random(135).astype(np.float32), (rng.random(135) * 40).astype(np.float32)
        count = np.float32([30.0, 1.0, 60.0][i % 3])
        jnorms.append(JaxObsNorm(mean=jnp.asarray(mean), m2=jnp.asarray(m2), count=jnp.asarray(count)))
        tnorms.append(ObsNormState(mean=torch.from_numpy(mean), m2=torch.from_numpy(m2),
                                   count=torch.tensor(count)))
    order = list(range(n)) + [0] * (K - n)
    stack_j = lambda xs: jax.tree_util.tree_map(lambda *ys: jnp.stack(ys), *[xs[i] for i in order])
    return (stack_j(jparams), stack_j(jnorms),
            OpponentStack.of([tparams[i] for i in order], [tnorms[i] for i in order]))


def test_ctde_pool_train_step_matches_jax():
    cfg = skull_cfg(opponent_pool_fraction=0.3)
    jenv = jax_fns(P)[0]
    network, tx, jstate, tstate, env = start(cfg, jenv, seed=1, walk=90)
    j_opp, j_opp_norm, t_stack = ctde_opponents(network, env, cfg, ACTIVE)
    assert t_stack.weights[0].shape == (K, 135, 32) and len(t_stack.weights) == 3
    k_seat = jax.random.PRNGKey(21)
    src = ReplaySource()
    k1, k2 = jax.random.split(k_seat)
    src.ints.append((np.asarray(jax.random.randint(k1, (E,), 0, P)), 0, P))
    src.ints.append((np.asarray(jax.random.randint(k2, (E, P), 0, ACTIVE)), 0, ACTIVE))
    j_seat = JaxSeating.create(E, L, P, ACTIVE, k_seat)
    t_seat = PoolSeating.create(E, L, P, ACTIVE, src)
    j_step = jax.jit(jax_make_pool_step(network, jenv, cfg, tx, L, K))
    t_step = make_pool_train_step(env, cfg, L)
    _, keys = replay_pool_rollout(src, jstate.carry.key, ACTIVE)
    replay_update(src, jstate.update_key, cfg.num_epochs)
    js0 = jstate.carry.env_states
    env.begin(js0.replace(shaping_coef=jnp.full_like(js0.shaping_coef, SHAPING)), keys)
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


def test_train_command_trains_skull_ctde_on_cpu(tmp_path):
    """configs/skull_ctde.toml as users run it (four players, CTDE, pool
    fraction 0.3), cut to 8 envs x 16 steps and 16-wide towers."""
    run = tmp_path / "run"
    rc = cli.main(
        ["train", "--config", "configs/skull_ctde.toml", "--num-envs", "8", "--num-steps", "16",
         "--total-steps", str(3 * 128), "--hidden-size", "16", "--num-hidden", "1",
         "--critic-hidden-size", "24", "--critic-num-hidden", "1", "--log-freq", "128",
         "--checkpoint-freq", "128", "--seed", "5", "--run-dir", str(run), "--quiet"],
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
    assert (meta["network_type"], meta["num_players"], meta["privileged_obs_dim"],
            meta["critic_hidden_size"], meta["hidden_size"]) == ("ctde", 4, 200, 24, 16)
    assert (run / "opponent_stats.json").exists()
    # The JAX package loads the port's checkpoint to the same logits and values.
    net, _ = load_model(ckpt)
    jnet, jparams, _ = JaxCheckpoints.load_model(ckpt)
    obs, priv = _skull_states(64, seed=4)
    with torch.no_grad():
        t_logits, t_values = net(torch.from_numpy(obs), torch.from_numpy(priv))
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(jnet.forward_actor(jparams, obs)),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(t_values.numpy(),
                               np.asarray(jnet.forward_critic(jparams, priv, obs)), rtol=0, atol=1e-5)


def test_pool_loads_the_committed_skull_ctde_checkpoints_as_opponents(tmp_path):
    """The three CTDE 512x2 Skull checkpoints as a rotation read from disk:
    each row's acting opponent (obs normalisation, then the actor tower)
    against JAX's stacked forward_actor and one-hot selection."""
    import shutil
    from pathlib import Path

    from burn_ppo_tpu.ppo.normalization import obs_norm_apply as jax_obs_norm_apply
    from burn_ppo_tpu.selfplay.opponent_pool import OpponentPool as JaxPool
    from burn_ppo_torch.ppo.pool_rollout import opponent_actor_forward_plain
    from burn_ppo_torch.selfplay.opponent_pool import OpponentPool

    gauntlet = Path(__file__).resolve().parent.parent / "gauntlet" / "skull"
    for i, name in enumerate(("r4", "r4_mid", "r4_best")):
        shutil.copytree(gauntlet / name, tmp_path / "checkpoints" / f"step_{i + 1:08d}")
    K = 4
    stack, names = OpponentPool(tmp_path, max_active=4, seed=2).refresh_rotation(pad_to=K)
    j_params, j_norm, j_names = JaxPool(tmp_path, max_active=4, seed=2).refresh_rotation(pad_to=K)
    assert names == j_names and len(names) == 3
    assert stack.activation == "tanh" and stack.weights[0].shape == (K, 135, 512)
    assert stack.norm is not None and stack.norm.mean.shape == (K, 135)
    jnet, _, _ = JaxCheckpoints.load_model(gauntlet / "r4")
    obs, _ = _skull_states(48, seed=6)
    slot = np.random.default_rng(1).integers(0, 3, 48).astype(np.int32)
    logits_k = jax.vmap(lambda p, n: jnet.forward_actor(p, jax_obs_norm_apply(n, obs)))(j_params, j_norm)
    ref = np.asarray(jnp.einsum("kea,ek->ea", logits_k, jax.nn.one_hot(slot, K, dtype=logits_k.dtype)))
    mine = opponent_actor_forward_plain(torch.from_numpy(obs), torch.from_numpy(slot), stack)
    # f32 on both sides; logits reach |20|: rtol 1e-5 + atol 1e-5.
    np.testing.assert_allclose(mine.numpy(), ref, rtol=1e-5, atol=1e-5)

"""The trainer's rollout on static buffers (``ppo/rollout_graph.py``), on
the CPU, against the JAX package step by step, JAX's random draws
replayed. On a card the same code is captured into one CUDA graph and
replayed; each input a graph would read at a stale address is covered
here by an update that changes it:

* the obs normalizer's stats, which every update merges its batch into
  in place (three CartPole train steps);
* the scheduled shaping coefficient (Liar's Dice, a value per update);
* the opponent stack of a new rotation and the active slot count of the
  reseat (Connect Four against the pool);
* the seating, remapped on the host after the slot count shrinks, as the
  ``Trainer`` does.
"""

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
from burn_ppo_tpu.train import make_train_step as jax_make_train_step  # noqa: E402
from burn_ppo_torch.convert import params_to_jax, tree_leaves  # noqa: E402
from burn_ppo_torch.envs.cartpole import CartPole  # noqa: E402
from burn_ppo_torch.models.network import ActorCriticNetwork  # noqa: E402
from burn_ppo_torch.ppo.normalization import ObsNormState  # noqa: E402
from burn_ppo_torch.ppo.pool_rollout import PoolSeating  # noqa: E402
from burn_ppo_torch.ppo.rollout import TorchRandomSource, init_rollout_carry  # noqa: E402
from burn_ppo_torch.ppo.rollout_graph import RolloutRunner, copy_into  # noqa: E402
from burn_ppo_torch.ppo.update import AdamState  # noqa: E402
from burn_ppo_torch.train import TrainState, make_pool_train_step, make_train_step  # noqa: E402
from tests import test_torch_liars_dice_ctde_step as ld  # noqa: E402
from tests.test_torch_pool_rollout import (  # noqa: E402
    CPU,
    JENV as C4_JENV,
    L as C4_L,
    T as C4_T,
    E as C4_E,
    K as C4_K,
    ReplaySource as PoolReplaySource,
    opponents,
    replay_pool_rollout,
    replay_seating,
    start as c4_start,
)
from tests.test_torch_train_step import (  # noqa: E402
    CFG as CARTPOLE_CFG,
    ENT,
    JENV as CARTPOLE_JENV,
    LR,
    ReplaySource,
    _replay_rollout,
    _replay_update,
    start,
)


def _assert_params_match(tstate, jstate):
    for a, b in zip(tree_leaves(params_to_jax(tstate.network.state_dict())),
                    jax.tree_util.tree_leaves(jstate.params)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-5)


def test_three_train_steps_on_the_static_carry_match_jax(start):
    """Three CartPole train steps: the carry the step returns is the
    runner's static carry every time, the update merges the batch into
    the runner's obs-norm stats in place (the state's stats are the
    runner's, which the next rollout reads), and every step matches
    JAX's."""
    network, tx, jstate, tstate, env, _ = start
    j_step = jax.jit(jax_make_train_step(network, CARTPOLE_JENV, CARTPOLE_CFG, tx))
    t_step = make_train_step(env, CARTPOLE_CFG)
    runner = t_step.runner
    src = ReplaySource()
    carry_key, update_key = jstate.carry.key, jstate.update_key
    carries = []
    for _ in range(3):
        carry_key = _replay_rollout(src, carry_key)
        update_key = _replay_update(src, update_key)
        jstate, j_m, j_logs = j_step(jstate, jnp.float32(LR), jnp.float32(ENT), jnp.float32(0.0))
        tstate, t_m, t_logs = t_step(tstate, LR, ENT, src)
        assert not src.uniforms and not src.perms
        # The update merged the batch into the runner's stats in place.
        for f in ("mean", "m2", "count"):
            assert getattr(tstate.obs_norm, f) is getattr(runner.obs_norm, f)
            np.testing.assert_allclose(getattr(tstate.obs_norm, f).numpy(),
                                       np.asarray(getattr(jstate.obs_norm, f)), rtol=1e-5)
        carries.append(tstate.carry)
        np.testing.assert_array_equal(t_logs.completed.numpy(),
                                      np.asarray(j_logs.completed, np.float32))
        for k, v in j_m.items():
            np.testing.assert_allclose(float(t_m[k]), float(v), rtol=1e-4, atol=1e-5, err_msg=k)
        _assert_params_match(tstate, jstate)
        j_obs = jax.vmap(CARTPOLE_JENV.obs)(jstate.carry.env_states)
        np.testing.assert_allclose(tstate.carry.obs.numpy(), np.asarray(j_obs), rtol=0, atol=1e-5)
        # Normalized returns: the port's prefix pass runs in f64 (rtol
        # 1e-3, as in the rollout tests).
        for f in ("returns", "mean", "m2", "count"):
            np.testing.assert_allclose(getattr(tstate.carry.return_norm, f).numpy(),
                                       np.asarray(getattr(jstate.carry.return_norm, f)),
                                       rtol=1e-3, atol=1e-5, err_msg=f)
    assert carries[0] is carries[1] is carries[2] is runner.carry
    assert runner.graph is None


def test_a_shaping_schedule_reaches_the_next_rollouts_env_states():
    """Liar's Dice CTDE self-play, three updates under a shaping schedule
    (0.05, 0.0, 0.02): each rollout's env states carry that update's
    coefficient (the runner writes it into its device scalar before the
    rollout), and each step matches JAX's given the same coefficient."""
    cfg = ld.liars_cfg()
    network, tx, jstate, tstate, env = ld.start(cfg)
    j_step = jax.jit(jax_make_train_step(network, ld.jax_fns()["env"], cfg, tx))
    t_step = make_train_step(env, cfg)
    src = ld.ReplaySource()
    carry_key, update_key = jstate.carry.key, jstate.update_key
    shaped = []
    for coef in (0.05, 0.0, 0.02):
        carry_key, keys = ld.replay_rollout(src, carry_key)
        update_key = ld.replay_update(src, update_key, cfg.num_epochs)
        js = jstate.carry.env_states
        env.begin(js.replace(shaping_coef=jnp.full_like(js.shaping_coef, coef)), keys)
        jstate, j_m, j_logs = j_step(jstate, jnp.float32(ld.LR), jnp.float32(ld.ENT),
                                     jnp.float32(coef))
        tstate, t_m, t_logs = t_step(tstate, ld.LR, ld.ENT, src, coef)
        assert not src.uniforms and not src.perms
        assert float(t_step.runner.shaping) == np.float32(coef)
        assert (tstate.carry.env_states.shaping_coef == np.float32(coef)).all()
        for f in ("completed", "total_rewards", "length", "outcome"):
            np.testing.assert_array_equal(
                getattr(t_logs, f).numpy(),
                np.asarray(getattr(j_logs, f), getattr(t_logs, f).numpy().dtype))
        ld.compare_states(tstate, jstate, t_m, j_m)
        shaped.append(float(t_logs.total_rewards.abs().sum()))
    assert all(s > 0 for s in shaped)


def _c4_pool_start(seed):
    cfg, network, params, tnet, env, j_norm, t_norm = c4_start(seed=seed)
    cfg.num_epochs, cfg.num_minibatches = 2, 4
    tx = make_optimizer(_update_cfg(cfg))
    k_carry, k_seat, k_update = jax.random.split(jax.random.PRNGKey(seed + 20), 3)
    jstate = JaxTrainState(params=params, opt_state=tx.init(params),
                           carry=jax_init_carry(C4_JENV, C4_E, k_carry), obs_norm=j_norm,
                           popart=None, update_key=k_update)
    src = PoolReplaySource()
    tstate = TrainState(network=tnet, opt_state=AdamState.create(tnet),
                        carry=init_rollout_carry(env, C4_E, src, CPU), obs_norm=t_norm)
    return cfg, network, tx, env, jstate, tstate, src, k_seat


def _pool_update(src, keys, cfg, j_step, t_step, jstate, tstate, j_seat, t_seat, rotation,
                 num_active):
    """One vs-pool update on both sides: JAX's draws replayed, the results
    compared as the two-step vs-pool test compares them."""
    j_opp, j_opp_norm, t_stack = rotation
    carry_key, update_key = keys
    carry_key = replay_pool_rollout(src, carry_key, num_active)
    update_key, sub = jax.random.split(update_key)
    for k in jax.random.split(sub, cfg.num_epochs):
        src.perms.append(np.asarray(jax.random.permutation(k, C4_T * C4_E)))
    jstate, j_seat, j_m, j_stats, j_rec = j_step(
        jstate, j_seat, j_opp, j_opp_norm, jnp.float32(LR), jnp.float32(ENT), jnp.float32(0.0),
        jnp.int32(num_active))
    tstate, t_seat, t_m, t_stats, t_rec = t_step(tstate, t_seat, t_stack, num_active, LR, ENT,
                                                 src)
    assert not src.uniforms and not src.ints and not src.perms
    for k, v in j_m.items():
        np.testing.assert_allclose(float(t_m[k]), float(v), rtol=1e-4, atol=1e-5, err_msg=k)
    _assert_params_match(tstate, jstate)
    np.testing.assert_allclose(tstate.carry.last_value_per_player.numpy(),
                               np.asarray(jstate.carry.last_value_per_player), rtol=1e-4,
                               atol=1e-5)
    for f in ("completed", "outcome", "learner_seat", "seat_opp"):
        np.testing.assert_array_equal(getattr(t_rec, f).numpy().astype(np.int32),
                                      np.asarray(getattr(j_rec, f)).astype(np.int32), err_msg=f)
    np.testing.assert_array_equal(t_seat.seat_opp.numpy(), np.asarray(j_seat.seat_opp))
    np.testing.assert_array_equal(t_seat.learner_seat.numpy(), np.asarray(j_seat.learner_seat))
    return (carry_key, update_key), jstate, tstate, j_seat, t_seat, t_rec


def test_a_new_rotation_and_a_growing_active_count_reach_the_next_rollout():
    """Two vs-pool updates: the second with a new rotation (other
    opponents, the same padded slot count) and one more active slot. The
    runner copies the stack into its own (its addresses kept, as K7's
    captured pointers need), asks the random source for the reseat's slots
    below the new count (the replayed source checks each draw's bounds),
    and both updates match JAX's."""
    cfg, network, tx, env, jstate, tstate, src, k_seat = _c4_pool_start(seed=4)
    replay_seating(src, k_seat, 2)
    j_seat = JaxSeating.create(C4_E, C4_L, 2, 2, k_seat)
    t_seat = PoolSeating.create(C4_E, C4_L, 2, 2, src)
    j_step = jax.jit(jax_make_pool_step(network, C4_JENV, cfg, tx, C4_L, C4_K))
    t_step = make_pool_train_step(env, cfg, C4_L)
    keys = (jstate.carry.key, jstate.update_key)
    addresses = []
    for rotation, active in ((opponents(network, 2, seed=5), 2),
                             (opponents(network, 3, seed=9), 3)):
        keys, jstate, tstate, j_seat, t_seat, t_rec = _pool_update(
            src, keys, cfg, j_step, t_step, jstate, tstate, j_seat, t_seat, rotation, active)
        static = t_step.runner.opponents
        assert int(t_step.runner.slot_hi) == active
        assert static is not rotation[2]
        for a, b in zip(static.weights + static.biases, rotation[2].weights + rotation[2].biases):
            assert torch.equal(a, b)
        addresses.append([w.data_ptr() for w in static.weights + static.biases])
    assert addresses[0] == addresses[1]


def test_a_seating_remapped_after_the_slot_count_shrinks_is_what_the_next_rollout_reads():
    """Three active slots, then two: the ``Trainer``'s host remap
    (``seat_opp % K``, new tensors) goes into the runner's static seating,
    and the second rollout's first step records the remapped slots; both
    updates match JAX's on the same remap."""
    cfg, network, tx, env, jstate, tstate, src, k_seat = _c4_pool_start(seed=6)
    replay_seating(src, k_seat, 3)
    j_seat = JaxSeating.create(C4_E, C4_L, 2, 3, k_seat)
    t_seat = PoolSeating.create(C4_E, C4_L, 2, 3, src)
    j_step = jax.jit(jax_make_pool_step(network, C4_JENV, cfg, tx, C4_L, C4_K))
    t_step = make_pool_train_step(env, cfg, C4_L)
    keys = (jstate.carry.key, jstate.update_key)
    rotation = opponents(network, 3, seed=1)
    keys, jstate, tstate, j_seat, t_seat, _ = _pool_update(
        src, keys, cfg, j_step, t_step, jstate, tstate, j_seat, t_seat, rotation, 3)
    assert int(t_seat.seat_opp.max()) == 2
    static = t_step.runner.seating
    assert t_seat is static
    t_seat = PoolSeating(t_seat.learner_seat, t_seat.seat_opp % 2)
    j_seat = j_seat.replace(seat_opp=j_seat.seat_opp % 2)
    remapped = t_seat.seat_opp.clone()
    keys, jstate, tstate, j_seat, t_seat, t_rec = _pool_update(
        src, keys, cfg, j_step, t_step, jstate, tstate, j_seat, t_seat,
        opponents(network, 2, seed=2), 2)
    assert t_seat is static
    np.testing.assert_array_equal(t_rec.seat_opp[0].numpy(), remapped[C4_L:].numpy())
    assert int(t_rec.seat_opp.max()) < 2


# ---------------------------------------------------------------------------
# The runner's own checks
# ---------------------------------------------------------------------------


def test_copy_into_writes_in_place_and_refuses_another_structure():
    a = ObsNormState.create(3, CPU)
    b = ObsNormState(mean=torch.ones(3), m2=torch.full((3,), 2.0), count=torch.tensor(5.0))
    mean = a.mean
    copy_into(a, b)
    assert a.mean is mean and torch.equal(a.mean, b.mean) and float(a.count) == 5.0
    with pytest.raises(ValueError, match="shape"):
        copy_into(a, ObsNormState.create(4, CPU))
    with pytest.raises(ValueError, match="tensors"):
        copy_into(PoolSeating(torch.zeros(2), torch.zeros(2, 2)), a)


@pytest.mark.parametrize("n", [1, 3, 8])
def test_a_device_slot_bound_draws_every_slot_below_it(n):
    """``TorchRandomSource.integers`` with a 0-dim tensor bound (the vs-pool
    reseat's, which a graph reads at each replay): i32 values in [0, n),
    every one of them drawn, each near 1/n of the draws."""
    rng = TorchRandomSource(torch.Generator().manual_seed(n))
    x = rng.integers((4096, 4), 0, torch.tensor(n, dtype=torch.int32))
    assert x.dtype == torch.int32 and x.shape == (4096, 4)
    counts = torch.bincount(x.flatten().long(), minlength=n)
    assert counts.numel() == n and bool((counts > 0).all())
    assert float((counts / x.numel() - 1.0 / n).abs().max()) < 0.02


def test_the_pool_rollout_draws_the_same_slots_from_an_int_or_a_tensor_bound():
    """``collect_rollouts_with_opponents`` turns an int active count into the
    tensor bound the runner passes, so the eager loop and a replayed graph
    share one draw rule: from one generator state both give the same
    rollout, its reseats drawn below the count."""
    from burn_ppo_torch.envs.connect_four import ConnectFour
    from burn_ppo_torch.ppo.pool_rollout import (
        OpponentStack,
        actor_params,
        collect_rollouts_with_opponents,
    )

    env = ConnectFour()
    E, L, K = 16, 8, 4
    net = ActorCriticNetwork(env.spec.obs_dim, env.spec.num_actions, hidden_size=8,
                             num_hidden=1, activation="relu",
                             generator=torch.Generator().manual_seed(0))
    stack = OpponentStack.of([actor_params(net)] * K, None)
    outs = []
    for bound in (3, torch.tensor(3, dtype=torch.int32)):
        rng = TorchRandomSource(torch.Generator().manual_seed(7))
        carry = init_rollout_carry(env, E, rng, CPU)
        seating = PoolSeating.create(E, L, env.spec.num_players, 3, rng)
        outs.append(collect_rollouts_with_opponents(net, env, stack, carry, seating, None, rng,
                                                    num_steps=12, num_learner_envs=L,
                                                    num_active=bound))
    for a, b in zip(*(copy_tree(o) for o in outs)):
        assert torch.equal(a, b)
    assert int(outs[0][1].seat_opp.max()) < 3 and bool(outs[0][2].dones.any())
    with pytest.raises(ValueError, match="from 0"):
        TorchRandomSource(torch.Generator()).integers((2,), 1, torch.tensor(3))


def test_every_kernel_wrapper_is_registered_once():
    """The wrappers' one registry (``kernels.WRAPPERS``), whose counters a
    capture puts back: every wrapper of a csrc kernel, each once."""
    from burn_ppo_torch import kernels
    from burn_ppo_torch.envs.cartpole import cartpole_step_autoreset
    from burn_ppo_torch.envs.connect_four import connect_four_step_autoreset
    from burn_ppo_torch.envs.liars_dice import liars_dice_step_autoreset
    from burn_ppo_torch.envs.skull import skull_step_autoreset
    from burn_ppo_torch.ops.categorical import masked_sample, sample_with_temperature
    from burn_ppo_torch.ops.gae import compute_gae, compute_gae_multiplayer
    from burn_ppo_torch.ppo import normalization as norm
    from burn_ppo_torch.ppo.episode_stats import summarize_episode_logs
    from burn_ppo_torch.ppo.pool_rollout import opponent_actor_forward
    from burn_ppo_torch.ppo.update import clip_adam, ppo_loss

    want = {cartpole_step_autoreset, connect_four_step_autoreset, liars_dice_step_autoreset,
            skull_step_autoreset, masked_sample, compute_gae, compute_gae_multiplayer,
            norm.obs_norm_apply, norm.obs_norm_update, norm.return_norm_roll,
            norm.return_norm_finalize, summarize_episode_logs, opponent_actor_forward,
            clip_adam, ppo_loss, sample_with_temperature, norm.popart_update_rescale,
            norm.popart_denormalize}
    assert len(kernels.WRAPPERS) == len(set(kernels.WRAPPERS)) == len(want)
    assert set(kernels.WRAPPERS) == want
    assert all(isinstance(w.launches, int) for w in kernels.WRAPPERS)


def copy_tree(out):
    from burn_ppo_torch.ppo.rollout_graph import state_leaves

    return [t.clone() for t in state_leaves(list(out))]


def test_switching_the_obs_normalizer_is_refused():
    env = CartPole()
    rng = TorchRandomSource(torch.Generator().manual_seed(0))
    carry = init_rollout_carry(env, 4, rng, CPU)
    runner = RolloutRunner(env, num_steps=2, gamma=0.99, normalize_returns=False)
    net = _tiny_cartpole_net()
    carry, batch, _ = runner.run(net, carry, ObsNormState.create(5, CPU), rng)
    assert batch.obs.shape == (2, 4, 5) and bool((batch.valid_mask == 1).all())
    with pytest.raises(ValueError, match="obs normalizer"):
        runner.run(net, carry, None, rng)


def _tiny_cartpole_net():
    return ActorCriticNetwork(5, 2, hidden_size=8, num_hidden=1, activation="tanh",
                              generator=torch.Generator().manual_seed(0))

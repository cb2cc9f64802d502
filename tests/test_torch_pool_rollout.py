"""The vs-pool rollout of the port against the JAX package's: kernel K7's
plain version (each row's acting opponent) against JAX's stacked vmap +
one-hot selection on the committed MLP 512x2 checkpoints, and
``collect_rollouts_with_opponents`` step for step, JAX's random draws
replayed."""

import dataclasses
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from burn_ppo_tpu.checkpoint import CheckpointManager as JaxCheckpoints  # noqa: E402
from burn_ppo_tpu.config import Config  # noqa: E402
from burn_ppo_tpu.envs import make_env as jax_make_env  # noqa: E402
from burn_ppo_tpu.ppo.normalization import ObsNormState as JaxObsNorm  # noqa: E402
from burn_ppo_tpu.ppo.normalization import obs_norm_apply as jax_obs_norm_apply  # noqa: E402
from burn_ppo_tpu.ppo.pool_rollout import PoolSeating as JaxSeating  # noqa: E402
from burn_ppo_tpu.ppo.pool_rollout import (  # noqa: E402
    collect_rollouts_with_opponents as jax_collect_pool,
)
from burn_ppo_tpu.ppo.rollout import init_rollout_carry as jax_init_carry  # noqa: E402
from burn_ppo_tpu.selfplay.opponent_pool import OpponentPool as JaxPool  # noqa: E402
from burn_ppo_tpu.train import build_network_for_env  # noqa: E402
from burn_ppo_torch.convert import params_from_jax  # noqa: E402
from burn_ppo_torch.envs.base import EpisodeAccumulator  # noqa: E402
from burn_ppo_torch.envs.connect_four import ConnectFour  # noqa: E402
from burn_ppo_torch.ppo.normalization import ObsNormState  # noqa: E402
from burn_ppo_torch.ppo.pool_rollout import (  # noqa: E402
    OpponentStack,
    PoolSeating,
    actor_params,
    collect_rollouts_with_opponents,
    opponent_actor_forward,
    opponent_actor_forward_plain,
)
from burn_ppo_torch.ppo.rollout import RandomSource, init_rollout_carry  # noqa: E402
from burn_ppo_torch.selfplay.opponent_pool import OpponentPool  # noqa: E402
from burn_ppo_torch.train import build_network_for_env as torch_build_network  # noqa: E402

GAUNTLET = Path(__file__).resolve().parent.parent / "gauntlet" / "connect_four"
TINY = float(jnp.finfo(jnp.float32).tiny)
CPU = torch.device("cpu")
JENV = jax_make_env("connect_four")


def _positions(n: int, seed: int) -> np.ndarray:
    """Raw obs of n positions reached by random legal play."""
    rng = np.random.default_rng(seed)
    env = ConnectFour()
    E = 16
    state = env.reset(torch.empty(E, 0))
    acc = EpisodeAccumulator.zero(E, 2, CPU)
    out = []
    while sum(len(o) for o in out) < n:
        mask = env.action_mask(state).numpy()
        actions = np.array([rng.choice(np.flatnonzero(m)) for m in mask], np.int32)
        step = env.step_autoreset(state, acc, torch.from_numpy(actions), torch.empty(E, 0))
        out.append(step.obs.numpy())
        state, acc = step.state, step.acc
    return np.concatenate(out)[:n]


def _jax_select(network, opp_params, opp_norm, obs, slot, K):
    """burn_ppo_tpu/ppo/pool_rollout.py:126-139 and 171-178: every slot's
    normalisation and actor over every row, then a one-hot contraction."""
    logits_k = jax.vmap(lambda p, n: network.forward_actor(p, jax_obs_norm_apply(n, obs)))(
        opp_params, opp_norm)
    return jnp.einsum("kea,ek->ea", logits_k, jax.nn.one_hot(slot, K, dtype=logits_k.dtype))


@pytest.fixture(scope="module")
def gauntlet_run(tmp_path_factory):
    """A run directory whose checkpoints are the three committed r4 ones."""
    run = tmp_path_factory.mktemp("gauntlet_run")
    for i, name in enumerate(("r4", "r4_mid", "r4_best")):
        shutil.copytree(GAUNTLET / name, run / "checkpoints" / f"step_{i + 1:08d}")
    return run


@pytest.mark.parametrize("low_count_slot", [None, 1])
def test_k7_plain_matches_jax_on_the_committed_checkpoints(gauntlet_run, low_count_slot):
    K = 8
    pool = OpponentPool(gauntlet_run, max_active=8, seed=4)
    jpool = JaxPool(gauntlet_run, max_active=8, seed=4)
    stack, names = pool.refresh_rotation(pad_to=K)
    j_params, j_norm, j_names = jpool.refresh_rotation(pad_to=K)
    assert names == j_names and len(names) == 3 and stack.num_slots == K
    assert stack.activation == "tanh" and stack.weights[0].shape == (K, 86, 512)
    if low_count_slot is not None:
        # A slot whose normaliser has seen < 2 samples is the identity.
        stack.norm.count[low_count_slot] = 1.0
        j_norm = j_norm.replace(count=j_norm.count.at[low_count_slot].set(1.0))
    network, _, _ = JaxCheckpoints.load_model(GAUNTLET / "r4")
    obs = _positions(64, seed=2)
    rng = np.random.default_rng(3)
    slot = rng.integers(0, 3, 64).astype(np.int32)
    slot[:4] = [3, 7, 0, 1]  # padded slots repeat the first opponent
    ref = np.asarray(_jax_select(network, j_params, j_norm, jnp.asarray(obs), jnp.asarray(slot), K))
    t_obs, t_slot = torch.from_numpy(obs), torch.from_numpy(slot)
    mine = opponent_actor_forward_plain(t_obs, t_slot, stack)
    # f32 on both sides at full matmul precision (512-wide layers): atol 1e-5.
    np.testing.assert_allclose(mine.numpy(), ref, rtol=0, atol=1e-5)
    before = opponent_actor_forward.launches
    torch.testing.assert_close(opponent_actor_forward(t_obs, t_slot, stack), mine, rtol=0, atol=0)
    assert opponent_actor_forward.launches == before  # CPU tensors launch nothing
    # The three checkpoints really differ, and a padded slot is slot 0.
    assert np.abs(ref[slot == 0] - np.asarray(_jax_select(
        network, j_params, j_norm, jnp.asarray(obs), jnp.ones(64, jnp.int32), K))[slot == 0]).max() > 1e-2
    np.testing.assert_allclose(mine[0].numpy(), opponent_actor_forward_plain(
        t_obs[:1], torch.zeros(1, dtype=torch.int32), stack)[0].numpy(), rtol=0, atol=1e-5)
    # A slot outside [0, K) gets zeros, as the one-hot contraction gives.
    out = opponent_actor_forward_plain(t_obs[:2], torch.tensor([K, -1], dtype=torch.int32), stack)
    assert not out.any()


# ---------------------------------------------------------------------------
# The rollout, step for step
# ---------------------------------------------------------------------------
E, L, T, K, ACTIVE = 16, 8, 8, 4, 3
P, A = 2, 7


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


def replay_seating(src, key, num_slots):
    """PoolSeating.create (pool_rollout.py:64-74)."""
    k1, k2 = jax.random.split(key)
    src.ints.append((np.asarray(jax.random.randint(k1, (E,), 0, P)), 0, P))
    hi = max(num_slots, 1)
    src.ints.append((np.asarray(jax.random.randint(k2, (E, P), 0, hi)), 0, hi))


def replay_pool_rollout(src, key, num_active, steps=T):
    """Per step (key, k_sample, k_opp, k_reset, k_seat, k_slot) =
    split(key, 6) (pool_rollout.py:143): the learner's and the opponents'
    Gumbel uniforms, nothing for Connect Four's reset, the new seats and
    the new slots. Returns the carry key after the rollout."""
    hi = max(num_active, 1)
    for _ in range(steps):
        key, k_sample, k_opp, _, k_seat, k_slot = jax.random.split(key, 6)
        src.uniforms.append(np.asarray(jax.random.uniform(k_sample, (E, A), minval=TINY, maxval=1.0)))
        src.uniforms.append(np.asarray(jax.random.uniform(k_opp, (E - L, A), minval=TINY,
                                                          maxval=1.0)))
        src.ints.append((np.asarray(jax.random.randint(k_seat, (E,), 0, P)), 0, P))
        src.ints.append((np.asarray(jax.random.randint(k_slot, (E, P), 0, hi)), 0, hi))
    return key


def _cfg(activation="relu") -> Config:
    return Config(env="connect_four", num_envs=E, num_steps=T, hidden_size=32, num_hidden=2,
                  activation=activation, normalize_obs=True, seed=0)


def opponents(network, n, seed):
    """n JAX-initialised actor towers and obs normalisers, stacked both
    ways and padded to K by repeating the first (refresh_rotation)."""
    rng = np.random.default_rng(seed)
    jparams, tparams, jnorms, tnorms = [], [], [], []
    for i in range(n):
        p = network.init(jax.random.PRNGKey(100 + i))
        net = torch_build_network(ConnectFour(), _cfg(), torch.Generator().manual_seed(0))
        net.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, p)))
        jparams.append(p)
        tparams.append(actor_params(net))
        mean = rng.random(86).astype(np.float32)
        m2 = (rng.random(86) * 50).astype(np.float32)
        count = np.float32([0.0, 1.0, 40.0][i % 3] if i else 40.0)
        jnorms.append(JaxObsNorm(mean=jnp.asarray(mean), m2=jnp.asarray(m2), count=jnp.asarray(count)))
        tnorms.append(ObsNormState(mean=torch.from_numpy(mean), m2=torch.from_numpy(m2),
                                   count=torch.tensor(count)))
    pad = [0] * (K - n)
    order = list(range(n)) + pad
    stack_j = lambda xs: jax.tree_util.tree_map(lambda *ys: jnp.stack(ys), *[xs[i] for i in order])
    return (stack_j(jparams), stack_j(jnorms),
            OpponentStack.of([tparams[i] for i in order], [tnorms[i] for i in order]))


def start(seed=0):
    cfg = _cfg()
    network = build_network_for_env(JENV, cfg)
    params = network.init(jax.random.PRNGKey(seed))
    env = ConnectFour()
    tnet = torch_build_network(env, cfg, torch.Generator().manual_seed(0))
    tnet.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    rng = np.random.default_rng(seed)
    mean, m2 = rng.random(86).astype(np.float32), (rng.random(86) * 30).astype(np.float32)
    j_norm = JaxObsNorm(mean=jnp.asarray(mean), m2=jnp.asarray(m2), count=jnp.float32(30.0))
    t_norm = ObsNormState(mean=torch.from_numpy(mean), m2=torch.from_numpy(m2),
                          count=torch.tensor(30.0))
    return cfg, network, params, tnet, env, j_norm, t_norm


@pytest.mark.parametrize("normalize_returns", [False, True])
def test_pool_rollout_matches_jax_step_for_step(normalize_returns):
    cfg, network, params, tnet, env, j_norm, t_norm = start()
    j_opp, j_opp_norm, t_stack = opponents(network, ACTIVE, seed=1)
    k_carry, k_seat = jax.random.split(jax.random.PRNGKey(7))
    src = ReplaySource()
    replay_seating(src, k_seat, ACTIVE)
    j_seat = JaxSeating.create(E, L, P, ACTIVE, k_seat)
    t_seat = PoolSeating.create(E, L, P, ACTIVE, src)
    vpp = np.random.default_rng(1).normal(size=(E, P)).astype(np.float32)
    j_carry0 = jax_init_carry(JENV, E, k_carry).replace(last_value_per_player=jnp.asarray(vpp))
    t_carry0 = dataclasses.replace(init_rollout_carry(env, E, src, CPU),
                                   last_value_per_player=torch.from_numpy(vpp.copy()))
    # Two rollouts back to back: the seating and the carry thread through.
    key = j_carry0.key
    j_carry, t_carry = j_carry0, t_carry0
    collect = jax.jit(lambda p, op, on, c, s, o: jax_collect_pool(
        network, JENV, p, op, on, c, s, o, None, num_steps=T, num_learner_envs=L, num_slots=K,
        num_active=jnp.int32(ACTIVE), gamma=cfg.gamma, normalize_returns=normalize_returns))
    for _ in range(2):
        key = replay_pool_rollout(src, key, ACTIVE)
        j_carry, j_seat_new, jb, jl = collect(params, j_opp, j_opp_norm, j_carry, j_seat, j_norm)
        t_carry, t_seat_new, tb, tl = collect_rollouts_with_opponents(
            tnet, env, t_stack, t_carry, t_seat, t_norm, src, num_steps=T, num_learner_envs=L,
            num_active=ACTIVE, gamma=cfg.gamma, normalize_returns=normalize_returns)
        assert not src.uniforms and not src.ints  # every draw consumed, in order
        eq = np.testing.assert_array_equal
        eq(tb.actions.numpy(), np.asarray(jb.actions))
        eq(tb.acting_players.numpy(), np.asarray(jb.acting_players))
        eq(tb.valid_mask.numpy(), np.asarray(jb.valid_mask))
        eq(tb.dones.numpy(), np.asarray(jb.dones))
        eq(tb.obs.numpy(), np.asarray(jb.obs))
        eq(tb.action_masks.numpy(), np.asarray(jb.action_masks))
        # The seating of every step, captured before the reseat, and after it.
        eq(tl.learner_seat.numpy(), np.asarray(jl.learner_seat))
        eq(tl.seat_opp.numpy(), np.asarray(jl.seat_opp))
        eq(t_seat_new.learner_seat.numpy(), np.asarray(j_seat_new.learner_seat))
        eq(t_seat_new.seat_opp.numpy(), np.asarray(j_seat_new.seat_opp))
        for f in ("completed", "total_rewards", "length", "outcome", "active_players"):
            eq(getattr(tl.episode, f).numpy(),
               np.asarray(getattr(jl.episode, f), getattr(tl.episode, f).numpy().dtype))
        eq(t_carry.env_states.board.numpy(), np.asarray(j_carry.env_states.board))
        for mine, ref in ((tb.values, jb.values), (tb.log_probs, jb.log_probs),
                          (t_carry.last_value_per_player, j_carry.last_value_per_player),
                          (t_carry.return_norm.returns, j_carry.return_norm.returns)):
            np.testing.assert_allclose(mine.numpy(), np.asarray(ref), rtol=0, atol=1e-5)
        # Normalized rewards: the port's prefix pass runs in f64 (rtol 1e-3,
        # as in the self-play rollout test); raw rewards are exact.
        np.testing.assert_allclose(tb.all_rewards.numpy(), np.asarray(jb.all_rewards),
                                   rtol=1e-3, atol=1e-5)
        for f in ("mean", "m2", "count"):
            np.testing.assert_allclose(getattr(t_carry.return_norm, f).numpy(),
                                       np.asarray(getattr(j_carry.return_norm, f)), rtol=1e-3,
                                       atol=1e-5)
        j_seat, t_seat = j_seat_new, t_seat_new
    valid = tb.valid_mask.numpy()
    assert (valid[:, :L] == 1).all() and 0 < valid[:, L:].mean() < 1
    # Opponents played: some pool-env actions differ from the learner's own
    # choice, and every slot drawn at a reseat is below the active count.
    assert tl.seat_opp.numpy().max() < ACTIVE and tb.dones.numpy()[:, L:].sum() > 0

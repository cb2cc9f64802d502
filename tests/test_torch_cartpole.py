"""CartPole step + auto-reset of the port (plain path of kernel K1)
against ``jax.vmap(autoreset_step)`` of the JAX package, with and
without the return normaliser's roll folded in."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

torch.set_num_threads(1)

from burn_ppo_tpu.envs.base import EpisodeAccumulator as JaxAcc  # noqa: E402
from burn_ppo_tpu.envs.base import autoreset_step as jax_autoreset_step  # noqa: E402
from burn_ppo_tpu.envs.cartpole import CartPole as JaxCartPole  # noqa: E402
from burn_ppo_tpu.envs.cartpole import CartPoleState as JaxState  # noqa: E402
from burn_ppo_tpu.ppo.normalization import return_norm_roll as jax_return_norm_roll  # noqa: E402
from burn_ppo_torch.envs.base import EpisodeAccumulator  # noqa: E402
from burn_ppo_torch.envs.cartpole import CartPole, CartPoleState  # noqa: E402

JENV = JaxCartPole()
ENV = CartPole()


@jax.jit
def _jax_step(state, acc, action, keys):
    return jax.vmap(lambda s, a, act, k: jax_autoreset_step(JENV, s, a, act, k))(
        state, acc, action, keys
    )


@jax.jit
def _jax_reset_values(keys):
    """The [E, 4] values env.reset(key) draws — what the port is handed."""
    fresh = jax.vmap(JENV.reset)(keys)
    return jnp.stack([fresh.x, fresh.x_dot, fresh.theta, fresh.theta_dot], axis=1)


def _jax_state(x, x_dot, theta, theta_dot, step_idx):
    E = x.shape[0]
    return JaxState(
        x=jnp.asarray(x), x_dot=jnp.asarray(x_dot), theta=jnp.asarray(theta),
        theta_dot=jnp.asarray(theta_dot), step_idx=jnp.asarray(step_idx, jnp.int32),
        rewards=jnp.zeros((E, 1), jnp.float32), done=jnp.zeros((E,), bool),
        key=jax.random.split(jax.random.PRNGKey(0), E),
    )


def _torch_state(js) -> CartPoleState:
    return CartPoleState.of(*(torch.from_numpy(np.array(getattr(js, f))) for f in
                              ("x", "x_dot", "theta", "theta_dot", "step_idx")))


def _compare_step(j_out, t_out, atol):
    j_next, j_acc, j_term, j_log = j_out
    # Tolerance: f32 physics in both; sin/cos and FMA contraction may
    # differ by an ulp between XLA:CPU and PyTorch's CPU kernels.
    for f in ("x", "x_dot", "theta", "theta_dot"):
        np.testing.assert_allclose(
            getattr(t_out.state, f).numpy(), np.asarray(getattr(j_next, f)), rtol=0, atol=atol
        )
    # Discrete outputs must agree exactly.
    np.testing.assert_array_equal(t_out.state.step_idx.numpy(), np.asarray(j_next.step_idx))
    np.testing.assert_array_equal(t_out.done.numpy(), np.asarray(j_term.done, np.float32))
    np.testing.assert_array_equal(t_out.rewards.numpy(), np.asarray(j_term.rewards))
    np.testing.assert_array_equal(t_out.log.completed.numpy(), np.asarray(j_log.completed, np.float32))
    np.testing.assert_array_equal(t_out.log.total_rewards.numpy(), np.asarray(j_log.total_rewards))
    np.testing.assert_array_equal(t_out.log.length.numpy(), np.asarray(j_log.length))
    np.testing.assert_array_equal(t_out.log.outcome.numpy(), np.asarray(j_log.outcome))
    np.testing.assert_array_equal(t_out.log.active_players.numpy(), np.asarray(j_log.active_players))
    np.testing.assert_array_equal(t_out.acc.reward_sum.numpy(), np.asarray(j_acc.reward_sum))
    np.testing.assert_array_equal(t_out.acc.length.numpy(), np.asarray(j_acc.length))
    j_obs = jax.vmap(JENV.obs)(j_next)
    np.testing.assert_allclose(t_out.obs.numpy(), np.asarray(j_obs), rtol=0, atol=atol)
    np.testing.assert_array_equal(t_out.mask.numpy(), np.asarray(jax.vmap(JENV.action_mask)(j_next), np.float32))


def test_step_autoreset_matches_jax_from_identical_states():
    rng = np.random.default_rng(1)
    E = 256
    f32 = np.float32
    # States on both sides of the failure thresholds and step counts at the
    # 500-step cap, so every branch (continue, failure, timeout) is hit.
    x = rng.uniform(-2.45, 2.45, E).astype(f32)
    x_dot = rng.uniform(-2, 2, E).astype(f32)
    theta = rng.uniform(-0.215, 0.215, E).astype(f32)
    theta_dot = rng.uniform(-2, 2, E).astype(f32)
    step_idx = rng.choice([0, 1, 17, 250, 498, 499], E).astype(np.int32)
    reward_sum = rng.integers(0, 400, E).astype(f32)
    length = rng.integers(0, 499, E).astype(np.int32)
    actions = rng.integers(0, 2, E).astype(np.int32)
    keys = jax.random.split(jax.random.PRNGKey(7), E)

    js = _jax_state(x, x_dot, theta, theta_dot, step_idx)
    j_acc = JaxAcc(reward_sum=jnp.asarray(reward_sum)[:, None], length=jnp.asarray(length))
    j_out = _jax_step(js, j_acc, jnp.asarray(actions), keys)

    t_out = ENV.step_autoreset(
        _torch_state(js),
        EpisodeAccumulator(torch.from_numpy(reward_sum)[:, None], torch.from_numpy(length)),
        torch.from_numpy(actions),
        torch.from_numpy(np.array(_jax_reset_values(keys))),
    )
    _compare_step(j_out, t_out, atol=1e-6)
    done = np.asarray(j_out[2].done)
    reward = np.asarray(j_out[2].rewards[:, 0])
    assert (done & (reward == 0)).any() and (done & (reward == 1)).any() and (~done).any()


def test_500_step_rollout_with_fixed_actions():
    E, T = 8, 500
    # Start some envs late in their episode so the 500-step timeout (pays 1)
    # is reached as well as pole/cart failures (pay 0).
    start_steps = np.array([0, 100, 200, 300, 400, 450, 480, 495], np.int32)
    key = jax.random.PRNGKey(3)
    key, sub = jax.random.split(key)
    init = np.asarray(_jax_reset_values(jax.random.split(sub, E)))
    js = _jax_state(*(init[:, i] for i in range(4)), start_steps)
    j_acc = JaxAcc(reward_sum=jnp.zeros((E, 1)), length=jnp.asarray(start_steps))
    ts = _torch_state(js)
    t_acc = EpisodeAccumulator(torch.zeros(E, 1), torch.from_numpy(start_steps.copy()))

    timeouts = failures = 0
    for t in range(T):
        actions = ((np.arange(E) + t // 3) % 2).astype(np.int32)  # a fixed schedule
        key, sub = jax.random.split(key)
        keys = jax.random.split(sub, E)
        j_out = _jax_step(js, j_acc, jnp.asarray(actions), keys)
        t_out = ENV.step_autoreset(
            ts, t_acc, torch.from_numpy(actions),
            torch.from_numpy(np.array(_jax_reset_values(keys))),
        )
        # Free-running over 500 steps: per-step ulp differences compound
        # inside an episode (resets re-synchronise both sides), so the
        # tolerance is 1e-5 rather than the single-step 1e-6.
        _compare_step(j_out, t_out, atol=1e-5)
        done = np.asarray(j_out[2].done)
        reward = np.asarray(j_out[2].rewards[:, 0])
        timeouts += int((done & (reward == 1)).sum())
        failures += int((done & (reward == 0)).sum())
        js, j_acc = j_out[0], j_out[1]
        ts, t_acc = t_out.state, t_out.acc
    assert timeouts > 0 and failures > 0


@jax.jit
def _jax_roll(returns, rewards, dones):
    return jax_return_norm_roll(returns, rewards, jnp.zeros(rewards.shape[0], jnp.int32), dones,
                                0.99)


def _compare_roll(j_roll, t_out, atol):
    """The rolled returns [E, 1] and the samples [E]. Tolerance: the same
    two f32 roundings on both sides, but XLA:CPU may contract
    ``returns * gamma + reward`` into one fma (one ulp of |returns| <= 1e3)."""
    j_ret, j_samples = j_roll
    assert t_out.returns.shape == j_ret.shape and t_out.samples.shape == j_samples.shape
    np.testing.assert_allclose(t_out.returns.numpy(), np.asarray(j_ret), rtol=1e-6, atol=atol)
    np.testing.assert_allclose(t_out.samples.numpy(), np.asarray(j_samples), rtol=1e-6, atol=atol)


def test_step_with_the_roll_matches_jax_step_then_roll():
    """CartPole's step with the return normaliser's roll folded in (the
    plain path of K1 with its epilogue) against JAX's step under
    ``autoreset_step`` followed by ``return_norm_roll`` on player 0, from
    the same numpy inputs: rows that fail, time out at 500 and continue."""
    rng = np.random.default_rng(5)
    E = 256
    f32 = np.float32
    x = rng.uniform(-2.45, 2.45, E).astype(f32)
    x_dot = rng.uniform(-2, 2, E).astype(f32)
    theta = rng.uniform(-0.215, 0.215, E).astype(f32)
    theta_dot = rng.uniform(-2, 2, E).astype(f32)
    step_idx = rng.choice([0, 3, 250, 498, 499], E).astype(np.int32)
    reward_sum = rng.integers(0, 400, E).astype(f32)
    length = rng.integers(0, 499, E).astype(np.int32)
    actions = rng.integers(0, 2, E).astype(np.int32)
    returns = (rng.normal(size=(E, 1)) * 30).astype(f32)
    keys = jax.random.split(jax.random.PRNGKey(11), E)

    js = _jax_state(x, x_dot, theta, theta_dot, step_idx)
    j_acc = JaxAcc(reward_sum=jnp.asarray(reward_sum)[:, None], length=jnp.asarray(length))
    j_out = _jax_step(js, j_acc, jnp.asarray(actions), keys)
    j_term = j_out[2]
    j_roll = _jax_roll(jnp.asarray(returns), j_term.rewards[:, 0], j_term.done.astype(jnp.float32))

    t_out = ENV.step_autoreset(
        _torch_state(js),
        EpisodeAccumulator(torch.from_numpy(reward_sum)[:, None], torch.from_numpy(length)),
        torch.from_numpy(actions),
        torch.from_numpy(np.array(_jax_reset_values(keys))),
        None,
        (torch.from_numpy(returns), 0.99),
    )
    _compare_step(j_out, t_out, atol=1e-6)
    _compare_roll(j_roll, t_out, atol=1e-6)
    done = np.asarray(j_term.done)
    reward = np.asarray(j_term.rewards[:, 0])
    assert (done & (reward == 0)).any() and (done & (reward == 1)).any() and (~done).any()
    assert not t_out.returns.numpy()[done].any()  # a finished episode's return restarts at 0


def test_rolled_returns_carry_over_steps_as_in_jax():
    """60 steps from starts near the 500-step cap, the rolling returns
    carried on both sides through failures and timeouts."""
    E, T = 16, 60
    start_steps = (440 + 4 * np.arange(E)).astype(np.int32)
    key = jax.random.PRNGKey(9)
    key, sub = jax.random.split(key)
    init = np.asarray(_jax_reset_values(jax.random.split(sub, E)))
    js = _jax_state(*(init[:, i] for i in range(4)), start_steps)
    j_acc = JaxAcc(reward_sum=jnp.zeros((E, 1)), length=jnp.asarray(start_steps))
    ts, t_acc = _torch_state(js), EpisodeAccumulator(torch.zeros(E, 1),
                                                       torch.from_numpy(start_steps.copy()))
    j_ret, t_ret = jnp.zeros((E, 1)), torch.zeros(E, 1)
    timeouts = failures = 0
    for t in range(T):
        actions = ((np.arange(E) + t // 4) % 2).astype(np.int32)
        key, sub = jax.random.split(key)
        keys = jax.random.split(sub, E)
        j_out = _jax_step(js, j_acc, jnp.asarray(actions), keys)
        j_term = j_out[2]
        j_ret, j_samples = _jax_roll(j_ret, j_term.rewards[:, 0], j_term.done.astype(jnp.float32))
        t_out = ENV.step_autoreset(ts, t_acc, torch.from_numpy(actions),
                                   torch.from_numpy(np.array(_jax_reset_values(keys))), None,
                                   (t_ret, 0.99))
        # Free-running: per-step ulp differences compound, as in the
        # 500-step test above, so 1e-5.
        _compare_step(j_out, t_out, atol=1e-5)
        _compare_roll((j_ret, j_samples), t_out, atol=1e-5)
        done = np.asarray(j_term.done)
        reward = np.asarray(j_term.rewards[:, 0])
        timeouts += int((done & (reward == 1)).sum())
        failures += int((done & (reward == 0)).sum())
        js, j_acc, ts, t_acc, t_ret = j_out[0], j_out[1], t_out.state, t_out.acc, t_out.returns
    assert timeouts > 0 and failures > 0


class _UnfoldedCartPole(CartPole):
    """CartPole whose step does not take the roll: the rollout then picks
    the acting reward with a gather and calls ``return_norm_roll``."""

    def step_autoreset(self, state, acc, action, reset_values, step_values=None, roll=None):
        return super().step_autoreset(state, acc, action, reset_values, step_values)


def test_collect_rollouts_with_the_roll_folded_in_matches_gather_and_roll(monkeypatch):
    """``collect_rollouts`` on CartPole with the return normaliser on,
    through the folded path and through the gather + ``return_norm_roll``
    composition, from the same carry and random draws, two rollouts in a
    row: the samples, the rolling returns, the stats and the normalised
    rewards equal bit for bit."""
    from burn_ppo_torch.models.network import ActorCriticNetwork
    from burn_ppo_torch.ppo import rollout as ro
    from burn_ppo_torch.ppo.normalization import ObsNormState

    rolls, samples = [], []
    roll, finalize = ro.return_norm_roll, ro.return_norm_finalize
    monkeypatch.setattr(ro, "return_norm_roll", lambda *a: (rolls.append(1), roll(*a))[1])
    monkeypatch.setattr(ro, "return_norm_finalize",
                        lambda st, s, *a: (samples.append(s), finalize(st, s, *a))[1])
    E, T = 24, 40
    net = ActorCriticNetwork(5, 2, hidden_size=16, num_hidden=2, activation="tanh",
                             generator=torch.Generator().manual_seed(0))
    results = []
    for env in (CartPole(), _UnfoldedCartPole()):
        rng = ro.TorchRandomSource(torch.Generator().manual_seed(3))
        carry = ro.init_rollout_carry(env, E, rng, torch.device("cpu"))
        # start some envs late in their episode so both terminals occur
        carry.env_states.step_idx[:] = torch.arange(E, dtype=torch.int32) * 20
        norm = ObsNormState.create(5, torch.device("cpu"))
        batches = []
        for _ in range(2):
            carry, batch, _ = ro.collect_rollouts(net, env, carry, norm, rng, num_steps=T,
                                                  gamma=0.99, normalize_returns=True)
            batches.append(batch)
        results.append((carry.return_norm, batches))
    assert len(rolls) == 2 * T  # only the unfolded run rolled outside the step
    (rn_f, b_f), (rn_u, b_u) = results
    assert len(samples) == 4
    for a, b in zip(samples[:2], samples[2:]):
        assert torch.equal(a, b)
    for f in ("returns", "mean", "m2", "count"):
        assert torch.equal(getattr(rn_f, f), getattr(rn_u, f))
    for x, y in zip(b_f, b_u):
        assert torch.equal(x.rewards, y.rewards) and torch.equal(x.all_rewards, y.all_rewards)
        assert torch.equal(x.dones, y.dones)
    assert float(rn_f.count) == 2 * T * E
    dones = torch.stack([b.dones for b in b_f])
    raw = torch.stack([b.all_rewards for b in b_f])
    assert bool((dones > 0).any()) and bool((dones == 0).any()) and not torch.equal(raw, torch.ones_like(raw))

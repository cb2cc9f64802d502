"""The CUDA kernels K1-K6 against their plain PyTorch versions, on the card.

Needs an NVIDIA GPU and nvcc; skips elsewhere. The test suite's conftest
imports JAX; where JAX is not installed, run them without it:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda --noconftest -q
"""

import pytest
import torch

from burn_ppo_torch.envs.base import EpisodeAccumulator, autoreset_step
from burn_ppo_torch.envs.cartpole import CartPole, CartPoleState, cartpole_step_autoreset
from burn_ppo_torch.envs.connect_four import ConnectFour, connect_four_step_autoreset
from burn_ppo_torch.ops.categorical import TINY, masked_sample, masked_sample_plain
from burn_ppo_torch.ops.gae import (
    compute_gae,
    compute_gae_multiplayer,
    compute_gae_multiplayer_plain,
    compute_gae_plain,
)
from burn_ppo_torch.ppo.normalization import (
    ObsNormState,
    obs_norm_apply,
    obs_norm_apply_plain,
    obs_norm_update,
    obs_norm_update_plain,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    from burn_ppo_torch.device import resolve_device

    return resolve_device("cuda")


@pytest.mark.parametrize("E", [1, 257, 4096])
def test_cartpole_kernel_matches_plain(dev, E):
    g = torch.Generator(device=dev).manual_seed(E)
    env = CartPole()
    u = lambda *s: torch.rand(*s, generator=g, device=dev)  # noqa: E731
    state = CartPoleState(
        x=(u(E) - 0.5) * 4.9, x_dot=(u(E) - 0.5) * 4, theta=(u(E) - 0.5) * 0.43,
        theta_dot=(u(E) - 0.5) * 4,
        step_idx=torch.randint(0, 500, (E,), generator=g, device=dev, dtype=torch.int32),
    )
    acc = EpisodeAccumulator(u(E, 1) * 100, torch.randint(0, 499, (E,), generator=g, device=dev,
                                                          dtype=torch.int32))
    action = torch.randint(0, 2, (E,), generator=g, device=dev, dtype=torch.int32)
    reset = (u(E, 4) - 0.5) * 0.1
    before = cartpole_step_autoreset.launches
    k = env.step_autoreset(state, acc, action, reset)
    torch.cuda.synchronize()
    assert cartpole_step_autoreset.launches == before + 1
    p = autoreset_step(env, state, acc, action, reset)
    for a, b in ((k.state.x, p.state.x), (k.state.x_dot, p.state.x_dot),
                 (k.state.theta, p.state.theta), (k.state.theta_dot, p.state.theta_dot),
                 (k.obs, p.obs)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)
    for a, b in ((k.state.step_idx, p.state.step_idx), (k.rewards, p.rewards), (k.done, p.done),
                 (k.acc.reward_sum, p.acc.reward_sum), (k.acc.length, p.acc.length),
                 (k.log.total_rewards, p.log.total_rewards), (k.log.length, p.log.length),
                 (k.log.outcome, p.log.outcome), (k.log.active_players, p.log.active_players),
                 (k.mask, p.mask)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("E,A,masked", [(4096, 2, False), (4096, 2, True), (300, 7, True),
                                        (64, 64, True)])
def test_sample_kernel_matches_plain(dev, E, A, masked):
    g = torch.Generator(device=dev).manual_seed(A)
    logits = torch.randn(E, A, generator=g, device=dev) * 2
    mask = None
    if masked:
        mask = (torch.rand(E, A, generator=g, device=dev) < 0.6).float()
        mask[:, 0] = 1.0
    u = torch.rand(E, A, generator=g, device=dev).clamp_min(TINY)
    before = masked_sample.launches
    a_k, lp_k = masked_sample(logits, mask, u)
    torch.cuda.synchronize()
    assert masked_sample.launches == before + 1
    a_p, lp_p = masked_sample_plain(logits, mask, u)
    assert torch.equal(a_k, a_p)
    torch.testing.assert_close(lp_k, lp_p, rtol=0, atol=1e-5)


def test_sample_kernel_refuses_too_many_actions(dev):
    x = torch.zeros(4, 65, device=dev)
    with pytest.raises(ValueError, match="at most 64"):
        masked_sample(x, None, x + 0.5)


@pytest.mark.parametrize("T,E", [(1, 3), (128, 4096), (7, 1000)])
def test_gae_kernel_matches_plain(dev, T, E):
    g = torch.Generator(device=dev).manual_seed(T)
    r = torch.randn(T, E, generator=g, device=dev)
    v = torch.randn(T, E, generator=g, device=dev)
    d = (torch.rand(T, E, generator=g, device=dev) < 0.05).float()
    last = torch.randn(E, generator=g, device=dev)
    before = compute_gae.launches
    adv_k, ret_k = compute_gae(r, v, d, last, 0.99, 0.95)
    torch.cuda.synchronize()
    assert compute_gae.launches == before + 1
    adv_p, ret_p = compute_gae_plain(r, v, d, last, 0.99, 0.95)
    torch.testing.assert_close(adv_k, adv_p, rtol=0, atol=1e-5)
    torch.testing.assert_close(ret_k, ret_p, rtol=0, atol=1e-5)


def test_wrappers_check_arguments(dev):
    with pytest.raises(TypeError):
        compute_gae(torch.zeros(2, 3, device=dev, dtype=torch.float64),
                    torch.zeros(2, 3, device=dev), torch.zeros(2, 3, device=dev),
                    torch.zeros(3, device=dev), 0.99, 0.95)
    with pytest.raises(ValueError, match="contiguous"):
        z = torch.zeros(3, 2, device=dev)
        compute_gae(z.T, z.T, z.T, torch.zeros(3, device=dev), 0.99, 0.95)


@pytest.mark.parametrize("E", [1, 257, 4096])
def test_connect_four_kernel_matches_plain_exactly(dev, E):
    """Random play for 60 steps: mostly legal moves, some full columns and
    out-of-range actions, some states already done; every output equal."""
    g = torch.Generator(device=dev).manual_seed(E)
    env = ConnectFour()
    empty = torch.empty(E, 0, device=dev)
    state, acc = env.reset(empty), EpisodeAccumulator.zero(E, 2, dev)
    seen_done = 0
    for t in range(60):
        legal = env.action_mask(state)
        action = torch.multinomial(legal, 1, generator=g)[:, 0]
        wild = torch.randint(-2, 9, (E,), generator=g, device=dev)
        action = torch.where(torch.rand(E, generator=g, device=dev) < 0.1, wild, action)
        action = action.to(torch.int32)
        if t % 9 == 4:
            done = torch.rand(E, generator=g, device=dev) < 0.1
            state.done = done
            state.winner = torch.where(done, torch.randint(-1, 3, (E,), generator=g, device=dev,
                                                           dtype=torch.int32), state.winner)
        before = connect_four_step_autoreset.launches
        k = env.step_autoreset(state, acc, action, empty)
        torch.cuda.synchronize()
        assert connect_four_step_autoreset.launches == before + 1
        p = autoreset_step(env, state, acc, action, empty)
        for f in ("board", "current", "winner", "done", "step_idx"):
            a, b = getattr(k.state, f), getattr(p.state, f)
            assert a.dtype == b.dtype and torch.equal(a, b), f
        for f in ("completed", "total_rewards", "length", "outcome", "active_players"):
            a, b = getattr(k.log, f), getattr(p.log, f)
            assert a.dtype == b.dtype and torch.equal(a, b), f
        for a, b in ((k.acc.reward_sum, p.acc.reward_sum), (k.acc.length, p.acc.length),
                     (k.rewards, p.rewards), (k.done, p.done), (k.obs, p.obs),
                     (k.mask, p.mask)):
            assert torch.equal(a, b)
        seen_done += int(p.done.sum())
        state, acc = p.state, p.acc
    assert seen_done > 0


def test_sample_kernel_matches_plain_with_connect_four_masks(dev):
    """A = 7 with 0-6 masked columns per row."""
    g = torch.Generator(device=dev).manual_seed(7)
    E, A = 4096, 7
    logits = torch.randn(E, A, generator=g, device=dev) * 2
    n_masked = torch.randint(0, A, (E, 1), generator=g, device=dev)
    mask = (torch.rand(E, A, generator=g, device=dev).argsort(1).argsort(1) >= n_masked).float()
    u = torch.rand(E, A, generator=g, device=dev).clamp_min(TINY)
    a_k, lp_k = masked_sample(logits, mask, u)
    a_p, lp_p = masked_sample_plain(logits, mask, u)
    assert torch.equal(a_k, a_p)
    assert bool(torch.all(torch.gather(mask, 1, a_k.long()[:, None]) == 1.0))
    torch.testing.assert_close(lp_k, lp_p, rtol=0, atol=1e-5)


@pytest.mark.parametrize("T,E,P", [(64, 4096, 2), (64, 4096, 4), (5, 33, 3), (16, 100, 8),
                                   (3, 10, 1)])
def test_gae_multiplayer_kernel_matches_plain(dev, T, E, P):
    g = torch.Generator(device=dev).manual_seed(T * P)
    done = (torch.rand(T, E, generator=g, device=dev) < 0.05).float()
    acting = torch.empty(T, E, dtype=torch.int32, device=dev)
    cur = torch.randint(0, P, (E,), generator=g, device=dev, dtype=torch.int32)
    for t in range(T):
        acting[t] = cur
        restart = torch.randint(0, P, (E,), generator=g, device=dev, dtype=torch.int32)
        cur = torch.where(done[t] > 0, restart, (cur + 1) % P)
    rewards = torch.randn(T, E, P, generator=g, device=dev)
    rewards *= torch.rand(T, E, P, generator=g, device=dev) < 0.3
    values = torch.randn(T, E, generator=g, device=dev)
    last_vpp = torch.randn(E, P, generator=g, device=dev)
    before = compute_gae_multiplayer.launches
    adv_k, ret_k = compute_gae_multiplayer(rewards, values, done, acting, last_vpp, 0.99, 0.95)
    torch.cuda.synchronize()
    assert compute_gae_multiplayer.launches == before + 1
    adv_p, ret_p = compute_gae_multiplayer_plain(rewards, values, done, acting, last_vpp,
                                                 0.99, 0.95)
    torch.testing.assert_close(adv_k, adv_p, rtol=0, atol=1e-5)
    torch.testing.assert_close(ret_k, ret_p, rtol=0, atol=1e-5)


def test_gae_multiplayer_kernel_refuses_more_than_eight_players(dev):
    z = torch.zeros(2, 3, device=dev)
    with pytest.raises(ValueError, match="1..8 players"):
        compute_gae_multiplayer(torch.zeros(2, 3, 9, device=dev), z, z,
                                torch.zeros(2, 3, dtype=torch.int32, device=dev),
                                torch.zeros(3, 9, device=dev), 0.99, 0.95)


def _obs01(g, dev, n, D):
    rate = torch.rand(D, generator=g, device=dev)
    rate[0] = 0.0  # a constant column
    return (torch.rand(n, D, generator=g, device=dev) < rate).float()


@pytest.mark.parametrize("count", [0.0, 1.0, None])
@pytest.mark.parametrize("shape", [(4096, 86), (3, 5, 86)])
def test_obs_norm_apply_kernel_matches_plain(dev, count, shape):
    g = torch.Generator(device=dev).manual_seed(len(shape))
    D = shape[-1]
    obs = torch.randn(*shape, generator=g, device=dev) * 3
    if count is None:
        state = obs_norm_update_plain(ObsNormState.create(D, dev), _obs01(g, dev, 5000, D))
    else:
        state = ObsNormState(mean=torch.rand(D, generator=g, device=dev),
                             m2=torch.rand(D, generator=g, device=dev),
                             count=torch.tensor(count, device=dev))
    before = obs_norm_apply.launches
    k = obs_norm_apply(state, obs)
    torch.cuda.synchronize()
    assert obs_norm_apply.launches == before + 1
    p = obs_norm_apply_plain(state, obs)
    torch.testing.assert_close(k, p, rtol=0, atol=1e-6)
    if count is not None:
        assert torch.equal(k, obs)


@pytest.mark.parametrize("N,D", [(262144, 86), (524288, 5), (7, 3), (1, 4)])
def test_obs_norm_update_kernel_matches_plain(dev, N, D):
    """Into an empty and into a filled state: mean to 1e-6 absolute, m2 to
    1e-5 relative, count exact."""
    g = torch.Generator(device=dev).manual_seed(N)
    make = ((lambda: _obs01(g, dev, N, D)) if D == 86
            else (lambda: torch.randn(N, D, generator=g, device=dev) * 2 + 0.5))
    state = ObsNormState.create(D, dev)
    for _ in range(2):
        x = make()
        before = obs_norm_update.launches
        k = obs_norm_update(state, x)
        torch.cuda.synchronize()
        assert obs_norm_update.launches == before + 1
        p = obs_norm_update_plain(state, x)
        torch.testing.assert_close(k.mean, p.mean, rtol=0, atol=1e-6)
        assert bool(torch.all((k.m2 - p.m2).abs() <= 1e-5 * p.m2.abs()))
        assert torch.equal(k.count, p.count)
        state = p

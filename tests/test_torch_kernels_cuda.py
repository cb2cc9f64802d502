"""The CUDA kernels K1-K12 against their plain PyTorch versions, on the card.

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
from burn_ppo_torch.envs.base import EpisodeLog
from burn_ppo_torch.ppo.episode_stats import summarize_episode_logs, summarize_episode_logs_plain
from burn_ppo_torch.envs.skull import FIELDS as SKULL_FIELDS
from burn_ppo_torch.envs.skull import Skull, skull_step_autoreset, walk_actions
from burn_ppo_torch.ppo.normalization import (
    ObsNormState,
    ReturnNormState,
    obs_norm_apply,
    obs_norm_apply_plain,
    obs_norm_update,
    obs_norm_update_plain,
    return_norm_finalize,
    return_norm_finalize_f64,
    return_norm_finalize_f64_plain,
    return_norm_roll,
    return_norm_roll_plain,
)
from burn_ppo_torch.ppo.pool_rollout import (
    OpponentStack,
    opponent_actor_forward,
    opponent_actor_forward_plain,
)
from burn_ppo_torch.ppo.update import (
    PPOUpdateConfig,
    clip_adam,
    clip_adam_plain,
    ppo_loss,
    ppo_loss_forward,
    ppo_loss_plain,
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


def make_opponents(g, dev, K, act, D=86, H=512, A=7, depth=2):
    """K random actor towers (orthogonal-like scale) and obs normalisers:
    slot 0 at count 0 (identity), slot 1 at count 1, the rest merged."""
    sizes = [D] + [H] * depth + [A]
    weights = [torch.randn(K, i, o, generator=g, device=dev) / i ** 0.5
               for i, o in zip(sizes, sizes[1:])]
    biases = [torch.randn(K, o, generator=g, device=dev) * 0.1 for o in sizes[1:]]
    count = torch.full((K,), 5000.0, device=dev)
    count[0] = 0.0
    if K > 1:
        count[1] = 1.0
    norm = ObsNormState(mean=torch.rand(K, D, generator=g, device=dev),
                        m2=torch.rand(K, D, generator=g, device=dev) * 1000.0, count=count)
    return OpponentStack(weights=weights, biases=biases, activation=act, norm=norm)


@pytest.mark.parametrize("K,act,Ep", [(8, "relu", 1024), (8, "tanh", 1024), (3, "tanh", 37),
                                      (3, "relu", 1500)])
def test_opponent_actor_kernel_matches_plain(dev, K, act, Ep):
    g = torch.Generator(device=dev).manual_seed(K * Ep)
    stack = make_opponents(g, dev, K, act)
    obs = (torch.rand(Ep, 86, generator=g, device=dev) < 0.3).float()
    slot = torch.randint(0, K, (Ep,), generator=g, device=dev, dtype=torch.int32)
    slot[:5] = torch.tensor([K, -1, K + 3, 0, K - 1], device=dev, dtype=torch.int32)
    before = opponent_actor_forward.launches
    k = opponent_actor_forward(obs, slot, stack)
    torch.cuda.synchronize()
    assert opponent_actor_forward.launches == before + 1
    p = opponent_actor_forward_plain(obs, slot, stack)
    assert torch.equal(k[:3], torch.zeros_like(k[:3]))  # out-of-range slots: zeros
    torch.testing.assert_close(k, p, rtol=1e-4, atol=1e-4)


def loss_batch(g, dev, M, A):
    logits = torch.randn(M, A, generator=g, device=dev) * 2
    n_masked = torch.randint(0, A, (M, 1), generator=g, device=dev)
    mask = (torch.rand(M, A, generator=g, device=dev).argsort(1).argsort(1) >= n_masked).float()
    logp = torch.log_softmax(logits + torch.where(mask > 0, 0.0, -1e9), -1)
    actions = torch.multinomial(mask, 1, generator=g)[:, 0].to(torch.int32)
    old_lp = logp.gather(1, actions.long()[:, None])[:, 0] + torch.randn(M, generator=g,
                                                                        device=dev) * 0.2
    values = torch.randn(M, generator=g, device=dev)
    mb = {
        "actions": actions, "old_log_probs": old_lp,
        "advantages": torch.randn(M, generator=g, device=dev) * 2 + 0.3,
        "returns": torch.randn(M, generator=g, device=dev),
        "old_values": values + torch.randn(M, generator=g, device=dev) * 0.3,
        "valid": (torch.rand(M, generator=g, device=dev) < 0.8).float(),
        "action_masks": mask,
    }
    return logits, values, mb


@pytest.mark.parametrize("M,A,clip_value", [(65536, 7, False), (65536, 7, True),
                                            (131072, 2, False), (1000, 7, True)])
def test_ppo_loss_kernel_matches_plain(dev, M, A, clip_value):
    g = torch.Generator(device=dev).manual_seed(M + A)
    logits, values, mb = loss_batch(g, dev, M, A)
    cfg = PPOUpdateConfig(clip_epsilon=0.1, clip_value=clip_value)
    before = ppo_loss.launches
    k = ppo_loss_forward(logits, values, mb, 0.05, cfg)
    torch.cuda.synchronize()
    assert ppo_loss.launches == before + 1
    p = ppo_loss_plain(logits, values, mb, 0.05, cfg)
    torch.testing.assert_close(k[0], p[0], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(k[1], p[1], rtol=1e-5, atol=1e-6)
    for a, b in zip(k[2:], p[2:]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6 * float(b.abs().max()))


@pytest.mark.parametrize("n", [4739, 311304])
@pytest.mark.parametrize("scale", [1e-3, 10.0])
def test_clip_adam_kernel_matches_plain(dev, n, scale):
    """Three steps below and above the max norm."""
    g = torch.Generator(device=dev).manual_seed(n)
    p_k = torch.randn(n, generator=g, device=dev)
    mu_k, nu_k = torch.zeros(n, device=dev), torch.zeros(n, device=dev)
    p_p, mu_p, nu_p = p_k.clone(), mu_k.clone(), nu_k.clone()
    for count in (1, 2, 3):
        grads = torch.randn(n, generator=g, device=dev) * scale / n ** 0.5
        kw = dict(lr=1e-3, max_grad_norm=0.5, eps=1e-5, bc1=1 - 0.9 ** count,
                  bc2=1 - 0.999 ** count)
        before = clip_adam.launches
        clip_adam(p_k, grads, mu_k, nu_k, **kw)
        torch.cuda.synchronize()
        assert clip_adam.launches == before + 1
        clip_adam_plain(p_p, grads, mu_p, nu_p, **kw)
    for a, b in ((p_k, p_p), (mu_k, mu_p), (nu_k, nu_p)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7 * float(b.abs().max()))


def episode_logs(g, dev, T, E, P, rate=0.05):
    kinds = torch.randint(0, 4, (T, E), generator=g, device=dev)
    places = torch.randint(1, P + 1, (T, E, P), generator=g, device=dev, dtype=torch.int32)
    places[kinds == 1] = 1  # all tied first: a draw
    places[kinds == 2] = 0  # the no-outcome sentinel
    return EpisodeLog(
        completed=(torch.rand(T, E, generator=g, device=dev) < rate).float(),
        total_rewards=torch.randn(T, E, P, generator=g, device=dev),
        length=torch.randint(1, 43, (T, E), generator=g, device=dev, dtype=torch.int32),
        outcome=places, active_players=torch.full((T, E), P, dtype=torch.int32, device=dev),
    )


@pytest.mark.parametrize("T,E,P,L", [(64, 4096, 2, 3072), (64, 4096, 2, None),
                                     (128, 4096, 1, None), (5, 33, 4, 20), (3, 7, 2, 1)])
def test_episode_stats_kernel_matches_plain(dev, T, E, P, L):
    g = torch.Generator(device=dev).manual_seed(T * P)
    logs = episode_logs(g, dev, T, E, P)
    before = summarize_episode_logs.launches
    k = summarize_episode_logs(logs, P, num_envs=L)
    torch.cuda.synchronize()
    assert summarize_episode_logs.launches == before + 1
    cut = EpisodeLog(**{f: getattr(logs, f)[:, :L] for f in logs.__dataclass_fields__})
    p = summarize_episode_logs_plain(logs if L is None else cut, P)
    assert set(k) == set(p)
    for key in ("count", "len_sum", "draws", "ret0_max", "ret0_min"):
        assert torch.equal(k[key], p[key]), key
    for key in ("ret_sum", "pts_sum"):
        torch.testing.assert_close(k[key], p[key], rtol=1e-6, atol=1e-3)


@pytest.mark.parametrize("E,n", [(1, 4), (257, 2), (4096, 4), (512, 6)])
def test_skull_kernel_matches_plain_exactly(dev, E, n):
    """K11 against the plain step along a walk of 150 steps, every output
    equal bit for bit; forced discards, finished games fed back in and a
    shaping coefficient on half the envs."""
    import dataclasses

    g = torch.Generator(device=dev).manual_seed(E + n)
    env = Skull(n)
    empty = torch.empty(E, 0, device=dev)
    state = env.reset(empty)
    state = dataclasses.replace(state, shaping_coef=(torch.arange(E, device=dev) % 2) * 0.05)
    acc = EpisodeAccumulator.zero(E, n, dev)
    dones = 0
    for _ in range(150):
        fd = torch.randint(0, 2, (E,), generator=g, device=dev, dtype=torch.int32)
        fd = torch.where(torch.rand(E, generator=g, device=dev) < 0.15, fd, -1)
        over = state.game_over | (torch.rand(E, generator=g, device=dev) < 0.003)
        state = dataclasses.replace(state, forced_discard=fd, game_over=over)
        action = walk_actions(env.action_mask(state), g)
        u = torch.rand(E, generator=g, device=dev)
        before = skull_step_autoreset.launches
        k = env.step_autoreset(state, acc, action, empty, u)
        torch.cuda.synchronize()
        assert skull_step_autoreset.launches == before + 1
        p = autoreset_step(env, state, acc, action, empty, u)
        pairs = [(getattr(k.state, f), getattr(p.state, f)) for f in SKULL_FIELDS]
        pairs += [(getattr(k.log, f), getattr(p.log, f))
                  for f in ("completed", "total_rewards", "length", "outcome", "active_players")]
        pairs += [(k.acc.reward_sum, p.acc.reward_sum), (k.acc.length, p.acc.length),
                  (k.rewards, p.rewards), (k.done, p.done), (k.obs, p.obs), (k.mask, p.mask),
                  (k.priv, p.priv)]
        for a, b in pairs:
            assert a.dtype == b.dtype and torch.equal(a, b)
        dones += int(p.done.sum())
        state, acc = p.state, p.acc
    assert dones > 0


@pytest.mark.parametrize("E,P", [(4096, 1), (4096, 4), (5, 3)])
def test_return_norm_roll_kernel_matches_plain_exactly(dev, E, P):
    g = torch.Generator(device=dev).manual_seed(E + P)
    returns = torch.randn(E, P, generator=g, device=dev)
    rewards = torch.randn(E, generator=g, device=dev)
    acting = torch.randint(0, P, (E,), generator=g, device=dev, dtype=torch.int32)
    dones = (torch.rand(E, generator=g, device=dev) < 0.1).float()
    before = return_norm_roll.launches
    k = return_norm_roll(returns, rewards, acting, dones, 0.99)
    torch.cuda.synchronize()
    assert return_norm_roll.launches == before + 1
    p = return_norm_roll_plain(returns, rewards, acting, dones, 0.99)
    assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])


@pytest.mark.parametrize("N,weighted,filled", [(524288, False, False), (524288, True, True),
                                               (1, False, False), (7, True, False),
                                               (100003, False, True)])
def test_return_norm_finalize_kernel_matches_plain(dev, N, weighted, filled):
    """The f64 stats to 1e-12 relative, the normalized rewards to f32
    rounding (2 ulp), the pass-through below a count of 2 exact."""
    g = torch.Generator(device=dev).manual_seed(N)
    samples = torch.randn(N, generator=g, device=dev) * 3 + 1
    rewards = torch.randn(N, generator=g, device=dev)
    valid = (torch.rand(N, generator=g, device=dev) < 0.7).float() if weighted else None
    z = torch.zeros((), device=dev)
    state = ReturnNormState(returns=torch.zeros(1, 1, device=dev), mean=z + (0.4 if filled else 0),
                            m2=z + (9e5 if filled else 0), count=z + (1e5 if filled else 0))
    before = return_norm_finalize.launches
    ks, kn = return_norm_finalize_f64(state, samples, rewards, 10.0, valid)
    torch.cuda.synchronize()
    assert return_norm_finalize.launches == before + 1
    ps, pn = return_norm_finalize_f64_plain(state, samples, rewards, 10.0, valid)
    assert torch.all((ks - ps).abs() <= 1e-12 * ps.abs())
    assert torch.all((kn - pn).abs() <= 2.4e-7 * pn.abs())


def test_return_norm_finalize_kernel_leaves_the_state_without_valid_samples(dev):
    N = 1000
    z = torch.zeros((), device=dev)
    state = ReturnNormState(returns=torch.zeros(1, 1, device=dev), mean=z + 0.1234567,
                            m2=z + 7.654321, count=z + 77.0)
    new, _ = return_norm_finalize(state, torch.randn(N, device=dev), torch.randn(N, device=dev),
                                     10.0, torch.zeros(N, device=dev))
    torch.cuda.synchronize()
    for f in ("mean", "m2", "count"):
        assert torch.equal(getattr(new, f), getattr(state, f))

"""The three CUDA kernels against their plain PyTorch versions, on the card.

Needs an NVIDIA GPU and nvcc; skips elsewhere. The test suite's conftest
imports JAX; where JAX is not installed, run them without it:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda --noconftest -q
"""

import pytest
import torch

from burn_ppo_torch.envs.base import EpisodeAccumulator, autoreset_step
from burn_ppo_torch.envs.cartpole import CartPole, CartPoleState, cartpole_step_autoreset
from burn_ppo_torch.ops.categorical import TINY, masked_sample, masked_sample_plain
from burn_ppo_torch.ops.gae import compute_gae, compute_gae_plain

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
    acc = EpisodeAccumulator(u(E) * 100, torch.randint(0, 499, (E,), generator=g, device=dev,
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
    for a, b in ((k.state.step_idx, p.state.step_idx), (k.reward, p.reward), (k.done, p.done),
                 (k.acc.reward_sum, p.acc.reward_sum), (k.acc.length, p.acc.length),
                 (k.log.total_rewards, p.log.total_rewards), (k.log.length, p.log.length)):
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

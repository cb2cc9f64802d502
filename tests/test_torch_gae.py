"""GAE of the port (plain path of kernel K3) and explained variance,
against the reference's hand vectors and ``compute_gae`` of the JAX
package."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from burn_ppo_tpu.ops.gae import compute_explained_variance as jax_ev  # noqa: E402
from burn_ppo_tpu.ops.gae import compute_gae as jax_gae  # noqa: E402
from burn_ppo_torch.ops.gae import compute_explained_variance, compute_gae  # noqa: E402

T_ = torch.tensor


def test_hand_computed_single_player():
    gamma, lam = 0.99, 0.95
    adv, ret = compute_gae(T_([[1.0], [1.0]]), T_([[0.5], [0.6]]), torch.zeros(2, 1),
                           T_([0.7]), gamma, lam)
    a1 = 1.0 + gamma * 0.7 - 0.6
    a0 = 1.0 + gamma * 0.6 - 0.5 + gamma * lam * a1
    np.testing.assert_allclose(adv[:, 0].numpy(), [a0, a1], rtol=1e-5)
    np.testing.assert_allclose(ret[:, 0].numpy(), [a0 + 0.5, a1 + 0.6], rtol=1e-5)


def test_done_blocks_bootstrap():
    adv, _ = compute_gae(T_([[1.0], [1.0]]), T_([[0.5], [0.6]]), T_([[1.0], [0.0]]),
                         T_([10.0]), 0.99, 0.95)
    assert float(adv[0, 0]) == pytest.approx(0.5, abs=1e-5)


def test_multi_env_isolation():
    r, v, d = T_([[1.0, 0.0], [0.0, 5.0]]), torch.zeros(2, 2), torch.zeros(2, 2)
    adv, _ = compute_gae(r, v, d, torch.zeros(2), 0.99, 0.95)
    solo, _ = compute_gae(r[:, :1], v[:, :1], d[:, :1], torch.zeros(1), 0.99, 0.95)
    np.testing.assert_allclose(adv[:, 0].numpy(), solo[:, 0].numpy())


def test_random_rollout_matches_jax():
    rng = np.random.default_rng(4)
    T, E = 32, 16
    rewards = rng.normal(size=(T, E)).astype(np.float32)
    values = rng.normal(size=(T, E)).astype(np.float32)
    dones = (rng.random((T, E)) < 0.1).astype(np.float32)
    last = rng.normal(size=E).astype(np.float32)
    j_adv, j_ret = jax_gae(jnp.asarray(rewards), jnp.asarray(values), jnp.asarray(dones),
                           jnp.asarray(last), 0.99, 0.95)
    t_adv, t_ret = compute_gae(*(torch.from_numpy(a) for a in (rewards, values, dones, last)),
                               0.99, 0.95)
    # Same recurrence in f32; XLA may contract mul+add into FMAs.
    np.testing.assert_allclose(t_adv.numpy(), np.asarray(j_adv), rtol=0, atol=1e-5)
    np.testing.assert_allclose(t_ret.numpy(), np.asarray(j_ret), rtol=0, atol=1e-5)


@pytest.mark.parametrize("T,E", [(128, 32), (100, 37)])
def test_kernel_shapes_match_jax(T, E):
    """K3's chip shapes on its plain version: [128, 32] (configs/cartpole.toml
    and the learning bar: one block of the kernel) and a T that is no whole
    number of the kernel's 64-step chunks with an E that is no whole
    number of its 32-env blocks (on the card [100, 4097])."""
    rng = np.random.default_rng(T + E)
    rewards = rng.normal(size=(T, E)).astype(np.float32)
    values = rng.normal(size=(T, E)).astype(np.float32)
    dones = (rng.random((T, E)) < 0.02).astype(np.float32)
    last = rng.normal(size=E).astype(np.float32)
    j_adv, j_ret = jax_gae(jnp.asarray(rewards), jnp.asarray(values), jnp.asarray(dones),
                           jnp.asarray(last), 0.99, 0.95)
    t_adv, t_ret = compute_gae(*(torch.from_numpy(a) for a in (rewards, values, dones, last)),
                               0.99, 0.95)
    np.testing.assert_allclose(t_adv.numpy(), np.asarray(j_adv), rtol=0, atol=1e-5)
    np.testing.assert_allclose(t_ret.numpy(), np.asarray(j_ret), rtol=0, atol=1e-5)


def test_explained_variance():
    v = T_([1.0, 2.0, 3.0, 4.0])
    assert float(compute_explained_variance(v, v)) == pytest.approx(1.0)
    bad = T_([4.0, 1.0, 7.0, -2.0])
    assert float(compute_explained_variance(bad, v)) < 0.0
    assert float(compute_explained_variance(v, torch.ones(4))) == 0.0


def test_explained_variance_masked_matches_jax():
    v, r, m = T_([1.0, 2.0, 100.0]), T_([1.0, 2.0, -100.0]), T_([1.0, 1.0, 0.0])
    assert float(compute_explained_variance(v, r, m)) == pytest.approx(1.0, abs=1e-5)
    rng = np.random.default_rng(5)
    vals, rets = rng.normal(size=(2, 200)).astype(np.float32)
    mask = (rng.random(200) < 0.7).astype(np.float32)
    expect = float(jax_ev(jnp.asarray(vals), jnp.asarray(rets), jnp.asarray(mask)))
    got = float(compute_explained_variance(*(torch.from_numpy(a) for a in (vals, rets, mask))))
    assert got == pytest.approx(expect, rel=1e-5)

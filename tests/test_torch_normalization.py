"""Obs and return normalizers of the port against the JAX package."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from burn_ppo_tpu.ppo import normalization as jn  # noqa: E402
from burn_ppo_torch.ppo import normalization as tn  # noqa: E402

CPU = torch.device("cpu")


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def test_obs_norm_update_and_apply_match_jax():
    rng = np.random.default_rng(0)
    j_state = jn.ObsNormState.create(5)
    t_state = tn.ObsNormState.create(5, CPU)
    obs = (rng.normal(size=(16, 5)) * [1, 2, 0.1, 3, 0.5] + [0, 1, 0, -2, 0.3]).astype(np.float32)
    # count < 2: identity on both sides.
    np.testing.assert_array_equal(tn.obs_norm_apply(t_state, _t(obs)).numpy(), obs)
    np.testing.assert_array_equal(np.asarray(jn.obs_norm_apply(j_state, jnp.asarray(obs))), obs)
    for i in range(3):
        batch = (rng.normal(size=(8, 4, 5)) * (i + 1) * 4).astype(np.float32)
        j_state = jn.obs_norm_update(j_state, jnp.asarray(batch))
        t_state = tn.obs_norm_update(t_state, _t(batch))
        # Same Chan merge in f32; the per-column sums may run in another order.
        for f in ("mean", "m2", "count"):
            np.testing.assert_allclose(getattr(t_state, f).numpy(),
                                       np.asarray(getattr(j_state, f)), rtol=1e-6, atol=1e-6)
        # Large scaled batches push some values past the +-10 clip.
        np.testing.assert_allclose(tn.obs_norm_apply(t_state, _t(obs * 40)).numpy(),
                                   np.asarray(jn.obs_norm_apply(j_state, jnp.asarray(obs * 40))),
                                   rtol=0, atol=1e-6)


def test_return_norm_roll_and_finalize_match_jax():
    rng = np.random.default_rng(1)
    T, E, gamma = 32, 16, 0.99
    j_state = jn.ReturnNormState.create(E, 1)
    t_state = tn.ReturnNormState.create(E, 1, CPU)
    for _ in range(2):  # the second pass starts from non-trivial stats
        rewards = (rng.random((T, E)) < 0.8).astype(np.float32) * rng.normal(1, 0.5, (T, E))
        rewards = rewards.astype(np.float32)
        dones = (rng.random((T, E)) < 0.08).astype(np.float32)
        j_ret, t_ret = j_state.returns, t_state.returns
        j_samples, t_samples = [], []
        for t in range(T):
            j_ret, js = jn.return_norm_roll(j_ret, jnp.asarray(rewards[t]),
                                            jnp.zeros(E, jnp.int32), jnp.asarray(dones[t]), gamma)
            t_ret, ts = tn.return_norm_roll(t_ret, _t(rewards[t]), torch.zeros(E, dtype=torch.int32),
                                            _t(dones[t]), gamma)
            j_samples.append(js)
            t_samples.append(ts)
        np.testing.assert_allclose(t_ret.numpy(), np.asarray(j_ret), rtol=1e-6, atol=1e-6)
        j_state = j_state.replace(returns=j_ret)
        t_state = tn.ReturnNormState(t_ret, t_state.mean, t_state.m2, t_state.count)
        j_state, j_norm = jn.return_norm_finalize(j_state, jnp.stack(j_samples),
                                                  jnp.asarray(rewards))
        t_state, t_norm = tn.return_norm_finalize(t_state, torch.stack(t_samples), _t(rewards))
        # Prefix sums over T*E positions, in another order and precision
        # (XLA's f32 scan; the port's f64 cumsum): rtol 1e-5. Early in a
        # fresh run the closed form cancels and the f32 side drifts most.
        np.testing.assert_allclose(t_norm.numpy(), np.asarray(j_norm), rtol=1e-5, atol=1e-6)
        for f in ("mean", "m2", "count"):
            np.testing.assert_allclose(getattr(t_state, f).numpy(),
                                       np.asarray(getattr(j_state, f)), rtol=1e-5)
    assert float(t_state.count) == 2 * T * E


def _finalize_f64(count, mean, m2, samples, rewards, clip=10.0):
    """The closed form of return_norm_finalize evaluated in float64."""
    x = samples.reshape(-1).astype(np.float64)
    r = rewards.reshape(-1).astype(np.float64)
    count_e = count + np.arange(1, x.size + 1)
    shift = x.mean()
    u = x - shift
    base = mean - shift
    mean_u = (count * base + np.cumsum(u)) / count_e
    m2_e = np.maximum(m2 + count * base**2 + np.cumsum(u * u) - count_e * mean_u**2, 0.0)
    out = np.clip(r / np.sqrt(m2_e / count_e + 1e-8), -clip, clip)
    return np.where(count_e < 2, r, out).reshape(rewards.shape)


def test_return_norm_finalize_matches_float64():
    rng = np.random.default_rng(2)
    T, E = 64, 32
    state = tn.ReturnNormState.create(E, 1, CPU)
    for _ in range(3):
        samples = rng.normal(5.0, 3.0, (T, E)).astype(np.float32)
        rewards = rng.normal(1.0, 0.5, (T, E)).astype(np.float32)
        expect = _finalize_f64(float(state.count), float(state.mean), float(state.m2),
                               samples, rewards)
        state, norm = tn.return_norm_finalize(state, _t(samples), _t(rewards))
        # f64 prefix pass; only the final f32 division and std rounding remain.
        np.testing.assert_allclose(norm.numpy(), expect, rtol=1e-6, atol=1e-7)


def test_return_norm_is_identity_until_two_samples():
    state = tn.ReturnNormState.create(3, 1, CPU)
    rewards = _t([[5.0, -2.0, 7.0]])
    state, norm = tn.return_norm_finalize(state, rewards * 3, rewards)
    assert float(norm[0, 0]) == 5.0  # count 1 at its own position
    assert float(norm[0, 1]) != -2.0


def test_obs_norm_plain_versions_match_jax_at_kernel_edges():
    """The plain versions of kernel K6: apply at count 0 and 1 (the
    identity) and after merges; update into an empty and a filled state,
    on Connect-Four-like 0/1 columns and constant columns."""
    rng = np.random.default_rng(3)
    D = 86
    batch = (rng.random((4, 16, D)) < 0.3).astype(np.float32)
    batch[..., 5] = 1.0  # a constant column: M2 stays 0, std floors at 1e-8
    obs = (rng.normal(size=(16, D)) * 2).astype(np.float32)
    j_state, t_state = jn.ObsNormState.create(D), tn.ObsNormState.create(D, CPU)
    for step in range(3):
        if step == 1:  # count 1: a single-row merge
            one = batch[:1, :1]
            j_state = jn.obs_norm_update(j_state, jnp.asarray(one))
            t_state = tn.obs_norm_update_plain(t_state, _t(one))
        j_out = np.asarray(jn.obs_norm_apply(j_state, jnp.asarray(obs)))
        t_out = tn.obs_norm_apply_plain(t_state, _t(obs)).numpy()
        np.testing.assert_allclose(t_out, j_out, rtol=0, atol=1e-6)
        if float(t_state.count) < 2:
            np.testing.assert_array_equal(t_out, obs)
        j_state = jn.obs_norm_update(j_state, jnp.asarray(batch))
        t_state = tn.obs_norm_update_plain(t_state, _t(batch))
        np.testing.assert_allclose(t_state.mean.numpy(), np.asarray(j_state.mean), rtol=0, atol=1e-6)
        np.testing.assert_allclose(t_state.m2.numpy(), np.asarray(j_state.m2), rtol=1e-5, atol=1e-6)
        assert float(t_state.count) == float(j_state.count)
    assert float(t_state.count) == 1 + 3 * 64


def test_return_norm_roll_on_the_acting_players_slot_matches_jax():
    rng = np.random.default_rng(4)
    E, P, gamma = 16, 3, 0.99
    j_ret = jnp.zeros((E, P))
    t_ret = torch.zeros(E, P)
    for _ in range(12):
        acting = rng.integers(0, P, E).astype(np.int32)
        rewards = rng.normal(size=E).astype(np.float32)
        dones = (rng.random(E) < 0.2).astype(np.float32)
        j_ret, js = jn.return_norm_roll(j_ret, jnp.asarray(rewards), jnp.asarray(acting),
                                        jnp.asarray(dones), gamma)
        t_ret, ts = tn.return_norm_roll(t_ret, _t(rewards), torch.from_numpy(acting), _t(dones),
                                        gamma)
        # One multiply-add per slot on both sides.
        np.testing.assert_allclose(t_ret.numpy(), np.asarray(j_ret), rtol=0, atol=1e-6)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-6)
    assert (t_ret.numpy() != 0).sum(axis=0).min() > 0  # every seat holds a return


def _jax_state(rng, D, start):
    """A JAX ObsNormState at count 0, count 1 (one row merged) or merged
    from a [64, D] batch of per-column scales and offsets."""
    state = jn.ObsNormState.create(D)
    if start == "count1":
        state = jn.obs_norm_update(state, jnp.asarray(rng.normal(size=(1, D)).astype(np.float32)))
    elif start == "merged":
        x = rng.normal(size=(64, D)) * rng.uniform(0.1, 3.0, D) + rng.normal(size=D)
        state = jn.obs_norm_update(state, jnp.asarray(x.astype(np.float32)))
    return state


@pytest.mark.parametrize("start", ["count0", "count1", "merged"])
@pytest.mark.parametrize("D", [4, 86, 270])
def test_obs_norm_update_then_apply_on_the_old_state_matches_jax(D, start):
    """The train step's pair (train.py:120-124 and 142-146 of the JAX
    package): the batch [T, E, D] merged into the stats, and the batch
    normalised with the stats from BEFORE the merge."""
    rng = np.random.default_rng(D)
    j_state = _jax_state(rng, D, start)
    t_state = tn.ObsNormState(*(_t(np.asarray(getattr(j_state, f))) for f in ("mean", "m2", "count")))
    batch = (rng.normal(size=(5, 3, D)) * 2.5 + 0.7).astype(np.float32)
    batch[..., 0] = 1.0  # a constant column
    batch[0, 0, 1] = 40.0  # past the clip once the stats are filled
    j_new = jn.obs_norm_update(j_state, jnp.asarray(batch))
    j_out = np.asarray(jn.obs_norm_apply(j_state, jnp.asarray(batch)))
    t_out = tn.obs_norm_apply(t_state, _t(batch))  # before the merge, in place
    t_new = tn.obs_norm_update(t_state, _t(batch))
    assert t_new is t_state
    assert t_out.shape == batch.shape
    np.testing.assert_allclose(t_new.mean.numpy(), np.asarray(j_new.mean), rtol=0, atol=1e-6)
    np.testing.assert_allclose(t_new.m2.numpy(), np.asarray(j_new.m2), rtol=1e-5, atol=1e-6)
    assert float(t_new.count) == float(j_new.count)
    np.testing.assert_allclose(t_out.numpy(), j_out, rtol=0, atol=1e-6)
    if start != "merged":  # count < 2 before the merge: the identity
        np.testing.assert_array_equal(t_out.numpy(), batch)
    else:
        assert np.abs(t_out.numpy()).max() == 10.0


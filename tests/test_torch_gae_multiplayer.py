"""Multiplayer GAE of the port (plain path of kernel K5) against
``compute_gae_multiplayer`` of the JAX package: the reference's hand
vectors and random turn-based rollouts."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from burn_ppo_tpu.ops.gae import compute_gae_multiplayer as jax_gae_mp  # noqa: E402
from burn_ppo_torch.ops.gae import compute_gae_multiplayer  # noqa: E402

# (all_rewards [T, E, P], values [T, E], dones [T, E], acting [T, E],
# last_vpp [E, P], gamma, lambda): the cases of tests/test_gae.py.
HAND = {
    "same_player_consecutive": ([[[0.0, 0.0]], [[1.0, 0.0]]], [[0.5], [0.8]], [[0.0], [1.0]],
                                [[0], [0]], [[0.8, 0.0]], 0.99, 0.95),
    "terminal_no_bleed": ([[[0.0, 0.0]], [[-1.0, 1.0]], [[1.0, -1.0]]], [[0.0], [0.0], [0.9]],
                          [[0.0], [1.0], [1.0]], [[0], [1], [0]], [[0.9, 0.0]], 0.99, 0.95),
    "attribution_boundary": ([[[0.0, 0.0]], [[-1.0, 1.0]], [[0.0, 0.0]], [[10.0, -10.0]]],
                             [[0.0]] * 4, [[0.0], [1.0], [0.0], [1.0]], [[0], [1], [0], [1]],
                             [[0.0, 0.0]], 0.99, 0.95),
    "three_players": ([[[0.0, 0.0, 0.0]], [[0.0, 0.0, 0.0]], [[-1.0, -1.0, 2.0]]], [[0.0]] * 3,
                      [[0.0], [0.0], [1.0]], [[0], [1], [2]], [[0.0, 0.0, 0.0]], 0.99, 0.95),
    "attribution_exact": ([[[0.0, 0.0]], [[-1.0, 1.0]]], [[0.2], [0.3]], [[0.0], [1.0]],
                          [[0], [1]], [[0.0, 0.0]], 0.9, 0.8),
    "per_player_bootstrap": ([[[0.0, 0.0]], [[0.0, 0.0]]], [[0.4], [0.6]], [[0.0], [0.0]],
                             [[0], [1]], [[0.5, 0.7]], 0.99, 0.95),
}


def _both(r, v, d, a, lv, gamma, lam):
    r, v, d, lv = (np.asarray(x, np.float32) for x in (r, v, d, lv))
    a = np.asarray(a, np.int32)
    j = jax_gae_mp(*(jnp.asarray(x) for x in (r, v, d, a, lv)), gamma, lam)
    t = compute_gae_multiplayer(*(torch.from_numpy(x) for x in (r, v, d, a, lv)), gamma, lam)
    return [np.asarray(x) for x in j], [x.numpy() for x in t]


@pytest.mark.parametrize("case", sorted(HAND))
def test_reference_vectors_match_jax(case):
    (j_adv, j_ret), (t_adv, t_ret) = _both(*HAND[case])
    np.testing.assert_allclose(t_adv, j_adv, rtol=0, atol=1e-6)
    np.testing.assert_allclose(t_ret, j_ret, rtol=0, atol=1e-6)


def test_attribution_exact_values():
    (_, _), (adv, ret) = _both(*HAND["attribution_exact"])
    np.testing.assert_allclose(adv[:, 0], [-1.2, 0.7], atol=1e-6)
    np.testing.assert_allclose(ret[:, 0], [-1.0, 1.0], atol=1e-6)


def _turn_based(P: int, T: int, E: int, seed: int, off_seats: bool = False):
    """Turns rotate through the seats and restart at a random seat after an
    episode ends; rewards arrive on some steps for every player. With
    ``off_seats``, some steps' acting index is -1 or P (no seat)."""
    rng = np.random.default_rng(seed)
    dones = (rng.random((T, E)) < 0.1).astype(np.float32)
    acting = np.zeros((T, E), np.int32)
    seat = rng.integers(0, P, E)
    for t in range(T):
        acting[t] = seat
        seat = np.where(dones[t] > 0, rng.integers(0, P, E), (seat + 1) % P)
    if off_seats:
        u = rng.random((T, E))
        acting = np.where(u < 0.1, -1, np.where(u < 0.2, P, acting)).astype(np.int32)
    rewards = (rng.normal(size=(T, E, P)) * (rng.random((T, E, P)) < 0.3)).astype(np.float32)
    values = rng.normal(size=(T, E)).astype(np.float32)
    last_vpp = rng.normal(size=(E, P)).astype(np.float32)
    return rewards, values, dones, acting, last_vpp


@pytest.mark.parametrize("P", [2, 3, 4])
def test_random_turn_based_rollouts_match_jax(P):
    (j_adv, j_ret), (t_adv, t_ret) = _both(*_turn_based(P, 16, 16, P), 0.99, 0.95)
    # Same recurrence in f32; XLA may contract mul+add into FMAs.
    np.testing.assert_allclose(t_adv, j_adv, rtol=0, atol=1e-5)
    np.testing.assert_allclose(t_ret, j_ret, rtol=0, atol=1e-5)


@pytest.mark.parametrize("P,T,E,off_seats", [
    (4, 16, 16, True), (2, 24, 9, True),  # acting indices -1 and P: no seat
    (8, 16, 16, False), (8, 12, 5, True),  # eight players
    (4, 1, 16, False), (3, 1, 7, True),  # one step
    (4, 37, 16, False), (2, 37, 33, True),  # T no multiple of K5's 16-step chunk
])
def test_turn_based_rollouts_at_the_kernels_edges_match_jax(P, T, E, off_seats):
    rewards, values, dones, acting, last_vpp = _turn_based(P, T, E, 10 * P + T, off_seats)
    if off_seats:
        assert ((acting < 0) | (acting >= P)).any()
    (j_adv, j_ret), (t_adv, t_ret) = _both(rewards, values, dones, acting, last_vpp, 0.99, 0.95)
    # Same recurrence in f32; XLA may contract mul+add into FMAs.
    np.testing.assert_allclose(t_adv, j_adv, rtol=0, atol=1e-5)
    np.testing.assert_allclose(t_ret, j_ret, rtol=0, atol=1e-5)

"""Masked categorical of the port (plain path of kernel K2) against the
JAX package, fed JAX's own Gumbel uniforms."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from burn_ppo_tpu.ops.categorical import (  # noqa: E402
    apply_action_mask,
    entropy_categorical,
    log_prob_categorical,
    sample_categorical,
)
from burn_ppo_torch.ops.categorical import (  # noqa: E402
    apply_action_mask as t_apply_action_mask,
    entropy_from_logp,
    masked_sample,
)

TINY = float(jnp.finfo(jnp.float32).tiny)


def test_jax_gumbel_is_minus_log_minus_log_of_its_uniform():
    key = jax.random.PRNGKey(5)
    u = jax.random.uniform(key, (64, 7), minval=TINY, maxval=1.0)
    np.testing.assert_array_equal(
        np.asarray(jax.random.gumbel(key, (64, 7))), np.asarray(-jnp.log(-jnp.log(u)))
    )


@pytest.mark.parametrize("num_actions,masked", [(2, False), (2, True), (7, True), (49, True)])
def test_sample_log_prob_entropy_match_jax(num_actions, masked):
    rng = np.random.default_rng(num_actions)
    E, A = 512, num_actions
    logits = (rng.normal(size=(E, A)) * 2).astype(np.float32)
    mask = None
    if masked:
        mask = (rng.random((E, A)) < 0.6).astype(np.float32)
        mask[np.arange(E), rng.integers(0, A, E)] = 1.0  # >= 1 legal action
    key = jax.random.PRNGKey(11 + A)
    u = jax.random.uniform(key, (E, A), minval=TINY, maxval=1.0)

    j_masked = apply_action_mask(jnp.asarray(logits), None if mask is None else jnp.asarray(mask))
    j_actions = sample_categorical(key, j_masked)
    j_logp = log_prob_categorical(j_masked, j_actions)
    j_ent = entropy_categorical(j_masked)

    t_mask = None if mask is None else torch.from_numpy(mask)
    t_actions, t_logp = masked_sample(
        torch.from_numpy(logits), t_mask, torch.from_numpy(np.array(u))
    )
    t_ent = entropy_from_logp(
        torch.log_softmax(t_apply_action_mask(torch.from_numpy(logits), t_mask), dim=-1)
    )

    # Same uniforms, same argmax rule (first maximum): actions are exact.
    np.testing.assert_array_equal(t_actions.numpy(), np.asarray(j_actions))
    assert t_actions.dtype == torch.int32
    if mask is not None:
        assert np.all(mask[np.arange(E), t_actions.numpy()] == 1.0)
    # log-softmax in f32 on both sides: differences of an ulp or two.
    np.testing.assert_allclose(t_logp.numpy(), np.asarray(j_logp), rtol=0, atol=1e-6)
    np.testing.assert_allclose(t_ent.numpy(), np.asarray(j_ent), rtol=0, atol=1e-6)


def test_ties_break_to_the_first_maximum():
    logits = torch.zeros(4, 3)
    u = torch.full((4, 3), 0.5)
    actions, logp = masked_sample(logits, None, u)
    assert actions.tolist() == [0, 0, 0, 0]
    np.testing.assert_allclose(logp.numpy(), np.log(1 / 3) * np.ones(4), rtol=1e-6)

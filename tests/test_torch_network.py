"""The port's MLP actor-critic against the JAX network, and its own init."""

import math

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from burn_ppo_tpu.models.network import ActorCriticNetwork as JaxNetwork  # noqa: E402
from burn_ppo_torch.convert import params_from_jax, params_to_jax, tree_leaves  # noqa: E402
from burn_ppo_torch.models.network import ActorCriticNetwork  # noqa: E402


def _pair(split: bool, activation: str, seed: int = 0):
    jnet = JaxNetwork(network_type="mlp", obs_dim=5, action_count=3, hidden_size=32,
                      num_hidden=2, activation=activation, split_networks=split)
    jparams = jax.tree_util.tree_map(np.asarray, jnet.init(jax.random.PRNGKey(seed)))
    tnet = ActorCriticNetwork(5, 3, hidden_size=32, num_hidden=2, activation=activation,
                              split_networks=split, generator=torch.Generator().manual_seed(1))
    tnet.load_state_dict(params_from_jax(jparams))
    return jnet, jparams, tnet


@pytest.mark.parametrize("split,activation", [(False, "relu"), (True, "tanh")])
def test_forward_matches_jax_with_converted_params(split, activation):
    jnet, jparams, tnet = _pair(split, activation)
    obs = np.random.default_rng(2).normal(size=(64, 5)).astype(np.float32) * 3
    j_logits, j_values = jnet.forward(jparams, obs)
    with torch.no_grad():
        t_logits, t_values = tnet(torch.from_numpy(obs))
    # f32 on both sides at full matmul precision; only summation order differs.
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(t_values.numpy(), np.asarray(j_values), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("split", [False, True])
def test_params_round_trip_in_jax_leaf_order(split):
    _, jparams, tnet = _pair(split, "tanh")
    back = params_to_jax(tnet.state_dict())
    j_leaves = jax.tree_util.tree_leaves(jparams)
    t_leaves = tree_leaves(back)
    assert len(j_leaves) == len(t_leaves)
    for a, b in zip(j_leaves, t_leaves):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(jparams)


@pytest.mark.parametrize("activation,gain", [("relu", math.sqrt(2.0)), ("tanh", 1.0)])
def test_own_init_is_orthogonal_with_reference_gains(activation, gain):
    # Statistical, not parity: the draws differ, the distribution must not.
    net = ActorCriticNetwork(5, 2, hidden_size=64, num_hidden=2, activation=activation,
                             generator=torch.Generator().manual_seed(3))

    def check(weight, g):
        w = weight.detach().double()  # [out, in]
        small = min(w.shape)
        gram = w @ w.T if w.shape[0] == small else w.T @ w
        np.testing.assert_allclose(gram.numpy(), g * g * np.eye(small), atol=1e-5)

    check(net.layers[0].weight, gain)
    check(net.layers[1].weight, gain)
    check(net.policy_head.weight, 0.01)
    check(net.value_head.weight, 1.0)
    for m in (*net.layers, net.policy_head, net.value_head):
        assert torch.count_nonzero(m.bias) == 0
    other = ActorCriticNetwork(5, 2, hidden_size=64, num_hidden=2, activation=activation,
                               generator=torch.Generator().manual_seed(4))
    assert not torch.equal(net.layers[0].weight, other.layers[0].weight)

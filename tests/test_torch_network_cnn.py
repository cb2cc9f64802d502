"""The port's CNN actor-critic against the JAX network through ``convert``:
shared and split towers, the conv-channel rule and the parameter layout."""

import math

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from burn_ppo_tpu.models.network import ActorCriticNetwork as JaxNetwork  # noqa: E402
from burn_ppo_torch.convert import params_from_jax, params_to_jax, tree_leaves  # noqa: E402
from burn_ppo_torch.models.network import ActorCriticNetwork  # noqa: E402

OBS_SHAPE = (6, 7, 2)
OBS_DIM = 86


def _pair(split: bool, activation: str = "relu", channels=(8, 8), layers: int = 2,
          kernel: int = 3, fc_layers: int = 1):
    kw = dict(network_type="cnn", hidden_size=32, num_hidden=1, activation=activation,
              split_networks=split, obs_shape=OBS_SHAPE, num_conv_layers=layers,
              conv_channels=channels, kernel_size=kernel, cnn_fc_hidden_size=32,
              cnn_num_fc_layers=fc_layers)
    jnet = JaxNetwork(obs_dim=OBS_DIM, action_count=7, **kw)
    jparams = jax.tree_util.tree_map(np.asarray, jnet.init(jax.random.PRNGKey(3)))
    tnet = ActorCriticNetwork(OBS_DIM, 7, generator=torch.Generator().manual_seed(1), **kw)
    tnet.load_state_dict(params_from_jax(jparams))
    return jnet, jparams, tnet


def _obs(n: int, seed: int = 0) -> np.ndarray:
    """Board-like planes plus a turn one-hot, with some noise so every
    input position matters."""
    rng = np.random.default_rng(seed)
    planes = (rng.random((n, 84)) < 0.3).astype(np.float32) + rng.normal(0, 0.1, (n, 84))
    turn = np.eye(2, dtype=np.float32)[rng.integers(0, 2, n)]
    return np.concatenate([planes, turn], axis=1).astype(np.float32)


@pytest.mark.parametrize("split,activation,channels,layers,kernel,fc_layers", [
    (False, "relu", (8, 8), 2, 3, 1),
    (True, "tanh", (4, 6), 3, 3, 2),  # the last channel count repeats for layer 3
    (False, "relu", (5,), 2, 2, 1),  # an even kernel: SAME pads the high side
])
def test_forward_matches_jax_with_converted_params(split, activation, channels, layers, kernel,
                                                   fc_layers):
    jnet, jparams, tnet = _pair(split, activation, channels, layers, kernel, fc_layers)
    obs = _obs(64)
    j_logits, j_values = jnet.forward(jparams, obs)
    with torch.no_grad():
        t_logits, t_values = tnet(torch.from_numpy(obs))
    # f32 at full precision on both sides (the test host's CPU kernels);
    # only the summation order of the convs and matmuls differs.
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), rtol=0, atol=1e-5)
    np.testing.assert_allclose(t_values.numpy(), np.asarray(j_values), rtol=0, atol=1e-5)


@pytest.mark.parametrize("split", [False, True])
def test_params_round_trip_in_jax_leaf_order(split):
    _, jparams, tnet = _pair(split)
    back = params_to_jax(tnet.state_dict())
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(jparams)
    for a, b in zip(jax.tree_util.tree_leaves(jparams), tree_leaves(back)):
        assert a.shape == b.shape  # HWIO conv kernels, [in, out] dense kernels
        np.testing.assert_array_equal(a, b)
    keys = {"conv_layers", "fc_layers", "policy_head", "value_head"}
    assert set(back) == (keys | {"critic_conv_layers", "critic_fc_layers"} if split else keys)


def test_own_init_is_orthogonal_with_relu_conv_gain():
    net = ActorCriticNetwork(OBS_DIM, 7, network_type="cnn", activation="tanh",
                             obs_shape=OBS_SHAPE, generator=torch.Generator().manual_seed(3))
    # Conv kernels are drawn as HWIO [3*3*in, out] matrices with the relu
    # gain whatever the activation (the convs are always relu).
    for conv in net.conv_layers:
        w = conv.weight.detach().double().permute(2, 3, 1, 0).reshape(-1, conv.out_channels)
        np.testing.assert_allclose((w.T @ w).numpy(), 2.0 * np.eye(conv.out_channels), atol=1e-5)
        assert torch.count_nonzero(conv.bias) == 0
    fc = net.fc_layers[0].weight.detach().double()
    assert fc.shape == (32, 6 * 7 * 8 + 2)  # final conv channels x board + the turn one-hot
    np.testing.assert_allclose((fc @ fc.T).numpy(), np.eye(32), atol=1e-5)  # tanh gain 1
    assert math.isclose(float(net.policy_head.weight.detach().norm(dim=1).max()), 0.01, rel_tol=1e-5)


def test_cnn_needs_obs_shape():
    with pytest.raises(ValueError, match="obs_shape"):
        ActorCriticNetwork(5, 2, network_type="cnn", generator=torch.Generator())

"""The CTDE actor-critic of the port against the JAX package's
``forward_actor`` / ``forward_critic`` with converted parameters, the
parameter layout both ways, and a CTDE checkpoint that each package loads."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from burn_ppo_tpu.checkpoint import CheckpointManager as JaxCheckpoints  # noqa: E402
from burn_ppo_tpu.envs.skull import Skull as JaxSkull  # noqa: E402
from burn_ppo_tpu.models.network import make_network as jax_make_network  # noqa: E402
from burn_ppo_torch.checkpoint import CheckpointManager, build_metadata, load_model, model_leaves  # noqa: E402
from burn_ppo_torch.convert import params_from_jax, params_to_jax, tree_leaves  # noqa: E402
from burn_ppo_torch.envs.skull import Skull  # noqa: E402
from burn_ppo_torch.models.network import make_network  # noqa: E402

NETS = [  # (hidden, depth, critic hidden, critic depth, activation)
    (32, 2, None, None, "tanh"),
    (24, 3, 40, 1, "relu"),
]


def _pair(hidden, depth, ch, cn, act, seed=0):
    spec = JaxSkull(4).spec
    jnet = jax_make_network(spec, network_type="ctde", hidden_size=hidden, num_hidden=depth,
                            activation=act, critic_hidden_size=ch, critic_num_hidden=cn)
    params = jnet.init(jax.random.PRNGKey(seed))
    tnet = make_network(Skull(4).spec, network_type="ctde", hidden_size=hidden, num_hidden=depth,
                        activation=act, critic_hidden_size=ch, critic_num_hidden=cn,
                        generator=torch.Generator().manual_seed(seed))
    tnet.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    return jnet, params, tnet


@pytest.mark.parametrize("hidden,depth,ch,cn,act", NETS)
def test_ctde_forward_matches_jax(hidden, depth, ch, cn, act):
    jnet, params, tnet = _pair(hidden, depth, ch, cn, act)
    rng = np.random.default_rng(1)
    obs = rng.normal(size=(64, 135)).astype(np.float32)
    priv = rng.normal(size=(64, 200)).astype(np.float32)
    logits = np.asarray(jnet.forward_actor(params, jnp.asarray(obs)))
    values = np.asarray(jnet.forward_critic(params, jnp.asarray(priv), jnp.asarray(obs)))
    with torch.no_grad():
        t_logits, t_values = tnet(torch.from_numpy(obs), torch.from_numpy(priv))
        actor_only = tnet.forward_actor(torch.from_numpy(obs))
    # f32 on both sides at full matmul precision: atol 1e-5.
    np.testing.assert_allclose(t_logits.numpy(), logits, rtol=0, atol=1e-5)
    np.testing.assert_allclose(t_values.numpy(), values, rtol=0, atol=1e-5)
    assert torch.equal(actor_only, t_logits)
    # The critic's first layer takes the 200 privileged features, then the 135 obs ones.
    assert tnet.critic_layers[0].in_features == 335
    with pytest.raises(ValueError, match="privileged_obs"):
        tnet(torch.from_numpy(obs))


@pytest.mark.parametrize("hidden,depth,ch,cn,act", NETS)
def test_ctde_params_round_trip_in_jax_leaf_order(hidden, depth, ch, cn, act):
    _, params, tnet = _pair(hidden, depth, ch, cn, act, seed=3)
    back = params_to_jax(tnet.state_dict())
    assert sorted(back) == ["actor_layers", "critic_layers", "policy_head", "value_head"]
    j_leaves = jax.tree_util.tree_leaves(params)
    t_leaves = tree_leaves(back)
    assert len(j_leaves) == len(t_leaves)
    for a, b in zip(t_leaves, j_leaves):
        np.testing.assert_array_equal(a, np.asarray(b))
    # Leaf 0 is the first actor bias, leaf 1 its kernel [135, hidden]; the
    # critic's first kernel is [200 + 135, critic hidden].
    assert t_leaves[0].shape == (hidden,) and t_leaves[1].shape == (135, hidden)
    assert t_leaves[2 * depth + 1].shape == (335, ch or hidden)


def test_ctde_checkpoint_loads_in_both_packages(tmp_path):
    _, params, tnet = _pair(24, 3, 40, 1, "relu", seed=5)
    meta = build_metadata(step=128, env_name="skull", network=tnet, num_players=4)
    assert (meta["network_type"], meta["privileged_obs_dim"], meta["critic_hidden_size"],
            meta["critic_num_hidden"]) == ("ctde", 200, 40, 1)
    path = CheckpointManager(tmp_path).save(128, model_leaves(tnet), [], {}, meta)
    back, meta_back = load_model(path)
    assert meta_back == meta
    for (k, a), (k2, b) in zip(tnet.state_dict().items(), back.state_dict().items()):
        assert k == k2 and torch.equal(a, b)
    j2, p2, _ = JaxCheckpoints.load_model(path)
    assert j2.is_ctde and j2.critic_hidden_size == 40
    for a, b in zip(jax.tree_util.tree_leaves(p2), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

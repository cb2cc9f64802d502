"""PPO loss, gradients and the whole update of the port against the JAX
package, with the JAX epoch permutations replayed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from burn_ppo_tpu.models.network import ActorCriticNetwork as JaxNetwork  # noqa: E402
from burn_ppo_tpu.ppo import update as ju  # noqa: E402
from burn_ppo_torch.convert import params_from_jax, params_to_jax, tree_leaves  # noqa: E402
from burn_ppo_torch.models.network import ActorCriticNetwork  # noqa: E402
from burn_ppo_torch.ppo import update as tu  # noqa: E402
from burn_ppo_torch.ppo.rollout import RandomSource  # noqa: E402

OBS, A, H = 5, 3, 16


class ReplaySource(RandomSource):
    """Hands out pre-drawn JAX permutations in order."""

    def __init__(self, perms):
        self.perms = list(perms)

    def permutation(self, n):
        p = self.perms.pop(0)
        assert p.shape == (n,)
        return torch.from_numpy(np.array(p, dtype=np.int64))


def _nets(split=False):
    jnet = JaxNetwork(network_type="mlp", obs_dim=OBS, action_count=A, hidden_size=H,
                      num_hidden=2, activation="tanh", split_networks=split)
    jparams = jnet.init(jax.random.PRNGKey(1))
    tnet = ActorCriticNetwork(OBS, A, hidden_size=H, num_hidden=2, activation="tanh",
                              split_networks=split, generator=torch.Generator().manual_seed(0))
    tnet.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, jparams)))
    return jnet, jparams, tnet


def _data(jnet, jparams, n, seed, masked=True):
    rng = np.random.default_rng(seed)
    obs = rng.normal(size=(n, OBS)).astype(np.float32)
    masks = np.ones((n, A), np.float32)
    if masked:
        masks = (rng.random((n, A)) < 0.7).astype(np.float32)
        masks[np.arange(n), 0] = 1.0
    actions = np.array([rng.choice(np.flatnonzero(m)) for m in masks], np.int32)
    logits, values = jnet.forward(jparams, jnp.asarray(obs))
    logp = jax.nn.log_softmax(logits + jnp.where(masks > 0, 0.0, -1e9), axis=-1)
    old_lp = np.asarray(logp)[np.arange(n), actions] + rng.normal(0, 0.05, n).astype(np.float32)
    data = {
        "obs": obs,
        "actions": actions,
        "old_log_probs": old_lp.astype(np.float32),
        "advantages": rng.normal(0.3, 2.0, n).astype(np.float32),
        "returns": rng.normal(1.0, 1.0, n).astype(np.float32),
        "old_values": (np.asarray(values) + rng.normal(0, 0.3, n)).astype(np.float32),
        "valid": np.ones(n, np.float32),
        "action_masks": masks,
    }
    return data


def _torch_data(data):
    return {k: torch.from_numpy(np.array(v)) for k, v in data.items()}


@pytest.mark.parametrize("clip_value", [False, True])
def test_minibatch_loss_and_grads_match_jax(clip_value):
    jnet, jparams, tnet = _nets(split=clip_value)
    data = _data(jnet, jparams, 64, seed=3)
    data["valid"][::7] = 0.0
    jcfg = ju.PPOUpdateConfig(clip_value=clip_value)
    tcfg = tu.PPOUpdateConfig(clip_value=clip_value)
    grad_fn = jax.value_and_grad(ju._minibatch_loss, has_aux=True)
    (j_loss, j_aux), j_grads = jax.jit(lambda p, mb: grad_fn(p, jnet, mb, None, 0.01, jcfg))(
        jparams, {k: jnp.asarray(v) for k, v in data.items()}
    )
    t_loss, t_aux = tu.minibatch_loss(tnet, _torch_data(data), 0.01, tcfg)
    names = [k for k, _ in tnet.named_parameters()]
    t_grads = torch.autograd.grad(t_loss, list(tnet.parameters()))
    # f32 on both sides, full matmul precision; reductions run in another
    # order, so values agree to rtol 1e-5 (atol 1e-8 covers entries that
    # are zero up to rounding).
    np.testing.assert_allclose(t_loss.item(), float(j_loss), rtol=1e-5)
    for k in ju.METRIC_KEYS:
        np.testing.assert_allclose(float(t_aux[k]), float(j_aux[k]), rtol=1e-5, atol=1e-8,
                                   err_msg=k)
    t_tree = params_to_jax(dict(zip(names, t_grads)))
    for a, b in zip(tree_leaves(t_tree), jax.tree_util.tree_leaves(j_grads)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-8)


CASES = {
    # name: (N, num_minibatches, num_epochs, target_kl, max_grad_norm, lr)
    "even_clipped": (48, 4, 2, None, 0.05, 3e-3),
    "uneven_pad": (37, 4, 3, None, 10.0, 3e-3),
    "all_pad_skip": (5, 4, 2, None, 0.5, 3e-3),
    "kl_early_stop": (64, 4, 3, 2e-3, 0.5, 5e-2),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_ppo_update_matches_jax_with_replayed_permutations(case):
    n, nmb, epochs, target_kl, max_norm, lr = CASES[case]
    jnet, jparams, tnet = _nets()
    data = _data(jnet, jparams, n, seed=n)
    kw = dict(num_minibatches=nmb, num_epochs=epochs, target_kl=target_kl,
              max_grad_norm=max_norm, clip_value=True, shuffle_block_rows=1)
    jcfg, tcfg = ju.PPOUpdateConfig(**kw), tu.PPOUpdateConfig(**kw)
    tx = ju.make_optimizer(jcfg)
    key = jax.random.PRNGKey(n)
    j_params, j_opt, _, j_m = jax.jit(
        lambda p, o, d, k: ju.ppo_update(jnet, tx, p, o, d, None, k, lr, 0.01, jcfg)
    )(jparams, tx.init(jparams), {k: jnp.asarray(v) for k, v in data.items()}, key)

    mb_size = -(-n // nmb)
    perms = [jax.random.permutation(k, nmb * mb_size)
             for k in jax.random.split(key, epochs)]
    opt = tu.AdamState.create(tnet)
    t_m = tu.ppo_update(tnet, opt, _torch_data(data), ReplaySource(perms), lr, 0.01, tcfg)

    count = float(j_m["num_minibatch_updates"])
    assert float(t_m["num_minibatch_updates"]) == count
    if case == "kl_early_stop":
        assert 0 < count < epochs * nmb
    if case == "all_pad_skip":
        assert count < epochs * nmb
    if case == "even_clipped":
        assert count == epochs * nmb
    # Minibatch reductions and Adam steps accumulate rounding in another
    # order over several steps: rtol 1e-4 / atol 1e-5.
    t_tree = params_to_jax(tnet.state_dict())
    for a, b in zip(tree_leaves(t_tree), jax.tree_util.tree_leaves(j_params)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-5)
    j_adam = j_opt[1]
    assert opt.count == int(j_adam.count)
    for mine, ref in ((opt.mu, j_adam.mu), (opt.nu, j_adam.nu)):
        for a, b in zip(tree_leaves(params_to_jax(mine)), jax.tree_util.tree_leaves(ref)):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-5)
    for k in list(ju.METRIC_KEYS) + ["explained_variance"]:
        np.testing.assert_allclose(float(t_m[k]), float(j_m[k]), rtol=1e-4, atol=1e-5,
                                   err_msg=k)


def test_clip_is_optax_clip_by_global_norm():
    """Below the max norm the gradient passes untouched; above, it scales
    by max/norm exactly (not clip_grad_norm_'s max/(norm + 1e-6))."""
    net = torch.nn.Linear(1, 1)
    with torch.no_grad():
        net.weight.zero_()
        net.bias.zero_()
    for g_scale, max_norm in ((0.1, 1.0), (10.0, 1.0)):
        opt = tu.AdamState.create(net)
        grads = [torch.full((1, 1), 3.0 * g_scale), torch.full((1,), 4.0 * g_scale)]
        norm = 5.0 * g_scale
        cfg = tu.PPOUpdateConfig(max_grad_norm=max_norm, adam_epsilon=1e-5)
        tu.clip_and_adam_step(net, grads, opt, 1.0, cfg)
        clipped = [g if norm < max_norm else g / norm * max_norm for g in grads]
        for mu, g in zip(opt.mu.values(), clipped):
            np.testing.assert_allclose(mu.numpy(), 0.1 * g.numpy(), rtol=1e-6)

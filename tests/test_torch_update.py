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


def _book():
    return tu.LossBook.create(torch.device("cpu"))


def _scalar(x):
    return torch.tensor(x, dtype=torch.float32)


_RUN = torch.ones((), dtype=torch.int32)


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
    t_loss, t_metrics = tu.minibatch_loss(tnet, _torch_data(data), _scalar(0.01), tcfg, _book())
    t_aux = dict(zip(tu.METRIC_KEYS, t_metrics))
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
    t_m = tu.ppo_update(tnet, opt, _torch_data(data), ReplaySource(perms), _scalar(lr),
                        _scalar(0.01), tcfg)

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
        for prm, g in zip(net.parameters(), grads):
            prm.grad.copy_(g)
        tu.clip_and_adam_step(opt, _scalar(1.0), cfg, _RUN)
        clipped = [g if norm < max_norm else g / norm * max_norm for g in grads]
        for mu, g in zip(opt.mu.values(), clipped):
            np.testing.assert_allclose(mu.numpy(), 0.1 * g.numpy(), rtol=1e-6)


class _Outputs:
    """A stand-in network whose 'parameters' are the logits and values
    themselves, so value_and_grad gives dL/dlogits and dL/dvalues."""

    def policy_and_value(self, params, obs, priv=None):
        return params["logits"], params["values"]


def _loss_inputs(M, A, seed, eps):
    rng = np.random.default_rng(seed)
    logits = (rng.normal(size=(M, A)) * 2).astype(np.float32)
    masks = (rng.random((M, A)) < 0.6).astype(np.float32)
    masks[np.arange(M), rng.integers(0, A, M)] = 1.0
    masks[:4] = 1.0  # every action legal
    masks[4] = 0.0
    masks[4, 0] = 1.0  # one legal action: no choice, zero entropy
    actions = np.array([rng.choice(np.flatnonzero(m)) for m in masks], np.int32)
    logp = np.asarray(jax.nn.log_softmax(jnp.asarray(logits) + jnp.where(masks > 0, 0.0, -1e9)))
    old_lp = logp[np.arange(M), actions] + rng.normal(0, 0.2, M).astype(np.float32)
    values = rng.normal(size=M).astype(np.float32)
    old_values = (values + rng.normal(0, 0.4, M)).astype(np.float32)
    # Ties JAX resolves by halving: value steps exactly at +-eps (the
    # clip's bound and max(e1^2, e2^2) tie at once) and unchanged values.
    old_values[5], values[5] = 0.5, 0.5 + eps
    old_values[6], values[6] = 0.5, 0.5 - eps
    old_values[7] = values[7]
    valid = (rng.random(M) < 0.75).astype(np.float32)
    valid[:8] = 1.0
    mb = {
        "actions": actions, "old_log_probs": old_lp.astype(np.float32),
        "advantages": rng.normal(0.3, 2.0, M).astype(np.float32),
        "returns": rng.normal(1.0, 1.0, M).astype(np.float32), "old_values": old_values,
        "valid": valid, "action_masks": masks,
    }
    return logits, values, mb


def _jax_mb(mb):
    """The JAX loss reads its (unused here) obs column too."""
    return {"obs": jnp.zeros((len(mb["valid"]), 1)), **{k: jnp.asarray(v) for k, v in mb.items()}}


@pytest.mark.parametrize("A", [2, 7])
@pytest.mark.parametrize("clip_value", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_k8_plain_loss_metrics_and_grads_match_jax(A, clip_value, masked):
    """K8's plain version against value_and_grad of the JAX loss in the
    logits and values: loss, the 14 metrics, dL/dlogits, dL/dvalues."""
    eps = 0.25  # exactly representable, so the value-clip ties are exact
    logits, values, mb = _loss_inputs(96, A, seed=A + 2 * clip_value, eps=eps)
    if not masked:
        mb.pop("action_masks")
    jcfg = ju.PPOUpdateConfig(clip_value=clip_value, clip_epsilon=eps)
    tcfg = tu.PPOUpdateConfig(clip_value=clip_value, clip_epsilon=eps)
    grad_fn = jax.value_and_grad(ju._minibatch_loss, has_aux=True)
    (j_loss, j_aux), j_grads = grad_fn(
        {"logits": jnp.asarray(logits), "values": jnp.asarray(values)}, _Outputs(),
        _jax_mb(mb), None, 0.03, jcfg)
    t_loss, t_metrics, t_dlogits, t_dvalues = tu.ppo_loss_plain(
        torch.from_numpy(logits), torch.from_numpy(values), _torch_data(mb), _scalar(0.03), tcfg,
        _book())
    np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=1e-5)
    for k, v in zip(tu.METRIC_KEYS, t_metrics):
        np.testing.assert_allclose(float(v), float(j_aux[k]), rtol=1e-5, atol=1e-7, err_msg=k)
    np.testing.assert_allclose(t_dlogits.numpy(), np.asarray(j_grads["logits"]), rtol=1e-5,
                               atol=1e-8)
    np.testing.assert_allclose(t_dvalues.numpy(), np.asarray(j_grads["values"]), rtol=1e-5,
                               atol=1e-8)
    # The tie rows: JAX splits the gradient, so the two value rows at the
    # clip bound get 3/4 of the unclipped 2 * (v - ret) slope.
    if clip_value:
        coef = 0.5 * 0.5 / mb["valid"].sum()
        for i in (5, 6):
            np.testing.assert_allclose(float(t_dvalues[i]),
                                       coef * 0.75 * 2 * (values[i] - mb["returns"][i]), rtol=1e-5)
    # Through the autograd node: the same gradients reach the inputs.
    lt = torch.from_numpy(logits).requires_grad_()
    vt = torch.from_numpy(values).requires_grad_()
    loss, metrics = tu.ppo_loss(lt, vt, _torch_data(mb), _scalar(0.03), tcfg, _book())
    (2.0 * loss).backward()
    np.testing.assert_allclose(lt.grad.numpy(), 2.0 * t_dlogits.numpy(), rtol=1e-6)
    np.testing.assert_allclose(vt.grad.numpy(), 2.0 * t_dvalues.numpy(), rtol=1e-6)


def test_k8_plain_all_invalid_minibatch_gives_zeros_like_jax():
    logits, values, mb = _loss_inputs(16, 7, seed=9, eps=0.2)
    mb["valid"][:] = 0.0
    cfg = ju.PPOUpdateConfig(clip_value=True)
    (j_loss, j_aux), j_grads = jax.value_and_grad(ju._minibatch_loss, has_aux=True)(
        {"logits": jnp.asarray(logits), "values": jnp.asarray(values)}, _Outputs(),
        _jax_mb(mb), None, 0.01, cfg)
    t_loss, t_metrics, t_dl, t_dv = tu.ppo_loss_plain(
        torch.from_numpy(logits), torch.from_numpy(values), _torch_data(mb), _scalar(0.01),
        tu.PPOUpdateConfig(clip_value=True), _book())
    assert float(t_loss) == float(j_loss) == 0.0
    for k, v in zip(tu.METRIC_KEYS, t_metrics):
        assert float(v) == pytest.approx(float(j_aux[k]), abs=1e-7), k
    assert not t_dl.any() and not t_dv.any() and not np.asarray(j_grads["logits"]).any()


@pytest.mark.parametrize("scale", [0.01, 50.0])
def test_k9_plain_matches_optax_over_three_steps(scale):
    """Below and above max_grad_norm: optax chain(clip_by_global_norm,
    scale_by_adam) then p - lr * u, on one flat parameter vector."""
    rng = np.random.default_rng(int(scale * 100))
    n, lr, max_norm = 300, 3e-3, 0.5
    p0 = rng.normal(size=n).astype(np.float32)
    tx = ju.make_optimizer(ju.PPOUpdateConfig(max_grad_norm=max_norm, adam_epsilon=1e-5))
    jp, jstate = jnp.asarray(p0), None
    jstate = tx.init(jp)
    tp, mu, nu = torch.from_numpy(p0.copy()), torch.zeros(n), torch.zeros(n)
    t_count = torch.zeros((), dtype=torch.int32)
    norms = []
    for count in (1, 2, 3):
        g = (rng.normal(size=n) * scale / np.sqrt(n)).astype(np.float32)
        norms.append(float(np.linalg.norm(g)))
        u, jstate = tx.update(jnp.asarray(g), jstate, jp)
        jp = jp - lr * u
        tu.clip_adam(tp, torch.from_numpy(g), mu, nu, lr=torch.tensor(lr), count=t_count,
                     run=_RUN, max_grad_norm=max_norm, eps=1e-5)
        assert int(t_count) == count == int(jstate[1].count)
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(mu.numpy(), np.asarray(jstate[1].mu), rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(nu.numpy(), np.asarray(jstate[1].nu), rtol=1e-6, atol=1e-12)
    assert all(x < max_norm for x in norms) if scale < 1 else all(x > max_norm for x in norms)


def test_ppo_update_may_have_invalid_skips_all_invalid_minibatches():
    """Two valid rows in 32: at least two of the four minibatches of every
    epoch hold none, and both packages skip exactly those."""
    n, nmb, epochs, lr = 32, 4, 2, 3e-3
    jnet, jparams, tnet = _nets()
    data = _data(jnet, jparams, n, seed=11)
    data["valid"][:] = 0.0
    data["valid"][[3, 20]] = 1.0
    kw = dict(num_minibatches=nmb, num_epochs=epochs, clip_value=True, shuffle_block_rows=1)
    jcfg, tcfg = ju.PPOUpdateConfig(**kw), tu.PPOUpdateConfig(**kw)
    tx = ju.make_optimizer(jcfg)
    key = jax.random.PRNGKey(5)
    j_params, _, _, j_m = jax.jit(
        lambda p, o, d, k: ju.ppo_update(jnet, tx, p, o, d, None, k, lr, 0.01, jcfg,
                                         may_have_invalid=True)
    )(jparams, tx.init(jparams), {k: jnp.asarray(v) for k, v in data.items()}, key)
    perms = [np.asarray(jax.random.permutation(k, n)) for k in jax.random.split(key, epochs)]
    expected = sum(int(np.isin(p.reshape(nmb, -1), [3, 20]).any(1).sum()) for p in perms)
    opt = tu.AdamState.create(tnet)
    t_m = tu.ppo_update(tnet, opt, _torch_data(data), ReplaySource(perms), _scalar(lr),
                        _scalar(0.01), tcfg, may_have_invalid=True)
    assert float(t_m["num_minibatch_updates"]) == float(j_m["num_minibatch_updates"]) == expected
    assert expected <= epochs * 2 and opt.count == expected
    for a, b in zip(tree_leaves(params_to_jax(tnet.state_dict())),
                    jax.tree_util.tree_leaves(j_params)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-5)
    for k in list(ju.METRIC_KEYS) + ["explained_variance"]:
        np.testing.assert_allclose(float(t_m[k]), float(j_m[k]), rtol=1e-4, atol=1e-5, err_msg=k)

"""The bf16 compute dtype (``--compute-dtype bfloat16``) of the port against
the JAX package on the CPU: the dense and conv layers and their
gradients, the MLP, CTDE and CNN networks and the PPO loss's gradients,
the opponents' plain forward against JAX's vmap over the stacked
opponents, one update on the same batch, and the trainer's paths (vs
pool, CNN self-play, resume).

Tolerances. One layer's products of bf16 operands are exact in f32, so a
layer's forward differs from JAX's by the order of its f32 sums alone and
is held at the f32 tolerance of the network tests (rtol 1e-5, atol 1e-5).
Its gradients are f32 sums rounded to bf16: on inputs whose every sum is
exact in f32 (dyadic values, 32-wide) they equal JAX's bit for bit; on
normal draws a sum that differs in its last f32 bit can land on the other
side of a bf16 rounding, one bf16 ulp: rtol 2^-7.

A network's outputs and gradients, and the plain opponent forward, are
held by ``bf16_agrees``, which reads each array by what it is:

- a leaf that both sides round to bf16 (a dense or conv kernel's
  gradient, ``rounded``): every element a bf16 value, and at most
  ``ULP_SHARE`` = 1/12 of its elements more than one bf16 ulp from JAX's.
  A cotangent sum whose last f32 bit differs between XLA's CPU conv and
  torch's lands on the other side of a rounding on some hosts: one ulp,
  which this reading does not count however many elements flip, where a
  max-relative reading took up to 2^-8 from one flip;
- an f32 array (logits, values, the loss, a bias's gradient): the
  norm-wise ``norm_err`` = |port - JAX| / |JAX| <= ``NORM_TOL`` =
  2^-10.5 (6.9e-4), which a few flipped roundings upstream barely move
  and one layer in f32 moves everywhere.

Readings on this file's inputs, the port against JAX and the controls
each test asserts fail it (the network in f32; one layer left in f32:
the policy head of the shared MLP, the split MLP's value head, the CTDE
critic's first layer, the CNN's first conv; the opponents' f32 tower on
the bf16-rounded weights):

- the port: every rounded leaf bf16-valued, at most 2 of 144 elements
  (1.4%, the CNN's first conv) more than one ulp apart, 0 in the MLP and
  CTDE leaves; f32 arrays <= 2.0e-4 (the CNN's conv biases, fed by
  flipped roundings of the input cotangent), <= 4.5e-7 elsewhere; the
  opponents' forward <= 7.8e-9;
- the controls: each has a rounded leaf that is not bf16-valued (its f32
  layer's kernel gradient), and a leaf with >= 13.8% of its elements
  more than one ulp apart; f32 arrays >= 2.1e-3; the opponents' f32
  tower >= 2.3e-3.

The same readings with ``torch.set_num_threads(4)``: unchanged. The
norm-wise reading alone on every array would separate the two by 1.7x
only (the port's CNN first-conv gradient 1.2e-3 from its flips, the
controls >= 2.1e-3), so a rounded leaf takes the ulp reading.

One update (8 Adam steps on bf16-rounded gradients) is held at |port -
JAX| <= tol (|JAX| + max |JAX|) (``bf16_close``): a flipped gradient
rounding moves one Adam step by 2^-8, ~1e-5 of a parameter, far under
the limits: the parameters ``UPDATE_TOL`` = 2^-9, port <= 9.9e-4, the
f32 update >= 3.4e-3; the updated networks' logits and values and the
update's losses 2^-8 (port <= 1.8e-3), the parameters alone tell the
control apart.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from burn_ppo_tpu.models import core as jcore  # noqa: E402
from burn_ppo_tpu.models import network as jnetwork  # noqa: E402
from burn_ppo_tpu.models.network import ActorCriticNetwork as JaxNetwork  # noqa: E402
from burn_ppo_tpu.ppo import update as ju  # noqa: E402
from burn_ppo_tpu.ppo.normalization import ObsNormState as JaxObsNorm  # noqa: E402
from burn_ppo_tpu.ppo.normalization import obs_norm_apply as jax_obs_norm_apply  # noqa: E402
from burn_ppo_torch import cli  # noqa: E402
from burn_ppo_torch.config import Config  # noqa: E402
from burn_ppo_torch.convert import params_from_jax, params_to_jax, tree_leaves  # noqa: E402
from burn_ppo_torch.models import core as tcore  # noqa: E402
from burn_ppo_torch.models import network as tnetwork  # noqa: E402
from burn_ppo_torch.models.network import ActorCriticNetwork  # noqa: E402
from burn_ppo_torch.ppo import update as tu  # noqa: E402
from burn_ppo_torch.ppo.normalization import ObsNormState  # noqa: E402
from burn_ppo_torch.ppo.pool_rollout import (  # noqa: E402
    OpponentStack,
    actor_params,
    opponent_actor_forward,
    opponent_actor_forward_plain,
)
from burn_ppo_torch.train import Trainer  # noqa: E402
from tests.test_torch_update import ReplaySource  # noqa: E402

BF16 = "bfloat16"
F32_RTOL, F32_ATOL = 1e-5, 1e-5
ULP_RTOL = 2.0**-7  # one bf16 ulp of a rounded sum
NORM_TOL = 2.0**-10.5  # an f32 output or gradient: |port - JAX| / |JAX|
ULP_SHARE = 1 / 12  # a rounded leaf: its share of elements over one bf16 ulp from JAX's
UPDATE_TOL = 2.0**-9  # the parameters after one update
UPDATED_TOL = 2.0**-8  # the updated network's outputs, the update's losses


def rel_err(a, b) -> float:
    """max |a - b| / (|b| + max |b|)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = float(np.max(np.abs(b))) if b.size else 0.0
    return float(np.max(np.abs(a - b) / (np.abs(b) + scale))) if scale else float(
        np.max(np.abs(a - b), initial=0.0))


def bf16_close(a, b, tol, what=""):
    """|a - b| <= tol (|b| + max |b|)."""
    err = rel_err(a, b)
    assert err <= tol, f"{what}: {err:.3g} of the scale, over {tol:.3g}"


def norm_err(a, b) -> float:
    """|a - b| / |b| in the 2-norm (|a - b| where b is 0)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = float(np.linalg.norm(b))
    return float(np.linalg.norm(a - b)) / (scale or 1.0)


def is_bf16(a) -> bool:
    a = np.asarray(a, np.float32)
    return bool(np.array_equal(a, a.astype(jnp.bfloat16).astype(np.float32)))


def ulp_share(a, b) -> float:
    """The share of elements of a and b (each rounded to bf16) more than
    one bf16 ulp apart: their distance in steps of the bf16 number line."""
    def ordinal(x):
        u = np.asarray(x, np.float32).astype(jnp.bfloat16).view(np.uint16).astype(np.int64)
        return np.where(u & 0x8000, -(u & 0x7FFF), u)

    return float(np.mean(np.abs(ordinal(a) - ordinal(b)) > 1))


def bf16_disagreement(a, b, rounded: bool) -> str:
    """Why ``a`` does not hold as the bf16 computation of ``b`` ("" where
    it does): a rounded leaf must be bf16-valued with at most ULP_SHARE of
    its elements over one ulp from b's, an f32 array within NORM_TOL."""
    if rounded:
        if not is_bf16(a):
            return "not bf16 values"
        share = ulp_share(a, b)
        return f"{share:.3g} of the elements over one bf16 ulp" if share > ULP_SHARE else ""
    err = norm_err(a, b)
    return f"{err:.3g} of the norm, over {NORM_TOL:.3g}" if err > NORM_TOL else ""


def bf16_agrees(got, want, rounded, what):
    for a, b, r, w in zip(got, want, rounded, what):
        why = bf16_disagreement(a, b, r)
        assert not why, f"{w}: {why}"


def bf16_fails(got, want, rounded) -> bool:
    """Whether a control fails ``bf16_agrees``."""
    return any(bf16_disagreement(a, b, r) for a, b, r in zip(got, want, rounded))


def dyadic(rng, shape):
    """f32 values k / 64, |k| < 600: some need 10 significant bits, so
    the bf16 rounding is exercised, and the rounded values' products are
    multiples of 2^-12 under 88, so a sum of up to 32 of them is exact in
    f32 in any order."""
    return (rng.integers(-599, 600, size=shape) / 64).astype(np.float32)


# ---------------------------------------------------------------------------
# One layer
# ---------------------------------------------------------------------------
def linear(k: np.ndarray, b: np.ndarray) -> torch.nn.Linear:
    lin = torch.nn.Linear(*k.shape)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(k.T))
        lin.bias.copy_(torch.from_numpy(b))
    return lin


def dense_both(x, k, b, G):
    """(JAX's y, d/dkernel, d/dbias, d/dx) and the port's, of sum(y * G)."""
    f = lambda p, xx: (jcore.dense(p, xx, jnp.bfloat16) * G).sum()  # noqa: E731
    p = {"kernel": jnp.asarray(k), "bias": jnp.asarray(b)}
    jy = np.asarray(jcore.dense(p, jnp.asarray(x), jnp.bfloat16))
    jg, jgx = jax.grad(f, argnums=(0, 1))(p, jnp.asarray(x))
    lin = linear(k, b)
    tx = torch.from_numpy(x).requires_grad_()
    ty = tcore.dense(lin, tx, BF16)
    (ty * torch.from_numpy(G)).sum().backward()
    return ((jy, np.asarray(jg["kernel"]), np.asarray(jg["bias"]), np.asarray(jgx)),
            (ty.detach().numpy(), lin.weight.grad.numpy().T, lin.bias.grad.numpy(),
             tx.grad.numpy()))


def test_dense_bf16_on_exact_sums_equals_jax_bit_for_bit():
    rng = np.random.default_rng(0)
    x, k = dyadic(rng, (32, 32)), dyadic(rng, (32, 24))
    b, G = dyadic(rng, (24,)), dyadic(rng, (32, 24))
    j, t = dense_both(x, k, b, G)
    for name, a, ref in zip(("y", "kernel", "bias", "x"), t, j):
        np.testing.assert_array_equal(a, ref, err_msg=name)
    # the roundings are exercised: x and the kernel are not bf16 values,
    # nor are the gradients before their rounding
    assert not np.array_equal(x, x.astype(jnp.bfloat16).astype(np.float32))
    assert not np.array_equal(k, k.astype(jnp.bfloat16).astype(np.float32))
    with torch.no_grad():
        unrounded = torch.from_numpy(G) @ torch.from_numpy(k.astype(jnp.bfloat16)
                                                          .astype(np.float32)).T
    assert not np.array_equal(unrounded.numpy(), t[3])


@pytest.mark.parametrize("B,I,O", [(64, 37, 48), (128, 270, 256), (33, 512, 49)])
def test_dense_bf16_forward_and_grads_match_jax(B, I, O):
    rng = np.random.default_rng(B + I + O)
    x = rng.normal(size=(B, I)).astype(np.float32)
    k = (rng.normal(size=(I, O)) / np.sqrt(I)).astype(np.float32)
    b, G = rng.normal(size=(O,)).astype(np.float32), rng.normal(size=(B, O)).astype(np.float32)
    (jy, jk, jb, jx), (ty, tk, tb, tx) = dense_both(x, k, b, G)
    np.testing.assert_allclose(ty, jy, rtol=F32_RTOL, atol=F32_ATOL)
    np.testing.assert_allclose(tb, jb, rtol=F32_RTOL, atol=F32_ATOL)  # an f32 sum of g
    np.testing.assert_allclose(tk, jk, rtol=ULP_RTOL, atol=1e-6)
    np.testing.assert_allclose(tx, jx, rtol=ULP_RTOL, atol=1e-6)
    # the gradients are bf16 values, widened
    for g in (tk, tx):
        np.testing.assert_array_equal(g, g.astype(jnp.bfloat16).astype(np.float32))


def conv_rule(params, x, compute_dtype=None):
    """JAX's ``conv2d_same`` with a backward JAX 0.9 cannot take for its
    bf16 conv (its transpose mixes the f32 cotangent with a bf16 operand):
    the dense's rule, the f32 conv's vjp at the bf16-rounded operands with
    each cotangent rounded to bf16 and widened. The forward is JAX's own."""
    if compute_dtype is None:
        return jcore.conv2d_same(params, x)

    @jax.custom_vjp
    def conv(k, b, xx):
        return jcore.conv2d_same({"kernel": k, "bias": b}, xx, compute_dtype)

    def fwd(k, b, xx):
        return conv(k, b, xx), (k, xx)

    def bwd(res, g):
        k, xx = res
        rnd = lambda t: t.astype(jnp.bfloat16).astype(jnp.float32)  # noqa: E731
        _, vjp = jax.vjp(lambda kk, xr: jax.lax.conv_general_dilated(
            xr, kk, (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"),
            precision=jax.lax.Precision.HIGHEST), rnd(k), rnd(xx))
        gk, gx = vjp(g)
        return rnd(gk), g.sum((0, 1, 2)), rnd(gx)

    conv.defvjp(fwd, bwd)
    return conv(params["kernel"], params["bias"], x)


def conv_both(x, k, b, G):
    f = lambda p, xx: (conv_rule(p, xx, jnp.bfloat16) * G).sum()  # noqa: E731
    p = {"kernel": jnp.asarray(k), "bias": jnp.asarray(b)}
    jy = np.asarray(jcore.conv2d_same(p, jnp.asarray(x), jnp.bfloat16))
    jg, jgx = jax.grad(f, argnums=(0, 1))(p, jnp.asarray(x))
    kh, kw, ci, co = k.shape
    conv = torch.nn.Conv2d(ci, co, (kh, kw), padding="same")
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(k).permute(3, 2, 0, 1))
        conv.bias.copy_(torch.from_numpy(b))
    tx = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous().requires_grad_()
    ty = tcore.conv2d_same(conv, tx, BF16)
    (ty * torch.from_numpy(G).permute(0, 3, 1, 2)).sum().backward()
    return ((jy, np.asarray(jg["kernel"]), np.asarray(jg["bias"]), np.asarray(jgx)),
            (ty.detach().permute(0, 2, 3, 1).numpy(), conv.weight.grad.permute(2, 3, 1, 0).numpy(),
             conv.bias.grad.numpy(), tx.grad.permute(0, 2, 3, 1).numpy()))


@pytest.mark.parametrize("kernel", [3, 2])
def test_conv_bf16_on_exact_sums_equals_jax_bit_for_bit(kernel):
    """SAME padding with an odd and an even kernel (the odd pixel high)."""
    rng = np.random.default_rng(kernel)
    # sums of at most 32 products: 4 x 8 pixels, 2 in and 3 out channels
    x, k = dyadic(rng, (1, 4, 8, 2)), dyadic(rng, (kernel, kernel, 2, 3))
    b, G = dyadic(rng, (3,)), dyadic(rng, (1, 4, 8, 3))
    j, t = conv_both(x, k, b, G)
    for name, a, ref in zip(("y", "kernel", "bias", "x"), t, j):
        np.testing.assert_array_equal(a, ref, err_msg=name)


def test_conv_bf16_forward_and_grads_match_jax():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(16, 6, 7, 2)).astype(np.float32)
    k = (rng.normal(size=(3, 3, 2, 16)) / 4).astype(np.float32)
    b, G = rng.normal(size=(16,)).astype(np.float32), rng.normal(size=(16, 6, 7, 16)).astype(np.float32)
    (jy, jk, jb, jx), (ty, tk, tb, tx) = conv_both(x, k, b, G)
    np.testing.assert_allclose(ty, jy, rtol=F32_RTOL, atol=F32_ATOL)
    np.testing.assert_allclose(tb, jb, rtol=F32_RTOL, atol=1e-4)  # a 672-term f32 sum of g
    np.testing.assert_allclose(tk, jk, rtol=ULP_RTOL, atol=1e-5)
    np.testing.assert_allclose(tx, jx, rtol=ULP_RTOL, atol=1e-6)


# ---------------------------------------------------------------------------
# Networks and the PPO loss's gradients
# ---------------------------------------------------------------------------
OBS, A = 10, 5
CNN_SHAPE = (6, 7, 2)


def net_pair(kind: str, split: bool = False, seed: int = 0):
    kw = dict(network_type=kind, hidden_size=32, num_hidden=2, activation="tanh",
              split_networks=split, compute_dtype=BF16)
    obs_dim = OBS
    if kind == "ctde":
        kw.update(privileged_obs_dim=6, critic_hidden_size=48, critic_num_hidden=2)
    if kind == "cnn":
        obs_dim = int(np.prod(CNN_SHAPE)) + 3
        kw.update(obs_shape=CNN_SHAPE, num_conv_layers=2, conv_channels=(8, 8), kernel_size=3,
                  cnn_fc_hidden_size=32, cnn_num_fc_layers=1, activation="relu")
    jnet = JaxNetwork(obs_dim=obs_dim, action_count=A, **kw)
    jparams = jax.tree_util.tree_map(np.asarray, jnet.init(jax.random.PRNGKey(seed)))
    tnet = ActorCriticNetwork(obs_dim, A, generator=torch.Generator().manual_seed(1), **kw)
    tnet.load_state_dict(params_from_jax(jparams))
    return jnet, jparams, tnet


def batch(jnet, jparams, n: int, seed: int, priv: bool):
    rng = np.random.default_rng(seed)
    obs = rng.normal(size=(n, jnet.obs_dim)).astype(np.float32)
    masks = (rng.random((n, A)) < 0.7).astype(np.float32)
    masks[:, 0] = 1.0
    data = {"obs": obs, "action_masks": masks,
            "actions": np.array([rng.choice(np.flatnonzero(m)) for m in masks], np.int32)}
    if priv:
        data["privileged_obs"] = rng.normal(size=(n, 6)).astype(np.float32)
    logits, values = jnet.policy_and_value(jparams, jnp.asarray(obs),
                                           jnp.asarray(data["privileged_obs"]) if priv else None)
    logp = jax.nn.log_softmax(logits + jnp.where(masks > 0, 0.0, -1e9), axis=-1)
    data.update(
        old_log_probs=(np.asarray(logp)[np.arange(n), data["actions"]]
                       + rng.normal(0, 0.05, n)).astype(np.float32),
        advantages=rng.normal(0.3, 2.0, n).astype(np.float32),
        returns=rng.normal(1.0, 1.0, n).astype(np.float32),
        old_values=(np.asarray(values) + rng.normal(0, 0.3, n)).astype(np.float32),
        valid=np.ones(n, np.float32))
    return data


def torch_data(data):
    return {k: torch.from_numpy(np.array(v)) for k, v in data.items()}


NETS = [("mlp", False), ("mlp", True), ("ctde", False), ("cnn", False)]


@pytest.fixture
def jax_cnn_rule(monkeypatch):
    """JAX's networks with ``conv_rule`` for their convs."""
    monkeypatch.setattr(jnetwork, "conv2d_same", conv_rule)


def port_outputs(tnet, data, kind):
    """The port's logits, values, PPO loss and loss gradients (in JAX's
    leaf order) on one batch."""
    priv = torch.from_numpy(data["privileged_obs"]) if kind == "ctde" else None
    with torch.no_grad():
        tl, tv = tnet(torch.from_numpy(data["obs"]), priv)
    t_loss, _ = tu.minibatch_loss(tnet, torch_data(data), torch.tensor(0.01),
                                  tu.PPOUpdateConfig(clip_value=True),
                                  tu.LossBook.create(torch.device("cpu")))
    names = [k for k, _ in tnet.named_parameters()]
    t_grads = torch.autograd.grad(t_loss, list(tnet.parameters()))
    return ([tl.numpy(), tv.numpy(), t_loss.item()]
            + tree_leaves(params_to_jax(dict(zip(names, t_grads)))))


def one_layer_in_f32(monkeypatch, tnet, kind, split):
    """Leave one layer of a bf16 network in f32 (a control): the shared
    MLP's policy head, the split MLP's value head, the CTDE critic's first
    layer, the CNN's first conv."""
    if kind == "cnn":
        conv0, conv = tnet.conv_layers[0], tnetwork.conv2d_same
        monkeypatch.setattr(tnetwork, "conv2d_same",
                            lambda c, x, dt=None: c(x) if c is conv0 else conv(c, x, dt))
        return
    if kind == "ctde":
        module, layer = tcore, tnet.critic_layers[0]
    else:
        module, layer = tnetwork, tnet.value_head if split else tnet.policy_head
    dense = module.dense
    monkeypatch.setattr(module, "dense",
                        lambda m, x, dt=None: m(x) if m is layer else dense(m, x, dt))


@pytest.mark.parametrize("kind,split", NETS)
def test_network_forward_and_loss_gradients_match_jax(kind, split, jax_cnn_rule, monkeypatch):
    jnet, jparams, tnet = net_pair(kind, split)
    data = batch(jnet, jparams, 96, seed=5, priv=kind == "ctde")
    jl, jv = jax.jit(jnet.policy_and_value)(
        jparams, jnp.asarray(data["obs"]),
        jnp.asarray(data["privileged_obs"]) if kind == "ctde" else None)
    jcfg = ju.PPOUpdateConfig(clip_value=True)
    grad_fn = jax.value_and_grad(ju._minibatch_loss, has_aux=True)
    (j_loss, _), j_grads = jax.jit(lambda p, mb: grad_fn(p, jnet, mb, None, 0.01, jcfg))(
        jparams, {k: jnp.asarray(v) for k, v in data.items()})
    leaves = jax.tree_util.tree_flatten_with_path(j_grads)[0]
    want = [jl, jv, float(j_loss)] + [np.asarray(b) for _, b in leaves]
    what = ["logits", "values", "loss"] + [jax.tree_util.keystr(p) for p, _ in leaves]
    # the dense and conv kernels' gradients are rounded to bf16 on both sides
    rounded = [False] * 3 + ["kernel" in w for w in what[3:]]
    got = port_outputs(tnet, data, kind)
    assert len(got) == len(want) and any(rounded)
    assert all(is_bf16(b) for b, r in zip(want, rounded) if r)
    bf16_agrees(got, want, rounded, what)
    # the controls fail the same measure: the network in f32, one layer in f32
    tnet.compute_dtype = None
    f32 = port_outputs(tnet, data, kind)
    tnet.compute_dtype = BF16
    with monkeypatch.context() as m:
        one_layer_in_f32(m, tnet, kind, split)
        one = port_outputs(tnet, data, kind)
    for control in (f32, one):
        assert bf16_fails(control, want, rounded)


def test_bf16_differs_from_f32():
    """The compute dtype is not a no-op: the same parameters give other
    outputs in f32, by about bf16's rounding (2^-9 relative), far more
    than f32's."""
    _, _, tnet = net_pair("mlp")
    obs = torch.from_numpy(np.random.default_rng(3).normal(size=(64, OBS)).astype(np.float32))
    with torch.no_grad():
        bf = tnet(obs)
        tnet.compute_dtype = None
        f32 = tnet(obs)
    for a, b in zip(bf, f32):
        assert 1e-4 < float((a - b).abs().max() / b.abs().max()) < 2.0**-5


# ---------------------------------------------------------------------------
# The opponents' plain forward (K7's plain version on a bf16 stack)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("normed", [False, True])
def test_plain_opponent_forward_bf16_matches_jax_vmap(normed):
    K, Ep, D, H = 3, 40, 12, 32
    jnet = JaxNetwork(network_type="mlp", obs_dim=D, action_count=7, hidden_size=H,
                      num_hidden=2, activation="relu", compute_dtype=BF16)
    tnets, jps = [], []
    for i in range(K):
        jp = jax.tree_util.tree_map(np.asarray, jnet.init(jax.random.PRNGKey(10 + i)))
        t = ActorCriticNetwork(D, 7, hidden_size=H, num_hidden=2, activation="relu",
                               compute_dtype=BF16, generator=torch.Generator().manual_seed(i))
        t.load_state_dict(params_from_jax(jp))
        tnets.append(t)
        jps.append(jp)
    rng = np.random.default_rng(normed)
    obs = (rng.normal(size=(Ep, D)) * 3 + 1).astype(np.float32)
    slot = rng.integers(-1, K + 1, Ep).astype(np.int32)  # outside [0, K): zeros
    norms = None
    if normed:
        counts = np.array([5.0, 1.0, 300.0], np.float32)  # slot 1: the identity (count < 2)
        norms = [ObsNormState(mean=torch.from_numpy(rng.normal(size=D).astype(np.float32)),
                              m2=torch.from_numpy((rng.random(D) * 50 + 1).astype(np.float32)),
                              count=torch.tensor(c)) for c in counts]
    stack = OpponentStack.of([actor_params(t, BF16) for t in tnets], norms)
    assert stack.bf16 and all(w.dtype == torch.bfloat16 for w in stack.weights)
    assert stack.biases[0].dtype == torch.float32
    got = opponent_actor_forward(torch.from_numpy(obs), torch.from_numpy(slot), stack)
    assert torch.equal(got, opponent_actor_forward_plain(torch.from_numpy(obs),
                                                         torch.from_numpy(slot), stack))
    assert opponent_actor_forward.launches == 0

    stacked = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *jps)

    def one(p, n):
        x = jnp.asarray(obs) if n is None else jax_obs_norm_apply(n, jnp.asarray(obs), 10.0)
        return jnet.forward_actor(p, x)

    if normed:
        jn = JaxObsNorm(mean=jnp.stack([n.mean.numpy() for n in norms]),
                        m2=jnp.stack([n.m2.numpy() for n in norms]), count=jnp.asarray(counts))
        logits_k = jax.vmap(one)(stacked, jn)
    else:
        logits_k = jax.vmap(lambda p: one(p, None))(stacked)
    onehot = jax.nn.one_hot(slot, K)
    want = np.asarray(jnp.einsum("kea,ek->ea", logits_k, onehot))
    bf16_agrees([got.numpy()], [want], [False], ["logits"])
    # the control fails the same measure: the f32 tower on the bf16-rounded
    # weights (the activations not rounded)
    f32 = dataclasses.replace(stack, weights=[w.float() for w in stack.weights])
    control = opponent_actor_forward_plain(torch.from_numpy(obs), torch.from_numpy(slot), f32)
    assert bf16_fails([control.numpy()], [want], [False])


# ---------------------------------------------------------------------------
# One update on the same batch
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["mlp", "ctde"])
def test_one_bf16_update_matches_jax(kind):
    jnet, jparams, tnet = net_pair(kind, seed=2)
    _, _, control = net_pair(kind, seed=2)
    control.compute_dtype = None  # the f32 update from the same parameters
    n, nmb, epochs, lr = 64, 4, 2, 3e-3
    data = batch(jnet, jparams, n, seed=11, priv=kind == "ctde")
    kw = dict(num_minibatches=nmb, num_epochs=epochs, max_grad_norm=0.5, clip_value=True,
              shuffle_block_rows=1)
    jcfg, tcfg = ju.PPOUpdateConfig(**kw), tu.PPOUpdateConfig(**kw)
    tx = ju.make_optimizer(jcfg)
    key = jax.random.PRNGKey(n)
    j_params, _, _, j_m = jax.jit(
        lambda p, o, d, k: ju.ppo_update(jnet, tx, p, o, d, None, k, lr, 0.01, jcfg))(
        jparams, tx.init(jparams), {k: jnp.asarray(v) for k, v in data.items()}, key)
    perms = [jax.random.permutation(k, n) for k in jax.random.split(key, epochs)]
    t_m, _ = (tu.ppo_update(net, tu.AdamState.create(net), torch_data(data), ReplaySource(perms),
                            torch.tensor(lr), torch.tensor(0.01), tcfg) for net in (tnet, control))
    assert float(t_m["num_minibatch_updates"]) == float(j_m["num_minibatch_updates"]) == 8
    j_leaves = [np.asarray(b) for b in jax.tree_util.tree_leaves(j_params)]
    for i, (a, b) in enumerate(zip(tree_leaves(params_to_jax(tnet.state_dict())), j_leaves)):
        bf16_close(a, b, UPDATE_TOL, f"param leaf {i}")
    assert max(rel_err(a, b) for a, b in zip(
        tree_leaves(params_to_jax(control.state_dict())), j_leaves)) > UPDATE_TOL
    # the updated networks on the same obs (not sampled actions: a near-tie
    # may flip between two bf16 runs)
    priv = jnp.asarray(data["privileged_obs"]) if kind == "ctde" else None
    jl, jv = jnet.policy_and_value(j_params, jnp.asarray(data["obs"]), priv)
    with torch.no_grad():
        tl, tv = tnet(torch.from_numpy(data["obs"]),
                      None if priv is None else torch.from_numpy(data["privileged_obs"]))
    bf16_close(tl.numpy(), jl, UPDATED_TOL, "logits")
    bf16_close(tv.numpy(), jv, UPDATED_TOL, "values")
    for k in ("policy_loss", "value_loss", "entropy"):
        bf16_close(float(t_m[k]), float(j_m[k]), UPDATED_TOL, k)


# ---------------------------------------------------------------------------
# The trainer: every path in bf16
# ---------------------------------------------------------------------------
def tiny(path, **kw):
    lines = {"env": '"connect_four"', "num_envs": 8, "num_steps": 8, "total_steps": 128,
             "hidden_size": 32, "num_hidden": 2, "checkpoint_freq": 64, "log_freq": 64,
             "seed": 3, "num_minibatches": 2, "num_epochs": 1, "compute_dtype": '"bfloat16"',
             "opponent_pool_fraction": 0.25}
    lines.update(kw)
    path.write_text("\n".join(f"{k} = {v}" for k, v in lines.items()) + "\n")
    return path


@pytest.mark.parametrize("name,kw", [
    ("pool_mlp", {}),
    ("cnn_selfplay", {"network_type": '"cnn"', "opponent_pool_fraction": 0.0,
                      "activation": '"relu"'}),
])
def test_bf16_trains_through_the_cli(name, kw, tmp_path):
    run = tmp_path / name
    assert cli.main(["train", "-c", str(tiny(tmp_path / "c.toml", **kw)), "--run-dir", str(run),
                     "--quiet"], device="cpu") == 0
    cfg = Config.load(run / "config.toml")
    assert cfg.compute_dtype == BF16
    assert (run / "checkpoints" / "step_00000128").is_dir()


def test_a_bf16_run_resumes_in_bf16(tmp_path):
    """A bf16 vs-pool run, resumed: the config round trip keeps the compute
    dtype, the restored learner runs in bf16, the pool's rotation stacks
    bf16 towers, and the resumed run trains on (checkpoints are f32, as
    JAX's are)."""
    run = tmp_path / "run"
    assert cli.main(["train", "-c", str(tiny(tmp_path / "c.toml")), "--run-dir", str(run),
                     "--quiet"], device="cpu") == 0
    cfg = Config.load(run / "config.toml")
    tr = Trainer(cfg, run, device="cpu", quiet=True,
                 resume_from=(run / "checkpoints" / "latest").resolve())
    assert tr.state.network.compute_dtype == BF16
    assert all(p.dtype == torch.float32 for p in tr.state.network.parameters())
    stack, names = tr.rotate()
    assert stack.bf16 and names
    assert all(w.dtype == torch.bfloat16 for w in stack.weights)
    assert cli.main(["train", "--resume", str(run), "--total-steps", "192", "--quiet"],
                    device="cpu") == 0
    assert Config.load(run / "config.toml").compute_dtype == BF16
    assert (run / "checkpoints" / "step_00000192").is_dir()

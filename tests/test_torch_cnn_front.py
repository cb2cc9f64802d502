"""K20, the CNN opponents' conv front, on the CPU: its plain version
(``opponent_cnn_front_plain``, each row's own slot's normalisation and
conv stack, the last conv before its relu, [Ep, C', H, W]) against JAX's
per-slot stack (``obs_norm_apply``, then ``_cnn_features``' NHWC
reshape and ``conv2d_same`` layers with relu between them, every slot
over every row), selected per row; and the config-time refusal of a
stack past the kernel's limits.

Tolerances: f32 on both sides at full precision, rtol 1e-5 / atol 1e-5:
the sums of 18 to 144 f32 products a conv output (XLA's conv and
PyTorch's CPU conv add them in other orders). bf16 (each conv's input
rounded to bf16, the weights bf16 values, f32 products and sums) by
``tests/test_torch_bf16.py``'s measure for an f32 array (``bf16_agrees``:
|port - JAX| / |JAX| <= 2^-10.5 in the 2-norm): a sum in another order
can land an inter-layer value on the other side of a bf16 rounding, one
ulp apart, which the next layer carries; the f32 front of the same
weights (no rounding at all), the control, fails it, and so does the
front that rounds the normalised obs but not the relu outputs between
the layers (the control of K20's bf16 check on the card)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from burn_ppo_tpu.models.core import conv2d_same  # noqa: E402
from burn_ppo_tpu.models.network import ActorCriticNetwork as JaxNetwork  # noqa: E402
from burn_ppo_tpu.ppo.normalization import ObsNormState as JaxObsNorm  # noqa: E402
from burn_ppo_tpu.ppo.normalization import obs_norm_apply as jax_obs_norm_apply  # noqa: E402
from burn_ppo_torch.config import Config  # noqa: E402
from burn_ppo_torch.convert import params_from_jax  # noqa: E402
from burn_ppo_torch.models.network import ActorCriticNetwork  # noqa: E402
from burn_ppo_torch.ppo.normalization import ObsNormState  # noqa: E402
from burn_ppo_torch.ppo.pool_rollout import (  # noqa: E402
    OpponentStack,
    actor_params,
    cnn_front_problems,
    opponent_cnn_front,
    opponent_cnn_front_plain,
)
from burn_ppo_torch.train import unsupported_config  # noqa: E402
from tests.test_torch_bf16 import bf16_agrees, bf16_fails  # noqa: E402

F32_RTOL, F32_ATOL = 1e-5, 1e-5
SHAPE, D, A, K = (6, 7, 2), 86, 7, 4
# The default stack, one layer of 5 x 5 kernels, three layers of [16, 4, 8].
STACKS = {"default_8x8_k3": ((8, 8), 3), "one_layer_k5": ((6,), 5),
          "three_layers_16_4_8_k3": ((16, 4, 8), 3)}


def _nets(channels, kernel, seed):
    """K JAX-initialised Connect Four CNNs of this conv stack with random
    biases, and the port's networks loaded from them."""
    kw = dict(obs_shape=SHAPE, num_conv_layers=len(channels), conv_channels=channels,
              kernel_size=kernel, activation="relu")
    jnet = JaxNetwork(network_type="cnn", obs_dim=D, action_count=A, **kw)
    rng = np.random.default_rng(seed)
    jps, tnets = [], []
    for k in range(K):
        p = jax.tree_util.tree_map(np.asarray, jnet.init(jax.random.PRNGKey(seed + k)))
        p = jax.tree_util.tree_map(
            lambda x: (x + (rng.normal(size=x.shape) * 0.1 if x.ndim == 1 else 0)).astype(np.float32),
            p)
        t = ActorCriticNetwork(D, A, network_type="cnn", generator=torch.Generator().manual_seed(k),
                               **kw)
        t.load_state_dict(params_from_jax(p))
        jps.append(p)
        tnets.append(t)
    return jps, tnets


def _norms(seed):
    """Obs normalisers at counts 5, 1 (the identity), 300 and 0 (the
    identity)."""
    rng = np.random.default_rng(seed)
    return [ObsNormState(mean=torch.from_numpy(rng.normal(size=D).astype(np.float32)),
                         m2=torch.from_numpy((rng.random(D) * 50 + 1).astype(np.float32)),
                         count=torch.tensor(c)) for c in (5.0, 1.0, 300.0, 0.0)]


def _inputs(seed, Ep=45):
    """Raw obs, and slots: every slot's rows, then -1 and K (zeros)."""
    rng = np.random.default_rng(seed)
    obs = (rng.normal(size=(Ep, D)) * 2 + 0.5).astype(np.float32)
    slot = rng.integers(0, K, Ep).astype(np.int32)
    slot[:K] = np.arange(K)
    slot[K:K + 2] = [-1, K]
    return obs, slot


def _jax_front(jps, norms, obs, slot, compute_dtype):
    """JAX's stack for every slot over every row (the obs normalised by
    the slot, the spatial slice as NHWC, each ``conv2d_same`` with relu
    between them), the last conv before its relu as NCHW; each row its
    slot's, zeros outside [0, K)."""
    cd = jnp.bfloat16 if compute_dtype == "bfloat16" else None
    H, W, C = SHAPE
    out = np.zeros((obs.shape[0], jps[0]["conv_layers"][-1]["bias"].shape[0], H, W), np.float32)
    for k, p in enumerate(jps):
        x = jnp.asarray(obs)
        if norms is not None:
            n = norms[k]
            x = jax_obs_norm_apply(JaxObsNorm(mean=jnp.asarray(n.mean.numpy()),
                                              m2=jnp.asarray(n.m2.numpy()),
                                              count=jnp.asarray(n.count.numpy())), x, 10.0)
        h = x[:, :H * W * C].reshape(-1, H, W, C)
        layers = p["conv_layers"]
        for i, layer in enumerate(layers):
            h = conv2d_same(layer, h, cd)
            if i < len(layers) - 1:
                h = jax.nn.relu(h)
        rows = slot == k
        out[rows] = np.asarray(h).transpose(0, 3, 1, 2)[rows]
    return out


@pytest.mark.parametrize("stack_name", list(STACKS))
@pytest.mark.parametrize("normed", [False, True])
@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
def test_cnn_front_plain_matches_jax_per_slot_stack(stack_name, normed, compute_dtype):
    """K20's plain version against JAX's per-slot conv stack, each row its
    own slot, rows of slot -1 and K zeros; the wrapper on CPU tensors is
    the plain version and launches nothing. In bf16 both controls fail."""
    channels, kernel = STACKS[stack_name]
    seed = 10 * len(channels) + kernel + 2 * normed
    jps, tnets = _nets(channels, kernel, seed)
    norms = _norms(seed) if normed else None
    obs, slot = _inputs(seed)
    want = _jax_front(jps, norms, obs, slot, compute_dtype)
    stack = OpponentStack.of([actor_params(t, compute_dtype) for t in tnets], norms)
    t_obs, t_slot = torch.from_numpy(obs), torch.from_numpy(slot)
    got = opponent_cnn_front_plain(t_obs, t_slot, stack)
    assert got.shape == (45, channels[-1], 6, 7) and got.dtype == torch.float32
    assert not got[K:K + 2].any() and np.abs(want[K + 2:]).max() > 0.1
    before = opponent_cnn_front.launches
    assert torch.equal(opponent_cnn_front(t_obs, t_slot, stack), got)
    assert opponent_cnn_front.launches == before
    if compute_dtype is None:
        np.testing.assert_allclose(got.numpy(), want, rtol=F32_RTOL, atol=F32_ATOL)
        return
    bf16_agrees([got.numpy()], [want], [False], [stack_name])
    f32 = dataclasses.replace(stack, weights=[w.float() for w in stack.weights])
    assert not f32.bf16
    assert bf16_fails([opponent_cnn_front_plain(t_obs, t_slot, f32).numpy()], [want], [False])
    if len(channels) > 1:
        # the chip check's control: the normalised obs rounded, the relu
        # outputs between the layers not
        control = opponent_cnn_front_plain(t_obs, t_slot, stack, round_between=False)
        assert bf16_fails([control.numpy()], [want], [False])


def test_cnn_front_limits_are_the_kernels():
    """The config-time refusal's limits are K20's own: the MAX_ constants
    of csrc/opponent_cnn_front.cu and csrc/slot_tiles.cuh."""
    import re
    from pathlib import Path

    from burn_ppo_torch.ppo import pool_rollout as pr

    csrc = Path(pr.__file__).resolve().parent.parent / "csrc"
    text = (csrc / "opponent_cnn_front.cu").read_text() + (csrc / "slot_tiles.cuh").read_text()
    limits = {m.group(1): int(m.group(2))
              for m in re.finditer(r"constexpr int (MAX_\w+) = (\d+);", text)}
    assert (limits["MAX_LAYERS"], limits["MAX_CHANNELS"], limits["MAX_KS"],
            limits["MAX_PLANE"], limits["MAX_SLOTS"]) == (
        pr._CNN_MAX_LAYERS, pr._CNN_MAX_CHANNELS, pr._CNN_MAX_KERNEL, pr._CNN_MAX_PLANE,
        pr._OPP_MAX_SLOTS)


def test_cnn_front_limits():
    """What K20 takes: 1-4 conv layers of 1-32 channels, kernels 1-5 on a
    padded plane of at most 256 cells, 1-128 slots."""
    assert cnn_front_problems(SHAPE, [2, 8, 8], 3, 8) == []
    assert cnn_front_problems(SHAPE, [2, 32, 32, 32, 12], 5, 128) == []
    assert cnn_front_problems(SHAPE, [2] + [8] * 5, 3, 8) == ["5 conv layers (1 to 4)"]
    assert cnn_front_problems(SHAPE, [2, 33], 3, 8) == ["conv channels [2, 33] (1 to 32)"]
    assert cnn_front_problems(SHAPE, [2, 8], 6, 8) == ["kernel size 6 (1 to 5)"]
    assert cnn_front_problems((14, 14, 2), [2, 8], 5, 8) == [
        "a 14 x 14 board with 5 x 5 kernels (a padded plane of at most 256 cells)"]
    assert cnn_front_problems(SHAPE, [2, 8], 3, 129) == ["129 slots (1 to 128)"]


@pytest.mark.parametrize("over", [{"conv_channels": [64, 8]}, {"kernel_size": 7},
                                  {"num_conv_layers": 5, "conv_channels": [8]}])
def test_a_conv_stack_past_k20s_limits_is_refused_against_the_pool(over):
    """A CNN whose conv stack K20 does not take (a 64-channel layer, 7 x 7
    kernels, five layers) is refused against the pool naming ROADMAP
    A12e, though K7's feature front takes its tower; in pure self-play it
    runs."""
    cfg = Config(env="connect_four", opponent_pool_fraction=0.25, network_type="cnn", **over)
    reason = unsupported_config(cfg)
    assert reason is not None and "ROADMAP A12e" in reason and "K20" in reason
    assert unsupported_config(dataclasses.replace(cfg, opponent_pool_fraction=0.0)) is None

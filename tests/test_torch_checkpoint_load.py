"""Loading a checkpoint into the port without JAX, for inference: the
shipped Connect Four gauntlet checkpoint against the JAX package's own
loader, and the port's save -> load round trip for the CNN."""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from burn_ppo_tpu.checkpoint import CheckpointManager as JaxCheckpoints  # noqa: E402
from burn_ppo_tpu.ppo.normalization import obs_norm_apply as jax_obs_norm_apply  # noqa: E402
from burn_ppo_torch.checkpoint import (  # noqa: E402
    CheckpointManager,
    build_metadata,
    load_model,
    load_obs_normalizer,
    model_leaves,
)
from burn_ppo_torch.envs.base import EpisodeAccumulator  # noqa: E402
from burn_ppo_torch.envs.connect_four import ConnectFour  # noqa: E402
from burn_ppo_torch.models.network import ActorCriticNetwork  # noqa: E402
from burn_ppo_torch.ppo.normalization import obs_norm_apply  # noqa: E402

R4 = Path(__file__).resolve().parent.parent / "gauntlet" / "connect_four" / "r4"


def _positions(n: int, seed: int = 0) -> np.ndarray:
    """Obs of n positions reached by random legal play."""
    rng = np.random.default_rng(seed)
    env = ConnectFour()
    E = 32
    state = env.reset(torch.empty(E, 0))
    acc = EpisodeAccumulator.zero(E, 2, torch.device("cpu"))
    out = []
    while sum(len(o) for o in out) < n:
        mask = env.action_mask(state).numpy()
        actions = np.array([rng.choice(np.flatnonzero(m)) for m in mask], np.int32)
        step = env.step_autoreset(state, acc, torch.from_numpy(actions), torch.empty(E, 0))
        out.append(step.obs.numpy())
        state, acc = step.state, step.acc
    return np.concatenate(out)[:n]


def test_gauntlet_r4_forward_matches_jax():
    net, meta = load_model(R4)
    norm = load_obs_normalizer(R4)
    assert meta["hidden_size"] == 512 and meta["activation"] == "tanh" and norm is not None
    jnet, jparams, _ = JaxCheckpoints.load_model(R4)
    jnorm = JaxCheckpoints.load_obs_normalizer(R4)
    for f in ("mean", "m2", "count"):  # the leaves in ObsNormState's field order
        np.testing.assert_array_equal(getattr(norm, f).numpy(), np.asarray(getattr(jnorm, f)))
    obs = _positions(256)
    assert len({o.tobytes() for o in obs}) > 100
    j_logits, j_values = jnet.forward(jparams, jax_obs_norm_apply(jnorm, obs))
    with torch.no_grad():
        t_logits, t_values = net(obs_norm_apply(norm, torch.from_numpy(obs)))
    # f32 on both sides at full matmul precision (512-wide layers): atol 1e-5.
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), rtol=0, atol=1e-5)
    np.testing.assert_allclose(t_values.numpy(), np.asarray(j_values), rtol=0, atol=1e-5)


@pytest.mark.parametrize("split", [False, True])
def test_cnn_checkpoint_round_trip(split, tmp_path):
    net = ActorCriticNetwork(86, 7, network_type="cnn", obs_shape=(6, 7, 2), split_networks=split,
                             conv_channels=(4, 6), num_conv_layers=3,
                             generator=torch.Generator().manual_seed(2))
    meta = build_metadata(step=64, env_name="connect_four", network=net, num_players=2)
    path = CheckpointManager(tmp_path).save(64, model_leaves(net), [], {}, meta)
    back, meta_back = load_model(path)
    assert meta_back == meta and load_obs_normalizer(path) is None
    for (k, a), (k2, b) in zip(net.state_dict().items(), back.state_dict().items()):
        assert k == k2
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    # The JAX package reads the same file into its own templates.
    jnet, params, _ = JaxCheckpoints.load_model(path)
    template = jnet.init(jax.random.PRNGKey(0))
    for a, b in zip(jax.tree_util.tree_leaves(params), jax.tree_util.tree_leaves(template)):
        assert a.shape == b.shape

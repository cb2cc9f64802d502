"""The CNN against the opponent pool (Connect Four, A12b) of the port
against the JAX package on the CPU: the CNN opponents' forward
(``opponent_cnn_forward_plain``, and the staged route through K20's and
K7's feature front's plain versions) against JAX's vmap over the
stacked opponents and one-hot selection, in f32 and bf16;
two vs-pool train steps with JAX's random draws replayed; and the
``train`` command against the pool, resumed.

Tolerances: f32 on both sides at full precision, rtol 1e-5 / atol 1e-5
(3 x 3 convs of 2 and 8 channels and a 338-wide FC layer, sums in another
order). The bf16 forward is held by ``tests/test_torch_bf16.py``'s
measure (``bf16_agrees``: logits are an f32 array, |port - JAX| / |JAX|
<= 2^-10.5); the port's f32 opponents on the same parameters, the control,
fail it. The train steps as the MLP's (rtol 1e-4 / atol 1e-5)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from burn_ppo_tpu.config import Config  # noqa: E402
from burn_ppo_tpu.models.network import ActorCriticNetwork as JaxNetwork  # noqa: E402
from burn_ppo_tpu.ppo.normalization import ObsNormState as JaxObsNorm  # noqa: E402
from burn_ppo_tpu.ppo.normalization import obs_norm_apply as jax_obs_norm_apply  # noqa: E402
from burn_ppo_tpu.ppo.pool_rollout import PoolSeating as JaxSeating  # noqa: E402
from burn_ppo_tpu.ppo.rollout import init_rollout_carry as jax_init_carry  # noqa: E402
from burn_ppo_tpu.ppo.update import make_optimizer  # noqa: E402
from burn_ppo_tpu.train import TrainState as JaxTrainState  # noqa: E402
from burn_ppo_tpu.train import _update_cfg, build_network_for_env  # noqa: E402
from burn_ppo_tpu.train import make_pool_train_step as jax_make_pool_step  # noqa: E402
from burn_ppo_torch import cli  # noqa: E402
from burn_ppo_torch.convert import params_from_jax, params_to_jax, tree_leaves  # noqa: E402
from burn_ppo_torch.envs.connect_four import ConnectFour  # noqa: E402
from burn_ppo_torch.models.network import ActorCriticNetwork  # noqa: E402
from burn_ppo_torch.ppo.normalization import ObsNormState  # noqa: E402
from burn_ppo_torch.ppo.pool_rollout import (  # noqa: E402
    OpponentStack,
    PoolSeating,
    actor_params,
    opponent_actor_forward,
    opponent_cnn_forward_plain,
    opponent_cnn_front,
    opponent_features_forward,
)
from burn_ppo_torch.ppo.rollout import init_rollout_carry  # noqa: E402
from burn_ppo_torch.ppo.update import AdamState  # noqa: E402
from burn_ppo_torch.train import TrainState, make_pool_train_step  # noqa: E402
from burn_ppo_torch.train import build_network_for_env as torch_build_network  # noqa: E402
from tests.test_torch_bf16 import bf16_agrees, bf16_fails  # noqa: E402
from tests.test_torch_pool_rollout import (  # noqa: E402
    ACTIVE,
    CPU,
    JENV,
    K,
    L,
    E,
    ReplaySource,
    replay_pool_rollout,
    replay_seating,
)
from tests.test_torch_selfplay_pool_step import LR, ENT, _replay_update  # noqa: E402

F32_RTOL, F32_ATOL = 1e-5, 1e-5
SHAPE, D, A = (6, 7, 2), 86, 7


def _jax_cnn(compute_dtype=None):
    return JaxNetwork(network_type="cnn", obs_dim=D, action_count=A, obs_shape=SHAPE,
                      activation="relu", compute_dtype=compute_dtype)


def _stacks(n, seed, normed, counts=(5.0, 1.0, 300.0)):
    """n JAX-initialised Connect Four CNNs (default shape: convs 2 -> 8 -> 8,
    FC 32, head 7) with random biases, and obs normalisers (one at count 1,
    the identity): the JAX params and norms stacked, and the port's
    networks loaded from them."""
    jnet = _jax_cnn()
    rng = np.random.default_rng(seed)
    jps, tnets, norms = [], [], []
    for i in range(n):
        p = jax.tree_util.tree_map(np.asarray, jnet.init(jax.random.PRNGKey(seed + i)))
        p = jax.tree_util.tree_map(
            lambda x: (x + (rng.normal(size=x.shape) * 0.1 if x.ndim == 1 else 0)).astype(np.float32),
            p)
        t = ActorCriticNetwork(D, A, network_type="cnn", obs_shape=SHAPE, activation="relu",
                               generator=torch.Generator().manual_seed(i))
        t.load_state_dict(params_from_jax(p))
        jps.append(p)
        tnets.append(t)
        norms.append(ObsNormState(
            mean=torch.from_numpy(rng.normal(size=D).astype(np.float32)),
            m2=torch.from_numpy((rng.random(D) * 50 + 1).astype(np.float32)),
            count=torch.tensor(counts[i % len(counts)])) if normed else None)
    return jps, tnets, (norms if normed else None)


def _jax_logits(jnet, jps, norms, obs, slot):
    """burn_ppo_tpu/ppo/pool_rollout.py:126-139 and 171-178: every slot's
    normalisation and CNN over every row, then a one-hot contraction."""
    stacked = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *jps)

    def one(p, n):
        x = jnp.asarray(obs) if n is None else jax_obs_norm_apply(n, jnp.asarray(obs), 10.0)
        return jnet.forward_actor(p, x)

    if norms is None:
        logits_k = jax.vmap(lambda p: one(p, None))(stacked)
    else:
        jn = JaxObsNorm(mean=jnp.stack([n.mean.numpy() for n in norms]),
                        m2=jnp.stack([n.m2.numpy() for n in norms]),
                        count=jnp.stack([n.count.numpy() for n in norms]))
        logits_k = jax.vmap(one)(stacked, jn)
    return np.asarray(jnp.einsum("kea,ek->ea", logits_k, jax.nn.one_hot(slot, len(jps))))


def _inputs(seed, Ep=40, n=3):
    rng = np.random.default_rng(seed)
    obs = (rng.normal(size=(Ep, D)) * 2 + 0.5).astype(np.float32)
    slot = rng.integers(0, n, Ep).astype(np.int32)
    slot[:3] = [-1, n, n + 5]  # outside [0, K): zeros
    return obs, slot


@pytest.mark.parametrize("normed", [False, True])
def test_cnn_opponent_forward_matches_jax(normed):
    """The JAX formulation (``opponent_cnn_forward_plain``) and the staged
    route the card runs (K20, then K7's feature front, each by its plain
    version on the CPU) against JAX's vmap at K = 3."""
    jps, tnets, norms = _stacks(3, 20 + normed, normed)
    obs, slot = _inputs(normed)
    want = _jax_logits(_jax_cnn(), jps, norms, obs, slot)
    stack = OpponentStack.of([actor_params(t) for t in tnets], norms)
    assert stack.cnn and not stack.bf16 and stack.obs_shape == SHAPE
    assert [tuple(w.shape) for w in stack.conv_weights] == [(24, 2, 3, 3), (24, 8, 3, 3)]
    assert [tuple(w.shape) for w in stack.weights] == [(3, 338, 32), (3, 32, 7)]
    t_obs, t_slot = torch.from_numpy(obs), torch.from_numpy(slot)
    plain = opponent_cnn_forward_plain(t_obs, t_slot, stack)
    np.testing.assert_allclose(plain.numpy(), want, rtol=F32_RTOL, atol=F32_ATOL)
    assert not plain[:3].any() and np.abs(want[3:]).max() > 0.05
    before = [w.launches for w in (opponent_cnn_front, opponent_features_forward,
                                   opponent_actor_forward)]
    staged = opponent_actor_forward(t_obs, t_slot, stack)
    np.testing.assert_allclose(staged.numpy(), want, rtol=F32_RTOL, atol=F32_ATOL)
    # CPU tensors launch nothing
    assert [w.launches for w in (opponent_cnn_front, opponent_features_forward,
                                 opponent_actor_forward)] == before
    # each slot is its own network's actor
    for k, t in enumerate(tnets):
        rows = slot == k
        x = t_obs[rows]
        if norms is not None and float(norms[k].count) >= 2:
            x = torch.clamp((x - norms[k].mean) / torch.sqrt(norms[k].m2 / norms[k].count), -10, 10)
        with torch.no_grad():
            np.testing.assert_allclose(t.forward_actor(x).numpy(), want[rows], rtol=F32_RTOL,
                                       atol=F32_ATOL)


@pytest.mark.parametrize("normed", [False, True])
def test_cnn_opponent_forward_bf16_matches_jax(normed):
    """A bf16 stack (``actor_params(net, "bfloat16")``: FC weights bf16,
    conv weights bf16 values) against JAX's bf16 forward under the vmap;
    the f32 stack of the same parameters, the control, fails the measure."""
    jps, tnets, norms = _stacks(3, 30 + normed, normed)
    obs, slot = _inputs(10 + normed)
    want = _jax_logits(_jax_cnn("bfloat16"), jps, norms, obs, slot)
    stack = OpponentStack.of([actor_params(t, "bfloat16") for t in tnets], norms)
    assert stack.bf16 and all(torch.equal(w, w.to(torch.bfloat16).float())
                              for w in stack.conv_weights)
    t_obs, t_slot = torch.from_numpy(obs), torch.from_numpy(slot)
    plain = opponent_cnn_forward_plain(t_obs, t_slot, stack)
    staged = opponent_actor_forward(t_obs, t_slot, stack)
    bf16_agrees([plain.numpy(), staged.numpy()], [want, want], [False, False],
                ["plain", "staged"])
    f32 = OpponentStack.of([actor_params(t) for t in tnets], norms)
    assert bf16_fails([opponent_actor_forward(t_obs, t_slot, f32).numpy()], [want], [False])


def _cnn_cfg():
    return Config(env="connect_four", num_envs=E, num_steps=8, network_type="cnn",
                  activation="relu", normalize_obs=True, seed=0)


def test_two_cnn_pool_train_steps_match_jax():
    """Two fused vs-pool train steps of the Connect Four CNN against JAX's,
    K = 4 slots (3 active), JAX's random draws replayed, as
    ``tests/test_torch_selfplay_pool_step.py`` holds the MLP's."""
    cfg = _cnn_cfg()
    cfg.num_epochs, cfg.num_minibatches = 2, 4
    network = build_network_for_env(JENV, cfg)
    params = network.init(jax.random.PRNGKey(3))
    env = ConnectFour()
    tnet = torch_build_network(env, cfg, torch.Generator().manual_seed(0))
    tnet.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    rng = np.random.default_rng(3)
    mean, m2 = rng.random(D).astype(np.float32), (rng.random(D) * 30).astype(np.float32)
    j_norm = JaxObsNorm(mean=jnp.asarray(mean), m2=jnp.asarray(m2), count=jnp.float32(30.0))
    t_norm = ObsNormState(mean=torch.from_numpy(mean), m2=torch.from_numpy(m2),
                          count=torch.tensor(30.0))
    jps, tnets, norms = _stacks(ACTIVE, 5, True, counts=(40.0, 1.0, 40.0))
    order = list(range(ACTIVE)) + [0] * (K - ACTIVE)  # padded as refresh_rotation pads
    j_opp = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *[jps[i] for i in order])
    j_opp_norm = JaxObsNorm(mean=jnp.stack([norms[i].mean.numpy() for i in order]),
                            m2=jnp.stack([norms[i].m2.numpy() for i in order]),
                            count=jnp.stack([norms[i].count.numpy() for i in order]))
    t_stack = OpponentStack.of([actor_params(tnets[i]) for i in order], [norms[i] for i in order])
    tx = make_optimizer(_update_cfg(cfg))
    k_carry, k_seat, k_update = jax.random.split(jax.random.PRNGKey(11), 3)
    src = ReplaySource()
    replay_seating(src, k_seat, ACTIVE)
    j_seat = JaxSeating.create(E, L, 2, ACTIVE, k_seat)
    t_seat = PoolSeating.create(E, L, 2, ACTIVE, src)
    jstate = JaxTrainState(params=params, opt_state=tx.init(params),
                           carry=jax_init_carry(JENV, E, k_carry), obs_norm=j_norm, popart=None,
                           update_key=k_update)
    tstate = TrainState(network=tnet, opt_state=AdamState.create(tnet),
                        carry=init_rollout_carry(env, E, src, CPU), obs_norm=t_norm)
    j_step = jax.jit(jax_make_pool_step(network, JENV, cfg, tx, L, K))
    t_step = make_pool_train_step(env, cfg, L)
    carry_key, update_key = jstate.carry.key, jstate.update_key
    for _ in range(2):
        carry_key = replay_pool_rollout(src, carry_key, ACTIVE, steps=cfg.num_steps)
        update_key = _replay_update(src, update_key, cfg.num_epochs)
        jstate, j_seat, j_m, j_stats, j_rec = j_step(
            jstate, j_seat, j_opp, j_opp_norm, jnp.float32(LR), jnp.float32(ENT),
            jnp.float32(0.0), jnp.int32(ACTIVE))
        tstate, t_seat, t_m, t_stats, t_rec = t_step(tstate, t_seat, t_stack, ACTIVE, LR, ENT,
                                                     src)
        assert not src.uniforms and not src.ints and not src.perms  # every draw, in order
        assert set(j_m) <= set(t_m)
        for k, v in j_m.items():
            np.testing.assert_allclose(float(t_m[k]), float(v), rtol=1e-4, atol=1e-5, err_msg=k)
        for a, b in zip(tree_leaves(params_to_jax(tstate.network.state_dict())),
                        jax.tree_util.tree_leaves(jstate.params)):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-5)
        for f in ("mean", "m2", "count"):
            np.testing.assert_allclose(getattr(tstate.obs_norm, f).numpy(),
                                       np.asarray(getattr(jstate.obs_norm, f)), rtol=1e-4,
                                       atol=1e-5)
        for f in ("completed", "outcome", "learner_seat", "seat_opp"):
            np.testing.assert_array_equal(getattr(t_rec, f).numpy().astype(np.int32),
                                          np.asarray(getattr(j_rec, f)).astype(np.int32), err_msg=f)
        np.testing.assert_array_equal(t_seat.seat_opp.numpy(), np.asarray(j_seat.seat_opp))
        # the opponents played: pool rows with the opponent to move
        assert L / E < float(t_m["learner_valid_fraction"]) < 1.0


def test_train_command_trains_the_cnn_against_the_pool_and_resumes(tmp_path, capsys):
    """``configs/connect_four.toml --network-type cnn --normalize-obs`` as
    users run it, cut to 16 envs x 16 steps, a checkpoint every update: the
    rotations stack CNN opponents from the checkpoints, the pool's files
    are written, a resume continues the run with its pool, and a fork of
    one of its checkpoints trains on with two updates a rotation."""
    run = tmp_path / "run"
    rc = cli.main(["train", "--config", "configs/connect_four.toml", "--network-type", "cnn",
                   "--num-envs", "16", "--num-steps", "16", "--total-steps", str(3 * 256),
                   "--normalize-obs", "--log-freq", "256", "--checkpoint-freq", "256",
                   "--seed", "5", "--debug-opponents", "--run-dir", str(run)], device="cpu")
    assert rc == 0
    assert capsys.readouterr().out.count("[opponents @ step") == 2
    stats = json.loads((run / "opponent_stats.json").read_text())["opponents"]
    assert [s["name"] for s in stats] == ["step_00000256", "step_00000512"]
    assert sum(s["games_played"] for s in stats) > 0
    assert (run / "rating_games.jsonl").read_text().strip()
    meta = json.loads((run / "checkpoints" / "latest" / "metadata.json").read_text())
    assert meta["network_type"] == "cnn" and meta["step"] == 768
    assert cli.main(["train", "--resume", str(run), "--total-steps", str(4 * 256), "--quiet"],
                    device="cpu") == 0
    stats = json.loads((run / "opponent_stats.json").read_text())["opponents"]
    assert [s["name"] for s in stats] == [f"step_{256 * i:08d}" for i in (1, 2, 3)]
    assert (run / "checkpoints" / "step_00001024").is_dir()
    losses = [json.loads(line)["value"] for line in (run / "metrics.jsonl").read_text().splitlines()
              if json.loads(line).get("name") == "train/policy_loss"]
    assert len(losses) == 4 and all(np.isfinite(losses))
    # a fork of the second checkpoint, two updates a rotation
    fork = tmp_path / "fork"
    assert cli.main(["train", "--fork", str(run / "checkpoints" / "step_00000512"),
                     "--pool-rotation-interval", "2", "--total-steps", str(5 * 256),
                     "--run-dir", str(fork), "--quiet"], device="cpu") == 0
    meta = json.loads((fork / "checkpoints" / "latest" / "metadata.json").read_text())
    assert meta["network_type"] == "cnn" and meta["step"] == 5 * 256
    assert json.loads((fork / "opponent_stats.json").read_text())["opponents"]


@pytest.mark.parametrize("bf16", [False, True])
def test_cnn_wrappers_launch_their_entry_points_once_each(monkeypatch, bf16):
    """The CNN stack's CUDA route with a stand-in kernel library: K20's
    entry once (obs, slot, the normalisers, each conv layer's stacked
    weights and biases, the channels [2, 8, 8], depth 2, kernel 3, H, W,
    the obs width, rows, slots, the bf16 flag), no conv after it, then
    K7's feature-front entry once on K20's output (the stack's packed
    layers, the tower's widths [338, 32, 7], its C' H W = 336 floats a row
    and the spatial width 84), each on its own counter; K7's raw-obs entry
    and counter untouched. A tower wider than K7's 512 columns is refused
    before K7 launches; a conv stack K20's entry refuses (past its limits)
    raises, counts no launch and launches nothing after it."""
    from burn_ppo_torch import kernels
    from tests.test_torch_import import _cuda_path_on_cpu

    lib = _cuda_path_on_cpu(monkeypatch, opponent_cnn_front, opponent_features_forward,
                            opponent_actor_forward)
    _, tnets, norms = _stacks(3, 40, True)
    stack = OpponentStack.of([actor_params(t, "bfloat16" if bf16 else None) for t in tnets], norms)
    obs, slot = (torch.from_numpy(x) for x in _inputs(2, Ep=16))
    before = [w.launches for w in (opponent_cnn_front, opponent_features_forward,
                                   opponent_actor_forward)]

    def no_conv(*args, **kw):
        raise AssertionError("a conv on the CNN opponents' device route")

    monkeypatch.setattr(torch.nn.functional, "conv2d", no_conv)
    out = opponent_actor_forward(obs, slot, stack)
    assert [name for name, _ in lib.calls] == ["opp_cnn_front", "opp_features_forward"]
    (_, front), (_, feat) = lib.calls
    assert len(front) == len(kernels.SIGNATURES["opp_cnn_front"])
    assert front[:3] == (obs.data_ptr(), slot.data_ptr(), stack.norm.mean.data_ptr())
    assert list(front[6]) == [w.data_ptr() for w in stack.conv_weights]
    assert list(front[7]) == [b.data_ptr() for b in stack.conv_biases]
    assert list(front[8]) == [2, 8, 8] and front[9:14] == (2, 3, 6, 7, D)
    assert front[15:18] == (16, 3, int(bf16))
    assert len(feat) == len(kernels.SIGNATURES["opp_features_forward"])
    assert list(feat[6]) == [w.data_ptr() for w in stack.packed.layers]
    assert list(feat[8]) == [338, 32, 7] and feat[9] == 2 and feat[11] == out.data_ptr()
    assert feat[12:15] == (16, 3, int(bf16))
    assert feat[15] == front[14] and feat[16:18] == (8 * 42, 84) and out.shape == (16, A)
    assert [w.launches for w in (opponent_cnn_front, opponent_features_forward,
                                 opponent_actor_forward)] == [before[0] + 1, before[1] + 1,
                                                              before[2]]
    wide = OpponentStack.of([actor_params(ActorCriticNetwork(
        D, A, network_type="cnn", obs_shape=SHAPE, conv_channels=(16, 16), activation="relu",
        generator=torch.Generator().manual_seed(k))) for k in range(2)], None)
    with pytest.raises(ValueError, match="obs width 674"):
        opponent_actor_forward(obs, slot.clamp(0, 1), wide)
    assert [name for name, _ in lib.calls[2:]] == ["opp_cnn_front"]  # K7 not launched
    deep = OpponentStack.of([actor_params(ActorCriticNetwork(
        D, A, network_type="cnn", obs_shape=SHAPE, num_conv_layers=2, conv_channels=(40, 8),
        kernel_size=7, activation="relu", generator=torch.Generator().manual_seed(k)))
        for k in range(2)], None)
    counts = [w.launches for w in (opponent_cnn_front, opponent_features_forward)]

    def refused(*args):  # the entry's cudaErrorInvalidValue
        lib.calls.append(("opp_cnn_front", args))
        return 1

    lib.opp_cnn_front = refused
    with pytest.raises(RuntimeError, match="opp_cnn_front"):
        opponent_actor_forward(obs, slot.clamp(0, 1), deep)
    assert [name for name, _ in lib.calls[3:]] == ["opp_cnn_front"]  # nothing after it
    assert list(lib.calls[3][1][8]) == [2, 40, 8] and lib.calls[3][1][10] == 7
    assert [w.launches for w in (opponent_cnn_front, opponent_features_forward)] == counts

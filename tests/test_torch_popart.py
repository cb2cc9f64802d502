"""PopArt (``normalize_values``) in the port against the JAX package: the
four functions and a sequence of masked updates, the value head's rescale
(K15's plain version, in place on the network's own parameters), the
rollout's denormalisation (K16's plain version), two train steps on
CartPole and on a tiny Liar's Dice CTDE against the pool with ``target_kl``
(both with the adaptive entropy controller too), the update on the
runners' static inputs with every host read refused, and ``popart.npz``
written by each package and resumed by the other."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from burn_ppo_tpu.config import Config as JaxConfig  # noqa: E402
from burn_ppo_tpu.models.network import ActorCriticNetwork as JaxNetwork  # noqa: E402
from burn_ppo_tpu.ppo import normalization as jn  # noqa: E402
from burn_ppo_tpu.ppo.entropy import AdaptiveEntropyState as JaxEntState  # noqa: E402
from burn_ppo_tpu.ppo.pool_rollout import PoolSeating as JaxSeating  # noqa: E402
from burn_ppo_tpu.train import Trainer as JaxTrainer  # noqa: E402
from burn_ppo_tpu.train import make_pool_train_step as jax_make_pool_step  # noqa: E402
from burn_ppo_tpu.train import make_train_step as jax_make_train_step  # noqa: E402
from burn_ppo_torch.config import Config  # noqa: E402
from burn_ppo_torch.convert import params_from_jax, params_to_jax, tree_leaves  # noqa: E402
from burn_ppo_torch.models.network import ActorCriticNetwork  # noqa: E402
from burn_ppo_torch.ppo import normalization as tn  # noqa: E402
from burn_ppo_torch.ppo.entropy import AdaptiveEntropyState  # noqa: E402
from burn_ppo_torch.ppo.normalization import ObsNormState, PopArtState  # noqa: E402
from burn_ppo_torch.ppo.pool_rollout import PoolSeating  # noqa: E402
from burn_ppo_torch.ppo.update import AdamState  # noqa: E402
from burn_ppo_torch.ppo.update_graph import UpdateGraph, UpdateRunner  # noqa: E402
from burn_ppo_torch.train import (  # noqa: E402
    Trainer,
    TrainState,
    make_pool_train_step,
    make_train_step,
    rollout_runner,
)
from tests.test_torch_liars_dice_ctde_step import (  # noqa: E402
    ACTIVE,
    L,
    K,
    E as LD_E,
    compare_states as compare_liars_states,
    jax_fns,
    liars_cfg,
    replay_pool_rollout,
    start as liars_start,
    with_shaping,
)
from tests.test_torch_liars_dice_ctde_step import LR as LD_LR  # noqa: E402
from tests.test_torch_liars_dice_ctde_step import P as LD_P  # noqa: E402
from tests.test_torch_liars_dice_ctde_step import SHAPING  # noqa: E402
from tests.test_torch_resume import assert_leaves_equal, cfg_file, live  # noqa: E402
from tests.test_torch_skull_ctde_pool import ctde_opponents  # noqa: E402
from tests.test_torch_skull_ctde_step import ReplaySource as PoolReplaySource  # noqa: E402
from tests.test_torch_skull_ctde_step import replay_update as pool_replay_update  # noqa: E402
from tests.test_torch_train_step import (  # noqa: E402
    CFG,
    ENT,
    JENV,
    LR,
    ReplaySource,
    _replay_rollout,
    _replay_update,
    start,
)
from tests.test_torch_update_graph_cpu import _NoHostReads  # noqa: E402

CPU = torch.device("cpu")


def t_state(mean, m2, count) -> PopArtState:
    return PopArtState(mean=torch.tensor(mean, dtype=torch.float32),
                       m2=torch.tensor(m2, dtype=torch.float32),
                       count=torch.tensor(count, dtype=torch.float32))


def j_state(s: PopArtState) -> jn.PopArtState:
    """A JAX copy of ``s`` (copied: JAX may share a numpy buffer, which
    the port then writes in place)."""
    return jn.PopArtState(**{f: jnp.array(getattr(s, f).numpy().copy())
                             for f in ("mean", "m2", "count")})


def assert_state_close(t: PopArtState, j, rtol=1e-5):
    # JAX sums the batch in f32, the port in f64 rounded once: rtol 1e-5.
    for f in ("mean", "m2", "count"):
        np.testing.assert_allclose(getattr(t, f).numpy(), np.asarray(getattr(j, f)), rtol=rtol,
                                   atol=1e-6, err_msg=f)


# The count < 2 identity (fresh, one sample), and a merged state.
STATES = [(0.0, 0.0, 0.0), (3.5, 0.0, 1.0), (-1.25, 812.0, 4096.0)]


@pytest.mark.parametrize("stats", STATES)
@pytest.mark.parametrize("masked", [False, True])
def test_popart_functions_match_jax(stats, masked):
    rng = np.random.default_rng(7)
    s = t_state(*stats)
    x = (rng.normal(size=1000) * 20 + 4).astype(np.float32)
    mask = (rng.random(1000) < 0.7).astype(np.float32) if masked else None
    new, old_mean, old_std = tn.popart_update(s, torch.from_numpy(x),
                                              None if mask is None else torch.from_numpy(mask))
    jnew, jmean, jstd = jn.popart_update(j_state(s), jnp.asarray(x),
                                         None if mask is None else jnp.asarray(mask))
    assert_state_close(new, jnew)
    assert float(old_mean) == float(jmean) and float(old_std) == float(jstd)
    assert float(s.count) == stats[2]  # popart_update writes nothing
    for state, jstate in ((s, j_state(s)), (new, jnew)):
        # The same state: the same bits; the merged one, as its stats.
        np.testing.assert_allclose(state.std.numpy(), np.asarray(jstate.std),
                                   rtol=0 if state is s else 1e-5)
        assert bool(state.initialized) == bool(jstate.initialized)
        y = torch.from_numpy(x[:64])
        # The same f32 operations, each rounded once: equal, or within an
        # ulp where XLA contracts x * std + mean into one FMA.
        np.testing.assert_allclose(tn.popart_normalize(state, y).numpy(),
                                   np.asarray(jn.popart_normalize(jstate, jnp.asarray(x[:64]))),
                                   rtol=1e-6, atol=1e-6)
        for got in (tn.popart_denormalize_plain(state, y), tn.popart_denormalize(state, y)):
            np.testing.assert_allclose(
                got.numpy(), np.asarray(jn.popart_denormalize(jstate, jnp.asarray(x[:64]))),
                rtol=1e-6, atol=1e-6)
    if stats[2] < 2.0:
        np.testing.assert_array_equal(tn.popart_normalize(s, torch.from_numpy(x)).numpy(), x)
        assert float(s.std) == 1.0


def test_a_sequence_of_masked_updates_matches_jax():
    """Fresh, one valid sample (count 1: still the identity), an empty
    mask (nothing merges), then batches of every size."""
    rng = np.random.default_rng(3)
    s, js = t_state(0.0, 0.0, 0.0), jn.PopArtState.create()
    sizes = [(64, 1), (64, 0), (256, None), (4096, 3000), (33, 33), (1000, None)]
    for n, valid in sizes:
        x = (rng.normal(size=n) * 50 - 10).astype(np.float32)
        if valid is None:
            mask = np.ones(n, np.float32)
        else:
            mask = np.zeros(n, np.float32)
            mask[rng.permutation(n)[:valid]] = 1.0
        s, _, _ = tn.popart_update(s, torch.from_numpy(x), torch.from_numpy(mask))
        js, _, _ = jn.popart_update(js, jnp.asarray(x), jnp.asarray(mask))
        assert_state_close(s, js)
        if valid in (0, 1) and float(s.count) < 2:
            assert not bool(s.initialized) and float(s.std) == 1.0
    assert float(s.count) == 1 + 256 + 3000 + 33 + 1000


def test_the_rescale_preserves_denormalized_outputs():
    """tests/test_normalization.py:117-131 on the port, and the rescale
    against JAX's."""
    s, _, _ = tn.popart_update(t_state(0.0, 0.0, 0.0), torch.tensor([1.0, 2.0, 3.0]))
    kernel, bias = torch.tensor([[0.5], [1.5]]), torch.tensor([0.2])
    x = torch.tensor([[1.0, -2.0]])
    out_old = tn.popart_denormalize(s, x @ kernel + bias)
    s2, old_mean, old_std = tn.popart_update(s, torch.tensor([10.0, 20.0, 30.0]))
    k2, b2 = tn.popart_rescale_value_head(kernel, bias, old_mean, old_std, s2.mean, s2.std,
                                          torch.tensor(True))
    np.testing.assert_allclose(tn.popart_denormalize(s2, x @ k2 + b2).numpy(), out_old.numpy(),
                               rtol=1e-4)
    jk, jb = jn.popart_rescale_value_head(jnp.asarray(kernel.numpy()), jnp.asarray(bias.numpy()),
                                          jnp.asarray(old_mean.numpy()),
                                          jnp.asarray(old_std.numpy()),
                                          jnp.asarray(s2.mean.numpy()), jnp.asarray(s2.std.numpy()),
                                          jnp.asarray(True))
    np.testing.assert_allclose(k2.numpy(), np.asarray(jk), rtol=1e-6)
    np.testing.assert_allclose(b2.numpy(), np.asarray(jb), rtol=1e-6)
    k3, b3 = tn.popart_rescale_value_head(kernel, bias, old_mean, old_std, s2.mean, s2.std,
                                          torch.tensor(False))
    assert torch.equal(k3, kernel) and torch.equal(b3, bias)


NETWORKS = [
    dict(obs_dim=5, action_count=2, network_type="mlp", hidden_size=64, num_hidden=2),
    dict(obs_dim=126, action_count=7, network_type="cnn", obs_shape=(6, 7, 3),
         cnn_fc_hidden_size=32),
    dict(obs_dim=270, action_count=49, network_type="ctde", privileged_obs_dim=120,
         hidden_size=32, num_hidden=2, critic_hidden_size=512, critic_num_hidden=3),
]


@pytest.mark.parametrize("kw", NETWORKS, ids=["mlp", "cnn", "ctde_512x3"])
@pytest.mark.parametrize("count", [0.0, 1.0, 300.0])
def test_update_rescale_writes_the_networks_value_head_as_jax(kw, count):
    """K15's plain version on a network's own value head, in place, against
    JAX's ``popart_update`` + ``popart_rescale_value_head`` on
    ``get_value_head``; the rest of the parameters untouched."""
    jnet = JaxNetwork(**kw)
    params = jnet.init(jax.random.PRNGKey(1))
    tnet = ActorCriticNetwork(**kw, generator=torch.Generator().manual_seed(0))
    tnet.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    AdamState.create(tnet)  # the flat buffers the trainer's parameters view
    jk, jb = jnet.get_value_head(params)
    kernel, bias = tnet.value_head_params()
    assert kernel.shape == jk.shape and bias.shape == jb.shape
    np.testing.assert_array_equal(kernel.numpy(), np.asarray(jk))
    rng = np.random.default_rng(int(count) + kw["obs_dim"])
    x = (rng.normal(size=600) * 7 + 2).astype(np.float32)
    w = (rng.random(600) < 0.75).astype(np.float32)
    s = t_state(1.5, 40.0 * count, count)
    js = j_state(s)
    before = [p.detach().clone() for p in tnet.parameters()]
    tn.popart_update_rescale(s, torch.from_numpy(x), torch.from_numpy(w), kernel, bias)
    js2, om, osd = jn.popart_update(js, jnp.asarray(x), jnp.asarray(w))
    jk2, jb2 = jn.popart_rescale_value_head(jk, jb, om, osd, js2.mean, js2.std, js2.initialized)
    assert_state_close(s, js2)
    k_now, b_now = tnet.value_head_params()
    np.testing.assert_allclose(k_now.numpy(), np.asarray(jk2), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(b_now.numpy(), np.asarray(jb2), rtol=1e-5, atol=1e-6)
    head = {id(tnet.value_head.weight), id(tnet.value_head.bias)}
    for p, b in zip(tnet.parameters(), before):
        if id(p) not in head:
            assert torch.equal(p.detach(), b)
    assert bool(s.initialized)  # 0 + 450-odd valid samples, or more


def popart_cfg(**kw):
    return dataclasses.replace(CFG, **kw)


def fresh(start, cfg):
    """A JAX and a port train state from the module's CartPole start, with
    PopArt and the controller as ``cfg`` sets them (the port's network a
    fresh copy of JAX's parameters)."""
    network, tx, jstate, tstate, env, _ = start
    jstate = jstate.replace(
        popart=jn.PopArtState.create() if cfg.normalize_values else None,
        ent_state=(JaxEntState.create(cfg.entropy_coef.get(0))
                   if cfg.adaptive_entropy is not None else None))
    tnet = ActorCriticNetwork(5, 2, hidden_size=64, num_hidden=2, activation="relu",
                              generator=torch.Generator().manual_seed(0))
    tnet.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, jstate.params)))
    ts = TrainState(
        network=tnet, opt_state=AdamState.create(tnet), carry=tstate.carry,
        obs_norm=ObsNormState.create(5, CPU),
        popart=PopArtState.create(CPU) if cfg.normalize_values else None,
        ent_state=(AdaptiveEntropyState.create(cfg.entropy_coef.get(0), CPU)
                   if cfg.adaptive_entropy is not None else None))
    return network, tx, jstate, ts, env


def assert_train_states_close(ts, jstate, t_m, j_m):
    # Reductions over minibatches and Adam steps in another order:
    # parameters and metrics rtol 1e-4 / atol 1e-5 (the other train-step
    # tests' tolerances); the PopArt stats, summed in f64 against JAX's f32
    # sums, rtol 1e-5.
    assert set(j_m) <= set(t_m) <= set(j_m) | {"learner_valid_fraction"}
    for k, v in j_m.items():
        np.testing.assert_allclose(float(t_m[k]), float(v), rtol=1e-4, atol=1e-5, err_msg=k)
    for a, b in zip(tree_leaves(params_to_jax(ts.network.state_dict())),
                    jax.tree_util.tree_leaves(jstate.params)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-5)
    if jstate.popart is not None:
        assert_state_close(ts.popart, jstate.popart)
    if jstate.ent_state is not None:
        e, je = ts.ent_state, jstate.ent_state
        np.testing.assert_allclose(float(e.coef), float(je.coef), rtol=1e-6)
        np.testing.assert_allclose(float(e.last_entropy), float(je.last_entropy), rtol=1e-4)
        assert bool(e.has_entropy) == bool(je.has_entropy)


FLAGS = [dict(normalize_values=True), dict(adaptive_entropy=0.5),
         dict(normalize_values=True, adaptive_entropy=0.5)]


@pytest.mark.parametrize("flags", FLAGS, ids=["popart", "adaptive", "both"])
def test_two_cartpole_train_steps_match_jax(start, flags):
    cfg = popart_cfg(**flags, adaptive_entropy_delta=0.004)
    network, tx, jstate, ts, env = fresh(start, cfg)
    ent = ENT if cfg.adaptive_entropy is None else cfg.adaptive_entropy.get(0) * math.log(2)
    j_step = jax.jit(jax_make_train_step(network, JENV, cfg, tx))
    t_step = make_train_step(env, cfg)
    src = ReplaySource()
    carry_key, update_key = jstate.carry.key, jstate.update_key
    coefs = []
    for _ in range(3):
        carry_key = _replay_rollout(src, carry_key)
        update_key = _replay_update(src, update_key)
        jstate, j_m, _ = j_step(jstate, jnp.float32(LR), jnp.float32(ent), jnp.float32(0.0))
        ts, t_m, _ = t_step(ts, LR, ent, src)
        assert not src.uniforms and not src.perms
        assert_train_states_close(ts, jstate, t_m, j_m)
        if cfg.adaptive_entropy is not None:
            coefs.append(float(t_m["adaptive_ent_coef"]))
    if cfg.normalize_values:
        assert float(ts.popart.count) == 3 * 32 * 16 and float(t_m["value_norm/std"]) != 1.0
    if cfg.adaptive_entropy is not None:
        # No step before the first record, then one delta an update.
        assert coefs[0] == np.float32(ENT) and len(set(coefs)) == 3
        assert abs(abs(coefs[2] - coefs[1]) - 0.004) < 1e-6


def test_the_update_on_static_inputs_reads_nothing_back(start):
    """The rollout through ``RolloutRunner``, the update through
    ``UpdateRunner.run`` with PopArt and the controller on, each host read
    of a tensor refused during the update (on a card the same code is
    replayed from CUDA graphs), against the JAX train step; then the
    eager update from the same saved state gives the same bits as ``run``."""
    cfg = popart_cfg(normalize_values=True, adaptive_entropy=0.5)
    network, tx, jstate, ts, env = fresh(start, cfg)
    target = 0.5 * math.log(2)
    j_step = jax.jit(jax_make_train_step(network, JENV, cfg, tx))
    runner, updater = rollout_runner(env, cfg), UpdateRunner(env, cfg)
    src = ReplaySource()
    carry_key, update_key = jstate.carry.key, jstate.update_key
    UpdateGraph.reset_counts()
    for i in range(2):
        carry_key = _replay_rollout(src, carry_key)
        update_key = _replay_update(src, update_key)
        jstate, j_m, _ = j_step(jstate, jnp.float32(LR), jnp.float32(target), jnp.float32(0.0))
        runner.run(ts.network, ts.carry, ts.obs_norm, src, popart=ts.popart)
        if i == 1:
            saved = [t.clone() for t in (ts.opt_state.flat_params, ts.opt_state.flat_mu,
                                         ts.opt_state.flat_nu, ts.opt_state.count_tensor,
                                         *runner.obs_norm.__dict__.values(),
                                         runner.popart.mean, runner.popart.m2,
                                         runner.popart.count, updater.entropy.coef,
                                         updater.entropy.last_entropy,
                                         updater.entropy.has_entropy)]
            perms = list(src.perms)
        with _NoHostReads():
            out = updater.run(ts.network, ts.opt_state, runner, src, LR, target,
                              entropy=ts.ent_state)
        ts = TrainState(ts.network, ts.opt_state, runner.carry, runner.obs_norm,
                        popart=runner.popart, ent_state=updater.entropy)
        assert_train_states_close(ts, jstate, out["metrics"], j_m)
    assert updater.graph is None and UpdateGraph.captures == UpdateGraph.replays == 0
    after = {k: v.clone() for k, v in out["metrics"].items()}
    live_after = [t.clone() for t in (ts.opt_state.flat_params, runner.popart.mean,
                                      updater.entropy.coef, updater.entropy.last_entropy)]
    dsts = [ts.opt_state.flat_params, ts.opt_state.flat_mu, ts.opt_state.flat_nu,
            ts.opt_state.count_tensor, *runner.obs_norm.__dict__.values(), runner.popart.mean,
            runner.popart.m2, runner.popart.count, updater.entropy.coef,
            updater.entropy.last_entropy, updater.entropy.has_entropy]
    for d, s in zip(dsts, saved):
        d.copy_(s)
    src.perms = perms
    again = updater.eager(ts.network, ts.opt_state, runner, src, LR, target, updater.entropy)
    for k, v in after.items():
        assert torch.equal(again["metrics"][k], v), k
    for a, b in zip(live_after, (ts.opt_state.flat_params, runner.popart.mean,
                                 updater.entropy.coef, updater.entropy.last_entropy)):
        assert torch.equal(a, b)


def test_a_liars_dice_ctde_pool_step_with_target_kl_matches_jax():
    """The widest critic's path in miniature: Liar's Dice CTDE against the
    pool with ``target_kl`` (the KL stop fires), PopArt and the adaptive
    controller, two train steps against JAX's."""
    cfg = liars_cfg(opponent_pool_fraction=0.25, normalize_values=True, adaptive_entropy=0.5,
                    target_kl=1e-5, adaptive_entropy_delta=0.003)
    network, tx, jstate, tstate, env = liars_start(cfg, seed=1, walk=45)
    jstate = jstate.replace(popart=jn.PopArtState.create(),
                            ent_state=JaxEntState.create(cfg.entropy_coef.get(0)))
    tstate = dataclasses.replace(tstate, popart=PopArtState.create(CPU),
                                 ent_state=AdaptiveEntropyState.create(cfg.entropy_coef.get(0),
                                                                       CPU))
    j_opp, j_opp_norm, t_stack = ctde_opponents(network, env, cfg, ACTIVE, obs_dim=270)
    target = 0.5 * math.log(49)
    k_seat = jax.random.PRNGKey(21)
    src = PoolReplaySource()
    k1, k2 = jax.random.split(k_seat)
    src.ints.append((np.asarray(jax.random.randint(k1, (LD_E,), 0, LD_P)), 0, LD_P))
    src.ints.append((np.asarray(jax.random.randint(k2, (LD_E, LD_P), 0, ACTIVE)), 0, ACTIVE))
    j_seat = JaxSeating.create(LD_E, L, LD_P, ACTIVE, k_seat)
    t_seat = PoolSeating.create(LD_E, L, LD_P, ACTIVE, src)
    j_step = jax.jit(jax_make_pool_step(network, jax_fns()["env"], cfg, tx, L, K))
    t_step = make_pool_train_step(env, cfg, L)
    runs = []
    for _ in range(2):
        _, keys = replay_pool_rollout(src, jstate.carry.key, ACTIVE)
        pool_replay_update(src, jstate.update_key, cfg.num_epochs)
        env.begin(with_shaping(jstate.carry.env_states), keys)
        jstate, j_seat, j_m, _, _ = j_step(
            jstate, j_seat, j_opp, j_opp_norm, jnp.float32(LD_LR), jnp.float32(target),
            jnp.float32(SHAPING), jnp.int32(ACTIVE))
        tstate, t_seat, t_m, _, _ = t_step(tstate, t_seat, t_stack, ACTIVE, LD_LR, target, src,
                                           SHAPING)
        assert not src.uniforms and not src.ints and not src.perms
        compare_liars_states(tstate, jstate, t_m, j_m)
        assert_train_states_close(tstate, jstate, t_m, j_m)
        runs.append(float(t_m["num_minibatch_updates"]))
    assert min(runs) < cfg.num_epochs * cfg.num_minibatches  # the KL stop fired
    assert bool(tstate.popart.initialized) and bool(tstate.ent_state.has_entropy)


def popart_toml(path, total, envs=8):
    cfg_file(path, total, envs=envs)
    path.write_text(path.read_text() + "normalize_values = true\n")
    return path


def jax_popart_leaves(t: JaxTrainer) -> dict:
    s = jax.device_get(t.state)
    leaves = jax.tree_util.tree_leaves
    return {"model": leaves(s.params), "optimizer": leaves(s.opt_state),
            "obs_norm": leaves(s.obs_norm), "return_norm": leaves(s.carry.return_norm),
            "popart": leaves(s.popart)}


def test_the_port_resumes_a_popart_checkpoint_the_jax_trainer_wrote(tmp_path):
    jt = JaxTrainer(JaxConfig.load(popart_toml(tmp_path / "j.toml", 64)), tmp_path / "jax",
                    quiet=True)
    jt.train()
    ckpt = (tmp_path / "jax" / "checkpoints" / "latest").resolve()
    assert (ckpt / "popart.npz").exists()
    want = jax_popart_leaves(JaxTrainer(JaxConfig.load(tmp_path / "j.toml"), tmp_path / "jr",
                                        resume_from=ckpt, quiet=True))
    assert float(want["popart"][2]) == 64
    cfg = Config.load(tmp_path / "j.toml").apply_overrides({"total_steps": 128}, resume=True)
    t = Trainer(cfg, tmp_path / "pr", device="cpu", quiet=True, resume_from=ckpt)
    got = live(t)
    got.pop("generator_state")
    assert_leaves_equal(got, {k: [np.asarray(x) for x in v] for k, v in want.items()})
    t.train()
    assert t.global_step == 128 and float(t.state.popart.count) == 128


def test_the_jax_trainer_resumes_a_popart_checkpoint_the_port_wrote(tmp_path):
    t = Trainer(Config.load(popart_toml(tmp_path / "p.toml", 64)), tmp_path / "port",
                device="cpu", quiet=True)
    t.train()
    ckpt = (tmp_path / "port" / "checkpoints" / "latest").resolve()
    import json

    assert json.loads((ckpt / "metadata.json").read_text())["normalize_values"] is True
    jt = JaxTrainer(JaxConfig.load(tmp_path / "p.toml"), tmp_path / "jr", resume_from=ckpt,
                    quiet=True)
    got = jax_popart_leaves(jt)
    want = live(t)
    want.pop("generator_state")
    assert_leaves_equal({k: [np.asarray(x) for x in v] for k, v in got.items()}, want)
    assert float(t.state.popart.count) == 64


def test_a_fork_that_turns_popart_on_keeps_it_fresh(tmp_path, capsys):
    """A run without PopArt forked with ``normalize_values``: the stats
    start fresh, with JAX's warning (train.py:888-897)."""
    t = Trainer(Config.load(cfg_file(tmp_path / "a.toml", 32)), tmp_path / "a", device="cpu",
                quiet=True)
    t.train()
    ckpt = (tmp_path / "a" / "checkpoints" / "latest").resolve()
    cfg = Config.load(popart_toml(tmp_path / "b.toml", 64, envs=4))
    child = Trainer(cfg, tmp_path / "b", device="cpu", resume_from=ckpt)
    assert "has no popart.npz; normalize_values starts from fresh statistics" in (
        capsys.readouterr().out)
    assert float(child.state.popart.count) == 0.0 and child.global_step == 32

"""The update with its KL stop and empty-minibatch skip decided on the
device (``ppo/update.py`` ``LossBook``, K8's bookkeeping and K9's run
flag) and the post-rollout half of a train step on static inputs
(``ppo/update_graph.py UpdateRunner``), on the CPU, against the JAX
package with JAX's random draws replayed and against the host loop the
device flags replace. On a card the same code is captured into CUDA
graphs and replayed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from burn_ppo_tpu.ppo import update as ju  # noqa: E402
from burn_ppo_tpu.train import make_train_step as jax_make_train_step  # noqa: E402
from burn_ppo_torch.convert import params_to_jax, tree_leaves  # noqa: E402
from burn_ppo_torch.ppo import update as tu  # noqa: E402
from burn_ppo_torch.ppo.rollout_graph import RolloutGraph  # noqa: E402
from burn_ppo_torch.ppo.update_graph import UpdateGraph, UpdateRunner  # noqa: E402
from burn_ppo_torch.train import TrainState, rollout_runner  # noqa: E402
from tests.test_torch_train_step import (  # noqa: E402
    CFG,
    ENT,
    JENV,
    LR,
    ReplaySource as StepReplaySource,
    _replay_rollout,
    _replay_update,
    start,
)
from tests.test_torch_update import CASES, ReplaySource, _data, _nets, _torch_data  # noqa: E402


class _NoHostReads:
    """Makes every read of a tensor's value on the host raise while it is
    entered: ``item``, ``tolist``, ``float``/``int``/``bool`` of a tensor."""

    NAMES = ("item", "tolist", "__float__", "__int__", "__bool__", "__index__")

    def __enter__(self):
        self.saved = {n: getattr(torch.Tensor, n) for n in self.NAMES}

        def refuse(name):
            def read(*a, **k):
                raise AssertionError(f"the update read a tensor on the host ({name})")
            return read

        for n in self.NAMES:
            setattr(torch.Tensor, n, refuse(n))
        return self

    def __exit__(self, *exc):
        for n, f in self.saved.items():
            setattr(torch.Tensor, n, f)


def _jax_update(jnet, jparams, data, key, lr, jcfg, may_have_invalid=False):
    tx = ju.make_optimizer(jcfg)
    return jax.jit(
        lambda p, o, d, k: ju.ppo_update(jnet, tx, p, o, d, None, k, lr, 0.01, jcfg,
                                         may_have_invalid=may_have_invalid)
    )(jparams, tx.init(jparams), {k: jnp.asarray(v) for k, v in data.items()}, key)


def _assert_update_matches(tnet, opt, t_m, j_params, j_opt, j_m):
    # Minibatch reductions and Adam steps accumulate rounding in another
    # order over several steps: rtol 1e-4 / atol 1e-5.
    for a, b in zip(tree_leaves(params_to_jax(tnet.state_dict())),
                    jax.tree_util.tree_leaves(j_params)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-5)
    j_adam = j_opt[1]
    assert opt.count == int(j_adam.count)
    for mine, ref in ((opt.mu, j_adam.mu), (opt.nu, j_adam.nu)):
        for a, b in zip(tree_leaves(params_to_jax(mine)), jax.tree_util.tree_leaves(ref)):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-5)
    for k in list(ju.METRIC_KEYS) + ["explained_variance", "num_minibatch_updates"]:
        np.testing.assert_allclose(float(t_m[k]), float(j_m[k]), rtol=1e-4, atol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("case", sorted(CASES))
def test_device_flag_update_matches_jax_and_reads_nothing_back(case):
    """The update with the learning rate and entropy coefficient as 0-dim
    tensors, no tensor read on the host while it runs, against JAX on
    every case of tests/test_torch_update.py (even, uneven pad, all-pad
    skip, KL stop)."""
    n, nmb, epochs, target_kl, max_norm, lr = CASES[case]
    jnet, jparams, tnet = _nets()
    data = _data(jnet, jparams, n, seed=n)
    kw = dict(num_minibatches=nmb, num_epochs=epochs, target_kl=target_kl,
              max_grad_norm=max_norm, clip_value=True, shuffle_block_rows=1)
    jcfg, tcfg = ju.PPOUpdateConfig(**kw), tu.PPOUpdateConfig(**kw)
    key = jax.random.PRNGKey(n)
    j_params, j_opt, _, j_m = _jax_update(jnet, jparams, data, key, lr, jcfg)
    mb_size = -(-n // nmb)
    perms = [jax.random.permutation(k, nmb * mb_size) for k in jax.random.split(key, epochs)]
    opt = tu.AdamState.create(tnet)
    t_data = _torch_data(data)
    with _NoHostReads():
        t_m = tu.ppo_update(tnet, opt, t_data, ReplaySource(perms), torch.tensor(lr),
                            torch.tensor(0.01), tcfg)
    assert isinstance(opt.count_tensor, torch.Tensor) and opt.count_tensor.dtype == torch.int32
    assert all(isinstance(v, torch.Tensor) and v.dim() == 0 for v in t_m.values())
    _assert_update_matches(tnet, opt, t_m, j_params, j_opt, j_m)


def test_a_kl_stop_mid_epoch_with_invalid_rows_matches_jax():
    """The vs-pool path (``may_have_invalid``): a third of the rows are
    opponent turns, and the KL stop fires inside an epoch, not at its
    end; JAX skips the rest with ``lax.cond``, the port with its flags."""
    n, nmb, epochs, lr = 96, 4, 3, 5e-2
    jnet, jparams, tnet = _nets()
    data = _data(jnet, jparams, n, seed=21)
    data["valid"][::3] = 0.0
    kw = dict(num_minibatches=nmb, num_epochs=epochs, target_kl=2e-3, clip_value=True,
              shuffle_block_rows=1)
    jcfg, tcfg = ju.PPOUpdateConfig(**kw), tu.PPOUpdateConfig(**kw)
    key = jax.random.PRNGKey(7)
    j_params, j_opt, _, j_m = _jax_update(jnet, jparams, data, key, lr, jcfg,
                                          may_have_invalid=True)
    perms = [jax.random.permutation(k, n) for k in jax.random.split(key, epochs)]
    opt = tu.AdamState.create(tnet)
    with _NoHostReads():
        t_m = tu.ppo_update(tnet, opt, _torch_data(data), ReplaySource(perms), torch.tensor(lr),
                            torch.tensor(0.01), tcfg, may_have_invalid=True)
    count = int(float(j_m["num_minibatch_updates"]))
    assert 0 < count < epochs * nmb and count % nmb != 0  # stopped inside an epoch
    _assert_update_matches(tnet, opt, t_m, j_params, j_opt, j_m)


def test_plain_k9_with_run_0_changes_nothing():
    """K9's plain version with its run flag 0 leaves parameters, moments
    and the count bit for bit; with 1 it takes the step, and with any
    other nonzero flag the same step."""
    rng = np.random.default_rng(3)
    start = [torch.from_numpy(rng.normal(size=300).astype(np.float32)) for _ in range(4)]
    start[3] = start[3].abs() * 1e-3  # nu >= 0
    kw = dict(lr=torch.tensor(3e-3), max_grad_norm=0.5, eps=1e-5)
    outs = {}
    for name, run in (("off", 0), ("on", 1), ("two", 2)):
        p, g, mu, nu = (t.clone() for t in start)
        count = torch.tensor(5, dtype=torch.int32)
        tu.clip_adam(p, g, mu, nu, count=count, run=torch.tensor(run, dtype=torch.int32), **kw)
        outs[name] = (p, mu, nu, count)
    for a, b in zip(outs["off"], (start[0], start[2], start[3], torch.tensor(5))):
        assert torch.equal(a, b.to(a.dtype))
    for a, b in zip(outs["on"], outs["two"]):
        assert torch.equal(a, b)
    assert int(outs["on"][3]) == 6 and not torch.equal(outs["on"][0], start[0])


def test_bias_corrections_are_the_host_expression_for_every_count():
    """The table K9 and its plain version read holds float32(1 - b^count),
    formed in double, for counts 1..100000 (the last entry, 1.0f, past
    its end)."""
    table = tu.adam_bias_table(torch.device("cpu"))
    counts = np.arange(1, 100001)
    cols = torch.from_numpy(np.minimum(counts, tu.ADAM_BIAS_LEN - 1))
    for row, b in ((0, tu.ADAM_B1), (1, tu.ADAM_B2)):
        want = np.array([1.0 - b ** int(c) for c in counts], dtype=np.float64).astype(np.float32)
        np.testing.assert_array_equal(table[row, cols].numpy(), want)


@pytest.mark.parametrize("target_kl", [None, 3e-3])
@pytest.mark.parametrize("can_be_empty", [False, True])
def test_plain_k8_bookkeeping_matches_the_host_loop(target_kl, can_be_empty):
    """K8's plain bookkeeping over a run of minibatches (some without a
    valid row) against the host loop it replaces: the sums of the
    minibatches run, their count and the stop flag, bit for bit."""
    jnet, jparams, tnet = _nets()
    cfg = tu.PPOUpdateConfig(target_kl=target_kl)
    book = tu.LossBook.create(torch.device("cpu"))
    sums, count, stop = torch.zeros(len(tu.METRIC_KEYS)), 0, False
    runs = []
    for i in range(8):
        mb = _torch_data(_data(jnet, jparams, 24, seed=100 + i))
        if i in (1, 4):
            mb["valid"][:] = 0.0
        logits, values = tnet(mb["obs"])
        with torch.no_grad():
            _, metrics, _, _ = tu.ppo_loss_plain(logits, values, mb, torch.tensor(0.01), cfg,
                                                 book, can_be_empty)
        run = not stop and not (can_be_empty and float(mb["valid"].sum()) <= 0.0)
        if run:
            sums = sums + metrics
            count += 1
            if target_kl is not None and float(metrics[3]) > target_kl:
                stop = True
        runs.append(run)
        assert int(book.run) == run
    assert torch.equal(book.sums, sums) and float(book.count) == count
    assert int(book.stop) == stop
    assert (not all(runs)) == (can_be_empty or stop)


def test_update_runner_twice_matches_jax_train_steps(start):
    """Two CartPole train steps, the rollout through ``RolloutRunner`` and
    the rest through ``UpdateRunner.run`` on its static inputs, each
    against the JAX train step: the metrics, the episode summaries'
    source, the parameters, the obs-norm stats (merged in place into the
    rollout runner's), and no graph on the CPU."""
    network, tx, jstate, tstate, env, _ = start
    j_step = jax.jit(jax_make_train_step(network, JENV, CFG, tx))
    runner, updater = rollout_runner(env, CFG), UpdateRunner(env, CFG)
    src = StepReplaySource()
    carry_key, update_key = jstate.carry.key, jstate.update_key
    UpdateGraph.reset_counts()
    RolloutGraph.reset_counts()
    for _ in range(2):
        carry_key = _replay_rollout(src, carry_key)
        update_key = _replay_update(src, update_key)
        jstate, j_m, j_logs = j_step(jstate, jnp.float32(LR), jnp.float32(ENT), jnp.float32(0.0))
        runner.run(tstate.network, tstate.carry, tstate.obs_norm, src)
        out = updater.run(tstate.network, tstate.opt_state, runner, src, LR, ENT)
        tstate = TrainState(tstate.network, tstate.opt_state, runner.carry, runner.obs_norm)
        assert not src.uniforms and not src.perms
        assert out is updater.outputs and set(out) == {"metrics", "stats"}
        assert float(updater.lr) == np.float32(LR) and float(updater.ent_coef) == np.float32(ENT)
        for k, v in j_m.items():
            np.testing.assert_allclose(float(out["metrics"][k]), float(v), rtol=1e-4, atol=1e-5,
                                       err_msg=k)
        assert float(out["stats"]["count"]) == float(np.asarray(j_logs.completed).sum())
        for a, b in zip(tree_leaves(params_to_jax(tstate.network.state_dict())),
                        jax.tree_util.tree_leaves(jstate.params)):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-5)
        for f in ("mean", "m2", "count"):
            np.testing.assert_allclose(getattr(runner.obs_norm, f).numpy(),
                                       np.asarray(getattr(jstate.obs_norm, f)), rtol=1e-5)
        assert tstate.opt_state.count == int(jstate.opt_state[1].count)
    assert updater.graph is None and UpdateGraph.captures == UpdateGraph.replays == 0


def test_update_graph_counts_are_its_own():
    """``UpdateGraph`` keeps replays, captures and launches apart from
    ``RolloutGraph``'s."""
    RolloutGraph.reset_counts()
    UpdateGraph.reset_counts()
    UpdateGraph.replays += 2
    UpdateGraph.launches[tu.clip_adam] = 32
    assert RolloutGraph.replays == 0 and RolloutGraph.launches == {}
    assert UpdateGraph.launches is not RolloutGraph.launches
    UpdateGraph.reset_counts()
    assert UpdateGraph.replays == 0 and UpdateGraph.launches == {}

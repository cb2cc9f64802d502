"""Update windows (A12c): the window sizes, the window report (K19's plain
version) and the pool records (K18's plain version) of the port against
the JAX package's; a non-pool window and a vs-pool window against JAX's
``make_train_window`` / ``make_pool_train_window`` with JAX's randoms
replayed; and the port's ``Trainer`` against JAX's on a tiny vs-pool run
with ``pool_rotation_interval = 4``."""

import json
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from burn_ppo_tpu.config import Config as JaxConfig  # noqa: E402
from burn_ppo_tpu.ppo.episode_stats import WindowedEpisodeTracker as JaxTracker  # noqa: E402
from burn_ppo_tpu.ppo.normalization import ObsNormState as JaxObsNorm  # noqa: E402
from burn_ppo_tpu.ppo.pool_rollout import PoolSeating as JaxSeating  # noqa: E402
from burn_ppo_tpu.ppo.rollout import init_rollout_carry as jax_init_carry  # noqa: E402
from burn_ppo_tpu.ppo.update import make_optimizer  # noqa: E402
from burn_ppo_tpu.train import PoolRecordLog as JaxRecordLog  # noqa: E402
from burn_ppo_tpu.train import Trainer as JaxTrainer  # noqa: E402
from burn_ppo_tpu.train import TrainState as JaxTrainState  # noqa: E402
from burn_ppo_tpu.train import _aggregate_window, _update_cfg, build_network_for_env  # noqa: E402
from burn_ppo_tpu.train import extract_pool_records as jax_extract  # noqa: E402
from burn_ppo_tpu.train import largest_pow2_le as jax_pow2  # noqa: E402
from burn_ppo_tpu.train import make_pool_train_window as jax_make_pool_window  # noqa: E402
from burn_ppo_tpu.train import make_train_window as jax_make_window  # noqa: E402
from burn_ppo_torch.config import Config  # noqa: E402
from burn_ppo_torch.convert import params_from_jax, params_to_jax, tree_leaves  # noqa: E402
from burn_ppo_torch.envs.cartpole import CartPole  # noqa: E402
from burn_ppo_torch.models.network import ActorCriticNetwork  # noqa: E402
from burn_ppo_torch.ppo.episode_stats import WindowedEpisodeTracker  # noqa: E402
from burn_ppo_torch.ppo.normalization import ObsNormState  # noqa: E402
from burn_ppo_torch.ppo.pool_rollout import PoolSeating  # noqa: E402
from burn_ppo_torch.ppo.rollout import init_rollout_carry  # noqa: E402
from burn_ppo_torch.ppo.update import AdamState  # noqa: E402
from burn_ppo_torch.ppo.window import (  # noqa: E402
    WindowBook,
    largest_pow2_le,
    record_capacity,
    window_records_plain,
)
from burn_ppo_torch.train import Trainer, TrainState, make_pool_train_step, make_train_step  # noqa: E402
from tests import test_torch_pool_rollout as pool_t  # noqa: E402
from tests import test_torch_train_step as step_t  # noqa: E402

CPU = torch.device("cpu")


# ---- (a) window sizes -------------------------------------------------

def _sizers(num_envs, num_steps, total, step, per_update, offset):
    """A JAX and a port trainer stand-in: what ``_window_size`` and
    ``_choose_window_k`` read."""
    jcfg = types.SimpleNamespace(num_steps=num_steps, total_steps=total)
    j = types.SimpleNamespace(cfg=jcfg, num_envs=num_envs, global_step=step,
                              elapsed_time_offset=offset, _per_update_time=per_update,
                              multihost=False)
    j._window_size = lambda *a: JaxTrainer._window_size(j, *a)
    t = types.SimpleNamespace(cfg=jcfg, num_envs=num_envs, global_step=step,
                              elapsed_time_offset=offset, _per_update_time=per_update)
    t._window_size = lambda *a: Trainer._window_size(t, *a)
    return j, t


@pytest.mark.parametrize("num_envs,num_steps", [(4096, 64), (16, 16), (3, 7), (1, 1)])
@pytest.mark.parametrize("cap", [None, 1, 8, 64])
def test_window_sizes_match_jax(num_envs, num_steps, cap, monkeypatch):
    """``largest_pow2_le``, ``_window_size`` and ``_choose_window_k`` on a
    grid of steps, boundaries, totals and time budgets, exactly."""
    for n in range(1, 300):
        assert largest_pow2_le(n) == jax_pow2(n)
    monkeypatch.setattr(time, "time", lambda: 1000.0)
    spu = num_envs * num_steps
    budgets = [None, 0.0, 0.5, 3.0, 100.0, 1e6]
    checked = 0
    for step in (0, spu, 7 * spu, 100 * spu + 1):
        for log_room in (1, spu, 3 * spu, 8 * spu, 100 * spu):
            for ckpt_room in (spu, 5 * spu, 64 * spu, 1000 * spu):
                for total in (step + spu, step + 9 * spu, step + 500 * spu):
                    for per_update in (None, 0.0, 0.01, 0.7):
                        for max_s in budgets:
                            j, t = _sizers(num_envs, num_steps, total, step, per_update, 2.5)
                            args = (step + log_room, step + ckpt_room)
                            rem = None if max_s is None else max_s - 3.5
                            assert (Trainer._window_size(t, *args, rem, per_update)
                                    == JaxTrainer._window_size(j, *args, rem, per_update))
                            want = JaxTrainer._choose_window_k(j, *args, max_s, 999.0, cap=cap)
                            got = Trainer._choose_window_k(t, *args, max_s, 999.0, cap=cap)
                            assert got == want, (step, log_room, ckpt_room, total, per_update,
                                                 max_s, cap)
                            checked += 1
    assert checked > 1000


# ---- (b) the window report ---------------------------------------------

def _update_outputs(rng, W, P, spike, guard_at):
    """W updates' metrics and episode summaries (numpy f32): a KL and
    clip-fraction spike at update ``spike``, a guard count at ``guard_at``,
    no episode ended in update 1 (extrema -inf / +inf)."""
    keys = ("policy_loss", "value_loss", "entropy", "approx_kl", "clip_fraction",
            "total_loss", "num_minibatch_updates", "explained_variance",
            "invalid_mask_count", "nonfinite_count")
    metrics, stats = [], []
    for w in range(W):
        m = {k: np.float32(rng.normal()) for k in keys}
        m["approx_kl"] = np.float32(0.5 if w == spike else rng.random() * 0.01)
        m["clip_fraction"] = np.float32(0.9 if w == spike else rng.random() * 0.1)
        m["invalid_mask_count"] = np.float32(3.0 if w == guard_at else 0.0)
        m["nonfinite_count"] = np.float32(1.0 if w == guard_at else 0.0)
        none = w == 1
        s = {
            "count": np.float32(0.0 if none else rng.integers(1, 50)),
            "ret_sum": rng.normal(size=P).astype(np.float32),
            "ret0_max": np.float32(-np.inf if none else rng.normal() + 1),
            "ret0_min": np.float32(np.inf if none else rng.normal() - 1),
            "len_sum": np.float32(0.0 if none else rng.integers(10, 500)),
            "pts_sum": (rng.integers(0, 40, size=P) / 2).astype(np.float32),
            "draws": np.float32(rng.integers(0, 3)),
        }
        metrics.append(m)
        stats.append(s)
    return metrics, stats


def _port_report(metrics, stats, P):
    book = WindowBook(CPU, P)
    book.start()
    for m, s in zip(metrics, stats):
        book.fold({k: torch.tensor(v) for k, v in m.items()},
                  {k: torch.tensor(v) for k, v in s.items()})
    return book.fetch()


@pytest.mark.parametrize("P,W,spike,guard_at", [(2, 4, 1, 2), (4, 8, 3, 0), (4, 1, 0, 0),
                                                (3, 5, 4, 4)])
def test_plain_window_report_matches_jax(P, W, spike, guard_at):
    """K19's plain fold against ``_aggregate_window`` on the stacked
    outputs: the last update's metrics and extrema exactly, the guards and
    the summaries' sums in another order of f32 adds, rtol 1e-6."""
    metrics, stats = _update_outputs(np.random.default_rng(P * 10 + W), W, P, spike, guard_at)
    stack = lambda xs: {k: jnp.stack([jnp.asarray(x[k]) for x in xs]) for k in xs[0]}
    j_m, j_s = _aggregate_window(stack(metrics), stack(stats))
    t_m, t_s, rows = _port_report(metrics, stats, P)
    assert rows is None and set(t_m) == set(j_m) and set(t_s) == set(j_s)
    assert t_m["approx_kl_max"] == 0.5 and t_m["invalid_mask_count"] == 3.0
    for k in j_m:
        np.testing.assert_allclose(t_m[k], np.asarray(j_m[k]), rtol=1e-6, err_msg=k)
    for k in j_s:
        np.testing.assert_allclose(np.asarray(t_s[k], np.float32), np.asarray(j_s[k]),
                                   rtol=1e-6, err_msg=k)
    # The trackers of both packages over the two reports.
    jt, tt = JaxTracker(P), WindowedEpisodeTracker(P)
    jt.ingest(jax.device_get(j_s))
    tt.ingest(t_s)
    assert tt.avg_return == pytest.approx(jt.avg_return, rel=1e-6)
    assert tt.total_episodes == jt.total_episodes


def test_windowed_ingests_give_jax_avg_return_and_the_per_update_one_differs():
    """The tracker fed one report a window (the port now, as JAX) against
    one a update (the port before windows): the same windows give JAX's
    average; per-update ingests trim the window at other points."""
    rng = np.random.default_rng(3)
    P, W = 2, 8
    jt, tt, per_update = JaxTracker(P), WindowedEpisodeTracker(P), WindowedEpisodeTracker(P)
    for _ in range(6):
        metrics, stats = _update_outputs(rng, W, P, spike=0, guard_at=0)
        for s in stats:
            s["count"] = np.float32(rng.integers(10, 40))
            s["ret0_max"], s["ret0_min"] = np.float32(1.0), np.float32(-1.0)
            per_update.ingest(s)
        stack = {k: jnp.stack([jnp.asarray(x[k]) for x in stats]) for k in stats[0]}
        jt.ingest(jax.device_get(_aggregate_window(
            {k: jnp.stack([jnp.asarray(m[k]) for m in metrics]) for k in metrics[0]}, stack)[1]))
        tt.ingest(_port_report(metrics, stats, P)[1])
    assert tt.avg_return == pytest.approx(jt.avg_return, rel=1e-6)
    assert tt.window_count == jt.window_count
    assert per_update.window_count != tt.window_count


# ---- (e) the pool records ------------------------------------------------

def _record_logs(rng, T, E, L, P, rate):
    completed = (rng.random((T, E)) < rate).astype(np.float32)
    seat = rng.integers(0, P, size=(T, E)).astype(np.int32)
    seat[:, :L] = -1
    seat[rng.random((T, E)) < 0.05] = -1  # self-play rows in the pool block are skipped
    outcome = np.stack([rng.permutation(P) + 1 for _ in range(T * E)]).reshape(T, E, P)
    slots = rng.integers(0, 8, size=(T, E, P)).astype(np.int32)
    return completed, outcome.astype(np.int32), seat, slots


@pytest.mark.parametrize("P,cap", [(2, None), (4, None), (3, None), (6, None), (4, 100),
                                   (2, 1)])
def test_plain_records_match_extract_pool_records_over_the_window(P, cap):
    """K18's plain version appended update by update against JAX's
    ``extract_pool_records`` over the W logs concatenated in (w, t, e)
    order; with a small capacity the first ``cap`` rows and the games
    past it counted (JAX's ``pool_record_overflow``)."""
    rng = np.random.default_rng(P)
    W, T, E, L = 4, 6, 40, 13
    logs = [_record_logs(rng, T, E, L, P, 0.3) for _ in range(W)]
    capacity = cap or record_capacity(W, T, E - L)
    book = WindowBook(CPU, P, record_rows=max(capacity, 5))
    book.rows.fill_(-7)  # rows past the count must not be read
    book.start(capacity)
    book.total.fill_(99)  # the first update restarts the count
    for c, o, s, sl in logs:
        window_records_plain(book, torch.from_numpy(c), torch.from_numpy(o), torch.from_numpy(s),
                             torch.from_numpy(sl), L)
        book.first.zero_()  # K19 clears the flag after each update
    want = jax_extract(JaxRecordLog(
        completed=np.concatenate([c[:, L:] for c, *_ in logs]) > 0,
        outcome=np.concatenate([o[:, L:] for _, o, _, _ in logs]),
        learner_seat=np.concatenate([s[:, L:] for _, _, s, _ in logs]),
        seat_opp=np.concatenate([sl[:, L:] for *_, sl in logs])), P)
    assert len(want) > 0
    book.layout = []  # nothing folded: fetch reads the records alone
    metrics, _, rows = book.fetch()
    assert int(book.total) == len(want)
    assert metrics["pool_record_overflow"] == max(len(want) - capacity, 0)
    np.testing.assert_array_equal(rows, want[:capacity])
    if cap is not None:
        assert metrics["pool_record_overflow"] > 0


# ---- (c) a non-pool window -------------------------------------------------

def _cartpole_start():
    network = build_network_for_env(step_t.JENV, step_t.CFG)
    tx = make_optimizer(_update_cfg(step_t.CFG))
    k_params, k_carry, k_update = jax.random.split(jax.random.PRNGKey(4), 3)
    params = network.init(k_params)
    jstate = JaxTrainState(params=params, opt_state=tx.init(params),
                           carry=jax_init_carry(step_t.JENV, step_t.E, k_carry),
                           obs_norm=JaxObsNorm.create(5), popart=None, update_key=k_update)
    _, sub = jax.random.split(k_carry)
    reset = np.array(step_t._reset_values(sub))

    def port_state():
        src = step_t.ReplaySource()
        src.uniforms.append(reset.copy())
        tnet = ActorCriticNetwork(5, 2, hidden_size=64, num_hidden=2, activation="relu",
                                  generator=torch.Generator().manual_seed(0))
        tnet.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
        return TrainState(network=tnet, opt_state=AdamState.create(tnet),
                          carry=init_rollout_carry(CartPole(), step_t.E, src, CPU),
                          obs_norm=ObsNormState.create(5, CPU))

    return network, tx, jstate, port_state


def _params(state):
    return [t.clone() for t in state.network.parameters()] + [
        state.opt_state.flat_mu.clone(), state.opt_state.flat_nu.clone()]


def test_a_window_of_four_matches_four_port_steps_and_jax_make_train_window():
    network, tx, jstate, port_state = _cartpole_start()
    K = 4
    lrs = [1e-3, 8e-4, 6e-4, 4e-4]
    src = step_t.ReplaySource()
    carry_key, update_key = jstate.carry.key, jstate.update_key
    for _ in range(K):
        carry_key = step_t._replay_rollout(src, carry_key)
        update_key = step_t._replay_update(src, update_key)
    draws = (list(src.uniforms), list(src.perms))
    j_window = jax.jit(jax_make_window(network, step_t.JENV, step_t.CFG, tx))
    f32 = lambda xs: jnp.asarray(xs, jnp.float32)
    jstate, j_m, j_s = j_window(jstate, f32(lrs), f32([step_t.ENT] * K), f32([0.0] * K))

    # The port's window: four graph-path steps folding into one book.
    book = WindowBook(CPU, 1)
    t_step = make_train_step(CartPole(), step_t.CFG, book=book)
    tstate = port_state()
    book.start()
    for lr in lrs:
        tstate, _, _ = t_step(tstate, lr, step_t.ENT, src)
    assert not src.uniforms and not src.perms
    t_m, t_s, _ = book.fetch()
    # Four sequential steps without a book, the same draws: bit for bit.
    src2 = step_t.ReplaySource()
    src2.uniforms, src2.perms = [u.copy() for u in draws[0]], [p.copy() for p in draws[1]]
    plain = make_train_step(CartPole(), step_t.CFG)
    seq = port_state()
    kls = []
    for lr in lrs:
        seq, m, _ = plain(seq, lr, step_t.ENT, src2)
        kls.append(float(m["approx_kl"]))
    for a, b in zip(_params(tstate), _params(seq)):
        assert torch.equal(a, b)
    assert t_m["approx_kl"] == float(m["approx_kl"]) and t_m["approx_kl_max"] == max(kls)
    # Against JAX: reductions in another order, rtol 1e-4 / atol 1e-5.
    assert set(t_m) == set(j_m) and set(t_s) == set(j_s)
    assert "approx_kl_max" in t_m and "clip_fraction_max" in t_m
    for k, v in j_m.items():
        np.testing.assert_allclose(t_m[k], float(v), rtol=1e-4, atol=1e-5, err_msg=k)
    for k, v in j_s.items():
        np.testing.assert_allclose(np.asarray(t_s[k], np.float32), np.asarray(v), rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    for a, b in zip(tree_leaves(params_to_jax(tstate.network.state_dict())),
                    jax.tree_util.tree_leaves(jstate.params)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-5)


# ---- (d) a vs-pool window ---------------------------------------------------

def test_a_pool_window_matches_jax_make_pool_train_window():
    """W = 4 vs-pool updates against one rotation of K = 3 opponents (4
    slots): parameters to the pool step test's tolerance, the records'
    rows[:count] exactly."""
    W = 4
    cfg, network, params, tnet, env, j_norm, t_norm = pool_t.start(seed=3)
    cfg.num_epochs, cfg.num_minibatches = 2, 4
    E, L, T, K, ACTIVE, P = pool_t.E, pool_t.L, pool_t.T, pool_t.K, pool_t.ACTIVE, pool_t.P
    tx = make_optimizer(_update_cfg(cfg))
    j_opp, j_opp_norm, t_stack = pool_t.opponents(network, ACTIVE, seed=5)
    k_carry, k_seat, k_update = jax.random.split(jax.random.PRNGKey(11), 3)
    src = pool_t.ReplaySource()
    pool_t.replay_seating(src, k_seat, ACTIVE)
    j_seat = JaxSeating.create(E, L, P, ACTIVE, k_seat)
    t_seat = PoolSeating.create(E, L, P, ACTIVE, src)
    jstate = JaxTrainState(params=params, opt_state=tx.init(params),
                           carry=jax_init_carry(pool_t.JENV, E, k_carry), obs_norm=j_norm,
                           popart=None, update_key=k_update)
    tstate = TrainState(network=tnet, opt_state=AdamState.create(tnet),
                        carry=init_rollout_carry(env, E, src, CPU), obs_norm=t_norm)
    carry_key, update_key = jstate.carry.key, jstate.update_key
    for _ in range(W):
        carry_key = pool_t.replay_pool_rollout(src, carry_key, ACTIVE)
        update_key, sub = jax.random.split(update_key)
        for k in jax.random.split(sub, cfg.num_epochs):
            src.perms.append(np.asarray(jax.random.permutation(k, T * E)))
    lrs = [1e-3, 9e-4, 8e-4, 7e-4]
    f32 = lambda xs: jnp.asarray(xs, jnp.float32)
    j_window = jax.jit(jax_make_pool_window(network, pool_t.JENV, cfg, tx, L, K))
    jstate, j_seat, j_m, j_s, j_rec = j_window(jstate, j_seat, j_opp, j_opp_norm, f32(lrs),
                                               f32([0.01] * W), f32([0.0] * W), jnp.int32(ACTIVE))

    book = WindowBook(CPU, P, record_rows=record_capacity(W, T, E - L))
    t_step = make_pool_train_step(env, cfg, L, book=book)
    book.start(record_capacity(W, T, E - L))
    for lr in lrs:
        tstate, t_seat, _, _, _ = t_step(tstate, t_seat, t_stack, ACTIVE, lr, 0.01, src)
    assert not src.uniforms and not src.ints and not src.perms
    t_m, t_s, rows = book.fetch()
    count = int(j_rec["count"])
    assert count > 0 and t_m["pool_record_overflow"] == float(j_m["pool_record_overflow"]) == 0
    np.testing.assert_array_equal(rows, np.asarray(j_rec["rows"][:count], np.int32))
    assert set(j_m) <= set(t_m) and set(t_s) == set(j_s)
    for k, v in j_m.items():
        np.testing.assert_allclose(t_m[k], float(v), rtol=1e-4, atol=1e-5, err_msg=k)
    for k, v in j_s.items():
        np.testing.assert_allclose(np.asarray(t_s[k], np.float32), np.asarray(v), rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    for a, b in zip(tree_leaves(params_to_jax(tstate.network.state_dict())),
                    jax.tree_util.tree_leaves(jstate.params)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(t_seat.seat_opp.numpy(), np.asarray(j_seat.seat_opp))


# ---- (f) the trainers ---------------------------------------------------------

TINY_POOL = dict(env="connect_four", num_envs=16, num_steps=8, hidden_size=16, num_hidden=1,
                 num_epochs=1, num_minibatches=2, opponent_pool_fraction=0.25,
                 max_active_opponents=3, pool_rotation_interval=4, total_steps=20 * 128,
                 log_freq=8 * 128, checkpoint_freq=8 * 128, seed=2)


def _record_trainer(tr, seen):
    """Wrap a trainer's window choice, rotation and record fold."""
    choose, apply = tr._choose_window_k, tr._apply_pool_records

    def choose_k(*a, **kw):
        k = choose(*a, **kw)
        seen["windows"].append((tr.global_step, k, kw.get("cap")))
        return k

    def fold(rows, names):
        seen["folds"].append(tr.global_step)
        return apply(rows, names)

    refresh = tr.pool.refresh_rotation

    def rotation(*a, **kw):
        seen["rotations"].append(tr.global_step)
        return refresh(*a, **kw)

    tr._choose_window_k, tr._apply_pool_records = choose_k, fold
    tr.pool.refresh_rotation = rotation


def _names(run):
    return {json.loads(x)["name"] for x in (run / "metrics.jsonl").read_text().splitlines()
            if json.loads(x)["type"] == "scalar"}


def test_port_and_jax_trainers_window_and_rotate_alike(tmp_path):
    """A Connect Four run against the pool, 20 updates of 128 steps, a
    checkpoint and a log every 8, 4 updates a rotation: the same
    windows (sizes, caps, global steps), rotations, folds, logged series
    (the host-perf series beyond the pool's three are A17b's) and
    checkpoints. The two draw from different generators, so their games
    differ: each package's tracker gives the same average over the
    port's window reports."""
    seen = {}
    for who, cls, cfg_cls in (("jax", JaxTrainer, JaxConfig), ("port", Trainer, Config)):
        cfg = cfg_cls(**TINY_POOL)
        kw = dict(device="cpu") if who == "port" else {}
        tr = cls(cfg, tmp_path / who, quiet=True, **kw)
        s = seen[who] = {"windows": [], "folds": [], "rotations": [], "ingests": []}
        _record_trainer(tr, s)
        if who == "port":
            ingest = tr.tracker.ingest
            tr.tracker.ingest = lambda stats: (s["ingests"].append(stats), ingest(stats))
        summary = tr.train()
        s["summary"], s["avg_return"] = summary, tr.tracker.avg_return
        s["checkpoints"] = sorted(p.name for p in (tmp_path / who / "checkpoints").glob("step_*"))
    j, t = seen["jax"], seen["port"]
    assert t["windows"] == j["windows"]
    # A self-play window of 8 before the pool holds a checkpoint, then
    # windows of 4, the rotation interval.
    assert t["windows"] == [(0, 8, None), (1024, 4, 4), (1536, 4, 4), (2048, 4, 4)]
    assert t["rotations"] == j["rotations"] == t["folds"] == j["folds"] == [1024, 1536, 2048]
    assert t["checkpoints"] == j["checkpoints"]
    jn, tn = _names(tmp_path / "jax"), _names(tmp_path / "port")
    host = {"perf/host_rss_mb", "perf/host_rss_peak_mb", "perf/checkpoint_time",
            "perf/checkpoint_save_time", "perf/checkpoint_graph_time",
            "perf/device_mb_in_use", "perf/device_mb_peak"}
    assert {"train/approx_kl_max", "train/clip_fraction_max", "perf/pool_rotation_time",
            "perf/pool_window_time", "perf/pool_record_time"} <= tn
    # The port also logs the learner's share of valid samples on the pool.
    assert tn - host - {"train/learner_valid_fraction"} == jn - host
    assert set(t["summary"]) - {"train/learner_valid_fraction"} == set(j["summary"])
    tracker = JaxTracker(2)
    for stats in t["ingests"]:
        tracker.ingest(stats)
    assert t["avg_return"] == pytest.approx(tracker.avg_return, rel=1e-6)
    meta = json.loads((tmp_path / "port" / "checkpoints" / "latest" / "metadata.json").read_text())
    assert meta["recent_returns"][0] == pytest.approx(tracker.avg_return, rel=1e-6)

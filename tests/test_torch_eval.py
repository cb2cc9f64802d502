"""The eval front end's host pieces and its logits, held against the JAX
package on the same inputs: the temperature schedule, the seat maps,
placements, ``EvalStats`` and its ratings, the temperature sampler's plain
version (K14) with JAX's uniforms replayed, and ``make_acting_logits_fn``
on the committed Connect Four gauntlet checkpoints (one model, three and
Random through K7's plain version, duplicates forwarded once, a CNN beside
an MLP through the per-model path)."""

import os
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import burn_ppo_tpu.eval as jev  # noqa: E402
from burn_ppo_tpu.envs import make_env as jax_make_env  # noqa: E402
from burn_ppo_tpu.ops.categorical import apply_action_mask as jax_mask  # noqa: E402
from burn_ppo_tpu.ops.categorical import sample_with_temperature as jax_sample  # noqa: E402
from burn_ppo_tpu.utils import rewards_to_placements as jax_placements  # noqa: E402
from burn_ppo_torch import eval as ev  # noqa: E402
from burn_ppo_torch.checkpoint import CheckpointManager, build_metadata, model_leaves  # noqa: E402
from burn_ppo_torch.envs import make_env  # noqa: E402
from burn_ppo_torch.models.network import ActorCriticNetwork  # noqa: E402
from burn_ppo_torch.ops.categorical import TINY, sample_with_temperature_plain  # noqa: E402
from burn_ppo_torch.utils import rewards_to_placements  # noqa: E402
from tests.test_torch_checkpoint_load import _positions  # noqa: E402

CPU = torch.device("cpu")
GAUNTLET = Path(__file__).resolve().parent.parent / "gauntlet"
C4 = GAUNTLET / "connect_four"


def temp_args(**kw):
    base = dict(temp=None, temp_final=None, temp_cutoff=None, no_temp_cutoff=False,
                temp_decay=False)
    return SimpleNamespace(**{**base, **kw})


TEMP_CASES = [
    {},
    {"temp": 0.7},
    {"temp": 0.0, "temp_cutoff": 10, "temp_final": 0.0},
    {"temp": 1.5, "temp_cutoff": 7, "temp_final": 0.25, "temp_decay": True},
    {"temp": 0.9, "temp_cutoff": 30, "temp_final": 0.1, "temp_decay": True},
    {"temp": 0.5, "no_temp_cutoff": True},
    {"temp_cutoff": 4},
]


@pytest.mark.parametrize("env_name", ["cartpole", "connect_four", "liars_dice", "skull"])
def test_temp_schedule_matches_jax(env_name):
    """``from_args`` (defaults, overrides, decay, no cutoff) and ``get_temp``
    over moves 0-60 against JAX's jitted ``get_temp`` (the one its stats
    engine runs) bit for bit; the two refusals raise in both."""
    jenv, env = jax_make_env(env_name), make_env(env_name)
    moves = np.arange(61, dtype=np.int32)
    for kw in TEMP_CASES:
        j = jev.TempSchedule.from_args(jenv, temp_args(**kw))
        t = ev.TempSchedule.from_args(env, temp_args(**kw))
        assert (t.initial, t.final_temp, t.cutoff, t.decay) == (
            j.initial, j.final_temp, j.cutoff, j.decay), kw
        assert t.describe() == j.describe()
        want = np.asarray(jax.jit(j.get_temp)(jnp.asarray(moves)))
        got = t.get_temp(torch.from_numpy(moves)).numpy()
        np.testing.assert_array_equal(got, want, err_msg=str(kw))
        assert float(t.get_temp(3)) == float(want[3])
    if env.spec.eval_temp_cutoff is None:
        for kw in ({"temp_final": 0.1}, {"temp_decay": True}):
            with pytest.raises(ValueError, match="requires --temp-cutoff"):
                jev.TempSchedule.from_args(jenv, temp_args(**kw))
            with pytest.raises(ValueError, match="requires --temp-cutoff"):
                ev.TempSchedule.from_args(env, temp_args(**kw))
    d, jd = ev.default_temp(env), jev.TempSchedule(
        initial=jenv.spec.eval_temp, final_temp=(jenv.spec.eval_temp_cutoff or (0, 0.0))[1],
        cutoff=(jenv.spec.eval_temp_cutoff or (None,))[0])
    assert (d.initial, d.final_temp, d.cutoff) == (jd.initial, jd.final_temp, jd.cutoff)


def jax_seat_maps(monkeypatch, S, P):
    """The seat table JAX's ``run_stats_mode`` builds for S sources and P
    seats: read where it is handed to ``jnp.asarray``, the run stopped
    before its first chunk."""
    seen = []

    class Stop(Exception):
        pass

    class JnpSpy:
        def __getattr__(self, name):
            return getattr(jnp, name)

        def asarray(self, x, *a, **k):
            if isinstance(x, np.ndarray) and x.ndim == 2 and not seen:
                seen.append(x.copy())
            return jnp.asarray(x, *a, **k)

    def stop(*a, **k):
        raise Stop

    monkeypatch.setattr(jev, "jnp", JnpSpy())
    monkeypatch.setattr(jev, "make_acting_logits_fn", stop)
    env = jax_make_env("skull").with_num_players(P)
    with pytest.raises(Stop):
        jev.run_stats_mode(env, [jev.PlayerSource.random()] * S, 1, num_envs=1, seed=0,
                           quiet=True)
    monkeypatch.undo()
    return seen[0]


@pytest.mark.parametrize("S, P", [(1, 4), (4, 4), (3, 3), (5, 3), (7, 2), (2, 5), (3, 6)])
def test_seat_maps_match_jax(monkeypatch, S, P):
    """S == 1, S == P, S > P and 1 < S < P."""
    np.testing.assert_array_equal(ev.seat_maps(S, P), jax_seat_maps(monkeypatch, S, P))
    np.testing.assert_array_equal(ev.generate_permutations(P), jev.generate_permutations(P))


def test_seat_maps_refuse_too_many_arrangements():
    env = jax_make_env("skull").with_num_players(6)
    with pytest.raises(ValueError, match="tournament mode"):
        jev.run_stats_mode(env, [jev.PlayerSource.random()] * 20, 1, num_envs=1, seed=0)
    with pytest.raises(ValueError, match="tournament mode"):
        ev.seat_maps(20, 6)


def test_rewards_to_placements_matches_jax_on_near_ties():
    rng = np.random.default_rng(0)
    levels = np.array([0.0, 4e-7, 9e-7, 1.2e-6, 1.0, 1.0 + 5e-7, -1.0, 0.33], np.float64)
    for _ in range(400):
        n = int(rng.integers(1, 7))
        r = [float(x) for x in rng.choice(levels, n)]
        assert rewards_to_placements(r) == jax_placements(r), r
    # Leader-relative grouping: 0, 6e-7, 1.2e-6 splits after the second.
    assert rewards_to_placements([1.2e-6, 6e-7, 0.0]) == jax_placements([1.2e-6, 6e-7, 0.0]) == [1, 1, 3]


def random_records(rng, S, P, n):
    perms = ev.seat_maps(S, P)
    out = []
    for _ in range(n):
        seats = perms[rng.integers(len(perms))]
        rewards = rng.choice(np.array([-1.0, 0.0, 0.33, 1.0], np.float32), P)
        out.append((seats, rewards_to_placements([float(x) for x in rewards]), rewards))
    return out


@pytest.mark.parametrize("names, P", [(["a", "b", "Random"], 2), (["solo"], 2),
                                      (["a", "b", "c", "Random"], 4), (["p"], 1),
                                      (["a", "b"], 3)])
def test_eval_stats_match_jax(names, P, capsys):
    rng = np.random.default_rng(len(names) * 10 + P)
    j, t = jev.EvalStats(list(names), P), ev.EvalStats(list(names), P)
    for seats, places, rewards in random_records(rng, len(names), P, 150):
        j.record_game(seats, places, rewards)
        t.record_game(seats, places, rewards)
    assert t.summary_rows() == j.summary_rows()
    assert (t.draws, t.total_games, t.game_records) == (j.draws, j.total_games, j.game_records)
    for fn in ("compute_ratings", "compute_parity_ratings"):
        (tr, tn), (jr, jn) = getattr(t, fn)(), getattr(j, fn)()
        assert tn == jn
        for a, b in zip(tr.ratings, jr.ratings):
            assert a.rating == pytest.approx(b.rating, abs=1e-9)
            assert a.uncertainty == pytest.approx(b.uncertainty, abs=1e-9)
    for parity in (False, True):
        j.print_table(parity_ratings=parity)
        want = capsys.readouterr().out
        t.print_table(parity_ratings=parity)
        got = capsys.readouterr().out
        strip = [ln for ln in got.splitlines() if not ln.startswith("Rating computation")]
        assert strip == [ln for ln in want.splitlines() if not ln.startswith("Rating computation")]


@pytest.mark.parametrize("A", [2, 7, 33, 49])
def test_sample_with_temperature_plain_matches_jax(A):
    """JAX's uniforms replayed; per-row temperatures 0, 1e-3, 0.4, 1 and a
    scalar; rows with exact ties among legal actions (greedy takes the
    LAST of them)."""
    rng = np.random.default_rng(A)
    E = 512
    logits = (rng.standard_normal((E, A)) * 2).astype(np.float32)
    mask = (rng.random((E, A)) > 0.3).astype(np.float32)
    mask[:, 0] = 1.0
    tied = rng.random(E) < 0.4
    cols = rng.choice(A, 2, replace=False) if A > 2 else np.array([0, 1])
    logits[np.ix_(tied, cols)] = 20.0
    mask[np.ix_(tied, cols)] = 1.0
    temps = rng.choice(np.array([0.0, 1e-3, 0.4, 1.0], np.float32), E)
    masked = jax_mask(jnp.asarray(logits), jnp.asarray(mask))
    for i, temp in enumerate((temps, np.float32(0.0), np.float32(0.7))):
        key = jax.random.PRNGKey(100 + i)
        want = np.asarray(jax.jit(jax_sample)(key, masked, jnp.asarray(temp)))
        u = np.array(jax.random.uniform(key, (E, A), minval=TINY, maxval=1.0))
        tt = torch.from_numpy(np.array(temp)) if np.ndim(temp) else float(temp)
        got = sample_with_temperature_plain(torch.from_numpy(logits), torch.from_numpy(mask), tt,
                                            torch.from_numpy(u)).numpy()
        np.testing.assert_array_equal(got, want)
        assert got.dtype == np.int32
        # the masked-logits form (mask None) is the same function
        got2 = sample_with_temperature_plain(torch.from_numpy(np.array(masked)), None, tt,
                                             torch.from_numpy(u)).numpy()
        np.testing.assert_array_equal(got2, want)
    greedy = (temps <= 0) & tied
    assert greedy.sum() > 10
    got = sample_with_temperature_plain(torch.from_numpy(logits), torch.from_numpy(mask),
                                        torch.from_numpy(temps), torch.ones(E, A) * 0.5).numpy()
    assert (got[greedy] == cols.max()).all()  # the last of the tied columns


# ---------------------------------------------------------------------------
# make_acting_logits_fn on the gauntlet
# ---------------------------------------------------------------------------
def both_sources(specs, tmp_cnn=None):
    """(JAX sources, port sources) of specs: a gauntlet entry name, "random",
    or "cnn" (the checkpoint written by ``cnn_checkpoint``)."""
    js, ts = [], []
    for s in specs:
        if s == "random":
            js.append(jev.PlayerSource.random())
            ts.append(ev.PlayerSource.random())
            continue
        path = tmp_cnn if s == "cnn" else C4 / s
        js.append(jev.PlayerSource.checkpoint(path))
        ts.append(ev.PlayerSource.checkpoint(path, CPU))
    return js, ts


def compare_logits(specs, tmp_cnn=None, E=96, seed=0):
    js, ts = both_sources(specs, tmp_cnn)
    obs = _positions(E, seed)
    acting = np.random.default_rng(seed).integers(0, len(specs), E).astype(np.int32)
    fn = ev.make_acting_logits_fn(make_env("connect_four"), ts, E)
    want = np.asarray(jev.make_acting_logits_fn(jax_make_env("connect_four"), js, E)(
        jnp.asarray(obs), jnp.asarray(acting)))
    with torch.no_grad():
        got = fn(torch.from_numpy(obs), torch.from_numpy(acting)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    rand = np.array([specs[a] == "random" for a in acting])
    assert (got[rand] == 0).all() and (np.abs(got[~rand]).sum(1) > 0).all()
    return fn, ts


def test_acting_logits_one_model():
    fn, _ = compare_logits(["r4"])
    assert fn.path == "single"


def test_acting_logits_three_models_and_random_take_k7():
    fn, ts = compare_logits(["r4", "random", "r4_mid", "r4_best"])
    assert fn.path == "stacked" and fn.stack.num_slots == 3
    assert fn.stack.norm is not None  # each slot's obs normaliser


def test_acting_logits_duplicates_forward_once(monkeypatch):
    """Two sources of one path share one network (the load cache) and the
    logits forward it once a call."""
    js, ts = both_sources(["r4", "r4", "random"])
    assert ts[0].network is ts[1].network and ts[0].obs_norm is ts[1].obs_norm
    assert js[0].params is js[1].params
    calls = []
    net = ts[0].network
    real = net.forward_actor
    monkeypatch.setattr(net, "forward_actor", lambda x: calls.append(len(x)) or real(x))
    fn, _ = compare_logits(["r4", "r4", "random"])
    assert fn.path == "single" and len(fn.uniques) == 1
    assert calls == [96]


def test_load_cache_is_keyed_by_mtime_and_bounded(tmp_path):
    ev.PlayerSource._load_cache.clear()
    a = ev.PlayerSource.checkpoint(C4 / "r4_mid", CPU)
    b = ev.PlayerSource.checkpoint(C4 / "r4_mid", CPU)
    assert a.network is b.network and len(ev.PlayerSource._load_cache) == 1
    path = cnn_checkpoint(tmp_path)
    c = ev.PlayerSource.checkpoint(path, CPU)
    meta = path / "metadata.json"
    meta.write_text(meta.read_text())  # rewritten at the same path: a new mtime
    os.utime(meta, ns=(meta.stat().st_atime_ns, meta.stat().st_mtime_ns + 10**9))
    assert ev.PlayerSource.checkpoint(path, CPU).network is not c.network
    assert len(ev.PlayerSource._load_cache) == 3
    ev.PlayerSource._load_cache.clear()
    for i in range(ev.LOAD_CACHE_SIZE):
        ev.PlayerSource._load_cache[("x", i, "cpu")] = (None, None)
    ev.PlayerSource.checkpoint(C4 / "r4_mid", CPU)  # a new entry drops the oldest
    assert len(ev.PlayerSource._load_cache) == ev.LOAD_CACHE_SIZE
    assert ("x", 0, "cpu") not in ev.PlayerSource._load_cache
    ev.PlayerSource._load_cache.clear()


def cnn_checkpoint(tmp_path):
    """A seeded Connect Four CNN saved by the port in the shared layout."""
    net = ActorCriticNetwork(86, 7, network_type="cnn", hidden_size=32, num_hidden=1,
                             activation="relu", obs_shape=(6, 7, 2), num_conv_layers=2,
                             conv_channels=(4, 8), cnn_fc_hidden_size=32,
                             generator=torch.Generator().manual_seed(7))
    meta = build_metadata(step=5, env_name="connect_four", network=net, num_players=2)
    return CheckpointManager(tmp_path / "cnn_run").save(5, model_leaves(net), [], {}, meta)


def test_acting_logits_cnn_and_mlp_take_the_per_model_path(tmp_path):
    path = cnn_checkpoint(tmp_path)
    fn, ts = compare_logits(["cnn", "r4", "random"], tmp_cnn=path)
    assert fn.path == "per_model" and fn.stack is None


def test_k7_choice_is_made_from_the_architectures():
    """Mixed widths, activations or obs normalisation, and towers past K7's
    limits take the per-model path; the choice reads no tensor."""
    def src(network_type="ctde", hidden=512, layers=2, act="tanh", norm=True, obs=135, A=33):
        net = SimpleNamespace(network_type=network_type, hidden_size=hidden, num_hidden=layers,
                              activation=act, obs_dim=obs, action_count=A)
        return ev.PlayerSource("checkpoint", "x", network=net, obs_norm=object() if norm else None)

    takes = ev.ActingLogits._k7_takes
    assert takes([src(), src()])
    assert not takes([src(), src(hidden=256, layers=3, act="relu", norm=False)])  # Skull's field
    assert not takes([src(), src(act="relu")])
    assert not takes([src(), src(norm=False)])
    assert not takes([src(network_type="cnn"), src(network_type="cnn")])
    assert not takes([src(hidden=1024), src(hidden=1024)])
    assert not takes([src(A=65), src(A=65)])
    assert not takes([src(layers=4), src(layers=4)])  # 5 layers with the head
    assert takes([src(network_type="mlp", hidden=512, layers=3, obs=270, A=49)] * 2)

"""The eval chunk on static buffers (``eval.StatsEngine``) and its step's
seating and records (K17), on the CPU: K17's plain version against the
bookkeeping of JAX's ``step_fn`` (the seat lookup through
``make_acting_logits_fn``'s ``unique_idx``, the jitted ``get_temp``, the
advance of the move counts and permutations, the ``perm`` row) and a host
model of the kernel's arithmetic against ``get_temp``; the engine over
several chunks against the earlier eager engine (a loop that rebinds
its carry), for every logits path; ``EngineCache``'s pods against fresh
engines, and a tournament with the cache against one without it."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import burn_ppo_tpu.eval as jev  # noqa: E402
from burn_ppo_tpu.envs import make_env as jax_make_env  # noqa: E402
from burn_ppo_torch import eval as ev  # noqa: E402
from burn_ppo_torch import tournament as tt  # noqa: E402
from burn_ppo_torch.checkpoint import CheckpointManager, build_metadata, model_leaves  # noqa: E402
from burn_ppo_torch.envs import make_env  # noqa: E402
from burn_ppo_torch.envs.base import EpisodeAccumulator, EpisodeLog  # noqa: E402
from burn_ppo_torch.models.network import ActorCriticNetwork  # noqa: E402
from burn_ppo_torch.ops.categorical import TINY, sample_with_temperature  # noqa: E402
from burn_ppo_torch.ppo.rollout_graph import state_leaves  # noqa: E402

CPU = torch.device("cpu")
GAUNTLET = Path(__file__).resolve().parent.parent / "gauntlet"
C4, SKULL, LD = GAUNTLET / "connect_four", GAUNTLET / "skull", GAUNTLET / "liars_dice"

SCHEDULES = [
    dict(initial=0.7),
    dict(initial=0.4, final_temp=0.0, cutoff=10),
    dict(initial=1.5, final_temp=0.25, cutoff=7, decay=True),
    dict(initial=0.9, final_temp=0.1, cutoff=30, decay=True),
    dict(initial=1.0, final_temp=0.3, cutoff=13, decay=True),
    dict(initial=0.05, final_temp=2.0, cutoff=3, decay=True),
]


def closure(fn, name):
    """A variable that JAX's acting-logits function closes over."""
    return fn.__closure__[fn.__code__.co_freevars.index(name)].cell_contents


def sources(paths, random_at=()):
    """(JAX sources, port sources) of gauntlet paths, Random at the given
    positions."""
    js = [jev.PlayerSource.checkpoint(p) for p in paths]
    ts = [ev.PlayerSource.checkpoint(p, CPU) for p in paths]
    for i in random_at:
        js.insert(i, jev.PlayerSource.random())
        ts.insert(i, ev.PlayerSource.random())
    return js, ts


# ---------------------------------------------------------------------------
# K17's plain version against JAX's step_fn bookkeeping
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("env_name,paths,random_at", [
    ("liars_dice", [LD / "r4", LD / "r4_best", LD / "r4_mid"], (1,)),
    ("skull", [SKULL / "r4", SKULL / "r4_flagship", SKULL / "r4_mid"], (0, 3)),
    ("connect_four", [C4 / "r4", C4 / "r4_mid", C4 / "r4_best"], ()),
])
def test_seat_pass_matches_jax_seat_lookup(env_name, paths, random_at):
    """slot = unique_idx[perm_table[perm_idx, player]] (-1 where the source
    is Random), the player read from a strided column; exact."""
    jenv, env = jax_make_env(env_name), make_env(env_name)
    js, ts = sources(paths, random_at)
    P, E = env.spec.num_players, 300
    jfn = jev.make_acting_logits_fn(jenv, js, E)
    unique_idx, is_random = (np.asarray(closure(jfn, n)) for n in ("unique_idx", "is_random"))
    perms = ev.seat_maps(len(ts), P)
    rng = np.random.default_rng(len(ts))
    perm_idx = rng.integers(0, len(perms), E).astype(np.int32)
    players = rng.integers(0, P, E).astype(np.int32)
    acting = np.asarray(jnp.asarray(perms)[jnp.asarray(perm_idx), jnp.asarray(players)])
    want = np.where(is_random[acting], -1, unique_idx[acting])
    columns = torch.from_numpy(rng.integers(0, 9, (E, 5)).astype(np.int32))
    columns[:, 3] = torch.from_numpy(players)
    logits = ev.ActingLogits(env, ts, CPU)
    slot, temps = torch.full((E,), 99, dtype=torch.int32), torch.zeros(E)
    ev.step_books(torch.from_numpy(perms), torch.from_numpy(perm_idx),
                  torch.zeros(E, dtype=torch.int32),
                  seats=ev.Seats(columns[:, 3], logits.slot_of_source,
                                 ev.TempSchedule(initial=0.5), slot, temps))
    np.testing.assert_array_equal(slot.numpy(), want)
    assert set(want) >= ({-1} if random_at else set()) | {0, 1}
    assert (temps.numpy() == np.float32(0.5)).all()


def test_seat_pass_without_a_player_column_seats_player_0():
    perm_table = torch.tensor([[2], [0], [1]], dtype=torch.int32)
    slot, temps = torch.zeros(4, dtype=torch.int32), torch.zeros(4)
    ev.step_books(perm_table, torch.tensor([0, 1, 2, 0], dtype=torch.int32),
                  torch.zeros(4, dtype=torch.int32),
                  seats=ev.Seats(None, torch.tensor([5, -1, 7], dtype=torch.int32),
                                 ev.TempSchedule(initial=1.0), slot, temps))
    assert slot.tolist() == [7, 5, -1, 7]


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_seat_pass_temperatures_match_jax_jitted_get_temp(schedule):
    """Moves 0 to 2 x cutoff (and past it), bit for bit against JAX's
    jitted get_temp, which the stats engine runs."""
    cutoff = schedule.get("cutoff") or 20
    moves = np.concatenate([np.arange(2 * cutoff + 3), [97, 1000]]).astype(np.int32)
    E = moves.shape[0]
    want = np.asarray(jax.jit(jev.TempSchedule(**schedule).get_temp)(jnp.asarray(moves)))
    temps = torch.full((E,), -1.0)
    ev.step_books(torch.zeros(1, 1, dtype=torch.int32), torch.zeros(E, dtype=torch.int32),
                  torch.from_numpy(moves),
                  seats=ev.Seats(None, torch.zeros(1, dtype=torch.int32),
                                 ev.TempSchedule(**schedule), torch.zeros(E, dtype=torch.int32),
                                 temps))
    np.testing.assert_array_equal(temps.numpy(), want)
    if schedule.get("decay"):
        assert len(np.unique(want)) > cutoff // 2  # the ramp is taken


def kernel_model_temps(args: tuple, moves: np.ndarray) -> np.ndarray:
    """csrc/eval_step.cu ``temperature`` in numpy, from the kernel's
    arguments: an f32 product with the f32 reciprocal, clamped; the ramp
    in f64, rounded once; ``final`` where move >= cutoff."""
    mode, initial, final, span, cutoff, inv = args
    move = moves.astype(np.float32)
    if mode == 0:
        return np.full(move.shape, initial, np.float32)
    ramp = np.full(move.shape, initial, np.float32)
    if mode == 2:
        t = np.clip(move * np.float32(inv), np.float32(0), np.float32(1))
        ramp = (t.astype(np.float64) * np.float64(span) + np.float64(initial)).astype(np.float32)
    return np.where(move >= np.float32(cutoff), np.float32(final), ramp)


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_kernel_arguments_give_get_temp_bit_for_bit(schedule):
    """What the kernel computes from ``TempSchedule.kernel_args`` equals
    the plain version's temperatures (the kernel itself runs on the card)."""
    t = ev.TempSchedule(**schedule)
    moves = np.arange(200, dtype=np.int32)
    args = t.kernel_args()
    assert all(float(np.float32(a)) == a for a in args[1:])  # f32 constants
    np.testing.assert_array_equal(kernel_model_temps(args, moves),
                                  t.get_temp(torch.from_numpy(moves)).numpy())


@pytest.mark.parametrize("schedule", SCHEDULES[1:4])
def test_fused_pass_matches_jax_advance_then_the_next_steps_seats(schedule):
    """K17's fused pass (the records of step t, then the seats of t + 1) on
    the CPU: row t, the advance, and the next step's slot and temperature
    as JAX's step_fn forms them in its next iteration (the advanced
    permutation and move count, the stepped state's player, the jitted
    get_temp), exact; and equal to the record half alone, then the seat
    half alone."""
    rng = np.random.default_rng(18)
    T, E, P = 4, 301, 4
    perms = ev.seat_maps(5, P)
    n_perms = len(perms)
    slot_of_source = np.array([0, -1, 1, 2, 3], dtype=np.int32)
    move = rng.integers(0, 2 * 30, E).astype(np.int32)
    perm_idx = rng.integers(0, n_perms, E).astype(np.int32)
    done = (rng.random(E) < 0.3).astype(np.float32)
    outcome = rng.integers(0, 5, (E, P)).astype(np.int32)
    totals = rng.normal(size=(E, P)).astype(np.float32)
    columns = rng.integers(0, P, (E, 7)).astype(np.int32)
    jd = jnp.asarray(done) > 0
    new_move = jnp.where(jd, 0, jnp.asarray(move) + 1)
    new_perm = jnp.where(jd, (jnp.asarray(perm_idx) + 1) % n_perms, jnp.asarray(perm_idx))
    acting = np.asarray(jnp.asarray(perms)[new_perm, jnp.asarray(columns[:, 2])])
    want_slot = slot_of_source[acting]
    want_temp = np.asarray(jax.jit(jev.TempSchedule(**schedule).get_temp)(new_move))
    temp = ev.TempSchedule(**schedule)
    step_log = EpisodeLog(completed=torch.from_numpy(done), total_rewards=torch.from_numpy(totals),
                          length=torch.zeros(E, dtype=torch.int32),
                          outcome=torch.from_numpy(outcome),
                          active_players=torch.zeros(E, dtype=torch.int32))
    outs = []
    for fused in (True, False):
        log = ev.ChunkLog.create(T, E, P, CPU)
        mc, pi = torch.from_numpy(move.copy()), torch.from_numpy(perm_idx.copy())
        slot, temps = torch.full((E,), 99, dtype=torch.int32), torch.full((E,), -1.0)
        table, player = torch.from_numpy(perms), torch.from_numpy(columns)[:, 2]
        sources = torch.from_numpy(slot_of_source)
        records = ev.Records(log, 2, step_log)
        seats = ev.Seats(player, sources, temp, slot, temps)
        if fused:
            ev.step_books(table, pi, mc, records, seats)
        else:
            ev.step_books(table, pi, mc, records=records)
            ev.step_books(table, pi, mc, seats=seats)
        outs.append([x.clone() for x in (mc, pi, slot, temps, *state_leaves(log))])
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    mc, pi, slot, temps = outs[0][:4]
    np.testing.assert_array_equal(mc.numpy(), np.asarray(new_move))
    np.testing.assert_array_equal(pi.numpy(), np.asarray(new_perm))
    np.testing.assert_array_equal(slot.numpy(), want_slot)
    np.testing.assert_array_equal(temps.numpy(), want_temp)
    np.testing.assert_array_equal(outs[0][4 + 3][2].numpy(), perm_idx)  # the log's perm row
    assert (want_slot == -1).any() and (np.asarray(new_move) >= temp.cutoff).any()


def test_a_chunk_runs_the_seat_pass_once_the_fused_pass_t_minus_1_times_and_the_record_pass_once(
        monkeypatch):
    """The engine's chunk of T steps: K17's seat pass before the first
    step, the fused pass after each step but the last, the record pass
    after the last (T + 1 launches on a card)."""
    calls = []
    real = ev.step_books

    def books(*a, **k):
        halves = dict(zip(("records", "seats"), a[3:]), **k)
        calls.append({(True, True): "record_and_seat", (True, False): "record_step",
                      (False, True): "sample_seats"}[
            (halves.get("records") is not None, halves.get("seats") is not None)])
        return real(*a, **k)

    monkeypatch.setattr(ev, "step_books", books)
    env = make_env("connect_four")
    engine = ev.StatsEngine(env, [ev.PlayerSource.random()] * 2, 8, ev.default_temp(env),
                            ev.random_source(0, CPU), CPU, chunk_steps=5)
    engine.eager_chunk()
    assert calls == ["sample_seats"] + ["record_and_seat"] * 4 + ["record_step"]


def test_record_pass_matches_jax_advance_and_perm_row():
    """Row t of the log: the step's log and the permutation BEFORE the
    advance (eval.py:586); move counts and permutations advanced where
    done (587-592), in place; exact."""
    rng = np.random.default_rng(17)
    T, E, P, n_perms = 5, 257, 4, 24
    move = rng.integers(0, 60, E).astype(np.int32)
    perm_idx = rng.integers(0, n_perms, E).astype(np.int32)
    done = (rng.random(E) < 0.3).astype(np.float32)
    outcome = rng.integers(0, 5, (E, P)).astype(np.int32)
    totals = rng.normal(size=(E, P)).astype(np.float32)
    jd = jnp.asarray(done) > 0
    want_move = np.asarray(jnp.where(jd, 0, jnp.asarray(move) + 1))
    want_perm = np.asarray(jnp.where(jd, (jnp.asarray(perm_idx) + 1) % n_perms,
                                     jnp.asarray(perm_idx)))
    log = ev.ChunkLog.create(T, E, P, CPU)
    step_log = EpisodeLog(completed=torch.from_numpy(done), total_rewards=torch.from_numpy(totals),
                          length=torch.zeros(E, dtype=torch.int32),
                          outcome=torch.from_numpy(outcome),
                          active_players=torch.zeros(E, dtype=torch.int32))
    mc, pi = torch.from_numpy(move.copy()), torch.from_numpy(perm_idx.copy())
    ev.step_books(torch.zeros(n_perms, P, dtype=torch.int32), pi, mc,
                  ev.Records(log, 3, step_log))
    np.testing.assert_array_equal(mc.numpy(), want_move)
    np.testing.assert_array_equal(pi.numpy(), want_perm)
    got = log.fetch()
    np.testing.assert_array_equal(got["perm"][3], perm_idx)
    np.testing.assert_array_equal(got["completed"][3], done)
    np.testing.assert_array_equal(got["outcome"][3], outcome)
    np.testing.assert_array_equal(got["total_rewards"][3], totals)
    assert not got["completed"][[0, 1, 2, 4]].any()  # other rows untouched
    assert 0 < done.sum() < E and (want_perm == 0).any()  # a wrap past the last perm


# ---------------------------------------------------------------------------
# The engine against the earlier eager loop
# ---------------------------------------------------------------------------
class EagerEngine:
    """The stats engine as it ran before graphs: the shared networks forwarded
    through ``ActingLogits``, the carry rebound every step, a new log
    every chunk."""

    def __init__(self, env, srcs, num_envs, temp, rng, chunk_steps):
        P = env.spec.num_players
        self.env, self.temp, self.rng = env, temp, rng
        self.num_envs, self.chunk_steps = num_envs, chunk_steps
        self.perms = ev.seat_maps(len(srcs), P)
        self.perm_table = torch.from_numpy(self.perms).long()
        self.n_perms = self.perms.shape[0]
        self.logits = ev.ActingLogits(env, srcs, CPU)
        with torch.no_grad():
            self.states = env.reset(env.draw_reset(rng, num_envs))
            self.acc = EpisodeAccumulator.zero(num_envs, P, CPU)
            self.obs, self.mask = env.obs(self.states), env.action_mask(self.states)
        self.move_count = torch.zeros(num_envs, dtype=torch.int32)
        self.perm_idx = torch.arange(num_envs, dtype=torch.int32) % self.n_perms

    def step(self, log, t):
        env, E, rng = self.env, self.num_envs, self.rng
        players = env.current_player(self.states)
        acting = self.perm_table[self.perm_idx.long(), players.long()]
        logits = self.logits(self.obs, acting)
        temps = self.temp.get_temp(self.move_count)
        actions = sample_with_temperature(
            logits, self.mask, temps, rng.uniform((E, env.spec.num_actions), TINY, 1.0))
        out = env.step_autoreset(self.states, self.acc, actions, env.draw_reset(rng, E),
                                 env.draw_step(rng, E))
        log.completed[t] = out.log.completed
        log.outcome[t] = out.log.outcome
        log.total_rewards[t] = out.log.total_rewards
        log.perm[t] = self.perm_idx
        done = out.done > 0
        self.move_count = torch.where(done, 0, self.move_count + 1).to(torch.int32)
        self.perm_idx = torch.where(done, (self.perm_idx + 1) % self.n_perms,
                                    self.perm_idx).to(torch.int32)
        self.states, self.acc, self.obs, self.mask = out.state, out.acc, out.obs, out.mask

    def run_chunk(self):
        log = ev.ChunkLog.create(self.chunk_steps, self.num_envs, self.env.spec.num_players, CPU)
        with torch.no_grad():
            for t in range(self.chunk_steps):
                self.step(log, t)
        return log

    def carry(self):
        return state_leaves([self.states, self.acc, self.obs, self.mask, self.move_count,
                             self.perm_idx])


def cnn_checkpoint(root: Path) -> Path:
    net = ActorCriticNetwork(86, 7, network_type="cnn", hidden_size=32, activation="relu",
                             obs_shape=(6, 7, 2), num_conv_layers=1, conv_channels=(4,),
                             cnn_fc_hidden_size=16, generator=torch.Generator().manual_seed(3))
    mgr = CheckpointManager(root / "cnn")
    meta = build_metadata(step=1, env_name="connect_four", network=net, num_players=2)
    mgr.save(1, model_leaves(net), [], {}, meta)
    return root / "cnn" / "checkpoints" / "step_00000001"


LINEUPS = {
    "connect_four_stacked": ("connect_four", [C4 / "r4", C4 / "r4_mid"], (), "stacked"),
    "connect_four_single": ("connect_four", [C4 / "r4"], (1,), "single"),
    "skull_three_and_random_stacked": ("skull", [SKULL / "r4", SKULL / "r4_best",
                                                 SKULL / "r4_mid"], (3,), "stacked"),
    "skull_per_model": ("skull", [SKULL / "r4", SKULL / "r4_flagship"], (2, 3), "per_model"),
    "connect_four_cnn_per_model": ("connect_four", ["cnn", C4 / "r4"], (), "per_model"),
    "liars_dice_random": ("liars_dice", [], (0, 1, 2, 3), "random"),
}


def lineup(name, tmp_path):
    env_name, paths, random_at, path = LINEUPS[name]
    paths = [cnn_checkpoint(tmp_path) if p == "cnn" else p for p in paths]
    return make_env(env_name), sources(paths, random_at)[1], path


@pytest.mark.parametrize("name", sorted(LINEUPS))
def test_static_engine_equals_the_eager_loop_chunk_after_chunk(name, tmp_path):
    """Three chunks of 32 steps from one seed: every log array and the
    final carry bit for bit, the generator at the same state."""
    env, srcs, path = lineup(name, tmp_path)
    E, T, temp = 12, 32, ev.default_temp(env)
    old = EagerEngine(env, srcs, E, temp, ev.random_source(8, CPU), T)
    new = ev.StatsEngine(env, srcs, E, temp, ev.random_source(8, CPU), CPU, chunk_steps=T)
    assert new.logits.path == path
    games = 0
    for _ in range(3):
        want, got = old.run_chunk().fetch(), new.run_chunk().fetch()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{name}: {k}")
        games += int(want["completed"].sum())
        for a, b in zip(state_leaves(new.carry), old.carry(), strict=True):
            assert a.dtype == b.dtype and torch.equal(a, b), name
    assert torch.equal(new.rng.generator.get_state(), old.rng.generator.get_state())
    assert games > 0 and new.chunks == 3 and new.graph is None


def test_engine_forwards_copies_never_the_load_caches_networks(tmp_path):
    """The engine's networks, obs normalisers and stack are its own
    buffers: a graph never reads the load cache's shared objects."""
    for name in ("connect_four_single", "skull_per_model", "skull_three_and_random_stacked"):
        env, srcs, path = lineup(name, tmp_path)
        engine = ev.StatsEngine(env, srcs, 4, ev.default_temp(env), ev.random_source(0, CPU), CPU)
        shared = {p.data_ptr() for s in srcs if s.network is not None
                  for p in [*s.network.parameters(), *state_leaves(s.obs_norm)]}
        own = ([p.data_ptr() for u in engine.logits.uniques
                for p in [*u.network.parameters(), *state_leaves(u.obs_norm)]]
               if path != "stacked" else [t.data_ptr() for t in state_leaves(engine.logits.stack)])
        assert own and not shared & set(own), name


# ---------------------------------------------------------------------------
# Engines reused across pods
# ---------------------------------------------------------------------------
def tiny_checkpoints(root: Path, n: int, env_name="liars_dice", hidden=32) -> list:
    env = make_env(env_name)
    out = []
    for i in range(n):
        net = ActorCriticNetwork(env.spec.obs_dim, env.spec.num_actions, hidden_size=hidden,
                                 num_hidden=1, activation="tanh",
                                 generator=torch.Generator().manual_seed(100 + i))
        mgr = CheckpointManager(root / f"run{i}")
        meta = build_metadata(step=10 * (i + 1), env_name=env_name, network=net,
                              num_players=env.spec.num_players)
        mgr.save(10 * (i + 1), model_leaves(net), [], {}, meta)
        out.append(root / f"run{i}" / "checkpoints" / f"step_{10 * (i + 1):08d}")
    return out


def test_a_cached_engine_plays_each_pod_as_a_fresh_engine(tmp_path):
    """One key, pods of 3 and 4 unique models (one holding Random): the
    cached engine's chunks equal a fresh engine's with the pod's seed; a
    lineup of another key builds another engine and a wrong one is
    refused."""
    ckpts = tiny_checkpoints(tmp_path, 4)
    env, temp = make_env("liars_dice"), ev.TempSchedule(initial=1.0)
    srcs = [ev.PlayerSource.checkpoint(p, CPU) for p in ckpts]
    pods = [(srcs, 11), ([srcs[2], ev.PlayerSource.random(), srcs[0], srcs[3]], 12),
            ([srcs[1], srcs[2], srcs[3], srcs[0]], 13)]
    cache = ev.EngineCache()
    for pod, seed in pods:
        engine = cache.engine(env, pod, 6, temp, seed, CPU, chunk_steps=24)
        fresh = ev.StatsEngine(env, pod, 6, temp, ev.random_source(seed, CPU), CPU, chunk_steps=24)
        for _ in range(2):
            got, want = engine.run_chunk().fetch(), fresh.run_chunk().fetch()
            for k in want:
                np.testing.assert_array_equal(got[k], want[k], err_msg=f"seed {seed}: {k}")
        for a, b in zip(state_leaves(engine.carry), state_leaves(fresh.carry), strict=True):
            assert torch.equal(a, b)
    assert (cache.built, cache.reused, len(cache.engines)) == (1, 2, 1)
    rand = ev.PlayerSource.random()
    other = cache.engine(env, [srcs[0], rand, rand, srcs[0]], 6, temp, 1, CPU, chunk_steps=24)
    assert other.logits.path == "single" and other is not engine
    assert (cache.built, len(cache.engines)) == (2, 2)
    with pytest.raises(ValueError, match="another key"):
        engine.logits.load(srcs[:1] + [rand] * 3)


class EnginePerPod(ev.EngineCache):
    """An engine a pod, as the tournament built them before the cache."""

    def engine(self, *args, **kw):
        self.engines.clear()
        return super().engine(*args, **kw)


def test_tournament_with_the_engine_cache_equals_one_without(tmp_path, monkeypatch, capsys):
    """Four tiny Liar's Dice checkpoints and Random, pods of four: five
    pods of one key, four holding Random. Game records, ratings,
    standings and the pods log bit for bit with the cache and with an
    engine a pod."""
    ckpts = tiny_checkpoints(tmp_path, 4)
    kept = []
    real = tt.run_stats_mode
    monkeypatch.setattr(tt, "run_stats_mode", lambda *a, **k: kept.append(real(*a, **k))
                        or kept[-1])
    runs, printed = [], []
    for cache in (ev.EngineCache, EnginePerPod):
        kept.clear()
        monkeypatch.setattr(tt, "EngineCache", cache)
        res = tt.run_tournament(ckpts, num_games=4, num_envs=4, include_random=True, seed=5,
                                device="cpu")
        runs.append((res, [s.game_records for s in kept]))
        printed.append(capsys.readouterr().out)
    assert "Stats engines: 1 built, reused for 4 pods" in printed[0]
    assert "Stats engines: 5 built, reused for 0 pods" in printed[1]
    (a, rec_a), (b, rec_b) = runs
    assert rec_a == rec_b and len(rec_a) == 5 and all(len(r) == 4 for r in rec_a)
    assert a["rankings"] == b["rankings"] and a["pods"] == b["pods"]
    assert sorted(p["logits"] for p in a["pods"]) == ["stacked"] * 5


def test_k17_fused_wrapper_launches_once_with_both_halves_arguments(monkeypatch):
    """K17's fused pass with a stand-in library: one launch of
    ``eval_step_books`` with the arguments its signature lists: the counts
    and permutations, the perm table, the step's log, row t of the log by
    pointer, the stepped state's player column where it lies (pointer and
    stride), the sources' slots, the schedule's f32 constants, the slot
    and temperature outputs; nothing allocated; one count."""
    from burn_ppo_torch import kernels
    from tests.test_torch_import import _cuda_path_on_cpu

    lib = _cuda_path_on_cpu(monkeypatch, ev.step_books)
    before = ev.step_books.launches
    E, P = 6, 4
    ints = torch.zeros(E, 9, dtype=torch.int32)
    perm_table = torch.zeros(24, P, dtype=torch.int32)
    perm_idx, move = torch.zeros(E, dtype=torch.int32), torch.zeros(E, dtype=torch.int32)
    slot, temps = torch.zeros(E, dtype=torch.int32), torch.zeros(E)
    sources = torch.zeros(5, dtype=torch.int32)
    temp = ev.TempSchedule(initial=1.5, final_temp=0.25, cutoff=7, decay=True)
    log = ev.ChunkLog.create(3, E, P, CPU)
    done = torch.zeros(E)
    step_log = EpisodeLog(completed=done, total_rewards=torch.zeros(E, P),
                          length=torch.zeros(E, dtype=torch.int32),
                          outcome=torch.zeros(E, P, dtype=torch.int32),
                          active_players=torch.zeros(E, dtype=torch.int32))
    made = []
    real_empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda *a, **k: made.append(a) or real_empty(*a, **k))
    ev.step_books(perm_table, perm_idx, move, ev.Records(log, 2, step_log),
                  ev.Seats(ints[:, 4], sources, temp, slot, temps))
    (name, args), = lib.calls
    assert name == "eval_step_books" and len(args) == len(kernels.SIGNATURES[name])
    assert args[:5] == (perm_idx.data_ptr(), move.data_ptr(), perm_table.data_ptr(), 24, P)
    assert args[5] == done.data_ptr()
    assert args[8:12] == tuple(x[2].data_ptr() for x in (log.completed, log.outcome,
                                                         log.total_rewards, log.perm))
    assert args[12] == ints[:, 4].data_ptr() and args[13] == 9
    assert args[14] == sources.data_ptr()
    assert args[15:21] == temp.kernel_args()
    assert args[21:24] == (slot.data_ptr(), temps.data_ptr(), E) and not made
    assert ev.step_books.launches == before + 1


def test_k17_wrappers_launch_once_each_with_the_strided_player_and_the_log_row(monkeypatch):
    """K17's halves alone with a stand-in library: the seat half reads the
    player column where it lies (its pointer and stride, no copy), takes
    the schedule's f32 constants and passes null record pointers; the
    record half writes row t of the log by pointer and passes a null slot
    and temperature; each is one launch of the one entry; neither half
    at all is refused before a launch."""
    from burn_ppo_torch import kernels
    from tests.test_torch_import import _cuda_path_on_cpu

    lib = _cuda_path_on_cpu(monkeypatch, ev.step_books)
    before = ev.step_books.launches
    E, P = 6, 4
    ints = torch.zeros(E, 9, dtype=torch.int32)
    perm_table = torch.zeros(24, P, dtype=torch.int32)
    perm_idx, move = torch.zeros(E, dtype=torch.int32), torch.zeros(E, dtype=torch.int32)
    slot, temps = torch.zeros(E, dtype=torch.int32), torch.zeros(E)
    temp = ev.TempSchedule(initial=1.5, final_temp=0.25, cutoff=7, decay=True)
    made = []
    real_empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda *a, **k: made.append(a) or real_empty(*a, **k))
    ev.step_books(perm_table, perm_idx, move,
                  seats=ev.Seats(ints[:, 4], torch.zeros(5, dtype=torch.int32), temp, slot, temps))
    (name, args), = lib.calls
    assert name == "eval_step_books" and len(args) == len(kernels.SIGNATURES[name])
    assert args[:5] == (perm_idx.data_ptr(), move.data_ptr(), perm_table.data_ptr(), 24, P)
    assert args[5:12] == (None,) * 7
    assert args[12] == ints[:, 4].data_ptr() and args[13] == 9
    assert args[15:21] == temp.kernel_args() and args[21:24] == (slot.data_ptr(),
                                                                temps.data_ptr(), E)
    log = ev.ChunkLog.create(3, E, P, CPU)
    done = torch.zeros(E)
    step_log = EpisodeLog(completed=done, total_rewards=torch.zeros(E, P),
                          length=torch.zeros(E, dtype=torch.int32),
                          outcome=torch.zeros(E, P, dtype=torch.int32),
                          active_players=torch.zeros(E, dtype=torch.int32))
    ev.step_books(perm_table, perm_idx, move, ev.Records(log, 2, step_log))
    name, args = lib.calls[1]
    assert name == "eval_step_books" and len(args) == len(kernels.SIGNATURES[name])
    assert args[:5] == (perm_idx.data_ptr(), move.data_ptr(), perm_table.data_ptr(), 24, P)
    assert args[5] == done.data_ptr()
    assert args[8:12] == tuple(x[2].data_ptr() for x in (log.completed, log.outcome,
                                                         log.total_rewards, log.perm))
    assert args[12] is None and args[21:24] == (None, None, E) and not made
    with pytest.raises(ValueError):
        ev.step_books(perm_table, perm_idx, move)
    assert len(lib.calls) == 2 and ev.step_books.launches == before + 2

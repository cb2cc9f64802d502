"""The eval front end run whole on the CPU against the JAX package: the
stats engine (Connect Four greedy, ``EvalStats`` equal to JAX's; Liar's
Dice with three gauntlet checkpoints and Random, step for step with JAX's
reset and sampling draws replayed), watch mode and a human game (the
printed text equal to JAX's), and ``eval`` through ``cli.main(...,
device="cpu")`` with its seat rules and refusals."""

import itertools
import json
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
from burn_ppo_tpu.envs.base import EpisodeAccumulator as JaxAcc  # noqa: E402
from burn_ppo_tpu.envs.base import autoreset_step as jax_autoreset_step  # noqa: E402
from burn_ppo_tpu.ops.categorical import apply_action_mask as jax_mask  # noqa: E402
from burn_ppo_tpu.ops.categorical import sample_with_temperature as jax_sample  # noqa: E402
from burn_ppo_torch import cli  # noqa: E402
from burn_ppo_torch import eval as ev  # noqa: E402
from burn_ppo_torch.envs import make_env  # noqa: E402
from burn_ppo_torch.envs.liars_dice import LiarsDice  # noqa: E402
from burn_ppo_torch.ops.categorical import TINY  # noqa: E402
from tests.test_torch_liars_dice import u_of  # noqa: E402
from tests.test_torch_skull_ctde_step import ReplaySource  # noqa: E402

CPU = torch.device("cpu")
GAUNTLET = Path(__file__).resolve().parent.parent / "gauntlet"
C4, LD = GAUNTLET / "connect_four", GAUNTLET / "liars_dice"
GREEDY = dict(initial=0.0, final_temp=0.0, cutoff=10)


def sources(paths, random=False):
    js = [jev.PlayerSource.checkpoint(p) for p in paths]
    ts = [ev.PlayerSource.checkpoint(p, CPU) for p in paths]
    if random:
        js.append(jev.PlayerSource.random())
        ts.append(ev.PlayerSource.random())
    return js, ts


def assert_stats_equal(t, j):
    assert t.game_records == j.game_records
    assert (t.placements, t.rewards, t.games) == (j.placements, j.rewards, j.games)
    assert (t.draws, t.total_games) == (j.draws, j.total_games)
    assert t.summary_rows() == j.summary_rows()


def test_connect_four_greedy_stats_match_jax():
    """r4 against r4_mid, greedy, 16 envs, 64 games: every game is
    deterministic, so the records must be JAX's exactly (K7's plain
    version for the two stacked models)."""
    js, ts = sources([C4 / "r4", C4 / "r4_mid"])
    j = jev.run_stats_mode(jax_make_env("connect_four"), js, 64, num_envs=16,
                           temp=jev.TempSchedule(**GREEDY), seed=3, quiet=True)
    t = ev.run_stats_mode(make_env("connect_four"), ts, 64, num_envs=16,
                          temp=ev.TempSchedule(**GREEDY), seed=3, quiet=True)
    assert t.logits_path == "stacked"
    assert_stats_equal(t, j)
    assert t.total_games == 64 and 0 < t.draws < 64


# ---------------------------------------------------------------------------
# Liar's Dice step for step
# ---------------------------------------------------------------------------
E_LD, T_LD = 8, 32  # envs, steps a chunk (two chunks)


def jax_engine_draws(jsrcs, seed, steps):
    """JAX's stats engine (eval.py:551-594) stepped one step at a time:
    its actions, episode logs and permutations, the sampling uniforms of
    each step's key, and the dice of its resets and rerolls."""
    env = jax_make_env("liars_dice")
    P, A = 4, 49
    perm_table = jnp.asarray(ev.seat_maps(len(jsrcs), P))
    n_perms = perm_table.shape[0]
    key, k_reset = jax.random.split(jax.random.PRNGKey(seed))
    states = jax.vmap(env.reset)(jax.random.split(k_reset, E_LD))
    init_dice = np.asarray(states.dice)
    acc = jax.vmap(lambda _: JaxAcc.zero(P))(jnp.arange(E_LD))
    move = jnp.zeros(E_LD, jnp.int32)
    perm_idx = jnp.arange(E_LD, dtype=jnp.int32) % n_perms
    logits_fn = jev.make_acting_logits_fn(env, jsrcs, E_LD)
    temp = jev.TempSchedule(initial=env.spec.eval_temp)

    @jax.jit
    def step(states, acc, move, perm_idx, key):
        k, k_sample, k_reset = jax.random.split(key, 3)
        obs = jax.vmap(env.obs)(states)
        mask = jax.vmap(env.action_mask)(states).astype(jnp.float32)
        acting = perm_table[perm_idx, jax.vmap(env.current_player)(states)]
        masked = jax_mask(logits_fn(obs, acting), mask)
        actions = jax_sample(k_sample, masked, temp.get_temp(move))
        reset_keys = jax.random.split(k_reset, E_LD)
        nxt, nacc, term, log = jax.vmap(
            lambda s, a, act, rk: jax_autoreset_step(env, s, a, act, rk))(states, acc, actions,
                                                                       reset_keys)
        done = term.done
        carry = (nxt, nacc, jnp.where(done, 0, move + 1),
                 jnp.where(done, (perm_idx + 1) % n_perms, perm_idx), k)
        u = jax.random.uniform(k_sample, (E_LD, A), minval=TINY, maxval=1.0)
        return carry, (actions, log, perm_idx, u, jax.vmap(env.reset)(reset_keys).dice, term.dice)

    out = []
    carry = (states, acc, move, perm_idx, key)
    for _ in range(steps):
        carry, rec = step(*carry)
        out.append(jax.tree_util.tree_map(np.asarray, rec))
    return init_dice, out


class ReplayDice(LiarsDice):
    """The port's Liar's Dice handed JAX's dice: each step's reset and
    reroll uniforms ``(face - 0.5) / 6``; it keeps the actions it was given."""

    def __init__(self, draws):
        self.draws, self.actions = list(draws), []

    def step_autoreset(self, state, acc, action, reset_values, step_values=None):
        u_reset, u_step = self.draws.pop(0)
        self.actions.append(action.numpy().copy())
        return super().step_autoreset(state, acc, action, torch.from_numpy(u_reset),
                                      torch.from_numpy(u_step))


def replay(init_dice, recs):
    """The port's random source and env for JAX's draws: the first reset's
    dice, then per step the sampling uniforms and two placeholders (the
    reset and reroll draws, replaced by ``ReplayDice``)."""
    src = ReplaySource()
    src.uniforms.append(u_of(init_dice))
    for rec in recs:
        src.uniforms += [rec[3], np.zeros((E_LD, 8), np.float32), np.zeros((E_LD, 8), np.float32)]
    return src, ReplayDice([(u_of(r[4]), u_of(r[5])) for r in recs])


def test_liars_dice_three_checkpoints_and_random_step_for_step():
    paths = [LD / "r4", LD / "r4_best", LD / "r4_mid"]
    js, ts = sources(paths, random=True)
    init_dice, recs = jax_engine_draws(js, seed=11, steps=2 * T_LD)
    src, env = replay(init_dice, recs)
    engine = ev.StatsEngine(env, ts, E_LD, ev.default_temp(env), src, CPU, chunk_steps=T_LD)
    # three models stacked for K7, in a stack of a slot per source
    assert engine.logits.path == "stacked" and len(engine.logits.uniques) == 3
    assert engine.logits.stack.num_slots == 4
    logs = [engine.run_chunk().fetch() for _ in range(2)]
    assert not src.uniforms and not env.draws  # every draw consumed, in order
    for t, rec in enumerate(recs):
        actions, log, perm = rec[0], rec[1], rec[2]
        got = logs[t // T_LD]
        i = t % T_LD
        np.testing.assert_array_equal(env.actions[t], actions, err_msg=f"step {t} actions")
        np.testing.assert_array_equal(got["completed"][i], log.completed.astype(np.float32))
        np.testing.assert_array_equal(got["perm"][i], perm)
        done = log.completed
        np.testing.assert_array_equal(got["outcome"][i][done], log.outcome[done])
        np.testing.assert_array_equal(got["total_rewards"][i][done], log.total_rewards[done])
    games = sum(int(g["completed"].sum()) for g in logs)
    first = int(logs[0]["completed"].sum())
    assert first > 4 and games > first + 4
    assert {a for acts in env.actions for a in acts} >= {48}  # calls happened

    # JAX's own engine, two chunks, against run_stats_mode on the replay.
    j = jev.run_stats_mode(jax_make_env("liars_dice"), js, games, num_envs=E_LD, seed=11,
                           chunk_steps=T_LD, quiet=True)
    src, env = replay(init_dice, recs)
    t = ev.run_stats_mode(env, ts, games, num_envs=E_LD, chunk_steps=T_LD, quiet=True, rng=src)
    assert not env.draws
    assert_stats_equal(t, j)
    assert t.total_games == games


# ---------------------------------------------------------------------------
# Watch mode and human play: the same text as JAX's
# ---------------------------------------------------------------------------
def test_watch_mode_prints_jax_text(capsys):
    """Two greedy Connect Four games, seats rotating between them."""
    js, ts = sources([C4 / "r4", C4 / "r4_mid"])
    jev.run_watch_mode(jax_make_env("connect_four"), js, 2, jev.TempSchedule(**GREEDY), seed=0)
    want = capsys.readouterr().out
    ev.run_watch_mode(make_env("connect_four"), ts, 2, ev.TempSchedule(**GREEDY), seed=0,
                      device=CPU)
    got = capsys.readouterr().out
    assert got == want
    assert want.count("=== Game") == 2 and "Final rewards" in want and "wins!" in want


def scripted_input(monkeypatch):
    moves = itertools.chain(["help", "hint", "render", "x", "9", "random"],
                            itertools.cycle(["4", "3", "5", "hint", "2", "6", "1", "7"]))
    monkeypatch.setattr("builtins.input", lambda prompt="": next(moves))


def test_human_game_prints_jax_text(monkeypatch, capsys):
    """A human (scripted input: every command, an unparsable and an
    illegal move, a random move, hints) against greedy r4."""
    import random

    js, ts = sources([C4 / "r4"])
    js.insert(0, jev.PlayerSource.human("Me"))
    ts.insert(0, ev.PlayerSource.human("Me"))
    outs = []
    for run, env, srcs, Temp in ((jev.run_interactive_evaluation, jax_make_env("connect_four"),
                                  js, jev.TempSchedule),
                                 (ev.run_interactive_evaluation, make_env("connect_four"), ts,
                                  ev.TempSchedule)):
        scripted_input(monkeypatch)
        random.seed(5)
        kw = {} if run is jev.run_interactive_evaluation else {"device": CPU}
        run(env, srcs, 1, Temp(**GREEDY), seed=0, **kw)
        outs.append(capsys.readouterr().out)
    assert outs[1] == outs[0]
    assert "Column" in outs[0] and "%" in outs[0] and "invalid input" in outs[0]
    assert "(random)" in outs[0] and "Wins:" in outs[0]


# ---------------------------------------------------------------------------
# The eval command
# ---------------------------------------------------------------------------
def eval_cli(*argv):
    return cli.main(["eval", *map(str, argv)], device="cpu")


def test_eval_cli_stats_watch_and_skull_players(capsys):
    assert eval_cli("-c", C4 / "r4", "--random", "-n", "8", "--num-envs", "8", "--seed", "1") == 0
    out = capsys.readouterr().out
    assert "Results over 8 games" in out and "Random" in out and "rated games" in out
    assert eval_cli("-c", C4 / "r4", "--random", "--watch", "-n", "1", "--seed", "1",
                    "--temp", "0") == 0
    assert "Final rewards" in capsys.readouterr().out
    assert eval_cli("-c", GAUNTLET / "skull" / "r4", "--random", "--players", "3", "-n", "3",
                    "--num-envs", "4", "--seed", "2", "--parity-ratings") == 0
    out = capsys.readouterr().out
    assert "Results over 3 games" in out and "Ratings:" in out


def cli_args(**kw):
    base = dict(temp=None, temp_final=None, temp_cutoff=None, no_temp_cutoff=False,
                temp_decay=False, env_name=None, players=None, num_games=1, seed=0, watch=False,
                step=False, animate=False, fps=2.0, num_envs=8, random=False, checkpoints=[])
    return SimpleNamespace(**{**base, **kw})


def test_eval_cli_human_never_truncated(monkeypatch):
    """Excess NON-human sources drop: the human keeps a seat
    (tests/test_eval_extra.py:311-335)."""
    srcs = [ev.PlayerSource.random(), ev.PlayerSource.random(), ev.PlayerSource.human("Me")]
    monkeypatch.setattr(ev, "build_sources", lambda a, e=None, device=None: (srcs, "connect_four"))
    captured = {}

    def fake_interactive(env, seats, num_games, temp, seed, device=None):
        captured["seats"] = seats

    monkeypatch.setattr(ev, "run_interactive_evaluation", fake_interactive)
    assert ev.run_evaluation_cli(cli_args(humans=["Me"]), device=CPU) == 0
    seats = captured["seats"]
    assert len(seats) == 2 and seats[0].kind == "random" and seats[1].kind == "human"


def test_eval_cli_too_many_humans_errors(monkeypatch, capsys):
    srcs = [ev.PlayerSource.human(n) for n in "ABC"]
    monkeypatch.setattr(ev, "build_sources", lambda a, e=None, device=None: (srcs, "connect_four"))
    assert ev.run_evaluation_cli(cli_args(humans=list("ABC")), device=CPU) == 1
    assert "humans" in capsys.readouterr().out


def test_eval_cli_human_seats_fill_with_non_humans(monkeypatch, capsys):
    """One human at a four-player table: the other seats cycle the
    non-human sources, and the game is played through the CLI."""
    moves = itertools.cycle(["random"])
    monkeypatch.setattr("builtins.input", lambda prompt="": next(moves))
    assert eval_cli("-c", GAUNTLET / "skull" / "r4", "--random", "--human", "Me", "-n", "1",
                    "--seed", "4") == 0
    out = capsys.readouterr().out
    assert "Wins:" in out and "Me" in out and "=== Skull (4 players) ===" in out


def test_eval_cli_without_players_errors(capsys):
    assert eval_cli("-e", "connect_four") == 1
    assert "need at least one" in capsys.readouterr().out
    assert eval_cli() == 1
    assert "no checkpoint given" in capsys.readouterr().out


def reference_checkpoint(tmp_path):
    """A directory of the Rust reference's layout: metadata.json and a Burn
    model.mpk that decodes to an empty map (no tensors), no model.npz."""
    d = tmp_path / "burn_ckpt"
    d.mkdir()
    meta = json.loads((C4 / "r4" / "metadata.json").read_text())
    (d / "metadata.json").write_text(json.dumps(meta))
    (d / "model.mpk").write_bytes(b"\x80")
    return d


def test_burn_mpk_checkpoint_is_refused_with_exit_2(tmp_path, capsys):
    """A Burn record without the network's tensors fails the port's import
    as it fails JAX's (KeyError, the same message), and ``eval`` and
    ``tournament`` exit 2 naming it; a well-formed one is accepted."""
    from burn_ppo_torch import interop
    from burn_ppo_tpu import interop as jinterop
    from tests.test_torch_interop import write_burn_dir

    d = reference_checkpoint(tmp_path)
    errors = []
    for load in (jinterop.load_reference_checkpoint, interop.load_reference_checkpoint):
        with pytest.raises(KeyError, match="missing tensor") as e:
            load(d)
        errors.append(str(e.value))
    assert errors[0] == errors[1]
    assert eval_cli("-c", d, "--random", "-n", "2") == 2
    err = capsys.readouterr().err
    assert "Burn record not imported" in err and "missing tensor" in err
    assert cli.main(["tournament", str(d), str(C4 / "r4"), "-n", "2"], device="cpu") == 2
    assert "missing tensor" in capsys.readouterr().err
    good = write_burn_dir(C4 / "r4", tmp_path / "good" / "r4")
    assert eval_cli("-c", good, "--random", "-n", "2") == 0
    assert "games: 2/2" in capsys.readouterr().out


def test_interactive_still_refused_and_no_cpu_fallback(monkeypatch, capsys):
    """The assistant is Skull's: a Connect Four checkpoint exits 2; no front
    end falls back to the CPU without a card."""
    assert cli.main(["interactive", str(C4 / "r4")], device="cpu") == 2
    assert "requires skull checkpoints" in capsys.readouterr().err
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cmd in (["eval", "-c", str(C4 / "r4"), "--random"], ["tournament", str(C4 / "r4"), "--random"],
                ["interactive", str(C4.parent / "skull" / "r4")]):
        with pytest.raises(RuntimeError, match="cuda"):
            cli.main(cmd)

"""Skull of the port (the plain path of kernel K11) against
``jax.vmap(autoreset_step)`` over the JAX package's ``Skull`` and against
the plain-Python rules oracle, at 2-6 players. Every output compares
exactly: states, rewards, done, the episode log, obs, mask and the
privileged obs.

The walks mix legal moves with unmasked and out-of-range actions, finished
games fed back in, forced discards and a shaping coefficient above 0. The
lost coaster is JAX's own draw, replayed: for each env the JAX state's key
gives ``choice = randint(0, c)``, and the port gets ``u = (choice + 0.5) / c``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from burn_ppo_tpu.envs.base import EpisodeAccumulator as JaxAcc  # noqa: E402
from burn_ppo_tpu.envs.base import autoreset_step as jax_autoreset_step  # noqa: E402
from burn_ppo_tpu.envs.skull import Skull as JaxSkull  # noqa: E402
from burn_ppo_torch.envs.base import (  # noqa: E402
    EpisodeAccumulator,
    first_true_clockwise,
    push_ring_row,
)
from burn_ppo_torch.envs.skull import A, FIELDS, Skull, SkullState  # noqa: E402
from burn_ppo_torch.ppo.rollout import RandomSource  # noqa: E402
from tests.oracles.skull_oracle import SkullOracle  # noqa: E402

_JAX_FNS = {}


def jax_fns(n):
    """Jitted vmapped autoreset step (with the post-reset obs, mask and
    privileged obs) and the replayed coaster draw of JAX's ``Skull(n)``."""
    if n not in _JAX_FNS:
        env = JaxSkull(n)

        @jax.jit
        def step(state, acc, action, keys):
            nxt, nacc, term, log = jax.vmap(
                lambda s, a, act, k: jax_autoreset_step(env, s, a, act, k))(state, acc, action, keys)
            return (nxt, nacc, term, log, jax.vmap(env.obs)(nxt), jax.vmap(env.action_mask)(nxt),
                    jax.vmap(env.privileged_obs)(nxt))

        @jax.jit
        def choice(keys, c):
            return jax.vmap(lambda k, m: jax.random.randint(jax.random.split(k)[1], (), 0, m))(keys, c)

        _JAX_FNS[n] = (env, step, choice)
    return _JAX_FNS[n]


def replay_u(choice_fn, js) -> np.ndarray:
    """The port's uniforms that give JAX's coaster choice of every env of
    the JAX state ``js`` (skull.py:404-410)."""
    has_trap, roses = np.asarray(js.has_trap), np.asarray(js.rose_count)
    bidder = np.asarray(js.current_bidder)
    b = np.clip(bidder, 0, 5)
    rows = np.arange(len(b))
    coasters = np.where(bidder >= 0, has_trap[rows, b].astype(np.int32) + roses[rows, b], 0)
    c = np.maximum(coasters, 1).astype(np.int32)
    choice = np.asarray(choice_fn(js.key, jnp.asarray(c)))
    return ((choice + 0.5) / c).astype(np.float32)


def to_jax(ts: SkullState, like, n):
    """The JAX state of the port's numpy state, keeping JAX's keys."""
    E = ts.phase.shape[0]
    return like.replace(**{f: jnp.asarray(getattr(ts, f).numpy()) for f in FIELDS},
                        rewards=jnp.zeros((E, n), jnp.float32), done=jnp.zeros(E, bool))


def pick_actions(rng, mask, p_masked=0.01, p_wild=0.005):
    """Mostly legal actions, half of them the highest legal one (the
    highest bid or a pass, the last seat to reveal), so that rounds reach
    their challenge and games end; a few unmasked and out-of-range ones."""
    E = mask.shape[0]
    actions = np.empty(E, np.int32)
    for e in range(E):
        legal, illegal = np.flatnonzero(mask[e]), np.flatnonzero(mask[e] == 0)
        x = rng.random()
        if x < p_wild or not legal.size:
            actions[e] = rng.choice([-1, 33, 40])
        elif x < p_wild + p_masked and illegal.size:
            actions[e] = rng.choice(illegal)
        elif x < 0.5:
            actions[e] = legal[-1]
        else:
            actions[e] = rng.choice(legal)
    return actions


def compare(j, t, n, where=""):
    nxt, nacc, term, log, obs, mask, priv = j
    eq = np.testing.assert_array_equal
    for f in FIELDS:
        eq(getattr(t.state, f).numpy(), np.asarray(getattr(nxt, f)), err_msg=f"{where} state.{f}")
    eq(t.rewards.numpy(), np.asarray(term.rewards), err_msg=f"{where} rewards")
    eq(t.done.numpy(), np.asarray(term.done, np.float32), err_msg=f"{where} done")
    eq(t.log.total_rewards.numpy(), np.asarray(log.total_rewards), err_msg=f"{where} log.total")
    eq(t.log.length.numpy(), np.asarray(log.length), err_msg=f"{where} log.length")
    eq(t.log.outcome.numpy(), np.asarray(log.outcome), err_msg=f"{where} log.outcome")
    eq(t.log.active_players.numpy(), np.asarray(log.active_players))
    eq(t.acc.reward_sum.numpy(), np.asarray(nacc.reward_sum), err_msg=f"{where} acc")
    eq(t.acc.length.numpy(), np.asarray(nacc.length))
    eq(t.obs.numpy(), np.asarray(obs), err_msg=f"{where} obs")
    eq(t.mask.numpy(), np.asarray(mask, np.float32), err_msg=f"{where} mask")
    eq(t.priv.numpy(), np.asarray(priv), err_msg=f"{where} priv")


def random_walk(n, E, T, seed, on_step=None):
    """E envs of ``Skull(n)`` for T steps, port and JAX side by side.
    Before every step a few envs get a forced discard, a few are marked
    finished; half play with shaping 0.05. Returns the event counts."""
    jenv, jstep, jchoice = jax_fns(n)
    env = Skull(n)
    rng = np.random.default_rng(seed)
    key = jax.random.PRNGKey(seed)
    key, sub = jax.random.split(key)
    js = jax.vmap(jenv.reset)(jax.random.split(sub, E))
    ts = env.reset(torch.empty(E, 0))
    ts = dataclasses.replace(ts, shaping_coef=torch.from_numpy(
        np.where(np.arange(E) % 2 == 0, 0.05, 0.0).astype(np.float32)))
    acc = EpisodeAccumulator.zero(E, n, torch.device("cpu"))
    j_acc = JaxAcc(reward_sum=jnp.zeros((E, n)), length=jnp.zeros(E, jnp.int32))
    seen = {"elim": 0, "game_end": 0, "invalid": 0, "finished_in": 0, "forced": 0, "shaped": 0,
            "hist_full": 0, "phase": [0, 0, 0]}
    for t in range(T):
        fd = np.where(rng.random(E) < 0.15, rng.integers(0, 2, E), -1).astype(np.int32)
        over = ts.game_over.numpy() | (rng.random(E) < 0.003)
        ts = dataclasses.replace(ts, forced_discard=torch.from_numpy(fd),
                                 game_over=torch.from_numpy(over))
        js = to_jax(ts, js, n)
        mask = env.action_mask(ts).numpy()
        actions = pick_actions(rng, mask)
        u = replay_u(jchoice, js)
        key, sub = jax.random.split(key)
        j = jstep(js, j_acc, jnp.asarray(actions), jax.random.split(sub, E))
        out = env.step_autoreset(ts, acc, torch.from_numpy(actions), torch.empty(E, 0),
                                 torch.from_numpy(u))
        compare(j, out, n, f"P{n} step {t}")
        if on_step is not None:
            on_step(ts, actions, u, out)
        phase = ts.phase.numpy()
        rew = out.rewards.numpy()
        done = out.done.numpy() > 0
        legal = mask[np.arange(E), np.clip(actions, 0, A - 1)] > 0
        bad = over | (actions < 0) | (actions >= A) | ~legal
        seen["invalid"] += int((bad & ~over).sum())
        seen["finished_in"] += int(over.sum())
        seen["forced"] += int(((fd >= 0) & (phase == 2) & ~bad).sum())
        seen["shaped"] += int(((np.abs(rew).sum(1) > 0) & ~done).sum())
        seen["game_end"] += int((done & ~bad).sum())
        seen["hist_full"] += int((ts.hist_len.numpy() == 8).sum())
        seen["elim"] += int((out.state.num_eliminated.numpy() > ts.num_eliminated.numpy()).sum())
        for p in range(3):
            seen["phase"][p] += int((phase == p).sum())
        js, j_acc = j[0], j[1]
        ts, acc = out.state, out.acc
    return seen


@pytest.mark.parametrize("n", [2, 3, 4, 5, 6])
def test_random_walks_match_jax_exactly(n):
    seen = random_walk(n, E=32, T=100, seed=n)
    assert min(seen["phase"]) > 0, seen
    for k in ("invalid", "finished_in", "forced", "shaped", "game_end"):
        assert seen[k] > 0, (k, seen)
    assert seen["elim"] > 0 or n == 2, seen  # two players: the first elimination ends the game
    assert seen["hist_full"] > 0 or n < 6, seen  # a full bid history, shifting


def test_oracle_agrees_on_whole_games():
    """The rules engine written from the reference, not from the JAX env:
    legal moves (half of them the highest), the discard choice mirrored
    into forced_discard, until every env has finished a game."""
    for n, seed in ((2, 1), (4, 2), (6, 3)):
        rng = np.random.default_rng(seed)
        env = Skull(n)
        E = 8
        oracles = [SkullOracle(n, 0.05) for _ in range(E)]
        ts = env.reset(torch.empty(E, 0))
        ts = dataclasses.replace(ts, shaping_coef=torch.full((E,), 0.05))
        acc = EpisodeAccumulator.zero(E, n, torch.device("cpu"))
        finished = np.zeros(E, bool)
        for _ in range(400):
            if finished.all():
                break
            mask, obs, priv = env.action_mask(ts).numpy(), env.obs(ts).numpy(), env.privileged_obs(ts).numpy()
            actions = np.zeros(E, np.int32)
            fd = np.full(E, -1, np.int32)
            discard = [None] * E
            for e, o in enumerate(oracles):
                np.testing.assert_array_equal(mask[e], np.array(o.action_mask(), np.float32))
                np.testing.assert_allclose(obs[e], o.observation(), rtol=0, atol=1e-7)
                np.testing.assert_allclose(priv[e], o.privileged_obs(), rtol=0, atol=1e-7)
                moves = np.flatnonzero(mask[e])
                actions[e] = moves[-1] if rng.random() < 0.5 else rng.choice(moves)
                if o.phase == "revealing":
                    b = o.current_bidder
                    legal = (["skull"] if o.has_trap[b] else []) + (["rose"] if o.rose_count[b] else [])
                    discard[e] = legal[int(rng.integers(len(legal)))]
                    fd[e] = 0 if discard[e] == "skull" else 1
            ts = dataclasses.replace(ts, forced_discard=torch.from_numpy(fd))
            out = env.step_autoreset(ts, acc, torch.from_numpy(actions), torch.empty(E, 0),
                                     torch.rand(E))
            for e, o in enumerate(oracles):
                rewards, done = o.step(int(actions[e]), discard[e])
                np.testing.assert_allclose(out.rewards[e].numpy(), rewards, rtol=0, atol=1e-7)
                assert bool(out.done[e]) == done
                if done:
                    np.testing.assert_array_equal(out.log.outcome[e].numpy(), o.placements())
                    finished[e] = True
                    o.reset()
            ts, acc = out.state, out.acc
        assert finished.all()


def test_turn_order_helpers_match_jax():
    from burn_ppo_tpu.envs.base import first_true_clockwise as jax_ftc
    from burn_ppo_tpu.envs.base import push_ring_row as jax_push

    rng = np.random.default_rng(0)
    for n in (2, 4, 6):
        ok = (rng.random((200, 6)) < 0.3) & (np.arange(6) < n)
        frm = rng.integers(0, n, 200).astype(np.int32)
        want = np.asarray(jax.vmap(lambda o, f: jax_ftc(o, f, n))(jnp.asarray(ok), jnp.asarray(frm)))
        got = first_true_clockwise(torch.from_numpy(ok), torch.from_numpy(frm), n).numpy()
        np.testing.assert_array_equal(got, want)
        assert (got >= 0).all() and (got < n).all()
    hist = rng.integers(0, 9, (50, 8, 2)).astype(np.int32)
    hlen = rng.integers(0, 9, 50).astype(np.int32)
    entry = rng.integers(0, 9, (50, 2)).astype(np.int32)
    jh, jl = jax.vmap(lambda h, l, e: jax_push(h, l, e, 8))(jnp.asarray(hist), jnp.asarray(hlen),
                                                           jnp.asarray(entry))
    th, tl = push_ring_row(torch.from_numpy(hist), torch.from_numpy(hlen), torch.from_numpy(entry), 8)
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))


def test_step_draws_one_uniform_per_env_and_the_reset_none():
    class Counting(RandomSource):
        def __init__(self):
            self.calls = []

        def uniform(self, shape, low, high):
            self.calls.append(tuple(shape))
            return torch.full(shape, 0.5)

    env = Skull(4)
    src = Counting()
    assert env.draw_reset(src, 5).shape == (5, 0)
    assert env.draw_step(src, 5).shape == (5,)
    assert src.calls == [(5,)]
    with pytest.raises(ValueError):
        Skull(7)
    assert env.with_num_players(3).spec.num_players == 3

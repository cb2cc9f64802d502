"""Liar's Dice of the port (the plain path of kernel K13) against
``jax.vmap(autoreset_step)`` over the JAX package's ``LiarsDice`` and against
the plain-Python rules oracle. Every output compares exactly: states,
rewards, done, the episode log, obs, mask and the privileged obs.

The walks mix legal moves with unmasked and out-of-range actions (-1, 49,
55), finished games fed back in and a shaping coefficient above 0. The dice
are JAX's own draws, replayed: the fresh game's from ``reset`` of the JAX
reset keys, the reroll's from JAX's stepped state, each handed to the port
as ``u = (face - 0.5) / 6``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from burn_ppo_tpu.envs.base import EpisodeAccumulator as JaxAcc  # noqa: E402
from burn_ppo_tpu.envs.base import autoreset_step as jax_autoreset_step  # noqa: E402
from burn_ppo_tpu.envs.liars_dice import LiarsDice as JaxLiarsDice  # noqa: E402
from burn_ppo_torch.envs.base import EpisodeAccumulator  # noqa: E402
from burn_ppo_torch.envs.liars_dice import (  # noqa: E402
    A,
    CALL,
    FIELDS,
    FACES,
    W,
    LiarsDice,
    LiarsDiceState,
    faces,
    walk_actions,
)
from burn_ppo_torch.ppo.rollout import RandomSource  # noqa: E402
from tests.oracles.liars_dice_oracle import LiarsDiceOracle  # noqa: E402

P = 4
_JAX = {}


def jax_fns():
    """JAX's env, its jitted vmapped autoreset step (with the post-reset
    obs, mask and privileged obs), reset and views."""
    if not _JAX:
        env = JaxLiarsDice()

        def views(s):
            return (jax.vmap(env.obs)(s), jax.vmap(env.action_mask)(s),
                    jax.vmap(env.privileged_obs)(s))

        @jax.jit
        def step(state, acc, action, keys):
            nxt, nacc, term, log = jax.vmap(
                lambda s, a, act, k: jax_autoreset_step(env, s, a, act, k))(state, acc, action, keys)
            return (nxt, nacc, term, log, *views(nxt))

        _JAX.update(env=env, step=step, reset=jax.jit(jax.vmap(env.reset)), views=jax.jit(views))
    return _JAX


def u_of(dice) -> np.ndarray:
    """The uniforms that give these [E, 4, 2] dice: (face - 0.5) / 6."""
    d = np.asarray(dice)
    return ((d.reshape(d.shape[0], -1) - 0.5) / FACES).astype(np.float32)


def to_port(js) -> LiarsDiceState:
    return LiarsDiceState.of(torch.from_numpy(np.array(js.shaping_coef)),
                             **{f: torch.from_numpy(np.array(getattr(js, f))) for f in FIELDS})


def to_jax(ts: LiarsDiceState, like):
    """The JAX state of the port's state, keeping JAX's keys."""
    E = ts.ints.shape[0]
    return like.replace(**{f: jnp.asarray(getattr(ts, f).numpy()) for f in FIELDS},
                        shaping_coef=jnp.asarray(ts.shaping_coef.numpy()),
                        rewards=jnp.zeros((E, P), jnp.float32), done=jnp.zeros(E, bool))


def replay(js, keys, j):
    """(reset uniforms, reroll uniforms) that replay JAX's dice of one step."""
    return (torch.from_numpy(u_of(jax_fns()["reset"](keys).dice)),
            torch.from_numpy(u_of(j[2].dice)))


def compare(j, t, where=""):
    nxt, nacc, term, log, obs, mask, priv = j
    eq = np.testing.assert_array_equal
    for f in FIELDS:
        eq(getattr(t.state, f).numpy(), np.asarray(getattr(nxt, f)), err_msg=f"{where} state.{f}")
    eq(t.state.shaping_coef.numpy(), np.asarray(nxt.shaping_coef), err_msg=f"{where} shaping")
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


def random_walk(E, T, seed):
    """E envs for T steps, port and JAX side by side (walk_actions: calls,
    patient rounds, unmasked and out-of-range actions); before every step
    0.3% are marked finished; half play with shaping 0.05. Returns the
    event counts."""
    fns = jax_fns()
    env = LiarsDice()
    g = torch.Generator().manual_seed(seed)
    key = jax.random.PRNGKey(seed)
    key, sub = jax.random.split(key)
    js = fns["reset"](jax.random.split(sub, E))
    js = js.replace(shaping_coef=jnp.asarray(np.where(np.arange(E) % 2 == 0, 0.05, 0.0), jnp.float32))
    ts = to_port(js)
    acc = EpisodeAccumulator.zero(E, P, torch.device("cpu"))
    j_acc = JaxAcc(reward_sum=jnp.zeros((E, P)), length=jnp.zeros(E, jnp.int32))
    seen = dict.fromkeys(("calls", "eliminations", "game_ends", "invalid", "finished_in",
                          "shaped", "hist_full", "out_of_range", "rows_with_zero_pad"), 0)
    for t in range(T):
        over = ts.game_over | (torch.rand(E, generator=g) < 0.003)
        ts = LiarsDiceState.of(ts.shaping_coef, **{**ts.fields(), "game_over": over})
        js = to_jax(ts, js)
        mask = env.action_mask(ts)
        actions = walk_actions(mask, g)
        keys = jax.random.split(jax.random.fold_in(key, t), E)
        j = fns["step"](js, j_acc, jnp.asarray(actions.numpy()), keys)
        u_reset, u_step = replay(js, keys, j)
        out = env.step_autoreset(ts, acc, actions, u_reset, u_step)
        compare(j, out, f"step {t}")
        a = actions.numpy()
        legal = mask.numpy()[np.arange(E), np.clip(a, 0, A - 1)] > 0
        bad = over.numpy() | (a < 0) | (a >= A) | ~legal
        done = out.done.numpy() > 0
        seen["invalid"] += int((bad & ~over.numpy()).sum())
        seen["out_of_range"] += int(((a < 0) | (a >= A)).sum())
        seen["finished_in"] += int(over.sum())
        seen["calls"] += int(((a == CALL) & ~bad).sum())
        seen["game_ends"] += int((done & ~bad).sum())
        seen["shaped"] += int(((np.abs(out.rewards.numpy()).sum(1) > 0) & ~done).sum())
        seen["hist_full"] += int((ts.hist_len.numpy() == 16).sum())
        seen["eliminations"] += int((out.state.num_eliminated > ts.num_eliminated).sum())
        seen["rows_with_zero_pad"] += int((out.state.ints[:, LiarsDiceState.PAD_COL:] == 0)
                                          .all(1).sum())
        js, j_acc = j[0], j[1]
        ts, acc = out.state, out.acc
    return seen


@pytest.mark.parametrize("seed", [0, 1])
def test_random_walks_match_jax_exactly(seed):
    seen = random_walk(E=48, T=120, seed=seed)
    for k, v in seen.items():
        assert v > 0, (k, seen)


def test_a_walk_through_the_padded_state_matches_jax_and_keeps_the_pad_at_zero():
    """The state is 73 columns of LAYOUT and 3 zero pad columns (rows of
    304 bytes, 16-byte aligned for K13); the plain step, reset and ``of``
    leave the pad at zero at every step of a walk that matches JAX."""
    assert (LiarsDiceState.PAD_COL, W) == (73, 76)
    E, T = 16, 60
    seen = random_walk(E=E, T=T, seed=2)
    assert seen["rows_with_zero_pad"] == E * T
    assert seen["calls"] > 0 and seen["game_ends"] > 0


def test_oracle_agrees_on_whole_games():
    """The rules engine written from the reference, not from the JAX env:
    legal moves (a third of them calls) until every env has finished two
    games; the oracle gets the port's dice at every reset and reroll."""
    rng = np.random.default_rng(3)
    env = LiarsDice()
    E = 8
    g = torch.Generator().manual_seed(3)
    u0 = torch.rand(E, 8, generator=g)
    ts = env.reset(u0)
    ts = LiarsDiceState(ts.ints, torch.full((E,), 0.05))
    oracles = [LiarsDiceOracle(d.tolist(), 0.05) for d in faces(u0)]
    acc = EpisodeAccumulator.zero(E, P, torch.device("cpu"))
    finished = np.zeros(E, int)
    for _ in range(600):
        if (finished >= 2).all():
            break
        mask, obs, priv = (env.action_mask(ts).numpy(), env.obs(ts).numpy(),
                           env.privileged_obs(ts).numpy())
        actions = np.zeros(E, np.int32)
        for e, o in enumerate(oracles):
            np.testing.assert_array_equal(mask[e], np.array(o.action_mask(), np.float32))
            np.testing.assert_allclose(obs[e], o.observation(), rtol=0, atol=1e-7)
            np.testing.assert_allclose(priv[e], o.privileged_obs(), rtol=0, atol=1e-7)
            moves = np.flatnonzero(mask[e])
            actions[e] = CALL if mask[e, CALL] and rng.random() < 0.35 else rng.choice(moves[:4])
        u_reset, u_step = torch.rand(E, 8, generator=g), torch.rand(E, 8, generator=g)
        out = env.step_autoreset(ts, acc, torch.from_numpy(actions), u_reset, u_step)
        for e, o in enumerate(oracles):
            rewards, done = o.step(int(actions[e]), faces(u_step)[e].tolist())
            np.testing.assert_allclose(out.rewards[e].numpy(), rewards, rtol=0, atol=1e-7)
            assert bool(out.done[e]) == done
            if done:
                np.testing.assert_array_equal(out.log.outcome[e].numpy(), o.placements())
                finished[e] += 1
                o.reset(faces(u_reset)[e].tolist())
        ts, acc = out.state, out.acc
    assert (finished >= 2).all()


# -- hand cases, each stepped by JAX beside the port ----------------------
def fresh_fields(E=1):
    f = {name: np.asarray(getattr(jax_fns()["reset"](jax.random.split(jax.random.PRNGKey(9), E)),
                                  name)) for name in FIELDS}
    return {k: np.array(v) for k, v in f.items()}


def both(fields: dict, action: int, shaping=0.05, seed=0):
    """One step of a single env built from ``fields`` by JAX and the port,
    compared exactly; returns (port output, JAX's stepped state)."""
    fns = jax_fns()
    E = fields["dice"].shape[0]
    keys = jax.random.split(jax.random.PRNGKey(seed), E)
    like = fns["reset"](keys)
    shaping = np.full(E, shaping, np.float32)
    js = like.replace(**{f: jnp.asarray(v) for f, v in fields.items()},
                      shaping_coef=jnp.asarray(shaping))
    ts = to_port(js)
    acts = np.full(E, action, np.int32)
    j = fns["step"](js, JaxAcc(reward_sum=jnp.zeros((E, P)), length=jnp.zeros(E, jnp.int32)),
                    jnp.asarray(acts), keys)
    u_reset, u_step = replay(js, keys, j)
    out = LiarsDice().step_autoreset(ts, EpisodeAccumulator.zero(E, P, torch.device("cpu")),
                                     torch.from_numpy(acts), u_reset, u_step)
    compare(j, out)
    return out, j[2]


def with_bid(dice, qty, face, bidder=3, current=0, dice_count=(2, 2, 2, 2), **extra):
    f = fresh_fields()
    f.update(dice=np.asarray([dice], np.int32), dice_count=np.asarray([dice_count], np.int32),
             bid_qty=np.asarray([qty], np.int32), bid_face=np.asarray([face], np.int32),
             last_bidder=np.asarray([bidder], np.int32), current=np.asarray([current], np.int32),
             bid_count=np.asarray([1], np.int32), hist_len=np.asarray([1], np.int32))
    f["hist"][0, 0] = (bidder, qty, face)
    f.update({k: np.asarray([v], np.int32) for k, v in extra.items()})
    return f


def test_wild_ones_count_toward_the_bid_face():
    # Fives: 5, 1, 1 and a 5 -> four with the wild 1s; "4 fives" stands.
    dice = [[5, 1], [1, 2], [3, 5], [2, 3]]
    out, term = both(with_bid(dice, 4, 5), CALL)
    assert np.asarray(term.dice_count)[0].tolist() == [1, 2, 2, 2]  # the caller (seat 0) loses
    out, term = both(with_bid(dice, 5, 5), CALL)
    assert np.asarray(term.dice_count)[0].tolist() == [2, 2, 2, 1]  # the bidder (seat 3) loses


def test_a_bid_of_ones_counts_only_ones():
    dice = [[5, 1], [1, 2], [3, 5], [2, 3]]
    _, term = both(with_bid(dice, 2, 1), CALL)  # two 1s: the bid stands
    assert np.asarray(term.dice_count)[0].tolist() == [1, 2, 2, 2]
    _, term = both(with_bid(dice, 3, 1), CALL)
    assert np.asarray(term.dice_count)[0].tolist() == [2, 2, 2, 1]


def test_an_exact_count_means_the_bid_stands():
    dice = [[4, 4], [2, 2], [3, 6], [4, 5]]
    out, term = both(with_bid(dice, 3, 4), CALL)
    assert np.asarray(term.dice_count)[0].tolist() == [1, 2, 2, 2]
    assert int(out.state.current[0]) == 0  # the loser opens the next round
    assert int(out.state.bid_qty[0]) == 0 and int(out.state.hist_len[0]) == 0
    np.testing.assert_allclose(out.rewards[0].numpy(), [0.05] * 4)


def test_an_eliminated_loser_passes_the_opening_to_the_next_alive_seat():
    # Seat 1 bid 1 six with one die left; seat 2 is already out.
    dice = [[2, 3], [4, 1], [2, 5], [3, 3]]
    f = with_bid(dice, 2, 6, bidder=1, current=2, dice_count=(2, 1, 0, 2),
                 placements=(0, 0, 4, 0), num_eliminated=1)
    f["current"][0] = 3
    out, term = both(f, CALL)  # one six (the wild 1): seat 1 loses its last die
    assert np.asarray(term.dice_count)[0].tolist() == [2, 0, 0, 2]
    assert np.asarray(term.placements)[0].tolist() == [0, 3, 4, 0]
    assert int(out.state.current[0]) == 3  # seat 2 is out: seat 3 opens
    np.testing.assert_allclose(out.rewards[0].numpy(), [0.05, 0.0, 0.0, 0.05])


def test_the_terminal_state_keeps_its_bid_and_the_placements_replace_the_shaping():
    dice = [[6, 6], [6, 2], [2, 2], [3, 3]]
    f = with_bid(dice, 3, 6, bidder=0, current=1, dice_count=(2, 1, 0, 0),
                 placements=(0, 0, 3, 4), num_eliminated=2)
    out, term = both(f, CALL)  # three sixes: the caller (seat 1) is out, game over
    assert bool(out.done[0]) and np.asarray(term.placements)[0].tolist() == [1, 2, 3, 4]
    np.testing.assert_array_equal(out.rewards[0].numpy(),
                                  np.float32([1.0, 0.33, -0.33, -1.0]))
    assert int(term.bid_qty[0]) == 3 and int(term.hist_len[0]) == 1 and int(term.current[0]) == 1
    np.testing.assert_array_equal(np.asarray(term.dice)[0], dice)  # no reroll at game end
    assert out.log.outcome[0].tolist() == [1, 2, 3, 4]
    assert int(out.state.bid_qty[0]) == 0 and out.state.dice_count[0].tolist() == [2] * 4


@pytest.mark.parametrize("action", [-1, 49, 55, CALL, 0])
def test_invalid_actions_end_the_game_before_any_clip(action):
    """55 and 49 must not become CALL; CALL and a bid of one 1 are invalid
    here (no bid to call; not higher than two 2s)."""
    f = fresh_fields()
    if action == 0:
        f = with_bid([[1, 2], [3, 4], [5, 6], [1, 1]], 2, 2)
    out, term = both(f, action)
    assert bool(out.done[0]) and bool(term.game_over[0])
    assert out.rewards.abs().sum() == 0 and out.log.outcome[0].tolist() == list(term.placements[0])


def test_bid_counts_through_the_reciprocal_products():
    """bid_count 0-48 in the obs (min(x / 20, 1)) and the privileged obs
    (x / 12), bid faces 1-6 and history faces through / 6: as XLA computes
    them, products with the f32 reciprocals."""
    E = 49
    fns = jax_fns()
    like = fns["reset"](jax.random.split(jax.random.PRNGKey(1), E))
    rng = np.random.default_rng(0)
    hist = np.zeros((E, 16, 3), np.int32)
    hist[:, :, 0] = rng.integers(0, 4, (E, 16))
    hist[:, :, 1] = rng.integers(1, 9, (E, 16))
    hist[:, :, 2] = rng.integers(1, 7, (E, 16))
    js = like.replace(bid_count=jnp.arange(E, dtype=jnp.int32),
                      bid_qty=jnp.asarray(rng.integers(1, 9, E), jnp.int32),
                      bid_face=jnp.asarray(np.arange(E) % 6 + 1, jnp.int32),
                      last_bidder=jnp.asarray(np.arange(E) % 5 - 1, jnp.int32),
                      hist=jnp.asarray(hist), hist_len=jnp.asarray(np.arange(E) % 17, jnp.int32))
    ts = to_port(js)
    env = LiarsDice()
    obs, mask, priv = fns["views"](js)
    np.testing.assert_array_equal(env.obs(ts).numpy(), np.asarray(obs))
    np.testing.assert_array_equal(env.action_mask(ts).numpy(), np.asarray(mask, np.float32))
    np.testing.assert_array_equal(env.privileged_obs(ts).numpy(), np.asarray(priv))
    # The trap is real: true division differs at 9, 13 and 18 (/ 20) and at
    # 5, 7, 10, ... (/ 12).
    x = np.arange(E, dtype=np.float32)
    assert (np.minimum(x / np.float32(20), 1) != env.obs(ts).numpy()[:, 73]).any()
    assert (x / np.float32(12) != env.privileged_obs(ts).numpy()[:, 4]).any()


def test_state_packs_every_field_and_the_draws_have_their_shapes():
    class Counting(RandomSource):
        def __init__(self):
            self.calls = []

        def uniform(self, shape, low, high):
            self.calls.append(tuple(shape))
            return torch.full(shape, 0.999999)

    env = LiarsDice()
    src = Counting()
    s = env.reset(env.draw_reset(src, 5))
    assert env.draw_step(src, 5).shape == (5, 8) and src.calls == [(5, 8), (5, 8)]
    assert s.ints.shape == (5, W) and W == 76
    assert (s.dice == 6).all() and (s.last_bidder == -1).all() and not s.game_over.any()
    assert faces(torch.tensor([[0.0, 1 / 6 - 1e-7, 1 / 6, 0.5, 5 / 6, 0.9999999, 0.25, 0.75]])).tolist() \
        == [[[1, 1], [2, 4], [6, 6], [2, 5]]]
    again = LiarsDiceState.of(s.shaping_coef, **s.fields())
    assert torch.equal(again.ints, s.ints)
    assert env.spec.obs_dim == 270 and env.spec.privileged_obs_dim == 120 and env.spec.num_actions == A

"""The envs' human-facing helpers (``render``, ``describe_action``,
``parse_action``) against the JAX package's: random-legal walks of each
env stepped by JAX, every state (terminal ones included) rendered by both
from the same fields, every action described, and a set of typed moves
parsed (the same action, or the same error)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from burn_ppo_tpu.envs import make_env as jax_make_env  # noqa: E402
from burn_ppo_torch.envs import make_env  # noqa: E402
from burn_ppo_torch.envs.base import env_row  # noqa: E402
from burn_ppo_torch.envs.cartpole import CartPoleState  # noqa: E402
from burn_ppo_torch.envs.connect_four import ConnectFourState  # noqa: E402
from burn_ppo_torch.envs.liars_dice import FIELDS as LD_FIELDS  # noqa: E402
from burn_ppo_torch.envs.liars_dice import LiarsDiceState  # noqa: E402
from burn_ppo_torch.envs.skull import FIELDS as SKULL_FIELDS  # noqa: E402
from burn_ppo_torch.envs.skull import SkullState  # noqa: E402


def to_port(name, js, e):
    """Env ``e`` of the JAX batch ``js`` as the port's state of one env."""
    def f(field):
        return torch.from_numpy(np.array(getattr(js, field))[e:e + 1])

    if name == "cartpole":
        return CartPoleState.of(*(f(k) for k in ("x", "x_dot", "theta", "theta_dot", "step_idx")))
    if name == "connect_four":
        return ConnectFourState.of(**{k: f(k) for k in ("board", "current", "winner", "done",
                                                        "step_idx")})
    if name == "liars_dice":
        return LiarsDiceState.of(f("shaping_coef"), **{k: f(k) for k in LD_FIELDS})
    return SkullState.of(**{k: f(k) for k in SKULL_FIELDS})


CASES = [("cartpole", None), ("connect_four", None), ("liars_dice", None), ("skull", 2),
         ("skull", 4), ("skull", 6)]


@pytest.mark.parametrize("name, players", CASES)
def test_render_matches_jax_along_walks(name, players):
    jenv, env = jax_make_env(name), make_env(name)
    if players:
        jenv, env = jenv.with_num_players(players), env.with_num_players(players)
    E, rng = 4, np.random.default_rng(players or 0)
    js = jax.vmap(jenv.reset)(jax.random.split(jax.random.PRNGKey(1), E))
    step = jax.jit(jax.vmap(jenv.step))
    mask_fn = jax.jit(jax.vmap(jenv.action_mask))
    finished = np.zeros(E, bool)
    rendered = terminal = 0
    for t in range(400 if name != "cartpole" else 90):
        done = np.asarray(js.done)
        for e in range(E):
            # every third state and every terminal one
            if finished[e] or (t % 3 and not done[e]):
                continue
            want = jenv.render(jax.tree_util.tree_map(lambda x: x[e], js))
            state = to_port(name, js, e)
            assert env.render(state) == want, f"env {e}"
            rendered += 1
            terminal += bool(done[e])
            finished[e] |= bool(done[e])
        if finished.all():
            break
        mask = np.asarray(mask_fn(js))
        # half the moves the highest legal action (the highest bid, a pass,
        # the last seat to reveal), so that rounds reach their end
        actions = np.array([(np.flatnonzero(m)[-1] if rng.random() < 0.5
                             else rng.choice(np.flatnonzero(m))) if m.any() else 0 for m in mask],
                           np.int32)
        js = step(js, jnp.asarray(actions))
    assert rendered > 12 and terminal > 0


def test_render_reads_one_env_of_a_batch():
    """``index`` picks the env; the batch may live anywhere (a copy of the
    row is read on the host)."""
    env = make_env("connect_four")
    state = env.reset(torch.empty(3, 0))
    board = state.board.clone()
    board[1, 5, 3] = 1
    s = ConnectFourState.of(**{**state.fields(), "board": board})
    assert env.render(s, 1) != env.render(s, 0) == env.render(s, 2)
    assert env_row(s, 1).ints.shape == (1, s.W)


@pytest.mark.parametrize("name", ["cartpole", "connect_four", "liars_dice", "skull"])
def test_describe_and_parse_match_jax(name):
    jenv, env = jax_make_env(name), make_env(name)
    for a in range(-1, env.spec.num_actions + 3):
        assert env.describe_action(a) == jenv.describe_action(a)
    typed = ["0", "1", "l", "R", "left", " right ", "4", "7", "8", "x", "", "call", "liar",
             "3 4s", "2 6", "9 4s", "3 7s", "1 1s", "skull", "s", "rose", "p", "pass", "bid 3",
             "5", "24", "25", "reveal p2", "reveal p6", "reveal x", "bid x"]
    for text in typed:
        try:
            want = ("ok", jenv.parse_action(text))
        except Exception as e:  # noqa: BLE001 - the same error type and message
            want = (type(e).__name__, str(e))
        try:
            got = ("ok", env.parse_action(text))
        except Exception as e:  # noqa: BLE001
            got = (type(e).__name__, str(e))
        assert got == want, text

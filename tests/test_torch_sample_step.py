"""Eval's sample folded into the env step (K14's row code as the sampling
front of K1, K4, K11 and K13) and PopArt's denormalisation folded into K2
(its value epilogue), on the CPU:

* the plain path of ``Environment.step_autoreset`` with a sampling front
  (no action) against JAX's
  ``sample_with_temperature`` then JAX's env step, on JAX's uniforms, for
  all four envs with greedy ties, constant and per-row temperatures:
  actions and states bit for bit (CartPole's physics floats to 1e-6, the
  tolerance of ``tests/test_torch_cartpole.py``: XLA's and PyTorch's sin
  and cos may differ in the last bit);
* the plain path of ``masked_sample`` with PopArt's state against JAX's
  sample, log-prob and ``popart_denormalize``, the count under 2 and
  above (``tests/test_torch_popart.py``'s tolerance for the values);
* with a stand-in kernel library: ``StatsEngine.step`` launches each
  env's step entry with its sampling front once a step and never K14, and
  an env step refuses a front whose width is not the env's; the learner's
  rollout
  step K2 with its epilogue once and never K16 (the vs-pool step also
  the opponents' K2 without it).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import tests.test_torch_cartpole as tcp  # noqa: E402
import tests.test_torch_connect_four as tc4  # noqa: E402
import tests.test_torch_liars_dice as tld  # noqa: E402
import tests.test_torch_skull as tsk  # noqa: E402
from burn_ppo_tpu.envs.base import EpisodeAccumulator as JaxAcc  # noqa: E402
from burn_ppo_tpu.ops.categorical import apply_action_mask as jax_mask  # noqa: E402
from burn_ppo_tpu.ops.categorical import log_prob_categorical as jax_log_prob  # noqa: E402
from burn_ppo_tpu.ops.categorical import sample_categorical as jax_categorical  # noqa: E402
from burn_ppo_tpu.ops.categorical import sample_with_temperature as jax_sample  # noqa: E402
from burn_ppo_tpu.ppo import normalization as jn  # noqa: E402
from burn_ppo_torch import eval as ev  # noqa: E402
from burn_ppo_torch.envs.base import EpisodeAccumulator  # noqa: E402
from burn_ppo_torch.envs.cartpole import CartPole  # noqa: E402
from burn_ppo_torch.envs.connect_four import ConnectFour  # noqa: E402
from burn_ppo_torch.envs.liars_dice import LiarsDice  # noqa: E402
from burn_ppo_torch.envs.skull import Skull  # noqa: E402
from burn_ppo_torch.models.network import ActorCriticNetwork  # noqa: E402
from burn_ppo_torch.ops.categorical import TINY, TemperatureFront, masked_sample  # noqa: E402
from burn_ppo_torch.ppo import pool_rollout, rollout  # noqa: E402
from burn_ppo_torch.ppo.normalization import PopArtState  # noqa: E402
from burn_ppo_torch.ppo.rollout import RolloutBuffers, TorchRandomSource  # noqa: E402
from burn_ppo_torch.ppo.rollout_graph import state_leaves  # noqa: E402
from tests.test_torch_import import _cuda_path_on_cpu  # noqa: E402

CPU = torch.device("cpu")
E, T = 16, 10
EVAL_TEMPS = np.array([0.0, 0.4, 1.0, 1e-3], np.float32)


# Each env's JAX and port sides: fresh states, one step of each from the
# actions JAX's sampler drew, and the comparison of the two outputs.
class CartPoleSides:
    env, A = CartPole(), 2

    def start(self, keys):
        js = jax.vmap(tcp.JENV.reset)(keys)
        return js, tcp._torch_state(js)

    def step(self, js, j_acc, actions, keys, front, ts, acc):
        j = tcp._jax_step(js, j_acc, actions, keys)
        reset = torch.from_numpy(np.array(tcp._jax_reset_values(keys)))
        out = self.env.step_autoreset(ts, acc, None, reset, front=front)
        tcp._compare_step(j, out, atol=1e-6)
        # the physics carries on from JAX's state (the ulps stay out of it)
        return out.actions, j[0], j[1], tcp._torch_state(j[0]), out.acc, out.mask


class ConnectFourSides:
    env, A = ConnectFour(), 7

    def start(self, keys):
        js = jax.vmap(tc4.JENV.reset)(keys)
        return js, tc4._torch_state(js)

    def step(self, js, j_acc, actions, keys, front, ts, acc):
        j = tc4._jax_step(js, j_acc, actions, keys)
        out = self.env.step_autoreset(ts, acc, None, torch.empty(E, 0), front=front)
        tc4._compare(j, out)
        return out.actions, j[0][0], j[0][1], out.state, out.acc, out.mask


class SkullSides:
    env, A = Skull(4), 33

    def start(self, keys):
        jenv = tsk.jax_fns(4)[0]
        return jax.vmap(jenv.reset)(keys), self.env.reset(torch.empty(E, 0))

    def step(self, js, j_acc, actions, keys, front, ts, acc):
        _, jstep, jchoice = tsk.jax_fns(4)
        u = torch.from_numpy(tsk.replay_u(jchoice, js))
        j = jstep(js, j_acc, actions, keys)
        out = self.env.step_autoreset(ts, acc, None, torch.empty(E, 0), u, front=front)
        tsk.compare(j, out, 4)
        return out.actions, j[0], j[1], out.state, out.acc, out.mask


class LiarsDiceSides:
    env, A = LiarsDice(), 49

    def start(self, keys):
        js = tld.jax_fns()["reset"](keys)
        return js, tld.to_port(js)

    def step(self, js, j_acc, actions, keys, front, ts, acc):
        j = tld.jax_fns()["step"](js, j_acc, actions, keys)
        u_reset, u_step = tld.replay(js, keys, j)
        out = self.env.step_autoreset(ts, acc, None, u_reset, u_step, front=front)
        tld.compare(j, out)
        return out.actions, j[0], j[1], out.state, out.acc, out.mask


# The position of the action among each env step entry's arguments.
ACTION_ARG = {"cartpole": 4, "connect_four": 3, "skull": 4, "liars_dice": 4}
SIDES = {"cartpole": CartPoleSides, "connect_four": ConnectFourSides, "skull": SkullSides,
         "liars_dice": LiarsDiceSides}


def logits_with_greedy_ties(rng, mask: np.ndarray, temps: np.ndarray) -> tuple:
    """Random logits; each greedy row with two legal actions gets an exact
    tie at its top between two of them (the last must win). Returns the
    logits and the rows with a tie."""
    logits = (rng.normal(size=mask.shape) * 2).astype(np.float32)
    ties = 0
    for e in np.flatnonzero(temps <= 0):
        legal = np.flatnonzero(mask[e])
        if legal.size >= 2:
            two = rng.choice(legal, 2, replace=False)
            logits[e, two] = logits[e].max() + 1.0
            ties += 1
    return logits, ties


@pytest.mark.parametrize("temps", ["per_row", 0.0, 0.4])
@pytest.mark.parametrize("name", sorted(SIDES))
def test_plain_sample_step_equals_jax_sample_then_step(name, temps):
    sides = SIDES[name]()
    P = sides.env.spec.num_players
    rng = np.random.default_rng(sorted(SIDES).index(name) * 10 + ["per_row", 0.0, 0.4].index(temps))
    key = jax.random.PRNGKey(3)
    js, ts = sides.start(jax.random.split(key, E))
    acc = EpisodeAccumulator.zero(E, P, CPU)
    j_acc = JaxAcc(reward_sum=jnp.zeros((E, P)), length=jnp.zeros(E, jnp.int32))
    mask = sides.env.action_mask(ts)
    ties = 0
    for t in range(T):
        temp = (EVAL_TEMPS[rng.integers(0, 4, E)] if temps == "per_row"
                else np.full(E, temps, np.float32))
        logits, n = logits_with_greedy_ties(rng, mask.numpy(), temp)
        ties += n
        k_sample, k_step = jax.random.split(jax.random.fold_in(key, t))
        jt = jnp.asarray(temp) if temps == "per_row" else temps
        want = jax_sample(k_sample, jax_mask(jnp.asarray(logits), jnp.asarray(mask.numpy())), jt)
        u = jax.random.uniform(k_sample, (E, sides.A), minval=TINY, maxval=1.0)
        front = TemperatureFront(torch.from_numpy(logits), mask,
                                 torch.from_numpy(temp) if temps == "per_row" else temps,
                                 torch.from_numpy(np.array(u)))
        got, js, j_acc, ts, acc, mask = sides.step(js, j_acc, want, jax.random.split(k_step, E),
                                                   front, ts, acc)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=f"step {t}")
    if temps != 0.4:
        assert ties > 0  # greedy ties were broken to the last index, as JAX does


@pytest.mark.parametrize("count", [0.0, 1.0, 2.0, 57.0])
@pytest.mark.parametrize("A", [2, 49])
def test_plain_sample_with_the_popart_epilogue_equals_jax(count, A):
    rng = np.random.default_rng(int(count) * 100 + A)
    rows = 64
    logits = rng.normal(size=(rows, A)).astype(np.float32)
    mask = (rng.random((rows, A)) < 0.7).astype(np.float32)
    mask[:, 0] = 1.0
    values = rng.normal(size=rows).astype(np.float32)
    key = jax.random.PRNGKey(A)
    masked = jax_mask(jnp.asarray(logits), jnp.asarray(mask))
    want_a = jax_categorical(key, masked)
    want_lp = jax_log_prob(masked, want_a)
    u = np.array(jax.random.uniform(key, (rows, A), minval=TINY, maxval=1.0))
    jstate = jn.PopArtState(mean=jnp.float32(0.75), m2=jnp.float32(3.5 * max(count, 1.0)),
                            count=jnp.float32(count))
    want_v = jn.popart_denormalize(jstate, jnp.asarray(values))
    state = PopArtState(mean=torch.tensor(0.75), m2=torch.tensor(np.float32(3.5 * max(count, 1.0))),
                        count=torch.tensor(np.float32(count)))
    out = torch.full((3, rows), -7.0)
    a, lp = masked_sample(torch.from_numpy(logits), torch.from_numpy(mask),
                          torch.from_numpy(u), popart=state,
                          values=torch.from_numpy(values), values_out=out[1])
    np.testing.assert_array_equal(a.numpy(), np.asarray(want_a))
    np.testing.assert_allclose(lp.numpy(), np.asarray(want_lp), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(out[1].numpy(), np.asarray(want_v), rtol=1e-6, atol=1e-6)
    if count < 2:
        np.testing.assert_array_equal(out[1].numpy(), values)  # not initialised: as it is
    assert bool((out[0] == -7.0).all()) and bool((out[2] == -7.0).all())
    # the sample without the epilogue is the same
    a2, lp2 = masked_sample(torch.from_numpy(logits), torch.from_numpy(mask),
                            torch.from_numpy(u))
    assert torch.equal(a, a2) and torch.equal(lp, lp2)


@pytest.mark.parametrize("name", sorted(SIDES))
def test_stats_engine_step_launches_the_fused_entry_once_and_k14_never(monkeypatch, name):
    """Each step one launch of the env's step entry with its sampling front
    (logits set, no action), K17 around it, and no K14."""
    env = SIDES[name].env
    engine = ev.StatsEngine(env, [ev.PlayerSource.random()] * env.spec.num_players, 8,
                            ev.default_temp(env), ev.random_source(0, CPU), CPU, chunk_steps=2)
    from burn_ppo_torch import kernels

    lib = _cuda_path_on_cpu(monkeypatch, *kernels.WRAPPERS)
    for w in kernels.WRAPPERS:
        w.launches = 0  # put back after the test
    with torch.no_grad():
        engine.seat(engine.carry)
        c = engine.step(engine.carry, 0)
        engine.step(c, 1, last=True)
    names = [n for n, _ in lib.calls]
    assert names == ["eval_step_books", f"{name}_step_autoreset", "eval_step_books",
                     f"{name}_step_autoreset", "eval_step_books"]
    for _, args in lib.calls[1::2]:
        assert len(args) == len(kernels.SIGNATURES[f"{name}_step_autoreset"])
        logits, *_, actions = args[-len(kernels.FRONT) - 1:-1]  # the front, then the stream
        assert logits is not None and actions is not None and args[ACTION_ARG[name]] is None
    fused = {w.__name__: w.launches for w in kernels.WRAPPERS if w.launches}
    assert fused == {f"{name}_step_autoreset": 2, "step_books": 3}


@pytest.mark.parametrize("name", sorted(SIDES))
def test_eval_step_on_the_cpu_is_the_step_given_the_plain_sample(name):
    """``Environment.sample_step_autoreset`` on CPU tensors (the stats
    engine's step): the plain sample, then ``step_autoreset`` with those
    actions, equal to the step wrapper's own plain path with the front."""
    env = SIDES[name].env
    n, P, A = 32, env.spec.num_players, env.spec.num_actions
    rng = ev.random_source(1, CPU)
    state, acc = env.reset(env.draw_reset(rng, n)), EpisodeAccumulator.zero(n, P, CPU)
    reset, u = env.draw_reset(rng, n), env.draw_step(rng, n)
    mask = env.action_mask(state)
    temps = torch.from_numpy(EVAL_TEMPS[np.arange(n) % 4])
    front = TemperatureFront(torch.randn(n, A, generator=torch.Generator().manual_seed(2)), mask,
                             temps, rng.uniform((n, A), TINY, 1.0))
    got = env.sample_step_autoreset(state, acc, front, reset, u)
    want = env.step_autoreset(state, acc, None, reset, u, front=front)
    assert torch.equal(got.actions, front.plain()) and torch.equal(got.actions, want.actions)
    leaves = state_leaves(got), state_leaves(want)
    assert len(leaves[0]) == len(leaves[1]) > 10
    assert all(torch.equal(a, b) for a, b in zip(*leaves))


@pytest.mark.parametrize("name", sorted(SIDES))
def test_a_front_of_another_width_than_the_env_is_refused(monkeypatch, name):
    """The step kernels read a front's rows at their env's own action count:
    a front one column wider or narrower is refused before the launch."""
    env = SIDES[name].env
    n, P, A = 8, env.spec.num_players, env.spec.num_actions
    rng = ev.random_source(0, CPU)
    state, acc = env.reset(env.draw_reset(rng, n)), EpisodeAccumulator.zero(n, P, CPU)
    reset, u = env.draw_reset(rng, n), env.draw_step(rng, n)
    from burn_ppo_torch import kernels

    lib = _cuda_path_on_cpu(monkeypatch, *kernels.WRAPPERS)
    for width in (A - 1, A + 1):
        front = TemperatureFront(torch.zeros(n, width), torch.ones(n, width), 0.5,
                                 torch.full((n, width), 0.5))
        with pytest.raises(ValueError, match="logits"):
            env.step_autoreset(state, acc, None, reset, u, front=front)
    assert lib.calls == []


def test_rollout_steps_launch_k2_with_its_epilogue_and_k16_never(monkeypatch):
    from burn_ppo_torch import kernels
    from burn_ppo_torch.ppo.pool_rollout import PoolSeating

    popart = PopArtState.create(CPU)
    cases = []
    for env, pool in ((CartPole(), False), (ConnectFour(), True)):
        net = ActorCriticNetwork(env.spec.obs_dim, env.spec.num_actions, hidden_size=8,
                                 num_hidden=1, generator=torch.Generator().manual_seed(0))
        rng = TorchRandomSource(torch.Generator().manual_seed(1))
        carry = rollout.init_rollout_carry(env, 8, rng, CPU)
        buffers = RolloutBuffers.create(env, 4, 8, CPU, privileged=False, samples=False,
                                        pool=pool)
        seating = PoolSeating.create(8, 4, env.spec.num_players, 2, rng) if pool else None
        cases.append((env, net, rng, carry, buffers, seating))
    lib = _cuda_path_on_cpu(monkeypatch, *kernels.WRAPPERS)
    for w in kernels.WRAPPERS:
        w.launches = 0  # put back after the test
    monkeypatch.setattr(pool_rollout, "opponent_actor_forward",
                        lambda obs, slot, stack, clip: torch.zeros(obs.shape[0], 7))
    for env, net, rng, carry, buffers, seating in cases:
        lib.calls.clear()
        with torch.no_grad():
            if seating is None:
                rollout.rollout_step(net, env, carry, None, rng, buffers, 2, gamma=0.99,
                                     normalize_returns=False, popart=popart)
            else:
                pool_rollout.pool_rollout_step(net, env, None, carry, seating, None, rng,
                                               buffers, 2, num_learner_envs=4,
                                               slot_hi=torch.tensor(2, dtype=torch.int32),
                                               gamma=0.99, normalize_returns=False,
                                               popart=popart)
        names = [n for n, _ in lib.calls]
        k2 = [args for n, args in lib.calls if n == "masked_gumbel_sample"]
        assert "popart_denormalize" not in names and len(k2) == (2 if seating else 1)
        learner = k2[0]
        assert len(learner) == len(kernels.SIGNATURES["masked_gumbel_sample"])
        assert learner[7] is not None and learner[8:12] == (
            popart.mean.data_ptr(), popart.m2.data_ptr(), popart.count.data_ptr(),
            buffers.values[2].data_ptr())
        if seating is not None:
            assert k2[1][7:12] == (None,) * 5  # the opponents' sample: no epilogue
    counts = {w.__name__: w.launches for w in kernels.WRAPPERS if w.launches}
    assert counts == {"masked_sample": 3, "cartpole_step_autoreset": 1,
                      "connect_four_step_autoreset": 1}


@pytest.mark.parametrize("name", sorted(SIDES))
def test_single_game_ends_on_the_terminal_state_of_its_last_move(name):
    """Watch mode's game (``eval.SingleGame``) steps with the reset off: the
    move that ends the game leaves the state the plain ``env.step`` gives
    for it, which ``terminal`` holds and ``view`` renders; the game's
    state is that same terminal state (no second step on the host)."""
    env = SIDES[name].env
    game = ev.SingleGame(env, ev.random_source(4, CPU), CPU)
    drawn = []
    real_draw = env.draw_step
    env.draw_step = lambda rng, n: drawn.append(real_draw(rng, n)) or drawn[-1]
    rng = np.random.default_rng(5)
    try:
        for _ in range(3000):
            prev = game.state
            legal = np.flatnonzero(game.mask[0].numpy())
            action = int(legal[-1] if rng.random() < 0.5 else rng.choice(legal))
            game.play(action)
            if game.done:
                break
    finally:
        del env.draw_step
    assert game.done and game.view() is game.terminal is game.state
    u = drawn[-1]
    args = (prev, torch.tensor([action], dtype=torch.int32)) + (() if u is None else (u,))
    want = env.step(*args)[0]
    for f in dataclasses.fields(want):
        assert torch.equal(getattr(game.terminal, f.name), getattr(want, f.name)), f.name
    assert env.render(game.view()) == env.render(want)

"""The packed Skull state of the port (``envs/skull.py`` LAYOUT, through
``envs/base.py`` PackedState): one [E, 108] i32 buffer of the integer and
bool fields and the f32 shaping coefficient, each field a view with the
JAX state's name, shape and dtype. The column offsets against the JAX
state's field order and against the kernel's (``csrc/skull_step.cu``),
the round trip through ``SkullState.of``, the bool views, the zero
padding column through the plain step, ``select_state`` on packed states,
both packed states through the shared base, and the kernel wrapper's host
work (its argument checks and allocations, with a stand-in library)."""

import math
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from burn_ppo_tpu.envs.skull import Skull as JaxSkull  # noqa: E402
from burn_ppo_tpu.envs.skull import SkullState as JaxSkullState  # noqa: E402
from burn_ppo_torch import kernels  # noqa: E402
from burn_ppo_torch.envs import skull as sk  # noqa: E402
from burn_ppo_torch.envs.base import EpisodeAccumulator, select_state  # noqa: E402
from burn_ppo_torch.envs.liars_dice import LiarsDiceState  # noqa: E402

CSRC = Path(__file__).resolve().parent.parent / "burn_ppo_torch" / "csrc" / "skull_step.cu"


def walked_state(n, E, steps, seed):
    """A packed state after ``steps`` random-legal plain steps (games end
    and restart on the way), with a random shaping coefficient."""
    g = torch.Generator().manual_seed(seed)
    env = sk.Skull(n)
    empty = torch.empty(E, 0)
    state = env.reset(empty)
    state = sk.SkullState(state.ints, torch.rand(E, generator=g))
    acc = EpisodeAccumulator.zero(E, n, torch.device("cpu"))
    for _ in range(steps):
        out = env.step_autoreset(state, acc, sk.walk_actions(env.action_mask(state), g), empty,
                                 torch.rand(E, generator=g))
        state, acc = out.state, out.acc
    return env, state, acc


def random_fields(E, seed):
    """Every field of FIELDS at random, in its dtype and shape."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, shape in sk.LAYOUT:
        if name in sk.SkullState.BOOL_FIELDS:
            out[name] = torch.from_numpy(rng.random((E, *shape)) < 0.5)
        else:
            out[name] = torch.from_numpy(rng.integers(-1, 25, (E, *shape)).astype(np.int32))
    out["shaping_coef"] = torch.from_numpy(rng.random(E).astype(np.float32))
    return out


def test_layout_follows_the_jax_state_and_pads_rows_to_16_bytes():
    jax_fields = [f for f in JaxSkullState.__dataclass_fields__ if f not in ("rewards", "done", "key")]
    assert list(sk.FIELDS) == jax_fields
    assert sk.SkullState.INT_FIELDS == tuple(f for f in sk.FIELDS if f != "shaping_coef")
    js = jax.vmap(JaxSkull(4).reset)(jax.random.split(jax.random.PRNGKey(0), 2))
    at = 0
    for name, shape in sk.LAYOUT:
        assert tuple(np.asarray(getattr(js, name)).shape[1:]) == shape, name
        assert sk.SkullState.SLICES[name] == (at, at + math.prod(shape), shape), name
        at += math.prod(shape)
    assert (at, sk.SkullState.PAD_COL, sk.W) == (107, 107, 108)
    assert sk.W * 4 % 16 == 0
    assert sk.SkullState.BOOL_FIELDS == {f for f in sk.SkullState.INT_FIELDS if np.asarray(getattr(js, f)).dtype == bool}


def test_kernel_column_offsets_match_the_layout():
    """The O_* offsets of csrc/skull_step.cu, evaluated in the order the
    source declares them, are LAYOUT's, then the pad column and W."""
    src = CSRC.read_text()
    env = {name: int(v) for name, v in re.findall(r"constexpr int (MAXP|CARDS|HIST) = (\d+);", src)}
    offsets = []
    for name, expr in re.findall(r"constexpr int (O_\w+|W) = ([^;]+);", src):
        env[name] = eval(expr, {}, dict(env))  # noqa: S307 - integer constants of the source
        offsets.append(env[name])
    want = [lo for lo, _, _ in (sk.SkullState.SLICES[f] for f in sk.SkullState.INT_FIELDS)] + [sk.SkullState.PAD_COL, sk.W]
    assert offsets == want


@pytest.mark.parametrize("n", [2, 3, 4, 5, 6])
def test_of_and_fields_round_trip(n):
    _, state, _ = walked_state(n, E=24, steps=30, seed=n)
    again = sk.SkullState.of(**state.fields())
    assert torch.equal(again.ints, state.ints) and torch.equal(again.shaping_coef, state.shaping_coef)
    fields = random_fields(40, seed=n)
    packed = sk.SkullState.of(**fields)
    assert packed.ints.shape == (40, sk.W) and packed.ints.dtype == torch.int32
    assert packed.ints.is_contiguous() and bool((packed.ints[:, sk.SkullState.PAD_COL] == 0).all())
    back = packed.fields()
    assert list(back) == list(sk.FIELDS)
    for name, x in fields.items():
        assert back[name].dtype == x.dtype and torch.equal(back[name], x), name


def test_bool_fields_read_as_bool_and_the_rest_as_i32():
    _, state, _ = walked_state(4, E=16, steps=20, seed=0)
    for name, shape in sk.LAYOUT:
        x = getattr(state, name)
        assert tuple(x.shape) == (16, *shape), name
        assert x.dtype == (torch.bool if name in sk.SkullState.BOOL_FIELDS else torch.int32), name
    lo = sk.SkullState.SLICES["game_over"][0]
    assert torch.equal(state.game_over, state.ints[:, lo] != 0)
    assert set(state.ints[:, sk.SkullState.SLICES["has_trap"][0]:sk.SkullState.SLICES["has_trap"][1]].unique().tolist()) <= {0, 1}


@pytest.mark.parametrize("n", [2, 4, 6])
def test_the_padding_column_stays_zero_through_the_plain_step(n):
    env, state, acc = walked_state(n, E=32, steps=60, seed=10 + n)
    assert bool((state.ints[:, sk.SkullState.PAD_COL] == 0).all())
    stepped, _, _ = env.step(state, torch.full((32,), 40, dtype=torch.int32), torch.rand(32))
    assert bool((stepped.ints[:, sk.SkullState.PAD_COL] == 0).all())  # every action out of range: ended
    assert bool(stepped.game_over.all())


def test_rep_writes_only_the_named_columns():
    _, state, _ = walked_state(4, E=8, steps=10, seed=3)
    new = sk._rep(state, current=torch.full((8,), 3, dtype=torch.int32),
                  passed=torch.ones(8, 6, dtype=torch.bool))
    lo_c, lo_p, hi_p = sk.SkullState.SLICES["current"][0], *sk.SkullState.SLICES["passed"][:2]
    changed = torch.zeros(sk.W, dtype=torch.bool)
    changed[lo_c] = True
    changed[lo_p:hi_p] = True
    assert torch.equal(new.ints[:, ~changed], state.ints[:, ~changed])
    assert bool((new.current == 3).all()) and bool(new.passed.all())
    assert new.ints.data_ptr() != state.ints.data_ptr()  # a copy: the input is unchanged


def test_select_state_on_packed_states():
    _, a, _ = walked_state(4, E=12, steps=15, seed=1)
    _, b, _ = walked_state(4, E=12, steps=25, seed=2)
    pick = torch.arange(12) % 3 == 0
    out = select_state(pick, a, b)
    assert isinstance(out, sk.SkullState)
    assert torch.equal(out.ints, torch.where(pick[:, None], a.ints, b.ints))
    assert torch.equal(out.shaping_coef, torch.where(pick, a.shaping_coef, b.shaping_coef))
    for name in sk.FIELDS:
        want = torch.where(pick.reshape(-1, *[1] * (getattr(a, name).dim() - 1)),
                           getattr(a, name), getattr(b, name))
        assert torch.equal(getattr(out, name), want), name


def test_the_kernel_wrapper_checks_few_arguments_and_allocates_two_buffers(monkeypatch):
    """The CUDA path's host work, run on CPU tensors with a stand-in
    library: six argument checks and an alignment check, two allocations,
    one launch; the outputs are views of the two buffers at the offsets
    the kernel writes (``_outputs``, 64-element blocks)."""
    E, n = 70, 4
    env, state, acc = walked_state(n, E, steps=5, seed=4)
    calls = {"expect": 0, "empty": 0, "launch": []}
    expect, empty = kernels.expect, torch.empty

    def counting_expect(*a, **k):
        calls["expect"] += 1
        return expect(*a, **k)

    def counting_empty(*a, **k):
        calls["empty"] += 1
        return empty(*a, **k)

    class Lib:
        @staticmethod
        def skull_step_autoreset(*args):
            calls["launch"].append(args)
            return 0

    monkeypatch.setattr(kernels, "expect", counting_expect)
    monkeypatch.setattr(kernels, "library", lambda: Lib)
    monkeypatch.setattr(kernels, "stream", lambda dev: 0)
    # the stand-in launch counts; the process's counter is restored after
    monkeypatch.setattr(sk.skull_step_autoreset, "launches", sk.skull_step_autoreset.launches)
    action = torch.zeros(E, dtype=torch.int32)
    u = torch.rand(E)
    before = sk.skull_step_autoreset.launches
    monkeypatch.setattr(torch, "empty", counting_empty)
    out = sk._launch(env, state, acc, action, u)
    monkeypatch.setattr(torch, "empty", empty)
    assert calls["expect"] == 6 and calls["empty"] == 2
    assert sk.skull_step_autoreset.launches == before + 1
    (args,) = calls["launch"]
    assert args[8:10] == (E, n)
    i32_base, f32_base = args[6], args[7]
    blk = lambda cols: -(-E * cols // 64) * 64 * 4  # noqa: E731
    assert out.state.ints.shape == (E, sk.W) and out.state.ints.data_ptr() == i32_base
    assert out.acc.length.data_ptr() == i32_base + blk(sk.W)
    assert out.log.outcome.shape == (E, n)
    assert out.log.outcome.data_ptr() == i32_base + blk(sk.W) + 2 * blk(1)
    assert out.state.shaping_coef.data_ptr() == f32_base
    assert out.log.completed is out.done
    widths = [(out.acc.reward_sum, n), (out.rewards, n), (out.done, 1), (out.log.total_rewards, n),
              (out.obs, sk.OBS_DIM), (out.mask, sk.A), (out.priv, sk.PRIV_DIM)]
    at = f32_base + blk(1)
    for t, cols in widths:
        assert t.data_ptr() == at and t.numel() == E * cols
        at += blk(cols)
    assert out.obs.shape == (E, sk.OBS_DIM) and out.priv.shape == (E, sk.PRIV_DIM)


@pytest.mark.parametrize("cls", [sk.SkullState, LiarsDiceState])
def test_both_packed_states_share_one_layout(cls):
    """envs/base.py PackedState gives each state its columns, views that
    share ``ints``'s memory, and ``of`` / ``fields`` (Skull's padded to 108
    columns, Liar's Dice's 73 padded to 76)."""
    assert (cls.PAD_COL, cls.W) == ((107, 108) if cls is sk.SkullState else (73, 76))
    rng = np.random.default_rng(7)
    E = 9
    fields = {name: torch.from_numpy(rng.random((E, *shape)) < 0.5) if name in cls.BOOL_FIELDS
              else torch.from_numpy(rng.integers(-1, 9, (E, *shape)).astype(np.int32))
              for name, shape in cls.LAYOUT}
    state = cls.of(torch.from_numpy(rng.random(E).astype(np.float32)), **fields)
    assert type(state) is cls and state.ints.shape == (E, cls.W)
    for name, x in fields.items():
        view = getattr(state, name)
        assert view.dtype == x.dtype and torch.equal(view, x), name
        lo = cls.SLICES[name][0]
        if name not in cls.BOOL_FIELDS:
            assert view.data_ptr() == state.ints[:, lo].data_ptr(), name
    again = cls.of(state.shaping_coef, **{f: getattr(state, f) for f in cls.INT_FIELDS})
    assert torch.equal(again.ints, state.ints)

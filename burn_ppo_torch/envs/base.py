"""Environment abstraction for the port: batched struct-of-arrays states.

Counterpart of burn_ppo_tpu/envs/base.py. The JAX package writes every
env function for ONE environment and vectorises it with ``vmap``; here
the batch dimension is written out: a state is a small dataclass of
``[E, ...]`` tensors, and every env function takes and returns whole
batches. Rewards, episode returns and outcomes are per player, ``[E, P]``
(``P = 1`` for CartPole).

``autoreset_step`` keeps the reference ordering (base.py:234-274): the
episode log, outcome included, is captured from the stepped (terminal)
state BEFORE the fresh state replaces it, and reset values are drawn for
every env at every step and selected where the episode ended. The env's
``context_fields`` (Skull's reward-shaping coefficient) survive the reset.

Randomness the step itself needs (Skull's lost coaster) is a per-env draw
from the caller's random source at every step (``draw_step``); the JAX
package keeps a PRNG key in each env state instead.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, ClassVar, NamedTuple, Optional, Tuple

import torch

State = Any


@dataclass(frozen=True)
class EnvSpec:
    """Static environment description (burn_ppo_tpu/envs/base.py EnvSpec)."""

    name: str
    obs_dim: int
    num_actions: int
    num_players: int = 1
    obs_shape: Optional[Tuple[int, int, int]] = None
    privileged_obs_dim: Optional[int] = None
    eval_temp: float = 0.3
    eval_temp_cutoff: Optional[Tuple[int, float]] = None
    variable_player_count: bool = False
    max_episode_steps: Optional[int] = None


@dataclass
class EpisodeLog:
    """Per-step episode-completion record of an env batch.

    ``completed`` is 1.0 where an episode finished at this step (the same
    tensor as the step's done); the other fields are meaningful there
    only. ``outcome`` holds 1-indexed placements, ``[0, ..]`` being the
    no-outcome sentinel of a game ended by an invalid move."""

    completed: torch.Tensor  # [E] f32
    total_rewards: torch.Tensor  # [E, P] f32 summed over the episode
    length: torch.Tensor  # [E] i32
    outcome: torch.Tensor  # [E, P] i32 placements
    active_players: torch.Tensor  # [E] i32


@dataclass
class EpisodeAccumulator:
    """Running per-env episode accumulators carried through the rollout."""

    reward_sum: torch.Tensor  # [E, P] f32
    length: torch.Tensor  # [E] i32

    @staticmethod
    def zero(num_envs: int, num_players: int, device: torch.device) -> "EpisodeAccumulator":
        return EpisodeAccumulator(
            reward_sum=torch.zeros(num_envs, num_players, dtype=torch.float32, device=device),
            length=torch.zeros(num_envs, dtype=torch.int32, device=device),
        )


class StepOutput(NamedTuple):
    """Everything one auto-reset env step produces for the rollout."""

    state: State  # post-reset state
    acc: EpisodeAccumulator  # post-reset accumulators
    rewards: torch.Tensor  # [E, P] f32 rewards of the stepped (terminal) state
    done: torch.Tensor  # [E] f32 1.0 where the episode ended at this step
    log: EpisodeLog
    obs: torch.Tensor  # [E, D] obs of the post-reset state
    mask: torch.Tensor  # [E, A] f32 action mask of the post-reset state
    priv: Optional[torch.Tensor] = None  # [E, Dp] privileged obs of the post-reset state
    # Where the step folds in the return normaliser's per-step roll
    # (``roll`` of ``Environment.step_autoreset``): the rolled returns
    # [E, 1] and the samples [E]; None where it does not.
    returns: Optional[torch.Tensor] = None
    samples: Optional[torch.Tensor] = None


def onehot_eq(i: torch.Tensor, size: int) -> torch.Tensor:
    """[E, size] bool: arange(size) == i (all False where i is out of range)."""
    return torch.arange(size, device=i.device)[None, :] == i[:, None]


def read_at(arr: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """arr[e, i[e]] of an [E, S] array; 0 / False where i is out of range,
    as the JAX package's one-hot read gives."""
    S = arr.shape[1]
    picked = torch.gather(arr, 1, torch.clamp(i, 0, S - 1).long()[:, None])[:, 0]
    return torch.where((i >= 0) & (i < S), picked, torch.zeros_like(picked))


def first_true_clockwise(ok: torch.Tensor, frm: torch.Tensor, n: int) -> torch.Tensor:
    """[E] i32 index of the first True of ``ok`` [E, S] clockwise after
    ``frm`` (frm itself last); (frm + 1) % n where none is True
    (burn_ppo_tpu/envs/base.py:73-88). ``ok`` may be padded beyond the n
    seats with False. ``%`` on tensors is floor-mod, as in JAX, so no seat
    comes out negative."""
    size = ok.shape[1]
    idx = torch.arange(size, device=ok.device)[None, :]
    dist = (idx - frm[:, None].long() - 1) % n
    d = torch.where(ok, dist, size + 1)
    return torch.where(ok.any(1), torch.argmin(d, dim=1), (frm.long() + 1) % n).to(torch.int32)


def push_ring_row(hist: torch.Tensor, hist_len: torch.Tensor, entry: torch.Tensor, size: int):
    """Append ``entry`` [E, W] to a fixed [E, size, W] history, shifting the
    rows up when it is full (burn_ppo_tpu/envs/base.py:91-105). Returns
    (hist, hist_len)."""
    full = hist_len >= size
    shifted = torch.where(full[:, None, None], torch.roll(hist, -1, dims=1), hist)
    at = torch.where(full, size - 1, hist_len)
    row = torch.arange(size, device=hist.device)[None, :, None] == at[:, None, None]
    return (torch.where(row, entry[:, None, :], shifted),
            torch.clamp(hist_len + 1, max=size).to(hist_len.dtype))


def _lead(state: State) -> torch.Tensor:
    """The first field of a state: its [E, ...] shape and device are the batch's."""
    return getattr(state, dataclasses.fields(state)[0].name)


def env_row(state: State, index: int = 0) -> State:
    """Env ``index`` of a batched state as a batch of one on the CPU, one
    copy a field: what the host's text helpers read."""
    return dataclasses.replace(state, **{
        f.name: getattr(state, f.name)[index:index + 1].cpu() for f in dataclasses.fields(state)
    })


def select_state(done: torch.Tensor, on_true: State, on_false: State) -> State:
    """Per-env select between two states of the same dataclass type."""
    return dataclasses.replace(
        on_false,
        **{
            f.name: torch.where(
                done.reshape(done.shape + (1,) * (getattr(on_false, f.name).dim() - 1)),
                getattr(on_true, f.name),
                getattr(on_false, f.name),
            )
            for f in dataclasses.fields(on_false)
        },
    )


class Environment:
    """Base class: subclasses provide batched functions over their state.

    ``step(state, action) -> (stepped, rewards [E, P], done [E] bool)``,
    ``reset(reset_values) -> state`` from values that ``draw_reset``
    takes from the caller's random source (ppo/rollout.py RandomSource),
    and ``obs(state) -> [E, obs_dim]``. The defaults below are those of a
    single-player env: everything legal, player 0 acting, every finished
    episode in first place.
    """

    spec: EnvSpec
    # State fields that survive the reset and that the trainer sets before
    # each rollout (the scheduled reward-shaping coefficient).
    context_fields: Tuple[str, ...] = ()

    def draw_reset(self, rng, num_envs: int) -> torch.Tensor:
        raise NotImplementedError

    def draw_step(self, rng, num_envs: int) -> Optional[torch.Tensor]:
        """Per-env randoms the step needs, drawn at every step; None when
        the step draws nothing."""
        return None

    def reset(self, reset_values: torch.Tensor) -> State:
        raise NotImplementedError

    def step(self, state: State, action: torch.Tensor):
        raise NotImplementedError

    def obs(self, state: State) -> torch.Tensor:
        raise NotImplementedError

    def action_mask(self, state: State) -> torch.Tensor:
        """[E, A] f32, 1.0 = legal."""
        lead = _lead(state)
        return lead.new_ones(lead.shape[0], self.spec.num_actions, dtype=torch.float32)

    def current_player(self, state: State) -> torch.Tensor:
        """[E] i32 index of the player to act."""
        lead = _lead(state)
        return lead.new_zeros(lead.shape[0], dtype=torch.int32)

    def game_outcome(self, state: State) -> torch.Tensor:
        """[E, P] i32 placements (1 = winner, ties share a place); read only
        where the episode ended."""
        lead = _lead(state)
        return lead.new_ones(lead.shape[0], self.spec.num_players, dtype=torch.int32)

    def active_player_count(self, state: State) -> torch.Tensor:
        lead = _lead(state)
        return lead.new_full((lead.shape[0],), self.spec.num_players, dtype=torch.int32)

    def privileged_obs(self, state: State) -> torch.Tensor:
        raise NotImplementedError(f"{self.spec.name} has no privileged observations")

    def step_autoreset(self, state, acc, action, reset_values, step_values=None,
                       roll=None) -> StepOutput:
        """One auto-reset step of every env. A single-player env may be
        given ``roll`` = (rolling returns [E, 1], gamma) and fold the return
        normaliser's per-step roll into its step (CartPole does, and fills
        ``StepOutput.returns`` and ``samples``); one that does not leaves
        both None and the caller rolls."""
        return autoreset_step(self, state, acc, action, reset_values, step_values)

    # -- human-facing helpers (watch mode and human play; base.py:184-195) ----
    def render(self, state: State, index: int = 0) -> Optional[str]:
        """Text of env ``index`` of the batch (``env_row``), or None where
        the env has no renderer."""
        return None

    def describe_action(self, action: int) -> str:
        return f"Action {action}"

    def parse_action(self, text: str) -> int:
        return int(text.strip())


@dataclass
class PackedState:
    """E envs of a state packed for its step kernel (K4, K11, K13): ``ints``
    [E, W] i32 holds the integer fields of the subclass's ``LAYOUT``
    ((name, per-env shape) in column order, those of ``BOOL_FIELDS`` as
    0 / 1), then zero pad columns up to ``W`` (None: no padding). Each
    field of ``LAYOUT`` reads as a view with its own name and shape, the
    bools as bool. ``fields()`` gives the fields named in ``FIELDS`` (by
    default the layout's), and ``of(**s.fields())`` rebuilds ``s``."""

    ints: torch.Tensor  # [E, W] i32

    LAYOUT: ClassVar[tuple] = ()
    BOOL_FIELDS: ClassVar[frozenset] = frozenset()
    W: ClassVar[Optional[int]] = None

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        cls.SLICES, col = {}, 0
        for name, shape in cls.LAYOUT:
            cls.SLICES[name] = (col, col + math.prod(shape), shape)
            setattr(cls, name, _field_view(name, col, col + math.prod(shape), shape,
                                           name in cls.BOOL_FIELDS))
            col += math.prod(shape)
        cls.PAD_COL = col  # the first pad column
        cls.W = col if cls.W is None else cls.W
        cls.INT_FIELDS = tuple(name for name, _ in cls.LAYOUT)
        if "FIELDS" not in cls.__dict__:
            cls.FIELDS = cls.INT_FIELDS

    @classmethod
    def pack(cls, **fields: torch.Tensor) -> torch.Tensor:
        """The [E, W] i32 buffer of the fields (every name of ``LAYOUT``)."""
        lead = fields[cls.INT_FIELDS[0]]
        E = lead.shape[0]
        cols = [fields[name].reshape(E, -1).to(torch.int32) for name in cls.INT_FIELDS]
        if cls.W > cls.PAD_COL:
            cols.append(torch.zeros(E, cls.W - cls.PAD_COL, dtype=torch.int32, device=lead.device))
        return torch.cat(cols, 1)

    @classmethod
    def of(cls, **fields: torch.Tensor):
        """Pack the fields into one state."""
        return cls(cls.pack(**fields))

    def fields(self) -> dict:
        return {name: getattr(self, name) for name in self.FIELDS}


@dataclass
class ShapedPackedState(PackedState):
    """A packed state with the f32 reward-shaping coefficient beside it
    (Skull, Liar's Dice), kept across resets."""

    shaping_coef: torch.Tensor  # [E] f32

    @classmethod
    def of(cls, shaping_coef: torch.Tensor, **fields: torch.Tensor):
        return cls(cls.pack(**fields), shaping_coef.to(torch.float32))


def _field_view(name: str, lo: int, hi: int, shape: tuple, is_bool: bool) -> property:
    def view(self: PackedState) -> torch.Tensor:
        x = self.ints[:, lo:hi]
        x = x.reshape(x.shape[0], *shape) if shape else x[:, 0]
        return x != 0 if is_bool else x

    view.__name__ = name
    return property(view)


# A fused env-step kernel writes its outputs into one buffer per dtype:
# (name, columns per env) blocks, each E x columns, starting on a
# 64-element (256 byte) boundary (csrc/cartpole_step.cu,
# connect_four_step.cu, liars_dice_step.cu, skull_step.cu). A block's
# columns may be given as a one-element tuple, ``(1,)``, for an [E, 1] view.
ARENA_ALIGN = 64


def _cols(cols) -> int:
    return cols[0] if isinstance(cols, tuple) else cols


def arena_size(E: int, blocks) -> int:
    return sum(-(-E * _cols(cols) // ARENA_ALIGN) * ARENA_ALIGN for _, cols in blocks)


def carve_arena(buf: torch.Tensor, E: int, blocks) -> dict:
    """The blocks of ``buf`` by name, as [E, cols] views ([E] for one column,
    [E, 1] for ``(1,)``). One ``as_strided`` a block, where a slice and a
    view would be two tensor constructions: a step wrapper carves about ten
    views per call."""
    out, at = {}, buf.storage_offset()
    for name, cols in blocks:
        n = _cols(cols)
        out[name] = (buf.as_strided((E, n), (n, 1), at) if n > 1 or isinstance(cols, tuple)
                     else buf.as_strided((E,), (1,), at))
        at += -(-E * n // ARENA_ALIGN) * ARENA_ALIGN
    return out


def autoreset_step(
    env: Environment,
    state: State,
    acc: EpisodeAccumulator,
    action: torch.Tensor,
    reset_values: torch.Tensor,
    step_values: Optional[torch.Tensor] = None,
) -> StepOutput:
    """Step every env with auto-reset (plain PyTorch).

    The log, outcome included, reads the stepped state before the reset
    values replace it (burn_ppo_tpu/envs/base.py:248-274); the context
    fields carry over into the fresh state (base.py:265-268)."""
    if step_values is None:
        stepped, rewards, done_b = env.step(state, action)
    else:
        stepped, rewards, done_b = env.step(state, action, step_values)
    new_sum = acc.reward_sum + rewards
    new_len = acc.length + 1
    done = done_b.to(torch.float32)
    log = EpisodeLog(
        completed=done,
        total_rewards=new_sum,
        length=new_len,
        outcome=env.game_outcome(stepped),
        active_players=env.active_player_count(stepped),
    )
    fresh = env.reset(reset_values)
    if env.context_fields:
        fresh = dataclasses.replace(fresh, **{f: getattr(stepped, f) for f in env.context_fields})
    next_state = select_state(done_b, fresh, stepped)
    next_acc = EpisodeAccumulator(
        reward_sum=torch.where(done_b[:, None], torch.zeros_like(new_sum), new_sum),
        length=torch.where(done_b, torch.zeros_like(new_len), new_len),
    )
    priv = env.privileged_obs(next_state) if env.spec.privileged_obs_dim else None
    return StepOutput(next_state, next_acc, rewards, done, log, env.obs(next_state),
                      env.action_mask(next_state), priv)

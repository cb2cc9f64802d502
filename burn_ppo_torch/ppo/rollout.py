"""Rollout collection as a loop over T steps into [T, E, ...] buffers.

Counterpart of burn_ppo_tpu/ppo/rollout.py:150-363 (single-player and
pure self-play; the TPU-only ``blocked_scan`` is not carried over). Step
t (``rollout_step``) writes its outputs into slice t of one
``RolloutBuffers``, made once by the caller (``ppo/rollout_graph.py``
keeps one for every update, so a captured CUDA graph finds them at the
same addresses). Per step, in the reference's order:

  1. the acting player and the action mask, read from the env states
     (the mask comes out of the previous env step);
  2. normalize the obs with the LAGGED obs-normalizer stats (kernel K6 on
     CUDA);
  3. network forward -> logits, value (the CTDE critic reads the
     normalized obs and the RAW privileged obs, rollout.py:228-249); with
     PopArt the value is denormalized as it is stored (kernel K16 on CUDA,
     rollout.py:253-254);
  4. masked Gumbel-max sample and log pi(a) (kernel K2 on CUDA);
  5. env step with auto-reset, episode log captured before the reset
     (kernel K1, K4, K11 or K13 on CUDA);
  6. the rolling-return update of the acting player's return: folded into
     the env step where the env does it (CartPole's K1), else a gather of
     the acting player's reward and K12's roll on CUDA.

Before the loop the trainer's ``env_context`` (the scheduled
reward-shaping coefficient) is written into every env state
(rollout.py:218-226).

After the loop (``finish_rollout``) the acting player's rewards are read
out of the ``[T, E, P]`` rewards, the return normalizer's prefix pass
(K12's finalize on CUDA) normalizes them at once, and the per-player last
values advance: each player's slot takes the value of the last step that
player acted in (what the reference's per-step one-hot update leaves
after T steps).

Randomness comes from a ``RandomSource``: on the main path one
``torch.Generator`` on the device (``TorchRandomSource``); in the parity
tests, a source that replays the JAX side's own draws.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import dataclasses

import torch

from burn_ppo_torch.envs.base import Environment, EpisodeAccumulator, EpisodeLog
from burn_ppo_torch.ops.categorical import TINY, masked_sample
from burn_ppo_torch.ppo.normalization import (
    ObsNormState,
    PopArtState,
    ReturnNormState,
    obs_norm_apply,
    popart_denormalize,
    return_norm_finalize,
    return_norm_roll,
)


class RandomSource:
    """Where the rollout and the update take their random numbers."""

    device = torch.device("cpu")

    def uniform(self, shape: Tuple[int, ...], low: float, high: float) -> torch.Tensor:
        """f32 uniforms in [low, high)."""
        raise NotImplementedError

    def permutation(self, n: int) -> torch.Tensor:
        """A random permutation of range(n), int64."""
        raise NotImplementedError

    def integers(self, shape: Tuple[int, ...], low: int, high) -> torch.Tensor:
        """i32 integers in [low, high) (``jax.random.randint``). ``high`` is
        an int, or with ``low`` 0 a 0-dim i32 tensor on the source's
        device, which a captured CUDA graph reads at each replay."""
        raise NotImplementedError


class TorchRandomSource(RandomSource):
    """All draws from one explicit generator, on the generator's device."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator
        self.device = generator.device

    def uniform(self, shape, low, high):
        u = torch.rand(shape, generator=self.generator, device=self.device)
        return torch.clamp(u * (high - low) + low, min=low)

    def permutation(self, n):
        return torch.randperm(n, generator=self.generator, device=self.device)

    def integers(self, shape, low, high):
        if isinstance(high, torch.Tensor):
            if low != 0:
                raise ValueError(f"a tensor bound draws from 0, not {low}")
            # 31 random bits modulo the bound: uniform but for a bias under
            # high / 2^31.
            bits = torch.randint(0, 2**31, shape, generator=self.generator, device=self.device,
                                 dtype=torch.int32)
            return bits.remainder_(high)
        return torch.randint(low, high, shape, generator=self.generator, device=self.device,
                             dtype=torch.int32)


@dataclass
class RolloutBatch:
    """Collected rollout data, [T, E, ...]. Obs are stored RAW; the update
    normalizes them with the same lagged stats the rollout used."""

    obs: torch.Tensor  # [T, E, D]
    actions: torch.Tensor  # [T, E] i32
    rewards: torch.Tensor  # [T, E] acting player's (return-normalized) reward
    all_rewards: torch.Tensor  # [T, E, P] (acting slot return-normalized)
    dones: torch.Tensor  # [T, E] f32
    values: torch.Tensor  # [T, E]
    log_probs: torch.Tensor  # [T, E]
    acting_players: torch.Tensor  # [T, E] i32
    action_masks: torch.Tensor  # [T, E, A] f32
    valid_mask: torch.Tensor  # [T, E] f32, all 1.0: the learner plays every seat
    privileged_obs: Optional[torch.Tensor] = None  # [T, E, Dp] raw, for the CTDE critic


@dataclass
class RolloutCarry:
    """State threaded between rollouts. ``obs`` and ``mask`` are always
    ``env.obs(env_states)`` and ``env.action_mask(env_states)`` (and
    ``priv`` its privileged obs, for an env that has one); the env step
    writes them, so the next rollout step and the bootstrap read them
    without recomputing. ``last_value_per_player`` persists across
    rollouts and episodes (rollout.py:173,283-285)."""

    env_states: object
    episode_acc: EpisodeAccumulator
    return_norm: ReturnNormState
    last_value_per_player: torch.Tensor  # [E, P]
    obs: torch.Tensor  # [E, D]
    mask: torch.Tensor  # [E, A]
    priv: Optional[torch.Tensor] = None  # [E, Dp]


LOG_FIELDS = ("completed", "total_rewards", "length", "outcome", "active_players")


@dataclass
class RolloutBuffers:
    """The [T, E, ...] outputs of a rollout, made once per (env, T, E,
    network kind) and written in place: step t writes slice t, so a
    captured CUDA graph finds them at the same addresses at every replay.
    ``valid`` is all ones here, made once; the vs-pool rollout writes its
    learner turns. ``samples`` exists with the return normalizer on,
    ``priv`` for a CTDE network, ``seat`` and ``slots`` on the vs-pool
    path."""

    obs: torch.Tensor  # [T, E, D] raw
    actions: torch.Tensor  # [T, E] i32
    rewards: torch.Tensor  # [T, E] acting player's (return-normalized) reward
    all_rewards: torch.Tensor  # [T, E, P]
    dones: torch.Tensor  # [T, E] f32
    values: torch.Tensor  # [T, E]
    log_probs: torch.Tensor  # [T, E]
    acting: torch.Tensor  # [T, E] i32
    masks: torch.Tensor  # [T, E, A] f32
    valid: torch.Tensor  # [T, E] f32
    log: EpisodeLog  # [T, E(, P)]
    samples: Optional[torch.Tensor] = None  # [T, E] rolling-return samples
    priv: Optional[torch.Tensor] = None  # [T, E, Dp] raw
    seat: Optional[torch.Tensor] = None  # [T, E] i32 learner seat before the reseat
    slots: Optional[torch.Tensor] = None  # [T, E, P] i32 opponent slots before it

    @staticmethod
    def create(env: Environment, num_steps: int, num_envs: int, device: torch.device, *,
               privileged: bool, samples: bool, pool: bool = False) -> "RolloutBuffers":
        spec = env.spec
        P, f32, i32 = spec.num_players, torch.float32, torch.int32

        def z(*shape, dtype=f32):
            return torch.zeros(num_steps, num_envs, *shape, dtype=dtype, device=device)

        return RolloutBuffers(
            obs=z(spec.obs_dim), actions=z(dtype=i32), rewards=z(), all_rewards=z(P), dones=z(),
            values=z(), log_probs=z(), acting=z(dtype=i32), masks=z(spec.num_actions),
            valid=z() if pool else torch.ones(num_steps, num_envs, device=device),
            log=EpisodeLog(completed=z(), total_rewards=z(P), length=z(dtype=i32),
                           outcome=z(P, dtype=i32), active_players=z(dtype=i32)),
            samples=z() if samples else None,
            priv=z(spec.privileged_obs_dim) if privileged else None,
            seat=z(dtype=i32) if pool else None, slots=z(P, dtype=i32) if pool else None,
        )

    def put(self, t: int, log: Optional[EpisodeLog] = None,
            **cols: Optional[torch.Tensor]) -> None:
        """Write one step's columns (None: skipped) and its episode log
        into slice ``t``."""
        pairs = [(getattr(self, k), v) for k, v in cols.items() if v is not None]
        if log is not None:
            pairs += [(getattr(self.log, k), getattr(log, k)) for k in LOG_FIELDS]
        for dst, v in pairs:
            dst[t].copy_(v)

    def batch(self) -> RolloutBatch:
        return RolloutBatch(
            obs=self.obs, actions=self.actions, rewards=self.rewards,
            all_rewards=self.all_rewards, dones=self.dones, values=self.values,
            log_probs=self.log_probs, acting_players=self.acting, action_masks=self.masks,
            valid_mask=self.valid, privileged_obs=self.priv,
        )


def init_rollout_carry(
    env: Environment, num_envs: int, rng: RandomSource, device: torch.device
) -> RolloutCarry:
    states = env.reset(env.draw_reset(rng, num_envs).to(device))
    P = env.spec.num_players
    return RolloutCarry(
        env_states=states,
        episode_acc=EpisodeAccumulator.zero(num_envs, P, device),
        return_norm=ReturnNormState.create(num_envs, P, device),
        last_value_per_player=torch.zeros(num_envs, P, dtype=torch.float32, device=device),
        obs=env.obs(states),
        mask=env.action_mask(states),
        priv=env.privileged_obs(states) if env.spec.privileged_obs_dim else None,
    )


def apply_env_context(carry: RolloutCarry, env_context: Optional[dict]) -> RolloutCarry:
    """Broadcast scalar context values (the scheduled reward-shaping
    coefficient) into the env states' context fields. A value is a host
    float or a 0-dim tensor on the states' device: a captured graph reads
    the tensor, which the caller writes before each replay."""
    if not env_context:
        return carry

    def fill(x: torch.Tensor, v) -> torch.Tensor:
        if isinstance(v, torch.Tensor):
            return v.to(x.dtype).expand(x.shape).contiguous()
        return torch.full_like(x, v)

    states = dataclasses.replace(carry.env_states, **{
        f: fill(getattr(carry.env_states, f), v) for f, v in env_context.items()})
    return dataclasses.replace(carry, env_states=states)


def advance_last_values(
    last_vpp: torch.Tensor,  # [E, P]
    values: torch.Tensor,  # [T, E]
    acting: torch.Tensor,  # [T, E] int
    valid: Optional[torch.Tensor] = None,  # [T, E], the steps that update a slot
) -> torch.Tensor:
    """The per-player last values after T steps of the reference's update
    ``vpp = vpp * (1 - onehot(acting)) + values * onehot(acting)``: each
    slot holds the value of the last step its player acted in, or its old
    value where the player never acted. With ``valid`` (the vs-pool
    rollout's learner turns, pool_rollout.py:216-220) only those steps
    count."""
    T, P = values.shape[0], last_vpp.shape[1]
    seats = torch.arange(P, device=values.device)
    steps = torch.arange(1, T + 1, device=values.device)[:, None, None]
    hit = acting[..., None] == seats
    if valid is not None:
        hit = hit & (valid[..., None] > 0)
    last_t = torch.amax(hit * steps, dim=0)  # [E, P], 0 = never
    picked = torch.gather(values, 0, torch.clamp(last_t - 1, min=0).T).T
    return torch.where(last_t > 0, picked, last_vpp)


def rollout_step(
    network,
    env: Environment,
    carry: RolloutCarry,
    obs_norm: Optional[ObsNormState],
    rng: RandomSource,
    buffers: RolloutBuffers,
    t: int,
    *,
    gamma: float,
    normalize_returns: bool,
    obs_clip: float = 10.0,
    popart: Optional[PopArtState] = None,
) -> RolloutCarry:
    """One step of the learner on every env, its outputs written into slice
    ``t`` of ``buffers`` (the values denormalized with ``popart``, when
    given). Returns the carry after the step; its
    ``return_norm`` holds the rolled returns, its stats and
    ``last_value_per_player`` are the rollout's start values."""
    E, A = carry.obs.shape[0], env.spec.num_actions
    states, ret_norm = carry.env_states, carry.return_norm
    players = env.current_player(states)
    obs = obs_norm_apply(obs_norm, carry.obs, obs_clip) if obs_norm is not None else carry.obs
    logits, values = network(obs, carry.priv)
    actions, log_probs = masked_sample(logits, carry.mask, rng.uniform((E, A), TINY, 1.0))
    values = store_values(popart, values, buffers, t)
    step = (states, carry.episode_acc, actions, env.draw_reset(rng, E), env.draw_step(rng, E))
    # One player: the env step may fold the roll of slot 0 in.
    if normalize_returns and env.spec.num_players == 1:
        out = env.step_autoreset(*step, roll=(ret_norm.returns, gamma))
    else:
        out = env.step_autoreset(*step)
    buffers.put(t, obs=carry.obs, actions=actions, all_rewards=out.rewards, dones=out.done,
                values=values, log_probs=log_probs, acting=players, masks=carry.mask,
                priv=carry.priv if buffers.priv is not None else None, log=out.log)
    if normalize_returns:
        if out.samples is None:  # the env step did not roll
            acting_reward = torch.gather(out.rewards, 1, players.long()[:, None])[:, 0]
            new_returns, samples = return_norm_roll(
                ret_norm.returns, acting_reward, players, out.done, gamma
            )
        else:
            new_returns, samples = out.returns, out.samples
        ret_norm = dataclasses.replace(ret_norm, returns=new_returns)
        buffers.put(t, samples=samples)
    return dataclasses.replace(carry, env_states=out.state, episode_acc=out.acc,
                               return_norm=ret_norm, obs=out.obs, mask=out.mask, priv=out.priv)


def store_values(popart: Optional[PopArtState], values: torch.Tensor, buffers: RolloutBuffers,
                 t: int) -> Optional[torch.Tensor]:
    """With PopArt, the learner's values denormalized straight into slice
    ``t`` of the buffers' values (K16 on CUDA, in place of the copy) and
    None returned; else ``values``, for ``RolloutBuffers.put``."""
    if popart is None:
        return values
    popart_denormalize(popart, values, out=buffers.values[t])
    return None


def finish_rollout(
    carry: RolloutCarry,
    buffers: RolloutBuffers,
    *,
    normalize_returns: bool,
    return_clip: float = 10.0,
    valid: Optional[torch.Tensor] = None,
) -> RolloutCarry:
    """After the last step: the acting player's rewards into
    ``buffers.rewards``, normalized (K12's finalize) where the normalizer
    is on and written back into ``all_rewards``; the carry with the new
    return stats and the advanced per-player last values. ``valid`` (the
    vs-pool rollout's learner turns) masks both."""
    slot = buffers.acting.long()[..., None]
    buffers.rewards.copy_(torch.gather(buffers.all_rewards, 2, slot)[..., 0])
    ret_norm = carry.return_norm
    if normalize_returns:
        args = (ret_norm, buffers.samples, buffers.rewards, return_clip)
        ret_norm, rewards = (return_norm_finalize(*args) if valid is None
                             else return_norm_finalize(*args, valid=valid))
        buffers.rewards.copy_(rewards)
        buffers.all_rewards.scatter_(2, slot, rewards[..., None])
    return dataclasses.replace(
        carry, return_norm=ret_norm,
        last_value_per_player=advance_last_values(
            carry.last_value_per_player, buffers.values, buffers.acting, valid))


def collect_rollouts(
    network,
    env: Environment,
    carry: RolloutCarry,
    obs_norm: Optional[ObsNormState],
    rng: RandomSource,
    *,
    num_steps: int,
    gamma: float,
    normalize_returns: bool,
    return_clip: float = 10.0,
    obs_clip: float = 10.0,
    env_context: Optional[dict] = None,
    buffers: Optional[RolloutBuffers] = None,
    popart: Optional[PopArtState] = None,
) -> Tuple[RolloutCarry, RolloutBatch, EpisodeLog]:
    """Single-player or pure self-play rollout (the learner acts every
    turn). Returns (carry', batch, episode logs [T, E]); the batch and the
    logs are views of ``buffers`` (made for this call when None), which
    the next rollout into them overwrites. ``carry`` is not written."""
    carry = apply_env_context(carry, env_context)
    if buffers is None:
        buffers = RolloutBuffers.create(env, num_steps, carry.obs.shape[0], carry.obs.device,
                                        privileged=network.is_ctde, samples=normalize_returns)
    with torch.no_grad():
        for t in range(num_steps):
            carry = rollout_step(network, env, carry, obs_norm, rng, buffers, t, gamma=gamma,
                                 normalize_returns=normalize_returns, obs_clip=obs_clip,
                                 popart=popart)
        carry = finish_rollout(carry, buffers, normalize_returns=normalize_returns,
                               return_clip=return_clip)
    return carry, buffers.batch(), buffers.log


def bootstrap_values(
    network,
    env: Environment,
    carry: RolloutCarry,
    obs_norm: Optional[ObsNormState],
    obs_clip: float = 10.0,
    popart: Optional[PopArtState] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Value of the final env states for the GAE bootstrap.

    Returns (last_values [E], last_value_per_player [E, P]), the acting
    players' slots refreshed with this forward (rollout.py:331-363); CTDE
    values come from the critic on the raw privileged obs (350-352); with
    ``popart`` denormalized (K16 on CUDA, 355-356)."""
    obs = carry.obs
    if obs_norm is not None:
        obs = obs_norm_apply(obs_norm, obs, obs_clip)
    with torch.no_grad():
        values = network(obs, carry.priv)[1]
    if popart is not None:
        values = popart_denormalize(popart, values)
    players = env.current_player(carry.env_states).long()[:, None]
    return values, carry.last_value_per_player.scatter(1, players, values[:, None])

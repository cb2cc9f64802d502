"""Rollout collection as a Python loop over T steps.

Counterpart of burn_ppo_tpu/ppo/rollout.py:150-363 (single-player and
pure self-play; the TPU-only ``blocked_scan`` is not carried over). Per
step, in the reference's order:

  1. the acting player and the action mask, read from the env states
     (the mask comes out of the previous env step);
  2. normalize the obs with the LAGGED obs-normalizer stats (kernel K6 on
     CUDA);
  3. network forward -> logits, value (the CTDE critic reads the
     normalized obs and the RAW privileged obs, rollout.py:228-249);
  4. masked Gumbel-max sample and log pi(a) (kernel K2 on CUDA);
  5. env step with auto-reset, episode log captured before the reset
     (kernel K1, K4, K11 or K13 on CUDA);
  6. the rolling-return update of the acting player's return: folded into
     the env step where the env does it (CartPole's K1), else a gather of
     the acting player's reward and K12's roll on CUDA.

Before the loop the trainer's ``env_context`` (the scheduled
reward-shaping coefficient) is written into every env state
(rollout.py:218-226).

After the loop the acting player's rewards are read out of the
``[T, E, P]`` rewards, the return normalizer's prefix pass (K12's
finalize on CUDA) normalizes them at once, and the per-player last values advance: each player's slot
takes the value of the last step that player acted in (what the
reference's per-step one-hot update leaves after T steps).

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
    ReturnNormState,
    obs_norm_apply,
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

    def integers(self, shape: Tuple[int, ...], low: int, high: int) -> torch.Tensor:
        """i32 integers in [low, high) (``jax.random.randint``)."""
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
    coefficient) into the env states' context fields."""
    if not env_context:
        return carry
    states = dataclasses.replace(carry.env_states, **{
        f: torch.full_like(getattr(carry.env_states, f), v) for f, v in env_context.items()})
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
) -> Tuple[RolloutCarry, RolloutBatch, EpisodeLog]:
    """Single-player or pure self-play rollout (the learner acts every
    turn). Returns (carry', batch, episode logs [T, E])."""
    carry = apply_env_context(carry, env_context)
    E = carry.obs.shape[0]
    A = env.spec.num_actions
    device = carry.obs.device
    cols: dict = {k: [] for k in ("obs", "actions", "rewards", "dones", "values", "log_probs",
                                  "acting", "masks", "samples", "priv")}
    log_cols: dict = {k: [] for k in ("completed", "total_rewards", "length", "outcome",
                                      "active_players")}
    states, acc, ret_norm = carry.env_states, carry.episode_acc, carry.return_norm
    obs_raw, mask, priv = carry.obs, carry.mask, carry.priv
    # One player: the env step may fold the roll of slot 0 in.
    fold_roll = normalize_returns and env.spec.num_players == 1
    with torch.no_grad():
        for _ in range(num_steps):
            players = env.current_player(states)
            obs = obs_norm_apply(obs_norm, obs_raw, obs_clip) if obs_norm is not None else obs_raw
            logits, values = network(obs, priv)
            actions, log_probs = masked_sample(logits, mask, rng.uniform((E, A), TINY, 1.0))
            step = (states, acc, actions, env.draw_reset(rng, E), env.draw_step(rng, E))
            out = (env.step_autoreset(*step, roll=(ret_norm.returns, gamma)) if fold_roll
                   else env.step_autoreset(*step))
            for k, v in (("obs", obs_raw), ("actions", actions), ("rewards", out.rewards),
                         ("dones", out.done), ("values", values), ("log_probs", log_probs),
                         ("acting", players), ("masks", mask)):
                cols[k].append(v)
            if network.is_ctde:
                cols["priv"].append(priv)
            for k in log_cols:
                log_cols[k].append(getattr(out.log, k))
            if normalize_returns:
                if out.samples is None:  # the env step did not roll
                    acting_reward = torch.gather(out.rewards, 1, players.long()[:, None])[:, 0]
                    new_returns, samples = return_norm_roll(
                        ret_norm.returns, acting_reward, players, out.done, gamma
                    )
                else:
                    new_returns, samples = out.returns, out.samples
                ret_norm = dataclasses.replace(ret_norm, returns=new_returns)
                cols["samples"].append(samples)
            states, acc, obs_raw, mask, priv = out.state, out.acc, out.obs, out.mask, out.priv

    s = {k: torch.stack(v) for k, v in cols.items() if v}
    all_rewards, acting = s["rewards"], s["acting"]
    slot = acting.long()[..., None]
    rewards = torch.gather(all_rewards, 2, slot)[..., 0]
    if normalize_returns:
        ret_norm, rewards = return_norm_finalize(ret_norm, s["samples"], rewards, return_clip)
        all_rewards = all_rewards.scatter(2, slot, rewards[..., None])
    batch = RolloutBatch(
        obs=s["obs"],
        actions=s["actions"],
        rewards=rewards,
        all_rewards=all_rewards,
        dones=s["dones"],
        values=s["values"],
        log_probs=s["log_probs"],
        acting_players=acting,
        action_masks=s["masks"],
        valid_mask=torch.ones(num_steps, E, dtype=torch.float32, device=device),
        privileged_obs=s.get("priv"),
    )
    logs = EpisodeLog(**{k: torch.stack(v) for k, v in log_cols.items()})
    new_carry = RolloutCarry(
        env_states=states, episode_acc=acc, return_norm=ret_norm,
        last_value_per_player=advance_last_values(
            carry.last_value_per_player, batch.values, acting),
        obs=obs_raw, mask=mask, priv=priv,
    )
    return new_carry, batch, logs


def bootstrap_values(
    network,
    env: Environment,
    carry: RolloutCarry,
    obs_norm: Optional[ObsNormState],
    obs_clip: float = 10.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Value of the final env states for the GAE bootstrap.

    Returns (last_values [E], last_value_per_player [E, P]), the acting
    players' slots refreshed with this forward (rollout.py:331-363); CTDE
    values come from the critic on the raw privileged obs (350-352)."""
    obs = carry.obs
    if obs_norm is not None:
        obs = obs_norm_apply(obs_norm, obs, obs_clip)
    with torch.no_grad():
        values = network(obs, carry.priv)[1]
    players = env.current_player(carry.env_states).long()[:, None]
    return values, carry.last_value_per_player.scatter(1, players, values[:, None])

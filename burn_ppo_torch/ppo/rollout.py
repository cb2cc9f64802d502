"""Rollout collection as a Python loop over T steps.

Counterpart of burn_ppo_tpu/ppo/rollout.py:177-363 (single-player path;
the TPU-only ``blocked_scan`` is not carried over). Per step, in the
reference's order:

  1. normalize the obs with the LAGGED obs-normalizer stats;
  2. network forward -> logits, value;
  3. action mask, Gumbel-max sample and log pi(a) (kernel K2 on CUDA);
  4. env step with auto-reset, episode log captured before the reset
     (kernel K1 on CUDA);
  5. the rolling-return update of the return normalizer.

After the loop the return normalizer's prefix pass normalizes the
rewards of the whole rollout at once.

Randomness comes from a ``RandomSource``: on the main path one
``torch.Generator`` on the device (``TorchRandomSource``); in the parity
tests, a source that replays the JAX side's own draws.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

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

    def uniform(self, shape: Tuple[int, ...], low: float, high: float) -> torch.Tensor:
        """f32 uniforms in [low, high)."""
        raise NotImplementedError

    def permutation(self, n: int) -> torch.Tensor:
        """A random permutation of range(n), int64."""
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


@dataclass
class RolloutBatch:
    """Collected rollout data, [T, E, ...]. Obs are stored RAW; the update
    normalizes them with the same lagged stats the rollout used."""

    obs: torch.Tensor  # [T, E, D]
    actions: torch.Tensor  # [T, E] i32
    rewards: torch.Tensor  # [T, E] (return-normalized when enabled)
    dones: torch.Tensor  # [T, E] f32
    values: torch.Tensor  # [T, E]
    log_probs: torch.Tensor  # [T, E]
    action_masks: torch.Tensor  # [T, E, A] f32
    valid_mask: torch.Tensor  # [T, E] f32, all 1.0 in single-player runs


@dataclass
class RolloutCarry:
    """State threaded between rollouts. ``obs`` is always
    ``env.obs(env_states)``; the env step writes it, so the next rollout
    step and the bootstrap read it without recomputing."""

    env_states: object
    episode_acc: EpisodeAccumulator
    return_norm: ReturnNormState
    obs: torch.Tensor  # [E, D]


def init_rollout_carry(
    env: Environment, num_envs: int, rng: RandomSource, device: torch.device
) -> RolloutCarry:
    states = env.reset(env.draw_reset(rng, num_envs).to(device))
    return RolloutCarry(
        env_states=states,
        episode_acc=EpisodeAccumulator.zero(num_envs, device),
        return_norm=ReturnNormState.create(num_envs, env.spec.num_players, device),
        obs=env.obs(states),
    )


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
) -> Tuple[RolloutCarry, RolloutBatch, EpisodeLog]:
    """Single-player rollout. Returns (carry', batch, episode logs [T, E])."""
    if env.spec.num_players != 1:
        raise NotImplementedError("multiplayer rollouts: ROADMAP A10")
    E = carry.obs.shape[0]
    A = env.spec.num_actions
    device = carry.obs.device
    mask = env.action_mask(E, device)
    cols: dict = {k: [] for k in ("obs", "actions", "rewards", "dones", "values",
                                  "log_probs", "samples", "completed",
                                  "total_rewards", "length")}
    states, acc, ret_norm = carry.env_states, carry.episode_acc, carry.return_norm
    obs_raw = carry.obs
    with torch.no_grad():
        for _ in range(num_steps):
            obs = obs_norm_apply(obs_norm, obs_raw, obs_clip) if obs_norm is not None else obs_raw
            logits, values = network(obs)
            actions, log_probs = masked_sample(logits, mask, rng.uniform((E, A), TINY, 1.0))
            out = env.step_autoreset(states, acc, actions, env.draw_reset(rng, E))
            cols["obs"].append(obs_raw)
            cols["actions"].append(actions)
            cols["rewards"].append(out.reward)
            cols["dones"].append(out.done)
            cols["values"].append(values)
            cols["log_probs"].append(log_probs)
            cols["completed"].append(out.log.completed)
            cols["total_rewards"].append(out.log.total_rewards)
            cols["length"].append(out.log.length)
            if normalize_returns:
                new_returns, samples = return_norm_roll(
                    ret_norm.returns, out.reward, out.done, gamma
                )
                ret_norm = ReturnNormState(new_returns, ret_norm.mean, ret_norm.m2, ret_norm.count)
                cols["samples"].append(samples)
            states, acc, obs_raw = out.state, out.acc, out.obs

    s = {k: torch.stack(v) for k, v in cols.items() if v}
    rewards = s["rewards"]
    if normalize_returns:
        ret_norm, rewards = return_norm_finalize(ret_norm, s["samples"], rewards, return_clip)
    T = num_steps
    batch = RolloutBatch(
        obs=s["obs"],
        actions=s["actions"],
        rewards=rewards,
        dones=s["dones"],
        values=s["values"],
        log_probs=s["log_probs"],
        action_masks=mask.expand(T, E, A),
        valid_mask=torch.ones(T, E, dtype=torch.float32, device=device),
    )
    logs = EpisodeLog(
        completed=s["completed"], total_rewards=s["total_rewards"], length=s["length"]
    )
    new_carry = RolloutCarry(env_states=states, episode_acc=acc, return_norm=ret_norm, obs=obs_raw)
    return new_carry, batch, logs


def bootstrap_values(
    network,
    carry: RolloutCarry,
    obs_norm: Optional[ObsNormState],
    obs_clip: float = 10.0,
) -> torch.Tensor:
    """Value of the final env states for the GAE bootstrap, [E]."""
    obs = carry.obs
    if obs_norm is not None:
        obs = obs_norm_apply(obs_norm, obs, obs_clip)
    with torch.no_grad():
        return network(obs)[1]

"""Generalized Advantage Estimation, with the reverse-scan kernels K3 and K5.

Counterpart of burn_ppo_tpu/ops/gae.py: single-player ``compute_gae``,
turn-based ``compute_gae_multiplayer`` (reward attribution and
per-player GAE chains) and ``compute_explained_variance``. For CPU
tensors the GAE functions run their plain PyTorch loops
(``compute_gae_plain``, ``compute_gae_multiplayer_plain``); for CUDA
tensors they launch the hand-written kernels ``csrc/gae.cu`` (ROADMAP
B4) and ``csrc/gae_multiplayer.cu`` (ROADMAP B9), or raise.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from burn_ppo_torch import kernels


def compute_gae_plain(
    rewards: torch.Tensor,  # [T, E]
    values: torch.Tensor,  # [T, E]
    dones: torch.Tensor,  # [T, E] 1.0 where the episode ended at t
    last_values: torch.Tensor,  # [E] bootstrap V(s_T)
    gamma: float,
    gae_lambda: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch K3: reverse loop over T (gae.py:41-53)."""
    dones = dones.to(values.dtype)
    advantages = torch.empty_like(values)
    next_value = last_values
    last_gae = torch.zeros_like(last_values)
    for t in range(values.shape[0] - 1, -1, -1):
        not_done = 1.0 - dones[t]
        delta = rewards[t] + gamma * next_value * not_done - values[t]
        last_gae = delta + gamma * gae_lambda * not_done * last_gae
        advantages[t] = last_gae
        next_value = values[t]
    return advantages, advantages + values


def compute_gae(
    rewards: torch.Tensor,
    values: torch.Tensor,
    dones: torch.Tensor,
    last_values: torch.Tensor,
    gamma: float,
    gae_lambda: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-player GAE. Returns (advantages [T, E], returns [T, E])."""
    if kernels.on_cpu(rewards, values, dones, last_values):
        return compute_gae_plain(rewards, values, dones, last_values, gamma, gae_lambda)
    T, E = values.shape
    for name, t, shape in (
        ("rewards", rewards, (T, E)),
        ("values", values, (T, E)),
        ("dones", dones, (T, E)),
        ("last_values", last_values, (E,)),
    ):
        kernels.expect(t, name, torch.float32, shape)
    advantages = torch.empty_like(values)
    returns = torch.empty_like(values)
    err = kernels.library().gae_reverse_scan(
        kernels.ptr(rewards), kernels.ptr(values), kernels.ptr(dones),
        kernels.ptr(last_values), kernels.ptr(advantages), kernels.ptr(returns),
        T, E, float(gamma), float(gamma * gae_lambda),
        kernels.stream(values.device),
    )
    kernels.check(err, "gae_reverse_scan")
    compute_gae.launches += 1
    return advantages, returns


kernels.counted(compute_gae)

MAX_KERNEL_PLAYERS = 8


def compute_gae_multiplayer_plain(
    all_rewards: torch.Tensor,  # [T, E, P] per-player rewards each step
    values: torch.Tensor,  # [T, E] acting player's value
    dones: torch.Tensor,  # [T, E]
    acting: torch.Tensor,  # [T, E] int, who acted at step t
    last_vpp: torch.Tensor,  # [E, P] per-player bootstrap values
    gamma: float,
    gae_lambda: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch K5: reverse loop over T (gae.py:85-117). Rewards other
    players earn between a player's turns are credited to that player's
    previous action; each player's GAE chain runs through its own turns."""
    T, E, P = all_rewards.shape
    dones = dones.to(values.dtype)
    seats = torch.arange(P, device=values.device)
    reward_carry = torch.zeros(E, P, dtype=values.dtype, device=values.device)
    gae_carry = torch.zeros_like(reward_carry)
    next_value = last_vpp.to(values.dtype)
    advantages = torch.empty_like(values)
    for t in range(T - 1, -1, -1):
        onehot = (acting[t][:, None] == seats).to(values.dtype)
        keep = 1.0 - dones[t][:, None]
        reward_carry = reward_carry * keep
        attributed = torch.sum(all_rewards[t] * onehot, dim=1) + torch.sum(reward_carry * onehot, dim=1)
        reward_carry = (reward_carry + all_rewards[t]) * (1.0 - onehot)
        gae_carry = gae_carry * keep
        next_value = torch.where(dones[t][:, None] > 0.5, next_value * onehot, next_value)
        not_done = keep[:, 0]
        delta = attributed + gamma * torch.sum(next_value * onehot, dim=1) * not_done - values[t]
        adv = delta + gamma * gae_lambda * not_done * torch.sum(gae_carry * onehot, dim=1)
        gae_carry = gae_carry * (1.0 - onehot) + adv[:, None] * onehot
        next_value = next_value * (1.0 - onehot) + values[t][:, None] * onehot
        advantages[t] = adv
    return advantages, advantages + values


def compute_gae_multiplayer(
    all_rewards: torch.Tensor,
    values: torch.Tensor,
    dones: torch.Tensor,
    acting: torch.Tensor,
    last_vpp: torch.Tensor,
    gamma: float,
    gae_lambda: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Multiplayer GAE. Returns (advantages [T, E], returns [T, E])."""
    if kernels.on_cpu(all_rewards, values, dones, acting, last_vpp):
        return compute_gae_multiplayer_plain(all_rewards, values, dones, acting, last_vpp,
                                             gamma, gae_lambda)
    T, E, P = all_rewards.shape
    if not 1 <= P <= MAX_KERNEL_PLAYERS:
        raise ValueError(f"multiplayer GAE kernel takes 1..{MAX_KERNEL_PLAYERS} players, got {P}")
    for name, t, dtype, shape in (
        ("all_rewards", all_rewards, torch.float32, (T, E, P)),
        ("values", values, torch.float32, (T, E)),
        ("dones", dones, torch.float32, (T, E)),
        ("acting", acting, torch.int32, (T, E)),
        ("last_vpp", last_vpp, torch.float32, (E, P)),
    ):
        kernels.expect(t, name, dtype, shape)
    advantages = torch.empty_like(values)
    returns = torch.empty_like(values)
    p = kernels.ptr
    err = kernels.library().gae_multiplayer_reverse_scan(
        p(all_rewards), p(values), p(dones), p(acting), p(last_vpp), p(advantages),
        p(returns), T, E, P, float(gamma), float(gamma * gae_lambda),
        kernels.stream(values.device),
    )
    kernels.check(err, "gae_multiplayer_reverse_scan")
    compute_gae_multiplayer.launches += 1
    return advantages, returns


kernels.counted(compute_gae_multiplayer)


def compute_explained_variance(
    values: torch.Tensor, returns: torch.Tensor, mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """1 - Var(returns - values) / Var(returns) over (masked) samples;
    0 when Var(returns) < 1e-8 (reference ppo.rs:1268-1290)."""
    if mask is None:
        mask = torch.ones_like(returns)
    mask = mask.to(returns.dtype)
    n = torch.clamp(torch.sum(mask), min=1.0)

    def masked_var(x):
        mean = torch.sum(x * mask) / n
        return torch.sum(torch.square(x - mean) * mask) / n

    var_ret = masked_var(returns)
    var_err = masked_var(returns - values)
    return torch.where(
        var_ret < 1e-8,
        torch.zeros_like(var_ret),
        1.0 - var_err / torch.clamp(var_ret, min=1e-8),
    )

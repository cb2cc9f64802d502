"""Generalized Advantage Estimation, with the reverse-scan kernel K3.

Counterpart of burn_ppo_tpu/ops/gae.py (single-player ``compute_gae``
and ``compute_explained_variance``; the multiplayer variant follows with
ROADMAP A10). For CPU tensors ``compute_gae`` runs the plain PyTorch
loop (``compute_gae_plain``); for CUDA tensors it launches the
hand-written kernel ``csrc/gae.cu`` (ROADMAP B4), or raises.
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


compute_gae.launches = 0


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

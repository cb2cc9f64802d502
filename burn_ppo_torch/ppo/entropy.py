"""Adaptive entropy-coefficient controller (burn_ppo_tpu/ppo/entropy.py).

Bang-bang control steering the policy entropy toward a scheduled target,
a ratio of the maximum entropy ln(A) (reference src/entropy.rs:14-105):
the coefficient moves by +/-delta in the direction of (target - last
entropy), clamped to [min, max]; no adjustment until the first entropy is
recorded.

* ``AdaptiveEntropyState`` and the plain ``adaptive_entropy_step`` /
  ``adaptive_entropy_record``: the device state and its two updates, in
  place on 0-dim tensors made once. On the trainer's path neither runs as
  a launch of its own: the first minibatch's PPO loss (K8,
  ``csrc/ppo_loss.cu``) steps the controller before its rows read the
  coefficient, and every minibatch's finalize records the update's mean
  entropy so far, so the update's last minibatch leaves the mean over the
  minibatches that ran (ROADMAP B19). ``ppo/update.py ppo_loss_plain``
  does the same with these functions on the CPU.
* ``AdaptiveEntropyController``: the host class, kept for the equivalence
  tests against the device state (the JAX package's unfused path).

The host writes only the scheduled target into a device scalar each
update; the controller's state is not checkpointed (a resume restarts
from ``entropy_coef.get(0)``, as the reference's in-memory controller).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from burn_ppo_torch.schedule import Schedule


@dataclass
class AdaptiveEntropyState:
    """The controller's device state (entropy.rs:14-30 fields)."""

    coef: torch.Tensor  # f32 scalar, the current coefficient
    last_entropy: torch.Tensor  # f32 scalar, the most recent entropy recorded
    has_entropy: torch.Tensor  # bool scalar; no adjustment until the first

    @staticmethod
    def create(initial_coef: float, device: torch.device) -> "AdaptiveEntropyState":
        return AdaptiveEntropyState(
            coef=torch.full((), initial_coef, dtype=torch.float32, device=device),
            last_entropy=torch.zeros((), dtype=torch.float32, device=device),
            has_entropy=torch.zeros((), dtype=torch.bool, device=device),
        )


def adaptive_entropy_step(state: AdaptiveEntropyState, target: torch.Tensor, min_coef: float,
                          max_coef: float, delta: float) -> torch.Tensor:
    """``get_coefficient`` (entropy.rs:73-87) in place: the coefficient for
    this update, also stored in ``state.coef``. Rust's ``signum(+0.0)`` is
    +1, so an entropy exactly on target still nudges the coefficient up by
    delta: ``copysign`` reproduces it."""
    error = target - state.last_entropy
    adjusted = torch.clamp(state.coef + delta * torch.copysign(torch.ones_like(error), error),
                           min_coef, max_coef)
    coef = torch.where(state.has_entropy, adjusted, state.coef)
    state.coef.copy_(coef)
    return coef


def adaptive_entropy_record(state: AdaptiveEntropyState, entropy: torch.Tensor) -> None:
    """``record_entropy`` (entropy.rs:62) in place."""
    state.last_entropy.copy_(entropy)
    state.has_entropy.fill_(True)


class AdaptiveEntropyController:
    """The host controller, one update per call (entropy.py:93-119)."""

    def __init__(self, target_schedule: Schedule, num_actions: int, initial_coef: float,
                 min_coef: float = 0.001, max_coef: float = 0.1, delta: float = 0.001):
        self.target_schedule = target_schedule
        self.min_coef = min_coef
        self.max_coef = max_coef
        self.delta = delta
        self.max_entropy = math.log(num_actions)
        self.current_coef = initial_coef
        self.last_entropy: Optional[float] = None

    def record_entropy(self, entropy: float) -> None:
        self.last_entropy = float(entropy)

    def target_entropy(self, step: int) -> float:
        return self.target_schedule.get(step) * self.max_entropy

    def get_coefficient(self, step: int) -> Tuple[float, float]:
        """(coefficient, target entropy), adjusted by the sign of the error."""
        target = self.target_entropy(step)
        if self.last_entropy is not None:
            sign = math.copysign(1.0, target - self.last_entropy)
            self.current_coef = min(self.max_coef,
                                    max(self.min_coef, self.current_coef + self.delta * sign))
        return self.current_coef, target

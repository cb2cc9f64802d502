"""CartPole-v1 as batched tensors, with the fused step kernel K1.

Counterpart of burn_ppo_tpu/envs/cartpole.py: Gym physics with
semi-implicit Euler, a 5-wide obs with the normalised episode time, a 500
step cap, and reward 1 per step except a failure terminal, which pays 0.
One player: rewards and episode returns are ``[E, 1]``, every action is
legal and every finished episode places first.

``step_autoreset`` is the rollout's env step. For CPU tensors it runs the
plain PyTorch composition (``envs/base.py autoreset_step`` over ``step``,
``reset`` and ``obs`` below); for CUDA tensors it launches the hand-written
kernel ``csrc/cartpole_step.cu`` (ROADMAP B1), or raises.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from burn_ppo_torch import kernels
from burn_ppo_torch.envs.base import (
    EnvSpec,
    Environment,
    EpisodeAccumulator,
    EpisodeLog,
    StepOutput,
    autoreset_step,
)

# The reference's constants are Python doubles that meet f32 arrays and
# round to f32; the same f32 values are spelled out in the kernel.
GRAVITY = 9.8
CART_MASS = 1.0
POLE_MASS = 0.1
TOTAL_MASS = CART_MASS + POLE_MASS
POLE_HALF_LENGTH = 0.5
POLE_MASS_LENGTH = POLE_MASS * POLE_HALF_LENGTH
FORCE_MAG = 10.0
TAU = 0.02
X_THRESHOLD = 2.4
THETA_THRESHOLD = float(np.float32(12.0 * math.pi / 180.0))
MAX_STEPS = 500
RESET_LOW, RESET_HIGH = -0.05, 0.05


@dataclass
class CartPoleState:
    """Struct of arrays over E envs."""

    x: torch.Tensor  # [E] f32
    x_dot: torch.Tensor
    theta: torch.Tensor
    theta_dot: torch.Tensor
    step_idx: torch.Tensor  # [E] i32


class CartPole(Environment):
    spec = EnvSpec(
        name="cartpole",
        obs_dim=5,
        num_actions=2,
        num_players=1,
        max_episode_steps=MAX_STEPS,
    )

    def draw_reset(self, rng, num_envs: int) -> torch.Tensor:
        """[E, 4] initial (x, x_dot, theta, theta_dot) in [-0.05, 0.05)."""
        return rng.uniform((num_envs, 4), RESET_LOW, RESET_HIGH)

    def reset(self, reset_values: torch.Tensor) -> CartPoleState:
        v = reset_values
        return CartPoleState(
            x=v[:, 0].contiguous(),
            x_dot=v[:, 1].contiguous(),
            theta=v[:, 2].contiguous(),
            theta_dot=v[:, 3].contiguous(),
            step_idx=torch.zeros(v.shape[0], dtype=torch.int32, device=v.device),
        )

    def step(self, state: CartPoleState, action: torch.Tensor):
        force = torch.where(action == 0, -FORCE_MAG, FORCE_MAG)
        cos_t = torch.cos(state.theta)
        sin_t = torch.sin(state.theta)
        temp = (
            force + POLE_MASS_LENGTH * torch.square(state.theta_dot) * sin_t
        ) / TOTAL_MASS
        theta_acc = (GRAVITY * sin_t - cos_t * temp) / (
            POLE_HALF_LENGTH
            * (4.0 / 3.0 - POLE_MASS * torch.square(cos_t) / TOTAL_MASS)
        )
        x_acc = temp - POLE_MASS_LENGTH * theta_acc * cos_t / TOTAL_MASS

        x_dot = state.x_dot + TAU * x_acc
        x = state.x + TAU * x_dot
        theta_dot = state.theta_dot + TAU * theta_acc
        theta = state.theta + TAU * theta_dot
        steps = state.step_idx + 1

        failed = (torch.abs(x) > X_THRESHOLD) | (torch.abs(theta) > THETA_THRESHOLD)
        done = failed | (steps >= MAX_STEPS)
        reward = torch.where(failed & (steps < MAX_STEPS), 0.0, 1.0).to(torch.float32)
        stepped = CartPoleState(x, x_dot, theta, theta_dot, steps)
        return stepped, reward[:, None], done

    def obs(self, state: CartPoleState) -> torch.Tensor:
        return torch.stack(
            [
                state.x,
                state.x_dot,
                state.theta,
                state.theta_dot,
                state.step_idx.to(torch.float32) / MAX_STEPS,
            ],
            dim=1,
        )

    def step_autoreset(
        self,
        state: CartPoleState,
        acc: EpisodeAccumulator,
        action: torch.Tensor,
        reset_values: torch.Tensor,
    ) -> StepOutput:
        return cartpole_step_autoreset(self, state, acc, action, reset_values)


def cartpole_step_autoreset(
    env: CartPole,
    state: CartPoleState,
    acc: EpisodeAccumulator,
    action: torch.Tensor,
    reset_values: torch.Tensor,
) -> StepOutput:
    """One auto-reset step of every env: plain PyTorch on the CPU, kernel
    K1 on a CUDA device."""
    if kernels.on_cpu(state.x, action, reset_values):
        return autoreset_step(env, state, acc, action, reset_values)
    return _launch(state, acc, action, reset_values)


cartpole_step_autoreset.launches = 0


def _launch(state, acc, action, reset_values) -> StepOutput:
    E = state.x.shape[0]
    f32, i32 = torch.float32, torch.int32
    for name, t, dt, shape in (
        ("x", state.x, f32, (E,)),
        ("x_dot", state.x_dot, f32, (E,)),
        ("theta", state.theta, f32, (E,)),
        ("theta_dot", state.theta_dot, f32, (E,)),
        ("step_idx", state.step_idx, i32, (E,)),
        ("reward_sum", acc.reward_sum, f32, (E, 1)),
        ("length", acc.length, i32, (E,)),
        ("action", action, i32, (E,)),
        ("reset_values", reset_values, f32, (E, 4)),
    ):
        kernels.expect(t, name, dt, shape)
    dev = state.x.device
    nxt = CartPoleState(*(torch.empty(E, dtype=f32, device=dev) for _ in range(4)),
                        step_idx=torch.empty(E, dtype=i32, device=dev))
    nacc = EpisodeAccumulator(
        reward_sum=torch.empty(E, 1, dtype=f32, device=dev),
        length=torch.empty(E, dtype=i32, device=dev),
    )
    reward = torch.empty(E, 1, dtype=f32, device=dev)
    done = torch.empty(E, dtype=f32, device=dev)
    ep_return = torch.empty(E, 1, dtype=f32, device=dev)
    ep_length = torch.empty(E, dtype=i32, device=dev)
    outcome = torch.empty(E, 1, dtype=i32, device=dev)
    active = torch.empty(E, dtype=i32, device=dev)
    obs = torch.empty(E, 5, dtype=f32, device=dev)
    mask = torch.empty(E, 2, dtype=f32, device=dev)
    p = kernels.ptr
    err = kernels.library().cartpole_step_autoreset(
        p(state.x), p(state.x_dot), p(state.theta), p(state.theta_dot),
        p(state.step_idx), p(acc.reward_sum), p(acc.length), p(action),
        p(reset_values),
        p(nxt.x), p(nxt.x_dot), p(nxt.theta), p(nxt.theta_dot), p(nxt.step_idx),
        p(nacc.reward_sum), p(nacc.length), p(reward), p(done), p(ep_return),
        p(ep_length), p(outcome), p(active), p(obs), p(mask), E, kernels.stream(dev),
    )
    kernels.check(err, "cartpole_step_autoreset")
    cartpole_step_autoreset.launches += 1
    log = EpisodeLog(completed=done, total_rewards=ep_return, length=ep_length,
                     outcome=outcome, active_players=active)
    return StepOutput(nxt, nacc, reward, done, log, obs, mask)

"""CartPole-v1 as batched tensors, with the fused step kernel K1.

Counterpart of burn_ppo_tpu/envs/cartpole.py: Gym physics with
semi-implicit Euler, a 5-wide obs with the normalised episode time, a 500
step cap, and reward 1 per step except a failure terminal, which pays 0.
One player: rewards and episode returns are ``[E, 1]``, every action is
legal and every finished episode places first.

The state is the four physics floats of each env as ONE ``[E, 4]`` f32
tensor (one 16-byte row an env; ``x``, ``x_dot``, ``theta`` and
``theta_dot`` read as views) and ``step_idx`` [E] i32.

``step_autoreset`` is the rollout's env step. For CPU tensors it runs the
plain PyTorch composition (``envs/base.py autoreset_step`` over ``step``,
``reset`` and ``obs`` below, then, with ``roll``,
``ppo/normalization.py return_norm_roll_plain`` on player 0's slot); for
CUDA tensors it launches the hand-written kernel ``csrc/cartpole_step.cu``
(ROADMAP B1), the roll folded in, or raises.
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
    arena_size,
    autoreset_step,
    carve_arena,
    env_row,
)
from burn_ppo_torch.ppo.normalization import return_norm_roll_plain

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
OBS_DIM = 5


def _column(i: int) -> property:
    return property(lambda self: self.phys[:, i])


@dataclass
class CartPoleState:
    """E envs: ``phys`` [E, 4] f32 rows (x, x_dot, theta, theta_dot), read
    by name as views, and ``step_idx`` [E] i32."""

    phys: torch.Tensor  # [E, 4] f32
    step_idx: torch.Tensor  # [E] i32

    x = _column(0)
    x_dot = _column(1)
    theta = _column(2)
    theta_dot = _column(3)

    @staticmethod
    def of(x, x_dot, theta, theta_dot, step_idx) -> "CartPoleState":
        return CartPoleState(torch.stack([x, x_dot, theta, theta_dot], dim=1), step_idx)


class CartPole(Environment):
    spec = EnvSpec(
        name="cartpole",
        obs_dim=OBS_DIM,
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
            phys=v.to(torch.float32).contiguous(),
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
        stepped = CartPoleState.of(x, x_dot, theta, theta_dot, steps)
        return stepped, reward[:, None], done

    def obs(self, state: CartPoleState) -> torch.Tensor:
        return torch.cat([state.phys, (state.step_idx.to(torch.float32) / MAX_STEPS)[:, None]],
                         dim=1)

    def step_autoreset(self, state, acc, action, reset_values, step_values=None,
                       roll=None) -> StepOutput:
        return cartpole_step_autoreset(self, state, acc, action, reset_values, roll)

    # -- human-facing helpers (cartpole.py:114-139) --------------------------
    def describe_action(self, action: int) -> str:
        return "Push left" if action == 0 else "Push right"

    def parse_action(self, text: str) -> int:
        t = text.strip().lower()
        if t in ("left", "l", "0"):
            return 0
        if t in ("right", "r", "1"):
            return 1
        raise ValueError("Enter 'left' or 'right' (or 'l'/'r')")

    def render(self, state: CartPoleState, index: int = 0) -> str:
        s = env_row(state, index)
        x, theta = float(s.x[0]), float(s.theta[0])
        width = 41
        pos = int((x / X_THRESHOLD + 1.0) * (width - 1) / 2)
        pos = max(0, min(width - 1, pos))
        track = ["-"] * width
        track[pos] = "C"
        angle_deg = theta * 180.0 / 3.141592653589793
        return (f"x={x:+.3f} theta={angle_deg:+.2f}deg step={int(s.step_idx[0])}\n"
                + "".join(track))


def cartpole_step_autoreset(
    env: CartPole,
    state: CartPoleState,
    acc: EpisodeAccumulator,
    action: torch.Tensor,
    reset_values: torch.Tensor,
    roll=None,
) -> StepOutput:
    """One auto-reset step of every env: plain PyTorch on the CPU, kernel
    K1 on a CUDA device. With ``roll`` = (rolling returns [E, 1], gamma)
    the step also advances the return normaliser's rolling return of the
    one player and returns it and the samples (``StepOutput.returns``,
    ``samples``)."""
    if kernels.on_cpu(state.phys, action, reset_values):
        out = autoreset_step(env, state, acc, action, reset_values)
        if roll is None:
            return out
        returns, gamma = roll
        acting = torch.zeros(action.shape[0], dtype=torch.int32)
        new_returns, samples = return_norm_roll_plain(returns, out.rewards[:, 0], acting,
                                                      out.done, gamma)
        return out._replace(returns=new_returns, samples=samples)
    return _launch(state, acc, action, reset_values, roll)


kernels.counted(cartpole_step_autoreset)

# The kernel's outputs, carved from one i32 and one f32 buffer (envs/base.py
# carve_arena); csrc/cartpole_step.cu computes the same offsets. ROLL_OUT
# follows F32_OUT where the roll is folded in.
I32_OUT = (("step_idx", 1), ("acc_length", 1), ("log_length", 1), ("outcome", (1,)),
           ("active_players", 1))
F32_OUT = (("phys", 4), ("acc_reward_sum", (1,)), ("rewards", (1,)), ("done", 1),
           ("log_total_rewards", (1,)), ("obs", OBS_DIM), ("mask", 2))
ROLL_OUT = F32_OUT + (("returns", (1,)), ("samples", 1))


def _launch(state: CartPoleState, acc: EpisodeAccumulator, action: torch.Tensor,
            reset_values: torch.Tensor, roll) -> StepOutput:
    E, dev = state.phys.shape[0], state.phys.device
    f32, i32 = torch.float32, torch.int32
    kernels.expect(state.phys, "state.phys", f32, (E, 4))
    kernels.expect_rows16(state.phys, "state.phys")
    kernels.expect(state.step_idx, "state.step_idx", i32, (E,))
    kernels.expect(acc.reward_sum, "reward_sum", f32, (E, 1))
    kernels.expect(acc.length, "length", i32, (E,))
    kernels.expect(action, "action", i32, (E,))
    kernels.expect(reset_values, "reset_values", f32, (E, 4))
    kernels.expect_rows16(reset_values, "reset_values")
    returns, gamma = (None, 0.0) if roll is None else roll
    if returns is not None:
        kernels.expect(returns, "returns", f32, (E, 1))
    f_out = F32_OUT if returns is None else ROLL_OUT
    oi = torch.empty(arena_size(E, I32_OUT), dtype=i32, device=dev)
    of = torch.empty(arena_size(E, f_out), dtype=f32, device=dev)
    err = kernels.library().cartpole_step_autoreset(
        state.phys.data_ptr(), state.step_idx.data_ptr(), acc.reward_sum.data_ptr(),
        acc.length.data_ptr(), action.data_ptr(), reset_values.data_ptr(),
        kernels.ptr(returns), oi.data_ptr(), of.data_ptr(), E, float(gamma),
        kernels.stream(dev))
    kernels.check(err, "cartpole_step_autoreset")
    cartpole_step_autoreset.launches += 1
    oi, of = carve_arena(oi, E, I32_OUT), carve_arena(of, E, f_out)
    done = of["done"]
    log = EpisodeLog(completed=done, total_rewards=of["log_total_rewards"],
                     length=oi["log_length"], outcome=oi["outcome"],
                     active_players=oi["active_players"])
    return StepOutput(CartPoleState(of["phys"], oi["step_idx"]),
                      EpisodeAccumulator(of["acc_reward_sum"], oi["acc_length"]),
                      of["rewards"], done, log, of["obs"], of["mask"],
                      returns=of.get("returns"), samples=of.get("samples"))

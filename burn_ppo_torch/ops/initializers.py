"""Parameter initializers (burn_ppo_tpu/ops/initializers.py).

Orthogonal init with per-layer gains: hidden layers sqrt(2) for relu and
1.0 for tanh, the policy head 0.01, the value head 1.0; biases start at 0.
"""

from __future__ import annotations

import math

import torch


def orthogonal(shape: tuple, gain: float, generator: torch.Generator) -> torch.Tensor:
    """Orthogonal matrix of ``shape`` = (in_dim, out_dim), the JAX layout,
    drawn on the generator's device: QR of a Gaussian with the sign
    correction that makes the distribution uniform over orthogonal
    matrices (the reference's construction)."""
    if len(shape) < 2:
        raise ValueError("orthogonal init requires >= 2 dimensions")
    n_rows = math.prod(shape[:-1])
    n_cols = shape[-1]
    flat = (max(n_rows, n_cols), min(n_rows, n_cols))
    a = torch.randn(flat, generator=generator, device=generator.device)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))
    if n_rows < n_cols:
        q = q.T
    return gain * q.reshape(shape)


def hidden_gain(activation: str) -> float:
    """sqrt(2) for relu, 1.0 for tanh (reference mlp.rs:84)."""
    return math.sqrt(2.0) if activation == "relu" else 1.0


POLICY_HEAD_GAIN = 0.01
VALUE_HEAD_GAIN = 1.0

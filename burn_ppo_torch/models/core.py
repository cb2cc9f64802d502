"""Dense layers and MLP stacks (burn_ppo_tpu/models/core.py:29-43, 83-96).

The reference keeps parameters as pytrees with ``[in, out]`` kernels; the
port uses ``nn.Linear`` (``weight`` is ``[out, in]``). ``convert.py``
maps between the two layouts.
"""

from __future__ import annotations

import torch
from torch import nn

from burn_ppo_torch.ops.initializers import orthogonal


def dense_init(in_dim: int, out_dim: int, gain: float, generator: torch.Generator) -> nn.Linear:
    """Orthogonal kernel + zero bias (reference src/network/mlp.rs:16-38),
    drawn on the generator's device."""
    layer = nn.Linear(in_dim, out_dim, device=generator.device)
    with torch.no_grad():
        layer.weight.copy_(orthogonal((in_dim, out_dim), gain, generator).T)
        layer.bias.zero_()
    return layer


def activation_fn(name: str):
    if name == "relu":
        return torch.relu
    if name == "tanh":
        return torch.tanh
    raise ValueError(f"Unknown activation '{name}' (expected 'relu' or 'tanh')")


def mlp_stack_init(
    in_dim: int, hidden: int, n_layers: int, gain: float, generator: torch.Generator
) -> nn.ModuleList:
    layers, size = [], in_dim
    for _ in range(n_layers):
        layers.append(dense_init(size, hidden, gain, generator))
        size = hidden
    return nn.ModuleList(layers)


def mlp_stack_apply(layers: nn.ModuleList, x: torch.Tensor, act) -> torch.Tensor:
    for layer in layers:
        x = act(layer(x))
    return x

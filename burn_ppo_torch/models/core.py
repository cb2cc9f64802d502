"""Dense and conv layers, MLP stacks (burn_ppo_tpu/models/core.py:29-96).

The reference keeps parameters as pytrees with ``[in, out]`` dense
kernels and HWIO conv kernels over NHWC activations; the port uses
``nn.Linear`` (``weight`` is ``[out, in]``) and ``nn.Conv2d`` (OIHW over
NCHW, computed by cuDNN on the card). ``convert.py`` maps between the two
layouts.
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


def conv_init(
    in_ch: int, out_ch: int, kernel_size: int, gain: float, generator: torch.Generator
) -> nn.Conv2d:
    """Stride-1, SAME-padded conv (models/core.py:46-72): an orthogonal
    kernel drawn in the reference's HWIO shape, stored OIHW, zero bias.
    PyTorch's ``padding="same"`` pads as XLA's SAME does, the odd pixel of
    an even kernel on the high side."""
    conv = nn.Conv2d(in_ch, out_ch, kernel_size, padding="same", device=generator.device)
    k = kernel_size
    with torch.no_grad():
        conv.weight.copy_(orthogonal((k, k, in_ch, out_ch), gain, generator).permute(3, 2, 0, 1))
        conv.bias.zero_()
    return conv


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

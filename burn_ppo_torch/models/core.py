"""Dense and conv layers, MLP stacks (burn_ppo_tpu/models/core.py:29-96).

The reference keeps parameters as pytrees with ``[in, out]`` dense
kernels and HWIO conv kernels over NHWC activations; the port uses
``nn.Linear`` (``weight`` is ``[out, in]``) and ``nn.Conv2d`` (OIHW over
NCHW, computed by cuDNN on the card). ``convert.py`` maps between the two
layouts.

With the bf16 compute dtype (``compute_dtype="bfloat16"``,
burn_ppo_tpu/models/core.py:37-70) every dense and conv layer rounds its
input and its kernel to bf16, takes the product with an f32 output and
adds the f32 bias; parameters, gradients and outputs stay f32. The
products of two bf16 values are exact in f32, so what differs from an
f32 layer is the rounding of the operands alone. The backward is JAX's
transpose of that forward, with the f32 cotangent g in both products and
each product rounded to bf16 as the cotangent of a bf16 operand, then
widened back: ``grad_x = f32(bf16(g @ W_b^T))``, ``grad_W =
f32(bf16(x_b^T @ g))``, ``grad_b = sum(g)`` in f32. JAX 0.9 cannot
transpose its own bf16 conv (the transpose mixes an f32 cotangent with a
bf16 operand and ``conv_general_dilated`` refuses it), so the conv's
backward follows the dense's rule.

On the card the dense forward is cuBLAS's bf16 product with an f32
output and the bias in its epilogue (``torch.addmm(..., out_dtype=
torch.float32)``, which torch 2.11 runs on CUDA); the conv's forward
is cuDNN's f32 conv of the rounded operands (cuDNN's bf16 conv returns
bf16, one rounding more), TF32 off; the backward's products are f32
products of the rounded operands (g stays f32: rounding it to reach the
bf16 tensor cores would be a different computation). On the CPU (no
``addmm.dtype`` kernel there) the forward's product is the f32 product of
the same rounded operands. The roundings and the backward's products run
under the profiler labels ``BF16_ROUND`` and ``BF16_BACKWARD_PRODUCT``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from burn_ppo_torch.ops.initializers import orthogonal

BF16 = "bfloat16"
COMPUTE_DTYPES = (None, BF16)
BF16_ROUND = "bf16_round"
BF16_BACKWARD_PRODUCT = "bf16_backward_f32_product"


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


def check_compute_dtype(compute_dtype: Optional[str]) -> None:
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype {compute_dtype!r}: expected None (f32) or {BF16!r}")


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bf16 (to nearest, ties to even, as XLA converts)."""
    with torch.profiler.record_function(BF16_ROUND):
        return t.to(torch.bfloat16)


def widened(t: torch.Tensor) -> torch.Tensor:
    """A bf16 cotangent widened back to f32: ``f32(bf16(t))``."""
    with torch.profiler.record_function(BF16_ROUND):
        return t.to(torch.bfloat16).to(torch.float32)


def bf16_addmm(bias: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``bias + a @ b`` of two bf16 matrices, in f32: cuBLAS's bf16 GEMM
    with an f32 output and the f32 bias added in its epilogue on the card
    (the f32 sum, then one f32 add, as JAX's dot then ``+ bias``), the f32
    product of the same values plus the bias on the CPU."""
    if a.is_cuda:
        return torch.addmm(bias, a, b, out_dtype=torch.float32)
    return a.float() @ b.float() + bias


class _DenseBF16(torch.autograd.Function):
    """``x [B, in] -> bf16(x) @ bf16(W)^T + b`` in f32, W ``[out, in]``."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        x_b, w_b = round_bf16(x), round_bf16(weight)
        ctx.save_for_backward(x_b, w_b)
        return bf16_addmm(bias, x_b, w_b.t())

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        x_b, w_b = ctx.saved_tensors
        need_x, need_w, need_b = ctx.needs_input_grad
        grad_x = grad_w = grad_b = None
        with torch.profiler.record_function(BF16_BACKWARD_PRODUCT):
            if need_x:
                grad_x = g @ w_b.float()
            if need_w:
                grad_w = g.t() @ x_b.float()
        if need_x:
            grad_x = widened(grad_x)
        if need_w:
            grad_w = widened(grad_w)
        if need_b:
            grad_b = g.sum(0)
        return grad_x, grad_w, grad_b


def same_pads(kernel_size) -> tuple:
    """XLA's SAME padding of a stride-1 conv as ``F.pad``'s (left, right,
    top, bottom): the odd pixel of an even kernel on the high side."""
    kh, kw = kernel_size
    return ((kw - 1) // 2, kw // 2, (kh - 1) // 2, kh // 2)


class _Conv2dSameBF16(torch.autograd.Function):
    """NCHW ``x`` -> the SAME conv of bf16(x) and bf16(W) plus the bias,
    in f32."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                pads: tuple) -> torch.Tensor:
        x_p = F.pad(round_bf16(x).float(), pads)
        w_r = round_bf16(weight).float()
        ctx.save_for_backward(x_p, w_r)
        ctx.pads, ctx.hw = pads, x.shape[2:]
        return F.conv2d(x_p, w_r, bias)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        x_p, w_r = ctx.saved_tensors
        need_x, need_w, need_b, _ = ctx.needs_input_grad
        with torch.profiler.record_function(BF16_BACKWARD_PRODUCT):
            gx, gw, _ = torch.ops.aten.convolution_backward(
                g.contiguous(), x_p, w_r, None, [1, 1], [0, 0], [1, 1], False, [0, 0], 1,
                [need_x, need_w, False])
        grad_x = grad_w = grad_b = None
        if need_x:
            left, _, top, _ = ctx.pads
            H, W = ctx.hw
            grad_x = widened(gx[:, :, top:top + H, left:left + W])
        if need_w:
            grad_w = widened(gw)
        if need_b:
            grad_b = g.sum((0, 2, 3))
        return grad_x, grad_w, grad_b, None


def dense(layer: nn.Linear, x: torch.Tensor, compute_dtype: Optional[str] = None) -> torch.Tensor:
    """One dense layer (burn_ppo_tpu/models/core.py:37-43): the f32
    ``nn.Linear``, or with ``compute_dtype="bfloat16"`` bf16 operands, an
    f32 product and the f32 bias."""
    if compute_dtype is None:
        return layer(x)
    return _DenseBF16.apply(x, layer.weight, layer.bias)


def conv2d_same(conv: nn.Conv2d, x: torch.Tensor, compute_dtype: Optional[str] = None) -> torch.Tensor:
    """One stride-1 SAME conv over NCHW ``x`` (burn_ppo_tpu/models/core.py:54-70):
    the f32 ``nn.Conv2d``, or with ``compute_dtype="bfloat16"`` bf16
    operands, an f32 conv and the f32 bias."""
    if compute_dtype is None:
        return conv(x)
    return _Conv2dSameBF16.apply(x, conv.weight, conv.bias, same_pads(conv.kernel_size))


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


def mlp_stack_apply(layers: nn.ModuleList, x: torch.Tensor, act,
                    compute_dtype: Optional[str] = None) -> torch.Tensor:
    for layer in layers:
        x = act(dense(layer, x, compute_dtype))
    return x

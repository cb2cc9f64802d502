"""Device resolution: the one place the port picks where tensors live."""

from __future__ import annotations

import torch


def resolve_device(name: str | torch.device) -> torch.device:
    """``"cuda"`` / ``"cuda:N"`` / ``"cpu"`` -> a torch.device.

    A CUDA request on a machine without a usable card raises: the port
    never falls back to the CPU silently. Float32 matmuls and convolutions
    are pinned to full precision (no TF32), as the reference runs at
    ``highest`` matmul precision.
    """
    device = torch.device(name)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(name)!r} requested but torch.cuda.is_available() "
                "is False"
            )
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {str(name)!r} (expected cuda or cpu)")
    return device

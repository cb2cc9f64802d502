"""K7's opponent towers packed at the rotation, as its bf16 tower and its
feature front hold them in shared memory (``csrc/opponent_tower.cuh``).

Each layer ``[K, in, out]`` of a stack becomes ``[K, kb, nt, 32, E]``: its
input rows cut into k-blocks (32 rows for bf16, 16 for f32), its output
columns into 8-column tiles, and each (k-block, tile) as the 32 lanes of a
warp hold it as the B fragments of two ``mma.sync`` steps, 16 bytes a lane
(E = 8 bf16 or 4 floats). For bf16 (m16n8k16), lane ``l`` holds rows ``16 s
+ 2 (l % 4) + h + 8 r`` of column ``l // 4`` at element ``4 s + 2 r + h``;
for f32 (m16n8k8) rows ``8 s + l % 4 + 4 r`` at element ``2 s + r``. A
k-block's tiles are contiguous, so the kernel moves a block's column slice
of a layer by bulk copies and reads a lane's fragments of two k-steps with
one conflict-free 16-byte shared load. The inputs past a layer's width and
the head's columns past its width are zeros.

The feature front's first layer also has its rows permuted: the kernel
reads a row's conv features in the conv output's NCHW order (channel,
then pixel), one contiguous range, where JAX's flatten is NHWC (pixel,
then channel); ``nchw_rows`` gives that order.

Plain tensor code: it runs on the CPU too, and ``unpack_tower`` gives the
stack's weights back bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch

LANES = 32
TILE = 8
UNIT_BYTES = 512  # one (k-block, tile): 32 lanes x 16 bytes


def k_block(dtype: torch.dtype) -> int:
    """Input rows of a packed k-block: two mma.sync k-steps."""
    return 32 if dtype == torch.bfloat16 else 16


def _fragment_index(kb: int, nt: int, dtype: torch.dtype,
                    device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (row, column) of the padded [kb * KB, nt * 8] layer that each
    packed element ``[kb, nt, lane, e]`` holds."""
    lane = torch.arange(LANES, device=device)
    if dtype == torch.bfloat16:
        e = torch.arange(8, device=device)
        s, r, h = e // 4, (e // 2) % 2, e % 2
        k_in = (16 * s + 8 * r + h)[None, :] + 2 * (lane % 4)[:, None]
    else:
        e = torch.arange(4, device=device)
        s, r = e // 2, e % 2
        k_in = (8 * s + 4 * r)[None, :] + (lane % 4)[:, None]
    n_in = (lane // 4)[:, None].expand_as(k_in)
    KB = k_block(dtype)
    rows = torch.arange(kb, device=device)[:, None, None, None] * KB + k_in
    cols = torch.arange(nt, device=device)[None, :, None, None] * TILE + n_in
    return rows.expand(kb, nt, *k_in.shape), cols.expand(kb, nt, *k_in.shape)


def _padded_shape(n_in: int, n_out: int, dtype: torch.dtype) -> Tuple[int, int]:
    KB = k_block(dtype)
    return -(-n_in // KB), -(-n_out // TILE)


def pack_layer(w: torch.Tensor, rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One layer ``[K, in, out]`` (bf16 or f32) packed as ``[K, kb, nt, 32,
    E]``; ``rows``: the order in which the packed layer reads the input
    rows (packed row j holds row ``rows[j]``)."""
    K, n_in, n_out = w.shape
    if rows is not None:
        w = w[:, rows]
    kb, nt = _padded_shape(n_in, n_out, w.dtype)
    padded = w.new_zeros(K, kb * k_block(w.dtype), nt * TILE)
    padded[:, :n_in, :n_out] = w
    r, c = _fragment_index(kb, nt, w.dtype, w.device)
    return padded[:, r, c].contiguous()


def unpack_layer(packed: torch.Tensor, n_in: int, n_out: int,
                 rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``pack_layer``'s inverse: the layer ``[K, n_in, n_out]``."""
    K, kb, nt = packed.shape[:3]
    padded = packed.new_empty(K, kb * k_block(packed.dtype), nt * TILE)
    r, c = _fragment_index(kb, nt, packed.dtype, packed.device)
    padded[:, r, c] = packed
    w = padded[:, :n_in, :n_out]
    if rows is not None:
        w = w[:, torch.argsort(rows)]
    return w.contiguous()


def nchw_rows(obs_shape: Sequence[int], channels: int, width: int,
              device=None) -> torch.Tensor:
    """The first FC layer's rows in the order the feature front reads its
    input: for j < H W C' (C' = ``channels``, the last conv's), row j is
    channel j // (H W) at pixel j % (H W) of the conv output, which JAX's
    NHWC flatten puts at row (j % (H W)) C' + j // (H W); the obs columns
    past the spatial slice follow unmoved, up to ``width``."""
    H, W, _ = obs_shape
    n = H * W * channels
    j = torch.arange(n, device=device)
    head = (j % (H * W)) * channels + j // (H * W)
    return torch.cat([head, torch.arange(n, width, device=device)])


@dataclass
class PackedTower:
    """A stack's FC tower and head packed for K7's bf16 tower or feature
    front: one ``[K, kb, nt, 32, E]`` tensor a layer."""

    layers: List[torch.Tensor]


def pack_tower(weights: Sequence[torch.Tensor],
               first_rows: Optional[torch.Tensor] = None) -> PackedTower:
    """Every layer packed; ``first_rows``: the first layer's row order
    (``nchw_rows`` for the feature front)."""
    return PackedTower(layers=[pack_layer(w, first_rows if i == 0 else None)
                               for i, w in enumerate(weights)])


def unpack_tower(packed: PackedTower, widths: Sequence[int],
                 first_rows: Optional[torch.Tensor] = None) -> List[torch.Tensor]:
    """``pack_tower``'s inverse for a tower of ``widths`` [in, hidden...,
    head]."""
    return [unpack_layer(w, widths[i], widths[i + 1], first_rows if i == 0 else None)
            for i, w in enumerate(packed.layers)]

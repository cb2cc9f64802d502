"""Update windows: several updates per host call, one report a window
(burn_ppo_tpu/train.py:291-360, 434-516), with kernels K18 and K19.

The JAX package scans k fused train steps on the device between two log,
checkpoint or time boundaries and reports once: the last update's
metrics, the guard counters summed, the window's maxima of ``approx_kl``
and ``clip_fraction`` and the episode summaries summed
(``_aggregate_window``); on the vs-pool path it also compacts the
window's completed pool games into a fixed ``[C, 2P-1]`` int8 buffer
(``compact_records``). The port runs a window as a host loop of the
rollout and update graph replays, and keeps the report and the records
on the device in a ``WindowBook``, folded into once an update by two hand
kernels inside the update's graphs:

* K18 (``window_records``, ``csrc/window_records.cu``) appends an update's
  completed pool games, read in place from the rollout's logs, at a
  running count, in JAX's (w, t, e) order, rows past the capacity
  counted and dropped;
* K19 (``window_report``, ``csrc/window_report.cu``) folds the update's
  metrics and summaries into the window's accumulators.

Both read the book's first-update flag (the host sets it at the window's
start, K19 clears it), so nothing is read back inside a window: the host
fetches the report, and the rows, once a window (``WindowBook.fetch``).
Each wrapper runs its plain PyTorch version for CPU tensors and launches
its kernel for CUDA tensors, or raises.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from burn_ppo_torch import kernels

# The longest window (train.py:1080-1083) and the record buffer's least
# capacity (train.py:489).
MAX_WINDOW = 64
MIN_RECORD_ROWS = 4096
GUARD_METRIC_KEYS = ("invalid_mask_count", "nonfinite_count")
MAX_METRIC_KEYS = ("approx_kl", "clip_fraction")
# K19's fold of each field (csrc/window_report.cu Op) and its sizes.
LAST, SUM, MAX, MIN = 0, 1, 2, 3
MAX_FIELDS, MAX_ENTRIES = 48, 128
# K18's entries a tile (csrc/window_records.cu TILE) and the tiles its
# scan's scratch holds: 8M entries an update (T x Ep), e.g. 128 x 65,536.
RECORD_TILE, MAX_RECORD_TILES = 1024, 8192
STATS_FOLDS = (("count", SUM), ("ret_sum", SUM), ("ret0_max", MAX), ("ret0_min", MIN),
               ("len_sum", SUM), ("pts_sum", SUM), ("draws", SUM))


def largest_pow2_le(n: int) -> int:
    """Largest power of two <= n (n >= 1), the one quantization of every
    window size (train.py:321-330)."""
    k = 1
    while k * 2 <= n:
        k *= 2
    return k


def record_capacity(window: int, num_steps: int, pool_envs: int) -> int:
    """The record buffer's rows for a window of ``window`` updates:
    max(4096, N // 8), N = W T Ep (train.py:464-489)."""
    return max(MIN_RECORD_ROWS, window * num_steps * pool_envs // 8)


class WindowBook:
    """An update window's report and records on the device: the
    first-update flag (i32, set by ``start``, cleared by K19), the
    report's accumulators (f32 [128], laid out at the first fold from the
    metrics' and summaries' keys) and, with ``record_rows``, the record
    buffer (int8 [record_rows, 2P-1]), the running count of the window's
    completed pool games (i32, those past the capacity included) and the
    window's capacity (i32, ``record_capacity`` of its length, at most
    ``record_rows``), and K18's scan scratch (``scan``: u64 as i64 [1 +
    ``MAX_RECORD_TILES``], zeroed once: the ticket and the tiles' flags,
    left consistent by every launch). Every tensor keeps its address: the
    update graphs read and write them where they were captured."""

    def __init__(self, device: torch.device, num_players: int, record_rows: int = 0):
        i32 = torch.int32
        self.device = torch.device(device)
        self.num_players = num_players
        self.first = torch.ones((), dtype=i32, device=self.device)
        self.acc = torch.zeros(MAX_ENTRIES, dtype=torch.float32, device=self.device)
        self.total = torch.zeros((), dtype=i32, device=self.device)
        self.cap = torch.zeros((), dtype=i32, device=self.device)
        self.rows = (torch.zeros(record_rows, 2 * num_players - 1, dtype=torch.int8,
                                 device=self.device) if record_rows else None)
        self.scan = (torch.zeros(1 + MAX_RECORD_TILES, dtype=torch.int64, device=self.device)
                     if record_rows and self.device.type == "cuda" else None)
        # (group, key, source key, fold, entries) of each field
        self.layout: Optional[List[Tuple[str, str, str, int, int]]] = None
        self.capacity = 0  # the record capacity of the window started last

    @property
    def records(self) -> bool:
        return self.rows is not None

    def leaves(self) -> List[torch.Tensor]:
        """The tensors an update reads and writes (a graph's warm-up puts
        them back); the rows are rewritten from the count, and K18's scan
        scratch is left ready for the next launch by every launch."""
        return [self.first, self.acc, self.total, self.cap]

    def start(self, capacity: int = 0) -> None:
        """Begin a window (of ``capacity`` record rows on the vs-pool path):
        the next update's K18 and K19 restart."""
        if self.records and not 1 <= capacity <= self.rows.shape[0]:
            raise ValueError(f"a window of {capacity} record rows in a buffer of "
                             f"{self.rows.shape[0]}")
        self.first.fill_(1)
        if self.records:
            self.cap.fill_(capacity)
        self.capacity = capacity

    # -- inside an update (graphed) -----------------------------------
    def fold(self, metrics: Dict[str, torch.Tensor], stats: Dict[str, torch.Tensor]) -> None:
        """K19: one update's metrics and episode summaries into the report."""
        window_report(self, self.fields(metrics, stats))

    def fields(self, metrics: Dict[str, torch.Tensor],
               stats: Dict[str, torch.Tensor]) -> List[Tuple[torch.Tensor, int]]:
        """(source, fold) of every accumulator field, in the layout fixed at
        the first call (train.py:341-359)."""
        srcs = {("metrics", k): v for k, v in metrics.items()}
        srcs.update({("stats", k): v for k, v in stats.items()})
        if self.layout is None:
            folds = [("metrics", k, k, SUM if k in GUARD_METRIC_KEYS else LAST) for k in metrics]
            folds += [("metrics", f"{k}_max", k, MAX) for k in MAX_METRIC_KEYS if k in metrics]
            folds += [("stats", k, k, op) for k, op in STATS_FOLDS]
            layout = [(g, k, s, op, srcs[(g, s)].numel()) for g, k, s, op in folds]
            if len(layout) > MAX_FIELDS or sum(f[-1] for f in layout) > MAX_ENTRIES:
                raise ValueError(f"a window report of {len(layout)} fields: at most {MAX_FIELDS} "
                                 f"fields of {MAX_ENTRIES} entries")
            self.layout = layout
        elif {(g, s) for g, _, s, _, _ in self.layout} != set(srcs):
            raise ValueError("an update's metrics or summaries changed their keys inside a run")
        return [(srcs[(g, s)], op) for g, _, s, op, _ in self.layout]

    # -- once a window (host) ------------------------------------------
    def fetch(self) -> Tuple[Dict[str, float], Dict[str, object], Optional[np.ndarray]]:
        """The window's report and records in one transfer: (metrics,
        episode summaries, record rows int32 [count, 2P-1] or None). On
        the vs-pool path the metrics carry ``pool_record_overflow``, the
        games past the capacity (train.py:495, 513)."""
        if self.layout is None:
            raise RuntimeError("no update folded into this window book")
        parts = [self.acc.view(torch.uint8), self.total.reshape(1).view(torch.uint8)]
        if self.records:
            parts.append(self.rows[:self.capacity].reshape(-1).view(torch.uint8))
        host = torch.cat(parts).cpu().numpy()
        n_acc = 4 * self.acc.numel()
        acc = host[:n_acc].view(np.float32)
        total = int(host[n_acc:n_acc + 4].view(np.int32)[0])
        metrics: Dict[str, float] = {}
        stats: Dict[str, object] = {}
        off = 0
        for group, key, _, _, n in self.layout:
            vals = acc[off:off + n]
            off += n
            if group == "metrics":
                metrics[key] = float(vals[0])
            else:
                stats[key] = vals.copy() if key in ("ret_sum", "pts_sum") else float(vals[0])
        out_rows = None
        if self.records:
            count = min(total, self.capacity)
            metrics["pool_record_overflow"] = float(max(total - self.capacity, 0))
            rows = host[n_acc + 4:].view(np.int8).reshape(self.capacity, -1)
            out_rows = rows[:count].astype(np.int32)
        return metrics, stats, out_rows


def window_records_plain(book: WindowBook, completed: torch.Tensor, outcome: torch.Tensor,
                         seat: torch.Tensor, slots: torch.Tensor, num_learner_envs: int) -> None:
    """Plain PyTorch K18 (train.py:462-495 for one update appended at the
    book's count): the completed pool games of columns [L, E), in (t, e)
    order, rows at or past the capacity dropped, the count of them all
    kept."""
    L = num_learner_envs
    P = outcome.shape[-1]
    c = completed[:, L:].reshape(-1)
    s = seat[:, L:].reshape(-1).to(torch.int64)
    sel = (c > 0) & (s >= 0)
    base = torch.where(book.first != 0, torch.zeros_like(book.total), book.total).to(torch.int64)
    pos = base + torch.cumsum(sel.to(torch.int64), 0) - 1
    idx = torch.nonzero(sel & (pos < book.cap.to(torch.int64))).squeeze(1)
    seat_k = s[idx]
    place = outcome[:, L:].reshape(-1, P)[idx].to(torch.int64)
    slot = slots[:, L:].reshape(-1, P)[idx].to(torch.int64)
    j = torch.arange(P - 1, device=c.device)
    opp = j[None, :] + (j[None, :] >= seat_k[:, None]).to(torch.int64)
    rows = torch.cat([place.gather(1, seat_k[:, None]), slot.gather(1, opp),
                      place.gather(1, opp)], dim=1)
    book.rows[pos[idx]] = rows.to(torch.int8)
    book.total.copy_(base + sel.sum())


def window_records(book: WindowBook, completed: torch.Tensor, outcome: torch.Tensor,
                   seat: torch.Tensor, slots: torch.Tensor, num_learner_envs: int) -> None:
    """K18: append one update's completed pool games to the book's rows
    (plain version for CPU tensors)."""
    if kernels.on_cpu(completed, outcome, seat, slots, book.total):
        return window_records_plain(book, completed, outcome, seat, slots, num_learner_envs)
    if book.rows is None:
        raise ValueError("window_records: the book has no record buffer")
    T, E = completed.shape
    P = outcome.shape[-1]
    L = num_learner_envs
    if not 0 <= L < E or P != book.num_players:
        raise ValueError(f"window_records: {L} learner envs of {E}, {P} players "
                         f"(the book's {book.num_players})")
    tiles = book.scan.numel() - 1
    if T * (E - L) > tiles * RECORD_TILE:
        raise ValueError(f"window_records: {T} x {E - L} entries, more than the scan's "
                         f"{tiles} tiles of {RECORD_TILE}")
    kernels.expect(completed, "completed", torch.float32, (T, E))
    kernels.expect(outcome, "outcome", torch.int32, (T, E, P))
    kernels.expect(seat, "seat", torch.int32, (T, E))
    kernels.expect(slots, "slots", torch.int32, (T, E, P))
    p = kernels.ptr
    err = kernels.library().window_records(
        p(completed), p(outcome), p(seat), p(slots), T, E, L, P, p(book.first), p(book.total),
        p(book.cap), p(book.rows), p(book.scan), tiles, kernels.stream(completed.device))
    kernels.check(err, "window_records")
    window_records.launches += 1


kernels.counted(window_records)


def window_report_plain(book: WindowBook, fields: Sequence[Tuple[torch.Tensor, int]]) -> None:
    """Plain PyTorch K19: each field copied into its accumulators at the
    window's first update, else folded (last, sum, max or min; a NaN
    kept, as jnp.max and jnp.min keep it); the flag cleared."""
    first = book.first != 0
    off = 0
    for src, op in fields:
        v = src.reshape(-1).to(torch.float32)
        n = v.numel()
        a = book.acc[off:off + n]
        if op == SUM:
            new = a + v
        elif op == MAX:
            new = torch.maximum(a, v)
        elif op == MIN:
            new = torch.minimum(a, v)
        else:
            new = v
        a.copy_(torch.where(first, v, new))
        off += n
    book.first.zero_()


def window_report(book: WindowBook, fields: Sequence[Tuple[torch.Tensor, int]]) -> None:
    """K19: fold one update's fields into the book's report (plain
    version for CPU tensors)."""
    srcs = [t for t, _ in fields]
    if kernels.on_cpu(*srcs, book.acc):
        return window_report_plain(book, fields)
    for i, t in enumerate(srcs):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise TypeError(f"window_report: field {i} must be a contiguous f32 tensor")
    # The table of accumulator entries: each entry's source address and fold.
    entries = [(t.data_ptr() + 4 * j, op) for t, op in fields for j in range(t.numel())]
    n = len(entries)
    if n > MAX_ENTRIES:
        raise ValueError(f"window_report: {n} accumulator entries, at most {MAX_ENTRIES}")
    ptrs = (ctypes.c_void_p * n)(*(a for a, _ in entries))
    ops = (ctypes.c_int * n)(*(op for _, op in entries))
    err = kernels.library().window_report(ptrs, ops, n, kernels.ptr(book.acc),
                                          kernels.ptr(book.first), kernels.stream(book.acc.device))
    kernels.check(err, "window_report")
    window_report.launches += 1


kernels.counted(window_report)

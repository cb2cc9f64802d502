"""Terminal training progress display (a copy of burn_ppo_tpu/progress.py,
with ``format_duration`` from burn_ppo_tpu/utils.py).

Parity with the reference's indicatif-based bar (src/progress.rs): an
in-place updating line with a bar, percentage, SPS, elapsed time
(including a supervisor child's carried-over offset), ETA, and either
the recent average return (single-player) or per-player Swiss points +
draw rate (multiplayer); messages print *through* the bar; finishes can
be quiet / interrupted / clearing (progress.rs:8-204).
"""

from __future__ import annotations

import sys
import time
from typing import Optional, Sequence

BAR_WIDTH = 24


def format_duration(seconds: float) -> str:
    seconds = int(seconds)
    h, rem = divmod(seconds, 3600)
    m, s = divmod(rem, 60)
    if h:
        return f"{h}h{m:02d}m{s:02d}s"
    if m:
        return f"{m}m{s:02d}s"
    return f"{s}s"


class TrainingProgress:
    def __init__(
        self,
        total_steps: int,
        *,
        start_step: int = 0,
        elapsed_offset: float = 0.0,
        quiet: bool = False,
        stream=None,
    ):
        self.total = max(total_steps, 1)
        self.start_step = start_step
        self.elapsed_offset = elapsed_offset
        self.quiet = quiet
        self.stream = stream or sys.stdout
        self.start_time = time.time()
        self._live = False
        self._last_line = ""
        self._isatty = hasattr(self.stream, "isatty") and self.stream.isatty()

    # ------------------------------------------------------------------
    def _elapsed(self) -> float:
        return time.time() - self.start_time + self.elapsed_offset

    def _line(self, step: int, sps: float, stats: str) -> str:
        frac = min(step / self.total, 1.0)
        filled = int(frac * BAR_WIDTH)
        bar = "=" * filled + ">" + " " * (BAR_WIDTH - filled)
        elapsed = self._elapsed()
        done = step - self.start_step
        # The final update can overshoot total (total_steps need not be a
        # multiple of steps-per-update); a negative ETA renders garbage.
        remaining = max(self.total - step, 0)
        eta = remaining / max(sps, 1e-9) if done > 0 else 0.0
        return (
            f"[{bar[:BAR_WIDTH]}] {frac * 100:5.1f}% {step:,}/{self.total:,} "
            f"| {sps:,.0f} sps | {format_duration(elapsed)}"
            f" (ETA {format_duration(eta)}) | {stats}"
        )

    def _render(self, text: str) -> None:
        if self.quiet:
            return
        if self._isatty:
            self.stream.write("\r\x1b[2K" + text)
            self.stream.flush()
            self._live = True
            self._last_line = text
        else:
            self.stream.write(text + "\n")
            self.stream.flush()

    # ------------------------------------------------------------------
    def update(self, step: int, sps: float, avg_return: float, extra: str = "") -> None:
        stats = f"return {avg_return:8.2f}"
        if extra:
            stats += f" | {extra}"
        self._render(self._line(step, sps, stats))

    def update_multiplayer(
        self,
        step: int,
        sps: float,
        avg_points: Sequence[float],
        draw_rate: float,
        elo: Optional[float] = None,
        extra: str = "",
    ) -> None:
        pts = "/".join(f"{p:.2f}" for p in avg_points)
        stats = f"points {pts} | draws {draw_rate:.1%}"
        if elo is not None:
            stats += f" | elo {elo:.0f}"
        if extra:
            stats += f" | {extra}"
        self._render(self._line(step, sps, stats))

    def println(self, message: str) -> None:
        """Print a message through (above) the live bar.

        The bar is redrawn beneath the message, like indicatif's
        println (progress.rs): without the redraw the bar vanishes
        until the next update and a following finish() would emit a
        newline for a bar line that no longer exists."""
        if self.quiet:
            return
        if self._live and self._isatty:
            self.stream.write("\r\x1b[2K" + message + "\n")
            self.stream.write("\r\x1b[2K" + self._last_line)
        else:
            self.stream.write(message + "\n")
        self.stream.flush()

    # -- finishes (progress.rs:196-204) ---------------------------------
    def finish(self, message: str = "done") -> None:
        if self.quiet:
            return
        if self._live and self._isatty:
            self.stream.write("\n")
        self.stream.write(f"{message} ({format_duration(self._elapsed())})\n")
        self.stream.flush()

    def finish_interrupted(self) -> None:
        self.finish("interrupted — checkpoint saved, resume with --resume")

    def finish_and_clear(self) -> None:
        if self._live and self._isatty:
            self.stream.write("\r\x1b[2K")
            self.stream.flush()

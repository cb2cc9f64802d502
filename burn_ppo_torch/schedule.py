"""Piecewise-linear parameter schedules (a copy of burn_ppo_tpu/schedule.py).

Feature parity with the reference's schedule system (src/schedule.rs):
milestones are ``(value, step)`` pairs, linearly interpolated between
milestones and held constant after the last one.  Two surface syntaxes:

  * TOML / Python: a plain float (constant) or ``[[value, step], ...]``.
  * CLI: ``"value"`` or ``"v@step,v@step"`` with ``K``/``M`` step suffixes
    (``"1e-3@0,1e-4@30M"``).

Schedules are evaluated on the host once per update (they gate learning
rate / entropy coefficient / reward shaping), so this is plain Python —
the resulting scalar is handed to the train step as a plain float.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Sequence, Tuple, Union


def parse_step_with_suffix(s: str) -> int:
    """Parse a step count with optional K (1e3) / M (1e6) suffix.

    Mirrors reference src/schedule.rs:151-182.
    """
    s = s.strip()
    if not s:
        raise ValueError("Empty step value")
    mult = 1
    if s[-1] in ("M", "m"):
        mult, s = 1_000_000, s[:-1]
    elif s[-1] in ("K", "k"):
        mult, s = 1_000, s[:-1]
    num = float(s)
    if num < 0:
        raise ValueError(f"Step value cannot be negative: '{s}'")
    return int(num * mult)


@dataclass(frozen=True)
class Schedule:
    """A piecewise-linear schedule over training env-steps.

    Reference: src/schedule.rs:29-147.
    """

    milestones: Tuple[Tuple[float, int], ...] = field(default_factory=tuple)

    @staticmethod
    def constant(value: float) -> "Schedule":
        return Schedule(((float(value), 0),))

    @staticmethod
    def of(milestones: Sequence[Tuple[float, int]]) -> "Schedule":
        return Schedule(tuple((float(v), int(s)) for v, s in milestones))

    def get(self, step: int) -> float:
        """Interpolated value at ``step``.

        Before the first milestone: first value. Between: linear
        interpolation. After the last: last value. Empty: 0.0.
        """
        ms = self.milestones
        if not ms:
            return 0.0
        if len(ms) == 1 or step <= ms[0][1]:
            return ms[0][0]
        for (v1, s1), (v2, s2) in zip(ms, ms[1:]):
            if s1 <= step < s2:
                t = (step - s1) / (s2 - s1)
                return v1 + (v2 - v1) * t
        return ms[-1][0]

    @property
    def is_constant(self) -> bool:
        return len(self.milestones) == 1 and self.milestones[0][1] == 0

    def initial_value(self) -> float:
        return self.get(0)

    @staticmethod
    def parse_cli(s: str) -> "Schedule":
        """Parse ``"0.001"`` or ``"0.001@0,0.0001@30M"`` (src/schedule.rs:108-147)."""
        s = s.strip()
        if "@" not in s:
            return Schedule.constant(float(s))
        milestones: List[Tuple[float, int]] = []
        for part in s.split(","):
            bits = part.strip().split("@")
            if len(bits) != 2:
                raise ValueError(
                    f"Invalid milestone '{part}': expected 'value@step'"
                )
            milestones.append((float(bits[0]), parse_step_with_suffix(bits[1])))
        if not milestones:
            raise ValueError("Empty schedule")
        milestones.sort(key=lambda m: m[1])
        return Schedule.of(milestones)

    @staticmethod
    def parse(value: Union[float, int, str, Sequence]) -> "Schedule":
        """Parse the TOML-side representation: scalar or ``[[v, step], ...]``.

        Also accepts the CLI string form for convenience.
        """
        if isinstance(value, Schedule):
            return value
        if isinstance(value, (int, float)):
            return Schedule.constant(float(value))
        if isinstance(value, str):
            return Schedule.parse_cli(value)
        if isinstance(value, (list, tuple)):
            ms = []
            for item in value:
                if not isinstance(item, (list, tuple)) or len(item) != 2:
                    raise ValueError(
                        f"Invalid schedule milestone {item!r}: expected [value, step]"
                    )
                ms.append((float(item[0]), int(item[1])))
            ms.sort(key=lambda m: m[1])
            if not ms:
                raise ValueError("Empty schedule")
            return Schedule.of(ms)
        raise ValueError(f"Cannot parse schedule from {value!r}")

    def to_toml_value(self) -> Union[float, List[List[float]]]:
        if self.is_constant:
            return self.milestones[0][0]
        return [[v, s] for v, s in self.milestones]

    def __str__(self) -> str:
        if self.is_constant:
            return repr(self.milestones[0][0])
        return ",".join(f"{v}@{s}" for v, s in self.milestones)

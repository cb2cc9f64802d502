"""Append-only JSONL metrics logger (a copy of burn_ppo_tpu/metrics.py).

Same on-disk format as the reference (src/metrics.rs): one JSON object
per line, either ``{"type":"hparams","step":0,"data":{...}}`` or
``{"type":"scalar","step":N,"name":"...","value":V}``, so the Aim
watcher (scripts/aim_watcher.py) streams either framework's runs.
"""

from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Any, Dict


class MetricsLogger:
    def __init__(self, run_dir: str | Path, _null: bool = False):
        self._null = _null
        if _null:
            # No-op logger for non-primary hosts: no mkdir, no file handle
            # (host-0 IO discipline in multi-host runs).
            self.path = None
            self._f = None
            return
        self.path = Path(run_dir) / "metrics.jsonl"
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._f = open(self.path, "a", buffering=1)

    @staticmethod
    def null() -> "MetricsLogger":
        return MetricsLogger("", _null=True)

    def log_hparams(self, hparams: Dict[str, Any], step: int = 0) -> None:
        self._write({"type": "hparams", "step": step, "data": _jsonable(hparams)})

    def log_scalar(self, name: str, value: float, step: int) -> None:
        value = float(value)
        if math.isnan(value) or math.isinf(value):
            # Reference parity: serde_json serializes non-finite floats
            # as null (metrics.rs). Writing 0.0 here would make a
            # diverged run read as a converged one on the plots.
            value = None
        self._write({"type": "scalar", "step": step, "name": name, "value": value})

    def log_scalars(self, scalars: Dict[str, float], step: int) -> None:
        for name, value in scalars.items():
            self.log_scalar(name, value, step)

    def _write(self, obj: Dict[str, Any]) -> None:
        if self._f is not None:
            self._f.write(json.dumps(obj) + "\n")

    def flush(self) -> None:
        if self._f is not None:
            self._f.flush()

    def close(self) -> None:
        if self._f is not None:
            self._f.close()


def _jsonable(v: Any) -> Any:
    if isinstance(v, dict):
        return {k: _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, float):
        # json.dumps would emit bare NaN/Infinity (invalid JSON) and
        # break strict consumers of the whole line; serde_json (the
        # reference's serializer) emits null for non-finite floats.
        return v if math.isfinite(v) else None
    if isinstance(v, (str, int, bool)) or v is None:
        return v
    return str(v)

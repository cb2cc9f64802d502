"""Where the time of K7's bf16 tower and feature front goes, block by block.

    python3 scripts/opponent_tower_trace.py [OUT_JSON]

On one NVIDIA GPU: the bf16 tower at Connect Four's and Skull's pool
blocks (Ep = 1024 and 1229, K = 8) and the CNN's feature front in f32 and
bf16 (Ep = 1024, K = 8, on K20's conv output), one warm launch each with
``opp_tower_trace``
set: every block records %globaltimer at its phase marks
(``csrc/opponent_tower.cuh`` TRACE_SLOTS). The kernels are built with
OPP_TOWER_TRACE defined, into a library of their own (the package's
build has no marks). Prints, for each case,
the launch's span and the median and largest time of each phase over the
blocks that ran a tile (microseconds), beside the kernel's device ms;
writes the marks and the summaries as JSON to OUT_JSON (default
``.cache/opponent_tower_trace.json``).
"""

import ctypes
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402  (exits non-zero without a card)
from burn_ppo_torch import kernels  # noqa: E402
from burn_ppo_torch.device import resolve_device  # noqa: E402
from burn_ppo_torch.ppo.pool_rollout import (  # noqa: E402
    opponent_actor_forward,
    opponent_cnn_front,
    opponent_features_forward,
)

SLOTS = 32
# (name, first mark, last mark) of each phase a block runs, in order.
PHASES = [("launch_offset", None, 0), ("slot_count", 0, 1), ("tile_named", 1, 2),
          ("rows_collected", 2, 3), ("rows_gathered", 3, 4), ("cluster_running", 4, 5)]
for _l in range(4):
    PHASES += [(f"layer{_l}_input_wait", 5 + 4 * _l if _l else 5, 6 + 4 * _l),
               (f"layer{_l}_first_stage", 6 + 4 * _l, 7 + 4 * _l),
               (f"layer{_l}_stages", 7 + 4 * _l, 8 + 4 * _l),
               (f"layer{_l}_epilogue", 8 + 4 * _l, 9 + 4 * _l)]


def traced_library() -> ctypes.CDLL:
    """The kernel library built with OPP_TOWER_TRACE defined (its own
    cache key), loaded as the wrappers' library, its trace entry bound."""
    kernels.NVCC_FLAGS = (*kernels.NVCC_FLAGS, "-DOPP_TOWER_TRACE")
    lib = kernels.library()
    lib.opp_tower_trace.argtypes, lib.opp_tower_trace.restype = [ctypes.c_void_p], ctypes.c_int
    return lib


def traced(fn, blocks: int, dev) -> torch.Tensor:
    """One warm launch of ``fn`` with the trace set: the marks [blocks, 32]."""
    lib = kernels.library()
    for _ in range(3):
        fn()
    buf = torch.zeros(blocks, SLOTS, dtype=torch.int64, device=dev)
    torch.cuda.synchronize()
    kernels.check(lib.opp_tower_trace(buf.data_ptr()), "opp_tower_trace")
    try:
        fn()
        torch.cuda.synchronize()
    finally:
        kernels.check(lib.opp_tower_trace(None), "opp_tower_trace")
    return buf.cpu()


def summary(marks: torch.Tensor, depth: int) -> dict:
    """The span and each phase's median and largest us over the blocks
    that ran a tile."""
    live = marks[marks[:, 2] > 0]
    t0 = int(marks[marks[:, 0] > 0, 0].min())
    out = {"blocks": int((marks[:, 0] > 0).sum()), "tiles_run": len(live),
           "span_us": (int(live[:, 22].max()) - t0) / 1e3}
    for name, a, b in PHASES:
        if name.startswith("layer") and int(name[5]) >= depth:
            continue
        start = torch.full((len(live),), t0) if a is None else live[:, a]
        d = (live[:, b] - start).double() / 1e3
        out[name] = [float(d.median()), float(d.max())]
    last = 9 + 4 * (depth - 1)
    d = (live[:, 22] - live[:, last]).double() / 1e3
    out["after_head"] = [float(d.median()), float(d.max())]
    d = (live[:, 23] - t0).double() / 1e3
    out["producer_first_copy_from_launch"] = [float(d.median()), float(d.max())]
    d = (live[:, 24] - live[:, 23]).double() / 1e3
    out["producer_issuing"] = [float(d.median()), float(d.max())]
    out["rows_per_tile"] = [int(live[:, 27].min()), int(live[:, 27].max())]
    out["sms"] = len(set(live[:, 25].tolist()))
    return out


def main(argv: list) -> int:
    out_path = Path(argv[0]) if argv else ROOT / ".cache" / "opponent_tower_trace.json"
    dev = resolve_device("cuda")
    card = cs.card()
    traced_library()
    g = torch.Generator(device=dev).manual_seed(23)
    cases = []
    for name, D, H, depth, A, Ep in (("c4_bf16", 86, 512, 2, 7, cs.EP),
                                     ("skull_bf16", 135, 256, 3, 33, cs.EP_SKULL)):
        obs = cs.connect_four_like(dev, g, Ep, D=D)
        stack = cs.bf16_weights(cs.random_opponents(dev, g, 8, "relu", D=D, H=H, A=A,
                                                    depth=depth))
        slot = torch.randint(0, 8, (Ep,), generator=g, device=dev, dtype=torch.int32)
        # 32 rows a tile, clusters of 2 (csrc/opponent_tower.cu)
        cases.append((f"{name}_32x2", depth + 1, ((Ep + 31) // 32 + 8) * 2,
                      lambda obs=obs, slot=slot, stack=stack:
                      opponent_actor_forward(obs, slot, stack),
                      "opponent_tower_bf16_kernel"))
    for bf16 in (False, True):
        stack = cs.cnn_opponents(dev, g, 8, bf16=bf16)
        obs = cs.connect_four_like(dev, g, cs.EP)
        slot = torch.randint(0, 8, (cs.EP,), generator=g, device=dev, dtype=torch.int32)
        feat = opponent_cnn_front(obs, slot, stack)
        # 16 rows a tile, no cluster (csrc/opponent_features.cu)
        cases.append((f"features_{'bf16' if bf16 else 'f32'}_16", 2, (cs.EP + 15) // 16 + 8,
                      lambda feat=feat, obs=obs, slot=slot, stack=stack:
                      opponent_features_forward(feat, obs, slot, stack),
                      "opponent_features_bf16_kernel" if bf16 else "opponent_features_kernel"))
    res = {"card": card, "cases": {}}
    print(card, flush=True)
    for name, depth, blocks, fn, kernel in cases:
        marks = traced(fn, blocks, dev)
        s = {"device_ms": cs.device_ms(fn, only=kernel)[0], **summary(marks, depth)}
        res["cases"][name] = {**s, "marks": marks.tolist()}
        print(name, json.dumps(s), flush=True)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(res))
    print(json.dumps({"ok": True, "out": str(out_path)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))

"""Time variants of K3 (burn_ppo_torch/csrc/gae.cu) on one NVIDIA GPU.

    python3 scripts/gae_variants.py [--parent DIR]

Each variant is this tree's ``gae.cu`` with its block width (``ENVS``),
chunk length (``CHUNK``) and ring depth (``STAGES``) replaced, built with
the package's nvcc flags into a library of its own under
``.cache/burn_ppo_torch/variants/``, checked bit for bit against this
tree's K3 and timed in turns with it (variant, this, this, variant; the
profiler's device ms per call, ``chip_smoke.turns``) at
``chip_smoke.GAE_SHAPES`` and [64, 4096]. With ``--parent``, DIR's
``gae.cu`` (a checkout of another commit) is checked and timed the same
way. Prints the card's name and power limit, then one JSON line per
variant and shape. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402  (exits where there is no card)
from burn_ppo_torch import kernels  # noqa: E402
from burn_ppo_torch.ops.gae import compute_gae  # noqa: E402

# (envs a block, steps a chunk, stages of the ring); this tree's is 16, 64, 2.
VARIANTS = ((32, 64, 2), (64, 64, 2), (16, 32, 4), (32, 32, 4), (32, 16, 8))
SHAPES = (*cs.GAE_SHAPES, (64, cs.E))
OUT = ROOT / ".cache" / "burn_ppo_torch" / "variants"


def variant_source(envs: int, chunk: int, stages: int) -> str:
    src = (kernels.CSRC / "gae.cu").read_text()
    for name, value in (("ENVS", envs), ("CHUNK", chunk), ("STAGES", stages)):
        src, n = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {value};", src)
        if n != 1:
            raise RuntimeError(f"gae.cu: {n} definitions of {name}, not one")
    return src


def build(sources: dict) -> dict:
    """Each source (name -> gae.cu text) in a dir of its own beside the
    headers it includes, all built at once; name -> (call, ptxas lines)."""
    cmds, libs = [], {}
    for name, src in sources.items():
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "gae.cu").write_text(src)
        for h in kernels.CSRC.glob("*.cuh"):
            shutil.copy(h, d / h.name)
        libs[name] = d / "libgae.so"
        cmds.append([kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-o", str(libs[name]),
                     str(d / "gae.cu")])
    out = {}
    for (name, lib), (rc, log) in zip(libs.items(), kernels._run_all(cmds)):
        if rc != 0:
            raise RuntimeError(f"{name} failed to build:\n{log}")
        dll = ctypes.CDLL(str(lib))
        dll.gae_reverse_scan.argtypes = kernels.SIGNATURES["gae_reverse_scan"]
        dll.gae_reverse_scan.restype = ctypes.c_int

        def call(r, v, d, last, dll=dll, name=name):
            T, E = v.shape
            adv, ret = torch.empty_like(v), torch.empty_like(v)
            p = kernels.ptr
            kernels.check(dll.gae_reverse_scan(p(r), p(v), p(d), p(last), p(adv), p(ret), T, E,
                                               0.99, float(0.99 * 0.95),
                                               kernels.stream(v.device)), name)
            return adv, ret

        out[name] = (call, cs.ptxas_summary(log))
    return out


def main(argv: list) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="a checkout of another commit whose gae.cu is timed too")
    args = ap.parse_args(argv)
    print(cs.card(), flush=True)
    kernels.library()
    sources = {f"envs{e}_chunk{c}_stages{s}": variant_source(e, c, s) for e, c, s in VARIANTS}
    if args.parent is not None:
        sources["parent"] = (args.parent / "burn_ppo_torch" / "csrc" / "gae.cu").read_text()
    built = build(sources)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    for T, E in SHAPES:
        r = torch.randn(T, E, generator=g, device=dev)
        v = torch.randn(T, E, generator=g, device=dev)
        d = (torch.rand(T, E, generator=g, device=dev) < 0.02).float()
        last = torch.randn(E, generator=g, device=dev)
        adv, ret = compute_gae(r, v, d, last, 0.99, 0.95)
        for name, (call, ptxas) in built.items():
            adv_o, ret_o = call(r, v, d, last)
            torch.cuda.synchronize()
            if not (torch.equal(adv, adv_o) and torch.equal(ret, ret_o)):
                raise AssertionError(f"{name} at [{T}, {E}]: not this tree's K3 bit for bit")
            print(json.dumps({"variant": name, "shape": [T, E], "equal_bit_for_bit": True,
                              "ptxas": ptxas,
                              **cs.turns(lambda: compute_gae(r, v, d, last, 0.99, 0.95),
                                         lambda call=call: call(r, v, d, last), who="variant")}),
                  flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))

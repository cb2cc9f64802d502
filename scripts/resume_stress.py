"""Resume determinism of burn_ppo_torch under load, on a CUDA card.

One fresh leg of a case of chip_smoke.py's resume phase, then resumes of
copies of its run dir, each in a process of its own: two alone, the rest
in batches that share the card at once. Every resume's last checkpoint,
and the epoch rows each update drew in its first graph, must equal the
first resume's bit for bit. Prints one JSON line (the copies that
differ, and where); exits 1 if any differs.

Usage (from the repo root):
    python scripts/resume_stress.py [--case liars_dice_ctde_pool]
        [--copies 18] [--batch 8] [--out result.json]
"""

import argparse
import hashlib
import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def digest(arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(a.tobytes())
    return h.hexdigest()[:16]


def leg(case: str, run: str, done: int, mode: str, out: str) -> None:
    """One leg in this process, the epoch rows of every update kept."""
    import torch

    import chip_smoke
    from burn_ppo_torch.ppo import update_graph

    rows = []
    run_update = update_graph.UpdateRunner.run

    def recorded(self, *a, **k):
        res = run_update(self, *a, **k)
        rows.append(self._made["plan"].rows.clone())
        return res

    update_graph.UpdateRunner.run = recorded
    res = chip_smoke.resume_leg(case, run, done, mode)
    torch.cuda.synchronize()
    Path(out).write_text(json.dumps({"rows": [digest([r.cpu().numpy()]) for r in rows],
                                     "minibatches_run": res["minibatches_run"]}))


def checkpoint_digests(run: Path) -> dict:
    from burn_ppo_torch.checkpoint import load_leaves

    latest = run / "checkpoints" / "latest"
    return {f.name: digest(load_leaves(f)) for f in sorted(latest.glob("*.npz"))}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--case", default="liars_dice_ctde_pool")
    p.add_argument("--copies", type=int, default=18)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--out")
    p.add_argument("--leg", nargs=4, metavar=("RUN", "DONE", "MODE", "OUT"))
    args = p.parse_args()
    if args.leg:
        run, done, mode, out = args.leg
        leg(args.case, run, int(done), mode, out)
        return 0

    def spawn(run: Path, done: int, mode: str) -> subprocess.Popen:
        return subprocess.Popen([sys.executable, __file__, "--case", args.case, "--leg",
                                 str(run), str(done), mode, f"{run}.json"], cwd=ROOT)

    def wait(procs) -> None:
        rcs = [q.wait() for q in procs]
        if any(rcs):
            raise RuntimeError(f"a leg exited {rcs}")

    from chip_smoke import RESUME_UPDATES

    with tempfile.TemporaryDirectory(prefix="resume_stress_") as d:
        fresh = Path(d) / "fresh"
        wait([spawn(fresh, 0, "fresh")])
        copies = [Path(d) / f"c{i}" for i in range(args.copies)]
        for c in copies:
            shutil.copytree(fresh, c, symlinks=True)
        for c in copies[:2]:
            wait([spawn(c, RESUME_UPDATES, "resume")])
        rest = copies[2:]
        for i in range(0, len(rest), args.batch):
            wait([spawn(c, RESUME_UPDATES, "resume") for c in rest[i:i + args.batch]])
        legs = {c.name: json.loads(Path(f"{c}.json").read_text())
                | {"checkpoint": checkpoint_digests(c)} for c in copies}
    ref = legs[copies[0].name]
    differ = {}
    for name, got in legs.items():
        bad = [f"update {i + 1} rows" for i, (a, b) in enumerate(zip(ref["rows"], got["rows"]))
               if a != b]
        bad += [f for f, h in got["checkpoint"].items() if ref["checkpoint"].get(f) != h]
        if got["minibatches_run"] != ref["minibatches_run"]:
            bad.append(f"minibatches_run {got['minibatches_run']}")
        if bad:
            differ[name] = bad
    result = {"case": args.case, "copies": args.copies, "alone": 2, "batch": args.batch,
              "differ": differ, "minibatches_run": ref["minibatches_run"]}
    if args.out:
        Path(args.out).write_text(json.dumps(result))
    print(json.dumps(result))
    return 1 if differ else 0


if __name__ == "__main__":
    raise SystemExit(main())

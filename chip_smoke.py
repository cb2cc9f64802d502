"""Smoke run of the PyTorch port (burn_ppo_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and the script
exits non-zero without the final result line:

  0. the card (nvidia-smi name and power limit), torch and CUDA versions;
  1. build the CUDA kernels from burn_ppo_torch/csrc with nvcc;
  2. each kernel against its plain PyTorch version at the main path's
     shapes (E = 4096, A = 2; GAE [128, 4096]), timed with CUDA events;
  3. the bench-shape train path through the CLI entry point (CartPole,
     MLP 64x2, 4096 envs x 128 steps, 5 updates), with the kernels'
     launch counters checked against what 5 updates imply;
  4. the CartPole learning bar (scripts/validate_cartpole.py settings):
     average return >= 195 within 200k steps.

The line before the last holds the kernel table, the last line
{"ok": true, "device": {...}}. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke: torch.cuda.is_available() is false; this smoke run needs an NVIDIA GPU")

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

from burn_ppo_torch import kernels  # noqa: E402
from burn_ppo_torch.device import resolve_device  # noqa: E402
from burn_ppo_torch.envs.base import EpisodeAccumulator, autoreset_step  # noqa: E402
from burn_ppo_torch.envs.cartpole import CartPole, CartPoleState, cartpole_step_autoreset  # noqa: E402
from burn_ppo_torch.ops.categorical import (  # noqa: E402
    TINY,
    apply_action_mask,
    masked_sample,
    masked_sample_plain,
)
from burn_ppo_torch.ops.gae import compute_gae, compute_gae_plain  # noqa: E402

E, A, T = 4096, 2, 128
BENCH_UPDATES = 5
WRAPPERS = {
    "cartpole_step_autoreset": cartpole_step_autoreset,
    "masked_gumbel_sample": masked_sample,
    "gae_reverse_scan": compute_gae,
}
SOURCES = {
    "cartpole_step_autoreset": ("burn_ppo_torch/csrc/cartpole_step.cu",
                                "burn_ppo_tpu/envs/cartpole.py:69"),
    "masked_gumbel_sample": ("burn_ppo_torch/csrc/masked_gumbel_sample.cu",
                             "burn_ppo_tpu/ops/categorical.py:27"),
    "gae_reverse_scan": ("burn_ppo_torch/csrc/gae.cu", "burn_ppo_tpu/ops/gae.py:30"),
}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def card() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median CUDA-event span around one call. The stream waits for the
    host's launch, so the span includes the wrapper's host work."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def max_err(pairs) -> float:
    return max(float((a.float() - b.float()).abs().max()) for a, b in pairs)


def check_cartpole(dev, g) -> dict:
    env = CartPole()

    def u(*shape):
        return torch.rand(*shape, generator=g, device=dev)

    # States on both sides of the failure thresholds and the 500-step cap.
    state = CartPoleState(
        x=(u(E) - 0.5) * 4.9, x_dot=(u(E) - 0.5) * 4, theta=(u(E) - 0.5) * 0.43,
        theta_dot=(u(E) - 0.5) * 4,
        step_idx=torch.randint(0, 500, (E,), generator=g, device=dev, dtype=torch.int32),
    )
    acc = EpisodeAccumulator(u(E) * 100, torch.randint(0, 499, (E,), generator=g, device=dev,
                                                       dtype=torch.int32))
    action = torch.randint(0, 2, (E,), generator=g, device=dev, dtype=torch.int32)
    reset = (u(E, 4) - 0.5) * 0.1
    k = env.step_autoreset(state, acc, action, reset)
    p = autoreset_step(env, state, acc, action, reset)
    torch.cuda.synchronize()
    exact = [(k.state.step_idx, p.state.step_idx), (k.reward, p.reward), (k.done, p.done),
             (k.acc.reward_sum, p.acc.reward_sum), (k.acc.length, p.acc.length),
             (k.log.total_rewards, p.log.total_rewards), (k.log.length, p.log.length)]
    for a, b in exact:
        if not torch.equal(a, b):
            raise AssertionError("cartpole_step_autoreset: discrete outputs differ from plain")
    err = max_err([(k.state.x, p.state.x), (k.state.x_dot, p.state.x_dot),
                   (k.state.theta, p.state.theta), (k.state.theta_dot, p.state.theta_dot),
                   (k.obs, p.obs)])
    if not err <= 1e-5:
        raise AssertionError(f"cartpole_step_autoreset: max abs err {err} > 1e-5")
    return {
        "max_abs_err": err, "tol": 1e-5, "dones": int(p.done.sum()),
        "ms": time_ms(lambda: env.step_autoreset(state, acc, action, reset)),
        "plain_ms": time_ms(lambda: autoreset_step(env, state, acc, action, reset)),
    }


def check_sample(dev, g) -> dict:
    logits = torch.randn(E, A, generator=g, device=dev) * 2
    mask = torch.ones(E, A, device=dev)  # CartPole: every action legal
    uni = torch.rand(E, A, generator=g, device=dev).clamp_min(TINY)
    a_k, lp_k = masked_sample(logits, mask, uni)
    a_p, lp_p = masked_sample_plain(logits, mask, uni)
    torch.cuda.synchronize()
    perturbed = apply_action_mask(logits, mask) - torch.log(-torch.log(uni))
    top2 = torch.topk(perturbed, 2, dim=-1).values
    decided = (top2[:, 0] - top2[:, 1]) > 1e-5
    if not torch.equal(a_k[decided], a_p[decided]):
        raise AssertionError("masked_gumbel_sample: actions differ from plain")
    err = max_err([(lp_k, lp_p)])
    if not err <= 1e-5:
        raise AssertionError(f"masked_gumbel_sample: log-prob max abs err {err} > 1e-5")
    return {
        "max_abs_err": err, "tol": 1e-5, "rows_compared": int(decided.sum()),
        "ms": time_ms(lambda: masked_sample(logits, mask, uni)),
        "plain_ms": time_ms(lambda: masked_sample_plain(logits, mask, uni)),
    }


def check_gae(dev, g) -> dict:
    r = torch.randn(T, E, generator=g, device=dev)
    v = torch.randn(T, E, generator=g, device=dev)
    d = (torch.rand(T, E, generator=g, device=dev) < 0.02).float()
    last = torch.randn(E, generator=g, device=dev)
    adv_k, ret_k = compute_gae(r, v, d, last, 0.99, 0.95)
    adv_p, ret_p = compute_gae_plain(r, v, d, last, 0.99, 0.95)
    torch.cuda.synchronize()
    err = max_err([(adv_k, adv_p), (ret_k, ret_p)])
    if not err <= 1e-5:
        raise AssertionError(f"gae_reverse_scan: max abs err {err} > 1e-5")
    return {
        "max_abs_err": err, "tol": 1e-5,
        "ms": time_ms(lambda: compute_gae(r, v, d, last, 0.99, 0.95)),
        "plain_ms": time_ms(lambda: compute_gae_plain(r, v, d, last, 0.99, 0.95)),
    }


def bench_train(tmp: Path, card_line: str) -> dict:
    from burn_ppo_torch import cli

    run = tmp / "bench"
    for w in WRAPPERS.values():
        w.launches = 0
    t0 = time.time()
    rc = cli.main(["train", "--config", str(ROOT / "configs" / "cartpole.toml"),
                   "--num-envs", str(E), "--total-steps", str(BENCH_UPDATES * E * T),
                   "--run-dir", str(run), "--quiet"])
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {name: w.launches for name, w in WRAPPERS.items()}
    if rc != 0:
        raise RuntimeError(f"train command exited {rc}")
    expect = {"cartpole_step_autoreset": BENCH_UPDATES * T,
              "masked_gumbel_sample": BENCH_UPDATES * T,
              "gae_reverse_scan": BENCH_UPDATES}
    if launches != expect:
        raise AssertionError(f"kernel launches {launches} != {expect}")
    scalars = [json.loads(x) for x in (run / "metrics.jsonl").read_text().splitlines()]
    scalars = [x for x in scalars if x["type"] == "scalar"]  # every update is logged
    for name in ("train/policy_loss", "train/value_loss", "train/total_loss", "train/entropy"):
        vals = [x["value"] for x in scalars if x["name"] == name]
        if len(vals) != BENCH_UPDATES or not all(
            v is not None and math.isfinite(v) for v in vals
        ):
            raise AssertionError(f"{name}: expected {BENCH_UPDATES} finite values, got {vals}")
    sps = [x["value"] for x in scalars if x["name"] == "perf/sps"]
    steady = sorted(sps[1:])
    return {
        "updates": BENCH_UPDATES, "env_steps": BENCH_UPDATES * E * T, "wall_s": wall,
        "env_steps_per_s_per_update": sps,
        "env_steps_per_s_median_after_first": steady[len(steady) // 2],
        "launches": launches, "card": card_line,
    }


def last_scalars(run: Path) -> dict:
    out = {}
    for line in (run / "metrics.jsonl").read_text().splitlines():
        rec = json.loads(line)
        if rec["type"] == "scalar":
            out[rec["name"]] = rec["value"]
    return out


def learning_bar(tmp: Path) -> dict:
    """scripts/validate_cartpole.py's run, through the port's CLI."""
    from burn_ppo_torch import cli

    run = tmp / "bar"
    t0 = time.time()
    rc = cli.main(["train", "--config", str(ROOT / "configs" / "cartpole.toml"),
                   "--num-envs", "32", "--num-steps", "128", "--total-steps", "200000",
                   "--learning-rate", "0.001", "--entropy-coef", "0.01", "--normalize-obs",
                   "--hidden-size", "64", "--num-hidden", "2", "--activation", "tanh",
                   "--checkpoint-freq", "100000", "--log-freq", "8192", "--seed", "1",
                   "--run-dir", str(run), "--quiet"])
    wall = time.time() - t0
    if rc != 0:
        raise RuntimeError(f"train command exited {rc}")
    meta = json.loads((run / "checkpoints" / "latest" / "metadata.json").read_text())
    last = last_scalars(run)
    out = {
        "final_step": meta["step"], "avg_return": meta["avg_return"],
        "approx_kl": last["train/approx_kl"],
        "explained_variance": last["train/explained_variance"], "wall_s": wall,
    }
    if not (meta["step"] >= 200_000 and meta["avg_return"] >= 195.0):
        raise AssertionError(f"CartPole learning bar failed: {out}")
    return out


def main() -> int:
    dev = resolve_device("cuda")
    card_line = card()
    emit("device", nvidia_smi=card_line, torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0], name=torch.cuda.get_device_name(0))

    t0 = time.time()
    lib_path = kernels.build()
    kernels.library()
    log = lib_path.with_suffix(".log")
    ptxas = [ln.strip() for ln in log.read_text().splitlines() if "Used" in ln] if log.exists() else []
    emit("build", seconds=time.time() - t0, library=str(lib_path.relative_to(ROOT)), ptxas=ptxas)

    g = torch.Generator(device=dev).manual_seed(0)
    checks = {
        "cartpole_step_autoreset": check_cartpole(dev, g),
        "masked_gumbel_sample": check_sample(dev, g),
        "gae_reverse_scan": check_gae(dev, g),
    }
    emit("kernels_vs_plain", card=card_line, **checks)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as d:
        bench = bench_train(Path(d), card_line)
        emit("bench_train", **bench)
        emit("learning_bar", card=card_line, **learning_bar(Path(d)))

    table = [
        {
            "name": name, "route": "cuda", "source": SOURCES[name][0],
            "replaces": SOURCES[name][1], "launches": bench["launches"][name],
            "max_abs_err": checks[name]["max_abs_err"], "ms": checks[name]["ms"],
            "plain_ms": checks[name]["plain_ms"],
        }
        for name in WRAPPERS
    ]
    print(json.dumps({"kernels": table}))
    print(card_line)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    os.chdir(ROOT)
    raise SystemExit(main())

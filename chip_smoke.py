"""Smoke run of the PyTorch port (burn_ppo_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and the script
exits non-zero without the final result line:

  0. the card (nvidia-smi name and power limit), torch and CUDA versions;
  1. build the CUDA kernels from burn_ppo_torch/csrc with nvcc;
  2. each kernel against its plain PyTorch version at the main paths'
     shapes, timed with CUDA events: K1 CartPole step (E = 4096), K2
     sample ([4096, 2] all legal; [4096, 7] with 0-6 masked columns), K3
     GAE [128, 4096], K4 Connect Four step (E = 4096, exact), K5
     multiplayer GAE ([64, 4096, 2] and P = 4), K6 obs-norm apply
     ([4096, 86], count 0, 1 and large) and update ([262144, 86],
     [524288, 5]);
  3. the CartPole bench-shape train path through the CLI entry point
     (MLP 64x2, 4096 envs x 128 steps, obs norm on, 5 updates);
  3b. Connect Four self-play through the CLI (configs/connect_four.toml,
     MLP 512x2, no opponent pool, 4096 envs x 64 steps, obs norm on,
     5 updates): finite losses, Swiss points summing to 1;
  3c. the same with the CNN (relu), 2 updates;
  4. the CartPole learning bar (scripts/validate_cartpole.py settings):
     average return >= 195 within 200k steps.

Each train phase sets every kernel's launch counter to 0 just before it
and checks the counts just after against what its updates imply.

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
from burn_ppo_torch.envs.connect_four import (  # noqa: E402
    COLS,
    ROWS,
    ConnectFour,
    connect_four_step_autoreset,
    has_win,
)
from burn_ppo_torch.ops.categorical import (  # noqa: E402
    TINY,
    apply_action_mask,
    masked_sample,
    masked_sample_plain,
)
from burn_ppo_torch.ops.gae import (  # noqa: E402
    compute_gae,
    compute_gae_multiplayer,
    compute_gae_multiplayer_plain,
    compute_gae_plain,
)
from burn_ppo_torch.ppo.normalization import (  # noqa: E402
    ObsNormState,
    obs_norm_apply,
    obs_norm_apply_plain,
    obs_norm_update,
    obs_norm_update_plain,
)

E, T = 4096, 128  # CartPole bench shape
T_C4 = 64  # Connect Four self-play shape: 4096 envs x 64 steps
BENCH_UPDATES = 5
CNN_UPDATES = 2
WRAPPERS = {
    "cartpole_step_autoreset": cartpole_step_autoreset,
    "masked_gumbel_sample": masked_sample,
    "gae_reverse_scan": compute_gae,
    "connect_four_step_autoreset": connect_four_step_autoreset,
    "gae_multiplayer_reverse_scan": compute_gae_multiplayer,
    "obs_norm_apply": obs_norm_apply,
    "obs_norm_update": obs_norm_update,
}
SOURCES = {
    "cartpole_step_autoreset": ("burn_ppo_torch/csrc/cartpole_step.cu",
                                "burn_ppo_tpu/envs/cartpole.py:69"),
    "masked_gumbel_sample": ("burn_ppo_torch/csrc/masked_gumbel_sample.cu",
                             "burn_ppo_tpu/ops/categorical.py:27"),
    "gae_reverse_scan": ("burn_ppo_torch/csrc/gae.cu", "burn_ppo_tpu/ops/gae.py:30"),
    "connect_four_step_autoreset": ("burn_ppo_torch/csrc/connect_four_step.cu",
                                    "burn_ppo_tpu/envs/connect_four.py:76"),
    "gae_multiplayer_reverse_scan": ("burn_ppo_torch/csrc/gae_multiplayer.cu",
                                     "burn_ppo_tpu/ops/gae.py:56"),
    "obs_norm_apply": ("burn_ppo_torch/csrc/obs_norm.cu",
                       "burn_ppo_tpu/ppo/normalization.py:78"),
    "obs_norm_update": ("burn_ppo_torch/csrc/obs_norm.cu",
                        "burn_ppo_tpu/ppo/normalization.py:68"),
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
    acc = EpisodeAccumulator(u(E, 1) * 100, torch.randint(0, 499, (E,), generator=g, device=dev,
                                                          dtype=torch.int32))
    action = torch.randint(0, 2, (E,), generator=g, device=dev, dtype=torch.int32)
    reset = (u(E, 4) - 0.5) * 0.1
    k = env.step_autoreset(state, acc, action, reset)
    p = autoreset_step(env, state, acc, action, reset)
    torch.cuda.synchronize()
    exact = [(k.state.step_idx, p.state.step_idx), (k.rewards, p.rewards), (k.done, p.done),
             (k.acc.reward_sum, p.acc.reward_sum), (k.acc.length, p.acc.length),
             (k.log.total_rewards, p.log.total_rewards), (k.log.length, p.log.length),
             (k.log.outcome, p.log.outcome), (k.log.active_players, p.log.active_players),
             (k.mask, p.mask)]
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


def check_sample(dev, g, A: int) -> dict:
    """A = 2: CartPole, every action legal. A = 7: Connect Four, 0-6
    masked columns per row."""
    logits = torch.randn(E, A, generator=g, device=dev) * 2
    if A == 2:
        mask = torch.ones(E, A, device=dev)
    else:
        n_masked = torch.randint(0, A, (E, 1), generator=g, device=dev)
        rank = torch.rand(E, A, generator=g, device=dev).argsort(1).argsort(1)
        mask = (rank >= n_masked).float()
    uni = torch.rand(E, A, generator=g, device=dev).clamp_min(TINY)
    a_k, lp_k = masked_sample(logits, mask, uni)
    a_p, lp_p = masked_sample_plain(logits, mask, uni)
    torch.cuda.synchronize()
    perturbed = apply_action_mask(logits, mask) - torch.log(-torch.log(uni))
    top2 = torch.topk(perturbed, 2, dim=-1).values
    decided = (top2[:, 0] - top2[:, 1]) > 1e-5
    if not torch.equal(a_k[decided], a_p[decided]):
        raise AssertionError(f"masked_gumbel_sample A={A}: actions differ from plain")
    if not bool(torch.all(torch.gather(mask, 1, a_k.long()[:, None]) > 0)):
        raise AssertionError(f"masked_gumbel_sample A={A}: sampled a masked action")
    err = max_err([(lp_k, lp_p)])
    if not err <= 1e-5:
        raise AssertionError(f"masked_gumbel_sample A={A}: log-prob max abs err {err} > 1e-5")
    return {
        "max_abs_err": err, "tol": 1e-5, "rows_compared": int(decided.sum()),
        "masked_per_row": [int((mask.sum(1) == A - k).sum()) for k in range(A)],
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


def win_directions(plane: torch.Tensor) -> torch.Tensor:
    """[E, 4] bool: a four of the plane horizontally, vertically and on
    either diagonal (the window groups of has_win)."""
    p = plane
    groups = (
        p[:, :, 0:4] & p[:, :, 1:5] & p[:, :, 2:6] & p[:, :, 3:7],
        p[:, 0:3, :] & p[:, 1:4, :] & p[:, 2:5, :] & p[:, 3:6, :],
        p[:, 0:3, 0:4] & p[:, 1:4, 1:5] & p[:, 2:5, 2:6] & p[:, 3:6, 3:7],
        p[:, 0:3, 3:7] & p[:, 1:4, 2:6] & p[:, 2:5, 1:5] & p[:, 3:6, 0:4],
    )
    return torch.stack([x.flatten(1).any(1) for x in groups], dim=1)


def pick(g, allowed: torch.Tensor) -> torch.Tensor:
    """One random True column per row (row of all False: column 0)."""
    w = allowed.float()
    w[w.sum(1) == 0, 0] = 1.0
    return torch.multinomial(w, 1, generator=g)[:, 0]


def nearly_full_boards(dev, g, n: int) -> torch.Tensor:
    """[n, 6, 7] boards one to five moves from full, without a four: a
    drawn board ((c // 2 + r) % 2 colouring), colours swapped for half,
    the top piece taken off random columns."""
    r = torch.arange(ROWS, device=dev)[:, None]
    c = torch.arange(COLS, device=dev)[None, :]
    drawn = ((c // 2 + r) % 2 + 1).to(torch.int32)
    assert not has_win((drawn == 1)[None]).any() and not has_win((drawn == 2)[None]).any()
    boards = drawn.expand(n, ROWS, COLS).clone()
    swap = torch.rand(n, generator=g, device=dev) < 0.5
    boards = torch.where(swap[:, None, None], 3 - boards, boards)
    removals = torch.randint(1, 6, (n,), generator=g, device=dev)
    rows = torch.arange(n, device=dev)
    for i in range(5):
        col = torch.randint(0, COLS, (n,), generator=g, device=dev)
        top = (boards[rows, :, col] == 0).sum(1)  # row of the column's top piece
        take = (i < removals) & (top < ROWS)
        boards[rows[take], top[take], col[take]] = 0
    return boards


def connect_four_states(dev, g):
    """E states reached by random legal play (mixed depths, since games
    restart as they end), the last 512 replaced by nearly full boards and
    64 marked done with a random winner."""
    env = ConnectFour()
    empty = torch.empty(E, 0, device=dev)
    state = env.reset(empty)
    acc = EpisodeAccumulator.zero(E, 2, dev)
    for _ in range(25):
        out = autoreset_step(env, state, acc, pick(g, env.action_mask(state) > 0).to(torch.int32),
                             empty)
        state, acc = out.state, out.acc
    full = nearly_full_boards(dev, g, 512)
    state.board[-512:] = full
    n1, n2 = (full == 1).sum((1, 2)), (full == 2).sum((1, 2))
    state.current[-512:] = (n1 != n2).to(torch.int32)
    state.winner[-512:] = -1
    state.step_idx[-512:] = (n1 + n2).to(torch.int32)
    done_rows = torch.randperm(E - 512, generator=g, device=dev)[:64]
    state.done[done_rows] = True
    state.winner[done_rows] = torch.randint(-1, 3, (64,), generator=g, device=dev,
                                            dtype=torch.int32)
    acc.reward_sum += torch.randint(-2, 3, (E, 2), generator=g, device=dev).float()
    return env, state, acc


def connect_four_actions(env, state, dev, g) -> torch.Tensor:
    """Half the envs take a winning column where they have one; 5% play a
    full column, 3% an action out of [0, 7); the rest a random legal one."""
    legal = env.action_mask(state) > 0
    wins = torch.stack([
        env.step(state, torch.full((E,), c, dtype=torch.int32, device=dev))[1].abs().sum(1) > 0
        for c in range(COLS)
    ], dim=1)
    u = torch.rand(E, generator=g, device=dev)
    act = pick(g, legal)
    act = torch.where((u < 0.5) & wins.any(1), pick(g, wins), act)
    act = torch.where((u >= 0.5) & (u < 0.55) & (~legal).any(1), pick(g, ~legal), act)
    wild = torch.tensor([-1, 7, 100, -50], device=dev)[torch.randint(0, 4, (E,), generator=g,
                                                                      device=dev)]
    return torch.where(u > 0.97, wild, act).to(torch.int32)


def check_connect_four(dev, g) -> dict:
    """K4 against the plain step over four consecutive steps: every output
    equal, bit for bit."""
    env, state, acc = connect_four_states(dev, g)
    empty = torch.empty(E, 0, device=dev)
    stats = {"steps": 4, "dones": 0, "wins_h_v_d1_d2": [0, 0, 0, 0], "draws": 0,
             "no_outcome": 0, "out_of_range": 0}
    for _ in range(4):
        action = connect_four_actions(env, state, dev, g)
        k = env.step_autoreset(state, acc, action, empty)
        p = autoreset_step(env, state, acc, action, empty)
        torch.cuda.synchronize()
        pairs = {f"state.{f}": (getattr(k.state, f), getattr(p.state, f))
                 for f in ("board", "current", "winner", "done", "step_idx")}
        pairs.update({f"log.{f}": (getattr(k.log, f), getattr(p.log, f))
                      for f in ("completed", "total_rewards", "length", "outcome",
                                "active_players")})
        pairs.update({"acc.reward_sum": (k.acc.reward_sum, p.acc.reward_sum),
                      "acc.length": (k.acc.length, p.acc.length),
                      "rewards": (k.rewards, p.rewards), "done": (k.done, p.done),
                      "obs": (k.obs, p.obs), "mask": (k.mask, p.mask)})
        for name, (a, b) in pairs.items():
            if a.dtype != b.dtype or not torch.equal(a, b):
                raise AssertionError(f"connect_four_step_autoreset: {name} differs from plain")
        stepped, rewards, done = env.step(state, action)
        won = rewards.abs().sum(1) > 0
        dirs = win_directions(stepped.board == (state.current + 1)[:, None, None])[won]
        stats["dones"] += int(done.sum())
        stats["wins_h_v_d1_d2"] = [a + int(b) for a, b in zip(stats["wins_h_v_d1_d2"],
                                                             dirs.sum(0))]
        stats["draws"] += int((done & (p.log.outcome == 1).all(1)).sum())
        stats["no_outcome"] += int((done & (p.log.outcome == 0).all(1)).sum())
        stats["out_of_range"] += int(((action < 0) | (action >= COLS)).sum())
        last = (state, acc, action)
        state, acc = p.state, p.acc
    if min(stats["wins_h_v_d1_d2"]) == 0 or stats["draws"] == 0 or stats["no_outcome"] == 0:
        raise AssertionError(f"connect_four_step_autoreset: a branch was not reached: {stats}")
    s, a, act = last
    return {
        "max_abs_err": 0.0, "tol": "exact", **stats,
        "ms": time_ms(lambda: env.step_autoreset(s, a, act, empty)),
        "plain_ms": time_ms(lambda: autoreset_step(env, s, a, act, empty)),
    }


def turn_based_rollout(dev, g, P: int):
    """[64, 4096, P] rewards, dones ~5%, acting players in turn order
    with a random first player after every episode end."""
    done = (torch.rand(T_C4, E, generator=g, device=dev) < 0.05).float()
    acting = torch.empty(T_C4, E, dtype=torch.int32, device=dev)
    cur = torch.randint(0, P, (E,), generator=g, device=dev, dtype=torch.int32)
    for t in range(T_C4):
        acting[t] = cur
        restart = torch.randint(0, P, (E,), generator=g, device=dev, dtype=torch.int32)
        cur = torch.where(done[t] > 0, restart, (cur + 1) % P)
    outcome = torch.randn(T_C4, E, P, generator=g, device=dev).sign()
    noise = torch.randn(T_C4, E, P, generator=g, device=dev) * 0.1
    noise *= torch.rand(T_C4, E, P, generator=g, device=dev) < 0.1
    rewards = torch.where(done[..., None] > 0, outcome, 0.0) + noise
    values = torch.randn(T_C4, E, generator=g, device=dev) * 0.5
    last_vpp = torch.randn(E, P, generator=g, device=dev) * 0.5
    return rewards, values, done, acting, last_vpp


def check_gae_multiplayer(dev, g) -> dict:
    out = {"tol": 1e-5}
    for P in (2, 4):
        args = turn_based_rollout(dev, g, P)
        adv_k, ret_k = compute_gae_multiplayer(*args, 0.99, 0.95)
        adv_p, ret_p = compute_gae_multiplayer_plain(*args, 0.99, 0.95)
        torch.cuda.synchronize()
        err = max_err([(adv_k, adv_p), (ret_k, ret_p)])
        if not err <= 1e-5:
            raise AssertionError(f"gae_multiplayer_reverse_scan P={P}: max abs err {err} > 1e-5")
        out[f"P{P}"] = {
            "max_abs_err": err,
            "ms": time_ms(lambda: compute_gae_multiplayer(*args, 0.99, 0.95)),
            "plain_ms": time_ms(lambda: compute_gae_multiplayer_plain(*args, 0.99, 0.95)),
        }
    out.update(max_abs_err=max(out["P2"]["max_abs_err"], out["P4"]["max_abs_err"]),
               ms=out["P2"]["ms"], plain_ms=out["P2"]["plain_ms"])
    return out


def connect_four_like(dev, g, n: int) -> torch.Tensor:
    """[n, 86] 0/1 columns with per-column rates, two of them constant."""
    rate = torch.rand(86, generator=g, device=dev)
    rate[5], rate[40] = 0.0, 1.0
    return (torch.rand(n, 86, generator=g, device=dev) < rate).float()


def check_obs_norm_apply(dev, g) -> dict:
    D = 86
    obs = connect_four_like(dev, g, E)
    z = torch.zeros(D, device=dev)
    states = {
        "count0": ObsNormState(mean=z, m2=z.clone(), count=torch.zeros((), device=dev)),
        "count1": ObsNormState(mean=obs[0].clone(), m2=z.clone(), count=torch.ones((), device=dev)),
        "merged": obs_norm_update_plain(ObsNormState.create(D, dev),
                                        connect_four_like(dev, g, E * T_C4)),
    }
    out = {"tol": 1e-6, "max_abs_err": 0.0}
    for name, st in states.items():
        k = obs_norm_apply(st, obs)
        p = obs_norm_apply_plain(st, obs)
        torch.cuda.synchronize()
        err = max_err([(k, p)])
        if not err <= 1e-6:
            raise AssertionError(f"obs_norm_apply {name}: max abs err {err} > 1e-6")
        if name != "merged" and not torch.equal(k, obs):
            raise AssertionError(f"obs_norm_apply {name}: not the identity below count 2")
        out[name] = err
        out["max_abs_err"] = max(out["max_abs_err"], err)
    st = states["merged"]
    out["ms"] = time_ms(lambda: obs_norm_apply(st, obs))
    out["plain_ms"] = time_ms(lambda: obs_norm_apply_plain(st, obs))
    batch = connect_four_like(dev, g, E * T_C4)
    out["update_batch_ms"] = time_ms(lambda: obs_norm_apply(st, batch))
    out["update_batch_plain_ms"] = time_ms(lambda: obs_norm_apply_plain(st, batch))
    return out


def check_obs_norm_update(dev, g) -> dict:
    """Into an empty and into a filled state, at the Connect Four update
    batch [262144, 86] and the CartPole one [524288, 5]: mean to 1e-6
    absolute, m2 to 1e-5 relative, count exact. ``max_abs_err`` is the
    mean's."""
    batches = {
        "c4_262144x86": lambda: connect_four_like(dev, g, E * T_C4),
        "cartpole_524288x5": lambda: torch.randn(E * T, 5, generator=g, device=dev)
        * torch.tensor([1.0, 0.5, 0.1, 0.8, 0.3], device=dev)
        + torch.tensor([0.0, 0.1, 0.0, -0.1, 0.5], device=dev),
    }
    out = {"tol": {"mean": 1e-6, "m2_rel": 1e-5, "count": "exact"}, "max_abs_err": 0.0}
    for name, make in batches.items():
        x1, x2 = make(), make()
        st = ObsNormState.create(x1.shape[1], dev)
        errs = []
        for x in (x1, x2):
            k = obs_norm_update(st, x)
            p = obs_norm_update_plain(st, x)
            torch.cuda.synchronize()
            mean_err = max_err([(k.mean, p.mean)])
            m2_rel = float(((k.m2 - p.m2).abs() / p.m2.abs().clamp_min(1e-30)).max())
            if not mean_err <= 1e-6:
                raise AssertionError(f"obs_norm_update {name}: mean err {mean_err} > 1e-6")
            if not bool(torch.all((k.m2 - p.m2).abs() <= 1e-5 * p.m2.abs())):
                raise AssertionError(f"obs_norm_update {name}: m2 rel err {m2_rel} > 1e-5")
            if not torch.equal(k.count, p.count):
                raise AssertionError(f"obs_norm_update {name}: count {k.count} != {p.count}")
            errs.append({"mean_abs": mean_err, "m2_rel": m2_rel, "count": float(k.count)})
            out["max_abs_err"] = max(out["max_abs_err"], mean_err)
            st = p
        out[name] = {
            "into_empty": errs[0], "into_filled": errs[1],
            "ms": time_ms(lambda: obs_norm_update(st, x1)),
            "plain_ms": time_ms(lambda: obs_norm_update_plain(st, x1)),
        }
    out.update(ms=out["c4_262144x86"]["ms"], plain_ms=out["c4_262144x86"]["plain_ms"])
    return out


def scalars(run: Path) -> dict:
    """name -> list of logged values, in step order."""
    out: dict = {}
    for line in (run / "metrics.jsonl").read_text().splitlines():
        rec = json.loads(line)
        if rec["type"] == "scalar":
            out.setdefault(rec["name"], []).append(rec["value"])
    return out


def train_phase(run: Path, args: list, updates: int, steps_per_update: int,
                expect: dict, card_line: str) -> tuple:
    """One training run through the CLI, with every launch counter at 0
    just before it and read just after; checks the counts against
    ``expect`` (kernels not named there: 0) and the losses for finiteness."""
    from burn_ppo_torch import cli

    for w in WRAPPERS.values():
        w.launches = 0
    t0 = time.time()
    rc = cli.main(["train", *args, "--total-steps", str(updates * steps_per_update),
                   "--checkpoint-freq", str(10**12), "--seed", "0",
                   "--run-dir", str(run), "--quiet"])
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {name: w.launches for name, w in WRAPPERS.items()}
    if rc != 0:
        raise RuntimeError(f"train command exited {rc}")
    want = {name: expect.get(name, 0) for name in WRAPPERS}
    if launches != want:
        raise AssertionError(f"kernel launches {launches} != {want}")
    series = scalars(run)
    for name in ("train/policy_loss", "train/value_loss", "train/total_loss", "train/entropy"):
        vals = series.get(name, [])
        if len(vals) != updates or not all(v is not None and math.isfinite(v) for v in vals):
            raise AssertionError(f"{name}: expected {updates} finite values, got {vals}")
    sps = series["perf/sps"]
    steady = sorted(sps[1:])
    return {
        "updates": updates, "env_steps": updates * steps_per_update, "wall_s": wall,
        "env_steps_per_s_per_update": sps,
        "env_steps_per_s_median_after_first": steady[len(steady) // 2],
        "launches": launches, "card": card_line,
    }, series


def bench_train(tmp: Path, card_line: str) -> dict:
    n = BENCH_UPDATES
    out, _ = train_phase(
        tmp / "bench", ["--config", str(ROOT / "configs" / "cartpole.toml"),
                        "--num-envs", str(E), "--num-steps", str(T)],
        n, E * T,
        {"cartpole_step_autoreset": n * T, "masked_gumbel_sample": n * T,
         "gae_reverse_scan": n, "obs_norm_apply": n * (T + 2), "obs_norm_update": n},
        card_line,
    )
    return out


def selfplay_train(tmp: Path, card_line: str, network: str, updates: int) -> dict:
    """Connect Four pure self-play: one apply per rollout step, one for the
    bootstrap and one for the update batch."""
    extra = ["--network-type", "cnn", "--activation", "relu"] if network == "cnn" else []
    out, series = train_phase(
        tmp / f"c4_{network}",
        ["--config", str(ROOT / "configs" / "connect_four.toml"),
         "--opponent-pool-fraction", "0", "--num-envs", str(E), "--num-steps", str(T_C4),
         "--normalize-obs", *extra],
        updates, E * T_C4,
        {"connect_four_step_autoreset": updates * T_C4, "masked_gumbel_sample": updates * T_C4,
         "gae_multiplayer_reverse_scan": updates,
         "obs_norm_apply": updates * (T_C4 + 2), "obs_norm_update": updates},
        card_line,
    )
    points = [a + b for a, b in zip(series["episode/player_0_points"],
                                    series["episode/player_1_points"])]
    draw_rate, length = series["episode/draw_rate"], series["episode/length_mean"]
    if len(points) != updates or not all(abs(s - 1.0) <= 1e-6 for s in points):
        raise AssertionError(f"Swiss points per update do not sum to 1: {points}")
    if not all(0.0 <= d <= 1.0 for d in draw_rate):
        raise AssertionError(f"draw_rate outside [0, 1]: {draw_rate}")
    if not all(7.0 <= x <= 42.0 for x in length):
        raise AssertionError(f"mean episode length outside [7, 42]: {length}")
    out.update(network=network, points_sum=points, draw_rate=draw_rate, length_mean=length,
               player_0_points=series["episode/player_0_points"],
               policy_loss=series["train/policy_loss"])
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
    last = {k: v[-1] for k, v in scalars(run).items()}
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
    sample_a2 = check_sample(dev, g, 2)
    sample_a7 = check_sample(dev, g, 7)
    checks = {
        "cartpole_step_autoreset": check_cartpole(dev, g),
        "masked_gumbel_sample": {
            "A2": sample_a2, "A7": sample_a7,
            "max_abs_err": max(sample_a2["max_abs_err"], sample_a7["max_abs_err"]),
            "ms": sample_a7["ms"], "plain_ms": sample_a7["plain_ms"],
        },
        "gae_reverse_scan": check_gae(dev, g),
        "connect_four_step_autoreset": check_connect_four(dev, g),
        "gae_multiplayer_reverse_scan": check_gae_multiplayer(dev, g),
        "obs_norm_apply": check_obs_norm_apply(dev, g),
        "obs_norm_update": check_obs_norm_update(dev, g),
    }
    emit("kernels_vs_plain", card=card_line, **checks)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as d:
        runs = {
            "bench_train": bench_train(Path(d), card_line),
            "selfplay_train": selfplay_train(Path(d), card_line, "mlp", BENCH_UPDATES),
            "selfplay_train_cnn": selfplay_train(Path(d), card_line, "cnn", CNN_UPDATES),
        }
        for phase, out in runs.items():
            emit(phase, **out)
        emit("learning_bar", card=card_line, **learning_bar(Path(d)))

    # Launches: the sum over the three train phases, each counted from 0.
    table = [
        {
            "name": name, "route": "cuda", "source": SOURCES[name][0],
            "replaces": SOURCES[name][1],
            "launches": sum(r["launches"][name] for r in runs.values()),
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

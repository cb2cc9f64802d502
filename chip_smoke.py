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
     [524288, 5]), K7 slot-grouped opponent forward (Ep = 1024 rows, MLP
     86 -> 512 -> 512 -> 7, K = 8 and K = 3, relu and tanh; and the Skull
     pool block, Ep = 1229, K = 8, 135 -> 256 -> 256 -> 256 -> 33), K8 PPO
     loss ([65536, 7], [65536, 33] and [131072, 2] minibatches, valid
     zeros, value clip on and off), K9 clip + Adam (CartPole's 4,739,
     Connect Four's 311,304 and Skull CTDE 512x2's 784,418 parameters,
     below and above the max norm), K10 episode statistics ([64, 4096]
     with the learner block [:, :3072], [128, 4096], and four players with
     tied places [:, :2867]), K11 Skull step (E = 4096, exact, along
     random-legal walks at 4, 2 and 6 players with invalid actions,
     finished games and forced discards), K12 return normaliser (roll at
     [4096, 1] and [4096, 4]; finalize at [524288] with and without a
     valid mask), K2 at [4096, 33] on Skull's own masks;
     each kernel's least time on the card (bytes or operations) and,
     where one PyTorch call computes the same function, that call's time;
  3. the CartPole bench-shape train path through the CLI entry point
     (MLP 64x2, 4096 envs x 128 steps, obs norm on, 5 updates);
  3b. Connect Four self-play through the CLI (configs/connect_four.toml,
     MLP 512x2, no opponent pool, 4096 envs x 64 steps, obs norm on,
     5 updates): finite losses, Swiss points summing to 1;
  3c. the same with the CNN (relu), 2 updates;
  3d. Connect Four against the opponent pool through the CLI
     (configs/connect_four.toml as users run it: MLP 512x2, pool fraction
     0.25, 8 opponents at most, 4096 x 64, obs norm on), a checkpoint
     after every update, 10 updates, so that the rotation reaches K = 8:
     finite losses, the pool and rating files, the learner's valid share
     near (L + Ep/2) / E;
  3e. Skull, four players, CTDE self-play at the bench_skull_ctde shape
     (configs/skull_ctde.toml with CTDE 512x2 actor and critic, tanh,
     4096 x 64, 4 epochs x 4 minibatches, no pool), 5 updates: finite
     losses, Swiss points summing to P (P - 1) / 2 = 6;
  3f. Skull CTDE against the pool (configs/skull_ctde.toml as users run
     it: CTDE 256x3 relu, pool fraction 0.3, 4096 x 128), a checkpoint
     after every update, 10 updates: the rotation reaches K = 8, the pool
     and rating files, the learner's valid share strictly between L / E
     and (L + Ep/2) / E (three of four seats of a pool env are the
     opponents');
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
from burn_ppo_torch.envs.skull import FIELDS as SKULL_FIELDS  # noqa: E402
from burn_ppo_torch.envs.skull import Skull, skull_step_autoreset, walk_actions  # noqa: E402
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
from burn_ppo_torch.envs.base import EpisodeLog  # noqa: E402
from burn_ppo_torch.ppo.episode_stats import (  # noqa: E402
    summarize_episode_logs,
    summarize_episode_logs_plain,
)
from burn_ppo_torch.ppo.normalization import (  # noqa: E402
    ObsNormState,
    ReturnNormState,
    obs_norm_apply,
    obs_norm_apply_plain,
    obs_norm_update,
    obs_norm_update_plain,
    return_norm_finalize,
    return_norm_finalize_f64,
    return_norm_finalize_f64_plain,
    return_norm_roll,
    return_norm_roll_plain,
)
from burn_ppo_torch.ppo.pool_rollout import (  # noqa: E402
    OpponentStack,
    opponent_actor_forward,
    opponent_actor_forward_plain,
)
from burn_ppo_torch.ppo.update import (  # noqa: E402
    PPOUpdateConfig,
    clip_adam,
    clip_adam_plain,
    ppo_loss,
    ppo_loss_forward,
    ppo_loss_plain,
)

E, T = 4096, 128  # CartPole bench shape
T_C4 = 64  # Connect Four self-play shape: 4096 envs x 64 steps
BENCH_UPDATES = 5
CNN_UPDATES = 2
POOL_UPDATES = 10
EP = 1024  # pool envs at 4096 envs and pool fraction 0.25
T_SKULL_POOL = 128  # configs/skull_ctde.toml's steps per update
EP_SKULL = 1229  # pool envs at 4096 envs and pool fraction 0.3
SKULL_CTDE_PARAMS = 784418  # CTDE actor and critic 512x2 on Skull's 135 + 200 inputs
# Published H100 SXM peaks (NVIDIA data sheet): HBM, and f32 and f64
# outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
TIMES = ("ms", "plain_ms", "device_ms", "plain_device_ms")
F32_FLOP_PER_S = 67e12
F64_FLOP_PER_S = 34e12
WRAPPERS = {
    "cartpole_step_autoreset": cartpole_step_autoreset,
    "masked_gumbel_sample": masked_sample,
    "gae_reverse_scan": compute_gae,
    "connect_four_step_autoreset": connect_four_step_autoreset,
    "gae_multiplayer_reverse_scan": compute_gae_multiplayer,
    "obs_norm_apply": obs_norm_apply,
    "obs_norm_update": obs_norm_update,
    "opponent_actor_forward": opponent_actor_forward,
    "ppo_loss": ppo_loss,
    "clip_adam": clip_adam,
    "episode_stats": summarize_episode_logs,
    "skull_step_autoreset": skull_step_autoreset,
    "return_norm_roll": return_norm_roll,
    "return_norm_finalize": return_norm_finalize,
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
    "opponent_actor_forward": ("burn_ppo_torch/csrc/opponent_actor.cu",
                               "burn_ppo_tpu/ppo/pool_rollout.py:126"),
    "ppo_loss": ("burn_ppo_torch/csrc/ppo_loss.cu", "burn_ppo_tpu/ppo/update.py:125"),
    "clip_adam": ("burn_ppo_torch/csrc/clip_adam.cu", "burn_ppo_tpu/ppo/update.py:82"),
    "episode_stats": ("burn_ppo_torch/csrc/episode_stats.cu",
                      "burn_ppo_tpu/ppo/episode_stats.py:25"),
    "skull_step_autoreset": ("burn_ppo_torch/csrc/skull_step.cu",
                             "burn_ppo_tpu/envs/skull.py:280"),
    "return_norm_roll": ("burn_ppo_torch/csrc/return_norm.cu",
                         "burn_ppo_tpu/ppo/normalization.py:105"),
    "return_norm_finalize": ("burn_ppo_torch/csrc/return_norm.cu",
                             "burn_ppo_tpu/ppo/normalization.py:136"),
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


def device_ms(fn, reps: int = 10) -> float:
    """Kernel time per call on the card, from the profiler: the CUDA-typed
    events only (a CPU op's device column counts the same kernels again)."""
    fn()
    torch.cuda.synchronize()
    act = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels_us = sum(e.self_device_time_total for e in prof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA)
    return kernels_us / 1e3 / reps


def timed(kernel, plain) -> dict:
    """Events time (the wrapper's host work included) and profiler device
    time of one call, for the kernel's wrapper and its plain version."""
    return {"ms": time_ms(kernel), "plain_ms": time_ms(plain),
            "device_ms": device_ms(kernel), "plain_device_ms": device_ms(plain)}


def max_err(pairs) -> float:
    return max(float((a.float() - b.float()).abs().max()) for a, b in pairs)


def nbytes(*tensors) -> int:
    """Bytes of the distinct buffers among the tensors (nested lists,
    dataclasses and None allowed). A buffer that two fields share, as a
    step's done and its log's completed, counts once; a buffer read and
    then written counts twice only from two calls."""
    seen = {}

    def walk(t):
        if isinstance(t, torch.Tensor):
            seen[(t.data_ptr(), t.numel() * t.element_size())] = t.numel() * t.element_size()
        elif isinstance(t, (list, tuple)):
            for x in t:
                walk(x)
        elif t is not None:
            walk(list(vars(t).values()))

    walk(tensors)
    return sum(seen.values())


def bound(bytes_moved: float, flops: float = 0.0, flops64: float = 0.0) -> dict:
    """The least time the card could take: the larger of the bytes over
    the HBM rate and the operations over the peak of their type (f32, and
    f64 for ``flops64``)."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = (flops / F32_FLOP_PER_S + flops64 / F64_FLOP_PER_S) * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops
            else "operations", "bytes": bytes_moved, "flops": flops, "flops64": flops64}


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
        **timed(lambda: env.step_autoreset(state, acc, action, reset),
                lambda: autoreset_step(env, state, acc, action, reset)),
        "library_ms": None,
        # ~30 f32 operations of Euler physics per env
        **bound(nbytes(state, acc, action, reset, k), 30.0 * E),
    }


def check_sample(dev, g, A: int, mask=None) -> dict:
    """A = 2: CartPole, every action legal. A = 7: Connect Four, 0-6
    masked columns per row. A = 33: the given Skull masks."""
    logits = torch.randn(E, A, generator=g, device=dev) * 2
    if mask is None and A == 2:
        mask = torch.ones(E, A, device=dev)
    elif mask is None:
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
        "legal_per_row_min_mean_max": [float(mask.sum(1).min()), float(mask.sum(1).mean()),
                                       float(mask.sum(1).max())],
        **timed(lambda: masked_sample(logits, mask, uni),
                lambda: masked_sample_plain(logits, mask, uni)),
        "library_ms": None,
        # per (row, action): mask add, two logs, add, compare, exp, add
        **bound(nbytes(logits, mask, uni, a_k, lp_k), 8.0 * E * A),
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
        **timed(lambda: compute_gae(r, v, d, last, 0.99, 0.95),
                lambda: compute_gae_plain(r, v, d, last, 0.99, 0.95)),
        "library_ms": None,
        **bound(nbytes(r, v, d, last, adv_k, ret_k), 8.0 * T * E),
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
    k = env.step_autoreset(s, a, act, empty)
    return {
        "max_abs_err": 0.0, "tol": "exact", **stats,
        **timed(lambda: env.step_autoreset(s, a, act, empty),
                lambda: autoreset_step(env, s, a, act, empty)),
        "library_ms": None,
        # the 69 four-in-a-row windows of the mover, a few operations each
        **bound(nbytes(s, a, act, k), 300.0 * E),
    }


def skull_walk(dev, g, n: int, steps: int) -> tuple:
    """K11 against the plain step at every step of a random-legal walk of
    4096 envs of ``Skull(n)``: every output equal, bit for bit. Before each
    step 15% of the envs get a forced discard and 0.3% are marked finished;
    half play with a shaping coefficient of 0.05. Returns (env, the last
    step's inputs and K11 output, event counts)."""
    env = Skull(n)
    empty = torch.empty(E, 0, device=dev)
    state = env.reset(empty)
    state.shaping_coef = (torch.arange(E, device=dev) % 2) * 0.05
    acc = EpisodeAccumulator.zero(E, n, dev)
    ev = {"steps": steps, "phase_placing_bidding_revealing": [0, 0, 0], "game_ends": 0,
          "skull_hits": 0, "rose_wins": 0, "eliminations": 0, "invalid_actions": 0,
          "finished_games_in": 0, "forced_discards_revealing": 0, "full_histories": 0}
    for _ in range(steps):
        fd = torch.randint(0, 2, (E,), generator=g, device=dev, dtype=torch.int32)
        state.forced_discard = torch.where(torch.rand(E, generator=g, device=dev) < 0.15, fd, -1)
        over = torch.rand(E, generator=g, device=dev) < 0.003
        state.game_over = state.game_over | over
        mask = env.action_mask(state)
        action = walk_actions(mask, g)
        u = torch.rand(E, generator=g, device=dev)
        k = env.step_autoreset(state, acc, action, empty, u)
        p = autoreset_step(env, state, acc, action, empty, u)
        torch.cuda.synchronize()
        pairs = {f"state.{f}": (getattr(k.state, f), getattr(p.state, f)) for f in SKULL_FIELDS}
        pairs.update({f"log.{f}": (getattr(k.log, f), getattr(p.log, f))
                      for f in ("completed", "total_rewards", "length", "outcome",
                                "active_players")})
        pairs.update({"acc.reward_sum": (k.acc.reward_sum, p.acc.reward_sum),
                      "acc.length": (k.acc.length, p.acc.length), "rewards": (k.rewards, p.rewards),
                      "done": (k.done, p.done), "obs": (k.obs, p.obs), "mask": (k.mask, p.mask),
                      "priv": (k.priv, p.priv)})
        for name, (a, b) in pairs.items():
            if a.dtype != b.dtype or not torch.equal(a, b):
                raise AssertionError(f"skull_step_autoreset P={n}: {name} differs from plain")
        legal = torch.gather(mask, 1, action.long().clamp(0, 32)[:, None])[:, 0] > 0
        valid = (action >= 0) & (action < 33) & legal & ~state.game_over
        done = k.done > 0
        for ph in range(3):
            ev["phase_placing_bidding_revealing"][ph] += int((state.phase == ph).sum())
        ev["game_ends"] += int((done & valid).sum())
        ev["skull_hits"] += int(((k.rewards < 0).any(1) & ~done).sum())
        ev["rose_wins"] += int(((k.rewards > 0).any(1) & ~done).sum())
        ev["eliminations"] += int(((k.state.num_eliminated > state.num_eliminated) & ~done).sum())
        ev["invalid_actions"] += int((~valid & ~state.game_over).sum())
        ev["finished_games_in"] += int(state.game_over.sum())
        ev["forced_discards_revealing"] += int(((state.forced_discard >= 0) & (state.phase == 2)
                                                & valid).sum())
        ev["full_histories"] += int((state.hist_len == 8).sum())
        last = (state, acc, action, u, k)
        state, acc = k.state, k.acc
    return env, last, ev


def check_skull(dev, g) -> tuple:
    """K11 along walks at 4 (300 steps), 2 and 6 players (80 steps each);
    every branch must occur. Returns (the check, the last P = 4 mask and
    obs for K2 and K7)."""
    out = {"max_abs_err": 0.0, "tol": "exact"}
    walks = {}
    for n, steps in ((4, 300), (2, 80), (6, 80)):
        walks[n] = skull_walk(dev, g, n, steps)
        out[f"P{n}"] = walks[n][2]
    for key in ("game_ends", "skull_hits", "rose_wins", "eliminations", "invalid_actions",
                "finished_games_in", "forced_discards_revealing"):
        if out["P4"][key] == 0:
            raise AssertionError(f"skull_step_autoreset: no {key} in the P=4 walk: {out['P4']}")
    if min(out["P4"]["phase_placing_bidding_revealing"]) == 0 or out["P6"]["full_histories"] == 0:
        raise AssertionError(f"skull_step_autoreset: a branch was not reached: {out}")
    env, (s, a, act, u, k), _ = walks[4]
    empty = torch.empty(E, 0, device=dev)
    out.update(
        **timed(lambda: env.step_autoreset(s, a, act, empty, u),
                lambda: autoreset_step(env, s, a, act, empty, u)),
        library_ms=None,
        # the mask, the phase machine, placements, obs and privileged obs:
        # ~2,000 integer and f32 operations per env
        **bound(nbytes(s, a, act, u, k), 2000.0 * E),
    )
    return out, k.mask, k.obs


def check_return_norm_roll(dev, g) -> dict:
    """K12's roll at CartPole's [4096, 1] and at [4096, 4]: exact."""
    out = {"max_abs_err": 0.0, "tol": "exact"}
    for P in (1, 4):
        args = (torch.randn(E, P, generator=g, device=dev) * 3,
                torch.randn(E, generator=g, device=dev),
                torch.randint(0, P, (E,), generator=g, device=dev, dtype=torch.int32),
                (torch.rand(E, generator=g, device=dev) < 0.02).float(), 0.99)
        k = return_norm_roll(*args)
        p = return_norm_roll_plain(*args)
        torch.cuda.synchronize()
        if not (torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])):
            raise AssertionError(f"return_norm_roll P={P}: differs from plain")
        if P == 1:
            out.update(**timed(lambda: return_norm_roll(*args), lambda: return_norm_roll_plain(*args)),
                       library_ms=None,
                       **bound(nbytes(*args[:4], k), 3.0 * E))
    return out


def check_return_norm_finalize(dev, g) -> dict:
    """K12's finalize over CartPole's [524288] (128 x 4096): into an empty
    and into a filled state, with and without a valid mask, and a mask
    with no valid sample. f64 stats to 1e-12 relative, normalized rewards
    to 2 f32 ulp; the empty mask leaves the state exactly as it was."""
    N = E * T
    tol = {"stats64_rel": 1e-12, "normalized_rel": 2.4e-7}
    out = {"tol": tol, "max_abs_err": 0.0}
    z = torch.zeros((), device=dev)
    states = {"empty": ReturnNormState(torch.zeros(E, 1, device=dev), z, z.clone(), z.clone()),
              "filled": ReturnNormState(torch.zeros(E, 1, device=dev), z + 0.37, z + 4.1e6,
                                        z + 2.6e6)}
    samples = torch.randn(N, generator=g, device=dev) * 2 + 0.5
    rewards = torch.randn(N, generator=g, device=dev)
    valid = (torch.rand(N, generator=g, device=dev) < 0.75).float()
    for sname, st in states.items():
        for vname, w in (("all", None), ("masked", valid)):
            ks, kn = return_norm_finalize_f64(st, samples, rewards, 10.0, w)
            ps, pn = return_norm_finalize_f64_plain(st, samples, rewards, 10.0, w)
            torch.cuda.synchronize()
            rel_s = float(((ks - ps).abs() / ps.abs().clamp_min(1e-300)).max())
            rel_n = float(((kn - pn).abs() / pn.abs().clamp_min(1e-30)).max())
            if not (rel_s <= tol["stats64_rel"] and rel_n <= tol["normalized_rel"]):
                raise AssertionError(f"return_norm_finalize {sname}/{vname}: stats rel {rel_s}, "
                                     f"normalized rel {rel_n}")
            out[f"{sname}_{vname}"] = {"stats64_rel": rel_s, "normalized_rel": rel_n}
            out["max_abs_err"] = max(out["max_abs_err"], max_err([(kn, pn)]))
    new, _ = return_norm_finalize(states["filled"], samples, rewards, 10.0, torch.zeros_like(valid))
    torch.cuda.synchronize()
    if not all(torch.equal(getattr(new, f), getattr(states["filled"], f)) for f in ("mean", "m2", "count")):
        raise AssertionError("return_norm_finalize: a batch without valid samples moved the stats")
    st = states["empty"]
    x64 = samples.double()
    out.update(
        **timed(lambda: return_norm_finalize_f64(st, samples, rewards),
                lambda: return_norm_finalize_f64_plain(st, samples, rewards)),
        library_ms=time_ms(lambda: torch.cumsum(x64, 0)),
        library_call="torch.cumsum of the f64 samples (one of the three prefix sums, no stats)",
        # read samples and rewards, write the normalized rewards; ~25 f64
        # operations per element
        **bound(nbytes(samples, rewards) + nbytes(rewards), flops64=25.0 * N),
    )
    return out


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
            **timed(lambda: compute_gae_multiplayer(*args, 0.99, 0.95),
                    lambda: compute_gae_multiplayer_plain(*args, 0.99, 0.95)),
        }
        if P == 2:
            out.update(library_ms=None, **bound(nbytes(*args, adv_k, ret_k), 12.0 * T_C4 * E * P))
    out.update(max_abs_err=max(out["P2"]["max_abs_err"], out["P4"]["max_abs_err"]),
               **{k: out["P2"][k] for k in TIMES})
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
    out.update(timed(lambda: obs_norm_apply(st, obs), lambda: obs_norm_apply_plain(st, obs)))
    out.update(library_ms=None, **bound(nbytes(obs, st) + nbytes(obs), 6.0 * obs.numel()))
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
            **timed(lambda: obs_norm_update(st, x1), lambda: obs_norm_update_plain(st, x1)),
        }
    x = connect_four_like(dev, g, E * T_C4)
    out.update(**{k: out["c4_262144x86"][k] for k in TIMES},
               library_ms=time_ms(lambda: torch.var_mean(x, dim=0)),
               library_call="torch.var_mean(batch, dim=0) (the batch moments, no merge)",
               **bound(nbytes(x) + 3 * 86 * 4 * 2, 4.0 * x.numel()))
    return out


def random_opponents(dev, g, K: int, act: str, D: int = 86, H: int = 512, A: int = 7,
                     depth: int = 2) -> OpponentStack:
    """K random actor towers D -> H (x depth) -> A, Connect Four's 86 -> 512
    -> 512 -> 7 by default (fan-in scaled) and obs normalisers: slot 0 at
    count 0 (the identity), slot 1 at count 1, the others merged."""
    sizes = [D] + [H] * depth + [A]
    weights = [torch.randn(K, i, o, generator=g, device=dev) / i ** 0.5
               for i, o in zip(sizes, sizes[1:])]
    biases = [torch.randn(K, o, generator=g, device=dev) * 0.1 for o in sizes[1:]]
    count = torch.full((K,), 5000.0, device=dev)
    count[0] = 0.0
    count[1] = 1.0
    norm = ObsNormState(mean=torch.rand(K, D, generator=g, device=dev),
                        m2=torch.rand(K, D, generator=g, device=dev) * 1000.0, count=count)
    return OpponentStack(weights=weights, biases=biases, activation=act, norm=norm)


def check_opponent_actor(dev, g, skull_obs: torch.Tensor) -> dict:
    """K7 at the pool block of the bench shape (Ep = 1024 rows), K = 8 and
    K = 3, relu and tanh, and at Skull's (Ep = 1229 rows of Skull obs, K =
    8, CTDE actor 135 -> 256 -> 256 -> 256 -> 33, relu, no obs
    normalisation, as configs/skull_ctde.toml trains):
    |kernel - plain| <= 1e-4 + 1e-4 |plain|."""
    out = {"tol": "1e-4 + 1e-4 * |plain|", "max_abs_err": 0.0}
    for K, act in ((8, "relu"), (8, "tanh"), (3, "relu"), (3, "tanh")):
        stack = random_opponents(dev, g, K, act)
        obs = connect_four_like(dev, g, EP)
        slot = torch.randint(0, K, (EP,), generator=g, device=dev, dtype=torch.int32)
        k = opponent_actor_forward(obs, slot, stack)
        p = opponent_actor_forward_plain(obs, slot, stack)
        torch.cuda.synchronize()
        if not bool(torch.all((k - p).abs() <= 1e-4 + 1e-4 * p.abs())):
            raise AssertionError(f"opponent_actor_forward K={K} {act}: max abs err "
                                 f"{max_err([(k, p)])}")
        out[f"K{K}_{act}"] = max_err([(k, p)])
        out["max_abs_err"] = max(out["max_abs_err"], out[f"K{K}_{act}"])
    stack = random_opponents(dev, g, 8, "relu")
    obs = connect_four_like(dev, g, EP)
    slot = torch.randint(0, 8, (EP,), generator=g, device=dev, dtype=torch.int32)
    xs = [torch.rand(8, EP, w.shape[1], generator=g, device=dev) for w in stack.weights]
    # Every row through its own slot only: 309,760 multiply-adds per row.
    macs = sum(w.shape[1] * w.shape[2] for w in stack.weights)
    out.update(
        **timed(lambda: opponent_actor_forward(obs, slot, stack),
                lambda: opponent_actor_forward_plain(obs, slot, stack)),
        library_ms=time_ms(lambda: [torch.bmm(x, w) for x, w in zip(xs, stack.weights)]),
        library_call="torch.bmm over the K x Ep stacked rows, one per layer (K times the work)",
        **bound(nbytes(obs, slot, stack.weights, stack.biases, stack.norm) + EP * 7 * 4,
                2.0 * EP * macs),
    )
    stack = random_opponents(dev, g, 8, "relu", D=135, H=256, A=33, depth=3)
    stack.norm = None
    obs = skull_obs[:EP_SKULL].contiguous()
    slot = torch.randint(0, 8, (EP_SKULL,), generator=g, device=dev, dtype=torch.int32)
    k = opponent_actor_forward(obs, slot, stack)
    p = opponent_actor_forward_plain(obs, slot, stack)
    torch.cuda.synchronize()
    if not bool(torch.all((k - p).abs() <= 1e-4 + 1e-4 * p.abs())):
        raise AssertionError(f"opponent_actor_forward Skull: max abs err {max_err([(k, p)])}")
    xs = [torch.rand(8, EP_SKULL, w.shape[1], generator=g, device=dev) for w in stack.weights]
    macs = sum(w.shape[1] * w.shape[2] for w in stack.weights)
    out["skull_Ep1229_K8_ctde256x3"] = {
        "max_abs_err": max_err([(k, p)]),
        **timed(lambda: opponent_actor_forward(obs, slot, stack),
                lambda: opponent_actor_forward_plain(obs, slot, stack)),
        "library_ms": time_ms(lambda: [torch.bmm(x, w) for x, w in zip(xs, stack.weights)]),
        **bound(nbytes(obs, slot, stack.weights, stack.biases) + EP_SKULL * 33 * 4,
                2.0 * EP_SKULL * macs),
    }
    out["max_abs_err"] = max(out["max_abs_err"], out["skull_Ep1229_K8_ctde256x3"]["max_abs_err"])
    return out


def loss_batch(dev, g, M: int, A: int):
    """A minibatch as the update gives it: 0 to A-1 masked actions per row,
    a fifth of the rows invalid."""
    logits = torch.randn(M, A, generator=g, device=dev) * 2
    n_masked = torch.randint(0, A, (M, 1), generator=g, device=dev)
    mask = (torch.rand(M, A, generator=g, device=dev).argsort(1).argsort(1) >= n_masked).float()
    logp = torch.log_softmax(apply_action_mask(logits, mask), -1)
    actions = torch.multinomial(mask, 1, generator=g)[:, 0].to(torch.int32)
    old_lp = logp.gather(1, actions.long()[:, None])[:, 0] + torch.randn(
        M, generator=g, device=dev) * 0.2
    values = torch.randn(M, generator=g, device=dev)
    mb = {
        "actions": actions, "old_log_probs": old_lp,
        "advantages": torch.randn(M, generator=g, device=dev) * 2 + 0.3,
        "returns": torch.randn(M, generator=g, device=dev),
        "old_values": values + torch.randn(M, generator=g, device=dev) * 0.3,
        "valid": (torch.rand(M, generator=g, device=dev) < 0.8).float(),
        "action_masks": mask,
    }
    return logits, values, mb


def check_ppo_loss(dev, g) -> dict:
    """K8 at the minibatch shapes: Connect Four [65536, 7] (value clip off
    and on), Skull [65536, 33], CartPole [131072, 2]. Loss and metrics to
    1e-5 relative, gradients to 1e-4 relative + 1e-6 of their largest
    entry."""
    out = {"tol": {"loss_metrics_rel": 1e-5, "grads_rel": 1e-4}, "max_abs_err": 0.0}
    for M, A, clip_value in ((65536, 7, False), (65536, 7, True), (65536, 33, False),
                             (131072, 2, False)):
        logits, values, mb = loss_batch(dev, g, M, A)
        cfg = PPOUpdateConfig(clip_epsilon=0.1, clip_value=clip_value)
        k = ppo_loss_forward(logits, values, mb, 0.05, cfg)
        p = ppo_loss_plain(logits, values, mb, 0.05, cfg)
        torch.cuda.synchronize()
        name = f"M{M}_A{A}" + ("_clip" if clip_value else "")
        for a, b, rel, what in ((k[0], p[0], 1e-5, "loss"), (k[1], p[1], 1e-5, "metrics"),
                                (k[2], p[2], 1e-4, "dlogits"), (k[3], p[3], 1e-4, "dvalues")):
            atol = 1e-6 * max(float(b.abs().max()), 1.0 if what in ("loss", "metrics") else 0.0)
            if not bool(torch.all((a - b).abs() <= atol + rel * b.abs())):
                raise AssertionError(f"ppo_loss {name}: {what} max abs err {max_err([(a, b)])}")
        out[name] = max_err(list(zip(k, p)))
        out["max_abs_err"] = max(out["max_abs_err"], out[name])
    logits, values, mb = loss_batch(dev, g, 65536, 7)
    cfg = PPOUpdateConfig(clip_epsilon=0.1)
    dl = torch.empty_like(logits)
    # logits, mask, dL/dlogits [M, 7]; values, the columns read, dL/dvalues
    # [M] (old_values is read only with the value clip on)
    read = [t for k, t in mb.items() if k != "old_values" or cfg.clip_value]
    moved = nbytes(logits, values, read) + nbytes(dl, values) + 15 * 4
    out.update(
        **timed(lambda: ppo_loss_forward(logits, values, mb, 0.05, cfg),
                lambda: ppo_loss_plain(logits, values, mb, 0.05, cfg)),
        library_ms=None,
        # per row: the masked log-softmax and its gradient (~12 per
        # action), ratio, clip, value and metric terms (~60)
        **bound(moved, 65536 * (12.0 * 7 + 60.0)),
    )
    logits, values, mb = loss_batch(dev, g, 65536, 33)
    read = [t for k, t in mb.items() if k != "old_values"]
    out["M65536_A33"] = {
        **timed(lambda: ppo_loss_forward(logits, values, mb, 0.05, cfg),
                lambda: ppo_loss_plain(logits, values, mb, 0.05, cfg)),
        "library_ms": None,
        **bound(nbytes(logits, values, read) + nbytes(logits, values) + 15 * 4,
                65536 * (12.0 * 33 + 60.0)),
    }
    return out


def check_clip_adam(dev, g) -> dict:
    """K9 over flat buffers of CartPole's MLP 64x2 (4,739 parameters),
    Connect Four's MLP 512x2 (311,304) and Skull's CTDE 512x2 (784,418),
    three steps below and three above the max norm: to 1e-5 relative +
    1e-7 of the largest entry."""
    out = {"tol": "1e-5 * |plain| + 1e-7 * max|plain|", "max_abs_err": 0.0}
    for n in (4739, 311304, SKULL_CTDE_PARAMS):
        for scale in (1e-3, 10.0):
            p_k = torch.randn(n, generator=g, device=dev)
            mu_k, nu_k = torch.zeros(n, device=dev), torch.zeros(n, device=dev)
            p_p, mu_p, nu_p = p_k.clone(), mu_k.clone(), nu_k.clone()
            for count in (1, 2, 3):
                grads = torch.randn(n, generator=g, device=dev) * scale / n ** 0.5
                kw = dict(lr=1e-3, max_grad_norm=0.5, eps=1e-5, bc1=1 - 0.9 ** count,
                          bc2=1 - 0.999 ** count)
                clip_adam(p_k, grads, mu_k, nu_k, **kw)
                clip_adam_plain(p_p, grads, mu_p, nu_p, **kw)
            torch.cuda.synchronize()
            for a, b in ((p_k, p_p), (mu_k, mu_p), (nu_k, nu_p)):
                if not bool(torch.all((a - b).abs() <= 1e-7 * float(b.abs().max())
                                      + 1e-5 * b.abs())):
                    raise AssertionError(f"clip_adam n={n} scale={scale}: max abs err "
                                         f"{max_err([(a, b)])}")
            name = f"n{n}_{'above' if scale > 1 else 'below'}"
            out[name] = max_err([(p_k, p_p), (mu_k, mu_p), (nu_k, nu_p)])
            out["max_abs_err"] = max(out["max_abs_err"], out[name])
    n = 311304
    prm, grads = torch.randn(n, generator=g, device=dev), torch.randn(n, generator=g, device=dev)
    mu, nu = torch.zeros(n, device=dev), torch.zeros(n, device=dev)
    kw = dict(lr=1e-6, max_grad_norm=0.5, eps=1e-5, bc1=0.1, bc2=0.001)
    lib = torch.nn.Parameter(prm.clone())
    lib.grad = grads.clone()
    adam = torch.optim.Adam([lib], lr=1e-6, eps=1e-5, fused=True)
    out.update(
        **timed(lambda: clip_adam(prm, grads, mu, nu, **kw),
                lambda: clip_adam_plain(prm, grads, mu, nu, **kw)),
        library_ms=time_ms(adam.step),
        library_call="torch.optim.Adam(fused=True).step() (Adam only: no global-norm clip)",
        # read params, grads, mu, nu; write params, mu, nu
        **bound(7 * 4 * n, 20.0 * n),
    )
    n = SKULL_CTDE_PARAMS
    prm, grads = torch.randn(n, generator=g, device=dev), torch.randn(n, generator=g, device=dev)
    mu, nu = torch.zeros(n, device=dev), torch.zeros(n, device=dev)
    out[f"n{n}"] = {
        **timed(lambda: clip_adam(prm, grads, mu, nu, **kw),
                lambda: clip_adam_plain(prm, grads, mu, nu, **kw)),
        "library_ms": None, **bound(7 * 4 * n, 20.0 * n),
    }
    return out


def episode_logs(dev, g, T: int, P: int, rate: float = 0.05) -> EpisodeLog:
    """[T, 4096] logs: wins, all-tied draws and the [0, ..] sentinel."""
    kinds = torch.randint(0, 4, (T, E), generator=g, device=dev)
    places = torch.randint(1, P + 1, (T, E, P), generator=g, device=dev, dtype=torch.int32)
    places[kinds == 1] = 1
    places[kinds == 2] = 0
    return EpisodeLog(
        completed=(torch.rand(T, E, generator=g, device=dev) < rate).float(),
        total_rewards=torch.randn(T, E, P, generator=g, device=dev),
        length=torch.randint(1, 43, (T, E), generator=g, device=dev, dtype=torch.int32),
        outcome=places, active_players=torch.full((T, E), P, dtype=torch.int32, device=dev),
    )


def check_episode_stats(dev, g) -> dict:
    """K10 at the learner block of the pool path ([64, 4096], first 3072
    columns), all of Connect Four's [64, 4096], CartPole's [128, 4096] and
    four players with tied places in Skull's learner block (first 2867):
    counts, extrema and lengths exact, sums to 1e-6 relative + 1e-3."""
    out = {"tol": {"count_len_draws_max_min": "exact", "sums": "1e-6 rel + 1e-3"},
           "max_abs_err": 0.0}
    L = E - EP
    for T_, P, cols in ((T_C4, 2, L), (T_C4, 2, None), (T, 1, None), (T_C4, 4, E - EP_SKULL)):
        logs = episode_logs(dev, g, T_, P)
        k = summarize_episode_logs(logs, P, num_envs=cols)
        cut = EpisodeLog(**{f: getattr(logs, f)[:, :cols] for f in vars(logs)})
        p = summarize_episode_logs_plain(logs if cols is None else cut, P)
        torch.cuda.synchronize()
        name = f"T{T_}_P{P}_" + ("all" if cols is None else f"first{cols}")
        for key in ("count", "len_sum", "draws", "ret0_max", "ret0_min"):
            if not torch.equal(k[key], p[key]):
                raise AssertionError(f"episode_stats {name}: {key} {k[key]} != {p[key]}")
        for key in ("ret_sum", "pts_sum"):
            if not bool(torch.all((k[key] - p[key]).abs() <= 1e-3 + 1e-6 * p[key].abs())):
                raise AssertionError(f"episode_stats {name}: {key} {k[key]} != {p[key]}")
        out[name] = max_err([(k[f], p[f]) for f in p])
        out["max_abs_err"] = max(out["max_abs_err"], out[name])

    def timing(P: int, cols: int) -> dict:
        logs = episode_logs(dev, g, T_C4, P)
        block = EpisodeLog(**{f: getattr(logs, f)[:, :cols] for f in vars(logs)})
        # The learner block's completed column is read whole; length, rewards
        # and placements only on the rows of completed episodes, as many as
        # this run's logs hold. Out: 5 + 2P floats. Ops: one test per entry,
        # ~30 per completed episode.
        done = int((block.completed > 0).sum())
        row = (block.length.element_size() + block.total_rewards[0, 0].numel() * 4
               + block.outcome[0, 0].numel() * 4)
        return {
            **timed(lambda: summarize_episode_logs(logs, P, num_envs=cols),
                    lambda: summarize_episode_logs_plain(block, P)),
            "library_ms": None, "completed_rows": done,
            **bound(nbytes(block.completed) + done * row + (5 + 2 * P) * 4,
                    T_C4 * cols + 30.0 * done),
        }

    out.update(timing(2, L))
    name = f"T{T_C4}_P4_first{E - EP_SKULL}"
    out[name] = {"max_abs_err": out.pop(name), **timing(4, E - EP_SKULL)}
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
                expect: dict, card_line: str, checkpoint_freq: int = 10**12) -> tuple:
    """One training run through the CLI, with every launch counter at 0
    just before it and read just after; checks the counts against
    ``expect`` (kernels not named there: 0) and the losses for finiteness.
    Every update launches K10 once, and K8 and K9 once per minibatch it
    runs (``train/minibatch_updates``: KL early stop and skipped
    all-invalid minibatches make that count the run's own)."""
    from burn_ppo_torch import cli

    for w in WRAPPERS.values():
        w.launches = 0
    t0 = time.time()
    rc = cli.main(["train", *args, "--total-steps", str(updates * steps_per_update),
                   "--checkpoint-freq", str(checkpoint_freq), "--seed", "0",
                   "--run-dir", str(run), "--quiet"])
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {name: w.launches for name, w in WRAPPERS.items()}
    if rc != 0:
        raise RuntimeError(f"train command exited {rc}")
    series = scalars(run)
    for name in ("train/policy_loss", "train/value_loss", "train/total_loss", "train/entropy",
                 "train/minibatch_updates"):
        vals = series.get(name, [])
        if len(vals) != updates or not all(v is not None and math.isfinite(v) for v in vals):
            raise AssertionError(f"{name}: expected {updates} finite values, got {vals}")
    minibatches = int(sum(series["train/minibatch_updates"]))
    want = {name: expect.get(name, 0) for name in WRAPPERS}
    want.update(ppo_loss=minibatches, clip_adam=minibatches, episode_stats=updates)
    if launches != want:
        raise AssertionError(f"kernel launches {launches} != {want}")
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
         "gae_reverse_scan": n, "obs_norm_apply": n * (T + 2), "obs_norm_update": n,
         "return_norm_roll": n * T, "return_norm_finalize": n},
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


def selfplay_pool_train(tmp: Path, card_line: str) -> dict:
    """Connect Four against the opponent pool, configs/connect_four.toml as
    users run it (pool fraction 0.25, 8 opponents at most), a checkpoint
    after every update. Update u runs against min(u - 1, 8) opponents (the
    first, with an empty pool, is pure self-play), so updates 9 and 10 run
    K = 8. Per pool update: K2 twice a step (learner, opponents), K7 once."""
    n = POOL_UPDATES
    pool_updates = n - 1
    run = tmp / "c4_pool"
    out, series = train_phase(
        run,
        ["--config", str(ROOT / "configs" / "connect_four.toml"), "--num-envs", str(E),
         "--num-steps", str(T_C4), "--normalize-obs"],
        n, E * T_C4,
        {"connect_four_step_autoreset": n * T_C4,
         "masked_gumbel_sample": n * T_C4 + pool_updates * T_C4,
         "opponent_actor_forward": pool_updates * T_C4,
         "gae_multiplayer_reverse_scan": n,
         "obs_norm_apply": n * (T_C4 + 2), "obs_norm_update": n},
        card_line, checkpoint_freq=E * T_C4,
    )
    stats = json.loads((run / "opponent_stats.json").read_text())["opponents"]
    rotation_sizes = [min(u - 1, 8) for u in range(1, n + 1)]
    # The stats file is written at each rotation's fold: after update 10 it
    # lists the 9 checkpoints that were in the pool, so updates 9 and 10 ran K = 8.
    if len(stats) != n - 1 or max(rotation_sizes) != 8:
        raise AssertionError(f"the pool did not reach 8 opponents: {len(stats)} in the stats file")
    for f in ("rating_games.jsonl", "rating_metadata.json", "checkpoints/best"):
        if not (run / f).exists():
            raise AssertionError(f"vs-pool run wrote no {f}")
    share = series["train/learner_valid_fraction"]
    want = (E - EP + EP / 2) / E
    if len(share) != pool_updates or not all(abs(s - want) <= 0.02 for s in share):
        raise AssertionError(f"learner valid share {share} not within 0.02 of {want}")
    sps = series["perf/sps"]
    out.update(rotation_sizes=rotation_sizes, opponents_in_pool=len(stats),
               games_played=sum(x["games_played"] for x in stats),
               learner_valid_share=share, learner_valid_share_expected=want,
               current_elo=series["train/current_elo"], best_elo=series["train/best_elo"],
               env_steps_per_s_at_k8=sps[8:], policy_loss=series["train/policy_loss"])
    return out


def skull_points(series: dict, updates: int) -> list:
    """Per update, the four players' Swiss points summed: P (P - 1) / 2 =
    6 a game, so 6 on average over any set of finished games."""
    points = [sum(v) for v in zip(*(series[f"episode/player_{p}_points"] for p in range(4)))]
    if len(points) < updates - 1 or not all(abs(s - 6.0) <= 1e-4 for s in points):
        raise AssertionError(f"Swiss points per update do not sum to 6: {points}")
    return points


def skull_selfplay_train(tmp: Path, card_line: str) -> dict:
    """The bench_skull_ctde shape: Skull, four players, CTDE actor and
    critic 512x2 (tanh), 4096 envs x 64 steps, 4 epochs x 4 minibatches,
    no pool (configs/skull_ctde.toml's other settings)."""
    n = BENCH_UPDATES
    out, series = train_phase(
        tmp / "skull_selfplay",
        ["--config", str(ROOT / "configs" / "skull_ctde.toml"), "--opponent-pool-fraction", "0",
         "--num-envs", str(E), "--num-steps", str(T_C4), "--hidden-size", "512",
         "--num-hidden", "2", "--activation", "tanh", "--critic-hidden-size", "512",
         "--critic-num-hidden", "2", "--num-epochs", "4", "--num-minibatches", "4"],
        n, E * T_C4,
        {"skull_step_autoreset": n * T_C4, "masked_gumbel_sample": n * T_C4,
         "gae_multiplayer_reverse_scan": n},
        card_line,
    )
    out.update(points_sum=skull_points(series, n),
               player_points=[series[f"episode/player_{p}_points"] for p in range(4)],
               length_mean=series["episode/length_mean"], policy_loss=series["train/policy_loss"])
    return out


def skull_pool_train(tmp: Path, card_line: str) -> dict:
    """configs/skull_ctde.toml as users run it (CTDE 256x3 relu, pool
    fraction 0.3: L = 2867 learner envs, Ep = 1229 pool envs, three of the
    four seats of a pool env the opponents'), 4096 x 128, a checkpoint
    after every update, 10 updates: the rotation reaches K = 8."""
    n = POOL_UPDATES
    pool_updates = n - 1
    run = tmp / "skull_pool"
    out, series = train_phase(
        run, ["--config", str(ROOT / "configs" / "skull_ctde.toml"), "--num-envs", str(E)],
        n, E * T_SKULL_POOL,
        {"skull_step_autoreset": n * T_SKULL_POOL,
         "masked_gumbel_sample": (n + pool_updates) * T_SKULL_POOL,
         "opponent_actor_forward": pool_updates * T_SKULL_POOL,
         "gae_multiplayer_reverse_scan": n},
        card_line, checkpoint_freq=E * T_SKULL_POOL,
    )
    stats = json.loads((run / "opponent_stats.json").read_text())["opponents"]
    if len(stats) != n - 1:
        raise AssertionError(f"the pool did not reach 8 opponents: {len(stats)} in the stats file")
    for f in ("rating_games.jsonl", "rating_metadata.json", "checkpoints/best"):
        if not (run / f).exists():
            raise AssertionError(f"Skull vs-pool run wrote no {f}")
    share = series["train/learner_valid_fraction"]
    L = E - EP_SKULL
    lo, hi = L / E, (L + EP_SKULL / 2) / E
    if len(share) != pool_updates or not all(lo < s < hi for s in share):
        raise AssertionError(f"learner valid share {share} not strictly inside ({lo}, {hi})")
    sps = series["perf/sps"]
    out.update(rotation_sizes=[min(u - 1, 8) for u in range(1, n + 1)], opponents_in_pool=len(stats),
               games_played=sum(x["games_played"] for x in stats), learner_valid_share=share,
               learner_valid_share_bounds=[lo, hi], points_sum=skull_points(series, n),
               current_elo=series["train/current_elo"], env_steps_per_s_at_k8=sps[8:],
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
    skull, skull_mask, skull_obs = check_skull(dev, g)
    sample_a2 = check_sample(dev, g, 2)
    sample_a7 = check_sample(dev, g, 7)
    sample_a33 = check_sample(dev, g, 33, skull_mask)
    checks = {
        "cartpole_step_autoreset": check_cartpole(dev, g),
        "masked_gumbel_sample": {
            "A2": sample_a2, "A7": sample_a7, "A33_skull": sample_a33,
            "max_abs_err": max(s["max_abs_err"] for s in (sample_a2, sample_a7, sample_a33)),
            # A = 7's: Connect Four's, the pool path's
            **{k: sample_a7[k] for k in TIMES + ("library_ms", "bound_ms", "bound_by")},
        },
        "gae_reverse_scan": check_gae(dev, g),
        "connect_four_step_autoreset": check_connect_four(dev, g),
        "gae_multiplayer_reverse_scan": check_gae_multiplayer(dev, g),
        "obs_norm_apply": check_obs_norm_apply(dev, g),
        "obs_norm_update": check_obs_norm_update(dev, g),
        "opponent_actor_forward": check_opponent_actor(dev, g, skull_obs),
        "ppo_loss": check_ppo_loss(dev, g),
        "clip_adam": check_clip_adam(dev, g),
        "episode_stats": check_episode_stats(dev, g),
        "skull_step_autoreset": skull,
        "return_norm_roll": check_return_norm_roll(dev, g),
        "return_norm_finalize": check_return_norm_finalize(dev, g),
    }
    emit("kernels_vs_plain", card=card_line, **checks)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as d:
        runs = {
            "bench_train": bench_train(Path(d), card_line),
            "selfplay_train": selfplay_train(Path(d), card_line, "mlp", BENCH_UPDATES),
            "selfplay_train_cnn": selfplay_train(Path(d), card_line, "cnn", CNN_UPDATES),
            "selfplay_pool": selfplay_pool_train(Path(d), card_line),
            "skull_ctde_selfplay": skull_selfplay_train(Path(d), card_line),
            "skull_ctde_pool": skull_pool_train(Path(d), card_line),
        }
        for phase, out in runs.items():
            emit(phase, **out)
        emit("learning_bar", card=card_line, **learning_bar(Path(d)))

    # Launches: the sum over the six train phases, each counted from 0.
    table = [
        {
            "name": name, "route": "cuda", "source": SOURCES[name][0],
            "replaces": SOURCES[name][1],
            "launches": sum(r["launches"][name] for r in runs.values()),
            **{k: checks[name][k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                             "bound_by", "library_ms")},
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

"""Running normalizers (burn_ppo_tpu/ppo/normalization.py:36-209).

* ``ObsNormState`` — per-dimension Welford mean/var, applied LAGGED (the
  rollout uses the previous stats; the raw batch merges in after it),
  clipped, identity while count < 2. ``obs_norm_apply`` and
  ``obs_norm_update`` run their plain PyTorch versions for CPU tensors
  and launch the hand-written kernel K6 (``csrc/obs_norm.cu``, ROADMAP
  B3) for CUDA tensors, or raise.
* ``ReturnNormState`` — per-env, per-player rolling discounted returns;
  rewards are divided by the running std of those returns (variance
  only), clipped. ``return_norm_roll`` is the elementwise per-step half,
  on the acting player's slot;
  ``return_norm_finalize`` is one inclusive prefix pass over the whole
  [T, E] rollout in the reference's visitation order (step-major, env
  index), in shifted coordinates. Both run their plain PyTorch versions
  for CPU tensors and launch the hand-written kernel K12
  (``csrc/return_norm.cu``, ROADMAP B5) for CUDA tensors, or raise.

PopArt (``normalize_values``) is not ported (ROADMAP A14): no ported
config or checkpoint uses it. Stats are device tensors, so nothing here
waits for the device.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple

import torch

from burn_ppo_torch import kernels


def _welford_merge(mean_a, m2_a, count_a, mean_b, m2_b, count_b):
    """Merge two Welford accumulators (Chan et al.)."""
    total = count_a + count_b
    safe_total = torch.clamp(total, min=1.0)
    delta = mean_b - mean_a
    mean = mean_a + delta * (count_b / safe_total)
    m2 = m2_a + m2_b + torch.square(delta) * (count_a * count_b / safe_total)
    keep = count_b > 0
    return (
        torch.where(keep, mean, mean_a),
        torch.where(keep, m2, m2_a),
        torch.where(keep, total, count_a),
    )


@dataclass
class ObsNormState:
    mean: torch.Tensor  # [D]
    m2: torch.Tensor  # [D]
    count: torch.Tensor  # scalar

    @staticmethod
    def create(obs_dim: int, device: torch.device) -> "ObsNormState":
        z = torch.zeros(obs_dim, dtype=torch.float32, device=device)
        return ObsNormState(
            mean=z, m2=z.clone(), count=torch.zeros((), dtype=torch.float32, device=device)
        )


def obs_norm_update_plain(state: ObsNormState, batch: torch.Tensor) -> ObsNormState:
    """Plain PyTorch K6 update: merge a raw obs batch [..., D] into the
    running stats (normalization.py:68-75)."""
    flat = batch.reshape(-1, batch.shape[-1])
    n = torch.tensor(float(flat.shape[0]), dtype=torch.float32, device=flat.device)
    mean_b = torch.mean(flat, dim=0)
    m2_b = torch.sum(torch.square(flat - mean_b), dim=0)
    mean, m2, count = _welford_merge(state.mean, state.m2, state.count, mean_b, m2_b, n)
    return ObsNormState(mean=mean, m2=m2, count=count)


def obs_norm_apply_plain(state: ObsNormState, obs: torch.Tensor, clip: float = 10.0) -> torch.Tensor:
    """Plain PyTorch K6 apply: normalize obs [..., D]; identity until
    count >= 2 (normalization.py:78-83)."""
    var = state.m2 / torch.clamp(state.count, min=1.0)
    std = torch.clamp(torch.sqrt(var), min=1e-8)
    normalized = torch.clamp((obs - state.mean) / std, -clip, clip)
    return torch.where(state.count < 2.0, obs, normalized)


def _expect_state(state: ObsNormState, D: int) -> None:
    kernels.expect(state.mean, "mean", torch.float32, (D,))
    kernels.expect(state.m2, "m2", torch.float32, (D,))
    kernels.expect(state.count, "count", torch.float32, ())


def obs_norm_apply(state: ObsNormState, obs: torch.Tensor, clip: float = 10.0) -> torch.Tensor:
    """Normalize obs [..., D] with the running stats; identity until
    count >= 2. The count stays on the device."""
    if kernels.on_cpu(obs, state.mean, state.m2, state.count):
        return obs_norm_apply_plain(state, obs, clip)
    D = obs.shape[-1]
    kernels.expect(obs, "obs", torch.float32, obs.shape)
    _expect_state(state, D)
    out = torch.empty_like(obs)
    err = kernels.library().obs_norm_apply(
        kernels.ptr(obs), kernels.ptr(state.mean), kernels.ptr(state.m2),
        kernels.ptr(state.count), kernels.ptr(out), obs.numel() // max(D, 1), D,
        float(clip), kernels.stream(obs.device),
    )
    kernels.check(err, "obs_norm_apply")
    obs_norm_apply.launches += 1
    return out


obs_norm_apply.launches = 0

# Threads of the update's first pass: enough to stream the batch, at
# least 16 elements each.
_UPDATE_MAX_THREADS = 1056 * 256


def obs_norm_update(state: ObsNormState, batch: torch.Tensor) -> ObsNormState:
    """Merge a raw obs batch [..., D] into the running stats."""
    if kernels.on_cpu(batch, state.mean, state.m2, state.count):
        return obs_norm_update_plain(state, batch)
    D = batch.shape[-1]
    N = batch.numel() // max(D, 1)
    kernels.expect(batch, "batch", torch.float32, batch.shape)
    _expect_state(state, D)
    if N == 0:
        return state
    lanes = max(1, min(_UPDATE_MAX_THREADS, -(-N * D // 16)) // D)
    scratch = torch.empty(2 * lanes * D, dtype=torch.float64, device=batch.device)
    new = ObsNormState(mean=torch.empty_like(state.mean), m2=torch.empty_like(state.m2),
                       count=torch.empty_like(state.count))
    p = kernels.ptr
    err = kernels.library().obs_norm_update(
        p(batch), p(state.mean), p(state.m2), p(state.count), p(scratch),
        p(new.mean), p(new.m2), p(new.count), N, D, lanes, kernels.stream(batch.device),
    )
    kernels.check(err, "obs_norm_update")
    obs_norm_update.launches += 1
    return new


obs_norm_update.launches = 0


@dataclass
class ReturnNormState:
    returns: torch.Tensor  # [E, P] rolling discounted returns per player
    mean: torch.Tensor  # scalar Welford mean of observed rolling returns
    m2: torch.Tensor  # scalar
    count: torch.Tensor  # scalar

    @staticmethod
    def create(num_envs: int, num_players: int, device: torch.device) -> "ReturnNormState":
        def z():
            return torch.zeros((), dtype=torch.float32, device=device)

        return ReturnNormState(
            returns=torch.zeros(num_envs, num_players, dtype=torch.float32, device=device),
            mean=z(),
            m2=z(),
            count=z(),
        )


def return_norm_roll_plain(
    returns: torch.Tensor,  # [E, P] rolling discounted returns
    rewards: torch.Tensor,  # [E] acting player's raw rewards this step
    acting: torch.Tensor,  # [E] int player indices
    dones: torch.Tensor,  # [E] 1.0 / True where the episode ended
    gamma: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch K12 roll (normalization.py:105-133): update the acting
    player's rolling return, capture the post-update sample, reset the
    slot on done. Returns (new_returns [E, P], samples [E])."""
    slot = acting.long()[:, None]
    updated = returns.scatter(1, slot, torch.gather(returns, 1, slot) * gamma + rewards[:, None])
    samples = torch.gather(updated, 1, slot)[:, 0]
    reset = updated.scatter(1, slot, 0.0)
    return torch.where(dones[:, None] != 0, reset, updated), samples


def return_norm_roll(
    returns: torch.Tensor,
    rewards: torch.Tensor,
    acting: torch.Tensor,
    dones: torch.Tensor,
    gamma: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-step half on the acting player's slot. CPU tensors take the
    plain version; CUDA tensors launch K12's roll (one thread per env),
    or raise."""
    if kernels.on_cpu(returns, rewards, acting, dones):
        return return_norm_roll_plain(returns, rewards, acting, dones, gamma)
    E, P = returns.shape
    kernels.expect(returns, "returns", torch.float32, (E, P))
    kernels.expect(rewards, "rewards", torch.float32, (E,))
    kernels.expect(acting, "acting", torch.int32, (E,))
    kernels.expect(dones, "dones", torch.float32, (E,))
    new_returns, samples = torch.empty_like(returns), torch.empty_like(rewards)
    p = kernels.ptr
    err = kernels.library().return_norm_roll(
        p(returns), p(rewards), p(acting), p(dones), p(new_returns), p(samples), E, P,
        float(gamma), kernels.stream(returns.device))
    kernels.check(err, "return_norm_roll")
    return_norm_roll.launches += 1
    return new_returns, samples


return_norm_roll.launches = 0


def return_norm_finalize_f64_plain(
    state: ReturnNormState,
    samples: torch.Tensor,
    rewards: torch.Tensor,
    clip: float = 10.0,
    valid: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch K12 finalize: (the new mean, m2 and count in f64 [3],
    the normalized rewards like ``rewards``).

    Every position is normalized with the running stats INCLUDING its own
    sample, in row-major [T, E] order — the reference's global per-env
    sequential update — computed from inclusive prefix sums in
    coordinates shifted by the batch mean. With ``valid`` (the vs-pool
    rollout's learner turns) only those samples fold into the stats, and
    every reward is normalized with the prefix stats at its position
    (normalization.py:162-209); a batch with no valid sample leaves the
    stats exactly as they were.

    The closed form subtracts two prefix sums (``q_e - count_e * mean^2``)
    that nearly cancel while the count is small, so the prefix pass runs in
    float64, as the reference keeps its Welford accumulators in f64; the
    state stays f32 and the rewards are normalized in f32."""
    shape = rewards.shape
    f64 = torch.float64
    x = samples.reshape(-1).to(f64)
    r = rewards.reshape(-1)
    n = x.shape[0]
    count0, mean0, m20 = state.count.to(f64), state.mean.to(f64), state.m2.to(f64)
    if valid is None:
        n_valid = torch.tensor(float(n), dtype=f64, device=x.device)
        count_e = count0 + torch.arange(1, n + 1, dtype=f64, device=x.device)
        shift = torch.sum(x) / float(n)
        u = x - shift
        s_e = torch.cumsum(u, dim=0)
        q_e = torch.cumsum(torch.square(u), dim=0)
    else:
        w = valid.reshape(-1).to(f64)
        n_valid = torch.sum(w)
        count_e = count0 + torch.cumsum(w, dim=0)
        shift = torch.sum(x * w) / torch.clamp(n_valid, min=1.0)
        u = x - shift
        s_e = torch.cumsum(w * u, dim=0)
        q_e = torch.cumsum(w * torch.square(u), dim=0)
    safe_c = torch.clamp(count_e, min=1.0)
    base_u = mean0 - shift
    mean_u_e = (count0 * base_u + s_e) / safe_c
    m2_e = m20 + count0 * torch.square(base_u) + q_e - count_e * torch.square(mean_u_e)
    m2_e = torch.clamp(m2_e, min=0.0)  # tiny negatives from rounding

    std = torch.sqrt(m2_e / safe_c + 1e-8).to(r.dtype)
    normalized = torch.clamp(r / std, -clip, clip)
    normalized = torch.where(count_e < 2.0, r, normalized)
    stats = torch.where(n_valid > 0, torch.stack([mean_u_e[-1] + shift, m2_e[-1], count_e[-1]]),
                        torch.stack([mean0, m20, count0]))
    return stats, normalized.reshape(shape)


# Threads of a K12 finalize block, and the most blocks it uses.
_FINALIZE_THREADS = 256
_FINALIZE_MAX_BLOCKS = 1024


def return_norm_finalize_f64(
    state: ReturnNormState,
    samples: torch.Tensor,
    rewards: torch.Tensor,
    clip: float = 10.0,
    valid: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the new stats in f64 [3], normalized rewards). CPU tensors take the
    plain version; CUDA tensors launch K12's finalize (three passes: block
    moments for the shift, block sums in shifted coordinates, then each
    block's prefix from the earlier blocks' sums and a scan of its own
    elements, all in f64), or raise."""
    ts = [samples, rewards, state.mean, state.m2, state.count] + ([] if valid is None else [valid])
    if kernels.on_cpu(*ts):
        return return_norm_finalize_f64_plain(state, samples, rewards, clip, valid)
    shape = rewards.shape
    N = rewards.numel()
    x, r = samples.reshape(-1), rewards.reshape(-1)
    kernels.expect(x, "samples", torch.float32, (N,))
    kernels.expect(r, "rewards", torch.float32, (N,))
    w = None if valid is None else valid.reshape(-1)
    if w is not None:
        kernels.expect(w, "valid", torch.float32, (N,))
    for t, name in ((state.mean, "mean"), (state.m2, "m2"), (state.count, "count")):
        kernels.expect(t, name, torch.float32, ())
    dev = x.device
    T = _FINALIZE_THREADS
    G = max(1, min(_FINALIZE_MAX_BLOCKS, -(-N // (8 * T))))
    scratch = torch.empty(5 * G, dtype=torch.float64, device=dev)
    stats = torch.empty(3, dtype=torch.float64, device=dev)
    normalized = torch.empty_like(r)
    p = kernels.ptr
    err = kernels.library().return_norm_finalize(
        p(x), p(r), p(w), p(state.mean), p(state.m2), p(state.count), p(scratch), p(normalized),
        p(stats), N, G, float(clip), kernels.stream(dev))
    kernels.check(err, "return_norm_finalize")
    return_norm_finalize.launches += 1
    return stats, normalized.reshape(shape)


def _with_stats(state: ReturnNormState, stats: torch.Tensor) -> ReturnNormState:
    s32 = stats.to(state.mean.dtype)
    return replace(state, mean=s32[0], m2=s32[1], count=s32[2])


def return_norm_finalize(
    state: ReturnNormState,
    samples: torch.Tensor,  # [..., E] post-update rolling-return samples
    rewards: torch.Tensor,  # [..., E] raw rewards
    clip: float = 10.0,
    valid: Optional[torch.Tensor] = None,  # [..., E] learner-turn stats mask
) -> Tuple[ReturnNormState, torch.Tensor]:
    """Prefix-Welford stats + normalization for a whole rollout: (the state
    with the new f32 mean, m2 and count, normalized rewards like
    ``rewards``). ``state.returns`` passes through (``return_norm_roll``
    advanced it)."""
    stats, normalized = return_norm_finalize_f64(state, samples, rewards, clip, valid)
    return _with_stats(state, stats), normalized


return_norm_finalize.launches = 0

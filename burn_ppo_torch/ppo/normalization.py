"""Running normalizers (burn_ppo_tpu/ppo/normalization.py:36-209).

* ``ObsNormState`` — per-dimension Welford mean/var, applied LAGGED (the
  rollout uses the previous stats; the raw batch merges in after it),
  clipped, identity while count < 2. ``obs_norm_apply`` and
  ``obs_norm_update`` run their plain PyTorch versions for CPU tensors
  and launch the hand-written kernel K6 (``csrc/obs_norm.cu``, ROADMAP
  B3) for CUDA tensors, or raise. The update merges into the state in
  place, so that the stats keep their addresses from update to update (a
  CUDA graph of the update reads and writes them there).
* ``ReturnNormState`` — per-env, per-player rolling discounted returns;
  rewards are divided by the running std of those returns (variance
  only), clipped. ``return_norm_roll`` is the elementwise per-step half,
  on the acting player's slot;
  ``return_norm_finalize`` is one inclusive prefix pass over the whole
  [T, E] rollout in the reference's visitation order (step-major, env
  index), in shifted coordinates. Both run their plain PyTorch versions
  for CPU tensors and launch the hand-written kernel K12
  (``csrc/return_norm.cu``, ROADMAP B5) for CUDA tensors, or raise.
  On CartPole's path the roll is folded into the env step (K1,
  ``envs/cartpole.py``). The finalize's f64 scratch is made once, with
  the state (``ReturnNormState.scratch``), so no call allocates it.

* ``PopArtState`` — PopArt's value normalizer (``normalize_values``,
  normalization.py:243-317): a scalar Welford mean and M2 of the raw
  returns. The critic learns normalized values; the rollout and the
  bootstrap denormalize its outputs (``popart_denormalize``, kernel K16,
  ``csrc/popart.cu``), and once per update ``popart_update_rescale``
  merges the batch's valid returns into the stats and rescales the value
  head in place so that its denormalized outputs are unchanged (kernel
  K15, one cooperative launch; ROADMAP B18). The loss normalizes the
  returns and old values with the new stats inside K8
  (``ppo/update.py``). ``popart_update``, ``popart_normalize``,
  ``popart_denormalize_plain`` and ``popart_rescale_value_head`` are the
  JAX package's functions in plain PyTorch.

Stats are device tensors, so nothing here waits for the device.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
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
    running stats in place (normalization.py:68-75); returns ``state``."""
    flat = batch.reshape(-1, batch.shape[-1])
    n = torch.full((), float(flat.shape[0]), dtype=torch.float32, device=flat.device)
    mean_b = torch.mean(flat, dim=0)
    m2_b = torch.sum(torch.square(flat - mean_b), dim=0)
    merged = _welford_merge(state.mean, state.m2, state.count, mean_b, m2_b, n)
    for dst, src in zip((state.mean, state.m2, state.count), merged):
        dst.copy_(src)
    return state


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
    count >= 2. The count stays on the device. The kernel takes any
    4-byte aligned start; it refuses a D past its shared-memory column
    table (``csrc/obs_norm.cu`` MAX_APPLY_DIM)."""
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


kernels.counted(obs_norm_apply)

# Threads of the update's first pass: enough to stream the batch, at
# least 16 elements each.
_UPDATE_MAX_THREADS = 1056 * 256


def obs_norm_update(state: ObsNormState, batch: torch.Tensor) -> ObsNormState:
    """Merge a raw obs batch [..., D] into the running stats in place;
    returns ``state``."""
    if kernels.on_cpu(batch, state.mean, state.m2, state.count):
        return obs_norm_update_plain(state, batch)
    D = batch.shape[-1]
    N = batch.numel() // max(D, 1)
    kernels.expect(batch, "batch", torch.float32, batch.shape)
    _expect_state(state, D)
    if N == 0:
        return state
    lanes = max(1, min(_UPDATE_MAX_THREADS, -(-N * D // 16)) // D)
    # Two partials a lane and column, then the old count (csrc/obs_norm.cu).
    scratch = torch.empty(2 * lanes * D + 1, dtype=torch.float64, device=batch.device)
    p = kernels.ptr
    err = kernels.library().obs_norm_update(
        p(batch), p(state.mean), p(state.m2), p(state.count), p(scratch), N, D, lanes,
        kernels.stream(batch.device),
    )
    kernels.check(err, "obs_norm_update")
    obs_norm_update.launches += 1
    return state


kernels.counted(obs_norm_update)


@dataclass
class ReturnNormState:
    returns: torch.Tensor  # [E, P] rolling discounted returns per player
    mean: torch.Tensor  # scalar Welford mean of observed rolling returns
    m2: torch.Tensor  # scalar
    count: torch.Tensor  # scalar
    # K12 finalize's f64 scratch on a CUDA device (return_norm_scratch),
    # carried from state to state; None on the CPU. Marked as scratch:
    # holds nothing between calls, so a copy of the state shares it.
    scratch: Optional[torch.Tensor] = field(default=None, metadata={"scratch": True})

    @staticmethod
    def create(num_envs: int, num_players: int, device: torch.device) -> "ReturnNormState":
        def z():
            return torch.zeros((), dtype=torch.float32, device=device)

        return ReturnNormState(
            returns=torch.zeros(num_envs, num_players, dtype=torch.float32, device=device),
            mean=z(),
            m2=z(),
            count=z(),
            scratch=return_norm_scratch(torch.device(device)),
        )


def return_norm_scratch(device: torch.device) -> Optional[torch.Tensor]:
    """K12 finalize's f64 scratch on a CUDA ``device``: two block sums and
    three more per block of the largest grid it launches there; None on
    the CPU."""
    if device.type == "cpu":
        return None
    with torch.cuda.device(device):
        n = kernels.library().return_norm_finalize_scratch_len()
    if n < 1:
        raise RuntimeError(f"return_norm_finalize: no resident grid on {device}")
    return torch.empty(n, dtype=torch.float64, device=device)


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


kernels.counted(return_norm_roll)


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


def return_norm_finalize_f64(
    state: ReturnNormState,
    samples: torch.Tensor,
    rewards: torch.Tensor,
    clip: float = 10.0,
    valid: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the new stats in f64 [3], normalized rewards). CPU tensors take the
    plain version; CUDA tensors launch K12's finalize (one cooperative
    launch: block moments for the shift, block sums in shifted coordinates,
    then each block's prefix and a scan of its own elements, all in f64,
    with ``state.scratch`` as its scratch), or raise."""
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
    scratch = state.scratch
    if scratch is None or scratch.device != x.device:
        raise ValueError("return_norm_finalize: CUDA tensors need the state's scratch on their "
                         "device (ReturnNormState.create, return_norm_scratch)")
    kernels.expect(scratch, "scratch", torch.float64, (scratch.numel(),))
    dev = x.device
    stats = torch.empty(3, dtype=torch.float64, device=dev)
    normalized = torch.empty_like(r)
    p = kernels.ptr
    err = kernels.library().return_norm_finalize(
        p(x), p(r), p(w), p(state.mean), p(state.m2), p(state.count), p(scratch),
        scratch.numel(), p(normalized), p(stats), N, float(clip), kernels.stream(dev))
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


kernels.counted(return_norm_finalize)


# ---------------------------------------------------------------------------
# PopArt value normalizer
# ---------------------------------------------------------------------------
POPART_EPS = 1e-4


@dataclass
class PopArtState:
    """Scalar Welford stats of the raw returns, 0-dim f32 tensors made
    once: the update merges into them in place, so the rollout and update
    graphs read them where they were captured."""

    mean: torch.Tensor
    m2: torch.Tensor
    count: torch.Tensor
    # K15's f64 scratch on a CUDA device (popart_scratch); None on the
    # CPU. Holds nothing between calls, so a copy of the state shares it.
    scratch: Optional[torch.Tensor] = field(default=None, metadata={"scratch": True})

    @staticmethod
    def create(device: torch.device) -> "PopArtState":
        def z():
            return torch.zeros((), dtype=torch.float32, device=device)

        return PopArtState(mean=z(), m2=z(), count=z(),
                           scratch=popart_scratch(torch.device(device)))

    @property
    def std(self) -> torch.Tensor:
        """1.0 before 2 samples (normalization.rs:313-320); a device
        expression."""
        s = torch.sqrt(self.m2 / torch.clamp(self.count, min=1.0) + POPART_EPS)
        return torch.where(self.count < 2.0, torch.ones_like(s), s)

    @property
    def initialized(self) -> torch.Tensor:
        return self.count >= 2.0


def popart_scratch(device: torch.device) -> Optional[torch.Tensor]:
    """K15's f64 scratch on a CUDA ``device``: three block sums per block
    of the largest grid it launches there; None on the CPU."""
    if device.type == "cpu":
        return None
    with torch.cuda.device(device):
        n = kernels.library().popart_update_scratch_len()
    if n < 1:
        raise RuntimeError(f"popart_update_rescale: no resident grid on {device}")
    return torch.empty(n, dtype=torch.float64, device=device)


def _batch_moments(returns: torch.Tensor, mask: Optional[torch.Tensor]):
    """(n, mean, m2) of the valid returns, each f32: the sums in double,
    the mean rounded to f32 before the squares about it are summed (JAX
    forms every sum in f32)."""
    x = returns.reshape(-1).to(torch.float64)
    w = torch.ones_like(x) if mask is None else mask.reshape(-1).to(torch.float64)
    n = torch.sum(w)
    mean_b = (torch.sum(x * w) / torch.clamp(n, min=1.0)).to(torch.float32)
    m2_b = torch.sum(torch.square(x - mean_b.to(torch.float64)) * w).to(torch.float32)
    return n.to(torch.float32), mean_b, m2_b


def popart_update(state: PopArtState, returns: torch.Tensor,
                  mask: Optional[torch.Tensor] = None
                  ) -> Tuple[PopArtState, torch.Tensor, torch.Tensor]:
    """Merge a batch of raw returns: (the new state, the old mean, the old
    std), new tensors; ``state`` is not written (normalization.py:271-285)."""
    n, mean_b, m2_b = _batch_moments(returns, mask)
    mean, m2, count = _welford_merge(state.mean, state.m2, state.count, mean_b, m2_b, n)
    return (PopArtState(mean=mean, m2=m2, count=count, scratch=state.scratch),
            state.mean.clone(), state.std)


def popart_normalize(state: PopArtState, x: torch.Tensor) -> torch.Tensor:
    return torch.where(state.initialized, (x - state.mean) / state.std, x)


def popart_denormalize_plain(state: PopArtState, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K16: ``x * std + mean`` once initialized."""
    return torch.where(state.initialized, x * state.std + state.mean, x)


def popart_rescale_value_head(kernel: torch.Tensor, bias: torch.Tensor, old_mean: torch.Tensor,
                              old_std: torch.Tensor, new_mean: torch.Tensor,
                              new_std: torch.Tensor, do_rescale: torch.Tensor):
    """W' = W * s_old/s_new ; b' = (b*s_old + mu_old - mu_new)/s_new, where
    ``do_rescale`` (normalization.py:297-317, reference src/ppo.rs:1599-1653):
    the denormalized outputs survive the stats shift."""
    new_kernel = kernel * (old_std / new_std)
    new_bias = (bias * old_std + old_mean - new_mean) / new_std
    return (torch.where(do_rescale, new_kernel, kernel), torch.where(do_rescale, new_bias, bias))


def popart_update_rescale_plain(state: PopArtState, returns: torch.Tensor, valid: torch.Tensor,
                                kernel: torch.Tensor, bias: torch.Tensor) -> None:
    """Plain PyTorch K15, in place: ``popart_update`` on the valid raw
    returns, then the value head (``kernel`` [H, 1], ``bias`` [1]) rescaled
    where the new state is initialized (update.py:241-257)."""
    new, old_mean, old_std = popart_update(state, returns, valid)
    head = popart_rescale_value_head(kernel, bias, old_mean, old_std, new.mean, new.std,
                                     new.initialized)
    with torch.no_grad():
        for dst, src in zip((kernel, bias, state.mean, state.m2, state.count),
                            (*head, new.mean, new.m2, new.count)):
            dst.copy_(src)


def popart_update_rescale(state: PopArtState, returns: torch.Tensor, valid: torch.Tensor,
                          kernel: torch.Tensor, bias: torch.Tensor) -> None:
    """Merge the batch's valid raw returns ([N] f32, ``valid`` [N] f32)
    into ``state`` and rescale the value head (``kernel`` [H, 1], ``bias``
    [1], views of the parameters' storage) in place. CPU tensors take the
    plain version; CUDA tensors launch K15 (one cooperative launch, the
    state's scratch), or raise. Nothing is allocated, so a CUDA graph can
    capture it."""
    ts = [returns, valid, kernel, bias, state.mean, state.m2, state.count]
    if kernels.on_cpu(*ts):
        return popart_update_rescale_plain(state, returns, valid, kernel, bias)
    N, H = returns.numel(), kernel.numel()
    kernels.expect(returns, "returns", torch.float32, (N,))
    kernels.expect(valid, "valid", torch.float32, (N,))
    kernels.expect(kernel, "kernel", torch.float32, (H, 1))
    kernels.expect(bias, "bias", torch.float32, (1,))
    for t, name in ((state.mean, "mean"), (state.m2, "m2"), (state.count, "count")):
        kernels.expect(t, name, torch.float32, ())
    scratch = state.scratch
    if scratch is None or scratch.device != returns.device:
        raise ValueError("popart_update_rescale: CUDA tensors need the state's scratch on "
                         "their device (PopArtState.create)")
    kernels.expect(scratch, "scratch", torch.float64, (scratch.numel(),))
    p = kernels.ptr
    err = kernels.library().popart_update(
        p(returns), p(valid), N, p(state.mean), p(state.m2), p(state.count), p(kernel), p(bias),
        H, p(scratch), scratch.numel(), kernels.stream(returns.device))
    kernels.check(err, "popart_update")
    popart_update_rescale.launches += 1


kernels.counted(popart_update_rescale)


def popart_denormalize(state: PopArtState, x: torch.Tensor,
                       out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x * std + mean`` once initialized, into ``out`` (a new tensor
    when None; it may be a view, such as a step's slice of the rollout's
    values). CPU tensors take the plain version; CUDA tensors launch K16
    (a thread an element), or raise."""
    ts = [x, state.mean, state.m2, state.count] + ([] if out is None else [out])
    if kernels.on_cpu(*ts):
        y = popart_denormalize_plain(state, x)
        return y if out is None else out.copy_(y)
    n = x.numel()
    kernels.expect(x, "x", torch.float32, x.shape)
    if out is None:
        out = torch.empty_like(x)
    kernels.expect(out, "out", torch.float32, x.shape)
    for t, name in ((state.mean, "mean"), (state.m2, "m2"), (state.count, "count")):
        kernels.expect(t, name, torch.float32, ())
    p = kernels.ptr
    err = kernels.library().popart_denormalize(
        p(x), p(state.mean), p(state.m2), p(state.count), p(out), n, kernels.stream(x.device))
    kernels.check(err, "popart_denormalize")
    popart_denormalize.launches += 1
    return out


kernels.counted(popart_denormalize)

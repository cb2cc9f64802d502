"""PPO update: epochs of shuffled minibatches, with kernels K8 and K9.

Counterpart of burn_ppo_tpu/ppo/update.py:71-431:

  * per-epoch shuffle of row tiles (``resolve_shuffle_block`` semantics),
    every epoch's permutation drawn up front as the reference splits its
    epoch keys up front;
  * the loss after the network forward (``ppo_loss``: per-minibatch
    Bessel advantage normalization, clipped surrogate, optional value
    clip, entropy bonus, the 14 ``METRIC_KEYS``, and dL/dlogits and
    dL/dvalues written in the forward) through a ``torch.autograd.Function``
    whose CUDA path is kernel K8 (``csrc/ppo_loss.cu``); the network's
    own backward (cuBLAS) takes it from there;
  * global-norm clip then Adam over every parameter at once
    (``clip_adam``, kernel K9, ``csrc/clip_adam.cu``): the network's
    parameters and their ``.grad`` are views of two flat buffers
    (``flat_parameters``), the moments two more; optax's formulas (the clip leaves gradients alone
    below ``max_grad_norm`` and scales them by max/norm above it — not
    ``clip_grad_norm_``'s max/(norm+1e-6)); the step is ``p - lr * u``;
  * KL early stop that still applies the offending minibatch;
  * an uneven N % num_minibatches split padded with copies of real rows
    whose valid flag is 0; a minibatch with no valid row (all pad, or all
    opponent turns on the vs-pool path: ``may_have_invalid``) is skipped,
    decided for every epoch at once from one device-to-host copy;
  * the 14 metrics averaged over the minibatches run, plus the explained
    variance.

The TPU-only packed [N, C] buffer and its 128-lane pad are not carried
over: rows are gathered per field with one index tensor.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from burn_ppo_torch import kernels
from burn_ppo_torch.ops.categorical import apply_action_mask, entropy_from_logp, log_prob_from_logp
from burn_ppo_torch.ops.gae import compute_explained_variance
from burn_ppo_torch.ppo.rollout import RandomSource


@dataclass(frozen=True)
class PPOUpdateConfig:
    clip_epsilon: float = 0.2
    clip_value: bool = False
    value_coef: float = 0.5
    max_grad_norm: float = 0.5
    num_epochs: int = 4
    num_minibatches: int = 4
    target_kl: Optional[float] = None
    adam_epsilon: float = 1e-5
    shuffle_block_rows: int = 0


ADAM_B1 = 0.9
ADAM_B2 = 0.999


def resolve_shuffle_block(n: int, mb_size: int, requested: int) -> int:
    """Largest power-of-2 tile size <= target that divides mb_size."""
    if requested == 1:
        return 1
    target = requested if requested > 1 else max(1, min(128, n // 16384))
    r = 1
    while r * 2 <= target and mb_size % (r * 2) == 0:
        r *= 2
    return r


def flat_parameters(network: torch.nn.Module) -> Tuple[torch.Tensor, torch.Tensor]:
    """Moves every parameter of ``network`` into one contiguous buffer in
    ``parameters()`` order (each parameter becomes a view of it) and gives
    each a ``.grad`` that views a second, zeroed buffer of the same
    layout, which ``backward()`` then accumulates into. Returns the two
    buffers."""
    params = list(network.parameters())
    flat = torch.cat([prm.detach().reshape(-1) for prm in params])
    grads = torch.zeros_like(flat)
    off = 0
    for prm in params:
        prm.data = flat[off:off + prm.numel()].view_as(prm)
        prm.grad = grads[off:off + prm.numel()].view_as(prm)
        off += prm.numel()
    return flat, grads


def _named_views(network: torch.nn.Module, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
    out, off = {}, 0
    for name, prm in network.named_parameters():
        out[name] = flat[off:off + prm.numel()].view_as(prm)
        off += prm.numel()
    return out


@dataclass
class AdamState:
    """optax ``chain(clip_by_global_norm, scale_by_adam)`` state: the step
    count and the two moments, beside the network's flat parameter and
    gradient buffers (``flat_parameters``, made once here). The moments
    are flat buffers of the same layout; ``mu`` and ``nu`` view them by
    parameter name. The count is a host integer: it changes only where
    the host decides that a minibatch runs. ``partial`` is K9's scratch
    on a CUDA device (``clip_adam_scratch``), made once here so that no
    step allocates; None on the CPU."""

    count: int
    flat_params: torch.Tensor
    flat_grads: torch.Tensor
    flat_mu: torch.Tensor
    flat_nu: torch.Tensor
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    partial: Optional[torch.Tensor] = None

    @staticmethod
    def create(network: torch.nn.Module) -> "AdamState":
        flat, grads = flat_parameters(network)
        mu, nu = torch.zeros_like(flat), torch.zeros_like(flat)
        return AdamState(count=0, flat_params=flat, flat_grads=grads, flat_mu=mu, flat_nu=nu,
                         mu=_named_views(network, mu), nu=_named_views(network, nu),
                         partial=clip_adam_scratch(flat.device))


def clip_adam_scratch(device: torch.device) -> Optional[torch.Tensor]:
    """K9's f64 scratch on a CUDA ``device``, one partial per block of the
    largest grid it launches there; None on the CPU."""
    if device.type == "cpu":
        return None
    with torch.cuda.device(device):
        n = kernels.library().clip_adam_scratch_len()
    if n < 1:
        raise RuntimeError(f"clip_adam: no resident grid on {device}")
    return torch.empty(n, dtype=torch.float64, device=device)


def clip_adam_plain(params: torch.Tensor, grads: torch.Tensor, mu: torch.Tensor,
                    nu: torch.Tensor, *, lr: float, max_grad_norm: float, eps: float,
                    bc1: float, bc2: float) -> None:
    """Plain PyTorch K9, in place on flat buffers."""
    g_norm = torch.sqrt(torch.sum(torch.square(grads)))
    g = torch.where(g_norm < max_grad_norm, grads, (grads / g_norm) * max_grad_norm)
    mu.copy_((1 - ADAM_B1) * g + ADAM_B1 * mu)
    nu.copy_((1 - ADAM_B2) * torch.square(g) + ADAM_B2 * nu)
    u = (mu / bc1) / (torch.sqrt(nu / bc2) + eps)
    params.sub_(lr * u)


def clip_adam(params: torch.Tensor, grads: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor,
              *, lr: float, max_grad_norm: float, eps: float, bc1: float, bc2: float,
              partial: Optional[torch.Tensor] = None) -> None:
    """Global-norm clip + Adam + ``p -= lr * u`` over flat buffers, in
    place. CPU tensors take the plain version; CUDA tensors launch K9
    (one launch; the norm stays on the device) with ``partial`` as its
    scratch (``clip_adam_scratch``; the four buffers 16-byte aligned), or
    raise. The launch allocates nothing, so a CUDA graph can capture it."""
    if kernels.on_cpu(params, grads, mu, nu):
        return clip_adam_plain(params, grads, mu, nu, lr=lr, max_grad_norm=max_grad_norm,
                               eps=eps, bc1=bc1, bc2=bc2)
    n = params.numel()
    for t, name in ((params, "params"), (grads, "grads"), (mu, "mu"), (nu, "nu")):
        kernels.expect(t, name, torch.float32, (n,))
        kernels.expect_rows16(t, name)
    if partial is None or partial.device != params.device:
        raise ValueError("clip_adam: CUDA buffers need K9's scratch on their device "
                         "(clip_adam_scratch)")
    kernels.expect(partial, "partial", torch.float64, (partial.numel(),))
    p = kernels.ptr
    err = kernels.library().clip_adam(
        p(params), p(grads), p(mu), p(nu), p(partial), n, partial.numel(), float(lr),
        float(max_grad_norm), float(eps), ADAM_B1, ADAM_B2, 1 - ADAM_B1, 1 - ADAM_B2,
        float(bc1), float(bc2), kernels.stream(params.device),
    )
    kernels.check(err, "clip_adam")
    clip_adam.launches += 1


kernels.counted(clip_adam)


def clip_and_adam_step(opt: AdamState, lr: float, cfg: PPOUpdateConfig) -> None:
    """Global-norm clip + Adam + ``p -= lr * u`` of every parameter, in
    place, from the gradients in ``opt.flat_grads``."""
    opt.count += 1
    with torch.no_grad():
        clip_adam(opt.flat_params, opt.flat_grads, opt.flat_mu, opt.flat_nu,
                  lr=lr, max_grad_norm=cfg.max_grad_norm, eps=cfg.adam_epsilon,
                  bc1=1.0 - ADAM_B1 ** opt.count, bc2=1.0 - ADAM_B2 ** opt.count,
                  partial=opt.partial)


def _wmean(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return torch.sum(x * w) / torch.clamp(torch.sum(w), min=1e-8)


def _wstd(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Bessel-corrected (sample) std over valid rows (utils.rs:86)."""
    m = _wmean(x, w)
    n = torch.sum(w)
    ss = torch.sum(torch.square(x - m) * w)
    return torch.sqrt(ss / torch.clamp(n - 1.0, min=1.0))


METRIC_KEYS = (
    "policy_loss",
    "value_loss",
    "entropy",
    "approx_kl",
    "clip_fraction",
    "total_loss",
    "value_mean",
    "returns_mean",
    "adv_mean_raw",
    "adv_std_raw",
    "value_error_mean",
    "value_error_std",
    "avg_valid_actions",
    "entropy_valid_pct",
)

# The minibatch columns the loss reads besides the network's outputs.
LOSS_FIELDS = ("actions", "old_log_probs", "advantages", "returns", "old_values", "valid")


def _jax_max(a: torch.Tensor, b: torch.Tensor):
    """``jnp.maximum(a, b)`` and the shares of its gradient (1/2 each at a tie)."""
    half = torch.where(a == b, 0.5, 0.0)
    return torch.maximum(a, b), torch.where(a > b, 1.0, half), torch.where(b > a, 1.0, half)


def _jax_clip(x: torch.Tensor, lo: float, hi: float):
    """``jnp.clip(x, lo, hi) = minimum(hi, maximum(lo, x))`` and its
    derivative (1/2 at either bound)."""
    m1 = torch.clamp(x, min=lo)
    d1 = torch.where(x > lo, 1.0, torch.where(x == lo, 0.5, 0.0))
    m2 = torch.clamp(m1, max=hi)
    d2 = torch.where(m1 < hi, 1.0, torch.where(m1 == hi, 0.5, 0.0))
    return m2, d1 * d2


def ppo_loss_plain(
    logits: torch.Tensor,
    values: torch.Tensor,
    mb: Dict[str, torch.Tensor],
    ent_coef: float,
    cfg: PPOUpdateConfig,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch K8: (loss, the 14 metrics [14], dL/dlogits [M, A],
    dL/dvalues [M]) of one minibatch, from the network's logits [M, A] and
    values [M] (burn_ppo_tpu/ppo/update.py:125-212 under value_and_grad,
    with JAX's gradient rules at ties)."""
    w = mb["valid"]
    mask = mb.get("action_masks")
    logp = torch.log_softmax(apply_action_mask(logits, mask), dim=-1)
    p = torch.exp(logp)
    actions = mb["actions"].long()
    new_log_probs = log_prob_from_logp(logp, actions)
    entropy = entropy_from_logp(logp)
    log_ratio = new_log_probs - mb["old_log_probs"]
    ratio = torch.exp(log_ratio)

    adv = mb["advantages"]
    wc = torch.clamp(torch.sum(w), min=1e-8)
    adv_mean = _wmean(adv, w)
    adv_std = _wstd(adv, w)
    adv_n = (adv - adv_mean) / (adv_std + 1e-8)

    eps = cfg.clip_epsilon
    r_clipped, d_clip = _jax_clip(ratio, 1.0 - eps, 1.0 + eps)
    pmax, g1, g2 = _jax_max(-adv_n * ratio, -adv_n * r_clipped)
    policy_loss = torch.sum(pmax * w) / wc
    dpmax_dr = g1 * -adv_n + g2 * (-adv_n * d_clip)

    returns = mb["returns"]
    if cfg.clip_value:
        old_values = mb["old_values"]
        dv, dv_clip = _jax_clip(values - old_values, -eps, eps)
        e1, e2 = values - returns, (old_values + dv) - returns
        vl, h1, h2 = _jax_max(torch.square(e1), torch.square(e2))
        dvl = h1 * (2.0 * e1) + h2 * (2.0 * e2 * dv_clip)
    else:
        e1 = values - returns
        vl, dvl = torch.square(e1), 2.0 * e1
    value_loss = 0.5 * (torch.sum(vl * w) / wc)
    entropy_mean = torch.sum(entropy * w) / wc
    loss = policy_loss + value_loss * cfg.value_coef - entropy_mean * ent_coef

    coef = w / wc
    dvalues = cfg.value_coef * 0.5 * coef * dvl
    onehot = torch.nn.functional.one_hot(actions, logits.shape[-1]).to(logits.dtype)
    dlogits = (dpmax_dr * ratio * coef)[:, None] * (onehot - p) + (ent_coef * coef)[:, None] * (
        torch.where(p > 0, p * (logp + entropy[:, None]), 0.0))

    value_errors = torch.abs(values - returns)
    metrics = [
        policy_loss, value_loss, entropy_mean,
        _wmean((ratio - 1.0) - log_ratio, w),
        _wmean((torch.abs(ratio - 1.0) > eps).to(torch.float32), w),
        loss, _wmean(values, w), _wmean(returns, w), adv_mean, adv_std,
        _wmean(value_errors, w), _wstd(value_errors, w),
    ]
    if mask is not None:
        valid_counts = torch.sum(mask, dim=-1)
        has_choice = (valid_counts > 1.0).to(torch.float32) * w
        max_ent = torch.log(torch.clamp(valid_counts, min=1.0 + 1e-8))
        metrics += [
            _wmean(valid_counts, w),
            torch.sum(entropy / torch.clamp(max_ent, min=1e-8) * has_choice)
            / torch.clamp(torch.sum(has_choice), min=1e-8),
        ]
    else:
        metrics += [torch.zeros((), device=w.device)] * 2
    return loss, torch.stack(metrics), dlogits, dvalues


# K8's widest row (csrc/ppo_loss.cu: 8 lanes a row, 8 entries a lane).
_LOSS_MAX_ACTIONS = 64


def ppo_loss_forward(
    logits: torch.Tensor,
    values: torch.Tensor,
    mb: Dict[str, torch.Tensor],
    ent_coef: float,
    cfg: PPOUpdateConfig,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(loss, metrics [14], dL/dlogits, dL/dvalues) of one minibatch. CPU
    tensors take the plain version; CUDA tensors launch K8 (two launches:
    the advantage statistics, then the rows with the last block's
    finalize), or raise."""
    mask = mb.get("action_masks")
    cols = [mb[k] for k in LOSS_FIELDS]
    ts = [logits, values, *cols] + ([] if mask is None else [mask])
    if kernels.on_cpu(*ts):
        return ppo_loss_plain(logits, values, mb, ent_coef, cfg)
    M, A = logits.shape
    if not 1 <= A <= _LOSS_MAX_ACTIONS:
        raise ValueError(f"ppo_loss: the kernel takes 1 to {_LOSS_MAX_ACTIONS} actions, got {A}")
    kernels.expect(logits, "logits", torch.float32, (M, A))
    kernels.expect(values, "values", torch.float32, (M,))
    if mask is not None:
        kernels.expect(mask, "action_masks", torch.float32, (M, A))
    for k, t in zip(LOSS_FIELDS, cols):
        kernels.expect(t, k, torch.int32 if k == "actions" else torch.float32, (M,))
    dev = logits.device
    lib = kernels.library()
    scratch = torch.empty(lib.ppo_loss_scratch_len(), dtype=torch.float64, device=dev)
    out = torch.empty(15, dtype=torch.float32, device=dev)
    dlogits = torch.empty_like(logits)
    dvalues = torch.empty_like(values)
    eps = cfg.clip_epsilon
    p = kernels.ptr
    err = lib.ppo_loss_forward(
        p(logits), p(values), p(mask), *(p(t) for t in cols), M, A, float(eps),
        float(1.0 - eps), float(1.0 + eps), int(cfg.clip_value), float(cfg.value_coef),
        float(ent_coef), p(scratch), p(out), p(dlogits), p(dvalues), kernels.stream(dev),
    )
    kernels.check(err, "ppo_loss_forward")
    ppo_loss.launches += 1
    return out[0], out[1:], dlogits, dvalues


class _PPOLoss(torch.autograd.Function):
    """The loss as one autograd node: the gradients are computed in the
    forward and the backward scales them."""

    @staticmethod
    def forward(ctx, logits, values, mb, ent_coef, cfg):
        loss, metrics, dlogits, dvalues = ppo_loss_forward(
            logits.detach(), values.detach(), mb, ent_coef, cfg)
        ctx.save_for_backward(dlogits, dvalues)
        ctx.mark_non_differentiable(metrics)
        return loss, metrics

    @staticmethod
    def backward(ctx, g_loss, _g_metrics):
        dlogits, dvalues = ctx.saved_tensors
        return g_loss * dlogits, g_loss * dvalues, None, None, None


def ppo_loss(
    logits: torch.Tensor,
    values: torch.Tensor,
    mb: Dict[str, torch.Tensor],
    ent_coef: float,
    cfg: PPOUpdateConfig,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scalar loss (differentiable in ``logits`` and ``values``) and the 14
    metrics [14] in ``METRIC_KEYS`` order."""
    mb = {k: mb[k].contiguous() for k in LOSS_FIELDS + ("action_masks",) if mb.get(k) is not None}
    return _PPOLoss.apply(logits.contiguous(), values.contiguous(), mb, ent_coef, cfg)


kernels.counted(ppo_loss)


def minibatch_loss(
    network: torch.nn.Module,
    mb: Dict[str, torch.Tensor],
    ent_coef: float,
    cfg: PPOUpdateConfig,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scalar loss (with autograd graph) + the detached metrics [14] in
    ``METRIC_KEYS`` order for one minibatch
    (burn_ppo_tpu/ppo/update.py:125-212); a CTDE network's values are its
    critic's on the minibatch's privileged obs."""
    logits, values = network(mb["obs"], mb.get("privileged_obs"))
    return ppo_loss(logits, values, mb, ent_coef, cfg)


def ppo_update(
    network: torch.nn.Module,
    opt: AdamState,
    data: Dict[str, torch.Tensor],
    rng: RandomSource,
    lr: float,
    ent_coef: float,
    cfg: PPOUpdateConfig,
    may_have_invalid: bool = False,
) -> Dict[str, torch.Tensor]:
    """num_epochs x num_minibatches PPO steps on flattened [N, ...] data
    (obs already normalized, actions, old_log_probs, advantages, returns,
    old_values, valid, optional action_masks and privileged_obs, which the
    shuffle carries like every other column). Updates ``network`` and
    ``opt`` in place; returns the metrics as device scalars.

    ``may_have_invalid``: the valid column carries real zeros (vs-pool
    rollouts mark opponent turns invalid), so a minibatch can have no
    valid row even without padding; such minibatches are skipped."""
    N = data["actions"].shape[0]
    nmb = cfg.num_minibatches
    mb_size = N // nmb
    if mb_size == 0:
        raise ValueError(f"batch size {N} < num_minibatches {nmb}")
    if N % nmb:
        mb_size = -(-N // nmb)
    pad = nmb * mb_size - N
    can_be_empty = pad >= mb_size or may_have_invalid
    device = data["actions"].device

    fields = {k: v for k, v in data.items() if v is not None}
    if pad:
        # Wrapped copies of real rows with valid = 0: every reduction is
        # valid-weighted, so a minibatch averages over its real rows only.
        fields = {k: torch.cat([v, v[:pad]]) for k, v in fields.items()}
        fields["valid"][N:] = 0.0
    R = resolve_shuffle_block(nmb * mb_size, mb_size, cfg.shuffle_block_rows)
    num_blocks = (nmb * mb_size) // R
    within = torch.arange(R, device=device)
    epoch_rows = [(rng.permutation(num_blocks).to(device)[:, None] * R + within).reshape(nmb, mb_size)
                  for _ in range(cfg.num_epochs)]
    if can_be_empty:
        # One transfer for every epoch's decision (valid sums of 0/1 flags are exact).
        empty = (torch.stack([fields["valid"][rows].sum(1) for rows in epoch_rows]) <= 0.0).tolist()

    sums = torch.zeros(len(METRIC_KEYS), device=device)
    count = 0
    stop = False
    for e, rows in enumerate(epoch_rows):
        if stop:
            break
        for i in range(nmb):
            if can_be_empty and empty[e][i]:
                continue
            mb = {k: v[rows[i]] for k, v in fields.items()}
            loss, metrics = minibatch_loss(network, mb, ent_coef, cfg)
            opt.flat_grads.zero_()
            loss.backward()
            clip_and_adam_step(opt, lr, cfg)
            sums = sums + metrics
            count += 1
            if cfg.target_kl is not None and float(metrics[3]) > cfg.target_kl:
                stop = True
                break

    averaged = sums / float(max(count, 1))
    metrics = dict(zip(METRIC_KEYS, averaged))
    metrics["num_minibatch_updates"] = torch.tensor(float(count), device=device)
    metrics["explained_variance"] = compute_explained_variance(
        data["old_values"], data["returns"], data["valid"]
    )
    return metrics

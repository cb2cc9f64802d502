"""PPO update: epochs of shuffled minibatches through autograd.

Counterpart of burn_ppo_tpu/ppo/update.py:71-431:

  * per-epoch shuffle of row tiles (``resolve_shuffle_block`` semantics),
    every epoch's permutation drawn up front as the reference splits its
    epoch keys up front;
  * per-minibatch Bessel advantage normalization;
  * clipped surrogate, optional value clip, entropy bonus;
  * global-norm clip then Adam, written to optax's formulas (the clip
    leaves gradients alone below ``max_grad_norm`` and scales them by
    max/norm above it — not ``clip_grad_norm_``'s max/(norm+1e-6));
    the step is ``p - lr * u``;
  * KL early stop that still applies the offending minibatch;
  * an uneven N % num_minibatches split padded with copies of real rows
    whose valid flag is 0, and all-pad minibatches skipped;
  * the 14 ``METRIC_KEYS`` averaged over the minibatches run, plus the
    explained variance.

The TPU-only packed [N, C] buffer and its 128-lane pad are not carried
over: rows are gathered per field with one index tensor.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

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


@dataclass
class AdamState:
    """optax ``chain(clip_by_global_norm, scale_by_adam)`` state: the step
    count and the two moments, one per network parameter, by name. The
    count is a host integer: it changes only where the host decides that a
    minibatch runs."""

    count: int
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]

    @staticmethod
    def create(network: torch.nn.Module) -> "AdamState":
        named = dict(network.named_parameters())
        return AdamState(
            count=0,
            mu={k: torch.zeros_like(p) for k, p in named.items()},
            nu={k: torch.zeros_like(p) for k, p in named.items()},
        )


def clip_and_adam_step(
    network: torch.nn.Module,
    grads: List[torch.Tensor],
    opt: AdamState,
    lr: float,
    cfg: PPOUpdateConfig,
) -> None:
    """Global-norm clip + Adam + ``p -= lr * u``, in place."""
    names = [k for k, _ in network.named_parameters()]
    params = [p for _, p in network.named_parameters()]
    g_norm = torch.sqrt(sum(torch.sum(torch.square(g)) for g in grads))
    trigger = g_norm < cfg.max_grad_norm
    opt.count += 1
    bc1 = 1.0 - ADAM_B1 ** opt.count
    bc2 = 1.0 - ADAM_B2 ** opt.count
    with torch.no_grad():
        for name, p, g in zip(names, params, grads):
            g = torch.where(trigger, g, (g / g_norm) * cfg.max_grad_norm)
            mu = (1 - ADAM_B1) * g + ADAM_B1 * opt.mu[name]
            nu = (1 - ADAM_B2) * torch.square(g) + ADAM_B2 * opt.nu[name]
            opt.mu[name], opt.nu[name] = mu, nu
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + cfg.adam_epsilon)
            p.sub_(lr * u)


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


def minibatch_loss(
    network: torch.nn.Module,
    mb: Dict[str, torch.Tensor],
    ent_coef: float,
    cfg: PPOUpdateConfig,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Scalar loss (with autograd graph) + detached metrics for one
    minibatch (burn_ppo_tpu/ppo/update.py:125-212)."""
    w = mb["valid"]
    logits, values = network(mb["obs"])
    mask = mb.get("action_masks")
    logp = torch.log_softmax(apply_action_mask(logits, mask), dim=-1)
    new_log_probs = log_prob_from_logp(logp, mb["actions"])
    entropy = entropy_from_logp(logp)

    log_ratio = new_log_probs - mb["old_log_probs"]
    ratio = torch.exp(log_ratio)

    adv = mb["advantages"]
    adv_mean = _wmean(adv, w)
    adv_std = _wstd(adv, w)
    adv_n = (adv - adv_mean) / (adv_std + 1e-8)

    eps = cfg.clip_epsilon
    pl1 = -adv_n * ratio
    pl2 = -adv_n * torch.clamp(ratio, 1.0 - eps, 1.0 + eps)
    policy_loss = _wmean(torch.maximum(pl1, pl2), w)

    returns = mb["returns"]
    old_values = mb["old_values"]
    if cfg.clip_value:
        v_clipped = old_values + torch.clamp(values - old_values, -eps, eps)
        vl = torch.maximum(torch.square(values - returns), torch.square(v_clipped - returns))
        value_loss = 0.5 * _wmean(vl, w)
    else:
        value_loss = 0.5 * _wmean(torch.square(values - returns), w)

    entropy_mean = _wmean(entropy, w)
    loss = policy_loss + value_loss * cfg.value_coef - entropy_mean * ent_coef

    with torch.no_grad():
        values_d, entropy_d = values.detach(), entropy.detach()
        value_errors = torch.abs(values_d - returns)
        aux = {
            "policy_loss": policy_loss.detach(),
            "value_loss": value_loss.detach(),
            "entropy": entropy_mean.detach(),
            "approx_kl": _wmean((ratio.detach() - 1.0) - log_ratio.detach(), w),
            "clip_fraction": _wmean(
                (torch.abs(ratio.detach() - 1.0) > eps).to(torch.float32), w
            ),
            "total_loss": loss.detach(),
            "value_mean": _wmean(values_d, w),
            "returns_mean": _wmean(returns, w),
            "adv_mean_raw": adv_mean,
            "adv_std_raw": adv_std,
            "value_error_mean": _wmean(value_errors, w),
            "value_error_std": _wstd(value_errors, w),
        }
        if mask is not None:
            valid_counts = torch.sum(mask, dim=-1)
            aux["avg_valid_actions"] = _wmean(valid_counts, w)
            has_choice = (valid_counts > 1.0).to(torch.float32) * w
            max_ent = torch.log(torch.clamp(valid_counts, min=1.0 + 1e-8))
            aux["entropy_valid_pct"] = torch.sum(
                entropy_d / torch.clamp(max_ent, min=1e-8) * has_choice
            ) / torch.clamp(torch.sum(has_choice), min=1e-8)
        else:
            aux["avg_valid_actions"] = torch.zeros((), device=w.device)
            aux["entropy_valid_pct"] = torch.zeros((), device=w.device)
    return loss, aux


def ppo_update(
    network: torch.nn.Module,
    opt: AdamState,
    data: Dict[str, torch.Tensor],
    rng: RandomSource,
    lr: float,
    ent_coef: float,
    cfg: PPOUpdateConfig,
) -> Dict[str, torch.Tensor]:
    """num_epochs x num_minibatches PPO steps on flattened [N, ...] data
    (obs already normalized, actions, old_log_probs, advantages, returns,
    old_values, valid, optional action_masks). Updates ``network`` and
    ``opt`` in place; returns the metrics as device scalars."""
    N = data["actions"].shape[0]
    nmb = cfg.num_minibatches
    mb_size = N // nmb
    if mb_size == 0:
        raise ValueError(f"batch size {N} < num_minibatches {nmb}")
    if N % nmb:
        mb_size = -(-N // nmb)
    pad = nmb * mb_size - N
    can_be_all_pad = pad >= mb_size
    device = data["actions"].device

    fields = {k: v for k, v in data.items() if v is not None}
    if pad:
        # Wrapped copies of real rows with valid = 0: every reduction is
        # valid-weighted, so a minibatch averages over its real rows only.
        fields = {k: torch.cat([v, v[:pad]]) for k, v in fields.items()}
        fields["valid"][N:] = 0.0
    R = resolve_shuffle_block(nmb * mb_size, mb_size, cfg.shuffle_block_rows)
    num_blocks = (nmb * mb_size) // R
    perms = [rng.permutation(num_blocks) for _ in range(cfg.num_epochs)]
    within = torch.arange(R, device=device)

    params = list(network.parameters())
    sums = {k: torch.zeros((), device=device) for k in METRIC_KEYS}
    count = 0
    stop = False
    for perm in perms:
        if stop:
            break
        rows = (perm.to(device)[:, None] * R + within).reshape(nmb, mb_size)
        for i in range(nmb):
            mb = {k: v[rows[i]] for k, v in fields.items()}
            if can_be_all_pad and float(torch.sum(mb["valid"])) <= 0.0:
                continue
            loss, aux = minibatch_loss(network, mb, ent_coef, cfg)
            grads = torch.autograd.grad(loss, params)
            clip_and_adam_step(network, list(grads), opt, lr, cfg)
            for k in METRIC_KEYS:
                sums[k] = sums[k] + aux[k]
            count += 1
            if cfg.target_kl is not None and float(aux["approx_kl"]) > cfg.target_kl:
                stop = True
                break

    denom = float(max(count, 1))
    metrics = {k: sums[k] / denom for k in METRIC_KEYS}
    metrics["num_minibatch_updates"] = torch.tensor(float(count), device=device)
    metrics["explained_variance"] = compute_explained_variance(
        data["old_values"], data["returns"], data["valid"]
    )
    return metrics

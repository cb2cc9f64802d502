"""Masked-categorical primitives, with the fused sampling kernel K2.

Counterpart of burn_ppo_tpu/ops/categorical.py: an additive -1e9 action
mask (finite, so ``p * log p`` of a masked action is exactly 0),
log-softmax, log-prob, entropy and Gumbel-max sampling.

``masked_sample`` is the rollout's policy step. For CPU tensors it runs
the plain PyTorch version (``masked_sample_plain``); for CUDA tensors it
launches the hand-written kernel ``csrc/masked_gumbel_sample.cu``
(ROADMAP B2), or raises. The Gumbel noise comes from uniforms the caller
draws (``u`` in [tiny, 1)), so tests can hand in the JAX side's draws:
``jax.random.categorical(k, l) == argmax(l - log(-log(u)))`` with
``u = jax.random.uniform(k, l.shape, minval=tiny, maxval=1)``.

``sample_with_temperature`` is eval's sampler: the mask, a temperature per
row (or one for all rows), a Gumbel-max sample where it is above 0 and the
greedy action where it is not. CPU tensors take
``sample_with_temperature_plain``; CUDA tensors launch the hand-written
kernel ``csrc/temperature_sample.cu`` (K14, ROADMAP B16), or raise.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from burn_ppo_torch import kernels

MASK_NEG = -1.0e9
TINY = torch.finfo(torch.float32).tiny
MAX_KERNEL_ACTIONS = 64
MIN_TEMP = 1.0e-8


def apply_action_mask(logits: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Additively mask invalid actions; ``mask`` is float (1.0 = valid) or bool."""
    if mask is None:
        return logits
    valid = mask if mask.dtype == torch.bool else mask != 0
    return logits + torch.where(valid, 0.0, MASK_NEG).to(logits.dtype)


def log_prob_from_logp(logp: torch.Tensor, actions: torch.Tensor) -> torch.Tensor:
    """log pi(a|s) selected from a precomputed log-softmax (a gather; the
    reference's one-hot contraction only avoided TPU gathers)."""
    return torch.gather(logp, -1, actions.long().unsqueeze(-1)).squeeze(-1)


def entropy_from_logp(logp: torch.Tensor) -> torch.Tensor:
    """Entropy per row; masked actions (p == 0) contribute exactly 0."""
    p = torch.exp(logp)
    return -torch.sum(torch.where(p > 0, p * logp, 0.0), dim=-1)


def masked_sample_plain(
    logits: torch.Tensor, mask: Optional[torch.Tensor], uniforms: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch K2: (actions [E] i32, log_probs [E] f32)."""
    masked = apply_action_mask(logits, mask)
    gumbel = -torch.log(-torch.log(uniforms))
    # torch.argmax returns the first maximal index, as jnp.argmax does.
    actions = torch.argmax(gumbel + masked, dim=-1).to(torch.int32)
    log_probs = log_prob_from_logp(torch.log_softmax(masked, dim=-1), actions)
    return actions, log_probs


def masked_sample(
    logits: torch.Tensor, mask: Optional[torch.Tensor], uniforms: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mask, Gumbel-max sample and log pi(a) of one rollout step."""
    ts = (logits, uniforms) if mask is None else (logits, mask, uniforms)
    if kernels.on_cpu(*ts):
        return masked_sample_plain(logits, mask, uniforms)
    rows, A = logits.shape
    if A > MAX_KERNEL_ACTIONS:
        raise ValueError(f"masked_sample kernel takes at most {MAX_KERNEL_ACTIONS} actions, got {A}")
    kernels.expect(logits, "logits", torch.float32, (rows, A))
    kernels.expect(uniforms, "uniforms", torch.float32, (rows, A))
    if mask is not None:
        kernels.expect(mask, "mask", torch.float32, (rows, A))
    actions = torch.empty(rows, dtype=torch.int32, device=logits.device)
    log_probs = torch.empty(rows, dtype=torch.float32, device=logits.device)
    err = kernels.library().masked_gumbel_sample(
        kernels.ptr(logits), kernels.ptr(mask), kernels.ptr(uniforms),
        kernels.ptr(actions), kernels.ptr(log_probs), rows, A,
        kernels.stream(logits.device),
    )
    kernels.check(err, "masked_gumbel_sample")
    masked_sample.launches += 1
    return actions, log_probs


kernels.counted(masked_sample)


def sample_with_temperature_plain(
    logits: torch.Tensor, mask: Optional[torch.Tensor],
    temperature: Union[float, torch.Tensor], uniforms: torch.Tensor,
) -> torch.Tensor:
    """Plain PyTorch K14 (burn_ppo_tpu/ops/categorical.py:84-111): actions
    [E] i32. Where the row's temperature t > 0, ``argmax(masked / max(t,
    1e-8) - log(-log(u)))``, the first maximum winning a tie, as
    ``jax.random.categorical`` picks; where t <= 0, the LAST maximal index
    of ``masked`` (the reference's greedy ``max_by`` keeps the later of
    equal elements). ``temperature`` is a float, a 0-dim tensor or one per
    row, [E]."""
    masked = apply_action_mask(logits, mask)
    rows, A = masked.shape
    t = torch.as_tensor(temperature, dtype=masked.dtype, device=masked.device).expand(rows)
    safe_t = torch.clamp(t, min=MIN_TEMP)
    gumbel = -torch.log(-torch.log(uniforms))
    sampled = torch.argmax(gumbel + masked / safe_t[:, None], dim=-1)
    greedy = A - 1 - torch.argmax(masked.flip(-1), dim=-1)
    return torch.where(t <= 0.0, greedy, sampled).to(torch.int32)


def sample_with_temperature(
    logits: torch.Tensor, mask: Optional[torch.Tensor],
    temperature: Union[float, torch.Tensor], uniforms: torch.Tensor,
) -> torch.Tensor:
    """Mask, temperature and sample of one eval step: actions [E] i32.
    ``uniforms`` [E, A] in [tiny, 1) are drawn by the caller for every row,
    greedy or not; ``temperature`` is a float or an [E] tensor (a 0-dim
    tensor only on the CPU)."""
    temps = temperature if isinstance(temperature, torch.Tensor) else None
    ts = [t for t in (logits, mask, temps, uniforms) if t is not None]
    if kernels.on_cpu(*ts):
        return sample_with_temperature_plain(logits, mask, temperature, uniforms)
    rows, A = logits.shape
    if A > MAX_KERNEL_ACTIONS:
        raise ValueError(f"temperature_sample kernel takes at most {MAX_KERNEL_ACTIONS} actions, "
                         f"got {A}")
    kernels.expect(logits, "logits", torch.float32, (rows, A))
    kernels.expect(uniforms, "uniforms", torch.float32, (rows, A))
    if mask is not None:
        kernels.expect(mask, "mask", torch.float32, (rows, A))
    if temps is not None:
        kernels.expect(temps, "temperature", torch.float32, (rows,))
    actions = torch.empty(rows, dtype=torch.int32, device=logits.device)
    err = kernels.library().temperature_sample(
        kernels.ptr(logits), kernels.ptr(mask), kernels.ptr(temps),
        0.0 if temps is not None else float(temperature), kernels.ptr(uniforms),
        kernels.ptr(actions), rows, A, kernels.stream(logits.device),
    )
    kernels.check(err, "temperature_sample")
    sample_with_temperature.launches += 1
    return actions


kernels.counted(sample_with_temperature)

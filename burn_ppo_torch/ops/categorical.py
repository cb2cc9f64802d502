"""Masked-categorical primitives, with the fused sampling kernel K2.

Counterpart of burn_ppo_tpu/ops/categorical.py: an additive -1e9 action
mask (finite, so ``p * log p`` of a masked action is exactly 0),
log-softmax, log-prob, entropy and Gumbel-max sampling.

``masked_sample`` is the rollout's policy step. For CPU tensors it runs
the plain PyTorch version (``masked_sample_plain``); for CUDA tensors it
launches the hand-written kernel ``csrc/masked_gumbel_sample.cu``
(ROADMAP B2), or raises. Given PopArt's state, the step's values and an
output slice, the same launch denormalises the values into the slice
(its epilogue, K16's operations; the plain path runs
``ppo/normalization.py popart_denormalize_plain`` after the sample). The
Gumbel noise comes from uniforms the caller
draws (``u`` in [tiny, 1)), so tests can hand in the JAX side's draws:
``jax.random.categorical(k, l) == argmax(l - log(-log(u)))`` with
``u = jax.random.uniform(k, l.shape, minval=tiny, maxval=1)``.

``sample_with_temperature`` is eval's sampler: the mask, a temperature per
row (or one for all rows), a Gumbel-max sample where it is above 0 and the
greedy action where it is not. CPU tensors take
``sample_with_temperature_plain``; CUDA tensors launch the hand-written
kernel ``csrc/temperature_sample.cu`` (K14, ROADMAP B16), or raise. Eval's
stats engine hands the same inputs (``TemperatureFront``) to the env's
step instead (``front``), whose kernel samples in its own launch
(``front_args`` checks them and gives the C arguments).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import torch

from burn_ppo_torch import kernels
from burn_ppo_torch.ppo.normalization import popart_denormalize_plain

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
    logits: torch.Tensor, mask: Optional[torch.Tensor], uniforms: torch.Tensor, *,
    popart=None, values: Optional[torch.Tensor] = None,
    values_out: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mask, Gumbel-max sample and log pi(a) of one rollout step. With
    ``popart`` (a ``PopArtState``), the step's ``values`` [rows] are
    denormalised into ``values_out`` [rows] (a view, such as a step's slice
    of the rollout's values), in the same launch on a card."""
    ts = (logits, uniforms) if mask is None else (logits, mask, uniforms)
    epilogue = () if popart is None else (values, popart.mean, popart.m2, popart.count,
                                           values_out)
    if kernels.on_cpu(*ts, *epilogue):
        out = masked_sample_plain(logits, mask, uniforms)
        if popart is not None:
            values_out.copy_(popart_denormalize_plain(popart, values))
        return out
    rows, A = logits.shape
    if A > MAX_KERNEL_ACTIONS:
        raise ValueError(f"masked_sample kernel takes at most {MAX_KERNEL_ACTIONS} actions, got {A}")
    kernels.expect(logits, "logits", torch.float32, (rows, A))
    kernels.expect(uniforms, "uniforms", torch.float32, (rows, A))
    if mask is not None:
        kernels.expect(mask, "mask", torch.float32, (rows, A))
    if popart is not None:
        for t, name, shape in ((values, "values", (rows,)), (values_out, "values_out", (rows,)),
                               (popart.mean, "mean", ()), (popart.m2, "m2", ()),
                               (popart.count, "count", ())):
            kernels.expect(t, name, torch.float32, shape)
    actions = torch.empty(rows, dtype=torch.int32, device=logits.device)
    log_probs = torch.empty(rows, dtype=torch.float32, device=logits.device)
    p = kernels.ptr
    err = kernels.library().masked_gumbel_sample(
        p(logits), p(mask), p(uniforms), p(actions), p(log_probs), rows, A,
        *(p(t) for t in epilogue or (None,) * 5), kernels.stream(logits.device),
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


class TemperatureFront(NamedTuple):
    """The inputs of one eval step's sample (K14's): ``logits`` [E, A],
    ``mask`` [E, A] or None, ``temperature`` a float or an [E] tensor (a
    0-dim tensor only on the CPU), ``uniforms`` [E, A] in [tiny, 1) drawn
    for every row, greedy or not."""

    logits: torch.Tensor
    mask: Optional[torch.Tensor]
    temperature: Union[float, torch.Tensor]
    uniforms: torch.Tensor

    def tensors(self) -> list:
        return [t for t in (self.logits, self.mask, self.temperature, self.uniforms)
                if isinstance(t, torch.Tensor)]

    def plain(self) -> torch.Tensor:
        return sample_with_temperature_plain(*self)


def front_args(front: Optional[TemperatureFront], actions: Optional[torch.Tensor],
               num_actions: int) -> tuple:
    """The checked C arguments of K14's row code for CUDA tensors:
    logits, mask, temperatures (null for a float), the float temperature,
    uniforms and the ``actions`` [E] i32 output, the rows ``num_actions``
    wide (an env step kernel's width is its own constant). All null
    without a front."""
    if front is None:
        return (None, None, None, 0.0, None, None)
    logits, mask, temperature, uniforms = front
    temps = temperature if isinstance(temperature, torch.Tensor) else None
    rows, A = actions.shape[0], num_actions
    if A > MAX_KERNEL_ACTIONS:
        raise ValueError(f"temperature_sample kernel takes at most {MAX_KERNEL_ACTIONS} actions, "
                         f"got {A}")
    kernels.expect(logits, "logits", torch.float32, (rows, A))
    kernels.expect(uniforms, "uniforms", torch.float32, (rows, A))
    if mask is not None:
        kernels.expect(mask, "mask", torch.float32, (rows, A))
    if temps is not None:
        kernels.expect(temps, "temperature", torch.float32, (rows,))
    kernels.expect(actions, "actions", torch.int32, (rows,))
    return (kernels.ptr(logits), kernels.ptr(mask), kernels.ptr(temps),
            0.0 if temps is not None else float(temperature), kernels.ptr(uniforms),
            kernels.ptr(actions))


def sample_with_temperature(
    logits: torch.Tensor, mask: Optional[torch.Tensor],
    temperature: Union[float, torch.Tensor], uniforms: torch.Tensor,
) -> torch.Tensor:
    """Mask, temperature and sample of one eval step: actions [E] i32
    (``TemperatureFront`` describes the inputs)."""
    front = TemperatureFront(logits, mask, temperature, uniforms)
    if kernels.on_cpu(*front.tensors()):
        return front.plain()
    rows, A = logits.shape
    actions = torch.empty(rows, dtype=torch.int32, device=logits.device)
    err = kernels.library().temperature_sample(*front_args(front, actions, A), rows, A,
                                               kernels.stream(logits.device))
    kernels.check(err, "temperature_sample")
    sample_with_temperature.launches += 1
    return actions


kernels.counted(sample_with_temperature)

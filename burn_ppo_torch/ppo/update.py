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
    opponent turns on the vs-pool path: ``may_have_invalid``) is skipped;
  * the 14 metrics averaged over the minibatches run, plus the explained
    variance;
  * with PopArt (``normalize_values``), the loss on returns and old values
    normalized with the value normalizer's new stats (update.py:164-166),
    inside K8; the stats merge and the value head's rescale run before the
    epochs (``ppo/update_graph.py prepare_update``, kernel K15);
  * with the adaptive entropy controller, the first minibatch's K8 steps
    it and every K8 records the update's mean entropy so far
    (``ppo/entropy.py``): ``ent_coef`` is then the scheduled target.

Nothing is read back to the host, so the update can be captured into
CUDA graphs (``ppo/update_graph.py``). Every epoch's rows are
drawn up front into one index tensor; the learning rate and the entropy
coefficient are 0-dim device tensors. Where the JAX scan skips a
minibatch with ``lax.cond`` (the KL stop, an empty minibatch), the port
runs its forward and backward all the same and decides on the device:
K8's finalize sets ``LossBook.run`` (and adds the metrics, counts the
minibatch, raises the stop flag), and K9 with ``run`` 0 leaves the
parameters, the moments and the Adam count as they were.

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
from burn_ppo_torch.ppo.entropy import (
    AdaptiveEntropyState,
    adaptive_entropy_record,
    adaptive_entropy_step,
)
from burn_ppo_torch.ppo.normalization import PopArtState, popart_normalize
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
    # The adaptive entropy controller's clamp and step (when it is on).
    ent_min_coef: float = 0.001
    ent_max_coef: float = 0.1
    ent_delta: float = 0.001


ADAM_B1 = 0.9
ADAM_B2 = 0.999
# Entries of the bias-correction table: from count 17,321 on, 1 - 0.999^count
# rounds to 1.0 in f32 (and 1 - 0.9^count from 165 on), so the last entry
# serves every larger count.
ADAM_BIAS_LEN = 32768


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


_BIAS_TABLES: Dict[torch.device, torch.Tensor] = {}


def adam_bias_table(device: torch.device) -> torch.Tensor:
    """f32 [2, ADAM_BIAS_LEN]: row 0 holds ``1 - 0.9^c``, row 1
    ``1 - 0.999^c`` at column c, each formed in double on the host and
    rounded to f32 once; made once per device. K9 and its plain version
    look the step's corrections up at min(count, ADAM_BIAS_LEN - 1)."""
    device = torch.device(device)
    table = _BIAS_TABLES.get(device)
    if table is None:
        rows = [[1.0 - b ** c for c in range(ADAM_BIAS_LEN)] for b in (ADAM_B1, ADAM_B2)]
        table = torch.tensor(rows, dtype=torch.float32)
        if not bool((table[:, -1] == 1.0).all()):
            raise AssertionError("the bias-correction table is too short")
        table = _BIAS_TABLES[device] = table.to(device)
    return table


@dataclass
class AdamState:
    """optax ``chain(clip_by_global_norm, scale_by_adam)`` state: the step
    count and the two moments, beside the network's flat parameter and
    gradient buffers (``flat_parameters``, made once here). The moments
    are flat buffers of the same layout; ``mu`` and ``nu`` view them by
    parameter name. The count is a 0-dim i32 tensor on the parameters'
    device (``count_tensor``), which K9 advances where a minibatch runs,
    so only the device knows it after a KL stop; ``count`` fetches it.
    ``partial`` is K9's scratch on a CUDA device (``clip_adam_scratch``),
    made once here so that no step allocates; None on the CPU."""

    count_tensor: torch.Tensor
    flat_params: torch.Tensor
    flat_grads: torch.Tensor
    flat_mu: torch.Tensor
    flat_nu: torch.Tensor
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    partial: Optional[torch.Tensor] = None

    @property
    def count(self) -> int:
        """The Adam count, fetched from the device."""
        return int(self.count_tensor)

    @staticmethod
    def create(network: torch.nn.Module) -> "AdamState":
        flat, grads = flat_parameters(network)
        mu, nu = torch.zeros_like(flat), torch.zeros_like(flat)
        adam_bias_table(flat.device)  # made now, before any graph capture
        return AdamState(count_tensor=torch.zeros((), dtype=torch.int32, device=flat.device),
                         flat_params=flat, flat_grads=grads, flat_mu=mu, flat_nu=nu,
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
                    nu: torch.Tensor, *, lr: torch.Tensor, count: torch.Tensor,
                    run: torch.Tensor, max_grad_norm: float, eps: float) -> None:
    """Plain PyTorch K9, in place on flat buffers: the step that makes the
    Adam count ``count + 1``, its bias corrections from
    ``adam_bias_table``; where ``run`` is 0, nothing changes."""
    c = count + 1
    bias = adam_bias_table(params.device)
    col = torch.clamp(c, max=ADAM_BIAS_LEN - 1).long()
    bc1, bc2 = bias[0, col], bias[1, col]
    g_norm = torch.sqrt(torch.sum(torch.square(grads)))
    g = torch.where(g_norm < max_grad_norm, grads, (grads / g_norm) * max_grad_norm)
    m = (1 - ADAM_B1) * g + ADAM_B1 * mu
    v = (1 - ADAM_B2) * torch.square(g) + ADAM_B2 * nu
    u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
    p = params - lr * u
    for dst, new in ((mu, m), (nu, v), (params, p), (count, c)):
        dst.copy_(torch.where(run != 0, new, dst))


def clip_adam(params: torch.Tensor, grads: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor,
              *, lr: torch.Tensor, count: torch.Tensor, run: torch.Tensor,
              max_grad_norm: float, eps: float, partial: Optional[torch.Tensor] = None) -> None:
    """Global-norm clip + Adam + ``p -= lr * u`` over flat buffers, in
    place, as the step that makes the Adam count ``count + 1``: ``lr`` a
    0-dim f32 tensor, ``count`` a 0-dim i32 tensor that the step advances,
    ``run`` a 0-dim i32 flag, 0 for a step that changes nothing. CPU
    tensors take the plain version; CUDA tensors launch K9 (one launch;
    the norm, the count and the flag stay on the device) with
    ``partial`` as its scratch (``clip_adam_scratch``; the four buffers
    16-byte aligned), or raise. The launch allocates nothing, so a CUDA
    graph can capture it."""
    if kernels.on_cpu(params, grads, mu, nu, lr, count, run):
        return clip_adam_plain(params, grads, mu, nu, lr=lr, count=count, run=run,
                               max_grad_norm=max_grad_norm, eps=eps)
    n = params.numel()
    for t, name in ((params, "params"), (grads, "grads"), (mu, "mu"), (nu, "nu")):
        kernels.expect(t, name, torch.float32, (n,))
        kernels.expect_rows16(t, name)
    kernels.expect(lr, "lr", torch.float32, ())
    kernels.expect(count, "count", torch.int32, ())
    kernels.expect(run, "run", torch.int32, ())
    if partial is None or partial.device != params.device:
        raise ValueError("clip_adam: CUDA buffers need K9's scratch on their device "
                         "(clip_adam_scratch)")
    kernels.expect(partial, "partial", torch.float64, (partial.numel(),))
    bias = adam_bias_table(params.device)
    p = kernels.ptr
    err = kernels.library().clip_adam(
        p(params), p(grads), p(mu), p(nu), p(partial), n, partial.numel(), p(lr), p(count),
        p(run), p(bias), ADAM_BIAS_LEN, float(max_grad_norm), float(eps), ADAM_B1, ADAM_B2,
        1 - ADAM_B1, 1 - ADAM_B2, kernels.stream(params.device),
    )
    kernels.check(err, "clip_adam")
    clip_adam.launches += 1


kernels.counted(clip_adam)


def clip_and_adam_step(opt: AdamState, lr: torch.Tensor, cfg: PPOUpdateConfig,
                       run: torch.Tensor) -> None:
    """Global-norm clip + Adam + ``p -= lr * u`` of every parameter, in
    place, from the gradients in ``opt.flat_grads``, ``lr`` a 0-dim f32
    tensor; the Adam count advances on the device. ``run`` (a 0-dim i32
    flag): 0 leaves everything as it was."""
    with torch.no_grad():
        clip_adam(opt.flat_params, opt.flat_grads, opt.flat_mu, opt.flat_nu, lr=lr,
                  count=opt.count_tensor, run=run, max_grad_norm=cfg.max_grad_norm,
                  eps=cfg.adam_epsilon, partial=opt.partial)


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


@dataclass
class LossBook:
    """One update's minibatch bookkeeping on the device, which K8's
    finalize writes (``ppo_loss(book=)``): the metric sums [14] and the
    minibatches run (f32), the stop flag (i32, 1 once the KL stop fired)
    and the current minibatch's run flag (i32, read by K9); beside them
    K8's output [15] and, on a CUDA device, its f64 scratch, made once
    here for every minibatch of the update."""

    sums: torch.Tensor
    count: torch.Tensor
    stop: torch.Tensor
    run: torch.Tensor
    out: torch.Tensor
    scratch: Optional[torch.Tensor] = None

    @staticmethod
    def create(device: torch.device) -> "LossBook":
        def z(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=device)

        scratch = None
        if device.type != "cpu":
            scratch = torch.empty(kernels.library().ppo_loss_scratch_len(), dtype=torch.float64,
                                  device=device)
        return LossBook(sums=z(len(METRIC_KEYS)), count=z(), stop=z(dtype=torch.int32),
                        run=z(dtype=torch.int32), out=z(1 + len(METRIC_KEYS)), scratch=scratch)


def book_plain(book: LossBook, metrics: torch.Tensor, valid: torch.Tensor,
               cfg: PPOUpdateConfig, can_be_empty: bool) -> None:
    """Plain twin of K8's bookkeeping (burn_ppo_tpu/ppo/update.py:346-382):
    the minibatch runs unless the KL stop fired or, where it may be empty,
    it holds no valid row; where it runs, the metrics are added and
    counted and its approx_kl (in double) may raise the stop flag."""
    run = book.stop == 0
    if can_be_empty:
        run = run & (torch.sum(valid) > 0.0)
    book.sums.copy_(torch.where(run, book.sums + metrics, book.sums))
    book.count.copy_(torch.where(run, book.count + 1.0, book.count))
    if cfg.target_kl is not None:
        kl_over = metrics[3].to(torch.float64) > cfg.target_kl
        book.stop.copy_(torch.where(run & kl_over, 1, book.stop))
    book.run.copy_(run)


def ppo_loss_plain(
    logits: torch.Tensor,
    values: torch.Tensor,
    mb: Dict[str, torch.Tensor],
    ent_coef: torch.Tensor,
    cfg: PPOUpdateConfig,
    book: LossBook,
    can_be_empty: bool = False,
    popart: Optional[PopArtState] = None,
    controller: Optional[AdaptiveEntropyState] = None,
    ent_step: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch K8: (loss, the 14 metrics [14], dL/dlogits [M, A],
    dL/dvalues [M]) of one minibatch, from the network's logits [M, A] and
    values [M] (burn_ppo_tpu/ppo/update.py:125-212 under value_and_grad,
    with JAX's gradient rules at ties), and its bookkeeping into ``book``
    (``book_plain``). With ``popart`` the returns and old values are
    normalized with its stats; with ``controller`` (the adaptive entropy
    controller's state) the coefficient is the
    controller's (stepped first where ``ent_step``, ``ent_coef`` the
    target) and the update's mean entropy so far is recorded."""
    if controller is not None:
        ent_coef = (adaptive_entropy_step(controller, ent_coef, cfg.ent_min_coef, cfg.ent_max_coef,
                                          cfg.ent_delta)
                    if ent_step else controller.coef.clone())
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
    if popart is not None:
        returns = popart_normalize(popart, returns)
    if cfg.clip_value:
        old_values = mb["old_values"]
        if popart is not None:
            old_values = popart_normalize(popart, old_values)
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
    metrics = torch.stack(metrics)
    book_plain(book, metrics, w, cfg, can_be_empty)
    if controller is not None:
        adaptive_entropy_record(controller, book.sums[2] / torch.clamp(book.count, min=1.0))
    return loss, metrics, dlogits, dvalues


# K8's widest row (csrc/ppo_loss.cu: 8 lanes a row, 8 entries a lane).
_LOSS_MAX_ACTIONS = 64


def ppo_loss_forward(
    logits: torch.Tensor,
    values: torch.Tensor,
    mb: Dict[str, torch.Tensor],
    ent_coef: torch.Tensor,
    cfg: PPOUpdateConfig,
    book: LossBook,
    can_be_empty: bool = False,
    popart: Optional[PopArtState] = None,
    controller: Optional[AdaptiveEntropyState] = None,
    ent_step: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(loss, metrics [14], dL/dlogits, dL/dvalues) of one minibatch, the
    entropy coefficient a 0-dim f32 tensor, and its bookkeeping into
    ``book``. CPU tensors take the plain version; CUDA tensors launch K8
    (two launches: the advantage statistics, then the rows with the last
    block's finalize, which does the update's bookkeeping and writes the
    loss and metrics into ``book.out``, in the book's scratch), or raise.
    ``popart`` and ``controller`` (with ``ent_step``): as ``ppo_loss_plain``,
    read and written on the device by the same two launches."""
    mask = mb.get("action_masks")
    cols = [mb[k] for k in LOSS_FIELDS]
    pa = [] if popart is None else [popart.mean, popart.m2, popart.count]
    ent = ([] if controller is None
           else [controller.coef, controller.last_entropy, controller.has_entropy])
    ts = [logits, values, *cols, ent_coef, book.sums, book.count, book.stop, book.run, book.out,
          *pa, *ent]
    if kernels.on_cpu(*ts, *([] if mask is None else [mask])):
        return ppo_loss_plain(logits, values, mb, ent_coef, cfg, book, can_be_empty, popart,
                              controller, ent_step)
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
    kernels.expect(ent_coef, "ent_coef", torch.float32, ())
    scratch, out = book.scratch, book.out
    if scratch is None or scratch.device != dev:
        raise ValueError("ppo_loss: a CUDA book needs K8's scratch on its device "
                         "(LossBook.create)")
    kernels.expect(scratch, "scratch", torch.float64, (lib.ppo_loss_scratch_len(),))
    kernels.expect(out, "out", torch.float32, (1 + len(METRIC_KEYS),))
    kernels.expect(book.sums, "sums", torch.float32, (len(METRIC_KEYS),))
    kernels.expect(book.count, "count", torch.float32, ())
    kernels.expect(book.stop, "stop", torch.int32, ())
    kernels.expect(book.run, "run", torch.int32, ())
    for t, name in zip(pa, ("popart mean", "popart m2", "popart count")):
        kernels.expect(t, name, torch.float32, ())
    for t, name, dtype in zip(ent, ("coef", "last_entropy", "has_entropy"),
                              (torch.float32, torch.float32, torch.bool)):
        kernels.expect(t, name, dtype, ())
    pa, ent = pa or [None] * 3, ent or [None] * 3
    dlogits = torch.empty_like(logits)
    dvalues = torch.empty_like(values)
    eps = cfg.clip_epsilon
    target_kl = -1.0 if cfg.target_kl is None else float(cfg.target_kl)
    p = kernels.ptr
    err = lib.ppo_loss_forward(
        p(logits), p(values), p(mask), *(p(t) for t in cols), M, A, float(eps),
        float(1.0 - eps), float(1.0 + eps), int(cfg.clip_value), float(cfg.value_coef),
        p(ent_coef), p(scratch), p(out), p(dlogits), p(dvalues), p(book.sums), p(book.count),
        p(book.stop), p(book.run),
        int(can_be_empty), target_kl, *(p(t) for t in pa), *(p(t) for t in ent), int(ent_step),
        float(cfg.ent_min_coef), float(cfg.ent_max_coef), float(cfg.ent_delta),
        kernels.stream(dev),
    )
    kernels.check(err, "ppo_loss_forward")
    ppo_loss.launches += 1
    return out[0], out[1:], dlogits, dvalues


class _PPOLoss(torch.autograd.Function):
    """The loss as one autograd node: the gradients are computed in the
    forward and the backward scales them."""

    @staticmethod
    def forward(ctx, logits, values, mb, ent_coef, cfg, book, can_be_empty, popart, controller,
                ent_step):
        loss, metrics, dlogits, dvalues = ppo_loss_forward(
            logits.detach(), values.detach(), mb, ent_coef, cfg, book, can_be_empty, popart,
            controller, ent_step)
        ctx.save_for_backward(dlogits, dvalues)
        ctx.mark_non_differentiable(metrics)
        return loss, metrics

    @staticmethod
    def backward(ctx, g_loss, _g_metrics):
        dlogits, dvalues = ctx.saved_tensors
        return (g_loss * dlogits, g_loss * dvalues) + (None,) * 8


def ppo_loss(
    logits: torch.Tensor,
    values: torch.Tensor,
    mb: Dict[str, torch.Tensor],
    ent_coef: torch.Tensor,
    cfg: PPOUpdateConfig,
    book: LossBook,
    can_be_empty: bool = False,
    popart: Optional[PopArtState] = None,
    controller: Optional[AdaptiveEntropyState] = None,
    ent_step: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scalar loss (differentiable in ``logits`` and ``values``) and the 14
    metrics [14] in ``METRIC_KEYS`` order, the update's bookkeeping
    (``LossBook``) done on the way; ``popart``, ``controller`` and
    ``ent_step`` as ``ppo_loss_forward`` takes them."""
    mb = {k: mb[k].contiguous() for k in LOSS_FIELDS + ("action_masks",) if mb.get(k) is not None}
    return _PPOLoss.apply(logits.contiguous(), values.contiguous(), mb, ent_coef, cfg, book,
                          can_be_empty, popart, controller, ent_step)


kernels.counted(ppo_loss)


def minibatch_loss(
    network: torch.nn.Module,
    mb: Dict[str, torch.Tensor],
    ent_coef: torch.Tensor,
    cfg: PPOUpdateConfig,
    book: LossBook,
    can_be_empty: bool = False,
    popart: Optional[PopArtState] = None,
    controller: Optional[AdaptiveEntropyState] = None,
    ent_step: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scalar loss (with autograd graph) + the detached metrics [14] in
    ``METRIC_KEYS`` order for one minibatch
    (burn_ppo_tpu/ppo/update.py:125-212); a CTDE network's values are its
    critic's on the minibatch's privileged obs."""
    logits, values = network(mb["obs"], mb.get("privileged_obs"))
    return ppo_loss(logits, values, mb, ent_coef, cfg, book, can_be_empty, popart, controller,
                    ent_step)


@dataclass
class UpdatePlan:
    """What an update's epochs read, made before the first (``plan_update``):
    the padded [nmb x mb_size, ...] columns, every epoch's rows [epochs,
    nmb, mb_size] drawn up front, the device bookkeeping, the learning
    rate and entropy coefficient (with the controller on, its target) as
    0-dim tensors, the unpadded data (for the explained variance), and
    the value normalizer and entropy controller the loss reads, or None."""

    fields: Dict[str, torch.Tensor]
    rows: torch.Tensor
    book: LossBook
    lr: torch.Tensor
    ent_coef: torch.Tensor
    can_be_empty: bool
    data: Dict[str, torch.Tensor]
    popart: Optional[PopArtState] = None
    controller: Optional[AdaptiveEntropyState] = None


def plan_update(data: Dict[str, torch.Tensor], rng: RandomSource, lr: torch.Tensor,
                ent_coef: torch.Tensor, cfg: PPOUpdateConfig, may_have_invalid: bool = False,
                popart: Optional[PopArtState] = None,
                controller: Optional[AdaptiveEntropyState] = None) -> UpdatePlan:
    """The pad, every epoch's permutation and a fresh ``LossBook``; ``lr``
    and ``ent_coef`` 0-dim f32 tensors on the data's device."""
    N = data["actions"].shape[0]
    nmb = cfg.num_minibatches
    mb_size = N // nmb
    if mb_size == 0:
        raise ValueError(f"batch size {N} < num_minibatches {nmb}")
    if N % nmb:
        mb_size = -(-N // nmb)
    pad = nmb * mb_size - N
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
    perms = torch.stack([rng.permutation(num_blocks).to(device) for _ in range(cfg.num_epochs)])
    rows = (perms[:, :, None] * R + within).reshape(cfg.num_epochs, nmb, mb_size)
    return UpdatePlan(fields=fields, rows=rows, book=LossBook.create(device), lr=lr,
                      ent_coef=ent_coef, can_be_empty=pad >= mb_size or may_have_invalid, data=data,
                      popart=popart, controller=controller)


def update_minibatch(network: torch.nn.Module, opt: AdamState, plan: UpdatePlan,
                     cfg: PPOUpdateConfig, epoch: int, m: int) -> None:
    """Minibatch ``m`` of ``epoch``: gathered by its device rows, its loss
    (K8, whose finalize decides whether it runs), backward, and K9, which
    changes nothing where it does not run. The update's first minibatch
    steps the entropy controller."""
    mb = {k: v[plan.rows[epoch, m]] for k, v in plan.fields.items()}
    loss, _ = minibatch_loss(network, mb, plan.ent_coef, cfg, plan.book, plan.can_be_empty,
                             plan.popart, plan.controller, ent_step=epoch == 0 and m == 0)
    opt.flat_grads.zero_()
    loss.backward()
    clip_and_adam_step(opt, plan.lr, cfg, plan.book.run)


def update_metrics(plan: UpdatePlan) -> Dict[str, torch.Tensor]:
    """The 14 metrics averaged over the minibatches run, their count and
    the explained variance (on the raw scale), as device scalars; with
    PopArt its new mean and std (train.py:173-175), with the entropy
    controller the coefficient the update used (train.py:246)."""
    book, data = plan.book, plan.data
    metrics = dict(zip(METRIC_KEYS, book.sums / torch.clamp(book.count, min=1.0)))
    metrics["num_minibatch_updates"] = book.count
    metrics["explained_variance"] = compute_explained_variance(
        data["old_values"], data["returns"], data["valid"]
    )
    if plan.popart is not None:
        metrics["value_norm/mean"] = plan.popart.mean.clone()
        metrics["value_norm/std"] = plan.popart.std
    if plan.controller is not None:
        metrics["adaptive_ent_coef"] = plan.controller.coef.clone()
    return metrics


def ppo_update(
    network: torch.nn.Module,
    opt: AdamState,
    data: Dict[str, torch.Tensor],
    rng: RandomSource,
    lr: torch.Tensor,
    ent_coef: torch.Tensor,
    cfg: PPOUpdateConfig,
    may_have_invalid: bool = False,
) -> Dict[str, torch.Tensor]:
    """num_epochs x num_minibatches PPO steps on flattened [N, ...] data
    (obs already normalized, actions, old_log_probs, advantages, returns,
    old_values, valid, optional action_masks and privileged_obs, which the
    shuffle carries like every other column). Updates ``network`` and
    ``opt`` in place; returns the metrics as device scalars. ``lr`` and
    ``ent_coef``: 0-dim f32 tensors on the data's device (a CUDA graph of
    the update reads them there). Reads nothing back: every minibatch
    runs, those after a KL stop changing nothing.

    ``may_have_invalid``: the valid column carries real zeros (vs-pool
    rollouts mark opponent turns invalid), so a minibatch can have no
    valid row even without padding; such minibatches are skipped."""
    plan = plan_update(data, rng, lr, ent_coef, cfg, may_have_invalid)
    for e in range(cfg.num_epochs):
        for m in range(cfg.num_minibatches):
            update_minibatch(network, opt, plan, cfg, e, m)
    return update_metrics(plan)

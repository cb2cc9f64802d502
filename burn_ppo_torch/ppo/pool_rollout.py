"""Rollout collection against historical opponents (vs-pool), with kernel K7.

Counterpart of burn_ppo_tpu/ppo/pool_rollout.py:58-303. A fraction of the
envs plays against sampled past checkpoints: envs ``[0, L)`` are pure
self-play (the learner plays every seat), envs ``[L, E)`` are pool envs
(the learner plays seat ``learner_seat[e]``, every other seat the
opponent in rotation slot ``seat_opp[e, seat]``). Step t
(``pool_rollout_step``) writes its outputs, the learner turns and the
seating among them, into slice t of a ``RolloutBuffers``. Per step, in
the reference's order:

  1. the learner forward on ALL E envs (its values are used everywhere;
     a CTDE learner's critic reads the raw privileged obs,
     pool_rollout.py:154-157) and its sample (K2);
  2. the opponents' actor forward on the pool block, only for each row's
     acting slot (``opponent_actor_forward``, kernel K7 on CUDA), and
     their sample (K2, with uniforms of their own);
  3. the env step with auto-reset (K4 or K11); ``valid = learner_turn``;
  4. the episode log and the seating are captured BEFORE the reseat; then
     envs whose episode ended get a new learner seat and new opponent
     slots, bounded by the rotation's active count.

The per-player last values change on learner turns only. Values are
always the learner critic's; opponents contribute actions only.

``opponent_actor_forward`` computes, per pool row, the acting slot's
obs normalisation (the identity while that slot's count < 2) and actor
MLP. Its plain version is the JAX formulation: K dense forwards over
every row, then a selection by slot (pool_rollout.py:126-139, 171-178).
JAX runs the learner's own network over the stacked opponents, so with
the bf16 compute dtype the opponents' dense layers take bf16 operands
too: such a stack holds its weights rounded to bf16 once, at the
rotation (``actor_params(network, "bfloat16")``), and K7 runs a stack of
bf16 weights through its bf16 tower, which reads the stack's packed
layers (``OpponentStack.packed``, ``ppo/opponent_pack.py``). Eval's
stacked models stay f32.

A CNN opponent (``OpponentStack.cnn``) runs in two launches, each row
under its own slot only: K20 (``opponent_cnn_front``) normalises a
row's spatial obs by its slot and runs the slot's whole conv stack on
chip, writing the last conv's output [Ep, C', H, W] (before its relu),
and K7's feature front (``opponent_features_forward``) loads each row's
features, relu'd, in that NCHW order (the packed first FC layer's rows
permuted to match JAX's NHWC flatten), then the row's extra obs columns
normalised by its slot, and runs the FC tower and the policy head.
``opponent_cnn_forward_plain`` is the JAX formulation from the raw obs:
every slot's stack over every row, then the selection.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, field, replace
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from burn_ppo_torch import kernels
from burn_ppo_torch.envs.base import Environment, EpisodeLog
from burn_ppo_torch.models.core import BF16, activation_fn, check_compute_dtype, round_bf16
from burn_ppo_torch.ops.categorical import TINY, masked_sample
from burn_ppo_torch.ppo.opponent_pack import PackedTower, k_block, nchw_rows, pack_tower
from burn_ppo_torch.ppo.normalization import (
    ObsNormState,
    PopArtState,
    obs_norm_apply,
    return_norm_roll,
)
from burn_ppo_torch.ppo.rollout import (
    RandomSource,
    RolloutBatch,
    RolloutBuffers,
    RolloutCarry,
    apply_env_context,
    finish_rollout,
    sample_and_store_values,
)

ACTIVATIONS = {"relu": 1, "tanh": 2}


@dataclass
class ActorParams:
    """One opponent's actor tower in the JAX layout: a weight ``[in, out]``
    and a bias ``[out]`` per hidden layer, then the policy head; the
    weights f32, or bf16 for the bf16 compute dtype (the biases stay
    f32). A CNN's also holds its conv layers, OIHW weights and biases
    (f32; with the bf16 compute dtype the weights hold bf16 values, the
    card's bf16 conv being an f32 conv of rounded operands), and the obs
    shape (H, W, C) of the spatial slice they read."""

    weights: List[torch.Tensor]
    biases: List[torch.Tensor]
    activation: str
    conv_weights: Optional[List[torch.Tensor]] = None
    conv_biases: Optional[List[torch.Tensor]] = None
    obs_shape: Optional[Tuple[int, int, int]] = None


def actor_params(network, compute_dtype: Optional[str] = None) -> ActorParams:
    """A copy of a network's actor tower (the MLP's shared layers, the
    CTDE actor's layers, or the CNN's convs and FC layers; then the policy
    head), detached from the live parameters, its weights rounded to bf16
    with ``compute_dtype="bfloat16"``. An opponent never reads the critic
    (nor a split CNN's critic convs)."""
    check_compute_dtype(compute_dtype)
    convs = None
    if network.network_type == "mlp":
        layers = list(network.layers) + [network.policy_head]
    elif network.network_type == "ctde":
        layers = list(network.actor_layers) + [network.policy_head]
    else:
        layers = list(network.fc_layers) + [network.policy_head]
        convs = list(network.conv_layers)
    bf16 = compute_dtype == BF16
    wdtype = torch.bfloat16 if bf16 else torch.float32
    params = ActorParams(
        weights=[layer.weight.detach().T.to(wdtype).contiguous() for layer in layers],
        biases=[layer.bias.detach().clone() for layer in layers],
        activation=network.activation,
    )
    if convs is not None:
        params.conv_weights = [(round_bf16(c.weight.detach()).float() if bf16
                                else c.weight.detach().clone()) for c in convs]
        params.conv_biases = [c.bias.detach().clone() for c in convs]
        params.obs_shape = tuple(network.obs_shape)
    return params


@dataclass
class OpponentStack:
    """The rotation's K opponents stacked on the device: weights ``[K, in,
    out]`` (f32, or bf16 for the bf16 compute dtype) and f32 biases
    ``[K, out]`` per layer, and the obs normalisers as ``[K, D]`` means
    and M2s and ``[K]`` counts (None: no normalisation). A CNN stack also
    holds its conv layers, the K opponents' OIHW weights stacked as
    ``[K * C_out, C_in, kh, kw]`` and biases ``[K * C_out]`` per layer
    (slot k's at rows ``[k * C_out, (k + 1) * C_out)``, which K20 reads
    as one block), and the obs shape; ``weights`` and ``biases`` are then
    its FC tower and head.

    A stack of bf16 weights and a CNN stack also hold their tower packed
    for K7's bf16 tower and feature front (``packed``, made from the
    weights at construction, ``ppo/opponent_pack.py``; a CNN's first FC
    layer in the conv output's NCHW order): a leaf of the stack, which
    ``copy_into`` carries with the weights at each rotation."""

    weights: List[torch.Tensor]
    biases: List[torch.Tensor]
    activation: str
    norm: Optional[ObsNormState] = None
    conv_weights: Optional[List[torch.Tensor]] = None
    conv_biases: Optional[List[torch.Tensor]] = None
    obs_shape: Optional[Tuple[int, int, int]] = None
    packed: Optional[PackedTower] = field(default=None, init=False)

    def __post_init__(self):
        if self.bf16 or self.cnn:
            self.packed = pack_tower(self.weights, self.first_rows())

    @property
    def bf16(self) -> bool:
        """Whether the weights are bf16 (K7's bf16 tower; a CNN stack's
        convs then take bf16-rounded operands)."""
        return self.weights[0].dtype == torch.bfloat16

    @property
    def cnn(self) -> bool:
        return self.conv_weights is not None

    @property
    def num_slots(self) -> int:
        return self.weights[0].shape[0]

    def first_rows(self) -> Optional[torch.Tensor]:
        """The order in which K7's feature front reads the first FC layer's
        input rows (``nchw_rows``), or None: a raw-obs tower reads them in
        order."""
        if not self.cnn:
            return None
        channels = self.conv_weights[-1].shape[0] // self.num_slots
        return nchw_rows(self.obs_shape, channels, self.weights[0].shape[1],
                         self.weights[0].device)

    @staticmethod
    def of(params: Sequence[ActorParams], norms: Optional[Sequence[ObsNormState]]):
        acts = {p.activation for p in params}
        if len(acts) != 1:
            raise ValueError(f"opponents with mixed activations {sorted(acts)}")
        if len({p.obs_shape for p in params}) != 1:
            raise ValueError("opponents of mixed towers: CNN and MLP, or other obs shapes")
        depth = len(params[0].weights)
        cnn = params[0].obs_shape is not None
        convs = range(len(params[0].conv_weights)) if cnn else range(0)
        return OpponentStack(
            weights=[torch.stack([p.weights[i] for p in params]) for i in range(depth)],
            biases=[torch.stack([p.biases[i] for p in params]) for i in range(depth)],
            activation=acts.pop(),
            norm=None if norms is None else ObsNormState(
                mean=torch.stack([n.mean for n in norms]), m2=torch.stack([n.m2 for n in norms]),
                count=torch.stack([n.count for n in norms])),
            conv_weights=[torch.cat([p.conv_weights[i] for p in params]) for i in convs]
            if cnn else None,
            conv_biases=[torch.cat([p.conv_biases[i] for p in params]) for i in convs]
            if cnn else None,
            obs_shape=params[0].obs_shape,
        )


def _by_slot(obs: torch.Tensor, norm: Optional[ObsNormState], K: int,
             clip: float) -> torch.Tensor:
    """The obs [Ep, D] under each slot's normaliser, [K, Ep, D] (the
    identity while a slot's count < 2; a view of obs without norms)."""
    x = obs.unsqueeze(0).expand(K, *obs.shape)
    if norm is None:
        return x
    var = norm.m2 / torch.clamp(norm.count, min=1.0)[:, None]
    std = torch.clamp(torch.sqrt(var), min=1e-8)[:, None, :]
    normalized = torch.clamp((x - norm.mean[:, None, :]) / std, -clip, clip)
    return torch.where((norm.count < 2.0)[:, None, None], x, normalized)


def _tower_plain(x: torch.Tensor, stack: OpponentStack) -> torch.Tensor:
    """Every slot's FC tower and head over its rows: x [K, Ep, in] ->
    logits [K, Ep, A], one ``bmm`` a layer. A stack of bf16 weights rounds
    each layer's input to bf16 and takes the f32 product of it and the
    bf16 weights (exact products, f32 sums) plus the f32 bias, as JAX's
    dense does."""
    act = activation_fn(stack.activation)
    depth = len(stack.weights)
    for i, (w, b) in enumerate(zip(stack.weights, stack.biases)):
        if stack.bf16:
            x, w = x.to(torch.bfloat16).float(), w.float()
        x = torch.bmm(x, w) + b[:, None, :]
        if i < depth - 1:
            x = act(x)
    return x


def _select(logits_k: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """Each row's acting slot of [K, Ep, A]; a row whose slot is outside
    [0, K) gets zeros, as JAX's one-hot contraction gives."""
    K = logits_k.shape[0]
    inside = (slot >= 0) & (slot < K)
    rows = torch.arange(logits_k.shape[1], device=logits_k.device)
    picked = logits_k[torch.where(inside, slot, 0).long(), rows]
    return torch.where(inside[:, None], picked, 0.0)


def opponent_actor_forward_plain(obs: torch.Tensor, slot: torch.Tensor, stack: OpponentStack,
                                 clip: float = 10.0) -> torch.Tensor:
    """Plain PyTorch K7: every slot's normalisation and actor MLP over all
    rows ([K, Ep, A], one ``bmm`` per layer), then each row's acting slot
    (zeros outside [0, K)). A stack of bf16 weights rounds each layer's
    input to bf16 after the f32 normalisation and activation."""
    return _select(_tower_plain(_by_slot(obs, stack.norm, stack.num_slots, clip), stack), slot)


def opponent_cnn_forward_plain(obs: torch.Tensor, slot: torch.Tensor, stack: OpponentStack,
                               clip: float = 10.0) -> torch.Tensor:
    """The CNN opponents' logits as JAX computes them
    (burn_ppo_tpu/ppo/pool_rollout.py:126-139, 171-178;
    models/network.py:187-198): for every slot, its normalisation of the
    raw obs [Ep, D], its conv stack over the spatial slice (stride-1 SAME
    convs, relu), the flatten in NHWC order with the remaining obs columns
    appended, its FC tower and head, over every row; then each row's
    acting slot (zeros outside [0, K)). Slot by slot, one conv per slot
    and layer. A bf16 stack rounds each conv's input to bf16 (its weights
    hold bf16 values) and takes the f32 conv, as JAX's bf16 conv does."""
    K, (H, W, C), Ep = stack.num_slots, stack.obs_shape, obs.shape[0]
    n = H * W * C
    x = _by_slot(obs, stack.norm, K, clip)
    feats = []
    for k in range(K):
        h = x[k][:, :n].reshape(Ep, H, W, C).permute(0, 3, 1, 2)
        for w, b in zip(stack.conv_weights, stack.conv_biases):
            c_out = w.shape[0] // K
            if stack.bf16:
                h = h.to(torch.bfloat16).float()
            h = torch.relu(F.conv2d(h, w[k * c_out:(k + 1) * c_out], b[k * c_out:(k + 1) * c_out],
                                    padding="same"))
        feats.append(torch.cat([h.permute(0, 2, 3, 1).reshape(Ep, -1), x[k][:, n:]], dim=1))
    return _select(_tower_plain(torch.stack(feats), stack), slot)


def opponent_cnn_front_plain(obs: torch.Tensor, slot: torch.Tensor, stack: OpponentStack,
                             clip: float = 10.0, round_between: bool = True) -> torch.Tensor:
    """Plain PyTorch K20: each row's own slot's normalisation of the
    spatial slice of the raw obs [Ep, D] and its conv stack (stride-1 SAME
    convs, relu between them), the last conv's output before its relu,
    [Ep, C', H, W] f32 in NCHW order; zeros where the slot is outside [0,
    K). Slot by slot over the rows of each slot. A bf16 stack rounds each
    conv's input to bf16 (the normalised obs, each relu's output) and takes
    the f32 conv of the rounded values, as ``opponent_cnn_forward_plain``
    and JAX's bf16 conv do; ``round_between`` False leaves the relu outputs
    unrounded (the control of K20's bf16 check)."""
    K, (H, W, C), Ep = stack.num_slots, stack.obs_shape, obs.shape[0]
    n = H * W * C
    out = obs.new_zeros(Ep, stack.conv_weights[-1].shape[0] // K, H, W)
    norm = _columns(stack.norm, 0, n)
    for k in range(K):
        rows = slot == k
        x = obs[rows, :n]
        if norm is not None:
            x = _by_slot(x, ObsNormState(mean=norm.mean[k:k + 1], m2=norm.m2[k:k + 1],
                                         count=norm.count[k:k + 1]), 1, clip)[0]
        h = x.reshape(-1, H, W, C).permute(0, 3, 1, 2)
        for i, (w, b) in enumerate(zip(stack.conv_weights, stack.conv_biases)):
            if i:
                h = torch.relu(h)
            if stack.bf16 and (round_between or not i):
                h = round_bf16(h).float()
            c_out = w.shape[0] // K
            h = F.conv2d(h, w[k * c_out:(k + 1) * c_out], b[k * c_out:(k + 1) * c_out],
                         padding="same")
        out[rows] = h
    return out


def _columns(norm: Optional[ObsNormState], lo: int, hi: int) -> Optional[ObsNormState]:
    """The stacked normalisers of obs columns [lo, hi)."""
    if norm is None:
        return None
    return ObsNormState(mean=norm.mean[:, lo:hi], m2=norm.m2[:, lo:hi], count=norm.count)


def opponent_features_forward_plain(feat: torch.Tensor, obs: torch.Tensor, slot: torch.Tensor,
                                    stack: OpponentStack, clip: float = 10.0) -> torch.Tensor:
    """Plain PyTorch K7 with the feature front: each row's conv features
    ``feat`` [Ep, C', H, W] (its own slot's last conv, K20's output)
    relu'd and flattened in NHWC order (h W C' + w C' + c), then the obs
    columns past the spatial slice normalised by each slot; every slot's
    FC tower and head over every row; each row's acting slot (zeros
    outside [0, K))."""
    K, (H, W, C), Ep = stack.num_slots, stack.obs_shape, obs.shape[0]
    n = H * W * C
    f = torch.relu(feat).permute(0, 2, 3, 1).reshape(1, Ep, -1).expand(K, -1, -1)
    extras = _by_slot(obs[:, n:], _columns(stack.norm, n, obs.shape[1]), K, clip)
    return _select(_tower_plain(torch.cat([f, extras], dim=2), stack), slot)


# K7's tilings of its f32 tower (csrc/opponent_actor.cu TILINGS): rows per
# cluster tile and blocks per cluster, the blocks of a cluster splitting
# each layer's columns. By default the kernel takes 32 x 3 when the
# expected clusters fit on the card at once, a block an SM, else 32 x 2
# (PERF.md, B11).
OPPONENT_TILINGS = ((32, 2), (32, 3))
# What K7 takes: widths of the obs, hidden layers and head; slots.
_OPP_MAX_WIDTH, _OPP_MAX_HEAD, _OPP_MAX_LAYERS, _OPP_MAX_SLOTS = 512, 64, 4, 128


def actor_widths(network) -> Optional[List[int]]:
    """The widths [D, hidden..., A] of a network's actor tower as K7 reads
    it from the raw obs, or None for a tower whose K7 front reads conv
    features (the CNN: ``cnn_actor_widths``)."""
    if network.network_type not in ("mlp", "ctde"):
        return None
    return [network.obs_dim] + [network.hidden_size] * network.num_hidden + [network.action_count]


def cnn_actor_widths(obs_shape: Sequence[int], obs_dim: int, last_channels: int,
                     fc_widths: Sequence[int], action_count: int) -> List[int]:
    """The widths [F, fc..., A] of a CNN's actor tower behind its convs, as
    K7's feature front reads it: F the flatten of the last conv
    (H W ``last_channels``) plus the obs columns past the spatial slice."""
    H, W, C = obs_shape
    return [H * W * last_channels + obs_dim - H * W * C, *fc_widths, action_count]


def opponent_tower_problems(widths: Sequence[int], num_slots: int) -> List[str]:
    """What K7 does not take of a tower of ``widths`` [D, hidden..., A] with
    ``num_slots`` slots; empty where it takes it."""
    D, hidden, depth = widths[0], list(widths[1:-1]), len(widths) - 1
    problems = []
    if not 1 <= depth <= _OPP_MAX_LAYERS:
        problems.append(f"{depth} layers (1 to {_OPP_MAX_LAYERS})")
    if not 1 <= D <= _OPP_MAX_WIDTH:
        problems.append(f"obs width {D} (1 to {_OPP_MAX_WIDTH})")
    if any(h % 32 or not 32 <= h <= _OPP_MAX_WIDTH for h in hidden):
        problems.append(f"hidden widths {hidden} (multiples of 32 up to {_OPP_MAX_WIDTH})")
    if not 1 <= widths[-1] <= _OPP_MAX_HEAD:
        problems.append(f"head width {widths[-1]} (1 to {_OPP_MAX_HEAD})")
    if not 1 <= num_slots <= _OPP_MAX_SLOTS:
        problems.append(f"{num_slots} slots (1 to {_OPP_MAX_SLOTS})")
    return problems


# What K20 takes, for the config-time refusal (csrc/opponent_cnn_front.cu's
# MAX_ constants; its entries refuse the rest on the device path): conv
# layers, channels a layer, kernel sizes, cells of the zero-haloed plane
# (H + ks - 1)(W + ks - 1).
_CNN_MAX_LAYERS, _CNN_MAX_CHANNELS, _CNN_MAX_KERNEL, _CNN_MAX_PLANE = 4, 32, 5, 256


def cnn_front_problems(obs_shape: Sequence[int], channels: Sequence[int], kernel_size: int,
                       num_slots: int) -> List[str]:
    """What K20 does not take of a conv stack on an ``obs_shape`` (H, W, C)
    board: ``channels`` [C, C_1, ..., C_L] (the obs channels, then each
    layer's outputs), square kernels of ``kernel_size``, ``num_slots``
    slots; empty where it takes it."""
    (H, W, _), depth = obs_shape, len(channels) - 1
    problems = []
    if not 1 <= depth <= _CNN_MAX_LAYERS:
        problems.append(f"{depth} conv layers (1 to {_CNN_MAX_LAYERS})")
    if any(not 1 <= c <= _CNN_MAX_CHANNELS for c in channels):
        problems.append(f"conv channels {list(channels)} (1 to {_CNN_MAX_CHANNELS})")
    if not 1 <= kernel_size <= _CNN_MAX_KERNEL:
        problems.append(f"kernel size {kernel_size} (1 to {_CNN_MAX_KERNEL})")
    elif (H + kernel_size - 1) * (W + kernel_size - 1) > _CNN_MAX_PLANE:
        problems.append(f"a {H} x {W} board with {kernel_size} x {kernel_size} kernels (a padded "
                        f"plane of at most {_CNN_MAX_PLANE} cells)")
    if not 1 <= num_slots <= _OPP_MAX_SLOTS:
        problems.append(f"{num_slots} slots (1 to {_OPP_MAX_SLOTS})")
    return problems


def _tower_args(obs: torch.Tensor, slot: torch.Tensor, stack: OpponentStack, D: int,
                clip: float, what: str) -> tuple:
    """K7's arguments up to the tiling (its C entries share them), the
    tower of input width ``D`` checked against what the kernel takes, and
    the output [Ep, A]. A bf16 or CNN stack passes its packed layers, an
    f32 raw-obs stack its weights."""
    norm = stack.norm
    wdtype = torch.bfloat16 if stack.bf16 else torch.float32
    Ep, obs_dim = obs.shape
    K = stack.num_slots
    widths = [D] + [w.shape[2] for w in stack.weights]
    problems = opponent_tower_problems(widths, K)
    if problems:
        raise ValueError(f"{what}: the kernel does not take " + ", ".join(problems))
    kernels.expect(obs, "obs", torch.float32, (Ep, obs_dim))
    kernels.expect(slot, "slot", torch.int32, (Ep,))
    if norm is not None:
        kernels.expect(norm.mean, "norm.mean", torch.float32, (K, obs_dim))
        kernels.expect(norm.m2, "norm.m2", torch.float32, (K, obs_dim))
        kernels.expect(norm.count, "norm.count", torch.float32, (K,))
    for i, (w, b) in enumerate(zip(stack.weights, stack.biases)):
        kernels.expect(w, f"weights[{i}]", wdtype, (K, widths[i], widths[i + 1]))
        kernels.expect(b, f"biases[{i}]", torch.float32, (K, widths[i + 1]))
    layers = stack.weights
    if stack.bf16 or stack.cnn:
        if stack.packed is None or len(stack.packed.layers) != len(layers):
            raise ValueError(f"{what}: the stack holds no packed tower of its weights")
        layers = stack.packed.layers
        for i, w in enumerate(layers):
            kb, nt = -(-widths[i] // k_block(wdtype)), -(-widths[i + 1] // 8)
            kernels.expect(w, f"packed.layers[{i}]", wdtype,
                           (K, kb, nt, 32, 16 // w.element_size()))
    for i, w in enumerate(layers):
        if w.data_ptr() % 16:
            raise ValueError(f"layer {i}: the kernel's 16-byte copies need an aligned buffer")
    out = torch.empty(Ep, widths[-1], dtype=torch.float32, device=obs.device)
    depth = len(layers)
    p = kernels.ptr
    w_ptrs = (ctypes.c_void_p * depth)(*(w.data_ptr() for w in layers))
    b_ptrs = (ctypes.c_void_p * depth)(*(b.data_ptr() for b in stack.biases))
    norm_ptrs = (None,) * 3 if norm is None else (p(norm.mean), p(norm.m2), p(norm.count))
    args = (p(obs), p(slot), *norm_ptrs, float(clip), w_ptrs, b_ptrs,
            (ctypes.c_int * (depth + 1))(*widths), depth, ACTIVATIONS[stack.activation], p(out),
            Ep, K)
    return args, out


def _feature_width(stack: OpponentStack, obs_dim: int) -> int:
    """The width of a CNN stack's tower input: the last conv's flatten
    plus the obs columns past the spatial slice."""
    H, W, C = stack.obs_shape
    return H * W * (stack.conv_weights[-1].shape[0] // stack.num_slots) + obs_dim - H * W * C


def _stack_tensors(stack: OpponentStack) -> list:
    norm = stack.norm
    ts = [*stack.weights, *stack.biases, *(stack.conv_weights or []), *(stack.conv_biases or [])]
    return ts if norm is None else ts + [norm.mean, norm.m2, norm.count]


def opponent_actor_forward(obs: torch.Tensor, slot: torch.Tensor, stack: OpponentStack,
                           clip: float = 10.0, tiling: Optional[int] = None) -> torch.Tensor:
    """Each pool row's policy logits under its acting slot's opponent:
    raw obs [Ep, D], slot [Ep] i32 -> logits [Ep, A]. CPU tensors take the
    plain version; CUDA tensors launch K7 (one launch, every layer of a
    tile of one slot's rows on chip), or raise. The weights' dtype selects
    the tower: f32 weights 3xTF32 on the tensor cores
    (``csrc/opponent_actor.cu``, ``opponent_mlp_kernel``; ``tiling``
    indexes ``OPPONENT_TILINGS``); bf16 weights the bf16 tower
    (``csrc/opponent_tower.cu``, ``opponent_tower_bf16_kernel``: the stack's
    packed layers moved by bulk copies into a ring of shared-memory
    stages, the normalised obs and the activations held as bf16, one
    ``mma.sync`` m16n8k16 bf16 product a step with f32 sums, f32 bias and
    activation, f32 logits; one tiling, 32 rows and a cluster of 2
    blocks). ``launches`` counts both; the device's kernel names tell them
    apart. ``tiling`` None: the kernel's choice; only the f32 tower takes
    one.

    A CNN stack runs K20 (``opponent_cnn_front``) and K7's feature front
    (``opponent_features_forward``), each counted by its own wrapper; this
    wrapper's ``launches`` counts K7's raw-obs launches only."""
    if tiling is not None and (stack.cnn or stack.bf16):
        raise ValueError("tiling: only K7's f32 tower over the raw obs offers tilings")
    if stack.cnn:
        feat = opponent_cnn_front(obs, slot, stack, clip)
        return opponent_features_forward(feat, obs, slot, stack, clip)
    if kernels.on_cpu(obs, slot, *_stack_tensors(stack)):
        return opponent_actor_forward_plain(obs, slot, stack, clip)
    args, out = _tower_args(obs, slot, stack, obs.shape[1], clip, "opponent_actor_forward")
    if stack.bf16:
        err = kernels.library().opp_tower_forward(*args, kernels.stream(obs.device))
        kernels.check(err, "opp_tower_forward")
    else:
        tiling = -1 if tiling is None else tiling
        if not -1 <= tiling < len(OPPONENT_TILINGS):
            raise ValueError(f"tiling {tiling}: expected an index of {OPPONENT_TILINGS}")
        err = kernels.library().opp_mlp_forward(*args, tiling, kernels.stream(obs.device))
        kernels.check(err, "opp_mlp_forward")
    opponent_actor_forward.launches += 1
    return out


kernels.counted(opponent_actor_forward)


def opponent_cnn_front(obs: torch.Tensor, slot: torch.Tensor, stack: OpponentStack,
                       clip: float = 10.0) -> torch.Tensor:
    """K20: each pool row's normalisation and conv stack under its own
    slot's CNN opponent, raw obs [Ep, D] and slot [Ep] i32 -> the last
    conv's output [Ep, C', H, W] f32 before its relu (zeros outside [0,
    K)). CPU tensors take ``opponent_cnn_front_plain``; CUDA tensors
    launch ``csrc/opponent_cnn_front.cu`` (one launch: a block a tile of
    one slot's rows, the slot's conv weights in shared memory, the
    normalised rows and every layer's activations in zero-haloed shared
    buffers, f32 FFMA products; bf16 operands for a bf16 stack), or
    raise: the entry refuses a stack past the kernel's limits (those
    ``cnn_front_problems`` names at config time)."""
    norm = stack.norm
    if kernels.on_cpu(obs, slot, *_stack_tensors(stack)):
        return opponent_cnn_front_plain(obs, slot, stack, clip)
    Ep, D = obs.shape
    K, (H, W, C) = stack.num_slots, stack.obs_shape
    ws, bs = stack.conv_weights, stack.conv_biases
    channels = [C] + [w.shape[0] // K for w in ws]
    ks = ws[0].shape[2]
    if H * W * C > D:
        raise ValueError(f"opponent_cnn_front: obs shape {stack.obs_shape} past the obs width {D}")
    kernels.expect(obs, "obs", torch.float32, (Ep, D))
    kernels.expect(slot, "slot", torch.int32, (Ep,))
    if norm is not None:
        kernels.expect(norm.mean, "norm.mean", torch.float32, (K, D))
        kernels.expect(norm.m2, "norm.m2", torch.float32, (K, D))
        kernels.expect(norm.count, "norm.count", torch.float32, (K,))
    for i, (w, b) in enumerate(zip(ws, bs)):
        kernels.expect(w, f"conv_weights[{i}]", torch.float32,
                       (K * channels[i + 1], channels[i], ks, ks))
        kernels.expect(b, f"conv_biases[{i}]", torch.float32, (K * channels[i + 1],))
    out = torch.empty(Ep, channels[-1], H, W, dtype=torch.float32, device=obs.device)
    p, depth = kernels.ptr, len(ws)
    norm_ptrs = (None,) * 3 if norm is None else (p(norm.mean), p(norm.m2), p(norm.count))
    err = kernels.library().opp_cnn_front(
        p(obs), p(slot), *norm_ptrs, float(clip),
        (ctypes.c_void_p * depth)(*(w.data_ptr() for w in ws)),
        (ctypes.c_void_p * depth)(*(b.data_ptr() for b in bs)),
        (ctypes.c_int * (depth + 1))(*channels), depth, ks, H, W, D, p(out), Ep, K,
        int(stack.bf16), kernels.stream(obs.device))
    kernels.check(err, "opp_cnn_front")
    opponent_cnn_front.launches += 1
    return out


kernels.counted(opponent_cnn_front)


def opponent_features_forward(feat: torch.Tensor, obs: torch.Tensor, slot: torch.Tensor,
                              stack: OpponentStack, clip: float = 10.0) -> torch.Tensor:
    """K7 with its feature front: each pool row's logits under its acting
    slot's CNN opponent, from its slot's last conv output ``feat`` [Ep, C',
    H, W] (K20's, before its relu) and the raw obs [Ep, D]. CPU tensors
    take ``opponent_features_forward_plain``; CUDA tensors launch
    ``csrc/opponent_features.cu`` (``opponent_features_kernel``, 3xTF32,
    or ``opponent_features_bf16_kernel``): one block a tile of 16 of one
    slot's rows, the slot's packed tower in shared memory; a row reads its
    ``feat`` row as one contiguous range (the packed first layer in that
    NCHW order), relu'd, then its obs columns past the spatial slice
    normalised by its slot. A ``feat`` that is not contiguous is copied
    into one first. Counted apart from ``opponent_actor_forward``."""
    if kernels.on_cpu(feat, obs, slot, *_stack_tensors(stack)):
        return opponent_features_forward_plain(feat, obs, slot, stack, clip)
    Ep, D = obs.shape
    K, (H, W, C) = stack.num_slots, stack.obs_shape
    cc = stack.conv_weights[-1].shape[0] // K
    if feat.dtype != torch.float32 or tuple(feat.shape) != (Ep, cc, H, W):
        raise ValueError(f"feat: expected f32 [{Ep}, {cc}, {H}, {W}] (the last conv's "
                         f"channels), got {feat.dtype} {tuple(feat.shape)}")
    args, out = _tower_args(obs, slot, stack, _feature_width(stack, D), clip,
                            "opponent_features_forward")
    feat = feat.contiguous()
    err = kernels.library().opp_features_forward(
        *args, int(stack.bf16), kernels.ptr(feat), cc * H * W, H * W * C,
        kernels.stream(obs.device))
    kernels.check(err, "opp_features_forward")
    opponent_features_forward.launches += 1
    return out


kernels.counted(opponent_features_forward)


@dataclass
class PoolSeating:
    """Per-env seating (burn_ppo_tpu/ppo/pool_rollout.py:58-74)."""

    learner_seat: torch.Tensor  # [E] i32; -1 = self-play env (learner everywhere)
    seat_opp: torch.Tensor  # [E, P] i32 opponent slot per seat (learner seat ignored)

    @staticmethod
    def create(num_envs: int, num_learner_envs: int, num_players: int, num_slots: int,
               rng: RandomSource) -> "PoolSeating":
        seats = rng.integers((num_envs,), 0, num_players)
        is_selfplay = torch.arange(num_envs, device=seats.device) < num_learner_envs
        return PoolSeating(
            learner_seat=torch.where(is_selfplay, -1, seats).to(torch.int32),
            seat_opp=rng.integers((num_envs, num_players), 0, max(num_slots, 1)),
        )


@dataclass
class PoolStepLog:
    """Per-step record for the host bookkeeping (win rates, ratings), [T, ...]."""

    episode: EpisodeLog
    learner_seat: torch.Tensor  # [T, E] seat BEFORE the reseat
    seat_opp: torch.Tensor  # [T, E, P] slots BEFORE the resample


def pool_rollout_step(
    network,
    env: Environment,
    opponents: OpponentStack,
    carry: RolloutCarry,
    seating: PoolSeating,
    obs_norm: Optional[ObsNormState],
    rng: RandomSource,
    buffers: RolloutBuffers,
    t: int,
    *,
    num_learner_envs: int,
    slot_hi: torch.Tensor,
    gamma: float,
    normalize_returns: bool,
    obs_clip: float = 10.0,
    popart: Optional[PopArtState] = None,
) -> Tuple[RolloutCarry, PoolSeating]:
    """One vs-pool step of every env, its outputs written into slice ``t``
    of ``buffers``; the reseat draws slots in [0, ``slot_hi``), a 0-dim
    integer tensor on the carry's device (a captured graph reads it at
    each replay). Returns the
    carry and the seating after the step (the carry as
    ``rollout.rollout_step`` returns it)."""
    E, A, P = carry.obs.shape[0], env.spec.num_actions, env.spec.num_players
    L = num_learner_envs
    Ep = E - L
    states, ret_norm, seat = carry.env_states, carry.return_norm, seating
    obs_raw, mask = carry.obs, carry.mask
    players = env.current_player(states)
    obs = obs_norm_apply(obs_norm, obs_raw, obs_clip) if obs_norm is not None else obs_raw
    logits, values = network(obs, carry.priv)
    # the values denormalized (pool_rollout.py:161-162) in K2's launch
    actions, log_probs, values = sample_and_store_values(
        logits, mask, rng.uniform((E, A), TINY, 1.0), values, popart, buffers, t)
    learner_turn = (seat.learner_seat < 0) | (players == seat.learner_seat)
    if Ep > 0:
        acting_slot = torch.gather(seat.seat_opp[L:], 1, players[L:].long()[:, None])[:, 0]
        opp_logits = opponent_actor_forward(obs_raw[L:].contiguous(), acting_slot.contiguous(),
                                            opponents, obs_clip)
        opp_actions, _ = masked_sample(opp_logits, mask[L:].contiguous(),
                                       rng.uniform((Ep, A), TINY, 1.0))
        actions = torch.cat([actions[:L], torch.where(learner_turn[L:], actions[L:], opp_actions)])
    out = env.step_autoreset(states, carry.episode_acc, actions, env.draw_reset(rng, E),
                             env.draw_step(rng, E))
    buffers.put(t, obs=obs_raw, actions=actions, all_rewards=out.rewards, dones=out.done,
                values=values, log_probs=log_probs, acting=players, masks=mask,
                valid=learner_turn.to(torch.float32), seat=seat.learner_seat,
                slots=seat.seat_opp, priv=carry.priv if buffers.priv is not None else None,
                log=out.log)
    if normalize_returns:
        # The rolling return advances for EVERY acting player; the stats
        # fold learner turns only, after the loop.
        acting_reward = torch.gather(out.rewards, 1, players.long()[:, None])[:, 0]
        new_returns, samples = return_norm_roll(
            ret_norm.returns, acting_reward, players, out.done, gamma
        )
        ret_norm = replace(ret_norm, returns=new_returns)
        buffers.put(t, samples=samples)
    # Reseat + resample where the episode just ended (after the capture
    # above).
    done = out.done > 0
    is_selfplay = torch.arange(E, device=done.device) < L
    new_seats = rng.integers((E,), 0, P)
    new_slots = rng.integers((E, P), 0, slot_hi)
    seat = PoolSeating(
        learner_seat=torch.where(done & ~is_selfplay, new_seats, seat.learner_seat),
        seat_opp=torch.where(done[:, None], new_slots, seat.seat_opp),
    )
    carry = replace(carry, env_states=out.state, episode_acc=out.acc, return_norm=ret_norm,
                    obs=out.obs, mask=out.mask, priv=out.priv)
    return carry, seat


def pool_step_log(buffers: RolloutBuffers) -> PoolStepLog:
    return PoolStepLog(episode=buffers.log, learner_seat=buffers.seat, seat_opp=buffers.slots)


def collect_rollouts_with_opponents(
    network,
    env: Environment,
    opponents: OpponentStack,
    carry: RolloutCarry,
    seating: PoolSeating,
    obs_norm: Optional[ObsNormState],
    rng: RandomSource,
    *,
    num_steps: int,
    num_learner_envs: int,
    num_active,
    gamma: float = 0.99,
    normalize_returns: bool = False,
    return_clip: float = 10.0,
    obs_clip: float = 10.0,
    env_context: Optional[dict] = None,
    buffers: Optional[RolloutBuffers] = None,
    popart: Optional[PopArtState] = None,
) -> Tuple[RolloutCarry, PoolSeating, RolloutBatch, PoolStepLog]:
    """The vs-pool rollout. ``num_active`` (<= the stacked slot count)
    bounds the slots drawn at a reseat: an int (0 counts as 1), or the
    bound itself as a 0-dim integer tensor on the carry's device. Per step the randoms are drawn in
    the reference's key order: learner uniforms [E, A], opponent uniforms
    [Ep, A], the env reset, the env step's own draw, new seats [E], new
    slots [E, P]. The batch and the log are views of ``buffers`` (made for
    this call when None); ``carry`` and ``seating`` are not written."""
    carry = apply_env_context(carry, env_context)
    if buffers is None:
        buffers = RolloutBuffers.create(env, num_steps, carry.obs.shape[0], carry.obs.device,
                                        privileged=network.is_ctde, samples=normalize_returns,
                                        pool=True)
    slot_hi = num_active
    if not isinstance(slot_hi, torch.Tensor):
        slot_hi = torch.tensor(max(num_active, 1), dtype=torch.int32, device=carry.obs.device)
    with torch.no_grad():
        for t in range(num_steps):
            carry, seating = pool_rollout_step(
                network, env, opponents, carry, seating, obs_norm, rng, buffers, t,
                num_learner_envs=num_learner_envs, slot_hi=slot_hi, gamma=gamma,
                normalize_returns=normalize_returns, obs_clip=obs_clip, popart=popart)
        carry = finish_rollout(carry, buffers, normalize_returns=normalize_returns,
                               return_clip=return_clip, valid=buffers.valid)
    return carry, seating, buffers.batch(), pool_step_log(buffers)

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
bf16 weights through its bf16 tower. Eval's stacked models stay f32.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, replace
from typing import List, Optional, Sequence, Tuple

import torch

from burn_ppo_torch import kernels
from burn_ppo_torch.envs.base import Environment, EpisodeLog
from burn_ppo_torch.models.core import BF16, activation_fn, check_compute_dtype
from burn_ppo_torch.ops.categorical import TINY, masked_sample
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
    f32)."""

    weights: List[torch.Tensor]
    biases: List[torch.Tensor]
    activation: str


def actor_params(network, compute_dtype: Optional[str] = None) -> ActorParams:
    """A copy of a network's actor tower (the MLP's shared layers, or the
    CTDE actor's layers, and the policy head), detached from the live
    parameters, its weights rounded to bf16 with ``compute_dtype=
    "bfloat16"``. K7 runs either unchanged: an opponent never reads the
    critic."""
    check_compute_dtype(compute_dtype)
    if network.network_type == "mlp":
        layers = list(network.layers) + [network.policy_head]
    elif network.network_type == "ctde":
        layers = list(network.actor_layers) + [network.policy_head]
    else:
        raise NotImplementedError(
            f"opponents of network_type {network.network_type!r}: ROADMAP A12b")
    wdtype = torch.bfloat16 if compute_dtype == BF16 else torch.float32
    return ActorParams(
        weights=[layer.weight.detach().T.to(wdtype).contiguous() for layer in layers],
        biases=[layer.bias.detach().clone() for layer in layers],
        activation=network.activation,
    )


@dataclass
class OpponentStack:
    """The rotation's K opponents stacked on the device: weights ``[K, in,
    out]`` (f32, or bf16 for the bf16 compute dtype) and f32 biases
    ``[K, out]`` per layer, and the obs normalisers as ``[K, D]`` means
    and M2s and ``[K]`` counts (None: no normalisation)."""

    weights: List[torch.Tensor]
    biases: List[torch.Tensor]
    activation: str
    norm: Optional[ObsNormState] = None

    @property
    def bf16(self) -> bool:
        """Whether the weights are bf16 (K7's bf16 tower)."""
        return self.weights[0].dtype == torch.bfloat16

    @property
    def num_slots(self) -> int:
        return self.weights[0].shape[0]

    @staticmethod
    def of(params: Sequence[ActorParams], norms: Optional[Sequence[ObsNormState]]):
        acts = {p.activation for p in params}
        if len(acts) != 1:
            raise ValueError(f"opponents with mixed activations {sorted(acts)}")
        depth = len(params[0].weights)
        stack = OpponentStack(
            weights=[torch.stack([p.weights[i] for p in params]) for i in range(depth)],
            biases=[torch.stack([p.biases[i] for p in params]) for i in range(depth)],
            activation=acts.pop(),
        )
        if norms is not None:
            stack.norm = ObsNormState(mean=torch.stack([n.mean for n in norms]),
                                      m2=torch.stack([n.m2 for n in norms]),
                                      count=torch.stack([n.count for n in norms]))
        return stack


def opponent_actor_forward_plain(obs: torch.Tensor, slot: torch.Tensor, stack: OpponentStack,
                                 clip: float = 10.0) -> torch.Tensor:
    """Plain PyTorch K7: every slot's normalisation and actor MLP over all
    rows ([K, Ep, A], one ``bmm`` per layer), then each row's acting slot
    (a row whose slot is outside [0, K) gets zeros, as JAX's one-hot
    contraction gives). A stack of bf16 weights rounds each layer's input
    to bf16 after the f32 normalisation and activation, and takes the f32
    product of it and the bf16 weights (exact products, f32 sums) plus
    the f32 bias, as JAX's dense does."""
    K = stack.num_slots
    x = obs.unsqueeze(0).expand(K, *obs.shape)
    if stack.norm is not None:
        n = stack.norm
        var = n.m2 / torch.clamp(n.count, min=1.0)[:, None]
        std = torch.clamp(torch.sqrt(var), min=1e-8)[:, None, :]
        normalized = torch.clamp((x - n.mean[:, None, :]) / std, -clip, clip)
        x = torch.where((n.count < 2.0)[:, None, None], x, normalized)
    act = activation_fn(stack.activation)
    depth = len(stack.weights)
    bf16 = stack.bf16
    for i, (w, b) in enumerate(zip(stack.weights, stack.biases)):
        if bf16:
            x, w = x.to(torch.bfloat16).float(), w.float()
        x = torch.bmm(x, w) + b[:, None, :]
        if i < depth - 1:
            x = act(x)
    inside = (slot >= 0) & (slot < K)
    rows = torch.arange(obs.shape[0], device=obs.device)
    picked = x[torch.where(inside, slot, 0).long(), rows]
    return torch.where(inside[:, None], picked, 0.0)


# K7's tilings (csrc/opponent_actor.cu TILINGS): rows per cluster tile and
# blocks per cluster, the blocks of a cluster splitting each layer's
# columns. By default the kernel takes 32 x 3 when the expected clusters
# fit on the card at once, a block an SM, else 32 x 2 (PERF.md, B11).
OPPONENT_TILINGS = ((32, 2), (32, 3))
# What K7 takes: widths of the obs, hidden layers and head; slots.
_OPP_MAX_WIDTH, _OPP_MAX_HEAD, _OPP_MAX_LAYERS, _OPP_MAX_SLOTS = 512, 64, 4, 128


def actor_widths(network) -> Optional[List[int]]:
    """The widths [D, hidden..., A] of a network's actor tower as
    ``actor_params`` reads it, or None for a tower K7 cannot run (the CNN)."""
    if network.network_type not in ("mlp", "ctde"):
        return None
    return [network.obs_dim] + [network.hidden_size] * network.num_hidden + [network.action_count]


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


def _check_opponent_tower(stack: OpponentStack, D: int) -> List[int]:
    """The tower's widths [D, hidden..., A], or ValueError for a tower K7
    does not take."""
    widths = [D] + [w.shape[2] for w in stack.weights]
    problems = opponent_tower_problems(widths, stack.num_slots)
    if problems:
        raise ValueError("opponent_actor_forward: the kernel does not take " + ", ".join(problems))
    return widths


def opponent_actor_forward(obs: torch.Tensor, slot: torch.Tensor, stack: OpponentStack,
                           clip: float = 10.0, tiling: Optional[int] = None) -> torch.Tensor:
    """Each pool row's policy logits under its acting slot's opponent:
    raw obs [Ep, D], slot [Ep] i32 -> logits [Ep, A]. CPU tensors take the
    plain version; CUDA tensors launch K7 (``csrc/opponent_actor.cu``: one
    launch, every layer of a tile of one slot's rows on chip), or raise.
    The weights' dtype selects the tower: f32 weights 3xTF32 on the tensor
    cores (``opponent_mlp_kernel``); bf16 weights the bf16 tower
    (``opponent_mlp_bf16_kernel``: the same slot grouping, tiles and
    clusters; the normalised obs and the activations held as bf16, the
    bf16 weights streamed, one ``mma.sync`` m16n8k16 bf16 product a step
    with f32 sums, f32 bias and activation, f32 logits). ``launches``
    counts both; the device's kernel names tell them apart. ``tiling``
    indexes ``OPPONENT_TILINGS`` (default: the kernel's choice)."""
    norm = stack.norm
    ts = [obs, slot, *stack.weights, *stack.biases]
    if norm is not None:
        ts += [norm.mean, norm.m2, norm.count]
    if kernels.on_cpu(*ts):
        return opponent_actor_forward_plain(obs, slot, stack, clip)
    wdtype = torch.bfloat16 if stack.bf16 else torch.float32
    Ep, D = obs.shape
    K = stack.num_slots
    widths = _check_opponent_tower(stack, D)
    kernels.expect(obs, "obs", torch.float32, (Ep, D))
    kernels.expect(slot, "slot", torch.int32, (Ep,))
    if norm is not None:
        kernels.expect(norm.mean, "norm.mean", torch.float32, (K, D))
        kernels.expect(norm.m2, "norm.m2", torch.float32, (K, D))
        kernels.expect(norm.count, "norm.count", torch.float32, (K,))
    for i, (w, b) in enumerate(zip(stack.weights, stack.biases)):
        kernels.expect(w, f"weights[{i}]", wdtype, (K, widths[i], widths[i + 1]))
        kernels.expect(b, f"biases[{i}]", torch.float32, (K, widths[i + 1]))
        if w.data_ptr() % 16:
            raise ValueError(f"weights[{i}]: the kernel's 16-byte copies need an aligned buffer")
    tiling = -1 if tiling is None else tiling
    if not -1 <= tiling < len(OPPONENT_TILINGS):
        raise ValueError(f"tiling {tiling}: expected an index of {OPPONENT_TILINGS}")
    dev = obs.device
    out = torch.empty(Ep, widths[-1], dtype=torch.float32, device=dev)
    depth = len(stack.weights)
    p = kernels.ptr
    w_ptrs = (ctypes.c_void_p * depth)(*(w.data_ptr() for w in stack.weights))
    b_ptrs = (ctypes.c_void_p * depth)(*(b.data_ptr() for b in stack.biases))
    norm_ptrs = (None,) * 3 if norm is None else (p(norm.mean), p(norm.m2), p(norm.count))
    err = kernels.library().opp_mlp_forward(
        p(obs), p(slot), *norm_ptrs, float(clip), w_ptrs, b_ptrs,
        (ctypes.c_int * (depth + 1))(*widths), depth, ACTIVATIONS[stack.activation], p(out), Ep,
        K, tiling, int(stack.bf16), kernels.stream(dev),
    )
    kernels.check(err, "opp_mlp_forward")
    opponent_actor_forward.launches += 1
    return out


kernels.counted(opponent_actor_forward)


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

"""Rollout collection against historical opponents (vs-pool), with kernel K7.

Counterpart of burn_ppo_tpu/ppo/pool_rollout.py:58-303. A fraction of the
envs plays against sampled past checkpoints: envs ``[0, L)`` are pure
self-play (the learner plays every seat), envs ``[L, E)`` are pool envs
(the learner plays seat ``learner_seat[e]``, every other seat the
opponent in rotation slot ``seat_opp[e, seat]``). Per step, in the
reference's order:

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
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch

from burn_ppo_torch import kernels
from burn_ppo_torch.envs.base import Environment, EpisodeLog
from burn_ppo_torch.models.core import activation_fn
from burn_ppo_torch.ops.categorical import TINY, masked_sample
from burn_ppo_torch.ppo.normalization import (
    ObsNormState,
    ReturnNormState,
    obs_norm_apply,
    return_norm_finalize,
    return_norm_roll,
)
from burn_ppo_torch.ppo.rollout import (
    RandomSource,
    RolloutBatch,
    RolloutCarry,
    advance_last_values,
    apply_env_context,
)

ACTIVATIONS = {"relu": 1, "tanh": 2}


@dataclass
class ActorParams:
    """One opponent's actor tower in the JAX layout: a weight ``[in, out]``
    and a bias ``[out]`` per hidden layer, then the policy head."""

    weights: List[torch.Tensor]
    biases: List[torch.Tensor]
    activation: str


def actor_params(network) -> ActorParams:
    """A copy of a network's actor tower (the MLP's shared layers, or the
    CTDE actor's layers, and the policy head), detached from the live
    parameters. K7 runs either unchanged: an opponent never reads the
    critic."""
    if network.network_type == "mlp":
        layers = list(network.layers) + [network.policy_head]
    elif network.network_type == "ctde":
        layers = list(network.actor_layers) + [network.policy_head]
    else:
        raise NotImplementedError(
            f"opponents of network_type {network.network_type!r}: ROADMAP A12b")
    return ActorParams(
        weights=[layer.weight.detach().T.contiguous() for layer in layers],
        biases=[layer.bias.detach().clone() for layer in layers],
        activation=network.activation,
    )


@dataclass
class OpponentStack:
    """The rotation's K opponents stacked on the device: weights ``[K, in,
    out]`` and biases ``[K, out]`` per layer, and the obs normalisers as
    ``[K, D]`` means and M2s and ``[K]`` counts (None: no normalisation)."""

    weights: List[torch.Tensor]
    biases: List[torch.Tensor]
    activation: str
    norm: Optional[ObsNormState] = None

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
    contraction gives)."""
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
    for i, (w, b) in enumerate(zip(stack.weights, stack.biases)):
        x = torch.bmm(x, w) + b[:, None, :]
        if i < depth - 1:
            x = act(x)
    inside = (slot >= 0) & (slot < K)
    rows = torch.arange(obs.shape[0], device=obs.device)
    picked = x[torch.where(inside, slot, 0).long(), rows]
    return torch.where(inside[:, None], picked, 0.0)


def opponent_actor_forward(obs: torch.Tensor, slot: torch.Tensor, stack: OpponentStack,
                           clip: float = 10.0) -> torch.Tensor:
    """Each pool row's policy logits under its acting slot's opponent:
    raw obs [Ep, D], slot [Ep] i32 -> logits [Ep, A]. CPU tensors take the
    plain version; CUDA tensors launch K7 (``csrc/opponent_actor.cu``:
    one counting sort of the rows by slot, then one slot-grouped dense
    launch per layer), or raise."""
    norm = stack.norm
    ts = [obs, slot, *stack.weights, *stack.biases]
    if norm is not None:
        ts += [norm.mean, norm.m2, norm.count]
    if kernels.on_cpu(*ts):
        return opponent_actor_forward_plain(obs, slot, stack, clip)
    Ep, D = obs.shape
    K = stack.num_slots
    kernels.expect(obs, "obs", torch.float32, (Ep, D))
    kernels.expect(slot, "slot", torch.int32, (Ep,))
    if norm is not None:
        kernels.expect(norm.mean, "norm.mean", torch.float32, (K, D))
        kernels.expect(norm.m2, "norm.m2", torch.float32, (K, D))
        kernels.expect(norm.count, "norm.count", torch.float32, (K,))
    fan_in = D
    for i, (w, b) in enumerate(zip(stack.weights, stack.biases)):
        kernels.expect(w, f"weights[{i}]", torch.float32, (K, fan_in, w.shape[2]))
        kernels.expect(b, f"biases[{i}]", torch.float32, (K, w.shape[2]))
        fan_in = w.shape[2]
    dev = obs.device
    lib, p, st = kernels.library(), kernels.ptr, kernels.stream(dev)
    perm = torch.empty(Ep, dtype=torch.int32, device=dev)
    offsets = torch.empty(K + 1, dtype=torch.int32, device=dev)
    kernels.check(lib.opp_slot_sort(p(slot), Ep, K, p(perm), p(offsets), st), "opp_slot_sort")
    act = ACTIVATIONS[stack.activation]
    x, depth = obs, len(stack.weights)
    for i, (w, b) in enumerate(zip(stack.weights, stack.biases)):
        first, last = i == 0, i == depth - 1
        n_in, n_out = w.shape[1], w.shape[2]
        # The last layer scatters back to row order; rows of an
        # out-of-range slot are never computed and keep the zeros.
        y = (torch.zeros if last else torch.empty)(Ep, n_out, dtype=torch.float32, device=dev)
        err = lib.opp_grouped_dense(
            p(x), p(perm) if first else None,
            p(norm.mean) if first and norm is not None else None,
            p(norm.m2) if first and norm is not None else None,
            p(norm.count) if first and norm is not None else None, float(clip),
            p(w), p(b), p(y), p(perm) if last else None, p(offsets),
            Ep, K, n_in, n_out, 0 if last else act, st,
        )
        kernels.check(err, "opp_grouped_dense")
        x = y
    opponent_actor_forward.launches += 1
    return x


opponent_actor_forward.launches = 0


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
    num_active: int,
    gamma: float = 0.99,
    normalize_returns: bool = False,
    return_clip: float = 10.0,
    obs_clip: float = 10.0,
    env_context: Optional[dict] = None,
) -> Tuple[RolloutCarry, PoolSeating, RolloutBatch, PoolStepLog]:
    """The vs-pool rollout. ``num_active`` (<= the stacked slot count)
    bounds the slots drawn at a reseat. Per step the randoms are drawn in
    the reference's key order: learner uniforms [E, A], opponent uniforms
    [Ep, A], the env reset, the env step's own draw, new seats [E], new
    slots [E, P]."""
    carry = apply_env_context(carry, env_context)
    E = carry.obs.shape[0]
    A, P = env.spec.num_actions, env.spec.num_players
    L = num_learner_envs
    Ep = E - L
    device = carry.obs.device
    is_selfplay = torch.arange(E, device=device) < L
    slot_hi = max(num_active, 1)
    cols: dict = {k: [] for k in ("obs", "actions", "rewards", "dones", "values", "log_probs",
                                  "acting", "masks", "valid", "samples", "seat", "slots", "priv")}
    log_cols: dict = {k: [] for k in ("completed", "total_rewards", "length", "outcome",
                                      "active_players")}
    states, acc, ret_norm = carry.env_states, carry.episode_acc, carry.return_norm
    obs_raw, mask, priv = carry.obs, carry.mask, carry.priv
    seat = seating
    with torch.no_grad():
        for _ in range(num_steps):
            players = env.current_player(states)
            obs = obs_norm_apply(obs_norm, obs_raw, obs_clip) if obs_norm is not None else obs_raw
            logits, values = network(obs, priv)
            actions, log_probs = masked_sample(logits, mask, rng.uniform((E, A), TINY, 1.0))
            learner_turn = (seat.learner_seat < 0) | (players == seat.learner_seat)
            if Ep > 0:
                acting_slot = torch.gather(seat.seat_opp[L:], 1, players[L:].long()[:, None])[:, 0]
                opp_logits = opponent_actor_forward(obs_raw[L:].contiguous(),
                                                    acting_slot.contiguous(), opponents, obs_clip)
                opp_actions, _ = masked_sample(opp_logits, mask[L:].contiguous(),
                                               rng.uniform((Ep, A), TINY, 1.0))
                actions = torch.cat(
                    [actions[:L], torch.where(learner_turn[L:], actions[L:], opp_actions)])
            out = env.step_autoreset(states, acc, actions, env.draw_reset(rng, E),
                                     env.draw_step(rng, E))
            for k, v in (("obs", obs_raw), ("actions", actions), ("rewards", out.rewards),
                         ("dones", out.done), ("values", values), ("log_probs", log_probs),
                         ("acting", players), ("masks", mask),
                         ("valid", learner_turn.to(torch.float32)),
                         ("seat", seat.learner_seat), ("slots", seat.seat_opp)):
                cols[k].append(v)
            if network.is_ctde:
                cols["priv"].append(priv)
            for k in log_cols:
                log_cols[k].append(getattr(out.log, k))
            if normalize_returns:
                # The rolling return advances for EVERY acting player; the
                # stats fold learner turns only, after the loop.
                acting_reward = torch.gather(out.rewards, 1, players.long()[:, None])[:, 0]
                new_returns, samples = return_norm_roll(
                    ret_norm.returns, acting_reward, players, out.done, gamma
                )
                ret_norm = ReturnNormState(new_returns, ret_norm.mean, ret_norm.m2, ret_norm.count)
                cols["samples"].append(samples)
            # Reseat + resample where the episode just ended (after the
            # capture above).
            done = out.done > 0
            new_seats = rng.integers((E,), 0, P)
            new_slots = rng.integers((E, P), 0, slot_hi)
            seat = PoolSeating(
                learner_seat=torch.where(done & ~is_selfplay, new_seats, seat.learner_seat),
                seat_opp=torch.where(done[:, None], new_slots, seat.seat_opp),
            )
            states, acc, obs_raw, mask, priv = out.state, out.acc, out.obs, out.mask, out.priv

    s = {k: torch.stack(v) for k, v in cols.items() if v}
    all_rewards, acting = s["rewards"], s["acting"]
    slot = acting.long()[..., None]
    rewards = torch.gather(all_rewards, 2, slot)[..., 0]
    if normalize_returns:
        ret_norm, rewards = return_norm_finalize(ret_norm, s["samples"], rewards, return_clip,
                                                 valid=s["valid"])
        all_rewards = all_rewards.scatter(2, slot, rewards[..., None])
    batch = RolloutBatch(
        obs=s["obs"], actions=s["actions"], rewards=rewards, all_rewards=all_rewards,
        dones=s["dones"], values=s["values"], log_probs=s["log_probs"], acting_players=acting,
        action_masks=s["masks"], valid_mask=s["valid"], privileged_obs=s.get("priv"),
    )
    logs = PoolStepLog(
        episode=EpisodeLog(**{k: torch.stack(v) for k, v in log_cols.items()}),
        learner_seat=s["seat"], seat_opp=s["slots"],
    )
    new_carry = RolloutCarry(
        env_states=states, episode_acc=acc, return_norm=ret_norm,
        last_value_per_player=advance_last_values(
            carry.last_value_per_player, batch.values, acting, batch.valid_mask),
        obs=obs_raw, mask=mask, priv=priv,
    )
    return new_carry, seat, batch, logs

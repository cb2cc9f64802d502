"""The post-rollout half of a train step on static inputs, replayed from
captured CUDA graphs on a card.

Counterpart of the rest of the JAX package's fused train-step program
(burn_ppo_tpu/train.py:110-249): after the rollout, the obs-normalizer
merge, the bootstrap value (denormalized with PopArt's old stats), GAE,
PopArt's merge of the raw returns and the value head's rescale (K15), the
batch's obs-norm apply, the flattening and padding, every epoch's
minibatches (the first stepping the adaptive entropy controller inside
K8, every one recording the mean entropy)
(burn_ppo_tpu/ppo/update.py:344-421, where ``lax.cond`` skips the
minibatches after a KL stop and the empty ones), the runtime-guard
counts and the episode summaries (K10), and with a ``WindowBook`` the
update window's records (K18, first) and report (K19, last)
(``ppo/window.py``): ``prepare_update``, then
``ppo/update.py``'s ``update_minibatch`` for each minibatch of each epoch
and ``update_metrics``, reading nothing back to the host: the KL stop and
the empty-minibatch skip are device flags (``ppo/update.py LossBook``),
so a skipped minibatch runs its forward and backward and K9 leaves
everything as it was.

``UpdateRunner`` runs it on inputs that keep their addresses from
update to update: the ``RolloutRunner``'s carry, obs-norm stats and
``RolloutBuffers`` (the update merges the batch into the runner's stats
in place, so the next rollout reads them where they are), the
network's flat parameter, gradient and moment buffers and the Adam
count (``AdamState``), the runner's PopArt stats, the entropy
controller's state (the runner's own, copied into from the caller's),
and the learning rate and entropy coefficient (the controller's target
when it is on) as 0-dim device tensors that ``run`` fills. On the CPU
it runs eagerly (the path the parity tests hold against JAX); on a card
it replays CUDA graphs captured at the runner's first update after one
eager warm-up on a side stream (the parameters, moments, count, obs-norm
and PopArt stats, the controller and the generator put back after it):

* without ``target_kl``, one graph of the whole update: nothing can stop
  a minibatch;
* with it, a graph per minibatch, the first also holding everything
  before the epochs and one more graph the metrics and summaries. After
  each minibatch graph the host queues a copy of the stop flag into
  pinned memory and an event behind it, waits, polling the event, until
  the copy has landed, and replays no further minibatch once it reads
  set: JAX's skipped minibatches (update.py:346-382, 411-420). The wait
  is a host wait on the device, one a minibatch, though not a stream or
  device synchronize (so ``torch.cuda.set_sync_debug_mode`` does not
  see it). Larger graphs run every minibatch after a stop as a no-op at
  the full cost of its GEMMs; reading the flag a graph behind costs one
  such no-op after each stop (``PERF.md``, row B15).

The epochs' permutations come from the generator of a
``TorchRandomSource``, registered with the graphs. The outputs (metrics,
summaries) are the graphs' own tensors, which the next replay
overwrites. A capture that fails raises; nothing falls back to the eager
loop.

``UpdateGraph`` counts replays, captures, the minibatch graphs skipped,
and each wrapper's launches in the graphs replayed, as ``RolloutGraph``
counts a rollout's.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

import torch

from burn_ppo_torch.config import Config
from burn_ppo_torch.envs.base import Environment
from burn_ppo_torch.ops.gae import compute_gae, compute_gae_multiplayer
from burn_ppo_torch.ppo.episode_stats import summarize_episode_logs
from burn_ppo_torch.ppo.entropy import AdaptiveEntropyState
from burn_ppo_torch.ppo.normalization import (
    ObsNormState,
    PopArtState,
    obs_norm_apply,
    obs_norm_update,
    popart_update_rescale,
)
from burn_ppo_torch.ppo.rollout import (
    RandomSource,
    RolloutBatch,
    RolloutCarry,
    TorchRandomSource,
    bootstrap_values,
)
from burn_ppo_torch.ppo.rollout_graph import (
    CapturedGraph,
    RolloutRunner,
    _clone,
    copy_into,
    state_leaves,
)
from burn_ppo_torch.ppo.update import (
    AdamState,
    PPOUpdateConfig,
    UpdatePlan,
    plan_update,
    update_metrics,
    update_minibatch,
)
from burn_ppo_torch.ppo.window import WindowBook, window_records


def update_config(cfg: Config) -> PPOUpdateConfig:
    return PPOUpdateConfig(
        clip_epsilon=cfg.clip_epsilon,
        clip_value=cfg.clip_value,
        value_coef=cfg.value_coef,
        max_grad_norm=cfg.max_grad_norm,
        num_epochs=cfg.num_epochs,
        num_minibatches=cfg.num_minibatches,
        target_kl=cfg.target_kl,
        adam_epsilon=cfg.adam_epsilon,
        shuffle_block_rows=cfg.shuffle_block_rows,
        ent_min_coef=cfg.adaptive_entropy_min_coef,
        ent_max_coef=cfg.adaptive_entropy_max_coef,
        ent_delta=cfg.adaptive_entropy_delta,
    )


def guard_counts(batch: RolloutBatch) -> Dict[str, torch.Tensor]:
    """Runtime-guard counts over a rollout (burn_ppo_tpu/train.py:185-204):
    rows with an empty action mask, and non-finite log-probs or values."""
    return {
        "invalid_mask_count": torch.sum(
            (torch.sum(batch.action_masks, dim=-1) == 0.0).to(torch.float32)
        ),
        "nonfinite_count": torch.sum((~torch.isfinite(batch.log_probs)).to(torch.float32))
        + torch.sum((~torch.isfinite(batch.values)).to(torch.float32)),
    }


def prepare_update(env: Environment, cfg: Config, network: torch.nn.Module,
                   carry: RolloutCarry, batch: RolloutBatch, obs_norm: Optional[ObsNormState],
                   rng: RandomSource, lr: torch.Tensor, ent_coef: torch.Tensor,
                   may_have_invalid: bool = False, popart: Optional[PopArtState] = None,
                   controller: Optional[AdaptiveEntropyState] = None) -> UpdatePlan:
    """Obs-normalizer merge, bootstrap, GAE, PopArt, flatten and the
    epochs' plan after a rollout (train.py:110-183, update.py:241-257).
    Lagged obs normalization: the update re-normalizes the batch with the
    stats the rollout used, then merges the raw batch into ``obs_norm`` in
    place, and the bootstrap reads the new stats. With ``popart`` the
    bootstrap denormalizes with its old stats, then the GAE returns (raw,
    the valid ones) merge into it in place and the value head is rescaled
    (K15), and the loss normalizes with the new stats."""
    obs_u = batch.obs
    if obs_norm is not None:
        obs_u = obs_norm_apply(obs_norm, batch.obs)
        obs_norm_update(obs_norm, batch.obs)
    last_values, last_vpp = bootstrap_values(network, env, carry, obs_norm, popart=popart)
    if env.spec.num_players > 1:
        advantages, returns = compute_gae_multiplayer(
            batch.all_rewards, batch.values, batch.dones, batch.acting_players, last_vpp,
            cfg.gamma, cfg.gae_lambda,
        )
    else:
        advantages, returns = compute_gae(
            batch.rewards, batch.values, batch.dones, last_values, cfg.gamma, cfg.gae_lambda
        )
    T, E = batch.actions.shape
    N = T * E
    data = {
        "obs": obs_u.reshape(N, -1),
        "actions": batch.actions.reshape(N),
        "old_log_probs": batch.log_probs.reshape(N),
        "advantages": advantages.reshape(N),
        "returns": returns.reshape(N),
        "old_values": batch.values.reshape(N),
        "valid": batch.valid_mask.reshape(N),
        "action_masks": batch.action_masks.reshape(N, env.spec.num_actions),
    }
    if batch.privileged_obs is not None:
        data["privileged_obs"] = batch.privileged_obs.reshape(N, -1)
    if popart is not None:
        kernel, bias = network.value_head_params()
        popart_update_rescale(popart, data["returns"], data["valid"], kernel, bias)
    return plan_update(data, rng, lr, ent_coef, update_config(cfg), may_have_invalid, popart,
                       controller)


class UpdateGraph(CapturedGraph):
    """One update captured into CUDA graphs (``CapturedGraph``): the whole
    update, or the plan and first minibatch, each further minibatch and
    the metrics, the minibatches after a KL stop skipped (``skipped``).
    Its counts are its own."""

    replays = 0
    captures = 0
    skipped = 0
    launches: Dict[Callable, int] = {}
    warmup_launches: Dict[Callable, int] = {}


class UpdateRunner:
    """The post-rollout half of one train-step configuration (env, config;
    on the vs-pool path the learner block's size, whose rows may all be
    invalid in a minibatch) on the static inputs of a ``RolloutRunner``:
    graph replays on a CUDA device (a graph per minibatch where
    ``target_kl`` can stop them), the eager loop elsewhere. ``polls`` and
    ``poll_seconds`` count the host's waits for the stop flag and the
    time they took. ``entropy`` is the adaptive entropy controller's
    state the graphs read and write (the runner's own, made at the first
    run that hands one), None with the controller off."""

    def __init__(self, env: Environment, cfg: Config, num_learner_envs: Optional[int] = None,
                 book: Optional[WindowBook] = None):
        self.env = env
        self.cfg = cfg
        self.num_learner_envs = num_learner_envs
        self.book = book
        self.lr: Optional[torch.Tensor] = None
        self.ent_coef: Optional[torch.Tensor] = None
        self.entropy: Optional[AdaptiveEntropyState] = None
        self.outputs: Optional[Dict[str, Dict[str, torch.Tensor]]] = None
        self.graph: Optional[UpdateGraph] = None
        self.polls = 0
        self.poll_seconds = 0.0
        self._made: Dict[str, object] = {}  # the graphs' plan and outputs
        self._stop = None  # pinned host copy of the stop flag, and its event
        self._bound = None  # the graph's network, optimizer, rollout runner, generator

    @property
    def pool(self) -> bool:
        return self.num_learner_envs is not None

    def _scalars(self, device: torch.device, lr: float, ent_coef: float) -> None:
        if self.lr is None:
            self.lr = torch.zeros((), dtype=torch.float32, device=device)
            self.ent_coef = torch.zeros((), dtype=torch.float32, device=device)
        self.lr.fill_(lr)
        self.ent_coef.fill_(ent_coef)

    def _entropy(self, entropy: Optional[AdaptiveEntropyState]) -> None:
        if self.entropy is None and entropy is not None:
            self.entropy = _clone(entropy)
        if (entropy is None) != (self.entropy is None):
            raise ValueError("the entropy controller cannot be switched on or off between updates")
        copy_into(self.entropy, entropy)

    def run(self, network, opt: AdamState, rollout: RolloutRunner, rng: RandomSource,
            lr: float, ent_coef: float,
            entropy: Optional[AdaptiveEntropyState] = None) -> Dict[str, Dict[str, torch.Tensor]]:
        """One update after ``rollout``'s last run, with this learning rate
        and entropy coefficient (with ``entropy``, the controller's state,
        the scheduled target entropy): {"metrics": ..., "stats": the
        episode summaries (the learner block's on the vs-pool path)}, the
        runner's own tensors, which the next run overwrites."""
        if rollout.carry.obs.device.type != "cuda":
            self.outputs = self.eager(network, opt, rollout, rng, lr, ent_coef, entropy)
            return self.outputs
        self._entropy(entropy)
        self._scalars(rollout.carry.obs.device, lr, ent_coef)
        self._graph(network, opt, rollout, rng).replay(self._stopped)
        self.outputs = self._made["outputs"]
        return self.outputs

    def _steps(self, made: Dict[str, object], network, opt: AdamState, rollout: RolloutRunner,
               rng: RandomSource) -> List[Callable[[], None]]:
        """The update as functions run in order: the plan and the first
        minibatch, each further minibatch, the metrics and summaries (all
        in one without ``target_kl``). ``made`` holds the plan and the
        outputs."""
        ucfg = update_config(self.cfg)

        def begin():
            buffers = rollout.buffers
            if self.book is not None and self.book.records:
                window_records(self.book, buffers.log.completed, buffers.log.outcome,
                               buffers.seat, buffers.slots, self.num_learner_envs)
            made["plan"] = prepare_update(self.env, self.cfg, network, rollout.carry,
                                          rollout.buffers.batch(), rollout.obs_norm, rng,
                                          self.lr, self.ent_coef, may_have_invalid=self.pool,
                                          popart=rollout.popart, controller=self.entropy)
            update_minibatch(network, opt, made["plan"], ucfg, 0, 0)

        def minibatch(e, m):
            return lambda: update_minibatch(network, opt, made["plan"], ucfg, e, m)

        def end():
            metrics = update_metrics(made["plan"])
            batch = rollout.buffers.batch()
            if self.cfg.runtime_guards != "off":
                metrics.update(guard_counts(batch))
            if self.pool:
                metrics["learner_valid_fraction"] = torch.mean(batch.valid_mask)
            stats = summarize_episode_logs(rollout.buffers.log, self.env.spec.num_players,
                                           num_envs=self.num_learner_envs)
            if self.book is not None:
                self.book.fold(metrics, stats)
            made["outputs"] = {"metrics": metrics, "stats": stats}

        rest = [minibatch(e, m) for e in range(ucfg.num_epochs)
                for m in range(ucfg.num_minibatches)][1:]
        steps = [begin, *rest, end]
        if self.cfg.target_kl is not None:
            return steps

        def whole():
            for step in steps:
                step()

        return [whole]

    def eager(self, network, opt: AdamState, rollout: RolloutRunner, rng: RandomSource,
              lr: float, ent_coef: float,
              entropy: Optional[AdaptiveEntropyState] = None) -> Dict[str, Dict[str, torch.Tensor]]:
        """The update run eagerly on the rollout runner's inputs, every
        minibatch (those after a KL stop change nothing): what a replay
        computes, in tensors of its own; ``entropy`` as ``run`` takes it."""
        self._entropy(entropy)
        self._scalars(rollout.carry.obs.device, lr, ent_coef)
        made: Dict[str, object] = {}
        for step in self._steps(made, network, opt, rollout, rng):
            step()
        return made["outputs"]

    def _stopped(self) -> bool:
        """Whether the KL stop has fired in the graphs launched so far: the
        flag copied into pinned memory behind them, the host waiting,
        polling an event, until the copy has landed."""
        if self._stop is None:
            self._stop = (torch.zeros((), dtype=torch.int32, pin_memory=True),
                          torch.cuda.Event())
        flag, done = self._stop
        flag.copy_(self._made["plan"].book.stop, non_blocking=True)
        done.record()
        t0 = time.perf_counter()
        while not done.query():
            time.sleep(0)
        self.poll_seconds += time.perf_counter() - t0
        self.polls += 1
        return bool(flag)

    def _graph(self, network, opt: AdamState, rollout: RolloutRunner,
               rng: RandomSource) -> UpdateGraph:
        if not isinstance(rng, TorchRandomSource):
            raise TypeError("a graphed update draws from a TorchRandomSource's generator")
        bound = (network, opt, rollout, [p.data_ptr() for p in network.parameters()],
                 rng.generator)
        if self.graph is None:
            self._bound = bound
            state = ([opt.flat_params, opt.flat_mu, opt.flat_nu, opt.count_tensor]
                     + state_leaves(rollout.obs_norm) + state_leaves(rollout.popart)
                     + state_leaves(self.entropy)
                     + ([] if self.book is None else self.book.leaves()))
            steps = self._steps(self._made, network, opt, rollout, rng)
            self.graph = UpdateGraph(steps, state, rng.generator)
        elif (any(a is not b for a, b in zip(bound[:3], self._bound[:3]))
              or bound[3] != self._bound[3] or bound[4] is not self._bound[4]):
            raise ValueError("the update graph reads the network, optimizer, rollout buffers "
                             "and generator it was captured with; those moved or changed")
        return self.graph

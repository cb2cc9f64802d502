"""The trainer's rollout on static buffers, replayed from a captured CUDA graph on a card.

Counterpart of the JAX package's whole-rollout device program: its
rollout is one ``lax.scan`` (burn_ppo_tpu/ppo/rollout.py:195-328,
ppo/pool_rollout.py:85-303), compiled once and run once an update. Here
``RolloutRunner`` runs ``collect_rollouts`` (or, on the vs-pool path,
``collect_rollouts_with_opponents``) on inputs that keep their addresses
from update to update, and writes its outputs into one ``RolloutBuffers``:

* the carry (env states, episode accumulators, the return normalizer,
  the per-player last values, obs, mask and privileged obs), which the
  end of the rollout writes back;
* the obs normalizer's stats and PopArt's value-normalizer stats: the
  update merges into the runner's own in place, and ``run`` copies in
  any others a caller hands it (never rebinding the runner's);
* the scheduled shaping coefficient, a 0-dim device tensor that ``run``
  writes before each rollout (a host float would be baked into a graph);
* on the vs-pool path, the seating (written back at the end, and copied
  in where the trainer remapped it on the host), the rotation's opponent
  stack, copied into one stack of the padded slot count (K7 takes its
  layers' pointers as host arrays, fixed at capture, the packed tower's
  of a bf16 or CNN stack among them; K20 a CNN stack's conv weights and
  biases the same way), and the reseat's
  slot bound, the rotation's active count as a 0-dim device tensor.

``run`` copies in every input that is not already the static one, then
runs the rollout: eagerly on the CPU (the path the parity tests hold
against JAX), or on a card by replaying one CUDA graph of all T steps and
the post-loop, captured at the runner's first rollout after one eager
warm-up on a side stream (which reaches the kernel library's first load,
K7's ``cudaFuncSetAttribute``, cuBLAS's workspace and cuDNN's conv plans
before capture);
the static inputs and the generator's state are then put back, so the
first replay draws what the eager loop would. Every random comes from
the generator of a ``TorchRandomSource``, registered with the graph, so
each replay draws from the generator's current offset and advances it as
the eager loop does. A capture that fails raises; nothing falls back to
the eager loop.

A replay runs no wrapper, so the kernels' launch counters do not move.
``RolloutGraph`` counts instead, over all its instances: ``replays``
(rollouts replayed), ``launches`` (each wrapper's kernel launches, those
captured times the replays), ``captures`` and ``warmup_launches`` (the
warm-ups' launches, which the wrappers' counters also hold). A capture
launches nothing, so the counters it moved are put back. The capture
and the counts are ``CapturedGraph``'s, which the update's graphs
(``ppo/update_graph.py``) share.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import torch

from burn_ppo_torch import kernels
from burn_ppo_torch.envs.base import Environment
from burn_ppo_torch.ppo.normalization import ObsNormState, PopArtState
from burn_ppo_torch.ppo.pool_rollout import (
    OpponentStack,
    PoolSeating,
    collect_rollouts_with_opponents,
    pool_step_log,
)
from burn_ppo_torch.ppo.rollout import (
    RandomSource,
    RolloutBuffers,
    RolloutCarry,
    TorchRandomSource,
    collect_rollouts,
)


def _fields(x) -> list:
    """A dataclass's fields, those marked as scratch left out."""
    return [f for f in dataclasses.fields(x) if not f.metadata.get("scratch")]


def state_leaves(x) -> List[torch.Tensor]:
    """The tensors of a state tree (dataclasses, lists, tuples), in field
    order; None, other values and scratch fields left out."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in state_leaves(v)]
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return [t for f in _fields(x) for t in state_leaves(getattr(x, f.name))]
    return []


def _clone(x):
    """The tree with every tensor copied into a contiguous buffer of its
    own (scratch fields shared; a field the dataclass derives itself, such
    as ``OpponentStack.packed``, derived anew from the copies)."""
    if isinstance(x, torch.Tensor):
        return x.clone(memory_format=torch.contiguous_format)
    if isinstance(x, list):
        return [_clone(v) for v in x]
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{f.name: _clone(getattr(x, f.name)) for f in _fields(x)
                                         if f.init})
    return x


def copy_into(dst, src) -> None:
    """Write every tensor of ``src`` into its place in ``dst``, a tree of
    the same structure; a tensor that already is ``dst``'s is skipped."""
    a, b = state_leaves(dst), state_leaves(src)
    if len(a) != len(b):
        raise ValueError(f"copy_into: {len(b)} tensors into a static tree of {len(a)}")
    for x, y in zip(a, b):
        if x is not y:
            if x.shape != y.shape:
                raise ValueError(f"copy_into: shape {tuple(y.shape)} into {tuple(x.shape)}")
            x.copy_(y)


def _launch_counts() -> List[int]:
    return [w.launches for w in kernels.WRAPPERS]


def _moved(start: List[int]) -> Dict[Callable, int]:
    return {w: w.launches - c for w, c in zip(kernels.WRAPPERS, start) if w.launches != c}


class CapturedGraph:
    """Functions captured into CUDA graphs, one graph each: ``steps`` are
    run once eagerly, in order, on a side stream (which reaches the kernel
    library's first load, function attributes and cuBLAS's workspace
    before capture), ``state`` (the tensors they write that they read) and
    the generator put back, then each step is captured, the generator
    registered with every graph, all graphs in one memory pool (safe
    while they are replayed in the order captured, as ``replay`` does,
    middle ones skipped or not). ``replay(skip)`` replays the first graph,
    each middle one while ``skip()`` is false, and the last. A subclass
    keeps its own counts over all its instances: ``replays``,
    ``captures``, ``skipped`` (middle graphs not replayed), ``launches``
    (each wrapper's launches in the graphs replayed) and
    ``warmup_launches``."""

    replays = 0
    captures = 0
    skipped = 0
    launches: Dict[Callable, int] = {}
    warmup_launches: Dict[Callable, int] = {}

    @classmethod
    def reset_counts(cls) -> None:
        cls.replays = cls.captures = cls.skipped = 0
        cls.launches, cls.warmup_launches = {}, {}

    def __init__(self, steps: List[Callable[[], None]], state: List[torch.Tensor],
                 generator: torch.Generator) -> None:
        if getattr(torch.cuda.CUDAGraph, "register_generator_state", None) is None:
            raise RuntimeError("this torch cannot register a generator with a CUDA graph "
                               f"(torch {torch.__version__}): every replay would draw the same "
                               "randoms")
        self._warm_up(steps, state, generator)
        self.graphs: List[torch.cuda.CUDAGraph] = []
        self.captured: List[Dict[Callable, int]] = []
        pool = torch.cuda.graph_pool_handle()
        for step in steps:
            start = _launch_counts()
            graph = torch.cuda.CUDAGraph()
            graph.register_generator_state(generator)
            try:
                with torch.cuda.graph(graph, pool=pool):
                    step()
            finally:
                # A capture launches nothing: put the counters back.
                self.captured.append(_moved(start))
                for w, c in zip(kernels.WRAPPERS, start):
                    w.launches = c
            self.graphs.append(graph)
        # Each capture begins by resetting the generator's graph seed and
        # offset tensors, shared by every graph registered with it, with
        # kernels launched eagerly on the capture stream; the first replay
        # writes them on the current stream. Unsynchronized, the last
        # capture's reset could land after that write and the replay draw
        # from offset 0, on a busy card.
        torch.cuda.synchronize()
        type(self).captures += 1

    def _warm_up(self, steps, state: List[torch.Tensor], generator: torch.Generator) -> None:
        current = torch.cuda.current_stream()
        saved = [t.clone() for t in state]
        rng_state = generator.get_state()
        start = _launch_counts()
        side = torch.cuda.Stream()
        side.wait_stream(current)
        with torch.cuda.stream(side):
            for step in steps:
                step()
        current.wait_stream(side)
        for t, s in zip(state, saved):
            t.copy_(s)
        generator.set_state(rng_state)
        _add(type(self).warmup_launches, _moved(start))

    def _replay(self, i: int) -> None:
        self.graphs[i].replay()
        _add(type(self).launches, self.captured[i])

    def replay(self, skip: Callable[[], bool] = lambda: False) -> None:
        cls = type(self)
        self._replay(0)
        for i in range(1, len(self.graphs) - 1):
            if skip():
                cls.skipped += len(self.graphs) - 1 - i
                break
            self._replay(i)
        if len(self.graphs) > 1:
            self._replay(len(self.graphs) - 1)
        cls.replays += 1


class RolloutGraph(CapturedGraph):
    """One rollout captured into a CUDA graph: ``fn`` is run once eagerly
    on a side stream, ``state`` (the tensors it writes that it reads) and
    the generator put back, then captured."""

    replays = 0
    captures = 0
    skipped = 0
    launches: Dict[Callable, int] = {}
    warmup_launches: Dict[Callable, int] = {}

    def __init__(self, fn: Callable[[], None], state: List[torch.Tensor],
                 generator: torch.Generator) -> None:
        super().__init__([fn], state, generator)


def _add(into: Dict[Callable, int], counts: Dict[Callable, int]) -> None:
    for w, n in counts.items():
        into[w] = into.get(w, 0) + n


class RolloutRunner:
    """One rollout configuration (env, T, the return normalizer; the
    learner block's size on the vs-pool path) on static buffers, made at
    the first ``run`` from its inputs: a graph replay on a CUDA device,
    the eager loop elsewhere."""

    def __init__(self, env: Environment, *, num_steps: int, gamma: float,
                 normalize_returns: bool, return_clip: float = 10.0,
                 num_learner_envs: Optional[int] = None):
        self.env = env
        self.num_steps = num_steps
        self.gamma = gamma
        self.normalize_returns = normalize_returns
        self.return_clip = return_clip
        self.num_learner_envs = num_learner_envs
        self.carry: Optional[RolloutCarry] = None
        self.obs_norm: Optional[ObsNormState] = None
        self.popart: Optional[PopArtState] = None
        self.shaping: Optional[torch.Tensor] = None
        self.seating: Optional[PoolSeating] = None
        self.opponents: Optional[OpponentStack] = None
        self.slot_hi: Optional[torch.Tensor] = None
        self.buffers: Optional[RolloutBuffers] = None
        self.graph: Optional[RolloutGraph] = None
        self._bound = None  # the graph's network, parameter addresses, generator

    @property
    def pool(self) -> bool:
        return self.num_learner_envs is not None

    def _allocate(self, network, carry, obs_norm, popart, seating, opponents) -> None:
        device = carry.obs.device
        self.carry = _clone(carry)
        self.obs_norm = _clone(obs_norm)
        self.popart = _clone(popart)
        if "shaping_coef" in self.env.context_fields:
            self.shaping = torch.zeros((), dtype=torch.float32, device=device)
        if self.pool:
            self.seating, self.opponents = _clone(seating), _clone(opponents)
            self.slot_hi = torch.ones((), dtype=torch.int32, device=device)
        self.buffers = RolloutBuffers.create(
            self.env, self.num_steps, carry.obs.shape[0], device, privileged=network.is_ctde,
            samples=self.normalize_returns, pool=self.pool)

    def run(self, network, carry: RolloutCarry, obs_norm: Optional[ObsNormState],
            rng: RandomSource, shaping_coef: float = 0.0, seating: Optional[PoolSeating] = None,
            opponents: Optional[OpponentStack] = None, num_active: int = 0,
            popart: Optional[PopArtState] = None):
        """One rollout from these inputs (``popart``: the value normalizer
        that denormalizes the learner's values, or None). Returns (carry,
        batch, episode logs), or on the vs-pool path (carry, seating,
        batch, ``PoolStepLog``): the runner's static carry and seating, and
        views of its buffers, all of which the next run overwrites."""
        if self.carry is None:
            self._allocate(network, carry, obs_norm, popart, seating, opponents)
        copy_into(self.carry, carry)
        for mine, given, what in ((self.obs_norm, obs_norm, "the obs normalizer"),
                                  (self.popart, popart, "PopArt")):
            if (given is None) != (mine is None):
                raise ValueError(f"{what} cannot be switched on or off between rollouts")
            copy_into(mine, given)
        if self.shaping is not None:
            self.shaping.fill_(shaping_coef)
        if self.pool:
            copy_into(self.seating, seating)
            if opponents.num_slots != self.opponents.num_slots:
                raise ValueError(f"an opponent stack of {opponents.num_slots} slots, not the "
                                 f"{self.opponents.num_slots} the runner holds: pad every "
                                 "rotation to the same count")
            copy_into(self.opponents, opponents)
            self.slot_hi.fill_(max(num_active, 1))
        if self.carry.obs.device.type == "cuda":
            self._graph(network, rng).replay()
        else:
            self._rollout(network, rng)
        batch = self.buffers.batch()
        if self.pool:
            return self.carry, self.seating, batch, pool_step_log(self.buffers)
        return self.carry, batch, self.buffers.log

    def _rollout(self, network, rng: RandomSource) -> None:
        """The whole rollout on the static inputs, the carry (and seating)
        written back."""
        kw = dict(num_steps=self.num_steps, gamma=self.gamma,
                  normalize_returns=self.normalize_returns, return_clip=self.return_clip,
                  env_context=None if self.shaping is None else {"shaping_coef": self.shaping},
                  buffers=self.buffers, popart=self.popart)
        if self.pool:
            carry, seating, _, _ = collect_rollouts_with_opponents(
                network, self.env, self.opponents, self.carry, self.seating, self.obs_norm, rng,
                num_learner_envs=self.num_learner_envs, num_active=self.slot_hi, **kw)
            copy_into(self.seating, seating)
        else:
            carry, _, _ = collect_rollouts(network, self.env, self.carry, self.obs_norm, rng, **kw)
        copy_into(self.carry, carry)

    def _graph(self, network, rng: RandomSource) -> RolloutGraph:
        if not isinstance(rng, TorchRandomSource):
            raise TypeError("a graphed rollout draws from a TorchRandomSource's generator")
        bound = (network, [p.data_ptr() for p in network.parameters()], rng.generator)
        if self.graph is None:
            self._bound = bound
            state = state_leaves(self.carry) + state_leaves(self.seating)
            self.graph = RolloutGraph(lambda: self._rollout(network, rng), state, rng.generator)
        elif (bound[0] is not self._bound[0] or bound[1] != self._bound[1]
              or bound[2] is not self._bound[2]):
            raise ValueError("the rollout graph reads the network's parameters and the generator "
                             "it was captured with; those moved or changed")
        return self.graph

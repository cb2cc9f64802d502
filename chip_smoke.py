"""Smoke run of the PyTorch port (burn_ppo_torch) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --parent DIR   # also time DIR's K7 towers and K20, train
                                         # phases 3, 3d, train steps and the Skull eval
                                         # chunk in turns
    python3 chip_smoke.py --parent DIR --only-k7   # K7's and K20's checks and turns
                                                   # alone (~90 s), no result line

Phases, each printing one JSON line; any failure raises and the script
exits non-zero without the final result line:

  0. the card (nvidia-smi name and power limit), torch and CUDA versions;
  1. build the CUDA kernels from burn_ppo_torch/csrc with nvcc;
  2. each kernel against its plain PyTorch version at the main paths'
     shapes, timed with CUDA events: K1 CartPole step (E = 4096 and 4097,
     with and without the return normaliser's roll folded in; failures,
     timeouts and continuing envs each required; timed with the roll), K2
     sample ([4096, 2] all legal; [4096, 7] with 0-6 masked columns), K3
     GAE ([128, 4096]; [128, 32], configs/cartpole.toml's; [100, 4097], a
     partial chunk and block on the 4-byte path), K4 Connect Four step
     (E = 4096, the packed state,
     exact, wins in all four directions, draws, invalid, out-of-range
     and already-done moves each counted and required), K5
     multiplayer GAE ([64, 4096, 2] and P = 4), K6 obs-norm apply
     ([4096, 86], count 0, 1 and large), its apply on the update batches
     [T x E, D] ([524288, 270], [262144, 86], [524288, 5]; also with L2
     flushed before each call), and its update ([262144, 86],
     [524288, 5]), K7 slot-grouped opponent forward (Ep = 1024 rows, MLP
     86 -> 512 -> 512 -> 7, K = 8 and K = 3, relu and tanh; and the Skull
     pool block, Ep = 1229, K = 8, 135 -> 256 -> 256 -> 256 -> 33; each of
     its tilings checked and timed; its bound the 3xTF32 one on the tensor
     cores, the f32 one beside it), K8 PPO loss ([65536, 7], [65536, 33]
     and [131072, 2] minibatches, valid zeros, value clip on and off, two
     calls bit for bit), K9 clip + Adam (CartPole's 4,739,
     Connect Four's 311,304 and Skull CTDE 512x2's 784,418 parameters,
     below and above the max norm, two runs bit for bit), K10 episode
     statistics ([64, 4096]
     with the learner block [:, :3072], [128, 4096], and four players with
     tied places [:, :2867]), K11 Skull step (E = 4096, the packed state,
     exact, along random-legal walks at 4, 2 and 6 players with invalid
     actions, finished games and forced discards), K12 return normaliser (roll at
     [4096, 1] and [4096, 4]; finalize at [524288] with and without a
     valid mask, two calls bit for bit, timed both ways), K2 at [4096, 33]
     on Skull's own masks and at the
     opponents' [1229, 33] (the pool rows [2867:] of the same masks, a
     view that does not start 16-byte aligned); K13 Liar's Dice
     step (E = 4096, exact, along a random-legal walk with calls,
     eliminations, finished games, invalid and out-of-range actions and
     full 16-row histories, each counted and required), and the older
     kernels at the Liar's Dice shapes: K2 at [4096, 49] on its masks and
     at the opponents' [1024, 49] (rows [3072:]), K5
     at [128, 4096, 4], K6 apply at [4096, 270] and update at
     [524288, 270], K7 at the pool block Ep = 1024, K = 8 for the CTDE
     actor 270 -> 256 -> 256 -> 49 and the MLP 270 -> 512 x3 -> 49 with
     per-slot obs norm, K8 at [65536, 49], K9 at the CTDE's 873,778 and
     the MLP's 689,714 parameters, K10 at [128, 3072] of [128, 4096],
     P = 4;
     K14, eval's temperature sampler, on every row at [1, 7], [64, 7],
     [64, 33], [256, 33], [64, 49] and [1024, 49] (the envs' masks,
     temperatures from 0, 0.4, 1 and 1e-3, exact greedy ties required);
     K17, the eval step's seating and records (``step_books``: the seat
     half alone, both halves in one launch, the record half alone), bit
     for bit at E = 1, 64, 256 and 4096, P = 2 and 4, under constant,
     cutoff and decay schedules with a Random seat (also with a seat
     table of 1680 maps), timed at [256, 4], the fused launch in turns
     against the two halves launched apart;
     each env step with K14's row code as its sampling front (eval's one
     launch a step: the step wrappers given a ``front``, their kernels'
     ``<env>_sample_step_kernel`` instance) against K14 then the step and
     against the plain sample then the plain step on the same inputs at
     E = 1, 64, 256 and 4096 along 12-step walks, the actions and every
     output bit for bit (CartPole's physics and obs against the plain
     step to K1's 1e-5), timed at the env's
     eval shape in turns with K14 + the step;
     K1, K4 and K13 also with the reset flag off (a finished env's terminal
     row kept) against the plain step, K4 at every step of its walk, K13
     every fourth;
     each kernel's least time on the card (bytes or operations) and,
     where one PyTorch call computes the same function, that call's time;
     K3, K4, K5, K6, K9, K10 and K13 print their ptxas lines (registers,
     stack frame, spills); K10 gives the same bits on two calls and on two
     replays of a captured graph, and is timed beside an empty kernel's
     launch (the floor); with --parent, when DIR's kernel sources differ
     from this tree's, the parent commit's K7 (its f32 tower at the four
     pool shapes, bit for bit this tree's; its bf16 tower and its feature
     front, each to its tolerance) and K20 with the grouped convs, built
     from DIR, checked and timed in turns with this tree's (parent, new,
     new, parent);
     a kernel time the profiler does not see (no CUDA kernel recorded in
     two tries) is reported as null, never as 0;
  2. (continued) K18, the update window's pool records (one launch of many
     blocks, a decoupled look-back), against its plain version bit for bit
     on one book over two windows of 8 appends in a row at the flagship
     shape (T = 64, E = 4096, Ep = 1229, P = 4, C = 78,656) and a window
     whose capacity of 500 rows overflows; K19, the window's report (one
     warp, a table an accumulator entry), bit for bit over 8 folds (a KL
     spike, a guard count, an update without an episode); each timed, one
     append or fold, beside an empty kernel's launch (K19 in turns with
     it); K7's bf16 tower (the stacks' weights rounded to bf16 and packed)
     against its plain version at Connect Four's pool block (Ep = 1024, K
     = 8, 86 -> 512 x2 -> 7, obs norm), the flagship's (Ep = 1229, 135 ->
     256 x3 -> 33) and Liar's Dice MLP's (Ep = 1024, 270 -> 512 x3 -> 49,
     obs norm, streamed through the ring), by its check with its control
     (K7's f32 tower on the rounded weights) failing, its device ms in turns
     with K7's f32 tower, with torch.bmm in bf16 and (--parent) with the
     parent's bf16 tower, its bound the bf16 tensor cores' rate;
  2a. phase ``popart``: K15, PopArt's update (the masked moments of the
     raw returns, the Welford merge and the value head's rescale, one
     launch with a last-block ticket) against its plain version at the CartPole batch
     [524288] (all valid, head 64) and the vs-pool batch with a quarter of
     its rows invalid (head 512), and one valid sample onto counts 0, 1
     and 2 (the rescale's gate); two calls and two replays of a captured
     graph bit for bit; timed beside torch.var_mean, in turns with it on
     the device clock (with --parent, also with the parent's K15, which
     must agree to the same tolerance); K16, the bootstrap's
     denormalisation, bit for bit at [4096] into a step's slice; K2 with
     its value epilogue (the rollout steps' denormalisation) against K2
     then K16 at [4096, 2] and [4096, 49], counts 0, 1, 2 and 5000, bit
     for bit, timed in turns with the two launches (with --parent, the
     parent's two); the rollout with PopArt on (CartPole, Liar's Dice CTDE
     against the pool) by both routes from one state, bit for bit; K8
     with PopArt's stats and the adaptive entropy controller stepping, at
     [65536, 7] and [65536, 49] with the value clip;
  2b. one K9 step, one K6 apply, one K1 step with the roll and one K12
     finalize captured into CUDA graphs: each replay equal bit for bit to
     the eager call;
  2c. the trainer's rollout as one captured CUDA graph
     (``ppo/rollout_graph.py``) against the eager loop
     (``collect_rollouts``), from the same generator state, rollout after
     rollout, every carry, batch and log tensor bit for bit and the
     generator at the same offset: CartPole 4096 x 128, Connect Four
     self-play 4096 x 64 (MLP 512x2), Skull CTDE self-play at the
     bench_skull_ctde shape, Liar's Dice CTDE against the pool 4096 x
     128 and Connect Four against the pool with the bf16 compute dtype
     (K7's bf16 tower) across new rotations, a growing and a shrinking active count (one
     graph, its slot bound on the device; the trainer's host remap of the
     seats) and a shaping change; one capture a case; then the eager loop
     and the graph timed in turns (events and device ms per rollout),
     with the rollout's bound (the per-step kernels' bounds of phase 2
     plus the forward at the f32 rate);
  2d. (in a process of its own) the trainer's update
     (``ppo/update_graph.py``: the obs-norm merge,
     bootstrap, GAE, every epoch's minibatches, the guard counts and the
     episode summaries) as captured CUDA graphs against the eager loop
     (``UpdateRunner.eager``) from one saved state, update after update:
     parameters, moments, the Adam count, obs-norm stats, every metric and
     summary bit for bit and the generator at the same offset; CartPole
     4096 x 128, Connect Four self-play 4096 x 64 (MLP 512x2, 6 epochs,
     target_kl 0.02), Liar's Dice CTDE against the pool as
     configs/liars_dice_ctde.toml runs it (the KL stop required to fire),
     then a last update with two valid rows left in its batch
     (all-invalid minibatches required), and the bench_skull_ctde shape
     with the bf16 compute dtype (its bf16 forward and backward under
     capture); one capture a runner; the
     minibatches run and skipped and the minibatch graphs skipped; from
     one saved state the eager loop and the graphs timed in turns, and the
     host's waits for the stop flag between minibatch graphs (count and
     ms); each update kernel's device launches in one profiled replay;
     one train step under ``torch.cuda.set_sync_debug_mode("error")`` (no
     stream or device synchronize; the host's wait for the stop flag is
     an event query, which that mode does not see); with
     --parent, whole train steps through ``Trainer.update`` (CartPole and
     Liar's Dice CTDE against the pool) of DIR and this tree in turns,
     each in a process of its own (phase ``update_turns``);
  3. the CartPole bench-shape train path through the CLI entry point
     (MLP 64x2, 4096 envs x 128 steps, obs norm on, the return normaliser
     on with its roll inside K1, 5 updates); with --parent (DIR a full
     checkout), the parent's phase 3 and this tree's, each in a process of
     its own, in turns (env-steps/s medians), and the same for phase 3d;
  3b. Connect Four self-play through the CLI (configs/connect_four.toml,
     MLP 512x2, no opponent pool, 4096 envs x 64 steps, obs norm on,
     5 updates): finite losses, Swiss points summing to 1;
  3c. the same with the CNN (relu) and the return normaliser on (the
     gather and K12's roll every step), 2 updates;
  3d. Connect Four against the opponent pool through the CLI
     (configs/connect_four.toml as users run it: MLP 512x2, pool fraction
     0.25, 8 opponents at most, 4096 x 64, obs norm on), a checkpoint
     after every update, 10 updates, so that the rotation reaches K = 8:
     finite losses, the pool and rating files, the learner's valid share
     near (L + Ep/2) / E;
  3e. Skull, four players, CTDE self-play at the bench_skull_ctde shape
     (configs/skull_ctde.toml with CTDE 512x2 actor and critic, tanh,
     4096 x 64, 4 epochs x 4 minibatches, no pool), 5 updates: finite
     losses, Swiss points summing to P (P - 1) / 2 = 6;
  3f. Skull CTDE against the pool (configs/skull_ctde.toml as users run
     it: CTDE 256x3 relu, pool fraction 0.3, 4096 x 128), a checkpoint
     after every update, 10 updates: the rotation reaches K = 8, the pool
     and rating files, the learner's valid share strictly between L / E
     and (L + Ep/2) / E (three of four seats of a pool env are the
     opponents');
  3g. Liar's Dice, four players, CTDE against the pool
     (configs/liars_dice_ctde.toml as users run it: CTDE actor 256x2 and
     critic 512x3 relu, shaping 0.05, pool fraction 0.25, 4 epochs x 8
     minibatches, 4096 x 128), a checkpoint after every update, 10
     updates: the rotation reaches K = 8, the pool and rating files, the
     learner's valid share strictly between L / E and (L + Ep/2) / E,
     Swiss points 6 a game;
  3h. Liar's Dice with the MLP 512x3 against the pool
     (configs/liars_dice.toml --normalize-obs, 4096 x 128), 3 updates: K6
     at width 270 and K7 with MLP towers and per-slot obs norm;
  3i. the device's idle share of one CartPole update (4096 x 128) and of
     one Connect Four update against a pool of 8 (4096 x 64): the
     profiler's device intervals in one update against the median of
     three unprofiled updates on the host's clock (and against the
     profiled update's own span); in one profiled replay of each
     update's rollout graph, each rollout kernel's device launches,
     counted by name, equal to those the graph captured;
  3j. resume and fork through the CLI, each leg a process of its own:
     CartPole at the bench shape (obs and return norm on), Liar's Dice
     CTDE against the pool (configs/liars_dice_ctde.toml, 4096 envs) and a
     --fork of the CartPole run (a new learning rate): 2 updates with a
     checkpoint after each; then at once, each in its own process, the
     checkpoint loaded by a resumed Trainer (every restored leaf, the
     generator state included, equal to the saved one) and two resumes
     of 2 updates from copies of the run dir, whose last checkpoints
     must be equal bit for bit; every leg's rollouts and updates graph
     replays, counted as in the train phases; the vs-pool case's pool
     stats and rating files carry the first leg's checkpoints; the fork
     records forked_from in every checkpoint;
  3k. (in a process of its own, with 3l) the eval command through
     cli.main on the card, every stats chunk one CUDA graph replay (``eval.StatsEngine``,
     ``EvalGraph``): Connect Four r4 against r4_mid, greedy, 256 games x
     64 envs (K4 with K14's sampling front, K7, K17 65 launches a chunk,
     K14 alone none; each
     wrapper's launches the graph's captured x replayed plus its warm-up),
     the game records equal to a CPU run; Skull r4, r4_best, r4_mid and
     Random, 1024 games x 256 envs (K11 with the sampling front, K7, K17;
     valid placements;
     one chunk graphed and eager in turns: events ms, device ms, idle
     share; games/s both ways in turns; the kernels counted on the device
     in one replay against those captured, K17 65 times, the fused step
     64, K14 and K11 without its front 0); with --parent,
     that chunk of the parent's tree and this one in turns, each in a
     process of its own (phase ``eval_chunk_turns``); from one saved carry and generator state, two graph
     replays against two eager chunks bit for bit on the stacked, single,
     per-model (the CTDE towers, and a seeded CNN) and random paths; a
     watched Connect Four and a watched Skull game (eager: the env step
     and K14 at E = 1, K6 for each model move), printed; K4, K11 and K14
     at E = 1 against their plain versions; a watched game of each env
     (``eval.SingleGame``, the step's reset off) to its end, its last
     position the plain step's; CartPole with a Random player, 256 games
     (K1 with the sampling front);
  3l. (after 3k, in its process) the tournament command on the three
     gauntlets as scripts/gauntlet.py rate plays them (48 games a pod on
     Skull, 192 on Connect Four and Liar's Dice), under seeds 0 and 1,
     pods of one shape sharing one engine and its graph
     (``eval.EngineCache``; captures and replays counted): every entry
     above Random by more than 2 of its sigma and within 4 combined sigma
     of gauntlet/<env>/ratings_r4.json under both seeds, the entries below
     JAX's counted; the pods that stacked their models for K7 and those
     that took the per-model path, both on Skull; a pod loaded into a
     cached engine against a fresh engine of its seed run eagerly, bit for
     bit; each gauntlet's seconds with the cache against an engine a pod
     run eagerly, in turns;
  3m. phase ``popart_entropy_train``: CartPole at the bench shape and
     configs/liars_dice_ctde.toml at 4096 envs against the pool, each with
     --normalize-values --adaptive-entropy 0.5 through the CLI, 4 updates
     (K15 once an update, K16 once (the bootstrap's; the rollout steps
     denormalise in K2's launch), every count checked as in the
     other train phases; the Liar's Dice KL stop required to fire), the
     PopArt and controller series printed update by update; then, in a
     process of its own, both updates as graphs against the eager loop bit
     for bit (PopArt's stats and the controller's state among the leaves)
     and K15, K16 and K8 counted on the device in one replay of each graph;
     the resume phase (3j) holds a CartPole case with both flags, whose
     popart.npz comes back bit for bit;
  3n. phase ``supervisor`` (while phase 3j runs): configs/cartpole.toml
     with --reload-every-n-checkpoints 1 for three checkpoints, twice at once,
     each ``python -m burn_ppo_torch train`` in a process of its own
     spawning three children (the later two with --resume and a growing
     --elapsed-time-offset-ms): the total step reached, one metrics entry
     an update without gap or repeat, each logged by a child on the card,
     the two runs' final model, optimizer and generator bit for bit;
  3o. phase ``interactive`` (after 3l, in its process): the Skull
     assistant's server in a thread on gauntlet/skull, its networks on the
     card, one scripted session through its HTTP API (r4 selected, a
     four-player game, a skull reveal and its discard, 24 ai_sample moves
     each after an ai_probs, an undo, then ai_sample moves to the game's
     end): every ai_probs' full probabilities summing to 1 within 1e-5
     with zero on every illegal action, the last position equal bit for
     bit to the plain step's on the same uniform (K11 with its reset
     off), K11 once per applied move and K6 once per forward, the median
     ms per route;
  3p. phase ``interop`` (after 3o, in its process): Burn NamedMpk
     directories of the Rust reference's layout written from the Connect
     Four and Skull r4 checkpoints (``write_burn_dir``, the MessagePack
     encoder here), loaded on the card through the loaders' route to
     ``interop.py``: parameters and obs normaliser bit for bit the
     ``.npz`` original's, two graphed chunks of each bit for bit the
     original's, ``eval`` (kernels counted) and ``tournament`` on the
     Connect Four directory with the original's games and standings;
  3q. phase ``pool_window`` (in a process of its own): configs/
     skull_ctde_tpu.toml unchanged at full width (Skull, 4 players, 4096 x
     64, CTDE 256x3 relu, pool fraction 0.3, 8 opponents, 8 updates a
     rotation) through the CLI for 24 updates: a self-play window of 8, a
     checkpoint joining the pool, two pool windows of 8, each one rotation
     and one record fold; K18 and K19 8 launches a window (the update
     graphs' replays), every count checked as in the train phases; the
     fetched rows, the overflow, the three perf/pool_* series and
     train/approx_kl_max printed; a pool window against 8 sequential pool
     steps of a book-less step with the same rotation of 8 freshly
     initialised opponents from the same state and generator state, bit
     for bit (parameters, optimizer, carry, seating, the rows against
     extract_pool_records); the window against 8 single-update rotations
     (pool_rotation_interval = 1) in turns, and one window profiled (its
     events and device ms, K18 and K19 8 each on the device);
  3r. the bf16 compute dtype (A18): Connect Four against the pool through
     the CLI with --compute-dtype bfloat16 (4 updates, a checkpoint each:
     K7's bf16 tower 64 launches a pool update, its f32 tower none) and
     the CNN's self-play in bf16 (2 updates), counted as every train
     phase; phase ``bf16`` (a process of its own): the bench_skull_ctde
     shape in f32 and bf16, train steps in turns, one replay of each
     update graph profiled (device ms, cuBLAS's GEMMs' share, the longest
     kernels), one eager bf16 update's roundings and backward f32 products
     (calls, launches, device ms, by their profiler labels); the flagship
     configs/skull_ctde_tpu.toml in bf16, one pool window of 8 against 8
     fresh opponents (bf16 stacks), every launch counted, K7's bf16 tower
     64 on the device in one profiled rollout replay;
  3s. the CNN against the pool (A12b): in phase 2, K20 (the opponents'
     conv front: each row's normalisation and whole conv stack under its
     own slot) against its plain version at Ep = 1024, 1023, 1 and
     0, K = 8, obs norm on and off, f32 (every element within 1e-5 max
     |plain|) and bf16 (``CNN_FRONT_BF16_TOL``, with its control, a front
     that skips the rounding between the layers, failing), its layout and
     bound, a profile of the CNN route showing K20 and K7's feature front
     as its only kernels, and (--parent) the parent's K20 plus the grouped
     cuDNN convs in turns with it, eagerly and as graph replays; K7's
     feature front after it against opponent_cnn_forward_plain (each
     slot's normalisation, convs and tower over every row, then the row's
     slot), f32 to K7's tolerance, the bf16 tower by its check with its
     control failing, its device ms in turns with torch.bmm over the K x Ep
     rows and (--parent) with the parent's feature front on the parent's
     conv output; the rollout case ``connect_four_pool_cnn`` graphed bit
     for bit; phase ``selfplay_pool_cnn``: configs/connect_four.toml with
     --network-type cnn through the CLI, 4096 x 64, 10 updates with a
     checkpoint each (K = 8 at updates 9 and 10), K20 and K7's feature
     front 64 launches a pool update, the update times on the host's
     clock, the idle share and the rollout graph's split (K20, the
     feature front, the learner's convs: device ms and launches in one
     profiled replay) from phase ``update_idle_share``'s CNN case; and 3
     updates of the same with --compute-dtype bfloat16;
  4. the CartPole learning bar (scripts/validate_cartpole.py settings):
     average return >= 195 within 200k steps, also with --compute-dtype
     bfloat16 (printed beside the f32 bar); then the same with
     --normalize-values, printed beside the JAX package's CPU result for
     that configuration (JAX_POPART_BAR), which it must match in clearing
     195.

Each train phase sets every kernel's launch counter, and the rollout
and update graphs' counts, to 0 just before it and checks the counts
just after against what its updates imply: the rollout and update
graphs replayed once an update, captured once a runner; a kernel's
launches its graphs' captured launches times their replays (a replay
runs no wrapper; phase 3i counts the replayed kernels on the device),
and no eager launch beyond the graphs' warm-ups (one eager rollout and
one eager update before a runner's captures); K8 and K9 once per
minibatch graph replayed; K19 once an update and K18 once a vs-pool
update (the update window's report and records, in the update graphs).

The line before the last holds the kernel table, the last line
{"ok": true, "device": {...}}. Imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from collections import Counter
from pathlib import Path

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke: torch.cuda.is_available() is false; this smoke run needs an NVIDIA GPU")

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

from burn_ppo_torch import kernels  # noqa: E402
from burn_ppo_torch.device import resolve_device  # noqa: E402
from burn_ppo_torch.envs.base import EpisodeAccumulator, autoreset_step  # noqa: E402
from burn_ppo_torch.envs.cartpole import (  # noqa: E402
    CartPole,
    CartPoleState,
    cartpole_step_autoreset,
)
from burn_ppo_torch.envs.connect_four import (  # noqa: E402
    COLS,
    ROWS,
    ConnectFour,
    ConnectFourState,
    connect_four_step_autoreset,
    has_win,
)
from burn_ppo_torch.envs.liars_dice import (  # noqa: E402
    LiarsDice,
    LiarsDiceState,
    liars_dice_step_autoreset,
)
from burn_ppo_torch.envs.liars_dice import walk_actions as liars_dice_actions  # noqa: E402
from burn_ppo_torch.envs.skull import FIELDS as SKULL_FIELDS  # noqa: E402
from burn_ppo_torch.envs.skull import (  # noqa: E402
    Skull,
    SkullState,
    skull_step_autoreset,
    walk_actions,
)
from burn_ppo_torch.ops.categorical import (  # noqa: E402
    TINY,
    TemperatureFront,
    apply_action_mask,
    front_args,
    masked_sample,
    masked_sample_plain,
    sample_with_temperature,
    sample_with_temperature_plain,
)
from burn_ppo_torch.ops.gae import (  # noqa: E402
    compute_gae,
    compute_gae_multiplayer,
    compute_gae_multiplayer_plain,
    compute_gae_plain,
)
from burn_ppo_torch.envs.base import EpisodeLog  # noqa: E402
from burn_ppo_torch.ppo.episode_stats import (  # noqa: E402
    summarize_episode_logs,
    summarize_episode_logs_plain,
)
from burn_ppo_torch.ppo.entropy import AdaptiveEntropyState, adaptive_entropy_record  # noqa: E402
from burn_ppo_torch.ppo.normalization import (  # noqa: E402
    ObsNormState,
    PopArtState,
    ReturnNormState,
    obs_norm_apply,
    obs_norm_apply_plain,
    obs_norm_update,
    obs_norm_update_plain,
    return_norm_finalize,
    return_norm_finalize_f64,
    return_norm_finalize_f64_plain,
    return_norm_roll,
    return_norm_roll_plain,
    return_norm_scratch,
    popart_denormalize,
    popart_denormalize_plain,
    popart_update_rescale,
    popart_update_rescale_plain,
)
from burn_ppo_torch.models.network import ActorCriticNetwork  # noqa: E402
from burn_ppo_torch.ppo.pool_rollout import (  # noqa: E402
    OPPONENT_TILINGS,
    OpponentStack,
    _feature_width,
    _tower_args,
    actor_params,
    opponent_actor_forward,
    opponent_actor_forward_plain,
    opponent_cnn_forward_plain,
    opponent_cnn_front,
    opponent_cnn_front_plain,
    opponent_features_forward,
    opponent_features_forward_plain,
)
from burn_ppo_torch.ppo.update import (  # noqa: E402
    LossBook,
    PPOUpdateConfig,
    clip_adam,
    clip_adam_plain,
    clip_adam_scratch,
    ppo_loss,
    ppo_loss_forward,
    ppo_loss_plain,
)
from burn_ppo_torch.config import Config  # noqa: E402
from burn_ppo_torch.envs import make_env  # noqa: E402
from burn_ppo_torch.eval import (  # noqa: E402
    ChunkLog,
    EvalGraph,
    TempSchedule,
    Records,
    Seats,
    seat_maps,
    step_books,
    step_books_plain,
)
from burn_ppo_torch.schedule import Schedule  # noqa: E402
from burn_ppo_torch.ppo.pool_rollout import PoolSeating, collect_rollouts_with_opponents  # noqa: E402
from burn_ppo_torch.ppo.rollout import (  # noqa: E402
    RolloutBuffers,
    TorchRandomSource,
    collect_rollouts,
    finish_rollout,
    init_rollout_carry,
)
from burn_ppo_torch.ppo.rollout import sample_and_store_values as SAMPLE_AND_STORE  # noqa: E402
from burn_ppo_torch.ppo.rollout_graph import RolloutGraph, state_leaves  # noqa: E402
from burn_ppo_torch.ppo.update import AdamState  # noqa: E402
from burn_ppo_torch.ppo.update_graph import UpdateGraph, UpdateRunner  # noqa: E402
from burn_ppo_torch.ppo.window import (  # noqa: E402
    WindowBook,
    record_capacity,
    window_records,
    window_records_plain,
    window_report,
    window_report_plain,
)
from burn_ppo_torch.train import (  # noqa: E402
    Trainer,
    build_network_for_env,
    extract_pool_records,
    make_pool_train_step,
    rollout_runner,
)

E, T = 4096, 128  # CartPole bench shape
T_C4 = 64  # Connect Four self-play shape: 4096 envs x 64 steps
BENCH_UPDATES = 5
CNN_UPDATES = 2
POOL_UPDATES = 10
EP = 1024  # pool envs at 4096 envs and pool fraction 0.25
T_SKULL_POOL = 128  # configs/skull_ctde.toml's steps per update
EP_SKULL = 1229  # pool envs at 4096 envs and pool fraction 0.3
SKULL_CTDE_PARAMS = 784418  # CTDE actor and critic 512x2 on Skull's 135 + 200 inputs
T_LD = 128  # configs/liars_dice*.toml's steps per update
EP_LD = 1024  # pool envs at 4096 envs and pool fraction 0.25
LD_OBS = 270
LD_CTDE_PARAMS = 873778  # CTDE actor 256x2 on 270, critic 512x3 on 120 + 270
LD_MLP_PARAMS = 689714  # MLP 512x3 on 270 -> 49 + value head
LD_UPDATES_MLP = 3
# bench.py's bench_skull_ctde shape on configs/skull_ctde.toml: CTDE actor
# and critic 512x2 tanh, 4096 x 64, 4 epochs x 4 minibatches, no pool.
SKULL_BENCH = {"opponent_pool_fraction": 0.0, "hidden_size": 512, "num_hidden": 2,
               "activation": "tanh", "critic_hidden_size": 512, "critic_num_hidden": 2,
               "num_epochs": 4, "num_minibatches": 4}
# Published H100 SXM peaks (NVIDIA data sheet): HBM, and f32 and f64
# outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
TIMES = ("ms", "plain_ms", "device_ms", "plain_device_ms")
F32_FLOP_PER_S = 67e12
F64_FLOP_PER_S = 34e12
# Dense TF32 on the tensor cores; an f32-accurate product there is three
# TF32 products (the 3xTF32 split of K7). Dense bf16 on the tensor cores
# (K7's bf16 tower).
TF32_FLOP_PER_S = 495e12
BF16_FLOP_PER_S = 989e12
# The kernels line's row of K7's bf16 tower, and the train runs whose K7
# launches are all that tower's (their stacks' weights bf16).
BF16_TOWER = "opponent_actor_forward_bf16_tower"
BF16_RUNS = ("selfplay_pool_bf16", "bf16_flagship_window")
# The kernels line's row of K7's feature front in its bf16 tower, and the
# CNN vs-pool runs whose feature-front launches are all that tower's.
CNN_BF16_TOWER = "opponent_features_forward_bf16_tower"
CNN_BF16_RUNS = ("selfplay_pool_cnn_bf16",)
CNN_POOL_UPDATES_BF16 = 3  # the CNN against the pool in bf16: K reaches 2
# configs/connect_four.toml's default CNN: convs 2 -> 8 -> 8 (3 x 3) over
# the 6 x 7 board, FC 338 -> 32, head 7.
C4_SHAPE, C4_CONV = (6, 7, 2), (8, 8)
WRAPPERS = {
    "cartpole_step_autoreset": cartpole_step_autoreset,
    "masked_gumbel_sample": masked_sample,
    "gae_reverse_scan": compute_gae,
    "connect_four_step_autoreset": connect_four_step_autoreset,
    "gae_multiplayer_reverse_scan": compute_gae_multiplayer,
    "obs_norm_apply": obs_norm_apply,
    "obs_norm_update": obs_norm_update,
    "opponent_actor_forward": opponent_actor_forward,
    "ppo_loss": ppo_loss,
    "clip_adam": clip_adam,
    "episode_stats": summarize_episode_logs,
    "skull_step_autoreset": skull_step_autoreset,
    "return_norm_roll": return_norm_roll,
    "return_norm_finalize": return_norm_finalize,
    "liars_dice_step_autoreset": liars_dice_step_autoreset,
    "temperature_sample": sample_with_temperature,
    "popart_update": popart_update_rescale,
    "popart_denormalize": popart_denormalize,
    "step_books": step_books,
    "window_records": window_records,
    "window_report": window_report,
    "opponent_cnn_front": opponent_cnn_front,
    "opponent_features_forward": opponent_features_forward,
}
SOURCES = {
    "cartpole_step_autoreset": ("burn_ppo_torch/csrc/cartpole_step.cu",
                                "burn_ppo_tpu/envs/cartpole.py:69"),
    "masked_gumbel_sample": ("burn_ppo_torch/csrc/masked_gumbel_sample.cu",
                             "burn_ppo_tpu/ops/categorical.py:27"),
    "gae_reverse_scan": ("burn_ppo_torch/csrc/gae.cu", "burn_ppo_tpu/ops/gae.py:30"),
    "connect_four_step_autoreset": ("burn_ppo_torch/csrc/connect_four_step.cu",
                                    "burn_ppo_tpu/envs/connect_four.py:76"),
    "gae_multiplayer_reverse_scan": ("burn_ppo_torch/csrc/gae_multiplayer.cu",
                                     "burn_ppo_tpu/ops/gae.py:56"),
    "obs_norm_apply": ("burn_ppo_torch/csrc/obs_norm.cu",
                       "burn_ppo_tpu/ppo/normalization.py:78"),
    "obs_norm_update": ("burn_ppo_torch/csrc/obs_norm.cu",
                        "burn_ppo_tpu/ppo/normalization.py:68"),
    "opponent_actor_forward": ("burn_ppo_torch/csrc/opponent_actor.cu",
                               "burn_ppo_tpu/ppo/pool_rollout.py:126"),
    # K7's bf16 tower (launched by K7's wrapper for a stack of bf16
    # weights): the same fusion with the learner's bf16 dense
    # (models/core.py:37)
    BF16_TOWER: ("burn_ppo_torch/csrc/opponent_tower.cu", "burn_ppo_tpu/ppo/pool_rollout.py:126"),
    "ppo_loss": ("burn_ppo_torch/csrc/ppo_loss.cu", "burn_ppo_tpu/ppo/update.py:125"),
    "clip_adam": ("burn_ppo_torch/csrc/clip_adam.cu", "burn_ppo_tpu/ppo/update.py:82"),
    "episode_stats": ("burn_ppo_torch/csrc/episode_stats.cu",
                      "burn_ppo_tpu/ppo/episode_stats.py:25"),
    "skull_step_autoreset": ("burn_ppo_torch/csrc/skull_step.cu",
                             "burn_ppo_tpu/envs/skull.py:280"),
    "return_norm_roll": ("burn_ppo_torch/csrc/return_norm.cu",
                         "burn_ppo_tpu/ppo/normalization.py:105"),
    "return_norm_finalize": ("burn_ppo_torch/csrc/return_norm.cu",
                             "burn_ppo_tpu/ppo/normalization.py:136"),
    "liars_dice_step_autoreset": ("burn_ppo_torch/csrc/liars_dice_step.cu",
                                  "burn_ppo_tpu/envs/liars_dice.py:133"),
    "temperature_sample": ("burn_ppo_torch/csrc/temperature_sample.cu",
                           "burn_ppo_tpu/ops/categorical.py:84"),
    "popart_update": ("burn_ppo_torch/csrc/popart.cu", "burn_ppo_tpu/ppo/normalization.py:272"),
    "popart_denormalize": ("burn_ppo_torch/csrc/popart.cu",
                           "burn_ppo_tpu/ppo/normalization.py:293"),
    "step_books": ("burn_ppo_torch/csrc/eval_step.cu", "burn_ppo_tpu/eval.py:575"),
    "window_records": ("burn_ppo_torch/csrc/window_records.cu", "burn_ppo_tpu/train.py:462"),
    "window_report": ("burn_ppo_torch/csrc/window_report.cu", "burn_ppo_tpu/train.py:333"),
    # the CNN opponents under the vmap of opponent_logits: each slot's
    # obs_norm_apply and the spatial reshape feeding the first conv (K20),
    # and the last relu, flatten, concat, FC tower and head (K7's feature
    # front; its bf16 tower with the learner's bf16 dense)
    "opponent_cnn_front": ("burn_ppo_torch/csrc/opponent_cnn_front.cu",
                           "burn_ppo_tpu/ppo/pool_rollout.py:132"),
    "opponent_features_forward": ("burn_ppo_torch/csrc/opponent_features.cu",
                                  "burn_ppo_tpu/models/network.py:195"),
    CNN_BF16_TOWER: ("burn_ppo_torch/csrc/opponent_features.cu",
                     "burn_ppo_tpu/models/network.py:195"),
}
# The env steps with K14's row code as their sampling front (the step
# kernels' other instance, launched by the same wrappers): eval's sample
# (eval.py:577-579) and env step (eval.py:581-583) in one launch.
SAMPLE_FRONT_REPLACES = "burn_ppo_tpu/eval.py:579"


T_START = time.time()


def emit(phase: str, **fields) -> None:
    """One phase's JSON line, with the seconds since the script started."""
    print(json.dumps({"phase": phase, **fields, "at_s": time.time() - T_START}), flush=True)


def card() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median CUDA-event span around one call. The stream waits for the
    host's launch, so the span includes the wrapper's host work."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def device_ms(fn, reps: int = 10, tries: int = 3, only: str | None = None) -> tuple:
    """Kernel time per call on the card, from the profiler: the CUDA-typed
    events only (a CPU op's device column counts the same kernels again).
    The profiler loses a launch now and then, most often one at the start
    of a profile, so a kernel's sum over ``reps`` calls reads low: each
    kernel counts as the mean of its recorded launches times its launches
    per call, ceil(recorded / reps), which holds while fewer than ``reps``
    of a kernel's launches are lost. ``only`` counts the kernels whose name
    holds it and no other (a kernel alone, not the copies that set up its
    inputs). Returns (ms, launches lost), or (None, None) when no profile
    of ``tries`` recorded a kernel: a reading of 0 is no measurement."""
    fn()
    torch.cuda.synchronize()
    act = torch.profiler.ProfilerActivity
    for _ in range(tries):
        with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA
                   and (only is None or only in e.key)]
        if kernels:
            per_call = [math.ceil(e.count / reps) for e in kernels]
            ms = sum(e.self_device_time_total / e.count * n for e, n in zip(kernels, per_call)) / 1e3
            return ms, sum(n * reps - e.count for e, n in zip(kernels, per_call))
    return None, None


def timed(kernel, plain) -> dict:
    """Events time (the wrapper's host work included) and profiler device
    time of one call, for the kernel's wrapper and its plain version, with
    the launches the profiler lost in ten calls; a device time the profiler
    did not see is null, with a note."""
    out = {"ms": time_ms(kernel), "plain_ms": time_ms(plain)}
    for key, fn in (("device_ms", kernel), ("plain_device_ms", plain)):
        out[key], out[f"{key}_launches_lost"] = device_ms(fn)
        if out[key] is None:
            out["device_note"] = "; ".join(filter(None, (
                out.get("device_note"), f"{key}: the profiler recorded no kernel in three "
                "profiles; not measured")))
    return out


def screen_device_times(node) -> None:
    """A device time under the bound beside it is no measurement (a launch
    the profiler missed, or inputs left in L2 by the call before): null,
    with the reading in a note. Walks every dict of the checks."""
    if isinstance(node, dict):
        b = node.get("bound_ms")
        for k in ("device_ms", "plain_device_ms"):
            if b is not None and node.get(k) is not None and node[k] < b:
                note = f"{k} read {node[k]} ms, under the bound {b} ms: not measured"
                node["device_note"] = "; ".join(filter(None, (node.get("device_note"), note)))
                node[k] = None
        for v in node.values():
            screen_device_times(v)


def max_err(pairs) -> float:
    return max(float((a.float() - b.float()).abs().max()) for a, b in pairs)


def nbytes(*tensors) -> int:
    """Bytes of the distinct buffers among the tensors (nested lists,
    dataclasses and None allowed). A buffer that two fields share, as a
    step's done and its log's completed, counts once; a buffer read and
    then written counts twice only from two calls."""
    seen = {}

    def walk(t):
        if isinstance(t, torch.Tensor):
            seen[(t.data_ptr(), t.numel() * t.element_size())] = t.numel() * t.element_size()
        elif isinstance(t, (list, tuple)):
            for x in t:
                walk(x)
        elif t is not None:
            walk(list(vars(t).values()))

    walk(tensors)
    return sum(seen.values())


def pad_bytes(state) -> int:
    """Bytes of a packed state's zero pad columns, read once and written
    once: they align the rows for 16-byte loads, and the step itself does
    not need them, so a bound leaves them out."""
    return 2 * (state.W - state.PAD_COL) * 4 * state.ints.shape[0]


def bound(bytes_moved: float, flops: float = 0.0, flops64: float = 0.0,
          flops_3xtf32: float = 0.0, flops_bf16: float = 0.0) -> dict:
    """The least time the card could take: the larger of the bytes over
    the HBM rate and the operations over the peak of their type (f32, f64
    for ``flops64``, for ``flops_3xtf32`` three TF32 products each on the
    tensor cores, and bf16 products on the tensor cores for
    ``flops_bf16``)."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = (flops / F32_FLOP_PER_S + flops64 / F64_FLOP_PER_S
             + 3.0 * flops_3xtf32 / TF32_FLOP_PER_S + flops_bf16 / BF16_FLOP_PER_S) * 1e3
    out = {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops
           else "operations", "bytes": bytes_moved, "flops": flops, "flops64": flops64}
    if flops_bf16:
        out["flops_bf16"] = flops_bf16
    if flops_3xtf32:
        out["flops_3xtf32"] = flops_3xtf32
        # the same products at the f32 rate outside the tensor cores
        out["bound_ffma_ms"] = max(t_bytes, flops_3xtf32 / F32_FLOP_PER_S * 1e3)
    return out


def kernel_name(mangled: str) -> str:
    """A kernel's name and integer template arguments from its mangled
    name: the shortest length-prefixed identifier that ends in ``kernel``
    (it may hold digits, as ``opponent_tower_bf16_kernel``; its length's
    digits may follow a hash's), then ``<...>``."""
    found = []
    for m in re.finditer(r"(\d+)(?=[A-Za-z_])", mangled):
        for i in range(len(m.group(1))):
            ident = mangled[m.end():m.end() + int(m.group(1)[i:])]
            if ident.endswith("kernel"):
                found.append((len(ident), m.end()))
    if not found:
        return mangled
    n, start = min(found)
    t = re.match(r"I((?:L[ib]\d+E)+)E", mangled[start + n:])
    return mangled[start:start + n] + (
        "<{}>".format(", ".join(re.findall(r"L[ib](\d+)E", t.group(1)))) if t else "")


def ptxas_summary(text: str) -> list:
    """ptxas -v output as one line per kernel: its name and template
    arguments (from the mangled name), then registers, shared memory and
    spills."""
    out, name, spill = [], None, ""
    for ln in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            spill = ""
            name = kernel_name(m.group(1))
        elif "spill" in ln and name is not None:
            spill = ln.strip()
        elif "Used" in ln and name is not None:
            out.append(f"{name}: {ln.split(':', 1)[1].strip()}; {spill}")
            name = None
    return out


def turns(new, other, who: str = "parent", only: str | None = None,
          other_only: str | None = None) -> dict:
    """The new kernel and another version (the parent commit's, unless
    ``who`` names another), in turns (other, new, new, other): device and
    events ms of each reading; ``only`` and ``other_only`` restrict each
    side's device time to the kernels of that name (``device_ms``)."""
    out: dict = {"device_ms_turns": [], "ms_turns": [], f"{who}_device_ms": [], f"{who}_ms": []}
    for key, fn, name in ((f"{who}_", other, other_only), ("", new, only), ("", new, only),
                          (f"{who}_", other, other_only)):
        out[f"{key}device_ms" if key else "device_ms_turns"].append(device_ms(fn, only=name)[0])
        out[f"{key}ms" if key else "ms_turns"].append(time_ms(fn))
    return out


class ParentKernels:
    """The parent commit's versions of the kernels this tree redesigned
    or whose header it changed (their C entry points as d19fb64 has them),
    built from a checkout of it into a library of their own (one ``nvcc``
    a source, all at once, then one link) and called as its wrappers
    called them, so that they are timed beside the new kernels in the same
    process: K7's f32 tower (``opp_mlp_forward``), its bf16 tower
    (``opp_tower_forward``) and its feature front (``opp_features_forward``
    on the grouped convs' output, every slot's channels of a row), which
    take this tree's arguments, and K20 (``opp_cnn_front``: every slot's
    normalised spatial obs as the grouped convs' input). Its ptxas lines
    cover them, beside this tree's."""

    SOURCES = ("opponent_actor.cu", "opponent_tower.cu", "opponent_features.cu",
               "opponent_cnn_front.cu")

    def __init__(self, parent_dir: Path):
        csrc = parent_dir / "burn_ppo_torch" / "csrc"
        out = ROOT / ".cache" / "burn_ppo_torch" / "parent" / "libparent_kernels.so"
        out.parent.mkdir(parents=True, exist_ok=True)
        objs = [out.parent / f"{Path(f).stem}.o" for f in self.SOURCES]
        nvcc = kernels._nvcc()
        logs = []
        for cmds in ([[nvcc, *kernels.NVCC_FLAGS, "-c", "-o", str(o), str(csrc / f)]
                      for f, o in zip(self.SOURCES, objs)],
                     [[nvcc, *kernels.ARCH, "-shared", "-o", str(out), *map(str, objs)]]):
            for rc, text in kernels._run_all(cmds):
                logs.append(text)
                if rc != 0:
                    raise RuntimeError(f"parent kernels failed to build:\n{text}")
        self.ptxas = ptxas_summary("\n".join(logs))
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        self.lib = ctypes.CDLL(str(out))
        for name, argtypes in (
                *((n, kernels.SIGNATURES[n]) for n in ("opp_mlp_forward", "opp_tower_forward",
                                                       "opp_features_forward")),
                ("opp_cnn_front", [vp] * 4 + [f, vp] + [i] * 7 + [vp])):
            fn = getattr(self.lib, name)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int

    def opponent_forward(self, obs, slot, stack: OpponentStack, clip: float = 10.0):
        """The parent's K7 over the raw obs (its f32 tower at its default
        tiling, or its bf16 tower for bf16 weights) into a new output."""
        args, out = _tower_args(obs, slot, stack, obs.shape[1], clip, "the parent's K7")
        s = kernels.stream(obs.device)
        kernels.check(self.lib.opp_tower_forward(*args, s) if stack.bf16
                      else self.lib.opp_mlp_forward(*args, -1, s), "parent K7")
        return out

    def cnn_front(self, obs, stack: OpponentStack, clip: float = 10.0):
        """The parent's K20: every slot's normalised spatial obs as the
        grouped convs' input, [Ep, K C, H, W] (bf16 values for a bf16
        stack)."""
        Ep, D = obs.shape
        K, (H, W, C), norm = stack.num_slots, stack.obs_shape, stack.norm
        out = torch.empty(Ep, K * C, H, W, dtype=torch.float32, device=obs.device)
        p = kernels.ptr
        norm_ptrs = (None,) * 3 if norm is None else (p(norm.mean), p(norm.m2), p(norm.count))
        kernels.check(self.lib.opp_cnn_front(p(obs), *norm_ptrs, float(clip), p(out), Ep, D, K,
                                             H, W, C, int(stack.bf16),
                                             kernels.stream(obs.device)), "parent K20")
        return out

    def conv_route(self, obs, stack: OpponentStack, clip: float = 10.0):
        """The parent's conv front: its K20, then the grouped cuDNN convs:
        every slot's last conv output of every row, [Ep, K C', H, W]."""
        return grouped_convs(self.cnn_front(obs, stack, clip), stack)

    def features_forward(self, feat, obs, slot, stack: OpponentStack, clip: float = 10.0):
        """The parent's K7 feature front on ``feat`` [Ep, K C', H, W] (a row
        of slot k reads channels [k C', (k + 1) C')) into a new output."""
        H, W, C = stack.obs_shape
        cc = feat.shape[1] // stack.num_slots
        args, out = _tower_args(obs, slot, stack, _feature_width(stack, obs.shape[1]), clip,
                                "the parent's feature front")
        feat = feat.contiguous()
        kernels.check(self.lib.opp_features_forward(
            *args, int(stack.bf16), kernels.ptr(feat), cc * H * W, H * W * C,
            kernels.stream(obs.device)), "parent K7 feature front")
        return out

    def cnn_forward(self, obs, slot, stack: OpponentStack, clip: float = 10.0):
        """The parent's CNN opponents: its K20, the grouped convs, its
        feature front."""
        return self.features_forward(self.conv_route(obs, stack, clip), obs, slot, stack, clip)


class EmptyKernel:
    """An empty kernel of one warp, built with the same flags into a
    library of its own: its device time is the floor under any launch."""

    SOURCE = (
        "#include <cuda_runtime.h>\n"
        "__global__ void empty_kernel() {}\n"
        'extern "C" int empty_launch(void* s) {\n'
        "  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(s)>>>();\n"
        "  return static_cast<int>(cudaGetLastError());\n"
        "}\n")

    def __init__(self):
        d = ROOT / ".cache" / "burn_ppo_torch" / "floor"
        d.mkdir(parents=True, exist_ok=True)
        (d / "empty.cu").write_text(self.SOURCE)
        out = d / "libempty.so"
        res = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-o", str(out),
                              str(d / "empty.cu")], capture_output=True, text=True, timeout=600)
        if res.returncode != 0:
            raise RuntimeError(f"the empty kernel failed to build:\n{res.stdout}{res.stderr}")
        self.lib = ctypes.CDLL(str(out))
        self.lib.empty_launch.argtypes, self.lib.empty_launch.restype = [ctypes.c_void_p], ctypes.c_int

    def __call__(self) -> None:
        kernels.check(self.lib.empty_launch(kernels.stream(torch.device("cuda"))), "empty kernel")


_EMPTY: "EmptyKernel | None" = None


def empty_kernel() -> "EmptyKernel":
    """The empty kernel, built once a process."""
    global _EMPTY
    if _EMPTY is None:
        _EMPTY = EmptyKernel()
    return _EMPTY



def same_kernel_sources(parent_dir: Path) -> bool:
    """Whether the parent's ``csrc`` holds exactly this tree's sources."""
    theirs = parent_dir / "burn_ppo_torch" / "csrc"
    mine = {f.name: f.read_bytes() for f in kernels.sources()}
    return ({f.name for f in theirs.glob("*.cu*")} == set(mine)
            and all((theirs / n).read_bytes() == b for n, b in mine.items()))


def cartpole_inputs(dev, g, n: int) -> tuple:
    """n envs on both sides of the failure thresholds, 5% of them at the
    last step before the 500-step cap, with rolling returns for the roll."""
    def u(*shape):
        return torch.rand(*shape, generator=g, device=dev)

    steps = torch.randint(0, 500, (n,), generator=g, device=dev, dtype=torch.int32)
    state = CartPoleState.of(
        (u(n) - 0.5) * 4.9, (u(n) - 0.5) * 4, (u(n) - 0.5) * 0.43, (u(n) - 0.5) * 4,
        torch.where(u(n) < 0.05, 499, steps).to(torch.int32))
    acc = EpisodeAccumulator(u(n, 1) * 100, torch.randint(0, 499, (n,), generator=g, device=dev,
                                                          dtype=torch.int32))
    action = torch.randint(0, 2, (n,), generator=g, device=dev, dtype=torch.int32)
    reset = (u(n, 4) - 0.5) * 0.1
    returns = torch.randn(n, 1, generator=g, device=dev) * 3
    return state, acc, action, reset, returns


def plain_cartpole(env, state, acc, action, reset, roll):
    """The plain step, then with ``roll`` the plain roll on player 0's slot:
    what the CPU path composes."""
    out = autoreset_step(env, state, acc, action, reset)
    if roll is None:
        return out
    acting = torch.zeros(action.shape[0], dtype=torch.int32, device=action.device)
    ret, samples = return_norm_roll_plain(roll[0], out.rewards[:, 0], acting, out.done, roll[1])
    return out._replace(returns=ret, samples=samples)


def check_cartpole(dev, g) -> dict:
    """K1 against the plain step at E = 4096 and 4097, with and without the
    roll folded in: the discrete outputs, the returns and the samples
    exact, the physics and obs to 1e-5; failures, timeouts and continuing
    envs each required. Timed with the roll at 4096."""
    env = CartPole()
    out = {"tol": {"floats": 1e-5, "discrete_returns_samples": "exact"}, "max_abs_err": 0.0}
    for n in (E, E + 1):
        state, acc, action, reset, returns = cartpole_inputs(dev, g, n)
        for rolled in (False, True):
            roll = (returns, 0.99) if rolled else None
            k = env.step_autoreset(state, acc, action, reset, None, roll)
            p = plain_cartpole(env, state, acc, action, reset, roll)
            torch.cuda.synchronize()
            exact = {"step_idx": (k.state.step_idx, p.state.step_idx),
                     "rewards": (k.rewards, p.rewards), "done": (k.done, p.done),
                     "acc.reward_sum": (k.acc.reward_sum, p.acc.reward_sum),
                     "acc.length": (k.acc.length, p.acc.length),
                     **{f"log.{f}": (getattr(k.log, f), getattr(p.log, f))
                        for f in ("completed", "total_rewards", "length", "outcome",
                                  "active_players")},
                     "mask": (k.mask, p.mask)}
            if rolled:
                exact.update(returns=(k.returns, p.returns), samples=(k.samples, p.samples))
            bad = [name for name, (a, b) in exact.items()
                   if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(a, b)]
            if bad or (not rolled and (k.returns is not None or k.samples is not None)):
                raise AssertionError(f"cartpole_step_autoreset E={n} roll={rolled}: {bad} "
                                     "differ from plain")
            err = max_err([(k.state.phys, p.state.phys), (k.obs, p.obs)])
            if not (err <= 1e-5 and k.obs.shape == p.obs.shape):
                raise AssertionError(f"cartpole_step_autoreset E={n} roll={rolled}: max abs err "
                                     f"{err} > 1e-5")
            done, paid = p.done > 0, p.rewards[:, 0] > 0
            ev = {"failures": int((done & ~paid).sum()), "timeouts": int((done & paid).sum()),
                  "continuing": int((~done).sum())}
            if min(ev.values()) == 0:
                raise AssertionError(f"cartpole_step_autoreset E={n}: a branch was not reached: {ev}")
            out[f"E{n}_{'roll' if rolled else 'no_roll'}"] = {"max_abs_err": err, **ev}
            out["max_abs_err"] = max(out["max_abs_err"], err)
        # the reset off (a watched game's last move): a finished env keeps
        # its stepped row and step count
        k = env.step_autoreset(state, acc, action, reset, reset=False)
        p = autoreset_step(env, state, acc, action, reset, reset=False)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in (
            (k.state.step_idx, p.state.step_idx), (k.done, p.done), (k.rewards, p.rewards),
            (k.acc.length, p.acc.length), (k.log.length, p.log.length)))
        err = max_err([(k.state.phys, p.state.phys), (k.obs, p.obs)])
        kept = int((k.state.step_idx[p.done > 0] > 0).sum())
        if not (same and err <= 1e-5 and kept == int((p.done > 0).sum()) > 0):
            raise AssertionError(f"cartpole_step_autoreset E={n}, reset off: discrete outputs "
                                 f"equal {same}, max abs err {err}, {kept} terminal rows kept")
        out[f"E{n}_reset_off"] = {"max_abs_err": err, "terminal_rows_kept": kept}
        out["max_abs_err"] = max(out["max_abs_err"], err)
    s, a, act, rs, ret = cartpole_inputs(dev, g, E)
    roll = (ret, 0.99)
    k = env.step_autoreset(s, a, act, rs, None, roll)

    def new():
        return env.step_autoreset(s, a, act, rs, None, roll)

    out.update(
        **timed(new, lambda: plain_cartpole(env, s, a, act, rs, roll)),
        library_ms=None,
        # ~30 f32 operations of Euler physics per env and 2 of the roll; a
        # reset row read only where the episode ends
        **bound(nbytes(s, a, act, ret, k) + int(k.done.sum()) * 16, 32.0 * E),
    )
    return out


def check_sample(dev, g, A: int, mask=None) -> dict:
    """A = 2: CartPole, every action legal. A = 7: Connect Four, 0-6
    masked columns per row. Otherwise the given masks (a walk's, or its
    pool rows [L:], a view that need not start 16-byte aligned), one row
    each."""
    rows = E if mask is None else mask.shape[0]
    logits = torch.randn(rows, A, generator=g, device=dev) * 2
    if mask is None and A == 2:
        mask = torch.ones(E, A, device=dev)
    elif mask is None:
        n_masked = torch.randint(0, A, (E, 1), generator=g, device=dev)
        rank = torch.rand(E, A, generator=g, device=dev).argsort(1).argsort(1)
        mask = (rank >= n_masked).float()
    uni = torch.rand(rows, A, generator=g, device=dev).clamp_min(TINY)
    perturbed = apply_action_mask(logits, mask) - torch.log(-torch.log(uni))
    top2 = torch.topk(perturbed, 2, dim=-1).values
    decided = (top2[:, 0] - top2[:, 1]) > 1e-5
    a_p, lp_p = masked_sample_plain(logits, mask, uni)

    def close(fn, who) -> float:
        a_k, lp_k = fn(logits, mask, uni)
        torch.cuda.synchronize()
        if not torch.equal(a_k[decided], a_p[decided]):
            raise AssertionError(f"masked_gumbel_sample{who} [{rows}, {A}]: actions differ from plain")
        if not bool(torch.all(torch.gather(mask, 1, a_k.long()[:, None]) > 0)):
            raise AssertionError(f"masked_gumbel_sample{who} [{rows}, {A}]: sampled a masked action")
        err = max_err([(lp_k, lp_p)])
        if not err <= 1e-5:
            raise AssertionError(f"masked_gumbel_sample{who} [{rows}, {A}]: log-prob max abs err "
                                 f"{err} > 1e-5")
        return err

    out = {
        "rows": rows, "max_abs_err": close(masked_sample, ""), "tol": 1e-5,
        "rows_compared": int(decided.sum()),
        "mask_start_16_byte_aligned": mask.data_ptr() % 16 == 0,
        "legal_per_row_min_mean_max": [float(mask.sum(1).min()), float(mask.sum(1).mean()),
                                       float(mask.sum(1).max())],
        **timed(lambda: masked_sample(logits, mask, uni),
                lambda: masked_sample_plain(logits, mask, uni)),
        "library_ms": None,
        # per (row, action): mask add, two logs, add, compare, exp, add
        **bound(nbytes(logits, mask, uni, a_p, lp_p), 8.0 * rows * A),
    }
    return out


# K3's shapes: the bench shape, configs/cartpole.toml's (one block), and
# a partial 64-step chunk with a partial 32-env block on the 4-byte path.
GAE_SHAPES = ((T, E), (T, 32), (100, E + 1))


def check_gae(dev, g, ptxas: list) -> dict:
    """K3 at ``GAE_SHAPES``: to 1e-5 of the plain version."""
    out = {"tol": 1e-5, "ptxas": kernel_ptxas(ptxas, "gae_reverse_scan_staged")}
    for steps, envs in GAE_SHAPES:
        r = torch.randn(steps, envs, generator=g, device=dev)
        v = torch.randn(steps, envs, generator=g, device=dev)
        d = (torch.rand(steps, envs, generator=g, device=dev) < 0.02).float()
        last = torch.randn(envs, generator=g, device=dev)
        args = (r, v, d, last, 0.99, 0.95)
        adv_k, ret_k = compute_gae(*args)
        adv_p, ret_p = compute_gae_plain(*args)
        torch.cuda.synchronize()
        err = max_err([(adv_k, adv_p), (ret_k, ret_p)])
        name = f"T{steps}_E{envs}"
        if not err <= 1e-5:
            raise AssertionError(f"gae_reverse_scan {name}: max abs err {err} > 1e-5")

        def new(args=args):
            return compute_gae(*args)

        out[name] = {
            "max_abs_err": err,
            **timed(new, lambda: compute_gae_plain(*args)),
            "library_ms": None,
            **bound(nbytes(r, v, d, last, adv_k, ret_k), 8.0 * steps * envs),
        }
    bench = out[f"T{T}_E{E}"]
    out.update(max_abs_err=max(out[f"T{t}_E{e}"]["max_abs_err"] for t, e in GAE_SHAPES),
               **{k: bench[k] for k in TIMES + ("library_ms", "bound_ms", "bound_by")})
    return out


def win_directions(plane: torch.Tensor) -> torch.Tensor:
    """[E, 4] bool: a four of the plane horizontally, vertically and on
    either diagonal (the window groups of has_win)."""
    p = plane
    groups = (
        p[:, :, 0:4] & p[:, :, 1:5] & p[:, :, 2:6] & p[:, :, 3:7],
        p[:, 0:3, :] & p[:, 1:4, :] & p[:, 2:5, :] & p[:, 3:6, :],
        p[:, 0:3, 0:4] & p[:, 1:4, 1:5] & p[:, 2:5, 2:6] & p[:, 3:6, 3:7],
        p[:, 0:3, 3:7] & p[:, 1:4, 2:6] & p[:, 2:5, 1:5] & p[:, 3:6, 0:4],
    )
    return torch.stack([x.flatten(1).any(1) for x in groups], dim=1)


def pick(g, allowed: torch.Tensor) -> torch.Tensor:
    """One random True column per row (row of all False: column 0)."""
    w = allowed.float()
    w[w.sum(1) == 0, 0] = 1.0
    return torch.multinomial(w, 1, generator=g)[:, 0]


def nearly_full_boards(dev, g, n: int) -> torch.Tensor:
    """[n, 6, 7] boards one to five moves from full, without a four: a
    drawn board ((c // 2 + r) % 2 colouring), colours swapped for half,
    the top piece taken off random columns."""
    r = torch.arange(ROWS, device=dev)[:, None]
    c = torch.arange(COLS, device=dev)[None, :]
    drawn = ((c // 2 + r) % 2 + 1).to(torch.int32)
    assert not has_win((drawn == 1)[None]).any() and not has_win((drawn == 2)[None]).any()
    boards = drawn.expand(n, ROWS, COLS).clone()
    swap = torch.rand(n, generator=g, device=dev) < 0.5
    boards = torch.where(swap[:, None, None], 3 - boards, boards)
    removals = torch.randint(1, 6, (n,), generator=g, device=dev)
    rows = torch.arange(n, device=dev)
    for i in range(5):
        col = torch.randint(0, COLS, (n,), generator=g, device=dev)
        top = (boards[rows, :, col] == 0).sum(1)  # row of the column's top piece
        take = (i < removals) & (top < ROWS)
        boards[rows[take], top[take], col[take]] = 0
    return boards


def connect_four_states(dev, g):
    """E states reached by random legal play (mixed depths, since games
    restart as they end), the last 512 replaced by nearly full boards and
    64 marked done with a random winner."""
    env = ConnectFour()
    empty = torch.empty(E, 0, device=dev)
    state = env.reset(empty)
    acc = EpisodeAccumulator.zero(E, 2, dev)
    for _ in range(25):
        out = autoreset_step(env, state, acc, pick(g, env.action_mask(state) > 0).to(torch.int32),
                             empty)
        state, acc = out.state, out.acc
    f = {name: x.clone() for name, x in state.fields().items()}
    full = nearly_full_boards(dev, g, 512)
    f["board"][-512:] = full
    n1, n2 = (full == 1).sum((1, 2)), (full == 2).sum((1, 2))
    f["current"][-512:] = (n1 != n2).to(torch.int32)
    f["winner"][-512:] = -1
    f["step_idx"][-512:] = (n1 + n2).to(torch.int32)
    done_rows = torch.randperm(E - 512, generator=g, device=dev)[:64]
    f["done"][done_rows] = True
    f["winner"][done_rows] = torch.randint(-1, 3, (64,), generator=g, device=dev,
                                           dtype=torch.int32)
    acc.reward_sum += torch.randint(-2, 3, (E, 2), generator=g, device=dev).float()
    return env, ConnectFourState.of(**f), acc


def connect_four_actions(env, state, dev, g) -> torch.Tensor:
    """Half the envs take a winning column where they have one; 5% play a
    full column, 3% an action out of [0, 7); the rest a random legal one."""
    legal = env.action_mask(state) > 0
    wins = torch.stack([
        env.step(state, torch.full((E,), c, dtype=torch.int32, device=dev))[1].abs().sum(1) > 0
        for c in range(COLS)
    ], dim=1)
    u = torch.rand(E, generator=g, device=dev)
    act = pick(g, legal)
    act = torch.where((u < 0.5) & wins.any(1), pick(g, wins), act)
    act = torch.where((u >= 0.5) & (u < 0.55) & (~legal).any(1), pick(g, ~legal), act)
    wild = torch.tensor([-1, 7, 100, -50], device=dev)[torch.randint(0, 4, (E,), generator=g,
                                                                      device=dev)]
    return torch.where(u > 0.97, wild, act).to(torch.int32)


def kernel_ptxas(ptxas: list, name: str) -> list:
    """The ptxas lines of one kernel (registers, shared memory, stack frame
    and spills)."""
    return [ln for ln in ptxas if ln.startswith(f"{name}_kernel")]


def check_connect_four(dev, g, ptxas: list) -> dict:
    """K4 against the plain step over four consecutive steps: every output
    equal, bit for bit, with the reset on and off (a finished env's
    terminal row kept, as a watched game's last move; the finished rows so
    checked counted). Timed on the last step."""
    env, state, acc = connect_four_states(dev, g)
    empty = torch.empty(E, 0, device=dev)
    stats = {"steps": 4, "dones": 0, "wins_h_v_d1_d2": [0, 0, 0, 0], "draws": 0,
             "no_outcome": 0, "out_of_range": 0, "done_in": 0, "terminal_rows_kept": 0}
    for _ in range(4):
        action = connect_four_actions(env, state, dev, g)
        k = env.step_autoreset(state, acc, action, empty)
        p = autoreset_step(env, state, acc, action, empty)
        torch.cuda.synchronize()
        bad = step_differences(k, p, ConnectFourState.INT_FIELDS)
        if bad:
            raise AssertionError(f"connect_four_step_autoreset: {bad} differ from plain")
        bad = step_differences(env.step_autoreset(state, acc, action, empty, reset=False),
                               autoreset_step(env, state, acc, action, empty, reset=False),
                               ConnectFourState.INT_FIELDS)
        if bad:
            raise AssertionError(f"connect_four_step_autoreset, reset off: {bad} differ from "
                                 "plain")
        stats["terminal_rows_kept"] += int(p.done.sum())
        stepped, rewards, done = env.step(state, action)
        won = rewards.abs().sum(1) > 0
        dirs = win_directions(stepped.board == (state.current + 1)[:, None, None])[won]
        stats["dones"] += int(done.sum())
        stats["wins_h_v_d1_d2"] = [a + int(b) for a, b in zip(stats["wins_h_v_d1_d2"],
                                                             dirs.sum(0))]
        stats["draws"] += int((done & (p.log.outcome == 1).all(1)).sum())
        stats["no_outcome"] += int((done & (p.log.outcome == 0).all(1)).sum())
        stats["out_of_range"] += int(((action < 0) | (action >= COLS)).sum())
        stats["done_in"] += int(state.done.sum())
        last = (state, acc, action)
        state, acc = p.state, p.acc
    if (min(stats["wins_h_v_d1_d2"]) == 0 or min(stats["draws"], stats["no_outcome"],
                                                   stats["out_of_range"], stats["done_in"],
                                                   stats["terminal_rows_kept"]) == 0):
        raise AssertionError(f"connect_four_step_autoreset: a branch was not reached: {stats}")
    s, a, act = last
    k = env.step_autoreset(s, a, act, empty)
    out = {
        "max_abs_err": 0.0, "tol": "exact", **stats,
        "ptxas": kernel_ptxas(ptxas, "connect_four_step_autoreset"),
        **timed(lambda: env.step_autoreset(s, a, act, empty),
                lambda: autoreset_step(env, s, a, act, empty)),
        "library_ms": None,
        # the 69 four-in-a-row windows of the mover, a few operations each
        **bound(nbytes(s, a, act, k) - pad_bytes(s), 300.0 * E),
    }
    return out


def step_differences(k, p, fields=()) -> list:
    """Names of the outputs of two auto-reset steps that differ: the packed
    state (and by field, each of ``fields``), the shaping coefficient where
    the state has one, the log, accumulators, rewards, done, obs, mask and
    privileged obs."""
    pairs = {f"state.{f}": (getattr(k.state, f), getattr(p.state, f)) for f in fields}
    pairs["state.ints"] = (k.state.ints, p.state.ints)
    if hasattr(p.state, "shaping_coef"):
        pairs["state.shaping_coef"] = (k.state.shaping_coef, p.state.shaping_coef)
    pairs.update({f"log.{f}": (getattr(k.log, f), getattr(p.log, f))
                  for f in ("completed", "total_rewards", "length", "outcome", "active_players")})
    pairs.update({"acc.reward_sum": (k.acc.reward_sum, p.acc.reward_sum),
                  "acc.length": (k.acc.length, p.acc.length), "rewards": (k.rewards, p.rewards),
                  "done": (k.done, p.done), "obs": (k.obs, p.obs), "mask": (k.mask, p.mask)})
    if p.priv is not None:
        pairs["priv"] = (k.priv, p.priv)
    return [name for name, (a, b) in pairs.items() if a.dtype != b.dtype or not torch.equal(a, b)]


def skull_walk(dev, g, n: int, steps: int) -> tuple:
    """K11 against the plain step at every step of a random-legal walk of
    4096 envs of ``Skull(n)``: every output equal, bit for bit, with the
    reset on and, every fourth step, with it off (a finished env's
    terminal row kept, as the assistant steps; the finished rows so
    checked counted). Before each step 15% of the envs get a forced
    discard and 0.3% are marked finished; half play with a shaping
    coefficient of 0.05. Returns (env, the last step's inputs and K11
    output, event counts)."""
    env = Skull(n)
    empty = torch.empty(E, 0, device=dev)
    state = env.reset(empty)
    state.shaping_coef = (torch.arange(E, device=dev) % 2) * 0.05
    acc = EpisodeAccumulator.zero(E, n, dev)
    ev = {"steps": steps, "phase_placing_bidding_revealing": [0, 0, 0], "game_ends": 0,
          "skull_hits": 0, "rose_wins": 0, "eliminations": 0, "invalid_actions": 0,
          "finished_games_in": 0, "forced_discards_revealing": 0, "full_histories": 0,
          "terminal_rows_kept": 0}
    for step in range(steps):
        fd = torch.randint(0, 2, (E,), generator=g, device=dev, dtype=torch.int32)
        fd = torch.where(torch.rand(E, generator=g, device=dev) < 0.15, fd, -1)
        over = state.game_over | (torch.rand(E, generator=g, device=dev) < 0.003)
        state = SkullState.of(**{**state.fields(), "forced_discard": fd, "game_over": over})
        mask = env.action_mask(state)
        action = walk_actions(mask, g)
        u = torch.rand(E, generator=g, device=dev)
        k = env.step_autoreset(state, acc, action, empty, u)
        p = autoreset_step(env, state, acc, action, empty, u)
        torch.cuda.synchronize()
        bad = step_differences(k, p, SKULL_FIELDS)
        if bad:
            raise AssertionError(f"skull_step_autoreset P={n}: {bad} differ from plain")
        bad = step % 4 == 0 and step_differences(
            env.step_autoreset(state, acc, action, empty, u, reset=False),
            autoreset_step(env, state, acc, action, empty, u, reset=False), SKULL_FIELDS)
        if bad:
            raise AssertionError(f"skull_step_autoreset P={n}, reset off: {bad} differ from "
                                 "plain")
        legal = torch.gather(mask, 1, action.long().clamp(0, 32)[:, None])[:, 0] > 0
        valid = (action >= 0) & (action < 33) & legal & ~state.game_over
        done = k.done > 0
        ev["terminal_rows_kept"] += int(done.sum()) if step % 4 == 0 else 0
        for ph in range(3):
            ev["phase_placing_bidding_revealing"][ph] += int((state.phase == ph).sum())
        ev["game_ends"] += int((done & valid).sum())
        ev["skull_hits"] += int(((k.rewards < 0).any(1) & ~done).sum())
        ev["rose_wins"] += int(((k.rewards > 0).any(1) & ~done).sum())
        ev["eliminations"] += int(((k.state.num_eliminated > state.num_eliminated) & ~done).sum())
        ev["invalid_actions"] += int((~valid & ~state.game_over).sum())
        ev["finished_games_in"] += int(state.game_over.sum())
        ev["forced_discards_revealing"] += int(((state.forced_discard >= 0) & (state.phase == 2)
                                                & valid).sum())
        ev["full_histories"] += int((state.hist_len == 8).sum())
        last = (state, acc, action, u, k)
        state, acc = k.state, k.acc
    return env, last, ev


def check_skull(dev, g) -> tuple:
    """K11 along walks at 4 (300 steps), 2 and 6 players (80 steps each);
    every branch must occur. Timed on the last P = 4 step. Returns (the
    check, the last P = 4 mask and obs for K2 and K7)."""
    out = {"max_abs_err": 0.0, "tol": "exact"}
    walks = {}
    for n, steps in ((4, 300), (2, 80), (6, 80)):
        walks[n] = skull_walk(dev, g, n, steps)
        out[f"P{n}"] = walks[n][2]
    for key in ("game_ends", "skull_hits", "rose_wins", "eliminations", "invalid_actions",
                "finished_games_in", "forced_discards_revealing", "terminal_rows_kept"):
        if out["P4"][key] == 0:
            raise AssertionError(f"skull_step_autoreset: no {key} in the P=4 walk: {out['P4']}")
    if min(out["P4"]["phase_placing_bidding_revealing"]) == 0 or out["P6"]["full_histories"] == 0:
        raise AssertionError(f"skull_step_autoreset: a branch was not reached: {out}")
    env, (s, a, act, u, k), _ = walks[4]
    empty = torch.empty(E, 0, device=dev)
    out.update(
        **timed(lambda: env.step_autoreset(s, a, act, empty, u),
                lambda: autoreset_step(env, s, a, act, empty, u)),
        library_ms=None,
        # the mask, the phase machine, placements, obs and privileged obs:
        # ~2,000 integer and f32 operations per env
        **bound(nbytes(s, a, act, u, k) - pad_bytes(s), 2000.0 * E),
    )
    return out, k.mask, k.obs


def liars_dice_walk(dev, g, steps: int) -> tuple:
    """K13 against the plain step at every step of a random-legal walk of
    4096 envs (``walk_actions``: calls, patient rounds, 1% unmasked and
    0.5% out-of-range actions): every output equal, bit for bit, with the
    reset on and, every fourth step, with it off (a finished env's
    terminal row kept, as a watched game's last move; the finished rows so
    checked counted). Before each step 0.3% of the envs are marked
    finished; half play with a shaping coefficient of 0.05. Returns (env,
    the last step's inputs and K13 output, event counts)."""
    env = LiarsDice()
    state = env.reset(torch.rand(E, 8, generator=g, device=dev))
    state = LiarsDiceState(state.ints, (torch.arange(E, device=dev) % 2) * 0.05)
    acc = EpisodeAccumulator.zero(E, 4, dev)
    ev = dict.fromkeys(("calls", "dice_lost", "eliminations", "game_ends", "finished_games_in",
                        "invalid_actions", "out_of_range_actions", "full_histories",
                        "shaped_rounds", "terminal_rows_kept"), 0)
    for step in range(steps):
        over = state.game_over | (torch.rand(E, generator=g, device=dev) < 0.003)
        state = LiarsDiceState.of(state.shaping_coef, **{**state.fields(), "game_over": over})
        mask = env.action_mask(state)
        action = liars_dice_actions(mask, g)
        u_reset = torch.rand(E, 8, generator=g, device=dev)
        u_step = torch.rand(E, 8, generator=g, device=dev)
        k = env.step_autoreset(state, acc, action, u_reset, u_step)
        p = autoreset_step(env, state, acc, action, u_reset, u_step)
        torch.cuda.synchronize()
        bad = step_differences(k, p)
        if bad:
            raise AssertionError(f"liars_dice_step_autoreset: {bad} differ from plain")
        bad = step % 4 == 0 and step_differences(
            env.step_autoreset(state, acc, action, u_reset, u_step, reset=False),
            autoreset_step(env, state, acc, action, u_reset, u_step, reset=False))
        if bad:
            raise AssertionError(f"liars_dice_step_autoreset, reset off: {bad} differ from plain")
        ev["terminal_rows_kept"] += int((k.done > 0).sum()) if step % 4 == 0 else 0
        stepped, _, _ = env.step(state, action, u_step)
        in_range = (action >= 0) & (action < 49)
        legal = torch.gather(mask, 1, action.long().clamp(0, 48)[:, None])[:, 0] > 0
        valid = in_range & legal & ~state.game_over
        done = k.done > 0
        ev["calls"] += int((valid & (action == 48)).sum())
        ev["dice_lost"] += int((state.dice_count.sum(1) - stepped.dice_count.sum(1)).sum())
        ev["eliminations"] += int((stepped.num_eliminated > state.num_eliminated).sum())
        ev["game_ends"] += int((done & valid).sum())
        ev["finished_games_in"] += int(state.game_over.sum())
        ev["invalid_actions"] += int((~valid & ~state.game_over).sum())
        ev["out_of_range_actions"] += int((~in_range).sum())
        ev["full_histories"] += int((state.hist_len == 16).sum())
        ev["shaped_rounds"] += int(((k.rewards != 0).any(1) & ~done).sum())
        last = (state, acc, action, u_reset, u_step, k)
        state, acc = k.state, k.acc
    return env, last, ev


def check_liars_dice(dev, g, ptxas: list) -> tuple:
    """K13 along a walk of 300 steps at E = 4096; every event must occur.
    Returns (the check, the last mask and obs for K2, K6 and K7)."""
    env, (s, a, act, ur, us, k), ev = liars_dice_walk(dev, g, 300)
    missing = [name for name, n in ev.items() if n == 0]
    if missing:
        raise AssertionError(f"liars_dice_step_autoreset: no {missing} in the walk: {ev}")
    # The kernel needs an env's reset uniforms only where the step is done
    # and its step uniforms only where a call opens a new round: one
    # 32-byte row (8 floats, one sector) each.
    done = k.done > 0
    new_round = (act == 48) & (s.bid_qty > 0) & ~s.game_over & ~done
    uniform_rows = int(done.sum()) + int(new_round.sum())
    out = {
        "max_abs_err": 0.0, "tol": "exact", "steps": 300, "events": ev,
        "ptxas": kernel_ptxas(ptxas, "liars_dice_step_autoreset"),
        **timed(lambda: env.step_autoreset(s, a, act, ur, us),
                lambda: autoreset_step(env, s, a, act, ur, us)),
        "library_ms": None,
        "uniform_rows_read": {"reset": int(done.sum()), "step": int(new_round.sum())},
        # the mask, the step, the reset, obs and privileged obs: ~1,500
        # integer and f32 operations per env
        **bound(nbytes(s, a, act, k) - pad_bytes(s) + uniform_rows * 8 * 4, 1500.0 * E),
    }
    return out, k.mask, k.obs


def check_return_norm_roll(dev, g) -> dict:
    """K12's roll at CartPole's [4096, 1] and at [4096, 4]: exact."""
    out = {"max_abs_err": 0.0, "tol": "exact"}
    for P in (1, 4):
        args = (torch.randn(E, P, generator=g, device=dev) * 3,
                torch.randn(E, generator=g, device=dev),
                torch.randint(0, P, (E,), generator=g, device=dev, dtype=torch.int32),
                (torch.rand(E, generator=g, device=dev) < 0.02).float(), 0.99)
        k = return_norm_roll(*args)
        p = return_norm_roll_plain(*args)
        torch.cuda.synchronize()
        if not (torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])):
            raise AssertionError(f"return_norm_roll P={P}: differs from plain")
        if P == 1:
            out.update(**timed(lambda: return_norm_roll(*args), lambda: return_norm_roll_plain(*args)),
                       library_ms=None,
                       **bound(nbytes(*args[:4], k), 3.0 * E))
    return out


def check_return_norm_finalize(dev, g) -> dict:
    """K12's finalize over CartPole's [524288] (128 x 4096): into an empty
    and into a filled state, with and without a valid mask, and a mask
    with no valid sample. f64 stats to 1e-12 relative, normalized rewards
    to 2 f32 ulp; the empty mask leaves the state exactly as it was; two
    calls give the same bits. Timed with and without the mask."""
    N = E * T
    tol = {"stats64_rel": 1e-12, "normalized_rel": 2.4e-7}
    out = {"tol": tol, "max_abs_err": 0.0}
    z = torch.zeros((), device=dev)
    scratch = return_norm_scratch(dev)
    out["scratch_doubles"] = scratch.numel()
    states = {"empty": ReturnNormState(torch.zeros(E, 1, device=dev), z, z.clone(), z.clone(),
                                       scratch),
              "filled": ReturnNormState(torch.zeros(E, 1, device=dev), z + 0.37, z + 4.1e6,
                                        z + 2.6e6, scratch)}
    samples = torch.randn(N, generator=g, device=dev) * 2 + 0.5
    rewards = torch.randn(N, generator=g, device=dev)
    valid = (torch.rand(N, generator=g, device=dev) < 0.75).float()

    def close(ks, kn, ps, pn, what):
        rel_s = float(((ks - ps).abs() / ps.abs().clamp_min(1e-300)).max())
        rel_n = float(((kn - pn).abs() / pn.abs().clamp_min(1e-30)).max())
        if not (rel_s <= tol["stats64_rel"] and rel_n <= tol["normalized_rel"]):
            raise AssertionError(f"return_norm_finalize {what}: stats rel {rel_s}, "
                                 f"normalized rel {rel_n}")
        return {"stats64_rel": rel_s, "normalized_rel": rel_n}

    for sname, st in states.items():
        for vname, w in (("all", None), ("masked", valid)):
            ks, kn = return_norm_finalize_f64(st, samples, rewards, 10.0, w)
            again = return_norm_finalize_f64(st, samples, rewards, 10.0, w)
            ps, pn = return_norm_finalize_f64_plain(st, samples, rewards, 10.0, w)
            torch.cuda.synchronize()
            if not (torch.equal(ks, again[0]) and torch.equal(kn, again[1])):
                raise AssertionError(f"return_norm_finalize {sname}/{vname}: two calls differ")
            out[f"{sname}_{vname}"] = close(ks, kn, ps, pn, f"{sname}/{vname}")
            out["max_abs_err"] = max(out["max_abs_err"], max_err([(kn, pn)]))
    out["bit_identical_across_calls"] = True
    new, _ = return_norm_finalize(states["filled"], samples, rewards, 10.0, torch.zeros_like(valid))
    torch.cuda.synchronize()
    if not all(torch.equal(getattr(new, f), getattr(states["filled"], f)) for f in ("mean", "m2", "count")):
        raise AssertionError("return_norm_finalize: a batch without valid samples moved the stats")
    st = states["empty"]
    x64 = samples.double()
    for vname, w in (("all", None), ("masked", valid)):
        def kern(w=w):
            return return_norm_finalize_f64(st, samples, rewards, 10.0, w)

        entry = {
            **timed(kern, lambda w=w: return_norm_finalize_f64_plain(st, samples, rewards, 10.0, w)),
            "library_ms": time_ms(lambda: torch.cumsum(x64, 0)),
            "library_turns": turns(kern, lambda: torch.cumsum(x64, 0), who="library",
                                   only="return_norm_finalize"),
            # read samples, rewards (and valid), write the normalized rewards
            # and the stats; ~25 f64 operations per element
            **bound(nbytes(samples, rewards, w) + nbytes(rewards) + 24, flops64=25.0 * N),
        }
        out[f"timed_{vname}"] = entry
    out.update({k: out["timed_all"][k] for k in TIMES + ("library_ms", "bound_ms", "bound_by")},
               library_call="torch.cumsum of the f64 samples (one of the three prefix sums, no stats)")
    return out


def turn_based_rollout(dev, g, P: int, steps: int = T_C4):
    """[steps, 4096, P] rewards, dones ~5%, acting players in turn order
    with a random first player after every episode end."""
    done = (torch.rand(steps, E, generator=g, device=dev) < 0.05).float()
    acting = torch.empty(steps, E, dtype=torch.int32, device=dev)
    cur = torch.randint(0, P, (E,), generator=g, device=dev, dtype=torch.int32)
    for t in range(steps):
        acting[t] = cur
        restart = torch.randint(0, P, (E,), generator=g, device=dev, dtype=torch.int32)
        cur = torch.where(done[t] > 0, restart, (cur + 1) % P)
    outcome = torch.randn(steps, E, P, generator=g, device=dev).sign()
    noise = torch.randn(steps, E, P, generator=g, device=dev) * 0.1
    noise *= torch.rand(steps, E, P, generator=g, device=dev) < 0.1
    rewards = torch.where(done[..., None] > 0, outcome, 0.0) + noise
    values = torch.randn(steps, E, generator=g, device=dev) * 0.5
    last_vpp = torch.randn(E, P, generator=g, device=dev) * 0.5
    return rewards, values, done, acting, last_vpp


def check_gae_multiplayer(dev, g, ptxas: list) -> dict:
    """K5 at Connect Four's [64, 4096, 2], Skull's bench shape [64, 4096,
    4] and the [128, 4096, 4] of skull_ctde.toml and both Liar's Dice
    configs: to 1e-5 of the plain version."""
    out = {"tol": 1e-5, "ptxas": kernel_ptxas(ptxas, "gae_multiplayer_staged")}
    for P, steps in ((2, T_C4), (4, T_C4), (4, T_LD)):
        args = turn_based_rollout(dev, g, P, steps)
        adv_k, ret_k = compute_gae_multiplayer(*args, 0.99, 0.95)
        adv_p, ret_p = compute_gae_multiplayer_plain(*args, 0.99, 0.95)
        torch.cuda.synchronize()
        err = max_err([(adv_k, adv_p), (ret_k, ret_p)])
        if not err <= 1e-5:
            raise AssertionError(f"gae_multiplayer_reverse_scan P={P}: max abs err {err} > 1e-5")
        name = f"P{P}" if steps == T_C4 else f"T{steps}_P{P}"

        def new():
            return compute_gae_multiplayer(*args, 0.99, 0.95)

        out[name] = {
            "max_abs_err": err,
            **timed(new, lambda: compute_gae_multiplayer_plain(*args, 0.99, 0.95)),
            "library_ms": None, **bound(nbytes(*args, adv_k, ret_k), 12.0 * steps * E * P),
        }
    out.update(max_abs_err=max(v["max_abs_err"] for k, v in out.items() if k.startswith(("P", "T"))),
               **{k: out["P2"][k] for k in TIMES + ("library_ms", "bound_ms", "bound_by")})
    return out


def connect_four_like(dev, g, n: int, D: int = 86) -> torch.Tensor:
    """[n, D] 0/1 columns with per-column rates, two of them constant
    (Connect Four's 86 by default; Liar's Dice's obs are 270 such columns
    but for a few fractions)."""
    rate = torch.rand(D, generator=g, device=dev)
    rate[5], rate[40] = 0.0, 1.0
    return (torch.rand(n, D, generator=g, device=dev) < rate).float()


def check_obs_norm_apply(dev, g, obs: torch.Tensor, rows: int) -> dict:
    """K6's apply on ``obs`` [4096, D] to 1e-6, from states at count 0 and
    1 (the identity) and merged from ``rows`` x D; timed on the merged one."""
    D = obs.shape[1]
    z = torch.zeros(D, device=dev)
    states = {
        "count0": ObsNormState(mean=z, m2=z.clone(), count=torch.zeros((), device=dev)),
        "count1": ObsNormState(mean=obs[0].clone(), m2=z.clone(), count=torch.ones((), device=dev)),
        "merged": obs_norm_update_plain(ObsNormState.create(D, dev),
                                        connect_four_like(dev, g, rows, D)),
    }
    out = {"tol": 1e-6, "max_abs_err": 0.0}
    for name, st in states.items():
        k = obs_norm_apply(st, obs)
        p = obs_norm_apply_plain(st, obs)
        torch.cuda.synchronize()
        err = max_err([(k, p)])
        if not err <= 1e-6:
            raise AssertionError(f"obs_norm_apply [{E}, {D}] {name}: max abs err {err} > 1e-6")
        if name != "merged" and not torch.equal(k, obs):
            raise AssertionError(f"obs_norm_apply [{E}, {D}] {name}: not the identity below count 2")
        out[name] = err
        out["max_abs_err"] = max(out["max_abs_err"], err)
    st = states["merged"]
    out.update(timed(lambda: obs_norm_apply(st, obs), lambda: obs_norm_apply_plain(st, obs)))
    out.update(library_ms=None, **bound(nbytes(obs, st) + nbytes(obs), 6.0 * obs.numel()))
    return out


def obs_norm_batches(dev, g) -> dict:
    """The update batches [T x E, D] of the train paths with obs norm:
    name -> a function making one (Liar's Dice MLP, Connect Four,
    CartPole)."""
    return {
        "liars_dice_524288x270": lambda: connect_four_like(dev, g, E * T_LD, LD_OBS),
        "c4_262144x86": lambda: connect_four_like(dev, g, E * T_C4),
        "cartpole_524288x5": lambda: torch.randn(E * T, 5, generator=g, device=dev)
        * torch.tensor([1.0, 0.5, 0.1, 0.8, 0.3], device=dev)
        + torch.tensor([0.0, 0.1, 0.0, -0.1, 0.5], device=dev),
    }


def cold_device_ms(fn, kernel: str, reps: int = 10, tries: int = 3):
    """Device time per call of the kernels whose name holds ``kernel``,
    with L2 flushed before every call (a 256 MB fill, outside the reading):
    the time of a call whose inputs come from HBM. None when no profile of
    ``tries`` recorded the kernel."""
    flush = torch.empty(64 << 20, device="cuda")
    fn()
    torch.cuda.synchronize()
    act = torch.profiler.ProfilerActivity
    for _ in range(tries):
        with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
            for _ in range(reps):
                flush.zero_()
                fn()
            torch.cuda.synchronize()
        hits = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.key]
        if hits:
            return sum(e.self_device_time_total / e.count for e in hits) / 1e3
    return None


def check_obs_norm_batch(dev, g) -> dict:
    """K6's apply on each update batch as the train step runs it once per
    update, with the state merged from another batch of the same shape: to
    1e-6 of the plain version, timed beside its bound (the batch and the
    state read, the batch written), and its device time also with L2
    flushed before each call (``cold_l2_device_ms``; at [524288, 5] the
    batch and its output fit in L2 between calls)."""
    out = {"tol": 1e-6, "max_abs_err": 0.0}
    for name, make in obs_norm_batches(dev, g).items():
        batch = make()
        st = obs_norm_update_plain(ObsNormState.create(batch.shape[1], dev), make())
        k = obs_norm_apply(st, batch)
        p = obs_norm_apply_plain(st, batch)
        torch.cuda.synchronize()
        err = max_err([(k, p)])
        if not err <= 1e-6:
            raise AssertionError(f"obs_norm_apply {name}: max abs err {err} > 1e-6")
        del p

        def new():
            return obs_norm_apply(st, batch)

        res = {
            "max_abs_err": err, **timed(new, lambda: obs_norm_apply_plain(st, batch)),
            "cold_l2_device_ms": cold_device_ms(new, "obs_norm_apply"),
            "library_ms": None, **bound(nbytes(batch, st) + nbytes(batch), 6.0 * batch.numel()),
        }
        del k
        out[name] = res
        out["max_abs_err"] = max(out["max_abs_err"], err)
    return out


def check_obs_norm_update(dev, g) -> dict:
    """Into an empty and into a filled state, at the Connect Four update
    batch [262144, 86], the CartPole one [524288, 5] and Liar's Dice's
    [524288, 270]: mean to 1e-6 absolute, m2 to 1e-5 relative, count
    exact. The update merges in place (into the state itself), and is
    timed so. ``max_abs_err`` is the mean's; the top level's times are
    Connect Four's."""
    batches = {
        "c4_262144x86": lambda: connect_four_like(dev, g, E * T_C4),
        "cartpole_524288x5": lambda: torch.randn(E * T, 5, generator=g, device=dev)
        * torch.tensor([1.0, 0.5, 0.1, 0.8, 0.3], device=dev)
        + torch.tensor([0.0, 0.1, 0.0, -0.1, 0.5], device=dev),
        "liars_dice_524288x270": lambda: connect_four_like(dev, g, E * T_LD, LD_OBS),
    }
    out = {"tol": {"mean": 1e-6, "m2_rel": 1e-5, "count": "exact"}, "max_abs_err": 0.0,
           "library_call": "torch.var_mean(batch, dim=0) (the batch moments, no merge)"}
    def copy(st):
        return ObsNormState(st.mean.clone(), st.m2.clone(), st.count.clone())

    for name, make in batches.items():
        x1, x2 = make(), make()
        st = ObsNormState.create(x1.shape[1], dev)
        errs = []
        for x in (x1, x2):
            k = obs_norm_update(copy(st), x)
            p = obs_norm_update_plain(copy(st), x)
            torch.cuda.synchronize()
            mean_err = max_err([(k.mean, p.mean)])
            m2_rel = float(((k.m2 - p.m2).abs() / p.m2.abs().clamp_min(1e-30)).max())
            if not mean_err <= 1e-6:
                raise AssertionError(f"obs_norm_update {name}: mean err {mean_err} > 1e-6")
            if not bool(torch.all((k.m2 - p.m2).abs() <= 1e-5 * p.m2.abs())):
                raise AssertionError(f"obs_norm_update {name}: m2 rel err {m2_rel} > 1e-5")
            if not torch.equal(k.count, p.count):
                raise AssertionError(f"obs_norm_update {name}: count {k.count} != {p.count}")
            errs.append({"mean_abs": mean_err, "m2_rel": m2_rel, "count": float(k.count)})
            out["max_abs_err"] = max(out["max_abs_err"], mean_err)
            st = p
        work, plain_work = copy(st), copy(st)

        def new():
            return obs_norm_update(work, x1)

        out[name] = {
            "into_empty": errs[0], "into_filled": errs[1],
            **timed(new, lambda: obs_norm_update_plain(plain_work, x1)),
            "library_ms": time_ms(lambda: torch.var_mean(x1, dim=0)),
            # the yardstick's device ms in turns with the kernel's
            "library_turns": turns(new, lambda: torch.var_mean(x1, dim=0), who="library",
                                   only="obs_norm_"),
            # read the batch and the state, write the state
            **bound(nbytes(x1) + 3 * x1.shape[1] * 4 * 2, 4.0 * x1.numel()),
        }
    out.update({k: out["c4_262144x86"][k] for k in TIMES + ("library_ms", "bound_ms", "bound_by")})
    return out


def random_opponents(dev, g, K: int, act: str, D: int = 86, H: int = 512, A: int = 7,
                     depth: int = 2) -> OpponentStack:
    """K random actor towers D -> H (x depth) -> A, Connect Four's 86 -> 512
    -> 512 -> 7 by default (fan-in scaled) and obs normalisers: slot 0 at
    count 0 (the identity), slot 1 at count 1, the others merged."""
    sizes = [D] + [H] * depth + [A]
    weights = [torch.randn(K, i, o, generator=g, device=dev) / i ** 0.5
               for i, o in zip(sizes, sizes[1:])]
    biases = [torch.randn(K, o, generator=g, device=dev) * 0.1 for o in sizes[1:]]
    count = torch.full((K,), 5000.0, device=dev)
    count[0] = 0.0
    count[1] = 1.0
    norm = ObsNormState(mean=torch.rand(K, D, generator=g, device=dev),
                        m2=torch.rand(K, D, generator=g, device=dev) * 1000.0, count=count)
    return OpponentStack(weights=weights, biases=biases, activation=act, norm=norm)


def check_opponent_actor(dev, g, skull_obs: torch.Tensor, ld_obs: torch.Tensor,
                         parent: "ParentKernels | None" = None) -> dict:
    """K7 at the pool blocks the main paths give it, K = 8: Connect Four's
    (Ep = 1024, MLP 86 -> 512 -> 512 -> 7 with per-slot obs norm), Skull's
    (Ep = 1229, CTDE actor 135 -> 256 x3 -> 33, as configs/skull_ctde.toml
    trains), Liar's Dice's (Ep = 1024, CTDE actor 270 -> 256 x2 -> 49 and
    the MLP 270 -> 512 x3 -> 49 with obs norm), all relu; and Connect
    Four's at K = 3, relu and tanh. Every tiling is checked and timed at
    the four shapes: |kernel - plain| <= 1e-4 + 1e-4 |plain|. With
    ``parent``, the parent's K7 f32 tower on the same inputs at each shape,
    bit for bit this tree's (its code is the parent's), and timed in turns
    with it."""
    out = {"tol": "1e-4 + 1e-4 * |plain|", "max_abs_err": 0.0,
           "tilings": [f"{r} rows x {c} blocks" for r, c in OPPONENT_TILINGS]}

    def close(k, p, what):
        if not bool(torch.all((k - p).abs() <= 1e-4 + 1e-4 * p.abs())):
            raise AssertionError(f"opponent_actor_forward {what}: max abs err {max_err([(k, p)])}")
        out["max_abs_err"] = max(out["max_abs_err"], max_err([(k, p)]))
        return max_err([(k, p)])

    for K, act in ((3, "relu"), (3, "tanh"), (8, "tanh")):
        stack = random_opponents(dev, g, K, act)
        obs = connect_four_like(dev, g, EP)
        slot = torch.randint(0, K, (EP,), generator=g, device=dev, dtype=torch.int32)
        out[f"c4_K{K}_{act}"] = close(opponent_actor_forward(obs, slot, stack),
                                      opponent_actor_forward_plain(obs, slot, stack), f"K={K} {act}")
    shapes = (("c4_Ep1024_K8_mlp512x2", connect_four_like(dev, g, EP), 512, 2, 7, True),
              ("skull_Ep1229_K8_ctde256x3", skull_obs[:EP_SKULL], 256, 3, 33, False),
              ("liars_dice_Ep1024_K8_ctde256x2", ld_obs[:EP_LD], 256, 2, 49, False),
              ("liars_dice_Ep1024_K8_mlp512x3", ld_obs[:EP_LD], 512, 3, 49, True))
    for name, obs, H, depth, A, normed in shapes:
        obs = obs.contiguous()
        Ep, D = obs.shape
        stack = random_opponents(dev, g, 8, "relu", D=D, H=H, A=A, depth=depth)
        if not normed:
            stack.norm = None
        slot = torch.randint(0, 8, (Ep,), generator=g, device=dev, dtype=torch.int32)
        plain = opponent_actor_forward_plain(obs, slot, stack)
        entry = {"max_abs_err": close(opponent_actor_forward(obs, slot, stack), plain, name)}
        widths = [D] + [w.shape[2] for w in stack.weights]
        resident = ctypes.c_int(0)
        chosen = kernels.library().opp_mlp_default_tiling(
            (ctypes.c_int * len(widths))(*widths), len(widths) - 1, Ep, 8,
            ctypes.byref(resident))
        entry["default_tiling"] = "{}x{}".format(*OPPONENT_TILINGS[chosen])
        entry["resident_3_block_clusters"] = resident.value
        tilings = {}
        for t, (r, c) in enumerate(OPPONENT_TILINGS):
            run = (lambda t=t: opponent_actor_forward(obs, slot, stack, tiling=t))
            tilings[f"{r}x{c}"] = {"max_abs_err": close(run(), plain, f"{name} tiling {t}"),
                                   "device_ms": device_ms(run)[0], "ms": time_ms(run)}
        xs = [torch.rand(8, Ep, w.shape[1], generator=g, device=dev) for w in stack.weights]
        macs = sum(w.shape[1] * w.shape[2] for w in stack.weights)
        entry.update(
            **timed(lambda: opponent_actor_forward(obs, slot, stack),
                    lambda: opponent_actor_forward_plain(obs, slot, stack)),
            tilings=tilings,
            library_ms=time_ms(lambda: [torch.bmm(x, w) for x, w in zip(xs, stack.weights)]),
            bmm_turns=turns(lambda: opponent_actor_forward(obs, slot, stack),
                            lambda: [torch.bmm(x, w) for x, w in zip(xs, stack.weights)],
                            who="bmm", only="opponent_mlp_kernel"),
            **({} if parent is None else parent_opponent_turns(parent, obs, slot, stack, close)),
            # Every row through its own slot only; f32-accurate products on
            # the tensor cores are three TF32 products (bound_ffma_ms: at
            # the f32 rate outside them).
            **bound(nbytes(obs, slot, stack.weights, stack.biases, stack.norm) + Ep * A * 4,
                    flops_3xtf32=2.0 * Ep * macs),
        )
        out[name] = entry
    out["library_call"] = "torch.bmm over the K x Ep stacked rows, one per layer (K times the work)"
    out.update({k: out["c4_Ep1024_K8_mlp512x2"][k]
                for k in TIMES + ("library_ms", "bound_ms", "bound_by", "bound_ffma_ms")})
    return out


def parent_opponent_turns(parent: "ParentKernels", obs, slot, stack, close) -> dict:
    """The parent's K7 against this tree's on one case: its error against
    this tree's output, whether the two are equal bit for bit, and both
    timed in turns."""
    mine = opponent_actor_forward(obs, slot, stack)
    theirs = parent.opponent_forward(obs, slot, stack)
    if not torch.equal(theirs, mine):
        raise AssertionError(f"K7's f32 tower: not bit for bit the parent's, max abs err "
                             f"{max_err([(theirs, mine)])}")
    return {"parent_max_abs_err": close(theirs, mine, "the parent's"),
            "parent_equal_bit_for_bit": True,
            "parent_turns": turns(lambda: opponent_actor_forward(obs, slot, stack),
                                  lambda: parent.opponent_forward(obs, slot, stack),
                                  only="opponent_mlp_kernel", other_only="opponent_mlp_kernel")}


BF16_TOWER_TOL = ("every |kernel - plain| <= 2^-8 (|plain| + max |plain|), their mean "
                  "<= 2^-15 max |plain|")


def bf16_weights(stack: OpponentStack) -> OpponentStack:
    """The stack as a bf16 run's rotation stores it: the weights rounded to
    bf16 once, the biases and normalisers f32."""
    return dataclasses.replace(stack, weights=[w.to(torch.bfloat16).contiguous()
                                               for w in stack.weights])


def bf16_tower_errors(k: torch.Tensor, p: torch.Tensor) -> dict:
    """K7's bf16 tower against its plain version: the max and mean
    |kernel - plain|, and whether they are within ``BF16_TOWER_TOL``. The
    two differ by f32 sums in another order, and where one lands on the
    other side of an activation's bf16 rounding, by one bf16 ulp passed on
    through the later layers: rare, so the mean stays near the f32 sums'.
    A tower that leaves the activations unrounded differs in every entry
    and fails the mean."""
    d, scale = (k - p).abs(), float(p.abs().max())
    return {"max_abs": float(d.max()), "mean_abs": float(d.mean()), "max_abs_plain": scale,
            "within": bool(torch.all(d <= 2.0**-8 * (p.abs() + scale)))
            and float(d.mean()) <= 2.0**-15 * scale}


def tower_layout(widths, bf16: bool, feat: bool) -> dict:
    """The new K7 body's shared-memory layout of a tower (the bf16 tower's,
    or the feature front's with ``feat``): stages, bytes a stage, the input
    buffers' bytes, the dynamic shared memory."""
    out = (ctypes.c_int * 3)()
    smem = kernels.library().opp_tower_layout(
        (ctypes.c_int * len(widths))(*widths), len(widths) - 1, int(bf16), int(feat), out)
    return {"stages": out[0], "stage_bytes": out[1], "input_buffer_bytes": out[2],
            "dynamic_smem_bytes": smem}


def check_opponent_actor_bf16(dev, g, skull_obs: torch.Tensor, ld_obs: torch.Tensor,
                              parent: "ParentKernels | None" = None) -> dict:
    """K7's bf16 tower at the pool blocks of the bf16 training paths, K = 8,
    each stack's weights rounded to bf16 once and packed: Connect Four's
    (Ep = 1024, MLP 86 -> 512 x2 -> 7, relu, per-slot obs norm), the
    flagship's (Ep = 1229, CTDE actor 135 -> 256 x3 -> 33, relu) and Liar's
    Dice MLP's (Ep = 1024, 270 -> 512 x3 -> 49, relu, obs norm; 1.37 MB a
    slot, streamed through the ring). Each checked against the plain
    version on the same bf16 stack (``bf16_tower_errors``), and the control, K7's f32 tower on the same
    rounded weights, must fail the same check. Timed against the plain
    version; its device ms in turns with K7's f32 tower on the f32
    weights, with torch.bmm in bf16 over the K x Ep stacked rows (the
    library call, K times the work, bf16 out) and, with ``parent``, with
    the parent's bf16 tower (checked the same way); its bound: the
    operations at the bf16 tensor cores' rate."""
    out = {"tol": BF16_TOWER_TOL, "max_abs_err": 0.0, "tiling": "32 rows x 2 blocks"}

    def close(k, p, what):
        errs = bf16_tower_errors(k, p)
        if not errs["within"]:
            raise AssertionError(f"K7's bf16 tower {what}: {errs}, over {BF16_TOWER_TOL}")
        out["max_abs_err"] = max(out["max_abs_err"], errs["max_abs"])
        return errs

    shapes = (("c4_Ep1024_K8_mlp512x2", connect_four_like(dev, g, EP), 512, 2, 7, True),
              ("skull_Ep1229_K8_ctde256x3", skull_obs[:EP_SKULL], 256, 3, 33, False),
              ("liars_dice_Ep1024_K8_mlp512x3", ld_obs[:EP_LD], 512, 3, 49, True))
    for name, obs, H, depth, A, normed in shapes:
        obs = obs.contiguous()
        Ep, D = obs.shape
        f32 = random_opponents(dev, g, 8, "relu", D=D, H=H, A=A, depth=depth)
        if not normed:
            f32.norm = None
        stack = bf16_weights(f32)
        slot = torch.randint(0, 8, (Ep,), generator=g, device=dev, dtype=torch.int32)
        plain = opponent_actor_forward_plain(obs, slot, stack)
        before = opponent_actor_forward.launches
        errs = close(opponent_actor_forward(obs, slot, stack), plain, name)
        if opponent_actor_forward.launches != before + 1:
            raise AssertionError("a bf16 stack did not launch K7")
        # the control: K7's f32 tower on the same rounded weights
        control = bf16_tower_errors(
            opponent_actor_forward(obs, slot, dataclasses.replace(
                stack, weights=[w.float() for w in stack.weights])), plain)
        if control["within"]:
            raise AssertionError(f"K7's f32 tower on the rounded weights passes the bf16 "
                                 f"tower's check at {name}: {control}")
        entry = {"max_abs_err": errs["max_abs"], "mean_abs_err": errs["mean_abs"],
                 "max_abs_plain": errs["max_abs_plain"],
                 "control_f32_tower_rounded_weights": control}
        widths = [D] + [w.shape[2] for w in stack.weights]
        xs = [torch.rand(8, Ep, w.shape[1], generator=g, device=dev).to(torch.bfloat16)
              for w in stack.weights]
        bmm_bf16 = (lambda: [torch.bmm(x, w) for x, w in zip(xs, stack.weights)])
        macs = sum(w.shape[1] * w.shape[2] for w in stack.weights)
        new = (lambda: opponent_actor_forward(obs, slot, stack))
        entry.update(
            **timed(new, lambda: opponent_actor_forward_plain(obs, slot, stack)),
            layout=tower_layout(widths, True, False), library_ms=time_ms(bmm_bf16),
            f32_tower_turns=turns(new, lambda: opponent_actor_forward(obs, slot, f32),
                                  who="f32_tower", only="opponent_tower_bf16_kernel",
                                  other_only="opponent_mlp_kernel"),
            bmm_bf16_turns=turns(new, bmm_bf16, who="bmm_bf16",
                                 only="opponent_tower_bf16_kernel"),
            # every row through its own slot only, bf16 products at the
            # tensor cores' bf16 rate
            **bound(nbytes(obs, slot, stack.weights, stack.biases, stack.norm) + Ep * A * 4,
                    flops_bf16=2.0 * Ep * macs),
        )
        if parent is not None:
            theirs = parent.opponent_forward(obs, slot, stack)
            entry["parent_errors"] = close(theirs, plain, f"{name}, the parent's bf16 tower")
            entry["parent_turns"] = turns(new, lambda: parent.opponent_forward(obs, slot, stack),
                                          only="opponent_tower_bf16_kernel",
                                          other_only="opponent_tower_bf16_kernel")
        out[name] = entry
    out["library_call"] = ("torch.bmm in bf16 over the K x Ep stacked rows, one per layer "
                           "(K times the work, bf16 out)")
    out.update({k: out["c4_Ep1024_K8_mlp512x2"][k]
                for k in TIMES + ("library_ms", "bound_ms", "bound_by")})
    return out


def cnn_opponents(dev, g, K: int, normed: bool = True, bf16: bool = False) -> OpponentStack:
    """K Connect Four CNNs of configs/connect_four.toml's default shape
    (convs 2 -> 8 -> 8, 3 x 3, FC 32, head 7), each initialised as the
    trainer initialises one from a seed drawn from ``g``, their biases
    random, stacked as a rotation stacks checkpoints (``actor_params``,
    ``OpponentStack.of``; bf16: as a bf16 run stores them), with obs
    normalisers: slot 0 at count 0, slot 1 at count 1 (the identity), the
    others merged."""
    params = []
    for _ in range(K):
        seed = int(torch.randint(0, 2**31, (1,), generator=g, device=dev))
        net = ActorCriticNetwork(86, 7, network_type="cnn", obs_shape=C4_SHAPE,
                                 conv_channels=C4_CONV, activation="relu",
                                 generator=torch.Generator(device=dev).manual_seed(seed))
        with torch.no_grad():
            for m in [*net.conv_layers, *net.fc_layers, net.policy_head]:
                m.bias.copy_(torch.randn(m.bias.shape, generator=g, device=dev) * 0.1)
        params.append(actor_params(net, "bfloat16" if bf16 else None))
    norms = None
    if normed:
        counts = [0.0, 1.0] + [5000.0] * (K - 2)
        norms = [ObsNormState(mean=torch.rand(86, generator=g, device=dev),
                              m2=torch.rand(86, generator=g, device=dev) * 300.0,
                              count=torch.tensor(c, device=dev)) for c in counts[:K]]
    return OpponentStack.of(params, norms)


def grouped_convs(x: torch.Tensor, stack: OpponentStack) -> torch.Tensor:
    """The parent's conv route after its K20 (cuDNN, one conv a layer with
    ``groups = K`` over every slot's channels of every row, relu between
    the layers, bf16 roundings after it for a bf16 stack): the last
    conv's output [Ep, K C', H, W], timed as the parent's route."""
    K = stack.num_slots
    for i, (w, b) in enumerate(zip(stack.conv_weights, stack.conv_biases)):
        if i:
            x = torch.relu(x)
            if stack.bf16:
                x = x.to(torch.bfloat16).float()
        x = torch.nn.functional.conv2d(x, w, b, padding="same", groups=K)
    return x


def graph_replay_ms(fn, reps: int = 20) -> float:
    """Median CUDA-event span of one replay of ``fn`` captured into a CUDA
    graph (after a warm-up on a side stream): its time as the rollout
    graph runs it, without the host's launches."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return time_ms(graph.replay, reps)


# K20's bf16 check. Its products are exact (bf16 values) and its f32
# sums run in another order than cuDNN's, so an inter-layer value may land
# on the other side of a bf16 rounding (ROADMAP, fault F1) and move the next
# layer's outputs near it by about an ulp's product.
CNN_FRONT_F32_TOL = "every |kernel - plain| <= 1e-5 max |plain|"
CNN_FRONT_BF16_TOL = ("at most 1% of the elements more than 1e-5 max |plain| from plain, every "
                      "|kernel - plain| <= 2^-7 max |plain|")


def cnn_front_errors(k: torch.Tensor, p: torch.Tensor, bf16: bool) -> dict:
    """K20 against its plain version: the max |kernel - plain|, the share
    of the elements more than 1e-5 max |plain| apart, and whether they are
    within ``CNN_FRONT_F32_TOL`` (f32: the order of the 18- and 72-term
    f32 sums) or ``CNN_FRONT_BF16_TOL``."""
    d = (k - p).abs()
    scale = float(p.abs().max()) if p.numel() else 0.0
    worst = float(d.max()) if d.numel() else 0.0
    share = float((d > 1e-5 * scale).float().mean()) if d.numel() else 0.0
    within = (share <= 0.01 and worst <= 2.0**-7 * scale) if bf16 else worst <= 1e-5 * scale
    return {"max_abs": worst, "max_abs_plain": scale, "share_over_1e-5": share,
            "within": within}


def cnn_front_layout(stack: OpponentStack) -> dict:
    """K20's shared-memory layout of a stack on its board: rows a tile,
    floats a row of an activation buffer, the dynamic shared memory (one
    layer's weights at a time, then the two activation buffers)."""
    K, (H, W, C) = stack.num_slots, stack.obs_shape
    ch = [C] + [w.shape[0] // K for w in stack.conv_weights]
    out = (ctypes.c_int * 2)()
    smem = kernels.library().opp_cnn_front_layout((ctypes.c_int * len(ch))(*ch), len(ch) - 1,
                                                  stack.conv_weights[0].shape[2], H, W, out)
    return {"rows_a_tile": out[0], "floats_a_buffer_row": out[1], "dynamic_smem_bytes": smem}


def route_kernels(fn, names: dict, reps: int = 10) -> dict:
    """One call of ``fn`` with ``torch.nn.functional.conv2d`` made to raise
    (the route calls no cuDNN conv), then ``reps`` calls under the
    profiler between two runs of ``LEAD_SPINS`` short device sleeps the
    host waits out: their device kernels counted by ``names`` (label -> a
    substring of the kernel's name). A profile in a process that profiled
    before may lose its first few kernel records (four, two calls of the
    route, in a full run of this script); the sleeps take that loss. Any other
    kernel, or a kernel of ``names`` more than ``reps`` times, fails at
    once; a profile with one under ``reps`` (a launch lost) is taken
    again, and three such profiles fail. Returns each kernel's launches a
    call and the profiles taken."""
    def no_conv(*args, **kw):
        raise AssertionError("a conv on the CNN opponents' route")

    real = torch.nn.functional.conv2d
    torch.nn.functional.conv2d = no_conv
    try:
        fn()
    finally:
        torch.nn.functional.conv2d = real
    torch.cuda.synchronize()
    act = torch.profiler.ProfilerActivity
    profiles = []
    while len(profiles) < 3:
        with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
            for _ in range(LEAD_SPINS):
                torch.cuda._sleep(PROFILE_LEAD_CYCLES // LEAD_SPINS)
            torch.cuda.synchronize()
            for _ in range(reps):
                fn()
            for _ in range(LEAD_SPINS):
                torch.cuda._sleep(PROFILE_LEAD_CYCLES // LEAD_SPINS)
            torch.cuda.synchronize()
        seen = Counter()
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA and SLEEP_KERNEL not in e.name:
                seen[next((k for k, sub in names.items() if sub in e.name), e.name[:80])] += 1
        profiles.append(dict(seen))
        if any(k not in names for k in seen) or any(seen[k] > reps for k in names):
            raise AssertionError(f"the route launched other kernels or more than once a call "
                                 f"({reps} calls): {dict(seen)}")
        if all(seen[k] == reps for k in names):
            return {"launches_a_call": {k: seen[k] // reps for k in names}, "calls": reps,
                    "profiles": len(profiles), "conv2d_called": False}
    raise AssertionError(f"the route's kernels in {reps} calls, three profiles: {profiles}")


LEAD_SPINS = 32

CNN_ROUTE_KERNELS = {"opponent_cnn_front": "opponent_cnn_front_kernel",
                     "opponent_features_forward": "opponent_features"}


def check_opponent_cnn(dev, g, parent: "ParentKernels | None" = None) -> dict:
    """The CNN opponents' path at Connect Four's pool block (Ep = 1024, K =
    8, the default [8, 8] stack of 3 x 3 kernels), f32 and bf16 (the stack
    stored as a bf16 run stores it): K20 against its plain version at Ep =
    1024, 1023, 1 and 0, obs norm on and off (``cnn_front_errors``; bf16
    with its control, a front that skips the rounding between the layers,
    failing), timed against its plain version, its layout and bound; the
    route (``opponent_actor_forward``) profiled: K20 and K7's feature front
    once each, no other kernel; K7's feature front after K20 against
    ``opponent_cnn_forward_plain`` (the JAX formulation from the raw obs),
    f32 to 1e-4 + 1e-4 |plain|, the bf16 tower by ``bf16_tower_errors``
    with its control (the f32 tower on the same rounded weights and
    features) failing, its device ms in turns with torch.bmm over the K x
    Ep stacked rows (its library call, K times the work). With
    ``parent``: the parent's K20 and grouped cuDNN convs, each row's slot
    checked against K20 by the same measure and timed in turns with K20
    (eagerly and as graph replays); the parent's feature front on their
    output checked the same way and timed in turns with this tree's; the
    whole route in turns with the parent's."""
    obs = connect_four_like(dev, g, EP)
    slot = torch.randint(0, 8, (EP,), generator=g, device=dev, dtype=torch.int32)
    slot[:3] = torch.tensor([-1, 8, 40], device=dev, dtype=torch.int32)
    inside = (slot >= 0) & (slot < 8)
    rows_in = int(inside.sum())
    front, feats, towers = {}, {}, {}
    for bf16 in (False, True):
        key = "bf16" if bf16 else "f32"
        stack = cnn_opponents(dev, g, 8, bf16=bf16)
        cases = {}
        for normed in (True, False):
            s = stack if normed else dataclasses.replace(stack, norm=None)
            for Ep in (EP, EP - 1, 1, 0):
                o, sl = obs[:Ep].contiguous(), slot[:Ep].contiguous()
                before = opponent_cnn_front.launches
                k = opponent_cnn_front(o, sl, s)
                torch.cuda.synchronize()
                p = opponent_cnn_front_plain(o, sl, s)
                errs = cnn_front_errors(k, p, bf16)
                name = f"Ep{Ep}_{'normed' if normed else 'raw'}"
                if opponent_cnn_front.launches != before + 1 or k.shape != p.shape \
                        or not errs["within"] or not torch.equal(k[:3], torch.zeros_like(k[:3])):
                    raise AssertionError(f"opponent_cnn_front {key} {name}: {errs}, shape "
                                         f"{tuple(k.shape)}; {CNN_FRONT_BF16_TOL if bf16 else ''}")
                cases[name] = errs
        k = opponent_cnn_front(obs, slot, stack)
        p = opponent_cnn_front_plain(obs, slot, stack)
        entry = {"tol": CNN_FRONT_BF16_TOL if bf16 else CNN_FRONT_F32_TOL, "cases": cases,
                 "max_abs_err": max(c["max_abs"] for c in cases.values()),
                 "shape": list(k.shape), "layout": cnn_front_layout(stack)}
        if bf16:
            control = cnn_front_errors(
                opponent_cnn_front_plain(obs, slot, stack, round_between=False), p, True)
            if control["within"]:
                raise AssertionError(f"a front without the rounding between the layers passes "
                                     f"K20's bf16 check: {control}")
            entry["control_unrounded_between_layers"] = control
        H, W, _ = stack.obs_shape
        macs = sum(w.numel() // 8 * H * W for w in stack.conv_weights)
        new = (lambda: opponent_cnn_front(obs, slot, stack))
        entry.update(
            **timed(new, lambda: opponent_cnn_front_plain(obs, slot, stack)),
            graph_ms=graph_replay_ms(new), macs_a_row=macs, library_ms=None,
            library_note="no one PyTorch call runs each row's own slot's conv stack",
            # the rows' spatial obs, the slot ids, the normalisers and the
            # slots' conv weights read once, the output written once; each
            # row's own slot's stack, its f32-accurate products at the
            # 3xTF32 rate as the port's other f32 products (bound_ffma_ms:
            # at the FFMA rate the kernel uses)
            **bound(rows_in * 84 * 4 + nbytes(slot, stack.norm, stack.conv_weights,
                                              stack.conv_biases) + k.numel() * 4,
                    **{"flops_bf16" if bf16 else "flops_3xtf32": 2.0 * rows_in * macs}))
        if parent is not None:
            theirs = parent.conv_route(obs, stack)
            cc = theirs.shape[1] // 8
            picked = theirs.view(EP, 8, cc, H, W)[torch.arange(EP, device=dev),
                                                   slot.clamp(0, 7).long()]
            perr = cnn_front_errors(picked[inside], p[inside], bf16)
            if not perr["within"]:
                raise AssertionError(f"the parent's K20 and grouped convs {key}: {perr}")
            route = (lambda: parent.conv_route(obs, stack))
            graphs = {"graph_ms_turns": [], "parent_graph_ms": []}
            for who in ("parent", "new", "new", "parent"):
                graphs["parent_graph_ms" if who == "parent" else "graph_ms_turns"].append(
                    graph_replay_ms(route if who == "parent" else new))
            entry["parent_k20_and_grouped_convs"] = {
                "errors": perr, **turns(new, route, only="opponent_cnn_front_kernel"), **graphs}
        # the whole route: K20, then K7's feature front, against the JAX
        # formulation; its kernels on the device
        want = opponent_cnn_forward_plain(obs, slot, stack)
        counts = (opponent_cnn_front.launches, opponent_features_forward.launches,
                  opponent_actor_forward.launches)
        got = opponent_actor_forward(obs, slot, stack)
        if (opponent_cnn_front.launches, opponent_features_forward.launches,
                opponent_actor_forward.launches) != (counts[0] + 1, counts[1] + 1, counts[2]):
            raise AssertionError("a CNN stack did not launch K20 and K7's feature front once each")
        if not torch.equal(got[:3], torch.zeros_like(got[:3])):
            raise AssertionError("K7's feature front: out-of-range slots not zeros")
        route_launches = route_kernels(lambda: opponent_actor_forward(obs, slot, stack),
                                       CNN_ROUTE_KERNELS)
        feat = k
        if bf16:
            errs = bf16_tower_errors(got, want)
            control = bf16_tower_errors(opponent_features_forward(
                feat, obs, slot, dataclasses.replace(
                    stack, weights=[w.float() for w in stack.weights])), want)
            if not errs["within"] or control["within"]:
                raise AssertionError(f"K7's bf16 feature front {errs}, its control {control}; "
                                     f"{BF16_TOWER_TOL}")
            fe = {"tol": BF16_TOWER_TOL, "max_abs_err": errs["max_abs"],
                  "mean_abs_err": errs["mean_abs"], "max_abs_plain": errs["max_abs_plain"],
                  "control_f32_tower_rounded_weights": control}
        else:
            d = (got - want).abs()
            if not bool(torch.all(d <= 1e-4 + 1e-4 * want.abs())):
                raise AssertionError(f"K7's feature front f32: max abs err {float(d.max())}")
            fe = {"tol": "1e-4 + 1e-4 * |plain|", "max_abs_err": float(d.max())}
        cc, (H, W, C) = feat.shape[1], stack.obs_shape
        F = H * W * cc + obs.shape[1] - H * W * C
        wdt = torch.bfloat16 if bf16 else torch.float32
        xs = [torch.rand(8, EP, w.shape[1], generator=g, device=dev).to(wdt) for w in stack.weights]
        tower_macs = sum(w.shape[1] * w.shape[2] for w in stack.weights)
        name = "opponent_features_bf16_kernel" if bf16 else "opponent_features_kernel"
        feat_new = (lambda: opponent_features_forward(feat, obs, slot, stack))
        bmm = (lambda: [torch.bmm(x, w) for x, w in zip(xs, stack.weights)])
        whole_new = (lambda: opponent_actor_forward(obs, slot, stack))
        whole = {"events_ms": time_ms(whole_new), "device_ms": device_ms(whole_new)[0],
                 "plain_events_ms": time_ms(lambda: opponent_cnn_forward_plain(obs, slot, stack)),
                 "kernels_on_the_device": route_launches}
        if parent is not None:
            theirs_feat = parent.conv_route(obs, stack)
            theirs = parent.features_forward(theirs_feat, obs, slot, stack)
            if bf16:
                fe["parent_errors"] = bf16_tower_errors(theirs, want)
                ok = fe["parent_errors"]["within"]
            else:
                fe["parent_max_abs_err"] = float((theirs - want).abs().max())
                ok = bool(torch.all((theirs - want).abs() <= 1e-4 + 1e-4 * want.abs()))
            if not ok:
                raise AssertionError(f"the parent's feature front {key} off its tolerance")
            fe["parent_turns"] = turns(
                feat_new, lambda: parent.features_forward(theirs_feat, obs, slot, stack),
                only=name, other_only=name)
            whole["parent_turns"] = turns(whole_new,
                                          lambda: parent.cnn_forward(obs, slot, stack))
        # what this run's rows read: their features and extra obs columns,
        # the weights, biases and normalisers, the logits out
        moved = (rows_in * F * 4 + nbytes(slot, stack.weights, stack.biases, stack.norm)
                 + EP * 7 * 4)
        ops = {"flops_bf16" if bf16 else "flops_3xtf32": 2.0 * rows_in * tower_macs}
        fe.update(
            **timed(feat_new, lambda: opponent_features_forward_plain(feat, obs, slot, stack)),
            layout=tower_layout([F] + [w.shape[2] for w in stack.weights], bf16, True),
            feature_width=F, library_ms=time_ms(bmm),
            bmm_turns=turns(feat_new, bmm, who="bmm", only=name),
            library_call="torch.bmm over the K x Ep stacked rows, one per layer (K times the "
                         "work" + (", bf16 out)" if bf16 else ")"),
            **bound(moved, **ops))
        front[key] = entry
        (towers if bf16 else feats)[key] = {**fe, "whole_path": whole}
    keys = TIMES + ("library_ms", "bound_ms", "bound_by", "max_abs_err")
    return {
        "opponent_cnn_front": {**front, **{k: front["f32"][k] for k in keys}},
        "opponent_features_forward": {**feats, **{k: feats["f32"][k] for k in keys}},
        CNN_BF16_TOWER: {**towers, **{k: towers["bf16"][k] for k in keys}},
    }


def loss_batch(dev, g, M: int, A: int):
    """A minibatch as the update gives it: 0 to A-1 masked actions per row,
    a fifth of the rows invalid."""
    logits = torch.randn(M, A, generator=g, device=dev) * 2
    n_masked = torch.randint(0, A, (M, 1), generator=g, device=dev)
    mask = (torch.rand(M, A, generator=g, device=dev).argsort(1).argsort(1) >= n_masked).float()
    logp = torch.log_softmax(apply_action_mask(logits, mask), -1)
    actions = torch.multinomial(mask, 1, generator=g)[:, 0].to(torch.int32)
    old_lp = logp.gather(1, actions.long()[:, None])[:, 0] + torch.randn(
        M, generator=g, device=dev) * 0.2
    values = torch.randn(M, generator=g, device=dev)
    mb = {
        "actions": actions, "old_log_probs": old_lp,
        "advantages": torch.randn(M, generator=g, device=dev) * 2 + 0.3,
        "returns": torch.randn(M, generator=g, device=dev),
        "old_values": values + torch.randn(M, generator=g, device=dev) * 0.3,
        "valid": (torch.rand(M, generator=g, device=dev) < 0.8).float(),
        "action_masks": mask,
    }
    return logits, values, mb


def check_ppo_loss(dev, g) -> dict:
    """K8 at the minibatch shapes: Connect Four [65536, 7] (value clip off
    and on), Skull [65536, 33], Liar's Dice [65536, 49], CartPole
    [131072, 2]. Loss and metrics to 1e-5 relative, gradients to 1e-4
    relative + 1e-6 of their largest entry; a second call on the same
    inputs gives the same bits. Called as the update calls it (the
    entropy coefficient on the device, the update's bookkeeping in a
    ``LossBook``)."""
    out = {"tol": {"loss_metrics_rel": 1e-5, "grads_rel": 1e-4}, "max_abs_err": 0.0}

    def close(k, p, name) -> float:
        for a, b, rel, what in ((k[0], p[0], 1e-5, "loss"), (k[1], p[1], 1e-5, "metrics"),
                                (k[2], p[2], 1e-4, "dlogits"), (k[3], p[3], 1e-4, "dvalues")):
            atol = 1e-6 * max(float(b.abs().max()), 1.0 if what in ("loss", "metrics") else 0.0)
            if not bool(torch.all((a - b).abs() <= atol + rel * b.abs())):
                raise AssertionError(f"ppo_loss {name}: {what} max abs err {max_err([(a, b)])}")
        return max_err(list(zip(k, p)))

    for M, A, clip_value in ((65536, 7, False), (65536, 7, True), (65536, 33, False),
                             (65536, 49, False), (131072, 2, False)):
        logits, values, mb = loss_batch(dev, g, M, A)
        cfg = PPOUpdateConfig(clip_epsilon=0.1, clip_value=clip_value)
        ent = torch.full((), 0.05, device=dev)
        k = ppo_loss_forward(logits, values, mb, ent, cfg, LossBook.create(dev))
        again = ppo_loss_forward(logits, values, mb, ent, cfg, LossBook.create(dev))
        p = ppo_loss_plain(logits, values, mb, ent, cfg, LossBook.create(dev))
        torch.cuda.synchronize()
        name = f"M{M}_A{A}" + ("_clip" if clip_value else "")
        close(k, p, name)
        if not all(torch.equal(a, b) for a, b in zip(k, again)):
            raise AssertionError(f"ppo_loss {name}: two calls on the same inputs differ")
        out[name] = max_err(list(zip(k, p)))
        out["max_abs_err"] = max(out["max_abs_err"], out[name])
    out["bit_identical_across_calls"] = True
    cfg = PPOUpdateConfig(clip_epsilon=0.1, target_kl=0.02)
    book, ent = LossBook.create(dev), torch.full((), 0.05, device=dev)
    for A in (7, 33, 49):
        logits, values, mb = loss_batch(dev, g, 65536, A)
        # logits, mask, dL/dlogits [M, A]; values, the columns read,
        # dL/dvalues [M] (old_values is read only with the value clip on)
        read = [t for k, t in mb.items() if k != "old_values" or cfg.clip_value]

        def new():
            return ppo_loss_forward(logits, values, mb, ent, cfg, book, True)

        entry = {
            "max_abs_err": out[f"M65536_A{A}"],
            **timed(new, lambda: ppo_loss_plain(logits, values, mb, ent, cfg, book, True)),
            "library_ms": None,
            # per row: the masked log-softmax and its gradient (~12 per
            # action), ratio, clip, value and metric terms (~60)
            **bound(nbytes(logits, values, read) + nbytes(logits, values) + 15 * 4,
                    65536 * (12.0 * A + 60.0)),
        }
        out[f"M65536_A{A}"] = entry
    out.update({k: out["M65536_A7"][k] for k in TIMES + ("library_ms", "bound_ms", "bound_by")})
    return out


def check_clip_adam(dev, g) -> dict:
    """K9 over flat buffers of CartPole's MLP 64x2 (4,739 parameters),
    Connect Four's MLP 512x2 (311,304), Skull's CTDE 512x2 (784,418) and
    Liar's Dice's CTDE (873,778) and MLP 512x3 (689,714), three steps
    below and three above the max norm: to 1e-5 relative + 1e-7 of the
    largest entry, and below it (no clip: the norm's rounding does not
    enter) bit for bit; a second run of the same steps equal bit for bit.
    Timed at each count."""
    out = {"tol": "1e-5 * |plain| + 1e-7 * max|plain|; below the max norm, bit for bit",
           "max_abs_err": 0.0}
    partial = clip_adam_scratch(dev)
    out["grid_blocks"] = partial.numel()
    lr = torch.full((), 1e-3, device=dev)
    run = torch.ones((), dtype=torch.int32, device=dev)

    def ours(fn):
        # this tree's K9 and its plain version: the learning rate, the
        # Adam count and the run flag on the device
        def step(*bufs, cnt):
            fn(*bufs, lr=lr, count=cnt, run=run, max_grad_norm=0.5, eps=1e-5)
        return step

    for n in (4739, 311304, SKULL_CTDE_PARAMS, LD_CTDE_PARAMS, LD_MLP_PARAMS):
        for scale in (1e-3, 10.0):
            p0 = torch.randn(n, generator=g, device=dev)
            grads = [torch.randn(n, generator=g, device=dev) * scale / n ** 0.5 for _ in range(3)]
            runs = {}
            for who, step in (("kernel", ours(lambda *b, **kw: clip_adam(*b, **kw,
                                                                          partial=partial))),
                              ("again", ours(lambda *b, **kw: clip_adam(*b, **kw,
                                                                         partial=partial))),
                              ("plain", ours(clip_adam_plain))):
                bufs = [p0.clone(), None, torch.zeros(n, device=dev), torch.zeros(n, device=dev)]
                cnt = torch.zeros((), dtype=torch.int32, device=dev)
                for count in (1, 2, 3):
                    bufs[1] = grads[count - 1]
                    step(*bufs, cnt=cnt)
                runs[who] = bufs[:1] + bufs[2:]
            torch.cuda.synchronize()
            name = f"n{n}_{'above' if scale > 1 else 'below'}"
            for a, b in zip(runs["kernel"], runs["plain"]):
                if not bool(torch.all((a - b).abs() <= 1e-7 * float(b.abs().max())
                                      + 1e-5 * b.abs())):
                    raise AssertionError(f"clip_adam {name}: max abs err {max_err([(a, b)])}")
            if not all(torch.equal(a, b) for a, b in zip(runs["kernel"], runs["again"])):
                raise AssertionError(f"clip_adam {name}: two runs differ")
            if scale < 1 and not all(torch.equal(a, b)
                                     for a, b in zip(runs["kernel"], runs["plain"])):
                raise AssertionError(f"clip_adam {name}: below the max norm, not the plain "
                                     "version's bits")
            out[name] = max_err(zip(runs["kernel"], runs["plain"]))
            out["max_abs_err"] = max(out["max_abs_err"], out[name])
    kw = dict(lr=torch.full((), 1e-6, device=dev), count=torch.zeros((), dtype=torch.int32,
                                                                     device=dev),
              run=run, max_grad_norm=0.5, eps=1e-5)
    for n in (311304, 4739, SKULL_CTDE_PARAMS, LD_CTDE_PARAMS, LD_MLP_PARAMS):
        prm, grads = torch.randn(n, generator=g, device=dev), torch.randn(n, generator=g, device=dev)
        mu, nu = torch.zeros(n, device=dev), torch.zeros(n, device=dev)
        entry = {
            **timed(lambda: clip_adam(prm, grads, mu, nu, **kw, partial=partial),
                    lambda: clip_adam_plain(prm, grads, mu, nu, **kw)),
            "library_ms": None,
            # read params, grads, mu, nu; write params, mu, nu (and the
            # step's scalars)
            **bound(7 * 4 * n, 20.0 * n),
        }
        if n == 311304:
            lib = torch.nn.Parameter(prm.clone())
            lib.grad = grads.clone()
            adam = torch.optim.Adam([lib], lr=1e-6, eps=1e-5, fused=True)
            entry.update(library_ms=time_ms(adam.step), library_call="torch.optim.Adam("
                         "fused=True).step() (Adam only: no global-norm clip)",
                         library_turns=turns(
                             lambda: clip_adam(prm, grads, mu, nu, **kw, partial=partial),
                             adam.step, who="library", only="clip_adam"))
        if n == 311304:
            out.update(entry)
        else:
            out[f"n{n}"] = entry
    return out


def check_graph_capture(dev, g, obs: torch.Tensor) -> dict:
    """One K9 step (Liar's Dice CTDE's 873,778 parameters, above the max
    norm), one K6 apply (``obs``), one K1 step with the roll (E = 4096)
    and one K12 finalize ([524288] with a valid mask, the state's scratch)
    captured into CUDA graphs on the current stream after a warm-up on a
    side stream: each replay, from the same inputs, equal bit for bit to
    the eager call. A replay runs no wrapper, so the launch counters do
    not move."""
    n = LD_CTDE_PARAMS
    start = [torch.randn(n, generator=g, device=dev),
             torch.randn(n, generator=g, device=dev) * 10.0 / n ** 0.5,
             torch.randn(n, generator=g, device=dev) * 1e-3,
             torch.rand(n, generator=g, device=dev) * 1e-6,
             torch.full((), 3, dtype=torch.int32, device=dev)]
    kw = dict(lr=torch.full((), 1e-3, device=dev), max_grad_norm=0.5, eps=1e-5,
              run=torch.ones((), dtype=torch.int32, device=dev), partial=clip_adam_scratch(dev))

    def adam(bufs):
        clip_adam(*bufs[:4], count=bufs[4], **kw)
    D = obs.shape[1]
    st = obs_norm_update_plain(ObsNormState.create(D, dev), connect_four_like(dev, g, E * T_LD, D))
    env = CartPole()
    cp = cartpole_inputs(dev, g, E)
    cp_roll = (cp[4], 0.99)
    N = E * T
    z = torch.zeros((), device=dev)
    rn = ReturnNormState(torch.zeros(E, 1, device=dev), z + 0.37, z + 4.1e6, z + 2.6e6,
                         return_norm_scratch(dev))
    fin_in = (torch.randn(N, generator=g, device=dev), torch.randn(N, generator=g, device=dev),
              10.0, (torch.rand(N, generator=g, device=dev) < 0.75).float())
    eager = [t.clone() for t in start]
    adam(eager)
    eager_obs = obs_norm_apply(st, obs)
    eager_step = env.step_autoreset(*cp[:4], None, cp_roll)
    eager_fin = return_norm_finalize_f64(rn, *fin_in)
    bufs = [t.clone() for t in start]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        adam([t.clone() for t in start])
        obs_norm_apply(st, obs)
        env.step_autoreset(*cp[:4], None, cp_roll)
        return_norm_finalize_f64(rn, *fin_in)
    torch.cuda.current_stream().wait_stream(side)
    names = ("clip_adam", "obs_norm_apply", "cartpole_step_autoreset", "return_norm_finalize")
    graphs = {name: torch.cuda.CUDAGraph() for name in names}
    with torch.cuda.graph(graphs["clip_adam"]):
        adam(bufs)
    with torch.cuda.graph(graphs["obs_norm_apply"]):
        captured = obs_norm_apply(st, obs)
    with torch.cuda.graph(graphs["cartpole_step_autoreset"]):
        captured_step = env.step_autoreset(*cp[:4], None, cp_roll)
    with torch.cuda.graph(graphs["return_norm_finalize"]):
        captured_fin = return_norm_finalize_f64(rn, *fin_in)
    step_pairs = [(captured_step.state.phys, eager_step.state.phys),
                  (captured_step.state.step_idx, eager_step.state.step_idx),
                  (captured_step.acc.reward_sum, eager_step.acc.reward_sum),
                  (captured_step.acc.length, eager_step.acc.length),
                  *((getattr(captured_step.log, f), getattr(eager_step.log, f))
                    for f in ("completed", "total_rewards", "length", "outcome", "active_players")),
                  *((getattr(captured_step, f), getattr(eager_step, f))
                    for f in ("rewards", "done", "obs", "mask", "returns", "samples"))]
    before = tuple(WRAPPERS[name].launches for name in names)
    for replay in range(2):
        for t, s0 in zip(bufs, start):
            t.copy_(s0)
        for t in (captured, *captured_fin, *(c for c, _ in step_pairs)):
            t.zero_()
        for graph in graphs.values():
            graph.replay()
        torch.cuda.synchronize()
        if not (all(torch.equal(a, b) for a, b in zip(bufs, eager))
                and torch.equal(captured, eager_obs)
                and all(torch.equal(a, b) for a, b in step_pairs)
                and all(torch.equal(a, b) for a, b in zip(captured_fin, eager_fin))):
            raise AssertionError(f"graph replay {replay} differs from the eager calls")
    if tuple(WRAPPERS[name].launches for name in names) != before:
        raise AssertionError("a graph replay moved a launch counter")
    return {"replays": 2, "equal_bit_for_bit": True, "clip_adam_n": n,
            "obs_norm_apply_shape": list(obs.shape), "cartpole_step_autoreset_envs": E,
            "return_norm_finalize_n": N,
            **{f"{name}_replay_ms": time_ms(graph.replay) for name, graph in graphs.items()}}


# Phase 2c: (name, config, T, overrides, pool) at 4096 envs.
ROLLOUT_CASES = (
    ("cartpole", "cartpole.toml", T, {}, False),
    ("connect_four_selfplay", "connect_four.toml", T_C4,
     {"opponent_pool_fraction": 0.0, "normalize_obs": True}, False),
    ("skull_ctde_selfplay", "skull_ctde.toml", T_C4,
     {"opponent_pool_fraction": 0.0, "hidden_size": 512, "num_hidden": 2, "activation": "tanh",
      "critic_hidden_size": 512, "critic_num_hidden": 2}, False),
    ("liars_dice_ctde_pool", "liars_dice_ctde.toml", T_LD, {}, True),
    # the bf16 compute dtype: the learner's bf16 dense and K7's bf16 tower
    ("connect_four_pool_bf16", "connect_four.toml", T_C4,
     {"normalize_obs": True, "compute_dtype": "bfloat16"}, True),
    # the CNN against the pool: K20, K7's feature front
    ("connect_four_pool_cnn", "connect_four.toml", T_C4,
     {"normalize_obs": True, "network_type": "cnn"}, True),
)
# The pool case's rounds: (shaping, the rotation's active count); each
# round a new stack, and the trainer's host remap of the seats where the
# count shrinks.
POOL_ROUNDS = ((0.05, 1), (0.05, 3), (0.02, 3), (0.02, 1))
SELFPLAY_SHAPING = (0.05, 0.05, 0.02)


def rollout_setup(dev, toml: str, steps: int, overrides: dict) -> tuple:
    """A trainer's rollout inputs at 4096 envs on the card: the config's
    network (its parameters in the flat buffer, as ``AdamState.create``
    leaves them), the carry, obs-norm stats where the config has them on,
    a seeded generator."""
    cfg = Config.load(ROOT / "configs" / toml)
    for k, v in {"num_envs": E, "num_steps": steps, **overrides}.items():
        setattr(cfg, k, v)
    env = make_env(cfg.env)
    if env.spec.variable_player_count:
        env = env.with_num_players(cfg.player_count.get_fixed_count())
    net = build_network_for_env(env, cfg, torch.Generator().manual_seed(0)).to(dev)
    AdamState.create(net)
    rng = TorchRandomSource(torch.Generator(device=dev).manual_seed(1))
    carry = init_rollout_carry(env, E, rng, dev)
    norm = None
    if cfg.normalize_obs:
        noise = torch.rand(carry.obs.shape, generator=rng.generator, device=dev)
        norm = obs_norm_update_plain(ObsNormState.create(env.spec.obs_dim, dev), carry.obs + noise)
    return cfg, env, net, rng, carry, norm


def rollout_bound(checks: dict, name: str, net, steps: int) -> dict:
    """The least time of one rollout: the per-step kernels' bounds (phase 2,
    at the same shapes) times the steps, plus the learner forward's
    operations at the f32 rate (the bf16 tensor cores' with the bf16
    compute dtype), plus the finalize where it runs."""
    samples = checks["masked_gumbel_sample"]
    per_step = {
        "cartpole": [checks["cartpole_step_autoreset"]["bound_ms"], samples["A2"]["bound_ms"],
                     bound(E * 5 * 4 * 2 + 11 * 4, 6.0 * E * 5)["bound_ms"]],
        "connect_four_selfplay": [checks["connect_four_step_autoreset"]["bound_ms"],
                                  samples["A7"]["bound_ms"], checks["obs_norm_apply"]["bound_ms"]],
        "skull_ctde_selfplay": [checks["skull_step_autoreset"]["bound_ms"],
                                samples["A33_skull"]["bound_ms"]],
        "liars_dice_ctde_pool": [
            checks["liars_dice_step_autoreset"]["bound_ms"], samples["A49_liars_dice"]["bound_ms"],
            samples["A49_liars_dice_opponents_Ep1024"]["bound_ms"],
            checks["opponent_actor_forward"]["liars_dice_Ep1024_K8_ctde256x2"]["bound_ms"]],
        # the opponents' sample [1024, 7] bounded by the learner's [4096, 7]
        "connect_four_pool_bf16": [
            checks["connect_four_step_autoreset"]["bound_ms"], 2 * samples["A7"]["bound_ms"],
            checks["obs_norm_apply"]["bound_ms"],
            checks[BF16_TOWER]["c4_Ep1024_K8_mlp512x2"]["bound_ms"]],
        # K20 (each row's own slot's convs) and K7's feature front
        "connect_four_pool_cnn": [
            checks["connect_four_step_autoreset"]["bound_ms"], 2 * samples["A7"]["bound_ms"],
            checks["obs_norm_apply"]["bound_ms"], checks["opponent_cnn_front"]["bound_ms"],
            checks["opponent_features_forward"]["bound_ms"]],
    }[name]
    H, W, _ = net.obs_shape or (1, 1, 1)
    flops = sum(2.0 * E * m.in_features * m.out_features
                for m in net.modules() if isinstance(m, torch.nn.Linear)) * steps
    flops += sum(2.0 * E * H * W * m.weight.numel()
                 for m in net.modules() if isinstance(m, torch.nn.Conv2d)) * steps
    rate = BF16_FLOP_PER_S if net.compute_dtype == "bfloat16" else F32_FLOP_PER_S
    once = checks["return_norm_finalize"]["bound_ms"] if name == "cartpole" else 0.0
    kernels_ms = sum(per_step) * steps + once
    return {"bound_ms": kernels_ms + flops / rate * 1e3, "bound_by": "operations"
            if flops / rate * 1e3 > kernels_ms else "bytes",
            "bound_kernels_ms": kernels_ms, "forward_flops": flops}


def first_difference(got: list, want: list) -> str | None:
    """Where two lists of tensors first differ (index, shape), or None."""
    if len(got) != len(want):
        return f"{len(got)} tensors against {len(want)}"
    for i, (a, b) in enumerate(zip(got, want)):
        if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(a, b):
            return f"tensor {i} of shape {tuple(b.shape)}"
    return None


def check_rollout_graph(dev, g, checks: dict, name: str, toml: str, steps: int, overrides: dict,
                        pool: bool) -> dict:
    """The trainer's graphed rollout against the eager loop
    (``collect_rollouts``, fresh buffers) from the same generator state,
    rollout after rollout: every carry, batch and log tensor equal bit for
    bit, and the generator left at the same offset; one capture. On the
    pool case the rounds change the rotation (a new stack each round), the
    active count (1, 3, 3, 1: the one graph reads it from the device) and
    the shaping, and apply the trainer's host remap when the count
    shrinks. Then the eager loop (into buffers of its own) and the graph
    timed in turns (eager, graph, graph, eager): events ms per rollout
    (the host's enqueue included) and the profiler's device ms; and the
    post-loop (the acting rewards' gather, K12's finalize where the
    normaliser is on, the last values) run eagerly after a replay, against
    its device time inside the graph."""
    cfg, env, net, rng, carry, norm = rollout_setup(dev, toml, steps, overrides)
    gen, P = rng.generator, env.spec.num_players
    normalize = cfg.effective_normalize_returns(P)
    L = E - int(round(E * cfg.opponent_pool_fraction)) if pool else None
    runner = rollout_runner(env, cfg, num_learner_envs=L)
    shaped = "shaping_coef" in env.context_fields
    if pool:
        obs_dim, act = env.spec.obs_dim, cfg.activation
        stacks = [cnn_opponents(dev, g, 8) if cfg.network_type == "cnn" else
                  random_opponents(dev, g, 8, act, D=obs_dim, H=cfg.hidden_size,
                                   A=env.spec.num_actions, depth=cfg.num_hidden)
                  for _ in POOL_ROUNDS]
        if net.is_ctde:
            for stack in stacks:
                stack.norm = None  # CTDE checkpoints carry no obs normaliser
        if cfg.compute_dtype == "bfloat16":  # as the rotation stores them
            stacks = [bf16_weights(stack) for stack in stacks]
        seat0 = PoolSeating.create(E, L, P, 1, rng)
        rounds = [(s, a, stack) for (s, a), stack in zip(POOL_ROUNDS, stacks)]
    else:
        rounds = [(s, 0, None) for s in SELFPLAY_SHAPING]
    RolloutGraph.reset_counts()
    eager_in, graph_in = (carry, seat0 if pool else None), (carry, seat0 if pool else None)
    prev_active = None
    for i, (shaping, active, stack) in enumerate(rounds):
        if pool and prev_active is not None and active < prev_active:
            eager_in = (eager_in[0], PoolSeating(eager_in[1].learner_seat,
                                                 eager_in[1].seat_opp % active))
            graph_in = (graph_in[0], PoolSeating(graph_in[1].learner_seat,
                                                 graph_in[1].seat_opp % active))
        prev_active = active
        kw = dict(num_steps=steps, gamma=cfg.gamma, normalize_returns=normalize,
                  return_clip=cfg.return_clip,
                  env_context={"shaping_coef": shaping} if shaped else None)
        start = gen.get_state()
        if pool:
            eager = collect_rollouts_with_opponents(net, env, stack, eager_in[0], eager_in[1],
                                                    norm, rng, num_learner_envs=L,
                                                    num_active=active, **kw)
            eager_in = (eager[0], eager[1])
        else:
            eager = collect_rollouts(net, env, eager_in[0], norm, rng, **kw)
            eager_in = (eager[0], None)
        want = [t.clone() for t in state_leaves(list(eager))]
        after = gen.get_state()
        gen.set_state(start)
        got = runner.run(net, graph_in[0], norm, rng, shaping, seating=graph_in[1],
                         opponents=stack, num_active=active)
        torch.cuda.synchronize()
        graph_in = (got[0], got[1] if pool else None)
        diff = first_difference(state_leaves(list(got)), want)
        if diff is not None or not torch.equal(gen.get_state(), after):
            raise AssertionError(f"rollout graph {name} round {i}: differs from the eager loop "
                                 f"at {diff or 'the generator offset'}")
    if RolloutGraph.replays != len(rounds) or RolloutGraph.captures != 1:
        raise AssertionError(f"{name}: {RolloutGraph.captures} captures and "
                             f"{RolloutGraph.replays} replays for {len(rounds)} rollouts")
    out = {"envs": E, "steps": steps, "rounds": len(rounds), "equal_bit_for_bit": True,
           "graphs_captured": RolloutGraph.captures,
           "launches_per_replay": {w.__name__: n // RolloutGraph.replays
                                   for w, n in RolloutGraph.launches.items()}}
    if pool:
        out["rounds_shaping_active"] = [[s, a] for s, a in POOL_ROUNDS]

    # The eager loop (from the runner's carry, which it does not write)
    # and the graph in turns.
    shaping, active, stack = rounds[-1]
    kw = dict(num_steps=steps, gamma=cfg.gamma, normalize_returns=normalize,
              return_clip=cfg.return_clip,
              env_context={"shaping_coef": shaping} if shaped else None,
              buffers=RolloutBuffers.create(env, steps, E, dev, privileged=net.is_ctde,
                                            samples=normalize, pool=pool))
    versions = {
        "eager": (lambda: collect_rollouts_with_opponents(
            net, env, stack, runner.carry, runner.seating, norm, rng, num_learner_envs=L,
            num_active=active, **kw)) if pool else
        (lambda: collect_rollouts(net, env, runner.carry, norm, rng, **kw)),
        "graph": lambda: runner.run(net, runner.carry, norm, rng, shaping,
                                    seating=runner.seating, opponents=stack, num_active=active),
    }

    def post_loop():
        finish_rollout(runner.carry, runner.buffers, normalize_returns=normalize,
                       return_clip=cfg.return_clip, valid=runner.buffers.valid if pool else None)

    ms = {v: [] for v in versions}
    dev_ms = {v: [] for v in versions}
    for i, v in enumerate(("eager", "graph", "graph", "eager")):
        ms[v].append(time_ms(versions[v], reps=3, warmup=1))
        if i < 2:  # the device times of the first turn; the events of both
            dev_ms[v].append(device_ms(versions[v], reps=3)[0])
    rollout_ms, rollout_dev = min(ms["graph"]), min(filter(None, dev_ms["graph"]), default=None)
    out["post_loop"] = {"eager_ms": time_ms(post_loop), "device_ms": device_ms(post_loop)[0]}
    out.update(ms_turns=ms, device_ms_turns=dev_ms, ms=rollout_ms, device_ms=rollout_dev,
               idle_share=None if rollout_dev is None else 1.0 - rollout_dev / rollout_ms,
               **rollout_bound(checks, name, net, steps))
    return out


def check_rollout_graphs(dev, g, checks: dict) -> dict:
    return {name: check_rollout_graph(dev, g, checks, name, toml, steps, over, pool)
            for name, toml, steps, over, pool in ROLLOUT_CASES}


# Phase 2d: (name, config, T, overrides, pool) at 4096 envs. On the
# vs-pool case a last round keeps two valid rows of the batch, so most of
# its minibatches hold none.
UPDATE_CASES = (
    ("cartpole", "cartpole.toml", T, {}, False),
    ("connect_four_selfplay", "connect_four.toml", T_C4,
     {"opponent_pool_fraction": 0.0, "normalize_obs": True, "num_epochs": 6,
      "target_kl": 0.02}, False),
    ("liars_dice_ctde_pool", "liars_dice_ctde.toml", T_LD, {}, True),
    # the bf16 compute dtype's forward and backward at the bench_skull_ctde shape
    ("skull_ctde_selfplay_bf16", "skull_ctde.toml", T_C4, {**SKULL_BENCH, "target_kl": None,
                                                            "compute_dtype": "bfloat16"}, False),
)
UPDATE_ROUNDS = 3  # and the empty-minibatch round on the vs-pool case


def update_leaves(opt: AdamState, runner, updater=None) -> list:
    """What an update writes and reads again: parameters, moments, the
    Adam count, the obs-norm stats, PopArt's stats and the entropy
    controller's state (where they are on)."""
    return [opt.flat_params, opt.flat_mu, opt.flat_nu, opt.count_tensor,
            *state_leaves(runner.obs_norm), *state_leaves(runner.popart),
            *state_leaves(None if updater is None else updater.entropy)]


def output_leaves(out: dict) -> list:
    return state_leaves([list(out["metrics"].values()), list(out["stats"].values())])


def update_bound(cfg, net, runner, opt: AdamState, minibatches: float) -> dict:
    """The least time of one update: the batch read once and the optimizer
    state read and written once (bytes), against the GEMMs of the
    minibatches that ran (forward, and backward at twice the forward) and
    of the bootstrap's forward at the f32 rate (operations); with the bf16
    compute dtype the forwards at the bf16 tensor cores' rate, the
    backward's f32 products at the f32 rate."""
    N = cfg.num_steps * E
    mb_size = -(-N // cfg.num_minibatches)
    macs = sum(m.in_features * m.out_features for m in net.modules()
               if isinstance(m, torch.nn.Linear))
    forward = 2.0 * macs * mb_size * minibatches + 2.0 * macs * E
    backward = 4.0 * macs * mb_size * minibatches
    n = opt.flat_params.numel()
    moved = nbytes(*state_leaves(runner.buffers.batch())) + 7 * 4 * n
    if net.compute_dtype == "bfloat16":
        return bound(moved, backward, flops_bf16=forward)
    return bound(moved, forward + backward)


def check_update_graph(dev, g, name: str, toml: str, steps: int, overrides: dict,
                       pool: bool) -> dict:
    """The trainer's graphed update against the eager loop
    (``UpdateRunner.eager``, every minibatch run), update after update, each
    after a graphed rollout: from one saved state (parameters, moments,
    Adam count, obs-norm stats, generator) both give the same bits in all
    of these, in every metric and episode summary, and leave the generator
    at the same offset; one capture. Then the minibatches run and skipped
    and the minibatch graphs skipped; from one saved state, the eager loop
    and the graphs timed in turns (events and device ms), and the host's
    waits for the stop flag in the timed replays (per wait and per
    update); each update kernel's device launches in one profiled replay
    against those captured; and one more train step (rollout and update)
    under ``torch.cuda.set_sync_debug_mode("error")``, which sees any
    stream or device synchronize (not the host's event polls)."""
    cfg, env, net, rng, carry, norm = rollout_setup(dev, toml, steps, overrides)
    opt = AdamState.create(net)
    P = env.spec.num_players
    L = E - int(round(E * cfg.opponent_pool_fraction)) if pool else None
    runner = rollout_runner(env, cfg, num_learner_envs=L)
    updater = UpdateRunner(env, cfg, num_learner_envs=L)
    lr, ent = cfg.learning_rate.get(0), cfg.entropy_coef.get(0)
    shaping = cfg.reward_shaping_coef.get(0)
    kw = {}
    popart = PopArtState.create(dev) if cfg.normalize_values else None
    if cfg.adaptive_entropy is not None:  # the update takes the target
        # The controller the update runs on from the start, so that the
        # first saved state holds it too.
        updater.entropy = AdaptiveEntropyState.create(ent, dev)
        ent = cfg.adaptive_entropy.get(0) * math.log(env.spec.num_actions)
    if pool:
        stack = random_opponents(dev, g, 8, cfg.activation, D=env.spec.obs_dim,
                                 H=cfg.hidden_size, A=env.spec.num_actions, depth=cfg.num_hidden)
        if net.is_ctde:
            stack.norm = None  # CTDE checkpoints carry no obs normaliser
        if cfg.compute_dtype == "bfloat16":
            stack = bf16_weights(stack)
        kw = dict(seating=PoolSeating.create(E, L, P, 1, rng), opponents=stack, num_active=8)

    def rollout(empty: bool = False):
        runner.run(net, runner.carry or carry, runner.obs_norm or norm, rng, shaping, **kw,
                   popart=runner.popart or popart)
        if pool:
            kw["seating"] = runner.seating
        if empty:  # two valid rows left: most minibatches hold none
            valid = runner.buffers.valid.view(-1)
            valid.zero_()
            valid[3:4].fill_(1.0)
            valid[valid.numel() // 2 + 7:][:1].fill_(1.0)

    UpdateGraph.reset_counts()
    launched = cfg.num_epochs * cfg.num_minibatches
    rounds = [False] * UPDATE_ROUNDS + ([True] if pool else [])
    ran = []
    for i, empty in enumerate(rounds):
        rollout(empty)
        saved = [t.clone() for t in update_leaves(opt, runner, updater)]
        start = rng.generator.get_state()
        eager = updater.eager(net, opt, runner, rng, lr, ent, updater.entropy)
        want = [t.clone() for t in update_leaves(opt, runner, updater) + output_leaves(eager)]
        after = rng.generator.get_state()
        for t, s0 in zip(update_leaves(opt, runner, updater), saved):
            t.copy_(s0)
        rng.generator.set_state(start)
        got = updater.run(net, opt, runner, rng, lr, ent, updater.entropy)
        torch.cuda.synchronize()
        diff = first_difference(update_leaves(opt, runner, updater) + output_leaves(got), want)
        if diff is not None or not torch.equal(rng.generator.get_state(), after):
            raise AssertionError(f"update graph {name} round {i}: differs from the eager loop "
                                 f"at {diff or 'the generator offset'}")
        ran.append(int(float(got["metrics"]["num_minibatch_updates"])))
    if UpdateGraph.replays != len(rounds) or UpdateGraph.captures != 1:
        raise AssertionError(f"{name}: {UpdateGraph.captures} captures and "
                             f"{UpdateGraph.replays} replays for {len(rounds)} updates")
    if pool and min(ran[:UPDATE_ROUNDS]) == launched:
        raise AssertionError(f"{name}: the KL stop fired in no update: {ran} of {launched}")
    if pool and ran[-1] > 2 * cfg.num_epochs:
        raise AssertionError(f"{name}: {ran[-1]} minibatches ran with two valid rows")
    out = {"envs": E, "steps": steps, "epochs": cfg.num_epochs,
           "minibatches_per_epoch": cfg.num_minibatches, "target_kl": cfg.target_kl,
           "updates": len(rounds), "last_update_two_valid_rows": pool,
           "equal_bit_for_bit": True, "graphs_captured":
           UpdateGraph.captures, "graphs_per_update": len(updater.graph.graphs),
           "minibatches_launched_eagerly": launched, "minibatches_run": ran,
           "minibatches_skipped": [launched - r for r in ran],
           "minibatch_graphs_skipped": UpdateGraph.skipped,
           "launches": {w.__name__: c for w, c in UpdateGraph.launches.items()}}

    # From one saved state, every call the same work: the eager loop and
    # the graphs in turns.
    rollout()
    saved = [t.clone() for t in update_leaves(opt, runner, updater)]
    start = rng.generator.get_state()
    versions = {"eager": lambda: updater.eager(net, opt, runner, rng, lr, ent, updater.entropy),
                "graph": lambda: updater.run(net, opt, runner, rng, lr, ent, updater.entropy)}
    minibatches = {}

    def from_saved(v):
        def call():
            for t, s0 in zip(update_leaves(opt, runner, updater), saved):
                t.copy_(s0)
            rng.generator.set_state(start)
            return versions[v]()
        return call

    for v in versions:
        minibatches[v] = int(float(from_saved(v)()["metrics"]["num_minibatch_updates"]))
    ms = {v: [] for v in versions}
    dev_ms = {v: [] for v in versions}
    order = ("eager", "graph")
    polls = (updater.polls, updater.poll_seconds, UpdateGraph.replays)
    for i, v in enumerate(order + order[::-1]):
        ms[v].append(time_ms(from_saved(v), reps=2, warmup=1))
        if i < len(order):  # the device times of the first turn; the events of both
            dev_ms[v].append(device_ms(from_saved(v), reps=2)[0])
    n_polls, wait_s = updater.polls - polls[0], updater.poll_seconds - polls[1]
    out.update(stop_flag_waits_per_update=n_polls / max(UpdateGraph.replays - polls[2], 1),
               stop_flag_wait_ms_per_wait=wait_s * 1e3 / n_polls if n_polls else None)
    update_ms, update_dev = min(ms["graph"]), min(filter(None, dev_ms["graph"]), default=None)
    out.update(timed_minibatches_run=minibatches, ms_turns=ms, device_ms_turns=dev_ms,
               ms=update_ms, device_ms=update_dev,
               idle_share=None if update_dev is None else 1.0 - update_dev / update_ms,
               **update_bound(cfg, net, runner, opt, minibatches["graph"]),
               library_ms=None,
               replay_kernel_counts=replay_kernel_counts(updater.graph, UPDATE_KERNELS))
    if popart is not None:  # K16: once in the update (the bootstrap), never in the rollout
        rollout_counts = replay_kernel_counts(runner.graph)
        k16 = (rollout_counts["counts"].get("popart_denormalize", [0, 0]),
               out["replay_kernel_counts"]["counts"].get("popart_denormalize"))
        if k16 != ([0, 0], [1, 1]):
            raise AssertionError(f"{name}: K16 in one replay of the rollout and of the update "
                                 f"graph {k16}, want [0, 0] and [1, 1]")
        out["rollout_replay_kernel_counts"] = rollout_counts
    if updater.entropy is not None:
        out["adaptive_ent_coef"] = float(updater.entropy.coef)
        out["value_norm"] = [float(runner.popart.mean), float(runner.popart.std)]

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        rollout()
        updater.run(net, opt, runner, rng, lr, ent, updater.entropy)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    out["train_step_without_stream_or_device_sync"] = True
    return out


def update_graph_cases(tmp: Path, card_line: str) -> dict:
    """Phase 2d, run in a process of its own (``phase_in_process``): in a
    process that has profiled phase 2's kernels the profiler drops K6's
    launches from a replay's profile."""
    dev = resolve_device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    return {"card": card_line, **{name: check_update_graph(dev, g, name, toml, steps, over, pool)
                                  for name, toml, steps, over, pool in UPDATE_CASES}}


# (name, config, T, overrides): the train steps timed in turns with the
# parent's (``update_turns``).
TURN_CASES = (
    ("cartpole", "cartpole.toml", T, {}),
    ("connect_four_pool", "connect_four.toml", T_C4, {"normalize_obs": True}),
    ("liars_dice_ctde_pool", "liars_dice_ctde.toml", T_LD, {}),
)
TURN_UPDATES = 5

UPDATE_TURN = """
import json, sys, tempfile, time
from pathlib import Path
sys.path.insert(0, ".")
import torch
from burn_ppo_torch.config import Config
from burn_ppo_torch.train import Trainer

out = {{}}
with tempfile.TemporaryDirectory(prefix="chip_smoke_update_turn_") as d:
    for name, toml, steps, over in {cases}:
        cfg = Config.load(Path("configs") / toml)
        for k, v in {{"num_envs": {envs}, "num_steps": steps, "seed": 0, **over}}.items():
            setattr(cfg, k, v)
        tr = Trainer(cfg, Path(d) / name, device="cuda", quiet=True)
        lr, ent = cfg.learning_rate.get(0), cfg.entropy_coef.get(0)
        shaping = cfg.reward_shaping_coef.get(0)
        tr.update(lr, ent, shaping)
        if tr.pool is not None:
            tr.global_step += 1
            tr.save_checkpoint()
            tr.update(lr, ent, shaping)
        ms, ran = [], []
        for _ in range({updates}):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m, _ = tr.update(lr, ent, shaping)
            ms.append((time.perf_counter() - t0) * 1e3)
            ran.append(m["num_minibatch_updates"])
        out[name] = {{"train_step_ms": ms, "minibatches_run": ran}}
print(json.dumps(out))
"""


def update_turns(parent_dir: Path) -> dict:
    """Whole train steps through ``Trainer.update`` (the rollout, the
    update, the fetch; on the vs-pool path against one checkpoint, the
    pool's record folds included) of the parent's tree and this one, in
    turns (parent, this, this, parent), each its own process: CartPole at
    4096 x 128, Connect Four against the pool at 4096 x 64 (obs norm on;
    its KL stop seldom fires) and Liar's Dice CTDE against the pool at
    4096 x 128 (it fires in most updates), after one warm update (two on
    the vs-pool paths), host ms of each of ``TURN_UPDATES`` updates and
    its minibatches run. ``parent_dir`` may be any tree of this
    repository whose ``Trainer.update`` has this signature."""
    code = UPDATE_TURN.format(cases=repr(TURN_CASES), envs=E, updates=TURN_UPDATES)
    out: dict = {}
    for key, tree in (("parent", parent_dir), ("this", ROOT), ("this", ROOT),
                      ("parent", parent_dir)):
        res = subprocess.run([sys.executable, "-c", code], cwd=tree, capture_output=True,
                             text=True, timeout=900)
        if res.returncode != 0:
            raise RuntimeError(f"update turn in {tree} exited {res.returncode}:\n"
                               f"{res.stderr[-4000:]}")
        for name, run in json.loads(res.stdout.strip().splitlines()[-1]).items():
            entry = out.setdefault(name, {})
            entry.setdefault(f"{key}_train_step_ms", []).append(run["train_step_ms"])
            entry.setdefault(f"{key}_minibatches_run", []).append(run["minibatches_run"])
            entry.setdefault(f"{key}_median_ms", []).append(
                sorted(run["train_step_ms"])[len(run["train_step_ms"]) // 2])
    return out


# The device kernel of each rollout wrapper (csrc), one launch a call.
ROLLOUT_KERNELS = {
    "cartpole_step_autoreset": "cartpole_step_autoreset_kernel",
    "connect_four_step_autoreset": "connect_four_step_autoreset_kernel",
    "skull_step_autoreset": "skull_step_autoreset_kernel",
    "liars_dice_step_autoreset": "liars_dice_step_autoreset_kernel",
    "masked_gumbel_sample": "masked_gumbel_sample_kernel",
    "obs_norm_apply": "obs_norm_apply_kernel",
    "opponent_actor_forward": "opponent_mlp_kernel",
    "opponent_cnn_front": "opponent_cnn_front_kernel",
    "opponent_features_forward": "opponent_features_kernel",
    "return_norm_roll": "return_norm_roll_kernel",
    "return_norm_finalize": "return_norm_finalize_kernel",
    "popart_denormalize": "popart_denormalize_kernel",
}


# A bf16 run's rollout: K7's launches are its bf16 tower, and its f32
# tower (no wrapper's count: any launch fails) reads 0.
BF16_ROLLOUT_KERNELS = {**ROLLOUT_KERNELS, "opponent_actor_forward": "opponent_tower_bf16_kernel",
                        "opponent_actor_forward's f32 tower": "opponent_mlp_kernel"}


# The device kernel of each update wrapper that launches one of it a call
# (K8's row pass; K6's update its merge).
UPDATE_KERNELS = {
    "ppo_loss": "ppo_loss_rows_kernel",
    "clip_adam": "clip_adam_kernel",
    "obs_norm_apply": "obs_norm_apply_kernel",
    "obs_norm_update": "obs_norm_merge_kernel",
    "gae_reverse_scan": "gae_reverse_scan_staged_kernel",
    "gae_multiplayer_reverse_scan": "gae_multiplayer_staged_kernel",
    "episode_stats": "episode_stats_kernel",
    "popart_update": "popart_update_kernel",
    "popart_denormalize": "popart_denormalize_kernel",
    "window_records": "window_records_kernel",
    "window_report": "window_report_kernel",
}


def kernel_counts(events, launched: dict, names: dict = ROLLOUT_KERNELS) -> dict:
    """Each kernel of ``names`` (wrapper -> device kernel), its device
    launches in a profile counted by name, beside its wrapper's launches:
    {name: [device, expected]} for the kernels either side has."""
    out = {}
    for name, kernel in names.items():
        pattern = re.compile(rf"(?<![A-Za-z0-9_]){kernel}(?![A-Za-z0-9_])")
        seen = sum(1 for e in events if e.device_type == torch.autograd.DeviceType.CUDA
                   and pattern.search(e.name))
        if seen or launched.get(name):
            out[name] = [seen, launched.get(name, 0)]
    return out


PROFILE_LEAD_CYCLES = 40_000_000  # ~20 ms of device time at the H100's ~2 GHz


def replay_kernel_counts(graph, names: dict = ROLLOUT_KERNELS) -> dict:
    """Each kernel's device launches (``names``: the rollout's or the
    update's) in one profiled replay of a graph (a ``RolloutGraph``, or an
    ``UpdateGraph`` replayed whole, no minibatch graph skipped), by name, against the
    launches it captured. A graph that left a kernel out or captured it
    twice fails. A count under the captured one (the profiler lost a
    launch) is profiled again, at most three replays; one over it fails
    at once. A replay of an update graph trains on."""
    captured = {name: sum(c.get(w, 0) for c in graph.captured) for name, w in WRAPPERS.items()}
    act = torch.profiler.ProfilerActivity
    profiles = []
    while len(profiles) < 3:
        with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
            # A replay enqueues all its kernels at once, and a profile can
            # miss the kernels of its first milliseconds (once an update
            # graph's first 7-9 minibatches, three profiles in a row): the
            # stream waits on the device first.
            torch.cuda._sleep(PROFILE_LEAD_CYCLES)
            graph.replay()
            torch.cuda.synchronize()
        counts = kernel_counts(prof.events(), captured, names)
        profiles.append(counts)
        if any(seen > want for seen, want in counts.values()):
            raise AssertionError(f"more kernels in a replay than captured: {counts}")
        if all(seen == want for seen, want in counts.values()):
            return {"counts": counts, "profiles": len(profiles)}
    seen = Counter(e.name[:80] for e in prof.events() if any(k in e.name for k in names.values()))
    raise AssertionError(f"kernels in a replay against those captured, three profiles: "
                         f"{profiles}; the names in the last: {dict(seen)}")


def idle_share(update, step) -> dict:
    """The union of the device's kernel and copy intervals in one update
    under the profiler, against the median of three unprofiled updates on
    the host's clock (each ending synchronised), and against the profiled
    update's own span (the profiler slows the host). One unprofiled update
    first, which captures the rollout's and the update's graphs; then the
    kernels of one replay of each (``step.runner.graph``,
    ``step.updater.graph``) counted on the device."""
    update()
    torch.cuda.synchronize()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        update()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall_ms = sorted(walls)[1]
    act = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
        with torch.profiler.record_function("one_update"):
            update()
            torch.cuda.synchronize()
    events = prof.events()
    window = [e for e in events if e.name == "one_update"
              and e.device_type != torch.autograd.DeviceType.CUDA]
    if not window:
        raise AssertionError("the profiler recorded no update range")
    w0, w1 = window[0].time_range.start, window[0].time_range.end
    spans = sorted((max(e.time_range.start, w0), min(e.time_range.end, w1)) for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA and e.name != "one_update"
                   and e.time_range.end > w0 and e.time_range.start < w1)
    if not spans:
        raise AssertionError("the profiler recorded no device work in an update")
    busy, end = 0.0, w0
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return {"update_ms": wall_ms, "update_ms_profiled": (w1 - w0) / 1e3,
            "device_busy_ms": busy / 1e3, "idle_share": 1.0 - busy / 1e3 / wall_ms,
            "idle_share_profiled": 1.0 - busy / (w1 - w0), "device_events": len(spans),
            "replay_kernel_counts": replay_kernel_counts(step.runner.graph),
            "update_replay_kernel_counts": replay_kernel_counts(step.updater.graph,
                                                                UPDATE_KERNELS)}


# cuDNN's conv kernels by name (not cuBLAS's GEMMs, whose names share
# "xmma" and "gemm" with them).
CONV_KERNEL = re.compile(r"conv|cudnn|fprop|implicit|winograd|fft", re.IGNORECASE)


def rollout_split(graph, net, obs: torch.Tensor) -> dict:
    """One profiled replay of a CNN vs-pool rollout graph split by kernel:
    device ms and launches of K20, K7's feature front, cuDNN's convs and
    the rest; and the conv kernels of one eager learner forward on the
    rollout's obs, T of which the replay's convs must be (the opponents
    run none): more fails; fewer (the profiler lost a launch) profiles
    the replay again, three times at most, and is reported as it reads."""
    act = torch.profiler.ProfilerActivity

    def profiled(fn):
        with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
            torch.cuda._sleep(PROFILE_LEAD_CYCLES)
            fn()
            torch.cuda.synchronize()
        return [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                and SLEEP_KERNEL not in e.name]

    with torch.no_grad():
        net(obs)
        torch.cuda.synchronize()
        learner = sum(1 for e in profiled(lambda: net(obs)) if CONV_KERNEL.search(e.name))
    steps = graph.captured[0].get(WRAPPERS["opponent_cnn_front"], 0)
    for profiles in range(1, 4):
        groups: dict = {}
        for e in profiled(graph.replay):
            key = ("opponent_cnn_front" if "opponent_cnn_front_kernel" in e.name
                   else "opponent_features_forward" if "opponent_features" in e.name
                   else "cudnn_convs" if CONV_KERNEL.search(e.name) else "other")
            g = groups.setdefault(key, {"launches": 0, "device_ms": 0.0})
            g["launches"] += 1
            g["device_ms"] += (e.time_range.end - e.time_range.start) / 1e3
        convs = groups.get("cudnn_convs", {}).get("launches", 0)
        if convs > steps * learner:
            raise AssertionError(f"{convs} conv launches in a CNN vs-pool rollout replay, over "
                                 f"the learner's {learner} a step times {steps} steps: {groups}")
        if convs == steps * learner:
            break
    return {"groups": groups, "learner_conv_launches_a_forward": learner, "steps": steps,
            "profiles": profiles, "convs_all_the_learners": convs == steps * learner,
            "device_ms": sum(g["device_ms"] for g in groups.values())}


def update_idle_shares(tmp: Path, card_line: str) -> dict:
    """The device's idle share of one CartPole update (4096 x 128, the
    bench shape) and of one Connect Four update against a pool of 8
    checkpoints (4096 x 64, configs/connect_four.toml with obs norm, K =
    8), with the MLP and with the CNN, through ``Trainer.update``; and in one replay of each update's
    rollout graph and of its update graphs (every minibatch), every kernel's
    device launches against those the graphs captured; the CNN's rollout
    replay split by kernel (``rollout_split``). Run in a process
    of its own (``phase_in_process``):
    in a process that has profiled phase 2's kernels the profiler drops a
    K6 launch from every profile."""
    out = {"card": card_line}
    for name, toml, steps, pool in (("cartpole", "cartpole.toml", T, False),
                                   ("connect_four_pool", "connect_four.toml", T_C4, True),
                                   ("connect_four_pool_cnn", "connect_four.toml", T_C4, True)):
        cfg = Config.load(ROOT / "configs" / toml)
        cfg.num_envs, cfg.num_steps, cfg.normalize_obs, cfg.seed = E, steps, True, 0
        if name.endswith("_cnn"):
            cfg.network_type = "cnn"
        tr = Trainer(cfg, tmp / f"idle_{name}", device="cuda", quiet=True)
        if pool:
            for _ in range(8):
                tr.global_step += 1
                tr.save_checkpoint()
        lr, ent = cfg.learning_rate.get(0), cfg.entropy_coef.get(0)
        out[name] = idle_share(lambda: tr.update(lr, ent, 0.0),
                               tr.pool_step if pool else tr.train_step)
        if pool:
            out[name]["rotation"] = len(tr.pool.active)
        if name.endswith("_cnn"):
            runner = tr.pool_step.runner
            out[name]["rollout_split"] = rollout_split(runner.graph, tr.state.network,
                                                       runner.carry.obs)
    return out


def episode_logs(dev, g, T: int, P: int, rate: float = 0.05) -> EpisodeLog:
    """[T, 4096] logs: wins, all-tied draws and the [0, ..] sentinel."""
    kinds = torch.randint(0, 4, (T, E), generator=g, device=dev)
    places = torch.randint(1, P + 1, (T, E, P), generator=g, device=dev, dtype=torch.int32)
    places[kinds == 1] = 1
    places[kinds == 2] = 0
    return EpisodeLog(
        completed=(torch.rand(T, E, generator=g, device=dev) < rate).float(),
        total_rewards=torch.randn(T, E, P, generator=g, device=dev),
        length=torch.randint(1, 43, (T, E), generator=g, device=dev, dtype=torch.int32),
        outcome=places, active_players=torch.full((T, E), P, dtype=torch.int32, device=dev),
    )


def summaries_equal(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def check_episode_stats(dev, g, ptxas: list) -> dict:
    """K10 at the learner block of the pool path ([64, 4096], first 3072
    columns), all of Connect Four's [64, 4096], CartPole's [128, 4096] and
    four players with tied places in Skull's learner block (first 2867)
    and Liar's Dice's ([128, 4096], first 3072): counts, extrema and
    lengths exact, sums to 1e-6 relative + 1e-3; two calls, and two
    replays of a captured graph, the eager call's bits. Timed at [64,
    3072] P = 2, [64, 2867] P = 4 and [128, 3072] P = 4 beside an empty
    kernel's launch (the floor under any launch)."""
    out = {"tol": {"count_len_draws_max_min": "exact", "sums": "1e-6 rel + 1e-3"},
           "max_abs_err": 0.0, "ptxas": kernel_ptxas(ptxas, "episode_stats")}
    L = E - EP

    def close(k, p, name, who="") -> None:
        for key in ("count", "len_sum", "draws", "ret0_max", "ret0_min"):
            if not torch.equal(k[key], p[key]):
                raise AssertionError(f"episode_stats{who} {name}: {key} {k[key]} != {p[key]}")
        for key in ("ret_sum", "pts_sum"):
            if not bool(torch.all((k[key] - p[key]).abs() <= 1e-3 + 1e-6 * p[key].abs())):
                raise AssertionError(f"episode_stats{who} {name}: {key} {k[key]} != {p[key]}")

    for T_, P, cols in ((T_C4, 2, L), (T_C4, 2, None), (T, 1, None), (T_C4, 4, E - EP_SKULL),
                        (T_LD, 4, E - EP_LD)):
        logs = episode_logs(dev, g, T_, P)
        k = summarize_episode_logs(logs, P, num_envs=cols)
        again = summarize_episode_logs(logs, P, num_envs=cols)
        cut = EpisodeLog(**{f: getattr(logs, f)[:, :cols] for f in vars(logs)})
        p = summarize_episode_logs_plain(logs if cols is None else cut, P)
        torch.cuda.synchronize()
        name = f"T{T_}_P{P}_" + ("all" if cols is None else f"first{cols}")
        close(k, p, name)
        if not summaries_equal(k, again):
            raise AssertionError(f"episode_stats {name}: two calls differ")
        out[name] = max_err([(k[f], p[f]) for f in p])
        out["max_abs_err"] = max(out["max_abs_err"], out[name])
    out["bit_identical_across_calls"] = True

    # Two replays of a captured call, each the eager call's bits.
    logs = episode_logs(dev, g, T_LD, 4)
    eager = summarize_episode_logs(logs, 4, num_envs=E - EP_LD)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        summarize_episode_logs(logs, 4, num_envs=E - EP_LD)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = summarize_episode_logs(logs, 4, num_envs=E - EP_LD)
    for i in range(2):
        for t in captured.values():
            t.zero_()
        graph.replay()
        torch.cuda.synchronize()
        if not summaries_equal(captured, eager):
            raise AssertionError(f"episode_stats: graph replay {i} differs from the eager call")
    out["graph_replays_equal_bit_for_bit"] = 2
    del graph

    floor = empty_kernel()

    def timing(P: int, cols: int, T_: int = T_C4) -> dict:
        logs = episode_logs(dev, g, T_, P)
        block = EpisodeLog(**{f: getattr(logs, f)[:, :cols] for f in vars(logs)})
        # The learner block's completed column is read whole; length, rewards
        # and placements only on the rows of completed episodes, as many as
        # this run's logs hold. Out: 5 + 2P floats. Ops: one test per entry,
        # ~30 per completed episode.
        done = int((block.completed > 0).sum())
        row = (block.length.element_size() + block.total_rewards[0, 0].numel() * 4
               + block.outcome[0, 0].numel() * 4)

        def new():
            return summarize_episode_logs(logs, P, num_envs=cols)

        res = {
            **timed(new, lambda: summarize_episode_logs_plain(block, P)),
            "library_ms": None, "completed_rows": done,
            **bound(nbytes(block.completed) + done * row + (5 + 2 * P) * 4,
                    T_ * cols + 30.0 * done),
        }
        return res

    out.update(timing(2, L))
    out["empty_kernel_device_ms"] = device_ms(floor)[0]
    name = f"T{T_C4}_P4_first{E - EP_SKULL}"
    out[name] = {"max_abs_err": out.pop(name), **timing(4, E - EP_SKULL)}
    name = f"T{T_LD}_P4_first{E - EP_LD}"
    out[name] = {"max_abs_err": out.pop(name), **timing(4, E - EP_LD, T_LD)}
    return out


def scalars(run: Path) -> dict:
    """name -> list of logged values, in step order."""
    out: dict = {}
    for line in (run / "metrics.jsonl").read_text().splitlines():
        rec = json.loads(line)
        if rec["type"] == "scalar":
            out.setdefault(rec["name"], []).append(rec["value"])
    return out


def train_phase(run: Path, args: list, updates: int, steps_per_update: int,
                expect: dict, card_line: str, checkpoint_freq: int = 10**12, done: int = 0,
                resume: bool = False, as_configured: bool = False) -> tuple:
    """One training run through the CLI, with every launch counter at 0
    just before it and read just after; checks the counts against
    ``expect`` (kernels not named there: 0) and the losses for finiteness.
    ``done`` updates were trained before (a fork's source, or with
    ``resume`` the run in ``run``, which is then resumed: ``args`` unused,
    the series read from the values this run logs after those already in
    its ``metrics.jsonl``).
    Every update is two graph replays, the rollout's and the update's
    (one capture each per runner), and launches K10 once, and K8 and K9
    once per minibatch graph replayed (every minibatch without
    ``target_kl``; with it, those the host replayed before it saw the
    stop flag): a minibatch after a KL stop or with no valid row launches
    both and changes nothing (``train/minibatch_updates`` counts those
    that ran). Every update folds its window's report (K19), and a vs-pool
    update appends its window's records (K18, in ``expect``): one window
    an update, since every log comes after one, except ``as_configured``:
    the config's own seed and log and checkpoint cadence, one series value
    a log."""
    from burn_ppo_torch import cli

    for w in WRAPPERS.values():
        w.launches = 0
    RolloutGraph.reset_counts()
    UpdateGraph.reset_counts()
    t0 = time.time()
    logged = {k: len(v) for k, v in scalars(run).items()} if resume else {}
    total = str((done + updates) * steps_per_update)
    cadence = [] if as_configured else ["--checkpoint-freq", str(checkpoint_freq), "--seed", "0"]
    rc = cli.main(["train", "--resume", str(run), "--total-steps", total, "--quiet"] if resume
                  else ["train", *args, "--total-steps", total, *cadence, "--run-dir", str(run),
                        "--quiet"])
    torch.cuda.synchronize()
    wall = time.time() - t0
    eager = {name: w.launches for name, w in WRAPPERS.items()}
    graphed = {name: RolloutGraph.launches.get(w, 0) + UpdateGraph.launches.get(w, 0)
               for name, w in WRAPPERS.items()}
    warmup = {name: RolloutGraph.warmup_launches.get(w, 0) + UpdateGraph.warmup_launches.get(w, 0)
              for name, w in WRAPPERS.items()}
    launches = {name: eager[name] + graphed[name] for name in WRAPPERS}
    if rc != 0:
        raise RuntimeError(f"train command exited {rc}")
    # Every rollout and every update is a graph replay, one each an
    # update, one capture each per runner; the only eager launches are the
    # graphs' warm-ups.
    captures = (RolloutGraph.captures, UpdateGraph.captures)
    if (RolloutGraph.replays, UpdateGraph.replays) != (updates, updates):
        raise AssertionError(f"{RolloutGraph.replays} rollout and {UpdateGraph.replays} update "
                             f"graph replays in {updates} updates")
    if captures[0] != captures[1] or not 1 <= captures[0] <= 2:
        raise AssertionError(f"graph captures (rollout, update) {captures}: one each per runner")
    if eager != warmup:
        raise AssertionError(f"eager launches {eager} beyond the warm-ups {warmup}")
    series = {k: v[logged.get(k, 0):] for k, v in scalars(run).items()}
    cfg = Config.load(run / "config.toml")
    logs = updates * steps_per_update // cfg.log_freq if as_configured else updates
    for name in ("train/policy_loss", "train/value_loss", "train/total_loss", "train/entropy",
                 "train/minibatch_updates"):
        vals = series.get(name, [])
        if len(vals) != logs or not all(v is not None and math.isfinite(v) for v in vals):
            raise AssertionError(f"{name}: expected {logs} finite values, got {vals}")
    # With windows a log holds the last update's count only.
    minibatches = None if as_configured else int(sum(series["train/minibatch_updates"]))
    # K8 and K9 launch in every minibatch graph replayed (those after a KL
    # stop are skipped where the update is a graph per minibatch)
    launched = updates * cfg.num_epochs * cfg.num_minibatches - UpdateGraph.skipped
    want = {name: expect.get(name, 0) for name in WRAPPERS}
    want.update(ppo_loss=launched, clip_adam=launched, episode_stats=updates,
                window_report=updates)
    # The main path's launches: eager (the warm-ups left out) plus the
    # graphs' (captured x replayed).
    main_path = {name: eager[name] - warmup[name] + graphed[name] for name in WRAPPERS}
    if main_path != want:
        raise AssertionError(f"kernel launches {main_path} != {want}")
    sps = series["perf/sps"]
    steady = sorted(sps[1:])
    return {
        "updates": updates, "env_steps": updates * steps_per_update, "wall_s": wall,
        "env_steps_per_s_per_update": sps,
        "env_steps_per_s_median_after_first": steady[len(steady) // 2],
        "launches": launches, "graph_launches": graphed, "warmup_launches": warmup,
        "graph_replays": [RolloutGraph.replays, UpdateGraph.replays],
        "graph_captures": list(captures), "minibatch_graphs_skipped": UpdateGraph.skipped,
        "minibatches_run": minibatches,
        "minibatches_skipped": None if minibatches is None else launched - minibatches,
        "card": card_line,
    }, series


def bench_train(tmp: Path, card_line: str) -> dict:
    """The CartPole bench shape. The return normaliser is on (one player):
    its roll runs inside K1, so K12's roll launches never, and the
    finalize once per update."""
    n = BENCH_UPDATES
    out, _ = train_phase(
        tmp / "bench", ["--config", str(ROOT / "configs" / "cartpole.toml"),
                        "--num-envs", str(E), "--num-steps", str(T)],
        n, E * T,
        {"cartpole_step_autoreset": n * T, "masked_gumbel_sample": n * T,
         "gae_reverse_scan": n, "obs_norm_apply": n * (T + 2), "obs_norm_update": n,
         "return_norm_finalize": n},
        card_line,
    )
    return out


TRAIN_TURN = """
import json, sys, tempfile
from pathlib import Path
sys.path.insert(0, ".")
import chip_smoke
with tempfile.TemporaryDirectory(prefix="chip_smoke_turn_") as d:
    print(json.dumps(chip_smoke.{}(Path(d), chip_smoke.card())))
"""


def phase_in_process(tree: Path, phase: str) -> dict:
    """``chip_smoke.<phase>(tmp, card)`` of ``tree``'s chip_smoke, in a
    process of its own: the phase's JSON result."""
    t0 = time.time()
    res = subprocess.run([sys.executable, "-c", TRAIN_TURN.format(phase)], cwd=tree,
                         capture_output=True, text=True, timeout=900)
    if res.returncode != 0:
        raise RuntimeError(f"{phase} in {tree} exited {res.returncode}:\n{res.stderr[-4000:]}")
    return {**json.loads(res.stdout.strip().splitlines()[-1]), "process_s": time.time() - t0}


def train_turns(parent_dir: Path, phase: str) -> dict:
    """A train phase (``bench_train``: phase 3, CartPole 4096 x 128;
    ``selfplay_pool_train``: phase 3d, Connect Four against the pool at the
    bench_selfplay_pool shape) for the parent's tree (a full checkout) and
    this one, in turns (parent, this, this, parent), each its own process
    running its own ``chip_smoke``: env-steps/s medians after the first
    update, every update's, and on the pool phase the updates at K = 8
    (the parent's tree may run fewer updates than this one's)."""
    out: dict = {"train_phase": phase}
    for key, tree in (("parent_", parent_dir), ("", ROOT), ("", ROOT), ("parent_", parent_dir)):
        run = phase_in_process(tree, phase)
        for name in ("env_steps_per_s_median_after_first", "env_steps_per_s_at_k8",
                     "env_steps_per_s_per_update"):
            if name in run:
                out.setdefault(f"{key}{name}", []).append(run[name])
    return out


def selfplay_train(tmp: Path, card_line: str, network: str, updates: int,
                   flags: tuple = ()) -> dict:
    """Connect Four pure self-play: one apply per rollout step, one for the
    bootstrap and one for the update batch. The CNN run also turns the
    return normaliser on: two players, so the rollout gathers the acting
    player's reward and launches K12's roll every step. ``flags``: more
    (``BF16_FLAGS``: the bf16 compute dtype)."""
    extra = (["--network-type", "cnn", "--activation", "relu", "--normalize-returns"]
             if network == "cnn" else []) + list(flags)
    rn = ({"return_norm_roll": updates * T_C4, "return_norm_finalize": updates}
          if network == "cnn" else {})
    out, series = train_phase(
        tmp / (f"c4_{network}" + ("_bf16" if flags else "")),
        ["--config", str(ROOT / "configs" / "connect_four.toml"),
         "--opponent-pool-fraction", "0", "--num-envs", str(E), "--num-steps", str(T_C4),
         "--normalize-obs", *extra],
        updates, E * T_C4,
        {"connect_four_step_autoreset": updates * T_C4, "masked_gumbel_sample": updates * T_C4,
         "gae_multiplayer_reverse_scan": updates,
         "obs_norm_apply": updates * (T_C4 + 2), "obs_norm_update": updates, **rn},
        card_line,
    )
    points = [a + b for a, b in zip(series["episode/player_0_points"],
                                    series["episode/player_1_points"])]
    draw_rate, length = series["episode/draw_rate"], series["episode/length_mean"]
    if len(points) != updates or not all(abs(s - 1.0) <= 1e-6 for s in points):
        raise AssertionError(f"Swiss points per update do not sum to 1: {points}")
    if not all(0.0 <= d <= 1.0 for d in draw_rate):
        raise AssertionError(f"draw_rate outside [0, 1]: {draw_rate}")
    if not all(7.0 <= x <= 42.0 for x in length):
        raise AssertionError(f"mean episode length outside [7, 42]: {length}")
    out.update(network=network, flags=list(flags), points_sum=points, draw_rate=draw_rate,
               length_mean=length,
               player_0_points=series["episode/player_0_points"],
               policy_loss=series["train/policy_loss"])
    return out


def selfplay_pool_train(tmp: Path, card_line: str) -> dict:
    """Connect Four against the opponent pool, configs/connect_four.toml as
    users run it (pool fraction 0.25, 8 opponents at most), a checkpoint
    after every update. Update u runs against min(u - 1, 8) opponents (the
    first, with an empty pool, is pure self-play), so updates 9 and 10 run
    K = 8. Per pool update: K2 twice a step (learner, opponents), K7 once."""
    n = POOL_UPDATES
    pool_updates = n - 1
    run = tmp / "c4_pool"
    out, series = train_phase(
        run,
        ["--config", str(ROOT / "configs" / "connect_four.toml"), "--num-envs", str(E),
         "--num-steps", str(T_C4), "--normalize-obs"],
        n, E * T_C4,
        {"connect_four_step_autoreset": n * T_C4,
         "masked_gumbel_sample": n * T_C4 + pool_updates * T_C4,
         "opponent_actor_forward": pool_updates * T_C4,
         "gae_multiplayer_reverse_scan": n, "window_records": pool_updates,
         "obs_norm_apply": n * (T_C4 + 2), "obs_norm_update": n},
        card_line, checkpoint_freq=E * T_C4,
    )
    stats = json.loads((run / "opponent_stats.json").read_text())["opponents"]
    rotation_sizes = [min(u - 1, 8) for u in range(1, n + 1)]
    # The stats file is written at each rotation's fold: after update 10 it
    # lists the 9 checkpoints that were in the pool, so updates 9 and 10 ran K = 8.
    if len(stats) != n - 1 or max(rotation_sizes) != 8:
        raise AssertionError(f"the pool did not reach 8 opponents: {len(stats)} in the stats file")
    for f in ("rating_games.jsonl", "rating_metadata.json", "checkpoints/best"):
        if not (run / f).exists():
            raise AssertionError(f"vs-pool run wrote no {f}")
    share = series["train/learner_valid_fraction"]
    want = (E - EP + EP / 2) / E
    if len(share) != pool_updates or not all(abs(s - want) <= 0.02 for s in share):
        raise AssertionError(f"learner valid share {share} not within 0.02 of {want}")
    sps = series["perf/sps"]
    out.update(rotation_sizes=rotation_sizes, opponents_in_pool=len(stats),
               games_played=sum(x["games_played"] for x in stats),
               learner_valid_share=share, learner_valid_share_expected=want,
               current_elo=series["train/current_elo"], best_elo=series["train/best_elo"],
               env_steps_per_s_at_k8=sps[8:], policy_loss=series["train/policy_loss"])
    return out


def selfplay_pool_cnn(tmp: Path, card_line: str, bf16: bool = False) -> dict:
    """The CNN against the opponent pool (A12b): configs/connect_four.toml
    as users run it with --network-type cnn (pool fraction 0.25, 8
    opponents at most), obs norm on, 4096 x 64, a checkpoint after every
    update: 10 updates, the pool reaching K = 8 at updates 9 and 10 (or,
    with ``bf16``, 3 updates with --compute-dtype bfloat16: K7's feature
    front in its bf16 tower). Per pool update, every step: K20 once, the
    K7's feature front once, K2 twice (learner, opponents), K7's raw-obs
    front never. The update times on the host's clock from
    ``perf/sps``."""
    n = CNN_POOL_UPDATES_BF16 if bf16 else POOL_UPDATES
    pool_updates = n - 1
    run = tmp / ("c4_pool_cnn" + ("_bf16" if bf16 else ""))
    out, series = train_phase(
        run,
        ["--config", str(ROOT / "configs" / "connect_four.toml"), "--network-type", "cnn",
         "--num-envs", str(E), "--num-steps", str(T_C4), "--normalize-obs",
         *(BF16_FLAGS if bf16 else ())],
        n, E * T_C4,
        {"connect_four_step_autoreset": n * T_C4,
         "masked_gumbel_sample": n * T_C4 + pool_updates * T_C4,
         "opponent_cnn_front": pool_updates * T_C4,
         "opponent_features_forward": pool_updates * T_C4,
         "gae_multiplayer_reverse_scan": n, "window_records": pool_updates,
         "obs_norm_apply": n * (T_C4 + 2), "obs_norm_update": n},
        card_line, checkpoint_freq=E * T_C4,
    )
    cfg = Config.load(run / "config.toml")
    if cfg.network_type != "cnn" or cfg.compute_dtype != ("bfloat16" if bf16 else None):
        raise AssertionError(f"the run's config.toml: {cfg.network_type} {cfg.compute_dtype}")
    stats = json.loads((run / "opponent_stats.json").read_text())["opponents"]
    rotation_sizes = [min(u - 1, 8) for u in range(1, n + 1)]
    if len(stats) != n - 1 or (not bf16 and max(rotation_sizes) != 8):
        raise AssertionError(f"the pool did not reach {min(n - 1, 8)} opponents: {len(stats)} "
                             "in the stats file")
    for f in ("rating_games.jsonl", "rating_metadata.json", "checkpoints/best"):
        if not (run / f).exists():
            raise AssertionError(f"the CNN vs-pool run wrote no {f}")
    share = series["train/learner_valid_fraction"]
    want = (E - EP + EP / 2) / E
    if len(share) != pool_updates or not all(abs(s - want) <= 0.02 for s in share):
        raise AssertionError(f"learner valid share {share} not within 0.02 of {want}")
    sps = series["perf/sps"]
    update_ms = [E * T_C4 / v * 1e3 for v in sps]
    out.update(rotation_sizes=rotation_sizes, opponents_in_pool=len(stats),
               games_played=sum(x["games_played"] for x in stats),
               learner_valid_share=share, learner_valid_share_expected=want,
               env_steps_per_s_at_k8=sps[8:], update_ms_host=update_ms,
               policy_loss=series["train/policy_loss"], value_loss=series["train/value_loss"])
    return out


def four_player_points(series: dict, updates: int) -> list:
    """Per update, the four players' Swiss points summed over the learner
    block's finished games: P (P - 1) / 2 = 6 a game, so 6 on average over
    any set of finished games."""
    points = [sum(v) for v in zip(*(series[f"episode/player_{p}_points"] for p in range(4)))]
    if len(points) < updates - 1 or not all(abs(s - 6.0) <= 1e-4 for s in points):
        raise AssertionError(f"Swiss points per update do not sum to 6: {points}")
    return points


def four_player_valid_share(series: dict, pool_updates: int, pool_envs: int) -> tuple:
    """The learner's share of valid (learner-turn) samples per vs-pool
    update, strictly between L / E and (L + Ep/2) / E: three of the four
    seats of a pool env are the opponents'. Returns (shares, bounds)."""
    share = series["train/learner_valid_fraction"]
    L = E - pool_envs
    lo, hi = L / E, (L + pool_envs / 2) / E
    if len(share) != pool_updates or not all(lo < s_ < hi for s_ in share):
        raise AssertionError(f"learner valid share {share} not strictly inside ({lo}, {hi})")
    return share, [lo, hi]


def skull_selfplay_train(tmp: Path, card_line: str) -> dict:
    """The bench_skull_ctde shape: Skull, four players, CTDE actor and
    critic 512x2 (tanh), 4096 envs x 64 steps, 4 epochs x 4 minibatches,
    no pool (configs/skull_ctde.toml's other settings)."""
    n = BENCH_UPDATES
    out, series = train_phase(
        tmp / "skull_selfplay",
        ["--config", str(ROOT / "configs" / "skull_ctde.toml"), "--opponent-pool-fraction", "0",
         "--num-envs", str(E), "--num-steps", str(T_C4), "--hidden-size", "512",
         "--num-hidden", "2", "--activation", "tanh", "--critic-hidden-size", "512",
         "--critic-num-hidden", "2", "--num-epochs", "4", "--num-minibatches", "4"],
        n, E * T_C4,
        {"skull_step_autoreset": n * T_C4, "masked_gumbel_sample": n * T_C4,
         "gae_multiplayer_reverse_scan": n},
        card_line,
    )
    out.update(points_sum=four_player_points(series, n),
               player_points=[series[f"episode/player_{p}_points"] for p in range(4)],
               length_mean=series["episode/length_mean"], policy_loss=series["train/policy_loss"])
    return out


def four_player_pool_train(tmp: Path, card_line: str, name: str, args: list, step_kernel: str,
                           steps: int, pool_envs: int, updates: int, network: str, obs_dim: int,
                           expect: dict | None = None) -> dict:
    """A four-player config against the opponent pool as users run it, at
    4096 x ``steps``, a checkpoint after every update: update u runs
    against min(u - 1, 8) opponents (the first, with an empty pool, is
    pure self-play), so 10 updates reach K = 8. Per pool update: K2 twice
    a step (learner, opponents), K7 once. Checks the pool's stats, the
    rating files, the learner's valid share, Swiss points 6 a game and the
    checkpoint's metadata."""
    pool_updates = updates - 1
    run = tmp / name
    out, series = train_phase(
        run, [*args, "--num-envs", str(E)], updates, E * steps,
        {step_kernel: updates * steps, "masked_gumbel_sample": (updates + pool_updates) * steps,
         "opponent_actor_forward": pool_updates * steps, "gae_multiplayer_reverse_scan": updates,
         "window_records": pool_updates, **(expect or {})},
        card_line, checkpoint_freq=E * steps,
    )
    stats = json.loads((run / "opponent_stats.json").read_text())["opponents"]
    # The stats file is written at each rotation's fold: after update u it
    # lists the u - 1 checkpoints that were in the pool.
    if len(stats) != pool_updates:
        raise AssertionError(f"{name}: {len(stats)} opponents in the stats file, not {pool_updates}")
    for f in ("rating_games.jsonl", "rating_metadata.json", "checkpoints/best"):
        if not (run / f).exists():
            raise AssertionError(f"{name}: the run wrote no {f}")
    share, bounds = four_player_valid_share(series, pool_updates, pool_envs)
    meta = json.loads((run / "checkpoints" / "latest" / "metadata.json").read_text())
    if (meta["network_type"], meta["obs_dim"], meta["num_players"]) != (network, obs_dim, 4):
        raise AssertionError(f"{name}: checkpoint metadata {meta}")
    sps = series["perf/sps"]
    out.update(rotation_sizes=[min(u - 1, 8) for u in range(1, updates + 1)],
               opponents_in_pool=len(stats), games_played=sum(x["games_played"] for x in stats),
               learner_valid_share=share, learner_valid_share_bounds=bounds,
               points_sum=four_player_points(series, updates),
               length_mean=series["episode/length_mean"], current_elo=series["train/current_elo"],
               env_steps_per_s_at_k8=sps[8:], policy_loss=series["train/policy_loss"])
    return out


RESUME_UPDATES = 2  # each leg of the resume phase
RESUME_LEG = """
import json, sys
from pathlib import Path
sys.path.insert(0, ".")
import chip_smoke
print(json.dumps(chip_smoke.{}))
"""


def in_processes(calls: list) -> list:
    """``chip_smoke.<call>`` (each a call's source text) in processes of
    their own, all at once: their JSON results, in order."""
    procs = [subprocess.Popen([sys.executable, "-c", RESUME_LEG.format(c)], cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for c in calls]
    try:
        outs = [p.communicate(timeout=900) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for c, p, (out, err) in zip(calls, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"{c} exited {p.returncode}:\n{err[-4000:]}")
    return [json.loads(out.strip().splitlines()[-1]) for out, _ in outs]


def resume_case(name: str) -> tuple:
    """(first leg's CLI flags, env steps an update, expected launches of a
    leg of ``n`` updates of which ``pool`` ran against the pool) of a case
    of the resume phase: CartPole at the bench shape (obs and return
    norm on; ``cartpole_popart_entropy`` with PopArt and the adaptive
    entropy controller too), Liar's Dice CTDE against the pool
    (liars_dice_ctde.toml)."""
    if name.startswith("cartpole"):
        popart = name == "cartpole_popart_entropy"
        return (["--config", str(ROOT / "configs" / "cartpole.toml"), "--num-envs", str(E),
                 "--num-steps", str(T), *(POPART_FLAGS if popart else [])], E * T,
                lambda n, pool: {"cartpole_step_autoreset": n * T, "masked_gumbel_sample": n * T,
                                 "gae_reverse_scan": n, "obs_norm_apply": n * (T + 2),
                                 "obs_norm_update": n, "return_norm_finalize": n,
                                 **({"popart_update": n, "popart_denormalize": n}
                                    if popart else {})})
    return (["--config", str(ROOT / "configs" / "liars_dice_ctde.toml"), "--num-envs", str(E)],
            E * T_LD,
            lambda n, pool: {"liars_dice_step_autoreset": n * T_LD,
                             "masked_gumbel_sample": (n + pool) * T_LD,
                             "opponent_actor_forward": pool * T_LD,
                             "gae_multiplayer_reverse_scan": n, "window_records": pool})


def resume_leg(case: str, run: str, done: int, mode: str, fork_from: str = "") -> dict:
    """One leg of the resume phase in this process, through the CLI: a
    fresh run (``mode`` "fresh"), a ``--fork`` of ``fork_from`` with a new
    learning rate ("fork"), or a ``--resume`` of ``run`` ("resume"), each
    ``RESUME_UPDATES`` updates with a checkpoint after each; the launch
    counts checked as in every train phase (every rollout and update a
    graph replay). The first update of a fresh vs-pool run has an empty
    pool; every later one runs against it."""
    args, spu, expect = resume_case(case)
    n = RESUME_UPDATES
    pool = 0 if case.startswith("cartpole") else n - 1 if mode == "fresh" else n
    if mode == "fork":
        args = ["--fork", fork_from, "--learning-rate", "0.0005", "--runs-base",
                str(Path(run).parent)]
    out, _ = train_phase(Path(run), args, n, spu, expect(n, pool), card(), checkpoint_freq=spu,
                         done=done, resume=mode == "resume")
    meta = json.loads((Path(run) / "checkpoints" / "latest" / "metadata.json").read_text())
    if meta["step"] != (done + n) * spu:
        raise AssertionError(f"{case} {mode}: the last checkpoint is at step {meta['step']}, "
                             f"not {(done + n) * spu}")
    return {k: out[k] for k in ("wall_s", "graph_replays", "graph_captures", "minibatches_run")} | {
        "launches": {k: v for k, v in out["launches"].items() if v},
        "forked_from": meta["forked_from"]}


def leaf_bytes(x) -> tuple:
    a = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return a.dtype.str, a.shape, a.tobytes()


def restored_leaves(run: str) -> dict:
    """A ``Trainer`` resumed from ``run``'s latest checkpoint in this
    process: every leaf it restored (parameters, moments, the Adam count,
    obs-norm and return-norm state, the generator state) equal to the
    saved one, bit for bit."""
    from burn_ppo_torch.checkpoint import load_leaves

    ckpt = (Path(run) / "checkpoints" / "latest").resolve()
    t = Trainer(Config.load(Path(run) / "config.toml"), run, quiet=True, resume_from=ckpt)
    live = {k: v for k, v in t.checkpoint_leaves().items() if v is not None}
    files = {f.stem: load_leaves(f) for f in ckpt.glob("*.npz")}
    if set(live) != set(files):
        raise AssertionError(f"{ckpt}: the trainer holds {sorted(live)}, the files {sorted(files)}")
    for k in live:
        if len(live[k]) != len(files[k]) or any(
                leaf_bytes(a) != leaf_bytes(b) for a, b in zip(live[k], files[k])):
            raise AssertionError(f"{ckpt}/{k}.npz: a restored leaf differs from the saved one")
    meta = json.loads((ckpt / "metadata.json").read_text())
    if t.global_step != meta["step"]:
        raise AssertionError(f"{ckpt}: global step {t.global_step}, saved {meta['step']}")
    return {"checkpoint": ckpt.name, "leaves": {k: len(v) for k, v in live.items()},
            "values": sum(int(np.prod(leaf_bytes(x)[1])) for v in live.values() for x in v),
            "generator_state_bytes": int(t.generator.get_state().numel())}


def equal_checkpoints(a: Path, b: Path) -> list:
    """The files of two runs' latest checkpoints, each leaf equal bit for
    bit; raises on the first that differs."""
    from burn_ppo_torch.checkpoint import load_leaves

    ca, cb = (r / "checkpoints" / "latest" for r in (a, b))
    names = sorted(f.name for f in ca.glob("*.npz"))
    if names != sorted(f.name for f in cb.glob("*.npz")):
        raise AssertionError(f"{ca} and {cb} hold other files")
    for f in names:
        la, lb = load_leaves(ca / f), load_leaves(cb / f)
        if len(la) != len(lb) or any(leaf_bytes(x) != leaf_bytes(y) for x, y in zip(la, lb)):
            raise AssertionError(f"two resumes differ in {f}: {ca} and {cb}")
    return names


def pool_carried(first: Path, resumed: Path) -> dict:
    """The first leg's checkpoints in the resumed run's pool stats (games
    no fewer) and rating files (its games a prefix of the log, its
    checkpoints rated)."""
    before = {s["name"]: s for s in json.loads((first / "opponent_stats.json").read_text())[
        "opponents"]}
    after = {s["name"]: s for s in json.loads((resumed / "opponent_stats.json").read_text())[
        "opponents"]}
    games = (first / "rating_games.jsonl").read_text().splitlines()
    resumed_games = (resumed / "rating_games.jsonl").read_text().splitlines()
    rated = json.loads((resumed / "rating_metadata.json").read_text())
    if not before or not set(before) < set(after) or any(
            after[k]["games_played"] < before[k]["games_played"] for k in before):
        raise AssertionError(f"the pool stats lost the first leg's checkpoints: {sorted(before)} "
                             f"-> {sorted(after)}")
    if resumed_games[:len(games)] != games or len(resumed_games) <= len(games):
        raise AssertionError("the rating log does not continue the first leg's")
    steps = rated["checkpoint_steps"]
    if not set(before) <= set(steps) or rated["first_checkpoint"] != min(before):
        raise AssertionError(f"the rating metadata lost the first leg's checkpoints: {rated}")
    return {"pool_before": sorted(before), "pool_after": sorted(after),
            "rating_games_before": len(games), "rating_games_after": len(resumed_games),
            "rated_checkpoints": sorted(steps), "current_checkpoint": rated["current_checkpoint"]}


def resume_phase(tmp: Path, card_line: str) -> dict:
    """Phase ``resume``: for CartPole at the bench shape, the same with
    PopArt and the adaptive entropy controller (``popart.npz`` among the
    leaves restored and compared), Liar's Dice CTDE against the pool, and
    a ``--fork`` of the CartPole run (a new learning rate): a leg of 2
    updates with a checkpoint after each, then in processes of their own,
    at once, the checkpoint loaded (every restored
    leaf the saved one) and two resumes of 2 updates from copies of the
    run dir, whose last checkpoints must be equal bit for bit; each leg's
    rollouts and updates graph replays; on the vs-pool case the pool stats
    and rating files carried over; the fork's lineage in its metadata."""
    import shutil

    t0 = time.time()
    out: dict = {"card": card_line, "updates_a_leg": RESUME_UPDATES}
    legs = {"cartpole": tmp / "cartpole", "liars_dice_ctde_pool": tmp / "liars_dice",
            "cartpole_popart_entropy": tmp / "cartpole_popart"}
    first = in_processes([f"resume_leg({c!r}, {str(r)!r}, 0, 'fresh')" for c, r in legs.items()])
    fork = tmp / "cartpole_fork"
    cases = [(c, r, 0, leg) for (c, r), leg in zip(legs.items(), first)]
    copies = {}
    for case, run, _, _ in cases:
        copies[run] = [run.with_name(f"{run.name}_{tag}") for tag in ("load", "r1", "r2")]
        for dst in copies[run]:
            shutil.copytree(run, dst, symlinks=True)
    # The two cases' loads and resumes, and the fork's first leg, at once.
    calls = [c for case, run, done, _ in cases for c in (
        f"restored_leaves({str(copies[run][0])!r})",
        *(f"resume_leg({case!r}, {str(r)!r}, {RESUME_UPDATES}, 'resume')"
          for r in copies[run][1:]))]
    src = str((legs["cartpole"] / "checkpoints" / "latest").resolve())
    calls.append(f"resume_leg('cartpole', {str(fork)!r}, {RESUME_UPDATES}, 'fork', {src!r})")
    results = in_processes(calls)
    fork_leg = results.pop()
    if fork_leg["forked_from"] != "cartpole":
        raise AssertionError(f"the fork's metadata records forked_from {fork_leg['forked_from']!r}")
    copies[fork] = [fork.with_name(f"{fork.name}_{tag}") for tag in ("load", "r1", "r2")]
    for dst in copies[fork]:
        shutil.copytree(fork, dst, symlinks=True)
    results += in_processes([f"restored_leaves({str(copies[fork][0])!r})",
                             *(f"resume_leg('cartpole', {str(r)!r}, {2 * RESUME_UPDATES}, "
                               "'resume')" for r in copies[fork][1:])])
    cases.append(("cartpole_fork", fork, RESUME_UPDATES, fork_leg))
    for i, (case, run, _, leg) in enumerate(cases):
        restored, r1, r2 = results[3 * i:3 * i + 3]
        res = {"first_leg": leg, "restored": restored, "resumes": [r1, r2],
               "equal_files": equal_checkpoints(copies[run][1], copies[run][2])}
        if r1["launches"] != r2["launches"]:
            raise AssertionError(f"{case}: the two resumes launched {r1['launches']} and "
                                 f"{r2['launches']}")
        if case == "liars_dice_ctde_pool":
            res["pool"] = pool_carried(run, copies[run][1])
        if case == "cartpole_popart_entropy":
            res["popart_leaves"] = res["restored"]["leaves"].get("popart")
            if res["popart_leaves"] != 3 or "popart.npz" not in res["equal_files"]:
                raise AssertionError(f"{case}: popart.npz not restored or not compared: {res}")
        if case == "cartpole_fork":
            for r in (fork, *copies[fork][1:]):
                meta = json.loads((r / "checkpoints" / "latest" / "metadata.json").read_text())
                if meta["forked_from"] != "cartpole":
                    raise AssertionError(f"{r}: forked_from {meta['forked_from']!r}")
            res["forked_from"] = "cartpole"
        out[case] = res
    out["seconds"] = time.time() - t0
    return out


def learning_bar(tmp: Path, extra: tuple = (), require: bool = True) -> dict:
    """scripts/validate_cartpole.py's run, through the port's CLI, with the
    ``extra`` flags; ``require``: the bar (>= 195) must be cleared."""
    from burn_ppo_torch import cli

    run = tmp / ("bar" + "".join(extra).replace("-", "_"))
    t0 = time.time()
    rc = cli.main(["train", "--config", str(ROOT / "configs" / "cartpole.toml"),
                   "--num-envs", "32", "--num-steps", "128", "--total-steps", "200000",
                   "--learning-rate", "0.001", "--entropy-coef", "0.01", "--normalize-obs",
                   "--hidden-size", "64", "--num-hidden", "2", "--activation", "tanh",
                   "--checkpoint-freq", "100000", "--log-freq", "8192", "--seed", "1",
                   *extra, "--run-dir", str(run), "--quiet"])
    wall = time.time() - t0
    if rc != 0:
        raise RuntimeError(f"train command exited {rc}")
    meta = json.loads((run / "checkpoints" / "latest" / "metadata.json").read_text())
    last = {k: v[-1] for k, v in scalars(run).items()}
    out = {
        "final_step": meta["step"], "avg_return": meta["avg_return"],
        "approx_kl": last["train/approx_kl"],
        "explained_variance": last["train/explained_variance"], "wall_s": wall,
    }
    if not (meta["step"] >= 200_000 and (meta["avg_return"] >= 195.0 or not require)):
        raise AssertionError(f"CartPole learning bar failed: {out}")
    return out


def learning_bar_popart(tmp: Path) -> dict:
    """The learning bar with ``--normalize-values``, beside the JAX
    package's result for the same configuration on the CPU
    (``JAX_POPART_BAR``): where JAX clears 195, the port must too."""
    jax_clears = (JAX_POPART_BAR["avg_return"] or 0.0) >= 195.0
    port = learning_bar(tmp, ("--normalize-values",), require=jax_clears)
    print(f"learning bar with --normalize-values: port (this card) avg_return "
          f"{port['avg_return']:.2f} at step {port['final_step']}; JAX package (CPU) "
          f"{JAX_POPART_BAR['avg_return']} at step {JAX_POPART_BAR['final_step']}", flush=True)
    return {"port": port, "jax_cpu": JAX_POPART_BAR, "jax_clears_195": jax_clears}


# ---------------------------------------------------------------------------
# PopArt (K15, K16, K8's normalised returns) and the adaptive entropy
# controller (inside K8)
# ---------------------------------------------------------------------------
POPART_UPDATES = 4  # each train run of phase popart_entropy_train
# The JAX package's result for the learning bar's configuration with
# normalize_values on, on the CPU (its CLI, seed 1; PERF.md names the run).
JAX_POPART_BAR = {"avg_return": 286.2758620689655, "final_step": 200704,
                  "run": "python -m burn_ppo_tpu train --config configs/cartpole.toml "
                         "--num-envs 32 --num-steps 128 --total-steps 200000 "
                         "--learning-rate 0.001 --entropy-coef 0.01 --normalize-obs "
                         "--hidden-size 64 --num-hidden 2 --activation tanh --seed 1 "
                         "--normalize-values --platform cpu"}


def popart_inputs(dev, g, N: int, count: float, H: int, valid: float | int = 1.0) -> tuple:
    """Raw returns [N] and valid [N] (``valid`` a share of rows, or an int:
    that many valid rows), a state of ``count`` samples, a value head [H, 1]
    and [1]."""
    x = torch.randn(N, generator=g, device=dev) * 30 + 7
    if isinstance(valid, int):
        w = torch.zeros(N, device=dev)
        w[torch.randperm(N, generator=g, device=dev)[:valid]] = 1.0
    else:
        w = (torch.rand(N, generator=g, device=dev) < valid).float()
    state = PopArtState.create(dev)
    state.mean.fill_(2.5 if count else 0.0)
    state.m2.fill_(90.0 * count)
    state.count.fill_(float(count))
    kernel = torch.randn(H, 1, generator=g, device=dev) * 0.1
    bias = torch.randn(1, generator=g, device=dev)
    return x, w, state, kernel, bias


def popart_leaves(state, kernel, bias) -> list:
    return [state.mean, state.m2, state.count, kernel, bias]


K15 = "popart_update_kernel"


def check_popart_update(dev, g) -> dict:
    """K15 against its plain version: the CartPole update batch [524288]
    (all valid, head 64), the vs-pool batch with a quarter of its rows
    invalid (head 512, the Liar's Dice CTDE critic's), and the count gate:
    one valid sample onto counts 0, 1 and 2 (the head untouched at a new
    count of 1, rescaled from 2 on). Stats and head to 1e-6 relative (the
    batch sums in another f64 order); two calls and two replays of a
    captured graph give the same bits; timed from a saved state beside
    ``torch.var_mean`` of the returns (the moments alone, unmasked), and
    in turns on the device clock with it. Each call
    first copies the saved state back (five small copies): ``device_ms``
    counts them, ``kernel_device_ms`` and the turns count K15 alone."""
    out: dict = {"tol": {"stats_rel": 1e-6, "head_rel": 1e-6}, "max_abs_err": 0.0}
    cases = (("cartpole_N524288_H64", 524288, 1e6, 64, 1.0),
             ("pool_N524288_H512_quarter_invalid", 524288, 3e6, 512, 0.75),
             ("count0_one_valid", 4096, 0, 64, 1), ("count1_one_valid", 4096, 1, 64, 1),
             ("count2_one_valid", 4096, 2, 512, 1))
    saved = {}
    for name, N, count, H, valid in cases:
        x, w, state, kernel, bias = popart_inputs(dev, g, N, count, H, valid)
        start = [t.clone() for t in popart_leaves(state, kernel, bias)]
        plain = PopArtState(*(t.clone() for t in start[:3]))
        pk, pb = start[3].clone(), start[4].clone()
        popart_update_rescale(state, x, w, kernel, bias)
        popart_update_rescale_plain(plain, x, w, pk, pb)
        torch.cuda.synchronize()
        pairs = list(zip(popart_leaves(state, kernel, bias), popart_leaves(plain, pk, pb)))
        for a, b in pairs:
            if not bool(torch.all((a - b).abs() <= 1e-6 * b.abs() + 1e-7)):
                raise AssertionError(f"popart_update {name}: max abs err {max_err([(a, b)])}")
        new_count = float(state.count)
        if new_count < 2 and not (torch.equal(kernel, start[3]) and torch.equal(bias, start[4])):
            raise AssertionError(f"popart_update {name}: the head moved at count {new_count}")
        if new_count >= 2 and torch.equal(kernel, start[3]):
            raise AssertionError(f"popart_update {name}: the head was not rescaled")
        out[name] = {"max_abs_err": max_err(pairs), "count": [count, new_count],
                     "head_rescaled": new_count >= 2}
        out["max_abs_err"] = max(out["max_abs_err"], out[name]["max_abs_err"])
        saved[name] = (x, w, state, kernel, bias, start)
    # Two calls and two graph replays from one saved state: the same bits.
    x, w, state, kernel, bias, start = saved["pool_N524288_H512_quarter_invalid"]
    leaves = popart_leaves(state, kernel, bias)

    def restore():
        for t, s0 in zip(leaves, start):
            t.copy_(s0)

    runs = []
    for _ in range(2):
        restore()
        popart_update_rescale(state, x, w, kernel, bias)
        runs.append([t.clone() for t in leaves])
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        restore()
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        popart_update_rescale(state, x, w, kernel, bias)
    popart_update_rescale.launches -= 1  # a capture launches nothing
    for _ in range(2):
        restore()
        graph.replay()
        torch.cuda.synchronize()
        runs.append([t.clone() for t in leaves])
    if not all(torch.equal(a, b) for r in runs[1:] for a, b in zip(r, runs[0])):
        raise AssertionError("popart_update: two calls or two graph replays differ")
    out["bit_identical_across_calls_and_replays"] = True
    for name in ("cartpole_N524288_H64", "pool_N524288_H512_quarter_invalid"):
        x, w, state, kernel, bias, start = saved[name]
        leaves = popart_leaves(state, kernel, bias)
        plain = PopArtState(*(t.clone() for t in start[:3]))
        pk, pb = start[3].clone(), start[4].clone()

        def new(x=x, w=w, state=state, kernel=kernel, bias=bias, leaves=leaves, start=start):
            for t, s0 in zip(leaves, start):
                t.copy_(s0)
            popart_update_rescale(state, x, w, kernel, bias)

        def old(x=x, w=w, plain=plain, pk=pk, pb=pb, start=start):
            for t, s0 in zip(popart_leaves(plain, pk, pb), start):
                t.copy_(s0)
            popart_update_rescale_plain(plain, x, w, pk, pb)

        def var_mean(x=x):
            torch.var_mean(x)

        H = kernel.numel()
        out[name].update(
            **timed(new, old), library_ms=time_ms(var_mean),
            # the kernel alone: ``new`` first restores five leaves (copies)
            kernel_device_ms=device_ms(new, only=K15)[0],
            library_device_ms=device_ms(var_mean)[0],
            library_turns=turns(new, var_mean, "library", only=K15),
            # returns and valid read once, the stats and the head read and
            # written; per element, the f64 sums (w, w x, then x - mean,
            # its square, times w, the sum)
            **bound(x.numel() * 8 + 2 * 12 + 2 * (H + 1) * 4, flops64=7.0 * x.numel()))
    out.update({k: out["cartpole_N524288_H64"][k]
                for k in TIMES + ("kernel_device_ms", "library_ms", "library_device_ms",
                                  "bound_ms", "bound_by")})
    return out


def check_popart_denormalize(dev, g) -> dict:
    """K16 against its plain version, bit for bit (two roundings each) at
    [4096] (the rollout's values a step) with counts 0, 1, 2 and large,
    written into a step's slice of a [T, E] buffer as the rollout does;
    timed at count 3e6."""
    out: dict = {"tol": "bit for bit", "max_abs_err": 0.0}
    buf = torch.zeros(T, E, device=dev)
    for count in (0, 1, 2, 3e6):
        x, _, state, _, _ = popart_inputs(dev, g, E, count, 1)
        popart_denormalize(state, x, out=buf[5])
        torch.cuda.synchronize()
        want = popart_denormalize_plain(state, x)
        if not torch.equal(buf[5], want) or (count < 2 and not torch.equal(buf[5], x)):
            raise AssertionError(f"popart_denormalize at count {count}: max abs err "
                                 f"{max_err([(buf[5], want)])}")
        if bool(buf[4].any()) or bool(buf[6].any()):
            raise AssertionError("popart_denormalize wrote outside its slice")
    out.update(**timed(lambda: popart_denormalize(state, x, out=buf[5]),
                       lambda: popart_denormalize_plain(state, x)),
               library_ms=None,
               # values read, the slice written, the three stats read; a
               # multiply and an add an element
               **bound(E * 4 * 2 + 12, 2.0 * E))
    return out


def check_ppo_loss_popart_entropy(dev, g) -> dict:
    """K8 with PopArt's stats (count 3e6: the gate open) and the
    controller stepping on this minibatch, against its plain version, at
    Connect Four's [65536, 7] and Liar's Dice's [65536, 49] with the value
    clip on (old values normalised too): loss and metrics to 1e-5
    relative, gradients to 1e-4 relative + 1e-6 of their largest entry,
    the stepped coefficient equal, the recorded entropy the book's mean;
    two calls give the same bits; then timed in turns against K8 with
    both off."""
    out: dict = {"tol": {"loss_metrics_rel": 1e-5, "grads_rel": 1e-4}, "max_abs_err": 0.0}
    for A in (7, 49):
        logits, values, mb = loss_batch(dev, g, 65536, A)
        mb["returns"] = mb["returns"] * 40 + 9
        mb["old_values"] = mb["old_values"] * 40 + 9
        _, _, popart, _, _ = popart_inputs(dev, g, 8, 3e6, 1)
        cfg = PPOUpdateConfig(clip_epsilon=0.1, clip_value=True, ent_delta=0.004)
        res = []
        for fn in (ppo_loss_forward, ppo_loss_forward, ppo_loss_plain):
            ctrl = AdaptiveEntropyState.create(0.02, dev)
            adaptive_entropy_record(ctrl, torch.tensor(0.3, device=dev))
            book = LossBook.create(dev)
            r = fn(logits, values, mb, torch.full((), 0.9, device=dev), cfg, book, False, popart,
                   ctrl, True)
            res.append(([t.clone() for t in r], ctrl, book))
        torch.cuda.synchronize()
        (k, kc, kb), (again, _, _), (p, pc, _) = res
        for a, b, rel in zip(k, p, (1e-5, 1e-5, 1e-4, 1e-4)):
            atol = 1e-6 * max(float(b.abs().max()), 1.0 if rel == 1e-5 else 0.0)
            if not bool(torch.all((a - b).abs() <= atol + rel * b.abs())):
                raise AssertionError(f"ppo_loss with PopArt A={A}: max abs err {max_err([(a, b)])}")
        if not all(torch.equal(a, b) for a, b in zip(k, again)):
            raise AssertionError(f"ppo_loss with PopArt A={A}: two calls differ")
        if float(kc.coef) != float(pc.coef) or float(kc.last_entropy) != float(
                kb.sums[2] / kb.count) or not bool(kc.has_entropy):
            raise AssertionError(f"ppo_loss's controller A={A}: {kc} against {pc}")
        out[f"M65536_A{A}_clip"] = {"max_abs_err": max_err(list(zip(k, p))),
                                    "coef": float(kc.coef),
                                    "recorded_entropy": [float(kc.last_entropy),
                                                         float(pc.last_entropy)]}
        # K8 with PopArt and the controller stepping, against K8 with both
        # off (the parent's path), in turns on the same minibatch.
        book, ctrl = LossBook.create(dev), AdaptiveEntropyState.create(0.02, dev)
        target, coef = torch.full((), 0.9, device=dev), torch.full((), 0.05, device=dev)
        out[f"M65536_A{A}_clip"].update(turns(
            lambda: ppo_loss_forward(logits, values, mb, target, cfg, book, False, popart, ctrl,
                                     True),
            lambda: ppo_loss_forward(logits, values, mb, coef, cfg, book, False), who="off"))
        out["max_abs_err"] = max(out["max_abs_err"], out[f"M65536_A{A}_clip"]["max_abs_err"])
    return out


def check_popart(dev, g) -> dict:
    """Phase ``popart``: K15, K16 and K8 with PopArt and the controller
    against their plain versions."""
    return {"popart_update": check_popart_update(dev, g),
            "popart_denormalize": check_popart_denormalize(dev, g),
            "ppo_loss_popart_entropy": check_ppo_loss_popart_entropy(dev, g)}


def popart_rollout_routes(dev) -> dict:
    """With PopArt on, the rollout as it runs (K2 denormalising the
    learner's values in its launch) against the parent's route (K2, then
    K16 into the step's slice of the values), from one carry and generator
    state, eagerly: CartPole at 4096 x 128 and Liar's Dice CTDE against a
    pool of 8 (3 active) at 4096 x 128, PopArt's stats initialised. Every
    carry, batch and log tensor (values, actions and log-probs among them)
    bit for bit; K16 launched 0 times in the first, T in the second."""
    from burn_ppo_torch.ppo import pool_rollout as pr
    from burn_ppo_torch.ppo import rollout as ro

    def k2_then_k16(logits, mask, uniforms, values, popart, buffers, t):
        actions, log_probs = masked_sample(logits, mask, uniforms)
        popart_denormalize(popart, values, out=buffers.values[t])
        return actions, log_probs, None

    out = {}
    g = torch.Generator(device=dev).manual_seed(22)
    for name, toml, steps, pool in (("cartpole", "cartpole.toml", T, False),
                                    ("liars_dice_ctde_pool", "liars_dice_ctde.toml", T_LD, True)):
        cfg, env, net, rng, carry, norm = rollout_setup(dev, toml, steps, POPART_OVERRIDES)
        P = env.spec.num_players
        popart = PopArtState.create(dev)
        popart.mean.fill_(1.5)
        popart.m2.fill_(9000.0)
        popart.count.fill_(1000.0)
        kw = dict(num_steps=steps, gamma=cfg.gamma,
                  normalize_returns=cfg.effective_normalize_returns(P),
                  return_clip=cfg.return_clip, popart=popart,
                  env_context={"shaping_coef": 0.05} if "shaping_coef" in env.context_fields
                  else None)
        if pool:
            L = E - int(round(E * cfg.opponent_pool_fraction))
            stack = random_opponents(dev, g, 8, cfg.activation, D=env.spec.obs_dim,
                                     H=cfg.hidden_size, A=env.spec.num_actions,
                                     depth=cfg.num_hidden)
            stack.norm = None
            seating = PoolSeating.create(E, L, P, 3, rng)
        start = rng.generator.get_state()
        runs, launches = [], []
        for route in ("k2_epilogue", "k2_then_k16"):
            rng.generator.set_state(start)
            before = (masked_sample.launches, popart_denormalize.launches)
            if route == "k2_then_k16":
                ro.sample_and_store_values = pr.sample_and_store_values = k2_then_k16
            try:
                res = (collect_rollouts_with_opponents(net, env, stack, carry, seating, norm, rng,
                                                       num_learner_envs=L, num_active=3, **kw)
                       if pool else collect_rollouts(net, env, carry, norm, rng, **kw))
                torch.cuda.synchronize()
            finally:
                ro.sample_and_store_values = pr.sample_and_store_values = SAMPLE_AND_STORE
            runs.append([t.clone() for t in state_leaves(list(res))])
            launches.append([masked_sample.launches - before[0],
                             popart_denormalize.launches - before[1]])
        diff = first_difference(runs[0], runs[1])
        k2 = steps * (2 if pool else 1)
        if diff is not None or launches != [[k2, 0], [k2, steps]]:
            raise AssertionError(f"popart rollout {name}: the two routes differ at {diff}, "
                                 f"launches (K2, K16) {launches}")
        out[name] = {"envs": E, "steps": steps, "equal_bit_for_bit": True,
                     "launches_k2_k16": dict(zip(("k2_epilogue", "k2_then_k16"), launches))}
    return out


POPART_FLAGS = ["--normalize-values", "--adaptive-entropy", "0.5"]
POPART_OVERRIDES = {"normalize_values": True, "adaptive_entropy": Schedule.parse(0.5)}


def popart_series(series: dict, updates: int, num_actions: int) -> dict:
    """The PopArt and controller series of a run, each with one finite
    value an update: the target 0.5 ln(A) at every update, the
    coefficient the update used (train/entropy_coef equal to
    train/adaptive_ent_coef), a std that moved off 1."""
    names = ("value_norm/mean", "value_norm/std", "train/adaptive_ent_coef",
             "train/entropy_target", "train/entropy_coef")
    out = {k: series.get(k, []) for k in names}
    for k, v in out.items():
        if len(v) != updates or not all(x is not None and math.isfinite(x) for x in v):
            raise AssertionError(f"{k}: expected {updates} finite values, got {v}")
    target = 0.5 * math.log(num_actions)
    if any(abs(t - target) > 1e-6 * target for t in out["train/entropy_target"]):
        raise AssertionError(f"train/entropy_target {out['train/entropy_target']} is not {target}")
    if out["train/entropy_coef"] != out["train/adaptive_ent_coef"]:
        raise AssertionError("train/entropy_coef is not the controller's coefficient")
    if all(s == 1.0 for s in out["value_norm/std"]):
        raise AssertionError("value_norm/std never moved off 1")
    return out


def popart_update_graph_cases(tmp: Path, card_line: str) -> dict:
    """The update with PopArt and the controller as captured CUDA graphs
    against the eager loop, bit for bit (``check_update_graph``, the
    PopArt stats and the controller's state among the leaves), in a
    process of its own as phase 2d: CartPole at 4096 x 128 and Liar's Dice
    CTDE against the pool (the KL stop required to fire); each graph's
    kernels (K15 and K16 once in the update, K16 never in the rollout, K8
    a minibatch) counted on the device in one replay."""
    dev = resolve_device("cuda")
    g = torch.Generator(device=dev).manual_seed(16)
    return {"card": card_line, **{name: check_update_graph(dev, g, name, toml, steps,
                                                          {**over, **POPART_OVERRIDES}, pool)
                                  for name, toml, steps, over, pool in POPART_UPDATE_CASES}}


POPART_UPDATE_CASES = (
    ("cartpole_popart_entropy", "cartpole.toml", T, {}, False),
    ("liars_dice_ctde_pool_popart_entropy", "liars_dice_ctde.toml", T_LD, {}, True),
)


def popart_entropy_train(tmp: Path, card_line: str) -> dict:
    """Phase ``popart_entropy_train``: CartPole at the bench shape and
    configs/liars_dice_ctde.toml at 4096 envs against the pool, each with
    ``--normalize-values --adaptive-entropy 0.5`` through the CLI,
    ``POPART_UPDATES`` updates, counted as every train phase (K15 once an
    update in its graph, K16 once, the bootstrap's: the rollout steps
    denormalise in K2's launch; on Liar's Dice a graph per minibatch, ``target_kl``'s
    path, whether or not the stop fires), the PopArt and controller series
    printed; then the graphed update against the eager one, the KL stop
    required there (``popart_update_graph_cases``), and whole train steps
    with both off and on in turns (``popart_turns``)."""
    n = POPART_UPDATES
    t0 = time.time()
    cartpole, series = train_phase(
        tmp / "popart_cartpole", ["--config", str(ROOT / "configs" / "cartpole.toml"),
                                  "--num-envs", str(E), "--num-steps", str(T), *POPART_FLAGS],
        n, E * T,
        {"cartpole_step_autoreset": n * T, "masked_gumbel_sample": n * T,
         "gae_reverse_scan": n, "obs_norm_apply": n * (T + 2), "obs_norm_update": n,
         "return_norm_finalize": n, "popart_update": n, "popart_denormalize": n},
        card_line)
    cartpole["series"] = popart_series(series, n, 2)
    pool = four_player_pool_train(
        tmp, card_line, "popart_liars_dice_pool",
        ["--config", str(ROOT / "configs" / "liars_dice_ctde.toml"), *POPART_FLAGS],
        "liars_dice_step_autoreset", T_LD, EP_LD, n, "ctde", LD_OBS,
        {"popart_update": n, "popart_denormalize": n})
    pool["series"] = popart_series(scalars(tmp / "popart_liars_dice_pool"), n, 49)
    for name, run in (("cartpole", cartpole), ("liars_dice_ctde_pool", pool)):
        for u in range(n):
            print(f"popart_entropy_train {name} update {u + 1}: "
                  + " ".join(f"{k}={v[u]!r}" for k, v in run["series"].items()), flush=True)
    return {"card": card_line, "cartpole": cartpole, "liars_dice_ctde_pool": pool,
            "update_graphs": phase_in_process(ROOT, "popart_update_graph_cases"),
            "train_step_turns": phase_in_process(ROOT, "popart_turns"),
            "seconds": time.time() - t0}


POPART_TURN_UPDATES = 4


def popart_turns(tmp: Path, card_line: str) -> dict:
    """Whole train steps through ``Trainer.update`` (rollout, update,
    fetch; on the vs-pool path against one checkpoint) with PopArt and the
    controller off and on, in turns (off, on, on, off) ``POPART_TURN_UPDATES``
    times, two trainers in this process after their warm updates:
    CartPole at 4096 x 128 and Liar's Dice CTDE against the pool at 4096 x
    128 (its KL stop makes the work vary: the minibatches run are kept
    beside each time). Host ms of each step, each ending synchronised."""
    out: dict = {"card": card_line}
    for name, toml, steps in (("cartpole", "cartpole.toml", T),
                              ("liars_dice_ctde_pool", "liars_dice_ctde.toml", T_LD)):
        trainers, steppers = {}, {}
        for key, over in (("off", {}), ("on", POPART_OVERRIDES)):
            cfg = Config.load(ROOT / "configs" / toml)
            for k, v in {"num_envs": E, "num_steps": steps, "seed": 0, **over}.items():
                setattr(cfg, k, v)
            tr = Trainer(cfg, tmp / f"{name}_{key}", quiet=True)
            trainers[key] = tr
            step = lambda tr=tr: tr.update(  # noqa: E731
                tr.cfg.learning_rate.get(0), tr.entropy_target(0) or tr.cfg.entropy_coef.get(0),
                tr.cfg.reward_shaping_coef.get(0))
            steppers[key] = step
            step()
            if tr.pool is not None:
                tr.global_step += 1
                tr.save_checkpoint()
                step()
        ms = {"off": [], "on": []}
        ran = {"off": [], "on": []}
        for _ in range(POPART_TURN_UPDATES):
            for key in ("off", "on", "on", "off"):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                m, _ = steppers[key]()
                torch.cuda.synchronize()
                ms[key].append((time.perf_counter() - t0) * 1e3)
                ran[key].append(m["num_minibatch_updates"])
        out[name] = {"train_step_ms": ms, "minibatches_run": ran,
                     "median_ms": {k: sorted(v)[len(v) // 2] for k, v in ms.items()}}
        del trainers, steppers
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# K14 and the front ends (eval, tournament)
# ---------------------------------------------------------------------------
EVAL_TEMPS = (0.0, 0.4, 1.0, 1e-3)


def temperature_case(dev, g, mask: torch.Tensor) -> dict:
    """K14 on the rows of an env's own mask (rows with a legal action):
    per-row temperatures mixed from 0, 0.4, 1 and 1e-3; every greedy row
    with two legal actions gets an exact tie at its top between two of
    them. The actions must equal the plain version's at every row."""
    mask = mask.contiguous()
    rows, A = mask.shape
    logits = torch.randn(rows, A, generator=g, device=dev) * 2
    temps = torch.tensor(EVAL_TEMPS, device=dev)[
        torch.randint(0, len(EVAL_TEMPS), (rows,), generator=g, device=dev)]
    # two legal columns of each row (legal ones rank first)
    two = torch.topk(mask + 0.5 * torch.rand(rows, A, generator=g, device=dev), 2, dim=1).indices
    tie = (temps == 0) & (mask.sum(1) >= 2)
    peak = (logits.max(1).values + 1.0)[:, None].expand(rows, 2)
    logits[tie.nonzero()[:, :1], two[tie]] = peak[tie]
    uni = torch.rand(rows, A, generator=g, device=dev).clamp_min(TINY)
    got = sample_with_temperature(logits, mask, temps, uni)
    torch.cuda.synchronize()
    want = sample_with_temperature_plain(logits, mask, temps, uni)
    if not torch.equal(got, want):
        bad = int((got != want).nonzero()[0, 0])
        raise AssertionError(f"temperature_sample [{rows}, {A}]: row {bad} took {int(got[bad])}, "
                             f"the plain version {int(want[bad])}")
    if not bool(torch.all(torch.gather(mask, 1, got.long()[:, None]) > 0)):
        raise AssertionError(f"temperature_sample [{rows}, {A}]: a masked action")
    if not torch.equal(got[tie].long(), two[tie].max(1).values):
        raise AssertionError(f"temperature_sample [{rows}, {A}]: a greedy tie not broken to the "
                             "last index")
    sampled = int((temps > 0).sum())
    return {
        "rows": rows, "greedy_rows": int((temps <= 0).sum()), "greedy_tie_rows": int(tie.sum()),
        "max_abs_err": 0.0, "tol": "exact (every row's action)",
        **timed(lambda: sample_with_temperature(logits, mask, temps, uni),
                lambda: sample_with_temperature_plain(logits, mask, temps, uni)),
        "library_ms": None,
        # logits, mask, temperatures, the sampled rows' uniforms, actions;
        # per sampled entry: mask add, divide, two logs, negations, add,
        # compare; per greedy entry: add, compare
        **bound(nbytes(logits, mask, temps, got) + sampled * A * 4,
                8.0 * sampled * A + 2.0 * (rows - sampled) * A),
    }


def check_temperature_sample(dev, g, c4_mask, skull_mask, ld_mask, ptxas: list) -> dict:
    """K14 at eval's shapes: one env (watch mode, human play) and the
    default 64 envs on Connect Four, Skull and Liar's Dice, Skull's 256
    envs of phase ``eval`` and Liar's Dice at 1024 rows."""
    def legal(m):
        return m[m.sum(1) > 0]

    cases = {"1x7": legal(c4_mask)[:1], "64x7": legal(c4_mask)[:64],
             "64x33": legal(skull_mask)[:64], "256x33": legal(skull_mask)[:256],
             "64x49": legal(ld_mask)[:64], "1024x49": legal(ld_mask)[:1024]}
    out = {name: temperature_case(dev, g, m) for name, m in cases.items()}
    ties = sum(c["greedy_tie_rows"] for c in out.values())
    if ties == 0 or min(c["greedy_tie_rows"] for n, c in out.items() if n != "1x7") == 0:
        raise AssertionError(f"temperature_sample: too few greedy rows with ties: "
                             f"{[c['greedy_tie_rows'] for c in out.values()]}")
    out.update({"greedy_tie_rows": ties, "max_abs_err": 0.0, "tol": "exact",
                "ptxas": kernel_ptxas(ptxas, "temperature_sample"),
                # phase eval's Skull shape stands for the kernel
                **{k: out["256x33"][k] for k in TIMES + ("library_ms", "bound_ms", "bound_by")}})
    return out


# The fused sample-and-step (K14's row code as the step's sampling front):
# checked at these env counts, timed at each env's eval shape (eval's
# default 64 envs; phase eval (b)'s 256 on Skull).
SAMPLE_STEP_SHAPES = (1, 64, 256, 4096)
SAMPLE_STEP_TIMED = {"cartpole": 64, "connect_four": 64, "skull": 256, "liars_dice": 64}
# Integer and f32 operations of one env's step (the bounds of K1, K4, K11
# and K13 above).
STEP_OPS = {"cartpole": 32.0, "connect_four": 300.0, "skull": 2000.0, "liars_dice": 1500.0}
SAMPLE_STEP_WALK = 12  # steps checked at each env count


def sample_step_env(dev, g, name: str, n: int) -> tuple:
    """(env, state, acc, draw) of ``n`` fresh envs (CartPole's on both
    sides of its thresholds); ``draw()`` gives a step's reset and step
    values."""
    empty = torch.empty(n, 0, device=dev)
    if name == "cartpole":
        state, acc, _, reset, _ = cartpole_inputs(dev, g, n)
        return CartPole(), state, acc, lambda: (reset, None)
    if name == "connect_four":
        env = ConnectFour()
        return env, env.reset(empty), EpisodeAccumulator.zero(n, 2, dev), lambda: (empty, None)
    if name == "skull":
        env = Skull(4)
        state = env.reset(empty)
        state.shaping_coef = (torch.arange(n, device=dev) % 2) * 0.05
        return env, state, EpisodeAccumulator.zero(n, 4, dev), lambda: (
            empty, torch.rand(n, generator=g, device=dev))
    env = LiarsDice()
    state = env.reset(torch.rand(n, 8, generator=g, device=dev))
    state = LiarsDiceState(state.ints, (torch.arange(n, device=dev) % 2) * 0.05)
    return env, state, EpisodeAccumulator.zero(n, 4, dev), lambda: (
        torch.rand(n, 8, generator=g, device=dev), torch.rand(n, 8, generator=g, device=dev))


def eval_front(dev, g, mask: torch.Tensor, step: int) -> tuple:
    """One eval step's sampling inputs on ``mask``'s rows: logits, per-row
    temperatures from 0, 0.4, 1 and 1e-3 (one float, 0.7, every fourth
    step), an exact tie at the top of every greedy row with two legal
    actions, and the uniforms. Returns (front, greedy tie rows, sampled
    rows)."""
    n, A = mask.shape
    logits = torch.randn(n, A, generator=g, device=dev) * 2
    temps = (0.7 if step % 4 == 3 else torch.tensor(EVAL_TEMPS, device=dev)[
        torch.randint(0, len(EVAL_TEMPS), (n,), generator=g, device=dev)])
    per_row = temps if isinstance(temps, torch.Tensor) else torch.full((n,), temps, device=dev)
    two = torch.topk(mask + 0.5 * torch.rand(n, A, generator=g, device=dev), 2, dim=1).indices
    tie = (per_row <= 0) & (mask.sum(1) >= 2)
    peak = (logits.max(1).values + 1.0)[:, None].expand(n, 2)
    logits[tie.nonzero()[:, :1], two[tie]] = peak[tie]
    uni = torch.rand(n, A, generator=g, device=dev).clamp_min(TINY)
    return TemperatureFront(logits, mask, temps, uni), int(tie.sum()), int((per_row > 0).sum())


def step_outputs_differ(name: str, k, p) -> list:
    """The outputs of two steps that differ, every one bit for bit
    (CartPole's physics rows and obs among them)."""
    if name != "cartpole":
        return step_differences(k, p)
    pairs = {"phys": (k.state.phys, p.state.phys), "step_idx": (k.state.step_idx, p.state.step_idx),
             "obs": (k.obs, p.obs), "mask": (k.mask, p.mask), "rewards": (k.rewards, p.rewards),
             "done": (k.done, p.done), "acc.reward_sum": (k.acc.reward_sum, p.acc.reward_sum),
             "acc.length": (k.acc.length, p.acc.length),
             **{f"log.{f}": (getattr(k.log, f), getattr(p.log, f))
                for f in ("completed", "total_rewards", "length", "outcome", "active_players")}}
    return [n for n, (a, b) in pairs.items() if a.dtype != b.dtype or not torch.equal(a, b)]


def sample_front_err(name: str, k, p) -> tuple:
    """The fused step ``k`` against the plain sample then the plain step
    ``p``: (the outputs that differ, the max abs error). Bit for bit,
    CartPole's physics and obs to K1's 1e-5 (sinf/cosf and fma contraction
    against torch's), its other outputs exact."""
    if name != "cartpole":
        bad = step_differences(k, p)
        return bad, 0.0
    err = max_err([(k.state.phys, p.state.phys), (k.obs, p.obs)])
    bad = [f for f in step_outputs_differ(name, k, p) if f not in ("phys", "obs")]
    return bad + (["phys or obs beyond 1e-5"] if err > 1e-5 else []), err


def check_sample_steps(dev, g, ptxas: list) -> dict:
    """Each env's step with K14's row code as its sampling front (eval's
    one launch a step: the step wrapper given a ``front``) against K14
    then the step kernel (the two launches it replaces) and against the
    plain sample then the plain step on the same inputs: at E = 1, 64, 256
    and 4096, along a walk of ``SAMPLE_STEP_WALK`` steps from fresh envs,
    the actions and every output bit for bit (against the plain step
    CartPole's physics and obs to K1's 1e-5, its max abs error reported),
    greedy ties and finished games counted. Timed at the env's eval shape
    beside its plain version (the plain sample, then the plain step), in
    turns with K14 + the step (``k14_then_step``). Keyed by the env step's
    wrapper."""
    out = {}
    for name in ("cartpole", "connect_four", "skull", "liars_dice"):
        res: dict = {"max_abs_err": 0.0,
                     "tol": "exact (actions and every output; against the plain step "
                            "CartPole's physics and obs to 1e-5)",
                     "ptxas": kernel_ptxas(ptxas, f"{name}_sample_step"), "shapes": {}}
        wrapper = WRAPPERS[f"{name}_step_autoreset"]
        for n in SAMPLE_STEP_SHAPES:
            env, state, acc, draw = sample_step_env(dev, g, name, n)
            mask, ev = env.action_mask(state), {"greedy_ties": 0, "done": 0}
            for step in range(SAMPLE_STEP_WALK):
                front, ties, sampled = eval_front(dev, g, mask, step)
                reset, u = draw()
                before = (wrapper.launches, sample_with_temperature.launches)
                k = env.step_autoreset(state, acc, None, reset, u, front=front)
                if (wrapper.launches, sample_with_temperature.launches) != (before[0] + 1,
                                                                           before[1]):
                    raise AssertionError(f"{name} step with its front: not one launch of its own")
                want = sample_with_temperature(*front)
                p = env.step_autoreset(state, acc, want, reset, u)
                plain = autoreset_step(env, state, acc, None, reset, u, front=front)
                torch.cuda.synchronize()
                bad = step_outputs_differ(name, k, p)
                if bad or not torch.equal(k.actions, want):
                    raise AssertionError(f"{name} step with its front E={n} step {step}: actions "
                                         f"equal {torch.equal(k.actions, want)}, {bad} differ "
                                         "from K14 then the step")
                bad, err = sample_front_err(name, k, plain)
                if bad or not torch.equal(k.actions, plain.actions):
                    raise AssertionError(f"{name} step with its front E={n} step {step}: actions "
                                         f"equal {torch.equal(k.actions, plain.actions)}, {bad} "
                                         f"differ from the plain sample then the plain step "
                                         f"(max abs err {err})")
                res["max_abs_err"] = max(res["max_abs_err"], err)
                ev["greedy_ties"] += ties
                ev["done"] += int(p.done.sum())
                last = (env, state, acc, front, reset, u, k, sampled)
                state, acc, mask = p.state, p.acc, p.mask
            res["shapes"][f"E{n}"] = ev
            if n == SAMPLE_STEP_TIMED[name]:
                timed_at = last
        if sum(ev["greedy_ties"] for ev in res["shapes"].values()) == 0 or (
                name in ("cartpole", "connect_four") and res["shapes"]["E256"]["done"] == 0):
            raise AssertionError(f"{name} step with its front: a case was not reached: "
                                 f"{res['shapes']}")
        env, s, a, front, reset, u, k, sampled = timed_at
        n, A = front.logits.shape

        def fused():
            return env.step_autoreset(s, a, None, reset, u, front=front)

        def two():
            return env.step_autoreset(s, a, sample_with_temperature(*front), reset, u)

        def plain():
            return autoreset_step(env, s, a, None, reset, u, front=front)

        pad = pad_bytes(s) if hasattr(s, "PAD_COL") else 0
        temps = front.temperature if isinstance(front.temperature, torch.Tensor) else None
        # the front's logits, mask, temperatures and the sampled rows'
        # uniforms, the actions; the step's state, accumulators, step
        # values and outputs (CartPole's reset rows where an episode ends)
        moved = (nbytes(front.logits, front.mask, temps, s, a, u, k) - pad
                 + 4 * sampled * A + (16 * int(k.done.sum()) if name == "cartpole" else 0))
        res.update(timed(fused, plain), library_ms=None, timed_envs=n,
                   **bound(moved, 8.0 * sampled * A + 2.0 * (n - sampled) * A
                           + STEP_OPS[name] * n),
                   k14_then_step_turns=turns(fused, two, who="k14_then_step"))
        out[f"{name}_step_autoreset"] = res
    return out


def check_sample_popart_epilogue(dev, g) -> dict:
    """K2 with its value epilogue (PopArt's denormalisation of the step's
    values into a slice of the rollout's) against K2 without it then K16
    into the same slice: actions, log-probs and values bit for bit, the
    slices beside it untouched; the values also against
    ``popart_denormalize_plain``, bit for bit; PopArt's count 0, 1, 2 and 5000, at the
    rollout's [4096, 2] (CartPole) and [4096, 49] (Liar's Dice) and the
    learner rows of a vs-pool step; timed at count 5000 in turns with K2 +
    K16."""
    out = {}
    for rows, A in ((E, 2), (E, 49)):
        case: dict = {"counts": []}
        for count in (0, 1, 2, 5000):
            logits = torch.randn(rows, A, generator=g, device=dev) * 2
            mask = (torch.rand(rows, A, generator=g, device=dev) < 0.6).float()
            mask[:, 0] = 1.0
            u = torch.rand(rows, A, generator=g, device=dev).clamp_min(TINY)
            values = torch.randn(rows, generator=g, device=dev) * 3
            state = PopArtState.create(dev)
            state.mean.fill_(2.5 if count else 0.0)
            state.m2.fill_(90.0 * count)
            state.count.fill_(float(count))
            buf = torch.full((3, rows), -7.0, device=dev)
            a, lp = masked_sample(logits, mask, u, popart=state, values=values, values_out=buf[1])
            a2, lp2 = masked_sample(logits, mask, u)
            want = torch.empty(rows, device=dev)
            popart_denormalize(state, values, out=want)
            plain = popart_denormalize_plain(state, values)
            torch.cuda.synchronize()
            same = (torch.equal(a, a2) and torch.equal(lp, lp2) and torch.equal(buf[1], want)
                    and bool((buf[0] == -7.0).all()) and bool((buf[2] == -7.0).all()))
            if not same:
                raise AssertionError(f"masked_gumbel_sample with the epilogue [{rows}, {A}] at "
                                     f"count {count}: not K2 then K16 bit for bit")
            if not torch.equal(buf[1], plain):
                raise AssertionError(f"masked_gumbel_sample with the epilogue [{rows}, {A}] at "
                                     f"count {count}: values not popart_denormalize_plain's bit "
                                     f"for bit (max abs err {max_err([(buf[1], plain)])})")
            case["counts"].append(count)

        def fused(state=state):
            return masked_sample(logits, mask, u, popart=state, values=values, values_out=buf[1])

        def two(state=state):
            masked_sample(logits, mask, u)
            return popart_denormalize(state, values, out=buf[1])

        case.update(tol="exact", k2_then_k16_turns=turns(fused, two, who="k2_then_k16"),
                    # logits, mask, uniforms, values and the three stats
                    # read; actions, log-probs and values written
                    **bound(4 * (3 * rows * A + 2 * rows + 3) + 8 * rows, 8.0 * rows * A))
        out[f"{rows}x{A}"] = case
    return out


# K17's schedules: constant (Skull, Liar's Dice), Connect Four's cutoff at
# move 10, two decays; moves drawn from [0, 70) cross every cutoff.
K17_SCHEDULES = (TempSchedule(initial=0.7), TempSchedule(initial=0.4, final_temp=0.0, cutoff=10),
                 TempSchedule(initial=1.5, final_temp=0.25, cutoff=7, decay=True),
                 TempSchedule(initial=1.0, final_temp=0.3, cutoff=13, decay=True))


def eval_step_inputs(dev, g, E: int, P: int) -> dict:
    """One eval step's seating and records: the seat maps of P + 1 sources
    (one Random), the player a strided column of a packed-like [E, 27]
    buffer (as Skull's), a quarter of the envs done (the step's done is its
    log's completed, one buffer)."""
    perms = torch.from_numpy(seat_maps(P + 1, P)).to(dev)
    ints = torch.randint(0, P, (E, 27), generator=g, device=dev, dtype=torch.int32)
    done = (torch.rand(E, generator=g, device=dev) < 0.25).float()
    return dict(
        perm_table=perms,
        perm_idx=torch.randint(0, perms.shape[0], (E,), generator=g, device=dev, dtype=torch.int32),
        player=ints[:, 5],
        slot_of_source=torch.tensor([0, -1] + list(range(1, P)), dtype=torch.int32, device=dev),
        move_count=torch.randint(0, 70, (E,), generator=g, device=dev, dtype=torch.int32),
        done=done,
        log=EpisodeLog(completed=done, total_rewards=torch.randn(E, P, generator=g, device=dev),
                       length=torch.zeros(E, dtype=torch.int32, device=dev),
                       outcome=torch.randint(0, P + 1, (E, P), generator=g, device=dev,
                                             dtype=torch.int32),
                       active_players=torch.zeros(E, dtype=torch.int32, device=dev)))


# K17's launches in a chunk: the seat half alone before the first step,
# both halves after each step but the last, the record half alone after it.
K17_HALVES = ("seats", "both", "records")
K17_DEVICE = {"seats": "sample_seats", "both": "record_and_seat", "records": "record_step"}


def books_buffers(x: dict) -> dict:
    """K17's outputs for ``eval_step_inputs``: a two-row log, the counts
    and permutations copied, the seat and temperature scratch."""
    E, P = x["log"].outcome.shape
    dev = x["done"].device
    return dict(log=ChunkLog.create(2, E, P, dev), pi=x["perm_idx"].clone(),
                mc=x["move_count"].clone(),
                slot=torch.full((E,), 99, dtype=torch.int32, device=dev),
                temps=torch.full((E,), -1.0, device=dev))


def books_call(x: dict, temp: TempSchedule, fn=step_books, halves: str = "both",
               b: dict | None = None) -> list:
    """K17 (or its plain version) on ``x``: the seat half alone, the
    record half alone (row 1 of the log), or both (``K17_HALVES``), into
    ``b`` (new buffers when None): every output."""
    b = books_buffers(x) if b is None else b
    records = None if halves == "seats" else Records(b["log"], 1, x["log"])
    seats = None if halves == "records" else Seats(x["player"], x["slot_of_source"], temp,
                                                   b["slot"], b["temps"])
    fn(x["perm_table"], b["pi"], b["mc"], records, seats)
    log = b["log"]
    return [b["pi"], b["mc"], b["slot"], b["temps"], log.completed, log.outcome,
            log.total_rewards, log.perm]


def check_eval_step(dev, g, ptxas: list) -> dict:
    """K17 (``step_books``, one C entry) against its plain version, every
    output bit for bit, at E = 1, 64, 256 and 4096 and P = 2 and 4, under
    the constant, cutoff and two decay schedules (moves crossing each
    cutoff; a Random seat), each half alone (a chunk's first and last
    step) and both in one launch (the records of a step, then the next
    step's seats), also with a large seat table (8 sources, 1680 seat
    maps at P = 4). Timed at phase eval (b)'s shape, 256 envs of four
    players, with the bytes bound of what these inputs need (each
    perm-table entry and source read once); the fused launch in turns
    against the two halves launched one after the other."""
    out: dict = {"shapes": [], "halves": {}}
    for E in (1, 64, 256, 4096):
        for P in (2, 4):
            x = eval_step_inputs(dev, g, E, P)
            random_rows = crossed = 0
            for temp in K17_SCHEDULES:
                for halves in K17_HALVES:
                    k = books_call(x, temp, halves=halves)
                    p = books_call(x, temp, step_books_plain, halves)
                    torch.cuda.synchronize()
                    if not all(torch.equal(a, b) for a, b in zip(k, p)):
                        raise AssertionError(f"step_books ({halves}) [{E}, {P}] {temp}: "
                                             "differs from plain")
                    if halves == "seats":
                        random_rows = int((k[2] == -1).sum())
                if temp.cutoff is not None:
                    crossed += int((x["move_count"] >= temp.cutoff).sum())
            out["shapes"].append({"E": E, "P": P, "random_rows": random_rows,
                                  "rows_past_cutoff": crossed, "done": int(x["done"].sum())})
    if not sum(c["random_rows"] for c in out["shapes"]) or not sum(
            c["rows_past_cutoff"] for c in out["shapes"]):
        raise AssertionError(f"step_books: no Random seat or no move past a cutoff: {out}")
    # A large seat table: 8 sources in 4 seats.
    x = eval_step_inputs(dev, g, 256, 4)
    x["perm_table"] = torch.from_numpy(seat_maps(8, 4)).to(dev)
    x["perm_idx"] = torch.randint(0, x["perm_table"].shape[0], (256,), generator=g, device=dev,
                                  dtype=torch.int32)
    x["slot_of_source"] = torch.tensor([0, -1, 1, 2, -1, 3, 4, 5], dtype=torch.int32, device=dev)
    for temp in K17_SCHEDULES:
        for halves in ("seats", "both"):
            if not all(torch.equal(a, b) for a, b in zip(
                    books_call(x, temp, halves=halves),
                    books_call(x, temp, step_books_plain, halves))):
                raise AssertionError(f"step_books ({halves}), 1680 seat maps, {temp}: differs "
                                     "from plain")
    out["large_table"] = {"n_perms": x["perm_table"].shape[0], "P": 4, "bit_for_bit": True}
    E, P = 256, 4
    x = eval_step_inputs(dev, g, E, P)
    temp = K17_SCHEDULES[1]
    entries = torch.unique(x["perm_idx"].long() * P + x["player"].long()).numel()
    sources = torch.unique(x["perm_table"].flatten()[
        x["perm_idx"].long() * P + x["player"].long()]).numel()
    # reads: completed (the step's done), outcome, totals, perm_idx, moves;
    # writes: the log row's four, perm_idx, moves
    record_bytes = 4 * (3 * E + 2 * E * P) + 4 * (4 * E + 2 * E * P)
    nbytes_ = {
        "seats": 4 * (5 * E + entries + sources),  # perm_idx, player, moves, slot, temp
        "records": record_bytes,
        # the records' reads and writes, then the player read and the slot
        # and temperature written (the counts and permutations stay in
        # registers)
        "both": record_bytes + 4 * (3 * E + entries + sources),
    }
    bufs = {h: books_buffers(x) for h in K17_HALVES}
    plain_bufs = {h: books_buffers(x) for h in K17_HALVES}
    for halves in K17_HALVES:
        out["halves"][halves] = {
            "device_kernel": f"{K17_DEVICE[halves]}_kernel",
            **timed(lambda h=halves: books_call(x, temp, halves=h, b=bufs[h]),
                    lambda h=halves: books_call(x, temp, step_books_plain, h, plain_bufs[h])),
            **bound(nbytes_[halves]), "ptxas": kernel_ptxas(ptxas, K17_DEVICE[halves])}
    both = out["halves"]["both"]
    out.update({k: both[k] for k in both if k not in ("device_kernel", "ptxas")},
               shape=[E, P], max_abs_err=0.0, tol="exact", library_ms=None,
               launches_per_chunk=k17_per_chunk())
    log = ChunkLog.create(64, E, P, dev)
    pk = {k: x[k].clone() for k in ("perm_idx", "move_count")}
    slot_b, temps_b = bufs["seats"]["slot"], bufs["seats"]["temps"]

    def pair():
        """The records of a step, then the next seat pass: two launches of
        this tree's halves alone."""
        step_books(x["perm_table"], pk["perm_idx"], pk["move_count"], Records(log, 0, x["log"]))
        step_books(x["perm_table"], pk["perm_idx"], pk["move_count"],
                   seats=Seats(x["player"], x["slot_of_source"], temp, slot_b, temps_b))

    def fused():
        books_call(x, temp, b=bufs["both"])

    out["pair_turns"] = turns(fused, pair, "pair")
    return {"step_books": out}


GAUNTLET = ROOT / "gauntlet"
C4_GREEDY = ["--temp", "0", "--temp-cutoff", "10", "--temp-final", "0"]
# Each eval kernel's device name (the profiler's), for the counts in one chunk.
# A chunk's env step samples in its own launch: every launch of the step
# wrapper is the kernel's instance with the sampling front, and the
# instance without it (no wrapper's count: any launch fails) and K14 must
# read 0 in a replay.
EVAL_KERNELS = {
    "connect_four_step_autoreset": "connect_four_sample_step_kernel",
    "skull_step_autoreset": "skull_sample_step_kernel",
    "connect_four_step_autoreset without its front": "connect_four_step_autoreset_kernel",
    "skull_step_autoreset without its front": "skull_step_autoreset_kernel",
    "opponent_actor_forward": "opponent_mlp_kernel",
    "temperature_sample": "temperature_sample_kernel",
    # K17's three kernels, one a kind of launch (csrc/eval_step.cu)
    "step_books": "(?:sample_seats|record_and_seat|record_step)_kernel",
}


def front_end_run(argv: list, expect: set) -> dict:
    """``cli.main(argv)`` on the card with every launch counter and the
    eval graphs' counts at 0 just before it and read just after: the
    kernels of ``expect`` must each launch, and no other. A stats run's
    chunks are graph replays: its launches are the wrappers' (the graphs'
    warm-ups; no other eager launch allowed) plus each graph's captured
    launches times its replays; ``main_path`` leaves the warm-ups out.
    Keeps what ``eval.run_stats_mode`` returned and the printed text."""
    import contextlib
    import io

    import burn_ppo_torch.eval as ev
    from burn_ppo_torch import cli

    stats = []
    real = ev.run_stats_mode
    ev.run_stats_mode = lambda *a, **k: stats.append(real(*a, **k)) or stats[-1]
    for w in WRAPPERS.values():
        w.launches = 0
    EvalGraph.reset_counts()
    buf = io.StringIO()
    t0 = time.time()
    try:
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
        torch.cuda.synchronize()
    finally:
        ev.run_stats_mode = real
    wall = time.time() - t0
    eager = {name: w.launches for name, w in WRAPPERS.items()}
    graphed = {name: EvalGraph.launches.get(w, 0) for name, w in WRAPPERS.items()}
    warmup = {name: EvalGraph.warmup_launches.get(w, 0) for name, w in WRAPPERS.items()}
    launches = {name: eager[name] + graphed[name] for name in WRAPPERS
                if eager[name] + graphed[name]}
    if rc != 0:
        raise RuntimeError(f"{' '.join(argv[:2])} exited {rc}:\n{buf.getvalue()[-2000:]}")
    if set(launches) != expect:
        raise AssertionError(f"{' '.join(argv)}: kernels launched {launches}, expected each of "
                             f"{sorted(expect)} and no other")
    if EvalGraph.captures and eager != warmup:
        raise AssertionError(f"{' '.join(argv)}: eager launches {eager} beyond the graphs' "
                             f"warm-ups {warmup}")
    return {"wall_s": wall, "launches": launches, "stats": stats, "text": buf.getvalue(),
            "main_path": {name: eager[name] - warmup[name] + graphed[name] for name in launches},
            "graph_captures": EvalGraph.captures, "graph_replays": EvalGraph.replays}


def k17_per_chunk(steps: int = 64) -> int:
    """K17's launches in a chunk of ``steps``: the seat half before the
    first step, both halves after each step but the last, the record half
    after the last (steps + 1 in all)."""
    return steps + 1


def check_chunk_launches(name: str, run: dict, step_kernel: str, steps_per_chunk: int = 64):
    """A stats run's main path: one graph replay a chunk, the env step with
    K14's sampling front (``step_kernel``) once a step of each replayed
    chunk and K14 alone never, K17 steps + 1 times a chunk."""
    m, chunks = run["main_path"], run["graph_replays"]
    want = {step_kernel: chunks * steps_per_chunk, "temperature_sample": None,
            "step_books": chunks * k17_per_chunk(steps_per_chunk)}
    if {k: m.get(k) for k in want} != want or chunks < 1:
        raise AssertionError(f"{name}: main-path launches {m}, {chunks} replays: want {want}")


def valid_placements(records: list) -> bool:
    """Every game's placements a competition ranking: each seat's place is
    one more than the seats placed strictly better."""
    return all(p == 1 + sum(q < p for _, q in rec) for rec in records for _, p in rec)


def first_divergence(sources_gpu, sources_cpu, temp, num_envs: int, steps: int) -> dict:
    """The first step where the card's and the CPU's greedy eval engines
    pick another action: the row and the top-two gap of its masked logits
    on the CPU."""
    import burn_ppo_torch.eval as ev

    env = make_env("connect_four")
    engines = [ev.StatsEngine(env, srcs, num_envs, temp, ev.random_source(0, d), d)
               for srcs, d in ((sources_gpu, resolve_device("cuda")),
                               (sources_cpu, torch.device("cpu")))]
    carries = [e.carry for e in engines]
    with torch.no_grad():
        for e, c in zip(engines, carries):
            e.seat(c)
        for t in range(steps):
            picks = []
            for e, c in zip(engines, carries):
                logits = e.logits.forward_slots(c.obs, e.slot)
                half = torch.full_like(logits, 0.5)
                picks.append((apply_action_mask(logits, c.mask).cpu(),
                              sample_with_temperature(logits, c.mask, 0.0, half).cpu()))
            rows = picks[0][1] != picks[1][1]
            if bool(rows.any()):
                r = int(rows.nonzero()[0, 0])
                top = torch.topk(picks[1][0][r], 2).values
                scale = float(picks[1][0][r].abs().max())
                return {"step": t, "row": r, "top_two_gap": float(top[0] - top[1]),
                        "k7_tol": 2 * (1e-4 + 1e-4 * scale)}
            carries = [e.step(c, 0) for e, c in zip(engines, carries)]  # seats the next step
    return {"step": None}


def seeded_cnn(dev):
    """A Connect Four CNN player (``configs/connect_four.toml`` with
    ``network_type = "cnn"``), its weights random from a seed: eval's
    per-model path through cuDNN."""
    import burn_ppo_torch.eval as ev

    cfg = Config.load(ROOT / "configs" / "connect_four.toml").apply_overrides(
        {"network_type": "cnn"})
    net = build_network_for_env(make_env("connect_four"), cfg, torch.Generator().manual_seed(5))
    return ev.PlayerSource(kind="checkpoint", name="cnn", network=net.to(dev).requires_grad_(False))


def engine_outputs(engine) -> list:
    """A chunk's log, the carry and the generator's state, copied."""
    return ([x.clone() for x in state_leaves(engine.log) + state_leaves(engine.carry)]
            + [engine.rng.generator.get_state()])


def replay_equals_eager(engine, chunks: int = 2) -> dict:
    """From one saved carry and generator state, ``chunks`` graph replays
    and as many eager chunks: every log array of every chunk, the final
    carry and the generator bit for bit."""
    if engine.graph is None:
        engine.run_chunk()  # the capture
    carry = [t.clone() for t in state_leaves(engine.carry)]
    gen = engine.rng.generator.get_state()
    runs, games = [], []
    for run in (engine.run_chunk, engine.eager_chunk):
        for t, s in zip(state_leaves(engine.carry), carry):
            t.copy_(s)
        engine.rng.generator.set_state(gen)
        outs, done = [], 0
        for _ in range(chunks):
            run()
            done += int(engine.log.completed.sum())
            outs += engine_outputs(engine)
        torch.cuda.synchronize()
        runs.append(outs)
        games.append(done)
    same = len(runs[0]) == len(runs[1]) and all(
        a.dtype == b.dtype and torch.equal(a.cpu(), b.cpu()) for a, b in zip(*runs))
    if not same:
        raise AssertionError(f"the graphed chunk ({engine.logits.path}) differs from the eager "
                             "chunk from the same carry and generator state")
    return {"path": engine.logits.path, "envs": engine.num_envs, "chunks": chunks,
            "games_completed": games[0], "bit_for_bit": True}


def chunk_turns(engine, reps: int = 2) -> dict:
    """One chunk as a graph replay and eagerly, in turns (graph, eager,
    eager, graph, ...): events ms each; then one profiled chunk of each:
    the device's busy ms (the kernels' and copies' time), and the idle
    share 1 - busy / events median."""
    def events(fn) -> float:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    engine.run_chunk()
    engine.eager_chunk()
    torch.cuda.synchronize()
    times: dict = {"graph": [], "eager": []}
    for _ in range(reps):
        for mode in ("graph", "eager", "eager", "graph"):
            times[mode].append(events(engine.run_chunk if mode == "graph" else engine.eager_chunk))
    act = torch.profiler.ProfilerActivity
    out: dict = {}
    for mode, fn in (("graph", engine.run_chunk), ("eager", engine.eager_chunk)):
        with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        busy = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
        med = sorted(times[mode])[len(times[mode]) // 2]
        out[mode] = {"events_ms": times[mode], "events_ms_median": med, "device_ms": busy,
                     "idle_share": 1.0 - busy / med if busy else None}
    return out


def chunk_bound(engine) -> dict:
    """The least time of one stacked-model chunk, as row B8's rollout bound:
    each step's kernels' bounds (the env step with its sampling front, the
    uniforms, K17's fused pass) plus the actor forwards of the rows a model plays (K7's
    towers) at the f32 rate, all from one step of this engine's carry
    (its seats, temperatures and env state), times its steps."""
    env, c, E = engine.env, engine.carry, engine.num_envs
    A, P, dev = env.spec.num_actions, env.spec.num_players, c.obs.device
    stack = engine.logits.stack
    rng = TorchRandomSource(torch.Generator(device=dev).manual_seed(0))
    with torch.no_grad():
        engine.seat(c)
        rows, sampled = int((engine.slot >= 0).sum()), int((engine.temps > 0).sum())
        action = torch.argmax(c.mask, 1).to(torch.int32)
        u = env.draw_step(rng, E)
        out = env.step_autoreset(c.states, c.acc, action, env.draw_reset(rng, E), u)
    pad = pad_bytes(c.states) if hasattr(c.states, "PAD_COL") else 0
    step = bound(nbytes(c.states, c.acc, action, u, out) - pad, 2000.0 * E)["bound_ms"]
    per_step = {
        "env_step": step,
        "uniforms": bound(4 * E * A)["bound_ms"],
        # the sampling front's logits, mask and uniforms of the sampled
        # rows and its actions (in the env step's launch)
        "sampling_front": bound(4 * (3 * sampled * A + E))["bound_ms"],
        # the records' reads and writes and the seats' player, slot and
        # temperature (the tables' few entries left out)
        "step_books": bound(4 * (7 * E + 4 * E * P) + 4 * 3 * E)["bound_ms"],
    }
    flops = rows * sum(2.0 * w.shape[1] * w.shape[2] for w in stack.weights)
    kernels_ms = sum(per_step.values()) * engine.chunk_steps
    forward_ms = flops * engine.chunk_steps / F32_FLOP_PER_S * 1e3
    return {"bound_ms": kernels_ms + forward_ms,
            "bound_by": "operations" if forward_ms > kernels_ms else "bytes",
            "bound_kernels_ms": kernels_ms, "forward_flops_per_step": flops,
            "model_rows": rows, "per_step_ms": per_step}


def games_per_s_turns(env, sources, games: int, num_envs: int) -> dict:
    """``run_stats_mode`` (a new engine each run: capture included) graphed
    and with its chunks run eagerly (``StatsEngine.run_chunk`` switched to
    ``eager_chunk`` for the run), in turns; games/s of each run."""
    import burn_ppo_torch.eval as ev

    out: dict = {"graph": [], "eager": []}
    real = ev.StatsEngine.run_chunk
    for mode in ("graph", "eager", "eager", "graph"):
        if mode == "eager":
            ev.StatsEngine.run_chunk = ev.StatsEngine.eager_chunk
        try:
            t0 = time.time()
            st = ev.run_stats_mode(env, sources, games, num_envs=num_envs, seed=0, quiet=True)
            torch.cuda.synchronize()
            out[mode].append(st.total_games / (time.time() - t0))
        finally:
            ev.StatsEngine.run_chunk = real
    return out


def eval_phase(tmp: Path, card_line: str) -> dict:
    """Phase ``eval`` (a process of its own, with phase ``tournament``):
    the eval command through ``cli.main`` on the card, every chunk one
    CUDA graph replay. (a)
    Connect Four r4 against r4_mid, greedy, 256 games x 64 envs: K4 with
    K14's sampling front and K7 once a step of every replayed chunk (K14
    alone never), K17 once a step and once more;
    the game records equal to the port's CPU run of the same command
    (every game is deterministic). (b) Skull r4, r4_best and r4_mid (CTDE
    512x2 tanh, obs norm: three stacked K7 slots) and Random, 1024 games x
    256 envs at the env's temperature: K11 with the sampling front, K7
    and K17; valid
    placements in every game; one chunk graphed and eager in turns
    (events and device ms, the idle share), games/s both ways in turns,
    the kernels counted on the device in one replay against those the
    graph captured (K14 and K11 without the front 0). (c) from one saved
    carry and generator state, two
    graph replays against two eager chunks bit for bit: Connect Four
    greedy (stacked), Skull three models and Random (stacked), Connect
    Four r4 and Random (single), Skull r4, r4_flagship and two Random
    (per_model, the CTDE 512x2 with obs norm and 256x3 without), a seeded
    Connect Four CNN beside r4 (per_model through cuDNN) and two Random
    (random). (d) one
    watched greedy Connect Four game and one watched Skull game: K4 or
    K11, K14 and K6 (each model move's obs norm) at E = 1, counted, eager;
    then K4, K11 and K14 at E = 1 against their plain versions along
    single-env games, and a watched game of each env to its end, its last
    position the plain step's (``watch_terminal_checks``). (e) CartPole,
    a Random player's 256 games at 64 envs: K1 with the sampling front
    once a step."""
    import burn_ppo_torch.eval as ev

    dev = resolve_device("cuda")
    out: dict = {"card": card_line}
    t_phase = time.time()
    c4 = [GAUNTLET / "connect_four" / "r4", GAUNTLET / "connect_four" / "r4_mid"]
    greedy = ev.TempSchedule(initial=0.0, final_temp=0.0, cutoff=10)

    # (a)
    t_part = time.time()
    run = front_end_run(["eval", "-c", str(c4[0]), "-c", str(c4[1]), *C4_GREEDY, "-n", "256",
                         "--num-envs", "64", "--seed", "0"],
                        {"connect_four_step_autoreset", "opponent_actor_forward", "step_books"})
    (gpu,) = run["stats"]
    check_chunk_launches("eval (a)", run, "connect_four_step_autoreset")
    L, steps = run["launches"], run["main_path"]["connect_four_step_autoreset"]
    if not (run["main_path"]["opponent_actor_forward"] == steps and gpu.logits_path == "stacked"
            and run["graph_captures"] == 1):
        raise AssertionError(f"eval (a): launches {L}, logits {gpu.logits_path}")
    t0 = time.time()
    cpu_sources = [ev.PlayerSource.checkpoint(p, "cpu") for p in c4]
    cpu = ev.run_stats_mode(make_env("connect_four"), cpu_sources, 256, num_envs=64, temp=greedy,
                            seed=0, quiet=True, device="cpu")
    same = (gpu.game_records == cpu.game_records and gpu.placements == cpu.placements
            and gpu.rewards == cpu.rewards and gpu.draws == cpu.draws)
    diverge = None
    if not same:
        diverge = first_divergence([ev.PlayerSource.checkpoint(p, dev) for p in c4], cpu_sources,
                                   greedy, 64, steps)
        if diverge["step"] is None or not diverge["top_two_gap"] <= diverge["k7_tol"]:
            raise AssertionError(f"eval (a): the card's games differ from the CPU's: {diverge}")
    out["connect_four_greedy"] = {
        "games": gpu.total_games, "draws": gpu.draws, "steps": steps, "wall_s": run["wall_s"],
        "games_per_s": gpu.total_games / run["wall_s"], "launches": L,
        "main_path_launches": run["main_path"], "graph_captures": run["graph_captures"],
        "graph_replays": run["graph_replays"], "records_equal_cpu_run": same,
        "first_divergence": diverge, "cpu_run_s": time.time() - t0, "summary": gpu.summary_rows(),
        "seconds": time.time() - t_part}

    # (b)
    t_part = time.time()
    skull = [GAUNTLET / "skull" / n for n in ("r4", "r4_best", "r4_mid")]
    argv = ["eval", *[x for p in skull for x in ("-c", str(p))], "--random", "-n", "1024",
            "--num-envs", "256", "--seed", "0"]
    run = front_end_run(argv, {"skull_step_autoreset", "opponent_actor_forward", "step_books"})
    (st,) = run["stats"]
    check_chunk_launches("eval (b)", run, "skull_step_autoreset")
    L = run["launches"]
    if not (run["main_path"]["opponent_actor_forward"] == run["main_path"]["skull_step_autoreset"]
            and st.logits_path == "stacked" and st.total_games == 1024):
        raise AssertionError(f"eval (b): launches {L}, logits {st.logits_path}, "
                             f"{st.total_games} games")
    if not valid_placements(st.game_records):
        raise AssertionError("eval (b): a game's placements are not a ranking")
    sources = [ev.PlayerSource.checkpoint(p, dev) for p in skull] + [ev.PlayerSource.random()]
    env = make_env("skull")
    engine = ev.StatsEngine(env, sources, 256, ev.default_temp(env), ev.random_source(1, dev), dev)
    chunk = chunk_turns(engine)
    counts = replay_kernel_counts(engine.graph, EVAL_KERNELS)
    k17 = counts["counts"]["step_books"][0]
    fused = counts["counts"]["skull_step_autoreset"][0]
    # kernels that a replay must not launch: K14 alone, the step without
    # its front (a device launch of either beyond the 0 captured fails in
    # replay_kernel_counts)
    absent = {k: counts["counts"].get(k, [0, 0])[0]
              for k in ("temperature_sample", "skull_step_autoreset without its front")}
    if k17 != k17_per_chunk() or fused != 64 or any(absent.values()):
        raise AssertionError(f"eval (b): in one replay K17 {k17} (want {k17_per_chunk()}), the "
                             f"fused step {fused} (want 64), {absent} (want 0)")
    chunk["k17_launches_in_one_replay"] = k17
    chunk["sample_step_launches_in_one_replay"] = fused
    chunk["k14_launches_in_one_replay"] = absent["temperature_sample"]
    chunk["bound"] = chunk_bound(engine)
    out["skull_three_models_and_random"] = {
        "games": st.total_games, "steps": run["main_path"]["skull_step_autoreset"],
        "wall_s": run["wall_s"], "games_per_s": st.total_games / run["wall_s"], "launches": L,
        "main_path_launches": run["main_path"], "graph_captures": run["graph_captures"],
        "graph_replays": run["graph_replays"], "placements_valid": True,
        "summary": st.summary_rows(), "chunk": chunk,
        "chunk_kernels_on_device": counts,
        "games_per_s_turns": games_per_s_turns(env, sources, 1024, 256),
        "seconds": time.time() - t_part}

    # (c)
    t_part = time.time()
    skull_mixed = [ev.PlayerSource.checkpoint(GAUNTLET / "skull" / n, dev)
                   for n in ("r4", "r4_flagship")] + [ev.PlayerSource.random()] * 2
    c4_dev = [ev.PlayerSource.checkpoint(p, dev) for p in c4]
    c4_env = make_env("connect_four")
    c4_temp = ev.default_temp(c4_env)
    cases = {
        "connect_four_greedy_stacked": (c4_env, c4_dev, 64, greedy),
        "skull_three_models_and_random_stacked": (env, sources, 256, ev.default_temp(env)),
        "connect_four_single": (c4_env, c4_dev[:1] + [ev.PlayerSource.random()], 64, c4_temp),
        "skull_per_model": (env, skull_mixed, 256, ev.default_temp(env)),
        "connect_four_cnn_per_model": (c4_env, [seeded_cnn(dev), c4_dev[0]], 64, c4_temp),
        "connect_four_random": (c4_env, [ev.PlayerSource.random()] * 2, 64, c4_temp),
    }
    out["replay_vs_eager"] = {
        name: replay_equals_eager(ev.StatsEngine(e, srcs, n, temp, ev.random_source(7, dev), dev))
        for name, (e, srcs, n, temp) in cases.items()}
    if {c["path"] for c in out["replay_vs_eager"].values()} != {"stacked", "single", "per_model",
                                                                 "random"}:
        raise AssertionError(f"replay_vs_eager: paths {out['replay_vs_eager']}")
    out["replay_vs_eager"]["seconds"] = time.time() - t_part

    # (d)
    watched = {}
    for name, argv, step_kernel in (
            ("connect_four", ["-c", str(c4[0]), "-c", str(c4[1]), *C4_GREEDY], "connect_four"),
            ("skull", ["-c", str(skull[0]), "--random"], "skull")):
        run = front_end_run(["eval", *argv, "--watch", "-n", "1", "--seed", "0"],
                            {f"{step_kernel}_step_autoreset", "temperature_sample",
                             "obs_norm_apply"})
        lines = run["text"].splitlines()
        moves = [ln for ln in lines if " (P" in ln and "): " in ln]
        model_moves = [ln for ln in moves if not ln.startswith("Random")]
        L = run["launches"]
        if not (L[f"{step_kernel}_step_autoreset"] == L["temperature_sample"] == len(moves)
                and L["obs_norm_apply"] == len(model_moves)):
            raise AssertionError(f"watch {name}: launches {L}, {len(moves)} moves")
        final = lines[max(i for i, ln in enumerate(lines) if ln.startswith("Final rewards"))
                      - (10 if name == "connect_four" else 0):]
        watched[name] = {"moves": len(moves), "launches": L, "wall_s": run["wall_s"],
                         "move_lines": moves if name == "connect_four" else moves[-6:],
                         "final": final}
    out["watch"] = watched
    out["single_env_vs_plain"] = single_env_walks(dev)
    out["watch_terminal_vs_plain"] = watch_terminal_checks(dev)

    # (e)
    run = front_end_run(["eval", "--env", "cartpole", "--random", "-n", "256", "--num-envs",
                         "64", "--seed", "0"], {"cartpole_step_autoreset", "step_books"})
    check_chunk_launches("eval (e)", run, "cartpole_step_autoreset")
    (cp,) = run["stats"]
    out["cartpole_random"] = {"games": cp.total_games, "wall_s": run["wall_s"],
                              "launches": run["launches"], "main_path_launches": run["main_path"],
                              "graph_replays": run["graph_replays"]}
    out["seconds"] = time.time() - t_phase
    out["launches_total"] = {name: sum(v["launches"].get(name, 0) for v in (
        out["connect_four_greedy"], out["skull_three_models_and_random"], *watched.values(),
        out["cartpole_random"])) for name in WRAPPERS}
    return out


def watch_terminal_checks(dev) -> dict:
    """Watch mode's game (``eval.SingleGame``: the env step kernel at E = 1
    with its reset off, K14's moves) played to its end on each env: the
    state the last move leaves (``terminal``, what the final render shows)
    equals the plain ``env.step`` of that move on the host copy of the
    state before it, every field bit for bit (CartPole's physics to 1e-5),
    and the game stepped once on the card a move, never on the host."""
    import burn_ppo_torch.eval as ev

    out = {}
    g = torch.Generator(device=dev).manual_seed(21)
    for env, step in ((CartPole(), cartpole_step_autoreset),
                      (ConnectFour(), connect_four_step_autoreset),
                      (Skull(4), skull_step_autoreset), (LiarsDice(), liars_dice_step_autoreset)):
        name, A = env.spec.name, env.spec.num_actions
        game = ev.SingleGame(env, ev.random_source(9, dev), dev)
        drawn = []
        real_draw = env.draw_step
        env.draw_step = lambda rng, n: drawn.append(real_draw(rng, n)) or drawn[-1]
        before, moves = step.launches, 0
        try:
            while not game.done and moves < 5000:
                prev = game.state
                logits = torch.randn(1, A, generator=g, device=dev)
                u = torch.rand(1, A, generator=g, device=dev).clamp_min(TINY)
                temp = torch.tensor([EVAL_TEMPS[moves % 4]], device=dev)
                action = int(sample_with_temperature(logits, game.mask, temp, u)[0])
                game.play(action)
                moves += 1
        finally:
            del env.draw_step
        if not game.done or step.launches - before != moves:
            raise AssertionError(f"watch {name}: done {game.done} after {moves} moves, "
                                 f"{step.launches - before} step launches")
        host = {f.name: getattr(prev, f.name).cpu() for f in dataclasses.fields(prev)}
        args = (dataclasses.replace(prev, **host), torch.tensor([action], dtype=torch.int32))
        want = env.step(*args + (() if drawn[-1] is None else (drawn[-1].cpu(),)))[0]
        got = {f.name: getattr(game.terminal, f.name).cpu() for f in dataclasses.fields(want)}
        if name == "cartpole":
            err = max_err([(got["phys"], want.phys)])
            bad = [] if err <= 1e-5 and torch.equal(got["step_idx"], want.step_idx) else ["phys"]
        else:
            bad = [f for f, t in got.items() if not torch.equal(t, getattr(want, f))]
        if bad or env.render(game.view()) != env.render(want):
            raise AssertionError(f"watch {name}: the last position differs from the plain step "
                                 f"in {bad}")
        out[name] = {"moves": moves, "step_launches": moves, "terminal_equals_plain_step": True}
    return out


def single_env_walks(dev) -> dict:
    """K4, K11 and K14 at E = 1, as watch mode and human play run them,
    against their plain versions along whole games: every step's outputs
    equal bit for bit (the plain env step on the CPU copy of the inputs,
    where a step of one env is not a few hundred launches), every action
    equal; temperatures cycling through 0, 0.4, 1 and 1e-3, so greedy and
    sampled moves both occur."""
    out = {}
    g = torch.Generator(device=dev).manual_seed(5)
    cpu = torch.device("cpu")

    def host(x):
        return None if x is None else dataclasses.replace(
            x, **{f.name: getattr(x, f.name).cpu() for f in dataclasses.fields(x)})

    for env, games in ((ConnectFour(), 3), (Skull(4), 2)):
        t0 = time.time()
        A = env.spec.num_actions
        steps = ends = 0
        for _ in range(games):
            empty = torch.empty(1, 0, device=dev)
            state = env.reset(empty)
            acc = EpisodeAccumulator.zero(1, env.spec.num_players, dev)
            mask = env.action_mask(state)
            for t in range(1000):
                logits = torch.randn(1, A, generator=g, device=dev)
                u = torch.rand(1, A, generator=g, device=dev).clamp_min(TINY)
                temp = torch.tensor([EVAL_TEMPS[t % 4]], device=dev)
                a = sample_with_temperature(logits, mask, temp, u)
                torch.cuda.synchronize()
                if not torch.equal(a, sample_with_temperature_plain(logits, mask, temp, u)):
                    raise AssertionError(f"temperature_sample at E = 1 ({env.spec.name}, step "
                                         f"{t}) differs from plain")
                su = env.draw_step(TorchRandomSource(g), 1)
                k = env.step_autoreset(state, acc, a, empty, su)
                p = autoreset_step(env, host(state), host(acc), a.cpu(), empty.cpu(),
                                   None if su is None else su.cpu())
                bad = step_differences(host_output(k), p, type(state).INT_FIELDS)
                if bad:
                    raise AssertionError(f"{env.spec.name} step at E = 1: {bad} differ from plain")
                steps += 1
                state, acc, mask = k.state, k.acc, k.mask
                if bool(k.done[0]):
                    ends += 1
                    break
        if ends != games:
            raise AssertionError(f"{env.spec.name} at E = 1: {ends} of {games} games ended")
        out[env.spec.name] = {"games": games, "steps": steps, "tol": "exact",
                              "seconds": time.time() - t0}
    return out


def host_output(k):
    """An env step's outputs copied to the CPU."""
    state = dataclasses.replace(
        k.state, **{f.name: getattr(k.state, f.name).cpu() for f in dataclasses.fields(k.state)})
    log = EpisodeLog(*(x.cpu() for x in (k.log.completed, k.log.total_rewards, k.log.length,
                                         k.log.outcome, k.log.active_players)))
    return k._replace(state=state, acc=EpisodeAccumulator(k.acc.reward_sum.cpu(), k.acc.length.cpu()),
                      rewards=k.rewards.cpu(), done=k.done.cpu(), log=log, obs=k.obs.cpu(),
                      mask=k.mask.cpu(), priv=None if k.priv is None else k.priv.cpu())


TOURNAMENT_GAMES = {"connect_four": 192, "skull": 48, "liars_dice": 192}
TOURNAMENT_PLAYERS = {"skull": 4, "liars_dice": 4}
# The gauntlets are rated under seed 0 and, as a second draw, seed 1.
TOURNAMENT_SEEDS = (0, 1)
# Besides the env step with K14's sampling front and K17: K7 for the pods
# whose models stack, and K6 for a pod of one model and Random (Connect Four) or the per-model
# path (Skull), whose models normalise their obs.
TOURNAMENT_KERNELS = {"connect_four": {"opponent_actor_forward", "obs_norm_apply"},
                      "skull": {"opponent_actor_forward", "obs_norm_apply"},
                      "liars_dice": {"opponent_actor_forward"}}


def gauntlet_entries(env_name: str) -> list:
    env_dir = GAUNTLET / env_name
    return sorted(p for p in env_dir.iterdir() if p.is_dir() and (p / "model.npz").exists())


# Each gauntlet entry's (rating, sigma) under seed 0 as the parent tree
# (05cbb50) rated it: the seat passes and records of K17 changed order and
# launches, not the games, so seed 0 must give these again.
PARENT_SEED0_RATINGS = {
    "connect_four": {"r4": (1802.0, 63.9), "r4_best": (1550.8, 51.3), "r4_mid": (1297.1, 40.4)},
    "skull": {"r4": (1366.3, 28.3), "r4_best": (1365.6, 28.4), "r4_flagship": (1366.1, 28.4),
              "r4_flagship_best": (1376.3, 28.5), "r4_mid": (1345.7, 28.4)},
    "liars_dice": {"r4": (1529.2, 58.5), "r4_best": (1534.1, 58.7), "r4_mid": (1498.2, 58.1)},
}


def gauntlet_ratings(env_name: str, res: dict, seed: int) -> list:
    """Each entry's rating beside JAX's ``ratings_r4.json``: above Random by
    more than 2 of its own sigma, and within 4 combined sigma of JAX's."""
    ref = {r["name"]: r for r in json.loads(
        (GAUNTLET / env_name / "ratings_r4.json").read_text())["rankings"]}
    rows = {r["name"]: r for r in res["rankings"]}
    base = rows["Random"]["rating"]
    table = []
    for name in sorted(rows):
        if name == "Random":
            continue
        r, j = rows[name], ref[name]
        comb = math.hypot(r["uncertainty"], j["uncertainty"])
        entry = {"name": name, "rating": r["rating"], "sigma": r["uncertainty"],
                 "jax_rating": j["rating"], "jax_sigma": j["uncertainty"],
                 "over_random_in_sigma": (r["rating"] - base) / r["uncertainty"],
                 "from_jax_in_combined_sigma": (r["rating"] - j["rating"]) / comb}
        table.append(entry)
        if not entry["over_random_in_sigma"] > 2.0:
            raise AssertionError(f"tournament {env_name} (seed {seed}): {name} not 2 sigma above "
                                 f"Random: {entry}")
        if not abs(entry["from_jax_in_combined_sigma"]) < 4.0:
            raise AssertionError(f"tournament {env_name} (seed {seed}): {name} more than 4 "
                                 f"combined sigma from ratings_r4.json: {entry}")
    return table


def cached_pods_equal_fresh_engines(dev) -> dict:
    """Two pods of one key through one ``EngineCache``: the second is
    loaded into the first's engine (its models, its seed, a fresh reset)
    and replays the graph the first captured; chunk by chunk it must equal
    a new engine of the second pod's seed run eagerly, bit for bit (every
    log array, the carry, the generator). Connect Four's stacked pods
    (64 envs) and Skull's per-model pods (48 envs, the CTDE 512x2 with obs
    norm beside the 256x3 without, and Random)."""
    import burn_ppo_torch.eval as ev

    out = {}
    for name, env_name, pods, E in (
            ("connect_four_stacked", "connect_four", (["r4", "r4_mid"], ["r4_best", "r4"]), 64),
            ("skull_per_model", "skull", (["r4", "r4_flagship", "r4_mid", None],
                                          ["r4_best", "r4_flagship_best", "r4", None]), 48)):
        env = make_env(env_name)
        temp = ev.default_temp(env)
        lineups = [[ev.PlayerSource.random() if n is None else
                    ev.PlayerSource.checkpoint(GAUNTLET / env_name / n, dev) for n in pod]
                   for pod in pods]
        cache = ev.EngineCache()
        first = cache.engine(env, lineups[0], E, temp, 101, dev)
        first.run_chunk()
        engine = cache.engine(env, lineups[1], E, temp, 202, dev)
        fresh = ev.StatsEngine(env, lineups[1], E, temp, ev.random_source(202, dev), dev)
        if engine is not first or cache.reused != 1:
            raise AssertionError(f"{name}: the second pod did not reuse the first's engine")
        games = 0
        for _ in range(2):
            engine.run_chunk()
            fresh.eager_chunk()
            torch.cuda.synchronize()
            games += int(engine.log.completed.sum())
            if not all(a.dtype == b.dtype and torch.equal(a.cpu(), b.cpu()) for a, b in
                       zip(engine_outputs(engine), engine_outputs(fresh), strict=True)):
                raise AssertionError(f"{name}: the cached engine's pod differs from a fresh "
                                     "engine's")
        out[name] = {"path": engine.logits.path, "envs": E, "chunks": 2, "games": games,
                     "bit_for_bit": True}
    return out


def tournament_turns(env_name: str, games: int, dev) -> dict:
    """A gauntlet's tournament with the engine cache and graphed chunks,
    and as the earlier engine played it (an engine a pod, chunks run
    eagerly: the tournament's ``EngineCache`` and ``StatsEngine.run_chunk``
    switched for the run), in turns: seconds of each."""
    import burn_ppo_torch.eval as ev
    import burn_ppo_torch.tournament as tt

    class EnginePerPod(ev.EngineCache):
        def engine(self, *args, **kw):
            self.engines.clear()
            return super().engine(*args, **kw)

    out: dict = {"graph_cached_s": [], "eager_per_pod_s": []}
    real = ev.StatsEngine.run_chunk
    for cached in (True, False, False, True):
        if not cached:
            ev.StatsEngine.run_chunk = ev.StatsEngine.eager_chunk
            tt.EngineCache = EnginePerPod
        try:
            t0 = time.time()
            tt.run_tournament(gauntlet_entries(env_name), num_games=games, num_envs=64,
                              include_random=True, players=TOURNAMENT_PLAYERS.get(env_name),
                              seed=0, quiet=True, device=dev)
            torch.cuda.synchronize()
            out["graph_cached_s" if cached else "eager_per_pod_s"].append(time.time() - t0)
        finally:
            ev.StatsEngine.run_chunk = real
            tt.EngineCache = ev.EngineCache
    return out


def tournament_phase(tmp: Path, card_line: str) -> dict:
    """Phase ``tournament`` (after phase ``eval``, in its process): the
    three gauntlets as ``scripts/gauntlet.py rate`` runs them (the entries with a model.npz,
    sorted, plus Random; 64 envs; Skull and Liar's Dice at 4 players; the
    format the field gives: round robin), through the port's
    ``tournament`` command on the card, 48 games a pod on Skull and 192 on
    Connect Four and Liar's Dice, under seeds 0 and 1: pods of one shape
    share one engine and its graph (graphs captured and replayed, counted;
    the command's "Stats engines" line). Every entry rated above Random by
    more than 2 of its own sigma, and within 4 combined sigma of
    ``gauntlet/<env>/ratings_r4.json``, under both seeds; the pods that
    stacked their models for K7 and those that took the per-model path
    counted (Skull's field mixes CTDE 512x2 tanh with obs norm and CTDE
    256x3 relu without: both must occur). Then a cached pod against a
    fresh engine of its seed, bit for bit, and each gauntlet's seconds
    with the cache and graphs against an engine a pod run eagerly,
    in turns. Under seed 0 every rating and sigma is the parent tree's
    (``PARENT_SEED0_RATINGS``): the same games."""
    out: dict = {"card": card_line}
    t_phase = time.time()
    dev = resolve_device("cuda")
    launches_total = {name: 0 for name in WRAPPERS}
    for env_name, games in TOURNAMENT_GAMES.items():
        step_kernel = f"{env_name}_step_autoreset"
        players = TOURNAMENT_PLAYERS.get(env_name)
        out[env_name] = {"games_per_pod": games}
        for seed in TOURNAMENT_SEEDS:
            res_path = tmp / f"{env_name}_{seed}.json"
            argv = (["tournament", *map(str, gauntlet_entries(env_name)), "--random", "-n",
                     str(games), "--num-envs", "64", "--seed", str(seed), "-o", str(res_path)]
                    + (["--players", str(players)] if players else []))
            run = front_end_run(argv, {step_kernel, "step_books", *TOURNAMENT_KERNELS[env_name]})
            res = json.loads(res_path.read_text())
            check_chunk_launches(f"tournament {env_name}", run, step_kernel)
            m = re.search(r"Stats engines: (\d+) built, reused for (\d+) pods", run["text"])
            if m is None or int(m.group(1)) != run["graph_captures"] or (
                    int(m.group(1)) + int(m.group(2)) != len(res["pods"])):
                raise AssertionError(f"tournament {env_name}: engines {m and m.group(0)}, "
                                     f"{run['graph_captures']} captures, {len(res['pods'])} pods")
            for name, n in run["launches"].items():
                launches_total[name] += n
            table = gauntlet_ratings(env_name, res, seed)
            if seed == 0 and {e["name"]: (e["rating"], e["sigma"]) for e in table} != (
                    PARENT_SEED0_RATINGS[env_name]):
                raise AssertionError(f"tournament {env_name} seed 0: ratings {table} are not the "
                                     f"parent tree's {PARENT_SEED0_RATINGS[env_name]}")
            out[env_name][f"seed_{seed}"] = {
                "seconds": run["wall_s"], "pods": len(res["pods"]),
                "pods_by_logits": dict(Counter(p["logits"] for p in res["pods"])),
                "engines_built": int(m.group(1)), "pods_reusing_an_engine": int(m.group(2)),
                "graph_captures": run["graph_captures"], "graph_replays": run["graph_replays"],
                "total_games": res["total_games"], "format": res["format"], "ratings": table,
                "below_jax": sum(e["rating"] < e["jax_rating"] for e in table),
                "launches": run["launches"], "main_path_launches": run["main_path"]}
        out[env_name]["turns"] = tournament_turns(env_name, games, dev)
    sk = out["skull"]["seed_0"]["pods_by_logits"]
    if not (sk.get("stacked", 0) > 0 and sk.get("per_model", 0) > 0):
        raise AssertionError(f"tournament skull: pods by logits {sk}: both K7 and per-model needed")
    out["below_jax"] = {f"seed_{seed}": sum(out[e][f"seed_{seed}"]["below_jax"]
                                            for e in TOURNAMENT_GAMES) for seed in TOURNAMENT_SEEDS}
    out["entries"] = sum(len(out[e]["seed_0"]["ratings"]) for e in TOURNAMENT_GAMES)
    out["cached_pod_vs_fresh_engine"] = cached_pods_equal_fresh_engines(dev)
    out["seconds"] = time.time() - t_phase
    out["launches_total"] = launches_total
    return out


def front_end_phases(tmp: Path, card_line: str) -> dict:
    """Phases ``eval``, ``tournament``, ``interactive`` and ``interop``, one
    after the other in one process (each starts its counters at 0)."""
    return {"eval": eval_phase(tmp, card_line), "tournament": tournament_phase(tmp, card_line),
            "interactive": interactive_phase(tmp, card_line),
            "interop": interop_phase(tmp, card_line)}


def burn_msgpack(obj) -> bytes:
    """MessagePack of a Burn record (maps, lists, strings, raw bytes, ints,
    floats, None): the encoder of phase ``interop``'s test directories,
    which the package only reads."""
    import struct

    if obj is None:
        return b"\xc0"
    if isinstance(obj, bool):
        return b"\xc3" if obj else b"\xc2"
    if isinstance(obj, int):
        return bytes([obj]) if 0 <= obj <= 0x7F else b"\xd3" + struct.pack(">q", obj)
    if isinstance(obj, float):
        return b"\xcb" + struct.pack(">d", obj)
    if isinstance(obj, str):
        b = obj.encode()
        return (bytes([0xA0 | len(b)]) if len(b) <= 31 else b"\xdb" + struct.pack(">I", len(b))) + b
    if isinstance(obj, (bytes, bytearray)):
        return b"\xc6" + struct.pack(">I", len(obj)) + bytes(obj)
    if isinstance(obj, (list, tuple)):
        head = bytes([0x90 | len(obj)]) if len(obj) <= 15 else b"\xdd" + struct.pack(">I", len(obj))
        return head + b"".join(burn_msgpack(v) for v in obj)
    head = bytes([0x80 | len(obj)]) if len(obj) <= 15 else b"\xdf" + struct.pack(">I", len(obj))
    return head + b"".join(burn_msgpack(k) + burn_msgpack(v) for k, v in obj.items())


def write_burn_dir(src: Path, dst: Path) -> Path:
    """The Rust reference's layout of checkpoint ``src`` (an MLP or CTDE
    network): ``model.mpk``, its weights as a Burn record (the network's
    enum variant, ParamSerde id/param wrappers, f32 byte leaves, Linear
    weights [d_in, d_out]), ``metadata.json``, and ``normalizer.json``
    with the obs normaliser's M2 as ``var``; no ``model.npz``."""
    from burn_ppo_torch.checkpoint import load_model, load_obs_normalizer
    from burn_ppo_torch.convert import params_to_jax

    network, meta = load_model(src)
    tree = params_to_jax(network.state_dict())

    def leaf(a, pid):
        a = np.ascontiguousarray(a, np.float32)
        return {"id": pid, "param": {"bytes": a.tobytes(), "shape": list(a.shape), "dtype": "F32"}}

    def linear(layer, pid):
        return {"weight": leaf(layer["kernel"], f"{pid}.w"),
                "bias": leaf(layer["bias"], f"{pid}.b")}

    record = {k: ([linear(x, f"{k}{i}") for i, x in enumerate(v)] if isinstance(v, list)
                  else linear(v, k)) for k, v in tree.items()}
    variant = {"mlp": "Mlp", "ctde": "Ctde"}[meta["network_type"]]
    dst.mkdir(parents=True)
    (dst / "model.mpk").write_bytes(burn_msgpack({variant: record}))
    (dst / "metadata.json").write_text(json.dumps(meta))
    norm = load_obs_normalizer(src)
    if norm is not None:
        (dst / "normalizer.json").write_text(json.dumps(
            {"mean": norm.mean.tolist(), "var": norm.m2.tolist(), "count": float(norm.count),
             "clip": 10.0}))
    return dst


def interop_phase(tmp: Path, card_line: str) -> dict:
    """Phase ``interop`` (in the front ends' process): Burn NamedMpk
    directories written from gauntlet checkpoints (``write_burn_dir``:
    Connect Four r4, MLP 512x2 with obs norm; Skull r4, CTDE 512x2 with
    obs norm), loaded on the card through ``checkpoint.load_model`` and
    ``load_obs_normalizer`` (their route to ``interop.py``): the
    parameters and the obs normaliser bit for bit the ``.npz`` original's;
    two graphed chunks of a stats engine of each (the model and Random)
    bit for bit the original's engine from the same seed; ``eval`` on the
    Connect Four directory through ``cli.main`` (its kernels counted) with
    the original's games, and ``tournament`` with it beside r4_mid with
    the original's standings."""
    import burn_ppo_torch.eval as ev
    from burn_ppo_torch.checkpoint import is_reference_checkpoint, load_model, load_obs_normalizer

    dev = resolve_device("cuda")
    t0 = time.time()
    out: dict = {"card": card_line}
    launches = {name: 0 for name in WRAPPERS}
    for env_name, E_eval in (("connect_four", 64), ("skull", 64)):
        src = GAUNTLET / env_name / "r4"
        burn = write_burn_dir(src, tmp / "burn" / env_name / "r4")
        if not is_reference_checkpoint(burn):
            raise AssertionError(f"interop {env_name}: the written directory is not a Burn one")
        (nb, _), (nn, _) = load_model(burn, dev), load_model(src, dev)
        same = [torch.equal(a, b) for a, b in zip(nb.state_dict().values(),
                                                  nn.state_dict().values(), strict=True)]
        norms = load_obs_normalizer(burn, dev), load_obs_normalizer(src, dev)
        same += [torch.equal(getattr(norms[0], f), getattr(norms[1], f))
                 for f in ("mean", "m2", "count")]
        if not all(same) or next(nb.parameters()).device != dev:
            raise AssertionError(f"interop {env_name}: the import differs from the .npz")
        env = make_env(env_name)
        logs = []
        for path in (burn, src):
            srcs = [ev.PlayerSource.checkpoint(path, dev)] + [ev.PlayerSource.random()] * (
                env.spec.num_players - 1)
            engine = ev.StatsEngine(env, srcs, E_eval, ev.default_temp(env),
                                    ev.random_source(5, dev), dev)
            for _ in range(2):
                engine.run_chunk()
            torch.cuda.synchronize()
            logs.append([t.cpu() for t in engine_outputs(engine)])
        if not all(torch.equal(a, b) for a, b in zip(*logs, strict=True)):
            raise AssertionError(f"interop {env_name}: the Burn directory's chunks differ from "
                                 "the .npz original's")
        out[env_name] = {"params_and_obs_norm_equal": True, "tensors_compared": len(same),
                         "chunks_equal_bit_for_bit": 2, "envs": E_eval,
                         "network": nb.network_type}
    c4 = GAUNTLET / "connect_four"
    burn = tmp / "burn" / "connect_four" / "r4"
    runs = {}
    for key, path in (("burn", burn), ("npz", c4 / "r4")):
        run = front_end_run(["eval", "-c", str(path), "--random", "-n", "128", "--num-envs", "64",
                             "--seed", "3"], {"connect_four_step_autoreset", "step_books",
                                              "obs_norm_apply"})
        check_chunk_launches(f"interop eval {key}", run, "connect_four_step_autoreset")
        runs[key] = run
        if key == "burn":
            for name, n in run["launches"].items():
                launches[name] += n
    (b,), (n,) = runs["burn"]["stats"], runs["npz"]["stats"]
    if not (b.game_records == n.game_records and b.placements == n.placements
            and b.rewards == n.rewards):
        raise AssertionError("interop eval: the Burn directory's games differ from the .npz's")
    out["eval"] = {"games": b.total_games, "wall_s": runs["burn"]["wall_s"],
                   "main_path_launches": runs["burn"]["main_path"], "games_equal_npz": True}
    results = []
    for path in (burn, c4 / "r4"):
        res_path = tmp / f"interop_{len(results)}.json"
        run = front_end_run(["tournament", str(path), str(c4 / "r4_mid"), "--random", "-n", "64",
                             "--num-envs", "64", "--seed", "4", "-o", str(res_path)],
                            {"connect_four_step_autoreset", "step_books", "opponent_actor_forward",
                             "obs_norm_apply"})
        if not results:
            for name, k in run["launches"].items():
                launches[name] += k
        results.append(json.loads(res_path.read_text()))
    rows = [[{k: r[k] for k in r if k not in ("source", "name")} for r in res["rankings"]]
            for res in results]
    if rows[0] != rows[1]:
        raise AssertionError(f"interop tournament: standings {rows}")
    out["tournament"] = {"pods": len(results[0]["pods"]), "games": results[0]["total_games"],
                         "standings_equal_npz": True}
    out["seconds"] = time.time() - t0
    out["launches_total"] = launches
    return out


INTERACTIVE_SAMPLES = 24  # ai_sample moves of the scripted session
# More ai_sample moves, at most, while none of them has met a forced discard
# yet: the session's generator is seeded from the OS, so 24 moves may meet none.
INTERACTIVE_DISCARD_SAMPLES = 400
INTERACTIVE_END_MOVES = 600  # then ai_sample moves until the game ends, at most
# A four-player skull reveal: P0 places its skull, P1-P3 a rose each, P0
# bids 4 (every card on the table: straight to revealing) and must reveal
# its own stack first, its skull.
SKULL_REVEAL = (0, 1, 1, 1, 5, 27)


def interactive_terminal_check(sess, state, drawn, label: str, discard: int) -> dict:
    """The assistant's position after the move that ended its game (one
    K11 launch with the reset off) against the plain Skull step of the
    position before it on the CPU, with the same uniform (the session's
    generator put back to its state before the move) and the chosen
    discard: the state, obs and mask equal bit for bit, no legal action."""
    from burn_ppo_torch.interactive import _with_discard

    env = sess.env
    action = {env.describe_action(a): a for a in range(env.spec.num_actions)}[label]
    g = torch.Generator(device=sess.device)
    g.set_state(drawn)
    u = env.draw_step(TorchRandomSource(g), 1).cpu()
    before = _with_discard(state, discard)
    before = SkullState(before.ints.cpu(), before.shaping_coef.cpu())
    stepped, _, done = env.step(before, torch.tensor([action], dtype=torch.int32), u)
    plain = _with_discard(stepped, -1)
    pos = sess.pos
    pairs = {"ints": (pos.state.ints, plain.ints),
             "shaping_coef": (pos.state.shaping_coef, plain.shaping_coef),
             "obs": (pos.obs, env.obs(plain)), "mask": (pos.mask, env.action_mask(plain))}
    bad = [k for k, (a, b) in pairs.items() if not torch.equal(a.cpu(), b)]
    if bad or not bool(done[0]) or bool(pos.mask.any()) or not bool(pos.state.game_over[0]):
        raise AssertionError(f"interactive: the terminal position differs from the plain step's "
                             f"({bad}, done {bool(done[0])})")
    return {"action": label, "discard": discard, "winner": int(pos.state.winner[0]),
            "tol": "exact"}


def interactive_phase(tmp: Path, card_line: str) -> dict:
    """Phase ``interactive`` (in the front ends' process): the Skull
    assistant's server (``burn_ppo_torch.interactive``) in a thread on
    ``gauntlet/skull``, its networks on the card, every launch counter at
    0 before and read after. One scripted session through the HTTP API:
    the page, the networks, r4 selected, a four-player game, a skull
    reveal and its discard, then ``INTERACTIVE_SAMPLES`` ``ai_sample``
    moves each after an ``ai_probs`` (a new game when one ends; every
    skull reveal's discard chosen; more moves, up to
    ``INTERACTIVE_DISCARD_SAMPLES``, until one of them has met a forced
    discard, which the phase requires), an undo back to the position before
    the last move, the history, then ``ai_sample`` moves until the game
    ends, whose last position must be the plain step's
    (``interactive_terminal_check``). Every ``ai_probs``: the network's full
    probabilities on the card sum to 1 within 1e-5, zero on every illegal
    action, and the listed ones legal and equal to them. K11 once per
    applied move, K6 once per forward. The median ms of each route."""
    import threading
    import urllib.request
    from http.server import ThreadingHTTPServer

    from burn_ppo_torch.interactive import InteractiveApp, make_handler

    dev = resolve_device("cuda")
    for w in WRAPPERS.values():
        w.launches = 0
    t0 = time.time()
    app = InteractiveApp([GAUNTLET / "skull"], device=dev)
    load_s = time.time() - t0
    names = [n["name"] for n in app.networks]
    net = app.networks[names.index("r4")]["source"]
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(app))
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    times: dict = {}
    sid = "chip-smoke"

    def call(path: str, body=None):
        req = urllib.request.Request(
            base + path, data=None if body is None else json.dumps(body).encode(),
            headers={"x-session-id": sid, "content-type": "application/json"},
            method="GET" if body is None else "POST")
        t = time.perf_counter()
        with urllib.request.urlopen(req, timeout=60) as r:
            raw = r.read()
        times.setdefault(path, []).append((time.perf_counter() - t) * 1e3)
        return raw if path == "/" else json.loads(raw)

    forwards = applied = discards = games = samples = 0
    last_discard = -1
    worst = 0.0
    try:
        if b"Skull Assistant" not in call("/"):
            raise AssertionError("interactive: the page is not the assistant's")
        if sorted(call("/api/networks")["networks"]) != sorted(names):
            raise AssertionError(f"interactive: networks {names}")
        call("/api/select_network", {"index": names.index("r4")})
        call("/api/new_game", {"num_players": 4, "ai_seat": 0})
        games += 1
        sess = app.sessions[sid]

        def discard(r):
            nonlocal discards, applied, last_discard
            last_discard = -1
            if not r.get("pending_discard"):
                applied += bool(r.get("ok"))
                return r
            me = call("/api/game_state")["players"][r["bidder"]]
            last_discard = 1 if me["roses"] else 0
            r = call("/api/execute_discard", {"choice": "rose" if me["roses"] else "skull"})
            discards += 1
            applied += 1
            return r

        for a in SKULL_REVEAL:
            r = call("/api/execute_action", {"action": a})
            if "error" in r:
                raise AssertionError(f"interactive: scripted move {a}: {r}")
        if not r.get("pending_discard"):
            raise AssertionError(f"interactive: the scripted reveal asked no discard: {r}")
        applied += len(SKULL_REVEAL) - 1
        discard(r)
        before_last = None
        while samples < INTERACTIVE_SAMPLES or (discards < 2
                                                and samples < INTERACTIVE_DISCARD_SAMPLES):
            state = call("/api/game_state")
            if state["game_over"]:
                call("/api/new_game", {"num_players": 4, "ai_seat": samples % 4})
                games += 1
                continue
            listed = call("/api/ai_probs", {})["probs"]
            full = np.asarray(app._model_probs(sess))
            forwards += 2
            mask = sess.pos.mask[0].cpu().numpy() > 0
            err = abs(float(full.sum()) - 1.0)
            worst = max(worst, err)
            if err > 1e-5 or (full[~mask] != 0).any():
                raise AssertionError(f"interactive: probabilities sum {full.sum()}, illegal "
                                     f"{full[~mask].max()}")
            if not all(mask[p["action"]] and abs(p["prob"] - float(full[p["action"]])) <= 1e-6
                       for p in listed):
                raise AssertionError(f"interactive: listed {listed} against {full}")
            before_last = state
            r = discard(call("/api/ai_sample", {}))
            forwards += 1
            if "error" in r:
                raise AssertionError(f"interactive: ai_sample: {r}")
            samples += 1
        if not call("/api/undo", {})["ok"]:
            raise AssertionError("interactive: undo refused")
        after = call("/api/game_state")
        if {k: v for k, v in after.items() if k != "can_undo"} != {
                k: v for k, v in before_last.items() if k != "can_undo"}:
            raise AssertionError("interactive: undo did not restore the position before the "
                                 "last move")
        history = call("/api/history")["history"]
        # Then AI moves until the game ends, the position before each move
        # and the generator's state kept.
        end = None
        for _ in range(INTERACTIVE_END_MOVES):
            before = (sess.pos.state, sess.generator.get_state())
            r = discard(call("/api/ai_sample", {}))
            forwards += 1
            if "error" in r:
                raise AssertionError(f"interactive: ai_sample towards the end: {r}")
            if r["state"]["game_over"]:
                end = (*before, sess.action_history[-1]["action"], last_discard)
                break
        if end is None:
            raise AssertionError(f"interactive: no game end in {INTERACTIVE_END_MOVES} moves")
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.join(timeout=10)
    torch.cuda.synchronize()
    launches = {name: w.launches for name, w in WRAPPERS.items() if w.launches}
    want = {"skull_step_autoreset": applied, "obs_norm_apply": forwards}
    if launches != want:
        raise AssertionError(f"interactive: launches {launches}, want {want}")
    terminal = interactive_terminal_check(sess, *end)
    on_card = next(net.network.parameters()).device.type == "cuda" and (
        net.obs_norm is None or net.obs_norm.mean.device.type == "cuda")
    if not on_card or discards < 2:
        raise AssertionError(f"interactive: network on the card {on_card}, {discards} discards")
    route_ms = {k: float(np.median(v)) for k, v in times.items()}
    return {"card": card_line, "networks": names, "selected": "r4", "network_on_cuda": on_card,
            "load_s": load_s, "games": games, "ai_samples": samples, "moves_applied": applied,
            "terminal_equals_plain": terminal,
            "discards": discards, "forwards": forwards, "history_entries": len(history),
            "probs_sum_max_err": worst, "launches": launches, "route_median_ms": route_ms,
            "route_calls": {k: len(v) for k, v in times.items()},
            "seconds": time.time() - t0,
            "launches_total": {name: launches.get(name, 0) for name in WRAPPERS}}


CHUNK_TURN = """
import json, sys
sys.path.insert(0, ".")
import torch
from pathlib import Path
import burn_ppo_torch.eval as ev
from burn_ppo_torch.device import resolve_device
from burn_ppo_torch.envs import make_env

dev = resolve_device("cuda")
g = Path("gauntlet") / "skull"
sources = ([ev.PlayerSource.checkpoint(g / n, dev) for n in ("r4", "r4_best", "r4_mid")]
           + [ev.PlayerSource.random()])
env = make_env("skull")
engine = ev.StatsEngine(env, sources, 256, ev.default_temp(env), ev.random_source(1, dev), dev)
engine.run_chunk()
torch.cuda.synchronize()
events = []
for _ in range(9):
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    engine.run_chunk()
    end.record()
    end.synchronize()
    events.append(start.elapsed_time(end))
act = torch.profiler.ProfilerActivity
with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
    engine.run_chunk()
    torch.cuda.synchronize()
cuda = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
busy = sum(e.self_device_time_total for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
k17 = {k: sum(1 for e in cuda if k in e.name)
       for k in ("sample_seats_kernel", "record_step_kernel", "record_and_seat_kernel")}
steps = {k: sum(1 for e in cuda if k in e.name)
         for k in ("temperature_sample_kernel", "skull_step_autoreset_kernel",
                   "skull_sample_step_kernel")}
med = sorted(events)[len(events) // 2]
print(json.dumps({"events_ms": events, "events_ms_median": med, "device_ms": busy,
                  "idle_share": 1.0 - busy / med, "k17_launches": k17,
                  "sample_and_step_launches": steps}))
"""


def chunk_tree_turns(parent_dir: Path) -> dict:
    """The Skull eval chunk of phase eval (b) (256 envs, r4, r4_best,
    r4_mid and Random, a graph replay) of the parent's tree and this one,
    in turns (parent, this, this, parent), each in a process of its own:
    the events ms of nine replays, one profiled replay's device busy ms
    and idle share, K17's, K14's and the Skull step's launches in it by
    name (this tree: K14 0, the step with its sampling front 64)."""
    out: dict = {}
    for key, tree in (("parent", parent_dir), ("this", ROOT), ("this", ROOT),
                      ("parent", parent_dir)):
        res = subprocess.run([sys.executable, "-c", CHUNK_TURN], cwd=tree, capture_output=True,
                             text=True, timeout=900)
        if res.returncode != 0:
            raise RuntimeError(f"chunk turn in {tree} exited {res.returncode}:\n"
                               f"{res.stderr[-4000:]}")
        run = json.loads(res.stdout.strip().splitlines()[-1])
        for name in ("events_ms_median", "device_ms", "idle_share", "k17_launches",
                     "sample_and_step_launches"):
            out.setdefault(f"{key}_{name}", []).append(run[name])
    if any(sum(k.values()) != 65 for k in out["this_k17_launches"]):
        raise AssertionError(f"chunk turns: this tree's K17 launches {out['this_k17_launches']}")
    fused = {"temperature_sample_kernel": 0, "skull_step_autoreset_kernel": 0,
             "skull_sample_step_kernel": 64}
    if any(k != fused for k in out["this_sample_and_step_launches"]):
        raise AssertionError(f"chunk turns: this tree's K14 and step launches "
                             f"{out['this_sample_and_step_launches']}, want {fused}")
    return out


SUPERVISED_STEPS = 4096  # configs/cartpole.toml: 32 envs x 128 steps, an update a checkpoint


def supervisor_start(tmp: Path) -> dict:
    """Phase ``supervisor``: ``python -m burn_ppo_torch train --config
    configs/cartpole.toml --reload-every-n-checkpoints 1`` for three
    checkpoints (an update each), twice at once, each supervisor in a
    process of its own (``cli.main``) spawning three children in turn:
    the first fresh, the later ones with ``--resume`` and a growing
    ``--elapsed-time-offset-ms``. This starts both runs; phase ``resume``
    runs meanwhile (both only check bits), then ``supervisor_finish``
    waits for them: each run ends at the total step with three
    checkpoints; its metrics have one entry an update, no gap or repeat,
    each with the device memory that only a child on the card logs; the
    two runs' final model, optimizer and generator equal bit for bit."""
    procs = {}
    for name in ("a", "b"):
        run = tmp / f"supervised_{name}"
        cmd = [sys.executable, "-m", "burn_ppo_torch", "train", "--config",
               str(ROOT / "configs" / "cartpole.toml"), "--total-steps",
               str(3 * SUPERVISED_STEPS), "--checkpoint-freq", str(SUPERVISED_STEPS),
               "--seed", "0", "--run-dir", str(run), "--reload-every-n-checkpoints", "1"]
        procs[name] = (run, subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    return {"procs": procs, "t0": time.time()}


def supervisor_finish(started: dict, card_line: str) -> dict:
    procs, total = started["procs"], 3 * SUPERVISED_STEPS
    out: dict = {"card": card_line, "total_steps": total}
    try:
        texts = {name: p.communicate(timeout=600)[0] for name, (_, p) in procs.items()}
    finally:
        for _, p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    for name, (run, p) in procs.items():
        text = texts[name]
        if p.returncode != 0:
            raise RuntimeError(f"supervised run {name} exited {p.returncode}:\n{text[-3000:]}")
        spawns = [ln for ln in text.splitlines() if ln.startswith("supervisor: spawn #")]
        offsets = [int(re.search(r"--elapsed-time-offset-ms (\d+)", ln).group(1)) for ln in spawns]
        resumed = ["--resume" in ln for ln in spawns]
        if resumed != [False, True, True] or not 0 < offsets[1] < offsets[2]:
            raise AssertionError(f"supervised run {name}: spawns {spawns}")
        step = json.loads((run / "checkpoints" / "latest" / "metadata.json").read_text())["step"]
        ckpts = sorted(int(d.name[5:]) for d in (run / "checkpoints").glob("step_*"))
        logged: dict = {}
        for line in (run / "metrics.jsonl").read_text().splitlines():
            rec = json.loads(line)
            if rec["type"] == "scalar":
                logged.setdefault(rec["name"], []).append(rec["step"])
        want = [SUPERVISED_STEPS * (i + 1) for i in range(3)]
        if step != total or ckpts != want or logged.get("perf/sps") != want:
            raise AssertionError(f"supervised run {name}: step {step}, checkpoints {ckpts}, "
                                 f"perf/sps logged at {logged.get('perf/sps')}")
        if logged.get("perf/device_mb_in_use") != want:
            raise AssertionError(f"supervised run {name}: device memory logged at "
                                 f"{logged.get('perf/device_mb_in_use')}: a child off the card")
        out[name] = {"children": len(spawns), "elapsed_offsets_ms": offsets, "final_step": step,
                     "checkpoints": ckpts, "logged_steps": logged["perf/sps"]}
    latest = [procs[n][0] / "checkpoints" / "latest" for n in ("a", "b")]
    files = ("model.npz", "optimizer.npz", "generator_state.npz")
    differ = [f for f in files if (latest[0] / f).read_bytes() != (latest[1] / f).read_bytes()]
    if differ:
        raise AssertionError(f"two supervised runs end differently: {differ}")
    out["equal_files"] = list(files)
    out["seconds"] = time.time() - started["t0"]
    return out


# ---- K18 and K19, the update window's records and report (PR 20) -------

FLAGSHIP = ROOT / "configs" / "skull_ctde_tpu.toml"
T_FLAG, W_FLAG = 64, 8  # its steps per update and updates a rotation
FLAGSHIP_UPDATES = 24  # a self-play window of 8, a checkpoint, two pool windows of 8
FLAGSHIP_OPPONENTS = 8
# K18's reads of a completed game: its seat, the P placements and the P-1
# opponents' slots (the learner's own slot is not read)
RECORD_BYTES = 4 + 4 * 4 + 4 * 3


def window_logs(dev, g, T: int, E_: int, L: int, P: int, rate: float) -> tuple:
    """One rollout's pool-record inputs: completed [T, E] f32 at ``rate``,
    placements [T, E, P] (a permutation of 1..P), the learner's seat [T, E]
    (-1 in the learner block), the opponents' slots [T, E, P]."""
    completed = (torch.rand(T, E_, generator=g, device=dev) < rate).to(torch.float32)
    seat = torch.randint(0, P, (T, E_), generator=g, device=dev, dtype=torch.int32)
    seat[:, :L] = -1
    outcome = (torch.argsort(torch.rand(T, E_, P, generator=g, device=dev), dim=-1) + 1)
    slots = torch.randint(0, 8, (T, E_, P), generator=g, device=dev, dtype=torch.int32)
    return completed, outcome.to(torch.int32), seat, slots


def records_run(fn, book: WindowBook, logs: list, capacity: int, L: int) -> tuple:
    """A window of appends through ``fn`` (K18 or its plain version), the
    first-update flag cleared after each as K19 clears it: (count, rows
    [:min(count, capacity)] on the host)."""
    book.start(capacity)
    for c, o, s_, sl in logs:
        fn(book, c, o, s_, sl, L)
        book.first.zero_()
    total = int(book.total)
    return total, book.rows[:min(total, capacity)].cpu()


def check_window_records(dev, g) -> dict:
    """K18 against its plain version bit for bit, on one book: two windows
    of 8 appends in a row at the flagship shape (Skull, 4 players, T = 64,
    E = 4096, Ep = 1229, C = 78,656) and a window whose capacity (500
    rows) overflows; one append timed (the first-update flag set, so each
    call starts the buffer)."""
    P, L = 4, E - EP_SKULL
    out = {}
    rows = record_capacity(W_FLAG, T_FLAG, EP_SKULL)
    runs = (("kernel", window_records), ("plain", window_records_plain))
    books = {who: WindowBook(dev, P, record_rows=rows) for who, _ in runs}
    for name, rate, capacity in (("flagship_W8", 0.03, rows), ("flagship_W8_again", 0.03, rows),
                                 ("overflow_C500", 0.3, 500)):
        logs = [window_logs(dev, g, T_FLAG, E, L, P, rate) for _ in range(W_FLAG)]
        res = {who: records_run(fn, books[who], logs, capacity, L) for who, fn in runs}
        kt, kr = res["kernel"]
        for who, (t, r) in res.items():
            if t != kt or not torch.equal(r, kr):
                raise AssertionError(f"window_records {name}: count {kt} against the {who} "
                                     f"{t}, rows equal {torch.equal(r, kr)}")
        if (capacity == 500) != (kt > capacity):
            raise AssertionError(f"window_records {name}: {kt} games for a capacity of {capacity}")
        out[name] = {"games": kt, "rows": len(kr), "overflow": max(kt - capacity, 0),
                     "capacity": capacity, "equal_bit_for_bit": [who for who, _ in runs]}
    logs = window_logs(dev, g, T_FLAG, E, L, P, 0.03)
    for b in books.values():
        b.start(rows)
    games = int(((logs[0][:, L:] > 0) & (logs[2][:, L:] >= 0)).sum())

    def new():
        window_records(books["kernel"], *logs, L)

    out.update(timed(new, lambda: window_records_plain(books["plain"], *logs, L)))
    out.update(library_ms=None, games_per_update=games, max_abs_err=0.0,
               empty_kernel_device_ms=device_ms(empty_kernel())[0],
               **bound(T_FLAG * EP_SKULL * 4 + games * (RECORD_BYTES + 2 * P - 1)))
    return out


def report_inputs(dev, g, P: int = 4) -> tuple:
    """An update's outputs as the update graph makes them: 14 metric means
    and the minibatch count as views of one tensor, the explained
    variance, the guards and the learner's valid share apart, and the
    episode summaries as views of K10's output."""
    sums = torch.rand(15, generator=g, device=dev)
    metrics = dict(zip([f"m{i}" for i in range(14)], sums[:14]))
    metrics.update(approx_kl=sums[3], clip_fraction=sums[4], num_minibatch_updates=sums[14],
                   explained_variance=torch.rand((), generator=g, device=dev),
                   invalid_mask_count=torch.zeros((), device=dev),
                   nonfinite_count=torch.zeros((), device=dev),
                   learner_valid_fraction=torch.rand((), generator=g, device=dev))
    out = torch.rand(5 + 2 * P, generator=g, device=dev) * 100
    stats = {"count": out[0], "ret_sum": out[1:1 + P], "ret0_max": out[P + 1],
             "ret0_min": out[P + 2], "len_sum": out[P + 3], "pts_sum": out[P + 4:2 * P + 4],
             "draws": out[2 * P + 4]}
    return metrics, stats, sums, out


def check_window_report(dev, g) -> dict:
    """K19 against its plain version bit for bit over a window of 8 folds
    of fresh outputs (a KL spike in the fourth, a guard count in the
    second, an update with no episode: extrema -inf / +inf); one fold
    timed, beside an empty kernel's launch (the floor)."""
    P = 4
    metrics, stats, sums, out = report_inputs(dev, g, P)
    folds = [("kernel", lambda b, f: window_report(b, f)),
             ("plain", lambda b, f: window_report_plain(b, f))]
    books = {who: WindowBook(dev, P) for who, _ in folds}
    for b in books.values():
        b.start()
    for w in range(W_FLAG):
        sums.copy_(torch.rand(15, generator=g, device=dev))
        out.copy_(torch.rand(5 + 2 * P, generator=g, device=dev) * 100)
        if w == 3:
            sums[3] = 7.5
        if w == 5:
            out[0], out[P + 1], out[P + 2] = 0.0, float("-inf"), float("inf")
        metrics["invalid_mask_count"].fill_(2.0 if w == 1 else 0.0)
        for who, fold in folds:
            fold(books[who], books[who].fields(metrics, stats))
    for who, b in books.items():
        if not torch.equal(b.acc, books["kernel"].acc) or int(b.first) != 0:
            raise AssertionError(f"window_report: the kernel's report differs from the {who} one")
    m, st, _ = books["kernel"].fetch()
    if m["approx_kl_max"] != 7.5 or m["invalid_mask_count"] != 2.0:
        raise AssertionError(f"window_report: maxima and sums {m}")
    fields = books["kernel"].fields(metrics, stats)
    entries = sum(t.numel() for t, _ in fields)
    res = {"fields": len(fields), "entries": entries, "report": {**m, **{
        k: (v.tolist() if isinstance(v, np.ndarray) else v) for k, v in st.items()}},
        "equal_bit_for_bit": [who for who, _ in folds]}

    def new():
        window_report(books["kernel"], fields)

    floor = empty_kernel()
    res.update(timed(new, lambda: window_report_plain(books["plain"], fields)),
               empty_kernel_turns=turns(new, floor, who="empty_kernel"))
    res.update(library_ms=None, max_abs_err=0.0, **bound(entries * 4 * 3 + 4))
    return res


def one_window_profile(run_window) -> dict:
    """One pool window under the profiler: its events span (CUDA events
    around the whole call, fetch included), the union of its device
    intervals, and K18's and K19's device launches counted by name."""
    act = torch.profiler.ProfilerActivity
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
        start.record()
        run_window()
        end.record()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, last = 0.0, float("-inf")
    for a, b in spans:
        if b > last:
            busy += b - max(a, last)
            last = b
    counts = {n: sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                     and k in e.name)
              for n, k in (("window_records", "window_records_kernel"),
                           ("window_report", "window_report_kernel"))}
    return {"events_ms": start.elapsed_time(end), "device_ms": busy / 1e3,
            "device_launches": counts}


def flagship_trainer(tmp: Path, name: str, compute_dtype=None) -> Trainer:
    """configs/skull_ctde_tpu.toml at full width on the card (with
    ``compute_dtype``), its pool holding 8 freshly initialised opponents
    (checkpoints 1-8, each a network seeded 1000 + i), the learner back at
    its own initial parameters."""
    cfg = Config.load(FLAGSHIP)
    cfg.compute_dtype = compute_dtype
    tr = Trainer(cfg, tmp / name, device="cuda", quiet=True)
    net = tr.state.network
    keep = [p.detach().clone() for p in net.parameters()]
    with torch.no_grad():
        for i in range(FLAGSHIP_OPPONENTS):
            fresh = build_network_for_env(tr.env, cfg, torch.Generator().manual_seed(1000 + i))
            for p, q in zip(net.parameters(), fresh.parameters()):
                p.copy_(q)
            tr.global_step = i + 1
            tr.save_checkpoint()
        for p, q in zip(net.parameters(), keep):
            p.copy_(q)
    tr.global_step = 0
    return tr


def trainer_leaves(tr: Trainer) -> list:
    st = tr.state
    return ([p.detach() for p in st.network.parameters()]
            + [st.opt_state.flat_mu, st.opt_state.flat_nu, st.opt_state.count_tensor]
            + state_leaves(st.carry) + state_leaves(tr.seating))


def window_against_sequential(tmp: Path) -> tuple:
    """A pool window of W = 8 (``Trainer.pool_window``: K18 and K19 in the
    update graphs, one fetch, one fold) against 8 sequential pool steps of
    a book-less ``make_pool_train_step`` with the same rotation, from the
    same start state and generator state (two trainers built alike): the
    parameters, the optimizer state, the carry and the seating bit for
    bit, the window's rows those of ``extract_pool_records`` over the 8
    steps' logs, its report the last step's metrics and the steps' KL
    maximum. Returns (the result, the window's trainer)."""
    from types import SimpleNamespace

    a, b = flagship_trainer(tmp, "window"), flagship_trainer(tmp, "sequential")
    rows_a = []
    apply = a._apply_pool_records
    a._apply_pool_records = lambda rows, names: (rows_a.append(rows), apply(rows, names))[1]
    stack_a, names_a = a.rotate()
    stack_b, names_b = b.rotate()
    if names_a != names_b or len(names_a) != FLAGSHIP_OPPONENTS:
        raise AssertionError(f"the two pools rotated {names_a} and {names_b}")
    sched = a.schedule(W_FLAG)
    metrics_a, _ = a.pool_window(stack_a, names_a, sched)
    step = make_pool_train_step(b.env, b.cfg, b.num_learner_envs)
    logs, kls = [], []
    for lr, ec, sc in sched:
        b.state, b.seating, m, _, rec = step(b.state, b.seating, stack_b, len(names_b), lr, ec,
                                             b.rng, sc)
        logs.append({k: v.cpu().numpy() for k, v in rec.__dict__.items()})
        kls.append(float(m["approx_kl"]))
    rows_b = extract_pool_records(SimpleNamespace(
        **{k: np.concatenate([x[k] for x in logs]) for k in logs[0]}), 4)
    cap = record_capacity(W_FLAG, T_FLAG, EP_SKULL)
    differ = [i for i, (x, y) in enumerate(zip(trainer_leaves(a), trainer_leaves(b)))
              if not torch.equal(x, y)]
    if differ or not np.array_equal(rows_a[0], rows_b[:cap]):
        raise AssertionError(f"pool window against sequential steps: leaves {differ} differ, "
                             f"rows equal {np.array_equal(rows_a[0], rows_b[:cap])}")
    if metrics_a["approx_kl"] != kls[-1] or metrics_a["approx_kl_max"] != max(kls):
        raise AssertionError(f"the window's KL {metrics_a['approx_kl']}, max "
                             f"{metrics_a['approx_kl_max']}; the steps' {kls}")
    return {"leaves_equal": len(trainer_leaves(a)), "rows": len(rows_a[0]),
            "overflow": metrics_a["pool_record_overflow"], "approx_kl_steps": kls,
            "opponents": names_a}, a


def window_turns(tr: Trainer, rounds: int = 3) -> dict:
    """A pool window of 8 against 8 single-update rotations in turns
    (window, singles, singles, window, each round), host ms each. The
    singles are this tree's windows of one (``pool_rotation_interval =
    1``: each a rotation, an update with K18 and K19, and a fetch), the
    parent's cadence but not its code. The time saved an update is given
    as the median's difference and as the range over the rounds' pairs;
    then one window profiled, its idle share from that one trace."""
    def window():
        stack, names = tr.rotate()
        tr.pool_window(stack, names, tr.schedule(W_FLAG))

    def singles():
        for lr, ec, sc in tr.schedule(W_FLAG):
            tr.update(lr, ec, sc)

    ms = {"window": [], "singles": []}
    for name in ("window", "singles", "singles", "window") * rounds:
        fn = window if name == "window" else singles
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ms[name].append((time.perf_counter() - t0) * 1e3)
    median = lambda xs: sorted(xs)[len(xs) // 2]  # noqa: E731
    saved = (median(ms["singles"]) - median(ms["window"])) / W_FLAG
    pairs = [(s_ - w) / W_FLAG for w, s_ in zip(ms["window"], ms["singles"])]
    profile = one_window_profile(window)
    profile["idle_share"] = 1.0 - profile["device_ms"] / profile["events_ms"]
    if profile["device_launches"] != {"window_records": W_FLAG, "window_report": W_FLAG}:
        raise AssertionError(f"one pool window's K18 and K19 on the device: "
                             f"{profile['device_launches']}")
    return {"window_ms_turns": ms["window"], "singles_ms_turns": ms["singles"],
            "host_ms_saved_per_update_median": saved,
            "host_ms_saved_per_update_range": [min(pairs), max(pairs)], "one_window": profile}


def pool_window_phase(tmp: Path, card_line: str) -> dict:
    """Phase ``pool_window`` (in a process of its own): (a)
    configs/skull_ctde_tpu.toml unchanged at full width (4096 x 64, CTDE
    256x3, pool fraction 0.3, K = 8, W = 8) through the CLI for 24 updates:
    a self-play window of 8, a checkpoint, two pool windows of 8, each one
    rotation and one record fold; the windows, rotations, folds, rows,
    overflow and K18/K19 launches a window (graph replays), counted as in
    every train phase; (b) a pool window against 8 sequential pool steps
    bit for bit; (c) the window against 8 single-update rotations in
    turns, and one window profiled (K18 and K19 8 each on the device)."""
    t0 = time.time()
    seen = {"windows": [], "rotations": [], "folds": [], "per_window": []}
    originals = {k: getattr(Trainer, k) for k in ("_choose_window_k", "rotate",
                                                  "_apply_pool_records", "pool_window",
                                                  "self_play_window")}

    def choose(self, *a, **kw):
        k = originals["_choose_window_k"](self, *a, **kw)
        seen["windows"].append({"step": self.global_step, "k": k, "cap": kw.get("cap")})
        return k

    def rotate(self):
        seen["rotations"].append(self.global_step)
        return originals["rotate"](self)

    def fold(self, rows, names):
        seen["folds"].append({"step": self.global_step, "rows": int(len(rows))})
        return originals["_apply_pool_records"](self, rows, names)

    def counted(kind):
        def run(self, *a):
            before = [UpdateGraph.launches.get(w, 0) for w in (window_records, window_report)]
            m, st = originals[kind](self, *a)
            after = [UpdateGraph.launches.get(w, 0) for w in (window_records, window_report)]
            seen["per_window"].append({
                "kind": kind, "step": self.global_step, "window_records": after[0] - before[0],
                "window_report": after[1] - before[1],
                "overflow": m.get("pool_record_overflow")})
            return m, st
        return run

    patches = {"_choose_window_k": choose, "rotate": rotate, "_apply_pool_records": fold,
               "pool_window": counted("pool_window"),
               "self_play_window": counted("self_play_window")}
    for k, f in patches.items():
        setattr(Trainer, k, f)
    try:
        pool_updates = FLAGSHIP_UPDATES - W_FLAG
        run, series = train_phase(
            tmp / "flagship", ["--config", str(FLAGSHIP)], FLAGSHIP_UPDATES, E * T_FLAG,
            {"skull_step_autoreset": FLAGSHIP_UPDATES * T_FLAG,
             "masked_gumbel_sample": (FLAGSHIP_UPDATES + pool_updates) * T_FLAG,
             "opponent_actor_forward": pool_updates * T_FLAG,
             "gae_multiplayer_reverse_scan": FLAGSHIP_UPDATES, "window_records": pool_updates},
            card_line, as_configured=True)
    finally:
        for k, f in originals.items():
            setattr(Trainer, k, f)
    spu = E * T_FLAG
    want_windows = [{"step": 0, "k": 8, "cap": None}, {"step": 8 * spu, "k": 8, "cap": 8},
                    {"step": 16 * spu, "k": 8, "cap": 8}]
    if seen["windows"] != want_windows:
        raise AssertionError(f"windows {seen['windows']}, not {want_windows}")
    if seen["rotations"] != [8 * spu, 16 * spu] or [f["step"] for f in seen["folds"]] != [
            8 * spu, 16 * spu]:
        raise AssertionError(f"rotations {seen['rotations']}, folds {seen['folds']}")
    want_counts = [("self_play_window", 0, 8), ("pool_window", 8, 8), ("pool_window", 8, 8)]
    got_counts = [(w["kind"], w["window_records"], w["window_report"]) for w in seen["per_window"]]
    if got_counts != want_counts:
        raise AssertionError(f"K18/K19 launches a window {got_counts}, not {want_counts}")
    perf = {k: series.get(k) for k in ("perf/pool_rotation_time", "perf/pool_window_time",
                                       "perf/pool_record_time", "train/approx_kl_max",
                                       "train/clip_fraction_max", "train/approx_kl")}
    if any(not v or len(v) != 2 for k, v in perf.items() if k.startswith("perf/pool")):
        raise AssertionError(f"the pool series: {perf}")
    sequential, tr = window_against_sequential(tmp)
    turns = window_turns(tr)
    print(f"pool_window ({card_line}): windows {[w['k'] for w in seen['windows']]}, rotations at "
          f"{seen['rotations']}, folds {seen['folds']}, K18/K19 a window {got_counts}; one "
          f"window {turns['one_window']['events_ms']:.1f} events ms, "
          f"{turns['one_window']['device_ms']:.1f} device ms (idle "
          f"{turns['one_window']['idle_share']:.3f} under the profiler); window against singles "
          f"{turns['host_ms_saved_per_update_median']:.2f} ms an update saved (median), range "
          f"{turns['host_ms_saved_per_update_range']}", flush=True)
    return {"card": card_line, "config": str(FLAGSHIP.relative_to(ROOT)), "run": run,
            "windows": seen["windows"], "rotations": seen["rotations"], "folds": seen["folds"],
            "per_window": seen["per_window"], "series": perf,
            "window_vs_sequential": sequential, "turns": turns, "seconds": time.time() - t0}


# ---------------------------------------------------------------------------
# The bf16 compute dtype (A18)
# ---------------------------------------------------------------------------
BF16_FLAGS = ("--compute-dtype", "bfloat16")
BF16_POOL_UPDATES = 4  # Connect Four against the pool in bf16: K reaches 3
BF16_TURN_UPDATES = 3  # bench_skull_ctde train steps a turn
# cuBLAS's GEMM kernels by name (nvjet, sm90 xmma, cutlass, the SIMT sgemm)
GEMM_NAME = re.compile(r"gemm|nvjet|xmma|cutlass", re.IGNORECASE)
# the profile's lead-in (torch.cuda._sleep), not the update's
SLEEP_KERNEL = "spin_kernel"


def selfplay_pool_bf16(tmp: Path, card_line: str) -> dict:
    """Connect Four against the opponent pool with the bf16 compute dtype
    (configs/connect_four.toml: MLP 512x2, pool fraction 0.25, 4096 x 64,
    obs norm on), a checkpoint after every update, 4 updates (K = 1, 2, 3):
    the learner's bf16 layers, and K7 once a pool step, its bf16 tower
    (the pool stores bf16 weights for a run whose config.toml keeps the
    dtype; phase ``bf16`` tells the towers apart on the device)."""
    n = BF16_POOL_UPDATES
    run = tmp / "c4_pool_bf16"
    out, series = train_phase(
        run, ["--config", str(ROOT / "configs" / "connect_four.toml"), "--num-envs", str(E),
              "--num-steps", str(T_C4), "--normalize-obs", *BF16_FLAGS],
        n, E * T_C4,
        {"connect_four_step_autoreset": n * T_C4, "masked_gumbel_sample": (2 * n - 1) * T_C4,
         "opponent_actor_forward": (n - 1) * T_C4, "gae_multiplayer_reverse_scan": n,
         "window_records": n - 1, "obs_norm_apply": n * (T_C4 + 2), "obs_norm_update": n},
        card_line, checkpoint_freq=E * T_C4)
    if Config.load(run / "config.toml").compute_dtype != "bfloat16":
        raise AssertionError("the bf16 run's config.toml lost its compute dtype")
    out.update(learner_valid_share=series["train/learner_valid_fraction"],
               policy_loss=series["train/policy_loss"], value_loss=series["train/value_loss"])
    return out


def bench_trainer(tmp: Path, name: str, compute_dtype) -> Trainer:
    """A trainer at bench.py's bench_skull_ctde shape (``SKULL_BENCH``, no
    ``target_kl``: every update the same work, as bench.py times it)."""
    cfg = Config.load(ROOT / "configs" / "skull_ctde.toml")
    for k, v in {"num_envs": E, "num_steps": T_C4, "seed": 0, **SKULL_BENCH, "target_kl": None,
                 "compute_dtype": compute_dtype}.items():
        setattr(cfg, k, v)
    return Trainer(cfg, tmp / name, device="cuda", quiet=True)


def update_breakdown(tr: Trainer) -> dict:
    """One replay of the trainer's update graph under the profiler: the
    kernels' device ms, cuBLAS's GEMMs' ms and share of it (by kernel
    name), and the six longest kernels (trains on, as any update)."""
    act = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
        torch.cuda._sleep(PROFILE_LEAD_CYCLES)
        tr.train_step.updater.graph.replay()
        torch.cuda.synchronize()
    per: Counter = Counter()
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and SLEEP_KERNEL not in e.name:
            per[e.name] += e.time_range.elapsed_us()
    total = sum(per.values())
    gemm = sum(v for k, v in per.items() if GEMM_NAME.search(k))
    if not total:
        raise AssertionError("the profiler recorded no kernel in an update graph's replay")
    return {"device_ms": total / 1e3, "gemm_ms": gemm / 1e3, "gemm_share": gemm / total,
            "gemm_kernels": sorted({k[:100] for k in per if GEMM_NAME.search(k)}),
            "top": [[k[:100], v / 1e3] for k, v in per.most_common(6)]}


def bf16_label_costs(tr: Trainer, lr: float, ent: float) -> dict:
    """One eager bf16 update under the profiler: for each of the bf16
    layers' profiler labels (``models/core.py``: the roundings to bf16,
    the backward's f32 products), its calls, the device kernels launched
    inside it and their device ms."""
    from burn_ppo_torch.models.core import BF16_BACKWARD_PRODUCT, BF16_ROUND

    act = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
        tr.train_step.updater.eager(tr.state.network, tr.state.opt_state, tr.train_step.runner,
                                    tr.rng, lr, ent, tr.state.ent_state)
        torch.cuda.synchronize()
    out = {}
    for label in (BF16_ROUND, BF16_BACKWARD_PRODUCT):
        calls = [e for e in prof.events() if e.name == label
                 and e.device_type == torch.autograd.DeviceType.CPU]
        launches, us = 0, 0.0
        stack = list(calls)
        while stack:
            e = stack.pop()
            launches += len(e.kernels)
            us += sum(k.duration for k in e.kernels)
            stack.extend(e.cpu_children)
        out[label] = {"calls": len(calls), "launches": launches, "device_ms": us / 1e3}
    if not out[BF16_ROUND]["calls"] or not out[BF16_ROUND]["launches"]:
        raise AssertionError(f"no bf16 rounding seen in an eager bf16 update: {out}")
    return out


def bench_bf16_turns(tmp: Path) -> dict:
    """The bench_skull_ctde shape in f32 and in bf16: each trainer warmed
    by two updates (their graphs captured), then ``BF16_TURN_UPDATES``
    train steps (``Trainer.update``: rollout, update, fetch) a turn in
    turns (f32, bf16, bf16, f32), host ms each; then for each one replay
    of its update graph profiled (device ms, the GEMMs' share) and, for
    bf16, one eager update's roundings and backward products."""
    trainers = {"f32": bench_trainer(tmp, "bench_f32", None),
                "bf16": bench_trainer(tmp, "bench_bf16", "bfloat16")}
    cfg = trainers["f32"].cfg
    lr, ent = cfg.learning_rate.get(0), cfg.entropy_coef.get(0)
    for tr in trainers.values():
        for _ in range(2):
            tr.update(lr, ent, 0.0)
    ms = {k: [] for k in trainers}
    for k in ("f32", "bf16", "bf16", "f32"):
        for _ in range(BF16_TURN_UPDATES):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m, _ = trainers[k].update(lr, ent, 0.0)
            ms[k].append((time.perf_counter() - t0) * 1e3)
            if not all(math.isfinite(m[x]) for x in ("policy_loss", "value_loss", "entropy")):
                raise AssertionError(f"bench_skull_ctde {k}: non-finite losses {m}")
    median = lambda xs: sorted(xs)[len(xs) // 2]  # noqa: E731
    out = {"shape": "bench_skull_ctde: Skull, 4 players, CTDE 512x2 tanh, 4096 x 64, "
                    "4 epochs x 4 minibatches, no pool, no target_kl",
           "train_step_ms_turns": ms,
           "env_steps_per_s_median": {k: E * T_C4 / median(v) * 1e3 for k, v in ms.items()},
           "update_graph": {k: update_breakdown(tr) for k, tr in trainers.items()},
           "bf16_eager_update_labels": bf16_label_costs(trainers["bf16"], lr, ent)}
    return out


def flagship_bf16_window(tmp: Path) -> dict:
    """configs/skull_ctde_tpu.toml with the bf16 compute dtype
    (``flagship_trainer``: a pool of 8 freshly initialised opponents): one
    rotation, its stack's weights bf16, and one pool window of 8 updates,
    every launch counted as in the train phases (K7's bf16 tower 8 x 64,
    its f32 tower 0); then K7's bf16 tower counted on the device in one
    profiled replay of the rollout graph."""
    tr = flagship_trainer(tmp, "flagship_bf16", compute_dtype="bfloat16")
    for w in WRAPPERS.values():
        w.launches = 0
    RolloutGraph.reset_counts()
    UpdateGraph.reset_counts()
    stack, names = tr.rotate()
    if any(w.dtype != torch.bfloat16 for w in stack.weights):
        raise AssertionError("the bf16 flagship's rotation did not stack bf16 towers")
    t0 = time.time()
    metrics, _ = tr.pool_window(stack, names, tr.schedule(W_FLAG))
    torch.cuda.synchronize()
    wall = time.time() - t0
    eager = {name: w.launches for name, w in WRAPPERS.items()}
    graphed = {name: RolloutGraph.launches.get(w, 0) + UpdateGraph.launches.get(w, 0)
               for name, w in WRAPPERS.items()}
    warmup = {name: RolloutGraph.warmup_launches.get(w, 0) + UpdateGraph.warmup_launches.get(w, 0)
              for name, w in WRAPPERS.items()}
    main_path = {name: eager[name] - warmup[name] + graphed[name] for name in WRAPPERS}
    launched = W_FLAG * tr.cfg.num_epochs * tr.cfg.num_minibatches - UpdateGraph.skipped
    want = {name: 0 for name in WRAPPERS}
    want.update(skull_step_autoreset=W_FLAG * T_FLAG, masked_gumbel_sample=2 * W_FLAG * T_FLAG,
                opponent_actor_forward=W_FLAG * T_FLAG, gae_multiplayer_reverse_scan=W_FLAG,
                window_records=W_FLAG, window_report=W_FLAG, episode_stats=W_FLAG,
                ppo_loss=launched, clip_adam=launched)
    if main_path != want or eager != warmup:
        raise AssertionError(f"bf16 flagship window launches {main_path} != {want} (eager "
                             f"{eager}, warm-ups {warmup})")
    device = replay_kernel_counts(tr.pool_step.runner.graph, BF16_ROLLOUT_KERNELS)
    if device["counts"].get("opponent_actor_forward") != [T_FLAG, T_FLAG]:
        raise AssertionError(f"K7's bf16 tower on the device in one rollout replay: {device}")
    return {"window_s": wall, "opponents": names, "main_path": main_path,
            "approx_kl": metrics["approx_kl"], "approx_kl_max": metrics["approx_kl_max"],
            "overflow": metrics["pool_record_overflow"], "rollout_replay_kernel_counts": device,
            "run": {"launches": {name: eager[name] + graphed[name] for name in WRAPPERS}}}


# The update's dense layers at bench_skull_ctde's minibatch (4096 x 64 / 4
# rows): the CTDE actor 135 -> 512 x2 -> 33, the critic 335 -> 512 x2 -> 1.
DENSE_BF16_M = 65536
DENSE_BF16_SHAPES = ((135, 512), (512, 512), (512, 33), (335, 512), (512, 1))
DENSE_BF16_TOL = "|y - ref| <= 2^-14 (|ref| + max |ref|)"


def check_dense_bf16(dev) -> dict:
    """``models/core.py dense`` with the bf16 compute dtype on the card
    (cuBLAS's bf16 GEMM with an f32 output and the bias in its epilogue)
    at the update's shapes, against the f32 product of the bf16-rounded
    operands plus the bias (TF32 off): f32 sums in another order, within
    ``DENSE_BF16_TOL``; an f32 output whose entries are not bf16 values;
    and the control, the reference rounded to bf16, fails the limit."""
    from burn_ppo_torch.models.core import dense

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on: the f32 reference would not be f32")
    g = torch.Generator(device=dev).manual_seed(18)
    out = {"tol": DENSE_BF16_TOL, "rows": DENSE_BF16_M}
    for fan_in, fan_out in DENSE_BF16_SHAPES:
        lin = torch.nn.Linear(fan_in, fan_out, device=dev)
        with torch.no_grad():
            lin.weight.copy_(torch.randn(fan_out, fan_in, generator=g, device=dev)
                             / fan_in ** 0.5)
            lin.bias.copy_(torch.randn(fan_out, generator=g, device=dev))
            x = torch.randn(DENSE_BF16_M, fan_in, generator=g, device=dev)
            y = dense(lin, x, "bfloat16")
            ref = (x.to(torch.bfloat16).float() @ lin.weight.to(torch.bfloat16).float().t()
                   + lin.bias)
        scale = ref.abs() + ref.abs().max()
        rel = float(((y - ref).abs() / scale).max())
        control = float(((ref.to(torch.bfloat16).float() - ref).abs() / scale).max())
        bf16_values = float((y == y.to(torch.bfloat16).float()).float().mean())
        name = f"{fan_in}x{fan_out}"
        if y.dtype != torch.float32 or rel > 2.0**-14 or control <= 2.0**-14 or bf16_values >= 0.01:
            raise AssertionError(f"dense bf16 on the card at {name}: dtype {y.dtype}, error "
                                 f"{rel} of the scale, the bf16-rounded control {control}, "
                                 f"bf16 values {bf16_values}")
        out[name] = {"max_err_of_scale": rel, "control_bf16_output_err_of_scale": control,
                     "share_of_bf16_values": bf16_values}
    return out


def bf16_phase(tmp: Path, card_line: str) -> dict:
    """Phase ``bf16`` (in a process of its own): the bf16 dense on the card
    at the update's shapes (``check_dense_bf16``), the bench_skull_ctde
    shape in f32 and bf16 in turns with each update's breakdown
    (``bench_bf16_turns``), and the bf16 flagship's pool window
    (``flagship_bf16_window``)."""
    t0 = time.time()
    return {"card": card_line, "dense_card_route": check_dense_bf16(torch.device("cuda")),
            "bench_skull_ctde": bench_bf16_turns(tmp),
            "flagship_window": flagship_bf16_window(tmp), "seconds": time.time() - t0}


def k7_turns(dev, card_line: str, ptxas: list, parent: "ParentKernels | None") -> None:
    """``--only-k7``: K7's and K20's checks alone, with the parent beside
    them where it was built: the f32 tower at the four pool shapes (bit for
    bit the parent's, in turns), the bf16 tower at the three bf16 pool
    blocks, K20 (in turns with the parent's K20 and grouped convs) and the
    feature front in f32 and bf16 (each in turns with the parent's and
    with torch.bmm, device ms). The Skull and Liar's Dice obs are random
    rows of their widths (the times depend on the shapes and the slots,
    not on the values). One JSON line a check, then a summary."""
    g = torch.Generator(device=dev).manual_seed(0)
    skull_obs = connect_four_like(dev, g, E, D=135)
    ld_obs = connect_four_like(dev, g, E, D=LD_OBS)
    emit("k7_ptxas", card=card_line, ptxas=[ln for ln in ptxas if ln.startswith(
        ("opponent_tower", "opponent_features", "opponent_mlp", "opponent_cnn_front"))],
         parent_ptxas=None if parent is None else parent.ptxas)
    f32 = check_opponent_actor(dev, g, skull_obs, ld_obs, parent)
    emit("k7_f32_tower", card=card_line, **f32)
    bf = check_opponent_actor_bf16(dev, torch.Generator(device=dev).manual_seed(21), skull_obs,
                                   ld_obs, parent)
    emit("k7_bf16_tower", card=card_line, **bf)
    cnn = check_opponent_cnn(dev, torch.Generator(device=dev).manual_seed(22), parent)
    emit("k7_feature_front", card=card_line, **cnn)
    who = "" if parent is None else " against the parent's {}"
    for name in ("c4_Ep1024_K8_mlp512x2", "skull_Ep1229_K8_ctde256x3",
                 "liars_dice_Ep1024_K8_mlp512x3"):
        e = bf[name]
        mine = (e["parent_turns"]["device_ms_turns"] if parent is not None
                else e["bmm_bf16_turns"]["device_ms_turns"])
        print(f"bf16 tower {name} ({card_line}): device ms in turns {mine}"
              + who.format(e.get("parent_turns", {}).get("parent_device_ms"))
              + f", bmm bf16 {e['bmm_bf16_turns']['bmm_bf16_device_ms']}; bound "
              f"{e['bound_ms']}", flush=True)
    for key, row in cnn["opponent_cnn_front"].items():
        if key not in ("f32", "bf16"):
            continue
        turn = row.get("parent_k20_and_grouped_convs", {})
        print(f"K20 {key} ({card_line}): device ms {row['device_ms']}, events ms {row['ms']}, "
              f"graph ms {row['graph_ms']}; in turns {turn.get('device_ms_turns')} against the "
              f"parent's K20 + grouped convs {turn.get('parent_device_ms')} (graphs "
              f"{turn.get('graph_ms_turns')} against {turn.get('parent_graph_ms')}); bound "
              f"{row['bound_ms']}", flush=True)
    for key, row in (("f32", cnn["opponent_features_forward"]["f32"]),
                     ("bf16", cnn[CNN_BF16_TOWER]["bf16"])):
        mine = (row["parent_turns"]["device_ms_turns"] if parent is not None
                else row["bmm_turns"]["device_ms_turns"])
        print(f"feature front {key} ({card_line}): device ms in turns {mine}"
              + who.format(row.get("parent_turns", {}).get("parent_device_ms"))
              + f", bmm {row['bmm_turns']['bmm_device_ms']}; bound {row['bound_ms']}", flush=True)


def main(argv: list) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Smoke run of burn_ppo_torch on one NVIDIA GPU.")
    ap.add_argument("--parent", type=Path, default=None,
                    help="a checkout of the parent commit: its K7 towers and K20 are built "
                         "from it and timed in turns with this tree's, and so are its CartPole "
                         "and Connect Four vs-pool train phases, its train steps and its Skull "
                         "eval chunk")
    ap.add_argument("--only-k7", action="store_true",
                    help="build, then run K7's and K20's checks alone (with --parent, in turns "
                         "with the parent's) and stop, without the result line")
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    card_line = card()
    emit("device", nvidia_smi=card_line, torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0], name=torch.cuda.get_device_name(0))
    if set(WRAPPERS.values()) != set(kernels.WRAPPERS):
        raise AssertionError("the kernel table's wrappers are not the registered ones "
                             "(kernels.WRAPPERS)")

    t0 = time.time()
    lib_path = kernels.build()
    kernels.library()
    log = lib_path.with_suffix(".log")
    ptxas = ptxas_summary(log.read_text()) if log.exists() else []
    # ParentKernels binds the entry points as d19fb64 has them; a parent
    # whose kernel sources are this tree's has nothing to time against them.
    parent = None
    if args.parent is not None and not same_kernel_sources(args.parent.resolve()):
        parent = ParentKernels(args.parent.resolve())
    emit("build", seconds=time.time() - t0, library=str(lib_path.relative_to(ROOT)), ptxas=ptxas,
         parent_ptxas=None if parent is None else parent.ptxas,
         parent_kernels=None if args.parent is None else
         "built and timed in turns" if parent is not None else "the parent's csrc is this tree's")
    if args.only_k7:
        k7_turns(dev, card_line, ptxas, parent)
        return 0

    g = torch.Generator(device=dev).manual_seed(0)
    skull, skull_mask, skull_obs = check_skull(dev, g)
    liars_dice, ld_mask, ld_obs = check_liars_dice(dev, g, ptxas)
    samples = {
        "A2": check_sample(dev, g, 2),
        "A7": check_sample(dev, g, 7),
        "A33_skull": check_sample(dev, g, 33, skull_mask),
        "A49_liars_dice": check_sample(dev, g, 49, ld_mask),
        # the opponents' rows of the pool envs, [L:] of the step's mask
        "A49_liars_dice_opponents_Ep1024": check_sample(dev, g, 49, ld_mask[E - EP_LD:]),
        "A33_skull_opponents_Ep1229": check_sample(dev, g, 33, skull_mask[E - EP_SKULL:]),
    }
    apply_c4 = check_obs_norm_apply(dev, g, connect_four_like(dev, g, E), E * T_C4)
    apply_ld = check_obs_norm_apply(dev, g, ld_obs, E * T_LD)
    apply_batch = check_obs_norm_batch(dev, g)
    checks = {
        "cartpole_step_autoreset": check_cartpole(dev, g),
        "masked_gumbel_sample": {
            **samples, "max_abs_err": max(x["max_abs_err"] for x in samples.values()),
            # A = 7's: Connect Four's, the pool path's
            **{k: samples["A7"][k] for k in TIMES + ("library_ms", "bound_ms", "bound_by")},
        },
        "gae_reverse_scan": check_gae(dev, g, ptxas),
        "connect_four_step_autoreset": check_connect_four(dev, g, ptxas),
        "gae_multiplayer_reverse_scan": check_gae_multiplayer(dev, g, ptxas),
        "obs_norm_apply": {**apply_c4, "liars_dice_4096x270": apply_ld, "update_batch": apply_batch,
                           "max_abs_err": max(apply_c4["max_abs_err"], apply_ld["max_abs_err"],
                                              apply_batch["max_abs_err"]),
                           "ptxas": [ln for ln in ptxas if ln.startswith("obs_norm_")]},
        "obs_norm_update": check_obs_norm_update(dev, g),
        "opponent_actor_forward": check_opponent_actor(dev, g, skull_obs, ld_obs, parent),
        "ppo_loss": check_ppo_loss(dev, g),
        "clip_adam": {**check_clip_adam(dev, g), "ptxas": kernel_ptxas(ptxas, "clip_adam")},
        "episode_stats": check_episode_stats(dev, g, ptxas),
        "skull_step_autoreset": skull,
        "return_norm_roll": check_return_norm_roll(dev, g),
        "return_norm_finalize": check_return_norm_finalize(dev, g),
        "liars_dice_step_autoreset": liars_dice,
    }
    # K14 on a generator of its own, so that the inputs of the checks above
    # stay those of the earlier trees.
    g14 = torch.Generator(device=dev).manual_seed(14)
    _, c4_state, _ = connect_four_states(dev, g14)
    checks["temperature_sample"] = check_temperature_sample(
        dev, g14, ConnectFour().action_mask(c4_state), skull_mask, ld_mask, ptxas)
    # K17, the eval step's seating and records, on a generator of its own.
    checks.update(check_eval_step(dev, torch.Generator(device=dev).manual_seed(17), ptxas))
    # K18 and K19, the update window's records and report, on one of their own.
    g20 = torch.Generator(device=dev).manual_seed(20)
    checks["window_records"] = {**check_window_records(dev, g20),
                                "ptxas": kernel_ptxas(ptxas, "window_records")}
    checks["window_report"] = {**check_window_report(dev, g20),
                               "ptxas": kernel_ptxas(ptxas, "window_report")}
    # K7's bf16 tower, on a generator of its own.
    checks[BF16_TOWER] = {
        **check_opponent_actor_bf16(dev, torch.Generator(device=dev).manual_seed(21), skull_obs,
                                    ld_obs, parent),
        "ptxas": kernel_ptxas(ptxas, "opponent_tower_bf16")}
    # The CNN opponents (A12b): K20 and K7's feature front in both towers,
    # on a generator of their own.
    checks.update(check_opponent_cnn(dev, torch.Generator(device=dev).manual_seed(22), parent))
    checks["opponent_cnn_front"]["ptxas"] = kernel_ptxas(ptxas, "opponent_cnn_front")
    checks["opponent_features_forward"]["ptxas"] = kernel_ptxas(ptxas, "opponent_features")
    checks[CNN_BF16_TOWER]["ptxas"] = kernel_ptxas(ptxas, "opponent_features_bf16")
    # The env steps with K14's sampling front, on a generator of their own:
    # each beside its step's own checks, its error in the step's.
    fronts = check_sample_steps(dev, torch.Generator(device=dev).manual_seed(19), ptxas)
    for name, res in fronts.items():
        checks[name]["sample_front"] = res
        checks[name]["max_abs_err"] = max(checks[name]["max_abs_err"], res["max_abs_err"])
    # Phase popart: K15, K16 and K8 with PopArt and the controller, on a
    # generator of their own.
    popart = check_popart(dev, torch.Generator(device=dev).manual_seed(16))
    # K2's value epilogue, on a generator of its own.
    popart["masked_gumbel_sample_popart_epilogue"] = check_sample_popart_epilogue(
        dev, torch.Generator(device=dev).manual_seed(20))
    popart["rollout_k2_epilogue_vs_k2_then_k16"] = popart_rollout_routes(dev)
    for name in ("popart_update", "popart_denormalize"):
        checks[name] = popart[name]
    popart["ptxas"] = [ln for ln in ptxas if ln.startswith("popart_")]
    checks["ppo_loss"]["max_abs_err"] = max(checks["ppo_loss"]["max_abs_err"],
                                            popart["ppo_loss_popart_entropy"]["max_abs_err"])
    screen_device_times(checks)
    emit("kernels_vs_plain", card=card_line,
         **{k: v for k, v in checks.items() if k not in popart})
    emit("popart", card=card_line, **popart)
    emit("graph_capture", card=card_line, **check_graph_capture(dev, g, ld_obs))
    emit("rollout_graphs", card=card_line, **check_rollout_graphs(dev, g, checks))
    emit("update_graphs", **phase_in_process(ROOT, "update_graph_cases"))
    if args.parent is not None:
        emit("update_turns", card=card_line, **update_turns(args.parent.resolve()))

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as d:
        runs = {
            "bench_train": bench_train(Path(d), card_line),
            "selfplay_train": selfplay_train(Path(d), card_line, "mlp", BENCH_UPDATES),
            "selfplay_train_cnn": selfplay_train(Path(d), card_line, "cnn", CNN_UPDATES),
            "selfplay_pool": selfplay_pool_train(Path(d), card_line),
            "skull_ctde_selfplay": skull_selfplay_train(Path(d), card_line),
            # CTDE 256x3 relu, pool fraction 0.3: L = 2867 learner envs,
            # Ep = 1229 pool envs
            "skull_ctde_pool": four_player_pool_train(
                Path(d), card_line, "skull_pool", ["--config", str(ROOT / "configs" / "skull_ctde.toml")],
                "skull_step_autoreset", T_SKULL_POOL, EP_SKULL, POOL_UPDATES, "ctde", 135),
            # CTDE actor 256x2, critic 512x3, relu, shaping 0.05, pool
            # fraction 0.25: L = 3072, Ep = 1024
            "liars_dice_ctde_pool": four_player_pool_train(
                Path(d), card_line, "liars_dice_pool",
                ["--config", str(ROOT / "configs" / "liars_dice_ctde.toml")],
                "liars_dice_step_autoreset", T_LD, EP_LD, POOL_UPDATES, "ctde", LD_OBS),
            # the MLP 512x3 relu against the pool with obs norm: K6 at width
            # 270 on the learner's obs, K7 with MLP towers and each slot's
            # obs normaliser
            "liars_dice_mlp_pool": four_player_pool_train(
                Path(d), card_line, "liars_dice_mlp_pool",
                ["--config", str(ROOT / "configs" / "liars_dice.toml"), "--normalize-obs"],
                "liars_dice_step_autoreset", T_LD, EP_LD, LD_UPDATES_MLP, "mlp", LD_OBS,
                {"obs_norm_apply": LD_UPDATES_MLP * (T_LD + 2), "obs_norm_update": LD_UPDATES_MLP}),
            # the bf16 compute dtype: Connect Four against the pool (K7's bf16
            # tower) and the CNN's self-play
            "selfplay_pool_bf16": selfplay_pool_bf16(Path(d), card_line),
            "selfplay_train_cnn_bf16": selfplay_train(Path(d), card_line, "cnn", CNN_UPDATES,
                                                      BF16_FLAGS),
            # the CNN against the pool (A12b): K20 and
            # K7's feature front, f32 to K = 8, then bf16
            "selfplay_pool_cnn": selfplay_pool_cnn(Path(d), card_line),
            "selfplay_pool_cnn_bf16": selfplay_pool_cnn(Path(d), card_line, bf16=True),
        }
        for phase, out in runs.items():
            emit(phase, **out)
        # The flagship config's update windows, in a process of its own.
        pool_window = phase_in_process(ROOT, "pool_window_phase")
        emit("pool_window", **pool_window)
        runs["pool_window"] = pool_window["run"]
        # The bf16 compute dtype at the bench_skull_ctde shape and on the
        # flagship's pool window, in a process of its own.
        bf16 = phase_in_process(ROOT, "bf16_phase")
        med, up = bf16["bench_skull_ctde"]["env_steps_per_s_median"], bf16["bench_skull_ctde"][
            "update_graph"]
        print(f"bf16 ({card_line}): bench_skull_ctde env-steps/s f32 {med['f32']:.0f}, bf16 "
              f"{med['bf16']:.0f}; update graph device ms f32 {up['f32']['device_ms']:.2f} "
              f"(GEMMs {up['f32']['gemm_share']:.3f}), bf16 {up['bf16']['device_ms']:.2f} "
              f"(GEMMs {up['bf16']['gemm_share']:.3f}); K7's bf16 tower on the flagship window "
              f"{bf16['flagship_window']['main_path']['opponent_actor_forward']} launches",
              flush=True)
        emit("bf16", **bf16)
        runs["bf16_flagship_window"] = bf16["flagship_window"]["run"]
        # PopArt and the adaptive entropy controller on two training paths.
        pe = popart_entropy_train(Path(d), card_line)
        emit("popart_entropy_train", **pe)
        runs["popart_cartpole"] = pe["cartpole"]
        runs["popart_liars_dice_pool"] = pe["liars_dice_ctde_pool"]
        idle = phase_in_process(ROOT, "update_idle_shares")
        emit("update_idle_share", **idle)
        cnn, cnn_idle = runs["selfplay_pool_cnn"], idle["connect_four_pool_cnn"]
        print(f"selfplay_pool_cnn ({card_line}): updates "
              + ", ".join(f"{x:.1f}" for x in cnn["update_ms_host"]) + " ms on the host's clock "
              f"(K = 8 at the last two); one update at K = 8 {cnn_idle['update_ms']:.1f} ms, "
              f"device busy {cnn_idle['device_busy_ms']:.1f} ms, idle share "
              f"{cnn_idle['idle_share']:.3f}", flush=True)
        split = cnn_idle["rollout_split"]
        print(f"CNN vs-pool rollout replay ({card_line}): {split['device_ms']:.3f} device ms; "
              + ", ".join(f"{k} {v['launches']} launches {v['device_ms']:.3f} ms"
                          for k, v in split["groups"].items()), flush=True)
        # The supervised runs go on while phase resume runs.
        supervised = supervisor_start(Path(d))
        emit("resume", **resume_phase(Path(d), card_line))
        emit("supervisor", **supervisor_finish(supervised, card_line))
        # The front ends, through cli.main, in one process of their own.
        front = phase_in_process(ROOT, "front_end_phases")
        front = {k: front[k] for k in ("eval", "tournament", "interactive", "interop")}
        watched = front["eval"]["watch"]["connect_four"]
        print("\n".join(["watched connect_four game:"] + watched["move_lines"]
                         + watched["final"]), flush=True)
        for env_name in TOURNAMENT_GAMES:
            for seed in TOURNAMENT_SEEDS:
                t = front["tournament"][env_name][f"seed_{seed}"]
                print(f"tournament {env_name} seed {seed}: {t['seconds']:.1f} s, pods "
                      f"{t['pods_by_logits']}, graphs {t['graph_captures']} captured "
                      f"{t['graph_replays']} replayed; "
                      + "; ".join(f"{e['name']} {e['rating']:.1f}±{e['sigma']:.1f} (JAX "
                                  f"{e['jax_rating']:.1f}±{e['jax_sigma']:.1f})"
                                  for e in t["ratings"]), flush=True)
        print("interactive routes, median ms: " + ", ".join(
            f"{k} {v:.2f}" for k, v in front["interactive"]["route_median_ms"].items()),
            flush=True)
        for phase, res in front.items():
            emit(phase, **res)
        if args.parent is not None:
            emit("eval_chunk_turns", card=card_line, **chunk_tree_turns(args.parent.resolve()))
        if args.parent is not None:
            for name, phase in (("bench_train_turns", "bench_train"),
                                ("bench_selfplay_pool_turns", "selfplay_pool_train")):
                emit(name, card=card_line, **train_turns(args.parent.resolve(), phase))
        bar = learning_bar(Path(d))
        emit("learning_bar", card=card_line, **bar)
        bar_bf16 = learning_bar(Path(d), BF16_FLAGS)
        print(f"learning bar ({card_line}): f32 avg_return {bar['avg_return']:.2f}, with "
              f"--compute-dtype bfloat16 {bar_bf16['avg_return']:.2f}", flush=True)
        emit("learning_bar_bf16", card=card_line, **bar_bf16, f32_avg_return=bar["avg_return"])
        emit("learning_bar_popart", card=card_line, **learning_bar_popart(Path(d)))

    KERNEL_KEYS = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    # Launches: the sum over the train phases (phase popart_entropy_train's
    # two, the bf16 runs and phase bf16's flagship window among them) and the
    # front ends' runs, each counted from 0.
    # K7's launches in the bf16 runs are its bf16 tower's (its own row),
    # the others its f32 tower's.
    table = [
        {
            "name": name, "route": "cuda", "source": SOURCES[name][0],
            "replaces": SOURCES[name][1],
            "launches": sum(r["launches"][name] for k, r in runs.items()
                            if (name != "opponent_actor_forward" or k not in BF16_RUNS)
                            and (name != "opponent_features_forward" or k not in CNN_BF16_RUNS))
            + sum(f["launches_total"][name] for f in front.values()),
            **{k: checks[name][k] for k in KERNEL_KEYS},
            # an env step's instance with K14's sampling front (eval's),
            # launched by the same wrapper: its own check and times
            **({"sample_front": {"replaces": SAMPLE_FRONT_REPLACES,
                                 **{k: checks[name]["sample_front"][k] for k in KERNEL_KEYS}}}
               if "sample_front" in checks[name] else {}),
        }
        for name in WRAPPERS
    ]
    table.append({"name": BF16_TOWER, "route": "cuda", "source": SOURCES[BF16_TOWER][0],
                  "replaces": SOURCES[BF16_TOWER][1],
                  "launches": sum(runs[k]["launches"]["opponent_actor_forward"] for k in BF16_RUNS),
                  **{k: checks[BF16_TOWER][k] for k in KERNEL_KEYS}})
    table.append({"name": CNN_BF16_TOWER, "route": "cuda", "source": SOURCES[CNN_BF16_TOWER][0],
                  "replaces": SOURCES[CNN_BF16_TOWER][1],
                  "launches": sum(runs[k]["launches"]["opponent_features_forward"]
                                  for k in CNN_BF16_RUNS),
                  **{k: checks[CNN_BF16_TOWER][k] for k in KERNEL_KEYS}})
    unlaunched = [row["name"] for row in table if not row["launches"]]
    if unlaunched:
        raise AssertionError(f"kernels the main paths never launched: {unlaunched}")
    print(json.dumps({"kernels": table}))
    print(card_line)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    os.chdir(ROOT)
    raise SystemExit(main(sys.argv[1:]))

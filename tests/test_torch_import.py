"""The port's package boundary: no JAX, no silent CPU, CPU tensors take
the plain path of every kernel wrapper."""

import ast
import ctypes
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from burn_ppo_torch import kernels  # noqa: E402
from burn_ppo_torch.device import resolve_device  # noqa: E402
from burn_ppo_torch.envs.base import EpisodeAccumulator  # noqa: E402
from burn_ppo_torch.envs.cartpole import CartPole, cartpole_step_autoreset  # noqa: E402
from burn_ppo_torch.envs.connect_four import ConnectFour, connect_four_step_autoreset  # noqa: E402
from burn_ppo_torch.envs.liars_dice import LiarsDice, liars_dice_step_autoreset  # noqa: E402
from burn_ppo_torch.envs.skull import Skull, skull_step_autoreset  # noqa: E402
from burn_ppo_torch.ops.categorical import masked_sample, sample_with_temperature  # noqa: E402
from burn_ppo_torch.ops.gae import compute_gae, compute_gae_multiplayer  # noqa: E402
from burn_ppo_torch.envs.base import EpisodeLog  # noqa: E402
from burn_ppo_torch.ppo.episode_stats import summarize_episode_logs  # noqa: E402
from burn_ppo_torch.ppo.normalization import (  # noqa: E402
    ObsNormState,
    ReturnNormState,
    obs_norm_apply,
    obs_norm_update,
    return_norm_finalize,
    return_norm_roll,
)
from burn_ppo_torch.ppo.pool_rollout import OpponentStack, opponent_actor_forward  # noqa: E402
from burn_ppo_torch.ppo.update import LossBook, PPOUpdateConfig, clip_adam, ppo_loss  # noqa: E402

WRAPPERS = (cartpole_step_autoreset, connect_four_step_autoreset, masked_sample, compute_gae,
            compute_gae_multiplayer, obs_norm_apply, obs_norm_update, opponent_actor_forward,
            ppo_loss, clip_adam, summarize_episode_logs, skull_step_autoreset, return_norm_roll,
            return_norm_finalize, sample_with_temperature)

REPO = Path(__file__).resolve().parent.parent


def test_every_module_imports_with_jax_blocked():
    # A subprocess: conftest has already imported jax into this one.
    code = textwrap.dedent(
        """
        import importlib, pkgutil, sys
        for name in ("jax", "jaxlib", "flax", "optax", "burn_ppo_tpu"):
            sys.modules[name] = None
        import burn_ppo_torch
        names = ["burn_ppo_torch"]
        for m in pkgutil.walk_packages(burn_ppo_torch.__path__, "burn_ppo_torch."):
            if m.name != "burn_ppo_torch.__main__":
                names.append(m.name)
        for n in names:
            importlib.import_module(n)
        leaked = sorted(k for k in sys.modules
                        if k.split(".")[0] in ("jax", "flax", "optax", "burn_ppo_tpu")
                        and sys.modules[k] is not None)
        assert not leaked, leaked
        print(len(names))
        """
    )
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 30  # every module was walked


def _imported_roots(path: Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_no_source_of_the_port_or_chip_smoke_imports_jax_or_the_jax_package():
    """Every import statement, also those inside functions, that the
    subprocess above would not reach."""
    files = sorted((REPO / "burn_ppo_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) >= 30
    for path in files:
        bad = _imported_roots(path) & {"jax", "jaxlib", "flax", "optax", "burn_ppo_tpu"}
        assert not bad, f"{path.relative_to(REPO)} imports {sorted(bad)}"


def test_resolve_device_refuses_missing_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_cpu_tensors_take_the_plain_path_and_count_no_launch():
    rng = np.random.default_rng(0)
    before = [w.launches for w in WRAPPERS]
    cpu = torch.device("cpu")
    env = CartPole()
    E = 8
    state = env.reset(torch.from_numpy(rng.uniform(-0.05, 0.05, (E, 4)).astype(np.float32)))
    out = env.step_autoreset(
        state,
        EpisodeAccumulator.zero(E, 1, cpu),
        torch.zeros(E, dtype=torch.int32),
        torch.zeros(E, 4),
    )
    assert out.obs.shape == (E, 5) and out.rewards.shape == (E, 1)
    c4 = ConnectFour()
    out = c4.step_autoreset(c4.reset(torch.empty(E, 0)), EpisodeAccumulator.zero(E, 2, cpu),
                            torch.full((E,), 3, dtype=torch.int32), torch.empty(E, 0))
    assert out.obs.shape == (E, 86) and out.mask.shape == (E, 7)
    actions, logp = masked_sample(
        torch.zeros(E, 2), torch.ones(E, 2), torch.full((E, 2), 0.5)
    )
    assert actions.dtype == torch.int32 and logp.shape == (E,)
    adv, ret = compute_gae(torch.ones(4, E), torch.zeros(4, E), torch.zeros(4, E),
                           torch.zeros(E), 0.99, 0.95)
    assert adv.shape == ret.shape == (4, E)
    adv, ret = compute_gae_multiplayer(torch.ones(4, E, 2), torch.zeros(4, E), torch.zeros(4, E),
                                       torch.zeros(4, E, dtype=torch.int32), torch.zeros(E, 2),
                                       0.99, 0.95)
    assert adv.shape == ret.shape == (4, E)
    norm = obs_norm_update(ObsNormState.create(5, cpu), torch.ones(4, E, 5))
    assert obs_norm_apply(norm, torch.ones(E, 5)).shape == (E, 5)
    stack = OpponentStack(weights=[torch.ones(3, 5, 4), torch.ones(3, 4, 2)],
                          biases=[torch.zeros(3, 4), torch.zeros(3, 2)], activation="tanh")
    assert opponent_actor_forward(torch.ones(E, 5), torch.zeros(E, dtype=torch.int32),
                                  stack).shape == (E, 2)
    mb = {"actions": torch.zeros(E, dtype=torch.int32), "old_log_probs": torch.zeros(E),
          "advantages": torch.arange(E, dtype=torch.float32), "returns": torch.zeros(E),
          "old_values": torch.zeros(E), "valid": torch.ones(E)}
    loss, metrics = ppo_loss(torch.zeros(E, 2), torch.zeros(E), mb, torch.tensor(0.01),
                             PPOUpdateConfig(), LossBook.create(cpu))
    assert loss.shape == () and metrics.shape == (14,)
    params = torch.ones(6)
    count = torch.zeros((), dtype=torch.int32)
    clip_adam(params, torch.ones(6), torch.zeros(6), torch.zeros(6), lr=torch.tensor(0.1),
              count=count, run=torch.ones((), dtype=torch.int32), max_grad_norm=0.5, eps=1e-5)
    assert bool(torch.all(params < 1.0)) and int(count) == 1
    logs = EpisodeLog(completed=torch.ones(2, E), total_rewards=torch.zeros(2, E, 2),
                      length=torch.ones(2, E, dtype=torch.int32),
                      outcome=torch.ones(2, E, 2, dtype=torch.int32),
                      active_players=torch.full((2, E), 2, dtype=torch.int32))
    assert float(summarize_episode_logs(logs, 2, num_envs=3)["count"]) == 6
    sk = Skull(4)
    out = sk.step_autoreset(sk.reset(torch.empty(E, 0)), EpisodeAccumulator.zero(E, 4, cpu),
                            torch.full((E,), 1, dtype=torch.int32), torch.empty(E, 0),
                            torch.full((E,), 0.5))
    assert out.obs.shape == (E, 135) and out.mask.shape == (E, 33) and out.priv.shape == (E, 200)
    ret, samples = return_norm_roll(torch.zeros(E, 4), torch.ones(E),
                                    torch.zeros(E, dtype=torch.int32), torch.zeros(E), 0.99)
    assert ret.shape == (E, 4) and samples.shape == (E,)
    rn, norm_r = return_norm_finalize(ReturnNormState.create(E, 4, cpu), torch.ones(3, E),
                                      torch.ones(3, E))
    assert norm_r.shape == (3, E) and float(rn.count) == 3 * E
    after = [w.launches for w in WRAPPERS]
    assert before == after == [0] * len(WRAPPERS)


def test_wrappers_refuse_mixed_and_unknown_devices():
    with pytest.raises(ValueError, match="mixed devices"):
        kernels.on_cpu(torch.zeros(1), torch.zeros(1, device="meta"))
    with pytest.raises(ValueError, match="no kernel"):
        kernels.on_cpu(torch.zeros(1, device="meta"))


def test_kernel_library_is_content_addressed_under_the_repo_cache():
    path = kernels.library_path()
    assert path.parent == REPO / ".cache" / "burn_ppo_torch" / "kernels"
    assert {p.name for p in kernels.sources()} >= {
        "cartpole_step.cu", "masked_gumbel_sample.cu", "gae.cu", "connect_four_step.cu",
        "gae_multiplayer.cu", "obs_norm.cu", "opponent_actor.cu", "ppo_loss.cu", "clip_adam.cu",
        "episode_stats.cu", "skull_step.cu", "return_norm.cu",
    }
    assert {name for name in kernels.SIGNATURES} >= {
        "opp_mlp_forward", "ppo_loss_forward", "clip_adam", "episode_stats",
        "skull_step_autoreset", "return_norm_roll", "return_norm_finalize"}
    assert "sm_90a" in " ".join(kernels.NVCC_FLAGS)
    assert "--use_fast_math" not in kernels.NVCC_FLAGS


def test_liars_dice_takes_the_plain_path_on_cpu_and_its_kernel_is_bound():
    from burn_ppo_torch.envs.base import ARENA_ALIGN as ALIGN
    from burn_ppo_torch.envs.base import arena_size as _arena_size
    from burn_ppo_torch.envs.base import carve_arena as _carve
    from burn_ppo_torch.envs.liars_dice import F32_OUT, I32_OUT

    cpu = torch.device("cpu")
    E = 8
    env = LiarsDice()
    half = torch.full((E, 8), 0.5)
    out = env.step_autoreset(env.reset(half), EpisodeAccumulator.zero(E, 4, cpu),
                             torch.full((E,), 3, dtype=torch.int32), half, half)
    assert out.obs.shape == (E, 270) and out.mask.shape == (E, 49) and out.priv.shape == (E, 120)
    assert liars_dice_step_autoreset.launches == 0
    assert "liars_dice_step.cu" in {p.name for p in kernels.sources()}
    assert "liars_dice_step_autoreset" in kernels.SIGNATURES
    # The kernel's output buffers: every block inside its buffer, disjoint,
    # starting on a 256-byte boundary, contiguous in its own shape.
    for blocks, dtype in ((I32_OUT, torch.int32), (F32_OUT, torch.float32)):
        for n in (1, 7, 4096):
            buf = torch.zeros(_arena_size(n, blocks), dtype=dtype)
            views = _carve(buf, n, blocks)
            for name, cols in blocks:
                v = views[name]
                assert v.is_contiguous() and v.numel() == n * cols
                assert (v.data_ptr() - buf.data_ptr()) % (ALIGN * 4) == 0
                v.add_(1)
            assert int(buf.sum()) == n * sum(c for _, c in blocks)  # no overlap


def test_connect_four_kernel_wrapper_passes_one_state_and_two_output_buffers(monkeypatch):
    """K4's CUDA path, run on CPU tensors with a stand-in library: the C
    entry point takes the packed state, the accumulators, the action and
    the i32 and f32 output buffers (8 arguments with E and the stream);
    the wrapper makes four argument checks and an alignment check, two
    allocations and one launch, and its outputs are views of the two
    buffers at the offsets the kernel writes (64-element blocks)."""
    from burn_ppo_torch.envs import connect_four as c4

    assert kernels.SIGNATURES["connect_four_step_autoreset"] == [ctypes.c_void_p] * 6 + [
        ctypes.c_int, ctypes.c_void_p]
    E = 70
    env = ConnectFour()
    state = env.reset(torch.empty(E, 0))
    acc = EpisodeAccumulator.zero(E, 2, torch.device("cpu"))
    calls = {"expect": 0, "empty": 0, "launch": []}
    expect, empty = kernels.expect, torch.empty

    def counting_expect(*a, **k):
        calls["expect"] += 1
        return expect(*a, **k)

    def counting_empty(*a, **k):
        calls["empty"] += 1
        return empty(*a, **k)

    class Lib:
        @staticmethod
        def connect_four_step_autoreset(*args):
            calls["launch"].append(args)
            return 0

    monkeypatch.setattr(kernels, "expect", counting_expect)
    monkeypatch.setattr(kernels, "library", lambda: Lib)
    monkeypatch.setattr(kernels, "stream", lambda dev: 0)
    # the stand-in launch counts; the process's counter is restored after
    monkeypatch.setattr(c4.connect_four_step_autoreset, "launches",
                        c4.connect_four_step_autoreset.launches)
    before = c4.connect_four_step_autoreset.launches
    action = torch.zeros(E, dtype=torch.int32)
    monkeypatch.setattr(torch, "empty", counting_empty)
    out = c4._launch(state, acc, action)
    monkeypatch.setattr(torch, "empty", empty)
    assert calls["expect"] == 4 and calls["empty"] == 2
    assert c4.connect_four_step_autoreset.launches == before + 1
    (args,) = calls["launch"]
    assert len(args) == 8 and args[:4] == (state.ints.data_ptr(), acc.reward_sum.data_ptr(),
                                           acc.length.data_ptr(), action.data_ptr())
    assert args[6:] == (E, 0)
    i32_base, f32_base = args[4], args[5]
    blk = lambda cols: -(-E * cols // 64) * 64 * 4  # noqa: E731
    assert out.state.ints.shape == (E, c4.W) and out.state.ints.data_ptr() == i32_base
    at = i32_base
    for t, cols in ((out.state.ints, c4.W), (out.acc.length, 1), (out.log.length, 1),
                    (out.log.outcome, 2), (out.log.active_players, 1)):
        assert t.data_ptr() == at and t.numel() == E * cols
        at += blk(cols)
    at = f32_base
    for t, cols in ((out.acc.reward_sum, 2), (out.rewards, 2), (out.done, 1),
                    (out.log.total_rewards, 2), (out.obs, c4.OBS_DIM), (out.mask, c4.COLS)):
        assert t.data_ptr() == at and t.numel() == E * cols
        at += blk(cols)
    assert out.log.completed is out.done and out.priv is None
    assert out.obs.shape == (E, c4.OBS_DIM) and out.mask.shape == (E, c4.COLS)
    with pytest.raises(ValueError, match="16-byte"):
        shifted = torch.zeros(E * c4.W + 1, dtype=torch.int32)[1:].view(E, c4.W)
        c4._launch(c4.ConnectFourState(shifted), acc, action)


class _StandIn:
    """A stand-in kernel library that records each entry point's arguments."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry


def _cuda_path_on_cpu(monkeypatch, *wrappers):
    """Routes the wrappers' CUDA path to a stand-in library with CPU
    tensors; each wrapper's launch counter is restored after the test."""
    lib = _StandIn()
    monkeypatch.setattr(kernels, "on_cpu", lambda *t: False)
    monkeypatch.setattr(kernels, "library", lambda: lib)
    monkeypatch.setattr(kernels, "stream", lambda dev: 0)
    for w in wrappers:
        monkeypatch.setattr(w, "launches", w.launches)
    return lib


def test_obs_norm_wrappers_launch_their_entry_points_once_each(monkeypatch):
    """K6's CUDA path with a stand-in library: the apply launches its entry
    point once with the obs' start, the output, the rows and the clip; the
    update launches its own once, in place into the state; each counts on
    its own counter."""
    lib = _cuda_path_on_cpu(monkeypatch, obs_norm_update, obs_norm_apply)
    before = (obs_norm_update.launches, obs_norm_apply.launches)
    state = ObsNormState.create(86, torch.device("cpu"))
    batch = torch.ones(3 * 5 * 86 + 1)[1:].view(3, 5, 86)  # starts 4 bytes in
    out = obs_norm_apply(state, batch, clip=5.0)
    (name, args), = lib.calls
    assert name == "obs_norm_apply" and len(args) == len(kernels.SIGNATURES["obs_norm_apply"])
    assert args[0] == batch.data_ptr() and args[4] == out.data_ptr() and out.shape == batch.shape
    assert args[5:8] == (15, 86, 5.0)
    new = obs_norm_update(state, torch.ones(3, 5, 86))
    name, args = lib.calls[1]
    assert name == "obs_norm_update" and len(args) == len(kernels.SIGNATURES["obs_norm_update"])
    assert new is state
    assert args[1] == state.mean.data_ptr() and args[3] == state.count.data_ptr()
    assert args[5:7] == (15, 86)
    assert (obs_norm_update.launches, obs_norm_apply.launches) == (before[0] + 1, before[1] + 1)


def test_clip_adam_wrapper_passes_the_callers_scratch_and_allocates_nothing(monkeypatch):
    """K9's CUDA path with a stand-in library: one launch with the
    scratch's pointer and length and the device scalars' and the
    bias-correction table's pointers, no allocation, and refusals without
    the scratch and for a buffer off a 16-byte boundary."""
    from burn_ppo_torch.ppo.update import ADAM_BIAS_LEN, adam_bias_table

    lib = _cuda_path_on_cpu(monkeypatch, clip_adam)
    n = 1001
    bufs = [torch.zeros(n) for _ in range(4)]
    partial = torch.empty(264, dtype=torch.float64)
    before = clip_adam.launches
    lr, count, run = (torch.tensor(0.1), torch.zeros((), dtype=torch.int32),
                      torch.ones((), dtype=torch.int32))
    kw = dict(lr=lr, count=count, run=run, max_grad_norm=0.5, eps=1e-5)
    table = adam_bias_table(torch.device("cpu"))
    empty, empty_like = torch.empty, torch.empty_like

    def refuse(*a, **k):
        raise AssertionError("clip_adam allocated")

    monkeypatch.setattr(torch, "empty", refuse)
    monkeypatch.setattr(torch, "empty_like", refuse)
    clip_adam(*bufs, **kw, partial=partial)
    monkeypatch.setattr(torch, "empty", empty)
    monkeypatch.setattr(torch, "empty_like", empty_like)
    (name, args), = lib.calls
    assert name == "clip_adam" and len(args) == len(kernels.SIGNATURES["clip_adam"])
    assert args[:6] == (*(b.data_ptr() for b in bufs), partial.data_ptr(), n)
    assert args[6] == 264 and clip_adam.launches == before + 1
    assert args[7:12] == (lr.data_ptr(), count.data_ptr(), run.data_ptr(), table.data_ptr(),
                          ADAM_BIAS_LEN)
    with pytest.raises(ValueError, match="scratch"):
        clip_adam(*bufs, **kw)
    with pytest.raises(ValueError, match="16-byte"):
        clip_adam(torch.zeros(n + 1)[1:], *bufs[1:], **kw, partial=partial)
    assert clip_adam.launches == before + 1


def test_episode_stats_wrapper_makes_its_scratch_once_and_refuses_it_in_a_capture(monkeypatch):
    """K10's CUDA path with a stand-in library: a first call inside a CUDA
    graph capture raises and makes nothing; the first call outside makes
    the device's scratch once (f64, zeroed, the library's length); every
    call passes it with its length, allocates only its output and
    launches once, a later call inside a capture too."""
    import contextlib

    from burn_ppo_torch.ppo import episode_stats as es

    lib = _cuda_path_on_cpu(monkeypatch, summarize_episode_logs)
    lib.episode_stats_scratch_len = lambda: 37
    monkeypatch.setattr(es, "_SCRATCH", {})
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    capturing = [True]
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: capturing[0])
    T, E, P = 2, 8, 2
    logs = EpisodeLog(completed=torch.ones(T, E), total_rewards=torch.zeros(T, E, P),
                      length=torch.ones(T, E, dtype=torch.int32),
                      outcome=torch.ones(T, E, P, dtype=torch.int32),
                      active_players=torch.full((T, E), P, dtype=torch.int32))
    before = summarize_episode_logs.launches
    with pytest.raises(RuntimeError, match="inside a CUDA graph capture"):
        summarize_episode_logs(logs, P, num_envs=5)
    assert es._SCRATCH == {} and lib.calls == []
    capturing[0] = False
    summarize_episode_logs(logs, P, num_envs=5)
    scratch = es._SCRATCH[torch.device("cpu")]
    assert scratch.dtype == torch.float64 and scratch.numel() == 37 and not bool(scratch.any())
    (name, args), = lib.calls
    assert name == "episode_stats" and len(args) == len(kernels.SIGNATURES["episode_stats"])
    assert args[:4] == tuple(t.data_ptr() for t in (logs.completed, logs.total_rewards,
                                                    logs.length, logs.outcome))
    assert args[4:10] == (T, E, 5, P, scratch.data_ptr(), 37)
    capturing[0] = True
    allocations = []
    empty, zeros = torch.empty, torch.zeros
    monkeypatch.setattr(torch, "empty", lambda *a, **k: (allocations.append(a), empty(*a, **k))[1])
    monkeypatch.setattr(torch, "zeros", lambda *a, **k: (allocations.append(a), zeros(*a, **k))[1])
    summarize_episode_logs(logs, P)
    monkeypatch.setattr(torch, "empty", empty)
    monkeypatch.setattr(torch, "zeros", zeros)
    assert allocations == [(5 + 2 * P,)] and list(es._SCRATCH.values()) == [scratch]
    assert lib.calls[1][1][6] == E and lib.calls[1][1][8] == scratch.data_ptr()
    assert summarize_episode_logs.launches == before + 2


def test_adam_state_on_the_cpu_holds_no_kernel_scratch():
    from burn_ppo_torch.ppo.update import AdamState, clip_adam_scratch

    net = torch.nn.Linear(3, 2)
    opt = AdamState.create(net)
    assert opt.partial is None and clip_adam_scratch(torch.device("cpu")) is None
    assert opt.flat_params.numel() == 8 and opt.flat_params.data_ptr() % 16 == 0


@pytest.mark.parametrize("rolled", [False, True])
def test_cartpole_kernel_wrapper_passes_two_state_rows_and_two_output_buffers(monkeypatch, rolled):
    """K1's CUDA path with a stand-in library: the C entry point takes the
    physics rows, step_idx, the accumulators, the action, the reset rows,
    the rolling returns (null without the roll), the i32 and f32 output
    buffers, E, gamma and the stream (12 arguments); the wrapper makes two
    allocations and one launch, and its outputs, the rolled returns and
    samples among them, are views of the two buffers at the offsets the
    kernel writes (64-element blocks)."""
    from burn_ppo_torch.envs import cartpole as cp

    assert kernels.SIGNATURES["cartpole_step_autoreset"] == [ctypes.c_void_p] * 9 + [
        ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    lib = _cuda_path_on_cpu(monkeypatch, cp.cartpole_step_autoreset, return_norm_roll)
    E = 70
    env = CartPole()
    state = env.reset(torch.zeros(E, 4))
    acc = EpisodeAccumulator.zero(E, 1, torch.device("cpu"))
    action, reset = torch.zeros(E, dtype=torch.int32), torch.zeros(E, 4)
    returns = torch.zeros(E, 1)
    before = cp.cartpole_step_autoreset.launches
    empty, allocations = torch.empty, []
    monkeypatch.setattr(torch, "empty", lambda *a, **k: (allocations.append(a), empty(*a, **k))[1])
    out = env.step_autoreset(state, acc, action, reset, None, (returns, 0.5) if rolled else None)
    monkeypatch.setattr(torch, "empty", empty)
    assert len(allocations) == 2 and cp.cartpole_step_autoreset.launches == before + 1
    (name, args), = lib.calls
    assert name == "cartpole_step_autoreset" and len(args) == 12
    assert args[:7] == (state.phys.data_ptr(), state.step_idx.data_ptr(),
                        acc.reward_sum.data_ptr(), acc.length.data_ptr(), action.data_ptr(),
                        reset.data_ptr(), returns.data_ptr() if rolled else None)
    assert args[9:] == (E, 0.5 if rolled else 0.0, 0)
    blk = lambda cols: -(-E * cols // 64) * 64 * 4  # noqa: E731
    at = args[7]
    for t, cols, shape in ((out.state.step_idx, 1, (E,)), (out.acc.length, 1, (E,)),
                           (out.log.length, 1, (E,)), (out.log.outcome, 1, (E, 1)),
                           (out.log.active_players, 1, (E,))):
        assert t.data_ptr() == at and t.shape == shape and t.dtype == torch.int32
        at += blk(cols)
    at = args[8]
    f32_blocks = [(out.state.phys, 4, (E, 4)), (out.acc.reward_sum, 1, (E, 1)),
                  (out.rewards, 1, (E, 1)), (out.done, 1, (E,)),
                  (out.log.total_rewards, 1, (E, 1)), (out.obs, 5, (E, 5)), (out.mask, 2, (E, 2))]
    if rolled:
        f32_blocks += [(out.returns, 1, (E, 1)), (out.samples, 1, (E,))]
    else:
        assert out.returns is None and out.samples is None
    for t, cols, shape in f32_blocks:
        assert t.data_ptr() == at and t.shape == shape and t.is_contiguous()
        at += blk(cols)
    assert out.log.completed is out.done and out.priv is None
    assert out.state.x.shape == (E,) and out.state.x.data_ptr() == args[8]
    assert return_norm_roll.launches == 0
    with pytest.raises(ValueError, match="16-byte"):
        env.step_autoreset(cp.CartPoleState(torch.zeros(E * 4 + 1)[1:].view(E, 4),
                                            state.step_idx), acc, action, reset)


def test_return_norm_finalize_wrapper_passes_the_states_scratch(monkeypatch):
    """K12 finalize's CUDA path with a stand-in library: one launch with the
    state's scratch and its length, two allocations (the stats and the
    normalised rewards), and a refusal without the scratch."""
    lib = _cuda_path_on_cpu(monkeypatch, return_norm_finalize)
    cpu = torch.device("cpu")
    assert ReturnNormState.create(8, 1, cpu).scratch is None
    state = ReturnNormState.create(8, 1, cpu)
    state.scratch = torch.empty(1320, dtype=torch.float64)
    samples, rewards, valid = torch.ones(3, 8), torch.ones(3, 8), torch.ones(3, 8)
    before = return_norm_finalize.launches
    empty, empty_like, allocations = torch.empty, torch.empty_like, []
    monkeypatch.setattr(torch, "empty", lambda *a, **k: (allocations.append(a), empty(*a, **k))[1])
    monkeypatch.setattr(torch, "empty_like",
                        lambda *a, **k: (allocations.append(a), empty_like(*a, **k))[1])
    new, norm = return_norm_finalize(state, samples, rewards, 5.0, valid)
    monkeypatch.setattr(torch, "empty", empty)
    monkeypatch.setattr(torch, "empty_like", empty_like)
    assert len(allocations) == 2 and return_norm_finalize.launches == before + 1
    (name, args), = lib.calls
    assert name == "return_norm_finalize"
    assert len(args) == len(kernels.SIGNATURES["return_norm_finalize"]) == 13
    assert args[2] == valid.data_ptr() and args[6:8] == (state.scratch.data_ptr(), 1320)
    assert args[10:12] == (24, 5.0) and norm.shape == (3, 8)
    assert new.scratch is state.scratch
    state.scratch = None
    with pytest.raises(ValueError, match="scratch"):
        return_norm_finalize(state, samples, rewards)


def test_front_end_modules_import_with_jax_blocked():
    """eval, tournament, human and utils are the port's own: none of them
    reaches JAX or the JAX package."""
    code = textwrap.dedent(
        """
        import sys
        for name in ("jax", "jaxlib", "flax", "optax", "burn_ppo_tpu"):
            sys.modules[name] = None
        import burn_ppo_torch.eval, burn_ppo_torch.tournament, burn_ppo_torch.human
        import burn_ppo_torch.utils, burn_ppo_torch.cli
        print(burn_ppo_torch.eval.run_stats_mode.__module__)
        """
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "burn_ppo_torch.eval"


@pytest.mark.parametrize("per_row", [True, False])
def test_temperature_sample_wrapper_launches_once_and_allocates_only_the_output(monkeypatch,
                                                                              per_row):
    """K14's CUDA path with a stand-in library: one launch with the logits,
    the mask, the temperatures (or null and the one temperature), the
    uniforms and the output; the wrapper allocates the output alone."""
    lib = _cuda_path_on_cpu(monkeypatch, sample_with_temperature)
    before = sample_with_temperature.launches
    rows, A = 6, 33
    logits, mask, uni = torch.zeros(rows, A), torch.ones(rows, A), torch.full((rows, A), 0.5)
    temps = torch.tensor([0.0, 0.4, 1.0, 1e-3, 0.0, 2.0]) if per_row else 0.25
    made = []
    real_empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda *a, **k: made.append((a, k)) or real_empty(*a, **k))
    out = sample_with_temperature(logits, mask, temps, uni)
    (name, args), = lib.calls
    assert name == "temperature_sample"
    assert len(args) == len(kernels.SIGNATURES["temperature_sample"])
    assert args[0] == logits.data_ptr() and args[1] == mask.data_ptr()
    if per_row:
        assert args[2] == temps.data_ptr() and args[3] == 0.0
    else:
        assert args[2] is None and args[3] == 0.25
    assert args[4] == uni.data_ptr() and args[5] == out.data_ptr() and args[6:8] == (rows, A)
    assert out.shape == (rows,) and out.dtype == torch.int32
    assert len(made) == 1
    assert sample_with_temperature.launches == before + 1
    lib.calls.clear()
    sample_with_temperature(logits, None, temps, uni)
    (_, args), = lib.calls
    assert args[1] is None


def test_temperature_sample_takes_the_plain_path_on_cpu():
    before = sample_with_temperature.launches
    logits = torch.tensor([[1.0, 3.0, 3.0, 0.0], [0.0, 0.0, 0.0, 0.0]])
    mask = torch.tensor([[1.0, 1.0, 1.0, 1.0], [1.0, 1.0, 0.0, 0.0]])
    got = sample_with_temperature(logits, mask, torch.zeros(2), torch.full((2, 4), 0.5))
    assert got.tolist() == [2, 1]  # greedy: the last of the tied maxima
    assert sample_with_temperature.launches == before

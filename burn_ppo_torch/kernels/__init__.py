"""Build and bind the hand-written CUDA kernels (``burn_ppo_torch/csrc``).

Every ``csrc/*.cu`` file compiles with its own ``nvcc``, all started
together, and the objects link into ONE shared library with a plain C
interface, loaded through ``ctypes``. The build runs at first use, on the
machine with the card, and is cached by a hash of the sources and flags
under ``<repo>/.cache/burn_ppo_torch/kernels/`` (a temp file, then an
atomic rename, so concurrent builds never see a torn library). There is
no fallback: a failed build raises with nvcc's output.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` turns a non-zero code into an
exception, because a refused launch never runs and a later
``torch.cuda.synchronize()`` would not report it.

The wrappers live beside their plain PyTorch versions (``envs/cartpole.py``,
``envs/connect_four.py``, ``envs/skull.py``, ``envs/liars_dice.py``: each
env's step, with K14's sampling front as an option,
``ops/categorical.py`` (K2, with PopArt's denormalisation as an optional
epilogue, and K14),
``ops/gae.py``, ``ppo/normalization.py`` (K6, K12, K15, K16),
``ppo/pool_rollout.py`` (K7, its f32 and its bf16 tower, its feature
front; K20, the CNN opponents' conv front; the bf16 tower and the
feature front read the stack's packed layers, ``ppo/opponent_pack.py``),
``ppo/update.py``, ``ppo/episode_stats.py``, ``eval.py`` (K17),
``ppo/window.py`` (K18, K19)) and use
the helpers below.
Each registers itself with :func:`counted`, which gives it a ``launches``
count: the wrapper adds one where it launches its kernel, and nowhere
else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
REPO_ROOT = Path(__file__).resolve().parents[2]
BUILD_DIR = REPO_ROOT / ".cache" / "burn_ppo_torch" / "kernels"

# Accurate sinf/cosf/logf/expf: no --use_fast_math (the env physics and
# the Gumbel transform are compared with their plain versions at 1e-5).
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_VP = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_long
_F = ctypes.c_float
_D = ctypes.c_double

# The sampling front of an env step entry (csrc/temperature_sample.cuh
# Front, ops/categorical.py front_args): logits (null: no front, the
# step's action given), mask (nullable), temperatures (nullable), the
# temperature of every row where they are null, uniforms, the sampled
# actions.
FRONT = [_VP] * 3 + [_F] + [_VP] * 2

# C signature of every entry point: (name, argtypes). Pointers and the
# stream are c_void_p (ctypes would otherwise pass a 32-bit int and cut
# the pointer); scalars are c_int / c_float / c_double.
SIGNATURES = {
    # physics rows, step_idx, reward_sum, length, action, reset rows, rolling
    # returns (nullable: no roll), the i32 and the f32 output buffer,
    # num_envs, gamma, the reset flag, the sampling front (FRONT), stream
    "cartpole_step_autoreset": [_VP] * 9 + [_I, _F, _I] + FRONT + [_VP],
    # packed state, reward_sum, length, action, the i32 and the f32 output
    # buffer, num_envs, the reset flag, the sampling front, stream
    "connect_four_step_autoreset": [_VP] * 6 + [_I, _I] + FRONT + [_VP],
    # logits, mask (nullable), uniforms, actions, log_probs, rows, A; the
    # value epilogue (all null, or all set): values, PopArt's mean, m2,
    # count, the values' output slice; stream
    "masked_gumbel_sample": [_VP] * 5 + [_I, _I] + [_VP] * 6,
    # logits, mask (nullable), temperatures (nullable), the temperature of
    # every row where they are null, uniforms, actions, rows, A, stream
    "temperature_sample": [_VP] * 3 + [_F] + [_VP] * 2 + [_I, _I, _VP],
    # rewards, values, dones, last_values, advantages, returns, T, E,
    # gamma, gamma*lambda, stream
    "gae_reverse_scan": [_VP] * 6 + [_I, _I, _F, _F, _VP],
    # all_rewards, values, dones, acting, last_vpp, advantages, returns,
    # T, E, P, gamma, gamma*lambda, stream
    "gae_multiplayer_reverse_scan": [_VP] * 7 + [_I, _I, _I, _F, _F, _VP],
    # obs, mean, m2, count, out, N, D, clip, stream
    "obs_norm_apply": [_VP] * 5 + [_L, _I, _F, _VP],
    # batch, mean, m2, count (merged into in place), scratch, N, D, lanes,
    # stream
    "obs_norm_update": [_VP] * 5 + [_L, _I, _L, _VP],
    # x, slot, norm mean, m2, count (nullable), clip, host arrays of the
    # layers' weight and bias pointers and of the widths, depth, act, out,
    # rows, K, tiling, stream: K7's f32 tower
    "opp_mlp_forward": [_VP] * 5 + [_F] + [_VP] * 3 + [_I, _I, _VP] + [_I] * 3 + [_VP],
    # the same arguments but the tiling, the weights the packed bf16 layers
    # (ppo/opponent_pack.py): K7's bf16 tower
    "opp_tower_forward": [_VP] * 5 + [_F] + [_VP] * 3 + [_I, _I, _VP] + [_I] * 2 + [_VP],
    # the same arguments up to the stream (the packed f32 or bf16 layers),
    # then the bf16 tower, the last conv's output (contiguous), its C' H W
    # floats a slot, the obs's spatial width H W C (its extra columns start
    # there), stream: K7's feature front
    "opp_features_forward": ([_VP] * 5 + [_F] + [_VP] * 3 + [_I, _I, _VP] + [_I] * 3
                             + [_VP, _I, _I, _VP]),
    # x, slot, norm mean, m2, count (nullable), clip, host arrays of the
    # conv layers' stacked weight and bias pointers and of the channels,
    # depth, kernel size, H, W, D, out, rows, K, bf16 operands, stream: K20
    "opp_cnn_front": [_VP] * 5 + [_F] + [_VP] * 3 + [_I] * 5 + [_VP] + [_I] * 3 + [_VP],
    # channels, depth, kernel size, H, W, out [3]: rows a tile, whether
    # every layer's weights are held at once, floats a row of a buffer
    "opp_cnn_front_layout": [_VP] + [_I] * 4 + [_VP],
    # widths, depth, rows, K, out: resident 3-block clusters
    "opp_mlp_default_tiling": [_VP, _I, _I, _I, _VP],
    # widths, depth, bf16, the feature front's (else the bf16 tower's),
    # out [3]: stages, bytes a stage, the input buffers' bytes
    "opp_tower_layout": [_VP, _I, _I, _I, _VP],
    # logits, values, mask, actions, old_lp, adv, returns, old_values, valid,
    # M, A, eps, lo, hi, clip_value, value_coef, ent_coef (f32 scalar),
    # scratch (f64 [ppo_loss_scratch_len()]), out, dlogits, dvalues, the
    # bookkeeping (sums, count, stop, run), can_be_empty,
    # target_kl (double), PopArt's mean, m2, count (nullable), the entropy
    # controller's coef, last entropy, has-entropy (nullable), its step
    # flag, min, max, delta, stream
    "ppo_loss_forward": ([_VP] * 9 + [_I] * 2 + [_F] * 3 + [_I, _F] + [_VP] * 9
                         + [_I, _D] + [_VP] * 6 + [_I] + [_F] * 3 + [_VP]),
    "ppo_loss_scratch_len": [],
    # params, grads, mu, nu, partial, n, partial's length, lr (f32 scalar),
    # count (i32 scalar), run (i32 scalar), the bias-correction
    # table (f32 [2, its length]), its length, max_norm, eps, b1, b2,
    # 1 - b1, 1 - b2, stream
    "clip_adam": [_VP] * 5 + [_L, _I] + [_VP] * 4 + [_I] + [_F] * 6 + [_VP],
    "clip_adam_scratch_len": [],
    # completed, totals, length, outcome, T, E, L, P, scratch (f64
    # [episode_stats_scratch_len()], zeroed once), its length, out, stream
    "episode_stats": [_VP] * 4 + [_I] * 4 + [_VP, _I, _VP, _VP],
    "episode_stats_scratch_len": [],
    # packed state, shaping, reward_sum, length, action, u, the i32 and the
    # f32 output buffer, num_envs, num_players, the reset flag, the sampling
    # front, stream
    "skull_step_autoreset": [_VP] * 8 + [_I, _I, _I] + FRONT + [_VP],
    # returns, rewards, acting, dones, new_returns, samples, E, P, gamma, stream
    "return_norm_roll": [_VP] * 6 + [_I, _I, _F, _VP],
    # samples, rewards, valid (nullable), mean, m2, count, scratch (f64
    # [return_norm_finalize_scratch_len()]), its length, normalized, stats
    # (f64 [3]), N, clip, stream
    "return_norm_finalize": [_VP] * 7 + [_I] + [_VP] * 2 + [_L, _F, _VP],
    "return_norm_finalize_scratch_len": [],
    # packed state, shaping, reward_sum, length, action, reset and step
    # uniforms, the i32 and the f32 output buffer, num_envs, the reset
    # flag, the sampling front, stream
    "liars_dice_step_autoreset": [_VP] * 9 + [_I, _I] + FRONT + [_VP],
    # returns, valid, N, mean, m2, count (merged into in place), the value
    # head's weight and bias (rescaled in place), H, scratch (f64
    # [popart_update_scratch_len()]), its length, stream
    "popart_update": [_VP, _VP, _L] + [_VP] * 5 + [_I, _VP, _I, _VP],
    "popart_update_scratch_len": [],
    # x, mean, m2, count, out, n, stream
    "popart_denormalize": [_VP] * 5 + [_L, _VP],
    # perm_idx, move_count, perm_table, n_perms, P; the records (a null
    # log row leaves them out): completed (the step's done), outcome,
    # total_rewards, the log row's completed, outcome, total_rewards and
    # perm; the seats (a null slot leaves them out): player (nullable), its
    # stride, slot_of_source, the schedule's mode, initial, final, span,
    # cutoff, 1 / cutoff, slot, temp; E, stream
    "eval_step_books": ([_VP, _VP, _VP, _I, _I] + [_VP] * 7 + [_VP, _L, _VP, _I] + [_F] * 5
                        + [_VP, _VP, _I, _VP]),
    # completed, outcome, seat, slots, T, E, L, P, the window's first-update
    # flag, its running count, its capacity, the record rows, the scan's
    # scratch (i64 [1 + its tiles], zeroed once), its tiles, stream
    "window_records": [_VP] * 4 + [_I] * 4 + [_VP] * 5 + [_I, _VP],
    # host arrays of each accumulator entry's source address and fold,
    # their count, the accumulators, the first-update flag, stream
    "window_report": [_VP] * 2 + [_I] + [_VP] * 3,
}

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None

# Every wrapper of a kernel of this library, in the order their modules
# registered them.
WRAPPERS: list = []


def counted(wrapper):
    """Register a kernel wrapper, its ``launches`` count at 0."""
    wrapper.launches = 0
    WRAPPERS.append(wrapper)
    return wrapper


def _nvcc() -> str:
    for cand in (
        os.environ.get("NVCC"),
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set NVCC or CUDA_HOME); the CUDA kernels of "
        "burn_ppo_torch are built from csrc/ at first use"
    )


def sources() -> list:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    """Content-addressed path of the shared library for these sources."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libburn_ppo_kernels-{h.hexdigest()[:16]}.so"


def _run_all(cmds: list) -> list:
    """Run the commands concurrently; (returncode, output) of each."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    try:
        outs = [p.communicate(timeout=600)[0] for p in procs]
        return [(p.returncode, out) for p, out in zip(procs, outs)]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def build() -> Path:
    """Compile ``csrc/*.cu`` into the cached library (no-op when present):
    one ``nvcc -c`` per source, all at once, then one link.

    nvcc's output (``-Xptxas -v``: registers, shared memory and spills of
    each kernel) is kept beside the library as ``.log``."""
    so_path = library_path()
    if so_path.exists():
        return so_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    work = Path(tempfile.mkdtemp(prefix=f".{so_path.stem}.", dir=BUILD_DIR))
    try:
        srcs = sorted(CSRC.glob("*.cu"))
        objs = [work / f"{src.stem}.o" for src in srcs]
        compiles = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(src)]
                    for src, o in zip(srcs, objs)]
        tmp = work / so_path.name
        link = [nvcc, *ARCH, "-shared", "-o", str(tmp), *map(str, objs)]
        logs = []
        for cmds in (compiles, [link]):
            for cmd, (rc, out) in zip(cmds, _run_all(cmds)):
                logs.append(f"$ {' '.join(cmd)}\n{out}")
                if rc != 0:
                    raise RuntimeError(f"nvcc failed ({rc}):\n{logs[-1]}")
        so_path.with_suffix(".log").write_text("\n".join(logs))
        tmp.replace(so_path)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return so_path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _LIB = lib
        return _LIB


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {err}")


def stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def on_cpu(*tensors: torch.Tensor) -> bool:
    """Dispatch rule of every wrapper: all-CPU -> plain version, all on
    one CUDA device -> kernel, anything else raises."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on mixed devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    return False


def expect_rows16(t: torch.Tensor, name: str) -> None:
    """A buffer that a kernel loads 16 bytes at a time (a packed env
    state whose ``W * 4`` is a multiple of 16, K9's flat buffers) must
    start 16-byte aligned."""
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: the kernel loads rows 16 bytes at a time; "
                         "the buffer must start 16-byte aligned")


def expect(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple) -> None:
    """Validate a kernel argument before its pointer crosses into C."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: kernel arguments must be contiguous")

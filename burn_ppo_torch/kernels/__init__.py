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
``envs/connect_four.py``, ``envs/skull.py``, ``ops/categorical.py``,
``ops/gae.py``, ``ppo/normalization.py``, ``ppo/pool_rollout.py``,
``ppo/update.py``, ``ppo/episode_stats.py``) and use the helpers below.
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

# C signature of every entry point: (name, argtypes). Pointers and the
# stream are c_void_p (ctypes would otherwise pass a 32-bit int and cut
# the pointer); scalars are c_int / c_float.
SIGNATURES = {
    # 9 inputs, 15 outputs, num_envs, stream
    "cartpole_step_autoreset": [_VP] * 24 + [_I, _VP],
    # 8 inputs, 15 outputs, num_envs, stream
    "connect_four_step_autoreset": [_VP] * 23 + [_I, _VP],
    # logits, mask (nullable), uniforms, actions, log_probs, rows, A, stream
    "masked_gumbel_sample": [_VP] * 5 + [_I, _I, _VP],
    # rewards, values, dones, last_values, advantages, returns, T, E,
    # gamma, gamma*lambda, stream
    "gae_reverse_scan": [_VP] * 6 + [_I, _I, _F, _F, _VP],
    # all_rewards, values, dones, acting, last_vpp, advantages, returns,
    # T, E, P, gamma, gamma*lambda, stream
    "gae_multiplayer_reverse_scan": [_VP] * 7 + [_I, _I, _I, _F, _F, _VP],
    # obs, mean, m2, count, out, N, D, clip, stream
    "obs_norm_apply": [_VP] * 5 + [_L, _I, _F, _VP],
    # batch, mean, m2, count, scratch, mean', m2', count', N, D, lanes, stream
    "obs_norm_update": [_VP] * 8 + [_L, _I, _L, _VP],
    # slot, rows, K, perm, offsets, stream
    "opp_slot_sort": [_VP, _I, _I, _VP, _VP, _VP],
    # x, gather, norm mean, m2, count, clip, w, b, y, scatter, offsets,
    # rows, K, n_in, n_out, act, stream
    "opp_grouped_dense": [_VP] * 5 + [_F] + [_VP] * 5 + [_I] * 5 + [_VP],
    # logits, values, mask, actions, old_lp, adv, returns, old_values, valid,
    # M, A, G, eps, lo, hi, clip_value, value_coef, ent_coef,
    # stats, sums, out, dlogits, dvalues, stream
    "ppo_loss_forward": [_VP] * 9 + [_I] * 3 + [_F] * 3 + [_I] + [_F] * 2 + [_VP] * 6,
    # params, grads, mu, nu, partial, n, G, lr, max_norm, eps, b1, b2,
    # 1 - b1, 1 - b2, bc1, bc2, stream
    "clip_adam": [_VP] * 5 + [_L, _I] + [_F] * 9 + [_VP],
    # completed, totals, length, outcome, T, E, L, P, G, sums, extrema, out, stream
    "episode_stats": [_VP] * 4 + [_I] * 5 + [_VP] * 4,
    # host arrays of the 29 input and 36 output pointers (the SkullState
    # fields in order, then the rest, csrc/skull_step.cu), num_envs,
    # num_players, stream
    "skull_step_autoreset": [_VP, _VP, _I, _I, _VP],
    # returns, rewards, acting, dones, new_returns, samples, E, P, gamma, stream
    "return_norm_roll": [_VP] * 6 + [_I, _I, _F, _VP],
    # samples, rewards, valid (nullable), mean, m2, count, scratch,
    # normalized, stats (f64 [3]), N, G, clip, stream
    "return_norm_finalize": [_VP] * 9 + [_L, _I, _F, _VP],
}

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


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


def expect(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple) -> None:
    """Validate a kernel argument before its pointer crosses into C."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: kernel arguments must be contiguous")

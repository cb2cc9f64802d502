"""Checkpoint saving in the JAX package's layout (save only).

Same on-disk format as burn_ppo_tpu/checkpoint.py:42-47, 264-316, 373-443,
so the JAX package can load what the port writes:

    <run>/checkpoints/step_00012345/
        model.npz          parameter leaves, JAX tree_leaves order and layout
        optimizer.npz      optax chain state leaves: count, mu..., nu...
        obs_norm.npz       (mean, m2, count)   when normalize_obs
        return_norm.npz    (returns, mean, m2, count)
        metadata.json
    <run>/checkpoints/latest -> step_00012345
    <run>/checkpoints/best   -> step_...

Writes are atomic (temp dir + rename, temp symlink + rename). The
generator state of the port has no JAX form, so no ``rng_state.npz`` is
written; the JAX loader derives a fresh shuffle key when it is absent.
Loading, resume and fork come later (ROADMAP A9 follow-up).
"""

from __future__ import annotations

import io
import json
import shutil
import tempfile
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from burn_ppo_torch.convert import params_to_jax, tree_leaves

CHECKPOINT_DIR_PREFIX = "step_"


def save_leaves(path: Path, leaves: List[Any]) -> None:
    arrays = {
        f"leaf_{i:05d}": (
            leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor) else np.asarray(leaf)
        )
        for i, leaf in enumerate(leaves)
    }
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    path.write_bytes(buf.getvalue())


def _atomic_symlink(link: Path, target: str) -> None:
    tmp = link.parent / f".{link.name}.tmp"
    if tmp.exists() or tmp.is_symlink():
        tmp.unlink()
    tmp.symlink_to(target)
    tmp.rename(link)


def model_leaves(network: torch.nn.Module) -> List[np.ndarray]:
    return tree_leaves(params_to_jax(network.state_dict()))


def optimizer_leaves(opt) -> List[np.ndarray]:
    """optax (EmptyState, ScaleByAdamState(count, mu, nu)) leaf order."""
    return (
        [np.asarray(opt.count, np.int32)]
        + tree_leaves(params_to_jax(opt.mu))
        + tree_leaves(params_to_jax(opt.nu))
    )


def build_metadata(
    *,
    step: int,
    env_name: str,
    network,
    num_players: int,
    avg_return: float = 0.0,
    best_avg_return: Optional[float] = None,
    recent_returns=(),
    forked_from: Optional[str] = None,
    rng_seed: int = 0,
    exploitability_vs_pool: Optional[float] = None,
    normalize_obs: bool = False,
    normalize_values: bool = False,
) -> Dict[str, Any]:
    """Architecture + bookkeeping record, the reference's metadata.json."""
    return {
        "normalize_obs": bool(normalize_obs),
        "normalize_values": bool(normalize_values),
        "step": int(step),
        "avg_return": float(avg_return),
        "rng_seed": int(rng_seed),
        "best_avg_return": None if best_avg_return is None else float(best_avg_return),
        "recent_returns": [float(r) for r in recent_returns],
        "forked_from": forked_from,
        "obs_dim": network.obs_dim,
        "action_count": network.action_count,
        "num_players": int(num_players),
        "hidden_size": network.hidden_size,
        "num_hidden": network.num_hidden,
        "activation": network.activation,
        "split_networks": network.split_networks,
        "network_type": network.network_type,
        "num_conv_layers": network.num_conv_layers,
        "conv_channels": list(network.conv_channels),
        "kernel_size": network.kernel_size,
        "cnn_fc_hidden_size": network.cnn_fc_hidden_size,
        "cnn_num_fc_layers": network.cnn_num_fc_layers,
        "privileged_obs_dim": network.privileged_obs_dim,
        "critic_hidden_size": network.critic_hidden_size,
        "critic_num_hidden": network.critic_num_hidden,
        "obs_shape": list(network.obs_shape) if network.obs_shape else None,
        "env_name": env_name,
        "exploitability_vs_pool": (
            None if exploitability_vs_pool is None else float(exploitability_vs_pool)
        ),
    }


class CheckpointManager:
    """Save checkpoints under ``<run_dir>/checkpoints``."""

    def __init__(self, run_dir: str | Path):
        self.dir = Path(run_dir) / "checkpoints"
        self.dir.mkdir(parents=True, exist_ok=True)

    def step_dir(self, step: int) -> Path:
        return self.dir / f"{CHECKPOINT_DIR_PREFIX}{step:08d}"

    def save(
        self,
        step: int,
        model: List[Any],
        optimizer: List[Any],
        aux: Dict[str, Optional[List[Any]]],
        metadata: Dict[str, Any],
    ) -> Path:
        """``model`` / ``optimizer`` / each ``aux`` entry are leaf lists in
        JAX order; an aux entry of None is skipped (feature off)."""
        final = self.step_dir(step)
        tmp = Path(tempfile.mkdtemp(prefix=f".tmp_{CHECKPOINT_DIR_PREFIX}{step}_", dir=self.dir))
        try:
            save_leaves(tmp / "model.npz", model)
            save_leaves(tmp / "optimizer.npz", optimizer)
            for name, leaves in aux.items():
                if leaves is not None:
                    save_leaves(tmp / f"{name}.npz", leaves)
            (tmp / "metadata.json").write_text(json.dumps(metadata, indent=2))
            if final.exists():
                shutil.rmtree(final)
            tmp.rename(final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self.set_latest(step)
        return final

    def set_latest(self, step: int) -> None:
        _atomic_symlink(self.dir / "latest", self.step_dir(step).name)

    def set_best(self, step: int) -> None:
        _atomic_symlink(self.dir / "best", self.step_dir(step).name)

"""Checkpoints in the JAX package's layout: save, and load for inference.

Same on-disk format as burn_ppo_tpu/checkpoint.py:42-47, 232-316, 373-511,
so each package loads what the other writes:

    <run>/checkpoints/step_00012345/
        model.npz          parameter leaves, JAX tree_leaves order and layout
        optimizer.npz      optax chain state leaves: count, mu..., nu...
        obs_norm.npz       (mean, m2, count)   when normalize_obs
        return_norm.npz    (returns, mean, m2, count)
        metadata.json
    <run>/checkpoints/latest -> step_00012345
    <run>/checkpoints/best   -> step_...  (best average return for one
                                           player, best rating otherwise)
    <run>/opponent_stats.json, rating_games.jsonl, rating_metadata.json
                                          (the vs-pool path, selfplay/)

Writes are atomic (temp dir + rename, temp symlink + rename). The
generator state of the port has no JAX form, so no ``rng_state.npz`` is
written; the JAX loader derives a fresh shuffle key when it is absent.
``load_model`` and ``load_obs_normalizer`` read a network and its obs
normalizer for inference; the optimizer state, resume and fork come later
(ROADMAP A9b).
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

from burn_ppo_torch.convert import params_from_jax, params_to_jax, tree_fill, tree_leaves
from burn_ppo_torch.models.network import ActorCriticNetwork
from burn_ppo_torch.ppo.normalization import ObsNormState

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


def load_leaves(path: Path) -> List[np.ndarray]:
    """The ``leaf_NNNNN`` arrays of an npz file, in order."""
    with np.load(io.BytesIO(path.read_bytes())) as data:
        return [data[f"leaf_{i:05d}"] for i in range(len(data.files))]


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


def network_from_metadata(meta: Dict[str, Any], device: str | torch.device = "cpu"):
    """The network ``metadata.json`` describes (checkpoint.py:317-336), with
    placeholder weights."""
    network_type = meta.get("network_type", "mlp")
    return ActorCriticNetwork(
        meta["obs_dim"],
        meta["action_count"],
        network_type=network_type,
        hidden_size=meta["hidden_size"],
        num_hidden=meta["num_hidden"],
        activation=meta["activation"],
        split_networks=meta.get("split_networks", False),
        privileged_obs_dim=meta.get("privileged_obs_dim"),
        critic_hidden_size=meta.get("critic_hidden_size"),
        critic_num_hidden=meta.get("critic_num_hidden"),
        obs_shape=tuple(meta["obs_shape"]) if meta.get("obs_shape") else None,
        num_conv_layers=meta.get("num_conv_layers", 2),
        conv_channels=tuple(meta.get("conv_channels", (8, 8))),
        kernel_size=meta.get("kernel_size", 3),
        cnn_fc_hidden_size=meta.get("cnn_fc_hidden_size", 32),
        cnn_num_fc_layers=meta.get("cnn_num_fc_layers", 1),
        generator=torch.Generator().manual_seed(0),
    ).to(device)


def load_model(ckpt_dir: str | Path, device: str | torch.device = "cpu"):
    """(network, metadata) of a checkpoint written by either package: the
    network rebuilt from ``metadata.json``, its weights filled from
    ``model.npz`` in ``tree_leaves`` order."""
    ckpt_dir = Path(ckpt_dir)
    meta = json.loads((ckpt_dir / "metadata.json").read_text())
    network = network_from_metadata(meta, device)
    template = params_to_jax(network.state_dict())
    params = tree_fill(template, load_leaves(ckpt_dir / "model.npz"))
    network.load_state_dict(params_from_jax(params))
    return network, meta


def load_obs_normalizer(ckpt_dir: str | Path,
                        device: str | torch.device = "cpu") -> Optional[ObsNormState]:
    """The obs normalizer of a checkpoint, or None when it trained without
    one. The leaves follow ``ObsNormState``'s field order (mean, m2,
    count), not sorted keys."""
    ckpt_dir = Path(ckpt_dir)
    meta = json.loads((ckpt_dir / "metadata.json").read_text())
    if not meta.get("normalize_obs"):
        return None
    mean, m2, count = (torch.as_tensor(np.asarray(a, np.float32), device=device)
                       for a in load_leaves(ckpt_dir / "obs_norm.npz"))
    D = meta["obs_dim"]
    if mean.shape != (D,) or m2.shape != (D,) or count.shape != ():
        raise ValueError(f"{ckpt_dir}/obs_norm.npz does not hold an obs_dim {D} normalizer")
    return ObsNormState(mean=mean, m2=m2, count=count)


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
        """Point ``best`` at a step (best average return with one player,
        best rating on the vs-pool path)."""
        _atomic_symlink(self.dir / "best", self.step_dir(step).name)

"""Checkpoints in the JAX package's layout: save, load, resume and fork.

Same on-disk format as burn_ppo_tpu/checkpoint.py:42-47, 232-316, 373-511,
so each package loads what the other writes:

    <run>/checkpoints/step_00012345/
        model.npz          parameter leaves, JAX tree_leaves order and layout
        optimizer.npz      optax chain state leaves: count, mu..., nu...
        obs_norm.npz       (mean, m2, count)   when normalize_obs
        return_norm.npz    (returns, mean, m2, count)
        popart.npz         (mean, m2, count)   when normalize_values
        generator_state.npz  the port's device generator (``torch.Generator``
                           state bytes), one leaf
        metadata.json
    <run>/checkpoints/latest -> step_00012345
    <run>/checkpoints/best   -> step_...  (best average return for one
                                           player, best rating otherwise)
    <run>/opponent_stats.json, rating_games.jsonl, rating_metadata.json
                                          (the vs-pool path, selfplay/)

Writes are atomic (temp dir + rename, temp symlink + rename). The JAX
package keeps its two PRNG keys in ``rng_state.npz``, which the port
neither writes nor reads: its generator state has no JAX form, so it
lives in a file of its own name, which JAX ignores (and derives a fresh
shuffle key, train.py:907-911); a port resuming a checkpoint without it
derives a stream of its own (``train.Trainer``). ``load_model`` and
``load_obs_normalizer`` read a network and its obs normalizer for
inference; ``load_params``, ``load_optimizer``, ``load_component`` and
``load_generator_state`` restore a run for resume and fork, copying into
the tensors that exist (the trainer's CUDA graphs read them where they
were captured). A checkpoint of the Rust reference (a Burn ``model.mpk``
and no ``model.npz``) is refused with ``NotPortedError``: its import is
ROADMAP A15's ``interop.py``.
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
# The port's generator state; never ``rng_state.npz``, which JAX loads as
# two JAX keys (burn_ppo_tpu/train.py:901-904).
GENERATOR_STATE = "generator_state"


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


def load_metadata(ckpt_dir: str | Path) -> Dict[str, Any]:
    return json.loads((Path(ckpt_dir) / "metadata.json").read_text())


def _fill(dsts: List[torch.Tensor], leaves: List[np.ndarray], what: str) -> None:
    """Copy ``leaves`` into ``dsts`` in place, after checking that every
    count and shape agrees (so a mismatch changes nothing)."""
    if len(leaves) != len(dsts):
        raise ValueError(f"{what}: {len(leaves)} leaves; the run holds {len(dsts)}")
    for d, a in zip(dsts, leaves):
        if tuple(np.shape(a)) != tuple(d.shape):
            raise ValueError(f"{what}: a leaf of shape {np.shape(a)} for one of {tuple(d.shape)}")
    with torch.no_grad():
        for d, a in zip(dsts, leaves):
            d.copy_(torch.as_tensor(np.asarray(a)))


def load_params(ckpt_dir: str | Path, network: torch.nn.Module) -> None:
    """Fill ``network``'s parameters from ``model.npz`` in place (in
    ``tree_leaves`` order; the architecture must match)."""
    template = params_to_jax(network.state_dict())
    params = tree_fill(template, load_leaves(Path(ckpt_dir) / "model.npz"))
    network.load_state_dict(params_from_jax(params))


def load_optimizer(ckpt_dir: str | Path, opt, network: torch.nn.Module) -> None:
    """Fill an ``AdamState`` (the count, ``mu`` and ``nu``) from
    ``optimizer.npz`` in place: the inverse of ``optimizer_leaves``."""
    template = params_to_jax(network.state_dict())
    leaves = load_leaves(Path(ckpt_dir) / "optimizer.npz")
    n = len(tree_leaves(template))
    if len(leaves) != 1 + 2 * n or np.shape(leaves[0]) != ():
        raise ValueError(f"{ckpt_dir}/optimizer.npz: {len(leaves)} leaves, not the count and "
                         f"two moments of {n} parameters")
    mu = params_from_jax(tree_fill(template, leaves[1:1 + n]))
    nu = params_from_jax(tree_fill(template, leaves[1 + n:]))
    names = list(opt.mu)
    _fill([opt.count_tensor] + [opt.mu[k] for k in names] + [opt.nu[k] for k in names],
          [leaves[0]] + [mu[k] for k in names] + [nu[k] for k in names], "optimizer.npz")


def load_component(ckpt_dir: str | Path, name: str, dsts: List[torch.Tensor]) -> bool:
    """Fill ``dsts`` from ``<name>.npz`` in place (leaves in the state's
    field order); False, with nothing changed, when the file is absent
    (the feature was off when it was saved)."""
    path = Path(ckpt_dir) / f"{name}.npz"
    if not path.exists():
        return False
    _fill(dsts, load_leaves(path), f"{name}.npz")
    return True


def load_generator_state(ckpt_dir: str | Path) -> Optional[torch.Tensor]:
    """The saved generator state (a uint8 CPU tensor for
    ``torch.Generator.set_state``), or None for a checkpoint without one
    (one that JAX wrote)."""
    path = Path(ckpt_dir) / f"{GENERATOR_STATE}.npz"
    if not path.exists():
        return None
    (state,) = load_leaves(path)
    return torch.from_numpy(np.ascontiguousarray(state, dtype=np.uint8))


class NotPortedError(RuntimeError):
    """Input the port cannot read yet; the message names the ROADMAP item.
    The command line turns it into exit code 2."""


def is_reference_checkpoint(ckpt_dir: str | Path) -> bool:
    """A checkpoint of the Rust reference: a Burn NamedMpk model file
    instead of ``model.npz`` (burn_ppo_tpu/checkpoint.py:449-455)."""
    d = Path(ckpt_dir)
    return not (d / "model.npz").exists() and ((d / "model.mpk").exists() or (d / "model").exists())


def _refuse_reference(ckpt_dir: str | Path) -> None:
    if is_reference_checkpoint(ckpt_dir):
        raise NotPortedError(
            f"{ckpt_dir} is a Burn .mpk checkpoint of the reference (no model.npz); "
            "its import is not ported to burn_ppo_torch yet (ROADMAP A15, interop)")


def load_model(ckpt_dir: str | Path, device: str | torch.device = "cpu"):
    """(network, metadata) of a checkpoint written by either package: the
    network rebuilt from ``metadata.json``, its weights filled from
    ``model.npz`` in ``tree_leaves`` order."""
    _refuse_reference(ckpt_dir)
    meta = load_metadata(ckpt_dir)
    network = network_from_metadata(meta, device)
    load_params(ckpt_dir, network)
    return network, meta


def load_obs_normalizer(ckpt_dir: str | Path,
                        device: str | torch.device = "cpu") -> Optional[ObsNormState]:
    """The obs normalizer of a checkpoint, or None when it trained without
    one. The leaves follow ``ObsNormState``'s field order (mean, m2,
    count), not sorted keys."""
    _refuse_reference(ckpt_dir)
    meta = load_metadata(ckpt_dir)
    if not meta.get("normalize_obs"):
        return None
    state = ObsNormState.create(meta["obs_dim"], torch.device(device))
    if not load_component(ckpt_dir, "obs_norm", [state.mean, state.m2, state.count]):
        raise FileNotFoundError(f"{ckpt_dir} trained with normalize_obs but has no obs_norm.npz")
    return state


class CheckpointManager:
    """Save and resolve checkpoints under ``<run_dir>/checkpoints``."""

    def __init__(self, run_dir: str | Path):
        self.dir = Path(run_dir) / "checkpoints"
        self.dir.mkdir(parents=True, exist_ok=True)

    def step_dir(self, step: int) -> Path:
        return self.dir / f"{CHECKPOINT_DIR_PREFIX}{step:08d}"

    def resolve(self, which: str = "latest") -> Optional[Path]:
        """'latest' / 'best' / 'step_NNN' / a step number -> its dir, or
        None (checkpoint.py:362-370)."""
        cand = self.dir / str(which)
        if cand.exists():
            return cand.resolve()
        if str(which).isdigit():
            p = self.step_dir(int(which))
            return p if p.exists() else None
        return None

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
        parked = None
        try:
            save_leaves(tmp / "model.npz", model)
            save_leaves(tmp / "optimizer.npz", optimizer)
            for name, leaves in aux.items():
                if leaves is not None:
                    save_leaves(tmp / f"{name}.npz", leaves)
            (tmp / "metadata.json").write_text(json.dumps(metadata, indent=2))
            if final.exists():
                # Overwrite (the last update on a checkpoint boundary saves
                # its step twice): park the old dir with a rename first, so
                # that a failure between the two renames leaves it
                # restorable. "<step>.old" fails the pool's step-dir digit
                # check, so scans ignore it.
                old = final.with_name(final.name + ".old")
                if old.exists():
                    shutil.rmtree(old)
                final.rename(old)
                parked = old
                tmp.rename(final)
                parked = None
                shutil.rmtree(old, ignore_errors=True)
            else:
                tmp.rename(final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            # The old dir was parked but the new one never landed: put the
            # old one back, or the step is gone and ``latest`` dangles.
            if parked is not None and not final.exists():
                try:
                    parked.rename(final)
                except OSError:
                    pass
            raise
        self.set_latest(step)
        return final

    def set_latest(self, step: int) -> None:
        _atomic_symlink(self.dir / "latest", self.step_dir(step).name)

    def set_best(self, step: int) -> None:
        """Point ``best`` at a step (best average return with one player,
        best rating on the vs-pool path)."""
        _atomic_symlink(self.dir / "best", self.step_dir(step).name)

"""Parameter layout conversion between the JAX package and the port.

The JAX parameters are a pytree of ``{"kernel", "bias"}`` layers:
``{"layers": [...], "critic_layers": [...], "policy_head": {...},
"value_head": {...}}`` for the MLP, ``"conv_layers"``, ``"fc_layers"``,
``"critic_conv_layers"``, ``"critic_fc_layers"`` plus the heads for the
CNN, and ``"actor_layers"``, ``"critic_layers"`` plus the heads for CTDE
(sorted-key leaf order: actor layers, critic layers, policy head, value
head, each bias before its kernel). Dense kernels are ``[in, out]``, conv kernels HWIO. The port's
``ActorCriticNetwork`` state dict has ``nn.Linear`` weights ``[out, in]``
and ``nn.Conv2d`` weights OIHW under ``layers.0.weight`` and so on. Both
directions work on numpy arrays, so neither side needs the other's
framework.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List

import numpy as np
import torch

_HEADS = ("policy_head", "value_head")
_STACKS = ("layers", "actor_layers", "critic_layers", "conv_layers", "fc_layers",
           "critic_conv_layers", "critic_fc_layers")


def _kernel_to_torch(k: np.ndarray) -> np.ndarray:
    """[in, out] -> [out, in]; HWIO -> OIHW."""
    return k.transpose(3, 2, 0, 1) if k.ndim == 4 else k.T


def _weight_to_jax(w: np.ndarray) -> np.ndarray:
    """[out, in] -> [in, out]; OIHW -> HWIO."""
    return w.transpose(2, 3, 1, 0) if w.ndim == 4 else w.T


def params_from_jax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX param tree (numpy leaves) -> port state dict."""
    out: Dict[str, torch.Tensor] = {}

    def put(prefix: str, layer: Dict[str, Any]) -> None:
        kernel = _kernel_to_torch(np.asarray(layer["kernel"], np.float32))
        out[f"{prefix}.weight"] = torch.from_numpy(kernel.copy())
        out[f"{prefix}.bias"] = torch.from_numpy(np.array(layer["bias"], np.float32))

    unknown = set(tree) - set(_STACKS) - set(_HEADS)
    if unknown:
        raise ValueError(f"not an MLP/CNN/CTDE param tree: unexpected keys {sorted(unknown)}")
    for stack in _STACKS:
        for i, layer in enumerate(tree.get(stack, ())):
            put(f"{stack}.{i}", layer)
    for head in _HEADS:
        put(head, tree[head])
    return out


def params_to_jax(state_dict: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """Port state dict -> JAX param tree with numpy leaves."""
    tree: Dict[str, Any] = {}
    stacks: Dict[str, Dict[int, Dict[str, np.ndarray]]] = {}
    for name, t in state_dict.items():
        a = t.detach().cpu().numpy().astype(np.float32)
        parts = name.split(".")
        leaf = "kernel" if parts[-1] == "weight" else "bias"
        value = _weight_to_jax(a).copy() if leaf == "kernel" else a
        if parts[0] in _STACKS:
            stacks.setdefault(parts[0], {}).setdefault(int(parts[1]), {})[leaf] = value
        elif parts[0] in _HEADS:
            tree.setdefault(parts[0], {})[leaf] = value
        else:
            raise ValueError(f"not an MLP/CNN/CTDE parameter: {name}")
    for stack, layers in stacks.items():
        tree[stack] = [layers[i] for i in sorted(layers)]
    return tree


def tree_leaves(tree: Any) -> List[Any]:
    """Leaves in ``jax.tree_util.tree_leaves`` order for dict/list/tuple
    trees: dict keys sorted, sequences in order, None dropped."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for x in tree for leaf in tree_leaves(x)]
    return [tree]


def tree_fill(template: Any, leaves: List[Any]) -> Any:
    """The inverse of ``tree_leaves``: ``template``'s structure with its
    leaves replaced, in order, by ``leaves`` (count and shapes must agree)."""
    want = tree_leaves(template)
    if len(leaves) != len(want):
        raise ValueError(f"{len(leaves)} leaves; the template holds {len(want)}")
    for leaf, t in zip(leaves, want):
        if np.shape(leaf) != np.shape(t):
            raise ValueError(f"leaf shape {np.shape(leaf)} != template {np.shape(t)}")
    it: Iterator[Any] = iter(leaves)

    def fill(t):
        if isinstance(t, dict):
            return {k: fill(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(fill(x) for x in t)
        return next(it)

    return fill(template)

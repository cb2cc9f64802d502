"""Parameter layout conversion between the JAX package and the port.

The JAX MLP's parameters are a pytree
``{"layers": [{"kernel", "bias"}, ...], "critic_layers": [...],
"policy_head": {...}, "value_head": {...}}`` with ``[in, out]`` kernels;
the port's ``ActorCriticNetwork`` state dict has ``nn.Linear`` weights of
shape ``[out, in]`` under ``layers.0.weight`` and so on. Both directions
work on numpy arrays, so neither side needs the other's framework.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

_HEADS = ("policy_head", "value_head")
_STACKS = ("layers", "critic_layers")


def params_from_jax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX MLP param tree (numpy leaves) -> port state dict."""
    out: Dict[str, torch.Tensor] = {}

    def put(prefix: str, dense: Dict[str, Any]) -> None:
        out[f"{prefix}.weight"] = torch.from_numpy(np.array(dense["kernel"], np.float32).T.copy())
        out[f"{prefix}.bias"] = torch.from_numpy(np.array(dense["bias"], np.float32))

    for stack in _STACKS:
        for i, dense in enumerate(tree.get(stack, ())):
            put(f"{stack}.{i}", dense)
    for head in _HEADS:
        put(head, tree[head])
    unknown = set(tree) - set(_STACKS) - set(_HEADS)
    if unknown:
        raise ValueError(f"not an MLP param tree: unexpected keys {sorted(unknown)}")
    return out


def params_to_jax(state_dict: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """Port state dict -> JAX MLP param tree with numpy leaves."""
    tree: Dict[str, Any] = {}
    stacks: Dict[str, Dict[int, Dict[str, np.ndarray]]] = {}
    for name, t in state_dict.items():
        a = t.detach().cpu().numpy().astype(np.float32)
        parts = name.split(".")
        leaf = "kernel" if parts[-1] == "weight" else "bias"
        value = a.T.copy() if leaf == "kernel" else a
        if parts[0] in _STACKS:
            stacks.setdefault(parts[0], {}).setdefault(int(parts[1]), {})[leaf] = value
        elif parts[0] in _HEADS:
            tree.setdefault(parts[0], {})[leaf] = value
        else:
            raise ValueError(f"not an MLP parameter: {name}")
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

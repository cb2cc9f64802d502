"""Actor-critic network (burn_ppo_tpu/models/network.py), MLP only.

Shared backbone or split actor/critic towers, with the reference's
orthogonal gains. The CNN arrives with Connect Four (ROADMAP A10) and the
CTDE critic with Skull (ROADMAP A14).
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from burn_ppo_torch.models.core import activation_fn, dense_init, mlp_stack_apply, mlp_stack_init
from burn_ppo_torch.ops.initializers import POLICY_HEAD_GAIN, VALUE_HEAD_GAIN, hidden_gain


class ActorCriticNetwork(nn.Module):
    """obs [B, obs_dim] -> (logits [B, A], values [B]).

    The description attributes (``network_type``, ``hidden_size``, ...)
    mirror the reference's static network object, so checkpoint metadata
    is written from the same fields."""

    network_type = "mlp"
    privileged_obs_dim = None
    critic_hidden_size = None
    critic_num_hidden = None
    obs_shape = None
    # CNN fields keep the reference's defaults in checkpoint metadata.
    num_conv_layers = 2
    conv_channels = (8, 8)
    kernel_size = 3
    cnn_fc_hidden_size = 32
    cnn_num_fc_layers = 1

    def __init__(
        self,
        obs_dim: int,
        action_count: int,
        *,
        hidden_size: int = 64,
        num_hidden: int = 2,
        activation: str = "tanh",
        split_networks: bool = False,
        generator: torch.Generator,
    ):
        super().__init__()
        self.obs_dim = obs_dim
        self.action_count = action_count
        self.hidden_size = hidden_size
        self.num_hidden = num_hidden
        self.activation = activation
        self.split_networks = split_networks
        self._act = activation_fn(activation)
        gain = hidden_gain(activation)
        g = generator
        self.layers = mlp_stack_init(obs_dim, hidden_size, num_hidden, gain, g)
        self.critic_layers = (
            mlp_stack_init(obs_dim, hidden_size, num_hidden, gain, g)
            if split_networks
            else None
        )
        self.policy_head = dense_init(hidden_size, action_count, POLICY_HEAD_GAIN, g)
        self.value_head = dense_init(hidden_size, 1, VALUE_HEAD_GAIN, g)

    def forward(self, obs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        ax = mlp_stack_apply(self.layers, obs, self._act)
        logits = self.policy_head(ax)
        cx = (
            mlp_stack_apply(self.critic_layers, obs, self._act)
            if self.critic_layers is not None
            else ax
        )
        return logits, self.value_head(cx)[:, 0]


def make_network(
    env_spec,
    *,
    network_type: str = "mlp",
    hidden_size: int = 64,
    num_hidden: int = 2,
    activation: str = "tanh",
    split_networks: bool = False,
    generator: torch.Generator,
) -> ActorCriticNetwork:
    """Build the network for an env; ``generator`` draws the orthogonal
    init on its device."""
    if network_type == "cnn":
        raise NotImplementedError("CNN network is not ported yet (ROADMAP A10)")
    if network_type == "ctde":
        raise NotImplementedError("CTDE network is not ported yet (ROADMAP A14)")
    if network_type != "mlp":
        raise ValueError(f"Unknown network_type '{network_type}'")
    return ActorCriticNetwork(
        env_spec.obs_dim,
        env_spec.num_actions,
        hidden_size=hidden_size,
        num_hidden=num_hidden,
        activation=activation,
        split_networks=split_networks,
        generator=generator,
    )

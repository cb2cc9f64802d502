"""Actor-critic network (burn_ppo_tpu/models/network.py): MLP, CNN and CTDE.

Shared backbone or split actor/critic towers, with the reference's
orthogonal gains. The CNN runs a stride-1 SAME conv stack over the
spatial slice of the obs (always relu, relu gain), flattens it in the
reference's NHWC order, appends the remaining obs features and runs an FC
stack on the configured activation. CTDE (network.py:165-182, 230-256) is
an actor MLP on the obs and a critic MLP of its own width and depth on
``concat(privileged_obs, obs)``, privileged obs first.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from burn_ppo_torch.models.core import (
    activation_fn,
    conv_init,
    dense_init,
    mlp_stack_apply,
    mlp_stack_init,
)
from burn_ppo_torch.ops.initializers import POLICY_HEAD_GAIN, VALUE_HEAD_GAIN, hidden_gain


class ActorCriticNetwork(nn.Module):
    """obs [B, obs_dim] (and privileged obs [B, Dp] for CTDE) -> (logits
    [B, A], values [B]).

    The description attributes (``network_type``, ``hidden_size``, ...)
    mirror the reference's static network object, so checkpoint metadata
    is written from the same fields; like the reference, every network
    records the env's ``privileged_obs_dim`` and the configured critic
    sizes, which only CTDE reads."""

    def __init__(
        self,
        obs_dim: int,
        action_count: int,
        *,
        network_type: str = "mlp",
        hidden_size: int = 64,
        num_hidden: int = 2,
        activation: str = "tanh",
        split_networks: bool = False,
        privileged_obs_dim: Optional[int] = None,
        critic_hidden_size: Optional[int] = None,
        critic_num_hidden: Optional[int] = None,
        obs_shape: Optional[Tuple[int, int, int]] = None,
        num_conv_layers: int = 2,
        conv_channels: Sequence[int] = (8, 8),
        kernel_size: int = 3,
        cnn_fc_hidden_size: int = 32,
        cnn_num_fc_layers: int = 1,
        generator: torch.Generator,
    ):
        super().__init__()
        if network_type not in ("mlp", "cnn", "ctde"):
            raise ValueError(f"Unknown network_type '{network_type}'")
        self.network_type = network_type
        self.obs_dim = obs_dim
        self.action_count = action_count
        self.hidden_size = hidden_size
        self.num_hidden = num_hidden
        self.activation = activation
        self.split_networks = split_networks
        self.privileged_obs_dim = privileged_obs_dim
        self.critic_hidden_size = critic_hidden_size
        self.critic_num_hidden = critic_num_hidden
        self.obs_shape = tuple(obs_shape) if obs_shape else None
        self.num_conv_layers = num_conv_layers
        self.conv_channels = tuple(conv_channels)
        self.kernel_size = kernel_size
        self.cnn_fc_hidden_size = cnn_fc_hidden_size
        self.cnn_num_fc_layers = cnn_num_fc_layers
        self._act = activation_fn(activation)
        gain = hidden_gain(activation)
        g = generator
        if network_type == "mlp":
            self.layers = mlp_stack_init(obs_dim, hidden_size, num_hidden, gain, g)
            self.critic_layers = (
                mlp_stack_init(obs_dim, hidden_size, num_hidden, gain, g) if split_networks else None
            )
            head_in = hidden_size
        elif network_type == "ctde":
            if privileged_obs_dim is None:
                raise ValueError("CTDE requires privileged_obs_dim")
            ch = critic_hidden_size or hidden_size
            cn = critic_num_hidden or num_hidden
            self.actor_layers = mlp_stack_init(obs_dim, hidden_size, num_hidden, gain, g)
            self.critic_layers = mlp_stack_init(privileged_obs_dim + obs_dim, ch, cn, gain, g)
            self.policy_head = dense_init(hidden_size, action_count, POLICY_HEAD_GAIN, g)
            self.value_head = dense_init(ch, 1, VALUE_HEAD_GAIN, g)
            return
        else:
            if self.obs_shape is None:
                raise ValueError("CNN requires obs_shape (H, W, C)")
            if num_conv_layers < 1:
                raise ValueError("CNN requires num_conv_layers >= 1")
            h, w, c = self.obs_shape
            fc_in = h * w * self._conv_channels(num_conv_layers - 1) + (obs_dim - h * w * c)

            def towers():
                convs, in_ch = [], c
                for i in range(num_conv_layers):
                    # Convs are always relu, so their gain is relu's (network.py:129-133).
                    convs.append(conv_init(in_ch, self._conv_channels(i), kernel_size,
                                           hidden_gain("relu"), g))
                    in_ch = self._conv_channels(i)
                fcs = mlp_stack_init(fc_in, cnn_fc_hidden_size, cnn_num_fc_layers, gain, g)
                return nn.ModuleList(convs), fcs

            self.conv_layers, self.fc_layers = towers()
            self.critic_conv_layers, self.critic_fc_layers = (
                towers() if split_networks else (None, None)
            )
            head_in = cnn_fc_hidden_size
        self.policy_head = dense_init(head_in, action_count, POLICY_HEAD_GAIN, g)
        self.value_head = dense_init(head_in, 1, VALUE_HEAD_GAIN, g)

    def _conv_channels(self, i: int) -> int:
        """Channels of conv layer i, repeating the last entry (network.py:86-91)."""
        if i < len(self.conv_channels):
            return int(self.conv_channels[i])
        return int(self.conv_channels[-1]) if self.conv_channels else 64

    def _cnn_features(self, obs: torch.Tensor, convs: nn.ModuleList, fcs: nn.ModuleList):
        h, w, c = self.obs_shape
        B, n = obs.shape[0], h * w * c
        x = obs[:, :n].reshape(B, h, w, c).permute(0, 3, 1, 2)  # NHWC -> NCHW
        for conv in convs:
            x = torch.relu(conv(x))
        # Flatten in NHWC order, so the first FC layer's rows keep the
        # reference's h * W * C + w * C + c layout (network.py:191-197).
        x = x.permute(0, 2, 3, 1).reshape(B, -1)
        if self.obs_dim > n:
            x = torch.cat([x, obs[:, n:]], dim=1)
        return mlp_stack_apply(fcs, x, self._act)

    @property
    def is_ctde(self) -> bool:
        return self.network_type == "ctde"

    def forward_actor(self, obs: torch.Tensor) -> torch.Tensor:
        """Policy logits [B, A] from the obs alone."""
        if self.is_ctde:
            return self.policy_head(mlp_stack_apply(self.actor_layers, obs, self._act))
        return self.forward(obs)[0]

    def forward(self, obs: torch.Tensor,
                privileged_obs: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """(logits, values); CTDE needs ``privileged_obs``, the others ignore it."""
        if self.is_ctde:
            if privileged_obs is None:
                raise ValueError("the CTDE critic needs privileged_obs")
            cx = mlp_stack_apply(self.critic_layers, torch.cat([privileged_obs, obs], dim=1),
                                 self._act)
            return self.forward_actor(obs), self.value_head(cx)[:, 0]
        if self.network_type == "mlp":
            ax = mlp_stack_apply(self.layers, obs, self._act)
            cx = (mlp_stack_apply(self.critic_layers, obs, self._act)
                  if self.critic_layers is not None else ax)
        else:
            ax = self._cnn_features(obs, self.conv_layers, self.fc_layers)
            cx = (self._cnn_features(obs, self.critic_conv_layers, self.critic_fc_layers)
                  if self.critic_conv_layers is not None else ax)
        return self.policy_head(ax), self.value_head(cx)[:, 0]


def make_network(
    env_spec,
    *,
    network_type: str = "mlp",
    hidden_size: int = 64,
    num_hidden: int = 2,
    activation: str = "tanh",
    split_networks: bool = False,
    critic_hidden_size: Optional[int] = None,
    critic_num_hidden: Optional[int] = None,
    num_conv_layers: int = 2,
    conv_channels: Sequence[int] = (8, 8),
    kernel_size: int = 3,
    cnn_fc_hidden_size: int = 32,
    cnn_num_fc_layers: int = 1,
    generator: torch.Generator,
) -> ActorCriticNetwork:
    """Build the network for an env; ``generator`` draws the orthogonal
    init on its device."""
    return ActorCriticNetwork(
        env_spec.obs_dim,
        env_spec.num_actions,
        network_type=network_type,
        hidden_size=hidden_size,
        num_hidden=num_hidden,
        activation=activation,
        split_networks=split_networks,
        privileged_obs_dim=env_spec.privileged_obs_dim,
        critic_hidden_size=critic_hidden_size,
        critic_num_hidden=critic_num_hidden,
        obs_shape=env_spec.obs_shape,
        num_conv_layers=num_conv_layers,
        conv_channels=conv_channels,
        kernel_size=kernel_size,
        cnn_fc_hidden_size=cnn_fc_hidden_size,
        cnn_num_fc_layers=cnn_num_fc_layers,
        generator=generator,
    )

"""MuZero networks in NCHW (port of ``minizero_tpu/models/muzero.py``;
reference ``minizero/network/py/muzero_network.py`` and
``muzero_atari_network.py``).

Representation, dynamics and prediction with the ``initial_inference`` and
``recurrent_inference`` entry points, hidden-state min-max scaling, and for
Atari a downsampling representation (96 -> 48 -> 24 -> 12 -> 6) and a
distributional reward head on the dynamics.

``initial_inference`` takes features ``[B, H, W, C]`` (the env surface, as
the AlphaZero net does) and returns the hidden state NCHW;
``recurrent_inference`` takes that hidden state and the action planes
``[B, C_a, h, w]``, both NCHW.

The Atari representation's stride-2 convolutions and 3x3 average pools use
flax's "SAME" padding as the JAX package does (``blocks.same_pad``: 0 before
and 1 after on even sizes; the pools divide by 9, padding included), not the
reference's symmetric ``padding=1`` (ROADMAP.md, queue C).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from minizero_tpu_torch.models.blocks import (
    DiscreteValueHead, PolicyHead, ResidualBlock, ValueHead, _bn, same_pad, scale_hidden_state)


class _Representation(nn.Module):
    """reference muzero_network.py:7-20"""

    def __init__(self, in_channels: int, channels: int, num_blocks: int):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, channels, 3, padding=1, bias=True)
        self.bn = _bn(channels)
        self.blocks = nn.ModuleList([ResidualBlock(channels) for _ in range(num_blocks)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn(self.conv(x)))
        for block in self.blocks:
            x = block(x)
        return x


class _AtariRepresentation(nn.Module):
    """Stride-2 convolutions and average pools, 96 -> 6 (reference
    muzero_atari_network.py:10-39; JAX muzero.py:45-67)."""

    def __init__(self, in_channels: int, channels: int, num_blocks: int):
        super().__init__()
        half = channels // 2
        self.conv1 = nn.Conv2d(in_channels, half, 3, stride=2, bias=True)
        self.bn1 = _bn(half)
        self.block1 = ResidualBlock(half)
        self.conv2 = nn.Conv2d(half, channels, 3, stride=2, bias=True)
        self.bn2 = _bn(channels)
        self.block2 = ResidualBlock(channels)
        self.block3 = ResidualBlock(channels)
        self.blocks = nn.ModuleList([ResidualBlock(channels) for _ in range(num_blocks)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(same_pad(x, 3, 2))))
        x = self.block1(x)
        x = F.relu(self.bn2(self.conv2(same_pad(x, 3, 2))))
        x = self.block2(x)
        x = F.avg_pool2d(same_pad(x, 3, 2), 3, 2)
        x = self.block3(x)
        x = F.avg_pool2d(same_pad(x, 3, 2), 3, 2)
        for block in self.blocks:
            x = block(x)
        return x


class _Dynamics(nn.Module):
    """reference muzero_network.py:23-37, with the reward head of
    muzero_atari_network.py:43-59 when ``reward_size`` > 0."""

    def __init__(self, channels: int, action_channels: int, num_blocks: int,
                 height: int, width: int, reward_size: int = 0):
        super().__init__()
        self.conv = nn.Conv2d(channels + action_channels, channels, 3, padding=1, bias=True)
        self.bn = _bn(channels)
        self.blocks = nn.ModuleList([ResidualBlock(channels) for _ in range(num_blocks)])
        self.reward_head = (DiscreteValueHead(channels, height, width, channels, reward_size)
                            if reward_size > 0 else None)

    def forward(self, hidden_state: torch.Tensor, action_plane: torch.Tensor):
        x = torch.cat([hidden_state, action_plane.to(hidden_state.dtype)], dim=1)
        x = F.relu(self.bn(self.conv(x)))
        for block in self.blocks:
            x = block(x)
        return x, (self.reward_head(x) if self.reward_head is not None else None)


class _Prediction(nn.Module):
    """reference muzero_network.py:40-50 / muzero_atari_network.py:62-72"""

    def __init__(self, channels: int, height: int, width: int, action_size: int,
                 num_value_hidden_channels: int, discrete_value_size: int):
        super().__init__()
        self.policy_head = PolicyHead(channels, height, width, action_size)
        if discrete_value_size == 1:
            self.value_head = ValueHead(channels, height, width, num_value_hidden_channels)
        else:
            self.value_head = DiscreteValueHead(channels, height, width,
                                                num_value_hidden_channels, discrete_value_size)
        self.discrete = discrete_value_size > 1

    def forward(self, hidden_state: torch.Tensor):
        policy_logit = self.policy_head(hidden_state)
        if not self.discrete:
            return policy_logit, self.value_head(hidden_state), None
        value_logit = self.value_head(hidden_state)
        return policy_logit, torch.softmax(value_logit, dim=-1), value_logit


class MuZeroNetwork(nn.Module):
    """Board-game MuZero (``atari_mode=False``) and MuZero-Atari
    (``atari_mode=True``) in one module, as the reference's
    ``create_network.py:6-63`` picks them."""

    def __init__(self, num_input_channels: int, input_height: int, input_width: int,
                 num_hidden_channels: int, hidden_height: int, hidden_width: int,
                 num_action_feature_channels: int, num_blocks: int, action_size: int,
                 num_value_hidden_channels: int, discrete_value_size: int = 1,
                 atari_mode: bool = False):
        super().__init__()
        c = num_hidden_channels
        rep = _AtariRepresentation if atari_mode else _Representation
        self.representation = rep(num_input_channels, c, num_blocks)
        self.dynamics = _Dynamics(c, num_action_feature_channels, num_blocks, hidden_height,
                                  hidden_width, discrete_value_size if atari_mode else 0)
        self.prediction = _Prediction(c, hidden_height, hidden_width, action_size,
                                      num_value_hidden_channels, discrete_value_size)

    def _outputs(self, hidden: torch.Tensor) -> dict:
        policy_logit, value, value_logit = self.prediction(hidden)
        out = {"policy_logit": policy_logit, "policy": torch.softmax(policy_logit, dim=-1),
               "value": value, "hidden_state": hidden}
        if value_logit is not None:
            out["value_logit"] = value_logit
        return out

    def initial_inference(self, state: torch.Tensor) -> dict:
        """representation + prediction (reference muzero_network.py:136-143);
        ``state`` [B, H, W, C]."""
        hidden = scale_hidden_state(self.representation(state.permute(0, 3, 1, 2)))
        return self._outputs(hidden)

    def recurrent_inference(self, hidden_state: torch.Tensor, action_plane: torch.Tensor) -> dict:
        """dynamics + prediction (reference muzero_network.py:145-152)."""
        next_hidden, reward_logit = self.dynamics(hidden_state, action_plane)
        out = self._outputs(scale_hidden_state(next_hidden))
        if reward_logit is not None:
            out["reward_logit"] = reward_logit
            out["reward"] = torch.softmax(reward_logit, dim=-1)
        return out

    def forward(self, state: torch.Tensor) -> dict:
        """The default call is the initial inference."""
        return self.initial_inference(state)

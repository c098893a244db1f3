"""AlphaZero network (port of ``minizero_tpu/models/alphazero.py``; reference
``minizero/network/py/alphazero_network.py``).

Conv stem + N residual blocks + policy/value heads; returns
``{policy_logit, policy, value[, value_logit]}`` like the reference's forward
(``alphazero_network.py:90-113``). Input features are ``[B, H, W, C]``, the
JAX layout; the module permutes them to NCHW for the convolutions.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from minizero_tpu_torch.models.blocks import (
    DiscreteValueHead, PolicyHead, ResidualBlock, ValueHead, _bn)


class AlphaZeroNetwork(nn.Module):
    def __init__(self, num_input_channels: int, input_height: int, input_width: int,
                 num_hidden_channels: int, hidden_height: int, hidden_width: int,
                 num_blocks: int, action_size: int, num_value_hidden_channels: int,
                 discrete_value_size: int = 1):
        super().__init__()
        self.discrete_value_size = discrete_value_size
        c = num_hidden_channels
        self.conv = nn.Conv2d(num_input_channels, c, 3, padding=1, bias=True)
        self.bn = _bn(c)
        self.blocks = nn.ModuleList([ResidualBlock(c) for _ in range(num_blocks)])
        self.policy_head = PolicyHead(c, hidden_height, hidden_width, action_size)
        if discrete_value_size == 1:
            self.value_head = ValueHead(c, hidden_height, hidden_width, num_value_hidden_channels)
        else:
            self.value_head = DiscreteValueHead(
                c, hidden_height, hidden_width, num_value_hidden_channels, discrete_value_size)

    def forward(self, state: torch.Tensor) -> dict:
        """state: [B, H, W, C_in] -> dict of outputs."""
        x = state.permute(0, 3, 1, 2)
        x = F.relu(self.bn(self.conv(x)))
        for block in self.blocks:
            x = block(x)
        policy_logit = self.policy_head(x)
        policy = torch.softmax(policy_logit, dim=-1)
        if self.discrete_value_size == 1:
            return {"policy_logit": policy_logit, "policy": policy,
                    "value": self.value_head(x)}
        value_logit = self.value_head(x)
        return {"policy_logit": policy_logit, "policy": policy,
                "value_logit": value_logit, "value": torch.softmax(value_logit, dim=-1)}

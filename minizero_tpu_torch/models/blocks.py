"""Network building blocks in NCHW (port of ``minizero_tpu/models/blocks.py``;
reference ``minizero/network/py/network_unit.py``).

ResidualBlock (2x conv3x3 + BN), PolicyHead (1x1 conv -> FC logits),
ValueHead (1x1 conv -> FC -> tanh), DiscreteValueHead (bin logits). Layers
keep torch's default initialisation, which the JAX package copies
(``blocks.py:21-53``). BatchNorm: eps 1e-5, momentum 0.1 (flax's 0.9).

The heads flatten NCHW, as the reference does. The JAX package flattens
NHWC, so ``weights.from_jax_variables`` permutes the input rows of the first
dense layer of each head.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def _bn(channels: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(channels, eps=1e-5, momentum=0.1)


class ResidualBlock(nn.Module):
    """reference network_unit.py:6-22"""

    def __init__(self, channels: int):
        super().__init__()
        self.conv1 = nn.Conv2d(channels, channels, 3, padding=1, bias=True)
        self.bn1 = _bn(channels)
        self.conv2 = nn.Conv2d(channels, channels, 3, padding=1, bias=True)
        self.bn2 = _bn(channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return F.relu(x + y)


class PolicyHead(nn.Module):
    """reference network_unit.py:25-42: 1x1 conv to ceil(A/(H*W)) channels,
    BN, relu, FC to action logits."""

    def __init__(self, in_channels: int, height: int, width: int, action_size: int):
        super().__init__()
        out_channels = math.ceil(action_size / (height * width))
        self.conv = nn.Conv2d(in_channels, out_channels, 1, bias=True)
        self.bn = _bn(out_channels)
        self.fc = nn.Linear(out_channels * height * width, action_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn(self.conv(x)))
        return self.fc(x.flatten(1))


class ValueHead(nn.Module):
    """Scalar tanh value head (reference network_unit.py:45-66)."""

    def __init__(self, in_channels: int, height: int, width: int, hidden_channels: int):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, 1, 1, bias=True)
        self.bn = _bn(1)
        self.fc1 = nn.Linear(height * width, hidden_channels)
        self.fc2 = nn.Linear(hidden_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn(self.conv(x)))
        x = F.relu(self.fc1(x.flatten(1)))
        return torch.tanh(self.fc2(x))


class DiscreteValueHead(nn.Module):
    """Distributional value head returning bin logits
    (reference network_unit.py:69-87)."""

    def __init__(self, in_channels: int, height: int, width: int,
                 hidden_channels: int, value_size: int):
        super().__init__()
        out_channels = math.ceil(value_size / (height * width))
        self.conv = nn.Conv2d(in_channels, out_channels, 1, bias=True)
        self.bn = _bn(out_channels)
        self.fc1 = nn.Linear(out_channels * height * width, hidden_channels)
        self.fc2 = nn.Linear(hidden_channels, value_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn(self.conv(x)))
        x = F.relu(self.fc1(x.flatten(1)))
        return self.fc2(x)


def scale_hidden_state(hidden_state: torch.Tensor) -> torch.Tensor:
    """Min-max scale each sample's hidden state to [0, 1], with the range
    widened by 1e-5 where it is below 1e-5 (reference
    ``muzero_network.py:154-164``; JAX ``blocks.py:131-182``). Forward only:
    the JAX package's arg-index min/max backward belongs with the trainer,
    which is not ported yet (ROADMAP.md)."""
    flat = hidden_state.reshape(hidden_state.shape[0], -1)
    mn = flat.amin(-1, keepdim=True)
    mx = flat.amax(-1, keepdim=True)
    s = mx - mn
    s = torch.where(s < 1e-5, s + 1e-5, s)
    return ((flat - mn) / s).reshape(hidden_state.shape)


def same_pad(x: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """Zero-pad an NCHW map as flax's (TensorFlow's) "SAME" padding does for
    a ``kernel`` x ``kernel`` window at ``stride``: the total padding
    ``max((ceil(n / stride) - 1) * stride + kernel - n, 0)`` per dimension,
    its smaller half before and the larger after. For a stride-2 3x3 window
    on an even size that is 0 before and 1 after, which ``padding=1`` of a
    torch conv or pool (1 on both sides) does not give."""
    pads = []
    for n in (x.shape[3], x.shape[2]):  # F.pad's order: last dimension first
        total = max((-(-n // stride) - 1) * stride + kernel - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)

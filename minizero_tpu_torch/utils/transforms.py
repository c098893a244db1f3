"""Distributional value decoding (port of
``minizero_tpu/utils/transforms.py``; reference ``minizero/utils/utils.h:93-108``
and ``environment/atari/atari.cpp:279-294``)."""

from __future__ import annotations

import torch

_EPS = 0.001


def invert_value(value: torch.Tensor) -> torch.Tensor:
    """h^-1(x) (reference utils.h:102-108)."""
    inner = (torch.sqrt(1.0 + 4.0 * _EPS * (torch.abs(value) + 1.0 + _EPS)) - 1.0) / (2.0 * _EPS)
    return torch.sign(value) * (inner * inner - 1.0)


def from_discrete_value(probs: torch.Tensor) -> torch.Tensor:
    """Expectation over bins then h^-1 (reference
    ``alphazero_network.h:85-95``). probs: [..., value_size] -> [...]."""
    value_size = probs.shape[-1]
    support = torch.arange(value_size, dtype=torch.float32, device=probs.device) - value_size // 2
    expectation = torch.sum(probs * support, dim=-1)
    return invert_value(expectation)

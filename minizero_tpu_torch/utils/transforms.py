"""Value transforms and distributional (two-hot) value coding (port of
``minizero_tpu/utils/transforms.py``; reference
``minizero/utils/utils.h:93-108`` and ``environment/atari/atari.cpp:279-294``)."""

from __future__ import annotations

import torch

_EPS = 0.001


def transform_value(value: torch.Tensor) -> torch.Tensor:
    """h(x) = sign(x)(sqrt(|x|+1)-1) + eps*x (reference utils.h:93-100)."""
    return torch.sign(value) * (torch.sqrt(torch.abs(value) + 1.0) - 1.0) + _EPS * value


def invert_value(value: torch.Tensor) -> torch.Tensor:
    """h^-1(x) (reference utils.h:102-108)."""
    inner = (torch.sqrt(1.0 + 4.0 * _EPS * (torch.abs(value) + 1.0 + _EPS)) - 1.0) / (2.0 * _EPS)
    return torch.sign(value) * (inner * inner - 1.0)


def to_discrete_value(value: torch.Tensor, value_size: int) -> torch.Tensor:
    """Two-hot encode ``value`` (already h-transformed) into ``value_size``
    bins centred on 0 (reference atari.cpp:279-294). value: [...] ->
    [..., value_size]."""
    shift = value_size // 2
    floor = torch.floor(value)
    ceil = torch.ceil(value)
    floor_idx = (floor.to(torch.int64) + shift).clamp(0, value_size - 1)
    ceil_idx = (ceil.to(torch.int64) + shift).clamp(0, value_size - 1)
    same = floor == ceil
    w_floor = torch.where(same, 1.0, ceil - value)
    w_ceil = torch.where(same, 0.0, value - floor)
    bins = torch.arange(value_size, device=value.device)
    oh_f = (bins == floor_idx[..., None]).to(torch.float32)
    oh_c = (bins == ceil_idx[..., None]).to(torch.float32)
    return oh_f * w_floor[..., None] + oh_c * w_ceil[..., None]


def from_discrete_value(probs: torch.Tensor) -> torch.Tensor:
    """Expectation over bins then h^-1 (reference
    ``alphazero_network.h:85-95``). probs: [..., value_size] -> [...]."""
    value_size = probs.shape[-1]
    support = torch.arange(value_size, dtype=torch.float32, device=probs.device) - value_size // 2
    expectation = torch.sum(probs * support, dim=-1)
    return invert_value(expectation)

"""Bit-packing for binary feature planes (port of
``minizero_tpu/utils/bitpack.py``).

Board-game feature planes are 0/1 masks, so 8 planes pack into one byte for
the self-play record stream and the replay buffer; the train step unpacks
them on the device.
"""

from __future__ import annotations

import torch


def packed_channels(channels: int) -> int:
    return -(-channels // 8)


def pack_planes(x: torch.Tensor) -> torch.Tensor:
    """[.., C] binary (0/1) values -> u8 [.., ceil(C/8)], bit k of byte j =
    plane 8*j + k."""
    c = x.shape[-1]
    pc = packed_channels(c)
    bits = torch.zeros(x.shape[:-1] + (pc * 8,), dtype=torch.uint8, device=x.device)
    bits[..., :c] = (x > 0).to(torch.uint8)
    bits = bits.reshape(x.shape[:-1] + (pc, 8))
    shifts = torch.arange(8, dtype=torch.uint8, device=x.device)
    return torch.sum(bits << shifts, dim=-1, dtype=torch.uint8)


def unpack_planes(packed: torch.Tensor, channels: int) -> torch.Tensor:
    """u8 [.., ceil(C/8)] -> f32 [.., C] of 0/1 planes (the inverse of
    ``pack_planes``; the trainer unpacks the replay's packed records)."""
    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)
    bits = (packed[..., None] >> shifts) & 1
    bits = bits.reshape(packed.shape[:-1] + (packed.shape[-1] * 8,))
    return bits[..., :channels].to(torch.float32)

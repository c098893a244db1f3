"""Per-game chance streams for the stochastic envs (2048, Tetris Block
Puzzle).

The JAX package carries a PRNG key in each game's state and splits it in
``step``. The port carries a counter-based stream instead: an int64 ``key``
per game and an int64 ``counter`` that ``step`` advances. Draw ``i`` of a
stream is the splitmix64 hash of ``key + (i + 1) * golden``, computed in
int64 tensor ops on the state's device. So a game's draws depend on its key
and counter only, not on its slot, the batch size or the other games, and
stepping one state twice (as a search does at a revisited node) draws the
same chance event. The two packages' streams differ; tests hand the JAX
env's chance events to the port's deterministic halves (``spawn``,
``place``).
"""

from __future__ import annotations

import torch


def _s64(x: int) -> int:
    """An unsigned 64-bit constant as the int64 with the same bits."""
    return x - (1 << 64) if x >= 1 << 63 else x


_GOLDEN = _s64(0x9E3779B97F4A7C15)
_MIX1 = _s64(0xBF58476D1CE4E5B9)
_MIX2 = _s64(0x94D049BB133111EB)


def _shr(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int64 ``x`` by ``k`` (torch's ``>>`` is
    arithmetic)."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def mix(index: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """splitmix64 output ``index`` of the stream seeded with ``key`` (int64
    tensors; products wrap modulo 2^64)."""
    z = key + (index + 1) * _GOLDEN
    z = (z ^ _shr(z, 30)) * _MIX1
    z = (z ^ _shr(z, 27)) * _MIX2
    return z ^ _shr(z, 31)


def uniform_int(key: torch.Tensor, index: torch.Tensor, m) -> torch.Tensor:
    """int64 draws in ``[0, m)`` (``m`` an int or an int64 tensor of at most
    2^24): the top 24 bits of the hash, scaled by ``m``."""
    return (_shr(mix(index, key), 40) * m) >> 24


def new_keys(batch: int, generator, device) -> torch.Tensor:
    """int64[B] stream keys drawn from ``generator`` (a ``torch.Generator``
    on ``device``, or None for the default one)."""
    return torch.randint(0, 1 << 62, (batch,), generator=generator, dtype=torch.int64,
                         device=device)

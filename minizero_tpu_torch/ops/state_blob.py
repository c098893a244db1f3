"""Pack a batch of env states into one dense int32 row per game (port of
``minizero_tpu/ops/state_blob.py``).

The large-N AlphaZero loop keeps every tree node's env state in a
``[B, N, W]`` int32 blob beside the tree and fetches the selected parent's
row with one row gather per simulation (``ops/gather_rows.py``).

Packing is pure bit movement, exact for every dtype: bool -> u8, then every
field is viewed as bytes, concatenated in field order, padded to a multiple
of 4 bytes and viewed as int32. The port's state dataclasses declare their
fields in the order of the JAX package's flax state classes, whose pytree
flatten order is their field order, so a row here equals the JAX package's
row for the same state word for word. ``BlobSpec.width`` is the state's own
width; the large-N engine stores rows at a stride rounded up to 4 words (16
bytes, the card's copy width), not to the JAX engine's (8, 128) TPU tiles.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Tuple

import torch


class BlobSpec(NamedTuple):
    """Static description of a packed state layout."""

    cls: type  # the state dataclass
    names: Tuple[str, ...]  # field names in packing order
    shapes: Tuple[Tuple[int, ...], ...]  # per-field trailing shape (no batch dim)
    dtypes: Tuple[torch.dtype, ...]
    nbytes: Tuple[int, ...]  # per-field bytes per game
    width: int  # int32 words per game


def blob_spec(states: Any) -> BlobSpec:
    """The layout of a batched state dataclass (``[B, ...]`` fields)."""
    fields = dataclasses.fields(states)
    names = tuple(f.name for f in fields)
    xs = [getattr(states, n) for n in names]
    shapes = tuple(tuple(x.shape[1:]) for x in xs)
    dtypes = tuple(x.dtype for x in xs)
    nbytes = tuple(int(x[0].numel()) * x.element_size() for x in xs)
    return BlobSpec(type(states), names, shapes, dtypes, nbytes, width=-(-sum(nbytes) // 4))


def _to_bytes(x: torch.Tensor) -> torch.Tensor:
    """[B, ...] any dtype -> u8[B, nbytes] (little-endian, as on both the
    CPU and the card)."""
    if x.dtype == torch.bool:
        x = x.to(torch.uint8)
    return x.reshape(x.shape[0], -1).contiguous().view(torch.uint8)


def pack_rows(spec: BlobSpec, states: Any) -> torch.Tensor:
    """Batched state -> i32[B, W]."""
    byts = torch.cat([_to_bytes(getattr(states, n)) for n in spec.names], dim=1)
    pad = spec.width * 4 - byts.shape[1]
    if pad:
        byts = torch.nn.functional.pad(byts, (0, pad))
    return byts.view(torch.int32)


def unpack_rows(spec: BlobSpec, blob: torch.Tensor) -> Any:
    """i32[B, W'] -> batched state, for any ``W' >= spec.width``: fields are
    read by byte offset, so the words past ``spec.width`` (the engine's pad
    to a 16-byte row stride) are ignored."""
    b = blob.shape[0]
    byts = blob.contiguous().view(torch.uint8)
    out = {}
    off = 0
    for name, shape, dtype, nb in zip(spec.names, spec.shapes, spec.dtypes, spec.nbytes):
        chunk = byts[:, off:off + nb]
        off += nb
        if dtype == torch.bool:
            x = chunk != 0
        else:
            x = chunk.clone(memory_format=torch.contiguous_format).view(dtype)
        out[name] = x.reshape((b,) + shape)
    return spec.cls(**out)

"""Observation (OBS tag) payloads of long-episode records (port of the
record half of ``minizero_tpu/tools/obs.py``).

Reference: ``minizero/utils/utils.h:35-91`` (gzip + hex-string
compression). An OBS tag keeps an Atari record's per-step u8 frames inside
the record, so a resumed run rebuilds its frame window from the records
alone. The zero loop and ``-mode sp`` write the tags with
``pack_observations``; ``ZeroLoop.resume`` reads them back with
``unpack_observations``.
"""

from __future__ import annotations

import zlib

import numpy as np


def compress_obs(data: bytes) -> str:
    """gzip + hex (reference compressString / binaryToHexString,
    utils.h:35-68)."""
    return zlib.compress(data, level=6).hex()


def decompress_obs(text: str) -> bytes:
    return zlib.decompress(bytes.fromhex(text))


def pack_observations(obs: np.ndarray) -> str:
    """A u8 observation stack as an OBS tag payload: ndim, shape (int32)
    and the bytes, compressed."""
    arr = np.ascontiguousarray(obs, np.uint8)
    header = np.asarray(arr.shape, np.int32).tobytes()
    return compress_obs(np.asarray([arr.ndim], np.int32).tobytes() + header + arr.tobytes())


def unpack_observations(payload: str) -> np.ndarray:
    raw = decompress_obs(payload)
    ndim = int(np.frombuffer(raw[:4], np.int32)[0])
    shape = tuple(np.frombuffer(raw[4:4 + 4 * ndim], np.int32))
    return np.frombuffer(raw[4 + 4 * ndim:], np.uint8).reshape(shape)

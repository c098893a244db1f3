"""Kill-All-Go 7x7 seki pattern table: generation, caching, the lookup's
sorted arrays (port of ``minizero_tpu/envs/seki7x7.py``, numpy only).

Counterpart of the reference's ``Seki7x7Table`` + ``SekiSearch``
(``minizero/environment/killallgo/killallgo_seki_7x7.{h,cpp}``): the table
maps an enclosed area's (black stones, empty points) pair to "this local
position is seki", proven by an AND-OR search that neither side can change
the local status. The port keeps its own copies of the generator
(``native/seki_gen.cpp``) and of the two tables it made
(``native/seki_7x7_5_5.tbl``, ``seki_7x7_5_8.tbl``, the default): a table
that is present is only read. A missing one is generated, which can take
hours; the generator builds with ``g++`` into ``_build/``.

Differences from the reference, both conservative (as in the JAX package):
patterns whose proof depended on a superko prune are left out, and the
runtime check scans every enclosed area, not only those the last move
touched.
"""

from __future__ import annotations

import os
import subprocess
from typing import Tuple

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE = os.path.join(_PKG, "native")
_SRC = os.path.join(NATIVE, "seki_gen.cpp")
_BIN = os.path.join(_PKG, "_build", "seki_gen")

# uint32 mixing constants (wrapped int32 on the device)
MIX = np.asarray([0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D, 0x27D4EB2F], np.uint64)


def _build_generator() -> str:
    if not os.path.exists(_BIN) or os.path.getmtime(_BIN) < os.path.getmtime(_SRC):
        os.makedirs(os.path.dirname(_BIN), exist_ok=True)
        subprocess.run(["g++", "-O2", "-o", _BIN, _SRC], check=True, capture_output=True,
                       timeout=300)
    return _BIN


def table_path(min_size: int, max_size: int) -> str:
    return os.path.join(NATIVE, f"seki_7x7_{min_size}_{max_size}.tbl")


def ensure_table(min_size: int = 5, max_size: int = 8) -> np.ndarray:
    """Load (or generate and keep) the table: uint64[M, 2], (black bits,
    empty bits) per seki pattern."""
    path = table_path(min_size, max_size)
    if not os.path.exists(path):
        subprocess.run([_build_generator(), str(min_size), str(max_size), path], check=True,
                       timeout=36000)
    return load_table(path)


def load_table(path: str) -> np.ndarray:
    rows = []
    with open(path) as f:
        for line in f:
            a, _, b = line.strip().partition(" ")
            if a:
                rows.append((int(a, 16), int(b, 16)))
    if not rows:
        return np.zeros((0, 2), np.uint64)
    return np.asarray(rows, np.uint64)


def pack_words(black: np.ndarray, empty: np.ndarray) -> np.ndarray:
    """49-bit masks -> int32[..., 4] words (25 low bits, 24 high bits each),
    the packing ``KillAllGoEnv`` does on the device."""
    black = np.asarray(black, np.uint64)
    empty = np.asarray(empty, np.uint64)
    w = np.stack([black & np.uint64(0x1FFFFFF), black >> np.uint64(25),
                  empty & np.uint64(0x1FFFFFF), empty >> np.uint64(25)], axis=-1)
    return w.astype(np.uint32).view(np.int32)


def mix_hash_np(words: np.ndarray) -> np.ndarray:
    """int32 words[..., 4] -> int32 hash (wrapping multiply and xor, the
    bit pattern of the device's int32 arithmetic)."""
    w = words.view(np.uint32).astype(np.uint64)
    h = np.zeros(w.shape[:-1], np.uint64)
    for k in range(4):
        h ^= (w[..., k] * MIX[k]) & np.uint64(0xFFFFFFFF)
    return h.astype(np.uint32).view(np.int32)


def sorted_device_table(table: np.ndarray) -> Tuple[np.ndarray, np.ndarray, int]:
    """-> (sorted int32 hashes [M], their int32 words [M, 4], the longest
    run of equal hashes), ready to become device tensors."""
    if len(table) == 0:
        return np.zeros((0,), np.int32), np.zeros((0, 4), np.int32), 1
    words = pack_words(table[:, 0], table[:, 1])
    h = mix_hash_np(words)
    order = np.argsort(h, kind="stable")
    h = h[order]
    words = words[order]
    # the longest run of equal hashes bounds the lookup's compare window
    runs = np.diff(np.flatnonzero(np.concatenate(([True], h[1:] != h[:-1], [True]))))
    return h, words, int(runs.max())

"""Native (C++) record codec, loaded through ``ctypes`` (port of
``minizero_tpu/native/__init__.py``).

``codec.cpp`` turns a whole game's per-move arrays into the record's move
stream in one call and parses such a stream back (reference
``base_env.h:207-319``, ``data_loader.cpp:99-200``). It is built with ``g++``
at first use into ``minizero_tpu_torch/_build/libmzcodec-<hash>.so`` (keyed
by a hash of the source and the flags), never next to the source. The plain
version is the pure-Python serializer and parser of
``selfplay/record.py``; every entry point here returns None where the
library cannot be built or loaded, and the caller then takes the plain
version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "codec.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
GXX_FLAGS = ("-O3", "-shared", "-fPIC")


class _Codec:
    """The loaded library, built once per process (first call wins)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.lib: Optional[ctypes.CDLL] = None
        self.tried = False
        self.error = ""


_CODEC = _Codec()


def library_path() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libmzcodec-{digest}.so")


def _build(path: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    subprocess.run(["g++", *GXX_FLAGS, _SRC, "-o", tmp], check=True, capture_output=True,
                   timeout=120)
    os.replace(tmp, path)


def load() -> Optional[ctypes.CDLL]:
    """The codec library, building it on first use; None if it cannot be
    built or loaded (``load_error()`` says why)."""
    c = _CODEC
    with c.lock:
        if c.lib is not None or c.tried:
            return c.lib
        c.tried = True
        path = library_path()
        try:
            if not os.path.exists(path):
                _build(path)
            lib = ctypes.CDLL(path)
        except (OSError, subprocess.SubprocessError) as exc:
            c.error = f"{type(exc).__name__}: {exc}"
            return None
        lib.mz_serialize_moves.restype = ctypes.c_int
        lib.mz_serialize_moves.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.c_char_p, ctypes.c_int,
        ]
        lib.mz_parse_moves.restype = ctypes.c_int
        lib.mz_parse_moves.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p,
        ]
        c.lib = lib
        return lib


def load_error() -> str:
    return _CODEC.error


def serialize_moves(
    actions: np.ndarray,
    players: np.ndarray,
    policy: np.ndarray,
    values: np.ndarray,
    rewards: np.ndarray,
    threshold: float = 0.0,
) -> Optional[str]:
    """One game's ``;B[a]P[...]V[v]R[r]`` move stream; None -> use the
    plain version."""
    lib = load()
    if lib is None:
        return None
    length = len(actions)
    action_size = policy.shape[1] if policy.ndim == 2 else 0
    actions = np.ascontiguousarray(actions, np.int32)
    players = np.ascontiguousarray(players, np.int8)
    policy = np.ascontiguousarray(policy, np.float32)
    values = np.ascontiguousarray(values, np.float32)
    rewards = np.ascontiguousarray(rewards, np.float32)
    if not (len(players) == len(values) == len(rewards) == length
            and (length == 0 or policy.shape[0] == length)):
        raise ValueError("serialize_moves: per-move arrays of different lengths")
    cap = 64 + length * (32 + 24 * max(1, int((policy > threshold).sum() // max(length, 1) + 2)))
    while True:
        buf = ctypes.create_string_buffer(cap)
        n = lib.mz_serialize_moves(
            actions.ctypes.data, players.ctypes.data, policy.ctypes.data,
            values.ctypes.data, rewards.ctypes.data,
            length, action_size, ctypes.c_float(threshold), buf, cap,
        )
        if n >= 0:
            return buf.raw[:n].decode("ascii")
        cap *= 4
        if cap > 1 << 28:
            return None


def parse_moves(text: str, max_moves: int, action_size: int):
    """Parse a record's move stream into arrays; None -> the plain parser."""
    lib = load()
    if lib is None:
        return None
    raw = text.encode("ascii", errors="ignore")
    actions = np.zeros(max_moves, np.int32)
    players = np.zeros(max_moves, np.int8)
    policy = np.zeros((max_moves, action_size), np.float32)
    values = np.zeros(max_moves, np.float32)
    rewards = np.zeros(max_moves, np.float32)
    n = lib.mz_parse_moves(
        raw, len(raw), max_moves, action_size,
        actions.ctypes.data, players.ctypes.data, policy.ctypes.data,
        values.ctypes.data, rewards.ctypes.data,
    )
    if n < 0:
        return None
    return (
        actions[:n].copy(), players[:n].copy(), policy[:n].copy(),
        values[:n].copy(), rewards[:n].copy(),
    )

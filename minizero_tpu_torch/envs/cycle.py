"""The cycle rule of Lines of Action and Surakarta (a move may not recreate
an earlier (position, player to move)), shared by both ports: the JAX
package's additive dual-uint32 Zobrist hashes (``envs/linesofaction.py``,
``envs/surakarta.py``), held as int32 bit patterns and summed in int64 with
the mod-2^32 wrap of ``envs/go.py``.

The JAX envs test a legal mask's candidates against the history by
broadcasting ``[A, MAXH]`` comparisons a game, which batched eagerly is
``[B, A, MAXH]`` booleans (0.77 GB a call at B=1024 for Lines of Action).
Here each game's history is sorted once as packed int64 keys and the
``[B, A]`` candidates are looked up by ``torch.searchsorted``: the same
answer in ``O(A log MAXH)`` memory a game.
"""

from __future__ import annotations

import numpy as np
import torch

from minizero_tpu_torch.envs.go import _wrap32

_SENTINEL = torch.iinfo(torch.int64).max


def zobrist_keys(nn: int, seed: int):
    """The JAX envs' key draws, bit for bit: (key_a, key_b) int64[NN, 2]
    holding int32 bit patterns, and the two turn keys as ints."""
    rs = np.random.RandomState(seed)
    ka = rs.randint(0, 2**32, size=(nn, 2), dtype=np.uint64).astype(np.uint32)
    kb = rs.randint(0, 2**32, size=(nn, 2), dtype=np.uint64).astype(np.uint32)
    tk = rs.randint(0, 2**32, size=(2,), dtype=np.uint64).astype(np.uint32).view(np.int32)
    return (ka.view(np.int32).astype(np.int64), kb.view(np.int32).astype(np.int64),
            int(tk[0]), int(tk[1]))


def board_hash(board: torch.Tensor, turn: torch.Tensor, key: torch.Tensor,
               turn_key: int) -> torch.Tensor:
    """i32[B]: the additive hash of boards i8[B, NN] (stones 1 and 2) and
    the player to move ``turn`` i8[B], under one key half (int64[NN, 2])."""
    colour = (board.long() - 1).clamp(0, 1)
    pos = torch.arange(board.shape[1], device=board.device)[None, :]
    cells = torch.where(board > 0, key[pos, colour], 0)
    return _wrap32(cells.sum(-1) + (turn == 2).long() * turn_key)


def move_hash(hash_: torch.Tensor, turn: torch.Tensor, board: torch.Tensor, frm: torch.Tensor,
              dest: torch.Tensor, key: torch.Tensor, turn_key: int) -> torch.Tensor:
    """i32[B, A]: the hash after each move id (from ``frm`` to ``dest``,
    long[A]) of the player to move, a capture where ``dest`` holds an enemy
    stone (isCircularAction, linesofaction.cpp:456-470)."""
    t = (turn.long() - 1).clamp(0, 1)[:, None]  # [B, 1]
    frm, dest = frm[None, :], dest[None, :]
    cap = board[:, dest[0]] == (3 - turn)[:, None].to(board.dtype)
    delta = key[dest, t] - key[frm, t] - torch.where(cap, key[dest, 1 - t], 0)
    tk = torch.where(t == 0, turn_key, -turn_key)
    return _wrap32(hash_.long()[:, None] + delta + tk)


def _pack(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a.long() << 32) | (b.long() & 0xFFFFFFFF)


def seen_before(history_a: torch.Tensor, history_b: torch.Tensor, num_moves: torch.Tensor,
                cand_a: torch.Tensor, cand_b: torch.Tensor) -> torch.Tensor:
    """bool[B, A]: each candidate (cand_a, cand_b) i32[B, A] equals a
    history entry (i32[B, MAXH]) at an index <= ``num_moves`` (i32[B]).
    Entries past ``num_moves`` become the largest int64; a candidate equal
    to that value repeats only where a live entry equals it too."""
    keys = _pack(history_a, history_b)
    live = torch.arange(keys.shape[1], device=keys.device)[None, :] <= num_moves.long()[:, None]
    hist = torch.where(live, keys, _SENTINEL).sort(dim=1).values
    cand = _pack(cand_a, cand_b)
    pos = torch.searchsorted(hist, cand).clamp(max=hist.shape[1] - 1)
    found = hist.gather(1, pos) == cand
    live_sentinel = (live & (keys == _SENTINEL)).any(1, keepdim=True)
    return found & ((cand != _SENTINEL) | live_sentinel)

"""8-fold dihedral board symmetry (port of ``minizero_tpu/utils/rotation.py``).

The same 8 rotations as the reference's ``minizero/utils/rotation.h``
(identity, 90/180/270, and their horizontal mirrors) as static numpy
permutation tables; the batched torch helpers apply one rotation per game
with a gather (features, policies read back, and the trainer's rotated
policy targets and MuZero unroll actions).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

NUM_ROTATIONS = 8

# Index of the inverse rotation (reference ``rotation.h:21-29``).
REVERSED_ROTATION = np.array([0, 3, 2, 1, 4, 5, 6, 7], dtype=np.int32)


def _rotate_xy(rotation: int, x: np.ndarray, y: np.ndarray):
    if rotation == 0:
        return x, y
    if rotation == 1:
        return y, -x
    if rotation == 2:
        return -x, -y
    if rotation == 3:
        return -y, x
    if rotation == 4:
        return x, -y
    if rotation == 5:
        return -y, -x
    if rotation == 6:
        return -x, y
    if rotation == 7:
        return y, x
    raise ValueError(f"bad rotation {rotation}")


@functools.lru_cache(maxsize=None)
def position_rotation_table(board_size: int) -> np.ndarray:
    """``table[r, pos] = rotated position`` for all 8 rotations.

    Matches ``getPositionByRotating`` (reference ``rotation.h:51-93``); the
    out-of-board "pass" position ``board_size**2`` maps to itself.
    """
    n = board_size
    pos = np.arange(n * n)
    center = (n - 1) / 2.0
    x = pos % n - center
    y = pos // n - center
    table = np.zeros((NUM_ROTATIONS, n * n + 1), dtype=np.int32)
    for r in range(NUM_ROTATIONS):
        rx, ry = _rotate_xy(r, x, y)
        table[r, : n * n] = np.round((ry + center) * n + (rx + center)).astype(np.int32)
        table[r, n * n] = n * n  # pass action is rotation-invariant
    return table


@functools.lru_cache(maxsize=None)
def action_rotation_table(board_size: int, action_size: int) -> np.ndarray:
    """``table[r, action] = rotated action`` for board games whose action ids
    are board positions (+ optional trailing pass)."""
    n = board_size
    table = np.tile(np.arange(action_size, dtype=np.int32), (NUM_ROTATIONS, 1))
    pos_table = position_rotation_table(n)
    m = min(action_size, n * n + 1)
    table[:, :m] = pos_table[:, :m]
    return table


@functools.lru_cache(maxsize=None)
def _device_table(kind: str, board_size: int, action_size: int, device: str) -> torch.Tensor:
    """The int64 permutation table of ``kind`` on ``device``, uploaded once
    per process: an upload on every call would wait for the device's queue
    to drain. Callers only read it.

    - "planes": ``[8, H*W]``, the feature gather ``table[rev(r)]``;
    - "actions": ``[8, A]``, ``table[r, a]`` = rotated action;
    - "labels": ``[8, A]``, the policy-label gather ``table[rev(r)]``."""
    if kind == "planes":
        nn = board_size * board_size
        table = position_rotation_table(board_size)[:, :nn][REVERSED_ROTATION]
    elif kind == "actions":
        table = action_rotation_table(board_size, action_size)
    elif kind == "labels":
        table = action_rotation_table(board_size, action_size)[REVERSED_ROTATION]
    else:
        raise ValueError(f"unknown table {kind!r}")
    return torch.as_tensor(table, dtype=torch.long, device=device)


def rotate_planes_batch(planes: torch.Tensor, rotations: torch.Tensor,
                        board_size: int) -> torch.Tensor:
    """Rotate ``[B, H, W, C]`` planes, game ``b`` by ``rotations[b]``.

    Output position ``p`` reads input position ``table[rev(r), p]`` — the
    reference feature rotation convention (``tictactoe.cpp:75``: read the
    board at the reversed rotation of the position)."""
    nn = board_size * board_size
    perm = _device_table("planes", board_size, 0, str(planes.device))[rotations.long()]
    b, h, w, c = planes.shape
    flat = planes.reshape(b, nn, c)
    return torch.gather(flat, 1, perm[:, :, None].expand(b, nn, c)).reshape(planes.shape)


def rotate_action_array_batch(values: torch.Tensor, rotations: torch.Tensor,
                              board_size: int) -> torch.Tensor:
    """``out[b, a] = values[b, rotate_{rotations[b]}(a)]`` over ``[B, A]`` —
    reads a policy produced from rotated features back in original
    coordinates (reference ``zero_actor.cpp:222-223``)."""
    table = _device_table("actions", board_size, values.shape[-1], str(values.device))
    return torch.gather(values, 1, table[rotations.long()])


def rotate_policy_labels_batch(policy: torch.Tensor, rotations: torch.Tensor,
                               board_size: int) -> torch.Tensor:
    """Rotate policy targets with their features: ``out[b, ..., rot(a)] =
    policy[b, ..., a]``, i.e. a gather through ``table[rev(r)]`` (the
    trainer's augmentation, JAX ``learner/train.py:109-136``). ``policy`` is
    ``[B, A]`` or ``[B, K + 1, A]``."""
    a = policy.shape[-1]
    perm = _device_table("labels", board_size, a, str(policy.device))[rotations.long()]
    perm = perm.reshape((perm.shape[0],) + (1,) * (policy.dim() - 2) + (a,))
    return torch.gather(policy, -1, perm.expand(policy.shape))


def rotate_actions_batch(actions: torch.Tensor, rotations: torch.Tensor,
                         board_size: int, action_size: int) -> torch.Tensor:
    """``out[b, k] = table[rotations[b], actions[b, k]]``: MuZero's unroll
    actions in the rotated frame (``[B, K]`` ids)."""
    table = _device_table("actions", board_size, action_size, str(actions.device))
    return table[rotations.long()[:, None], actions.long()].to(actions.dtype)

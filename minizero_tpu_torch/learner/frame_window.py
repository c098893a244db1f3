"""The Atari frame window (port of ``minizero_tpu/learner/frame_window.py``).

The 32-channel MuZero-Atari feature stack (8 history frames x [action plane
+ RGB], reference ``atari.cpp:112-122``) repeats every frame in 8
consecutive positions' stacks. So records store each position's newest RGB
frame once (``GameRecord.frames``, u8[lead + L, H, W, 3]), the replay
window's frames stay on the device in one u8 tensor, and a training batch's
stacks are assembled there from 8 gathered rows and broadcast action planes:
per SGD step only the gather plan (indices, masks, action bytes) crosses to
the card, and each game's frames cross once, when it is added.

The ``lead`` rows of a record are up to 8 positions of pre-chunk history
(frames and the actions that led to them), so continuation chunks of long
episodes assemble the same bytes ``AtariVecEnv.features_u8`` showed the
search at self-play time (``tests/test_torch_frame_window.py``).

A window larger than ``learner_device_feature_window_gb`` keeps its frames
in host memory instead (``on_device=False``) and assembles the stacks with
numpy (``assemble_features_host``); the zero loop says so when it picks it.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List

import numpy as np
import torch

from minizero_tpu_torch import resolve_device, upload
from minizero_tpu_torch.envs.atari import ACTION_SIZE

HISTORY = 8  # frames a stack (reference atari.h kHistorySize)


def assemble_features(frames: torch.Tensor, idx: torch.Tensor, valid: torch.Tensor,
                      aplane: torch.Tensor) -> torch.Tensor:
    """u8 frame rows -> u8 stacked feature planes, on the frames' device.

    frames  u8[R, H, W, 3] — the window
    idx     int[..., 8]    — window row of history slot k (0 oldest)
    valid   bool[..., 8]   — False: zero (before the episode start)
    aplane  u8[..., 8]     — quantised action-plane byte a slot
    returns u8[..., H, W, 32]: channel 4k = action plane, 4k+1..3 = RGB
    (reference ``atari.cpp:112-122``; the train step scales by 1/255)."""
    lead_shape = tuple(idx.shape)
    h, w = frames.shape[1], frames.shape[2]
    f = frames[idx.reshape(-1).long()].reshape(*lead_shape, h, w, 3)
    f = f * valid.to(torch.uint8)[..., None, None, None]
    ap = aplane[..., None, None, None].expand(*lead_shape, h, w, 1)
    x = torch.cat([ap, f], dim=-1)                  # [..., 8, H, W, 4]
    x = x.movedim(-4, -2)                           # [..., H, W, 8, 4]
    return x.reshape(*x.shape[:-2], HISTORY * 4)    # [..., H, W, 32]


def assemble_features_host(flat_frames: np.ndarray, idx: np.ndarray,
                           valid: np.ndarray, aplane: np.ndarray) -> np.ndarray:
    """Numpy twin of :func:`assemble_features`, for a window kept in host
    memory."""
    lead_shape = idx.shape
    h, w = flat_frames.shape[1], flat_frames.shape[2]
    f = flat_frames[idx.reshape(-1)].reshape(*lead_shape, h, w, 3)
    f = np.where(valid[..., None, None, None], f, np.uint8(0))
    ap = np.broadcast_to(aplane[..., None, None, None],
                         (*lead_shape, h, w, 1)).astype(np.uint8)
    x = np.concatenate([ap, f], axis=-1)
    x = np.moveaxis(x, -4, -2)
    return np.ascontiguousarray(x).reshape(*x.shape[:-2], HISTORY * 4)


def rows_needed(cfg, max_game_length: int) -> int:
    """An upper bound on the live rows of a config's replay window: per
    record its stored positions (a chunk of ``seqlen`` trainable positions
    plus the unroll and n-step margin on both sides, or a whole episode of
    at most ``max_game_length`` moves when chunking is off), 8 lead rows
    and 2 of slack; two more records' worth for the ring-wrap tail."""
    seqlen = cfg.zero_actor_intermediate_sequence_length
    margin = cfg.learner_muzero_unrolling_step + cfg.learner_n_step_return
    stored = seqlen + 2 * margin if seqlen > 0 else max_game_length
    per_game = stored + HISTORY + 2
    games = cfg.zero_replay_buffer * cfg.zero_num_games_per_iteration
    return per_game * (games + 2)


class FrameWindow:
    """One u8 frame ring ``[rows, H, W, 3]`` on ``device`` (the card by
    default) and the host's bookkeeping of which rows hold which record.

    Records claim contiguous row ranges in arrival order; the cursor wraps
    to 0 when a record would straddle the end (the short tail is wasted), so
    a sample's 8 history rows never need modular indexing. Records whose
    rows the cursor overwrites are dropped; the owner sizes ``rows`` to its
    replay window (``rows_needed``). With ``on_device=False`` the rows live
    in a host array, ``assemble`` runs on numpy and uploads the stacks."""

    def __init__(self, rows: int, height: int, width: int, device=None, on_device: bool = True):
        self.rows = int(rows)
        self.on_device = on_device
        self.device = resolve_device(device)
        if on_device:
            self.frames = torch.zeros((self.rows, height, width, 3), dtype=torch.uint8,
                                      device=self.device)
        else:
            self.frames = np.zeros((self.rows, height, width, 3), np.uint8)
        self._cursor = 0
        # id(record) -> dict(base, lead, n, aplane_full u8[lead+L], record);
        # the record reference keeps its id from being reused while it lives
        self._games: "OrderedDict[int, dict]" = OrderedDict()

    @property
    def nbytes(self) -> int:
        return self.rows * int(np.prod(self.frames.shape[1:]))

    def add(self, record) -> None:
        """Copy ``record.frames`` (u8[lead+L, H, W, 3]) into the ring."""
        frames = record.frames
        n = frames.shape[0]
        if n > self.rows:
            raise ValueError(f"frame window too small: a record needs {n} rows, "
                             f"the window has {self.rows}")
        base = self._claim(n)
        if self.on_device:
            self.frames[base:base + n] = upload(frames, self.device)
        else:
            self.frames[base:base + n] = frames
        lead_actions = (record.lead_actions if record.lead_actions is not None
                        else np.zeros(0, np.int32))
        actions_full = np.concatenate([np.asarray(lead_actions, np.int64),
                                       np.asarray(record.actions, np.int64)])
        # quantised action-plane byte a position (atari.cpp: action/|A|*255)
        aplane_full = np.clip(actions_full.astype(np.float32) / ACTION_SIZE * 255.0,
                              0, 255).astype(np.uint8)
        self._games[id(record)] = {"base": base, "lead": int(record.frame_lead), "n": n,
                                   "aplane_full": aplane_full, "record": record}
        self._cursor = base + n

    def _claim(self, n: int) -> int:
        """The first row of a free block of ``n`` rows at the cursor; a tail
        too short for it is evicted and the cursor wraps to 0."""
        if self._cursor + n > self.rows:
            self._evict_range(self._cursor, self.rows)
            self._cursor = 0
        base = self._cursor
        self._evict_range(base, base + n)
        return base

    def _evict_range(self, lo: int, hi: int) -> None:
        for key in [k for k, e in self._games.items()
                    if e["base"] < hi and e["base"] + e["n"] > lo]:
            del self._games[key]

    def retain(self, live_records: List) -> None:
        """Drop the bookkeeping of records the replay buffer evicted."""
        live = {id(r) for r in live_records}
        for key in [k for k in self._games if k not in live]:
            del self._games[key]

    def __contains__(self, record) -> bool:
        return id(record) in self._games

    def lookup(self, records: List, pos_ids: np.ndarray) -> Dict[str, np.ndarray]:
        """A batch's gather plan: window rows, masks and action-plane bytes.

        ``records[i]`` is lane i's sampled record, ``pos_ids[i]`` its
        position (0-based in the record's stored range)."""
        b = len(records)
        base = np.empty(b, np.int64)
        lead = np.empty(b, np.int64)
        entries = []
        for i, rec in enumerate(records):
            e = self._games.get(id(rec))
            if e is None:
                raise KeyError(
                    "a sampled record's frames were overwritten in the frame window: "
                    "the window is too small for the replay buffer (raise "
                    "learner_device_feature_window_gb or lower zero_replay_buffer)")
            entries.append(e)
            base[i] = e["base"]
            lead[i] = e["lead"]
        pos = np.asarray(pos_ids, np.int64)
        k = np.arange(HISTORY)
        rel = lead[:, None] + pos[:, None] - (HISTORY - 1) + k  # [B, 8]
        valid = rel >= 0
        idx = base[:, None] + np.maximum(rel, 0)
        # slot k's action plane: the action that led to slot k's frame
        arel = rel - 1
        aplane = np.zeros((b, HISTORY), np.uint8)
        for i, e in enumerate(entries):
            av = arel[i] >= 0
            aplane[i, av] = e["aplane_full"][arel[i][av]]
        return {"frame_idx": idx, "frame_valid": valid, "frame_aplane": aplane}

    def assemble(self, plan: Dict[str, np.ndarray]) -> torch.Tensor:
        """The stacks of a ``lookup`` plan, u8[B, H, W, 32] on the window's
        device."""
        keys = ("frame_idx", "frame_valid", "frame_aplane")
        if not self.on_device:
            return upload(assemble_features_host(self.frames, *(plan[k] for k in keys)),
                          self.device)
        return assemble_features(self.frames, *(upload(plan[k], self.device) for k in keys))

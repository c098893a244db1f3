"""Host-side trajectory collection (port of
``minizero_tpu/selfplay/collector.py``).

The engine advances B games in lock-step on the card; this collector
accumulates each slot's per-move data on the host and finalises
``GameRecord``s on game end — the role the reference's ActorGroup plays when
it emits ``SelfPlay ...`` lines on game completion
(``actor/actor_group.cpp:24-50``, ``handleSearchDone``
``actor_group.cpp:116-134``), including resign handling (the searched move is
NOT recorded on resignation).

``add_scan`` takes a ``move_scan`` chunk (``selfplay/engine.py``'s
``ScanMoves``, tensors on the card) and ``add_moves`` one ``MoveOutput``;
each moves its tensors to the host once, field by field as a whole, and
works on numpy from there. Numpy arrays are taken as they are.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch

from minizero_tpu_torch.learner.replay import GameRecord


@dataclass
class FinishedGame:
    record: GameRecord
    players: Tuple[int, ...]
    slot: int
    abs_start: int = 0  # episode position of the record's first move (Atari chunks)


def _host(x) -> np.ndarray:
    """A tensor (on any device) or an array as a host numpy array."""
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


class TrajectoryCollector:
    def __init__(self, cfg, env_spec, batch_size: int, seed: int = 0):
        self.cfg = cfg
        self.spec = env_spec
        self.batch = batch_size
        self.rng = np.random.RandomState(seed)
        self._slots: List[dict] = [self._new_slot() for _ in range(batch_size)]
        # hard cap so a buggy env can't wedge the loop
        self.max_moves = max(env_spec.max_game_length, 1) * 2
        # add_scan's chunk store: chunk id -> host arrays [M, B, ...], and
        # per slot the (chunk, start, end) segments of its running game
        self._chunks: Dict[int, dict] = {}
        self._next_cid = 0
        self._segs: List[list] = [[] for _ in range(batch_size)]

    def _new_slot(self) -> dict:
        # per-game resign enablement (reference zero_actor.cpp:23-27)
        enable_resign = self.rng.rand() >= self.cfg.zero_disable_resign_ratio
        return {
            "actions": [],
            "turns": [],
            "policy": [],
            "values": [],
            "rewards": [],
            "features": [],
            "enable_resign": enable_resign,
        }

    def add_moves(self, out) -> Tuple[List[FinishedGame], np.ndarray]:
        """Feed one batched ``MoveOutput``; returns finished games and the
        bool[B] mask of slots to reset."""
        action = _host(out.action)
        turn = _host(out.turn)
        policy = _host(out.policy_target)
        value = _host(out.root_value)
        reward = _host(out.reward)
        resign = _host(out.resign)
        features = _host(out.features)
        done = _host(out.done)
        eval_score = _host(out.eval_score)
        resign_score = _host(out.resign_score)

        finished: List[FinishedGame] = []
        reset_mask = np.zeros(self.batch, bool)
        for i in range(self.batch):
            slot = self._slots[i]
            if resign[i] and slot["enable_resign"] and len(slot["actions"]) > 0:
                # resignation: the searched move is not played/recorded
                # (reference actor_group.cpp:121-122)
                finished.append(self._finalize(i, float(resign_score[i])))
                reset_mask[i] = True
                continue
            slot["actions"].append(int(action[i]))
            slot["turns"].append(int(turn[i]))
            slot["policy"].append(policy[i].astype(np.float16))
            slot["values"].append(float(value[i]))
            slot["rewards"].append(float(reward[i]))
            slot["features"].append(features[i])
            if done[i] or len(slot["actions"]) >= self.max_moves:
                finished.append(self._finalize(i, float(eval_score[i])))
                reset_mask[i] = True
        return finished, reset_mask

    def enable_resign_flags(self) -> np.ndarray:
        """Initial per-slot resign enablement (seed for move_scan's
        on-device bookkeeping)."""
        return np.array([s["enable_resign"] for s in self._slots], bool)

    def add_scan(self, sm) -> List[FinishedGame]:
        """Consume a stacked ``ScanMoves`` chunk ([M, B, ...]). The finish
        decisions (``resigned``: finalize WITHOUT recording the move;
        ``ended``: record then finalize) were made on the device by
        ``move_scan`` — the collector replays them instead of re-deriving
        resign gating.

        The chunk arrays are stored WHOLE and each slot tracks (chunk, start,
        end) segments; a game's record materialises only at its finish event
        via numpy slices across its segments."""
        cid = self._next_cid
        self._next_cid += 1
        chunk = {
            "actions": _host(sm.action),
            "turns": _host(sm.turn),
            "policy": _host(sm.policy_target).astype(np.float16),
            "values": _host(sm.root_value),
            "rewards": _host(sm.reward),
            "features": _host(sm.features),
        }
        self._chunks[cid] = chunk
        eval_score = _host(sm.eval_score)
        resign_score = _host(sm.resign_score)
        resigned = _host(sm.resigned)
        ended = _host(sm.ended)
        n_moves = resigned.shape[0]

        finished: List[FinishedGame] = []
        start_m = np.zeros(self.batch, np.int64)
        # argwhere is (m-major) sorted, so per slot events arrive in order
        for m, i in np.argwhere(resigned | ended):
            segs = self._segs[i]
            if resigned[m, i]:
                if m > start_m[i]:
                    segs.append((cid, int(start_m[i]), int(m)))
                result = float(resign_score[m, i])
            else:
                segs.append((cid, int(start_m[i]), int(m) + 1))
                result = float(eval_score[m, i])
            finished.append(self._finalize_segments(int(i), segs, result))
            self._segs[i] = []
            start_m[i] = m + 1
        for i in range(self.batch):
            if start_m[i] < n_moves:
                self._segs[i].append((cid, int(start_m[i]), n_moves))
        # drop chunks no active segment references
        live = {s[0] for segs in self._segs for s in segs}
        for k in [k for k in self._chunks if k not in live and k != cid]:
            del self._chunks[k]
        return finished

    def _finalize_segments(self, slot_idx: int, segs: list,
                           result: float) -> FinishedGame:
        """Assemble a GameRecord from (chunk, start, end) column slices."""

        def cat(field, empty_shape, dtype):
            parts = [self._chunks[c][field][m0:m1, slot_idx]
                     for c, m0, m1 in segs]
            if not parts:
                return np.zeros(empty_shape, dtype)
            return np.concatenate(parts) if len(parts) > 1 else np.array(parts[0])

        a = self.spec.action_size
        # feature planes may be bit-packed (utils/bitpack.py): take the
        # stored chunk shape rather than the spec's logical channel count
        any_chunk = next(iter(self._chunks.values()))
        h, w, c = any_chunk["features"].shape[-3:]
        record = GameRecord(
            actions=cat("actions", (0,), np.int32).astype(np.int32),
            policy=cat("policy", (0, a), np.float16),
            values=cat("values", (0,), np.float32).astype(np.float32),
            rewards=cat("rewards", (0,), np.float32).astype(np.float32),
            features=cat("features", (0, h, w, c), np.uint8),
            result=result,
        )
        players = tuple(int(t) for t in cat("turns", (0,), np.int32))
        return FinishedGame(record=record, players=players, slot=slot_idx)

    def _finalize(self, slot_idx: int, result: float) -> FinishedGame:
        slot = self._slots[slot_idx]
        record = GameRecord(
            actions=np.asarray(slot["actions"], np.int32),
            policy=np.stack(slot["policy"]) if slot["policy"] else np.zeros((0, self.spec.action_size), np.float16),
            values=np.asarray(slot["values"], np.float32),
            rewards=np.asarray(slot["rewards"], np.float32),
            features=np.stack(slot["features"])
            if slot["features"]
            else np.zeros((0, self.spec.input_height, self.spec.input_width, self.spec.num_input_channels), np.uint8),
            result=result,
        )
        players = tuple(slot["turns"])
        self._slots[slot_idx] = self._new_slot()
        return FinishedGame(record=record, players=players, slot=slot_idx)

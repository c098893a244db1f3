"""Surakarta, batched over games (port of ``minizero_tpu/envs/surakarta.py``).

Reference: ``minizero/environment/surakarta/surakarta.{h,cpp}``. Policy =
N^4 ids (from * NN + dest, ``surakarta.h:70``): 1,296 at 6 x 6. A normal
move steps to an empty 8-neighbour (``surakarta.cpp:358-363``) and never
captures; a capture travels a circuit (red lines: rows and columns 2 and
n-3; green: 1 and n-2, ``:143-149``) through at least one arc, over empty
squares (its own start may be passed), onto an enemy piece (``runCircuit``).
A move may not recreate an earlier (position, player to move)
(``isCircularAction``; the hashes of ``envs/cycle.py``). The game ends after
``no_capture_plies`` plies without a capture, when a side has no pieces or
no legal move; the most pieces win.

Features: 18 planes = 8 x 2 history and 2 turn planes. No rotation.

Every walk (loop x entry x direction) is unrolled at construction into
``[W, L]`` visit-order tables, so the capture mask is a few gathers and one
scatter-max (several walks can reach the same move id).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch

from minizero_tpu_torch import resolve_device
from minizero_tpu_torch.envs import cycle
from minizero_tpu_torch.envs.base import Env, EnvSpec

_HISTORY = 8
_MARKER = (-1, -1)


def _trajectory(n: int, line: Tuple[int, int]):
    """The reference's circuit with its arc markers
    (surakarta.cpp createSingleTrajectory): points (x, y, 'h'/'v'), markers
    (-1, -1, None)."""
    lo, hi = line
    traj = [(i, lo, "h") for i in range(n)]
    traj.append(_MARKER + (None,))
    traj += [(hi, i, "v") for i in range(n)]
    traj.append(_MARKER + (None,))
    traj += [(i, hi, "h") for i in range(n - 1, -1, -1)]
    traj.append(_MARKER + (None,))
    traj += [(lo, i, "v") for i in range(n - 1, -1, -1)]
    traj.append(_MARKER + (None,))
    return traj


def _find_start(traj, x, y, d, same_dir):
    for idx, p in enumerate(traj):
        if (p[0], p[1]) == (x, y) and (not same_dir or p[2] == d):
            return idx
    return -1


def _walks_for_loop(n: int, line: Tuple[int, int]):
    """runCircuit's enumeration: for every from-square and each of its four
    directional entries into the loop, the board squares visited in order
    and whether an arc was crossed before each."""
    traj = _trajectory(n, line)
    length = len(traj)
    lo, hi = line
    cross = {(lo, lo), (lo, hi), (hi, lo), (hi, hi)}
    walks = []
    for y in range(n):
        for x in range(n):
            if x not in line and y not in line:
                continue
            # findNeighbors (surakarta.cpp:239-280)
            if (x, y) in cross:
                starts = [_find_start(traj, x, y + 1, "v", True),
                          _find_start(traj, x, y - 1, "v", True),
                          _find_start(traj, x + 1, y, "h", True),
                          _find_start(traj, x - 1, y, "h", True)]
            else:
                pt = _find_start(traj, x, y, None, False)
                starts = [-1, -1, -1, -1]
                if x in line:
                    starts[0] = starts[1] = pt
                if y in line:
                    starts[2] = starts[3] = pt
            for i, si in enumerate(starts):
                if si == -1:
                    continue
                stride = 1
                cx, cy = traj[si][0], traj[si][1]
                if (cx == lo and i == 0) or (cx == hi and i == 1):
                    stride = -1
                if (cy == lo and i == 3) or (cy == hi and i == 2):
                    stride = -1
                idx = si
                if (cx, cy) == (x, y):
                    idx += stride
                visited, arcs = [], []
                arc = False
                for _ in range(length - 1):
                    idx %= length
                    p = traj[idx]
                    if (p[0], p[1]) == _MARKER:
                        arc = True
                    else:
                        visited.append(p[1] * n + p[0])
                        arcs.append(arc)
                    idx += stride
                walks.append((y * n + x, visited, arcs))
    return walks


def walk_tables(n: int):
    """(walk_from i64[W], walk_pos i64[W, L] (-1 padded), walk_arc bool[W, L])
    over the red loop's walks, then the green loop's."""
    walks: List = _walks_for_loop(n, (2, n - 3)) + _walks_for_loop(n, (1, n - 2))
    length = max(len(v) for _, v, _ in walks)
    wf = np.zeros(len(walks), np.int64)
    wv = np.full((len(walks), length), -1, np.int64)
    wa = np.zeros((len(walks), length), bool)
    for w, (f, visited, arcs) in enumerate(walks):
        wf[w] = f
        wv[w, :len(visited)] = visited
        wa[w, :len(arcs)] = arcs
    return wf, wv, wa


@dataclass
class SurakartaState:
    """Batched Surakarta state; every field leads with the batch dimension."""

    board: torch.Tensor  # i8[B, NN]
    turn: torch.Tensor  # i8[B]
    num_moves: torch.Tensor  # i32[B]
    no_capture_plies: torch.Tensor  # i32[B]
    hash_a: torch.Tensor  # i32[B]
    hash_b: torch.Tensor  # i32[B]
    history_a: torch.Tensor  # i32[B, MAX+1]
    history_b: torch.Tensor  # i32[B, MAX+1]
    board_history: torch.Tensor  # i8[B, 8, NN]


class SurakartaEnv(Env):
    def __init__(self, board_size: int = 6, no_capture_plies: int = 50):
        n = board_size
        self.n, self.nn = n, n * n
        self.no_capture_limit = int(no_capture_plies)
        self.max_moves = 4 * self.nn  # the no-capture rule bounds games anyway
        self.spec = EnvSpec(
            name="surakarta",
            num_players=2,
            board_size=n,
            action_size=self.nn * self.nn,
            num_input_channels=18,
            input_height=n,
            input_width=n,
            hidden_height=n,
            hidden_width=n,
            max_game_length=self.max_moves,
        )
        wf, wv, wa = walk_tables(n)
        ids = np.arange(self.nn * self.nn)
        frm, dst = ids // self.nn, ids % self.nn
        is_nbr = ((np.abs(frm % n - dst % n) <= 1) & (np.abs(frm // n - dst // n) <= 1)
                  & (frm != dst))
        key_a, key_b, self._turn_key_a, self._turn_key_b = cycle.zobrist_keys(self.nn, 20260819)
        start = np.zeros(self.nn, np.int8)
        start[:2 * n] = 1
        start[(n - 2) * n:] = 2
        self._np = {"walk_from": wf, "walk_pos": wv, "walk_arc": wa, "is_nbr": is_nbr,
                    "from": frm, "dest": dst, "key_a": key_a, "key_b": key_b, "start": start}

    def num_rotations(self) -> int:
        return 1

    def _hashes(self, board, turn):
        tb = self._tables(board.device)
        return (cycle.board_hash(board, turn, tb["key_a"], self._turn_key_a),
                cycle.board_hash(board, turn, tb["key_b"], self._turn_key_b))

    def _capture_mask(self, board: torch.Tensor, turn: torch.Tensor) -> torch.Tensor:
        """bool[B, N^4]: circuit captures (reference runCircuit)."""
        tb = self._tables(board.device)
        v, s = tb["walk_pos"], tb["walk_from"]  # [W, L], [W]
        b, nn = board.shape[0], self.nn
        blocked = (board[:, v.clamp(min=0)] > 0) & (v >= 0) & (v != s[:, None])  # [B, W, L]
        has_block = blocked.any(-1)
        first = blocked.to(torch.uint8).argmax(-1)  # the first blocking entry
        target = v[torch.arange(v.shape[0], device=board.device)[None, :], first]  # [B, W]
        arc_ok = tb["walk_arc"][torch.arange(v.shape[0], device=board.device)[None, :], first]
        tc = target.clamp(min=0)
        valid = (has_block & arc_ok & (board.gather(1, tc) == (3 - turn)[:, None].to(board.dtype))
                 & (board[:, s] == turn[:, None]))
        mask = torch.zeros((b, nn * nn), dtype=torch.int32, device=board.device)
        mask = mask.scatter_reduce(1, s[None, :] * nn + tc, valid.to(torch.int32), reduce="amax")
        return mask > 0

    # -------------------------------------------------------------- protocol
    def init(self, batch_size: int, device=None) -> SurakartaState:
        dev = resolve_device(device)
        board = self._tables(dev)["start"].repeat(batch_size, 1)
        turn = torch.ones((batch_size,), dtype=torch.int8, device=dev)
        ha, hb = self._hashes(board, turn)
        history_a = torch.zeros((batch_size, self.max_moves + 1), dtype=torch.int32, device=dev)
        history_b = torch.zeros_like(history_a)
        history_a[:, 0], history_b[:, 0] = ha, hb
        board_history = torch.zeros((batch_size, _HISTORY, self.nn), dtype=torch.int8, device=dev)
        board_history[:, 0] = board
        zeros = torch.zeros((batch_size,), dtype=torch.int32, device=dev)
        return SurakartaState(board=board, turn=turn, num_moves=zeros, no_capture_plies=zeros,
                              hash_a=ha, hash_b=hb, history_a=history_a, history_b=history_b,
                              board_history=board_history)

    def legal_mask(self, state: SurakartaState) -> torch.Tensor:
        tb = self._tables(state.board.device)
        board, turn = state.board, state.turn
        frm, dest = tb["from"], tb["dest"]
        normal = tb["is_nbr"] & (board[:, frm] == turn[:, None]) & (board[:, dest] == 0)
        capture = self._capture_mask(board, turn)
        cand_a = cycle.move_hash(state.hash_a, turn, board, frm, dest, tb["key_a"],
                                 self._turn_key_a)
        cand_b = cycle.move_hash(state.hash_b, turn, board, frm, dest, tb["key_b"],
                                 self._turn_key_b)
        repeat = cycle.seen_before(state.history_a, state.history_b, state.num_moves,
                                   cand_a, cand_b)
        return (normal | capture) & ~repeat

    def step(self, state: SurakartaState, action: torch.Tensor) -> SurakartaState:
        tb = self._tables(state.board.device)
        a = action.long()
        rows = torch.arange(a.shape[0], device=a.device)
        frm, dst = tb["from"][a], tb["dest"][a]
        captured = state.board[rows, dst] == (3 - state.turn).to(state.board.dtype)
        board = state.board.clone()
        board[rows, frm] = 0
        board[rows, dst] = state.turn
        turn = (3 - state.turn).to(torch.int8)
        ha, hb = self._hashes(board, turn)
        num_moves = state.num_moves + 1
        slot = num_moves.long().clamp(0, self.max_moves)[:, None]
        return SurakartaState(
            board=board, turn=turn, num_moves=num_moves,
            no_capture_plies=torch.where(captured, 0, state.no_capture_plies + 1).to(torch.int32),
            hash_a=ha, hash_b=hb,
            history_a=state.history_a.scatter(1, slot, ha[:, None]),
            history_b=state.history_b.scatter(1, slot, hb[:, None]),
            board_history=torch.cat([board[:, None], state.board_history[:, :-1]], dim=1))

    def is_terminal(self, state: SurakartaState) -> torch.Tensor:
        wiped = ~(state.board == 1).any(-1) | ~(state.board == 2).any(-1)
        no_capture = state.no_capture_plies >= self.no_capture_limit
        stuck = ~self.legal_mask(state).any(-1)
        return wiped | no_capture | stuck | (state.num_moves >= self.max_moves)

    def eval_score(self, state: SurakartaState) -> torch.Tensor:
        """The most pieces win (surakarta.cpp eval)."""
        c1 = (state.board == 1).sum(-1)
        c2 = (state.board == 2).sum(-1)
        return torch.where(c1 > c2, 1.0, torch.where(c2 > c1, -1.0, 0.0)).to(torch.float32)

    def turn(self, state: SurakartaState) -> torch.Tensor:
        return state.turn

    def features(self, state: SurakartaState) -> torch.Tensor:
        """18 planes, ``[B, H, W, C]`` (surakarta.cpp getFeatures)."""
        n, nn = self.n, self.nn
        b = state.board.shape[0]
        turn = state.turn
        hist = state.board_history
        own_h = (hist == turn[:, None, None]).to(torch.float32)
        opp_h = (hist == (3 - turn)[:, None, None]).to(torch.float32)
        planes = torch.stack([own_h, opp_h], dim=2).reshape(b, 2 * _HISTORY, nn)
        p1 = (turn == 1).to(torch.float32)[:, None, None].expand(b, 1, nn)
        p2 = (turn == 2).to(torch.float32)[:, None, None].expand(b, 1, nn)
        feats = torch.cat([planes, p1, p2], dim=1)
        return feats.reshape(b, 18, n, n).permute(0, 2, 3, 1).contiguous()

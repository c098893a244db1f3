"""The Game of the Amazons, batched over games (port of
``minizero_tpu/envs/amazons.py``).

Reference: ``minizero/environment/amazons/amazons.{h,cpp}``. A turn is two
actions: move an amazon (a queen move over empty squares), then shoot an
arrow (a queen move from its landing square) that blocks a square for
good. Turns go P1 P1 P2 P2 (``amazons.h:51``), so the player to move comes
from the action count and repeats over two plies. Action ids follow the
reference's table (``amazons.cpp initialize()``): every (from, dir, len)
queen move in (square, dir, len) order, then NN arrow targets (3,040 at
10 x 10, ``amazons.h:70``). A player left without a legal action loses
(``amazons.cpp updateLegalAction``).

Features: 28 planes = 8 x 2 own / opponent amazon snapshots (every second
history entry, aligned to the move phases), 8 arrow snapshots (aligned to
the arrow phases) and 4 phase planes (``amazons.cpp getFeatures``). No
rotation.

Legality is two static 0/1 products: a move is legal where an own amazon
stands on its from-square and every square of its ray up to the dest is
empty (``[A_move, NN]`` paths against the occupied squares); the arrow mask
projects the clear moves from the last landing square onto their dests. A
step's ``is_terminal`` and ``eval_score`` share one legal mask: the env
keeps the last state's mask and reuses it for the same state.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from minizero_tpu_torch import resolve_device
from minizero_tpu_torch.envs.base import Env, EnvSpec

_HISTORY = 16  # action-level snapshots; the features take every second
# (dx, dy) in the reference's order, amazons.cpp initialize()
_DIRS = ((-1, -1), (0, -1), (1, -1), (-1, 0), (0, 0), (1, 0), (-1, 1), (0, 1), (1, 1))
_ARROW = 3  # the board value of an arrow


def move_table(n: int):
    """The queen-move table in the reference's id order: (from, dest)
    int64[A_move] and the ray cells of each move up to and with its dest,
    f32[A_move, NN]."""
    frm, dst, paths = [], [], []
    for y in range(n):
        for x in range(n):
            for dx, dy in _DIRS:
                if dx == 0 and dy == 0:
                    continue
                path = []
                xx, yy = x + dx, y + dy
                while 0 <= xx < n and 0 <= yy < n:
                    path.append(xx + n * yy)
                    frm.append(x + n * y)
                    dst.append(xx + n * yy)
                    row = np.zeros(n * n, np.float32)
                    row[path] = 1.0
                    paths.append(row)
                    xx += dx
                    yy += dy
    return np.asarray(frm, np.int64), np.asarray(dst, np.int64), np.stack(paths)


@dataclass
class AmazonsState:
    """Batched Amazons state; every field leads with the batch dimension."""

    board: torch.Tensor  # i8[B, NN]: 0 empty, 1/2 amazons, 3 arrow
    num_actions: torch.Tensor  # i32[B]
    last_dest: torch.Tensor  # i32[B]: landing square of the last amazon move
    board_history: torch.Tensor  # i8[B, 16, NN], [:, 0] = current


class AmazonsEnv(Env):
    def __init__(self, board_size: int = 8):
        assert 5 <= board_size <= 10
        n = board_size
        self.n, self.nn = n, n * n
        frm, dst, paths = move_table(n)
        self.num_moves_part = len(frm)
        self.spec = EnvSpec(
            name=f"amazons_{n}x{n}",
            num_players=2,
            board_size=n,
            action_size=self.num_moves_part + self.nn,
            num_input_channels=28,
            input_height=n,
            input_width=n,
            hidden_height=n,
            hidden_width=n,
            max_game_length=2 * self.nn,
        )
        dest_onehot = np.zeros((len(frm), self.nn), np.float32)
        dest_onehot[np.arange(len(frm)), dst] = 1.0
        interval = n // 3 - (1 if n % 3 == 0 else 0)
        start = np.zeros(self.nn, np.int8)
        for x, y in ((0, interval), (interval, 0), (n - 1 - interval, 0), (n - 1, interval)):
            start[x + n * y] = 1
        for x, y in ((0, n - 1 - interval), (interval, n - 1),
                     (n - 1 - interval, n - 1), (n - 1, n - 1 - interval)):
            start[x + n * y] = 2
        self._np = {"from": frm, "dest": dst, "path_t": np.ascontiguousarray(paths.T),
                    "dest_onehot": dest_onehot, "start": start}
        self._last_mask = None  # ((board, num_actions, last_dest), mask) of the last call

    def num_rotations(self) -> int:
        return 1  # composite move ids; the reference has no rotation here

    def init(self, batch_size: int, device=None) -> AmazonsState:
        dev = resolve_device(device)
        board = self._tables(dev)["start"].repeat(batch_size, 1)
        # the reference pushes the initial board twice (amazons.cpp reset)
        history = torch.zeros((batch_size, _HISTORY, self.nn), dtype=torch.int8, device=dev)
        history[:, 0] = board
        history[:, 1] = board
        return AmazonsState(
            board=board,
            num_actions=torch.zeros((batch_size,), dtype=torch.int32, device=dev),
            last_dest=torch.full((batch_size,), -1, dtype=torch.int32, device=dev),
            board_history=history)

    @staticmethod
    def _turn_of(num_actions: torch.Tensor) -> torch.Tensor:
        """P1 P1 P2 P2, repeating (amazons.h:51)."""
        return torch.where(num_actions % 4 < 2, 1, 2).to(torch.int8)

    def turn(self, state: AmazonsState) -> torch.Tensor:
        return self._turn_of(state.num_actions)

    def legal_mask(self, state: AmazonsState) -> torch.Tensor:
        key = (state.board, state.num_actions, state.last_dest)
        if self._last_mask is not None and all(x is y for x, y in zip(self._last_mask[0], key)):
            return self._last_mask[1]
        tb = self._tables(state.board.device)
        board = state.board
        turn = self._turn_of(state.num_actions)[:, None]
        blocked = ((board != 0).to(torch.float32) @ tb["path_t"]) > 0  # a non-empty ray cell
        move_phase = (state.num_actions % 2 == 0)[:, None]
        move_mask = (board[:, tb["from"]] == turn) & ~blocked & move_phase
        arrow_sel = ((tb["from"][None, :] == state.last_dest[:, None]) & ~blocked).to(torch.float32)
        arrow_mask = ((arrow_sel @ tb["dest_onehot"]) > 0) & ~move_phase
        mask = torch.cat([move_mask, arrow_mask], dim=1)
        self._last_mask = (key, mask)
        return mask

    def step(self, state: AmazonsState, action: torch.Tensor) -> AmazonsState:
        tb = self._tables(state.board.device)
        act = action.long()
        rows = torch.arange(act.shape[0], device=act.device)
        turn = self._turn_of(state.num_actions)
        is_arrow = act >= self.num_moves_part
        a = act.clamp(0, self.num_moves_part - 1)
        frm, dst = tb["from"][a], tb["dest"][a]
        moved = state.board.clone()
        moved[rows, frm] = 0
        moved[rows, dst] = turn
        shot = state.board.clone()
        shot[rows, (act - self.num_moves_part).clamp(0, self.nn - 1)] = _ARROW
        board = torch.where(is_arrow[:, None], shot, moved)
        return AmazonsState(
            board=board,
            num_actions=state.num_actions + 1,
            last_dest=torch.where(is_arrow, state.last_dest, dst.to(torch.int32)),
            board_history=torch.cat([board[:, None], state.board_history[:, :-1]], dim=1))

    def is_terminal(self, state: AmazonsState) -> torch.Tensor:
        return ~self.legal_mask(state).any(-1)

    def eval_score(self, state: AmazonsState) -> torch.Tensor:
        """The stuck player's opponent wins (amazons.cpp updateLegalAction);
        0 while the game runs."""
        stuck = ~self.legal_mask(state).any(-1)
        win = torch.where(self._turn_of(state.num_actions) == 1, -1.0, 1.0)
        return torch.where(stuck, win, 0.0).to(torch.float32)

    def features(self, state: AmazonsState) -> torch.Tensor:
        """28 planes, ``[B, H, W, C]`` (amazons.cpp getFeatures)."""
        n, nn = self.n, self.nn
        b = state.board.shape[0]
        dev = state.board.device
        turn = self._turn_of(state.num_actions)[:, None, None]
        hist = state.board_history  # [B, 16, NN]
        size = (state.num_actions + 2).long()[:, None]  # the reference's history length
        avail = size.clamp(max=16)
        k = torch.arange(8, device=dev)[None, :]
        rows = torch.arange(b, device=dev)[:, None]
        # amazon snapshots at (size - 1) % 2 + 2k, arrow snapshots at size % 2 + 2k
        idx_move = (size - 1) % 2 + 2 * k
        snaps = hist[rows, idx_move.clamp(max=_HISTORY - 1)]  # [B, 8, NN]
        valid_move = (idx_move < avail)[..., None]
        own = (snaps == turn) & valid_move
        other = (snaps == 3 - turn) & valid_move
        pairs = torch.stack([own, other], dim=2).reshape(b, 16, nn).to(torch.float32)
        idx_arrow = size % 2 + 2 * k
        snaps_a = hist[rows, idx_arrow.clamp(max=_HISTORY - 1)]
        arrows = ((snaps_a == _ARROW) & (idx_arrow < avail)[..., None]).to(torch.float32)
        phase = (state.num_actions % 4).long()[:, None]
        phase_planes = (torch.arange(4, device=dev)[None, :] == phase).to(torch.float32)
        phase_planes = phase_planes[:, :, None].expand(b, 4, nn)
        feats = torch.cat([pairs, arrows, phase_planes], dim=1)
        return feats.reshape(b, 28, n, n).permute(0, 2, 3, 1).contiguous()

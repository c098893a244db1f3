"""Breakthrough, batched over games (port of
``minizero_tpu/envs/breakthrough.py``).

Reference: ``minizero/environment/breakthrough/breakthrough.{h,cpp}``.
Pawns step one rank forward, straight or diagonally; only a diagonal step
captures. Reaching the far rank, or taking every enemy pawn, wins. The move
table repeats the reference's enumeration (``breakthrough.cpp
initialize()``): the moves of boards 5..8 are appended in that order, so a
board's action ids are a prefix of the table (policy sizes 104 / 160 / 228
/ 308 for n = 5..8).

Features: 20 planes = 8 x 2 history, own and opponent threat planes (pawns
with an enemy pawn a diagonal step ahead) and 2 turn planes
(``breakthrough.cpp getFeatures``). No rotation augmentation
(``breakthrough.h:70-71``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from minizero_tpu_torch import resolve_device
from minizero_tpu_torch.envs.base import Env, EnvSpec

_HISTORY = 8
_MAX_N = 8
_DIRS = ((-1, 1), (0, 1), (1, 1), (-1, -1), (0, -1), (1, -1))  # (dx, dy)


def move_table(board_size: int):
    """(from_x, from_y, dest_x, dest_y) i64 arrays in the reference's move-id
    order for ``board_size`` (smaller boards' moves first)."""
    seen, moves = set(), []
    for n in range(5, _MAX_N + 1):
        for y in range(n):
            for x in range(n):
                for ddx, ddy in _DIRS:
                    xx, yy = x + ddx, y + ddy
                    if 0 <= xx < n and 0 <= yy < n and (x, y, xx, yy) not in seen:
                        seen.add((x, y, xx, yy))
                        moves.append((x, y, xx, yy))
        if n == board_size:
            break
    return tuple(np.array(col, np.int64) for col in zip(*moves))


@dataclass
class BreakthroughState:
    """Batched Breakthrough state; every field leads with the batch
    dimension."""

    board: torch.Tensor  # i8[B, NN]
    turn: torch.Tensor  # i8[B]
    num_moves: torch.Tensor  # i32[B]
    board_history: torch.Tensor  # i8[B, 8, NN], [:, 0] = current


class BreakthroughEnv(Env):
    def __init__(self, board_size: int = 8):
        assert 5 <= board_size <= _MAX_N
        n = board_size
        self.n = n
        self.nn = n * n
        fx, fy, dx, dy = move_table(n)
        self.spec = EnvSpec(
            name=f"breakthrough_{n}x{n}",
            num_players=2,
            board_size=n,
            action_size=len(fx),
            num_input_channels=20,
            input_height=n,
            input_width=n,
            hidden_height=n,
            hidden_width=n,
            max_game_length=4 * self.nn,
        )
        rows = np.arange(self.nn) // n
        start = np.zeros(self.nn, np.int8)
        start[rows <= 1] = 1
        start[rows >= n - 2] = 2
        self._np = {"from": fx + n * fy, "dest": dx + n * dy, "straight": fx == dx,
                    "dy": dy - fy, "start": start}

    def num_rotations(self) -> int:
        return 1  # the reference disables rotation (breakthrough.h:70-71)

    def init(self, batch_size: int, device=None) -> BreakthroughState:
        dev = resolve_device(device)
        board = self._tables(dev)["start"].repeat(batch_size, 1)
        history = torch.zeros((batch_size, _HISTORY, self.nn), dtype=torch.int8, device=dev)
        history[:, 0] = board
        return BreakthroughState(
            board=board,
            turn=torch.ones((batch_size,), dtype=torch.int8, device=dev),
            num_moves=torch.zeros((batch_size,), dtype=torch.int32, device=dev),
            board_history=history,
        )

    def step(self, state: BreakthroughState, action: torch.Tensor) -> BreakthroughState:
        tb = self._tables(state.board.device)
        a = action.long()
        rows = torch.arange(a.shape[0], device=a.device)
        board = state.board.clone()
        board[rows, tb["from"][a]] = 0
        board[rows, tb["dest"][a]] = state.turn
        return BreakthroughState(
            board=board,
            turn=(3 - state.turn).to(torch.int8),
            num_moves=state.num_moves + 1,
            board_history=torch.cat([board[:, None], state.board_history[:, :-1]], dim=1),
        )

    def legal_mask(self, state: BreakthroughState) -> torch.Tensor:
        """An own pawn stepping one rank toward the opponent onto a cell
        without an own pawn; a straight step does not capture."""
        tb = self._tables(state.board.device)
        turn = state.turn[:, None]
        own = state.board[:, tb["from"]] == turn
        forward = tb["dy"][None, :] == torch.where(turn == 1, 1, -1)
        dest = state.board[:, tb["dest"]]
        return own & forward & (dest != turn) & ~(tb["straight"][None, :] & (dest != 0))

    def _winner(self, state: BreakthroughState) -> torch.Tensor:
        n = self.n
        board = state.board
        p1_gone = ~(board == 1).any(1)
        p2_gone = ~(board == 2).any(1)
        p1_home = (board[:, (n - 1) * n:] == 1).any(1)
        p2_home = (board[:, :n] == 2).any(1)
        w = torch.where(p1_gone, 2, torch.where(p2_gone, 1, 0))
        return torch.where(p1_home, 1, torch.where(p2_home, 2, w)).to(torch.int8)

    def is_terminal(self, state: BreakthroughState) -> torch.Tensor:
        return self._winner(state) != 0

    def eval_score(self, state: BreakthroughState) -> torch.Tensor:
        w = self._winner(state)
        return torch.where(w == 1, 1.0, torch.where(w == 2, -1.0, 0.0)).to(torch.float32)

    def turn(self, state: BreakthroughState) -> torch.Tensor:
        return state.turn

    def _threat_plane(self, board: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
        """f32[B, NN]: pawns of ``p`` (i8[B]) with an opponent pawn a
        diagonal step ahead."""
        n = self.n
        b2 = board.reshape(-1, n, n)
        own = b2 == p[:, None, None]
        pad = F.pad((b2 == (3 - p)[:, None, None]).to(torch.int32), (1, 1, 1, 1))
        up = torch.where(p == 1, 1, -1).long()                        # [B]
        r = torch.arange(n, device=board.device)
        ahead = pad[torch.arange(b2.shape[0], device=board.device)[:, None], r[None, :] + up[:, None] + 1]
        threat = own & ((ahead[:, :, :-2] + ahead[:, :, 2:]) > 0)
        return threat.to(torch.float32).reshape(-1, n * n)

    def features(self, state: BreakthroughState) -> torch.Tensor:
        """20 planes, ``[B, H, W, C]`` (breakthrough.cpp getFeatures)."""
        n, nn = self.n, self.nn
        b = state.board.shape[0]
        turn = state.turn
        opp = (3 - turn).to(torch.int8)
        hist = state.board_history
        own_h = (hist == turn[:, None, None]).to(torch.float32)
        opp_h = (hist == opp[:, None, None]).to(torch.float32)
        planes = torch.stack([own_h, opp_h], dim=2).reshape(b, 2 * _HISTORY, nn)
        p1 = (turn == 1).to(torch.float32)[:, None, None].expand(b, 1, nn)
        p2 = (turn == 2).to(torch.float32)[:, None, None].expand(b, 1, nn)
        feats = torch.cat([planes, self._threat_plane(state.board, turn)[:, None],
                           self._threat_plane(state.board, opp)[:, None], p1, p2], dim=1)
        return feats.reshape(b, 20, n, n).permute(0, 2, 3, 1).contiguous()

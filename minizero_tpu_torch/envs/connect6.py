"""Connect6, batched over games (port of ``minizero_tpu/envs/connect6.py``).

Reference: ``minizero/environment/connect6/connect6.{h,cpp}``. Black places
one stone on move 0, then each player places two (``connect6.h:24``): the
player to move follows from the stone count. Six or more in a row through
the last stone wins (``connect6.cpp:217-225``); a full board ends the game
too (``connect6.cpp:65-69``).

Features: 24 planes = 8 x 2 history, 4 threat-space planes (the empty cells
of 6-cell windows that hold exactly 5 or 4 stones of one side and none of
the other, for the mover and the opponent) and 4 turn / stones-left planes
(``connect6.cpp:131-178``). Window membership is a static [W, 6] index
table, so a threat plane is one gather, two counts and one scatter.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from minizero_tpu_torch import resolve_device
from minizero_tpu_torch.envs.base import Env, EnvSpec

_HISTORY = 8
_WIN = 6


def window_table(n: int) -> np.ndarray:
    """i64[W, 6]: every 6-cell window in the 4 directions (JAX
    ``_window_tables``' order)."""
    wins = []
    for dr, dc in ((0, 1), (1, 0), (1, 1), (1, -1)):
        for r in range(n):
            for c in range(n):
                rr, cc = r + (_WIN - 1) * dr, c + (_WIN - 1) * dc
                if 0 <= rr < n and 0 <= cc < n:
                    wins.append([(r + i * dr) * n + (c + i * dc) for i in range(_WIN)])
    return np.asarray(wins, np.int64)


@dataclass
class Connect6State:
    """Batched Connect6 state; every field leads with the batch dimension."""

    board: torch.Tensor  # i8[B, NN]
    turn: torch.Tensor  # i8[B]
    num_moves: torch.Tensor  # i32[B]
    winner: torch.Tensor  # i8[B]
    board_history: torch.Tensor  # i8[B, 8, NN], [:, 0] = current


class Connect6Env(Env):
    def __init__(self, board_size: int = 19):
        n = board_size
        self.n = n
        self.nn = n * n
        self.spec = EnvSpec(
            name="connect6",
            num_players=2,
            board_size=n,
            action_size=self.nn,
            num_input_channels=24,
            input_height=n,
            input_width=n,
            hidden_height=n,
            hidden_width=n,
            max_game_length=self.nn,
        )
        self._np = {"win": window_table(n)}

    @staticmethod
    def _turn_for(num_moves: torch.Tensor) -> torch.Tensor:
        """Player to move after ``num_moves`` stones: B, W, W, B, B, ..."""
        return (1 + ((num_moves + 1) // 2) % 2).to(torch.int8)

    def init(self, batch_size: int, device=None) -> Connect6State:
        dev = resolve_device(device)
        return Connect6State(
            board=torch.zeros((batch_size, self.nn), dtype=torch.int8, device=dev),
            turn=torch.ones((batch_size,), dtype=torch.int8, device=dev),
            num_moves=torch.zeros((batch_size,), dtype=torch.int32, device=dev),
            winner=torch.zeros((batch_size,), dtype=torch.int8, device=dev),
            board_history=torch.zeros((batch_size, _HISTORY, self.nn), dtype=torch.int8,
                                      device=dev),
        )

    def step(self, state: Connect6State, action: torch.Tensor) -> Connect6State:
        win_idx = self._tables(state.board.device)["win"]
        rows = torch.arange(action.shape[0], device=action.device)
        p = state.turn
        board = state.board.clone()
        board[rows, action.long()] = p
        win = (board[:, win_idx] == p[:, None, None]).all(2).any(1)
        winner = torch.where(state.winner != 0, state.winner, torch.where(win, p, 0))
        num_moves = state.num_moves + 1
        return Connect6State(
            board=board,
            turn=self._turn_for(num_moves),
            num_moves=num_moves,
            winner=winner.to(torch.int8),
            board_history=torch.cat([board[:, None], state.board_history[:, :-1]], dim=1),
        )

    def legal_mask(self, state: Connect6State) -> torch.Tensor:
        return state.board == 0

    def is_terminal(self, state: Connect6State) -> torch.Tensor:
        return (state.winner != 0) | (state.num_moves >= self.nn)

    def eval_score(self, state: Connect6State) -> torch.Tensor:
        w = state.winner
        return torch.where(w == 1, 1.0, torch.where(w == 2, -1.0, 0.0)).to(torch.float32)

    def turn(self, state: Connect6State) -> torch.Tensor:
        return state.turn

    def _threat_space(self, board: torch.Tensor, p: torch.Tensor, target: int) -> torch.Tensor:
        """f32[B, NN]: empty cells of windows holding exactly ``target``
        stones of ``p`` (i8[B]) and none of the opponent
        (connect6.cpp:81-124)."""
        win_idx = self._tables(board.device)["win"]
        cells = board[:, win_idx]                                   # [B, W, 6]
        own = (cells == p[:, None, None]).sum(2)
        opp = (cells == (3 - p)[:, None, None]).sum(2)
        sel = ((own == target) & (opp == 0)).to(torch.int32)        # [B, W]
        covered = torch.zeros(board.shape, dtype=torch.int32, device=board.device)
        covered.scatter_add_(1, win_idx.reshape(1, -1).expand(board.shape[0], -1),
                             sel[:, :, None].expand(-1, -1, _WIN).reshape(board.shape[0], -1))
        return ((covered > 0) & (board == 0)).to(torch.float32)

    def features(self, state: Connect6State) -> torch.Tensor:
        """24 planes, ``[B, H, W, C]`` (connect6.cpp:131-178)."""
        n, nn = self.n, self.nn
        b = state.board.shape[0]
        turn = state.turn
        opp = (3 - turn).to(torch.int8)
        hist = state.board_history
        own_h = (hist == turn[:, None, None]).to(torch.float32)
        opp_h = (hist == opp[:, None, None]).to(torch.float32)
        planes = torch.stack([own_h, opp_h], dim=2).reshape(b, 2 * _HISTORY, nn)
        threat = torch.stack([
            self._threat_space(state.board, turn, 5), self._threat_space(state.board, turn, 4),
            self._threat_space(state.board, opp, 5), self._threat_space(state.board, opp, 4)], 1)
        turn_idx = 2 * (turn == 2).to(torch.int64) + (state.num_moves.long() + 1) % 2
        turn_planes = (torch.arange(4, device=turn.device)[None, :] == turn_idx[:, None]).to(
            torch.float32)[:, :, None].expand(-1, -1, nn)
        feats = torch.cat([planes, threat, turn_planes], dim=1)
        return feats.reshape(b, 24, n, n).permute(0, 2, 3, 1).contiguous()

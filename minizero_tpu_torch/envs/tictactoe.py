"""TicTacToe, batched over games (port of ``minizero_tpu/envs/tictactoe.py``;
reference ``minizero/environment/tictactoe/tictactoe.{h,cpp}``).

The reference's simplest env: the zero loop's CPU tests play it, since its
games finish in at most 9 moves.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from minizero_tpu_torch import resolve_device
from minizero_tpu_torch.envs.base import Env, EnvSpec

# All 8 winning lines as position-index triples.
_LINES = ((0, 1, 2), (3, 4, 5), (6, 7, 8), (0, 3, 6), (1, 4, 7), (2, 5, 8), (0, 4, 8), (2, 4, 6))


@dataclass
class TicTacToeState:
    board: torch.Tensor  # i8[B, 9]: 0 empty, 1 O (player1), 2 X (player2)
    turn: torch.Tensor  # i8[B]: 1 or 2
    num_moves: torch.Tensor  # i32[B]


class TicTacToeEnv(Env):
    spec = EnvSpec(
        name="tictactoe",
        num_players=2,
        board_size=3,
        action_size=9,
        num_input_channels=4,
        input_height=3,
        input_width=3,
        hidden_height=3,
        hidden_width=3,
        max_game_length=9,
    )

    def __init__(self):
        self._lines_by_device = {}  # the winning lines, uploaded once per device

    def init(self, batch_size: int, device=None) -> TicTacToeState:
        dev = resolve_device(device)
        return TicTacToeState(
            board=torch.zeros((batch_size, 9), dtype=torch.int8, device=dev),
            turn=torch.ones((batch_size,), dtype=torch.int8, device=dev),
            num_moves=torch.zeros((batch_size,), dtype=torch.int32, device=dev),
        )

    def step(self, state: TicTacToeState, action: torch.Tensor) -> TicTacToeState:
        # reference tictactoe.cpp:20-27
        board = state.board.clone()
        board.scatter_(1, action.long().clamp(0, 8)[:, None], state.turn[:, None])
        return TicTacToeState(board=board, turn=(3 - state.turn).to(torch.int8),
                              num_moves=state.num_moves + 1)

    def legal_mask(self, state: TicTacToeState) -> torch.Tensor:
        return state.board == 0

    def _winner(self, state: TicTacToeState) -> torch.Tensor:
        """i8[B]: 0 none, 1 player1, 2 player2 (reference ``eval()``,
        tictactoe.cpp:118-144)."""
        key = str(state.board.device)
        if key not in self._lines_by_device:
            self._lines_by_device[key] = torch.tensor(_LINES, device=state.board.device)
        lines = state.board[:, self._lines_by_device[key]]  # [B, 8, 3]
        win = (lines[..., 0] == lines[..., 1]) & (lines[..., 1] == lines[..., 2]) & (lines[..., 0] != 0)
        return torch.where(win, lines[..., 0], torch.zeros_like(lines[..., 0])).amax(-1)

    def is_terminal(self, state: TicTacToeState) -> torch.Tensor:
        return (self._winner(state) != 0) | (state.board != 0).all(-1)

    def eval_score(self, state: TicTacToeState) -> torch.Tensor:
        w = self._winner(state)
        return torch.where(w == 1, 1.0, torch.where(w == 2, -1.0, 0.0)).to(torch.float32)

    def turn(self, state: TicTacToeState) -> torch.Tensor:
        return state.turn

    def features(self, state: TicTacToeState) -> torch.Tensor:
        """f32[B, 3, 3, 4]: own stones, opponent stones, P1-turn, P2-turn
        (reference tictactoe.cpp:71-97), NHWC."""
        turn = state.turn[:, None]
        own = (state.board == turn).to(torch.float32)
        opp = (state.board == (3 - turn)).to(torch.float32)
        p1 = (turn == 1).to(torch.float32).expand(-1, 9)
        p2 = (turn == 2).to(torch.float32).expand(-1, 9)
        return torch.stack([own, opp, p1, p2], dim=-1).reshape(-1, 3, 3, 4)

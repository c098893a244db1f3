"""Clobber, batched over games (port of ``minizero_tpu/envs/clobber.py``).

Reference: ``minizero/environment/clobber/clobber.{h,cpp}``. A piece captures
an orthogonally adjacent opponent piece by moving onto it; the player without
a move loses.

Action id = ``dir * N*N + from_pos`` with dir 0 = up (+row), 1 = down,
2 = left, 3 = right (``clobber.cpp:53-84``): 400 actions on the default
10x10 board. Legal iff the from-square holds the mover's piece and the
destination (inside the board) holds an opponent piece
(``clobber.cpp:184-203``), the whole mask from two table gathers. Terminal
when the mover has no move; the opponent then wins
(``clobber.cpp:205-217, 288-292``). Features: 18 planes = 8 x 2 history + 2
turn planes (``clobber.cpp:219-248``); no rotation augmentation
(``clobber.h:77-78``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from minizero_tpu_torch import resolve_device
from minizero_tpu_torch.envs.base import Env, EnvSpec

_HISTORY = 8


@dataclass
class ClobberState:
    """Batched Clobber state; every field leads with the batch dimension."""

    board: torch.Tensor  # i8[B, NN]
    turn: torch.Tensor  # i8[B]
    num_moves: torch.Tensor  # i32[B]
    board_history: torch.Tensor  # i8[B, 8, NN], [:, 0] = current


class ClobberEnv(Env):
    def __init__(self, board_size: int = 10):
        n = board_size
        self.n = n
        self.nn = n * n
        self.spec = EnvSpec(
            name="clobber",
            num_players=2,
            board_size=n,
            action_size=4 * self.nn,
            num_input_channels=18,
            input_height=n,
            input_width=n,
            hidden_height=n,
            hidden_width=n,
            max_game_length=self.nn,
        )
        # destination per action, -1 off the board (clobber.cpp:53-84)
        dest = np.full((4, self.nn), -1, np.int64)
        for pos in range(self.nn):
            r, c = divmod(pos, n)
            for d, (dr, dc) in enumerate(((1, 0), (-1, 0), (0, -1), (0, 1))):
                rr, cc = r + dr, c + dc
                if 0 <= rr < n and 0 <= cc < n:
                    dest[d, pos] = rr * n + cc
        rows, cols = np.divmod(np.arange(self.nn), n)
        self._np = {
            "dest": dest.reshape(-1),
            "from": np.tile(np.arange(self.nn, dtype=np.int64), 4),
            # even row -> player 1 on the odd columns, odd row -> on the even ones
            "start": np.where((rows + cols) % 2 == 1, 1, 2).astype(np.int8),
        }

    def num_rotations(self) -> int:
        return 1  # the reference disables rotation for clobber (clobber.h:77-78)

    def init(self, batch_size: int, device=None) -> ClobberState:
        dev = resolve_device(device)
        board = self._tables(dev)["start"].repeat(batch_size, 1)
        history = torch.zeros((batch_size, _HISTORY, self.nn), dtype=torch.int8, device=dev)
        history[:, 0] = board
        return ClobberState(
            board=board,
            turn=torch.ones((batch_size,), dtype=torch.int8, device=dev),
            num_moves=torch.zeros((batch_size,), dtype=torch.int32, device=dev),
            board_history=history,
        )

    def step(self, state: ClobberState, action: torch.Tensor) -> ClobberState:
        tb = self._tables(state.board.device)
        action = action.long()
        rows = torch.arange(action.shape[0], device=action.device)
        board = state.board.clone()
        board[rows, tb["from"][action]] = 0
        board[rows, tb["dest"][action].clamp(min=0)] = state.turn
        return ClobberState(
            board=board,
            turn=(3 - state.turn).to(torch.int8),
            num_moves=state.num_moves + 1,
            board_history=torch.cat([board[:, None], state.board_history[:, :-1]], dim=1),
        )

    def legal_mask(self, state: ClobberState) -> torch.Tensor:
        tb = self._tables(state.board.device)
        own = state.board[:, tb["from"]] == state.turn[:, None]
        dest_opp = state.board[:, tb["dest"].clamp(min=0)] == (3 - state.turn)[:, None]
        return own & (tb["dest"] >= 0) & dest_opp

    def is_terminal(self, state: ClobberState) -> torch.Tensor:
        return ~self.legal_mask(state).any(1)

    def eval_score(self, state: ClobberState) -> torch.Tensor:
        """The stuck player's opponent wins (clobber.cpp:288-292); 0 while
        the game is not over."""
        stuck = ~self.legal_mask(state).any(1)
        win = torch.where(state.turn == 1, -1.0, 1.0)
        return torch.where(stuck, win, 0.0).to(torch.float32)

    def turn(self, state: ClobberState) -> torch.Tensor:
        return state.turn

    def features(self, state: ClobberState) -> torch.Tensor:
        """18 planes, ``[B, H, W, C]`` (clobber.cpp:219-248)."""
        n, nn = self.n, self.nn
        b = state.board.shape[0]
        turn = state.turn[:, None, None]
        hist = state.board_history
        own = (hist == turn).to(torch.float32)
        opp = (hist == 3 - turn).to(torch.float32)
        planes = torch.stack([own, opp], dim=2).reshape(b, 2 * _HISTORY, nn)
        p1 = (turn == 1).to(torch.float32).expand(b, 1, nn)
        p2 = (turn == 2).to(torch.float32).expand(b, 1, nn)
        feats = torch.cat([planes, p1, p2], dim=1)
        return feats.reshape(b, 18, n, n).permute(0, 2, 3, 1).contiguous()

"""Othello, batched over games (port of ``minizero_tpu/envs/othello.py``).

Reference: ``minizero/environment/othello/othello.{h,cpp}``. The reference
walks rays per direction on bitsets (``othello.cpp:109-148``,
``getCanPutPoint`` / ``getFlipPoint``); here the same ray algebra runs on
``[B, N, N]`` bool planes with zero-filled shifts, unrolled over the 8
directions.

Semantics: pass is legal only when the mover has no placing move
(``othello.cpp:195-201``), terminal = two consecutive passes
(``othello.cpp:203-209``), eval = the sign of the stone count difference once
neither side can place (``othello.cpp:211-236``). Features: own / opponent /
turn planes (4 channels).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from minizero_tpu_torch import resolve_device
from minizero_tpu_torch.envs.base import Env, EnvSpec

_DIRS = ((0, 1), (0, -1), (1, 0), (-1, 0), (1, 1), (1, -1), (-1, 1), (-1, -1))


@dataclass
class OthelloState:
    """Batched Othello state; every field leads with the batch dimension."""

    board: torch.Tensor  # i8[B, NN] 0/1/2
    turn: torch.Tensor  # i8[B]
    num_moves: torch.Tensor  # i32[B]
    consecutive_pass: torch.Tensor  # i8[B]
    legal_own: torch.Tensor  # bool[B, NN]: placing moves for `turn`
    legal_opp: torch.Tensor  # bool[B, NN]: placing moves for the other player


def shift(x: torch.Tensor, dr: int, dc: int) -> torch.Tensor:
    """Shift ``[..., N, N]`` planes by (dr, dc), zero-filling (no wrap):
    ``out[r, c] = x[r - dr, c - dc]``."""
    n_r, n_c = x.shape[-2], x.shape[-1]
    out = torch.zeros_like(x)
    out[..., max(dr, 0):n_r + min(dr, 0), max(dc, 0):n_c + min(dc, 0)] = \
        x[..., max(-dr, 0):n_r + min(-dr, 0), max(-dc, 0):n_c + min(-dc, 0)]
    return out


class OthelloEnv(Env):
    def __init__(self, board_size: int = 8):
        self.n = board_size
        self.nn = board_size * board_size
        self.spec = EnvSpec(
            name=f"othello_{board_size}x{board_size}",
            num_players=2,
            board_size=board_size,
            action_size=self.nn + 1,
            num_input_channels=4,
            input_height=board_size,
            input_width=board_size,
            hidden_height=board_size,
            hidden_width=board_size,
            max_game_length=2 * self.nn,
            has_pass=True,
        )

    def _legal_plane(self, own: torch.Tensor, opp: torch.Tensor) -> torch.Tensor:
        """bool[B, N, N] placing moves for the player holding ``own`` stones
        (reference getCanPutPoint, othello.cpp:46-66)."""
        empty = ~(own | opp)
        legal = torch.zeros_like(own)
        for dr, dc in _DIRS:
            t = opp & shift(own, dr, dc)
            for _ in range(self.n - 2):
                t = t | (opp & shift(t, dr, dc))
            legal = legal | (empty & shift(t, dr, dc))
        return legal

    def _flips(self, placed: torch.Tensor, own: torch.Tensor, opp: torch.Tensor) -> torch.Tensor:
        """bool[B, N, N] opponent stones flipped by ``placed`` (reference
        getFlipPoint, othello.cpp:68-89)."""
        flip = torch.zeros_like(own)
        for dr, dc in _DIRS:
            x = opp & shift(placed, dr, dc)
            for _ in range(self.n - 2):
                x = x | (opp & shift(x, dr, dc))
            closed = (own & shift(x, dr, dc)).flatten(1).any(1)[:, None, None]
            flip = flip | (x & closed)
        return flip

    def _planes(self, board: torch.Tensor, colour: torch.Tensor) -> torch.Tensor:
        return (board == colour[:, None]).reshape(-1, self.n, self.n)

    def init(self, batch_size: int, device=None) -> OthelloState:
        n, nn = self.n, self.nn
        dev = resolve_device(device)
        start = np.zeros((nn,), np.int8)
        h = n // 2
        start[(h - 1) * n + (h - 1)] = 2  # white
        start[h * n + h] = 2
        start[(h - 1) * n + h] = 1  # black
        start[h * n + (h - 1)] = 1
        board = torch.as_tensor(start, device=dev).repeat(batch_size, 1)
        own = (board == 1).reshape(-1, n, n)
        opp = (board == 2).reshape(-1, n, n)
        return OthelloState(
            board=board,
            turn=torch.ones((batch_size,), dtype=torch.int8, device=dev),
            num_moves=torch.zeros((batch_size,), dtype=torch.int32, device=dev),
            consecutive_pass=torch.zeros((batch_size,), dtype=torch.int8, device=dev),
            legal_own=self._legal_plane(own, opp).reshape(-1, nn),
            legal_opp=self._legal_plane(opp, own).reshape(-1, nn),
        )

    def step(self, state: OthelloState, action: torch.Tensor) -> OthelloState:
        n, nn = self.n, self.nn
        action = action.long()
        is_pass = action >= nn
        pos = action.clamp(0, nn - 1)
        turn = state.turn
        opp_colour = (3 - turn).to(state.board.dtype)
        own = self._planes(state.board, turn)
        opp = self._planes(state.board, opp_colour)
        cells = torch.arange(nn, device=action.device)
        placed = ((cells[None, :] == pos[:, None]) & ~is_pass[:, None]).reshape(-1, n, n)
        flips = self._flips(placed, own, opp)
        new_own = (own | placed | flips).reshape(-1, nn)
        new_opp = (opp & ~flips).reshape(-1, nn)
        board = torch.where(new_own, turn[:, None],
                            torch.where(new_opp, opp_colour[:, None], torch.zeros_like(state.board)))
        board = torch.where(is_pass[:, None], state.board, board)
        b_own = self._planes(board, opp_colour)  # the next player's stones
        b_opp = self._planes(board, turn)
        return OthelloState(
            board=board,
            turn=opp_colour,
            num_moves=state.num_moves + 1,
            consecutive_pass=torch.where(is_pass, state.consecutive_pass + 1,
                                         torch.zeros_like(state.consecutive_pass)),
            legal_own=self._legal_plane(b_own, b_opp).reshape(-1, nn),
            legal_opp=self._legal_plane(b_opp, b_own).reshape(-1, nn),
        )

    def legal_mask(self, state: OthelloState) -> torch.Tensor:
        has_move = state.legal_own.any(1)
        return torch.cat([state.legal_own, (~has_move)[:, None]], dim=1)

    def is_terminal(self, state: OthelloState) -> torch.Tensor:
        return state.consecutive_pass >= 2

    def eval_score(self, state: OthelloState) -> torch.Tensor:
        black = (state.board == 1).sum(1)
        white = (state.board == 2).sum(1)
        neither_moves = ~(state.legal_own.any(1) | state.legal_opp.any(1))
        one = torch.ones(black.shape, dtype=torch.float32, device=black.device)
        score = torch.where(black > white, one, torch.where(black < white, -one, 0.0 * one))
        return torch.where(neither_moves, score, 0.0 * one)

    def turn(self, state: OthelloState) -> torch.Tensor:
        return state.turn

    def features(self, state: OthelloState) -> torch.Tensor:
        """4 planes: own, opponent, P1-turn, P2-turn (reference
        othello.cpp:238-263), ``[B, H, W, C]``."""
        return turn_planes(state.board, state.turn, self.n)


def turn_planes(board: torch.Tensor, turn: torch.Tensor, n: int) -> torch.Tensor:
    """The 4-plane features of the stone games (own, opponent, P1-turn,
    P2-turn), ``[B, n, n, 4]`` float32, from ``board`` i8[B, n*n]."""
    t = turn[:, None]
    own = (board == t).to(torch.float32)
    opp = (board == (3 - t)).to(torch.float32)
    p1 = (t == 1).to(torch.float32).expand_as(own)
    p2 = (t == 2).to(torch.float32).expand_as(own)
    return torch.stack([own, opp, p1, p2], dim=-1).reshape(-1, n, n, 4)

"""Gomoku and Outer-Open Gomoku, batched over games (port of
``minizero_tpu/envs/gomoku.py``).

Reference: ``minizero/environment/gomoku/gomoku.{h,cpp}``. 4 feature planes
(own / opponent / turn), policy = N*N (225 on the default 15x15), win = five
in a row (exactly five when ``exactly_five``: an overline does not win,
``gomoku.cpp:140-163``), draw on a full board. The winner is derived from
the last move by directional run lengths and kept in the state.
``outer_open`` restricts Black's first move to the outer two rings
(``gomoku.cpp:53-56``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from minizero_tpu_torch import resolve_device
from minizero_tpu_torch.envs.base import Env, EnvSpec
from minizero_tpu_torch.envs.othello import turn_planes


@dataclass
class GomokuState:
    """Batched Gomoku state; every field leads with the batch dimension."""

    board: torch.Tensor  # i8[B, NN]
    turn: torch.Tensor  # i8[B]
    num_moves: torch.Tensor  # i32[B]
    winner: torch.Tensor  # i8[B] 0/1/2


class GomokuEnv(Env):
    def __init__(self, board_size: int = 15, exactly_five: bool = True, rule: str = "standard"):
        self.n = board_size
        self.nn = board_size * board_size
        self.exactly_five = exactly_five
        self.rule = rule
        self.spec = EnvSpec(
            name="gomoku" if rule == "standard" else "outer_open_gomoku",
            num_players=2,
            board_size=board_size,
            action_size=self.nn,
            num_input_channels=4,
            input_height=board_size,
            input_width=board_size,
            hidden_height=board_size,
            hidden_width=board_size,
            max_game_length=self.nn,
        )
        outer = np.zeros((board_size, board_size), bool)
        outer[:2, :] = outer[-2:, :] = True
        outer[:, :2] = outer[:, -2:] = True
        self._np_outer = outer.reshape(-1)
        self._outer = {}

    def init(self, batch_size: int, device=None) -> GomokuState:
        dev = resolve_device(device)
        return GomokuState(
            board=torch.zeros((batch_size, self.nn), dtype=torch.int8, device=dev),
            turn=torch.ones((batch_size,), dtype=torch.int8, device=dev),
            num_moves=torch.zeros((batch_size,), dtype=torch.int32, device=dev),
            winner=torch.zeros((batch_size,), dtype=torch.int8, device=dev),
        )

    def _run_length(self, board: torch.Tensor, r, c, player, dr: int, dc: int) -> torch.Tensor:
        """Stones of ``player`` in the ray from (r, c) along (dr, dc), the
        start included, at most 6 (reference calculateNumberOfConnection,
        gomoku.cpp:151-164; the JAX package's 6-step fori_loop)."""
        n = self.n
        count = torch.zeros_like(r)
        alive = torch.ones_like(r, dtype=torch.bool)
        for i in range(6):
            rr, cc = r + dr * i, c + dc * i
            inside = (rr >= 0) & (rr < n) & (cc >= 0) & (cc < n)
            cell = torch.gather(board, 1, (rr.clamp(0, n - 1) * n + cc.clamp(0, n - 1))[:, None])[:, 0]
            alive = alive & inside & (cell == player)
            count = count + alive.long()
        return count

    def step(self, state: GomokuState, action: torch.Tensor) -> GomokuState:
        action = action.long()
        board = state.board.scatter(1, action[:, None], state.turn[:, None])
        r, c = action // self.n, action % self.n
        p = state.turn
        win = torch.zeros_like(action, dtype=torch.bool)
        for dr, dc in ((1, 0), (0, 1), (1, 1), (1, -1)):
            count = (self._run_length(board, r, c, p, dr, dc)
                     + self._run_length(board, r, c, p, -dr, -dc) - 1)
            win = win | ((count == 5) if self.exactly_five else (count >= 5))
        return GomokuState(
            board=board,
            turn=(3 - state.turn).to(torch.int8),
            num_moves=state.num_moves + 1,
            winner=torch.where(win, p, torch.zeros_like(p)),
        )

    def legal_mask(self, state: GomokuState) -> torch.Tensor:
        empty = state.board == 0
        if self.rule == "outer_open":
            key = str(empty.device)
            if key not in self._outer:
                self._outer[key] = torch.as_tensor(self._np_outer, device=empty.device)
            first = (state.num_moves == 0)[:, None]
            return torch.where(first, empty & self._outer[key], empty)
        return empty

    def is_terminal(self, state: GomokuState) -> torch.Tensor:
        return (state.winner != 0) | (state.board != 0).all(1)

    def eval_score(self, state: GomokuState) -> torch.Tensor:
        w = state.winner
        return torch.where(w == 1, 1.0, torch.where(w == 2, -1.0, 0.0)).to(torch.float32)

    def turn(self, state: GomokuState) -> torch.Tensor:
        return state.turn

    def features(self, state: GomokuState) -> torch.Tensor:
        return turn_planes(state.board, state.turn, self.n)

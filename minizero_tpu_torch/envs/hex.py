"""Hex with the swap rule, batched over games (port of
``minizero_tpu/envs/hex.py``).

Reference: ``minizero/environment/hex/hex.{h,cpp}``. Player 1 connects the
left and right edges, Player 2 the top and bottom. With the swap rule the
second player may play on the first stone's cell to swap: the stone is
reflected over the anti-diagonal and recoloured. The winner is found by
reachability from a player's first edge over the 6-neighbour hex adjacency
(the reference propagates edge flags incrementally), computed at ``step``
and kept in the state. No rotation augmentation (``hex.h:61-62``).

The reachability runs the JAX package's fixed 2 N propagation rounds, each
one neighbour step, with no host check between them: the same answer as
the JAX package's (which a chain more than 2 N steps from its seed edge
does not reach), and no synchronisation with the card.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from minizero_tpu_torch import resolve_device
from minizero_tpu_torch.envs.base import Env, EnvSpec
from minizero_tpu_torch.envs.othello import turn_planes


@dataclass
class HexState:
    """Batched Hex state; every field leads with the batch dimension."""

    board: torch.Tensor  # i8[B, NN]
    turn: torch.Tensor  # i8[B]
    num_moves: torch.Tensor  # i32[B]
    winner: torch.Tensor  # i8[B]


class HexEnv(Env):
    def __init__(self, board_size: int = 11, use_swap_rule: bool = True):
        n = board_size
        self.n = n
        self.nn = n * n
        self.use_swap_rule = use_swap_rule
        self.spec = EnvSpec(
            name=f"hex_{n}x{n}",
            num_players=2,
            board_size=n,
            action_size=self.nn,
            num_input_channels=4,
            input_height=n,
            input_width=n,
            hidden_height=n,
            hidden_width=n,
            max_game_length=self.nn + 1,
        )
        # 6-neighbour hex adjacency (reference updateWinner offsets)
        nbr = np.tile(np.arange(self.nn)[:, None], (1, 6))
        valid = np.zeros((self.nn, 6), bool)
        for p in range(self.nn):
            r, c = divmod(p, n)
            for j, (dr, dc) in enumerate(((-1, -1), (-1, 0), (0, -1), (0, 1), (1, 0), (1, 1))):
                rr, cc = r + dr, c + dc
                if 0 <= rr < n and 0 <= cc < n:
                    nbr[p, j] = rr * n + cc
                    valid[p, j] = True
        cols = np.arange(self.nn) % n
        rows = np.arange(self.nn) // n
        self._np = {"nbr": nbr.astype(np.int64), "nbr_valid": valid,
                    "edge1_p1": cols == 0, "edge2_p1": cols == n - 1,  # left, right
                    "edge1_p2": rows == 0, "edge2_p2": rows == n - 1}  # top, bottom

    def num_rotations(self) -> int:
        return 1  # no square symmetry (reference hex.h:61-62)

    def init(self, batch_size: int, device=None) -> HexState:
        dev = resolve_device(device)
        return HexState(
            board=torch.zeros((batch_size, self.nn), dtype=torch.int8, device=dev),
            turn=torch.ones((batch_size,), dtype=torch.int8, device=dev),
            num_moves=torch.zeros((batch_size,), dtype=torch.int32, device=dev),
            winner=torch.zeros((batch_size,), dtype=torch.int8, device=dev),
        )

    def _connected_to(self, board: torch.Tensor, player: int, seed: torch.Tensor) -> torch.Tensor:
        """bool[B, NN]: stones of ``player`` reached from ``seed`` cells
        through same-colour hex neighbours in 2 N rounds."""
        tb = self._tables(board.device)
        mine = board == player
        reach = seed[None, :] & mine
        connected = mine[:, tb["nbr"]] & tb["nbr_valid"] & mine[:, :, None]
        for _ in range(2 * self.n):
            reach = reach | (mine & (connected & reach[:, tb["nbr"]]).any(-1))
        return reach

    def _winner(self, board: torch.Tensor) -> torch.Tensor:
        tb = self._tables(board.device)
        p1 = (self._connected_to(board, 1, tb["edge1_p1"]) & tb["edge2_p1"]).any(1)
        p2 = (self._connected_to(board, 2, tb["edge1_p2"]) & tb["edge2_p2"]).any(1)
        zero = torch.zeros(board.shape[:1], dtype=torch.int8, device=board.device)
        return torch.where(p1, zero + 1, torch.where(p2, zero + 2, zero))

    def step(self, state: HexState, action: torch.Tensor) -> HexState:
        n = self.n
        action = action.long()
        rows = torch.arange(action.shape[0], device=action.device)
        is_swap = (state.num_moves == 1) & (state.board[rows, action] != 0)
        if not self.use_swap_rule:
            is_swap = torch.zeros_like(is_swap)
        # swap: the first stone reflected over the anti-diagonal, recoloured
        r, c = action // n, action % n
        reflected = (n - 1 - c) * n + (n - 1 - r)
        board = state.board.clone()
        board[rows[is_swap], action[is_swap]] = 0
        board[rows, torch.where(is_swap, reflected, action)] = state.turn
        return HexState(
            board=board,
            turn=(3 - state.turn).to(torch.int8),
            num_moves=state.num_moves + 1,
            winner=self._winner(board),
        )

    def legal_mask(self, state: HexState) -> torch.Tensor:
        empty = state.board == 0
        if self.use_swap_rule:
            # on move 2 every cell is playable (the first stone's = swap),
            # reference hex.cpp isLegalAction
            return empty | (state.num_moves == 1)[:, None]
        return empty

    def is_terminal(self, state: HexState) -> torch.Tensor:
        return state.winner != 0

    def eval_score(self, state: HexState) -> torch.Tensor:
        w = state.winner
        return torch.where(w == 1, 1.0, torch.where(w == 2, -1.0, 0.0)).to(torch.float32)

    def turn(self, state: HexState) -> torch.Tensor:
        return state.turn

    def features(self, state: HexState) -> torch.Tensor:
        return turn_planes(state.board, state.turn, self.n)

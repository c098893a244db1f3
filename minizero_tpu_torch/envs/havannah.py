"""Havannah, batched over games (port of ``minizero_tpu/envs/havannah.py``).

Reference: ``minizero/environment/havannah/havannah.{h,cpp}``. The hex board
of side n lives in a (2n-1)^2 grid; cell (i, j) is on the board iff
n-1 <= i+j <= 3n-3. A group wins by a bridge (2 of the 6 corners), a fork
(3 of the 6 borders, corners excluded) or a ring (``havannah.cpp
updateWinner``): the group holds at least 6 stones, the new stone has at
least 2 own neighbours, and some neighbour has 6 own neighbours (a filled
ring) or the group encloses a region (``isCycle`` / ``detectHole``). Swap
rule: on move 1 every valid cell is legal, the first stone's cell too,
which turns that stone White. Features: 20 planes = 8 x 2 history, the
valid-cell plane, the swappable plane and 2 turn planes.

The group and the enclosed region come from connected-component labels:
``cc_rounds`` = ceil(log2 (2n-1)^2) + 4 fixed rounds of min-propagation,
each with a pointer jump, as the JAX package runs them (12 at n = 8), so
that the two packages agree move for move; the enclosed region floods the
complement of the group on the grid padded by one cell.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from minizero_tpu_torch import resolve_device
from minizero_tpu_torch.envs.base import Env, EnvSpec

_HISTORY = 8
# hex neighbours of (i, j) on the extended grid (havannah.cpp:296-300)
_NBRS = ((-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0))


def _neighbours(size: int, inside):
    """(nbr i64[size^2, 6], valid bool[size^2, 6]) on a size x size grid;
    ``inside`` bool[size^2] marks the cells that have neighbours."""
    cells = size * size
    nbr = np.tile(np.arange(cells)[:, None], (1, 6))
    valid = np.zeros((cells, 6), bool)
    for p in range(cells):
        if not inside[p]:
            continue
        i, j = divmod(p, size)
        for k, (di, dj) in enumerate(_NBRS):
            a, b = i + di, j + dj
            if 0 <= a < size and 0 <= b < size and inside[a * size + b]:
                nbr[p, k] = a * size + b
                valid[p, k] = True
    return nbr.astype(np.int64), valid


@dataclass
class HavannahState:
    """Batched Havannah state; every field leads with the batch dimension."""

    board: torch.Tensor  # i8[B, EE]
    turn: torch.Tensor  # i8[B]
    num_moves: torch.Tensor  # i32[B]
    winner: torch.Tensor  # i8[B]
    first_action: torch.Tensor  # i32[B] (for the swap rule)
    board_history: torch.Tensor  # i8[B, 8, EE]


class HavannahEnv(Env):
    def __init__(self, board_size: int = 8, use_swap_rule: bool = True):
        n = board_size
        e = 2 * n - 1
        self.n, self.e, self.ee = n, e, e * e
        self.use_swap = use_swap_rule
        self.cc_rounds = int(math.ceil(math.log2(max(self.ee, 2)))) + 4
        self.spec = EnvSpec(
            name=f"havannah{n}x{n}",
            num_players=2,
            board_size=e,  # feature planes live on the extended grid
            action_size=self.ee,
            num_input_channels=20,
            input_height=e,
            input_width=e,
            hidden_height=e,
            hidden_width=e,
            max_game_length=3 * n * n - 3 * n + 2,  # number of valid cells + 1
        )
        ii, jj = np.divmod(np.arange(self.ee), e)
        valid = (ii + jj >= n - 1) & (ii + jj <= 3 * n - 3)
        nbr, nvalid = _neighbours(e, valid)
        corners = np.zeros(self.ee, bool)
        corners[[n - 1, e - 1, (n - 1) * e, n * e - 1, (e - 1) * e, (e - 1) * e - 1 + n]] = True
        borders = np.zeros((6, self.ee), bool)
        for i in range(n - 2):
            borders[0, n + i] = True
            borders[1, (i + 1) * e + n - 2 - i] = True
            borders[2, (n + i) * e] = True
            borders[3, (e - 1) * e + 1 + i] = True
            borders[4, (e - 1 - i) * e - n + 1 + i] = True
            borders[5, (n - 1 - i) * e - 1] = True
        pe = e + 2
        self.pe, self.pee = pe, pe * pe
        pnbr, pvalid = _neighbours(pe, np.ones(self.pee, bool))
        pi, pj = np.divmod(np.arange(self.pee), pe)
        self._np = {"valid": valid, "nbr": nbr, "nbr_valid": nvalid, "corners": corners,
                    "borders": borders, "pnbr": pnbr, "pnbr_valid": pvalid,
                    "pad_ring": (pi == 0) | (pi == pe - 1) | (pj == 0) | (pj == pe - 1),
                    "pad_index": (ii + 1) * pe + (jj + 1)}

    def num_rotations(self) -> int:
        return 1

    def _cc_labels(self, active: torch.Tensor, nbr: torch.Tensor, nbr_valid: torch.Tensor) -> torch.Tensor:
        """i64[B, S] component labels (the least member index; S outside
        ``active``) after ``cc_rounds`` rounds."""
        size = active.shape[1]
        idx = torch.arange(size, device=active.device)
        labels = torch.where(active, idx, size)
        connected = active[:, nbr] & nbr_valid & active[:, :, None]
        for _ in range(self.cc_rounds):
            nl = torch.where(connected, labels[:, nbr], size)
            lab = torch.minimum(labels, nl.amin(-1))
            lab = torch.minimum(lab, torch.gather(lab, 1, lab.clamp(0, size - 1)))
            labels = torch.where(active, lab, size)
        return labels

    def _has_hole(self, group: torch.Tensor) -> torch.Tensor:
        """bool[B]: the group encloses a background region (detectHole)."""
        tb = self._tables(group.device)
        b = group.shape[0]
        path = torch.zeros((b, self.pee), dtype=torch.bool, device=group.device)
        path[:, tb["pad_index"]] = group
        background = ~path
        labels = self._cc_labels(background, tb["pnbr"], tb["pnbr_valid"])
        outside = torch.zeros((b, self.pee + 1), dtype=torch.bool, device=group.device)
        outside.scatter_(1, torch.where(tb["pad_ring"], labels, self.pee), True)
        enclosed = background & ~torch.gather(outside, 1, labels.clamp(0, self.pee))
        return enclosed.any(1)

    def _winner_after(self, board: torch.Tensor, pos: torch.Tensor, player: torch.Tensor) -> torch.Tensor:
        tb = self._tables(board.device)
        rows = torch.arange(board.shape[0], device=board.device)
        active = board == player[:, None]
        labels = self._cc_labels(active, tb["nbr"], tb["nbr_valid"])
        group = active & (labels == labels[rows, pos][:, None])
        bridge = (group & tb["corners"]).sum(1) >= 2
        fork = (group[:, None, :] & tb["borders"]).any(2).sum(1) >= 3
        own_nbrs = (active[:, tb["nbr"]] & tb["nbr_valid"]).sum(2)        # [B, EE]
        big_enough = group.sum(1) >= 6
        two_back = own_nbrs[rows, pos] >= 2
        pn = tb["nbr"][pos]                                               # [B, 6]
        nbr_full = (tb["nbr_valid"][pos] & (board[rows[:, None], pn] == player[:, None])
                    & (own_nbrs[rows[:, None], pn] == 6)).any(1)
        ring = big_enough & two_back & (nbr_full | self._has_hole(group))
        return torch.where(bridge | fork | ring, player, 0).to(torch.int8)

    def init(self, batch_size: int, device=None) -> HavannahState:
        dev = resolve_device(device)
        return HavannahState(
            board=torch.zeros((batch_size, self.ee), dtype=torch.int8, device=dev),
            turn=torch.ones((batch_size,), dtype=torch.int8, device=dev),
            num_moves=torch.zeros((batch_size,), dtype=torch.int32, device=dev),
            winner=torch.zeros((batch_size,), dtype=torch.int8, device=dev),
            first_action=torch.full((batch_size,), -1, dtype=torch.int32, device=dev),
            board_history=torch.zeros((batch_size, _HISTORY, self.ee), dtype=torch.int8,
                                      device=dev),
        )

    def legal_mask(self, state: HavannahState) -> torch.Tensor:
        valid = self._tables(state.board.device)["valid"]
        empty = (state.board == 0) & valid
        if self.use_swap:
            return torch.where((state.num_moves == 1)[:, None], valid, empty)
        return empty

    def step(self, state: HavannahState, action: torch.Tensor) -> HavannahState:
        player = state.turn
        a = action.long()
        rows = torch.arange(a.shape[0], device=a.device)
        # a swap plays on the first stone's cell, which turns that stone White
        board = state.board.clone()
        board[rows, a] = player
        winner = torch.where(state.winner != 0, state.winner, self._winner_after(board, a, player))
        return HavannahState(
            board=board,
            turn=(3 - player).to(torch.int8),
            num_moves=state.num_moves + 1,
            winner=winner.to(torch.int8),
            first_action=torch.where(state.num_moves == 0, action.to(torch.int32),
                                     state.first_action),
            board_history=torch.cat([board[:, None], state.board_history[:, :-1]], dim=1),
        )

    def is_terminal(self, state: HavannahState) -> torch.Tensor:
        valid = self._tables(state.board.device)["valid"]
        return (state.winner != 0) | ~((state.board == 0) & valid).any(1)

    def eval_score(self, state: HavannahState) -> torch.Tensor:
        w = state.winner
        return torch.where(w == 1, 1.0, torch.where(w == 2, -1.0, 0.0)).to(torch.float32)

    def turn(self, state: HavannahState) -> torch.Tensor:
        return state.turn

    def features(self, state: HavannahState) -> torch.Tensor:
        """20 planes, ``[B, H, W, C]`` (havannah.cpp getFeatures)."""
        e, ee = self.e, self.ee
        b = state.board.shape[0]
        turn = state.turn
        hist = state.board_history
        own_h = hist == turn[:, None, None]
        opp_h = hist == (3 - turn)[:, None, None]
        planes = torch.stack([own_h, opp_h], dim=2).reshape(b, 2 * _HISTORY, ee)
        valid = self._tables(state.board.device)["valid"][None, None].expand(b, 1, ee)
        swappable = ((state.num_moves == 1) & self.use_swap)[:, None, None].expand(b, 1, ee)
        p1 = (turn == 1)[:, None, None].expand(b, 1, ee)
        p2 = (turn == 2)[:, None, None].expand(b, 1, ee)
        feats = torch.cat([planes, valid, swappable, p1, p2], dim=1).to(torch.float32)
        return feats.reshape(b, 20, e, e).permute(0, 2, 3, 1).contiguous()

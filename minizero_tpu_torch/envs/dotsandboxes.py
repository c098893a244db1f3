"""Dots and Boxes, batched over games (port of
``minizero_tpu/envs/dotsandboxes.py``).

Reference: ``minizero/environment/dotsandboxes/dotsandboxes.{h,cpp}``. The
board is the (2N+1) x (2N+1) grid of dots, line slots and boxes
(``dotsandboxes.cpp:107-137``), one int8 code per cell. Line slots are the
odd flat positions, so action ``a`` sets cell ``2a + 1``
(``dotsandboxes.h:88``) and the legal mask is the odd cells without a line.
A box is closed when it is unowned and its four sides are set; only boxes
beside the new line can be, so a whole-board count of set sides finds
them. A move that closes a box keeps the turn
(``dotsandboxes.cpp:178-183``). Terminal when every box is owned; the
majority of boxes wins (``dotsandboxes.cpp:214-245``).

Features: 8 history steps x 11 planes + 2 turn planes = 90 planes on the
full grid (``dotsandboxes.cpp:247-325``); history slots before the game's
start hold -1 and give all-zero planes. No rotation augmentation. AlphaZero
only, as in the reference: ``action_features`` raises
(``dotsandboxes.cpp:327-330``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from minizero_tpu_torch import resolve_device
from minizero_tpu_torch.envs.base import Env, EnvSpec

# grid cell codes (reference Grid enum, dotsandboxes.h:13-21)
EMPTY_BOX = 0
P1_BOX = 1
P2_BOX = 2
NO_LINE = 3
LINE = 4
DOT = 5
_HISTORY = 8


@dataclass
class DotsAndBoxesState:
    """Batched Dots and Boxes state; every field leads with the batch
    dimension."""

    board: torch.Tensor  # i8[B, (2N+1)^2] cell codes
    turn: torch.Tensor  # i8[B]
    num_moves: torch.Tensor  # i32[B]
    board_history: torch.Tensor  # i8[B, 8, (2N+1)^2], [:, 0] = current; -1 before the start
    continue_history: torch.Tensor  # i8[B, 8]: the player who closed a box and moves again, 0 none


class DotsAndBoxesEnv(Env):
    def __init__(self, board_size: int = 9):
        n = board_size
        self.n = n
        self.full = 2 * n + 1
        action_size = 2 * n * (n + 1)
        self.spec = EnvSpec(
            name="dotsandboxes",
            num_players=2,
            board_size=n,
            action_size=action_size,
            num_input_channels=90,
            input_height=self.full,
            input_width=self.full,
            hidden_height=self.full,
            hidden_width=self.full,
            max_game_length=action_size,  # every move sets one line
        )
        ys, xs = np.mgrid[0:self.full, 0:self.full]
        init = np.full((self.full, self.full), EMPTY_BOX, np.int8)
        init[(ys % 2 == 0) & (xs % 2 == 0)] = DOT
        init[(ys % 2 == 0) ^ (xs % 2 == 0)] = NO_LINE
        self._np = {"box": ((ys % 2 == 1) & (xs % 2 == 1)).reshape(-1),
                    "init": init.reshape(-1)}

    def num_rotations(self) -> int:
        return 1

    def action_features(self, action):
        raise NotImplementedError("dotsandboxes is AlphaZero-only (reference "
                                  "dotsandboxes.cpp:327-330 getActionFeatures throws)")

    def _adjacent_line_count(self, board: torch.Tensor) -> torch.Tensor:
        """i32[..., (2N+1)^2]: per cell, the LINE cells among its 4 grid
        neighbours (meaningful at box cells, which are interior)."""
        f = self.full
        g = (board == LINE).to(torch.int32).reshape(-1, f, f)
        p = F.pad(g, (1, 1, 1, 1))
        cnt = p[:, :-2, 1:-1] + p[:, 2:, 1:-1] + p[:, 1:-1, :-2] + p[:, 1:-1, 2:]
        return cnt.reshape(board.shape)

    def init(self, batch_size: int, device=None) -> DotsAndBoxesState:
        dev = resolve_device(device)
        board = self._tables(dev)["init"].repeat(batch_size, 1)
        hist = torch.full((batch_size, _HISTORY, self.full * self.full), -1, dtype=torch.int8,
                          device=dev)
        hist[:, 0] = board
        return DotsAndBoxesState(
            board=board,
            turn=torch.ones((batch_size,), dtype=torch.int8, device=dev),
            num_moves=torch.zeros((batch_size,), dtype=torch.int32, device=dev),
            board_history=hist,
            continue_history=torch.zeros((batch_size, _HISTORY), dtype=torch.int8, device=dev),
        )

    def step(self, state: DotsAndBoxesState, action: torch.Tensor) -> DotsAndBoxesState:
        rows = torch.arange(action.shape[0], device=action.device)
        board = state.board.clone()
        board[rows, 2 * action.long() + 1] = LINE
        newly = (board == EMPTY_BOX) & (self._adjacent_line_count(board) == 4)
        board = torch.where(newly, state.turn[:, None], board)
        closed = newly.any(1)
        turn = torch.where(closed, state.turn, 3 - state.turn).to(torch.int8)
        cont = torch.where(closed, state.turn, 0).to(torch.int8)
        return DotsAndBoxesState(
            board=board,
            turn=turn,
            num_moves=state.num_moves + 1,
            board_history=torch.cat([board[:, None], state.board_history[:, :-1]], dim=1),
            continue_history=torch.cat([cont[:, None], state.continue_history[:, :-1]], dim=1),
        )

    def legal_mask(self, state: DotsAndBoxesState) -> torch.Tensor:
        return state.board[:, 1::2] == NO_LINE

    def is_terminal(self, state: DotsAndBoxesState) -> torch.Tensor:
        return ~(state.board == EMPTY_BOX).any(1)

    def eval_score(self, state: DotsAndBoxesState) -> torch.Tensor:
        p1 = (state.board == P1_BOX).sum(1)
        p2 = (state.board == P2_BOX).sum(1)
        return torch.where(p1 > p2, 1.0, torch.where(p2 > p1, -1.0, 0.0)).to(torch.float32)

    def turn(self, state: DotsAndBoxesState) -> torch.Tensor:
        return state.turn

    def features(self, state: DotsAndBoxesState) -> torch.Tensor:
        """90 planes, ``[B, H, W, C]`` (dotsandboxes.cpp:247-325): per
        history step own boxes, opponent boxes, empty boxes, no-line, line,
        boxes with 1..4 sides set, own-continue and opponent-continue; then
        the two turn planes."""
        b = state.board.shape[0]
        cells = self.full * self.full
        box = self._tables(state.board.device)["box"]
        own = state.turn[:, None, None]
        opp = (3 - state.turn)[:, None, None]
        hist = state.board_history                                     # [B, 8, C]
        cnt = self._adjacent_line_count(hist)
        cp = state.continue_history[:, :, None]                        # [B, 8, 1]
        ones = torch.ones_like(hist, dtype=torch.bool)
        planes = torch.stack([
            hist == own, hist == opp, hist == EMPTY_BOX, hist == NO_LINE, hist == LINE,
            box & (cnt == 1), box & (cnt == 2), box & (cnt == 3), box & (cnt == 4),
            ones & (cp == own), ones & (cp == opp)], dim=2).reshape(b, 11 * _HISTORY, cells)
        t1 = (state.turn == 1)[:, None, None].expand(b, 1, cells)
        t2 = (state.turn == 2)[:, None, None].expand(b, 1, cells)
        feats = torch.cat([planes, t1, t2], dim=1).to(torch.float32)
        return feats.permute(0, 2, 1).reshape(b, self.full, self.full, 90).contiguous()

    # -- console ---------------------------------------------------------------

    def render(self, state: DotsAndBoxesState, game: int = 0) -> str:
        """Text board of game ``game`` (reference toStringDebug,
        dotsandboxes.cpp:377-397): dots ``*``, lines ``-`` and ``|``, boxes
        ``X`` (player 1) and ``O`` (player 2), top row first."""
        b = state.board[game].cpu().numpy().reshape(self.full, self.full)
        sym = {EMPTY_BOX: " ", P1_BOX: "X", P2_BOX: "O", NO_LINE: " ", DOT: "*"}
        rows = []
        for y in range(self.full - 1, -1, -1):
            cells = []
            for x in range(self.full):
                v = int(b[y, x])
                cells.append(("-" if y % 2 == 0 else "|") if v == LINE else sym.get(v, "?"))
            rows.append(" ".join(cells))
        return "\n".join(rows) + "\n"

    def action_to_string(self, action_id: int) -> str:
        """Line coordinate "A1A2": the two dots the line joins, columns
        lettered without "I" (reference getCoordString,
        dotsandboxes.cpp:68-92)."""
        n = self.n
        dots = n + 1
        x2 = action_id % (2 * n + 1)
        y2 = action_id // (2 * n + 1)
        shift = y2 * dots

        def dot_str(p):
            x, y = p % dots, p // dots
            return chr(x + ord("A") + (1 if x >= 8 else 0)) + str(y + 1)

        if x2 < n:  # horizontal
            return dot_str(x2 + shift) + dot_str(x2 + 1 + shift)
        return dot_str(x2 - n + shift) + dot_str(x2 + 1 + shift)

    def string_to_action(self, coord: str) -> int:
        """The line between two adjacent dots given as "A1A2" (either
        order, any case), -1 for a string that names none (reference
        coordToActionID, dotsandboxes.cpp:11-66)."""
        s = coord.strip().upper()
        dots = self.n + 1

        def parse(buf):
            if not buf or not buf[0].isalpha():
                return -1
            x = ord(buf[0]) - ord("A") - (1 if buf[0] > "I" else 0)
            try:
                y = int(buf[1:]) - 1
            except ValueError:
                return -1
            if x >= dots or y >= dots or x < 0 or y < 0:
                return -1
            return x + dots * y

        if len(s) == 4:
            a, b = s[:2], s[2:]
        elif len(s) == 5:
            mid = 3 if s[2].isdigit() else 2
            a, b = s[:mid], s[mid:]
        elif len(s) == 6:
            a, b = s[:3], s[3:]
        else:
            return -1
        fp, dp = parse(a), parse(b)
        if fp == -1 or dp == -1:
            return -1
        if fp > dp:
            fp, dp = dp, fp
        diff = dp - fp
        if diff not in (1, dots):
            return -1
        level = fp // dots
        fp -= level * dots
        dp -= level * dots
        return (fp if diff == 1 else dp - 1) + level * (2 * dots - 1)

"""Lines of Action, batched over games (port of
``minizero_tpu/envs/linesofaction.py``).

Reference: ``minizero/environment/linesofaction/linesofaction.{h,cpp}``.
A move slides exactly as many squares as there are pieces (both colours)
on the whole line through its from-square (``linesofaction.cpp:184``),
crosses no enemy piece (``:186-192``), lands on no own piece (``:194``),
and may not recreate an earlier (position, player to move): the cycle rule
(``:195, 456-470``), kept with the additive dual-uint32 Zobrist hashes of
``envs/cycle.py``. A player whose pieces form one 8-connected group wins;
both connected after a capture is a draw (``:419-434``). 1,456 move ids at
8 x 8: every (from, dest) ray pair in 8 directions (``:17-64``).

Features: 22 planes = 8 x 2 history, 4 whole-line piece-count planes (/8,
on occupied squares) and 2 turn planes (``linesofaction.cpp:227-276``). No
rotation augmentation.

Line counts and path blocking are products of 0/1 tables with 0/1 boards
(counts <= 8): exact in float32 whatever the matmul precision.
Connectivity keeps the JAX package's 10 label rounds.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from minizero_tpu_torch import resolve_device
from minizero_tpu_torch.envs import cycle
from minizero_tpu_torch.envs.base import Env, EnvSpec

_HISTORY = 8
_N = 8  # reference kLinesOfActionBoardSize
# direction order of the reference's initialize() (linesofaction.cpp:31)
_DIRS = ((1, 0), (0, 1), (-1, 0), (0, -1), (1, 1), (-1, 1), (-1, -1), (1, -1))
# the line planes' directions, indices 0, 1, 4, 5 (linesofaction.cpp:257-266)
_LINE_DIRS = ((1, 0), (0, 1), (1, 1), (1, -1))
_LABEL_ROUNDS = 10


def move_table(n: int):
    """(from, dest, dir4, dist) int64 arrays in the reference's move-id
    order."""
    moves = []
    for y in range(n):
        for x in range(n):
            for dx, dy in _DIRS:
                xx, yy = x + dx, y + dy
                while 0 <= xx < n and 0 <= yy < n:
                    moves.append((x + n * y, xx + n * yy, (dx, dy)))
                    xx += dx
                    yy += dy
    frm = np.array([m[0] for m in moves], np.int64)
    dst = np.array([m[1] for m in moves], np.int64)
    dir4 = np.zeros(len(moves), np.int64)
    dist = np.zeros(len(moves), np.int64)
    for i, (f, d, (dx, dy)) in enumerate(moves):
        dist[i] = max(abs(d % n - f % n), abs(d // n - f // n))
        for k, (lx, ly) in enumerate(_LINE_DIRS):
            if (dx, dy) in ((lx, ly), (-lx, -ly)):
                dir4[i] = k
    return frm, dst, dir4, dist


def line_tables(n: int):
    """(line [4 * NN, NN], path [A, NN], nbr8 [NN, 8], nbr8_valid): whole-
    line membership by direction, the cells strictly between a move's from
    and dest, and the 8-neighbour table (self-padded)."""
    nn = n * n
    line = np.zeros((4, nn, nn), np.float32)
    for k, (dx, dy) in enumerate(_LINE_DIRS):
        for p in range(nn):
            x, y = p % n, p // n
            for s in (1, -1):
                xx, yy = x, y
                while 0 <= xx < n and 0 <= yy < n:
                    line[k, p, xx + n * yy] = 1.0
                    xx += s * dx
                    yy += s * dy
    frm, dst, _, _ = move_table(n)
    path = np.zeros((len(frm), nn), np.float32)
    for a, (f, d) in enumerate(zip(frm, dst)):
        fx, fy, tx, ty = f % n, f // n, d % n, d // n
        steps = max(abs(tx - fx), abs(ty - fy))
        sx, sy = (tx - fx) // steps, (ty - fy) // steps
        for i in range(1, steps):
            path[a, (fx + i * sx) + n * (fy + i * sy)] = 1.0
    nbr = np.tile(np.arange(nn)[:, None], (1, 8))
    valid = np.zeros((nn, 8), bool)
    for p in range(nn):
        x, y = p % n, p // n
        for j, (dx, dy) in enumerate(_DIRS):
            xx, yy = x + dx, y + dy
            if 0 <= xx < n and 0 <= yy < n:
                nbr[p, j] = xx + n * yy
                valid[p, j] = True
    return line.reshape(4 * nn, nn), path, nbr.astype(np.int64), valid


@dataclass
class LinesOfActionState:
    """Batched Lines of Action state; every field leads with the batch
    dimension."""

    board: torch.Tensor  # i8[B, NN]
    turn: torch.Tensor  # i8[B]
    num_moves: torch.Tensor  # i32[B]
    hash_a: torch.Tensor  # i32[B] additive Zobrist (mod 2^32)
    hash_b: torch.Tensor  # i32[B]
    history_a: torch.Tensor  # i32[B, MAX+1] hashes of the past (position, turn)s
    history_b: torch.Tensor  # i32[B, MAX+1]
    board_history: torch.Tensor  # i8[B, 8, NN]


class LinesOfActionEnv(Env):
    def __init__(self, board_size: int = _N):
        assert board_size == _N, "the reference fixes Lines of Action at 8x8"
        n = board_size
        self.n, self.nn = n, n * n
        frm, dst, dir4, dist = move_table(n)
        self.max_moves = 4 * self.nn  # the cycle rule keeps games short; a hard cap
        self.spec = EnvSpec(
            name="linesofaction",
            num_players=2,
            board_size=n,
            action_size=len(frm),
            num_input_channels=22,
            input_height=n,
            input_width=n,
            hidden_height=n,
            hidden_width=n,
            max_game_length=self.max_moves,
        )
        line, path, nbr, nbr_valid = line_tables(n)
        key_a, key_b, self._turn_key_a, self._turn_key_b = cycle.zobrist_keys(self.nn, 20260818)
        board = np.zeros(self.nn, np.int8)
        board[1:n - 1] = 1  # bottom row (linesofaction.cpp:78-81)
        board[(n - 1) * n + 1:(n - 1) * n + n - 1] = 1  # top row
        for i in range(1, n - 1):
            board[i * n] = 2
            board[i * n + n - 1] = 2
        self._np = {"from": frm, "dest": dst, "dir4": dir4, "dist": dist.astype(np.float32),
                    "line_t": np.ascontiguousarray(line.T), "path_t": np.ascontiguousarray(path.T),
                    "nbr8": nbr, "nbr8_valid": nbr_valid, "key_a": key_a, "key_b": key_b,
                    "start": board}

    def num_rotations(self) -> int:
        return 1  # move-indexed policy; the reference disables rotation

    # ------------------------------------------------------------ primitives
    def _hashes(self, board, turn):
        tb = self._tables(board.device)
        return (cycle.board_hash(board, turn, tb["key_a"], self._turn_key_a),
                cycle.board_hash(board, turn, tb["key_b"], self._turn_key_b))

    def _line_counts(self, board: torch.Tensor) -> torch.Tensor:
        """f32[B, 4, NN]: pieces on the whole line through each square."""
        occ = (board > 0).to(torch.float32)
        return (occ @ self._tables(board.device)["line_t"]).reshape(-1, 4, self.nn)

    def _connected(self, board: torch.Tensor, p: int) -> torch.Tensor:
        """bool[B]: every piece of player ``p`` is in one 8-connected group
        (true with no pieces, as the reference's search from nothing)."""
        tb = self._tables(board.device)
        nn = self.nn
        nbr = tb["nbr8"]
        active = board == p
        idx = torch.arange(nn, device=board.device)[None, :]
        labels = torch.where(active, idx, nn)
        connected = active[:, nbr] & tb["nbr8_valid"] & active[:, :, None]
        for _ in range(_LABEL_ROUNDS):
            nbr_lab = torch.where(connected, labels[:, nbr], nn)
            lab = torch.minimum(labels, nbr_lab.amin(-1))
            lab = torch.minimum(lab, lab.gather(1, lab.clamp(0, nn - 1)))
            labels = torch.where(active, lab, nn)
        least = labels.amin(-1, keepdim=True)
        return (~active | (labels == least)).all(-1)

    # -------------------------------------------------------------- protocol
    def init(self, batch_size: int, device=None) -> LinesOfActionState:
        dev = resolve_device(device)
        board = self._tables(dev)["start"].repeat(batch_size, 1)
        turn = torch.ones((batch_size,), dtype=torch.int8, device=dev)
        ha, hb = self._hashes(board, turn)
        history_a = torch.zeros((batch_size, self.max_moves + 1), dtype=torch.int32, device=dev)
        history_b = torch.zeros_like(history_a)
        history_a[:, 0], history_b[:, 0] = ha, hb
        board_history = torch.zeros((batch_size, _HISTORY, self.nn), dtype=torch.int8, device=dev)
        board_history[:, 0] = board
        return LinesOfActionState(
            board=board, turn=turn,
            num_moves=torch.zeros((batch_size,), dtype=torch.int32, device=dev),
            hash_a=ha, hash_b=hb, history_a=history_a, history_b=history_b,
            board_history=board_history)

    def legal_mask(self, state: LinesOfActionState) -> torch.Tensor:
        tb = self._tables(state.board.device)
        board, turn = state.board, state.turn
        opp = (3 - turn).to(board.dtype)
        frm, dest = tb["from"], tb["dest"]
        counts = self._line_counts(board)  # [B, 4, NN]
        own_from = board[:, frm] == turn[:, None]
        right_dist = counts[:, tb["dir4"], frm] == tb["dist"]
        no_cross = ((board == opp[:, None]).to(torch.float32) @ tb["path_t"]) == 0
        not_own_dest = board[:, dest] != turn[:, None]
        cand_a = cycle.move_hash(state.hash_a, turn, board, frm, dest, tb["key_a"],
                                 self._turn_key_a)
        cand_b = cycle.move_hash(state.hash_b, turn, board, frm, dest, tb["key_b"],
                                 self._turn_key_b)
        repeat = cycle.seen_before(state.history_a, state.history_b, state.num_moves,
                                   cand_a, cand_b)
        return own_from & right_dist & no_cross & not_own_dest & ~repeat

    def step(self, state: LinesOfActionState, action: torch.Tensor) -> LinesOfActionState:
        tb = self._tables(state.board.device)
        a = action.long()
        rows = torch.arange(a.shape[0], device=a.device)
        board = state.board.clone()
        board[rows, tb["from"][a]] = 0
        board[rows, tb["dest"][a]] = state.turn
        turn = (3 - state.turn).to(torch.int8)
        ha, hb = self._hashes(board, turn)
        num_moves = state.num_moves + 1
        slot = num_moves.long().clamp(0, self.max_moves)[:, None]
        return LinesOfActionState(
            board=board, turn=turn, num_moves=num_moves, hash_a=ha, hash_b=hb,
            history_a=state.history_a.scatter(1, slot, ha[:, None]),
            history_b=state.history_b.scatter(1, slot, hb[:, None]),
            board_history=torch.cat([board[:, None], state.board_history[:, :-1]], dim=1))

    def is_terminal(self, state: LinesOfActionState) -> torch.Tensor:
        return (self._connected(state.board, 1) | self._connected(state.board, 2)
                | (state.num_moves >= self.max_moves))

    def eval_score(self, state: LinesOfActionState) -> torch.Tensor:
        c1 = self._connected(state.board, 1)
        c2 = self._connected(state.board, 2)
        return torch.where(c1 & c2, 0.0, torch.where(c1, 1.0, torch.where(c2, -1.0, 0.0))
                           ).to(torch.float32)

    def turn(self, state: LinesOfActionState) -> torch.Tensor:
        return state.turn

    def features(self, state: LinesOfActionState) -> torch.Tensor:
        """22 planes, ``[B, H, W, C]`` (linesofaction.cpp:227-276)."""
        n, nn = self.n, self.nn
        b = state.board.shape[0]
        turn = state.turn
        hist = state.board_history
        own_h = (hist == turn[:, None, None]).to(torch.float32)
        opp_h = (hist == (3 - turn)[:, None, None]).to(torch.float32)
        planes = torch.stack([own_h, opp_h], dim=2).reshape(b, 2 * _HISTORY, nn)
        occ = (state.board > 0).to(torch.float32)
        counts = self._line_counts(state.board) / 8.0 * occ[:, None, :]
        p1 = (turn == 1).to(torch.float32)[:, None, None].expand(b, 1, nn)
        p2 = (turn == 2).to(torch.float32)[:, None, None].expand(b, 1, nn)
        feats = torch.cat([planes, counts, p1, p2], dim=1)
        return feats.reshape(b, 22, n, n).permute(0, 2, 3, 1).contiguous()

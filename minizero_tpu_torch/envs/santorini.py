"""Santorini, batched over games (port of ``minizero_tpu/envs/santorini.py``).

Reference: ``minizero/environment/santorini/{santorini,board}.{h,cpp}``.
1,900 action ids (``santorini.cpp parseAction``): 0..1599 are from-square
(25) x move direction (8) x build direction (8); 1600..1899 place both
workers at the opening, C(25, 2) unordered square pairs in the reference's
combination order. A worker moves to an 8-neighbour at most one level
higher and free of workers (``board.cpp getLegalMove``), then builds on an
8-neighbour of its landing square of level <= 3 and free of workers (the
square it left is free, ``getLegalBuild``); placements avoid the opponent's
workers. A player with a worker on level 3 wins; a player without a move
loses (``board.cpp isTerminal / checkWin``, ``santorini.cpp
getEvalScore``). The placement phase lasts until both of a player's workers
are placed.

Features: 50 planes = 8 history boards x (own workers, opponent workers,
levels 1..4) and 2 turn planes (``santorini.cpp getFeatures``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from minizero_tpu_torch import resolve_device
from minizero_tpu_torch.envs.base import Env, EnvSpec

_N = 5
_NN = 25
_HISTORY = 8
# the reference's kDirection order (santorini.cpp:14-22), as (dx, dy)
_REF_DIRS = ((-1, -1), (0, -1), (1, -1), (-1, 0), (1, 0), (-1, 1), (0, 1), (1, 1))


def tables():
    """(from, to, build, place_a, place_b) in the reference's id order;
    ``to`` and ``build`` are -1 off the board."""
    frm = np.zeros(1600, np.int64)
    to = np.full(1600, -1, np.int64)
    build = np.full(1600, -1, np.int64)
    for a in range(1600):
        f, mdir, bdir = a // 64, (a % 64) // 8, a % 8
        fx, fy = f % _N, f // _N
        tx, ty = fx + _REF_DIRS[mdir][0], fy + _REF_DIRS[mdir][1]
        frm[a] = f
        if 0 <= tx < _N and 0 <= ty < _N:
            to[a] = tx + _N * ty
            bx, by = tx + _REF_DIRS[bdir][0], ty + _REF_DIRS[bdir][1]
            if 0 <= bx < _N and 0 <= by < _N:
                build[a] = bx + _N * by
    # placement id z in 1..300 decodes to the pair (x < y)
    pa = np.zeros(300, np.int64)
    pb = np.zeros(300, np.int64)
    for z in range(1, 301):
        x = int(np.ceil((47.0 - np.sqrt(2401 - 8 * z)) / 2))
        pa[z - 1], pb[z - 1] = x, z - ((47 - x) * x // 2 + x) + x
    return frm, to, build, pa, pb


@dataclass
class SantoriniState:
    """Batched Santorini state; every field leads with the batch dimension."""

    levels: torch.Tensor  # i8[B, 25]: building level 0..4 (4 = dome)
    pieces: torch.Tensor  # i32[B, 2, 2]: worker squares per player (-1 unplaced)
    turn: torch.Tensor  # i8[B]
    num_moves: torch.Tensor  # i32[B]
    hist_levels: torch.Tensor  # i8[B, 8, 25]
    hist_pieces: torch.Tensor  # i8[B, 8, 25]: 0 none / 1 / 2


class SantoriniEnv(Env):
    spec = EnvSpec(
        name="santorini",
        num_players=2,
        board_size=_N,
        action_size=1900,
        num_input_channels=50,
        input_height=_N,
        input_width=_N,
        hidden_height=_N,
        hidden_width=_N,
        max_game_length=128,
    )

    def __init__(self):
        frm, to, build, pa, pb = tables()
        self._np = {"from": frm, "to": to, "build": build, "place_a": pa, "place_b": pb}

    def num_rotations(self) -> int:
        return 1

    def init(self, batch_size: int, device=None) -> SantoriniState:
        dev = resolve_device(device)
        return SantoriniState(
            levels=torch.zeros((batch_size, _NN), dtype=torch.int8, device=dev),
            pieces=torch.full((batch_size, 2, 2), -1, dtype=torch.int32, device=dev),
            turn=torch.ones((batch_size,), dtype=torch.int8, device=dev),
            num_moves=torch.zeros((batch_size,), dtype=torch.int32, device=dev),
            hist_levels=torch.zeros((batch_size, _HISTORY, _NN), dtype=torch.int8, device=dev),
            hist_pieces=torch.zeros((batch_size, _HISTORY, _NN), dtype=torch.int8, device=dev))

    # ------------------------------------------------------------ primitives
    @staticmethod
    def _piece_plane(pieces: torch.Tensor) -> torch.Tensor:
        """i8[B, 25]: 0 none, 1 a P1 worker, 2 a P2 worker (unplaced
        workers write to a spare 26th square, dropped)."""
        b = pieces.shape[0]
        flat = pieces.reshape(b, 4).long()
        idx = torch.where(flat >= 0, flat, _NN)
        owner = torch.tensor([1, 1, 2, 2], dtype=torch.int8, device=pieces.device)
        plane = torch.zeros((b, _NN + 1), dtype=torch.int8, device=pieces.device)
        for j in range(4):  # P1's workers first, as the JAX env writes them
            plane[torch.arange(b, device=pieces.device), idx[:, j]] = owner[j]
        return plane[:, :_NN]

    # -------------------------------------------------------------- protocol
    def legal_mask(self, state: SantoriniState) -> torch.Tensor:
        tb = self._tables(state.levels.device)
        turn = state.turn[:, None]
        p = state.turn.long() - 1
        rows = torch.arange(p.shape[0], device=p.device)
        occupancy = self._piece_plane(state.pieces)  # i8[B, 25]
        levels = state.levels
        placement = ~(state.pieces[rows, p] >= 0).all(-1)[:, None]  # [B, 1]
        # placement: both squares free of the opponent's workers
        # (santorini.cpp isLegalAction; own workers are unplaced then)
        opp_occ = occupancy == (3 - turn)
        place_ok = ~opp_occ[:, tb["place_a"]] & ~opp_occ[:, tb["place_b"]] & placement
        # move and build
        frm, to, build = tb["from"], tb["to"], tb["build"]
        to_c, b_c = to.clamp(min=0), build.clamp(min=0)
        own_from = occupancy[:, frm] == turn
        climb_ok = levels[:, to_c].long() <= levels[:, frm].long() + 1
        move_ok = own_from & (to >= 0) & climb_ok & (occupancy[:, to_c] == 0)
        # the square left is free, the landing square is not
        b_free = ((occupancy[:, b_c] == 0) | (build == frm)) & (build != to)
        build_ok = (build >= 0) & (levels[:, b_c] <= 3) & b_free
        return torch.cat([move_ok & build_ok & ~placement, place_ok], dim=1)

    def step(self, state: SantoriniState, action: torch.Tensor) -> SantoriniState:
        tb = self._tables(state.levels.device)
        a_all = action.long()
        b = a_all.shape[0]
        rows = torch.arange(b, device=a_all.device)
        p = state.turn.long() - 1
        is_place = a_all >= 1600
        za = (a_all - 1600).clamp(0, 299)
        a = a_all.clamp(0, 1599)
        placed = state.pieces.clone()
        placed[rows, p, 0] = tb["place_a"][za].to(torch.int32)
        placed[rows, p, 1] = tb["place_b"][za].to(torch.int32)
        frm, to, build = tb["from"][a], tb["to"][a], tb["build"][a]
        which = torch.where(state.pieces[rows, p, 0] == frm, 0, 1)
        moved = state.pieces.clone()
        moved[rows, p, which] = to.to(torch.int32)
        built = state.levels.clone()
        built[rows, build.clamp(0, _NN - 1)] += (~is_place).to(torch.int8)
        pieces = torch.where(is_place[:, None, None], placed, moved)
        levels = torch.where(is_place[:, None], state.levels, built)
        plane = self._piece_plane(pieces)
        return SantoriniState(
            levels=levels, pieces=pieces, turn=(3 - state.turn).to(torch.int8),
            num_moves=state.num_moves + 1,
            hist_levels=torch.cat([levels[:, None], state.hist_levels[:, :-1]], dim=1),
            hist_pieces=torch.cat([plane[:, None], state.hist_pieces[:, :-1]], dim=1))

    def _check_win(self, state: SantoriniState, p: int) -> torch.Tensor:
        """bool[B]: a worker of player index ``p`` on level 3 (board.cpp
        checkWin)."""
        pos = state.pieces[:, p].long()
        lv = state.levels.gather(1, pos.clamp(0, _NN - 1))
        return ((pos >= 0) & (lv == 3)).any(-1)

    def is_terminal(self, state: SantoriniState) -> torch.Tensor:
        all_placed = (state.pieces >= 0).reshape(-1, 4).all(-1)
        won = self._check_win(state, 0) | self._check_win(state, 1)
        stuck = ~self.legal_mask(state).any(-1)
        return all_placed & (won | stuck)

    def eval_score(self, state: SantoriniState) -> torch.Tensor:
        """The winner by level 3, else the stuck player's opponent
        (santorini.cpp getEvalScore); 0 while the game runs."""
        w1, w2 = self._check_win(state, 0), self._check_win(state, 1)
        stuck_score = torch.where(state.turn == 1, -1.0, 1.0)
        score = torch.where(w1, 1.0, torch.where(w2, -1.0, stuck_score))
        return torch.where(self.is_terminal(state), score, 0.0).to(torch.float32)

    def turn(self, state: SantoriniState) -> torch.Tensor:
        return state.turn

    def features(self, state: SantoriniState) -> torch.Tensor:
        """50 planes, ``[B, H, W, C]`` (santorini.cpp getFeatures)."""
        b = state.levels.shape[0]
        turn = state.turn[:, None, None]
        avail = (state.num_moves + 1).clamp(max=_HISTORY)
        valid = (torch.arange(_HISTORY, device=turn.device)[None, :] < avail[:, None])[..., None]
        hp, hl = state.hist_pieces, state.hist_levels
        per_hist = [(hp == turn) & valid, (hp == 3 - turn) & valid]
        per_hist += [(hl == lv) & valid for lv in range(1, 5)]
        planes = torch.stack(per_hist, dim=2).to(torch.float32).reshape(b, 48, _NN)
        p1 = (state.turn == 1).to(torch.float32)[:, None, None].expand(b, 1, _NN)
        p2 = (state.turn == 2).to(torch.float32)[:, None, None].expand(b, 1, _NN)
        feats = torch.cat([planes, p1, p2], dim=1)
        return feats.reshape(b, 50, _N, _N).permute(0, 2, 3, 1).contiguous()

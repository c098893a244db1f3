"""ConHex, batched over games (port of ``minizero_tpu/envs/conhex.py``).

Reference: ``minizero/environment/conhex/{conhex,conhex_graph,
conhex_graph_cell}.cpp``. Stones go on the 81 holes of a 9x9 grid, 12 of
them permanently invalid (``conhex.cpp:15-26``). The 41 cells around the
holes (16 outer of 3 holes, 24 inner of 6, the centre of 5) belong to the
FIRST player to hold 2 (outer) or 3 (inner, centre) of their holes. Cells
sharing a hole that belongs to exactly 3 cells are adjacent; Player 1
connects top and bottom, Player 2 left and right, through owned cells and
the players' virtual border nodes. Swap rule: move 1 may repeat move 0,
which replaces it with White's stone reflected over the anti-diagonal
(``conhex.cpp:43-60``). Features: own and opponent stones, own and opponent
cells (cell ids in the first 41 entries of the plane), turn planes.

Connectivity is a transitive closure over the 45 graph nodes by 6 rounds of
boolean matrix squaring (2^6 > 45), as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from minizero_tpu_torch import resolve_device
from minizero_tpu_torch.envs.base import Env, EnvSpec

_N = 9
_NN = 81
_INVALID = (10, 16, 20, 24, 30, 32, 48, 50, 56, 60, 64, 70)

# (holes, edge flags) in cell-id order (conhex_graph.cpp initGraph)
_T, _R, _L, _B = 1, 2, 4, 8
_CELLS = (
    ((0, 1, 9), _T | _L), ((1, 2, 3), _T), ((3, 4, 5), _T), ((5, 6, 7), _T),
    ((7, 8, 17), _T | _R), ((17, 26, 35), _R), ((35, 44, 53), _R), ((53, 62, 71), _R),
    ((71, 79, 80), _R | _B), ((77, 78, 79), _B), ((75, 76, 77), _B), ((73, 74, 75), _B),
    ((63, 72, 73), _B | _L), ((45, 54, 63), _L), ((27, 36, 45), _L), ((9, 18, 27), _L),
    ((1, 2, 9, 11, 18, 19), 0), ((2, 3, 4, 11, 12, 13), 0), ((4, 5, 6, 13, 14, 15), 0),
    ((6, 7, 15, 17, 25, 26), 0), ((25, 26, 34, 35, 43, 44), 0),
    ((43, 44, 52, 53, 61, 62), 0), ((61, 62, 69, 71, 78, 79), 0),
    ((67, 68, 69, 76, 77, 78), 0), ((65, 66, 67, 74, 75, 76), 0),
    ((54, 55, 63, 65, 73, 74), 0), ((36, 37, 45, 46, 54, 55), 0),
    ((18, 19, 27, 28, 36, 37), 0), ((11, 12, 19, 21, 28, 29), 0),
    ((12, 13, 14, 21, 22, 23), 0), ((14, 15, 23, 25, 33, 34), 0),
    ((33, 34, 42, 43, 51, 52), 0), ((51, 52, 59, 61, 68, 69), 0),
    ((57, 58, 59, 66, 67, 68), 0), ((46, 47, 55, 57, 65, 66), 0),
    ((28, 29, 37, 38, 46, 47), 0), ((21, 22, 29, 31, 38, 39), 0),
    ((22, 23, 31, 33, 41, 42), 0), ((41, 42, 49, 51, 58, 59), 0),
    ((38, 39, 47, 49, 57, 58), 0), ((31, 39, 40, 41, 49), 0),
)
_NC = len(_CELLS)  # 41
_TOP, _LEFT, _RIGHT, _BOTTOM = _NC, _NC + 1, _NC + 2, _NC + 3
_NG = _NC + 4  # graph nodes


def graph_tables():
    """(invalid bool[81], member f32[41, 81], threshold i32[41], adjacency
    bool[2, 45, 45] of Player 1's and Player 2's graphs)."""
    invalid = np.zeros(_NN, bool)
    invalid[list(_INVALID)] = True
    member = np.zeros((_NC, _NN), np.float32)
    threshold = np.zeros(_NC, np.int32)
    hole_cells = [[] for _ in range(_NN)]
    for cid, (holes, _) in enumerate(_CELLS):
        member[cid, list(holes)] = 1.0
        threshold[cid] = 2 if len(holes) == 3 else 3
        for h in holes:
            hole_cells[h].append(cid)
    adj = np.zeros((_NG, _NG), bool)
    for cells in hole_cells:
        if len(cells) == 3:
            for a in cells:
                for b in cells:
                    adj[a, b] = a != b
    adj1, adj2 = adj.copy(), adj.copy()
    for cid, (_, flag) in enumerate(_CELLS):
        for bit, node, m in ((_T, _TOP, adj1), (_B, _BOTTOM, adj1), (_L, _LEFT, adj2),
                             (_R, _RIGHT, adj2)):
            if flag & bit:
                m[cid, node] = m[node, cid] = True
    return invalid, member, threshold, np.stack([adj1, adj2])


@dataclass
class ConHexState:
    """Batched ConHex state; every field leads with the batch dimension."""

    holes: torch.Tensor  # i8[B, 81]
    cell_owner: torch.Tensor  # i8[B, 41], the first capturer
    turn: torch.Tensor  # i8[B]
    num_moves: torch.Tensor  # i32[B]
    winner: torch.Tensor  # i8[B]
    first_action: torch.Tensor  # i32[B]


class ConHexEnv(Env):
    spec = EnvSpec(
        name="conhex",
        num_players=2,
        board_size=_N,
        action_size=_NN,
        num_input_channels=6,
        input_height=_N,
        input_width=_N,
        hidden_height=_N,
        hidden_width=_N,
        max_game_length=_NN,
    )

    def __init__(self, use_swap_rule: bool = True):
        self.use_swap = use_swap_rule
        invalid, member, threshold, adj = graph_tables()
        self._np = {"invalid": invalid, "member": member, "threshold": threshold, "adj": adj,
                    "eye": np.eye(_NG, dtype=bool)}

    def num_rotations(self) -> int:
        return 1

    def init(self, batch_size: int, device=None) -> ConHexState:
        dev = resolve_device(device)
        return ConHexState(
            holes=torch.zeros((batch_size, _NN), dtype=torch.int8, device=dev),
            cell_owner=torch.zeros((batch_size, _NC), dtype=torch.int8, device=dev),
            turn=torch.ones((batch_size,), dtype=torch.int8, device=dev),
            num_moves=torch.zeros((batch_size,), dtype=torch.int32, device=dev),
            winner=torch.zeros((batch_size,), dtype=torch.int8, device=dev),
            first_action=torch.full((batch_size,), -1, dtype=torch.int32, device=dev),
        )

    def legal_mask(self, state: ConHexState) -> torch.Tensor:
        valid = ~self._tables(state.holes.device)["invalid"]
        empty = (state.holes == 0) & valid
        if self.use_swap:
            return torch.where((state.num_moves == 1)[:, None], valid, empty)
        return empty

    def _connected(self, cell_owner: torch.Tensor, player: torch.Tensor) -> torch.Tensor:
        """bool[B]: ``player``'s borders are joined through its cells."""
        tb = self._tables(cell_owner.device)
        b = cell_owner.shape[0]
        owned = torch.cat([cell_owner == player[:, None],
                           torch.ones((b, 4), dtype=torch.bool, device=cell_owner.device)], 1)
        adj = tb["adj"][(player.long() - 1).clamp(0, 1)]             # [B, 45, 45]
        m = (adj & owned[:, None, :] & owned[:, :, None]) | tb["eye"]
        m = m.to(torch.float32)
        for _ in range(6):
            m = (torch.bmm(m, m) > 0).to(torch.float32)
        src = torch.where(player == 1, _TOP, _LEFT).long()
        dst = torch.where(player == 1, _BOTTOM, _RIGHT).long()
        rows = torch.arange(b, device=cell_owner.device)
        return m[rows, src, dst] > 0

    def step(self, state: ConHexState, action: torch.Tensor) -> ConHexState:
        tb = self._tables(state.holes.device)
        player = state.turn
        a = action.long()
        rows = torch.arange(a.shape[0], device=a.device)
        is_swap = (state.num_moves == 1) & (action.to(torch.int32) == state.first_action)
        if not self.use_swap:
            is_swap = torch.zeros_like(is_swap)
        # the swap's reflection over the anti-diagonal (conhex.cpp:49-54)
        r, c = a // _N, a % _N
        eff = torch.where(is_swap, (_N - 1 - c) * _N + (_N - 1 - r), a)
        holes = torch.where(is_swap[:, None], 0, state.holes).to(torch.int8)
        cell_owner = torch.where(is_swap[:, None], 0, state.cell_owner).to(torch.int8)
        holes[rows, eff] = player
        counts = (holes == player[:, None]).to(torch.float32) @ tb["member"].T
        newly = (cell_owner == 0) & (counts.to(torch.int32) >= tb["threshold"])
        cell_owner = torch.where(newly, player[:, None], cell_owner).to(torch.int8)
        win = self._connected(cell_owner, player)
        winner = torch.where(state.winner != 0, state.winner, torch.where(win, player, 0))
        return ConHexState(
            holes=holes,
            cell_owner=cell_owner,
            turn=(3 - player).to(torch.int8),
            num_moves=state.num_moves + 1,
            winner=winner.to(torch.int8),
            first_action=torch.where(state.num_moves == 0, action.to(torch.int32),
                                     state.first_action),
        )

    def is_terminal(self, state: ConHexState) -> torch.Tensor:
        valid = ~self._tables(state.holes.device)["invalid"]
        full = ~((state.holes == 0) & valid).any(1)
        return (state.winner != 0) | full

    def eval_score(self, state: ConHexState) -> torch.Tensor:
        w = state.winner
        return torch.where(w == 1, 1.0, torch.where(w == 2, -1.0, 0.0)).to(torch.float32)

    def turn(self, state: ConHexState) -> torch.Tensor:
        return state.turn

    def features(self, state: ConHexState) -> torch.Tensor:
        """6 planes, ``[B, 9, 9, 6]`` (conhex.cpp getFeatures)."""
        b = state.holes.shape[0]
        turn = state.turn[:, None]
        opp = 3 - turn
        pad = torch.zeros((b, _NN - _NC), dtype=torch.bool, device=state.holes.device)
        feats = torch.stack([
            state.holes == turn, state.holes == opp,
            torch.cat([state.cell_owner == turn, pad], 1), torch.cat([state.cell_owner == opp, pad], 1),
            (turn == 1).expand(b, _NN), (turn == 2).expand(b, _NN)], dim=-1)
        return feats.to(torch.float32).reshape(b, _N, _N, 6)

"""Go, batched over games (port of ``minizero_tpu/envs/go.py``).

Reference: ``minizero/environment/go/go.{h,cpp}``. The state carries
per-position block labels and liberty counts, updated incrementally by
``step`` (merge = relabel the members of the <= 4 neighbouring own blocks;
capture = clear whole labelled blocks), plus an additive dual Zobrist hash
for positional superko. Every function works on a batch of games at once.

The JAX package phrases the per-block aggregates as one-hot ``[NN, NN]``
reductions and bf16 matmuls for the TPU's matrix unit; here they are integer
gathers and ``scatter_add`` over the <= 4 neighbours of each point, with
int64 sums wrapped to int32 — the same mod-2^32 hashes, bit for bit.

Semantics preserved (file:line of the reference):
  * legality: empty point with an empty neighbour, a >1-liberty own neighbour
    block, or a capturable (1-liberty) opponent neighbour block, and no
    superko repetition of the resulting hash (``go.cpp:208-243``)
  * terminal: two consecutive passes or more than 2*N*N moves
    (``go.cpp:246-257``)
  * scoring: Tromp-Taylor territory vs komi; win -> +/-1 (``go.cpp:259-277``,
    ``go.cpp:703-723``), including the reference's convention that a
    no-boundary empty region counts for Black
  * features: 18 planes = 8 x (own, opponent) history + 2 turn planes
    (``go.cpp:280-307``)
"""

from __future__ import annotations

from dataclasses import dataclass

import math

import numpy as np
import torch

from minizero_tpu_torch import resolve_device
from minizero_tpu_torch.envs.base import Env, EnvSpec

_HISTORY_PLANES = 8


@dataclass
class GoState:
    """Batched Go state; every field leads with the batch dimension."""

    board: torch.Tensor  # i8[B, NN] 0 empty / 1 black / 2 white
    turn: torch.Tensor  # i8[B]
    num_moves: torch.Tensor  # i32[B]
    consecutive_pass: torch.Tensor  # i8[B]
    hash_a: torch.Tensor  # i32[B] (bit pattern of the mod-2^32 additive hash)
    hash_b: torch.Tensor  # i32[B]
    history_a: torch.Tensor  # i32[B, MAXH] post-move hashes (superko table)
    history_b: torch.Tensor  # i32[B, MAXH]
    legal: torch.Tensor  # bool[B, NN + 1] cached mask for player `turn`
    labels: torch.Tensor  # i32[B, NN] block label per stone (NN for empty)
    lib_at: torch.Tensor  # i32[B, NN] liberties of the stone's block (0 empty)
    board_history: torch.Tensor  # i8[B, 8, NN] ring: [:, 0] = current board


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 with mod-2^32 wraparound (the additive Zobrist
    arithmetic, ``go.cpp:19-71``)."""
    return (torch.remainder(x + 2 ** 31, 2 ** 32) - 2 ** 31).to(torch.int32)


class GoEnv(Env):
    def __init__(self, board_size: int = 9, komi: float = 7.5, ko_rule: str = "positional"):
        nn = board_size * board_size
        self.n = board_size
        self.nn = nn
        self.komi = float(komi)
        self.situational = ko_rule == "situational"
        self.max_moves = 2 * nn + 1
        self.cc_rounds = int(math.ceil(math.log2(max(nn, 2)))) + 4
        self.spec = EnvSpec(
            name=f"go_{board_size}x{board_size}",
            num_players=2,
            board_size=board_size,
            action_size=nn + 1,
            num_input_channels=18,
            input_height=board_size,
            input_width=board_size,
            hidden_height=board_size,
            hidden_width=board_size,
            max_game_length=self.max_moves,
            has_pass=True,
        )
        # neighbour index table [NN, 4] (self-padded at borders) + validity
        nbr = np.tile(np.arange(nn)[:, None], (1, 4))
        valid = np.zeros((nn, 4), bool)
        for p in range(nn):
            r, c = divmod(p, board_size)
            for j, (dr, dc) in enumerate(((1, 0), (-1, 0), (0, 1), (0, -1))):
                rr, cc = r + dr, c + dc
                if 0 <= rr < board_size and 0 <= cc < board_size:
                    nbr[p, j] = rr * board_size + cc
                    valid[p, j] = True
        # the JAX package's Zobrist draws, bit for bit (the same seed and
        # sequence of draws; int32 bit patterns held as int64 for summing)
        rs = np.random.RandomState(20260817)
        key_a = rs.randint(0, 2**32, size=(nn, 2), dtype=np.uint64).astype(np.uint32)
        key_b = rs.randint(0, 2**32, size=(nn, 2), dtype=np.uint64).astype(np.uint32)
        turn_keys = rs.randint(0, 2**32, size=(2,), dtype=np.uint64).astype(np.uint32).view(np.int32)
        self._np_tables = {
            "nbr": nbr.astype(np.int64),
            "nbr_valid": valid,
            "key_a": key_a.view(np.int32).astype(np.int64),
            "key_b": key_b.view(np.int32).astype(np.int64),
        }
        self._turn_key_a = int(turn_keys[0]) if self.situational else 0
        self._turn_key_b = int(turn_keys[1]) if self.situational else 0
        self._tables_by_device = {}

    def _tables(self, device: torch.device):
        key = str(device)
        if key not in self._tables_by_device:
            self._tables_by_device[key] = {
                k: torch.as_tensor(v, device=device) for k, v in self._np_tables.items()}
        return self._tables_by_device[key]

    # ------------------------------------------------------------ primitives
    def _adj_or(self, x: torch.Tensor) -> torch.Tensor:
        """Neighbour-OR over the board axis: bool[..., NN] -> bool[..., NN]
        true where any 4-neighbour is true."""
        n = self.n
        g = x.reshape(x.shape[:-1] + (n, n))
        out = torch.zeros_like(g)
        out[..., :-1, :] |= g[..., 1:, :]
        out[..., 1:, :] |= g[..., :-1, :]
        out[..., :, :-1] |= g[..., :, 1:]
        out[..., :, 1:] |= g[..., :, :-1]
        return out.reshape(x.shape)

    def _cc_labels(self, active: torch.Tensor, connected: torch.Tensor) -> torch.Tensor:
        """i32[B, NN] connected-component labels (the least member index; NN
        outside ``active``). ``connected``: bool[B, NN, 4] edge mask. The JAX
        package's fixed ``cc_rounds`` rounds of min-propagation, each with a
        pointer jump, so that the labels equal its labels."""
        nn = self.nn
        nb = self._tables(active.device)["nbr"]
        idx = torch.arange(nn, device=active.device)
        labels = torch.where(active, idx, nn)
        for _ in range(self.cc_rounds):
            nbr_lab = torch.where(connected, labels[:, nb], nn)
            lab = torch.minimum(labels, nbr_lab.amin(-1))
            lab = torch.minimum(lab, torch.gather(lab, 1, lab.clamp(0, nn - 1)))  # pointer jump
            labels = torch.where(active, lab, nn)
        return labels.to(torch.int32)

    @staticmethod
    def _first_of_label(mask: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        """bool[B, P, 4]: neighbour slot j is set in ``mask`` and no earlier
        slot k < j that is set carries the same block label — so each block
        adjacent to a point is counted once."""
        keep = mask.clone()
        for j in range(1, 4):
            for k in range(j):
                keep[..., j] &= ~(mask[..., k] & (labels[..., k] == labels[..., j]))
        return keep

    def _block_aggregates(self, board: torch.Tensor, labels: torch.Tensor):
        """(lib_at i32[B, NN], block_keys int64[B, NN + 1, 2]): liberties of
        each stone's block, and per-block Zobrist key sums (mod 2^32)."""
        nn = self.nn
        tb = self._tables(board.device)
        bsz = board.shape[0]
        occupied = board > 0
        empty = board == 0
        lab = labels.long()
        nb = tb["nbr"]
        # liberties: every empty point adds 1 to each distinct block around it
        n_lab = lab[:, nb]  # [B, NN, 4]
        n_occ = occupied[:, nb] & tb["nbr_valid"]
        first = self._first_of_label(n_occ, n_lab) & empty[:, :, None]
        lib_count = torch.zeros((bsz, nn + 1), dtype=torch.int64, device=board.device)
        lib_count.scatter_add_(1, torch.where(first, n_lab, nn).reshape(bsz, -1),
                               first.reshape(bsz, -1).long())
        lib_at = torch.where(occupied, torch.gather(lib_count, 1, lab.clamp(max=nn)), 0)
        # per-block key sums at each stone's colour
        is_black = board == 1
        cell_a = torch.where(is_black, tb["key_a"][:, 0], tb["key_a"][:, 1])
        cell_b = torch.where(is_black, tb["key_b"][:, 0], tb["key_b"][:, 1])
        idx = torch.where(occupied, lab, nn)
        bk = torch.zeros((bsz, nn + 1, 2), dtype=torch.int64, device=board.device)
        bk[:, :, 0].scatter_add_(1, idx, cell_a)
        bk[:, :, 1].scatter_add_(1, idx, cell_b)
        return lib_at.to(torch.int32), bk

    def _legal_mask_for(self, board, labels, lib_at, block_keys, turn,
                        hash_a, hash_b, history_a, history_b, num_moves):
        """bool[B, NN + 1] legality for ``turn`` (reference go.cpp:208-243)."""
        nn = self.nn
        tb = self._tables(board.device)
        empty = board == 0
        turn_c = turn[:, None]
        opp_c = (3 - turn).to(board.dtype)[:, None]
        nbr_empty = self._adj_or(empty)
        own_safe = self._adj_or((board == turn_c) & (lib_at > 1))
        capturable = (board == opp_c) & (lib_at == 1)
        has_capture = self._adj_or(capturable)
        legal_basic = empty & (nbr_empty | own_safe | has_capture)

        # superko: candidate hash = hash + turn key + stone key - the key sums
        # of the distinct capturable blocks adjacent to the point
        nb = tb["nbr"]
        lab = labels.long()
        n_lab = lab[:, nb]  # [B, NN, 4]
        first = self._first_of_label(capturable[:, nb] & tb["nbr_valid"], n_lab)
        safe = n_lab.clamp(max=nn)
        cap_a = torch.where(first, torch.gather(block_keys[:, :, 0], 1, safe.reshape(len(board), -1))
                            .reshape(n_lab.shape), 0).sum(-1)
        cap_b = torch.where(first, torch.gather(block_keys[:, :, 1], 1, safe.reshape(len(board), -1))
                            .reshape(n_lab.shape), 0).sum(-1)
        black = (turn == 1)[:, None]
        stone_a = torch.where(black, tb["key_a"][:, 0], tb["key_a"][:, 1])
        stone_b = torch.where(black, tb["key_b"][:, 0], tb["key_b"][:, 1])
        new_a = _wrap32(hash_a.long()[:, None] + self._turn_key_a + stone_a - cap_a)
        new_b = _wrap32(hash_b.long()[:, None] + self._turn_key_b + stone_b - cap_b)
        valid_h = (torch.arange(history_a.shape[1], device=board.device)[None, :]
                   < num_moves[:, None])  # [B, MAXH]
        repeat = ((history_a[:, None, :] == new_a[:, :, None])
                  & (history_b[:, None, :] == new_b[:, :, None])
                  & valid_h[:, None, :]).any(-1)
        board_legal = legal_basic & ~repeat
        return torch.cat([board_legal, torch.ones_like(board_legal[:, :1])], dim=1)

    # -------------------------------------------------------------- protocol
    def init(self, batch_size: int, device=None) -> GoState:
        nn = self.nn
        dev = resolve_device(device)

        def z(*shape, dtype):
            return torch.zeros((batch_size,) + shape, dtype=dtype, device=dev)

        return GoState(
            board=z(nn, dtype=torch.int8),
            turn=torch.ones((batch_size,), dtype=torch.int8, device=dev),
            num_moves=z(dtype=torch.int32),
            consecutive_pass=z(dtype=torch.int8),
            hash_a=z(dtype=torch.int32),
            hash_b=z(dtype=torch.int32),
            history_a=z(self.max_moves + 1, dtype=torch.int32),
            history_b=z(self.max_moves + 1, dtype=torch.int32),
            legal=torch.ones((batch_size, nn + 1), dtype=torch.bool, device=dev),
            labels=torch.full((batch_size, nn), nn, dtype=torch.int32, device=dev),
            lib_at=z(nn, dtype=torch.int32),
            board_history=z(_HISTORY_PLANES, nn, dtype=torch.int8),
        )

    def step(self, state: GoState, action: torch.Tensor) -> GoState:
        """Apply one action per game (reference GoEnv::act, go.cpp:132-190)
        with incremental label maintenance — no propagation loop."""
        nn = self.nn
        tb = self._tables(state.board.device)
        board, labels = state.board, state.labels
        action = action.long()
        is_pass = action >= nn
        pos = action.clamp(0, nn - 1)
        turn = state.turn
        opp = (3 - turn).to(board.dtype)
        iota = torch.arange(nn, device=board.device)
        pos_mask = iota[None, :] == pos[:, None]
        play = ~is_pass[:, None]

        # the <= 4 neighbours of the played point
        nb = tb["nbr"][pos]  # [B, 4]
        nvalid = tb["nbr_valid"][pos] & play
        nb_board = torch.gather(board, 1, nb)
        nb_lab = torch.gather(labels, 1, nb)
        nb_lib = torch.gather(state.lib_at, 1, nb)
        occupied = board > 0

        # captured blocks: opponent neighbour blocks with 1 liberty
        cap_q = nvalid & (nb_board == opp[:, None]) & (nb_lib == 1)
        cap_lab = torch.where(cap_q, nb_lab, -1)
        captured = occupied & (labels[:, :, None] == cap_lab[:, None, :]).any(-1)

        new_board = torch.where(captured, torch.zeros_like(board), board)
        new_board = torch.where(pos_mask & play, turn[:, None].to(board.dtype), new_board)

        # merge own neighbour blocks with the new stone (min label), clear
        # captured blocks
        own_q = nvalid & (nb_board == turn[:, None])
        own_lab = torch.where(own_q, nb_lab, -1)
        merged = torch.minimum(torch.where(own_q, nb_lab, nn).amin(-1), pos.to(torch.int32))
        member_merged = occupied & (labels[:, :, None] == own_lab[:, None, :]).any(-1)
        merged_c = merged[:, None].to(labels.dtype)
        new_labels = torch.where(captured, torch.full_like(labels, nn), labels)
        new_labels = torch.where(member_merged & ~captured, merged_c, new_labels)
        new_labels = torch.where(pos_mask, merged_c, new_labels)
        new_labels = torch.where(is_pass[:, None], labels, new_labels)

        # additive hash update (go.cpp:141-155, 168-175)
        opp_black = (opp == 1)[:, None]
        cell_opp_a = torch.where(opp_black, tb["key_a"][:, 0], tb["key_a"][:, 1])
        cell_opp_b = torch.where(opp_black, tb["key_b"][:, 0], tb["key_b"][:, 1])
        cap_key_a = torch.where(captured, cell_opp_a, 0).sum(-1)
        cap_key_b = torch.where(captured, cell_opp_b, 0).sum(-1)
        black = (turn == 1)[:, None]
        played = pos_mask & play
        stone_a = torch.where(played, torch.where(black, tb["key_a"][:, 0], tb["key_a"][:, 1]), 0).sum(-1)
        stone_b = torch.where(played, torch.where(black, tb["key_b"][:, 0], tb["key_b"][:, 1]), 0).sum(-1)
        new_hash_a = _wrap32(state.hash_a.long() + self._turn_key_a + stone_a - cap_key_a)
        new_hash_b = _wrap32(state.hash_b.long() + self._turn_key_b + stone_b - cap_key_b)

        hist_idx = state.num_moves.long().clamp(0, self.max_moves)[:, None]
        history_a = state.history_a.scatter(1, hist_idx, new_hash_a[:, None])
        history_b = state.history_b.scatter(1, hist_idx, new_hash_b[:, None])

        num_moves = state.num_moves + 1
        consecutive_pass = torch.where(is_pass, state.consecutive_pass + 1,
                                       torch.zeros_like(state.consecutive_pass))
        board_history = torch.cat([new_board[:, None], state.board_history[:, :-1]], dim=1)

        new_lib_at, block_keys = self._block_aggregates(new_board, new_labels)
        legal = self._legal_mask_for(
            new_board, new_labels, new_lib_at, block_keys, opp,
            new_hash_a, new_hash_b, history_a, history_b, num_moves)
        return GoState(
            board=new_board,
            turn=opp,
            num_moves=num_moves,
            consecutive_pass=consecutive_pass,
            hash_a=new_hash_a,
            hash_b=new_hash_b,
            history_a=history_a,
            history_b=history_b,
            legal=legal,
            labels=new_labels,
            lib_at=new_lib_at,
            board_history=board_history,
        )

    def legal_mask(self, state: GoState) -> torch.Tensor:
        return state.legal

    def is_terminal(self, state: GoState) -> torch.Tensor:
        return (state.consecutive_pass >= 2) | (state.num_moves > 2 * self.nn)

    def _flood_empty(self, src: torch.Tensor, empty: torch.Tensor) -> torch.Tensor:
        """Empty cells connected (through empty cells) to ``src`` cells,
        propagated to the fixed point."""
        reach = empty & self._adj_or(src)
        while True:
            nxt = reach | (empty & self._adj_or(reach))
            if torch.equal(nxt, reach):
                return reach
            reach = nxt

    def eval_score(self, state: GoState) -> torch.Tensor:
        return self._score_board(state.board)

    def _score_board(self, board: torch.Tensor) -> torch.Tensor:
        """Tromp-Taylor result (reference go.cpp:259-277, 703-723): an empty
        region counts for a colour iff it reaches only that colour."""
        empty = board == 0
        reach_b = self._flood_empty(board == 1, empty)
        reach_w = self._flood_empty(board == 2, empty)
        # region with no white boundary -> black (reference check order
        # go.cpp:713-717, including the empty-board quirk)
        black_area = empty & ~reach_w
        white_area = empty & reach_w & ~reach_b
        f32 = torch.float32
        black = (board == 1).to(f32).sum(-1) + black_area.to(f32).sum(-1)
        white = (board == 2).to(f32).sum(-1) + white_area.to(f32).sum(-1) + self.komi
        one = torch.ones_like(black)
        return torch.where(black > white, one, torch.where(black < white, -one, 0.0 * one))

    def turn(self, state: GoState) -> torch.Tensor:
        return state.turn

    def features(self, state: GoState) -> torch.Tensor:
        """18 planes, [B, H, W, C] (reference go.cpp:280-307)."""
        n = self.n
        bsz = state.board.shape[0]
        turn = state.turn[:, None, None]
        opp = (3 - state.turn).to(state.board.dtype)[:, None, None]
        hist = state.board_history  # [B, 8, NN]
        own = (hist == turn).to(torch.float32)
        other = (hist == opp).to(torch.float32)
        planes = torch.stack([own, other], dim=2).reshape(bsz, 2 * _HISTORY_PLANES, self.nn)
        p1 = (state.turn == 1).to(torch.float32)[:, None, None].expand(bsz, 1, self.nn)
        p2 = (state.turn == 2).to(torch.float32)[:, None, None].expand(bsz, 1, self.nn)
        feats = torch.cat([planes, p1, p2], dim=1)  # [B, 18, NN] (CHW)
        return feats.reshape(bsz, 18, n, n).permute(0, 2, 3, 1).contiguous()

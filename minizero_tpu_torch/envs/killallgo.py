"""Kill-All Go, batched over games (port of ``minizero_tpu/envs/killallgo.py``):
a 7x7 Go variant in which Black plays two opening moves (White's first turn
is a forced pass) and White wins unless Black kills every White stone; the
game ends as soon as Benson's unconditional-life analysis settles it.

Reference: ``minizero/environment/killallgo/killallgo.{h,cpp}``: the move
staging (``killallgo.cpp:27-32``) and the Benson-based terminal test and
score (``killallgo.cpp:34-49``). Benson's algorithm (``go.cpp:614-678``) is
phrased on ``[B, L, P]`` label-by-point masks with batched products, as the
JAX package phrases it on ``[L, P]`` one-hots.

Benson's fixpoint (keep blocks with two vital regions, keep regions whose
every bordering block is kept) is the JAX package's ``while_loop`` of at most
NN rounds. Every round after the fixpoint is the identity, so the port runs
the rounds in chunks of ``BENSON_CHUNK`` and asks the card whether the last
round of a chunk changed anything: one host synchronisation per chunk, where
a check after every round would cost one per round. Both players' analyses
run as one batch, so a terminal test costs one synchronisation whenever
every game settles within ``BENSON_CHUNK - 1`` rounds (``benson_checks``
counts them).

The optional 7x7 seki table (``env_killallgo_use_seki``, default false):
``use_seki=True`` adds a lookup of every White-enclosed area in the proven
seki table to the terminal test: a seki means Black can no longer kill
everything, so the game ends for White (``killallgo.cpp:36``). The lookup is
``torch.searchsorted`` on the sorted hashes plus a scan of the window of
equal hashes (``envs/seki7x7.py``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from minizero_tpu_torch.envs.go import GoEnv, GoState

BENSON_CHUNK = 8


class KillAllGoEnv(GoEnv):
    def __init__(self, board_size: int = 7, use_seki: bool = False,
                 seki_min_size: int = 5, seki_max_size: int = 8,
                 ko_rule: str = "positional"):
        super().__init__(board_size=board_size, komi=0.0, ko_rule=ko_rule)
        self.spec = dataclasses.replace(self.spec, name=f"killallgo_{board_size}x{board_size}")
        self.use_seki = bool(use_seki)
        self.benson_checks = 0
        if self.use_seki:
            if board_size != 7:
                raise ValueError("the seki table is 7x7-only (reference kKillAllGoBoardSize)")
            from minizero_tpu_torch.envs import seki7x7

            hashes, words, window = seki7x7.sorted_device_table(
                seki7x7.ensure_table(seki_min_size, seki_max_size))
            self._np_tables.update(seki_hash=hashes, seki_words=words)
            self._seki_window = window
            self._seki_mix = [int(m) for m in seki7x7.MIX]

    # ------------------------------------------------------------------ seki
    def _seki_detected(self, state: GoState) -> torch.Tensor:
        """bool[B]: some White-enclosed area matches a proven seki pattern
        (reference SekiSearch::isSeki + lookupSekiBitboard,
        killallgo_seki_7x7.cpp:377-474). The area's (black, empty) masks are
        the key, and at most one of its surrounding White blocks may border
        other areas too."""
        nn = self.nn
        tb = self._tables(state.board.device)
        idx = torch.arange(nn, device=state.board.device)
        board = state.board
        white, black, empty = board == 2, board == 1, board == 0
        nonw = ~white
        connected = nonw[:, tb["nbr"]] & tb["nbr_valid"] & nonw[:, :, None]
        area_labels = self._cc_labels(nonw, connected)
        area_oh = (area_labels[:, None, :] == idx[:, None]) & nonw[:, None, :]  # [B, L, P]
        area_exists = area_oh.any(2)
        block_oh = (state.labels[:, None, :] == idx[:, None]) & white[:, None, :]
        reach_b = self._adj_or(block_oh)  # [B, Lb, P]
        a2b = torch.bmm(area_oh.float(), reach_b.float().transpose(1, 2)) > 0  # [B, La, Lb]
        multi = (a2b.float().sum(1) > 1).float()  # blocks bordering several areas
        surround_multi = torch.bmm(a2b.float(), multi[:, :, None])[:, :, 0]  # [B, La]
        filter_ok = area_exists & (surround_multi <= 1)

        # each area's (black, empty) masks in 4 words of 25 + 24 cells
        # (seki7x7.pack_words' layout)
        pow_lo = 1 << idx[:25]
        pow_hi = 1 << (idx[25:] - 25)

        def pack(mask):  # bool [B, L, P] -> int64 [B, L, 2]
            m = mask.long()
            return torch.stack([(m[:, :, :25] * pow_lo).sum(-1), (m[:, :, 25:] * pow_hi).sum(-1)], -1)

        words = torch.cat([pack(area_oh & black[:, None, :]), pack(area_oh & empty[:, None, :])], -1)
        h = torch.zeros_like(words[..., 0])
        for k in range(4):  # the int32 wrapping multiply, in int64 modulo 2^32
            h = h ^ ((words[..., k] * self._seki_mix[k]) & 0xFFFFFFFF)
        h = torch.where(h >= 2 ** 31, h - 2 ** 32, h).to(torch.int32)
        words = words.to(torch.int32)
        table_h, table_w = tb["seki_hash"], tb["seki_words"]
        m = table_h.shape[0]
        if m == 0:
            return torch.zeros(board.shape[:1], dtype=torch.bool, device=board.device)
        pos = torch.searchsorted(table_h, h)
        found = torch.zeros_like(filter_ok)
        for j in range(self._seki_window):
            at = (pos + j).clamp(0, m - 1)
            found |= (table_h[at] == h) & (table_w[at] == words).all(-1)
        return (found & filter_ok).any(1)

    # ----------------------------------------------------------------- benson
    def _benson_bitboard(self, board: torch.Tensor, labels: torch.Tensor,
                         player: torch.Tensor) -> torch.Tensor:
        """bool[B, NN] unconditionally alive (pass-alive) points of
        ``player`` (i8[B] or a number): stones of alive blocks and their
        vital enclosed regions (reference GoEnv::findBensonBitboard,
        go.cpp:614-678).

        Blocks are the ``labels`` of the player's stones; regions are the
        connected components of its non-stones. ``vital[a, b]``: every empty
        point of region a is a liberty of block b."""
        nn = self.nn
        tb = self._tables(board.device)
        idx = torch.arange(nn, device=board.device)
        player = torch.as_tensor(player, dtype=board.dtype, device=board.device).reshape(-1, 1)
        p_stone = board == player
        empty = board == 0
        nonp = ~p_stone
        connected = nonp[:, tb["nbr"]] & tb["nbr_valid"] & nonp[:, :, None]
        area_labels = self._cc_labels(nonp, connected)

        block_oh = (labels[:, None, :] == idx[:, None]) & p_stone[:, None, :]  # [B, L, P]
        area_oh = (area_labels[:, None, :] == idx[:, None]) & nonp[:, None, :]  # [B, L, P]
        block_exists = block_oh.any(2)
        area_exists = area_oh.any(2)
        reach = self._adj_or(block_oh)  # points next to each block
        lib = (reach & empty[:, None, :]).float()  # liberties of each block
        area_empty = (area_oh & empty[:, None, :]).float()
        empty_cnt = area_empty.sum(2)  # [B, L]
        # small counts: exact in float32 (and in TF32)
        overlap = torch.bmm(area_empty, lib.transpose(1, 2))  # [B, La, Lb]
        vital = ((overlap >= empty_cnt[:, :, None]) & (empty_cnt[:, :, None] > 0)
                 & area_exists[:, :, None] & block_exists[:, None, :])
        adj_ab = torch.bmm(area_oh.float(), reach.float().transpose(1, 2)) > 0

        alive_block = vital.any(1)
        alive_area = vital.any(2)
        # the JAX loop: at most NN rounds, stopping when a round changes
        # nothing; a round after that is the identity
        done = 0
        while done < nn:
            for _ in range(min(BENSON_CHUNK, nn - done)):
                ab2 = (vital & alive_area[:, :, None]).sum(1) >= 2
                aa2 = alive_area & ~(adj_ab & ~ab2[:, None, :]).any(2)
                changed = (ab2 != alive_block).any() | (aa2 != alive_area).any()
                alive_block, alive_area = ab2, aa2
                done += 1
            self.benson_checks += 1
            if not bool(changed):
                break
        lab_c = labels.long().clamp(0, nn - 1)
        area_c = area_labels.long().clamp(0, nn - 1)
        return ((p_stone & torch.gather(alive_block, 1, lab_c))
                | (nonp & torch.gather(alive_area, 1, area_c)))

    # ------------------------------------------------------------------ rules
    def _legal_mask_for(self, board, labels, lib_at, block_keys, turn,
                        hash_a, hash_b, history_a, history_b, num_moves):
        """Move 1 (White's first) must be a pass; moves 0 and 2 must NOT be
        a pass; otherwise plain Go legality (reference killallgo.cpp:27-32)."""
        base = super()._legal_mask_for(board, labels, lib_at, block_keys, turn,
                                       hash_a, hash_b, history_a, history_b, num_moves)
        nn = self.nn
        pass_only = num_moves == 1
        board_part = base[:, :nn] & ~pass_only[:, None]
        pass_part = torch.where(pass_only, True, (num_moves >= 3) & base[:, nn])
        return torch.cat([board_part, pass_part[:, None]], dim=1)

    def init(self, batch_size: int, device=None) -> GoState:
        state = super().init(batch_size, device=device)
        state.legal[:, self.nn] = False  # move 0: no pass
        return state

    def is_terminal(self, state: GoState) -> torch.Tensor:
        """Terminal when every point is Black-pass-alive, any point is
        White-pass-alive, or by plain Go termination (killallgo.cpp:35-41)."""
        b = state.board.shape[0]
        players = torch.cat([torch.ones_like(state.turn), torch.full_like(state.turn, 2)])
        benson = self._benson_bitboard(torch.cat([state.board, state.board]),
                                       torch.cat([state.labels, state.labels]), players)
        terminal = (benson[:b].sum(1) == self.nn) | benson[b:].any(1) | super().is_terminal(state)
        if self.use_seki:
            terminal = terminal | self._seki_detected(state)  # White survives (killallgo.cpp:36)
        return terminal

    def eval_score(self, state: GoState) -> torch.Tensor:
        """Black wins iff White has no stones or Black is pass-alive
        everywhere (killallgo.cpp:43-49)."""
        benson_b = self._benson_bitboard(state.board, state.labels, 1)
        no_white = ~(state.board == 2).any(1)
        black_all = benson_b.sum(1) == self.nn
        return torch.where(no_white | black_all, 1.0, -1.0).to(torch.float32)

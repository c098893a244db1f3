"""Tetris Block Puzzle, batched over games (port of
``minizero_tpu/envs/tetrisblockpuzzle.py``).

Reference: ``minizero/environment/stochastic/tetrisblockpuzzle/*``. Single
player: place held blocks on an 8x8 board. 801 actions, one per (block,
anchor) where one of the 19 block shapes fits inside the board, in (block,
row, col) order. A move is legal iff its block is in the (sorted) hand and
its cells are empty. After a placement full rows and columns clear at once
and the reward is their number. The used hand slot refills from the
preview queue, or with a fresh uniform block of 19 (the chance event), and
the hand is kept sorted. Terminal when nothing is legal or after 13500
steps; the eval score is the total reward.

``place(state, action, new_block)`` is the deterministic half: the
placement, the clear and the refill with a given chance block. ``step``
draws that block from the game's chance stream (``envs/chance.py``) at its
counter, which every step advances, a placement that does not fit too (as
the JAX key is split at every step).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from minizero_tpu_torch import resolve_device
from minizero_tpu_torch.envs import chance
from minizero_tpu_torch.envs.base import Env, EnvSpec

_N = 8
_NN = 64
_NUM_BLOCKS = 19
_MAX_STEPS = 13500

# kBlocksPos (tetrisblockpuzzle.cpp:22-47)
_BLOCKS = (
    ((0, 0), (0, 1), (1, 0), (1, 1)),
    ((0, 0), (0, 1), (1, 1), (1, 2)),
    ((0, 1), (1, 0), (1, 1), (2, 0)),
    ((0, 1), (0, 2), (1, 0), (1, 1)),
    ((0, 0), (1, 0), (1, 1), (2, 1)),
    ((0, 0), (0, 1), (0, 2), (0, 3)),
    ((0, 0), (1, 0), (2, 0), (3, 0)),
    ((0, 0), (1, 0), (1, 1), (1, 2)),
    ((0, 0), (0, 1), (1, 0), (2, 0)),
    ((0, 0), (0, 1), (0, 2), (1, 2)),
    ((0, 1), (1, 1), (2, 0), (2, 1)),
    ((0, 2), (1, 0), (1, 1), (1, 2)),
    ((0, 0), (1, 0), (2, 0), (2, 1)),
    ((0, 0), (0, 1), (0, 2), (1, 0)),
    ((0, 0), (0, 1), (1, 1), (2, 1)),
    ((0, 0), (0, 1), (0, 2), (1, 1)),
    ((0, 1), (1, 0), (1, 1), (2, 1)),
    ((0, 1), (1, 0), (1, 1), (1, 2)),
    ((0, 0), (1, 0), (1, 1), (2, 0)),
)


def _action_tables():
    """(masks bool[801, 64], block ids i32[801]) in (block, row, col) order."""
    masks, block_ids = [], []
    for b, cells in enumerate(_BLOCKS):
        for i in range(_N):
            for j in range(_N):
                if all(0 <= i + r < _N and 0 <= j + c < _N for r, c in cells):
                    m = np.zeros(_NN, bool)
                    for r, c in cells:
                        m[(i + r) * _N + (j + c)] = True
                    masks.append(m)
                    block_ids.append(b)
    return np.stack(masks), np.asarray(block_ids, np.int32)


@dataclass
class TetrisState:
    """Batched Tetris Block Puzzle state; every field leads with the batch
    dimension."""

    board: torch.Tensor  # bool[B, 64]
    holding: torch.Tensor  # i8[B, nh] sorted block ids
    preview: torch.Tensor  # i8[B, np] FIFO preview queue (may be size 0)
    reward: torch.Tensor  # f32[B] last clear count
    total: torch.Tensor  # f32[B]
    num_moves: torch.Tensor  # i32[B]
    key: torch.Tensor  # i64[B] chance stream key
    counter: torch.Tensor  # i64[B] chance stream position


class TetrisBlockPuzzleEnv(Env):
    def __init__(self, num_holding_block: int = 3, num_preview: int = 0):
        masks, block_ids = _action_tables()
        self.nh = int(num_holding_block)
        self.np_ = int(num_preview)
        self.spec = EnvSpec(
            name="tetrisblockpuzzle",
            num_players=1,
            board_size=_N,
            action_size=len(masks),
            num_input_channels=2 + _NUM_BLOCKS * (self.nh + self.np_),
            input_height=_N,
            input_width=_N,
            hidden_height=_N,
            hidden_width=_N,
            num_action_feature_channels=_NUM_BLOCKS,
            discrete_value_size=601,
            max_game_length=_MAX_STEPS,
        )
        self._np = {"masks": masks, "block_ids": block_ids.astype(np.int64),
                    "masks_f": masks.astype(np.float32)}

    def num_rotations(self) -> int:
        return 1

    # -- protocol -------------------------------------------------------------
    def init(self, batch_size: int, device=None) -> TetrisState:
        """Every game from stream key 0."""
        dev = resolve_device(device)
        return self._start(torch.zeros((batch_size,), dtype=torch.int64, device=dev))

    def init_random(self, batch_size: int, generator=None, device=None) -> TetrisState:
        dev = resolve_device(device)
        return self._start(chance.new_keys(batch_size, generator, dev))

    def _start(self, key: torch.Tensor) -> TetrisState:
        """The hand from draws 0..nh-1, the preview from the next np."""
        b, dev = key.shape[0], key.device
        k = self.nh + self.np_
        draws = chance.uniform_int(key[:, None], torch.arange(k, device=dev)[None, :],
                                   _NUM_BLOCKS).to(torch.int8)
        return TetrisState(
            board=torch.zeros((b, _NN), dtype=torch.bool, device=dev),
            holding=torch.sort(draws[:, :self.nh], dim=1).values,
            preview=draws[:, self.nh:],
            reward=torch.zeros((b,), dtype=torch.float32, device=dev),
            total=torch.zeros((b,), dtype=torch.float32, device=dev),
            num_moves=torch.zeros((b,), dtype=torch.int32, device=dev),
            key=key,
            counter=torch.full((b,), k, dtype=torch.int64, device=dev),
        )

    @staticmethod
    def crash(board: torch.Tensor):
        """Clear full rows and columns of ``board`` bool[B, 64]: (board,
        count i32[B]) (bitboard.h crash)."""
        b = board.reshape(-1, _N, _N)
        rows = b.all(2)
        cols = b.all(1)
        count = rows.sum(1, dtype=torch.int32) + cols.sum(1, dtype=torch.int32)
        cleared = b & ~rows[:, :, None] & ~cols[:, None, :]
        return cleared.reshape(-1, _NN), count

    def place(self, state: TetrisState, action: torch.Tensor, new_block: torch.Tensor) -> TetrisState:
        """Place ``action``'s block, clear, and refill the hand with
        ``new_block`` (i8[B], the chance event); a placement that does not
        fit changes nothing but the step count and the stream."""
        tb = self._tables(state.board.device)
        a = action.long()
        mask = tb["masks"][a]
        fits = ~(state.board & mask).any(1)
        cleared, count = self.crash(state.board | mask)
        board = torch.where(fits[:, None], cleared, state.board)
        reward = torch.where(fits, count.to(torch.float32), 0.0)
        block = tb["block_ids"][a].to(torch.int8)
        # the first hand slot holding the block
        slot = (state.holding == block[:, None]).to(torch.int32).argmax(1)
        if self.np_ > 0:
            refill = state.preview[:, 0]
            preview = torch.cat([state.preview[:, 1:], new_block[:, None]], dim=1)
            preview = torch.where(fits[:, None], preview, state.preview)
        else:
            refill = new_block
            preview = state.preview
        holding = state.holding.clone()
        holding[torch.arange(a.shape[0], device=a.device), slot] = refill
        holding = torch.sort(holding, dim=1).values
        return TetrisState(
            board=board,
            holding=torch.where(fits[:, None], holding, state.holding),
            preview=preview,
            reward=reward,
            total=state.total + reward,
            num_moves=state.num_moves + 1,
            key=state.key,
            counter=state.counter + 1,
        )

    def step(self, state: TetrisState, action: torch.Tensor) -> TetrisState:
        new_block = chance.uniform_int(state.key, state.counter, _NUM_BLOCKS).to(torch.int8)
        return self.place(state, action, new_block)

    def legal_mask(self, state: TetrisState) -> torch.Tensor:
        tb = self._tables(state.board.device)
        overlap = (state.board.to(torch.float32) @ tb["masks_f"].T) > 0
        in_hand = (tb["block_ids"][None, :, None] == state.holding.long()[:, None, :]).any(2)
        return ~overlap & in_hand

    def is_terminal(self, state: TetrisState) -> torch.Tensor:
        return ~self.legal_mask(state).any(1) | (state.num_moves >= _MAX_STEPS)

    def eval_score(self, state: TetrisState) -> torch.Tensor:
        return state.total

    def reward(self, state: TetrisState) -> torch.Tensor:
        return state.reward

    def turn(self, state: TetrisState) -> torch.Tensor:
        return torch.ones_like(state.num_moves, dtype=torch.int8)

    def features(self, state: TetrisState) -> torch.Tensor:
        """``[B, 8, 8, 2 + 19 (nh + np)]`` (tetrisblockpuzzle.cpp
        getFeatures): empty and occupied planes, then a block's one-hot
        over 19 planes per hand and preview slot."""
        b = state.board.shape[0]
        occ = state.board.to(torch.float32)
        blocks = torch.cat([state.holding, state.preview], dim=1).long()   # [B, nh + np]
        onehot = (blocks[:, :, None] == torch.arange(_NUM_BLOCKS, device=occ.device)).to(
            torch.float32).reshape(b, -1, 1).expand(-1, -1, _NN)
        feats = torch.cat([(1.0 - occ)[:, None], occ[:, None], onehot], dim=1)
        return feats.reshape(b, -1, _N, _N).permute(0, 2, 3, 1).contiguous()

    def action_features(self, action: torch.Tensor) -> torch.Tensor:
        """``[B, 19, 8, 8]`` NCHW: the placed cells on the block's plane."""
        tb = self._tables(action.device)
        a = action.long()
        mask = tb["masks"][a].to(torch.float32).reshape(-1, 1, _N, _N)
        hot = (torch.arange(_NUM_BLOCKS, device=a.device)[None, :] == tb["block_ids"][a][:, None])
        return mask * hot.to(torch.float32)[:, :, None, None]

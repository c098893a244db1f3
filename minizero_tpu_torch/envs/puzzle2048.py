"""2048, batched over games (port of ``minizero_tpu/envs/puzzle2048.py``).

Reference: ``minizero/environment/stochastic/puzzle2048/puzzle2048.{h,cpp}``.
Single player. Actions 0..3 = up/right/down/left; a slide is legal iff it
changes the board; the reward is the sum of the merged tiles' values. After
a slide that changes the board a tile spawns at a uniform empty cell: 2
(exponent 1) with probability 0.9, else 4 (exponent 2). A game starts with
two spawned tiles. Terminal when no slide changes the board; the eval score
is the total reward. 16 one-hot exponent planes; 4 action-feature planes.

The transition comes in two halves:

* ``slide(state)``: deterministic, all four directions at once. Each of a
  board's 16 lines (4 per direction, read toward the side slid to) is looked
  up in a table of every line -> (slid line, merge score), built once with
  numpy. The table covers exponents 0..17, every tile a 4x4 game can reach
  (the largest is 2^17).
* ``spawn(board, nth, tile)``: tile exponent ``tile`` on the ``nth`` empty
  cell.

``step`` slides, then spawns where the slide changed the board, with both
draws taken from the game's chance stream (``envs/chance.py``) at its
counter, which every step advances (the JAX key is split at every step).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from minizero_tpu_torch import resolve_device
from minizero_tpu_torch.envs import chance
from minizero_tpu_torch.envs.base import Env, EnvSpec

_N = 4
_NN = 16
_MAX_EXP = 17  # the largest tile of a 4x4 game is 2^17


def _line_tables():
    """Every line of exponents 0.._MAX_EXP (base-18 index, first cell most
    significant) slid toward index 0 -> (slid line i8[4], score i32): the
    nonzero tiles packed in order, then the first equal pair merged, and
    the next pair after it (JAX ``_slide_row_left``)."""
    base = _MAX_EXP + 1
    digits = np.stack(np.meshgrid(*[np.arange(base)] * _N, indexing="ij"), -1).reshape(-1, _N)
    r = np.take_along_axis(digits, np.argsort(digits == 0, axis=1, kind="stable"), axis=1)
    e0, e1, e2, e3 = r.T
    m01 = (e0 > 0) & (e0 == e1)
    m12 = ~m01 & (e1 > 0) & (e1 == e2)
    m23 = ~m12 & (e2 > 0) & (e2 == e3)
    z = np.zeros_like(e0)
    out = r.copy()
    out[m01] = np.stack([e0 + 1, e2, e3, z], 1)[m01]
    both = m01 & m23
    out[both] = np.stack([e0 + 1, e2 + 1, z, z], 1)[both]
    out[m12] = np.stack([e0, e1 + 1, e3, z], 1)[m12]
    only23 = m23 & ~m01
    out[only23] = np.stack([e0, e1, e2 + 1, z], 1)[only23]
    scores = (np.where(m01, 1 << (e0 + 1), 0) + np.where(m12, 1 << (e1 + 1), 0)
              + np.where(m23, 1 << (e2 + 1), 0))
    return out.astype(np.int8), scores.astype(np.int32)


def _direction_lines():
    """i64[4, 4, 4]: per direction (up, right, down, left) its 4 lines' cells,
    ordered toward the side slid to."""
    r = np.arange(_N)
    up = r[None, :] * _N + r[:, None]            # line c: column c, top down
    right = r[:, None] * _N + (_N - 1 - r)[None, :]
    down = (_N - 1 - r)[None, :] * _N + r[:, None]
    left = r[:, None] * _N + r[None, :]
    return np.stack([up, right, down, left]).astype(np.int64)


@dataclass
class Puzzle2048State:
    """Batched 2048 state; every field leads with the batch dimension."""

    board: torch.Tensor  # i8[B, 16] tile exponents
    reward: torch.Tensor  # f32[B] last slide's score
    total: torch.Tensor  # f32[B]
    num_moves: torch.Tensor  # i32[B]
    key: torch.Tensor  # i64[B] chance stream key
    counter: torch.Tensor  # i64[B] chance stream position


class Puzzle2048Env(Env):
    spec = EnvSpec(
        name="puzzle2048",
        num_players=1,
        board_size=_N,
        action_size=4,
        num_input_channels=16,
        input_height=_N,
        input_width=_N,
        hidden_height=_N,
        hidden_width=_N,
        num_action_feature_channels=4,
        discrete_value_size=601,
        max_game_length=8192,
    )

    def __init__(self):
        lines, scores = _line_tables()
        dirs = _direction_lines()
        # position -> its index in the direction's flattened lines
        inverse = np.argsort(dirs.reshape(4, _NN), axis=1)
        self._np = {"lines": lines, "scores": scores, "dirs": dirs, "inverse": inverse,
                    "place": (_MAX_EXP + 1) ** np.arange(_N - 1, -1, -1, dtype=np.int64)}

    def num_rotations(self) -> int:
        return 1

    # -- the deterministic halves --------------------------------------------
    def slide_all(self, board: torch.Tensor):
        """(boards i8[B, 4, 16], scores i32[B, 4], changed bool[B, 4]) of the
        four slides of ``board`` i8[B, 16]."""
        tb = self._tables(board.device)
        b = board.shape[0]
        cells = board.long()[:, tb["dirs"]]                      # [B, 4, 4, 4]
        idx = (cells * tb["place"]).sum(-1)                       # [B, 4, 4]
        slid = tb["lines"][idx].reshape(b, 4, _NN)                # in line order
        boards = torch.gather(slid, 2, tb["inverse"][None].expand(b, 4, _NN))
        scores = tb["scores"][idx].sum(-1)
        changed = (boards != board[:, None, :]).any(-1)
        return boards, scores, changed

    def slide(self, state: Puzzle2048State, action: torch.Tensor):
        """(board i8[B, 16], score i32[B], changed bool[B]) of ``action``'s
        slide."""
        boards, scores, changed = self.slide_all(state.board)
        a = action.long()
        rows = torch.arange(a.shape[0], device=a.device)
        return boards[rows, a], scores[rows, a], changed[rows, a]

    @staticmethod
    def spawn(board: torch.Tensor, nth: torch.Tensor, tile: torch.Tensor) -> torch.Tensor:
        """Exponent ``tile`` (i8[B]) on the ``nth`` (i64[B]) empty cell of
        each board; a full board is left as it is."""
        empty = board == 0
        cum = torch.cumsum(empty.to(torch.int64), dim=1) - 1
        at = empty & (cum == nth[:, None])
        return torch.where(at, tile.to(board.dtype)[:, None], board)

    def _spawn_from_stream(self, board, key, counter):
        """The spawn of draw pair ``counter`` (cell draw ``2c``, tile draw
        ``2c + 1``)."""
        n_empty = (board == 0).sum(1).clamp(min=1)
        nth = chance.uniform_int(key, 2 * counter, n_empty)
        tile = torch.where(chance.uniform_int(key, 2 * counter + 1, 10) == 0, 2, 1)
        return self.spawn(board, nth, tile.to(torch.int8))

    # -- protocol -------------------------------------------------------------
    def init(self, batch_size: int, device=None) -> Puzzle2048State:
        """Every game from stream key 0."""
        dev = resolve_device(device)
        return self._start(torch.zeros((batch_size,), dtype=torch.int64, device=dev))

    def init_random(self, batch_size: int, generator=None, device=None) -> Puzzle2048State:
        dev = resolve_device(device)
        return self._start(chance.new_keys(batch_size, generator, dev))

    def _start(self, key: torch.Tensor) -> Puzzle2048State:
        b, dev = key.shape[0], key.device
        board = torch.zeros((b, _NN), dtype=torch.int8, device=dev)
        zero = torch.zeros((b,), dtype=torch.int64, device=dev)
        board = self._spawn_from_stream(board, key, zero)
        board = self._spawn_from_stream(board, key, zero + 1)
        return Puzzle2048State(
            board=board,
            reward=torch.zeros((b,), dtype=torch.float32, device=dev),
            total=torch.zeros((b,), dtype=torch.float32, device=dev),
            num_moves=torch.zeros((b,), dtype=torch.int32, device=dev),
            key=key,
            counter=zero + 2,
        )

    def after_slide(self, state: Puzzle2048State, board: torch.Tensor, score: torch.Tensor,
                    changed: torch.Tensor, spawned: torch.Tensor) -> Puzzle2048State:
        """The stepped state from a slide's result and the board after its
        spawn (``spawned``)."""
        gain = torch.where(changed, score.to(torch.float32), 0.0)
        return Puzzle2048State(
            board=torch.where(changed[:, None], spawned, state.board),
            reward=gain,
            total=state.total + gain,
            num_moves=state.num_moves + 1,
            key=state.key,
            counter=state.counter + 1,
        )

    def step(self, state: Puzzle2048State, action: torch.Tensor) -> Puzzle2048State:
        board, score, changed = self.slide(state, action)
        spawned = self._spawn_from_stream(board, state.key, state.counter)
        return self.after_slide(state, board, score, changed, spawned)

    def legal_mask(self, state: Puzzle2048State) -> torch.Tensor:
        return self.slide_all(state.board)[2]

    def is_terminal(self, state: Puzzle2048State) -> torch.Tensor:
        return ~self.legal_mask(state).any(1)

    def eval_score(self, state: Puzzle2048State) -> torch.Tensor:
        return state.total

    def reward(self, state: Puzzle2048State) -> torch.Tensor:
        return state.reward

    def turn(self, state: Puzzle2048State) -> torch.Tensor:
        return torch.ones_like(state.num_moves, dtype=torch.int8)

    def features(self, state: Puzzle2048State) -> torch.Tensor:
        """16 one-hot exponent planes, ``[B, 4, 4, 16]``."""
        planes = torch.arange(16, dtype=state.board.dtype, device=state.board.device)
        onehot = (state.board[:, :, None] == planes).to(torch.float32)
        return onehot.reshape(-1, _N, _N, 16)

    def action_features(self, action: torch.Tensor) -> torch.Tensor:
        """``[B, 4, 4, 4]`` NCHW: the chosen action's plane all ones."""
        hot = (torch.arange(4, device=action.device)[None, :] == action.long()[:, None])
        return hot.to(torch.float32)[:, :, None, None].expand(-1, 4, _N, _N).contiguous()

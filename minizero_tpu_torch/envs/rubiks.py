"""Rubik's cube, batched over games (port of ``minizero_tpu/envs/rubiks.py``).

Reference: ``minizero/environment/rubiks/rubiks.{h,cpp}``. Single player:
solve the cube within 30 rotations. 12 actions per layer pair (6 faces x
clockwise / prime), all legal; terminal when solved or after 30 rotations;
the eval score is +1 solved, else -1 (``rubiks.cpp:71-80``). Features: 6
colour planes over the six faces stacked into a [6n, n] grid.

The reference's sticker-swap rotation (``rubiks.cpp:118-168``) runs once,
in numpy, on a cube of sticker indices at construction, which gives each
action's permutation; ``step`` is one gather. ``init_random`` scrambles
each game with ``scramble`` random rotations drawn from the caller's
generator (``rubiks.cpp:14-37``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from minizero_tpu_torch import resolve_device
from minizero_tpu_torch.envs.base import Env, EnvSpec

_FACES = 6
_MAX_ROTATE = 30  # kMaxRotateNum

# kCubeRotateSide (rubiks.h:96-115)
_SIDES = (
    ((1, 0, 0, 0), (2, 0, 0, 0), (3, 0, 0, 0), (4, 0, 0, 0)),
    ((0, 1, 0, 1), (4, 1, 1, 0), (5, 1, 0, 1), (2, 1, 0, 1)),
    ((0, 0, 1, 1), (1, 1, 1, 0), (5, 0, 0, 0), (3, 1, 0, 1)),
    ((0, 1, 1, 0), (2, 1, 1, 0), (5, 1, 1, 0), (4, 1, 0, 1)),
    ((0, 0, 0, 0), (3, 1, 1, 0), (5, 0, 1, 1), (1, 1, 0, 1)),
    ((1, 0, 1, 1), (4, 0, 1, 1), (3, 0, 1, 1), (2, 0, 1, 1)),
)


def _coords(side, ly, bs, n):
    f, a, b, c = side
    if a:
        x = (n - bs - 1) if c else bs
        y = (n - ly - 1) if b else ly
    else:
        x = (n - ly - 1) if b else ly
        y = (n - bs - 1) if c else bs
    return f, x, y


def _rotate_np(board, face, layer, prime, n):
    """RubiksEnv::rotate (rubiks.cpp:118-168) on a [6, n, n] numpy array."""
    sides = _SIDES[face]
    if prime:
        board[face] = board[face].T.copy()
        for i in range(2, -1, -1):
            for ly in range(layer):
                for bs in range(n):
                    fa, ax, ay = _coords(sides[i], ly, bs, n)
                    fb, bx, by = _coords(sides[i + 1], ly, bs, n)
                    board[fa, ax, ay], board[fb, bx, by] = board[fb, bx, by], board[fa, ax, ay]
    board[face] = board[face][::-1].copy()
    if not prime:
        board[face] = board[face].T.copy()
        for i in range(1, 4):
            for ly in range(layer):
                for bs in range(n):
                    fa, ax, ay = _coords(sides[i], ly, bs, n)
                    fb, bx, by = _coords(sides[i - 1], ly, bs, n)
                    board[fa, ax, ay], board[fb, bx, by] = board[fb, bx, by], board[fa, ax, ay]
    return board


def action_permutations(n: int) -> np.ndarray:
    """i64[A, 6 n n]: action ``a`` maps stickers ``s`` to ``s[perm[a]]``."""
    cells = _FACES * n * n
    num_actions = max(n // 2, 1) * 12
    perms = np.zeros((num_actions, cells), np.int64)
    for a in range(num_actions):
        idx = np.arange(cells).reshape(_FACES, n, n)
        perms[a] = _rotate_np(idx.copy(), a % 6, a // 12 + 1, (a % 12) >= 6, n).reshape(-1)
    return perms


@dataclass
class RubiksState:
    """Batched cube state; every field leads with the batch dimension."""

    stickers: torch.Tensor  # i8[B, 6 n n] colour per sticker (0..5)
    num_moves: torch.Tensor  # i32[B]


class RubiksEnv(Env):
    def __init__(self, board_size: int = 3, scramble: int = 5):
        assert 2 <= board_size <= 3
        n = board_size
        self.n = n
        self.scramble = int(scramble)
        perms = action_permutations(n)
        self.num_actions = perms.shape[0]
        self.spec = EnvSpec(
            name="rubiks",
            num_players=1,
            board_size=n,
            action_size=self.num_actions,
            num_input_channels=_FACES,
            input_height=_FACES * n,
            input_width=n,
            hidden_height=_FACES * n,
            hidden_width=n,
            max_game_length=_MAX_ROTATE,
        )
        self._np = {"perms": perms,
                    "solved": np.repeat(np.arange(_FACES, dtype=np.int8), n * n)}

    def num_rotations(self) -> int:
        return 1

    def init(self, batch_size: int, device=None) -> RubiksState:
        dev = resolve_device(device)
        return RubiksState(
            stickers=self._tables(dev)["solved"].repeat(batch_size, 1),
            num_moves=torch.zeros((batch_size,), dtype=torch.int32, device=dev),
        )

    def init_random(self, batch_size: int, generator=None, device=None) -> RubiksState:
        """Each game scrambled by ``scramble`` uniform rotations."""
        state = self.init(batch_size, device=device)
        dev = state.stickers.device
        actions = torch.randint(0, self.num_actions, (batch_size, self.scramble),
                                generator=generator, device=dev)
        stickers = state.stickers
        for i in range(self.scramble):
            stickers = torch.gather(stickers, 1, self._tables(dev)["perms"][actions[:, i]])
        return RubiksState(stickers=stickers, num_moves=state.num_moves)

    def step(self, state: RubiksState, action: torch.Tensor) -> RubiksState:
        perm = self._tables(state.stickers.device)["perms"][action.long()]
        return RubiksState(stickers=torch.gather(state.stickers, 1, perm),
                           num_moves=state.num_moves + 1)

    def legal_mask(self, state: RubiksState) -> torch.Tensor:
        return torch.ones((state.stickers.shape[0], self.num_actions), dtype=torch.bool,
                          device=state.stickers.device)

    def _solved_now(self, state: RubiksState) -> torch.Tensor:
        return (state.stickers == self._tables(state.stickers.device)["solved"]).all(1)

    def is_terminal(self, state: RubiksState) -> torch.Tensor:
        return self._solved_now(state) | (state.num_moves >= _MAX_ROTATE)

    def eval_score(self, state: RubiksState) -> torch.Tensor:
        return torch.where(self._solved_now(state), 1.0, -1.0).to(torch.float32)

    def turn(self, state: RubiksState) -> torch.Tensor:
        return torch.ones_like(state.num_moves, dtype=torch.int8)

    def features(self, state: RubiksState) -> torch.Tensor:
        """``[B, 6n, n, 6]`` colour indicator planes."""
        n = self.n
        colours = torch.arange(_FACES, dtype=state.stickers.dtype, device=state.stickers.device)
        grid = state.stickers.reshape(-1, _FACES * n, n)
        return (grid[:, :, :, None] == colours).to(torch.float32)

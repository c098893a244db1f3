"""Environment core (port of ``minizero_tpu/envs/base.py``).

An environment is a bundle of functions over a *batched* state: a dataclass
whose tensor fields all lead with the batch dimension ``[B, ...]``. Where the
JAX package writes single-game functions and ``vmap``s them, the port writes
the batch dimension out.

Conventions (matching the reference, ``base_env.h:22-27``):
  * players are 1 (Black / first player) and 2 (White); 0 = empty
  * ``eval_score`` is from Player 1's perspective: +1 black win, -1 white
    win, 0 draw
  * features are ``[B, H, W, C]`` at this surface (the JAX layout); the
    network permutes to NCHW inside
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable

import torch

from minizero_tpu_torch.utils import rotation as rot


@dataclass(frozen=True)
class EnvSpec:
    """Static env metadata (reference ``base_env.h:89-96``)."""

    name: str
    num_players: int
    board_size: int
    action_size: int
    num_input_channels: int
    input_height: int
    input_width: int
    hidden_height: int
    hidden_width: int
    num_action_feature_channels: int = 1
    discrete_value_size: int = 1
    max_game_length: int = 0  # hard cap on moves per game (for fixed shapes)
    has_pass: bool = False
    binary_features: bool = True  # 0/1 planes -> bit-packable for transfer


def map_state(fn: Callable[..., torch.Tensor], state: Any, *others: Any) -> Any:
    """Apply ``fn`` field by field to one or more states of the same class
    (the port's ``jax.tree_util.tree_map`` over a state dataclass)."""
    return type(state)(**{
        f.name: fn(getattr(state, f.name), *(getattr(o, f.name) for o in others))
        for f in dataclasses.fields(state)
    })


def select_states(mask: torch.Tensor, a: Any, b: Any) -> Any:
    """Per game: ``a`` where ``mask[b]`` else ``b`` (mask bool[B])."""
    def sel(x, y):
        return torch.where(mask.reshape((-1,) + (1,) * (x.dim() - 1)), x, y)
    return map_state(sel, a, b)


class Env:
    """Batched functional environment interface."""

    spec: EnvSpec

    def _tables(self, device) -> dict:
        """The env's numpy tables ``self._np`` as tensors on ``device``,
        uploaded once per device."""
        by_device = self.__dict__.setdefault("_by_device", {})
        key = str(device)
        if key not in by_device:
            by_device[key] = {k: torch.as_tensor(v, device=device) for k, v in self._np.items()}
        return by_device[key]

    def init(self, batch_size: int, device=None) -> Any:
        """Initial states for ``batch_size`` games on ``device``: the CUDA
        card by default, the CPU only when asked for by name
        (``minizero_tpu_torch.resolve_device``: without a card the default
        raises ``RuntimeError``)."""
        raise NotImplementedError

    def init_random(self, batch_size: int, generator=None, device=None) -> Any:
        """Initial states with per-episode randomness (scrambles, seeds);
        deterministic envs ignore ``generator``. ``device`` as in ``init``."""
        return self.init(batch_size, device=device)

    def step(self, state: Any, action: torch.Tensor) -> Any:
        """Apply ``action`` i32[B] for the player to move in each game. Safe
        on illegal actions and terminal states (result unspecified but
        well-shaped); the search masks illegality itself."""
        raise NotImplementedError

    def legal_mask(self, state: Any) -> torch.Tensor:
        """bool[B, action_size]; reference ``BaseEnv::isLegalAction``."""
        raise NotImplementedError

    def is_terminal(self, state: Any) -> torch.Tensor:
        raise NotImplementedError

    def eval_score(self, state: Any) -> torch.Tensor:
        """f32[B] outcome from Player 1's perspective."""
        raise NotImplementedError

    def resign_eval_score(self, state: Any) -> torch.Tensor:
        """Eval score when the player to move resigns: next player wins."""
        turn = self.turn(state)
        return torch.where(turn == 1, -1.0, 1.0).to(torch.float32)

    def reward(self, state: Any) -> torch.Tensor:
        """Reward of the last transition (0 for board games)."""
        turn = self.turn(state)
        return torch.zeros(turn.shape, dtype=torch.float32, device=turn.device)

    def turn(self, state: Any) -> torch.Tensor:
        raise NotImplementedError

    def features(self, state: Any) -> torch.Tensor:
        """f32[B, H, W, C] network input planes."""
        raise NotImplementedError

    def action_features(self, action: torch.Tensor) -> torch.Tensor:
        """f32[B, 1, hidden_H, hidden_W]: the action planes fed to the MuZero
        dynamics net, NCHW (reference ``BaseEnv::getActionFeatures``; a
        one-hot plane for board games, ``tictactoe.cpp:99-104``). An action
        outside the board (Go's pass) gives an all-zero plane."""
        h, w = self.spec.hidden_height, self.spec.hidden_width
        cells = torch.arange(h * w, device=action.device)
        plane = (cells[None, :] == action.long()[:, None]).to(torch.float32)
        return plane.reshape(-1, 1, h, w)

    # -- symmetry -----------------------------------------------------------
    def rotate_features_batch(self, feats: torch.Tensor, rotations: torch.Tensor) -> torch.Tensor:
        """Per-game feature rotation ([B, H, W, C], i32[B])."""
        return rot.rotate_planes_batch(feats, rotations, self.spec.board_size)

    def rotate_policy_back_batch(self, policy: torch.Tensor, rotations: torch.Tensor) -> torch.Tensor:
        """Per-game ``out[a] = policy[rotate(a)]`` ([B, A], i32[B])."""
        return rot.rotate_action_array_batch(policy, rotations, self.spec.board_size)

    def num_rotations(self) -> int:
        """Number of valid symmetry rotations (1 disables augmentation)."""
        return rot.NUM_ROTATIONS

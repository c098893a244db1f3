"""Atari (ALE) spec and action planes (port of the device-side parts of
``minizero_tpu/envs/atari.py``; reference
``minizero/environment/atari/atari.{h,cpp}``).

Only what the MuZero search needs is here: the static spec (18 actions,
96 x 96 RGB with an 8-step history of [action, R, G, B] planes, a 6 x 6
hidden state, 601-bin value and reward heads) and the action planes of the
dynamics net. The host-side env with its ALE and frame ring is not ported
yet (ROADMAP.md, queue A), so ``envs.make_env`` still refuses "atari".
"""

from __future__ import annotations

import torch

from minizero_tpu_torch.envs.base import EnvSpec

ACTION_SIZE = 18
RESOLUTION = 96
FRAME_SKIP = 4
HISTORY = 8
MAX_FRAMES = 108000


def atari_spec(game_name: str = "ms_pacman") -> EnvSpec:
    return EnvSpec(
        name=f"atari_{game_name}",
        num_players=1,
        board_size=RESOLUTION,
        action_size=ACTION_SIZE,
        num_input_channels=HISTORY * 4,
        input_height=RESOLUTION,
        input_width=RESOLUTION,
        binary_features=False,
        hidden_height=6,
        hidden_width=6,
        num_action_feature_channels=ACTION_SIZE,
        discrete_value_size=601,
        max_game_length=MAX_FRAMES // FRAME_SKIP,
    )


def action_features(action: torch.Tensor, spec: EnvSpec) -> torch.Tensor:
    """f32[B, 18, hidden_H, hidden_W]: the chosen action's channel filled
    with ones, NCHW (reference ``atari.cpp`` getActionFeatures)."""
    onehot = (torch.arange(ACTION_SIZE, device=action.device)[None, :]
              == action.long()[:, None]).to(torch.float32)
    return onehot[:, :, None, None].expand(-1, -1, spec.hidden_height, spec.hidden_width)

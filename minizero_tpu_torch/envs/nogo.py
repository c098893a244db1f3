"""NoGo, batched over games (port of ``minizero_tpu/envs/nogo.py``): Go in
which capturing and suicide are illegal and passing is forbidden; the player
left without a legal move loses.

Reference: ``minizero/environment/nogo/nogo.h:25-85``. A thin override of
the port's Go env: no capture can ever happen, so the board only gains
stones, and legality is a few neighbour reductions.
"""

from __future__ import annotations

import dataclasses

import torch

from minizero_tpu_torch.envs.go import GoEnv, GoState


class NoGoEnv(GoEnv):
    def __init__(self, board_size: int = 9):
        super().__init__(board_size=board_size, komi=0.0)
        self.spec = dataclasses.replace(
            self.spec, name=f"nogo_{board_size}x{board_size}", max_game_length=self.nn)

    def _legal_mask_for(self, board, labels, lib_at, block_keys, turn,
                        hash_a, hash_b, history_a, history_b, num_moves):
        """Legal iff: an empty point that does NOT capture (no adjacent
        1-liberty opponent block) and is not suicide (an empty neighbour or a
        >1-liberty own neighbour block); pass is never legal (reference
        nogo.h:25-57)."""
        tb = self._tables(board.device)
        nb, valid = tb["nbr"], tb["nbr_valid"]
        nbr_board = board[:, nb]  # [B, NN, 4]
        nbr_lib = lib_at[:, nb]
        turn_c = turn[:, None, None]
        nbr_empty = (valid & (nbr_board == 0)).any(-1)
        own_safe = (valid & (nbr_board == turn_c) & (nbr_lib > 1)).any(-1)
        captures = (valid & (nbr_board == 3 - turn_c) & (nbr_lib == 1)).any(-1)
        board_legal = (board == 0) & ~captures & (nbr_empty | own_safe)
        return torch.cat([board_legal, torch.zeros_like(board_legal[:, :1])], dim=1)

    def init(self, batch_size: int, device=None) -> GoState:
        state = super().init(batch_size, device=device)
        state.legal[:, self.nn] = False  # pass is never legal in NoGo
        return state

    def is_terminal(self, state: GoState) -> torch.Tensor:
        """Terminal when the player to move has no legal action (reference
        nogo.h:59-66)."""
        return ~state.legal.any(1)

    def eval_score(self, state: GoState) -> torch.Tensor:
        """The player to move (who is stuck) loses (reference nogo.h:68-76)."""
        return torch.where(state.turn == 1, -1.0, 1.0).to(torch.float32)

"""Environment registry (port of ``minizero_tpu/envs/__init__.py``).

``env_defaults`` keeps the per-env config defaults of every game family, so
``config.default_config`` gives the same configs as the JAX package, and
``make_env`` builds every family of the JAX registry. Atari's env lives on
the host (``envs/atari.py``): ``make_env`` builds one ``AtariEnv`` with the
real ALE, which needs the optional ``ale_py`` package (without it,
``ImportError``); the zero loop and ``-mode sp`` build a batch of them and
take an ``ale_factory``.
"""

from __future__ import annotations

import importlib
from typing import Any, Callable, Dict, Tuple

from minizero_tpu_torch.envs.base import Env

# name -> (module, class, ctor kwargs from cfg, per-env config defaults)
_TABLE: Dict[str, Tuple[str, str, Callable[..., Dict[str, Any]], Dict[str, Any]]] = {
    "tictactoe": (
        "minizero_tpu_torch.envs.tictactoe",
        "TicTacToeEnv",
        lambda cfg: {},
        {"env_board_size": 3, "actor_dirichlet_noise_alpha": 0.11},
    ),
    "othello": (
        "minizero_tpu_torch.envs.othello",
        "OthelloEnv",
        lambda cfg: {"board_size": cfg.env_board_size or 8},
        {"env_board_size": 8, "actor_dirichlet_noise_alpha": 0.12},
    ),
    "go": (
        "minizero_tpu_torch.envs.go",
        "GoEnv",
        lambda cfg: {"board_size": cfg.env_board_size or 9, "komi": cfg.env_go_komi},
        {"env_board_size": 9, "env_go_komi": 7.5, "actor_dirichlet_noise_alpha": 0.03},
    ),
    "nogo": (
        "minizero_tpu_torch.envs.nogo",
        "NoGoEnv",
        lambda cfg: {"board_size": cfg.env_board_size or 9},
        {"env_board_size": 9, "actor_dirichlet_noise_alpha": 0.03},
    ),
    "gomoku": (
        "minizero_tpu_torch.envs.gomoku",
        "GomokuEnv",
        lambda cfg: {
            "board_size": cfg.env_board_size or 15,
            "exactly_five": cfg.env_gomoku_exactly_five_stones,
            "rule": cfg.env_gomoku_rule,
        },
        {"env_board_size": 15, "actor_dirichlet_noise_alpha": 0.03},
    ),
    "outer_open_gomoku": (
        "minizero_tpu_torch.envs.gomoku",
        "GomokuEnv",
        lambda cfg: {
            "board_size": cfg.env_board_size or 15,
            "exactly_five": cfg.env_gomoku_exactly_five_stones,
            "rule": "outer_open",
        },
        {"env_board_size": 15, "actor_dirichlet_noise_alpha": 0.03},
    ),
    "hex": (
        "minizero_tpu_torch.envs.hex",
        "HexEnv",
        lambda cfg: {"board_size": cfg.env_board_size or 11, "use_swap_rule": cfg.env_hex_use_swap_rule},
        {"env_board_size": 11, "actor_dirichlet_noise_alpha": 0.03},
    ),
    "connect6": (
        "minizero_tpu_torch.envs.connect6",
        "Connect6Env",
        lambda cfg: {"board_size": cfg.env_board_size or 19},
        {"env_board_size": 19, "actor_dirichlet_noise_alpha": 0.03},
    ),
    "killallgo": (
        "minizero_tpu_torch.envs.killallgo",
        "KillAllGoEnv",
        lambda cfg: {"board_size": cfg.env_board_size or 7, "use_seki": cfg.env_killallgo_use_seki,
                     "ko_rule": cfg.env_killallgo_ko_rule},
        {"env_board_size": 7, "actor_dirichlet_noise_alpha": 0.03},
    ),
    "clobber": (
        "minizero_tpu_torch.envs.clobber",
        "ClobberEnv",
        lambda cfg: {"board_size": cfg.env_board_size or 10},
        {"env_board_size": 10, "actor_dirichlet_noise_alpha": 0.03},
    ),
    "breakthrough": (
        "minizero_tpu_torch.envs.breakthrough",
        "BreakthroughEnv",
        lambda cfg: {"board_size": cfg.env_board_size or 8},
        {"env_board_size": 8, "actor_dirichlet_noise_alpha": 0.03},
    ),
    "havannah": (
        "minizero_tpu_torch.envs.havannah",
        "HavannahEnv",
        lambda cfg: {
            "board_size": cfg.env_board_size or 8,
            "use_swap_rule": cfg.env_havannah_use_swap_rule,
        },
        {"env_board_size": 8, "actor_dirichlet_noise_alpha": 0.03},
    ),
    "conhex": (
        "minizero_tpu_torch.envs.conhex",
        "ConHexEnv",
        lambda cfg: {"use_swap_rule": cfg.env_conhex_use_swap_rule},
        {"env_board_size": 9, "actor_dirichlet_noise_alpha": 0.03},
    ),
    "amazons": (
        "minizero_tpu_torch.envs.amazons",
        "AmazonsEnv",
        lambda cfg: {"board_size": cfg.env_board_size or 10},
        {"env_board_size": 10, "actor_dirichlet_noise_alpha": 0.03},
    ),
    "santorini": (
        "minizero_tpu_torch.envs.santorini",
        "SantoriniEnv",
        lambda cfg: {},
        {"env_board_size": 5, "actor_dirichlet_noise_alpha": 0.03},
    ),
    "surakarta": (
        "minizero_tpu_torch.envs.surakarta",
        "SurakartaEnv",
        lambda cfg: {
            "board_size": cfg.env_board_size or 6,
            "no_capture_plies": cfg.env_surakarta_no_capture_plies,
        },
        {"env_board_size": 6, "actor_dirichlet_noise_alpha": 0.03},
    ),
    "linesofaction": (
        "minizero_tpu_torch.envs.linesofaction",
        "LinesOfActionEnv",
        lambda cfg: {"board_size": cfg.env_board_size or 8},
        {"env_board_size": 8, "actor_dirichlet_noise_alpha": 0.03},
    ),
    "puzzle2048": (
        "minizero_tpu_torch.envs.puzzle2048",
        "Puzzle2048Env",
        lambda cfg: {},
        # the reference trains 2048 with gumbel muzero + n-step returns
        {
            "env_board_size": 4,
            "actor_mcts_value_rescale": True,
            "actor_mcts_reward_discount": 1.0,
            "actor_select_action_by_count": True,
            "actor_use_random_rotation_features": False,
            "learner_n_step_return": 10,
            "nn_type_name": "muzero",
        },
    ),
    "tetrisblockpuzzle": (
        "minizero_tpu_torch.envs.tetrisblockpuzzle",
        "TetrisBlockPuzzleEnv",
        lambda cfg: {
            "num_holding_block": cfg.env_tetris_block_puzzle_num_holding_block,
            "num_preview": cfg.env_tetris_block_puzzle_num_preview_holding_block,
        },
        {
            "env_board_size": 8,
            "actor_mcts_value_rescale": True,
            "actor_select_action_by_count": True,
            "actor_use_random_rotation_features": False,
            "learner_n_step_return": 10,
            "nn_type_name": "muzero",
        },
    ),
    "rubiks": (
        "minizero_tpu_torch.envs.rubiks",
        "RubiksEnv",
        lambda cfg: {
            "board_size": cfg.env_board_size or 3,
            "scramble": cfg.env_rubiks_scramble_rotate,
        },
        {"env_board_size": 3, "actor_dirichlet_noise_alpha": 0.03},
    ),
    "atari": (
        "minizero_tpu_torch.envs.atari",
        "AtariEnv",
        lambda cfg: {"game_name": cfg.env_atari_name, "rom_dir": cfg.env_atari_rom_dir},
        # reference atari.h:86-92 setUpEnv overrides
        {
            "actor_num_simulation": 50,
            "actor_mcts_value_rescale": True,
            "actor_mcts_reward_discount": 0.997,
            "actor_mcts_init_q_average": True,
            "actor_select_action_softmax_temperature_decay": True,
            "actor_use_random_rotation_features": False,
            "zero_actor_intermediate_sequence_length": 200,
            "zero_actor_record_observations": True,
            "learner_n_step_return": 10,
            "learner_use_per": True,
            "nn_type_name": "muzero",
        },
    ),
    "dotsandboxes": (
        "minizero_tpu_torch.envs.dotsandboxes",
        "DotsAndBoxesEnv",
        lambda cfg: {"board_size": cfg.env_board_size or 9},
        # setUpEnv: board 9 (dotsandboxes.h:77); AlphaZero-only like the
        # reference (getActionFeatures throws, dotsandboxes.cpp:327-330)
        {"env_board_size": 9},
    ),
}


def env_defaults(name: str) -> Dict[str, Any]:
    if name not in _TABLE:
        raise KeyError(f"unknown env {name!r}; known: {sorted(_TABLE)}")
    return dict(_TABLE[name][3])


def make_env(cfg) -> Env:
    """Build the env named by ``cfg.env_name``."""
    name = cfg.env_name
    if name not in _TABLE:
        raise KeyError(f"unknown env {name!r}; known: {sorted(_TABLE)}")
    module_name, class_name, kwargs_fn, _ = _TABLE[name]
    module = importlib.import_module(module_name)
    return getattr(module, class_name)(**kwargs_fn(cfg))


def available_envs():
    """Every env family's name."""
    return sorted(_TABLE)

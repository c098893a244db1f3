"""Global configuration system (PyTorch port; counterpart of
``minizero_tpu/config.py``, which it copies: the module is pure Python).

Re-design of the reference's global flag registry
(``minizero/config/configuration.{h,cpp}`` and ``configure_loader.{h,cpp}``):
~70 typed parameters grouped into Program / Actor / Zero / Learner / Network /
Environment, loadable from ``.cfg`` files (newline-separated ``key=value``) and
from colon-separated ``conf_str`` strings, and round-trippable to annotated
``.cfg`` text (reference: ``configure_loader.cpp:34-73``).

A frozen dataclass instead of mutable C++ globals: ``replace()`` produces an
updated copy (used by the server's ``update_config`` annealing messages,
reference ``zero/zero_server.cpp:301-323``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, fields
from typing import Any, Dict, Optional, Tuple


# (name, default, description, group) — mirrors configuration.cpp:92-205.
# Booleans round-trip as "true"/"false" like the reference's ConfigureLoader.
_PARAMS: Tuple[Tuple[str, Any, str, str], ...] = (
    # program parameters (configuration.cpp:7-11)
    ("program_seed", 0, "assign a program seed", "Program"),
    ("program_auto_seed", False, "true for assigning a random seed automatically", "Program"),
    ("program_quiet", False, "true for silencing the error message", "Program"),
    ("program_use_color_message", True, "true for enabling color message output", "Program"),
    # actor parameters (configuration.cpp:13-34)
    ("actor_num_simulation", 50, "simulation number of MCTS", "Actor"),
    ("actor_mcts_puct_base", 19652.0, "hyperparameter for puct_bias in the PUCT formula of MCTS, determining the level of exploration", "Actor"),
    ("actor_mcts_puct_init", 1.25, "hyperparameter for puct_bias in the PUCT formula of MCTS", "Actor"),
    ("actor_mcts_reward_discount", 1.0, "discount factor for calculating Q values", "Actor"),
    ("actor_mcts_think_batch_size", 1, "the MCTS selection batch size; only works when running console", "Actor"),
    ("actor_mcts_think_time_limit", 0.0, "the MCTS time limit in seconds, 0 represents disabling time limit; only works when running console", "Actor"),
    ("actor_mcts_value_rescale", False, "true for games whose rewards are not bounded in [-1, 1], e.g., Atari games", "Actor"),
    ("actor_mcts_value_flipping_player", "W", "the player whose node values are flipped in the PUCT formula", "Actor"),
    ("actor_select_action_by_count", False, "true for selecting the action by the maximum MCTS count", "Actor"),
    ("actor_select_action_by_softmax_count", True, "true for selecting the action by the proportion of MCTS count", "Actor"),
    ("actor_select_action_softmax_temperature", 1.0, "the softmax temperature when using actor_select_action_by_softmax_count", "Actor"),
    ("actor_select_action_softmax_temperature_decay", False, "true for decaying the temperature based on training iteration (1, 0.5, 0.25 for 0-50%, 50-75%, 75-100%)", "Actor"),
    ("actor_use_random_rotation_features", True, "true for randomly rotating input features; only supported in alphazero", "Actor"),
    ("actor_use_dirichlet_noise", True, "true for adding dirichlet noise to the policy", "Actor"),
    ("actor_dirichlet_noise_alpha", 0.03, "hyperparameter for dirichlet noise, usually (1 / sqrt(number of actions))", "Actor"),
    ("actor_dirichlet_noise_epsilon", 0.25, "hyperparameter for dirichlet noise", "Actor"),
    ("actor_use_gumbel", False, "true for enabling Gumbel Zero", "Actor"),
    ("actor_use_gumbel_noise", False, "true for adding Gumbel noise to the policy", "Actor"),
    ("actor_gumbel_sample_size", 16, "hyperparameter for Gumbel Zero; the number of sampled actions", "Actor"),
    ("actor_gumbel_sigma_visit_c", 50.0, "hyperparameter for the monotonically increasing transformation sigma in Gumbel Zero", "Actor"),
    ("actor_gumbel_sigma_scale_c", 1.0, "hyperparameter for the monotonically increasing transformation sigma in Gumbel Zero", "Actor"),
    ("actor_resign_threshold", -0.9, "the threshold determining when to resign in the actor", "Actor"),
    ("actor_mcts_init_q_average", False, "true to initialize unvisited-child Q to the average of visited children (reference Atari builds, mcts.cpp:211-216); false for avg minus one loss", "Actor"),
    # zero parameters (configuration.cpp:36-49)
    ("zero_num_threads", 4, "the number of threads that the zero server uses for zero training", "Zero"),
    ("zero_num_parallel_games", 32, "the number of games to be run in parallel for zero training", "Zero"),
    ("zero_server_port", 9999, "the port number to host the server", "Zero"),
    ("zero_training_directory", "", "the output directory name for storing training results", "Zero"),
    ("zero_num_games_per_iteration", 2000, "the number of games to play in each iteration", "Zero"),
    ("zero_start_iteration", 0, "the first iteration of training", "Zero"),
    ("zero_end_iteration", 100, "the last iteration of training", "Zero"),
    ("zero_replay_buffer", 20, "replay buffer stores (zero_replay_buffer x zero_num_games_per_iteration) games/sequences", "Zero"),
    ("zero_disable_resign_ratio", 0.1, "the probability to keep playing when the winrate is below actor_resign_threshold", "Zero"),
    ("zero_moves_per_dispatch", 8, "moves advanced per device dispatch during self-play collection (move_scan chunk length; TPU-only knob)", "Zero"),
    ("zero_collective_timeout", 300.0, "seconds a multi-host collective (stats allgather / checkpoint barrier) may block before the process aborts for restart-from-checkpoint; 0 disables the watchdog (TPU-only knob; the reference instead drops lost TCP workers, zero_server.cpp:86)", "Zero"),
    ("zero_actor_intermediate_sequence_length", 0, "the max sequence length when running self-play; 0 (unlimited) for board games, 200 for atari", "Zero"),
    ("zero_actor_ignored_command", "reset_actors", "the commands to ignore by the actor", "Zero"),
    ("zero_actor_record_observations", False, "store compressed per-step observations in records as OBS tags (atari; see -mode remove_obs/recover_obs)", "Zero"),
    ("zero_server_accept_different_model_games", True, "true for accepting self-play games generated by an out-of-date model", "Zero"),
    ("zero_display_latest_games", 0, "the number of latest games to display statistics in log; 0 to disable", "Zero"),
    # learner parameters (configuration.cpp:51-66)
    ("learner_use_per", False, "true for enabling Prioritized Experience Replay", "Learner"),
    ("learner_per_alpha", 1.0, "PER exponent controlling the probability of sampling a transition", "Learner"),
    ("learner_per_init_beta", 1.0, "PER initial beta for linear annealing", "Learner"),
    ("learner_per_beta_anneal", True, "true to linearly anneal PER beta based on training iteration", "Learner"),
    ("learner_training_step", 500, "the number of training steps for updating the model in each iteration", "Learner"),
    ("learner_training_display_step", 100, "the training step interval to display training information", "Learner"),
    ("learner_batch_size", 1024, "the batch size for training", "Learner"),
    ("learner_muzero_unrolling_step", 5, "the number of steps to unroll for muzero training", "Learner"),
    ("learner_n_step_return", 0, "the number of steps for the n-step value; 0 for board games, 10 for atari", "Learner"),
    ("learner_optimizer", "SGD", "the type of optimizer, support SGD, Adam, AdamW", "Learner"),
    ("learner_learning_rate", 0.02, "learning rate; usually 0.02 for sgd, 0.001 for adam and adamw", "Learner"),
    ("learner_momentum", 0.9, "momentum; only for sgd", "Learner"),
    ("learner_weight_decay", 0.0001, "weight decay; 0.0001 for sgd, 0 for adam, 0.01 for adamw", "Learner"),
    ("learner_value_loss_scale", 1.0, "scaling of the value loss", "Learner"),
    ("learner_num_thread", 8, "the number of threads for training", "Learner"),
    ("learner_device_feature_window_gb", 8.0, "HBM budget for the device-resident Atari frame window (learner/frame_window.py); windows past the budget fall back to host-assembled feature uploads", "Learner"),
    # network parameters (configuration.cpp:68-73)
    ("nn_file_name", "", "the file name of model weights", "Network"),
    ("nn_num_blocks", 1, "the number of residual blocks", "Network"),
    ("nn_num_hidden_channels", 256, "the size of the hidden channels in residual blocks", "Network"),
    ("nn_num_value_hidden_channels", 256, "the size of the hidden channels in the value network", "Network"),
    ("nn_type_name", "alphazero", "the type of training algorithm and network: alphazero/muzero", "Network"),
    # environment parameters (configuration.cpp:75-90)
    ("env_name", "tictactoe", "the environment (game) to run", "Environment"),
    ("env_board_size", 0, "the size of board", "Environment"),
    ("env_atari_rom_dir", "/opt/atari57/", "the file path of the atari rom", "Environment"),
    ("env_atari_name", "ms_pacman", "the atari game to play", "Environment"),
    ("env_conhex_use_swap_rule", True, "the swap rule in ConHex", "Environment"),
    ("env_go_komi", 7.5, "the komi in Go", "Environment"),
    ("env_go_ko_rule", "positional", "the ko rules in Go: positional / situational", "Environment"),
    ("env_gomoku_rule", "standard", "the opening rule in Gomoku: standard / outer_open", "Environment"),
    ("env_gomoku_exactly_five_stones", True, "true for standard Gomoku; false for freestyle Gomoku", "Environment"),
    ("env_havannah_use_swap_rule", True, "true for enabling swap rule in Havannah", "Environment"),
    ("env_hex_use_swap_rule", True, "the swap rule in Hex", "Environment"),
    ("env_killallgo_ko_rule", "positional", "the ko rules in Killall-Go: positional (only consider stones), situational (consider stones and the turn)", "Environment"),
    ("env_killallgo_use_seki", False, "true for enabling seki", "Environment"),
    ("env_rubiks_scramble_rotate", 5, "the number of random rotations from the initial state of a rubik's cube", "Environment"),
    ("env_surakarta_no_capture_plies", 50, "game is over if playing this many plies without capture", "Environment"),
    ("env_tetris_block_puzzle_num_holding_block", 3, "number of holding blocks", "Environment"),
    ("env_tetris_block_puzzle_num_preview_holding_block", 0, "number of preview holding blocks", "Environment"),
)

_DESCRIPTIONS: Dict[str, str] = {name: desc for name, _, desc, _ in _PARAMS}
_GROUPS: Dict[str, str] = {name: group for name, _, _, group in _PARAMS}
_GROUP_ORDER = ("Program", "Actor", "Zero", "Learner", "Network", "Environment")


def _parse_value(current: Any, text: str) -> Any:
    """Parse ``text`` into the type of ``current`` (ConfigureLoader setters,
    reference ``configure_loader.h:11-32``)."""
    text = text.strip()
    if isinstance(current, bool):
        return text.lower() == "true"
    if isinstance(current, int):
        return int(float(text))
    if isinstance(current, float):
        return float(text)
    return text


def _format_value(value: Any) -> str:
    if isinstance(value, bool):
        return "true" if value else "false"
    return str(value)


@dataclass(frozen=True)
class Config:
    """Frozen, hashable configuration."""

    # Populated dynamically below from _PARAMS.

    def replace(self, **kwargs: Any) -> "Config":
        return dataclasses.replace(self, **kwargs)

    # ------------------------------------------------------------------ I/O
    def load_string(self, conf_str: str, sep: str = ":") -> "Config":
        """Apply a colon-separated ``key=value`` conf string
        (reference ``configure_loader.cpp:45-62``)."""
        updates: Dict[str, Any] = {}
        for token in conf_str.split(sep):
            token = token.strip()
            if not token or token.startswith("#") or "=" not in token:
                continue
            key, _, raw = token.partition("=")
            key = key.strip()
            raw = raw.split("#")[0]
            if not hasattr(self, key):
                raise KeyError(f"unknown configuration key: {key!r}")
            updates[key] = _parse_value(getattr(self, key), raw)
        return self.replace(**updates)

    def load_file(self, path: str) -> "Config":
        """Apply a newline-separated ``.cfg`` file
        (reference ``configure_loader.cpp:34-43``)."""
        with open(path) as f:
            content = f.read()
        return self.load_string(content, sep="\n")

    def to_string(self) -> str:
        """Round-trip to commented ``.cfg`` text grouped like the reference
        (``configure_loader.cpp:64-73``)."""
        lines = []
        for group in _GROUP_ORDER:
            lines.append(f"# {group}")
            for f in fields(self):
                if _GROUPS.get(f.name) != group:
                    continue
                value = getattr(self, f.name)
                desc = _DESCRIPTIONS.get(f.name, "")
                lines.append(f"{f.name}={_format_value(value)} # {desc}")
            lines.append("")
        return "\n".join(lines)

    def save_file(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_string())

    # --------------------------------------------------------------- helpers
    @property
    def use_gumbel(self) -> bool:
        return self.actor_use_gumbel


# Attach the parameter fields to Config dynamically so the table above stays
# the single source of truth.
Config = dataclass(frozen=True)(
    type(
        "Config",
        (Config,),
        {
            "__annotations__": {name: type(default) for name, default, _, _ in _PARAMS},
            **{name: default for name, default, _, _ in _PARAMS},
        },
    )
)


def algorithm_preset(algorithm: str, is_atari: bool = False) -> Dict[str, Any]:
    """az / mz / gaz / gmz presets (reference tools/quick-run.sh:331-347)."""
    algorithm = algorithm.lower()
    out: Dict[str, Any] = {}
    if algorithm not in ("az", "mz", "gaz", "gmz"):
        raise ValueError(f"unknown algorithm {algorithm!r}")
    out["nn_type_name"] = "alphazero" if algorithm.endswith("az") else "muzero"
    if algorithm.startswith("g"):
        n = 18 if is_atari else 16
        out.update(
            actor_num_simulation=n,
            actor_use_dirichlet_noise=False,
            actor_use_gumbel=True,
            actor_use_gumbel_noise=True,
            actor_gumbel_sample_size=n,
            actor_gumbel_sigma_visit_c=50.0,
            actor_gumbel_sigma_scale_c=0.1 if is_atari else 1.0,
        )
    return out


def default_config(env_name: Optional[str] = None, **overrides: Any) -> Config:
    """Build a config with per-env defaults applied (the reference applies
    ``Env::setUpEnv()`` then the conf file, ``docs/Development.md:57-71``)."""
    cfg = Config()
    if env_name is not None:
        from minizero_tpu_torch.envs import env_defaults

        cfg = cfg.replace(env_name=env_name, **env_defaults(env_name))
    if overrides:
        cfg = cfg.replace(**overrides)
    return cfg

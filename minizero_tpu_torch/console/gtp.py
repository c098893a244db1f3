"""GTP console (port of ``minizero_tpu/console/gtp.py``; reference
``minizero/console/console.{h,cpp}``).

The reference registers its GTP commands over a C++ actor and a TorchScript
net (``console.cpp:22-40``); here the same command set drives the batched
self-play engine with one game, in float32, on the card unless the CPU is
asked for. Replies follow GTP: ``=[id] result`` / ``?[id] error`` and a
blank line.
"""

from __future__ import annotations

import dataclasses
import sys
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from minizero_tpu_torch.config import Config
from minizero_tpu_torch.envs import make_env
from minizero_tpu_torch.models.factory import create_network, init_network
from minizero_tpu_torch.search.mcts import tree_string
from minizero_tpu_torch.selfplay.engine import SelfPlayEngine
from minizero_tpu_torch.selfplay.record import parse_game
from minizero_tpu_torch.utils.color_message import color_enabled, get_color_text
from minizero_tpu_torch.utils.transforms import from_discrete_value


def action_to_gtp(action_id: int, board_size: int, has_pass: bool) -> str:
    """reference SGFLoader::actionIDToBoardCoordinateString
    (sgf_loader.cpp:101-111)."""
    if has_pass and action_id == board_size * board_size:
        return "PASS"
    x = action_id % board_size
    y = action_id // board_size
    return chr(x + ord("A") + (1 if x >= 8 else 0)) + str(y + 1)


def gtp_to_action(coord: str, board_size: int) -> int:
    """reference SGFLoader::boardCoordinateStringToActionID
    (sgf_loader.cpp:89-99)."""
    s = coord.strip().upper()
    if s == "PASS":
        return board_size * board_size
    if len(s) < 2:
        return -1
    x = ord(s[0]) - ord("A") - (1 if s[0] > "I" else 0)
    try:
        y = int(s[1:]) - 1
    except ValueError:
        return -1
    return y * board_size + x


def env_action_to_string(env, action_id: int) -> str:
    """Env-specific move string when the env defines one, else plain board
    coordinates."""
    if hasattr(env, "action_to_string"):
        return env.action_to_string(action_id)
    return action_to_gtp(action_id, env.spec.board_size, env.spec.has_pass)


def env_string_to_action(env, coord: str) -> int:
    if hasattr(env, "string_to_action"):
        return env.string_to_action(coord)
    return gtp_to_action(coord, env.spec.board_size)


def render_board(env, state, game: int = 0) -> str:
    """Text board of game ``game`` of a batched state (reference per-env
    toString): the env's own ``render`` where it has one; else, for a state
    without a ``board``, its fields as the game's numpy arrays; else the
    board as a numpy array when it is no n x n grid; else the n x n stone
    board."""
    if hasattr(env, "render"):
        return env.render(state, game)
    board = getattr(state, "board", None)
    if board is None:
        fields = ", ".join(f"{f.name}={getattr(state, f.name)[game].cpu().numpy()!r}"
                           for f in dataclasses.fields(state))
        return f"{type(state).__name__}({fields})"
    b = board[game].cpu().numpy()
    n = env.spec.board_size
    if b.size % (n * n) or b.size < n * n:
        return str(b)
    b = b.reshape(-1)[: n * n].reshape(n, n)
    sym = {0: ".", 1: "O", 2: "X", 3: "#"}
    # interactive terminals get the reference's colored board (stones bold
    # on a yellow board, go.cpp:329-344); pipes and GUIs get plain text
    paint = color_enabled(getattr(env, "cfg", None))

    def cell(v: int) -> str:
        ch = sym.get(v, "?")
        if not paint:
            return ch
        fg = {1: "black", 2: "white"}.get(v, "black")
        return get_color_text(ch, bold=v in (1, 2), color=fg, background="yellow")

    header = "  " + " ".join(chr(c + ord("A") + (1 if c >= 8 else 0)) for c in range(n))
    lines = [header]
    for r in range(n - 1, -1, -1):
        row = " ".join(cell(int(v)) for v in b[r])
        lines.append(f"{r + 1:2d} {row} {r + 1}")
    lines.append(header)
    return "\n".join(lines)


class ConsoleActor:
    """One game over the batched engine (batch 1, float32), with think-batch
    rounds when ``actor_mcts_think_batch_size > 1`` and a wall-clock cap when
    ``actor_mcts_think_time_limit > 0``. ``network`` defaults to a fresh net
    seeded with ``program_seed``; ``device`` to the card."""

    def __init__(self, cfg: Config, network: Optional[torch.nn.Module] = None, device=None):
        self.cfg = cfg
        self.env = make_env(cfg)
        if network is None:
            network = init_network(create_network(cfg, self.env.spec), seed=cfg.program_seed)
        self.engine = SelfPlayEngine(self.env, cfg, network, use_bf16=False, device=device,
                                     seed=cfg.program_seed,
                                     use_think_batch=cfg.actor_mcts_think_batch_size > 1)
        self.network = self.engine.network
        self.device = self.engine.device
        self.generator = torch.Generator(device=self.device).manual_seed(cfg.program_seed)
        self.reset()

    def reset(self) -> None:
        self.states = self.engine.init_batch(1, self.generator)
        self.actions: List[int] = []
        self.last_resign = False

    def _step(self, action: int) -> None:
        self.states = self.env.step(
            self.states, torch.tensor([action], dtype=torch.int32, device=self.device))
        self.actions.append(action)

    def act(self, action_id: int) -> bool:
        mask = self.legal_mask()
        if action_id < 0 or action_id >= len(mask) or not mask[action_id]:
            return False
        self._step(action_id)
        return True

    def think(self, play: bool = True):
        limit = float(self.cfg.actor_mcts_think_time_limit)
        if limit > 0 and self.engine.supports_timed_search():
            return self._think_timed(limit, play)
        out = self.engine.move(self.states, self.cfg.actor_select_action_softmax_temperature,
                               self.generator)
        action = int(out.action[0])
        self.last_resign = bool(out.resign[0])
        if play and not self.last_resign:
            self.states = out.states
            self.actions.append(action)
        return action, out

    def _think_timed(self, limit: float, play: bool):
        """Wall-clock capped think (reference ZeroActor::think,
        zero_actor.cpp:36-49): simulations in chunks of ``n // 8``, the
        clock read between chunks after the card has finished the chunk, the
        decision from the partial tree."""
        t0 = time.monotonic()
        n = self.cfg.actor_num_simulation
        chunk = max(1, n // 8)
        carry = self.engine.az_init_timed(self.states, self.generator)
        done = 0
        while done < n:
            hi = min(done + chunk, n)
            carry = self.engine.az_advance_timed(carry, done + 1, hi + 1)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            done = hi
            if time.monotonic() - t0 >= limit:
                break
        action_b, _, _, resign_b, _ = self.engine.az_finish_timed(
            carry, self.cfg.actor_select_action_softmax_temperature)
        action = int(action_b[0])
        self.last_resign = bool(resign_b[0])
        if play and not self.last_resign:
            self._step(action)
        return action, None

    @torch.no_grad()
    def policy_value(self):
        """Direct net probe (reference calculatePolicyValue,
        console.cpp:220-240): (policy f32[A] as a numpy array, value)."""
        out = self.network(self.env.features(self.states))
        policy = out["policy"][0].float().cpu().numpy()
        if self.env.spec.discrete_value_size > 1:
            value = float(from_discrete_value(out["value"].float())[0])
        else:
            value = float(out["value"][0, 0])
        return policy, value

    def is_terminal(self) -> bool:
        return bool(self.env.is_terminal(self.states)[0])

    def eval_score(self) -> float:
        return float(self.env.eval_score(self.states)[0])

    def legal_mask(self) -> np.ndarray:
        return self.env.legal_mask(self.states)[0].cpu().numpy()

    def turn(self) -> int:
        return int(self.env.turn(self.states)[0])


class GTPConsole:
    """The GTP command loop over a ``ConsoleActor`` made at the first
    command that needs one, on ``device`` (the card by default)."""

    def __init__(self, cfg: Config, out=None, device=None):
        self.cfg = cfg
        self.out = out if out is not None else sys.stdout
        self.device = device
        self.actor: Optional[ConsoleActor] = None
        self._id = ""
        self.commands: Dict[str, Callable[[List[str]], None]] = {
            "gogui-analyze_commands": self.cmd_gogui_analyze,
            "list_commands": self.cmd_list_commands,
            "name": lambda a: self.success("minizero_tpu"),
            "version": lambda a: self.success("1.0"),
            "protocol_version": lambda a: self.success("2"),
            "clear_board": self.cmd_clear_board,
            "showboard": self.cmd_showboard,
            "play": self.cmd_play,
            "boardsize": self.cmd_boardsize,
            "genmove": self.cmd_genmove,
            "reg_genmove": self.cmd_genmove,
            "final_score": self.cmd_final_score,
            "pv": self.cmd_pv,
            "pv_string": self.cmd_pv_string,
            "game_string": self.cmd_game_string,
            "load_model": self.cmd_load_model,
            "get_conf_str": self.cmd_get_conf_str,
            "load_game": self.cmd_load_game,
            "tree_string": self.cmd_tree_string,
            "quit": self.cmd_quit,
        }
        self.running = True

    # ----------------------------------------------------------------- plumb
    def _ensure_actor(self) -> ConsoleActor:
        if self.actor is None:
            self.actor = ConsoleActor(self.cfg, device=self.device)
        return self.actor

    def success(self, message: str = "") -> None:
        print(f"={self._id} {message}\n", file=self.out, flush=True)

    def fail(self, message: str = "") -> None:
        print(f"?{self._id} {message}\n", file=self.out, flush=True)

    def execute(self, line: str) -> None:
        line = line.strip()
        if not line:
            return
        args = line.split()
        self._id = ""
        if args and args[0].isdigit():
            self._id = args[0]
            args = args[1:]
        if not args or args[0] not in self.commands:
            return self.fail(f"Unknown command: {line}")
        self.commands[args[0]](args)

    def run(self, stream=None) -> None:
        for line in stream if stream is not None else sys.stdin:
            self.execute(line)
            if not self.running:
                break

    # -------------------------------------------------------------- commands
    def cmd_gogui_analyze(self, args):
        self.success("sboard/policy_value/pv\n")

    def cmd_list_commands(self, args):
        self.success("\n".join(sorted(self.commands)))

    def cmd_clear_board(self, args):
        self._ensure_actor().reset()
        self.success()

    def cmd_showboard(self, args):
        actor = self._ensure_actor()
        self.success("\n" + render_board(actor.env, actor.states))

    def cmd_play(self, args):
        if len(args) < 3:
            return self.fail("play requires: play <color> <move>")
        actor = self._ensure_actor()
        action = env_string_to_action(actor.env, args[2])
        if not actor.act(action) and not actor.is_terminal():
            return self.fail(f'Invalid action: "{args[2]}"')
        self.success()

    def cmd_boardsize(self, args):
        if len(args) != 2:
            return self.fail("boardsize requires a size")
        self.cfg = self.cfg.replace(env_board_size=int(args[1]))
        self.actor = ConsoleActor(self.cfg, device=self.device)
        self.success()

    def cmd_genmove(self, args):
        actor = self._ensure_actor()
        if actor.is_terminal():
            return self.success("PASS")
        t0 = time.time()
        action, _ = actor.think(play=(args[0] == "genmove"))
        print(f"Spent Time = {time.time() - t0:.3f} (s)", file=sys.stderr)
        if actor.last_resign:
            return self.success("Resign")
        self.success(env_action_to_string(actor.env, action))

    def cmd_final_score(self, args):
        self.success(str(self._ensure_actor().eval_score()))

    def cmd_pv(self, args):
        actor = self._ensure_actor()
        policy, value = actor.policy_value()
        mask = actor.legal_mask()
        n = actor.env.spec.board_size
        entries = sorted(
            ((env_action_to_string(actor.env, a), float(policy[a])) for a in np.nonzero(mask)[0]),
            key=lambda kv: -kv[1],
        )
        lines = ["[policy] " + " ".join(f"{k}: {v:.3f}" for k, v in entries), f"[value] {value}"]
        print("\n".join(lines), file=sys.stderr)
        grid = []
        for row in range(n - 1, -1, -1):
            cells = []
            for col in range(n):
                a = row * n + col
                cells.append(f"{policy[a] * 100:.2f}%" if a < len(mask) and mask[a] else '""')
            grid.append(" ".join(cells))
        self.success("\n" + "\n".join(grid) + "\n")

    def cmd_pv_string(self, args):
        actor = self._ensure_actor()
        policy, value = actor.policy_value()
        mask = actor.legal_mask()
        parts = [f"{env_action_to_string(actor.env, a)} {policy[a] * 100:.1f}"
                 for a in np.nonzero(mask)[0]]
        self.success(f"\n[value] {value}\n" + " ".join(parts))

    def cmd_game_string(self, args):
        actor = self._ensure_actor()
        parts = [f"(;GM[{actor.env.spec.name}]SZ[{actor.env.spec.board_size}]"]
        for i, a in enumerate(actor.actions):
            parts.append(f";{'B' if i % 2 == 0 else 'W'}[{a}]")
        parts.append(")")
        self.success("".join(parts))

    def cmd_load_model(self, args):
        """A ``ZeroLoop`` checkpoint of the port (``torch.save``; its
        ``"model"`` state dict) into the actor's network."""
        if len(args) != 2:
            return self.fail("load_model requires a checkpoint path")
        actor = self._ensure_actor()
        try:
            payload = torch.load(args[1], map_location=actor.device, weights_only=True)
            actor.network.load_state_dict(payload["model"])
        except Exception as e:  # any failure is a GTP error reply, with its reason
            return self.fail(f"Failed to load model: {e}")
        self.success()

    def cmd_get_conf_str(self, args):
        if len(args) != 2:
            return self.fail("get_conf_str requires keys")
        lines = [f"{key}={getattr(self.cfg, key)}" for key in args[1].split(":")
                 if key and hasattr(self.cfg, key)]
        self.success("\n" + "\n".join(lines))

    def cmd_load_game(self, args):
        """Replay a record file into the console env (reference
        cmdLoadGame, console.cpp; resizes the board from the SZ tag)."""
        if len(args) != 2:
            return self.fail("load_game requires a record file path")
        try:
            with open(args[1]) as f:
                content = f.readline().strip()
        except OSError:
            return self.fail("Failed to load SGF file")
        actor = self._ensure_actor()
        tags, moves = parse_game(content, actor.env.spec.action_size)
        size = int(tags.get("SZ", 0) or 0)
        if size and size != actor.env.spec.board_size:
            self.cfg = self.cfg.replace(env_board_size=size)
            self.actor = actor = ConsoleActor(self.cfg, device=self.device)
        actor.reset()
        for i, m in enumerate(moves):
            if not actor.act(int(m["action"])):
                return self.fail(f"Invalid SGF action at move {i + 1}: {m['action']}")
        self.success("\n" + render_board(actor.env, actor.states))

    def cmd_tree_string(self, args):
        """Dump the current position's search tree (reference
        Tree::getTreeInfo_r, tree.h:79-110) in SGF-style nesting."""
        actor = self._ensure_actor()
        trees = actor.engine.search_trees(actor.states, actor.generator)
        n = actor.env.spec.board_size
        has_pass = actor.env.spec.has_pass
        self.success(tree_string(actor.engine.spec, trees,
                                 lambda a: action_to_gtp(a, n, has_pass)))

    def cmd_quit(self, args):
        self.running = False
        self.success()

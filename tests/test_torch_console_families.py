"""The console's text forms of every board-game and puzzle family, held
against the JAX package on the CPU.

* Every family that ``make_env`` builds without the ALE (Atari's env needs
  ``ale_py``): from a numpy seed, random legal actions are played through
  the JAX env and the port's in lock-step, and after every move each
  game's ``render_board`` (colour off: the output is no terminal), the
  ``env_action_to_string`` of every legal action and the
  ``env_string_to_action`` of those strings are equal. 2048 and Tetris
  hand the JAX env's chance events to the port's deterministic halves, as
  their own parity tests do.
* Dots and Boxes through both ``GTPConsole``s on carried weights: its
  "A1A2" line coordinates in ``play`` and ``genmove`` and its own text
  board in ``showboard``; the replies are equal line for line.
"""

import io
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minizero_tpu.config import algorithm_preset as j_preset
from minizero_tpu.config import default_config as j_default
from minizero_tpu.console import gtp as jgtp
from minizero_tpu.envs import available_envs
from minizero_tpu.envs import make_env as j_make_env
from minizero_tpu_torch.config import algorithm_preset, default_config
from minizero_tpu_torch.console.gtp import (
    ConsoleActor, GTPConsole, env_action_to_string, env_string_to_action, render_board)
from minizero_tpu_torch.envs import make_env

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import test_torch_puzzle2048 as t2048  # noqa: E402
import test_torch_tetris as ttetris  # noqa: E402
from test_torch_eval_console import _DETERMINISTIC, _TINY, _carried  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

FAMILIES = [name for name in available_envs() if name != "atari"]
MOVES = 12
BATCH = 2


def _chance_hooks(name, tenv):
    """(port states from JAX states, the port's step given the JAX env's
    stepped states) for the stochastic puzzles; None for the others."""
    if name == "puzzle2048":
        return t2048._from_jax, lambda ts, a, js: t2048.step_with_jax_spawns(tenv, ts, a, js)
    if name == "tetrisblockpuzzle":
        return ttetris._from_jax, lambda ts, a, js: tenv.place(
            ts, a, ttetris.jax_blocks(tenv, ts, a, js))
    return None


def test_families_cover_every_env_but_atari():
    assert len(FAMILIES) == 21 and "dotsandboxes" in FAMILIES


@pytest.mark.parametrize("name", FAMILIES)
def test_console_text_forms_match_jax(name):
    jenv, tenv = j_make_env(j_default(name)), make_env(default_config(name))
    jstep = jax.jit(jax.vmap(jenv.step))
    jterm = jax.jit(jax.vmap(jenv.is_terminal))
    one = jenv.init()
    j0 = jax.tree_util.tree_map(lambda x: jnp.broadcast_to(x, (BATCH,) + x.shape), one)
    hooks = _chance_hooks(name, tenv)
    t0 = tenv.init(BATCH, device="cpu") if hooks is None else hooks[0](j0)
    js, ts = j0, t0
    rng = np.random.default_rng(17)
    for move in range(MOVES + 1):
        legal = tenv.legal_mask(ts).numpy()
        for g in range(BATCH):
            what = f"{name} move {move} game {g}"
            jone = jax.tree_util.tree_map(lambda x: x[g], js)
            assert render_board(tenv, ts, g) == jgtp.render_board(jenv, jone), what
            for a in np.nonzero(legal[g])[0].tolist():
                s = env_action_to_string(tenv, a)
                assert s == jgtp.env_action_to_string(jenv, a), f"{what} action {a}"
                assert env_string_to_action(tenv, s) == jgtp.env_string_to_action(jenv, s), \
                    f"{what} string {s!r}"
        if move == MOVES:
            break
        # a finished game restarts in its slot, on both sides
        done = np.asarray(jterm(js))
        if done.any():
            keep = jnp.asarray(~done)
            js = jax.tree_util.tree_map(
                lambda x, y: jnp.where(keep.reshape((-1,) + (1,) * (x.ndim - 1)), x, y), js, j0)
            tkeep = torch.from_numpy(~done)
            ts = type(ts)(**{f: torch.where(
                tkeep.reshape((-1,) + (1,) * (getattr(ts, f).dim() - 1)),
                getattr(ts, f), getattr(t0, f)) for f in ts.__dataclass_fields__})
            legal = tenv.legal_mask(ts).numpy()
        action = (rng.random(legal.shape) * legal + 1e-9 * legal).argmax(-1).astype(np.int32)
        js = jstep(js, jnp.asarray(action))
        ts = (tenv.step(ts, torch.from_numpy(action)) if hooks is None
              else hooks[1](ts, torch.from_numpy(action), js))


def test_dots_and_boxes_line_coordinates():
    """The reference's examples (dotsandboxes.cpp:26-42) on the port, and
    every line's string back to its action."""
    env = make_env(default_config("dotsandboxes"))
    for a in range(env.spec.action_size):
        assert env.string_to_action(env.action_to_string(a)) == a
    assert env.action_to_string(0) == "A1B1" and env.string_to_action("A1B1") == 0
    assert env.string_to_action("a1a2") == env.string_to_action("A2A1") == 9
    assert env.string_to_action("A1C1") == -1 and env.string_to_action("Z9Z10") == -1


_DOTS_SCRIPT = ["play b A1A2", "showboard", "genmove w", "showboard", "play b A1C1",
                "play w b1B2", "genmove b", "pv", "showboard", "final_score"]


def test_dots_and_boxes_console_replies_match_jax():
    """``play b A1A2``, ``showboard`` and deterministic ``genmove`` (Gumbel
    AlphaZero, noise and rotation off, float32) through the JAX console and
    the port's, on the same weights: equal replies, line for line."""
    over = {**_TINY, **dict(algorithm_preset("gaz")), **_DETERMINISTIC,
            "actor_num_simulation": 8, "env_board_size": 3}
    assert dict(algorithm_preset("gaz")) == dict(j_preset("gaz"))
    cfg, jcfg = default_config("dotsandboxes", **over), j_default("dotsandboxes", **over)
    jvars, net = _carried(cfg, jcfg, seed=3)
    jout, out = io.StringIO(), io.StringIO()
    jconsole, console = jgtp.GTPConsole(jcfg, out=jout), GTPConsole(cfg, out=out, device="cpu")
    jconsole.actor = jgtp.ConsoleActor(jcfg, variables=jvars)
    console.actor = ConsoleActor(cfg, network=net, device="cpu")
    for line in _DOTS_SCRIPT:
        jconsole.execute(line)
        console.execute(line)
    lines = out.getvalue().splitlines()
    assert lines == jout.getvalue().splitlines()
    text = out.getvalue()
    assert 'Invalid action: "A1C1"' in text and "|" in text and "*" in text
    assert sum(r.startswith("= ") and len(r) == 6 for r in lines) >= 2  # two "A1A2"-style moves

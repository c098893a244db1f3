"""The port's Gomoku (with Outer-Open Gomoku) and Hex envs held against the
JAX package.

Random playouts from numpy seeds step the JAX env and the port's in
lock-step (every state field, legal mask, features, terminal flag, score
and player to move equal after every move, exact), with the swap rule
forced on half of the Hex games. The rule cases of
``tests/test_gomoku_hex.py`` run on both packages: five in a row, the
overline under ``exactly_five`` and in freestyle, the outer-open first
move, both Hex directions, the diagonal adjacency and the swap reflection.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minizero_tpu.envs.gomoku import GomokuEnv as JGomoku
from minizero_tpu.envs.hex import HexEnv as JHex
from minizero_tpu_torch.config import default_config
from minizero_tpu_torch.envs import make_env
from minizero_tpu_torch.envs.gomoku import GomokuEnv
from minizero_tpu_torch.envs.hex import HexEnv

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_env_parity import check_state, playout_parity  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401


@pytest.mark.parametrize("board_size,exactly_five,rule,moves,seed", [
    (15, True, "standard", 120, 0), (9, False, "standard", 70, 1), (9, True, "outer_open", 70, 2)])
def test_gomoku_random_playouts_match_jax(board_size, exactly_five, rule, moves, seed):
    kw = dict(board_size=board_size, exactly_five=exactly_five, rule=rule)
    ended, scores = playout_parity(JGomoku(**kw), GomokuEnv(**kw), moves, 16, seed)
    assert ended > 0 and {-1.0, 1.0} <= set(scores)


def _force_swap(step, legal, rng, ts, action):
    """On the second move of a game, half of the slots swap (play the first
    stone's cell)."""
    first = ts.board.numpy() != 0
    swap = (ts.num_moves.numpy() == 1) & (np.arange(len(action)) % 2 == 0)
    return np.where(swap, first.argmax(-1), action).astype(np.int32)


@pytest.mark.parametrize("board_size,swap,moves,seed", [(11, True, 130, 3), (5, False, 40, 4),
                                                        (7, True, 60, 5)])
def test_hex_random_playouts_match_jax(board_size, swap, moves, seed):
    swaps = []

    def count_swaps(step, js, ts):
        swaps.append(int(((ts.num_moves == 2) & (ts.board != 0).sum(1).eq(1)).sum()))

    ended, scores = playout_parity(JHex(board_size, swap), HexEnv(board_size, swap), moves, 16,
                                   seed, choose=_force_swap if swap else None,
                                   on_step=count_swaps if swap else None)
    assert ended > 0 and set(scores) <= {-1.0, 1.0}
    assert not swap or sum(swaps) > 0


def _play_both(jenv, tenv, actions):
    js, ts = jenv.init(), tenv.init(1, device="cpu")
    jstep = jax.jit(jenv.step)
    for a in actions:
        js = jstep(js, jnp.int32(a))
        ts = tenv.step(ts, torch.tensor([a], dtype=torch.int32))
    check_state(jax.tree_util.tree_map(lambda x: x[None], js), ts, f"after {actions}")
    assert bool(jenv.is_terminal(js)) == bool(tenv.is_terminal(ts)[0])
    assert float(jenv.eval_score(js)) == float(tenv.eval_score(ts)[0])
    return ts


@pytest.mark.parametrize("kw,actions,terminal,score", [
    (dict(board_size=9), [0, 9, 1, 10, 2, 11, 3, 12, 4], True, 1.0),
    (dict(board_size=9, exactly_five=True), [0, 18, 1, 19, 2, 20, 3, 21, 5, 22, 4], False, 0.0),
    (dict(board_size=9, exactly_five=False), [0, 18, 1, 19, 2, 20, 3, 21, 5, 22, 4], True, 1.0),
    (dict(board_size=9), [1, 0, 2, 10, 3, 20, 4, 30, 6, 40], True, -1.0),
])
def test_gomoku_rule_cases_match_jax(kw, actions, terminal, score):
    ts = _play_both(JGomoku(**kw), GomokuEnv(**kw), actions)
    env = GomokuEnv(**kw)
    assert bool(env.is_terminal(ts)[0]) == terminal and float(env.eval_score(ts)[0]) == score


def test_outer_open_first_move():
    env = make_env(default_config("outer_open_gomoku", env_board_size=9))
    s = env.init(1, device="cpu")
    mask = env.legal_mask(s)[0].numpy().reshape(9, 9)
    assert not mask[4, 4] and mask[0, 0] and mask[8, 8]
    s = env.step(s, torch.tensor([0], dtype=torch.int32))
    assert env.legal_mask(s)[0].numpy().reshape(9, 9)[4, 4]


@pytest.mark.parametrize("kw,actions,score", [
    (dict(board_size=5, use_swap_rule=False), [10, 0, 11, 1, 12, 2, 13, 3, 14], 1.0),
    (dict(board_size=5, use_swap_rule=False), [0, 2, 5, 7, 10, 12, 15, 17, 4, 22], -1.0),
    (dict(board_size=3, use_swap_rule=False), [0, 1, 4, 2, 8], 1.0),
])
def test_hex_rule_cases_match_jax(kw, actions, score):
    ts = _play_both(JHex(**kw), HexEnv(**kw), actions)
    assert bool(HexEnv(**kw).is_terminal(ts)[0]) and float(ts.winner[0]) == (1 if score > 0 else 2)


def test_hex_swap_reflects_the_first_stone():
    ts = _play_both(JHex(5, True), HexEnv(5, True), [6, 6])
    board = ts.board[0].numpy().reshape(5, 5)
    assert board[1, 1] == 0 and board[3, 3] == 2 and int(ts.turn[0]) == 1
    env = make_env(default_config("hex"))
    assert env.spec.action_size == 121 and env.num_rotations() == 1 and env.use_swap_rule

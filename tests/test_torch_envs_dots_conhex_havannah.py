"""The port's Dots and Boxes, ConHex and Havannah envs, and Gumbel
AlphaZero self-play on them, held against the JAX package.

Random playouts step the JAX env and the port's in lock-step
(``tests/torch_env_parity.py::playout_parity``): every state field, the
legal mask, the features, the terminal flag, the score and the player to
move are equal after every move (exact). The transparent oracles of
``tests/test_dotsandboxes.py`` and ``tests/test_havannah_conhex.py`` play
against the port, and their hand-built cases run on it. Then a tiny
integer parity net plays Gumbel AlphaZero n=6 through both engines from
random openings: actions exact, policy targets and root values within the
bounds of ``tests/test_torch_engine.py``. A Dots and Boxes move that closes
a box keeps the turn, so the tree's leaf player comes from the env.
"""

import os
import sys

import numpy as np
import pytest
import torch

from minizero_tpu.envs.conhex import ConHexEnv as JConHex
from minizero_tpu.envs.dotsandboxes import DotsAndBoxesEnv as JDots
from minizero_tpu.envs.havannah import HavannahEnv as JHavannah
from minizero_tpu_torch.envs.conhex import ConHexEnv, graph_tables
from minizero_tpu_torch.envs.dotsandboxes import DotsAndBoxesEnv
from minizero_tpu_torch.envs.havannah import HavannahEnv

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_dotsandboxes import Oracle as PyDots  # noqa: E402
from test_havannah_conhex import PyConHex, PyHavannah  # noqa: E402
from torch_env_parity import engine_parity, playout_parity  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401


def _one(env, state, action):
    return env.step(state, torch.tensor([action], dtype=torch.int32))


# ------------------------------------------------------------ dots and boxes
@pytest.mark.parametrize("n,moves,batch,seed", [(9, 200, 8, 0), (3, 60, 16, 1)])
def test_dotsandboxes_random_playouts_match_jax(n, moves, batch, seed):
    ended, scores = playout_parity(JDots(n), DotsAndBoxesEnv(n), moves, batch, seed)
    assert ended > 0 and set(scores) <= {-1.0, 0.0, 1.0}


@pytest.mark.parametrize("n,seed", [(2, 0), (3, 1)])
def test_dotsandboxes_oracle_playout(n, seed):
    env = DotsAndBoxesEnv(n)
    oracle = PyDots(n)
    s = env.init(1, device="cpu")
    rng = np.random.RandomState(seed)
    moves = 0
    while not oracle.terminal():
        legal = oracle.legal()
        np.testing.assert_array_equal(env.legal_mask(s)[0].numpy(), legal)
        action = int(rng.choice(np.flatnonzero(legal)))
        oracle.act(action)
        s = _one(env, s, action)
        assert int(s.turn[0]) == oracle.turn
        np.testing.assert_array_equal(s.board[0].numpy(), oracle.board)
        np.testing.assert_array_equal(env.features(s)[0].numpy(), oracle.features())
        moves += 1
    assert bool(env.is_terminal(s)[0]) and float(env.eval_score(s)[0]) == oracle.score()
    assert moves == 2 * n * (n + 1)


def test_dotsandboxes_capture_keeps_the_turn_and_spec():
    env = DotsAndBoxesEnv(1)
    s = env.init(1, device="cpu")
    for a in range(4):
        assert int(s.turn[0]) == [1, 2, 1, 2][a]
        s = _one(env, s, a)
    assert bool(env.is_terminal(s)[0]) and float(env.eval_score(s)[0]) == -1.0
    assert int(s.turn[0]) == 2
    spec = DotsAndBoxesEnv(9).spec
    assert (spec.num_input_channels, spec.input_height, spec.action_size) == (90, 19, 180)
    with pytest.raises(NotImplementedError):
        env.action_features(torch.zeros((1,), dtype=torch.int32))


# ------------------------------------------------------------------- conhex
def test_conhex_tables_equal_the_jax_ones():
    invalid, member, threshold, adj = graph_tables()
    j = JConHex()
    np.testing.assert_array_equal(invalid, np.asarray(j._invalid))
    np.testing.assert_array_equal(member, np.asarray(j._member))
    np.testing.assert_array_equal(threshold, np.asarray(j._threshold))
    np.testing.assert_array_equal(adj, np.stack([np.asarray(a) for a in j._adj]))


@pytest.mark.parametrize("swap,moves,seed", [(True, 120, 2), (False, 90, 3)])
def test_conhex_random_playouts_match_jax(swap, moves, seed):
    """Sticky first-capturer cells, border-to-border connection, the swap's
    reflection."""
    ended, scores = playout_parity(JConHex(swap), ConHexEnv(swap), moves, 16, seed)
    assert ended > 0 and set(scores) <= {-1.0, 1.0}


@pytest.mark.parametrize("seed", [0, 1])
def test_conhex_oracle_playout_and_swap(seed):
    env = ConHexEnv()
    oracle = PyConHex()
    rng = np.random.RandomState(seed)
    s = env.init(1, device="cpu")
    for _ in range(81):
        legal = np.array([oracle.legal(p) for p in range(81)])
        np.testing.assert_array_equal(env.legal_mask(s)[0].numpy(), legal)
        assert bool(env.is_terminal(s)[0]) == oracle.terminal()
        if oracle.terminal():
            break
        a = int(rng.choice(np.flatnonzero(legal)))
        oracle.play(a)
        s = _one(env, s, a)
        np.testing.assert_array_equal(s.holes[0].numpy(), np.array(oracle.holes, np.int8))
        np.testing.assert_array_equal(s.cell_owner[0].numpy(), np.array(oracle.cell_owner, np.int8))
        assert int(s.winner[0]) == oracle.winner
    assert float(env.eval_score(s)[0]) == oracle.score()
    s = _one(env, _one(env, env.init(1, device="cpu"), 1), 1)
    assert int(s.holes[0, 1]) == 0 and int(s.holes[0, 71]) == 2


# ----------------------------------------------------------------- havannah
@pytest.mark.parametrize("n,swap,moves,batch,seed", [
    (8, True, 170, 8, 4), (5, True, 90, 16, 5), (4, False, 60, 16, 6)])
def test_havannah_random_playouts_match_jax(n, swap, moves, batch, seed):
    """Bridge, fork and ring from the same fixed label rounds (12 at n=8)."""
    ended, scores = playout_parity(JHavannah(n, swap), HavannahEnv(n, swap), moves, batch, seed)
    assert ended > 0 and set(scores) <= {-1.0, 0.0, 1.0}


@pytest.mark.parametrize("seed", [0, 1])
def test_havannah_oracle_playout(seed):
    env = HavannahEnv(5)
    oracle = PyHavannah(5)
    rng = np.random.RandomState(seed)
    s = env.init(1, device="cpu")
    for _ in range(70):
        legal = np.array([oracle.legal(p) for p in range(env.ee)])
        np.testing.assert_array_equal(env.legal_mask(s)[0].numpy(), legal)
        assert bool(env.is_terminal(s)[0]) == oracle.terminal()
        if oracle.terminal():
            break
        a = int(rng.choice(np.flatnonzero(legal)))
        oracle.play(a)
        s = _one(env, s, a)
        np.testing.assert_array_equal(s.board[0].numpy(), np.array(oracle.board, np.int8))
        assert int(s.winner[0]) == oracle.winner
    assert float(env.eval_score(s)[0]) == oracle.score()


def test_havannah_bridge_ring_and_swap():
    env = HavannahEnv(4, use_swap_rule=False)
    s = env.init(1, device="cpu")
    for a in [3, 45, 4, 39, 5, 33, 6]:
        assert bool(env.legal_mask(s)[0, a])
        s = _one(env, s, a)
    assert int(s.winner[0]) == 1
    env = HavannahEnv(5, use_swap_rule=False)
    e = env.e
    black = [i * e + j for i, j in [(3, 4), (3, 5), (4, 3), (4, 5), (5, 3), (5, 4)]]
    white = [8, 7, e + 7, e + 8, 2 * e + 7]
    s = env.init(1, device="cpu")
    for b, w in zip(black, white + [None]):
        s = _one(env, s, b)
        if w is not None:
            s = _one(env, s, w)
    assert int(s.winner[0]) == 1
    env = HavannahEnv(5)
    s = _one(env, env.init(1, device="cpu"), 40)
    assert bool(env.legal_mask(s)[0, 40])
    board = _one(env, s, 40).board[0].numpy()
    assert board[40] == 2 and (board != 1).all()


# two random n=8 games whose winner the fixed label rounds get wrong (ROADMAP
# C3): in the first a win of White's is not seen, in the second a ring of
# Black's is seen where the oracle's exact flood finds none
_ROUNDS_MISS = (
    ([
    188, 28, 96, 11, 37, 104, 27, 138, 211, 158, 38, 201, 73, 35, 58, 106, 112, 173, 88, 121,
    142, 13, 36, 110, 171, 101, 71, 131, 137, 150, 203, 136, 141, 26, 74, 154, 118, 124, 10,
    116, 64, 41, 7, 87, 89, 198, 9, 135, 169, 55, 183, 184, 65, 161, 139, 215, 56, 200, 77, 99,
    53, 185, 57, 214, 52, 125, 103, 114, 172, 182, 43, 197, 94, 187, 63, 170, 210, 132, 93,
    122, 146, 152, 151, 8, 199, 156, 212, 181, 86, 166, 165, 29, 174, 81, 66, 105, 84, 130, 22,
    123, 217, 147, 159, 24, 95, 144], 2, 0),
    ([
    74, 88, 42, 99, 64, 67, 77, 201, 95, 184, 29, 70, 100, 108, 186, 174, 54, 35, 12, 182, 130,
    65, 147, 107, 102, 145, 213, 180, 94, 37, 40, 83, 21, 106, 171, 141, 63, 139, 39, 143, 66,
    188, 152, 68, 84, 166, 85, 41, 93, 144, 187, 212, 140, 135, 123, 196, 217, 52, 22, 168,
    159, 153, 167, 170, 105, 198, 69, 128, 216, 125, 23, 101, 13, 56, 109, 118, 59, 185, 96,
    189, 119, 8, 137, 115, 169, 131, 142, 111, 98, 124, 7, 113, 51, 44, 72, 28, 57, 86, 80, 79,
    49, 11, 38, 138, 133, 181, 26, 210, 132, 211, 36, 114, 127, 120, 104, 160, 126, 150, 9,
    117, 165, 14, 110, 199, 146, 172, 112], 0, 1),
)


@pytest.mark.parametrize("case", [0, 1])
def test_havannah_fixed_rounds_follow_the_jax_package(case):
    """The port keeps the JAX package's fixed 12 label rounds at n=8, so it
    agrees with it move for move, also where the rounds give another winner
    than the reference's exact search (ROADMAP C3, a fault of the reference
    kept on purpose, like Hex's C2)."""
    import jax
    import jax.numpy as jnp

    actions, oracle_winner, env_winner = _ROUNDS_MISS[case]
    jenv, env, oracle = JHavannah(8), HavannahEnv(8), PyHavannah(8)
    jstep = jax.jit(jenv.step)
    js, s = jenv.init(), env.init(1, device="cpu")
    for a in actions:
        assert not oracle.terminal() and not bool(env.is_terminal(s)[0])
        oracle.play(a)
        js, s = jstep(js, jnp.int32(a)), _one(env, s, a)
        assert int(s.winner[0]) == int(js.winner)
    assert (oracle.winner, int(s.winner[0])) == (oracle_winner, env_winner)


# ---------------------------------------------------------------- self-play
@pytest.mark.parametrize("env_name,over", [
    ("dotsandboxes", {"env_board_size": 3}), ("conhex", {}), ("havannah", {"env_board_size": 5})])
def test_gaz_moves_match_jax_engine(env_name, over):
    """Gumbel AlphaZero n=6 on tree step B1's plain version against the JAX
    engine's Pallas kernel (interpret mode)."""
    engine_parity(env_name, "gaz", 6, opening=6, over=over)

"""The port's Santorini and Amazons envs, and Gumbel AlphaZero self-play on
them, held against the JAX package.

Random playouts step the JAX env and the port's in lock-step
(``tests/torch_env_parity.py::playout_parity``): every state field, the
legal mask, the features, the terminal flag, the score and the player to
move are equal after every move (exact). The transparent oracles of
``tests/test_amazons_santorini_surakarta.py`` play against the port; the
copied tables equal the JAX ones. Then a tiny integer parity net plays
Gumbel AlphaZero n=6 through both engines: actions exact, policy targets
and root values within the bounds of ``tests/test_torch_engine.py``.
Amazons' turns come two actions at a time (P1 P1 P2 P2), so the engine's
moves there cover a player moving twice in a row.
"""

import os
import sys

import numpy as np
import pytest
import torch

from minizero_tpu.envs.amazons import AmazonsEnv as JAmazons
from minizero_tpu.envs.amazons import _move_table as j_amazons_table
from minizero_tpu.envs.santorini import SantoriniEnv as JSantorini
from minizero_tpu.envs.santorini import _tables as j_santorini_tables
from minizero_tpu_torch.envs.amazons import AmazonsEnv, move_table
from minizero_tpu_torch.envs.santorini import SantoriniEnv, tables

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_amazons_santorini_surakarta import PyAmazons, PySantorini  # noqa: E402
from torch_env_parity import engine_parity, playout_parity  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401


def _one(env, state, action):
    return env.step(state, torch.tensor([action], dtype=torch.int32))


# ---------------------------------------------------------------- santorini
def test_santorini_tables_equal_the_jax_ones():
    for got, want in zip(tables(), j_santorini_tables()):
        np.testing.assert_array_equal(got, want)
    assert vars(SantoriniEnv.spec) == vars(JSantorini.spec)
    assert (SantoriniEnv.spec.action_size, SantoriniEnv.spec.num_input_channels) == (1900, 50)


@pytest.mark.parametrize("moves,batch,seed", [(160, 8, 0), (120, 16, 1)])
def test_santorini_random_playouts_match_jax(moves, batch, seed):
    """The placement phase, climbs, domes, wins on level 3 and stuck
    players."""
    ended, scores = playout_parity(JSantorini(), SantoriniEnv(), moves, batch, seed)
    assert ended > 0 and set(scores) <= {-1.0, 1.0}


@pytest.mark.parametrize("seed", [0, 1])
def test_santorini_oracle_playout(seed):
    env = SantoriniEnv()
    oracle = PySantorini()
    rng = np.random.RandomState(seed)
    s = env.init(1, device="cpu")
    for move in range(130):
        got = np.flatnonzero(env.legal_mask(s)[0].numpy())
        want = sorted(oracle.legal())
        np.testing.assert_array_equal(got, np.array(want, np.int64), err_msg=f"move {move}")
        assert bool(env.is_terminal(s)[0]) == oracle.terminal(), f"move {move}"
        if oracle.terminal():
            break
        a = int(rng.choice(want))
        oracle.play(a)
        s = _one(env, s, a)
        np.testing.assert_array_equal(s.levels[0].numpy(), np.array(oracle.levels, np.int8))
    if oracle.terminal():
        assert float(env.eval_score(s)[0]) == oracle.score()
    f = env.features(env.init(1, device="cpu"))[0].numpy()
    assert f.shape == (5, 5, 50) and (f[:, :, 48] == 1).all()


# ------------------------------------------------------------------ amazons
@pytest.mark.parametrize("n", [6, 10])
def test_amazons_tables_equal_the_jax_ones(n):
    for got, want in zip(move_table(n), j_amazons_table(n)):
        np.testing.assert_array_equal(got, want)
    j, t = JAmazons(n), AmazonsEnv(n)
    np.testing.assert_array_equal(t._tables("cpu")["dest_onehot"].numpy(),
                                  np.asarray(j._dest_onehot))
    assert t.spec.action_size == j.spec.action_size == {6: 616, 10: 3040}[n]


@pytest.mark.parametrize("n,moves,batch,seed", [(6, 120, 8, 0), (5, 80, 16, 1), (10, 60, 4, 2)])
def test_amazons_random_playouts_match_jax(n, moves, batch, seed):
    """Move and arrow phases, the turn over two actions, stuck players."""
    ended, scores = playout_parity(JAmazons(n), AmazonsEnv(n), moves, batch, seed)
    assert set(scores) <= {-1.0, 1.0}
    if n < 10:
        assert ended > 0


@pytest.mark.parametrize("seed", [0, 1])
def test_amazons_oracle_playout(seed):
    env = AmazonsEnv(6)
    oracle = PyAmazons(6)
    rng = np.random.RandomState(seed)
    s = env.init(1, device="cpu")
    np.testing.assert_array_equal(s.board[0].numpy(), np.array(oracle.board, np.int8))
    for move in range(80):
        got = np.flatnonzero(env.legal_mask(s)[0].numpy())
        want = sorted(oracle.legal())
        np.testing.assert_array_equal(got, np.array(want, np.int64), err_msg=f"move {move}")
        assert bool(env.is_terminal(s)[0]) == (len(want) == 0)
        assert int(env.turn(s)[0]) == oracle.turn()
        if not want:
            break
        a = int(rng.choice(want))
        oracle.play(a)
        s = _one(env, s, a)
        np.testing.assert_array_equal(s.board[0].numpy(), np.array(oracle.board, np.int8))
    if not oracle.legal():
        assert float(env.eval_score(s)[0]) == (-1.0 if oracle.turn() == 1 else 1.0)
    f = env.features(env.init(1, device="cpu"))[0].numpy()
    assert f.shape == (6, 6, 28) and (f[:, :, 24] == 1).all()
    assert f[:, :, 0].sum() == 4 and f[:, :, 1].sum() == 4


def test_amazons_reuses_a_states_mask_and_recomputes_a_new_one():
    env = AmazonsEnv(6)
    s = env.init(3, device="cpu")
    m = env.legal_mask(s)
    assert env.legal_mask(s) is m  # is_terminal and eval_score share it
    s2 = env.step(s, m.to(torch.int64).argmax(-1).to(torch.int32))
    m2 = env.legal_mask(s2)
    assert m2 is not m and not m2[:, :env.num_moves_part].any() and m2.any(-1).all()


# ---------------------------------------------------------------- self-play
@pytest.mark.parametrize("env_name,moves", [("santorini", 3), ("amazons", 4)])
def test_gaz_moves_match_jax_engine(env_name, moves):
    """Gumbel AlphaZero n=6 on tree step B1's plain version (the wide
    kernel's shapes, A = 1,900 and 3,040) against the JAX engine's Pallas
    kernel (interpret mode); Amazons over both plies of a player's turn."""
    engine_parity(env_name, "gaz", 6, moves=moves, opening=6)

"""The port's Rubik's cube, Connect6 and Breakthrough envs, and Gumbel
AlphaZero self-play on them, held against the JAX package.

Random playouts step the JAX env and the port's in lock-step
(``tests/torch_env_parity.py::playout_parity``): every state field, the
legal mask, the features, the terminal flag, the score and the player to
move are equal after every move (exact). The cases of
``tests/test_rubiks.py`` and ``tests/test_connect6_clobber_breakthrough.py``
run on the port. Then a tiny integer parity net plays Gumbel AlphaZero n=6
through both engines from random openings, noise and rotation off: actions
exact, policy targets and root values within the bounds of
``tests/test_torch_engine.py``.
"""

import os
import sys

import numpy as np
import pytest
import torch

from minizero_tpu.envs.breakthrough import BreakthroughEnv as JBreakthrough
from minizero_tpu.envs.connect6 import Connect6Env as JConnect6
from minizero_tpu.envs.rubiks import RubiksEnv as JRubiks
from minizero_tpu_torch.envs.breakthrough import BreakthroughEnv, move_table
from minizero_tpu_torch.envs.connect6 import Connect6Env
from minizero_tpu_torch.envs.rubiks import RubiksEnv, action_permutations

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_connect6_clobber_breakthrough import PyBreakthrough  # noqa: E402
from torch_env_parity import engine_parity, playout_parity  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401


def _one(env, state, action):
    return env.step(state, torch.tensor([action], dtype=torch.int32))


# ------------------------------------------------------------------- rubiks
@pytest.mark.parametrize("n", [2, 3])
def test_rubiks_permutations_equal_the_jax_tables(n):
    np.testing.assert_array_equal(action_permutations(n), np.asarray(JRubiks(n)._perms))


@pytest.mark.parametrize("n,moves,seed", [(3, 70, 0), (2, 70, 1)])
def test_rubiks_random_playouts_match_jax(n, moves, seed):
    """From the solved cube (terminal at once, so every game restarts);
    the 30-rotation cap ends the others."""
    ended, scores = playout_parity(JRubiks(n, 5), RubiksEnv(n, 5), moves, 8, seed)
    assert ended > 0 and set(scores) <= {-1.0, 1.0}


def test_rubiks_rotation_then_prime_and_four_turns_are_identity():
    env = RubiksEnv(3)
    s = env.init(1, device="cpu")
    for face in range(6):
        back = _one(env, _one(env, s, face), face + 6)
        assert torch.equal(back.stickers, s.stickers)
        t = s
        for _ in range(4):
            t = _one(env, t, face)
        assert torch.equal(t.stickers, s.stickers)


def test_rubiks_rotation_preserves_colour_counts_and_centers():
    env = RubiksEnv(3)
    s = env.init(1, device="cpu")
    rng = np.random.RandomState(0)
    for _ in range(20):
        s = _one(env, s, int(rng.randint(12)))
    stickers = s.stickers[0].numpy()
    assert all((stickers == c).sum() == 9 for c in range(6))
    np.testing.assert_array_equal(stickers.reshape(6, 3, 3)[:, 1, 1], np.arange(6))


def test_rubiks_scramble_terminal_and_inverse():
    """The scramble draws its rotations from the caller's generator; undoing
    them with primes in reverse solves the cube."""
    env = RubiksEnv(3, scramble=5)
    s = env.init(1, device="cpu")
    assert bool(env.is_terminal(s)[0]) and float(env.eval_score(s)[0]) == 1.0
    sr = env.init_random(4, torch.Generator().manual_seed(3), device="cpu")
    assert not bool(env.is_terminal(sr).any()) and (env.eval_score(sr) == -1.0).all()
    actions = torch.randint(0, 12, (4, 5), generator=torch.Generator().manual_seed(3))
    for a in actions.flip(1).T:
        sr = env.step(sr, ((a + 6) % 12).to(torch.int32))
    assert bool(env._solved_now(sr).all())
    t = env.init_random(1, torch.Generator().manual_seed(4), device="cpu")
    for _ in range(30):
        t = _one(env, t, 0)
    assert bool(env.is_terminal(t)[0])


def test_rubiks_features_and_two_by_two():
    env = RubiksEnv(3)
    f = env.features(env.init(1, device="cpu"))[0].numpy()
    assert f.shape == (18, 3, 6) and f.sum() == 54
    assert (f.reshape(6, 3, 3, 6)[np.arange(6), :, :, np.arange(6)] == 1).all()
    env2 = RubiksEnv(2, scramble=3)
    assert env2.spec.action_size == 12
    s = env2.step(env2.init_random(2, torch.Generator().manual_seed(0), device="cpu"),
                  torch.tensor([5, 5], dtype=torch.int32))
    assert tuple(s.stickers.shape) == (2, 24)


# ----------------------------------------------------------------- connect6
@pytest.mark.parametrize("n,moves,batch,seed", [(19, 40, 8, 2), (9, 90, 16, 3)])
def test_connect6_random_playouts_match_jax(n, moves, batch, seed):
    """Two stones a turn after Black's first; six in a row or a full board
    ends the game."""
    ended, scores = playout_parity(JConnect6(n), Connect6Env(n), moves, batch, seed)
    if n == 9:
        assert ended > 0 and set(scores) <= {-1.0, 0.0, 1.0}


def test_connect6_turn_schedule_and_win():
    env = Connect6Env(9)
    s = env.init(1, device="cpu")
    owners = []
    rng = np.random.RandomState(0)
    for _ in range(9):
        owners.append(int(s.turn[0]))
        s = _one(env, s, int(rng.choice(np.flatnonzero(env.legal_mask(s)[0].numpy()))))
    assert owners == [1, 2, 2, 1, 1, 2, 2, 1, 1]
    s = env.init(1, device="cpu")
    for a in [0, 72, 73, 1, 2, 74, 75, 3, 4, 76, 60]:
        assert not bool(env.is_terminal(s)[0])
        s = _one(env, s, a)
    s = _one(env, s, 5)
    assert bool(env.is_terminal(s)[0]) and float(env.eval_score(s)[0]) == 1.0


def test_connect6_threat_planes_and_features():
    env = Connect6Env(9)
    board = torch.zeros((1, 81), dtype=torch.int8)
    board[0, [36, 37, 38, 39]] = 1
    one = torch.ones((1,), dtype=torch.int8)
    t4 = env._threat_space(board, one, 4)[0].numpy()
    assert t4[40] == 1.0 and t4[41] == 1.0 and t4[36] == 0.0
    assert env._threat_space(board, one, 5).sum() == 0.0
    s = _one(env, env.init(1, device="cpu"), 1)
    f = env.features(s)[0].numpy()
    assert f.shape == (9, 9, 24)
    assert f[0, 1, 1] == 1.0 and f[:, :, 0].sum() == 0  # White to move: Black's stone is opp
    assert f[:, :, 2].sum() == 0 and (f[:, :, 22] == 1).all()


# -------------------------------------------------------------- breakthrough
@pytest.mark.parametrize("n,moves,batch,seed", [(8, 120, 16, 4), (6, 80, 16, 5)])
def test_breakthrough_random_playouts_match_jax(n, moves, batch, seed):
    """Reaching the far rank or taking every enemy pawn wins."""
    ended, scores = playout_parity(JBreakthrough(n), BreakthroughEnv(n), moves, batch, seed)
    assert ended > 0 and set(scores) <= {-1.0, 1.0}


def test_breakthrough_move_table_and_oracle_playout():
    for n, expect in ((5, 104), (6, 160), (7, 228), (8, 308)):
        assert len(move_table(n)[0]) == expect
    env = BreakthroughEnv(6)
    oracle = PyBreakthrough(6)
    rng = np.random.RandomState(0)
    s = env.init(1, device="cpu")
    for _ in range(300):
        legal = env.legal_mask(s)[0].numpy()
        np.testing.assert_array_equal(legal, [oracle.legal(a) for a in range(len(legal))])
        assert bool(env.is_terminal(s)[0]) == (oracle.winner() != 0)
        if oracle.winner():
            break
        a = int(rng.choice(np.flatnonzero(legal)))
        oracle.play(a)
        s = _one(env, s, a)
        np.testing.assert_array_equal(s.board[0].numpy(), np.array(oracle.board, np.int8))
    assert float(env.eval_score(s)[0]) == (1.0 if oracle.winner() == 1 else -1.0)
    f = env.features(env.init(1, device="cpu"))[0].numpy()
    assert f.shape == (6, 6, 20) and f[:, :, 16].sum() == 0 and (f[:, :, 18] == 1).all()


# ---------------------------------------------------------------- self-play
@pytest.mark.parametrize("env_name,over", [
    ("rubiks", {}), ("connect6", {"env_board_size": 9}), ("breakthrough", {})])
def test_gaz_moves_match_jax_engine(env_name, over):
    """Gumbel AlphaZero n=6 on tree step B1's plain version against the JAX
    engine's Pallas kernel (interpret mode)."""
    engine_parity(env_name, "gaz", 6, over=over)

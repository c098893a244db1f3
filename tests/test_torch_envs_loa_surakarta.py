"""The port's Lines of Action and Surakarta envs, and Gumbel AlphaZero
self-play on them, held against the JAX package.

Random playouts step the JAX env and the port's in lock-step
(``tests/torch_env_parity.py::playout_parity``): every state field, the
legal mask, the features, the terminal flag, the score and the player to
move are equal after every move (exact). The transparent oracles of
``tests/test_linesofaction.py`` and ``tests/test_amazons_santorini_surakarta.py``
play against the port; the copied move and walk tables equal the JAX ones.
Both families keep the cycle rule with a sorted-history lookup
(``envs/cycle.py``) where the JAX envs broadcast ``[A, MAXH]``
comparisons: a Lines of Action playout that plays moves back and forth
reaches positions the rule forbids, and the masks stay equal. Then a tiny
integer parity net plays Gumbel AlphaZero n=6 through both engines: actions
exact, policy targets and root values within the bounds of
``tests/test_torch_engine.py``.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minizero_tpu.envs.linesofaction import LinesOfActionEnv as JLoA
from minizero_tpu.envs.linesofaction import _move_table as j_loa_table
from minizero_tpu.envs.surakarta import SurakartaEnv as JSurakarta
from minizero_tpu_torch.envs import cycle
from minizero_tpu_torch.envs.linesofaction import LinesOfActionEnv, line_tables, move_table
from minizero_tpu_torch.envs.surakarta import SurakartaEnv, walk_tables

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_amazons_santorini_surakarta import PySurakarta  # noqa: E402
from test_linesofaction import PyLoA  # noqa: E402
from torch_env_parity import engine_parity, playout_parity  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401


def _one(env, state, action):
    return env.step(state, torch.tensor([action], dtype=torch.int32))


# ---------------------------------------------------------- lines of action
def test_loa_tables_equal_the_jax_ones():
    j = JLoA()
    for got, want in zip(move_table(8), j_loa_table(8)):
        np.testing.assert_array_equal(got, want)
    line, path, nbr, valid = line_tables(8)
    np.testing.assert_array_equal(line, np.asarray(j._line2))
    np.testing.assert_array_equal(path, np.asarray(j._path))
    np.testing.assert_array_equal(nbr, np.asarray(j._nbr8))
    np.testing.assert_array_equal(valid, np.asarray(j._nbr8_valid))
    t = LinesOfActionEnv()
    tb = t._tables("cpu")
    np.testing.assert_array_equal(tb["key_a"].numpy(), np.asarray(j._key_a))
    np.testing.assert_array_equal(tb["key_b"].numpy(), np.asarray(j._key_b))
    assert (t._turn_key_a, t._turn_key_b) == (int(j._turn_key_a), int(j._turn_key_b))
    assert t.spec == LinesOfActionEnv().spec and t.spec.action_size == 1456


@pytest.mark.parametrize("moves,batch,seed", [(150, 8, 0), (120, 16, 1)])
def test_loa_random_playouts_match_jax(moves, batch, seed):
    ended, scores = playout_parity(JLoA(), LinesOfActionEnv(), moves, batch, seed)
    assert set(scores) <= {-1.0, 0.0, 1.0}


def test_loa_back_and_forth_meets_the_cycle_rule():
    """Each player undoes its own move of two plies ago where it can, so
    the opponent's undo would recreate an earlier position: the rule
    forbids it, in the port's sorted lookup as in JAX's broadcast form."""
    env = LinesOfActionEnv()
    tb = env._tables("cpu")
    reverse = {(int(f), int(d)): a for a, (f, d) in enumerate(zip(tb["from"], tb["dest"]))}
    back = np.array([reverse[(int(d), int(f))] for f, d in zip(tb["from"], tb["dest"])])
    played = []
    forbidden = []

    def choose(step, legal, rng, ts, action):
        if len(played) >= 2:
            undo = back[played[-2]]
            take = legal[np.arange(len(undo)), undo]
            action = np.where(take, undo, action).astype(np.int32)
        played.append(action)
        return action

    def on_step(step, js, ts):
        plain = env.legal_mask(ts)
        cand_a = cycle.move_hash(ts.hash_a, ts.turn, ts.board, tb["from"], tb["dest"],
                                 tb["key_a"], env._turn_key_a)
        cand_b = cycle.move_hash(ts.hash_b, ts.turn, ts.board, tb["from"], tb["dest"],
                                 tb["key_b"], env._turn_key_b)
        seen = cycle.seen_before(ts.history_a, ts.history_b, ts.num_moves, cand_a, cand_b)
        forbidden.append(int(seen.sum()))
        assert not (plain & seen).any()

    playout_parity(JLoA(), env, 24, 8, 3, choose=choose, on_step=on_step)
    assert sum(forbidden) > 0, "no position repeated: the cycle rule was not exercised"


def test_cycle_lookup_matches_the_broadcast_form():
    """``cycle.seen_before`` against the broadcast comparison on random
    histories, with forced hits, entries past ``num_moves`` that must not
    count, and candidates equal to the sort's sentinel."""
    rng = np.random.default_rng(0)
    b, maxh, a = 16, 40, 60
    ha = rng.integers(-2**31, 2**31, size=(b, maxh)).astype(np.int32)
    hb = rng.integers(-2**31, 2**31, size=(b, maxh)).astype(np.int32)
    num = rng.integers(0, maxh, size=b).astype(np.int32)
    ca = rng.integers(-2**31, 2**31, size=(b, a)).astype(np.int32)
    cb = rng.integers(-2**31, 2**31, size=(b, a)).astype(np.int32)
    for i in range(b):
        for j in range(0, a, 7):  # copies of live and of dead history entries
            k = rng.integers(0, maxh)
            ca[i, j], cb[i, j] = ha[i, k], hb[i, k]
    ha[0, 0], hb[0, 0] = 2**31 - 1, -1  # a live entry equal to the sentinel
    ca[:2, -1], cb[:2, -1] = 2**31 - 1, -1
    valid = np.arange(maxh)[None, :] <= num[:, None]
    want = ((ha[:, None, :] == ca[:, :, None]) & (hb[:, None, :] == cb[:, :, None])
            & valid[:, None, :]).any(-1)
    got = cycle.seen_before(*(torch.from_numpy(x) for x in (ha, hb, num, ca, cb)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[0, -1] and not want[1, -1]


@pytest.mark.parametrize("seed", [0, 1])
def test_loa_oracle_playout(seed):
    env = LinesOfActionEnv()
    oracle = PyLoA()
    rng = np.random.RandomState(seed)
    s = env.init(1, device="cpu")
    for move in range(120):
        mask = env.legal_mask(s)[0].numpy()
        want = np.array([oracle.legal(a) for a in range(env.spec.action_size)])
        np.testing.assert_array_equal(mask, want, err_msg=f"move {move}")
        assert bool(env.is_terminal(s)[0]) == oracle.terminal(), f"move {move}"
        if oracle.terminal() or not want.any():
            break
        a = int(rng.choice(np.flatnonzero(want)))
        oracle.play(a)
        s = _one(env, s, a)
        np.testing.assert_array_equal(s.board[0].numpy(), np.array(oracle.board, np.int8))
    if oracle.terminal():
        assert float(env.eval_score(s)[0]) == oracle.score()
    f = env.features(env.init(1, device="cpu"))[0].numpy()
    assert f.shape == (8, 8, 22) and f[0, 1, 16] == 6 / 8.0 and f[0, 0, 16] == 0.0


# ---------------------------------------------------------------- surakarta
def test_surakarta_tables_equal_the_jax_ones():
    j = JSurakarta(6, 50)
    wf, wv, wa = walk_tables(6)
    np.testing.assert_array_equal(wf, np.asarray(j._walk_from))
    np.testing.assert_array_equal(wv, np.asarray(j._walk_pos))
    np.testing.assert_array_equal(wa, np.asarray(j._walk_arc))
    t = SurakartaEnv(6, 50)
    tb = t._tables("cpu")
    np.testing.assert_array_equal(tb["is_nbr"].numpy(), np.asarray(j._is_nbr))
    np.testing.assert_array_equal(tb["key_a"].numpy(), np.asarray(j._key_a))
    np.testing.assert_array_equal(tb["key_b"].numpy(), np.asarray(j._key_b))
    assert t.spec.action_size == 1296


@pytest.mark.parametrize("n,limit,moves,seed", [(6, 50, 150, 0), (6, 12, 100, 1), (8, 20, 60, 2)])
def test_surakarta_random_playouts_match_jax(n, limit, moves, seed):
    """Captures along the circuits (the random mover prefers them), the
    no-capture limit ending games, a larger board's walk tables."""
    captures = []

    def choose(step, legal, rng, ts, action):
        nn = n * n
        enemy = ts.board.numpy()[:, np.arange(nn * nn) % nn] == (3 - ts.turn.numpy())[:, None]
        caps = legal & enemy
        pick = (rng.random(legal.shape) * caps + 1e-9 * caps).argmax(-1).astype(np.int32)
        use = caps.any(-1) & (rng.random(len(pick)) < 0.7)
        captures.append(int(use.sum()))
        return np.where(use, pick, action).astype(np.int32)

    ended, scores = playout_parity(JSurakarta(n, limit), SurakartaEnv(n, limit), moves, 8, seed,
                                   choose=choose)
    assert ended > 0 and sum(captures) > 0 and set(scores) <= {-1.0, 0.0, 1.0}


@pytest.mark.parametrize("seed", [0, 1])
def test_surakarta_oracle_playout(seed):
    env = SurakartaEnv(6, 50)
    oracle = PySurakarta()
    rng = np.random.RandomState(seed)
    s = env.init(1, device="cpu")
    for move in range(90):
        mask = env.legal_mask(s)[0].numpy()
        want = np.array([oracle.legal(a) for a in range(36 * 36)])
        np.testing.assert_array_equal(mask, want, err_msg=f"move {move}")
        assert bool(env.is_terminal(s)[0]) == oracle.terminal(), f"move {move}"
        if oracle.terminal():
            break
        legal = np.flatnonzero(want)
        caps = [a for a in legal if oracle.board[a % 36] == 3 - oracle.turn]
        a = int(rng.choice(caps if caps and rng.rand() < 0.7 else legal))
        oracle.play(a)
        s = _one(env, s, a)
        np.testing.assert_array_equal(s.board[0].numpy(), np.array(oracle.board, np.int8))
    if oracle.terminal():
        assert float(env.eval_score(s)[0]) == oracle.score()


def test_surakarta_known_circuit_capture():
    """A black piece on a red line captures around an arc (the oracle's
    hand position)."""
    env = SurakartaEnv(6, 50)
    oracle = PySurakarta()
    oracle.board = [0] * 36
    oracle.board[14] = 1
    oracle.board[12] = 2
    oracle.history = {(tuple(oracle.board), 1)}
    s = env.init(1, device="cpu")
    s.board = torch.tensor([oracle.board], dtype=torch.int8)
    s.hash_a, s.hash_b = env._hashes(s.board, s.turn)
    s.history_a = torch.zeros_like(s.history_a)
    s.history_b = torch.zeros_like(s.history_b)
    s.history_a[:, 0], s.history_b[:, 0] = s.hash_a, s.hash_b
    want = np.array([oracle.legal(a) for a in range(36 * 36)])
    np.testing.assert_array_equal(env.legal_mask(s)[0].numpy(), want)
    assert want[14 * 36 + 12]
    jenv = JSurakarta(6, 50)
    js = jenv.init().replace(board=jnp.asarray(np.array(oracle.board, np.int8)))
    ha, hb = jenv._board_hash(js.board, jnp.int8(1))
    js = js.replace(hash_a=ha, hash_b=hb, history_a=js.history_a.at[0].set(ha),
                    history_b=js.history_b.at[0].set(hb))
    assert (int(ha), int(hb)) == (int(s.hash_a[0]), int(s.hash_b[0]))
    np.testing.assert_array_equal(np.asarray(jax.jit(jenv.legal_mask)(js)), want)


# ---------------------------------------------------------------- self-play
@pytest.mark.parametrize("env_name", ["linesofaction", "surakarta"])
def test_gaz_moves_match_jax_engine(env_name):
    """Gumbel AlphaZero n=6 on tree step B1's plain version (the wide
    kernel's shapes, A = 1,456 and 1,296) against the JAX engine's Pallas
    kernel (interpret mode)."""
    engine_parity(env_name, "gaz", 6, opening=6)

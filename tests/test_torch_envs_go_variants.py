"""The port's NoGo and Kill-All-Go envs and its seki table, held against the
JAX package.

Random playouts from numpy seeds step the JAX env and the port's in
lock-step (every state field, legal mask, features, terminal flag, score
and player to move equal after every move). Benson's unconditional life is
compared on random and hand-built boards (the cases of
``tests/test_nogo_killallgo.py``), the seki test on positions built from
table rows and on their perturbations, and the port's copies of the seki
tables and their sorted lookup arrays word for word. All exact.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minizero_tpu.envs import seki7x7 as jseki
from minizero_tpu.envs.killallgo import KillAllGoEnv as JKillAllGo
from minizero_tpu.envs.nogo import NoGoEnv as JNoGo
from minizero_tpu_torch.config import default_config
from minizero_tpu_torch.envs import make_env
from minizero_tpu_torch.envs import seki7x7 as tseki
from minizero_tpu_torch.envs.killallgo import KillAllGoEnv
from minizero_tpu_torch.envs.nogo import NoGoEnv

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_env_parity import check_state, playout_parity, stone_labels  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401


def _rare_pass(nn):
    def choose(step, legal, rng, ts, action):
        # pass only when nothing else is legal, or with probability 0.05
        board_moves = legal[:, :nn].any(1)
        want_pass = legal[:, nn] & (~board_moves | (rng.random(len(action)) < 0.05))
        scores = rng.random(legal[:, :nn].shape) * legal[:, :nn]
        return np.where(want_pass, nn, scores.argmax(-1)).astype(np.int32)
    return choose


@pytest.mark.parametrize("board_size,moves,batch,seed", [(9, 90, 16, 0), (5, 40, 16, 1)])
def test_nogo_random_playouts_match_jax(board_size, moves, batch, seed):
    """Pass never legal; the mover without a legal move loses."""
    ended, scores = playout_parity(JNoGo(board_size), NoGoEnv(board_size), moves, batch, seed)
    assert ended > 0 and set(scores) <= {-1.0, 1.0}


def test_nogo_capture_is_illegal():
    env = NoGoEnv(5)
    s = env.init(1, device="cpu")
    assert not bool(env.legal_mask(s)[0, 25])
    for a in [7, 12, 11, 24, 13, 23]:  # B7 W12 B11 W24 B13 W23
        s = env.step(s, torch.tensor([a], dtype=torch.int32))
    assert not bool(env.legal_mask(s)[0, 17])  # would capture W12


@pytest.mark.parametrize("use_seki,ko_rule,seed", [(False, "positional", 2), (True, "positional", 3),
                                                   (False, "situational", 4)])
def test_killallgo_random_playouts_match_jax(use_seki, ko_rule, seed):
    """The move staging (White's first move a forced pass), Benson's
    terminal test and score, the superko rule, and the seki lookup."""
    jenv = JKillAllGo(7, use_seki=use_seki, ko_rule=ko_rule)
    tenv = KillAllGoEnv(7, use_seki=use_seki, ko_rule=ko_rule)
    ended, scores = playout_parity(jenv, tenv, 70, 12, seed, choose=_rare_pass(49))
    assert ended > 0 and set(scores) <= {-1.0, 1.0}
    assert tenv.benson_checks > 0


def _random_boards(count, seed):
    rng = np.random.default_rng(seed)
    density = rng.uniform(0.2, 0.95, size=(count, 1))
    black = rng.random((count, 49)) < density * rng.uniform(0.3, 0.9, size=(count, 1))
    white = ~black & (rng.random((count, 49)) < density)
    return np.where(black, 1, np.where(white, 2, 0)).astype(np.int8)


def _hand_built_boards():
    two_eyes = np.zeros(49, np.int8)
    two_eyes[[1, 3, 7, 8, 9, 10]] = 1  # eyes at 0 and 2
    one_eye = np.zeros(49, np.int8)
    one_eye[[1, 7, 8]] = 1
    full = np.ones(49, np.int8)
    full[[0, 2]] = 0
    return np.stack([two_eyes, one_eye, full])


def test_benson_matches_jax_on_random_and_hand_built_boards():
    """Stone labels and both players' pass-alive points on 64 random boards
    and the hand-built cases of tests/test_nogo_killallgo.py."""
    jenv, tenv = JKillAllGo(7), KillAllGoEnv(7)
    boards = np.concatenate([_hand_built_boards(), _random_boards(64, 5)])
    tboard = torch.from_numpy(boards)
    tlabels = stone_labels(tenv, tboard)
    jlabels = jax.vmap(jenv._stone_labels)(jnp.asarray(boards))
    np.testing.assert_array_equal(np.asarray(jlabels), tlabels.numpy())
    alive = 0
    for player in (1, 2):
        want = jax.vmap(lambda b, l, p=player: jenv._benson_bitboard(b, l, p))(
            jnp.asarray(boards), jlabels)
        got = tenv._benson_bitboard(tboard, tlabels, player)
        np.testing.assert_array_equal(np.asarray(want), got.numpy(), err_msg=f"player {player}")
        alive += int(got.any(1).sum())
    assert alive > 3
    got = tenv._benson_bitboard(tboard[:3], tlabels[:3], 1).numpy()
    expected = np.zeros(49, bool)
    expected[[0, 1, 2, 3, 7, 8, 9, 10]] = True
    np.testing.assert_array_equal(got[0], expected)  # two eyes: alive with its eyes
    assert not got[1].any() and got[2].all()  # one eye: dead; full board: all alive


def test_killallgo_legality_staging_and_white_wiped_out():
    env = KillAllGoEnv(7)
    s = env.init(1, device="cpu")
    mask = env.legal_mask(s)[0].numpy()
    assert not mask[49] and mask[:49].all()
    for a, want_pass, want_board in ((24, True, False), (49, False, True), (0, True, True)):
        s = env.step(s, torch.tensor([a], dtype=torch.int32))
        mask = env.legal_mask(s)[0].numpy()
        assert bool(mask[49]) == want_pass and bool(mask[:49].any()) == want_board
    board = torch.zeros((1, 49), dtype=torch.int8)
    board[0, [24, 25]] = 1
    state = dataclasses.replace(env.init(1, device="cpu"), board=board,
                                labels=stone_labels(env, board))
    assert float(env.eval_score(state)[0]) == 1.0


def _dilate(bits, eight):
    out = bits
    for i in range(49):
        if (bits >> i) & 1:
            r, c = divmod(i, 7)
            for dr in (-1, 0, 1):
                for dc in (-1, 0, 1):
                    if (eight or dr == 0 or dc == 0) and 0 <= r + dr < 7 and 0 <= c + dc < 7:
                        out |= 1 << ((r + dr) * 7 + c + dc)
    return out


def _seki_boards(table, rows):
    """For each table row: the position built from it (an inner black shape
    and its eyes, a White ring, an outer black wall), then the same with one
    ring stone removed (tests/test_nogo_killallgo.py:197-263)."""
    boards = []
    for row in rows:
        black, eyes = int(table[row, 0]), int(table[row, 1])
        shape = black | eyes
        ring = _dilate(shape, True) & ~shape
        outer = _dilate(ring, False) & ~shape & ~ring
        for white in (ring, ring & ~(ring & -ring)):
            board = np.zeros(49, np.int8)
            for i in range(49):
                if ((black | outer) >> i) & 1:
                    board[i] = 1
                elif (white >> i) & 1:
                    board[i] = 2
            boards.append(board)
    return np.stack(boards)


@pytest.mark.parametrize("sizes", [(5, 5), (5, 8)])
def test_killallgo_seki_detection_matches_jax(sizes):
    """Positions built from table rows and their perturbations: the port's
    seki test, terminal flag and score equal the JAX env's. With the 5-5
    table, the first five rows are seki and their opened twins are not, as
    the JAX package's test asserts; with the default 5-8 table, twelve rows
    drawn from a seed are compared."""
    jenv = JKillAllGo(7, use_seki=True, seki_min_size=sizes[0], seki_max_size=sizes[1])
    tenv = KillAllGoEnv(7, use_seki=True, seki_min_size=sizes[0], seki_max_size=sizes[1])
    table = tseki.ensure_table(*sizes)
    rows = (range(5) if sizes == (5, 5)
            else np.random.default_rng(6).choice(len(table), size=12, replace=False))
    boards = _seki_boards(table, rows)
    tboard = torch.from_numpy(boards)
    ts = dataclasses.replace(tenv.init(len(boards), device="cpu"), board=tboard,
                             labels=stone_labels(tenv, tboard))
    js = jax.vmap(lambda b: jenv.init().replace(board=b, labels=jenv._stone_labels(b)))(
        jnp.asarray(boards))
    check_state(js, ts, "built positions")
    got = tenv._seki_detected(ts).numpy()
    np.testing.assert_array_equal(np.asarray(jax.vmap(jenv._seki_detected)(js)), got)
    np.testing.assert_array_equal(np.asarray(jax.vmap(jenv.is_terminal)(js)),
                                  tenv.is_terminal(ts).numpy())
    np.testing.assert_array_equal(np.asarray(jax.vmap(jenv.eval_score)(js)),
                                  tenv.eval_score(ts).numpy())
    assert got[0::2].sum() >= 5
    if sizes == (5, 5):
        assert got[0::2].all() and not got[1::2].any()
        assert (tenv.eval_score(ts).numpy()[0::2] == -1.0).all()  # White survives


@pytest.mark.parametrize("sizes", [(5, 5), (5, 8)])
def test_seki_tables_and_lookup_arrays_equal_the_jax_packages(sizes):
    """The port's copies of the tracked tables, and the sorted hashes, words
    and window built from them, word for word."""
    want = jseki.ensure_table(*sizes)
    got = tseki.ensure_table(*sizes)
    assert got.dtype == want.dtype and len(got) > 100
    np.testing.assert_array_equal(got, want)
    for w, g in zip(jseki.sorted_device_table(want), tseki.sorted_device_table(got)):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    words = tseki.pack_words(got[:50, 0], got[:50, 1])
    np.testing.assert_array_equal(words, jseki.pack_words(want[:50, 0], want[:50, 1]))
    np.testing.assert_array_equal(tseki.mix_hash_np(words), jseki.mix_hash_np(words))


def test_killallgo_config_reaches_the_env():
    env = make_env(default_config("killallgo", env_killallgo_ko_rule="situational",
                                  env_killallgo_use_seki=True))
    assert isinstance(env, KillAllGoEnv) and env.situational and env.use_seki
    assert env.spec.action_size == 50
    assert not make_env(default_config("killallgo")).situational

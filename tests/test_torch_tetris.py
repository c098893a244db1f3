"""The port's Tetris Block Puzzle env held against the JAX package.

The action and mask tables and the row / column clear equal the JAX ones.
Playouts step both envs in lock-step; the two packages' chance streams
differ, so the port's ``place`` is handed the block the JAX env drew, read
off its stepped hand (or preview queue), and every field but the stream is
equal after every move. The stream's blocks are uniform over the 19
shapes (chi-square at a fixed seed), and the cases of
``tests/test_tetrisblockpuzzle.py`` run on the port.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from minizero_tpu.envs import tetrisblockpuzzle as jtetris
from minizero_tpu_torch.envs import chance
from minizero_tpu_torch.envs import tetrisblockpuzzle as ttetris
from minizero_tpu_torch.envs.tetrisblockpuzzle import TetrisBlockPuzzleEnv, TetrisState

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_env_parity import playout_parity  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

_ENV = TetrisBlockPuzzleEnv(3, 0)


def _state(board, holding, preview=()):
    n = 1
    return TetrisState(
        board=torch.as_tensor(np.asarray(board, bool)).reshape(n, 64),
        holding=torch.tensor([holding], dtype=torch.int8),
        preview=torch.tensor([list(preview)], dtype=torch.int8).reshape(n, len(preview)),
        reward=torch.zeros((n,)), total=torch.zeros((n,)),
        num_moves=torch.zeros((n,), dtype=torch.int32),
        key=torch.zeros((n,), dtype=torch.int64), counter=torch.zeros((n,), dtype=torch.int64))


def test_tables_equal_the_jax_ones():
    assert ttetris._BLOCKS == jtetris._BLOCKS
    masks, ids = ttetris._action_tables()
    jmasks, jids = jtetris._action_tables()
    np.testing.assert_array_equal(masks, jmasks)
    np.testing.assert_array_equal(ids, jids)
    assert masks.shape == (801, 64) and (masks.sum(1) == 4).all()


def test_crash_matches_jax():
    rng = np.random.default_rng(0)
    boards = rng.random((64, 64)) < 0.8
    boards[::4, :8] = True   # full rows and columns in some boards
    boards[1::4, ::8] = True
    got, count = TetrisBlockPuzzleEnv.crash(torch.from_numpy(boards))
    jcrash = jax.jit(jax.vmap(jtetris.TetrisBlockPuzzleEnv()._crash))
    want, wcount = jcrash(jnp.asarray(boards))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(count.numpy(), np.asarray(wcount))
    assert int(count.max()) >= 2


def _from_jax(js):
    b = np.asarray(js.board).shape[0]
    return TetrisState(
        board=torch.from_numpy(np.array(js.board)), holding=torch.from_numpy(np.array(js.holding)),
        preview=torch.from_numpy(np.array(js.preview)), reward=torch.from_numpy(np.array(js.reward)),
        total=torch.from_numpy(np.array(js.total)),
        num_moves=torch.from_numpy(np.array(js.num_moves)),
        key=torch.zeros((b,), dtype=torch.int64), counter=torch.zeros((b,), dtype=torch.int64))


def jax_blocks(env, ts, action, js_next):
    """The chance block the JAX env drew: the last of its stepped preview
    queue, or with no queue the block its stepped hand holds in place of
    the one played (any block where the placement did not fit)."""
    if env.np_ > 0:
        return torch.from_numpy(np.array(js_next.preview)[:, -1])
    ids = ttetris._action_tables()[1]
    new = np.array(js_next.holding)
    out = np.zeros(new.shape[0], np.int8)
    for i, a in enumerate(action.tolist()):
        rest = ts.holding[i].tolist()
        if ids[a] in rest:
            rest.remove(int(ids[a]))
        left = new[i].tolist()
        for x in rest:
            if x in left:
                left.remove(x)
        out[i] = left[0] if len(left) == 1 else 0
    return torch.from_numpy(out)


@pytest.mark.parametrize("nh,npv,moves,batch,seed", [(3, 0, 80, 16, 0), (2, 2, 60, 16, 1)])
def test_random_playouts_match_jax_with_its_blocks(nh, npv, moves, batch, seed):
    """Every field but the stream equal after every move, games restarting
    when no placement is left."""
    env = TetrisBlockPuzzleEnv(nh, npv)
    hook = (("key", "counter"), _from_jax,
            lambda ts, a, js: env.place(ts, a, jax_blocks(env, ts, a, js)))
    ended, scores = playout_parity(jtetris.TetrisBlockPuzzleEnv(nh, npv), env, moves, batch, seed,
                                   chance=hook)
    assert ended > 0 and min(scores) >= 0


def test_stream_blocks_are_uniform_and_depend_on_the_game_only():
    n = 19 * 1000
    s = _ENV.init_random(n, torch.Generator().manual_seed(3), device="cpu")
    counts = np.bincount(s.holding.reshape(-1).numpy(), minlength=19)
    assert stats.chisquare(counts).pvalue > 1e-3
    # a stepped game draws the same block alone as in its batch, twice
    a = torch.from_numpy(np.argmax(_ENV.legal_mask(s).numpy(), 1).astype(np.int32))
    full = _ENV.step(s, a)
    new = chance.uniform_int(s.key, s.counter, 19)
    assert stats.chisquare(np.bincount(new.numpy(), minlength=19)).pvalue > 1e-3
    one = TetrisState(**{k: getattr(s, k)[5:6] for k in s.__dataclass_fields__})
    for _ in range(2):
        alone = _ENV.step(one, a[5:6])
        assert torch.equal(alone.holding, full.holding[5:6])


def test_legal_requires_block_in_hand_and_fit():
    s = _ENV.init_random(4, torch.Generator().manual_seed(0), device="cpu")
    mask = _ENV.legal_mask(s).numpy()
    ids = ttetris._action_tables()[1]
    for i in range(4):
        assert set(ids[np.flatnonzero(mask[i])].tolist()) <= set(s.holding[i].tolist())
        assert mask[i].any()


def test_place_clears_rows_and_columns():
    board = np.zeros(64, bool)
    board[2:8] = True
    s = _state(board, [0, 5, 6])
    assert bool(_ENV.legal_mask(s)[0, 0])
    s2 = _ENV.place(s, torch.tensor([0], dtype=torch.int32), torch.tensor([4], dtype=torch.int8))
    b = s2.board[0].numpy().reshape(8, 8)
    assert float(s2.reward[0]) == 1.0 and not b[0].any() and b[1, 0] and b[1, 1]
    assert s2.holding[0].tolist() == [4, 5, 6]
    board = np.zeros((8, 8), bool)
    board[0, 2:] = True
    board[2:, 0] = True
    board[2:, 1] = True
    s = _state(board.reshape(-1), [0, 0, 0])
    s2 = _ENV.step(s, torch.tensor([0], dtype=torch.int32))
    b = s2.board[0].numpy().reshape(8, 8)
    assert float(s2.reward[0]) == 3.0 and not b[0].any() and not b[:, :2].any()


def test_preview_queue_fifo_and_a_misfit_changes_nothing():
    env = TetrisBlockPuzzleEnv(2, 2)
    s = env.init_random(1, torch.Generator().manual_seed(3), device="cpu")
    first = int(s.preview[0, 0])
    a = torch.tensor([int(np.flatnonzero(env.legal_mask(s)[0].numpy())[0])], dtype=torch.int32)
    s2 = env.step(s, a)
    assert first in s2.holding[0].tolist() and tuple(s2.preview.shape) == (1, 2)
    s3 = env.step(s2, a)  # the same cells again: no fit
    assert torch.equal(s3.board, s2.board) and torch.equal(s3.holding, s2.holding)
    assert float(s3.reward[0]) == 0.0 and int(s3.counter[0]) == int(s2.counter[0]) + 1


def test_playout_accumulates_reward_and_features():
    s = _ENV.init_random(1, torch.Generator().manual_seed(4), device="cpu")
    rng = np.random.RandomState(0)
    total = 0.0
    for _ in range(200):
        mask = _ENV.legal_mask(s)[0].numpy()
        if not mask.any():
            break
        s = _ENV.step(s, torch.tensor([int(rng.choice(np.flatnonzero(mask)))], dtype=torch.int32))
        total += float(s.reward[0])
    assert float(s.total[0]) == total
    assert tuple(_ENV.features(s).shape) == (1, 8, 8, 59)
    af = _ENV.action_features(torch.tensor([0, 800], dtype=torch.int32))
    assert tuple(af.shape) == (2, 19, 8, 8) and float(af[0, 0].sum()) == 4 and float(af[1].sum()) == 4

"""The port's 2048 env, its trained Gumbel MuZero net, and self-play on it
with in-tree rewards, held against the JAX package.

* The slide against JAX's ``_slide`` and a transparent oracle on random
  boards, all four directions (exact).
* Playouts in lock-step with the JAX env: the two packages' chance streams
  differ, so the port's ``spawn`` is handed the cell and the tile read off
  the JAX board after its slide (``playout_parity``'s chance hook); every
  field but the stream is equal after every move.
* The chance stream: tile frequencies and cell choice pass a chi-square
  test at a fixed seed; a game's draw depends on its state only, not on
  its slot, the batch size or the other games.
* The cases of ``tests/test_puzzle2048.py`` on the port.
* The trained net (``minizero_tpu_torch/assets/p2048_gmz_r5_iter30000.npz``)
  against the JAX checkpoint: initial and recurrent inference in float32
  within 1e-4 (the value is a 601-bin distribution read back through the
  value transform, up to ~600).
* Gumbel MuZero and Gumbel / plain AlphaZero moves against the JAX engine
  on integer parity nets with 601-bin values, with spawns forced on both
  sides by test-only subclasses (a spawn that is a function of the board):
  root visits through the actions, which are exact, and policy targets and
  root values within ``tests/test_torch_engine.py``'s bounds. AlphaZero
  on 2048 hands the env's leaf rewards to the tree step (its reward
  regime); the JAX engine runs the same semantics on its plain loop.
* One zero iteration of Gumbel MuZero on 2048 through the port's
  ``ZeroLoop`` (the mirror of ``test_stochastic_training_flow``).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats
from torch import nn

from minizero_tpu.envs.puzzle2048 import Puzzle2048Env as JPuzzle
from minizero_tpu.envs.puzzle2048 import _slide
from minizero_tpu_torch.envs import chance
from minizero_tpu_torch.envs.puzzle2048 import Puzzle2048Env, Puzzle2048State

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from parity_common import ACTION_OFFSET, MZ_MOD  # noqa: E402
from test_puzzle2048 import _oracle_slide  # noqa: E402
from torch_env_parity import engine_parity, playout_parity  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ENV = Puzzle2048Env()


def _state(board, **kw):
    b = torch.as_tensor(np.asarray(board, np.int8)).reshape(-1, 16)
    n = b.shape[0]
    f = torch.zeros((n,), dtype=torch.float32)
    return Puzzle2048State(board=b, reward=kw.get("reward", f), total=kw.get("total", f),
                           num_moves=torch.zeros((n,), dtype=torch.int32),
                           key=torch.arange(n, dtype=torch.int64),
                           counter=torch.zeros((n,), dtype=torch.int64))


# ------------------------------------------------------------------ slides
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_slide_matches_jax_and_the_oracle(seed):
    rng = np.random.RandomState(seed)
    boards = rng.randint(0, 6 + 4 * seed, (40, 16)).astype(np.int8)
    got, scores, changed = _ENV.slide_all(torch.from_numpy(boards))
    jslide = jax.jit(jax.vmap(lambda b, d: _slide(b.reshape(4, 4), d), in_axes=(0, None)))
    for d in range(4):
        nb, score, ch = jslide(jnp.asarray(boards), jnp.int32(d))
        np.testing.assert_array_equal(got[:, d].numpy(), np.asarray(nb).reshape(-1, 16))
        np.testing.assert_array_equal(scores[:, d].numpy(), np.asarray(score))
        np.testing.assert_array_equal(changed[:, d].numpy(), np.asarray(ch))
    for i, board in enumerate(boards):
        for d in range(4):
            ob, oscore, och = _oracle_slide(board, d)
            np.testing.assert_array_equal(got[i, d].numpy(), ob)
            assert (int(scores[i, d]), bool(changed[i, d])) == (oscore, och)


def test_slide_table_reaches_the_largest_tile():
    """Two 65536 tiles (exponent 16) merge into 131072 (17), and a line of
    the largest tile slides."""
    got, scores, _ = _ENV.slide_all(torch.tensor([[16, 16, 17, 0] + [0] * 12], dtype=torch.int8))
    assert got[0, 3, :4].tolist() == [17, 17, 0, 0] and int(scores[0, 3]) == 1 << 17


def test_merge_priority_and_double_merge():
    got, scores, _ = _ENV.slide_all(torch.tensor([[2, 2, 2, 0] * 4, [1, 1, 2, 2] * 4],
                                                 dtype=torch.int8))
    assert got[0, 3, :4].tolist() == [3, 2, 0, 0] and int(scores[0, 3]) == 4 * 8
    assert got[1, 3, :4].tolist() == [2, 3, 0, 0] and int(scores[1, 3]) == 4 * (4 + 8)


# ------------------------------------------------------ lock-step playouts
def _from_jax(js):
    b = np.asarray(js.board).shape[0]
    return Puzzle2048State(
        board=torch.from_numpy(np.array(js.board)), reward=torch.from_numpy(np.array(js.reward)),
        total=torch.from_numpy(np.array(js.total)),
        num_moves=torch.from_numpy(np.array(js.num_moves)),
        key=torch.zeros((b,), dtype=torch.int64), counter=torch.zeros((b,), dtype=torch.int64))


def jax_spawns(slid, jboard):
    """(nth, tile) of the tile the JAX env spawned on ``slid`` (its board
    after the slide) to give ``jboard``: the new tile's rank among the
    empty cells, and its exponent."""
    slid = slid.numpy()
    new = (slid == 0) & (jboard != 0)
    cum = np.cumsum(slid == 0, axis=1) - 1
    nth = np.where(new.any(1), (cum * new).sum(1), 0)
    tile = np.where(new.any(1), (jboard * new).sum(1), 1)
    return torch.from_numpy(nth.astype(np.int64)), torch.from_numpy(tile.astype(np.int8))


def step_with_jax_spawns(env, ts, action, js_next):
    board, score, changed = env.slide(ts, action)
    nth, tile = jax_spawns(board, np.asarray(js_next.board))
    return env.after_slide(ts, board, score, changed, env.spawn(board, nth, tile))


@pytest.mark.parametrize("moves,batch,seed", [(300, 16, 0), (120, 32, 1)])
def test_random_playouts_match_jax_with_its_spawns(moves, batch, seed):
    """Every field but the stream equal after every move; games run to
    their end and restart."""
    env = Puzzle2048Env()
    hook = (("key", "counter"), _from_jax,
            lambda ts, a, js: step_with_jax_spawns(env, ts, a, js))
    ended, scores = playout_parity(JPuzzle(), env, moves, batch, seed, chance=hook)
    if moves >= 300:
        assert ended > 0 and min(scores) > 0


# -------------------------------------------------------------- the stream
def test_spawn_frequencies_pass_a_chi_square_test():
    """20000 games on one board with 14 empty cells, each with its own key:
    the tile is 2 with probability 0.9, the cell uniform over the empty
    ones."""
    n = 20000
    board = np.zeros((n, 16), np.int8)
    board[:, [5, 10]] = [3, 1]
    s = _state(board)
    s.key = chance.new_keys(n, torch.Generator().manual_seed(12), "cpu")
    out = _ENV.step(s, torch.zeros((n,), dtype=torch.int32)).board.numpy()  # up
    slid = _ENV.slide(s, torch.zeros((n,), dtype=torch.int32))[0].numpy()
    new = (out != slid)
    assert (new.sum(1) == 1).all()
    tiles = out[new]
    assert stats.chisquare([(tiles == 1).sum(), (tiles == 2).sum()], [0.9 * n, 0.1 * n]).pvalue > 1e-3
    cells = np.argmax(new, 1)
    empty = np.flatnonzero(slid[0] == 0)
    counts = np.array([(cells == c).sum() for c in empty])
    assert counts.sum() == n
    assert stats.chisquare(counts).pvalue > 1e-3


def test_draws_depend_on_the_game_only():
    """The same state and action give the same spawn at any slot and batch
    size, and stepping a state twice (a revisited tree node) repeats it."""
    s = _ENV.init_random(12, torch.Generator().manual_seed(5), device="cpu")
    a = torch.from_numpy(np.argmax(_ENV.legal_mask(s).numpy(), 1).astype(np.int32))
    full = _ENV.step(s, a)
    again = _ENV.step(s, a)
    assert torch.equal(full.board, again.board)
    perm = torch.tensor([7, 3, 11])
    part = _ENV.step(Puzzle2048State(**{k: getattr(s, k)[perm] for k in s.__dataclass_fields__}),
                     a[perm])
    assert torch.equal(part.board, full.board[perm])
    assert torch.equal(part.counter, full.counter[perm])


def test_init_random_and_step_invariants():
    """Two starting tiles of exponent 1 or 2; a step adds exactly one tile
    to the oracle's slide, and the total is the slide's score."""
    s = _ENV.init_random(8, torch.Generator().manual_seed(0), device="cpu")
    b0 = s.board.numpy()
    assert ((b0 > 0).sum(1) == 2).all() and set(b0[b0 > 0].tolist()) <= {1, 2}
    a = torch.from_numpy(np.argmax(_ENV.legal_mask(s).numpy(), 1).astype(np.int32))
    s2 = _ENV.step(s, a)
    for i in range(8):
        ob, oscore, _ = _oracle_slide(b0[i], int(a[i]))
        diff = (s2.board[i].numpy() != ob) & (ob == 0)
        assert diff.sum() == 1 and s2.board[i].numpy()[np.argmax(diff)] in (1, 2)
        assert float(s2.total[i]) == oscore == float(s2.reward[i])


def test_illegal_action_is_noop_and_terminal():
    board = np.zeros(16, np.int8)
    board[[0, 1]] = [1, 2]
    s = _state(board)
    assert not bool(_ENV.legal_mask(s)[0, 0])
    s2 = _ENV.step(s, torch.tensor([0], dtype=torch.int32))
    assert torch.equal(s2.board, s.board) and float(s2.reward[0]) == 0.0
    full = np.array([[1, 2, 1, 2], [2, 1, 2, 1], [1, 2, 1, 2], [2, 1, 2, 1]], np.int8).reshape(-1)
    assert bool(_ENV.is_terminal(_state(full))[0])
    full[0] = 2
    assert not bool(_ENV.is_terminal(_state(full))[0])


def test_features_and_action_features():
    s = _ENV.init_random(2, torch.Generator().manual_seed(0), device="cpu")
    f = _ENV.features(s)
    assert tuple(f.shape) == (2, 4, 4, 16) and float(f[0].sum()) == 16
    af = _ENV.action_features(torch.tensor([2, 0], dtype=torch.int32))
    assert tuple(af.shape) == (2, 4, 4, 4)
    assert bool((af[0, 2] == 1).all()) and float(af[0].sum()) == 16 and float(af[1, 0].sum()) == 16


# ---------------------------------------------------------- the trained net
def test_trained_2048_net_matches_the_jax_checkpoint():
    """The npz holds the checkpoint's variables; the port's net gives the
    JAX net's policy, value and hidden state on positions of random
    playouts, and after one recurrent step on random actions. The
    board-game MuZero net has no reward head in either package."""
    from minizero_tpu.config import algorithm_preset as j_preset
    from minizero_tpu.config import default_config as j_default
    from minizero_tpu.eval.match import load_checkpoint_variables
    from minizero_tpu.models.factory import create_network as j_create
    from minizero_tpu_torch.config import algorithm_preset, default_config
    from minizero_tpu_torch.models.factory import create_network
    from minizero_tpu_torch.utils.transforms import from_discrete_value
    from minizero_tpu_torch.weights import from_jax_muzero_variables, load_variables_npz

    ckpt = os.path.join(ROOT, "runs", "p2048_gmz_r5", "model", "weight_iter_30000.ckpt")
    npz = os.path.join(ROOT, "minizero_tpu_torch", "assets", "p2048_gmz_r5_iter30000.npz")
    jcfg = j_default("puzzle2048", **j_preset("gmz"))
    jenv = JPuzzle()
    jnet = j_create(jcfg, jenv.spec)
    variables = load_checkpoint_variables(ckpt, jcfg, jnet, jenv.spec)
    loaded = load_variables_npz(npz)
    flat = jax.tree_util.tree_leaves_with_path(variables)
    assert len(flat) == 54 == sum(1 for _ in jax.tree_util.tree_leaves(loaded))
    for path, leaf in flat:
        node = loaded
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(node, np.asarray(leaf))

    rng = np.random.default_rng(30000)
    s = _ENV.init_random(16, torch.Generator().manual_seed(1), device="cpu")
    for _ in range(int(rng.integers(10, 60))):
        legal = _ENV.legal_mask(s).numpy()
        a = (rng.random(legal.shape) * legal + 1e-9).argmax(-1).astype(np.int32)
        s = _ENV.step(s, torch.from_numpy(a))
    feats = _ENV.features(s)
    actions = torch.from_numpy(rng.integers(0, 4, 16).astype(np.int32))
    jout = jnet.apply(variables, jnp.asarray(feats.numpy()), method=jnet.initial_inference)
    jplanes = jax.vmap(jenv.action_features)(jnp.asarray(actions.numpy()))
    jrec = jnet.apply(variables, jout["hidden_state"], jplanes, method=jnet.recurrent_inference)
    cfg = default_config("puzzle2048", **algorithm_preset("gmz"))
    net = create_network(cfg, _ENV.spec)
    net.load_state_dict(from_jax_muzero_variables(loaded, hidden_hw=16))
    net.eval()
    with torch.no_grad():
        out = net.initial_inference(feats)
        rec = net.recurrent_inference(out["hidden_state"], _ENV.action_features(actions))
    for got, want in ((out, jout), (rec, jrec)):
        assert "reward" not in got and "reward" not in want
        np.testing.assert_allclose(got["policy"].numpy(), np.asarray(want["policy"]), atol=1e-5)
        np.testing.assert_allclose(got["value"].numpy(), np.asarray(want["value"]), atol=1e-5)
        np.testing.assert_allclose(got["hidden_state"].permute(0, 2, 3, 1).numpy(),
                                   np.asarray(want["hidden_state"]), atol=1e-4)
        v = from_discrete_value(got["value"])
        vj = from_discrete_value(torch.from_numpy(np.array(want["value"])))
        np.testing.assert_allclose(v.numpy(), vj.numpy(), rtol=1e-4, atol=1e-3)
    assert float(from_discrete_value(out["value"]).mean()) > 50.0  # a trained value, not ~0


# --------------------------------------------------------- self-play parity
_BINS = 601
_VALUE_MOD = 8.0


def _value_bins_jax(t):
    """A 601-bin one-hot at 300 - 4 + (t mod 8): exact in both packages."""
    b = (t - _VALUE_MOD * jnp.floor(t / _VALUE_MOD)).astype(jnp.int32) + _BINS // 2 - 4
    return (b[:, None] == jnp.arange(_BINS)[None, :]).astype(jnp.float32)


def _value_bins_torch(t):
    b = (t - _VALUE_MOD * torch.floor(t / _VALUE_MOD)).long() + _BINS // 2 - 4
    return (b[:, None] == torch.arange(_BINS)[None, :]).float()


def _weights(seed=20261017):
    rng = np.random.Generator(np.random.PCG64(seed))
    return {"Wp": rng.integers(-7, 8, size=(256, 4)).astype(np.float32),      # x: 16 x 16 planes
            "Wv": rng.integers(-3, 4, size=(256,)).astype(np.float32),
            "Wr": rng.integers(-3, 4, size=(256, 64)).astype(np.float32),      # hidden K = 64
            "Wd": rng.integers(-2, 3, size=(64, 64)).astype(np.float32),
            "Wa": rng.integers(-7, 8, size=(64, 64)).astype(np.float32),       # 4 x 4 x 4 planes
            "Wq": rng.integers(-7, 8, size=(64, 4)).astype(np.float32),
            "Wu": rng.integers(-3, 4, size=(64,)).astype(np.float32)}


def jax_parity_nets():
    """(AlphaZero net, variables, MuZero net, variables) in flax: integer
    weights on NCHW-flattened inputs, 601-bin values."""
    from flax import linen as fnn

    from minizero_tpu.models.alphazero import AlphaZeroNetwork
    from minizero_tpu.models.muzero import MuZeroNetwork

    def flat(x):
        return jnp.transpose(x.astype(jnp.float32), (0, 3, 1, 2)).reshape(x.shape[0], -1)

    offset = jnp.arange(4, dtype=jnp.float32) * ACTION_OFFSET

    class AZ(AlphaZeroNetwork):
        @fnn.compact
        def __call__(self, state, train: bool = False):
            x = flat(state)
            wp = self.param("Wp", fnn.initializers.zeros, (256, 4), jnp.float32)
            wv = self.param("Wv", fnn.initializers.zeros, (256,), jnp.float32)
            logits = x @ wp / 32.0 + offset
            return {"policy_logit": logits, "policy": fnn.softmax(logits, -1),
                    "value": _value_bins_jax(x @ wv)}

    class MZ(MuZeroNetwork):
        def setup(self):
            z = fnn.initializers.zeros
            for name, shape in (("Wr", (256, 64)), ("Wd", (64, 64)), ("Wa", (64, 64)),
                                ("Wq", (64, 4)), ("Wu", (64,))):
                setattr(self, name, self.param(name, z, shape, jnp.float32))

        def _predict(self, h):
            logits = h @ self.Wq / 256.0 + offset
            return {"policy_logit": logits, "policy": fnn.softmax(logits, -1),
                    "value": _value_bins_jax(h @ self.Wu), "hidden_state": h}

        def initial_inference(self, state, train: bool = False):
            t = flat(state) @ self.Wr
            return self._predict(t - MZ_MOD * jnp.floor(t / MZ_MOD))

        def recurrent_inference(self, hidden_state, action_plane, train: bool = False):
            t = hidden_state @ self.Wd + flat(action_plane) @ self.Wa
            return self._predict(t - MZ_MOD * jnp.floor(t / MZ_MOD))

        def __call__(self, state, train: bool = False):
            return self.initial_inference(state, train)

    w = {k: jnp.asarray(v) for k, v in _weights().items()}
    az = AZ(num_input_channels=16, input_height=4, input_width=4, num_hidden_channels=1,
            hidden_height=4, hidden_width=4, num_blocks=0, action_size=4,
            num_value_hidden_channels=1, discrete_value_size=_BINS)
    mz = MZ(num_input_channels=16, input_height=4, input_width=4, num_hidden_channels=4,
            hidden_height=4, hidden_width=4, num_action_feature_channels=4, num_blocks=0,
            action_size=4, num_value_hidden_channels=1, discrete_value_size=_BINS)
    return (az, {"params": {"Wp": w["Wp"], "Wv": w["Wv"]}},
            mz, {"params": {k: w[k] for k in ("Wr", "Wd", "Wa", "Wq", "Wu")}})


class TorchAZ(nn.Module):
    def __init__(self):
        super().__init__()
        for k, v in _weights().items():
            self.register_buffer(k.lower(), torch.from_numpy(v))

    def forward(self, state):
        x = state.float().permute(0, 3, 1, 2).reshape(state.shape[0], -1)
        logits = x @ self.wp / 32.0 + torch.arange(4, dtype=torch.float32) * ACTION_OFFSET
        return {"policy_logit": logits, "policy": torch.softmax(logits, -1),
                "value": _value_bins_torch(x @ self.wv)}


class TorchMZ(TorchAZ):
    def _predict(self, h):
        logits = h @ self.wq / 256.0 + torch.arange(4, dtype=torch.float32) * ACTION_OFFSET
        return {"policy_logit": logits, "policy": torch.softmax(logits, -1),
                "value": _value_bins_torch(h @ self.wu), "hidden_state": h}

    def initial_inference(self, state):
        t = state.float().permute(0, 3, 1, 2).reshape(state.shape[0], -1) @ self.wr
        return self._predict(t - MZ_MOD * torch.floor(t / MZ_MOD))

    def recurrent_inference(self, hidden_state, action_plane):
        t = hidden_state @ self.wd + action_plane.float().reshape(action_plane.shape[0], -1) @ self.wa
        return self._predict(t - MZ_MOD * torch.floor(t / MZ_MOD))

    def forward(self, state):
        return self.initial_inference(state)


class JForcedSpawn(JPuzzle):
    """The JAX env with a spawn that is a function of the board: the
    ``(7 s + 3) mod n_empty``-th empty cell, exponent 2 when ``s`` (the sum
    of the exponents) is a multiple of 10, else 1."""

    def _spawn(self, board, rng):
        empty = board == 0
        n_empty = jnp.sum(empty.astype(jnp.int32))
        s = jnp.sum(board.astype(jnp.int32))
        nth = (7 * s + 3) % jnp.maximum(n_empty, 1)
        cum = jnp.cumsum(empty.astype(jnp.int32)) - 1
        pos = jnp.argmax(empty & (cum == nth))
        tile = jnp.where(s % 10 == 0, 2, 1).astype(board.dtype)
        return jnp.where(n_empty > 0, board.at[pos].set(tile), board)


class ForcedSpawn(Puzzle2048Env):
    """The port's env with the same spawn."""

    def _spawn_from_stream(self, board, key, counter):
        n_empty = (board == 0).sum(1).clamp(min=1)
        s = board.long().sum(1)
        tile = torch.where(s % 10 == 0, 2, 1).to(torch.int8)
        return self.spawn(board, (7 * s + 3) % n_empty, tile)


@pytest.mark.parametrize("algo,sims,opening", [("gmz", 8, 30), ("gaz", 8, 30), ("az", 12, 50)])
def test_selfplay_matches_jax_engine_with_forced_spawns(algo, sims, opening):
    """Gumbel MuZero (B1's board regime with value rescale: the board-game
    MuZero net has no reward head), and Gumbel and plain AlphaZero with the
    env's rewards in the tree (the port's B1' against the JAX engine's plain
    loop), from random openings: root visits and actions exact, root values
    up to ~700."""
    az, az_vars, mz, mz_vars = jax_parity_nets()
    nets = (mz, mz_vars, TorchMZ()) if algo == "gmz" else (az, az_vars, TorchAZ())
    eng = engine_parity("puzzle2048", algo, sims, moves=4, batch=6, opening=opening,
                        over={"nn_type_name": "muzero" if algo == "gmz" else "alphazero"},
                        jenv=JForcedSpawn(), tenv=ForcedSpawn(), nets=nets,
                        stream_fields=("key", "counter"), root_visits=True)
    assert eng.is_muzero == (algo == "gmz") and not eng.use_tree_kernel_v2
    assert eng.env_rewards


def test_reward_regime_reaches_the_tree():
    """An AlphaZero search on 2048 stores the leaves' merge scores in the
    tree (B1's reward regime); the MuZero search does not (no reward
    head)."""
    from minizero_tpu_torch.config import algorithm_preset, default_config
    from minizero_tpu_torch.selfplay.engine import SelfPlayEngine

    over = dict(algorithm_preset("gaz"))
    over.update(actor_num_simulation=8, actor_gumbel_sample_size=4, nn_type_name="alphazero")
    cfg = default_config("puzzle2048", **over)
    eng = SelfPlayEngine(ForcedSpawn(), cfg, TorchAZ(), use_bf16=False, device="cpu")
    s = eng.init_batch(4)
    for _ in range(10):
        s = eng.move(s).states
    trees = eng.search_trees(s)
    assert bool((trees.reward[:, 1:] > 0).any())
    assert eng.spec.value_rescale and eng.spec.discount == 1.0


# --------------------------------------------------------------- zero loop
def test_stochastic_training_flow_on_the_port(tmp_path):
    """One Gumbel MuZero iteration on 2048 through the port's ZeroLoop:
    records with per-move rewards, a game's result equal to the sum of its
    rewards, n-step value targets that are not zero, a checkpoint."""
    from minizero_tpu_torch.config import algorithm_preset, default_config
    from minizero_tpu_torch.zero.loop import ZeroLoop

    over = dict(algorithm_preset("gmz"))
    over.update(actor_num_simulation=3, actor_gumbel_sample_size=3, nn_num_blocks=1,
                nn_num_hidden_channels=8, nn_num_value_hidden_channels=8,
                zero_num_parallel_games=4, zero_num_games_per_iteration=4,
                learner_training_step=2, learner_training_display_step=2, learner_batch_size=4,
                learner_muzero_unrolling_step=2, zero_end_iteration=2, program_auto_seed=False)
    cfg = default_config("puzzle2048", **over)
    loop = ZeroLoop(cfg, str(tmp_path / "run"), device="cpu")
    loop.run()
    assert int(loop.state.step) == 4
    rec = loop.buffer.games[0]
    assert rec.rewards.sum() > 0
    assert abs(rec.result - rec.rewards.sum()) < 1e-3
    assert loop.buffer.value_target(rec, 0) != 0.0
    assert os.path.exists(tmp_path / "run" / "model" / "weight_iter_4.ckpt")
    loop.close()

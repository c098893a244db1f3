"""The port's Othello and Clobber envs, and self-play on them, held against
the JAX package.

Random playouts from numpy seeds step the JAX env and the port's in
lock-step: every state field, the legal mask, the features, the terminal
flag, the score and the player to move are equal after every move (exact).
The oracle cases of ``tests/test_othello.py`` and
``tests/test_connect6_clobber_breakthrough.py`` run on the port. Then a
tiny integer parity net (exact in both frameworks) plays Gumbel and plain
AlphaZero self-play through both engines with noise and rotation off:
actions exact, policy targets and root values within the bounds of
``tests/test_torch_engine.py``. Clobber's 400 actions are more than a
register row of the CUDA tree steps holds; its plain AlphaZero runs the
large-N loop (tree step B2, row gather B3), forced at n=10.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minizero_tpu.config import default_config as j_default
from minizero_tpu.envs import make_env as j_make_env
from minizero_tpu.envs.clobber import ClobberEnv as JClobber
from minizero_tpu.envs.othello import OthelloEnv as JOthello
from minizero_tpu_torch.config import algorithm_preset, default_config
from minizero_tpu_torch.envs import make_env
from minizero_tpu_torch.envs.clobber import ClobberEnv
from minizero_tpu_torch.envs.othello import OthelloEnv

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_env_parity import engine_parity, playout_parity  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401


@pytest.mark.parametrize("board_size,moves,batch,seed", [(8, 130, 16, 0), (6, 80, 16, 1)])
def test_othello_random_playouts_match_jax(board_size, moves, batch, seed):
    """Pass forced when nothing else is legal, two passes end the game,
    the score reads the stone count once neither side can place."""
    ended, scores = playout_parity(JOthello(board_size), OthelloEnv(board_size), moves, batch,
                                   seed)
    assert ended > 0 and set(scores) <= {-1.0, 0.0, 1.0}


def test_othello_initial_moves_and_flip():
    """The oracle cases of tests/test_othello.py on the port: the opening
    moves, and a move that flips along one ray."""
    env = OthelloEnv(8)
    s = env.init(1, device="cpu")
    legal = np.flatnonzero(env.legal_mask(s)[0].numpy())
    assert sorted(legal.tolist()) == [19, 26, 37, 44]
    s = env.step(s, torch.tensor([19], dtype=torch.int32))
    board = s.board[0].numpy()
    assert board[19] == 1 and board[27] == 1  # d4 flipped to black
    assert int((board == 1).sum()) == 4 and int((board == 2).sum()) == 1
    assert int(s.turn[0]) == 2


@pytest.mark.parametrize("board_size,moves,batch,seed", [(10, 100, 16, 2), (5, 40, 16, 3)])
def test_clobber_random_playouts_match_jax(board_size, moves, batch, seed):
    """The stuck player's opponent wins; 400 actions on the 10x10 board."""
    ended, scores = playout_parity(JClobber(board_size), ClobberEnv(board_size), moves, batch,
                                   seed)
    assert ended > 0 and set(scores) <= {-1.0, 1.0}


def test_clobber_features_and_spec():
    env = ClobberEnv(10)
    assert env.spec.action_size == 400 and env.num_rotations() == 1
    s = env.init(2, device="cpu")
    f = env.features(s)
    assert tuple(f.shape) == (2, 10, 10, 18)
    assert float(f[0, ..., 16].min()) == 1.0 and float(f[0, ..., 17].max()) == 0.0


@pytest.mark.parametrize("env_name,algo,sims,force_v2", [
    ("othello", "gaz", 6, False), ("othello", "az", 6, False),
    ("clobber", "gaz", 6, False), ("clobber", "az", 10, True)])
def test_selfplay_matches_jax_engine(env_name, algo, sims, force_v2):
    """Move for move against the JAX engine on the same parity weights:
    Gumbel AlphaZero on tree step B1, plain AlphaZero on B1, and Clobber's
    plain AlphaZero on the large-N loop (B2 and B3)."""
    eng = engine_parity(env_name, algo, sims, moves=4, opening=0, force_v2=force_v2)
    assert eng.use_tree_kernel_v2 == force_v2


def test_trained_othello_weights_match_the_jax_checkpoint():
    """The trained Othello net the port reads from ``minizero_tpu_torch/
    assets/oth8_gaz_r5_iter60000.npz`` (exported by
    ``scripts/export_trained_weights.py ... othello gaz``) against the JAX
    net loaded from its ``.ckpt`` under ``runs/``: the same variables, and
    the same policy and value within 1e-5 on positions from random Othello
    playouts."""
    from minizero_tpu.config import algorithm_preset as j_preset
    from minizero_tpu.eval.match import load_checkpoint_variables
    from minizero_tpu.models.factory import create_network as j_create
    from minizero_tpu_torch.models.factory import create_network
    from minizero_tpu_torch.weights import from_jax_variables, load_variables_npz

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ckpt = os.path.join(root, "runs", "oth8_gaz_r5", "model", "weight_iter_60000.ckpt")
    npz = os.path.join(root, "minizero_tpu_torch", "assets", "oth8_gaz_r5_iter60000.npz")
    jcfg = j_default("othello", **j_preset("gaz"))
    jenv = j_make_env(jcfg)
    jnet = j_create(jcfg, jenv.spec)
    variables = load_checkpoint_variables(ckpt, jcfg, jnet, jenv.spec)
    loaded = load_variables_npz(npz)
    flat_j = jax.tree_util.tree_leaves_with_path(variables)
    assert len(flat_j) == sum(1 for _ in jax.tree_util.tree_leaves(loaded))
    for path, leaf in flat_j:
        node = loaded
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(node, np.asarray(leaf))

    env = OthelloEnv(8)
    rng = np.random.default_rng(60000)
    s = env.init(16, device="cpu")
    for _ in range(int(rng.integers(4, 40))):
        legal = env.legal_mask(s).numpy()
        s = env.step(s, torch.from_numpy((rng.random(legal.shape) * legal).argmax(-1).astype(np.int32)))
    feats = env.features(s)
    want = jnet.apply(variables, jnp.asarray(feats.numpy()), train=False)
    cfg = default_config("othello", **algorithm_preset("gaz"))
    net = create_network(cfg, make_env(cfg).spec)
    net.load_state_dict(from_jax_variables(loaded, hidden_hw=64))
    net.eval()
    with torch.no_grad():
        got = net(feats)
    for key in ("policy", "value"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=0, atol=1e-5,
                                   err_msg=key)
    assert float(got["policy"].max()) > 0.2  # a trained net, not a flat prior

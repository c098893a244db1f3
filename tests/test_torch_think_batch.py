"""The console's search extras of the port held against the JAX package:
the think-batch rounds (virtual loss, one network forward over K leaves,
deduplicated expansions), the timed search over the tree-step loop, and
``tree_string``.

Parity runs on the integer-exact parity nets of ``tests/parity_common.py``
(the AlphaZero one of ``tests/test_torch_engine.py`` and the MuZero one of
``tests/test_torch_muzero_search.py``), with noise and rotation off, select
by count and float32, from the same random openings in both packages.
Tolerances: root visit counts, every node's visit count, the tree's shape
and the actions exact; ``tree_string``'s printed floats within 0.001 (its
precision). The invariants of ``tests/test_mcts.py:120-266`` run on the port
with tiny random nets.
"""

import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minizero_tpu.config import default_config as j_default
from minizero_tpu.envs import make_env as j_make_env
from minizero_tpu.search import gumbel as jgz
from minizero_tpu.search import mcts as jmcts
from minizero_tpu.selfplay.engine import SelfPlayEngine as JEngine
from minizero_tpu_torch.config import algorithm_preset, default_config
from minizero_tpu_torch.envs import make_env
from minizero_tpu_torch.models.factory import create_network, init_network
from minizero_tpu_torch.ops.tree_kernel import fused_tree_step
from minizero_tpu_torch.search import gumbel as gz
from minizero_tpu_torch.search import mcts
from minizero_tpu_torch.search.decide import decide
from minizero_tpu_torch.selfplay.engine import SelfPlayEngine

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from parity_common import jax_muzero_parity_network, jax_parity_network  # noqa: E402
from test_torch_engine import TorchParityNet  # noqa: E402
from test_torch_muzero_search import TorchMuZeroParityNet  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401


def _deterministic(algo, sims, think_batch=1):
    over = dict(algorithm_preset(algo))
    over.update(actor_num_simulation=sims, actor_gumbel_sample_size=4,
                actor_select_action_by_count=True, actor_use_gumbel_noise=False,
                actor_use_dirichlet_noise=False, actor_use_random_rotation_features=False,
                actor_mcts_think_batch_size=think_batch)
    return over


def _engines(game, algo, sims, think_batch, batch, plies, seed):
    """The JAX and the port engine on the same parity net, and the same
    batch of random openings (``plies`` legal moves per game)."""
    over = _deterministic(algo, sims, think_batch)
    jcfg, cfg = j_default(game, **over), default_config(game, **over)
    muzero = algo in ("mz", "gmz")
    jnet, jvars = (jax_muzero_parity_network if muzero else jax_parity_network)(game)
    net = (TorchMuZeroParityNet if muzero else TorchParityNet)(game)
    tb = think_batch > 1
    jeng = JEngine(j_make_env(jcfg), jcfg, jnet, use_bf16=False, use_think_batch=tb)
    eng = SelfPlayEngine(make_env(cfg), cfg, net, use_bf16=False, device="cpu", use_think_batch=tb)
    assert vars(eng.spec) == vars(jeng.spec) and eng.is_muzero == muzero
    rng = np.random.default_rng(seed)
    js, ts = jeng.init_batch(batch), eng.init_batch(batch)
    jstep = jax.jit(jax.vmap(jeng.env.step))
    for _ in range(plies):
        legal = eng.env.legal_mask(ts).numpy()
        acts = (rng.random(legal.shape) * legal).argmax(-1).astype(np.int32)
        js = jstep(js, jnp.asarray(acts))
        ts = eng.env.step(ts, torch.from_numpy(acts))
    np.testing.assert_array_equal(ts.board.numpy(), np.asarray(js.board))
    return jeng, jvars, eng, js, ts


def _assert_same_trees(tt, jt):
    np.testing.assert_array_equal(mcts.root_children_visits(tt).numpy(),
                                  np.asarray(jax.vmap(jmcts.root_children_visits)(jt)))
    np.testing.assert_array_equal(tt.visits.numpy(), np.asarray(jt.visits))
    np.testing.assert_array_equal(tt.children_index.numpy(), np.asarray(jt.children_index))


def _assert_same_action(spec, tt, jspec, jt):
    if spec.use_gumbel:
        want = jax.vmap(lambda t: jgz.decide_action(jspec, t))(jt)
    else:
        want = jax.vmap(jmcts.select_action_by_max_count)(jt)
    np.testing.assert_array_equal(decide(spec, tt, 1.0, -0.9).action.numpy(), np.asarray(want))


@pytest.mark.parametrize("game,algo,k,sims", [
    ("tictactoe", "az", 4, 24), ("tictactoe", "gaz", 8, 16), ("go", "gaz", 8, 16),
    ("tictactoe", "az", 8, 18), ("tictactoe", "mz", 8, 20), ("tictactoe", "gmz", 4, 16)])
def test_think_batch_search_matches_jax(game, algo, k, sims):
    """K virtual-loss selections a round, one forward over the K x B leaves,
    deduplicated expansions, a short last round where K does not divide n:
    the finished trees and the actions equal the JAX engine's."""
    jeng, jvars, eng, js, ts = _engines(game, algo, sims, k, batch=5,
                                        plies=4 if game == "tictactoe" else 10, seed=sims + k)
    assert eng.spec.think_batch == k and eng.spec.max_nodes == -(-sims // k) * k + 1
    before = fused_tree_step.launches
    tt = eng.search_trees(ts)
    assert fused_tree_step.launches == before  # think batches run on no kernel
    assert tt.evloss is not None and not bool(tt.evloss.any()) and not bool(tt.nvloss.any())
    jt = jeng.search_trees(jvars, js, jax.random.PRNGKey(0))
    _assert_same_trees(tt, jt)
    np.testing.assert_array_equal(tt.num_nodes.numpy(), np.asarray(jt.num_nodes))
    assert (mcts.root_children_visits(tt).sum(-1) == sims).all()
    _assert_same_action(eng.spec, tt, jeng.spec, jt)


def test_think_batch_engine_moves_match_jax():
    """Three moves of the think-batch engine, action by action."""
    jeng, jvars, eng, js, ts = _engines("tictactoe", "gaz", 16, 4, batch=3, plies=2, seed=1)
    for mv in range(3):
        jout = jeng.move(jvars, js, jax.random.PRNGKey(mv))
        out = eng.move(ts)
        np.testing.assert_array_equal(out.action.numpy(), np.asarray(jout.action))
        np.testing.assert_array_equal(out.states.board.numpy(), np.asarray(jout.states.board))
        js, ts = jout.states, out.states


@pytest.mark.parametrize("game,algo", [("go", "gaz"), ("tictactoe", "az")])
def test_timed_search_matches_jax(game, algo):
    """6 of 16 simulations, then resumed to 17 root visits
    (``tests/test_mcts.py:247-266``): the visits equal the JAX timed
    search's at both points, and the full budget equals the untimed
    search's trees and action."""
    jeng, jvars, eng, js, ts = _engines(game, algo, 16, 1, batch=4, plies=2, seed=3)
    assert eng.supports_timed_search() and jeng.supports_timed_search()
    carry = eng.az_init_timed(ts)
    jcarry = jeng.az_init_timed(jvars, js, jax.random.PRNGKey(0))
    carry = eng.az_advance_timed(carry, 1, 7)
    jcarry = jeng.az_advance_timed(jvars, jcarry, 1, 7)
    action, _, _, _, trees = eng.az_finish_timed(carry)
    jaction, _, _, _, jtrees = jeng.az_finish_timed(jcarry)
    assert (trees.visits[:, 0] == 7).all()
    _assert_same_trees(trees, jtrees)
    np.testing.assert_array_equal(action.numpy(), np.asarray(jaction))
    carry = eng.az_advance_timed(carry, 7, 17)
    jcarry = jeng.az_advance_timed(jvars, jcarry, 7, 17)
    action, _, _, _, trees = eng.az_finish_timed(carry)
    jaction, _, _, _, jtrees = jeng.az_finish_timed(jcarry)
    assert (trees.visits[:, 0] == 17).all()
    _assert_same_trees(trees, jtrees)
    np.testing.assert_array_equal(action.numpy(), np.asarray(jaction))
    full = eng.search_trees(ts)
    for name in ("visits", "children_index", "parent", "action_from_parent", "num_nodes"):
        assert torch.equal(getattr(trees, name), getattr(full, name)), name
    assert torch.equal(action, eng.move(ts).action)


def test_timed_muzero_search_matches_the_untimed_one():
    """The MuZero search's chunked pieces (JAX ``muzero_search.py:347-368``)
    advanced in three chunks give the untimed search's trees."""
    _, _, eng, _, ts = _engines("go", "gmz", 16, 1, batch=3, plies=6, seed=4)
    search = eng._muzero
    feats, legal, turns = eng.env.features(ts), eng.env.legal_mask(ts), eng.env.turn(ts)
    with torch.no_grad():
        carry = search.init_timed(feats, legal, turns)
        for lo, hi in ((1, 5), (5, 12), (12, 17)):
            carry = search.advance_timed(carry, lo, hi)
        res, trees = search.finish_timed(carry)
        full = search.search_trees(feats, legal, turns)
    for name in ("visits", "children_index", "mean"):
        assert torch.equal(getattr(trees, name), getattr(full, name)), name
    assert torch.equal(res.action, search(feats, legal, turns).action)


_FLOAT = re.compile(r"-?\d+\.\d+")


@pytest.mark.parametrize("game,algo", [("go", "gaz"), ("tictactoe", "gmz")])
def test_tree_string_matches_jax(game, algo):
    """The same nesting, moves and counts as the JAX dump of the same
    search; the printed floats within 0.001."""
    jeng, jvars, eng, js, ts = _engines(game, algo, 16, 1, batch=2, plies=3, seed=5)
    tt = eng.search_trees(ts)
    jt = jeng.search_trees(jvars, js, jax.random.PRNGKey(0))
    for g in range(2):
        got = mcts.tree_string(eng.spec, tt, str, game=g)
        want = jmcts.tree_string(jeng.spec, jax.tree_util.tree_map(lambda x: x[g], jt), str)
        assert _FLOAT.sub("#", got) == _FLOAT.sub("#", want)
        np.testing.assert_allclose([float(x) for x in _FLOAT.findall(got)],
                                   [float(x) for x in _FLOAT.findall(want)], rtol=0, atol=1e-3)
        assert got.count("C[") == int((tt.visits[g] > 0).sum())


# ---------------------------------------------------------------------------
# the invariants of tests/test_mcts.py:120-266, on the port
# ---------------------------------------------------------------------------

def _tiny(**over):
    cfg = default_config("tictactoe", nn_num_blocks=1, nn_num_hidden_channels=8,
                         nn_num_value_hidden_channels=8,
                         actor_num_simulation=over.pop("sims", 24), **over)
    env = make_env(cfg)
    return env, cfg, init_network(create_network(cfg, env.spec), seed=0)


def _check_move(out, batch):
    actions = out.action.numpy()
    assert actions.shape == (batch,) and ((actions >= 0) & (actions < 9)).all()
    pt = out.policy_target.numpy()
    np.testing.assert_allclose(pt.sum(-1), 1.0, rtol=1e-4)
    assert (pt >= 0).all()


@pytest.mark.parametrize("nn_type,gumbel", [("alphazero", False), ("alphazero", True),
                                            ("muzero", False), ("muzero", True)])
def test_think_batch_move_invariants(nn_type, gumbel):
    """K=4 selections a forward still give a legal move and a normalised
    policy target (AlphaZero and MuZero, PUCT and Gumbel)."""
    over = dict(nn_type_name=nn_type, sims=16, actor_mcts_think_batch_size=4)
    if gumbel:
        over.update(actor_use_gumbel=True, actor_use_gumbel_noise=True,
                    actor_use_dirichlet_noise=False, actor_select_action_by_count=True,
                    actor_gumbel_sample_size=4)
    env, cfg, net = _tiny(**over)
    eng = SelfPlayEngine(env, cfg, net, use_think_batch=True, device="cpu", seed=11)
    assert eng.spec.think_batch == 4 and eng.is_muzero == (nn_type == "muzero")
    _check_move(eng.move(eng.init_batch(3)), 3)


def test_think_batch_finds_immediate_win():
    """Tactical correctness survives virtual-loss batching."""
    env, cfg, net = _tiny(sims=100, actor_select_action_by_count=True,
                          actor_use_dirichlet_noise=False, actor_mcts_think_batch_size=8)
    eng = SelfPlayEngine(env, cfg, net, use_think_batch=True, eval_mode=True, device="cpu")
    states = env.init(2, device="cpu")
    for a in (0, 3, 1, 4):
        states = env.step(states, torch.full((2,), a, dtype=torch.int32))
    out = eng.move(states)
    assert (out.action == 2).all() and (out.eval_score == 1.0).all()


def test_muzero_search_trees_and_tree_string():
    env, cfg, net = _tiny(nn_type_name="muzero", sims=12)
    eng = SelfPlayEngine(env, cfg, net, device="cpu", seed=3)
    trees = eng.search_trees(eng.init_batch(1))
    assert int(mcts.root_children_visits(trees).sum()) == 12
    assert mcts.tree_string(eng.spec, trees).count("C[") >= 2


def test_timed_search_partial_and_full():
    env, cfg, net = _tiny(sims=16, actor_use_dirichlet_noise=False,
                          actor_select_action_by_count=True)
    eng = SelfPlayEngine(env, cfg, net, device="cpu", seed=31)
    carry = eng.az_advance_timed(eng.az_init_timed(eng.init_batch(2)), 1, 7)
    action, pt, _, _, trees = eng.az_finish_timed(carry)
    assert (trees.visits[:, 0] == 7).all()
    assert ((action >= 0) & (action < 9)).all()
    np.testing.assert_allclose(pt.sum(-1).numpy(), 1.0, rtol=1e-5)
    _, _, _, _, trees = eng.az_finish_timed(eng.az_advance_timed(carry, 7, 17))
    assert (trees.visits[:, 0] == 17).all()


def test_gumbel_selection_marks_duplicates_only_under_virtual_loss():
    """``dup`` exists on trees with virtual loss and flags a new edge that
    a selection of the round already took."""
    env, cfg, net = _tiny(sims=16, actor_use_gumbel=True, actor_gumbel_sample_size=2,
                          actor_mcts_think_batch_size=4)
    eng = SelfPlayEngine(env, cfg, net, use_think_batch=True, device="cpu")
    plain = SelfPlayEngine(env, cfg, net, device="cpu")
    states = eng.init_batch(2)
    feats, legal, turns = env.features(states), env.legal_mask(states), env.turn(states)
    with torch.no_grad():
        assert gz.gumbel_select_leaf(plain.spec, plain._az_root_trees(
            feats, legal, turns, plain.generator)).dup is None
        trees = eng._az_root_trees(feats, legal, turns, eng.generator)
    first = gz.gumbel_select_leaf(eng.spec, trees)
    assert first.is_new.all() and not first.dup.any()
    mcts.add_path_vloss(trees, first)
    assert (trees.nvloss[:, 0] == 1).all() and (trees.evloss.sum((1, 2)) == 1).all()
    # the root's Gumbel step ranks candidates by real visits only, so the
    # next selection takes the same new edge again: a duplicate
    second = gz.gumbel_select_leaf(eng.spec, trees)
    assert second.dup.all() and torch.equal(second.action, first.action)
    mcts.clear_vloss(trees)
    assert not trees.evloss.any() and not trees.nvloss.any()

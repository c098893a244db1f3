"""The port's search functions and its plain tree step held against the JAX
package: root expansion, backup, root noise, Gumbel candidates, then the
port's ``tree_step_reference`` against the JAX ``fused_tree_step`` (the
Pallas kernel in interpret mode) simulation by simulation on random trees,
then the action / policy-target extraction on the finished trees.

Tolerances: integers (selections, children, masks, sample sizes) exact;
floats 1e-5 absolute and relative (visits are small integers, means are
incremental averages of float32 values), root noise 1e-6.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minizero_tpu.ops.tree_kernel import NextSelection as JNextSelection
from minizero_tpu.ops.tree_kernel import fused_tree_step as j_fused_tree_step
from minizero_tpu.search import gumbel as jgz
from minizero_tpu.search import mcts as jmcts
from minizero_tpu_torch.ops.tree_kernel import fused_tree_step, tree_step_reference
from minizero_tpu_torch.search import gumbel as tgz
from minizero_tpu_torch.search import mcts as tmcts

B, A, SIMS = 8, 8, 12
FIELDS = ("visits", "mean", "value", "reward", "expanded", "terminal", "parent",
          "action_from_parent", "to_play", "children_index", "prior", "logit", "noise",
          "legal", "gumbel_active", "gumbel_sample_size", "gumbel_budget")


def _spec_kwargs(use_gumbel, regime="board"):
    kw = dict(action_size=A, num_simulations=SIMS, use_gumbel=use_gumbel,
              use_gumbel_noise=use_gumbel, use_dirichlet_noise=not use_gumbel,
              gumbel_sample_size=4, flip_player2_value=True)
    if regime == "atari":
        # MuZero Atari semantics (tests/test_tree_kernel.py:206-221): reward
        # head, discounted backup, min-max value rescale, average init-Q,
        # one player
        kw.update(flip_player2_value=False, discount=0.997, value_rescale=True,
                  init_q_average=True)
    return kw


def _leaf_inputs(rng):
    logits = rng.normal(size=(B, A)).astype(np.float32)
    policy = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    legal = rng.random((B, A)) < 0.9
    legal[:, 0] = True
    terminal = rng.random(B) < 0.1
    value = rng.uniform(-1.0, 1.0, size=B).astype(np.float32)
    turn = (1 + (rng.random(B) < 0.5)).astype(np.int32)
    return (policy.astype(np.float32), np.log(policy + 1e-9).astype(np.float32),
            legal, terminal, value, turn)


def _to_torch(arrays):
    return [torch.from_numpy(np.asarray(x)) for x in arrays]


def _check_trees(jt, tt, step, atol=1e-5):
    for name in FIELDS:
        want = np.asarray(getattr(jt, name))
        got = getattr(tt, name).numpy()
        assert want.shape == got.shape, f"{step}: {name} shape {want.shape} vs {got.shape}"
        if want.dtype.kind == "f":
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol, err_msg=f"{step}: {name}")
        else:
            np.testing.assert_array_equal(got.astype(np.int64), want.astype(np.int64),
                                          err_msg=f"{step}: {name}")


def _check_selection(jsel, tsel, step):
    for name in ("parent", "action", "leaf", "is_new", "path"):
        np.testing.assert_array_equal(getattr(tsel, name).numpy().astype(np.int64),
                                      np.asarray(getattr(jsel, name)).astype(np.int64),
                                      err_msg=f"{step}: selection {name}")


def _root_trees(use_gumbel, seed, regime="board"):
    """The same expanded root (plus root noise and Gumbel candidates) built
    by both packages from one set of numpy inputs."""
    jspec = jmcts.SearchSpec(**_spec_kwargs(use_gumbel, regime))
    tspec = tmcts.SearchSpec(**_spec_kwargs(use_gumbel, regime))
    rng = np.random.default_rng(seed)
    policy, logit, legal, _, _, _ = _leaf_inputs(rng)
    value = rng.normal(size=B).astype(np.float32)
    turns = np.ones(B, np.int32)
    zeros_i = np.zeros(B, np.int32)
    no_parent = np.full(B, -1, np.int32)
    falses = np.zeros(B, bool)

    proto = jnp.zeros((3,), jnp.int8)
    jt = jax.vmap(lambda t: jmcts.init_tree(jspec, proto, t))(jnp.asarray(turns))
    jt = jax.vmap(functools.partial(jmcts.expand_node, jspec, store_embedding=False))(
        jt, jnp.asarray(zeros_i), jnp.asarray(no_parent), jnp.asarray(zeros_i),
        jnp.asarray(turns), jnp.asarray(policy), jnp.asarray(logit), jnp.asarray(legal),
        jnp.asarray(falses))
    jt = jax.vmap(functools.partial(jmcts.backup, jspec))(
        jt, jnp.asarray(zeros_i), jnp.asarray(value), jnp.zeros((B,), jnp.float32))

    tt = tmcts.init_tree(tspec, torch.from_numpy(turns))
    tt = tmcts.expand_node(tspec, tt, 0, *_to_torch([no_parent, zeros_i, turns, policy, logit,
                                                     legal, falses]))
    tt = tmcts.backup(tspec, tt, *_to_torch([zeros_i, value, np.zeros(B, np.float32)]))
    _check_trees(jt, tt, "root expansion")

    # root noise: the port is handed the draws that the JAX function makes
    keys = jax.random.split(jax.random.PRNGKey(seed), B)
    jt = jax.vmap(functools.partial(jmcts.add_root_noise, jspec))(jt, keys)
    if use_gumbel:
        draws = jax.vmap(lambda k: jax.random.gumbel(k, (A,)))(keys)
    else:
        draws = jax.vmap(lambda k: jax.random.gamma(k, jspec.dirichlet_alpha, (A,)))(keys)
    tt = tmcts.add_root_noise(tspec, tt, noise=torch.from_numpy(np.array(draws)))
    _check_trees(jt, tt, "root noise", atol=1e-6)
    if use_gumbel:
        jt = jax.vmap(functools.partial(jgz.init_candidates, jspec))(jt)
        tt = tgz.init_candidates(tspec, tt)
        _check_trees(jt, tt, "init_candidates", atol=1e-6)
    return jspec, tspec, jt, tt


@pytest.mark.parametrize("regime", ["board", "atari"])
@pytest.mark.parametrize("use_gumbel", [True, False])
def test_tree_step_reference_matches_jax_kernel(use_gumbel, regime):
    """Board regime and the MuZero Atari regime (in-tree rewards, discount,
    value rescale); the CUDA kernel covers both."""
    atari = regime == "atari"
    jspec, tspec, jt, tt = _root_trees(use_gumbel, seed=11 + use_gumbel, regime=regime)
    j_step = jax.jit(lambda trees, sel, *args, leaf_reward=None: j_fused_tree_step(
        jspec, trees, sel, *args, interpret=True, leaf_reward=leaf_reward))
    n = jspec.max_nodes
    jsel = JNextSelection(parent=jnp.zeros((B,), jnp.int32), action=jnp.zeros((B,), jnp.int32),
                          leaf=jnp.full((B,), -1, jnp.int32), is_new=jnp.zeros((B,), bool),
                          path=jnp.zeros((B, n), bool))
    tsel = tmcts.empty_selection(tspec, B, "cpu")
    rng = np.random.default_rng(99)
    for sim in range(SIMS + 1):
        li = _leaf_inputs(rng)
        reward = None
        if atari:
            # MuZero interior nodes: never terminal, all actions legal, one player
            pol, logit, _, _, val, _ = li
            li = (pol, logit, np.ones((B, A), bool), np.zeros(B, bool), val, np.ones(B, np.int32))
            reward = rng.uniform(-1.0, 1.0, size=B).astype(np.float32)
        phase = 0 if sim == 0 else 1
        jt, jsel = j_step(jt, jsel, *[jnp.asarray(x) for x in li],
                          jnp.int32(sim), jnp.int32(phase),
                          leaf_reward=None if reward is None else jnp.asarray(reward))
        prev, snapshot = tt, tt.clone()
        tt, tsel = tree_step_reference(
            tspec, prev, tsel, *_to_torch(li), sim, phase,
            leaf_reward=None if reward is None else torch.from_numpy(reward))
        for name in FIELDS:  # the plain version leaves its input tree unchanged
            assert torch.equal(getattr(prev, name), getattr(snapshot, name)), name
        _check_trees(jt, tt, f"sim {sim}")
        _check_selection(jsel, tsel, f"sim {sim}")

    # decisions and targets on the finished trees
    rows = np.arange(B)
    if use_gumbel:
        np.testing.assert_array_equal(tgz.decide_action(tspec, tt).numpy(),
                                      np.asarray(jax.vmap(functools.partial(jgz.decide_action, jspec))(jt)))
        np.testing.assert_allclose(
            tgz.improved_policy_target(tspec, tt).numpy(),
            np.asarray(jax.vmap(functools.partial(jgz.improved_policy_target, jspec))(jt)),
            rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(tmcts.select_action_by_max_count(tt).numpy(),
                                  np.asarray(jax.vmap(jmcts.select_action_by_max_count)(jt)))
    np.testing.assert_allclose(tmcts.mcts_policy_target(tt).numpy(),
                               np.asarray(jax.vmap(jmcts.mcts_policy_target)(jt)), atol=1e-6)
    np.testing.assert_allclose(tmcts.root_children_q(tspec, tt).numpy(),
                               np.asarray(jax.vmap(functools.partial(jmcts.root_children_q, jspec))(jt)),
                               atol=1e-6)
    action = rng.integers(0, A, size=B).astype(np.int32)
    for threshold in (-0.9, 0.0, 0.5):
        np.testing.assert_array_equal(
            tmcts.is_resign(tspec, tt, torch.from_numpy(action), threshold).numpy(),
            np.asarray(jax.vmap(lambda t, a: jmcts.is_resign(jspec, t, a, threshold))(
                jt, jnp.asarray(action))))
    sampled = tmcts.select_action_by_softmax_count(
        tspec, tt, 1.0, torch.Generator().manual_seed(0)).numpy()
    assert (tmcts.root_children_visits(tt).numpy()[rows, sampled] > 0).all()


def test_fused_tree_step_on_cpu_takes_the_plain_path():
    """On CPU tensors the wrapper is the plain version, in the board regime
    and in the reward regime (leaf rewards, discount, value rescale), and
    launches no kernel."""
    before = (fused_tree_step.launches, fused_tree_step.launches_rewards)
    for regime in ("board", "atari"):
        _, tspec, _, tt = _root_trees(True, seed=5, regime=regime)
        rng = np.random.default_rng(7)
        sel = tmcts.empty_selection(tspec, B, "cpu")
        for sim in range(4):
            li = _to_torch(_leaf_inputs(rng))
            reward = None
            if regime == "atari":
                assert tspec.value_rescale and tspec.discount != 1.0
                reward = torch.from_numpy(rng.uniform(-1.0, 1.0, size=B).astype(np.float32))
            phase = 0 if sim == 0 else 1
            want_t, want_s = tree_step_reference(tspec, tt, sel, *li, sim, phase,
                                                 leaf_reward=reward)
            got_t, got_s = fused_tree_step(tspec, tt, sel, *li, sim, phase, leaf_reward=reward)
            for name in FIELDS:
                assert torch.equal(getattr(want_t, name), getattr(got_t, name)), (regime, sim, name)
            for name in ("parent", "action", "leaf", "is_new", "path"):
                assert torch.equal(getattr(want_s, name), getattr(got_s, name)), (regime, sim, name)
            tt, sel = got_t, got_s
        if regime == "atari":  # the rewards reached the tree
            assert bool((tt.reward != 0).any())
    # no kernel on CPU tensors
    assert (fused_tree_step.launches, fused_tree_step.launches_rewards) == before

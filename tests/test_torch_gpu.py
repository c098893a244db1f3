"""Card-only tests of the port's CUDA kernels, and the port's import guard.

The ``gpu`` tests need a CUDA device: a CUDA kernel has no CPU mode, so they
skip without one (decided inside the test). Run them on a card with
``python -m pytest tests/test_torch_gpu.py -m gpu``.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")


def _assert_equal_outputs(got, want, what):
    """Integers and bools exact, floats within 1e-5, field by field."""
    for f in dataclasses.fields(got):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if g is None and w is None:  # a tree's virtual loss outside think batches
            continue
        if g.dtype.is_floating_point:
            torch.testing.assert_close(g, w, rtol=0, atol=1e-5, msg=f"{what}: {f.name}")
        else:
            assert torch.equal(g, w), f"{what}: {f.name}"


@pytest.mark.gpu
@pytest.mark.parametrize("use_gumbel", [True, False])
def test_tree_step_kernel_matches_plain_on_card(use_gumbel):
    """Every tree step of two moves at B=256 (Go 9x9, n=16, a 1 x 64 net):
    the CUDA kernel and the plain version run from the same state; integer
    outputs exact, float outputs within 1e-5."""
    _need_card()
    from minizero_tpu_torch.config import algorithm_preset, default_config
    from minizero_tpu_torch.envs import make_env
    from minizero_tpu_torch.models.factory import create_network, init_network
    from minizero_tpu_torch.ops.tree_kernel import fused_tree_step, tree_step_reference
    from minizero_tpu_torch.selfplay.engine import SelfPlayEngine

    over = dict(algorithm_preset("gaz")) if use_gumbel else dict(algorithm_preset("az"))
    over.update(actor_num_simulation=16, nn_num_hidden_channels=64, nn_num_value_hidden_channels=64)
    cfg = default_config("go", **over)
    env = make_env(cfg)
    eng = SelfPlayEngine(env, cfg, init_network(create_network(cfg, env.spec), seed=2),
                         device="cuda", seed=4)
    calls = []

    def checked(spec, trees, sel, *rest, leaf_reward=None):
        ref_sel = sel.clone()
        want_t, want_s = tree_step_reference(spec, trees.clone(), ref_sel, *rest,
                                             leaf_reward=leaf_reward)
        before = fused_tree_step.launches
        got_t, got_s = fused_tree_step(spec, trees, sel, *rest, leaf_reward=leaf_reward)
        assert fused_tree_step.launches == before + 1
        for f in dataclasses.fields(got_t):
            got, want = getattr(got_t, f.name), getattr(want_t, f.name)
            if got is None and want is None:
                continue
            if got.dtype.is_floating_point:
                torch.testing.assert_close(got, want, rtol=0, atol=1e-5, msg=f.name)
            else:
                assert torch.equal(got, want), f.name
        for name in ("parent", "action", "leaf", "is_new", "path"):
            assert torch.equal(getattr(got_s, name), getattr(want_s, name)), name
        calls.append(rest[-2])
        return got_t, got_s

    eng.tree_step = checked
    states = eng.init_batch(256)
    for _ in range(2):
        states = eng.move(states).states
    torch.cuda.synchronize()
    assert calls == list(range(17)) * 2


@pytest.mark.gpu
def test_tree_step_v2_and_gather_rows_kernels_match_plain_on_card():
    """Every v2 tree step and every parent-state gather of two moves of a
    staged search (az n=80: capacity stages 65 and 81) at B=96 (Go 9x9, a
    1 x 32 net): each kernel and its plain version run from the same state."""
    _need_card()
    from minizero_tpu_torch.config import algorithm_preset, default_config
    from minizero_tpu_torch.envs import make_env
    from minizero_tpu_torch.models.factory import create_network, init_network
    from minizero_tpu_torch.ops.gather_rows import gather_rows, gather_rows_reference
    from minizero_tpu_torch.ops.tree_kernel_v2 import fused_tree_step_v2, tree_step_v2_reference
    from minizero_tpu_torch.selfplay.engine import SelfPlayEngine

    over = dict(algorithm_preset("az"))
    over.update(actor_num_simulation=80, nn_num_hidden_channels=32, nn_num_value_hidden_channels=32)
    cfg = default_config("go", **over)
    env = make_env(cfg)
    eng = SelfPlayEngine(env, cfg, init_network(create_network(cfg, env.spec), seed=5),
                         device="cuda", seed=6)
    assert eng.use_tree_kernel_v2
    steps, gathers, caps = [], [], set()

    def checked_step(spec, packed, sel, *rest):
        want_p, want_s = tree_step_v2_reference(spec, packed, sel.clone(), *rest)
        before = fused_tree_step_v2.launches
        got_p, got_s = fused_tree_step_v2(spec, packed, sel, *rest)
        assert fused_tree_step_v2.launches == before + 1
        _assert_equal_outputs(got_p, want_p, f"sim {rest[-2]}")
        _assert_equal_outputs(got_s, want_s, f"sim {rest[-2]}")
        steps.append(rest[-2])
        caps.add(packed.visits.shape[1])
        return got_p, got_s

    def checked_gather(x, idx):
        before = (gather_rows.launches, gather_rows.launches_aligned)
        got = gather_rows(x, idx)
        # the engine's padded blob (697 -> 700 words) takes the aligned path
        assert (gather_rows.launches, gather_rows.launches_aligned) == (before[0] + 1,
                                                                         before[1] + 1)
        assert torch.equal(got, gather_rows_reference(x, idx))
        gathers.append(1)
        return got

    eng.tree_step_v2, eng.gather_rows = checked_step, checked_gather
    states = eng.init_batch(96)
    for _ in range(2):
        states = eng.move(states).states
    torch.cuda.synchronize()
    assert steps == list(range(81)) * 2 and len(gathers) == 160 and caps == {65, 81}


@pytest.mark.gpu
@pytest.mark.parametrize("init_q_average", [False, True])
def test_tree_step_v2_kernel_matches_plain_on_random_trees(init_q_average):
    """Random trees (B=64, A=8, n=40, capacity stages 5 -> 9 -> 17 -> 33 ->
    41) with many terminal leaves, so that terminal children are selected
    again and back up their stored value, under both init-Q rules: kernel
    and plain version from the same state at every simulation."""
    _need_card()
    from minizero_tpu_torch.ops import tree_kernel_v2 as tv2
    from minizero_tpu_torch.search import mcts

    b, a, sims = 64, 8, 40
    spec = mcts.SearchSpec(action_size=a, num_simulations=sims, use_gumbel=False,
                           flip_player2_value=True, init_q_average=init_q_average)
    g = torch.Generator(device="cuda").manual_seed(11 + init_q_average)
    dev = "cuda"

    def leaf_inputs():
        policy = torch.softmax(torch.randn((b, a), generator=g, device=dev), -1)
        legal = torch.rand((b, a), generator=g, device=dev) < 0.9
        legal[:, 0] = True
        terminal = torch.rand((b,), generator=g, device=dev) < 0.45
        value = torch.rand((b,), generator=g, device=dev) * 2.0 - 1.0
        turn = (1 + (torch.rand((b,), generator=g, device=dev) < 0.5)).to(torch.int32)
        return policy, legal.contiguous(), terminal, value, turn

    policy, legal, _, value, _ = leaf_inputs()
    turns = torch.ones((b,), dtype=torch.int32, device=dev)
    zeros_i = torch.zeros((b,), dtype=torch.int32, device=dev)
    trees = mcts.init_tree(spec, turns)
    trees = mcts.expand_node(spec, trees, 0, zeros_i - 1, zeros_i, turns, policy, policy.log(),
                             legal, torch.zeros((b,), dtype=torch.bool, device=dev))
    trees = mcts.backup(spec, trees, zeros_i, value, torch.zeros_like(value))
    caps = [5, 9, 17, 33, sims + 1]
    packed = tv2.pack_trees(spec, trees, caps[0])
    sel = tv2.empty_selection_v2(spec, b, caps[0], dev)
    cap_i, revisits = 0, 0
    for sim in range(sims + 1):
        if sim >= caps[cap_i]:
            cap_i += 1
            packed = tv2.grow(packed, caps[cap_i])
            extra = caps[cap_i] - sel.path.shape[1]
            sel.path = torch.cat([sel.path, torch.zeros((b, extra), dtype=torch.bool, device=dev)], 1)
        li = leaf_inputs()
        phase = 0 if sim == 0 else 1
        revisits += int((~sel.is_new).sum()) if phase else 0
        want_p, want_s = tv2.tree_step_v2_reference(spec, packed, sel, *li, sim, phase)
        packed, sel = tv2.fused_tree_step_v2(spec, packed, sel, *li, sim, phase)
        _assert_equal_outputs(packed, want_p, f"sim {sim}")
        _assert_equal_outputs(sel, want_s, f"sim {sim}")
    assert revisits > 0


@pytest.mark.gpu
@pytest.mark.parametrize("b,n,w,offset", [
    (5, 7, 697, 0), (13, 12, 128, 0), (1023, 201, 697, 0), (64, 9, 8, 0),
    (1024, 201, 700, 0), (1023, 201, 700, 0), (7, 1, 4, 0), (33, 9, 700, 1)])
def test_gather_rows_kernel_matches_plain_on_card(b, n, w, offset):
    """Odd batches and batches that are not a multiple of the kernel's games
    per block, node counts that are not a multiple of 8 and N = 1, the Go
    9x9 state (697 words: the generic path, 4-byte words) and the engine's
    padded stride of it (700 words: the aligned path, 16-byte elements),
    and a base 4 bytes off (a contiguous view at storage offset ``offset``:
    the generic path); -1 and out-of-range indices are skipped (their rows
    are not compared: the kernel leaves them undefined). Each case checks
    which path's counter moved."""
    _need_card()
    from minizero_tpu_torch.ops.gather_rows import gather_rows, gather_rows_reference

    g = torch.Generator(device="cuda").manual_seed(b)
    base = torch.randint(-2**31, 2**31 - 1, (b * n * w + offset,), generator=g, device="cuda",
                         dtype=torch.int32)
    x = base[offset:].view(b, n, w)
    assert x.is_contiguous() and (x.data_ptr() % 16 == 0) == (offset == 0)
    idx = torch.randint(0, n, (b,), generator=g, device="cuda", dtype=torch.int32)
    skip = torch.rand((b,), generator=g, device="cuda") < 0.3
    idx = torch.where(skip, torch.where(torch.rand((b,), generator=g, device="cuda") < 0.5, -1, n),
                      idx).to(torch.int32)
    aligned = w % 4 == 0 and offset == 0
    before = (gather_rows.launches, gather_rows.launches_aligned)
    got = gather_rows(x, idx)
    torch.cuda.synchronize()
    assert (gather_rows.launches, gather_rows.launches_aligned) == (before[0] + 1,
                                                                     before[1] + int(aligned))
    want = gather_rows_reference(x, idx)
    assert torch.equal(got[~skip], want[~skip])
    assert torch.equal(got[~skip], x[torch.arange(b, device="cuda"), idx.long().clamp(0, n - 1)][~skip])


def _reward_regime_steps(spec, b, seed, make_leaf, reward_scale=1.0, dev="cuda", edit=None,
                         rewards=True):
    """Root expansion, then every simulation of a search on random leaf
    inputs (MuZero interiors: all legal, never terminal), each step run by
    the CUDA kernel and the plain version from the same state and compared.
    ``edit(trees)`` may rewrite the trees before the phase-0 step. With
    ``rewards`` False the leaves carry no reward (the board regime when the
    discount is 1). Returns the final trees, the final selection and the
    longest selection path."""
    from minizero_tpu_torch.ops.tree_kernel import (
        fused_tree_step, tree_step_reference, uses_reward_regime)
    from minizero_tpu_torch.search import gumbel as gz
    from minizero_tpu_torch.search import mcts

    a = spec.action_size
    g = torch.Generator(device=dev).manual_seed(seed)
    turns = torch.ones((b,), dtype=torch.int32, device=dev)
    zeros_i = torch.zeros((b,), dtype=torch.int32, device=dev)
    policy, logit = make_leaf(g)
    trees = mcts.init_tree(spec, turns)
    trees = mcts.expand_node(spec, trees, 0, zeros_i - 1, zeros_i, turns, policy, logit,
                             torch.ones((b, a), dtype=torch.bool, device=dev),
                             torch.zeros((b,), dtype=torch.bool, device=dev))
    value = (torch.rand((b,), generator=g, device=dev) * 2.0 - 1.0) * reward_scale
    trees = mcts.backup(spec, trees, zeros_i, value, torch.zeros_like(value))
    if spec.use_gumbel:
        trees = gz.init_candidates(spec, trees)
    if edit is not None:
        trees = edit(trees)
    sel = mcts.empty_selection(spec, b, dev)
    ones = torch.ones((b, a), dtype=torch.bool, device=dev)
    no_term = torch.zeros((b,), dtype=torch.bool, device=dev)
    depth = 0
    for sim in range(spec.num_simulations + 1):
        policy, logit = make_leaf(g)
        value = (torch.rand((b,), generator=g, device=dev) * 2.0 - 1.0) * reward_scale
        reward = None
        if sim > 0 and rewards:
            reward = (torch.rand((b,), generator=g, device=dev) * 2.0 - 1.0) * reward_scale
        phase = 0 if sim == 0 else 1
        args = (policy, logit, ones, no_term, value, turns, sim, phase)
        ref_sel = sel.clone()
        want_t, want_s = tree_step_reference(spec, trees.clone(), ref_sel, *args,
                                             leaf_reward=reward)
        counter = "launches_rewards" if uses_reward_regime(spec, reward) else "launches"
        before = getattr(fused_tree_step, counter)
        trees, sel = fused_tree_step(spec, trees, sel, *args, leaf_reward=reward)
        assert getattr(fused_tree_step, counter) == before + 1
        _assert_equal_outputs(trees, want_t, f"sim {sim}")
        _assert_equal_outputs(sel, want_s, f"sim {sim}")
        depth = max(depth, int(sel.path.sum(1).max()))
    return trees, sel, depth


def _random_leaf(b, a, dev="cuda"):
    def make(g):
        logit = torch.randn((b, a), generator=g, device=dev)
        return torch.softmax(logit, -1), logit
    return make


@pytest.mark.gpu
@pytest.mark.parametrize("use_gumbel", [True, False])
def test_tree_step_reward_regime_matches_plain_on_random_trees(use_gumbel):
    """The MuZero Atari regime (leaf rewards, discount 0.997, min-max value
    rescale, average init-Q, one player) on random trees at the Atari search's
    shapes (A=18, n=50) and B=256, Gumbel on and off (mirrors
    tests/test_tree_kernel.py:206): kernel and plain version from the same
    state at every simulation."""
    _need_card()
    from minizero_tpu_torch.search import mcts

    spec = mcts.SearchSpec(action_size=18, num_simulations=50, use_gumbel=use_gumbel,
                           use_gumbel_noise=use_gumbel, use_dirichlet_noise=not use_gumbel,
                           gumbel_sample_size=8, flip_player2_value=False, discount=0.997,
                           value_rescale=True, init_q_average=True)
    trees, _, _ = _reward_regime_steps(spec, 256, 21 + use_gumbel, _random_leaf(256, 18))
    assert bool((trees.reward != 0).any()) and int(trees.num_nodes.min()) == 51


@pytest.mark.gpu
def test_tree_step_reward_regime_matches_plain_at_go_shapes():
    """The reward regime at Go 9x9 shapes (A=82, N=51), two players with the
    value flip and the visited-children init-Q, at B=128."""
    _need_card()
    from minizero_tpu_torch.search import mcts

    spec = mcts.SearchSpec(action_size=82, num_simulations=50, use_gumbel=False,
                           use_dirichlet_noise=True, flip_player2_value=True, discount=0.997,
                           value_rescale=True, init_q_average=False)
    _reward_regime_steps(spec, 128, 31, _random_leaf(128, 82))


@pytest.mark.gpu
def test_tree_step_reward_regime_backs_up_a_deep_chain():
    """Every prior on action 0: each walk follows the chain of first children
    to its end, so the last backups walk N levels from leaf to root, with
    rewards of size ~100 (the scale of Atari values)."""
    _need_card()
    from minizero_tpu_torch.search import mcts

    b, a, sims = 64, 18, 50
    spec = mcts.SearchSpec(action_size=a, num_simulations=sims, use_gumbel=False,
                           use_dirichlet_noise=False, flip_player2_value=False, discount=0.997,
                           value_rescale=True, init_q_average=True)

    def chain_leaf(g):
        logit = torch.full((b, a), -30.0, device="cuda")
        logit[:, 0] = 0.0
        return torch.softmax(logit, -1), logit

    trees, sel, depth = _reward_regime_steps(spec, b, 41, chain_leaf, reward_scale=100.0)
    assert depth == sims + 1  # the last path: root, node 1, ..., node sims
    assert bool((trees.visits[:, 0] == sims + 1).all())


@pytest.mark.gpu
def test_tree_step_rescale_with_fewer_than_two_visited_nodes():
    """With fewer than 2 visited nodes the rescaled q of a visited child is
    1: trees whose only visited node is one root child (root visits cleared)
    take one selection step (phase 0), kernel against the plain version."""
    _need_card()
    from minizero_tpu_torch.search import mcts

    b, a = 64, 18
    spec = mcts.SearchSpec(action_size=a, num_simulations=6, use_gumbel=False,
                           use_dirichlet_noise=False, flip_player2_value=False, discount=0.997,
                           value_rescale=True, init_q_average=True)
    trees, _, _ = _reward_regime_steps(spec, b, 51, _random_leaf(b, a))

    def only_one_visited(t):
        t = t.clone()
        child = t.children_index[:, 0].max(-1).values.long()  # an expanded root child
        keep = t.visits[torch.arange(b, device="cuda"), child]
        t.visits.zero_()
        t.visits[torch.arange(b, device="cuda"), child] = keep
        return t

    edited = only_one_visited(trees)
    assert bool(((edited.visits > 0).sum(1) == 1).all())
    from minizero_tpu_torch.ops.tree_kernel import fused_tree_step, tree_step_reference

    zf = torch.zeros((b, a), device="cuda")
    args = (zf, zf, torch.ones((b, a), dtype=torch.bool, device="cuda"),
            torch.zeros((b,), dtype=torch.bool, device="cuda"), torch.zeros((b,), device="cuda"),
            torch.ones((b,), dtype=torch.int32, device="cuda"), 0, 0)
    want_t, want_s = tree_step_reference(spec, edited.clone(), mcts.empty_selection(spec, b, "cuda"),
                                         *args)
    got_t, got_s = fused_tree_step(spec, edited, mcts.empty_selection(spec, b, "cuda"), *args)
    _assert_equal_outputs(got_t, want_t, "one visited node")
    _assert_equal_outputs(got_s, want_s, "one visited node")


@pytest.mark.gpu
def test_muzero_searches_match_plain_on_card():
    """Every tree step of a Go 9x9 Gumbel MuZero move (n=16, board regime)
    and of an Atari MuZero search (n=50, reward regime) at B=64 with 1 x 32
    nets: kernel and plain version from the same state; the launch counters
    tell the two regimes apart."""
    _need_card()
    from minizero_tpu_torch.config import algorithm_preset, default_config
    from minizero_tpu_torch.envs import atari, make_env
    from minizero_tpu_torch.models.factory import create_network, init_network
    from minizero_tpu_torch.ops.tree_kernel import fused_tree_step, tree_step_reference
    from minizero_tpu_torch.selfplay.engine import SelfPlayEngine, search_spec_from_config
    from minizero_tpu_torch.selfplay.muzero_search import make_muzero_search

    steps = []

    def checked(spec, trees, sel, *rest, leaf_reward=None):
        ref_sel = sel.clone()
        want_t, want_s = tree_step_reference(spec, trees.clone(), ref_sel, *rest,
                                             leaf_reward=leaf_reward)
        got_t, got_s = fused_tree_step(spec, trees, sel, *rest, leaf_reward=leaf_reward)
        _assert_equal_outputs(got_t, want_t, f"sim {rest[-2]}")
        _assert_equal_outputs(got_s, want_s, f"sim {rest[-2]}")
        steps.append(rest[-2])
        return got_t, got_s

    tiny = dict(nn_num_hidden_channels=32, nn_num_value_hidden_channels=32)
    cfg = default_config("go", **algorithm_preset("gmz"), **tiny)
    env = make_env(cfg)
    eng = SelfPlayEngine(env, cfg, init_network(create_network(cfg, env.spec), seed=8),
                         device="cuda", seed=9)
    eng.tree_step = checked
    before = (fused_tree_step.launches, fused_tree_step.launches_rewards)
    eng.move(eng.init_batch(64))
    torch.cuda.synchronize()
    assert steps == list(range(17))
    assert (fused_tree_step.launches, fused_tree_step.launches_rewards) == (before[0] + 17, before[1])

    acfg = default_config("atari", **algorithm_preset("mz"), **tiny)
    spec = atari.atari_spec()
    net = init_network(create_network(acfg, spec), seed=10).cuda().eval()
    search = make_muzero_search(net, search_spec_from_config(acfg, spec),
                                lambda x: atari.action_features(x, spec), 1, discrete_value=True)
    search.tree_step = checked
    steps.clear()
    feats = torch.rand((64, 96, 96, 32), generator=torch.Generator(device="cuda").manual_seed(1),
                       device="cuda")
    with torch.no_grad():
        res = search(feats, torch.ones((64, 18), dtype=torch.bool, device="cuda"),
                     torch.ones((64,), dtype=torch.int32, device="cuda"),
                     torch.Generator(device="cuda").manual_seed(2))
    torch.cuda.synchronize()
    assert steps == list(range(51))
    assert (fused_tree_step.launches, fused_tree_step.launches_rewards) == (before[0] + 17, before[1] + 51)
    assert bool(torch.isfinite(res.root_value).all())


# ---------------------------------------------------------------------------
# cases that the register-row / shared-memory designs of the two tree-step
# kernels could get wrong: prefetched paths left halfway, walks as deep as
# the capacity, exact score ties, signed zeros, ragged blocks, revisits
# ---------------------------------------------------------------------------

def _v2_step_checked(spec, packed, sel, leaf, sim, phase):
    """One v2 step by the kernel and the plain version from the same state;
    every field compared. Returns the kernel's outputs."""
    from minizero_tpu_torch.ops import tree_kernel_v2 as tv2

    want_p, want_s = tv2.tree_step_v2_reference(spec, packed, sel.clone(), *leaf, sim, phase)
    before = tv2.fused_tree_step_v2.launches
    got_p, got_s = tv2.fused_tree_step_v2(spec, packed, sel.clone(), *leaf, sim, phase)
    assert tv2.fused_tree_step_v2.launches == before + 1
    _assert_equal_outputs(got_p, want_p, f"sim {sim} (phase {phase})")
    _assert_equal_outputs(got_s, want_s, f"sim {sim} (phase {phase})")
    return got_p, got_s


def _v2_root(spec, b, cap, policy, legal):
    """Packed trees of capacity ``cap`` holding an expanded, backed-up root."""
    from minizero_tpu_torch.ops import tree_kernel_v2 as tv2
    from minizero_tpu_torch.search import mcts

    turns = torch.ones((b,), dtype=torch.int32, device="cuda")
    zeros_i = torch.zeros((b,), dtype=torch.int32, device="cuda")
    trees = mcts.init_tree(spec, turns)
    trees = mcts.expand_node(spec, trees, 0, zeros_i - 1, zeros_i, turns, policy, policy.log(),
                             legal, torch.zeros((b,), dtype=torch.bool, device="cuda"))
    trees = mcts.backup(spec, trees, zeros_i, torch.zeros((b,), device="cuda"),
                        torch.zeros((b,), device="cuda"))
    return tv2.pack_trees(spec, trees, cap)


@pytest.mark.gpu
@pytest.mark.parametrize("cap", [65, 129, 201])
def test_tree_step_v2_chain_as_deep_as_the_capacity(cap):
    """Every prior on action 0 and every leaf value 0 (so q is +0.0 or, under
    the player flip, -0.0): each walk re-follows the previous path and goes
    one level deeper, and the last walks the whole chain of cap - 1 levels at
    the Go 9x9 shapes (A = 82) and B = 37. Then, from the state before the
    last step, the node halfway down loses its child's prior and gains an
    open lane of prior 1: the next walk follows the prefetched path halfway
    and leaves it there. Kernel and plain version on every step."""
    _need_card()
    from minizero_tpu_torch.ops import tree_kernel_v2 as tv2
    from minizero_tpu_torch.search import mcts

    b, a = 37, 82
    spec = mcts.SearchSpec(action_size=a, num_simulations=cap - 1, use_gumbel=False,
                           flip_player2_value=True, init_q_average=False)
    logit = torch.full((b, a), -30.0, device="cuda")
    logit[:, 0] = 0.0
    policy = torch.softmax(logit, -1)
    legal = torch.ones((b, a), dtype=torch.bool, device="cuda")
    no_term = torch.zeros((b,), dtype=torch.bool, device="cuda")
    zero_v = torch.zeros((b,), device="cuda")

    def leaf(sim):
        turn = torch.full((b,), 1 + sim % 2, dtype=torch.int32, device="cuda")
        return policy, legal, no_term, zero_v, turn

    packed = _v2_root(spec, b, cap, policy, legal)
    sel = tv2.empty_selection_v2(spec, b, cap, "cuda")
    for sim in range(cap - 1):
        packed, sel = _v2_step_checked(spec, packed, sel, leaf(sim), sim, 0 if sim == 0 else 1)
    before_last = (packed.clone(), sel.clone())
    _, last = _v2_step_checked(spec, packed, sel, leaf(cap - 1), cap - 1, 1)
    assert bool((last.path.sum(1) == cap).all()) and bool((last.parent == cap - 1).all())

    packed, sel = before_last
    half = (cap - 1) // 2
    packed.pedge[:, half + 1] = 0.0
    packed.prior[:, half, 1] = 1.0
    _, left = _v2_step_checked(spec, packed, sel, leaf(cap - 1), cap - 1, 1)
    assert bool((left.path.sum(1) == half + 1).all())
    assert bool((left.parent == half).all()) and bool((left.action == 1).all())
    assert bool(left.is_new.all())


def _crafted_v2_trees(b, a, cap, seed):
    """Packed trees whose scores tie often: a root of 1 or 3 visits (so
    sqrt(n) is 0 or not) whose lanes are illegal, open, expanded children or
    terminal children (node 1 + a), with means, edge priors and row priors
    drawn from a few values that include -0.0 and +0.0; each child's own
    row is all open lanes. Node cap - 1 stays free for an expansion."""
    from minizero_tpu_torch.ops import tree_kernel_v2 as tv2

    rng = np.random.default_rng(seed)
    lanes = a + tv2.SPARE
    priors = np.array([-0.0, 0.0, 0.25, 0.5], np.float32)
    means = np.array([-0.0, 0.0, 0.5, -0.5], np.float32)
    kind = rng.integers(0, 4, size=(b, a))  # 0 illegal, 1 open, 2 child, 3 terminal child
    kind[:, 0] = np.where(kind[:, 0] == 0, 1, kind[:, 0])
    prior = np.zeros((b, cap, lanes), np.float32)
    cix = np.full((b, cap, lanes), -2, np.int32)
    visits = np.zeros((b, cap), np.float32)
    mean = np.zeros((b, cap), np.float32)
    value = np.zeros((b, cap), np.float32)
    pedge = np.zeros((b, cap), np.float32)
    pvec = np.full((b, cap), -1, np.int32)
    avec = np.full((b, cap), -1, np.int32)
    pterm = np.zeros((b, cap), np.int32)
    node = 1 + np.arange(a)
    prior[:, 0, :a] = priors[rng.integers(0, 4, size=(b, a))]
    cix[:, 0, :a] = np.select([kind == 1, kind == 2, kind == 3], [-1, node, -3 - node], -2)
    cix[:, 0, a:a + 5] = np.array([-1, -1, 1, 1, 0])
    cix[:, 0, a + 2] = rng.integers(1, 3, size=b)
    visits[:, 0] = np.where(rng.random(b) < 0.5, 1.0, 3.0)
    has = kind >= 2
    visits[:, 1:a + 1] = np.where(has, rng.integers(1, 3, size=(b, a)), 0)
    mean[:, 1:a + 1] = np.where(has, means[rng.integers(0, 4, size=(b, a))], 0.0)
    value[:, 1:a + 1] = np.where(has, rng.uniform(-1, 1, size=(b, a)), 0.0)
    pedge[:, 1:a + 1] = np.where(has, priors[rng.integers(0, 4, size=(b, a))], 0.0)
    pvec[:, 1:a + 1] = np.where(has, 0, -1)
    avec[:, 1:a + 1] = np.where(has, np.arange(a), -1)
    pterm[:, 1:a + 1] = kind == 3
    child_rows = has & (kind == 2)
    for j in range(a):
        rows = child_rows[:, j]
        prior[rows, 1 + j, :a] = priors[rng.integers(0, 4, size=(int(rows.sum()), a))]
        cix[rows, 1 + j, :a] = -1
        cix[rows, 1 + j, a:a + 5] = np.array([0, j, 1, 1, 0])
        cix[rows, 1 + j, a + 2] = rng.integers(1, 3, size=int(rows.sum()))
    t = lambda x: torch.from_numpy(x).cuda()  # noqa: E731
    return tv2.PackedTrees(prior=t(prior), cix=t(cix), visits=t(visits), mean=t(mean),
                           value=t(value), pedge=t(pedge), pvec=t(pvec), avec=t(avec),
                           pterm=t(pterm))


@pytest.mark.gpu
@pytest.mark.parametrize("init_q_average", [False, True])
def test_tree_step_v2_exact_ties_and_signed_zeros(init_q_average):
    """Crafted trees at B = 1023 (not a multiple of the four games of a
    block), A = 8: scores that tie exactly with equal and with different
    priors, children against open lanes, and -0.0 against +0.0 in scores
    and priors. A selection step (phase 0), then a full step from its
    selection: new edges expand and terminal children are revisited (their
    stored value backs up). Kernel and plain version compared on every
    field; the data is checked to hold each kind of tie."""
    _need_card()
    from minizero_tpu_torch.ops import tree_kernel_v2 as tv2
    from minizero_tpu_torch.search import mcts

    b, a = 1023, 8
    cap = a + 2
    spec = mcts.SearchSpec(action_size=a, num_simulations=cap - 1, use_gumbel=False,
                           flip_player2_value=True, init_q_average=init_q_average)
    packed = _crafted_v2_trees(b, a, cap, seed=3 + init_q_average)

    # the root's scores where sqrt(n) = 0: ties are exact by construction
    cx, pr = packed.cix[:, 0, :a], packed.prior[:, 0, :a]
    mat = (cx >= 0) | (cx <= -3)
    child = torch.where(cx >= 0, cx, -3 - cx).long().clamp(0, cap - 1)
    q = torch.gather(packed.mean, 1, child)
    q = torch.where((packed.cix[:, 0, a + 2] == 2)[:, None], -q, q)
    sum_q = torch.where(mat, q, 0.0).double().sum(-1).float()
    nv = mat.sum(-1).float()
    init_q = (torch.where(nv > 0, sum_q / nv.clamp(min=1.0), torch.ones_like(sum_q))
              if init_q_average else (sum_q - 1.0) / (nv + 1.0))
    score = torch.where(mat, q, torch.where(cx == -1, init_q[:, None], -torch.inf))
    tb = torch.where(mat, torch.gather(packed.pedge, 1, child), pr)
    flat = packed.visits[:, 0] == 1.0
    top = (score == score.amax(-1, keepdim=True)) & ((cx == -1) | mat) & flat[:, None]
    ties = top.sum(-1) >= 2
    tb_top = torch.where(top, tb, -torch.inf)
    equal_tb = ties & ((tb_top == tb_top.amax(-1, keepdim=True)) & top).sum(-1).ge(2)
    assert int(equal_tb.sum()) > 0 and int((ties & ~equal_tb).sum()) > 0
    signed = top & (torch.signbit(tb) | torch.signbit(score))
    assert int((signed.any(-1) & ties).sum()) > 0

    rng = np.random.default_rng(9 + init_q_average)
    policy = torch.from_numpy(rng.dirichlet(np.ones(a), size=b).astype(np.float32)).cuda()
    legal = torch.from_numpy(rng.random((b, a)) < 0.8).cuda()
    terminal = torch.from_numpy(rng.random(b) < 0.3).cuda()
    value = torch.from_numpy(rng.uniform(-1, 1, size=b).astype(np.float32)).cuda()
    turn = torch.from_numpy(rng.integers(1, 3, size=b).astype(np.int32)).cuda()
    leaf = (policy, legal, terminal, value, turn)
    sel = tv2.empty_selection_v2(spec, b, cap, "cuda")
    packed, sel = _v2_step_checked(spec, packed, sel, leaf, 0, 0)
    revisits = int((~sel.is_new).sum())
    assert revisits > 0 and int(sel.is_new.sum()) > 0
    _v2_step_checked(spec, packed, sel, leaf, cap - 1, 1)


@pytest.mark.gpu
def test_tree_step_v2_kernel_at_a_ragged_batch_with_revisits():
    """Random trees at the Go 9x9 action count (A = 82) and B = 1023, capacity
    stages 17 -> 33 -> 41, with many terminal leaves (revisits back up their
    stored value): kernel and plain version from the same state at every
    simulation."""
    _need_card()
    from minizero_tpu_torch.ops import tree_kernel_v2 as tv2
    from minizero_tpu_torch.search import mcts

    b, a, sims = 1023, 82, 40
    spec = mcts.SearchSpec(action_size=a, num_simulations=sims, use_gumbel=False,
                           flip_player2_value=True, init_q_average=False)
    g = torch.Generator(device="cuda").manual_seed(17)

    def leaf_inputs():
        policy = torch.softmax(torch.randn((b, a), generator=g, device="cuda") * 3.0, -1)
        legal = torch.rand((b, a), generator=g, device="cuda") < 0.9
        legal[:, 0] = True
        terminal = torch.rand((b,), generator=g, device="cuda") < 0.4
        value = torch.rand((b,), generator=g, device="cuda") * 2.0 - 1.0
        turn = (1 + (torch.rand((b,), generator=g, device="cuda") < 0.5)).to(torch.int32)
        return policy, legal.contiguous(), terminal, value, turn

    policy, legal, _, _, _ = leaf_inputs()
    caps = [17, 33, sims + 1]
    packed = _v2_root(spec, b, caps[0], policy, legal)
    sel = tv2.empty_selection_v2(spec, b, caps[0], "cuda")
    cap_i, revisits = 0, 0
    for sim in range(sims + 1):
        if sim >= caps[cap_i]:
            cap_i += 1
            packed = tv2.grow(packed, caps[cap_i])
            extra = caps[cap_i] - sel.path.shape[1]
            sel.path = torch.cat([sel.path, torch.zeros((b, extra), dtype=torch.bool,
                                                        device="cuda")], 1)
        phase = 0 if sim == 0 else 1
        revisits += int((~sel.is_new).sum()) if phase else 0
        packed, sel = _v2_step_checked(spec, packed, sel, leaf_inputs(), sim, phase)
    assert revisits > 0


def _tied_leaf(b, a, dev="cuda"):
    """Leaf priors and logits drawn from a few values (priors include -0.0
    and +0.0), so that PUCT scores and the Gumbel root step's logits tie."""
    priors = torch.tensor([-0.0, 0.0, 0.125, 0.25], device=dev)

    def make(g):
        idx = torch.randint(0, 4, (b, a), generator=g, device=dev)
        logit = torch.randint(0, 2, (b, a), generator=g, device=dev).float()
        return priors[idx], logit
    return make


@pytest.mark.gpu
def test_tree_step_halving_ticks_and_ties_in_the_board_regime():
    """Gumbel AlphaZero at the Go 9x9 action count (A = 82), n = 32, m = 8
    (two halving ticks: 8 -> 4 -> 2) and B = 1023, on leaves whose priors
    and logits tie (-0.0 and +0.0 among them): every step's halving tick,
    root step and PUCT descent, kernel against the plain version; every
    game halves its candidates."""
    _need_card()
    from minizero_tpu_torch.search import mcts

    b, a = 1023, 82
    spec = mcts.SearchSpec(action_size=a, num_simulations=32, use_gumbel=True,
                           use_gumbel_noise=False, use_dirichlet_noise=False,
                           gumbel_sample_size=8, flip_player2_value=True)
    trees, _, _ = _reward_regime_steps(spec, b, 61, _tied_leaf(b, a), rewards=False)
    assert int(trees.gumbel_sample_size.max()) < 8


@pytest.mark.gpu
def test_tree_step_reward_regime_chain_of_n_levels_with_rescale():
    """The reward regime with value rescale on a chain (every prior on
    action 0) of N = 129 nodes at B = 1023: the last backups walk 128
    parent pointers through shared memory, discounting through rewards of
    size ~100. Kernel and plain version on every step."""
    _need_card()
    from minizero_tpu_torch.search import mcts

    b, a, sims = 1023, 18, 128
    spec = mcts.SearchSpec(action_size=a, num_simulations=sims, use_gumbel=False,
                           use_dirichlet_noise=False, flip_player2_value=False, discount=0.997,
                           value_rescale=True, init_q_average=True)

    def chain_leaf(g):
        logit = torch.full((b, a), -30.0, device="cuda")
        logit[:, 0] = 0.0
        return torch.softmax(logit, -1), logit

    trees, _, depth = _reward_regime_steps(spec, b, 71, chain_leaf, reward_scale=100.0)
    assert depth == sims + 1
    assert bool((trees.visits[:, 0] == sims + 1).all())


def _wide_b1_search(a, sims, regime, b, seed, dev="cuda"):
    """Every step of a search at ``a`` > 384 actions (the tree step's wide
    kernel), each held against the plain version: the board regime with the
    Gumbel root on tied leaves (halving ticks: m = 4 at n = 16, 16 at n =
    200); the reward regime with PUCT and value rescale; or the reward
    regime with the Gumbel root, as AlphaZero runs it on the stochastic
    puzzles (one player, discount 1, value rescale, leaf rewards and values
    up to 100, tied leaves). Returns the trees, the Gumbel sample size and
    the longest selection path."""
    from minizero_tpu_torch.search import mcts

    board = regime == "board"
    gumbel = regime in ("board", "gumbel_reward")
    m0 = 4 if sims < 64 else 16
    spec = mcts.SearchSpec(action_size=a, num_simulations=sims, use_gumbel=gumbel,
                           use_gumbel_noise=False, use_dirichlet_noise=False,
                           gumbel_sample_size=m0, flip_player2_value=board,
                           discount=0.997 if regime == "reward" else 1.0,
                           value_rescale=not board, init_q_average=regime == "reward")
    make = _tied_leaf(b, a, dev) if gumbel else _random_leaf(b, a, dev)
    trees, _, depth = _reward_regime_steps(spec, b, seed, make, dev=dev, rewards=not board,
                                           reward_scale=100.0 if regime == "gumbel_reward"
                                           else 1.0)
    return trees, m0, depth


def _v2_caps(sims):
    """The engine's capacity stages for ``sims`` simulations (65 -> 129 ->
    ... -> sims + 1), or one stage below 65 nodes."""
    caps, c = [], 65
    while c < sims + 1:
        caps.append(c)
        c = (c - 1) * 2 + 1
    return caps + [sims + 1]


def _wide_b2_search(a, sims, b, seed, dev="cuda"):
    """Every step of a staged v2 search at ``a`` > 384 actions (B2's wide
    kernel) on random leaves, a third of them terminal, each held against
    the plain version. Returns the number of revisited terminal leaves."""
    from minizero_tpu_torch.ops import tree_kernel_v2 as tv2
    from minizero_tpu_torch.search import mcts

    spec = mcts.SearchSpec(action_size=a, num_simulations=sims, use_gumbel=False,
                           flip_player2_value=True, init_q_average=False)
    g = torch.Generator(device=dev).manual_seed(seed)

    def leaf_inputs():
        policy = torch.softmax(torch.randn((b, a), generator=g, device=dev) * 3.0, -1)
        legal = torch.rand((b, a), generator=g, device=dev) < 0.9
        legal[:, 0] = True
        terminal = torch.rand((b,), generator=g, device=dev) < 0.3
        value = torch.rand((b,), generator=g, device=dev) * 2.0 - 1.0
        turn = (1 + (torch.rand((b,), generator=g, device=dev) < 0.5)).to(torch.int32)
        return policy, legal.contiguous(), terminal, value, turn

    policy, legal, _, _, _ = leaf_inputs()
    turns = torch.ones((b,), dtype=torch.int32, device=dev)
    zeros_i = torch.zeros((b,), dtype=torch.int32, device=dev)
    trees = mcts.init_tree(spec, turns)
    trees = mcts.expand_node(spec, trees, 0, zeros_i - 1, zeros_i, turns, policy, policy.log(),
                             legal, torch.zeros((b,), dtype=torch.bool, device=dev))
    trees = mcts.backup(spec, trees, zeros_i, torch.zeros((b,), device=dev),
                        torch.zeros((b,), device=dev))
    caps = _v2_caps(sims)
    packed = tv2.pack_trees(spec, trees, caps[0])
    sel = tv2.empty_selection_v2(spec, b, caps[0], dev)
    cap_i, revisits = 0, 0
    for sim in range(sims + 1):
        if sim >= caps[cap_i]:
            cap_i += 1
            packed = tv2.grow(packed, caps[cap_i])
            extra = caps[cap_i] - sel.path.shape[1]
            sel.path = torch.cat([sel.path, torch.zeros((b, extra), dtype=torch.bool,
                                                        device=dev)], 1)
        phase = 0 if sim == 0 else 1
        revisits += int((~sel.is_new).sum()) if phase else 0
        packed, sel = _v2_step_checked(spec, packed, sel, leaf_inputs(), sim, phase)
    return revisits


# the wide tree steps' cases: (A, simulations, regime, B). The first 18 are
# the grid at B = 64 (ids kept as before); then a row that starts 8 bytes
# off a 16-byte boundary (A = 402), a group 5 count (A = 1456), one game (B
# = 1, a block alone on the card: the console's shape), and n = 800 (N =
# 801) at B <= 8, where the node vectors fill most of a block's shared memory
_B1_WIDE_CASES = [pytest.param(a, sims, regime, 64, id=f"{a}-{sims}-{regime}")
                  for regime in ("board", "reward", "gumbel_reward")
                  for sims in (16, 200) for a in (385, 801, 3040)] + [
    pytest.param(402, 16, "board", 64, id="402-16-board"),
    pytest.param(402, 200, "reward", 64, id="402-200-reward"),
    pytest.param(402, 16, "gumbel_reward", 1, id="402-16-gumbel_reward-B1"),
    pytest.param(1456, 16, "board", 64, id="1456-16-board"),
    pytest.param(1456, 200, "reward", 64, id="1456-200-reward"),
    pytest.param(1456, 16, "board", 1, id="1456-16-board-B1"),
    pytest.param(3040, 16, "board", 1, id="3040-16-board-B1"),
    pytest.param(402, 800, "board", 8, id="402-800-board-B8"),
    pytest.param(3040, 800, "board", 2, id="3040-800-board-B2"),
]


@pytest.mark.gpu
@pytest.mark.parametrize("a,sims,regime,b", _B1_WIDE_CASES)
def test_tree_step_above_384_actions_matches_plain(a, sims, regime, b):
    """The tree step at more actions than a lane's registers hold (A = 385,
    801 and 3040; N = 17 and 201; B = 64; and the cases above): the wide
    kernel against the plain version at every step, in the board regime
    (Gumbel root, halving ticks, tied leaves), the reward regime (PUCT,
    rescale) and the reward regime with the Gumbel root (Tetris Block
    Puzzle's 801 actions under AlphaZero: leaf rewards, rescale, halving
    ticks)."""
    _need_card()
    from minizero_tpu_torch.ops._build import kernel_attributes

    assert kernel_attributes("tree_step", a, sims + 1)["dynamic_smem"] <= 232_448
    trees, m0, depth = _wide_b1_search(a, sims, regime, b, 80 + a % 7 + sims, dev="cuda")
    assert depth >= 2
    if regime != "reward":
        assert int(trees.gumbel_sample_size.max()) < m0


@pytest.mark.gpu
@pytest.mark.parametrize("a", [402, 3040])
def test_tree_step_wide_halving_with_neg_inf_and_tied_scores(a):
    """The wide kernel's halving tick, whose rank runs over the active set
    only, against the plain version's whole-row rank: Gumbel AlphaZero at
    n = 200, m = 16 and B = 64 on tied leaves, with the budget set to 0 so
    that the first tick comes at simulation 1, when every active action
    but one is unvisited (score NEG_INF), and a third of each game's active
    actions made illegal (NEG_INF however often visited); the scores that
    are not NEG_INF tie often (logits 0 or 1). Every step compared; every
    game halves its candidates."""
    _need_card()
    from minizero_tpu_torch.search import mcts

    b = 64
    spec = mcts.SearchSpec(action_size=a, num_simulations=200, use_gumbel=True,
                           use_gumbel_noise=False, use_dirichlet_noise=False,
                           gumbel_sample_size=16, flip_player2_value=True)

    def edit(trees):
        trees = trees.clone()
        active = trees.gumbel_active.clone()
        rank = active.long().cumsum(1)
        illegal = active & (rank % 3 == 0)
        trees.legal[:, 0] &= ~illegal
        trees.gumbel_budget.zero_()
        return trees

    trees, _, _ = _reward_regime_steps(spec, b, 97 + a, _tied_leaf(b, a), rewards=False,
                                       edit=edit)
    assert int(trees.gumbel_sample_size.max()) <= 2


@pytest.mark.gpu
@pytest.mark.parametrize("a,sims,b", [pytest.param(a, sims, 64, id=f"{a}-{sims}")
                                      for sims in (16, 200) for a in (385, 801, 3040)] + [
    pytest.param(402, 200, 64, id="402-200"),
    pytest.param(1456, 200, 64, id="1456-200"),
    pytest.param(402, 200, 1, id="402-200-B1"),
    pytest.param(3040, 16, 1, id="3040-16-B1"),
    pytest.param(402, 800, 8, id="402-800-B8"),
    pytest.param(3040, 800, 4, id="3040-800-B4"),
])
def test_tree_step_v2_above_384_actions_matches_plain(a, sims, b):
    """The v2 tree step at A = 385, 801 and 3040, capacity 17 and the
    staged 65 -> 129 -> 201, B = 64; A = 402 (rows 8 bytes off a 16-byte
    boundary) and 1456; one game (B = 1); and capacity 801 (65 -> ... ->
    513 -> 801) at B <= 8: the wide kernel against the plain version at
    every step, with terminal leaves revisited."""
    _need_card()
    assert _wide_b2_search(a, sims, b, 90 + a % 5 + sims, dev="cuda") > 0


def _window(x):
    """Bytes of the 16-byte aligned window a bulk copy of x bytes fetches."""
    return 16 * ((x + 30) // 16)


def _round16(x):
    return 16 * ((x + 15) // 16)


def _wide_warps(a):
    return min(8, max(2, (a + 383) // 384))


def _b1_wide_smem(n, a):
    """The wide tree step's block (one game): two mbarriers, two sets of
    48-byte reduction slots a warp, two row buffers (children_index, prior,
    legal), the root's active flags and the node vectors (24N + 3N bytes)."""
    return (16 + 96 * _wide_warps(a) + 2 * (2 * _window(4 * a) + _window(a)) + _window(a)
            + _round16(24 * n) + _round16(3 * n))


def _b2_wide_smem(cap, a):
    """B2's wide block: the same barriers and slots, two buffers of a cix
    and a prior row (A + 8 lanes each) and the node statistics (28 cap +
    cap bytes)."""
    lanes = a + 8
    return 16 + 96 * _wide_warps(a) + 4 * _window(4 * lanes) + _round16(28 * cap) + _round16(cap)


@pytest.mark.gpu
def test_shared_memory_ceilings():
    """On the card, the blocks' shared memory as the kernels' launchers size
    it: up to 384 actions the register kernel's four warps (5N + A +
    (3N + 3) / 4 floats each); above, the wide kernel's one game a block
    (_b1_wide_smem: two bulk-copy row buffers of about 9A bytes, the
    root's flags, the node vectors), within the 232,448 bytes a Hopper
    block may hold: the ceiling at N = 17 is A = 12,160, and past it the
    wrapper raises ValueError. B2's wide block (_b2_wide_smem) at A = 400
    holds capacities up to 7,780."""
    _need_card()
    from minizero_tpu_torch.ops import tree_kernel
    from minizero_tpu_torch.ops._build import kernel_attributes
    from minizero_tpu_torch.search import mcts

    def b1(n, a):
        return kernel_attributes("tree_step", a, n)["dynamic_smem"]

    def b2(cap, a=400):
        return kernel_attributes("tree_step_v2", a, cap)["dynamic_smem"]

    limit = 232_448
    assert b1(17, 82) == 16 * (5 * 17 + 82 + 13)
    assert b1(17, 384) == 16 * (5 * 17 + 384 + 13)
    for n, a in ((17, 385), (17, 402), (17, 801), (17, 1456), (17, 3040), (201, 3040),
                 (801, 3040), (801, 402), (17, 12_160)):
        assert b1(n, a) == _b1_wide_smem(n, a) <= limit, (n, a)
    # at least two blocks an SM at Amazons' shape (228 KB an SM, 1 KB a block reserved)
    assert 2 * (b1(17, 3040) + 1024) <= 228 * 1024
    assert _b1_wide_smem(17, 12_161) > limit
    with pytest.raises(ValueError):
        b1(17, 12_161)
    assert b2(201, 82) == 16 * (5 * 201 + 51) <= limit
    for cap, a in ((51, 400), (201, 402), (801, 3040), (7_780, 400)):
        assert b2(cap, a) == _b2_wide_smem(cap, a) <= limit, (cap, a)
    assert _b2_wide_smem(7_781, 400) > limit
    with pytest.raises(ValueError):
        b2(7_781)
    spec = mcts.SearchSpec(action_size=12_161, num_simulations=16, use_gumbel=True,
                           use_gumbel_noise=False, use_dirichlet_noise=False)
    dev = torch.device("cuda")
    tree = mcts.init_tree(spec, torch.ones((1,), dtype=torch.int32, device=dev))
    sel = mcts.empty_selection(spec, 1, dev)
    leaf = (torch.zeros((1, 12_161), device=dev), torch.zeros((1, 12_161), device=dev),
            torch.ones((1, 12_161), dtype=torch.bool, device=dev),
            torch.zeros((1,), dtype=torch.bool, device=dev), torch.zeros((1,), device=dev),
            torch.ones((1,), dtype=torch.int32, device=dev))
    with pytest.raises(ValueError, match="shared memory"):
        tree_kernel.fused_tree_step(spec, tree, sel, *leaf, 0, 0)


@pytest.mark.gpu
def test_register_tree_step_refuses_more_nodes_than_a_block_holds():
    """B1's register kernel (A <= 384) past its shared-memory ceiling: its
    four warps take 16 (5N + A + (3N + 3) / 4) bytes, 232,416 at N = 2,512
    and A = 82 (the ceiling) and 240,512 at N = 2,600, above the 232,448 a
    Hopper block may hold. The launcher refuses that shape as it refuses
    the wide kernel's, so the wrapper raises the ValueError that names
    dynamic_smem, not a launch error."""
    _need_card()
    from minizero_tpu_torch.ops import tree_kernel
    from minizero_tpu_torch.ops._build import kernel_attributes
    from minizero_tpu_torch.search import mcts

    assert kernel_attributes("tree_step", 82, 2512)["dynamic_smem"] == 232_416
    with pytest.raises(ValueError):
        kernel_attributes("tree_step", 82, 2513)
    b, a, n = 4, 82, 2600
    spec = mcts.SearchSpec(action_size=a, num_simulations=n - 1, use_gumbel=True,
                           use_gumbel_noise=False, use_dirichlet_noise=False)
    dev = torch.device("cuda")
    tree = mcts.init_tree(spec, torch.ones((b,), dtype=torch.int32, device=dev))
    sel = mcts.empty_selection(spec, b, dev)
    leaf = (torch.zeros((b, a), device=dev), torch.zeros((b, a), device=dev),
            torch.ones((b, a), dtype=torch.bool, device=dev),
            torch.zeros((b,), dtype=torch.bool, device=dev), torch.zeros((b,), device=dev),
            torch.ones((b,), dtype=torch.int32, device=dev))
    with pytest.raises(ValueError, match="dynamic_smem"):
        tree_kernel.fused_tree_step(spec, tree, sel, *leaf, 0, 0)


@pytest.mark.gpu
@pytest.mark.parametrize("regime", ["board", "reward"])
def test_register_tree_step_at_801_nodes_matches_plain(regime):
    """B1's register kernel below its ceiling at n = 800 (N = 801, A = 82,
    75,008 bytes a block), B = 8: every step of a search against the plain
    version, in the board regime (Gumbel root, tied leaves, halving ticks)
    and the reward regime (PUCT, rescale)."""
    _need_card()
    from minizero_tpu_torch.ops._build import kernel_attributes

    assert kernel_attributes("tree_step", 82, 801)["dynamic_smem"] == 75_008
    trees, m0, depth = _wide_b1_search(82, 800, regime, 8, 61, dev="cuda")
    assert depth >= 2
    if regime == "board":
        assert int(trees.gumbel_sample_size.max()) < m0


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["tree_step", "tree_step_v2"])
def test_register_tree_steps_at_the_n800_protocol_shapes_match_plain(kernel):
    """The shapes of the README's n=800 protocol at its batch (B = 96, as
    ``scripts/n800_pair.py`` plays min(games, 96) games in lock-step), A =
    82: B1's register kernel on N = 801 node trees in the board regime
    (Gumbel root over 16 candidates, tied leaves, halving ticks), and B2's
    register kernel staged 65 -> 129 -> 257 -> 513 -> 801 on random leaves,
    a third terminal; every step against the plain version."""
    _need_card()
    from minizero_tpu_torch.ops._build import kernel_attributes

    if kernel == "tree_step":
        assert kernel_attributes("tree_step", 82, 801)["dynamic_smem"] == 75_008
        trees, m0, depth = _wide_b1_search(82, 800, "board", 96, 62, dev="cuda")
        assert depth >= 2 and int(trees.gumbel_sample_size.max()) < m0
        assert trees.visits[:, 0].tolist() == [801.0] * 96
    else:
        assert kernel_attributes("tree_step_v2", 82, 801)["dynamic_smem"] == 67_296
        assert _wide_b2_search(82, 800, 96, 63, dev="cuda") > 0


@pytest.mark.gpu
@pytest.mark.parametrize("algo", ["gaz", "gmz"])
def test_train_step_on_card_matches_cpu(algo):
    """3 SGD steps of the AlphaZero or MuZero (K=5) train step on the card
    and on the CPU, Go 9x9, 1 x 32, batch 64, each step from the same
    weights, running statistics, momentum and rotation ids, TF32 off: the
    metrics, parameters and running statistics agree within 1e-4 (the card
    sums the convolutions in another order, and a ReLU input within float
    noise of 0 may land on either side of its kink: the momentum, one
    step's raw gradient, is not compared; ``chip_smoke.py`` phase 6c)."""
    _need_card()
    import copy

    from minizero_tpu_torch.config import algorithm_preset, default_config
    from minizero_tpu_torch.envs import make_env
    from minizero_tpu_torch.learner.train import init_train_state, make_train_step
    from minizero_tpu_torch.models.factory import create_network, init_network
    from minizero_tpu_torch.utils.bitpack import pack_planes

    over = dict(algorithm_preset(algo))
    over.update(nn_num_hidden_channels=32, nn_num_value_hidden_channels=32)
    cfg = default_config("go", **over)
    env = make_env(cfg)
    spec, b, k = env.spec, 64, cfg.learner_muzero_unrolling_step
    cpu_net = init_network(create_network(cfg, spec), seed=3)
    card_net = copy.deepcopy(cpu_net).cuda()
    cpu_state, card_state = init_train_state(cfg, cpu_net), init_train_state(cfg, card_net)
    cpu_step, card_step = make_train_step(cfg, env, cpu_net), make_train_step(cfg, env, card_net)
    rng = np.random.default_rng(4)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for s in range(3):
            card_net.load_state_dict(cpu_net.state_dict())
            card_state.optimizer.load_state_dict(copy.deepcopy(cpu_state.optimizer.state_dict()))
            card_state.step = cpu_state.step
            planes = torch.from_numpy(rng.random((b, 9, 9, 18)) > 0.5)
            p = rng.random((b, k + 1, spec.action_size) if algo == "gmz" else (b, spec.action_size))
            batch = {"features": pack_planes(planes).numpy(), "loss_scale": np.ones(b, np.float32),
                     "policy": (p / p.sum(-1, keepdims=True)).astype(np.float16)}
            if algo == "gmz":
                batch.update(value=rng.choice([-1.0, 1.0], (b, k + 1)).astype(np.float32),
                             actions=rng.integers(0, spec.action_size, (b, k)).astype(np.int32),
                             reward=np.zeros((b, k), np.float32))
            else:
                batch["value"] = rng.choice([-1.0, 1.0], b).astype(np.float32)
            rots = torch.from_numpy(rng.integers(0, 8, b))
            m_cpu = cpu_step(cpu_state, batch, rotations=rots)
            m_card = card_step(card_state, batch, rotations=rots.cuda())
            for key in m_cpu:
                torch.testing.assert_close(m_card[key].cpu(), m_cpu[key], rtol=0, atol=1e-4,
                                           msg=f"step {s}: {key}")
            sd_card = card_net.state_dict()
            for key, want in cpu_net.state_dict().items():
                torch.testing.assert_close(sd_card[key].cpu(), want, rtol=0, atol=1e-4,
                                           msg=f"step {s}: {key}")
            assert not card_net.training
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


@pytest.mark.gpu
def test_native_codec_builds_and_loads_on_the_card_machine():
    """The record codec builds with g++ into ``_build/`` and writes the
    plain writer's strings."""
    _need_card()
    from minizero_tpu_torch import native
    from minizero_tpu_torch.learner.replay import GameRecord
    from minizero_tpu_torch.selfplay.record import serialize_game

    assert native.load() is not None, native.load_error()
    assert os.path.exists(native.library_path())
    rng = np.random.default_rng(5)
    for length in (0, 1, 40):
        p = rng.random((length, 82)) * (rng.random((length, 82)) > 0.5)
        p[:, 0] += 1e-3
        rec = GameRecord(actions=rng.integers(0, 82, length).astype(np.int32),
                         policy=(p / p.sum(-1, keepdims=True)).astype(np.float16),
                         values=rng.uniform(-1, 1, length).astype(np.float32),
                         rewards=np.zeros(length, np.float32),
                         features=np.zeros((length, 9, 9, 3), np.uint8), result=1.0)
        assert (serialize_game("go_9x9", rec, 9, model_file="weight_iter_0")
                == serialize_game("go_9x9", rec, 9, model_file="weight_iter_0", plain=True))


# ---------------------------------------------------------------------------
# the console and eval paths on the card: B1 at B=1, the timed search, a
# small match, each against the plain version or the CPU
# ---------------------------------------------------------------------------

def _integer_net(spec, seed, muzero=False):
    """``chip_smoke.integer_net`` (``integer_muzero_net`` with ``muzero``):
    integer weights, so the card and the CPU evaluate it alike (up to ~1 ulp
    in the softmax)."""
    sys.path.insert(0, ROOT)
    import chip_smoke

    return (chip_smoke.integer_muzero_net if muzero else chip_smoke.integer_net)(spec, seed)


@pytest.mark.gpu
@pytest.mark.parametrize("env_name,algo,over", [
    ("othello", "gaz", {}), ("nogo", "gaz", {}),
    ("killallgo", "gaz", {"env_killallgo_use_seki": True}), ("clobber", "gaz", {}),
    ("clobber", "az", {"actor_num_simulation": 50}), ("gomoku", "gaz", {}),
    ("outer_open_gomoku", "gaz", {}), ("hex", "gaz", {}),
    ("puzzle2048", "gmz", {}), ("puzzle2048", "gaz", {}),
    ("puzzle2048", "az", {"actor_num_simulation": 200}), ("tetrisblockpuzzle", "gmz", {}),
    ("rubiks", "gaz", {}), ("connect6", "gaz", {}), ("dotsandboxes", "gaz", {}),
    ("breakthrough", "gaz", {}), ("conhex", "gaz", {}), ("havannah", "gaz", {}),
    ("linesofaction", "gaz", {}), ("surakarta", "gaz", {}), ("santorini", "gaz", {}),
    ("amazons", "gaz", {})])
def test_new_family_move_on_card_matches_cpu(env_name, algo, over):
    """One move of each family ported after Go and TicTacToe at B=32 on the card and
    on the CPU from the same random openings (integer-exact net, float32,
    noise and rotation off; each device builds a fixed start itself, and
    the random starts of 2048, Tetris and Rubik's are drawn on the CPU and
    copied to the card): actions, stepped states (the
    chance streams' draws among them), rewards, terminal flags and scores
    equal; policy targets within 1e-4, root values within 1e-5 (relative
    for the puzzles' scores). Clobber's 400 actions take the wide kernels:
    B1 (gaz) and, with az n=50, B2 and B3 on the large-N loop; Tetris's 801
    take B1's; 2048 gaz runs B1' (the env's rewards in the tree), and so
    does 2048 az n=200: B2 has no reward regime, so a reward env stays on
    B1 at N=201. Lines of Action, Surakarta, Santorini and Amazons (A =
    1,456 / 1,296 / 1,900 / 3,040) take B1's wide kernel; their cycle rule
    sorts and searches the history on each device."""
    _need_card()
    from minizero_tpu_torch.config import algorithm_preset, default_config
    from minizero_tpu_torch.envs import make_env
    from minizero_tpu_torch.envs.base import Env, map_state
    from minizero_tpu_torch.ops.tree_kernel import fused_tree_step
    from minizero_tpu_torch.ops.tree_kernel_v2 import fused_tree_step_v2
    from minizero_tpu_torch.selfplay.engine import SelfPlayEngine

    small = dict(algorithm_preset(algo))
    small.update(actor_use_gumbel_noise=False, actor_use_dirichlet_noise=False,
                 actor_use_random_rotation_features=False, actor_select_action_by_count=True,
                 **over)
    cfg = default_config(env_name, **small)
    env = make_env(cfg)
    muzero = algo.endswith("mz")
    gpu = SelfPlayEngine(env, cfg, _integer_net(env.spec, 3, muzero), use_bf16=False,
                         device="cuda")
    cpu = SelfPlayEngine(env, cfg, _integer_net(env.spec, 3, muzero), use_bf16=False,
                         device="cpu")
    assert gpu.use_tree_kernel_v2 == (algo == "az" and not gpu.env_rewards)
    if type(env).init_random is Env.init_random:  # a fixed start: each device builds its own
        gs, cs = gpu.init_batch(32), cpu.init_batch(32)
    else:  # CPU and CUDA generators draw different streams: one random start for both
        cs = cpu.init_batch(32)
        gs = map_state(lambda x: x.cuda(), cs)
    rng = np.random.default_rng(4)
    for _ in range(3):  # distinct random openings, the same on both devices
        legal = env.legal_mask(cs).numpy()
        a = torch.from_numpy((rng.random(legal.shape) * legal).argmax(-1).astype(np.int32))
        gs, cs = env.step(gs, a.cuda()), env.step(cs, a)
    counters = ("launches", "launches_rewards")
    before = [getattr(fused_tree_step, c) for c in counters] + [fused_tree_step_v2.launches]
    go, co = gpu.move(gs), cpu.move(cs)
    torch.cuda.synchronize()
    n = cfg.actor_num_simulation + 1
    after = [getattr(fused_tree_step, c) for c in counters] + [fused_tree_step_v2.launches]
    want = [0, 0, 0]
    want[2 if gpu.use_tree_kernel_v2 else 1 if gpu.env_rewards and not gpu.is_muzero else 0] = n
    assert [x - y for x, y in zip(after, before)] == want
    assert torch.equal(go.action.cpu(), co.action)
    for name in ("done", "eval_score", "turn", "reward"):
        assert torch.equal(getattr(go, name).cpu(), getattr(co, name)), name
    for f in dataclasses.fields(co.states):
        assert torch.equal(getattr(go.states, f.name).cpu(), getattr(co.states, f.name)), f.name
    torch.testing.assert_close(go.policy_target.cpu(), co.policy_target, rtol=0, atol=1e-4)
    # a puzzle's root value is a score (up to hundreds): relative there
    rtol = 1e-5 if env.spec.discrete_value_size > 1 else 0
    torch.testing.assert_close(go.root_value.cpu(), co.root_value, rtol=rtol, atol=1e-5)


@pytest.mark.gpu
def test_host_engine_ring_and_moves_on_card_match_cpu():
    """The Atari host engine on the card and on the CPU over two vec envs of
    the same seeds (FakeALE, integer-exact MuZero net, f32, noise off,
    select by count), across episode resets: the device ring and action
    ids, the assembled stacks, actions and rewards equal, policy targets
    within 1e-4, root values within 1e-5 relative; every tree step a
    reward-regime launch (B1') on the card."""
    _need_card()
    from minizero_tpu_torch.config import algorithm_preset, default_config
    from minizero_tpu_torch.envs import atari
    from minizero_tpu_torch.ops.tree_kernel import fused_tree_step
    from minizero_tpu_torch.selfplay.host_engine import HostSelfPlayEngine

    over = dict(algorithm_preset("mz", is_atari=True))
    over.update(actor_num_simulation=8, actor_use_dirichlet_noise=False,
                actor_select_action_by_count=True)
    cfg = default_config("atari", **over)
    engines = []
    for device in ("cuda", "cpu"):
        vec = atari.AtariVecEnv(16, seed=3, ale_factory=lambda s: atari.FakeALE(seed=s, length=40))
        engines.append(HostSelfPlayEngine(vec, cfg, _integer_net(vec.spec, 7, muzero=True),
                                          use_bf16=False, device=device))
    gpu, cpu = engines
    before = (fused_tree_step.launches, fused_tree_step.launches_rewards)
    for mv in range(14):
        go, co = gpu.move(), cpu.move()
        assert torch.equal(gpu._ring.cpu(), cpu._ring) and torch.equal(gpu._ahist.cpu(), cpu._ahist)
        assert torch.equal(gpu.features().cpu(), cpu.features()), f"move {mv}"
        np.testing.assert_array_equal(go.action, co.action, err_msg=f"move {mv}")
        np.testing.assert_array_equal(go.reward, co.reward)
        np.testing.assert_array_equal(go.frames, co.frames)
        np.testing.assert_allclose(go.policy_target, co.policy_target, rtol=0, atol=1e-4)
        np.testing.assert_allclose(go.root_value, co.root_value, rtol=1e-5, atol=1e-5)
        assert gpu.vec_env.reset_done() == cpu.vec_env.reset_done()
    after = (fused_tree_step.launches, fused_tree_step.launches_rewards)
    assert (after[0] - before[0], after[1] - before[1]) == (0, 14 * 9)


@pytest.mark.gpu
def test_frame_window_assembly_on_card_matches_cpu():
    """The frame window on the card and on the CPU, fed the same records
    (chunks with lead history, a wrapped ring): the stacks of random gather
    plans are byte-equal, and equal the host-memory path's."""
    _need_card()
    from minizero_tpu_torch.learner.frame_window import FrameWindow
    from minizero_tpu_torch.learner.replay import GameRecord

    rng = np.random.default_rng(2)
    windows = [FrameWindow(700, 96, 96, device="cuda"), FrameWindow(700, 96, 96, device="cpu"),
               FrameWindow(700, 96, 96, device="cpu", on_device=False)]
    records = []
    for i in range(12):
        n, lead = int(rng.integers(20, 120)), int(rng.integers(0, 9))
        rec = GameRecord(actions=rng.integers(0, 18, n).astype(np.int32),
                         policy=np.zeros((n, 18), np.float16), values=np.zeros(n, np.float32),
                         rewards=np.zeros(n, np.float32), features=None, result=0.0,
                         frames=rng.integers(0, 256, (lead + n, 96, 96, 3)).astype(np.uint8),
                         frame_lead=lead, lead_actions=rng.integers(0, 18, lead).astype(np.int32))
        for fw in windows:
            fw.add(rec)
        records.append(rec)
    live = [r for r in records if r in windows[0]]
    assert len(live) < len(records) and all(all(r in fw for fw in windows) for r in live)
    pick = rng.integers(0, len(live), 256)
    recs = [live[i] for i in pick]
    pos = np.array([rng.integers(0, r.length) for r in recs])
    plans = [fw.lookup(recs, pos) for fw in windows]
    got = [fw.assemble(plan) for fw, plan in zip(windows, plans)]
    assert got[0].device.type == "cuda" and got[0].dtype == torch.uint8
    assert torch.equal(got[0].cpu(), got[1]) and torch.equal(got[1], got[2])


def _console_cfg(**over):
    from minizero_tpu_torch.config import algorithm_preset, default_config

    base = dict(algorithm_preset("gaz"))
    base.update(actor_use_gumbel_noise=False, actor_use_dirichlet_noise=False,
                actor_use_random_rotation_features=False, actor_select_action_by_count=True)
    base.update(over)
    return default_config("go", **base)


@pytest.mark.gpu
def test_console_genmove_at_batch_one_matches_plain_on_card():
    """Every tree step of one console ``genmove`` (B=1, Go 9x9 gaz n=16,
    float32) by the kernel and the plain version from the same state, and
    the move equal to the CPU console's."""
    _need_card()
    from minizero_tpu_torch.console.gtp import ConsoleActor
    from minizero_tpu_torch.envs import make_env
    from minizero_tpu_torch.ops.tree_kernel import fused_tree_step, tree_step_reference

    cfg = _console_cfg()
    spec = make_env(cfg).spec
    card = ConsoleActor(cfg, network=_integer_net(spec, 3))
    cpu = ConsoleActor(cfg, network=_integer_net(spec, 3), device="cpu")
    assert card.device.type == "cuda"
    steps = []

    def checked(spec, trees, sel, *rest, leaf_reward=None):
        want_t, want_s = tree_step_reference(spec, trees.clone(), sel.clone(), *rest,
                                             leaf_reward=leaf_reward)
        got_t, got_s = fused_tree_step(spec, trees, sel, *rest, leaf_reward=leaf_reward)
        _assert_equal_outputs(got_t, want_t, f"sim {rest[-2]}")
        _assert_equal_outputs(got_s, want_s, f"sim {rest[-2]}")
        steps.append(rest[-2])
        return got_t, got_s

    card.engine.tree_step = checked
    for a in (40, 30):
        assert card.act(a) and cpu.act(a)
    before = fused_tree_step.launches
    action, _ = card.think()
    torch.cuda.synchronize()
    assert steps == list(range(17)) and fused_tree_step.launches == before + 17
    assert action == cpu.think()[0]


@pytest.mark.gpu
def test_timed_search_on_card_matches_cpu():
    """6 of 16 simulations, then the rest, on the card and on the CPU from
    the same positions: visits equal at both points."""
    _need_card()
    from minizero_tpu_torch.envs import make_env
    from minizero_tpu_torch.selfplay.engine import SelfPlayEngine

    cfg = _console_cfg()
    env = make_env(cfg)
    card = SelfPlayEngine(env, cfg, _integer_net(env.spec, 4), use_bf16=False, device="cuda")
    cpu = SelfPlayEngine(env, cfg, _integer_net(env.spec, 4), use_bf16=False, device="cpu")
    gs, cs = card.init_batch(8), cpu.init_batch(8)
    rng = np.random.default_rng(1)
    for _ in range(6):
        legal = env.legal_mask(cs).numpy()
        a = torch.from_numpy((rng.random(legal.shape) * legal).argmax(-1).astype(np.int32))
        gs, cs = env.step(gs, a.cuda()), env.step(cs, a)
    gcarry, ccarry = card.az_init_timed(gs), cpu.az_init_timed(cs)
    for lo, hi in ((1, 7), (7, 17)):
        gcarry, ccarry = card.az_advance_timed(gcarry, lo, hi), cpu.az_advance_timed(ccarry, lo, hi)
        ga, *_, gt = card.az_finish_timed(gcarry)
        ca, *_, ct = cpu.az_finish_timed(ccarry)
        assert torch.equal(gt.visits.cpu(), ct.visits) and torch.equal(ga.cpu(), ca)
        assert (ct.visits[:, 0] == hi).all()


@pytest.mark.gpu
def test_eval_match_on_card_matches_cpu(monkeypatch):
    """A small synchronized match (Go 9x9 gaz n=16, 8 games at B=4, a
    40-move cap, float32) gives the same result on the card and the CPU."""
    _need_card()
    import functools

    import minizero_tpu_torch.eval.match as tmatch
    from minizero_tpu_torch.envs import make_env
    from minizero_tpu_torch.ops.tree_kernel import fused_tree_step

    monkeypatch.setattr(tmatch, "SelfPlayEngine",
                        functools.partial(tmatch.SelfPlayEngine, use_bf16=False))
    cfg = _console_cfg(zero_num_parallel_games=4)
    spec = make_env(cfg).spec
    results = []
    for device in ("cuda", "cpu"):
        before = fused_tree_step.launches
        r = tmatch.play_match(cfg, _integer_net(spec, 5), _integer_net(spec, 6), num_games=8,
                              seed=0, max_moves=40, opening_random_plies=0, device=device)
        results.append((r.p1_wins, r.p2_wins, r.draws))
        launched = fused_tree_step.launches - before
        assert (launched > 0) == (device == "cuda") and launched % (17 * 16) == 0
    assert results[0] == results[1] and sum(results[0]) == 8


def test_port_and_chip_smoke_import_without_jax():
    """``minizero_tpu_torch`` (every module, the MuZero ones and the tools by
    name), ``chip_smoke``, ``scripts/zero_recipe_torch.py`` and
    ``scripts/multi_card_torch.py`` import with
    jax, flax, msgpack, the JAX
    package, matplotlib and PIL blocked (the card's machine has none of
    them: the tools import their drawing libraries where they draw)."""
    code = "\n".join([
        "import importlib, pkgutil, sys",
        "for name in ('jax', 'jaxlib', 'flax', 'optax', 'msgpack', 'minizero_tpu', 'tests',",
        "             'matplotlib', 'PIL'):",
        "    sys.modules[name] = None",
        "import minizero_tpu_torch",
        "names = [m.name for m in pkgutil.walk_packages(minizero_tpu_torch.__path__, 'minizero_tpu_torch.')]",
        "for name in names:",
        "    importlib.import_module(name)",
        "assert {'minizero_tpu_torch.models.muzero', 'minizero_tpu_torch.selfplay.muzero_search',",
        "        'minizero_tpu_torch.envs.atari', 'minizero_tpu_torch.weights',",
        "        'minizero_tpu_torch.search.decide', 'minizero_tpu_torch.zero.loop',",
        "        'minizero_tpu_torch.learner.train', 'minizero_tpu_torch.native',",
        "        'minizero_tpu_torch.eval.match', 'minizero_tpu_torch.console.gtp',",
        "        'minizero_tpu_torch.utils.progress', 'minizero_tpu_torch.utils.color_message',",
        "        'minizero_tpu_torch.selfplay.host_engine', 'minizero_tpu_torch.learner.frame_window',",
        "        'minizero_tpu_torch.tools.obs', 'minizero_tpu_torch.envs.linesofaction',",
        "        'minizero_tpu_torch.envs.surakarta', 'minizero_tpu_torch.envs.santorini',",
        "        'minizero_tpu_torch.envs.amazons', 'minizero_tpu_torch.envs.cycle',",
        "        'minizero_tpu_torch.tools.analysis', 'minizero_tpu_torch.tools.to_sgf',",
        "        'minizero_tpu_torch.tools.plot_board', 'minizero_tpu_torch.tools.to_video',",
        "        'minizero_tpu_torch.tools.dependency_graph', 'minizero_tpu_torch.tools.profile',",
        "        'minizero_tpu_torch.tools.trace_report', 'minizero_tpu_torch.parallel.mesh',",
        "        'minizero_tpu_torch.parallel.distributed', 'minizero_tpu_torch.parallel.watchdog',",
        "        'minizero_tpu_torch.__main__'} <= set(names), names",
        "import chip_smoke",
        "import importlib.util",
        "spec = importlib.util.spec_from_file_location('recipe', 'scripts/zero_recipe_torch.py')",
        "recipe = importlib.util.module_from_spec(spec)",
        "spec.loader.exec_module(recipe)",
        "assert recipe.recipe_config().zero_num_games_per_iteration == 2000",
        "spec = importlib.util.spec_from_file_location('multi_card', 'scripts/multi_card_torch.py')",
        "multi_card = importlib.util.module_from_spec(spec)",
        "spec.loader.exec_module(multi_card)",
        "assert multi_card.WORLD == 4 and multi_card.config().learner_batch_size == 1024",
        "assert not any(k.split('.')[0] in ('jax', 'flax', 'minizero_tpu') and sys.modules[k] is not None",
        "               for k in list(sys.modules))",
    ])
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=300)


def test_entry_points_raise_without_a_card():
    """Entry points default to CUDA and raise where there is none; the CPU
    runs only when asked for."""
    from minizero_tpu_torch import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device()
    # the console's actor and the eval match: the card by default, the CPU
    # only when asked for
    from minizero_tpu_torch.config import default_config
    from minizero_tpu_torch.console.gtp import ConsoleActor
    from minizero_tpu_torch.envs import make_env
    from minizero_tpu_torch.eval.match import play_match
    from minizero_tpu_torch.models.factory import create_network

    cfg = default_config("tictactoe", nn_num_hidden_channels=8, nn_num_value_hidden_channels=8,
                         actor_num_simulation=2, zero_num_parallel_games=2)
    net = create_network(cfg, make_env(cfg).spec)
    assert ConsoleActor(cfg, network=net, device="cpu").states.board.device.type == "cpu"
    assert play_match(cfg, net, net, num_games=2, device="cpu").games == 2
    if torch.cuda.is_available():
        assert ConsoleActor(cfg, network=net).states.board.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ConsoleActor(cfg, network=net)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            play_match(cfg, net, net, num_games=2)


@pytest.mark.gpu
def test_profile_and_trace_report_count_b1_on_card(tmp_path):
    """``tools/profile.py`` on the card (Go 9x9 gaz n=16, 1 x 32, B=64, 2
    steady moves, 2 SGD steps) with a trace: ``tools/trace_report.py``
    finds B1's kernel exactly 17 times a steady move, by name and under
    its own name by source (it is launched through ctypes, outside any
    op); the launch counter saw the first move's 17 too."""
    _need_card()
    from minizero_tpu_torch.config import algorithm_preset, default_config
    from minizero_tpu_torch.ops.tree_kernel import fused_tree_step
    from minizero_tpu_torch.tools import profile, trace_report

    over = dict(algorithm_preset("gaz"))
    over.update(nn_num_hidden_channels=32, nn_num_value_hidden_channels=32, learner_batch_size=64)
    cfg = default_config("go", **over)
    before = fused_tree_step.launches
    rows = profile.profile_selfplay(cfg, moves=2, batch=64, trace_dir=str(tmp_path), train_steps=2)
    assert fused_tree_step.launches - before == 17 * 3
    assert [r["phase"] for r in rows] == ["selfplay_compile", "selfplay_steady", "train_compile",
                                          "train_steady"]
    trace = str(tmp_path / profile.SELFPLAY_TRACE)
    for by in ("op", "source"):
        found, total_us = trace_report.aggregate(trace, by=by)
        b1 = [(k, c) for k, _, c in found if "tree_step_kernel<" in k]
        assert sum(c for _, c in b1) == 17 * 2, (by, b1)
        assert total_us > 0
    assert trace_report.main(["-trace_dir", str(tmp_path)]) == 0


@pytest.mark.gpu
def test_world_one_nccl_train_step_matches_plain_on_card():
    """The data-parallel train step in an NCCL group of one rank equals the
    plain step on the card (Go 9x9 gaz, 1 x 32, batch 64, TF32 off):
    metrics and parameters within 1e-5."""
    _need_card()
    import copy
    import socket

    import torch.distributed as dist

    from minizero_tpu_torch.config import algorithm_preset, default_config
    from minizero_tpu_torch.envs import make_env
    from minizero_tpu_torch.learner.train import init_train_state, make_train_step
    from minizero_tpu_torch.models.factory import create_network, init_network
    from minizero_tpu_torch.parallel.distributed import make_sharded_train_step
    from minizero_tpu_torch.parallel.mesh import make_mesh
    from minizero_tpu_torch.utils.bitpack import pack_planes

    over = dict(algorithm_preset("gaz"))
    over.update(nn_num_hidden_channels=32, nn_num_value_hidden_channels=32)
    cfg = default_config("go", **over)
    env = make_env(cfg)
    plain_net = init_network(create_network(cfg, env.spec), seed=3).cuda()
    dp_net = copy.deepcopy(plain_net)
    rng = np.random.default_rng(5)
    b = 64
    p = rng.random((b, env.spec.action_size))
    batch = {"features": pack_planes(torch.from_numpy(rng.random((b, 9, 9, 18)) > 0.5)).numpy(),
             "loss_scale": np.ones(b, np.float32), "value": rng.choice([-1.0, 1.0], b).astype(np.float32),
             "policy": (p / p.sum(-1, keepdims=True)).astype(np.float16)}
    rots = torch.from_numpy(rng.integers(0, 8, b)).cuda()
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", world_size=1, rank=0)
    try:
        mesh = make_mesh(device="cuda")
        m_plain = make_train_step(cfg, env, plain_net)(init_train_state(cfg, plain_net), batch,
                                                       rotations=rots)
        m_dp = make_sharded_train_step(cfg, env, dp_net, mesh)(init_train_state(cfg, dp_net),
                                                                batch, rotations=rots)
    finally:
        dist.destroy_process_group()
        torch.backends.cudnn.allow_tf32 = tf32
    for key in m_plain:
        torch.testing.assert_close(m_dp[key], m_plain[key], rtol=0, atol=1e-5, msg=key)
    for key, want in plain_net.state_dict().items():
        torch.testing.assert_close(dp_net.state_dict()[key], want, rtol=0, atol=1e-5, msg=key)


# one of two gloo ranks on the card, dp 1 x mp 2: argv = repo, rank, port,
# the job file (overrides, batch, rotations), the output file
_SPLIT_HEADS_RANK = r"""
import sys
sys.path.insert(0, sys.argv[1])
import torch
import torch.distributed as dist
rank, port, job_file, out_file = int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5]
torch.backends.cudnn.allow_tf32 = False
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=2, rank=rank)
from minizero_tpu_torch.config import default_config
from minizero_tpu_torch.envs import make_env
from minizero_tpu_torch.learner.train import init_train_state
from minizero_tpu_torch.models.factory import create_network, init_network
from minizero_tpu_torch.parallel.distributed import make_sharded_train_step
from minizero_tpu_torch.parallel.mesh import make_mesh, whole_state

job = torch.load(job_file, weights_only=False)
cfg = default_config("go", **job["over"])
env = make_env(cfg)
net = init_network(create_network(cfg, env.spec), seed=3).cuda()
mesh = make_mesh(model_parallel=2, device="cuda")
step = make_sharded_train_step(cfg, env, net, mesh)
metrics = step(init_train_state(cfg, net), job["batch"], rotations=job["rotations"].cuda())
whole, _ = whole_state(mesh, net)
torch.save({"metrics": {k: v.cpu() for k, v in metrics.items()},
            "model": {k: v.cpu() for k, v in whole.items()},
            "fc": tuple(net.policy_head.fc.weight.shape), "device": str(net.policy_head.fc.weight.device)},
           out_file)
dist.destroy_process_group()
print(f"RANK_{rank}_DONE", flush=True)
"""


@pytest.mark.gpu
def test_split_heads_train_step_on_two_gloo_ranks_matches_plain_on_card(tmp_path):
    """The train step with the dense heads split over mp = 2 (dp 1 x mp 2),
    two gloo ranks on the one card (NCCL refuses two ranks on one card),
    equals the plain step on the card (Go 9x9 gaz, 1 x 32, value hidden 32,
    batch 64, TF32 off): metrics and whole parameters within 1e-5, the
    policy layer's 82 outputs held 41 a rank, both ranks bitwise equal."""
    _need_card()
    import socket

    from minizero_tpu_torch.config import algorithm_preset, default_config
    from minizero_tpu_torch.envs import make_env
    from minizero_tpu_torch.learner.train import init_train_state, make_train_step
    from minizero_tpu_torch.models.factory import create_network, init_network
    from minizero_tpu_torch.utils.bitpack import pack_planes

    over = dict(algorithm_preset("gaz"))
    over.update(nn_num_hidden_channels=32, nn_num_value_hidden_channels=32)
    cfg = default_config("go", **over)
    env = make_env(cfg)
    rng = np.random.default_rng(5)
    b = 64
    p = rng.random((b, env.spec.action_size))
    batch = {"features": pack_planes(torch.from_numpy(rng.random((b, 9, 9, 18)) > 0.5)).numpy(),
             "loss_scale": np.ones(b, np.float32), "value": rng.choice([-1.0, 1.0], b).astype(np.float32),
             "policy": (p / p.sum(-1, keepdims=True)).astype(np.float16)}
    rots = torch.from_numpy(rng.integers(0, 8, b))
    job = str(tmp_path / "job.pt")
    torch.save({"over": over, "batch": batch, "rotations": rots}, job)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = str(s.getsockname()[1])
    env_vars = {k: v for k, v in os.environ.items()
                if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    procs = [subprocess.Popen([sys.executable, "-c", _SPLIT_HEADS_RANK, ROOT, str(r), port, job,
                               str(tmp_path / f"rank{r}.pt")], cwd=ROOT, env=env_vars,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        outs = [pr.communicate(timeout=300)[0] for pr in procs]
    finally:
        for pr in procs:
            pr.kill()
    for r, (pr, out) in enumerate(zip(procs, outs)):
        assert pr.returncode == 0 and f"RANK_{r}_DONE" in out, f"rank {r}:\n{out[-4000:]}"
    ranks = [torch.load(str(tmp_path / f"rank{r}.pt")) for r in range(2)]
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        net = init_network(create_network(cfg, env.spec), seed=3).cuda()
        m_plain = make_train_step(cfg, env, net)(init_train_state(cfg, net), batch,
                                                 rotations=rots.cuda())
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    for rk in ranks:
        assert rk["fc"] == (41, 2 * 81) and rk["device"].startswith("cuda"), rk["fc"]
        for key, want in ranks[0]["model"].items():
            assert torch.equal(rk["model"][key], want), key
    for key in m_plain:
        torch.testing.assert_close(ranks[0]["metrics"][key], m_plain[key].cpu(), rtol=0,
                                   atol=1e-5, msg=key)
    for key, want in net.state_dict().items():
        torch.testing.assert_close(ranks[0]["model"][key], want.cpu(), rtol=0, atol=1e-5,
                                   msg=key)


# one of four NCCL ranks, one a card, joined through the launcher's
# variables (init_distributed): argv = repo, the job file (overrides, batch,
# rotations), the output file
_DP4_NCCL_RANK = r"""
import sys
sys.path.insert(0, sys.argv[1])
import torch
import torch.distributed as dist
job_file, out_file = sys.argv[2], sys.argv[3]
torch.backends.cudnn.allow_tf32 = False
from minizero_tpu_torch.config import default_config
from minizero_tpu_torch.envs import make_env
from minizero_tpu_torch.learner.train import init_train_state
from minizero_tpu_torch.models.factory import create_network, init_network
from minizero_tpu_torch.parallel.distributed import init_distributed, make_sharded_train_step
from minizero_tpu_torch.parallel.mesh import batch_sharding, make_mesh

rank, world = init_distributed()
mesh = make_mesh()
job = torch.load(job_file, weights_only=False)
cfg = default_config("go", **job["over"])
env = make_env(cfg)
net = init_network(create_network(cfg, env.spec), seed=3).to(mesh.device)
step = make_sharded_train_step(cfg, env, net, mesh)
rows = batch_sharding(mesh, len(job["rotations"]))
metrics = step(init_train_state(cfg, net), {k: v[rows] for k, v in job["batch"].items()},
               rotations=job["rotations"][rows].to(mesh.device))
torch.save({"metrics": {k: v.cpu() for k, v in metrics.items()},
            "model": {k: v.cpu() for k, v in net.state_dict().items()},
            "backend": dist.get_backend(), "device": str(mesh.device),
            "current": torch.cuda.current_device(), "world": world}, out_file)
dist.destroy_process_group()
print(f"RANK_{rank}_DONE", flush=True)
"""


@pytest.mark.gpu
def test_four_nccl_ranks_train_step_matches_plain_on_card_zero(tmp_path):
    """The dp-4 train step on four NCCL ranks, one a card (Go 9x9 gaz,
    1 x 32, global batch 64, 16 rows a rank, TF32 off), equals the plain
    step on card 0: metrics and parameters within 1e-5 after one step, the
    four ranks bitwise equal. Needs four cards."""
    _need_card()
    if torch.cuda.device_count() < 4:
        pytest.skip(f"needs four cards, {torch.cuda.device_count()} visible")
    import socket

    from minizero_tpu_torch.config import algorithm_preset, default_config
    from minizero_tpu_torch.envs import make_env
    from minizero_tpu_torch.learner.train import init_train_state, make_train_step
    from minizero_tpu_torch.models.factory import create_network, init_network
    from minizero_tpu_torch.utils.bitpack import pack_planes

    over = dict(algorithm_preset("gaz"))
    over.update(nn_num_hidden_channels=32, nn_num_value_hidden_channels=32)
    cfg = default_config("go", **over)
    env = make_env(cfg)
    rng = np.random.default_rng(6)
    b = 64
    p = rng.random((b, env.spec.action_size))
    batch = {"features": pack_planes(torch.from_numpy(rng.random((b, 9, 9, 18)) > 0.5)).numpy(),
             "loss_scale": np.ones(b, np.float32), "value": rng.choice([-1.0, 1.0], b).astype(np.float32),
             "policy": (p / p.sum(-1, keepdims=True)).astype(np.float16)}
    rots = torch.from_numpy(rng.integers(0, 8, b))
    job = str(tmp_path / "job.pt")
    torch.save({"over": over, "batch": batch, "rotations": rots}, job)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = str(s.getsockname()[1])
    base = {k: v for k, v in os.environ.items()
            if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    procs = [subprocess.Popen([sys.executable, "-c", _DP4_NCCL_RANK, ROOT, job,
                               str(tmp_path / f"rank{r}.pt")], cwd=ROOT,
                              env=dict(base, RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE="4",
                                       MASTER_ADDR="localhost", MASTER_PORT=port),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(4)]
    try:
        outs = [pr.communicate(timeout=300)[0] for pr in procs]
    finally:
        for pr in procs:
            pr.kill()
    for r, (pr, out) in enumerate(zip(procs, outs)):
        assert pr.returncode == 0 and f"RANK_{r}_DONE" in out, f"rank {r}:\n{out[-4000:]}"
    ranks = [torch.load(str(tmp_path / f"rank{r}.pt")) for r in range(4)]
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        net = init_network(create_network(cfg, env.spec), seed=3).to("cuda:0")
        m_plain = make_train_step(cfg, env, net)(init_train_state(cfg, net), batch,
                                                 rotations=rots.to("cuda:0"))
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    for r, rk in enumerate(ranks):
        assert (rk["backend"], rk["device"], rk["current"], rk["world"]) == (
            "nccl", f"cuda:{r}", r, 4), r
        for key, want in ranks[0]["model"].items():
            assert torch.equal(rk["model"][key], want), (r, key)
    for key in m_plain:
        torch.testing.assert_close(ranks[0]["metrics"][key], m_plain[key].cpu(), rtol=0,
                                   atol=1e-5, msg=key)
    for key, want in net.state_dict().items():
        torch.testing.assert_close(ranks[0]["model"][key], want.cpu(), rtol=0, atol=1e-5,
                                   msg=key)

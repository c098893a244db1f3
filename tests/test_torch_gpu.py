"""Card-only tests of the port's CUDA kernels, and the port's import guard.

The ``gpu`` tests need a CUDA device: a CUDA kernel has no CPU mode, so they
skip without one (decided inside the test). Run them on a card with
``python -m pytest tests/test_torch_gpu.py -m gpu``.
"""

import dataclasses
import os
import subprocess
import sys

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

    def checked(spec, trees, sel, *rest):
        ref_sel = dataclasses.replace(sel, **{f.name: getattr(sel, f.name).clone()
                                              for f in dataclasses.fields(sel)})
        want_t, want_s = tree_step_reference(spec, trees.clone(), ref_sel, *rest)
        before = fused_tree_step.launches
        got_t, got_s = fused_tree_step(spec, trees, sel, *rest)
        assert fused_tree_step.launches == before + 1
        for f in dataclasses.fields(got_t):
            got, want = getattr(got_t, f.name), getattr(want_t, f.name)
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
        before = gather_rows.launches
        got = gather_rows(x, idx)
        assert gather_rows.launches == before + 1
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
@pytest.mark.parametrize("b,n,w", [(5, 7, 697), (13, 12, 128), (1023, 201, 697), (64, 9, 8)])
def test_gather_rows_kernel_matches_plain_on_card(b, n, w):
    """Odd batches, node counts that are not a multiple of 8, the Go 9x9
    row width (697 words, 4-byte copies) and widths that take 16-byte
    copies; -1 and out-of-range indices are skipped (their rows are not
    compared: the kernel leaves them undefined)."""
    _need_card()
    from minizero_tpu_torch.ops.gather_rows import gather_rows, gather_rows_reference

    g = torch.Generator(device="cuda").manual_seed(b)
    x = torch.randint(-2**31, 2**31 - 1, (b, n, w), generator=g, device="cuda", dtype=torch.int32)
    idx = torch.randint(0, n, (b,), generator=g, device="cuda", dtype=torch.int32)
    skip = torch.rand((b,), generator=g, device="cuda") < 0.3
    idx = torch.where(skip, torch.where(torch.rand((b,), generator=g, device="cuda") < 0.5, -1, n),
                      idx).to(torch.int32)
    before = gather_rows.launches
    got = gather_rows(x, idx)
    torch.cuda.synchronize()
    assert gather_rows.launches == before + 1
    want = gather_rows_reference(x, idx)
    assert torch.equal(got[~skip], want[~skip])
    assert torch.equal(got[~skip], x[torch.arange(b, device="cuda"), idx.long().clamp(0, n - 1)][~skip])


def _reward_regime_steps(spec, b, seed, make_leaf, reward_scale=1.0, dev="cuda", edit=None):
    """Root expansion, then every simulation of a search on random leaf
    inputs (MuZero interiors: all legal, never terminal), each step run by
    the CUDA kernel and the plain version from the same state and compared.
    ``edit(trees)`` may rewrite the trees before the phase-0 step. Returns
    the final trees, the final selection and the longest selection path."""
    from minizero_tpu_torch.ops.tree_kernel import fused_tree_step, tree_step_reference
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
        if sim > 0:
            reward = (torch.rand((b,), generator=g, device=dev) * 2.0 - 1.0) * reward_scale
        phase = 0 if sim == 0 else 1
        args = (policy, logit, ones, no_term, value, turns, sim, phase)
        ref_sel = dataclasses.replace(sel, **{f.name: getattr(sel, f.name).clone()
                                              for f in dataclasses.fields(sel)})
        want_t, want_s = tree_step_reference(spec, trees.clone(), ref_sel, *args,
                                             leaf_reward=reward)
        before = fused_tree_step.launches_rewards
        trees, sel = fused_tree_step(spec, trees, sel, *args, leaf_reward=reward)
        assert fused_tree_step.launches_rewards == before + 1
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
        ref_sel = dataclasses.replace(sel, **{f.name: getattr(sel, f.name).clone()
                                              for f in dataclasses.fields(sel)})
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


def test_port_and_chip_smoke_import_without_jax():
    """``minizero_tpu_torch`` (every module, the MuZero ones by name) and
    ``chip_smoke`` import with jax, flax, msgpack and the JAX package
    blocked."""
    code = "\n".join([
        "import importlib, pkgutil, sys",
        "for name in ('jax', 'jaxlib', 'flax', 'optax', 'msgpack', 'minizero_tpu', 'tests'):",
        "    sys.modules[name] = None",
        "import minizero_tpu_torch",
        "names = [m.name for m in pkgutil.walk_packages(minizero_tpu_torch.__path__, 'minizero_tpu_torch.')]",
        "for name in names:",
        "    importlib.import_module(name)",
        "assert {'minizero_tpu_torch.models.muzero', 'minizero_tpu_torch.selfplay.muzero_search',",
        "        'minizero_tpu_torch.envs.atari', 'minizero_tpu_torch.weights',",
        "        'minizero_tpu_torch.search.decide'} <= set(names), names",
        "import chip_smoke",
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

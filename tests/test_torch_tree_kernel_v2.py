"""The port's large-N tree step held against the JAX package: the layout
code (``pack_trees``, ``grow``, ``unpack_trees``) and the plain PyTorch
version ``tree_step_v2_reference`` (what ``fused_tree_step_v2`` runs on the
CPU) against the JAX ``fused_tree_step_v2`` (the Pallas kernel in interpret
mode), simulation by simulation on random trees, staged and unstaged.

Shapes of ``tests/test_tree_kernel_v2.py:108`` (B=8, A=8, n=12; capacity
stages [5, 9, n] and [n]), plus a case with average init-Q and a case with
many terminal leaves (revisited terminal children back up their stored
value). Every ``PackedTrees`` and ``V2Selection`` field is compared after
every simulation. Tolerances: integers and bools exact; floats within 1e-6
absolute (visits are small integers, means are incremental averages of
float32 values; the port sums the children's Q in float64, the JAX kernel
in float32 in node order).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minizero_tpu.ops import tree_kernel_v2 as jv2
from minizero_tpu.search import mcts as jmcts
from minizero_tpu_torch.ops import tree_kernel_v2 as tv2
from minizero_tpu_torch.search import mcts as tmcts

B, A, SIMS = 8, 8, 12
FLOAT_ATOL = 1e-6
TREE_FIELDS = ("visits", "mean", "value", "prior", "legal", "children_index", "parent",
               "action_from_parent", "to_play", "expanded", "terminal")


def _spec_kwargs(init_q_average):
    return dict(action_size=A, num_simulations=SIMS, use_gumbel=False,
                use_dirichlet_noise=True, flip_player2_value=True,
                init_q_average=init_q_average)


def _leaf_inputs(rng, p_terminal):
    logits = rng.normal(size=(B, A)).astype(np.float32)
    policy = (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)).astype(np.float32)
    legal = rng.random((B, A)) < 0.9
    legal[:, 0] = True
    terminal = rng.random(B) < p_terminal
    value = rng.uniform(-1.0, 1.0, size=B).astype(np.float32)
    turn = (1 + (rng.random(B) < 0.5)).astype(np.int32)
    return policy, legal, terminal, value, turn


def _root_trees(jspec, tspec, rng):
    """The same expanded and backed-up root, built by both packages."""
    policy, legal, _, _, _ = _leaf_inputs(rng, 0.0)
    logit = np.log(policy + 1e-9).astype(np.float32)
    value = rng.normal(size=B).astype(np.float32)
    turns = np.ones(B, np.int32)
    zeros_i = np.zeros(B, np.int32)
    no_parent = np.full(B, -1, np.int32)
    falses = np.zeros(B, bool)
    proto = jnp.zeros((3,), jnp.int8)
    jt = jax.vmap(lambda t: jmcts.init_tree(jspec, proto, t))(jnp.asarray(turns))
    jt = jax.vmap(functools.partial(jmcts.expand_node, jspec, store_embedding=False))(
        jt, *[jnp.asarray(x) for x in (zeros_i, no_parent, zeros_i, turns, policy, logit, legal,
                                       falses)])
    jt = jax.vmap(functools.partial(jmcts.backup, jspec))(
        jt, jnp.asarray(zeros_i), jnp.asarray(value), jnp.zeros((B,), jnp.float32))
    tt = tmcts.init_tree(tspec, torch.from_numpy(turns))
    tt = tmcts.expand_node(tspec, tt, 0, *[torch.from_numpy(x) for x in (
        no_parent, zeros_i, turns, policy, logit, legal, falses)])
    tt = tmcts.backup(tspec, tt, *[torch.from_numpy(x) for x in (
        zeros_i, value, np.zeros(B, np.float32))])
    return jt, tt


def _assert_same(got: torch.Tensor, want, what):
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape, f"{what}: shape {got.shape} vs {want.shape}"
    if want.dtype.kind == "f":
        np.testing.assert_allclose(got, want, rtol=0, atol=FLOAT_ATOL, err_msg=what)
    else:
        np.testing.assert_array_equal(got.astype(np.int64), want.astype(np.int64), err_msg=what)


def _check_packed(jp, tp, step):
    for f in dataclasses.fields(tp):
        _assert_same(getattr(tp, f.name), getattr(jp, f.name), f"{step}: packed.{f.name}")


def _check_sel(jsel, tsel, step):
    for f in dataclasses.fields(tsel):
        _assert_same(getattr(tsel, f.name), getattr(jsel, f.name), f"{step}: selection.{f.name}")


def _check_tree(jt, tt, step):
    for name in TREE_FIELDS:
        _assert_same(getattr(tt, name), getattr(jt, name), f"{step}: tree.{name}")


@pytest.mark.parametrize("staged,init_q_average,p_terminal", [
    (False, False, 0.1),
    (True, False, 0.1),
    (True, True, 0.1),
    (False, False, 0.45),
], ids=["unstaged", "staged", "staged-average-init-q", "terminal-leaves"])
def test_tree_step_v2_reference_matches_jax_kernel(staged, init_q_average, p_terminal):
    jspec = jmcts.SearchSpec(**_spec_kwargs(init_q_average))
    tspec = tmcts.SearchSpec(**_spec_kwargs(init_q_average))
    assert jv2.supports_fused_tree_step_v2(jspec) and tv2.supports_fused_tree_step_v2(tspec)
    assert tv2.lane_width(tspec) == jv2.lane_width(jspec) == A + 8
    n = tspec.max_nodes
    caps = [5, 9, n] if staged else [n]
    rng = np.random.default_rng(17 + 2 * staged + init_q_average)
    jt, tt = _root_trees(jspec, tspec, rng)
    jp = jv2.pack_trees(jspec, jt, caps[0])
    tp = tv2.pack_trees(tspec, tt, caps[0])
    _check_packed(jp, tp, "pack_trees")
    jsel = jv2.empty_selection_v2(jspec, B, caps[0])
    tsel = tv2.empty_selection_v2(tspec, B, caps[0], "cpu")
    _check_sel(jsel, tsel, "empty selection")
    j_step = jax.jit(lambda p, s, *args: jv2.fused_tree_step_v2(jspec, p, s, *args, interpret=True))

    cap_i = 0
    revisits = 0
    for sim in range(SIMS + 1):
        if sim >= caps[cap_i]:  # row sim must exist: grow before it
            cap_i += 1
            jp = jv2.grow(jp, caps[cap_i])
            tp = tv2.grow(tp, caps[cap_i])
            _check_packed(jp, tp, f"grow to {caps[cap_i]}")
            extra = caps[cap_i] - tsel.path.shape[1]
            jsel = jsel._replace(path=jnp.pad(jsel.path, ((0, 0), (0, extra))))
            tsel.path = torch.cat([tsel.path, torch.zeros((B, extra), dtype=torch.bool)], 1)
        li = _leaf_inputs(rng, p_terminal)
        phase = 0 if sim == 0 else 1
        revisits += int((~tsel.is_new).sum()) if phase else 0
        jp, jsel = j_step(jp, jsel, *[jnp.asarray(x) for x in li], jnp.int32(sim),
                          jnp.int32(phase))
        before, snapshot = tp, tp.clone()
        tp, tsel = tv2.tree_step_v2_reference(tspec, before, tsel,
                                              *[torch.from_numpy(x) for x in li], sim, phase)
        for f in dataclasses.fields(before):  # the plain version leaves its input unchanged
            assert torch.equal(getattr(before, f.name), getattr(snapshot, f.name)), f.name
        _check_packed(jp, tp, f"sim {sim}")
        _check_sel(jsel, tsel, f"sim {sim}")
        _check_tree(jv2.unpack_trees(jspec, jp, jt), tv2.unpack_trees(tspec, tp, tt), f"sim {sim}")
    if p_terminal > 0.4:
        assert revisits > 0  # terminal children were selected again and backed up


def test_fused_tree_step_v2_on_cpu_takes_the_plain_path():
    tspec = tmcts.SearchSpec(**_spec_kwargs(False))
    jspec = jmcts.SearchSpec(**_spec_kwargs(False))
    rng = np.random.default_rng(5)
    _, tt = _root_trees(jspec, tspec, rng)
    tp = tv2.pack_trees(tspec, tt, tspec.max_nodes)
    sel = tv2.empty_selection_v2(tspec, B, tspec.max_nodes, "cpu")
    li = [torch.from_numpy(x) for x in _leaf_inputs(rng, 0.1)]
    before = tv2.fused_tree_step_v2.launches
    want_p, want_s = tv2.tree_step_v2_reference(tspec, tp, sel, *li, 0, 0)
    got_p, got_s = tv2.fused_tree_step_v2(tspec, tp, sel, *li, 0, 0)
    for f in dataclasses.fields(want_p):
        assert torch.equal(getattr(want_p, f.name), getattr(got_p, f.name)), f.name
    for f in dataclasses.fields(want_s):
        assert torch.equal(getattr(want_s, f.name), getattr(got_s, f.name)), f.name
    assert tv2.fused_tree_step_v2.launches == before  # no kernel on CPU tensors
    gumbel = tmcts.SearchSpec(action_size=A, num_simulations=SIMS, use_gumbel=True)
    assert not tv2.supports_fused_tree_step_v2(gumbel)
    with pytest.raises(NotImplementedError):
        tv2.fused_tree_step_v2(gumbel, tp, sel, *li, 0, 0)

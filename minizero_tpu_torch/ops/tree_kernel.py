"""Fused per-simulation MCTS tree step (port of
``minizero_tpu/ops/tree_kernel.py``).

One simulation's whole tree transition for a batch of trees:

    expand(new leaf) -> backup(leaf value) -> Gumbel sequential-halving tick
    -> select the next leaf (Gumbel root step + PUCT walk)

``fused_tree_step`` launches the hand-written CUDA kernel
``csrc/tree_step.cu`` on CUDA tensors and calls ``tree_step_reference``, the
plain PyTorch version of the same contract built on ``search/mcts.py`` and
``search/gumbel.py``, on CPU tensors. Both regimes of the JAX kernel are
covered (think_batch 1): the board regime (no in-tree rewards, discount 1, no
value rescale) and the MuZero reward regime (``leaf_reward`` given, or a
discount other than 1, or value rescale), which stores the leaf's reward,
backs up with discounting and rescales Q to the tree's value bounds.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from minizero_tpu_torch.ops import _build
from minizero_tpu_torch.search import gumbel as gz
from minizero_tpu_torch.search import mcts
from minizero_tpu_torch.search.mcts import SearchSpec, Selection, Tree

# the next selection plus its root-to-leaf path mask (the JAX package's
# NextSelection): parent/action/leaf i32[B], is_new bool[B], path bool[B, N]
NextSelection = Selection


def supports_fused_tree_step(spec: SearchSpec) -> bool:
    """The kernel's domain: lock-step batching replaces virtual loss, so
    think batches stay elsewhere."""
    return spec.think_batch == 1


def tree_step_reference(
    spec: SearchSpec,
    trees: Tree,
    sel: NextSelection,
    leaf_policy, leaf_logit, leaf_legal, leaf_terminal, leaf_value, leaf_turn,
    node_idx: int, phase: int,
    leaf_reward: Optional[torch.Tensor] = None,
) -> Tuple[Tree, NextSelection]:
    """Plain PyTorch version of the fused step; leaves its inputs unchanged
    and returns ``(trees, next_selection)``. ``phase == 0``: selection only."""
    if phase > 0:
        b = trees.visits.shape[0]
        rows = torch.arange(b, device=trees.visits.device)
        trees = mcts.expand_node(
            spec, trees, node_idx, sel.parent, sel.action, leaf_turn,
            leaf_policy, leaf_logit, leaf_legal, leaf_terminal, enabled=sel.is_new)
        start = torch.where(sel.is_new, int(node_idx), sel.leaf.long().clamp(min=0))
        if leaf_reward is None:
            leaf_reward = torch.zeros_like(leaf_value)
        v = torch.where(sel.is_new, leaf_value, trees.value[rows, start])
        r = torch.where(sel.is_new, leaf_reward, trees.reward[rows, start])
        trees = mcts.backup(spec, trees, start, v, r, store_leaf=sel.is_new)
        if spec.use_gumbel:
            trees = gz.sequential_halving_tick(spec, trees)
    if spec.use_gumbel:
        nsel = gz.gumbel_select_leaf(spec, trees)
    else:
        nsel = mcts.select_leaf(spec, trees)
    return trees, nsel


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_ARGTYPES = [_I] * 12 + [_F] * 6 + [_P] * 35  # see tree_step_launch


def _library():
    lib = _build.load("tree_step")
    fn = lib.tree_step_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _check(name: str, x: torch.Tensor, dtype: torch.dtype, shape, device) -> None:
    if x.device != device:
        raise ValueError(f"fused_tree_step: {name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"fused_tree_step: {name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"fused_tree_step: {name} has shape {tuple(x.shape)}, expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"fused_tree_step: {name} is not contiguous")


def uses_reward_regime(spec: SearchSpec, leaf_reward: Optional[torch.Tensor]) -> bool:
    """Whether a step runs the MuZero reward regime rather than the board
    regime: leaf rewards or a discount other than 1 (the JAX kernel's
    ``use_rewards or discount != 1``), which back up serially through the
    nodes' rewards and take ``q = reward + discount * mean``. The kernel is
    handed this flag, so the launch counters and the backup it runs agree.
    Value rescale is an option of either regime."""
    return leaf_reward is not None or spec.discount != 1.0


def fused_tree_step(
    spec: SearchSpec,
    trees: Tree,
    sel: NextSelection,
    leaf_policy, leaf_logit, leaf_legal, leaf_terminal, leaf_value, leaf_turn,
    node_idx: int, phase: int,
    leaf_reward: Optional[torch.Tensor] = None,
) -> Tuple[Tree, NextSelection]:
    """Run one simulation's tree transition on a batch of trees; returns
    ``(trees, next_selection)``.

    On CUDA tensors the CUDA kernel updates ``trees`` in place (the JAX
    kernel aliased its tree inputs to its outputs) and the returned tree is
    the same object; on CPU tensors this is ``tree_step_reference``.
    ``fused_tree_step.launches`` counts the kernel's launches in the board
    regime, ``fused_tree_step.launches_rewards`` those in the reward regime
    (``uses_reward_regime``)."""
    if not supports_fused_tree_step(spec):
        raise NotImplementedError("fused_tree_step: think_batch > 1 is not ported (ROADMAP.md)")
    device = trees.visits.device
    if device.type == "cpu":
        return tree_step_reference(
            spec, trees, sel, leaf_policy, leaf_logit, leaf_legal, leaf_terminal,
            leaf_value, leaf_turn, node_idx, phase, leaf_reward=leaf_reward)
    if device.type != "cuda":
        raise ValueError(f"fused_tree_step: unsupported device {device}")

    b, n = trees.visits.shape
    a = spec.action_size
    if n != spec.max_nodes:
        raise ValueError(f"fused_tree_step: trees hold {n} nodes, spec says {spec.max_nodes}")
    if not 0 <= int(node_idx) < n:
        raise ValueError(f"fused_tree_step: node_idx {node_idx} outside [0, {n})")
    f32, i32, u8 = torch.float32, torch.int32, torch.bool
    inputs = [
        ("visits", trees.visits, f32, (b, n)), ("mean", trees.mean, f32, (b, n)),
        ("value", trees.value, f32, (b, n)), ("reward", trees.reward, f32, (b, n)),
        ("expanded", trees.expanded, u8, (b, n)),
        ("terminal", trees.terminal, u8, (b, n)), ("parent", trees.parent, i32, (b, n)),
        ("action_from_parent", trees.action_from_parent, i32, (b, n)),
        ("to_play", trees.to_play, i32, (b, n)),
        ("children_index", trees.children_index, i32, (b, n, a)),
        ("prior", trees.prior, f32, (b, n, a)), ("logit", trees.logit, f32, (b, n, a)),
        ("legal", trees.legal, u8, (b, n, a)),
        ("gumbel_active", trees.gumbel_active, u8, (b, a)),
        ("gumbel_sample_size", trees.gumbel_sample_size, i32, (b,)),
        ("gumbel_budget", trees.gumbel_budget, f32, (b,)),
        ("num_nodes", trees.num_nodes, i32, (b,)),
        ("sel.parent", sel.parent, i32, (b,)), ("sel.action", sel.action, i32, (b,)),
        ("sel.leaf", sel.leaf, i32, (b,)), ("sel.is_new", sel.is_new, u8, (b,)),
        ("sel.path", sel.path, u8, (b, n)),
        ("leaf_policy", leaf_policy, f32, (b, a)), ("leaf_logit", leaf_logit, f32, (b, a)),
        ("leaf_legal", leaf_legal, u8, (b, a)), ("leaf_terminal", leaf_terminal, u8, (b,)),
        ("leaf_value", leaf_value, f32, (b,)), ("leaf_turn", leaf_turn, i32, (b,)),
    ]
    for name, x, dtype, shape in inputs:
        _check(name, x, dtype, shape, device)
    if leaf_reward is not None:
        _check("leaf_reward", leaf_reward, f32, (b,), device)
    nsel = NextSelection(
        parent=torch.empty((b,), dtype=i32, device=device),
        action=torch.empty((b,), dtype=i32, device=device),
        leaf=torch.empty((b,), dtype=i32, device=device),
        is_new=torch.empty((b,), dtype=u8, device=device),
        path=torch.empty((b, n), dtype=u8, device=device),
    )
    outputs = [nsel.parent, nsel.action, nsel.leaf, nsel.is_new, nsel.path]
    launch = _library()
    reward_regime = uses_reward_regime(spec, leaf_reward)
    m0 = spec.gumbel_sample_size
    rc = launch(
        b, n, a, int(node_idx), int(phase),
        int(spec.use_gumbel), int(spec.flip_player2_value), int(spec.init_q_average),
        int(spec.num_simulations), int(leaf_reward is not None), int(reward_regime),
        int(spec.value_rescale),
        spec.puct_base, spec.puct_init, math.log2(m0) if m0 > 0 else 0.0,
        spec.gumbel_sigma_visit_c, spec.gumbel_sigma_scale_c, spec.discount,
        *[x.data_ptr() for _, x, _, _ in inputs],
        leaf_reward.data_ptr() if leaf_reward is not None else None,
        *[x.data_ptr() for x in outputs],
        torch.cuda.current_stream(device).cuda_stream,
    )
    if rc == _build.SHAPE_TOO_LARGE:
        raise ValueError(
            f"fused_tree_step: one game of {n} nodes x {a} actions needs more shared memory "
            f"than a block may hold on this card (csrc/tree_step.cu, dynamic_smem)")
    if rc != 0:
        raise RuntimeError(f"fused_tree_step: CUDA kernel launch failed (cudaError {rc})")
    if reward_regime:
        fused_tree_step.launches_rewards += 1
    else:
        fused_tree_step.launches += 1
    return trees, nsel


fused_tree_step.launches = 0
fused_tree_step.launches_rewards = 0

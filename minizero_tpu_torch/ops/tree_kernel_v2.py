"""Large-N fused MCTS tree step on node-indexed packed trees (port of
``minizero_tpu/ops/tree_kernel_v2.py``).

One simulation's tree transition for a batch of plain AlphaZero PUCT trees
(no Gumbel, discount 1, no in-tree rewards, no value rescale; reference
``actor/mcts.cpp:139-217``):

    expand the new leaf at row s -> write its parent edge -> back up the
    leaf value along the selected path -> PUCT walk to the next leaf

The trees are packed per node (``PackedTrees``):

- ``prior`` f32[B, cap, L] and ``cix`` i32[B, cap, L], ``L = A + 8``. The
  action lanes of ``cix`` hold -2 (illegal), -1 (legal, no child yet), the
  child node (>= 0) or ``-3 - node`` for a terminal child; the spare lanes
  hold the node's parent, action from parent, player to move, expanded and
  terminal flags (lanes A .. A+4);
- per-node vectors ``visits``, ``mean``, ``value`` (the stored leaf value),
  ``pedge`` (the prior of the edge into the node), ``pvec`` (parent, -1 for
  the root and unused rows), ``avec`` (action from parent) and ``pterm``
  (terminal flag), each [B, cap].

The engine grows the capacity in stages (65 -> 129 -> ... -> N) so that
early simulations touch only rows that can exist (``grow``).

``fused_tree_step_v2`` launches the hand-written CUDA kernel
``csrc/tree_step_v2.cu`` on CUDA tensors and calls
``tree_step_v2_reference``, the plain PyTorch version of the same contract,
on CPU tensors. PUCT ties go to the larger prior (``pedge`` for a child
node, the row's prior otherwise), then to the lower action index; the sum
of the children's Q at a node is taken in float64 and rounded once, on both
sides, so that it does not depend on the order of summation.
"""

from __future__ import annotations

import ctypes
import dataclasses
from dataclasses import dataclass
from typing import Tuple

import torch

from minizero_tpu_torch.ops import _build
from minizero_tpu_torch.search.mcts import SearchSpec, Tree

SPARE = 8  # spare lanes for the packed node scalars


@dataclass
class PackedTrees:
    """Node-indexed tree arrays for a batch of games (capacity ``cap``)."""

    prior: torch.Tensor  # f32[B, cap, L]
    cix: torch.Tensor  # i32[B, cap, L]: child encodings; node scalars at A..
    visits: torch.Tensor  # f32[B, cap]
    mean: torch.Tensor  # f32[B, cap]
    value: torch.Tensor  # f32[B, cap]: stored network value per node
    pedge: torch.Tensor  # f32[B, cap]: prior of the edge into the node
    pvec: torch.Tensor  # i32[B, cap]: parent node (-1 for root/unused rows)
    avec: torch.Tensor  # i32[B, cap]: action from parent
    pterm: torch.Tensor  # i32[B, cap]: terminal flag

    def clone(self) -> "PackedTrees":
        return PackedTrees(**{f.name: getattr(self, f.name).clone()
                              for f in dataclasses.fields(self)})


@dataclass
class V2Selection:
    """Next-simulation selection; ``prior`` is the chosen edge's prior,
    recorded into ``pedge`` when the edge's node is expanded."""

    parent: torch.Tensor  # i32[B]
    action: torch.Tensor  # i32[B]
    leaf: torch.Tensor  # i32[B] (-1 for new edges)
    is_new: torch.Tensor  # bool[B]
    path: torch.Tensor  # bool[B, cap]
    prior: torch.Tensor  # f32[B]

    def clone(self) -> "V2Selection":
        return V2Selection(**{f.name: getattr(self, f.name).clone()
                              for f in dataclasses.fields(self)})


def supports_fused_tree_step_v2(spec: SearchSpec) -> bool:
    return (spec.think_batch == 1 and not spec.value_rescale
            and float(spec.discount) == 1.0 and not spec.use_gumbel)


def lane_width(spec: SearchSpec) -> int:
    return spec.action_size + SPARE


def empty_selection_v2(spec: SearchSpec, batch: int, cap: int, device) -> V2Selection:
    i32 = torch.int32
    return V2Selection(
        parent=torch.zeros((batch,), dtype=i32, device=device),
        action=torch.zeros((batch,), dtype=i32, device=device),
        leaf=torch.full((batch,), -1, dtype=i32, device=device),
        is_new=torch.zeros((batch,), dtype=torch.bool, device=device),
        path=torch.zeros((batch, cap), dtype=torch.bool, device=device),
        prior=torch.zeros((batch,), dtype=torch.float32, device=device),
    )


# ---------------------------------------------------------------------------
# pack / unpack <-> mcts.Tree
# ---------------------------------------------------------------------------

def pack_trees(spec: SearchSpec, trees: Tree, cap: int) -> PackedTrees:
    """Pack a freshly rooted tree batch (only node 0 expanded, its prior
    already noised): no child edge or terminal-child encoding exists yet."""
    a, l = spec.action_size, lane_width(spec)
    b = trees.visits.shape[0]
    dev = trees.visits.device
    prior = torch.zeros((b, cap, l), dtype=torch.float32, device=dev)
    prior[:, 0, :a] = trees.prior[:, 0]
    cix = torch.full((b, cap, l), -2, dtype=torch.int32, device=dev)
    cix[:, 0, :a] = torch.where(trees.legal[:, 0], -1, -2).to(torch.int32)
    for j, v in enumerate((trees.parent[:, 0], trees.action_from_parent[:, 0],
                           trees.to_play[:, 0], trees.expanded[:, 0], trees.terminal[:, 0])):
        cix[:, 0, a + j] = v.to(torch.int32)

    def node0(x):
        out = torch.zeros((b, cap), dtype=torch.float32, device=dev)
        out[:, 0] = x[:, 0]
        return out

    pterm = torch.zeros((b, cap), dtype=torch.int32, device=dev)
    pterm[:, 0] = trees.terminal[:, 0].to(torch.int32)
    return PackedTrees(
        prior=prior, cix=cix,
        visits=node0(trees.visits), mean=node0(trees.mean), value=node0(trees.value),
        pedge=torch.zeros((b, cap), dtype=torch.float32, device=dev),
        pvec=torch.full((b, cap), -1, dtype=torch.int32, device=dev),
        avec=torch.full((b, cap), -1, dtype=torch.int32, device=dev),
        pterm=pterm,
    )


def _pad_nodes(x: torch.Tensor, extra: int, fill) -> torch.Tensor:
    if extra == 0:
        return x
    shape = (x.shape[0], extra) + tuple(x.shape[2:])
    return torch.cat([x, torch.full(shape, fill, dtype=x.dtype, device=x.device)], dim=1)


def grow(packed: PackedTrees, cap: int) -> PackedTrees:
    """Extend the node capacity (stage boundary); new rows read as
    unmaterialised (cix -2, parent -1)."""
    extra = cap - packed.visits.shape[1]
    fills = {"cix": -2, "pvec": -1, "avec": -1}
    return PackedTrees(**{f.name: _pad_nodes(getattr(packed, f.name), extra, fills.get(f.name, 0))
                          for f in dataclasses.fields(packed)})


def unpack_trees(spec: SearchSpec, packed: PackedTrees, trees: Tree) -> Tree:
    """Write the packed statistics back into ``trees`` (``[B, N, ...]``);
    logit, noise, reward, num_nodes and the Gumbel fields keep their content
    from before the loop."""
    a, n = spec.action_size, spec.max_nodes
    extra = n - packed.visits.shape[1]
    cx = packed.cix[:, :, :a]
    ci = torch.where(cx >= 0, cx, torch.where(cx <= -3, -cx - 3, -1))

    def padn(x, fill=0):
        return _pad_nodes(x, extra, fill)

    return trees.replace(
        visits=padn(packed.visits), mean=padn(packed.mean), value=padn(packed.value),
        prior=padn(packed.prior[:, :, :a]),
        legal=padn(cx != -2, False),
        children_index=padn(ci, -1),
        parent=padn(packed.cix[:, :, a].clamp(min=-1), -1),
        action_from_parent=padn(packed.cix[:, :, a + 1].clamp(min=-1), -1),
        to_play=padn(packed.cix[:, :, a + 2].clamp(min=0)),
        expanded=padn(packed.cix[:, :, a + 3] > 0, False),
        terminal=padn(packed.cix[:, :, a + 4] > 0, False),
    )


# ---------------------------------------------------------------------------
# the plain PyTorch version
# ---------------------------------------------------------------------------

def tree_step_v2_reference(
    spec: SearchSpec,
    packed: PackedTrees,
    sel: V2Selection,
    leaf_policy, leaf_legal, leaf_terminal, leaf_value, leaf_turn,
    node_idx: int, phase: int,
) -> Tuple[PackedTrees, V2Selection]:
    """Plain PyTorch version of the fused v2 step; leaves its inputs
    unchanged and returns ``(packed, next_selection)``. ``phase == 0``:
    selection only."""
    a = spec.action_size
    b, cap, _ = packed.prior.shape
    dev = packed.visits.device
    rows = torch.arange(b, device=dev)
    s = int(node_idx)
    p = packed.clone()
    if phase > 0:
        # ---- 1. expand at row s, and the parent's edge ------------------
        fresh = sel.is_new
        live = leaf_legal & ~leaf_terminal[:, None]
        prior_row = torch.zeros_like(p.prior[:, s])
        prior_row[:, :a] = torch.where(live, leaf_policy, 0.0)
        cix_row = torch.full_like(p.cix[:, s], -2)
        cix_row[:, :a] = torch.where(live, -1, -2).to(torch.int32)
        for j, v in enumerate((sel.parent, sel.action, leaf_turn, ~leaf_terminal, leaf_terminal)):
            cix_row[:, a + j] = v.to(torch.int32)
        p.prior[:, s] = torch.where(fresh[:, None], prior_row, p.prior[:, s])
        p.cix[:, s] = torch.where(fresh[:, None], cix_row, p.cix[:, s])
        p.pvec[:, s] = torch.where(fresh, sel.parent, p.pvec[:, s])
        p.avec[:, s] = torch.where(fresh, sel.action, p.avec[:, s])
        p.pterm[:, s] = torch.where(fresh, leaf_terminal.to(torch.int32), p.pterm[:, s])
        p.pedge[:, s] = torch.where(fresh, sel.prior, p.pedge[:, s])
        p.value[:, s] = torch.where(fresh, leaf_value, p.value[:, s])
        enc = torch.where(leaf_terminal, -3 - s, s).to(torch.int32)
        f = rows[fresh]
        p.cix[f, sel.parent[fresh].long(), sel.action[fresh].long()] = enc[fresh]
        # ---- 2. back up along the path plus the start node --------------
        start = torch.where(fresh, s, sel.leaf.long().clamp(min=0))
        val = torch.where(fresh, leaf_value, p.value[rows, start])
        path = sel.path.clone()
        path[rows, start] = True
        p.visits = p.visits + path.to(torch.float32)
        p.mean = p.mean + torch.where(
            path, (val[:, None] - p.mean) / torch.clamp(p.visits, min=1.0), 0.0)

    # ---- 3. PUCT walk from the root ---------------------------------------
    iota_a = torch.arange(a, device=dev)
    cur = torch.zeros((b,), dtype=torch.long, device=dev)
    curvis = p.visits[:, 0]
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    npath = torch.zeros((b, cap), dtype=torch.bool, device=dev)
    nsel = empty_selection_v2(spec, b, cap, dev)
    nsel.path = npath
    base = torch.full((b,), spec.puct_base, dtype=torch.float32, device=dev)
    for _ in range(cap):
        if bool(done.all()):
            break
        row = p.cix[rows, cur]  # [B, L]
        cx = row[:, :a]
        mat = (cx >= 0) | (cx <= -3)
        child = torch.where(cx >= 0, cx, -3 - cx).long().clamp(0, cap - 1)
        q = torch.gather(p.mean, 1, child)
        if spec.flip_player2_value:
            q = torch.where((row[:, a + 2] == 2)[:, None], -q, q)
        cvis = torch.gather(p.visits, 1, child)
        cped = torch.gather(p.pedge, 1, child)
        pr = p.prior[rows, cur][:, :a]
        sum_q = torch.where(mat, q, 0.0).double().sum(-1).float()
        nv = mat.sum(-1).to(torch.float32)
        if spec.init_q_average:
            init_q = torch.where(nv > 0, sum_q / torch.clamp(nv, min=1.0), torch.ones_like(sum_q))
        else:
            init_q = (sum_q - 1.0) / (nv + 1.0)
        total = curvis - 1.0
        bias = spec.puct_init + torch.log((1.0 + total + spec.puct_base) / base)
        sq = torch.sqrt(torch.clamp(total, min=0.0))
        sc_m = q + bias[:, None] * cped * sq[:, None] / (1.0 + cvis)
        sc_u = init_q[:, None] + bias[:, None] * pr * sq[:, None]
        cand = mat | (cx == -1)
        score = torch.where(mat, sc_m, torch.where(cx == -1, sc_u, -torch.inf))
        tb = torch.where(mat, cped, pr)
        best = score.amax(-1, keepdim=True)
        tie = cand & (score >= best)
        p_best = torch.where(tie, tb, -torch.inf).amax(-1)
        act = torch.where(tie & (tb >= p_best[:, None]), iota_a, a).amin(-1).clamp(max=a - 1)
        c = cx[rows, act]
        stop_new = c == -1
        stop_term = c <= -3
        stop = stop_new | stop_term
        walking = ~done
        npath[rows, cur] |= walking
        npath[rows, (-3 - c).long().clamp(0, cap - 1)] |= walking & stop_term
        end = walking & stop
        nsel.parent = torch.where(end, cur.to(torch.int32), nsel.parent)
        nsel.action = torch.where(end, act.to(torch.int32), nsel.action)
        nsel.leaf = torch.where(end, torch.where(stop_term, -3 - c, -1), nsel.leaf)
        nsel.is_new = torch.where(end, stop_new, nsel.is_new)
        nsel.prior = torch.where(end, p_best, nsel.prior)
        descend = walking & ~stop
        cur = torch.where(descend, c.long().clamp(min=0), cur)
        curvis = torch.where(descend, p.visits[rows, cur], curvis)
        done = done | stop
    return p, nsel


# ---------------------------------------------------------------------------
# the CUDA kernel's wrapper
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_ARGTYPES = [ctypes.c_int] * 8 + [ctypes.c_float] * 2 + [_P] * 27  # see tree_step_v2_launch


def _library():
    fn = _build.load("tree_step_v2").tree_step_v2_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _check(name: str, x: torch.Tensor, dtype: torch.dtype, shape, device) -> None:
    if x.device != device:
        raise ValueError(f"fused_tree_step_v2: {name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"fused_tree_step_v2: {name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"fused_tree_step_v2: {name} has shape {tuple(x.shape)}, "
                         f"expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"fused_tree_step_v2: {name} is not contiguous")


def fused_tree_step_v2(
    spec: SearchSpec,
    packed: PackedTrees,
    sel: V2Selection,
    leaf_policy, leaf_legal, leaf_terminal, leaf_value, leaf_turn,
    node_idx: int, phase: int,
) -> Tuple[PackedTrees, V2Selection]:
    """One simulation's tree transition on packed trees; returns
    ``(packed, next_selection)`` (``sel.path`` has the packed capacity;
    phase 0 = selection only).

    On CUDA tensors the CUDA kernel updates ``packed`` in place (the JAX
    kernel aliased its tree inputs to its outputs) and returns the same
    object; on CPU tensors this is ``tree_step_v2_reference``.
    ``fused_tree_step_v2.launches`` counts the kernel's launches."""
    if not supports_fused_tree_step_v2(spec):
        raise NotImplementedError(
            "fused_tree_step_v2: plain AlphaZero PUCT only (think_batch 1, no Gumbel, "
            "discount 1, no value rescale)")
    device = packed.visits.device
    if device.type == "cpu":
        return tree_step_v2_reference(spec, packed, sel, leaf_policy, leaf_legal,
                                      leaf_terminal, leaf_value, leaf_turn, node_idx, phase)
    if device.type != "cuda":
        raise ValueError(f"fused_tree_step_v2: unsupported device {device}")

    b, cap, l = packed.prior.shape
    a = spec.action_size
    if l != lane_width(spec):
        raise ValueError(f"fused_tree_step_v2: {l} lanes, spec says {lane_width(spec)}")
    if not 0 <= int(node_idx) < cap:
        raise ValueError(f"fused_tree_step_v2: node_idx {node_idx} outside [0, {cap})")
    f32, i32, u8 = torch.float32, torch.int32, torch.bool
    inputs = [
        ("prior", packed.prior, f32, (b, cap, l)), ("cix", packed.cix, i32, (b, cap, l)),
        ("visits", packed.visits, f32, (b, cap)), ("mean", packed.mean, f32, (b, cap)),
        ("value", packed.value, f32, (b, cap)), ("pedge", packed.pedge, f32, (b, cap)),
        ("pvec", packed.pvec, i32, (b, cap)), ("avec", packed.avec, i32, (b, cap)),
        ("pterm", packed.pterm, i32, (b, cap)),
        ("sel.parent", sel.parent, i32, (b,)), ("sel.action", sel.action, i32, (b,)),
        ("sel.leaf", sel.leaf, i32, (b,)), ("sel.is_new", sel.is_new, u8, (b,)),
        ("sel.path", sel.path, u8, (b, cap)), ("sel.prior", sel.prior, f32, (b,)),
        ("leaf_policy", leaf_policy, f32, (b, a)), ("leaf_legal", leaf_legal, u8, (b, a)),
        ("leaf_terminal", leaf_terminal, u8, (b,)), ("leaf_value", leaf_value, f32, (b,)),
        ("leaf_turn", leaf_turn, i32, (b,)),
    ]
    for name, x, dtype, shape in inputs:
        _check(name, x, dtype, shape, device)
    nsel = V2Selection(
        parent=torch.empty((b,), dtype=i32, device=device),
        action=torch.empty((b,), dtype=i32, device=device),
        leaf=torch.empty((b,), dtype=i32, device=device),
        is_new=torch.empty((b,), dtype=u8, device=device),
        path=torch.empty((b, cap), dtype=u8, device=device),
        prior=torch.empty((b,), dtype=f32, device=device),
    )
    outputs = [nsel.parent, nsel.action, nsel.leaf, nsel.is_new, nsel.path, nsel.prior]
    rc = _library()(
        b, cap, a, l, int(node_idx), int(phase),
        int(spec.flip_player2_value), int(spec.init_q_average),
        spec.puct_base, spec.puct_init,
        *[x.data_ptr() for _, x, _, _ in inputs],
        *[x.data_ptr() for x in outputs],
        torch.cuda.current_stream(device).cuda_stream,
    )
    if rc == _build.SHAPE_TOO_LARGE:
        raise ValueError(
            f"fused_tree_step_v2: capacity {cap} needs more shared memory a block than this "
            f"card holds (csrc/tree_step_v2.cu, dynamic_smem)")
    if rc != 0:
        raise RuntimeError(f"fused_tree_step_v2: CUDA kernel launch failed (cudaError {rc})")
    fused_tree_step_v2.launches += 1
    return packed, nsel


fused_tree_step_v2.launches = 0

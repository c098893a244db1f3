"""Batched array MCTS (port of ``minizero_tpu/search/mcts.py``).

The tree is a struct of arrays of fixed capacity ``N = num_simulations + 1``
nodes per game, for ``B`` games at once: per-node vectors ``[B, N]`` and dense
per-action child rows ``[B, N, A]`` (reference ``minizero/actor/mcts.{h,cpp}``,
``actor/tree.h``). Where the JAX package writes single-game functions and
``vmap``s them, these functions take the whole batch; node indices are
``[B]`` tensors.

Semantics preserved from the reference (file:line cited per function):
incremental-mean backup, PUCT with visited-children init-Q, min-max value
rescaling via tree value bounds, player value flipping, Dirichlet / Gumbel
root noise, softmax-count action sampling with value threshold.

Differences from the JAX module: node states (the JAX ``Tree.embedding``)
are kept by the self-play engine beside the tree, and the think-batch
virtual loss (``evloss``, ``nvloss``) exists only on trees of a spec with
``think_batch > 1`` (``None`` otherwise). The PUCT walk has
the contract of the fused tree step (``ops/tree_kernel.py``): it starts at an
expanded node, and a walk that ends on an unexpanded (terminal) child
reports that child as the leaf and its parent edge as (parent, action).
Sums of Q over a node's children are taken in float64 and rounded once, so
their value does not depend on the order of summation (the CUDA kernel does
the same).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Callable, Optional

import torch

NO_NODE = -1
NEG_INF = -3.4e38


@dataclass(frozen=True)
class SearchSpec:
    """Static search hyperparameters (reference
    ``config/configuration.cpp:13-34``)."""

    action_size: int
    num_simulations: int
    puct_base: float = 19652.0
    puct_init: float = 1.25
    discount: float = 1.0
    value_rescale: bool = False
    init_q_average: bool = False  # reference mcts.cpp:211-216 (#if ATARI)
    flip_player2_value: bool = True  # actor_mcts_value_flipping_player == 'W'
    # noise
    use_dirichlet_noise: bool = True
    dirichlet_alpha: float = 0.03
    dirichlet_epsilon: float = 0.25
    use_gumbel_noise: bool = False
    # gumbel zero
    use_gumbel: bool = False
    gumbel_sample_size: int = 16
    gumbel_sigma_visit_c: float = 50.0
    gumbel_sigma_scale_c: float = 1.0
    # action selection
    select_by_count: bool = False
    softmax_value_threshold: float = 0.1
    # intra-tree leaf batching with virtual loss (console/eval only)
    think_batch: int = 1

    @property
    def max_nodes(self) -> int:
        # root + one node per simulation (with leaf batching, one slot per
        # selection: rounds * think_batch)
        k = max(1, self.think_batch)
        rounds = -(-self.num_simulations // k)
        return rounds * k + 1


@dataclass
class Tree:
    """Search trees of ``B`` games, capacity ``N`` nodes, ``A`` actions."""

    # per-node stats (reference MCTSNode fields, mcts.h)
    visits: torch.Tensor  # f32[B, N] count_
    mean: torch.Tensor  # f32[B, N] mean_ (player-1 perspective)
    value: torch.Tensor  # f32[B, N] raw network value_
    reward: torch.Tensor  # f32[B, N] reward_
    terminal: torch.Tensor  # bool[B, N]
    expanded: torch.Tensor  # bool[B, N]
    parent: torch.Tensor  # i32[B, N]
    action_from_parent: torch.Tensor  # i32[B, N]
    to_play: torch.Tensor  # i32[B, N] player to move at node (1-based)
    # per-node per-action child data (dense rows)
    children_index: torch.Tensor  # i32[B, N, A] (-1 = not materialised)
    prior: torch.Tensor  # f32[B, N, A] policy_ (with dirichlet noise mixed at root)
    logit: torch.Tensor  # f32[B, N, A] policy_logit_ (with gumbel noise at root)
    noise: torch.Tensor  # f32[B, N, A] policy_noise_
    legal: torch.Tensor  # bool[B, N, A]
    num_nodes: torch.Tensor  # i32[B] next free node slot
    # gumbel sequential-halving state (reference gumbel_zero.h:10-22)
    gumbel_active: torch.Tensor  # bool[B, A]: root actions still candidates
    gumbel_sample_size: torch.Tensor  # i32[B]
    gumbel_budget: torch.Tensor  # f32[B]: per-candidate visit budget this phase
    # virtual loss of a think-batch round (reference mcts.h:33-47), only
    # when ``think_batch > 1``: evloss[b, n, a] in-flight selections through
    # edge (n, a), nvloss[b, n] through node n; zero outside a round
    evloss: Optional[torch.Tensor] = None  # f32[B, N, A]
    nvloss: Optional[torch.Tensor] = None  # f32[B, N]

    def replace(self, **kw) -> "Tree":
        return dataclasses.replace(self, **kw)

    def clone(self) -> "Tree":
        return Tree(**{f.name: _clone(getattr(self, f.name))
                       for f in dataclasses.fields(self)})


@dataclass
class Selection:
    """A batch of selected edges and their root-to-leaf path masks."""

    parent: torch.Tensor  # i32[B]: node whose child edge was selected
    action: torch.Tensor  # i32[B]: selected action at parent
    leaf: torch.Tensor  # i32[B]: existing leaf node revisited (-1 if new edge)
    is_new: torch.Tensor  # bool[B]: True -> create a node for (parent, action)
    path: torch.Tensor  # bool[B, N]: root..parent (+ leaf)
    # think_batch > 1 only: this new edge was already selected in the round
    # (reference zero_actor.cpp:141-144); None otherwise
    dup: Optional[torch.Tensor] = None  # bool[B]

    def clone(self) -> "Selection":
        return Selection(**{f.name: _clone(getattr(self, f.name))
                            for f in dataclasses.fields(self)})


def _clone(x: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if x is None else x.clone()


def _rows(b: int, device) -> torch.Tensor:
    return torch.arange(b, device=device)


def _take(x: torch.Tensor, node: torch.Tensor) -> torch.Tensor:
    """``x[b, node[b]]`` for ``x`` [B, N, ...] and ``node`` [B]."""
    return x[_rows(x.shape[0], x.device), node.long()]


def _take_nodes(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``values[b, idx[b, a]]`` for per-node ``values`` [B, N] and ``idx``
    [B, A] (indices clamped at 0)."""
    return torch.gather(values, 1, idx.long().clamp(min=0))


def init_tree(spec: SearchSpec, root_to_play: torch.Tensor) -> Tree:
    """Fresh trees; node 0 reserved for the root (reference Tree::reset,
    tree.h:55-77). ``root_to_play`` i32[B] sets the batch and device."""
    b = root_to_play.shape[0]
    n, a = spec.max_nodes, spec.action_size
    dev = root_to_play.device
    f32, i32 = torch.float32, torch.int32
    to_play = torch.zeros((b, n), dtype=i32, device=dev)
    to_play[:, 0] = root_to_play.to(i32)
    vloss = spec.think_batch > 1
    return Tree(
        visits=torch.zeros((b, n), dtype=f32, device=dev),
        mean=torch.zeros((b, n), dtype=f32, device=dev),
        value=torch.zeros((b, n), dtype=f32, device=dev),
        reward=torch.zeros((b, n), dtype=f32, device=dev),
        terminal=torch.zeros((b, n), dtype=torch.bool, device=dev),
        expanded=torch.zeros((b, n), dtype=torch.bool, device=dev),
        parent=torch.full((b, n), NO_NODE, dtype=i32, device=dev),
        action_from_parent=torch.full((b, n), NO_NODE, dtype=i32, device=dev),
        to_play=to_play,
        children_index=torch.full((b, n, a), NO_NODE, dtype=i32, device=dev),
        prior=torch.zeros((b, n, a), dtype=f32, device=dev),
        logit=torch.zeros((b, n, a), dtype=f32, device=dev),
        noise=torch.zeros((b, n, a), dtype=f32, device=dev),
        legal=torch.zeros((b, n, a), dtype=torch.bool, device=dev),
        num_nodes=torch.ones((b,), dtype=i32, device=dev),
        gumbel_active=torch.zeros((b, a), dtype=torch.bool, device=dev),
        gumbel_sample_size=torch.zeros((b,), dtype=i32, device=dev),
        gumbel_budget=torch.zeros((b,), dtype=f32, device=dev),
        evloss=torch.zeros((b, n, a), dtype=f32, device=dev) if vloss else None,
        nvloss=torch.zeros((b, n), dtype=f32, device=dev) if vloss else None,
    )


# --------------------------------------------------------------------------
# value normalisation (reference MCTSNode::getNormalizedMean, mcts.cpp:40-53)
# --------------------------------------------------------------------------

def _node_q(spec: SearchSpec, tree: Tree) -> torch.Tensor:
    """Per-node raw q = reward + discount * mean, [B, N]."""
    if spec.discount == 1.0:
        return tree.reward + tree.mean
    return tree.reward + spec.discount * tree.mean


def _tree_value_bounds(spec: SearchSpec, tree: Tree):
    """(lower, upper, enough), each [B], over all visited nodes' q
    (reference mcts.cpp:219-228; ``enough`` is False with fewer than 2
    visited nodes, where the reference returns 1.0, mcts.cpp:44)."""
    q = _node_q(spec, tree)
    visited = tree.visits > 0
    lo = torch.where(visited, q, 3.4e38).amin(-1)
    hi = torch.where(visited, q, NEG_INF).amax(-1)
    enough = visited.sum(-1) >= 2
    return lo, hi, enough


def _normalize_q(spec: SearchSpec, q: torch.Tensor, edge_player: torch.Tensor,
                 bounds) -> torch.Tensor:
    """Value rescaling + player flip of raw q values (reference
    mcts.cpp:40-53, without virtual loss). ``q`` [B, ...]; ``edge_player``
    and the bounds broadcast against it."""
    if spec.value_rescale:
        lo, hi, enough = bounds
        scaled = (q - lo) / torch.clamp(hi - lo, min=1e-8)
        scaled = torch.clamp(2.0 * scaled - 1.0, -1.0, 1.0)
        q = torch.where(enough, scaled, torch.ones_like(scaled))
    if spec.flip_player2_value:
        q = torch.where(edge_player == 2, -q, q)
    return q


def _bounds_for(spec: SearchSpec, tree: Tree, dims: int):
    """Tree bounds shaped to broadcast against a [B, ...] tensor of rank
    ``dims`` (None when the spec does not rescale)."""
    if not spec.value_rescale:
        return None
    shape = (-1,) + (1,) * (dims - 1)
    return tuple(x.reshape(shape) for x in _tree_value_bounds(spec, tree))


def node_normalized_mean(spec: SearchSpec, tree: Tree, node: torch.Tensor) -> torch.Tensor:
    """Normalized mean of ``node`` [B] (its edge player = to_play of its
    parent; for the root, the previous player of the root's to_play)."""
    q = _take(_node_q(spec, tree), node)
    parent = _take(tree.parent, node)
    edge_player = torch.where(parent >= 0, _take(tree.to_play, parent.clamp(min=0)),
                              3 - tree.to_play[:, 0])
    return _normalize_q(spec, q, edge_player, _bounds_for(spec, tree, 1))


# --------------------------------------------------------------------------
# selection (reference MCTS::selectChildByPUCTScore, mcts.cpp:181-198)
# --------------------------------------------------------------------------

def _children_stats(spec: SearchSpec, tree: Tree, node: torch.Tensor):
    """Child (index, has_child, visits, q_norm) rows [B, A] of ``node`` [B].
    Children's edge player is ``to_play[node]``."""
    cidx = _take(tree.children_index, node)
    has_child = cidx >= 0
    c_visits = torch.where(has_child, _take_nodes(tree.visits, cidx), 0.0)
    c_q_raw = torch.where(has_child, _take_nodes(_node_q(spec, tree), cidx), 0.0)
    edge_player = _take(tree.to_play, node)[:, None]
    q_norm = _normalize_q(spec, c_q_raw, edge_player, _bounds_for(spec, tree, 2))
    q_norm = torch.where(has_child & (c_visits > 0), q_norm, 0.0)
    if tree.evloss is not None:
        # virtual-loss dilution (reference mcts.cpp:51): each in-flight
        # selection counts as a -1 outcome for the edge player; an edge
        # with only virtual visits scores -1
        ev = _take(tree.evloss, node)
        cv = c_visits + ev
        q_norm = torch.where(cv > 0, (q_norm * c_visits - ev) / torch.clamp(cv, min=1e-8), 0.0)
        c_visits = cv
    return cidx, has_child, c_visits, q_norm


def _puct_scores(spec: SearchSpec, tree: Tree, node: torch.Tensor) -> torch.Tensor:
    """[B, A] PUCT scores of ``node``'s children; illegal actions -> -inf.
    With virtual loss, a child with only virtual visits counts as visited
    (reference calculateInitQValue, mcts.cpp:206).

    Divisors are tensors, never Python numbers: PyTorch's CUDA division by
    a Python number multiplies by its reciprocal, which rounds differently
    from the IEEE division that the CUDA kernel and the JAX package do."""
    _, _, c_visits, q_norm = _children_stats(spec, tree, node)
    visited = c_visits > 0
    # init Q for unvisited children (reference mcts.cpp:200-217)
    sum_q = torch.where(visited, q_norm, 0.0).double().sum(-1).float()
    num_visited = visited.sum(-1).to(torch.float32)
    if spec.init_q_average:
        init_q = torch.where(num_visited > 0, sum_q / torch.clamp(num_visited, min=1.0),
                             torch.ones_like(sum_q))
    else:
        init_q = (sum_q - 1.0) / (num_visited + 1.0)
    total_sim = _take(tree.visits, node) - 1.0
    if tree.nvloss is not None:
        # reference selectChildByPUCTScore: getCountWithVirtualLoss() - 1
        total_sim = total_sim + _take(tree.nvloss, node)
    base = torch.full_like(total_sim, spec.puct_base)
    puct_bias = spec.puct_init + torch.log((1.0 + total_sim + spec.puct_base) / base)
    prior = _take(tree.prior, node)
    u = (puct_bias[:, None] * prior * torch.sqrt(torch.clamp(total_sim, min=0.0))[:, None]
         / (1.0 + c_visits))
    score = u + torch.where(visited, q_norm, init_q[:, None])
    return torch.where(_take(tree.legal, node), score, NEG_INF)


def _argmax_with_prior_tiebreak(scores: torch.Tensor, prior: torch.Tensor) -> torch.Tensor:
    """Row-wise argmax of ``scores`` [B, A]; ties go to the larger prior,
    then the lower index (reference mcts.cpp:188-195). Returns i32[B]."""
    best = scores.amax(-1, keepdim=True)
    tiebreak = torch.where(scores >= best, prior, NEG_INF)
    best_tb = tiebreak.amax(-1, keepdim=True)
    a = scores.shape[-1]
    iota = torch.arange(a, device=scores.device).expand_as(scores)
    return torch.where(tiebreak >= best_tb, iota, a).amin(-1).to(torch.int32)


def _walk(spec: SearchSpec, tree: Tree, node: torch.Tensor, done: torch.Tensor,
          sel: Selection) -> Selection:
    """PUCT descent from ``node`` [B] for the games not ``done``, until an
    unmaterialised child edge or an unexpanded (terminal) child (reference
    MCTS::selectFromNode, mcts.cpp:139-149). Fills ``sel`` in place."""
    b = node.shape[0]
    rows = _rows(b, node.device)
    node = node.long()
    done = done.clone()
    for _ in range(spec.max_nodes):
        if bool(done.all()):
            break
        scores = _puct_scores(spec, tree, node)
        action = _argmax_with_prior_tiebreak(scores, _take(tree.prior, node))
        child = tree.children_index[rows, node, action.long()].long()
        child_exp = (child >= 0) & _take(tree.expanded, child.clamp(min=0))
        stop_new = child < 0
        stop_leaf = (child >= 0) & ~child_exp
        stop = stop_new | stop_leaf
        walking = ~done
        sel.path[rows, node] |= walking
        sel.path[rows, child.clamp(min=0)] |= walking & stop_leaf
        end = walking & stop
        sel.parent = torch.where(end, node.to(torch.int32), sel.parent)
        sel.action = torch.where(end, action, sel.action)
        sel.leaf = torch.where(end, torch.where(stop_leaf, child, NO_NODE).to(torch.int32), sel.leaf)
        sel.is_new = torch.where(end, stop_new, sel.is_new)
        node = torch.where(walking & ~stop, child, node)
        done = done | stop
    return sel


def empty_selection(spec: SearchSpec, batch: int, device) -> Selection:
    i32 = torch.int32
    return Selection(
        parent=torch.zeros((batch,), dtype=i32, device=device),
        action=torch.zeros((batch,), dtype=i32, device=device),
        leaf=torch.full((batch,), NO_NODE, dtype=i32, device=device),
        is_new=torch.zeros((batch,), dtype=torch.bool, device=device),
        path=torch.zeros((batch, spec.max_nodes), dtype=torch.bool, device=device),
    )


def mark_duplicates(tree: Tree, sel: Selection) -> Selection:
    """Set ``sel.dup`` on trees with virtual loss: the selected edge
    already carries a selection of this round."""
    if tree.evloss is not None:
        rows = _rows(sel.parent.shape[0], sel.parent.device)
        sel.dup = tree.evloss[rows, sel.parent.long(), sel.action.long()] > 0
    return sel


def select_leaf(spec: SearchSpec, tree: Tree) -> Selection:
    """PUCT walk from the root (which the engine always expands) with its
    path mask."""
    b = tree.visits.shape[0]
    dev = tree.visits.device
    root = torch.zeros((b,), dtype=torch.long, device=dev)
    sel = empty_selection(spec, b, dev)
    sel = _walk(spec, tree, root, torch.zeros((b,), dtype=torch.bool, device=dev), sel)
    return mark_duplicates(tree, sel)


def add_path_vloss(tree: Tree, sel: Selection, enabled: bool = True) -> None:
    """+1 virtual loss, in place, on the selected edge and on every node
    and edge from its parent up to the root (reference ZeroActor::step adds
    it to the whole node path, zero_actor.cpp:145). ``enabled`` False (the
    short last round's surplus selections) adds nothing."""
    if not enabled:
        return
    b = sel.parent.shape[0]
    rows = _rows(b, sel.parent.device)
    node = sel.parent.long()
    tree.evloss[rows, node, sel.action.long()] += 1.0
    live = node >= 0
    while bool(live.any()):
        safe = node.clamp(min=0)
        tree.nvloss[rows[live], safe[live]] += 1.0
        parent = tree.parent[rows, safe].long()
        up = live & (parent >= 0)
        tree.evloss[rows[up], parent[up], tree.action_from_parent[rows, safe][up].long()] += 1.0
        node = torch.where(live, parent, node)
        live = up


def think_batch_backup(spec: SearchSpec, tree: Tree, sel: Selection, enabled: bool, slot: int,
                       policy: torch.Tensor, policy_logit: torch.Tensor, legal: torch.Tensor,
                       terminal: torch.Tensor, to_play: torch.Tensor, value: torch.Tensor,
                       reward: torch.Tensor) -> Tree:
    """Complete one selection of a think-batch round from its leaf's
    evaluation (the JAX engine's ``think_batch_round``, engine.py:508-534).
    The first selection of a new edge in the round creates node ``slot``
    and backs up the leaf's value; a duplicate of it reaches the node that
    selection created, and a revisit its existing leaf, and both back up
    the value stored there. ``enabled`` False (the short last round's
    surplus) changes nothing. Returns a new Tree."""
    b = tree.visits.shape[0]
    rows = _rows(b, tree.visits.device)
    fresh = sel.is_new & ~sel.dup
    en = torch.full_like(fresh, bool(enabled))
    tree = expand_node(spec, tree, slot, sel.parent, sel.action, to_play, policy, policy_logit,
                       legal, terminal, enabled=fresh & en)
    known = torch.where(sel.is_new, tree.children_index[rows, sel.parent.long(), sel.action.long()],
                        sel.leaf)
    start = torch.where(fresh, int(slot), known.long().clamp(min=0))
    val = torch.where(fresh, value, tree.value[rows, start])
    rew = torch.where(fresh, reward, tree.reward[rows, start])
    return backup(spec, tree, start, val, rew, store_leaf=fresh, enabled=en)


def clear_vloss(tree: Tree) -> None:
    """End of a round: every selection's virtual loss is added and removed
    within one round (reference zero_actor.cpp:152-156), so the net effect
    is zeroing, in place."""
    tree.evloss.zero_()
    tree.nvloss.zero_()


# --------------------------------------------------------------------------
# expansion + backup (reference MCTS::expand / MCTS::backup, mcts.cpp:151-179)
# --------------------------------------------------------------------------

def _as_nodes(x, b: int, device) -> torch.Tensor:
    """A node index given as an int or as [B] -> long[B]."""
    if isinstance(x, torch.Tensor):
        return x.long()
    return torch.full((b,), int(x), dtype=torch.long, device=device)


def expand_node(
    spec: SearchSpec,
    tree: Tree,
    node_idx,  # int or [B]
    parent: torch.Tensor,  # [B] (-1: no parent edge)
    action: torch.Tensor,  # [B]
    to_play: torch.Tensor,  # [B]
    policy: torch.Tensor,  # f32[B, A] network policy (softmax over ALL actions)
    policy_logit: torch.Tensor,  # f32[B, A]
    legal: torch.Tensor,  # bool[B, A]
    terminal: torch.Tensor,  # bool[B]: node is terminal -> not expanded
    enabled: Optional[torch.Tensor] = None,  # bool[B]
) -> Tree:
    """Materialise node ``node_idx`` with its child candidate rows (reference
    ``zero_actor.cpp:215-229``: priors keep the raw network softmax mass of
    each legal action, not renormalised). Games with ``enabled`` False are
    left untouched. Returns a new Tree; the input is not modified."""
    b, n = tree.visits.shape
    a = spec.action_size
    dev = tree.visits.device
    if enabled is None:
        enabled = torch.ones((b,), dtype=torch.bool, device=dev)
    node = _as_nodes(node_idx, b, dev)
    parent = parent.long()
    expanded = ~terminal
    iota_n = torch.arange(n, device=dev)
    node_m = (iota_n[None, :] == node[:, None]) & enabled[:, None]  # [B, N]
    parent_m = (iota_n[None, :] == parent[:, None]) & (parent >= 0)[:, None] & enabled[:, None]
    child_write = parent_m[:, :, None] & (torch.arange(a, device=dev)[None, None, :]
                                          == action.long()[:, None, None])
    live = legal & expanded[:, None]
    row_m = node_m[:, :, None]
    return tree.replace(
        terminal=torch.where(node_m, terminal[:, None], tree.terminal),
        expanded=torch.where(node_m, expanded[:, None], tree.expanded),
        parent=torch.where(node_m, parent.to(torch.int32)[:, None], tree.parent),
        action_from_parent=torch.where(node_m, action.to(torch.int32)[:, None],
                                       tree.action_from_parent),
        to_play=torch.where(node_m, to_play.to(torch.int32)[:, None], tree.to_play),
        children_index=torch.where(child_write, node.to(torch.int32)[:, None, None],
                                   tree.children_index),
        prior=torch.where(row_m, torch.where(live, policy, 0.0)[:, None, :], tree.prior),
        logit=torch.where(row_m, torch.where(live, policy_logit, 0.0)[:, None, :], tree.logit),
        legal=torch.where(row_m, live[:, None, :], tree.legal),
        num_nodes=torch.maximum(tree.num_nodes,
                                torch.where(enabled, node + 1, 0).to(torch.int32)),
    )


def backup(
    spec: SearchSpec,
    tree: Tree,
    leaf: torch.Tensor,  # [B]
    value: torch.Tensor,  # f32[B]
    reward: torch.Tensor,  # f32[B]
    store_leaf: Optional[torch.Tensor] = None,  # bool[B]
    enabled: Optional[torch.Tensor] = None,  # bool[B]
) -> Tree:
    """Propagate ``value`` from ``leaf`` to the root with incremental means
    and per-step reward discounting (reference MCTS::backup,
    mcts.cpp:166-179). ``store_leaf`` False (a revisit) keeps the stored
    value/reward at the leaf; ``enabled`` False makes it a no-op. Returns a
    new Tree."""
    b, n = tree.visits.shape
    dev = tree.visits.device
    if store_leaf is None:
        store_leaf = torch.ones((b,), dtype=torch.bool, device=dev)
    if enabled is None:
        enabled = torch.ones((b,), dtype=torch.bool, device=dev)
    leaf = leaf.long()
    iota = torch.arange(n, device=dev)
    leaf_m = (iota[None, :] == leaf[:, None]) & (store_leaf & enabled)[:, None]
    tree = tree.replace(value=torch.where(leaf_m, value[:, None], tree.value),
                        reward=torch.where(leaf_m, reward[:, None], tree.reward))
    visits, mean = tree.visits, tree.mean
    node = torch.where(enabled, leaf, NO_NODE)
    updated = value
    for _ in range(n):
        if not bool((node >= 0).any()):
            break
        m = (iota[None, :] == node[:, None]) & (node >= 0)[:, None]
        new_count = visits + m.to(torch.float32)
        mean = mean + torch.where(m, (updated[:, None] - mean) / torch.clamp(new_count, min=1.0), 0.0)
        visits = new_count
        node_c = node.clamp(min=0)
        r = _take(tree.reward, node_c)
        updated = r + updated if spec.discount == 1.0 else r + spec.discount * updated
        node = torch.where(node >= 0, _take(tree.parent, node_c).long(), node)
    return tree.replace(visits=visits, mean=mean)


# --------------------------------------------------------------------------
# root noise (reference ZeroActor::addNoiseToNodeChildren,
# zero_actor.cpp:194-213)
# --------------------------------------------------------------------------

def _sample_gamma(alpha: float, shape, generator, device) -> torch.Tensor:
    """Gamma(alpha, 1) draws from ``generator``: Marsaglia-Tsang for
    alpha + 1, boosted by U^(1/alpha) (alpha < 1 is the Dirichlet case)."""
    d = alpha + 1.0 - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    out = torch.zeros(shape, dtype=torch.float32, device=device)
    pending = torch.ones(shape, dtype=torch.bool, device=device)
    while bool(pending.any()):
        x = torch.randn(shape, generator=generator, device=device)
        u = torch.rand(shape, generator=generator, device=device)
        v = (1.0 + c * x) ** 3
        ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v + d * torch.log(v.clamp(min=1e-30)))
        take = pending & ok
        out = torch.where(take, d * v, out)
        pending = pending & ~ok
    u = torch.rand(shape, generator=generator, device=device)
    return out * u ** (1.0 / alpha)


def add_root_noise(spec: SearchSpec, tree: Tree, noise: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None) -> Tree:
    """Mix root exploration noise into the root row. ``noise`` f32[B, A]
    supplies the raw draws (Dirichlet: gamma samples, normalised here over
    the legal actions; Gumbel: standard Gumbel samples); otherwise they are
    drawn from ``generator``. Returns a new Tree."""
    legal = tree.legal[:, 0]
    b, a = legal.shape
    dev = legal.device
    if spec.use_dirichlet_noise:
        gamma = noise if noise is not None else _sample_gamma(
            spec.dirichlet_alpha, (b, a), generator, dev)
        gamma = torch.where(legal, gamma, 0.0)
        total = torch.clamp(gamma.sum(-1, keepdim=True), min=1e-20)
        dist = gamma / total
        eps = spec.dirichlet_epsilon
        new_prior = torch.where(legal, (1.0 - eps) * tree.prior[:, 0] + eps * dist, 0.0)
        prior, nz = tree.prior.clone(), tree.noise.clone()
        prior[:, 0] = new_prior
        nz[:, 0] = dist
        return tree.replace(prior=prior, noise=nz)
    if spec.use_gumbel_noise:
        if noise is None:
            u = torch.rand((b, a), generator=generator, device=dev)
            tiny = torch.finfo(torch.float32).tiny
            noise = -torch.log(-torch.log(u.clamp(min=tiny)))
        g = torch.where(legal, noise, 0.0)
        logit, nz = tree.logit.clone(), tree.noise.clone()
        logit[:, 0] = tree.logit[:, 0] + g
        nz[:, 0] = g
        return tree.replace(logit=logit, noise=nz)
    return tree


# --------------------------------------------------------------------------
# action / policy-target extraction
# --------------------------------------------------------------------------

def root_children_visits(tree: Tree) -> torch.Tensor:
    """f32[B, A] visit counts of root children (0 for unvisited)."""
    cidx = tree.children_index[:, 0]
    return torch.where(cidx >= 0, _take_nodes(tree.visits, cidx), 0.0)


def root_children_q(spec: SearchSpec, tree: Tree) -> torch.Tensor:
    """f32[B, A] normalized mean of root children (0 where unvisited)."""
    root = torch.zeros(tree.visits.shape[0], dtype=torch.long, device=tree.visits.device)
    _, has_child, c_visits, q_norm = _children_stats(spec, tree, root)
    return torch.where(has_child & (c_visits > 0), q_norm, 0.0)


def select_action_by_max_count(tree: Tree) -> torch.Tensor:
    """reference MCTS::selectChildByMaxCount (mcts.cpp:91-104); count ties
    go to the higher-prior action, then the lowest action id."""
    return _argmax_with_prior_tiebreak(root_children_visits(tree), tree.prior[:, 0])


def select_action_by_softmax_count(spec: SearchSpec, tree: Tree, temperature: float,
                                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Sample an action proportional to count^(1/T) among children whose
    value is within ``softmax_value_threshold`` of the most visited child's
    (reference MCTS::selectChildBySoftmaxCount, mcts.cpp:106-124)."""
    counts = root_children_visits(tree)
    q = root_children_q(spec, tree)
    best = counts.argmax(-1, keepdim=True)
    best_mean = torch.gather(q, 1, best)
    weight = torch.pow(torch.clamp(counts, min=0.0), 1.0 / max(float(temperature), 1e-8))
    eligible = (counts > 0) & (q >= best_mean - spec.softmax_value_threshold)
    weight = torch.where(eligible, weight, 0.0)
    # guard: always at least the max-count child
    fallback = torch.zeros_like(weight).scatter(1, best, 1.0)
    weight = torch.where(weight.sum(-1, keepdim=True) > 0, weight, fallback)
    return torch.multinomial(weight, 1, generator=generator)[:, 0].to(torch.int32)


def mcts_policy_target(tree: Tree) -> torch.Tensor:
    """Normalised visit-count distribution over actions (reference
    getSearchDistributionString, mcts.cpp:126-137)."""
    counts = root_children_visits(tree)
    return counts / torch.clamp(counts.sum(-1, keepdim=True), min=1e-8)


def is_resign(spec: SearchSpec, tree: Tree, selected_action: torch.Tensor,
              threshold: float) -> torch.Tensor:
    """reference MCTS::isResign (mcts.cpp:84-89), bool[B]."""
    b = tree.visits.shape[0]
    root = torch.zeros((b,), dtype=torch.long, device=tree.visits.device)
    root_q = node_normalized_mean(spec, tree, root)
    child = _take(tree.children_index[:, 0], selected_action)
    child_q = node_normalized_mean(spec, tree, child.clamp(min=0))
    child_q = torch.where(child >= 0, child_q, 0.0)
    return (-root_q < threshold) & (child_q < threshold)


def tree_string(spec: SearchSpec, tree: Tree, action_to_str: Callable[[int], str] = str,
                game: int = 0) -> str:
    """SGF-style dump of game ``game``'s search tree (reference
    ``Tree::getTreeInfo_r``, tree.h:79-110): each visited node emits
    ``;[move]C[count/mean/value/prior]``, its visited children in
    parentheses, most visited first. On the host; for the console."""
    visits = tree.visits[game].cpu().numpy()
    mean = tree.mean[game].cpu().numpy()
    value = tree.value[game].cpu().numpy()
    prior = tree.prior[game].cpu().numpy()
    ci = tree.children_index[game].cpu().numpy()
    afp = tree.action_from_parent[game].cpu().numpy()
    parent = tree.parent[game].cpu().numpy()

    def node_str(n: int) -> str:
        move = "root" if n == 0 else action_to_str(int(afp[n]))
        p = prior[parent[n], afp[n]] if n != 0 else 0.0
        return (f";[{move}]C[count: {visits[n]:.0f}, mean: {mean[n]:.3f}, "
                f"value: {value[n]:.3f}, prior: {p:.3f}]")

    def rec(n: int) -> str:
        kids = [int(c) for c in ci[n] if c >= 0 and visits[int(c)] > 0]
        kids.sort(key=lambda c: -visits[c])
        return node_str(n) + "".join(f"({rec(c)})" for c in kids)

    return f"({rec(0)})"

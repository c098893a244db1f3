"""Gumbel AlphaZero root search, batched (port of
``minizero_tpu/search/gumbel.py``; reference ``minizero/actor/gumbel_zero.{h,cpp}``).

Top-k Gumbel action sampling, sequential halving of root candidates with
per-phase budgets, and the completed-Q improved-policy target. Candidacy is a
dense bool[B, A] mask on the tree plus (sample_size, budget) per game.
"""

from __future__ import annotations

import math

import torch

from minizero_tpu_torch.search.mcts import (
    NEG_INF,
    SearchSpec,
    Selection,
    Tree,
    _bounds_for,
    _normalize_q,
    _node_q,
    _take_nodes,
    _tree_value_bounds,
    _walk,
    empty_selection,
    mark_duplicates,
    root_children_visits,
)


def _root_child_q_norm(spec: SearchSpec, tree: Tree):
    """([B, A] normalized mean of root children, 0 where unvisited or
    missing; [B, A] their visits)."""
    cidx = tree.children_index[:, 0]
    has = cidx >= 0
    visits = torch.where(has, _take_nodes(tree.visits, cidx), 0.0)
    q_raw = torch.where(has, _take_nodes(_node_q(spec, tree), cidx), 0.0)
    q = _normalize_q(spec, q_raw, tree.to_play[:, :1], _bounds_for(spec, tree, 2))
    return torch.where(has & (visits > 0), q, 0.0), visits


def _sigma(spec: SearchSpec, tree: Tree) -> torch.Tensor:
    """[B, 1] (c_visit + max root child count) * c_scale."""
    max_count = root_children_visits(tree).amax(-1, keepdim=True)
    return (spec.gumbel_sigma_visit_c + max_count) * spec.gumbel_sigma_scale_c


def _sigma_scores(spec: SearchSpec, tree: Tree) -> torch.Tensor:
    """[B, A] candidate ranking score: logit (incl. gumbel noise) +
    sigma * q for visited children, -inf unvisited (reference
    GumbelZero::sortCandidatesByScore, gumbel_zero.cpp:121-137)."""
    q, visits = _root_child_q_norm(spec, tree)
    score = tree.logit[:, 0] + _sigma(spec, tree) * q
    return torch.where(tree.legal[:, 0] & (visits > 0), score, NEG_INF)


def _top_k_mask(values: torch.Tensor, mask: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """bool[B, A]: the top ``k[b]`` entries of ``values`` among ``mask``,
    ranked as the JAX package's pairwise comparison ranks them (an entry's
    rank is the number of entries greater, or equal at a lower index). A
    stable descending sort gives the same ranks in O(A) memory a row where
    the pairwise table takes O(A^2) (70 GB at B=1024, A=3040); -0.0 becomes
    +0.0 first, as ``==`` equates them and a radix sort would not."""
    masked = torch.where(mask, values, NEG_INF) + 0.0
    order = torch.sort(masked, dim=-1, descending=True, stable=True).indices
    ranks = torch.empty_like(order)
    ranks.scatter_(1, order, torch.arange(masked.shape[-1], device=values.device).expand_as(order))
    return mask & (ranks < k.reshape(-1, 1))


def _first_argmax(x: torch.Tensor) -> torch.Tensor:
    """Row-wise argmax, lowest index among ties (jnp.argmax), long[B]."""
    best = x.amax(-1, keepdim=True)
    a = x.shape[-1]
    iota = torch.arange(a, device=x.device).expand_as(x)
    return torch.where(x >= best, iota, a).amin(-1)


def init_candidates(spec: SearchSpec, tree: Tree) -> Tree:
    """After the root expansion: keep the ``gumbel_sample_size`` legal
    actions with the highest (noised) logits and set the first phase budget
    (reference gumbel_zero.cpp:92-99)."""
    m0 = spec.gumbel_sample_size
    legal = tree.legal[:, 0]
    k = torch.clamp(legal.sum(-1), max=m0)
    active = _top_k_mask(tree.logit[:, 0], legal, k)
    budget = max(1.0, math.floor(spec.num_simulations / (math.log2(m0) * m0)))
    b = legal.shape[0]
    return tree.replace(
        gumbel_active=active,
        gumbel_sample_size=torch.full((b,), m0, dtype=torch.int32, device=legal.device),
        gumbel_budget=torch.full((b,), budget, dtype=torch.float32, device=legal.device),
    )


def sequential_halving_tick(spec: SearchSpec, tree: Tree) -> Tree:
    """After each simulation: when every active candidate reached the phase
    budget, halve the candidate set (keep the top by sigma score) and extend
    the budget (reference gumbel_zero.cpp:100-118)."""
    m0 = spec.gumbel_sample_size
    visits = root_children_visits(tree)
    active = tree.gumbel_active
    all_reached = torch.where(active, visits >= tree.gumbel_budget[:, None], True).all(-1)
    m_cur = tree.gumbel_sample_size
    denom = math.log2(m0) * torch.clamp(m_cur.to(torch.float32) / 2.0, min=1.0)
    # tensor numerator: PyTorch computes ``number / tensor`` as a reciprocal
    # times the number, which is not IEEE division
    next_budget = torch.floor(torch.full_like(denom, float(spec.num_simulations)) / denom)
    do_halve = all_reached & (next_budget > 0) & (m_cur > 2)

    scores = _sigma_scores(spec, tree)
    new_m = torch.div(m_cur, 2, rounding_mode="floor")
    new_active = _top_k_mask(scores, active, new_m)
    # reference: new budget = count of the best-by-score candidate +
    # next_budget (gumbel_zero.cpp:115, candidates_[0] after sorting)
    best = _first_argmax(torch.where(new_active, scores, NEG_INF))
    new_budget = torch.gather(visits, 1, best[:, None])[:, 0] + next_budget
    return tree.replace(
        gumbel_active=torch.where(do_halve[:, None], new_active, active),
        gumbel_sample_size=torch.where(do_halve, new_m, m_cur),
        gumbel_budget=torch.where(do_halve, new_budget, tree.gumbel_budget),
    )


def gumbel_select_leaf(spec: SearchSpec, tree: Tree) -> Selection:
    """Root step: the active candidate with the lowest count (ties -> higher
    logit, then lower index); below the chosen child, ordinary PUCT
    (reference GumbelZero::selection, gumbel_zero.cpp:74-88). The path mask
    holds the root, every node descended through, and the leaf; ``dup`` is
    set on trees with virtual loss."""
    b = tree.visits.shape[0]
    dev = tree.visits.device
    visits = root_children_visits(tree)
    active = tree.gumbel_active
    count_key = torch.where(active, -visits, NEG_INF)
    best_count = count_key.amax(-1, keepdim=True)
    tie = torch.where(count_key >= best_count, tree.logit[:, 0], NEG_INF)
    action = _first_argmax(tie)
    rows = torch.arange(b, device=dev)
    child = tree.children_index[rows, 0, action].long()
    child_exp = (child >= 0) & tree.expanded[rows, child.clamp(min=0)]
    stop_new = child < 0
    stop_leaf = (child >= 0) & ~child_exp

    sel = empty_selection(spec, b, dev)
    sel.action = action.to(torch.int32)
    sel.is_new = stop_new
    sel.leaf = torch.where(stop_leaf, child, -1).to(torch.int32)
    sel.path[:, 0] = True
    sel.path[rows, child.clamp(min=0)] |= stop_leaf
    sel = _walk(spec, tree, child.clamp(min=0), stop_new | stop_leaf, sel)
    return mark_duplicates(tree, sel)


def decide_action(spec: SearchSpec, tree: Tree) -> torch.Tensor:
    """argmax sigma score among candidates (reference
    GumbelZero::decideActionNode with actor_select_action_by_count,
    gumbel_zero.cpp:60-72), i32[B]."""
    scores = _sigma_scores(spec, tree)
    return _first_argmax(torch.where(tree.gumbel_active, scores, NEG_INF)).to(torch.int32)


def improved_policy_target(spec: SearchSpec, tree: Tree) -> torch.Tensor:
    """Completed-Q improved policy: noise-free logits plus sigma(Q), with the
    non-visited-node value estimate, softmax-normalised over legal root
    actions (reference GumbelZero::getMCTSPolicy, gumbel_zero.cpp:9-58)."""
    legal = tree.legal[:, 0]
    q, visits = _root_child_q_norm(spec, tree)
    visited = legal & (visits > 0)
    prior0 = tree.prior[:, 0]
    # value estimate for non-visited children (gumbel_zero.cpp:11-32)
    pi_sum = torch.where(visited, prior0, 0.0).sum(-1)
    q_sum = torch.where(visited, prior0 * q, 0.0).sum(-1)
    value_pi = tree.value[:, 0]
    if spec.value_rescale:
        lo, hi, enough = _tree_value_bounds(spec, tree)
        scaled = (value_pi - lo) / torch.clamp(hi - lo, min=1e-8)
        scaled = torch.clamp(2.0 * scaled - 1.0, -1.0, 1.0)
        value_pi = torch.where(enough, scaled, torch.ones_like(scaled))
    if spec.flip_player2_value:
        value_pi = torch.where(tree.to_play[:, 0] == 2, -value_pi, value_pi)
    n = spec.num_simulations
    non_visited = (1.0 / (1.0 + n)) * (value_pi + (n / torch.clamp(pi_sum, min=1e-8)) * q_sum)
    completed_q = torch.where(visited, q, non_visited[:, None])
    new_logits = tree.logit[:, 0] - tree.noise[:, 0] + _sigma(spec, tree) * completed_q
    new_logits = torch.where(legal, new_logits, NEG_INF)
    new_logits = new_logits - new_logits.amax(-1, keepdim=True)
    # reference drops entries below exp(-38) (gumbel_zero.cpp:52-53)
    weights = torch.where(legal & (new_logits >= -38.0), torch.exp(new_logits), 0.0)
    return weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-20)

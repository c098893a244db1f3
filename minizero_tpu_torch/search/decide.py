"""The move decision shared by the AlphaZero and MuZero searches (port of
``_decide``, ``minizero_tpu/selfplay/muzero_search.py:316-349``, which the
JAX engine's decision matches): from finished trees, the action, the policy
target, the root value and the resign signal."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from minizero_tpu_torch.search import gumbel as gz
from minizero_tpu_torch.search import mcts
from minizero_tpu_torch.search.mcts import SearchSpec, Tree


class SearchResult(NamedTuple):
    action: torch.Tensor  # i32[B]
    policy_target: torch.Tensor  # f32[B, A]
    root_value: torch.Tensor  # f32[B]
    resign: torch.Tensor  # bool[B]


def decide(spec: SearchSpec, trees: Tree, temperature: float, resign_threshold: float,
           generator: Optional[torch.Generator] = None) -> SearchResult:
    """Action, policy target, root value and resign signal from finished
    trees (reference ZeroActor::decideActionNode, zero_actor.cpp:178-192)."""
    if spec.use_gumbel:
        if spec.select_by_count:
            action = gz.decide_action(spec, trees)
        else:
            action = mcts.select_action_by_softmax_count(spec, trees, temperature, generator)
        policy_target = gz.improved_policy_target(spec, trees)
    else:
        if spec.select_by_count:
            action = mcts.select_action_by_max_count(trees)
        else:
            action = mcts.select_action_by_softmax_count(spec, trees, temperature, generator)
        policy_target = mcts.mcts_policy_target(trees)
    resign = mcts.is_resign(spec, trees, action, resign_threshold)
    return SearchResult(action=action, policy_target=policy_target,
                        root_value=trees.mean[:, 0], resign=resign)

"""Batched MuZero search over plain tensors (port of
``minizero_tpu/selfplay/muzero_search.py``; reference: the MuZero path of
``actor/zero_actor.cpp:58-68, 231-245``).

MuZero needs the env only at the root (features and legal mask); every
simulation below it runs the dynamics net on the parent's hidden state. So
the whole search (root inference, ``n`` simulations, the action and policy
target) is one function over tensors, used by the self-play engine for
board games and directly for Atari, whose env lives on the host.

Per simulation: the selected parent's hidden state, one recurrent inference
(dynamics + prediction), then ONE fused tree step (``ops/tree_kernel.py``:
the CUDA kernel on the card, its plain version on the CPU). Hidden states
live in a ``[B, N, ...]`` buffer in the compute dtype beside the tree; the
parent's is read by indexing. Every interior node expands all actions and
is never terminal; the leaf's player is 1 for one-player games, else the
parent's opponent. The leaf reward is passed to the tree step only when the
net has a reward head (Atari), so board games stay in the kernel's board
regime, as in the JAX package.

For the console: with ``think_batch > 1`` the search runs rounds of K
virtual-loss selections and ONE recurrent forward over the K x B edges
(on the plain search functions, as the JAX package does), and
``init_timed`` / ``advance_timed`` / ``finish_timed`` run the tree-step
loop's simulations in chunks the caller sizes.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

from minizero_tpu_torch.ops.tree_kernel import fused_tree_step, supports_fused_tree_step
from minizero_tpu_torch.search import gumbel as gz
from minizero_tpu_torch.search import mcts
from minizero_tpu_torch.search.decide import SearchResult, decide
from minizero_tpu_torch.search.mcts import SearchSpec, Tree
from minizero_tpu_torch.utils.transforms import from_discrete_value


def _scalar(out, key: str, discrete: bool) -> torch.Tensor:
    if discrete:
        return from_discrete_value(out[key].float())
    return out[key][:, 0].float()


class TimedMuZeroSearch(NamedTuple):
    """A search in flight on the tree-step loop: the trees, the next
    selection, the hidden-state buffer and the generator of its draws."""

    trees: Tree
    sel: Any
    hidden: torch.Tensor
    generator: Optional[torch.Generator]


class MuZeroSearch:
    """``search = MuZeroSearch(...)``; ``search(feats, legal, turns,
    generator, temperature)`` runs a search and decides, and
    ``search.search_trees(feats, legal, turns, generator)`` returns the
    finished trees, for a MuZero network
    (any module with ``initial_inference(feats [B, H, W, C])`` and
    ``recurrent_inference(hidden, action_planes)``, already on the device
    and in ``compute_dtype``). ``tree_step`` is the per-simulation tree
    transition; a caller may wrap it (e.g. to hold the kernel against its
    plain version) as long as the contract of
    ``ops.tree_kernel.fused_tree_step`` is kept."""

    def __init__(self, network, spec: SearchSpec,
                 action_features_fn: Callable[[torch.Tensor], torch.Tensor],
                 num_players: int, discrete_value: bool,
                 compute_dtype: torch.dtype = torch.float32, resign_threshold: float = -0.9):
        self.network = network
        self.spec = spec
        self.action_features_fn = action_features_fn
        self.num_players = num_players
        self.discrete_value = discrete_value
        self.compute_dtype = compute_dtype
        self.resign_threshold = resign_threshold
        self.tree_step = fused_tree_step

    def _root_setup(self, feats: torch.Tensor, legal: torch.Tensor, turns: torch.Tensor,
                    generator: Optional[torch.Generator]):
        """Root inference, tree init, root expansion, backup and noise
        (reference MuZero initial inference path, zero_actor.cpp:58-62).
        Returns the trees and the root hidden states."""
        spec = self.spec
        batch = feats.shape[0]
        dev = feats.device
        out = self.network.initial_inference(feats.to(self.compute_dtype))
        policy = out["policy"].float()
        logits = out["policy_logit"].float()
        value = _scalar(out, "value", self.discrete_value)
        turns = turns.to(torch.int32)
        zeros_i = torch.zeros((batch,), dtype=torch.int32, device=dev)
        trees = mcts.init_tree(spec, turns)
        trees = mcts.expand_node(spec, trees, 0, zeros_i - 1, zeros_i, turns, policy, logits,
                                 legal, torch.zeros((batch,), dtype=torch.bool, device=dev))
        trees = mcts.backup(spec, trees, zeros_i, value, torch.zeros_like(value))
        trees = mcts.add_root_noise(spec, trees, generator=generator)
        if spec.use_gumbel:
            trees = gz.init_candidates(spec, trees)
        return trees, out["hidden_state"]

    def _recurrent_eval(self, parent_hidden: torch.Tensor, actions: torch.Tensor):
        """One dynamics + prediction forward for a batch of (parent, action)
        edges; returns (policy, logits, value, reward or None, hidden)."""
        planes = self.action_features_fn(actions).to(self.compute_dtype)
        out = self.network.recurrent_inference(parent_hidden, planes)
        value = _scalar(out, "value", self.discrete_value)
        reward = from_discrete_value(out["reward"].float()) if "reward" in out else None
        return (out["policy"].float(), out["policy_logit"].float(), value, reward,
                out["hidden_state"])

    def _leaf_turn(self, trees: Tree, parent: torch.Tensor) -> torch.Tensor:
        """The leaf's player: 1 in one-player games, else the parent's
        opponent (``parent`` long[M] over the games repeated M / B times)."""
        b = trees.visits.shape[0]
        if self.num_players == 1:
            return torch.ones(parent.shape, dtype=torch.int32, device=parent.device)
        rows = torch.arange(parent.shape[0], device=parent.device) % b
        return 3 - trees.to_play[rows, parent]

    def _hidden_buffer(self, root_hidden: torch.Tensor) -> torch.Tensor:
        spec = self.spec
        hidden = torch.zeros((root_hidden.shape[0], spec.max_nodes) + tuple(root_hidden.shape[1:]),
                             dtype=self.compute_dtype, device=root_hidden.device)
        hidden[:, 0] = root_hidden
        return hidden

    def _phase0(self, trees: Tree):
        """Phase-0 (selection only) tree step on the expanded root."""
        spec = self.spec
        batch, a = trees.visits.shape[0], spec.action_size
        dev = trees.visits.device
        zeros_f = torch.zeros((batch, a), dtype=torch.float32, device=dev)
        return self.tree_step(
            spec, trees, mcts.empty_selection(spec, batch, dev), zeros_f, zeros_f,
            torch.zeros((batch, a), dtype=torch.bool, device=dev),
            torch.zeros((batch,), dtype=torch.bool, device=dev),
            torch.zeros((batch,), dtype=torch.float32, device=dev),
            torch.ones((batch,), dtype=torch.int32, device=dev), 0, 0)

    def _sim(self, trees: Tree, sel, hidden: torch.Tensor, s: int):
        """Simulation ``s``: the parent's hidden state, one recurrent
        inference, one tree step, and the new hidden state stored at slot
        ``s`` (every MuZero selection creates node ``s``: no node is
        terminal). Returns (trees, next selection)."""
        spec = self.spec
        batch, a = trees.visits.shape[0], spec.action_size
        dev = trees.visits.device
        parent = sel.parent.long()
        policy, logits, value, reward, leaf_hidden = self._recurrent_eval(
            hidden[torch.arange(batch, device=dev), parent], sel.action)
        trees, sel = self.tree_step(
            spec, trees, sel, policy, logits, torch.ones((batch, a), dtype=torch.bool, device=dev),
            torch.zeros((batch,), dtype=torch.bool, device=dev), value,
            self._leaf_turn(trees, parent), s, 1, leaf_reward=reward)
        hidden[:, s] = leaf_hidden
        return trees, sel

    def _sim_loop(self, trees: Tree, root_hidden: torch.Tensor) -> Tree:
        """Phase-0 selection, then every simulation on the tree step."""
        trees, sel = self._phase0(trees)
        hidden = self._hidden_buffer(root_hidden)
        for s in range(1, self.spec.num_simulations + 1):
            trees, sel = self._sim(trees, sel, hidden, s)
        return trees

    def _think_batch_rounds(self, trees: Tree, root_hidden: torch.Tensor) -> Tree:
        """The console's think-batch rounds (JAX ``_think_batch_rounds``,
        muzero_search.py:198-289): K selections under virtual loss, ONE
        recurrent forward over the K x B edges, the K selections completed
        in order (``mcts.think_batch_backup``), the virtual loss cleared at
        the round's end."""
        spec = self.spec
        k, n, a = spec.think_batch, spec.num_simulations, spec.action_size
        batch = trees.visits.shape[0]
        dev = trees.visits.device
        rows = torch.arange(batch, device=dev).repeat(k)
        hidden = self._hidden_buffer(root_hidden)
        all_legal = torch.ones((batch, a), dtype=torch.bool, device=dev)
        no_terminal = torch.zeros((batch,), dtype=torch.bool, device=dev)
        select = gz.gumbel_select_leaf if spec.use_gumbel else mcts.select_leaf
        for r in range(-(-n // k)):
            sels = []
            for j in range(k):
                en = r * k + j + 1 <= n
                sel = select(spec, trees)
                mcts.add_path_vloss(trees, sel, en)
                sels.append((sel, en))
            parents = torch.cat([sel.parent.long() for sel, _ in sels])
            policy, logits, value, reward, leaf_hidden = self._recurrent_eval(
                hidden[rows, parents], torch.cat([sel.action for sel, _ in sels]))
            if reward is None:
                reward = torch.zeros_like(value)
            turn = self._leaf_turn(trees, parents)
            for j, (sel, en) in enumerate(sels):
                part = slice(j * batch, (j + 1) * batch)
                slot = r * k + j + 1
                trees = mcts.think_batch_backup(
                    spec, trees, sel, en, slot, policy[part], logits[part], all_legal,
                    no_terminal, turn[part], value[part], reward[part])
                # node ``slot`` exists only where this selection created it
                hidden[:, slot] = leaf_hidden[part]
                if spec.use_gumbel:
                    trees = gz.sequential_halving_tick(spec, trees)
            mcts.clear_vloss(trees)
        return trees

    def search_trees(self, feats: torch.Tensor, legal: torch.Tensor, turns: torch.Tensor,
                     generator: Optional[torch.Generator] = None) -> Tree:
        """The finished trees of a full search (the analysis surface; twin of
        ``SelfPlayEngine.search_trees``)."""
        trees, root_hidden = self._root_setup(feats, legal, turns, generator)
        if self.spec.think_batch > 1:
            return self._think_batch_rounds(trees, root_hidden)
        return self._sim_loop(trees, root_hidden)

    def __call__(self, feats: torch.Tensor, legal: torch.Tensor, turns: torch.Tensor,
                 generator: Optional[torch.Generator] = None,
                 temperature: float = 1.0) -> SearchResult:
        trees = self.search_trees(feats, legal, turns, generator)
        return decide(self.spec, trees, temperature, self.resign_threshold, generator)

    # chunked pieces for a wall-clock capped think (reference
    # ZeroActor::think, zero_actor.cpp:36-49; JAX muzero_search.py:347-368)
    def init_timed(self, feats: torch.Tensor, legal: torch.Tensor, turns: torch.Tensor,
                   generator: Optional[torch.Generator] = None) -> TimedMuZeroSearch:
        """Root inference, expansion and the phase-0 selection."""
        if not supports_fused_tree_step(self.spec):
            raise ValueError("the timed search runs on the tree step: think_batch must be 1")
        trees, root_hidden = self._root_setup(feats, legal, turns, generator)
        trees, sel = self._phase0(trees)
        return TimedMuZeroSearch(trees, sel, self._hidden_buffer(root_hidden), generator)

    def advance_timed(self, carry: TimedMuZeroSearch, lo: int, hi: int) -> TimedMuZeroSearch:
        """Run simulations ``[lo, hi)`` of a search in flight."""
        trees, sel = carry.trees, carry.sel
        for s in range(lo, hi):
            trees, sel = self._sim(trees, sel, carry.hidden, s)
        return carry._replace(trees=trees, sel=sel)

    def finish_timed(self, carry: TimedMuZeroSearch, temperature: float = 1.0):
        """Decide from the (possibly partial) trees: (result, trees)."""
        return (decide(self.spec, carry.trees, temperature, self.resign_threshold,
                       carry.generator), carry.trees)


# the name the JAX package gives the function that makes the search
make_muzero_search = MuZeroSearch

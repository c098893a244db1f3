"""Self-play engine: batched env + MCTS + network on one device (port of
``minizero_tpu/selfplay/engine.py``, its kernel paths).

B independent games advance in lock-step: one MCTS simulation for all games
per network forward, ``num_simulations + 1`` forwards per move (reference
ActorGroup, ``minizero/actor/actor_group.cpp``). Each simulation picks the
selected parent's state, steps the env, evaluates the leaf, then runs ONE
fused tree step: the CUDA kernel on the card, its plain PyTorch version on
the CPU. Three loops, dispatched as in the JAX engine:

- AlphaZero trees with ``max_nodes < 48`` (e.g. Gumbel n=16), and on an
  env with in-tree rewards (2048, Tetris) at any tree size: ``[B, N, A]``
  trees on ``ops/tree_kernel.py`` (kernel B1; with the env's leaf rewards
  in its reward regime, B1'), node states in ``[B, N, ...]`` buffers beside
  the tree;
- plain AlphaZero PUCT with ``max_nodes >= 48`` (e.g. n=200) on an env
  without rewards: node-indexed
  packed trees on ``ops/tree_kernel_v2.py`` (kernel B2), node states packed
  into one ``[B, N, W]`` int32 blob (``ops/state_blob.py``) whose parent row
  is fetched by ``ops/gather_rows.py`` (kernel B3);
- MuZero (a network with ``recurrent_inference``), at any tree size: the
  search of ``selfplay/muzero_search.py`` on kernel B1, hidden states in a
  ``[B, N, ...]`` buffer; the env is consulted at the root only, and no
  feature rotation is drawn.

Per move the engine returns what the reference records per move
(``actor/base_actor.cpp:59-66``): the search policy P, the root mean value V,
the env reward R, plus the action, the resign signal and the pre-move feature
planes. ``move_scan`` plays several moves with the finished-game bookkeeping
(resign gating, the max-move cap, slot resets) of the JAX scan, as a Python
loop over moves. ``search_trees`` returns the finished trees of one search.

For the console (``console/gtp.py``), two more ways to search: the
think-batch rounds (``use_think_batch``: K virtual-loss selections, one
network forward over the K leaves, on the plain search functions, as the
JAX engine runs them off its kernel), and the timed search
(``az_init_timed`` / ``az_advance_timed`` / ``az_finish_timed``), which
runs the kernel loop's simulations in chunks the caller sizes.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, NamedTuple, Optional

import torch

from minizero_tpu_torch import resolve_device
from minizero_tpu_torch.config import Config
from minizero_tpu_torch.envs.base import Env, map_state, select_states
from minizero_tpu_torch.ops.gather_rows import gather_rows
from minizero_tpu_torch.ops.state_blob import blob_spec, pack_rows, unpack_rows
from minizero_tpu_torch.ops.tree_kernel import fused_tree_step, supports_fused_tree_step
from minizero_tpu_torch.ops.tree_kernel_v2 import (
    empty_selection_v2, fused_tree_step_v2, grow, pack_trees, supports_fused_tree_step_v2,
    unpack_trees)
from minizero_tpu_torch.search import gumbel as gz
from minizero_tpu_torch.search import mcts
from minizero_tpu_torch.search.decide import decide
from minizero_tpu_torch.search.mcts import SearchSpec, Tree
from minizero_tpu_torch.selfplay.muzero_search import make_muzero_search
from minizero_tpu_torch.utils.bitpack import pack_planes
from minizero_tpu_torch.utils.transforms import from_discrete_value


def search_spec_from_config(cfg: Config, env_spec, eval_mode: bool = False,
                            think_batch: int = 1) -> SearchSpec:
    """Build the static search spec (eval mode disables exploration noise,
    reference ``README.md:203`` eval recipe)."""
    return SearchSpec(
        think_batch=max(1, think_batch),
        action_size=env_spec.action_size,
        num_simulations=cfg.actor_num_simulation,
        puct_base=cfg.actor_mcts_puct_base,
        puct_init=cfg.actor_mcts_puct_init,
        discount=cfg.actor_mcts_reward_discount,
        value_rescale=cfg.actor_mcts_value_rescale,
        init_q_average=cfg.actor_mcts_init_q_average,
        flip_player2_value=(cfg.actor_mcts_value_flipping_player == "W" and env_spec.num_players == 2),
        use_dirichlet_noise=cfg.actor_use_dirichlet_noise and not eval_mode,
        dirichlet_alpha=cfg.actor_dirichlet_noise_alpha,
        dirichlet_epsilon=cfg.actor_dirichlet_noise_epsilon,
        use_gumbel_noise=cfg.actor_use_gumbel_noise and not eval_mode,
        use_gumbel=cfg.actor_use_gumbel,
        gumbel_sample_size=cfg.actor_gumbel_sample_size,
        gumbel_sigma_visit_c=cfg.actor_gumbel_sigma_visit_c,
        gumbel_sigma_scale_c=cfg.actor_gumbel_sigma_scale_c,
        select_by_count=cfg.actor_select_action_by_count or eval_mode,
    )


class MoveOutput(NamedTuple):
    """Per-move results for a batch of games (device tensors)."""

    action: torch.Tensor  # i32[B]
    turn: torch.Tensor  # i32[B] — player who makes this move
    policy_target: torch.Tensor  # f32[B, A] — P tag
    root_value: torch.Tensor  # f32[B] — V tag (root mean)
    reward: torch.Tensor  # f32[B] — R tag (env reward after the move)
    resign: torch.Tensor  # bool[B] — search proposes resignation
    features: torch.Tensor  # u8[B, H, W, C'] — pre-move planes (bit-packed
    # 8-per-byte for binary_features envs, utils/bitpack.py)
    states: Any  # stepped env states
    done: torch.Tensor  # bool[B] — stepped state is terminal
    eval_score: torch.Tensor  # f32[B] — eval score of stepped state
    resign_score: torch.Tensor  # f32[B] — eval score if current player resigns


class ScanMoves(NamedTuple):
    """Stacked per-move outputs of ``move_scan`` ([M, B, ...] tensors).

    ``resigned``/``ended`` record the finish decisions so a collector can
    replay them: a ``resigned`` move is NOT recorded (reference
    actor_group.cpp:121-122); an ``ended`` move is recorded and then the game
    finalises with ``eval_score``."""

    action: torch.Tensor  # i32[M, B]
    turn: torch.Tensor  # i32[M, B]
    policy_target: torch.Tensor  # f16[M, B, A] (record storage precision)
    root_value: torch.Tensor  # f32[M, B]
    reward: torch.Tensor  # f32[M, B]
    resign: torch.Tensor  # bool[M, B] — raw search proposal
    features: torch.Tensor  # u8[M, B, H, W, C]
    done: torch.Tensor  # bool[M, B]
    eval_score: torch.Tensor  # f32[M, B]
    resign_score: torch.Tensor  # f32[M, B]
    resigned: torch.Tensor  # bool[M, B] — finished by resignation this move
    ended: torch.Tensor  # bool[M, B] — finished by termination this move


class TimedSearch(NamedTuple):
    """An AlphaZero search in flight on the tree-step loop (the JAX timed
    carry): the trees, the next selection, the node-state buffers and the
    generator of the search's draws."""

    trees: Tree
    sel: mcts.Selection
    nodes: Any
    generator: torch.Generator


class SelfPlayEngine:
    """Batched self-play on one device.

    ``network`` is an AlphaZero or MuZero ``nn.Module``
    (``models/factory.py``; MuZero is recognised by its
    ``recurrent_inference``); the engine moves it to ``device`` and
    evaluates it in ``torch.bfloat16``
    (``use_bf16``, the JAX engine's default) or float32 — tree statistics
    stay float32. ``device`` defaults to CUDA and raises when there is no
    card; the CPU is used only when asked for. Random draws (root noise,
    feature rotations, action sampling, resign gating) come from
    ``generator`` where a call passes one, else from the engine's own,
    seeded with ``seed``. ``use_think_batch`` searches in rounds of
    ``actor_mcts_think_batch_size`` selections (the console's leaf
    batching; the reference allows it only there). ``_force_kernel_v2``
    takes the large-N loop at any tree size (tests use it at small n)."""

    def __init__(self, env: Env, cfg: Config, network: torch.nn.Module,
                 eval_mode: bool = False, use_bf16: bool = True, device=None,
                 seed: int = 0, use_think_batch: bool = False, _force_kernel_v2: bool = False):
        self.env = env
        self.cfg = cfg
        self.device = resolve_device(device)
        self.network = network.to(self.device).eval()
        think_batch = cfg.actor_mcts_think_batch_size if use_think_batch else 1
        self.spec = search_spec_from_config(cfg, env.spec, eval_mode=eval_mode,
                                            think_batch=think_batch)
        self.is_muzero = callable(getattr(network, "recurrent_inference", None))
        # an env with in-tree rewards (2048, Tetris) hands each leaf's reward
        # to the tree step, which then runs its reward regime (B1'): the
        # reward stored at the node, q = r + discount * mean, value rescale
        self.env_rewards = type(env).reward is not Env.reward
        # large-N plain AlphaZero runs on the node-indexed v2 tree step (O(A)
        # per walk step); small trees (Gumbel n=16) stay on v1, and MuZero
        # always does, as do envs with rewards (v2 has no reward regime);
        # think batches run on neither
        self.use_tree_kernel_v2 = (not self.is_muzero and not self.env_rewards
                                   and supports_fused_tree_step_v2(self.spec)
                                   and (self.spec.max_nodes >= 48 or _force_kernel_v2))
        self.use_rotation = (cfg.actor_use_random_rotation_features and not self.is_muzero
                             and env.num_rotations() > 1)
        self.compute_dtype = torch.bfloat16 if use_bf16 else torch.float32
        self._infer_net = (copy.deepcopy(self.network).to(self.compute_dtype)
                           if use_bf16 else self.network)
        self.generator = torch.Generator(device=self.device).manual_seed(int(seed))
        # the per-simulation tree transition; a caller may wrap it (e.g. to
        # hold the kernel against its plain version) as long as the contract
        # of ops.tree_kernel.fused_tree_step is kept; likewise the large-N
        # loop's tree step and parent-state gather
        self.tree_step = fused_tree_step
        self.tree_step_v2 = fused_tree_step_v2
        self.gather_rows = gather_rows
        self._blob = None  # the large-N loop's [B, N, W] state blob, reused across moves
        self._muzero = None
        if self.is_muzero:
            self._muzero = make_muzero_search(
                self._infer_net, self.spec, env.action_features, env.spec.num_players,
                discrete_value=env.spec.discrete_value_size > 1,
                compute_dtype=self.compute_dtype,
                resign_threshold=cfg.actor_resign_threshold)

    # ------------------------------------------------------------- env batch
    def init_batch(self, batch_size: int, generator: Optional[torch.Generator] = None):
        return self.env.init_random(batch_size, generator or self.generator, device=self.device)

    def reset_slots(self, states, mask: torch.Tensor, generator: Optional[torch.Generator] = None):
        """Fresh games in the slots where ``mask`` (bool[B]) is set."""
        fresh = self.env.init_random(mask.shape[0], generator or self.generator, device=self.device)
        return select_states(mask, fresh, states)

    # ------------------------------------------------------------- inference
    def _sync_inference_net(self) -> None:
        """The bf16 copy follows the float32 weights (the JAX engine casts
        the variables at every move)."""
        if self._infer_net is not self.network:
            self._infer_net.load_state_dict(self.network.state_dict())

    def _forward_features(self, feats: torch.Tensor, generator: torch.Generator):
        """AlphaZero net forward with optional random feature rotation
        (reference zero_actor.cpp:54-57, 222-223)."""
        if self.use_rotation:
            rots = torch.randint(0, self.env.num_rotations(), (feats.shape[0],),
                                 generator=generator, device=feats.device)
            feats = self.env.rotate_features_batch(feats, rots)
        out = self._infer_net(feats.to(self.compute_dtype))
        policy = out["policy"].float()
        logits = out["policy_logit"].float()
        if self.use_rotation:
            policy = self.env.rotate_policy_back_batch(policy, rots)
            logits = self.env.rotate_policy_back_batch(logits, rots)
        return policy, logits, self._scalar_value(out)

    def _scalar_value(self, out) -> torch.Tensor:
        if self.env.spec.discrete_value_size > 1:
            return from_discrete_value(out["value"].float())
        return out["value"][:, 0].float()

    # ---------------------------------------------------------------- search
    def _leaf_scores(self, leaf_states, leaf_terminal: torch.Tensor) -> torch.Tensor:
        """Terminal-leaf outcomes, f32[B]; zeros on non-terminal games. The
        score is computed only when some leaf is terminal."""
        if not bool(leaf_terminal.any()):
            return torch.zeros(leaf_terminal.shape, dtype=torch.float32, device=leaf_terminal.device)
        return torch.where(leaf_terminal, self.env.eval_score(leaf_states), 0.0)

    def _az_root_trees(self, feats, legal, turns, generator) -> Tree:
        """Root eval + tree init + root expansion/backup/noise (reference
        root handling in ZeroActor::afterNNEvaluation + addNoiseToNodeChildren)."""
        spec = self.spec
        batch = feats.shape[0]
        dev = feats.device
        policy, logits, value = self._forward_features(feats, generator)
        trees = mcts.init_tree(spec, turns.to(torch.int32))
        zeros_i = torch.zeros((batch,), dtype=torch.int32, device=dev)
        trees = mcts.expand_node(
            spec, trees, 0, torch.full((batch,), -1, dtype=torch.int32, device=dev), zeros_i,
            turns, policy, logits, legal, torch.zeros((batch,), dtype=torch.bool, device=dev))
        trees = mcts.backup(spec, trees, zeros_i, value,
                            torch.zeros((batch,), dtype=torch.float32, device=dev))
        trees = mcts.add_root_noise(spec, trees, generator=generator)
        if spec.use_gumbel:
            trees = gz.init_candidates(spec, trees)
        return trees

    def _kernel_phase0(self, trees: Tree):
        """Phase-0 (selection only) tree step on the freshly expanded root,
        in the regime of the search's other steps."""
        spec = self.spec
        batch = trees.visits.shape[0]
        dev = trees.visits.device
        zeros_f = torch.zeros((batch, spec.action_size), dtype=torch.float32, device=dev)
        zeros_b = torch.zeros((batch, spec.action_size), dtype=torch.bool, device=dev)
        zero = torch.zeros((batch,), dtype=torch.float32, device=dev)
        sel0 = mcts.empty_selection(spec, batch, dev)
        return self.tree_step(
            spec, trees, sel0, zeros_f, zeros_f, zeros_b,
            torch.zeros((batch,), dtype=torch.bool, device=dev), zero,
            torch.ones((batch,), dtype=torch.int32, device=dev), 0, 0,
            leaf_reward=zero if self.env_rewards else None)

    def _node_buffers(self, root_states):
        """``[B, N, ...]`` node-state buffers beside the tree (the JAX
        tree's embedding), the root's state at node 0."""
        n = self.spec.max_nodes

        def alloc(x):
            buf = torch.zeros((x.shape[0], n) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
            buf[:, 0] = x
            return buf

        return map_state(alloc, root_states)

    @staticmethod
    def _store_nodes(nodes, slot: int, leaf_states) -> None:
        """Node ``slot``'s state, stored unconditionally: the node exists
        only where the selection of that slot created it."""
        for f in dataclasses.fields(nodes):
            getattr(nodes, f.name)[:, slot] = getattr(leaf_states, f.name)

    def _evaluate_leaves(self, parent_states, actions, generator):
        """Step each parent state by its action and evaluate the leaf:
        (leaf states, terminal, policy, logits, value, legal, turn); a
        terminal leaf's value is its outcome."""
        env = self.env
        leaf_states = env.step(parent_states, actions)
        leaf_terminal = env.is_terminal(leaf_states)
        policy, logits, net_value = self._forward_features(env.features(leaf_states), generator)
        value = torch.where(leaf_terminal, self._leaf_scores(leaf_states, leaf_terminal), net_value)
        return (leaf_states, leaf_terminal, policy, logits, value, env.legal_mask(leaf_states),
                env.turn(leaf_states).to(torch.int32))

    def _kernel_sim(self, trees: Tree, sel, nodes, s: int, generator):
        """Simulation ``s`` of the tree-step loop: the selected parent's
        state, one env step, the leaf's evaluation, then ONE fused tree
        step; returns (trees, next selection)."""
        rows = torch.arange(trees.visits.shape[0], device=trees.visits.device)
        parent = sel.parent.long()
        leaf_states, terminal, policy, logits, value, legal, turn = self._evaluate_leaves(
            map_state(lambda buf: buf[rows, parent], nodes), sel.action, generator)
        trees, sel = self.tree_step(self.spec, trees, sel, policy, logits, legal, terminal,
                                    value, turn, s, 1,
                                    leaf_reward=self.env.reward(leaf_states) if self.env_rewards
                                    else None)
        self._store_nodes(nodes, s, leaf_states)
        return trees, sel

    def _kernel_sim_loop(self, trees: Tree, root_states, generator) -> Tree:
        """Phase-0 selection, then every simulation on the tree step."""
        trees, sel = self._kernel_phase0(trees)
        nodes = self._node_buffers(root_states)
        for s in range(1, self.spec.num_simulations + 1):
            trees, sel = self._kernel_sim(trees, sel, nodes, s, generator)
        return trees

    def _think_batch_loop(self, trees: Tree, root_states, generator) -> Tree:
        """The console's think-batch rounds (JAX ``think_batch_round``,
        engine.py:461-562; reference ZeroActor::step, zero_actor.cpp:129-157):
        K selections under virtual loss, ONE network forward over the K x B
        leaves, then the K selections completed in order
        (``mcts.think_batch_backup``: node slots ``r*K + j + 1``, duplicates
        deduplicated), the virtual loss cleared at the round's end. The last
        round may be short. On the plain search functions, as in the JAX
        package: lock-step batching is the tree step's domain."""
        spec, env = self.spec, self.env
        k, n = spec.think_batch, spec.num_simulations
        batch = trees.visits.shape[0]
        rows = torch.arange(batch, device=trees.visits.device).repeat(k)
        nodes = self._node_buffers(root_states)
        select = gz.gumbel_select_leaf if spec.use_gumbel else mcts.select_leaf
        for r in range(-(-n // k)):
            sels = []
            for j in range(k):
                en = r * k + j + 1 <= n
                sel = select(spec, trees)
                mcts.add_path_vloss(trees, sel, en)
                sels.append((sel, en))
            parents = torch.cat([sel.parent.long() for sel, _ in sels])
            actions = torch.cat([sel.action for sel, _ in sels])
            leaf_states, terminal, policy, logits, value, legal, turn = self._evaluate_leaves(
                map_state(lambda buf: buf[rows, parents], nodes), actions, generator)
            reward = env.reward(leaf_states)
            for j, (sel, en) in enumerate(sels):
                part = slice(j * batch, (j + 1) * batch)
                slot = r * k + j + 1
                trees = mcts.think_batch_backup(
                    spec, trees, sel, en, slot, policy[part], logits[part], legal[part],
                    terminal[part], turn[part], value[part], reward[part])
                self._store_nodes(nodes, slot, map_state(lambda x: x[part], leaf_states))
                if spec.use_gumbel:
                    trees = gz.sequential_halving_tick(spec, trees)
            mcts.clear_vloss(trees)
        return trees

    # ------------------------------------------------ timed (console) search
    # Wall-clock think cap (reference ZeroActor::think, zero_actor.cpp:36-49;
    # JAX engine.py:641-697): the console runs the tree-step loop's
    # simulations in chunks, checks the clock between them, and decides from
    # whatever the tree holds. AlphaZero on the v1 tree step only.

    def supports_timed_search(self) -> bool:
        return not self.is_muzero and supports_fused_tree_step(self.spec)

    @torch.no_grad()
    def az_init_timed(self, states, generator: Optional[torch.Generator] = None) -> TimedSearch:
        """Root evaluation, the root's expansion and the phase-0 selection."""
        self._sync_inference_net()
        env = self.env
        gen = generator or self.generator
        trees = self._az_root_trees(env.features(states), env.legal_mask(states),
                                    env.turn(states), gen)
        trees, sel = self._kernel_phase0(trees)
        return TimedSearch(trees, sel, self._node_buffers(states), gen)

    @torch.no_grad()
    def az_advance_timed(self, carry: TimedSearch, lo: int, hi: int) -> TimedSearch:
        """Run simulations ``[lo, hi)`` of a search in flight."""
        trees, sel = carry.trees, carry.sel
        for s in range(lo, hi):
            trees, sel = self._kernel_sim(trees, sel, carry.nodes, s, carry.generator)
        return carry._replace(trees=trees, sel=sel)

    @torch.no_grad()
    def az_finish_timed(self, carry: TimedSearch, temperature: float = 1.0):
        """Decide from the (possibly partial) trees: (action, policy
        target, root value, resign, trees)."""
        action, policy_target, root_value, resign = self._decide(
            carry.trees, temperature, carry.generator)
        return action, policy_target, root_value, resign, carry.trees

    def _kernel_sim_loop_v2(self, trees: Tree, root_states, generator) -> Tree:
        """Large-N AlphaZero sim loop on the node-indexed v2 tree step.

        Node states live in a packed int32 blob ``[B, N, Wp]``; each
        simulation gathers the selected parent's row (``self.gather_rows``),
        unpacks it, steps the env, evaluates the leaf, runs ONE v2 tree step
        and stores the leaf's row at slot ``s`` in place (node ``s`` is read
        only where this simulation created it, so the unconditional store is
        safe). Node capacity is staged (65 -> 129 -> ... -> N): simulations
        in ``[lo, cap)`` run on capacity-``cap`` arrays.

        The row stride ``Wp`` is the state's ``bspec.width`` words rounded
        up to a multiple of 4 (Go 9x9: 697 -> 700), so that every row starts
        16-byte aligned and the gather takes its 16-byte path (the JAX
        engine pads for its TPU DMAs the same way, to 128 words). The pad
        words stay zero and ``unpack_rows`` ignores them."""
        spec, env = self.spec, self.env
        batch = trees.visits.shape[0]
        n = spec.max_nodes
        dev = trees.visits.device
        bspec = blob_spec(root_states)
        w = bspec.width
        shape = (batch, n, -(-w // 4) * 4)
        if self._blob is None or tuple(self._blob.shape) != shape or self._blob.device != dev:
            self._blob = torch.zeros(shape, dtype=torch.int32, device=dev)
        blob = self._blob
        blob[:, 0, :w] = pack_rows(bspec, root_states)

        caps = []
        c = 65
        while c < n:
            caps.append(c)
            c = (c - 1) * 2 + 1
        caps.append(n)

        packed = pack_trees(spec, trees, caps[0])
        zeros_f = torch.zeros((batch, spec.action_size), dtype=torch.float32, device=dev)
        zeros_b = torch.zeros((batch, spec.action_size), dtype=torch.bool, device=dev)
        packed, sel = self.tree_step_v2(
            spec, packed, empty_selection_v2(spec, batch, caps[0], dev), zeros_f, zeros_b,
            torch.zeros((batch,), dtype=torch.bool, device=dev),
            torch.zeros((batch,), dtype=torch.float32, device=dev),
            torch.ones((batch,), dtype=torch.int32, device=dev), 0, 0)
        lo = 1
        for cap in caps:
            if packed.visits.shape[1] < cap:
                packed = grow(packed, cap)
                pad = torch.zeros((batch, cap - sel.path.shape[1]), dtype=torch.bool, device=dev)
                sel.path = torch.cat([sel.path, pad], dim=1)
            for s in range(lo, cap):
                parent_states = unpack_rows(bspec, self.gather_rows(blob, sel.parent))
                leaf_states = env.step(parent_states, sel.action)
                leaf_terminal = env.is_terminal(leaf_states)
                policy, _, net_value = self._forward_features(env.features(leaf_states), generator)
                value = torch.where(leaf_terminal, self._leaf_scores(leaf_states, leaf_terminal),
                                    net_value)
                packed, sel = self.tree_step_v2(
                    spec, packed, sel, policy, env.legal_mask(leaf_states), leaf_terminal,
                    value, env.turn(leaf_states).to(torch.int32), s, 1)
                blob[:, s, :w] = pack_rows(bspec, leaf_states)
            lo = cap
        return unpack_trees(spec, packed, trees)

    def _search(self, states, turns, feats, generator) -> Tree:
        """Root evaluation and the whole sim loop; the finished trees."""
        if self.is_muzero:
            self._muzero.tree_step = self.tree_step
            return self._muzero.search_trees(feats, self.env.legal_mask(states), turns, generator)
        trees = self._az_root_trees(feats, self.env.legal_mask(states), turns, generator)
        if self.spec.think_batch > 1:
            return self._think_batch_loop(trees, states, generator)
        if self.use_tree_kernel_v2:
            return self._kernel_sim_loop_v2(trees, states, generator)
        return self._kernel_sim_loop(trees, states, generator)

    @torch.no_grad()
    def search_trees(self, states, generator: Optional[torch.Generator] = None) -> Tree:
        """Run the full search and return the finished trees (the analysis
        surface of the JAX engine's ``search_trees``)."""
        self._sync_inference_net()
        env = self.env
        return self._search(states, env.turn(states), env.features(states),
                            generator or self.generator)

    def _decide(self, trees: Tree, temperature: float, generator):
        return decide(self.spec, trees, temperature, self.cfg.actor_resign_threshold, generator)

    @torch.no_grad()
    def move(self, states, temperature: float = 1.0,
             generator: Optional[torch.Generator] = None) -> MoveOutput:
        """Search every game and play the chosen action."""
        env = self.env
        gen = generator or self.generator
        turns = env.turn(states)
        feats = env.features(states)
        if env.spec.binary_features:
            # 8 planes per byte for the record stream (utils/bitpack.py)
            features_u8 = pack_planes(feats)
        else:
            features_u8 = feats.to(torch.uint8)
        self._sync_inference_net()
        trees = self._search(states, turns, feats, gen)
        action, policy_target, root_value, resign = self._decide(trees, temperature, gen)
        stepped = env.step(states, action)
        return MoveOutput(
            action=action,
            turn=turns.to(torch.int32),
            policy_target=policy_target,
            root_value=root_value,
            reward=env.reward(stepped),
            resign=resign,
            features=features_u8,
            states=stepped,
            done=env.is_terminal(stepped),
            eval_score=env.eval_score(stepped),
            resign_score=env.resign_eval_score(states),
        )

    # ------------------------------------------------------------ multi-move
    @torch.no_grad()
    def move_scan(self, states, temperature: float = 1.0, num_moves: int = 8,
                  enable_resign: Optional[torch.Tensor] = None,
                  moves_since_reset: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None):
        """Advance every game ``num_moves`` moves: move -> finish decision ->
        slot reset. Returns ``(ScanMoves, states, enable_resign,
        moves_since_reset)``; thread the last two back in across calls."""
        gen = generator or self.generator
        batch = self.env.turn(states).shape[0]
        dev = self.device
        disable_ratio = float(self.cfg.zero_disable_resign_ratio)
        max_moves = int(max(self.env.spec.max_game_length, 1) * 2)
        enable = (torch.ones((batch,), dtype=torch.bool, device=dev)
                  if enable_resign is None else enable_resign.to(dev))
        msr = (torch.zeros((batch,), dtype=torch.int32, device=dev)
               if moves_since_reset is None else moves_since_reset.to(dev, torch.int32))
        rows = []
        for _ in range(num_moves):
            out = self.move(states, temperature, gen)
            # resign requires a prior recorded move (collector contract);
            # resign takes precedence over done
            resigned = out.resign & enable & (msr > 0)
            ended = (out.done | (msr + 1 >= max_moves)) & ~resigned
            reset = resigned | ended
            states = self.reset_slots(out.states, reset, gen)
            fresh_enable = torch.rand((batch,), generator=gen, device=dev) >= disable_ratio
            enable = torch.where(reset, fresh_enable, enable)
            msr = torch.where(reset, torch.zeros_like(msr), msr + 1)
            rows.append(ScanMoves(
                action=out.action, turn=out.turn,
                policy_target=out.policy_target.to(torch.float16),
                root_value=out.root_value, reward=out.reward, resign=out.resign,
                features=out.features, done=out.done, eval_score=out.eval_score,
                resign_score=out.resign_score, resigned=resigned, ended=ended,
            ))
        stacked = ScanMoves(*[torch.stack(field) for field in zip(*rows)])
        return stacked, states, enable, msr

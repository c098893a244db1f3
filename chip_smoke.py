"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's self-play and search paths (``minizero_tpu_torch``) at
full width, with 1 x 256 nets made from a seed and bf16 inference, then one
whole zero iteration (self-play, records, replay, SGD, checkpoint) of the
flagship and of Gumbel MuZero, then the flagship run's eval match, GTP
console and the other CLI modes, then the tree steps past 384 actions and
the families Othello, NoGo, Kill-All-Go, Clobber, Gomoku and Hex, then 2048
(with its trained net), Tetris Block Puzzle, Rubik's cube, Connect6, Dots
and Boxes, Breakthrough, ConHex and Havannah, then Atari's self-play over
the host env and its zero iteration, and Lines of Action, Surakarta,
Santorini and Amazons, then the tools (the profiler and its trace report
among them) and the zero loop over ``torch.distributed``, then the README's
strength protocol at n=800, and holds every CUDA kernel of them against its
plain PyTorch version on the card:

- the flagship Go 9x9 Gumbel AlphaZero path, n=16, 1024 games (tree step
  B1, ``csrc/tree_step.cu``, board regime);
- the large-N Go 9x9 AlphaZero path, n=200, 1024 games (tree step B2,
  ``csrc/tree_step_v2.cu``, and the parent-state row gather B3,
  ``csrc/gather_rows.cu``, every launch on its 16-byte aligned path);
- Go 9x9 Gumbel MuZero, n=16, 1024 games (tree step B1, board regime, with
  the MuZero network and its hidden-state store);
- the Atari MuZero search, n=50, 256 games on random features, as the JAX
  package's ``bench.py:143-188`` runs it (tree step B1 in its reward
  regime, B1': leaf rewards, discount 0.997, value rescale).

Phases:

  1. device: the card's name and power limit;
  2. build: every kernel with nvcc (seconds, registers, shared memory);
  3. kernel vs plain version: one full-width move or search of each path in
     which every kernel launch runs beside its plain version from the same
     state; integers must match exactly, floats within 1e-5; then small
     inputs of each path played on the card and on the CPU;
  4. main paths: ``move_scan`` of each self-play path (8 gaz moves, 4 az
     moves, 8 gmz moves) and 3 Atari searches, after a warm-up, with every
     launch counter set to 0 just before and read just after, legality of
     every action, env-steps/s or ms per search, and each kernel's time
     beside its plain version's, its bound and (where one PyTorch call
     computes the same function) that call's; B3 also with L2 flushed
     before each launch, on the indices of a random-init and of a trained
     net's move, beside the floor of its grid (``csrc/gather_rows_floor.cu``,
     a kernel that reads the indices only);
  5. where the device time goes: one move or search of each path under
     ``torch.profiler``; B3's time in a move per launch;
  6. one zero iteration of the flagship through ``zero.loop.ZeroLoop.run``
     (gaz n=16, 1 x 256, 1024 games in lock-step, 500 SGD steps at batch
     1024, from a seeded random init): B1 beside its plain version on the
     first ``move_scan`` chunk, launch counts over the iteration, the
     records parsed back, the logs, a checkpoint reloaded into a fresh
     loop; games/s, env-steps/s, the ``[SelfPlay Timing]`` split, SGD ms
     per step (CUDA events, steps 11-500), checkpoint size and times, peak
     device memory; 6e a fresh loop's ``resume()`` on that run directory:
     the replay window rebuilt from the records, its features replayed on
     the card, equal to the loop's byte for byte, with the same step,
     network and optimizer state; 6b the same for Gumbel MuZero (K=5, 200
     SGD steps); 6f a fresh loop's ``resume()`` on 6b's run: the window
     equal to the loop's byte for byte, and one ``sample_muzero`` batch of
     each buffer from the same ``RandomState`` equal; 6c the train step on
     the card against the CPU (TF32 off) and a fixed full-width batch whose
     loss falls; 6d the native record codec against the plain writer on 64
     of the iteration's games;
  7. eval through the CLI (``-mode eval`` on phase 6's gaz run): its
     iteration-1 checkpoint against its bootstrap one, 1024 games at
     B=1024 on the synchronized path, B1 beside its plain version over the
     first 16 plies, W/L/D, Elo, ``eval.csv``, plies, ms per ply, games/s,
     B1 launches; a self-match of the iteration-1 net (256 games at
     B=256, rotation off, two random opening plies) whose wins must split
     evenly; 7b the GTP console
     (``-mode console`` as a subprocess, a script of ``load_model``,
     ``play``, five ``genmove``, ``pv``, ``tree_string``, ``showboard``,
     ``final_score``) plain, with a think time limit and with think batches
     of 8, every reply ``=``, ms per ``genmove``; one ``genmove`` in this
     process with B1 at B=1 beside its plain version, and B1's time there;
     7c ``-mode sp`` (128 records at B=1024, parsed back), ``-mode
     env_test`` on Go 9x9 and ``-mode zero_training_name``, each timed.
  8. past 384 actions, and six more env families: 8a B1 in the
     board and the reward regime and B2 on synthetic searches at A = 385,
     801 and 3040 and N (capacity) = 17 and 201 (B=1024; B=256 where a tree
     would pass 4 GB), every step of an N=17 search and six of an N=201 one
     beside the plain version, each timed beside its bound; 8b Othello
     (gaz n=16, the trained ``runs/oth8_gaz_r5`` net of
     ``minizero_tpu_torch/assets/``): one move checked, ``move_scan`` of 8
     moves, one zero iteration through ``ZeroLoop.run`` (1024 games, 500
     SGD steps at batch 1024, from a seeded init) and ``-mode eval`` of the
     trained net against a seeded init (1024 games at B=1024), which it
     must win; 8c NoGo 9x9 and Kill-All-Go 7x7 with the seki table, 8d
     Clobber 10x10 (gaz n=16 on B1's wide kernel at A=400; az n=50 on B2's
     wide kernel and B3, 4 moves), 8e Gomoku 15x15 and Hex 11x11: gaz n=16
     at B=1024 from seeded 1 x 256 nets, one move with every launch beside
     its plain version, then 4 moves of ``move_scan`` with exact launch
     counts and every action legal (8 moves for the trained Othello net).
  9. the stochastic puzzles and the rest of group 3: 9a 2048 gmz n=16 with
     the trained ``runs/p2048_gmz_r5`` net of ``minizero_tpu_torch/assets/``
     (B1's board regime with value rescale: the board-game MuZero net has
     no reward head), one move checked, ``move_scan`` of 8 moves, then 1024
     whole games from the same boards with the trained net and with a
     seeded init, the trained net's mean return at least 1.5x the init's;
     9b one 2048 zero iteration at that run's recipe (512 games in
     lock-step, 200 SGD steps at batch 1024; records parsed back with their
     rewards, a checkpoint reloaded, SGD ms/step and the step's idle
     share); 9c 2048 gaz n=16 (AlphaZero with the env's rewards in the
     tree: B1'); 9d Tetris Block Puzzle gmz and gaz n=16 (A=801, B1's wide
     kernel; gaz in its reward regime with the Gumbel root); 9e Rubik's,
     Connect6, Dots and Boxes, Breakthrough, ConHex and Havannah gaz n=16:
     each 1 checked move, 1 warm-up and 4 moves of ``move_scan`` as in 8c.
 10. Atari over the host env at ``runs/atari_gmz_r5_b128``'s widths
     (Gumbel MuZero n=18, B1' with the Gumbel root, 128 games in lock-step
     on FakeALE(length=900), a seeded net, bf16), and group 5: 10a the host
     engine (``selfplay/host_engine.py``): one move with every B1' launch
     beside its plain version, the card ring's stack byte-equal to
     ``AtariVecEnv.features_u8`` on the first 10 moves and after resets,
     32 timed moves split into search and host; 10b one zero iteration at
     the run's recipe (128 sequences, 200 SGD steps at batch 128, a replay
     window of 7 iterations whose frame window is on the card, OBS tags):
     16 records' OBS against the window's rows, 256 sampled stacks
     assembled on the card equal to ``rebuild_features_from_frames``, SGD
     ms/step and one step's idle share, ``resume`` of the buffer and the
     window from every record; 10c ``run_selfplay_host`` (``-mode sp``) at
     B=32 over 50-move episodes; 10d Lines of Action,
     Surakarta, Santorini and Amazons gaz n=16 at B=1024 on B1's wide kernel
     (A = 1,456 / 1,296 / 1,900 / 3,040), as in 9e.
 11. the tools and the data-parallel zero loop: 11a ``tools/analysis.py``'s
     parsers on phase 6's gaz logs (equal to the op.log lines), its plots or,
     without matplotlib, the loop's one ``[Analysis] skipped`` line,
     ``tools/to_sgf.py`` on the run's 1024 records, ``-mode remove_obs`` on
     16 of phase 10b's records and ``recover_obs_file`` with an
     ``AtariObsReplayer`` over FakeALE (every OBS tag equal to the stripped
     one); 11b ``tools/profile.py`` at the flagship's widths (8 steady
     moves, 20 SGD steps at batch 1024) with a trace, and
     ``tools/trace_report.py`` on it: B1 exactly 17 launches a steady move,
     its mean time and the window's device time a move; then, side by
     side, 11c ``-mode zero -multi_device`` under ``torch.distributed.run
     --nproc_per_node=1`` on NCCL (256 games, 50 SGD steps at batch 1024)
     and 11d two gloo ranks on the one card (2 x 128 games, 20 SGD steps
     at global batch 256): record shards, one checkpoint from rank 0, the
     hosts line, each rank's B1 launches, and bitwise equal parameters on
     every rank; beside them 11e, the dense heads split over ``mp``:
     ``ZeroLoop(mesh=make_mesh(model_parallel=2))``, dp 1 x mp 2, as two
     gloo ranks on the card with 11c's games and seed (20 SGD steps at
     batch 1024): each rank's local heads (policy 82 -> 41, value hidden
     256 -> 128, the scalar value layer whole), its B1 launches, the record
     file equal to 11c's byte for byte, rank 0's files only, a checkpoint
     that loads into a plain network, and bitwise equal whole weights on
     both ranks.
 12. the README's strength protocol at n=800 (``scripts/n800_pair.py``:
     800 simulations, the most visited action, no noise, eval mode, 4
     uniform opening plies, 96 games in lock-step), Go 9x9 at 1 x 256 in
     two eval engines as ``play_match`` builds them, each path 4 searched
     plies after the openings: 12a az n=800, the trained az n=200 net of
     ``minizero_tpu_torch/assets/`` against a seeded init (B2 staged 65 ->
     ... -> 801, B3 over the [96, 801, 700] blob), 12b gaz n=800 between
     two seeded inits (B1 on [96, 801, 82] trees, sequential halving of 16
     candidates); the first ply's tree steps at simulations 0, 1, 2, 100,
     400 and 800 (and every row gather) beside the plain versions, exact
     launch counts over the 4 plies, every action legal, ms per ply, the
     games finished so far, and B1 and B2 timed at simulations 100, 400
     and 800 beside their plain versions and bounds, B3 beside
     ``x[arange(B), idx]``.

Prints one progress line per phase, then a JSON line of kernel numbers, the
card's name and power limit, and last ``{"ok": true, "device": {...}}``.
Exits non-zero, printing no result, when anything fails or no CUDA device
is present. Imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import atexit
import copy
import ctypes
import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# flagship self-play config (bench.py:1-12), the large-N AlphaZero config
# (bench.py:54-67: az n=200), Go Gumbel MuZero (the runs/go9_gmz_r4 config)
# and the Atari MuZero search (bench.py:143-188: n=50, B=256)
BATCH = 1024
SCAN_MOVES = 8
AZ_SIMS = 200
AZ_SCAN_MOVES = 4
ATARI_BATCH = 256
ATARI_SIMS = 50
ATARI_SEARCHES = 3
# B2 timed at one simulation of each capacity stage (65, 129, 201); B3 at
# the gather of simulation 190
V2_TIMED_SIMS = (60, 120, AZ_SIMS - 10)
B3_TIMED_SIM = AZ_SIMS - 10
# B3's round-robin timing rounds; L2 flush between cold launches (the
# card's L2 is 50 MB)
B3_ROUNDS = 3
FLUSH_BYTES = 128 << 20
# the trained az n=200 net (scripts/export_trained_weights.py), and the
# moves it plays before its timed move
TRAINED_NPZ = os.path.join("minizero_tpu_torch", "assets", "go9_az200_r3b_iter25000.npz")
TRAINED_WARM_MOVES = 8
FLOAT_ATOL = 1e-5
# phase 6: one zero iteration at the flagship's widths (the one cut: 1024
# games, one a slot, where the reference recipe plays 2000); SGD timed by
# CUDA events over steps SGD_TIMED_FROM..ZERO_STEPS; the train step on the
# card against the CPU within TRAIN_ATOL (TF32 off)
ZERO_GAMES = 1024
ZERO_BATCH = 1024
ZERO_STEPS = 500
# phase 6b's Gumbel MuZero iteration takes fewer steps (~61 ms each)
GMZ_ZERO_STEPS = 200
SGD_TIMED_FROM = 11
CODEC_GAMES = 64
TRAIN_ATOL = 1e-4
# phase 7: eval, console and the other CLI modes on phase 6's gaz run (the
# synchronized match reads its finished flags every EVAL_PLIES_PER_CHECK
# plies, eval/match.py); B1 beside its plain version over the first
# EVAL_CHECKED_PLIES plies of the match; the console's time limit (s)
EVAL_GAMES = 1024
EVAL_CHECKED_PLIES = 16
# the self-match's games (at B=256: its time is its plies', host-bound)
SELF_MATCH_GAMES = 256
EVAL_PLIES_PER_CHECK = 16
CONSOLE_TIME_LIMIT = 0.01
SP_GAMES = 128
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32 FLOP/s outside
# the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12

_T0 = time.perf_counter()


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - _T0:8.2f} s] {msg}", flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 3 helpers: the tree step held against its plain version
# ---------------------------------------------------------------------------

class TreeStepCheck:
    """Wraps the engine's tree step: each call runs the CUDA kernel and the
    plain PyTorch version from the same state and compares every output.
    Keeps a copy of the inputs of simulation ``keep_sim`` for timing, and
    counts the calls in the reward regime (B1')."""

    def __init__(self, keep_sim: int):
        from minizero_tpu_torch.ops.tree_kernel import (
            fused_tree_step, tree_step_reference, uses_reward_regime)

        self.kernel = fused_tree_step
        self.plain = tree_step_reference
        self.reward_regime = uses_reward_regime
        self.keep_sim = keep_sim
        self.kept = None
        self.calls = 0
        self.reward_calls = 0
        self.int_elems = 0
        self.float_elems = 0
        self.max_abs_err = 0.0

    def _compare(self, name, got, want, where):
        if got.dtype.is_floating_point:
            err = float((got - want).abs().max()) if got.numel() else 0.0
            self.max_abs_err = max(self.max_abs_err, err)
            self.float_elems += got.numel()
            if not err <= FLOAT_ATOL:
                fail(f"tree step {where}: {name} differs by {err} (> {FLOAT_ATOL})")
        else:
            self.int_elems += got.numel()
            if not torch.equal(got, want):
                bad = int((got != want).sum())
                fail(f"tree step {where}: {name} differs in {bad} of {got.numel()} elements")

    def __call__(self, spec, trees, sel, *rest, leaf_reward=None):
        node_idx, phase = rest[-2], rest[-1]
        leaf = rest[:-2]
        ref_in = trees.clone()
        ref_sel = sel.clone()
        if node_idx == self.keep_sim and self.kept is None:
            self.kept = (spec, trees.clone(), ref_sel, tuple(x.clone() for x in leaf),
                         node_idx, phase, None if leaf_reward is None else leaf_reward.clone())
        want_t, want_s = self.plain(spec, ref_in, ref_sel, *leaf, node_idx, phase,
                                    leaf_reward=leaf_reward)
        got_t, got_s = self.kernel(spec, trees, sel, *leaf, node_idx, phase,
                                   leaf_reward=leaf_reward)
        where = f"sim {node_idx} (phase {phase})"
        for f in dataclasses.fields(got_t):
            if getattr(got_t, f.name) is None and getattr(want_t, f.name) is None:
                continue  # a tree's virtual loss, present only in think batches
            self._compare(f.name, getattr(got_t, f.name), getattr(want_t, f.name), where)
        for name in ("parent", "action", "leaf", "is_new", "path"):
            self._compare(f"selection.{name}", getattr(got_s, name), getattr(want_s, name), where)
        self.calls += 1
        self.reward_calls += int(self.reward_regime(spec, leaf_reward))
        return got_t, got_s


def tree_step_work(kept, nsel, trees_after):
    """(bytes, flops) that one tree step must move / do for these inputs:
    each input element read once and each output written once, counting
    only what this run's data needs (the rows of new leaves, the root row,
    the rows of the nodes the walk descends through). A node's statistics
    (visits and mean, and its reward in the reward regime) are read once,
    if the step looks at the node at all: a node backed up, the root, a
    root child, a node the walk descends through or one of its children,
    and with value rescale every node of the tree for its value bounds
    (the visits of every node, the mean and reward of the visited ones).
    The new leaf's statistics are outputs only."""
    spec, trees, sel, leaf, node_idx, phase, leaf_reward = kept
    from minizero_tpu_torch.ops.tree_kernel import uses_reward_regime

    rewards = uses_reward_regime(spec, leaf_reward)
    b, n = trees.visits.shape
    a = spec.action_size
    rows = torch.arange(b, device=trees.visits.device)
    new = int(sel.is_new.sum())
    backed = sel.path.clone() if phase > 0 else torch.zeros_like(sel.path)
    revisit = (phase > 0) & ~sel.is_new & (sel.leaf >= 0)
    backed[rows[revisit], sel.leaf[revisit].long()] = True
    if phase > 0:
        backed[rows[sel.is_new], node_idx] = True
    path_nodes = int(backed.sum())

    def children_of(mask):
        ci = trees_after.children_index.long()
        hit = (ci >= 0) & mask[:, :, None]
        out = torch.zeros((b, n + 1), dtype=torch.bool, device=mask.device)
        out.scatter_(1, torch.where(hit, ci, n).view(b, -1), True)
        return out[:, :n]

    # the nodes the walk descends through: the next path less its leaf, and
    # less the root when the Gumbel root step chose
    walked = nsel.path.clone()
    has_leaf = nsel.leaf >= 0
    walked[rows[has_leaf], nsel.leaf[has_leaf].long()] = False
    if spec.use_gumbel:
        walked[:, 0] = False
    root = torch.zeros_like(walked)
    root[:, 0] = True
    looked = backed | root | children_of(root) | walked | children_of(walked)
    seen_visits = looked.clone()
    seen_q = looked.clone()
    if spec.value_rescale:
        slots = torch.arange(n, device=looked.device)[None, :]
        seen_visits |= slots < trees_after.num_nodes[:, None]
        seen_q |= trees_after.visits > 0
    if phase > 0:  # the new leaf's statistics are written, not read
        for m in (seen_visits, seen_q):
            m[rows[sel.is_new], node_idx] = False
    node_reads = int(seen_visits.sum()) + int(seen_q.sum()) * (2 if rewards else 1)

    byts = b * (4 * 3 + 1 + n)            # selection in
    byts += b * (1 + 4 + 4)               # leaf terminal, value, turn
    byts += new * a * 9                   # policy/logit/legal rows of new leaves
    byts += new * (a * 9 + 2 + 4 * 4 + 4)  # the new node's row, scalars, parent edge
    byts += node_reads * 4                # node statistics, each read once
    byts += path_nodes * 8                # backup: visits and mean written
    if rewards:
        byts += b * 4 + new * 4           # leaf rewards in, the new nodes' rewards out
        byts += path_nodes * 4            # the serial backup follows the parent pointers
    # the Gumbel root step's row (children_index, logit, legal, gumbel_active)
    # and its state; a PUCT root is a walked node, counted with them below
    root_children = int(children_of(root).sum()) if spec.use_gumbel else 0
    if spec.use_gumbel:
        byts += b * a * 10 + b * 16
    halved = int((trees_after.gumbel_sample_size != trees.gumbel_sample_size).sum())
    byts += halved * a
    # PUCT rows (children_index, prior, legal) of the nodes walked through
    children = int(((trees_after.children_index >= 0) & walked[:, :, None]).sum())
    walked = int(walked.sum())
    byts += walked * a * 9
    byts += b * (4 * 3 + 1 + n)           # selection out
    flops = walked * a * 12 + halved * a * a * 3 + (b * a * 6 if spec.use_gumbel else 0)
    if rewards:  # q = reward + discount * mean at each child read
        flops += (children + root_children) * 2 + path_nodes * 2
    if spec.value_rescale:  # the bounds over the visited nodes, and each child's rescale
        flops += int((trees_after.visits > 0).sum()) * 4 + (children + root_children) * 5
    return byts, flops


def time_events(fn, reps: int, hold: bool = True) -> float:
    """Mean ms per call of ``fn(i)`` for i in 1..reps, by CUDA events,
    after one warm-up call ``fn(0)``. With ``hold`` the card first spins on
    a ~25 ms sleep kernel while the host enqueues every call, so that the
    events time the card and not the host's launch rate (a launch through
    a Python wrapper can take longer on the host than a short kernel takes
    on the card). Without it (plain versions, which synchronise inside) the
    events time the whole call."""
    fn(0)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if hold:
        torch.cuda._sleep(50_000_000)
    start.record()
    for i in range(1, reps + 1):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_kernel(kept, reps: int = 20):
    """Mean ms per launch of the CUDA tree step on ``reps`` fresh copies of
    the kept state, by CUDA events on the card's clock."""
    from minizero_tpu_torch.ops.tree_kernel import fused_tree_step

    spec, trees, sel, leaf, node_idx, phase, reward = kept
    copies = [trees.clone() for _ in range(reps + 1)]
    return time_events(lambda i: fused_tree_step(spec, copies[i], sel, *leaf, node_idx, phase,
                                                 leaf_reward=reward), reps)


def time_plain(kept, reps: int = 5):
    from minizero_tpu_torch.ops.tree_kernel import tree_step_reference

    spec, trees, sel, leaf, node_idx, phase, reward = kept
    return time_events(lambda i: tree_step_reference(spec, trees, sel, *leaf, node_idx, phase,
                                                     leaf_reward=reward), reps, hold=False)


def warm_selection_ms(kept, reps: int = 20) -> float:
    """Mean ms per launch of the selection-only step (phase 0) of the kept
    state, repeated on one copy of it: it writes no tree field, and after
    the first launch every row the walks read is in L2, so this is the
    kernel's own chain with memory warm (card clock)."""
    from minizero_tpu_torch.ops.tree_kernel import fused_tree_step
    from minizero_tpu_torch.ops.tree_kernel_v2 import fused_tree_step_v2

    if len(kept) == 7:  # B1
        spec, trees, sel, leaf, idx, _, reward = kept
        one = trees.clone()
        return time_events(lambda i: fused_tree_step(spec, one, sel, *leaf, idx, 0,
                                                     leaf_reward=reward), reps)
    spec, packed, sel, leaf, idx, _ = kept
    one = packed.clone()
    return time_events(lambda i: fused_tree_step_v2(spec, one, sel, *leaf, idx, 0), reps)


def tree_step_numbers(kept, reps: int = 20):
    """(kernel ms, plain ms, bound ms, bound_by, bytes, flops, deepest next
    path in nodes) of the CUDA tree step at the kept state; the kernel
    timed over ``reps`` fresh copies of it."""
    from minizero_tpu_torch.ops.tree_kernel import fused_tree_step

    k_ms = time_kernel(kept, reps)
    p_ms = time_plain(kept, min(5, reps))
    spec, trees, sel, leaf, idx, phase, reward = kept
    after = trees.clone()
    _, nsel = fused_tree_step(spec, after, sel, *leaf, idx, phase, leaf_reward=reward)
    byts, flops = tree_step_work(kept, nsel, after)
    t_bytes, t_ops = byts / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    return (k_ms, p_ms, max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            byts, flops, int(nsel.path.sum(1).max()))


# ---------------------------------------------------------------------------
# phase 3c helpers: tree step B2 and row gather B3 held against their plain
# versions
# ---------------------------------------------------------------------------

def _compare_fields(check, got, want, where):
    for f in dataclasses.fields(got):
        check._compare(f.name, getattr(got, f.name), getattr(want, f.name), where)


class TreeStepV2Check(TreeStepCheck):
    """Wraps the engine's v2 tree step: each call runs the CUDA kernel and
    the plain version from the same state and compares every output (only
    at the simulations in ``check_sims`` when that is given). Keeps a copy
    of the inputs of each simulation in ``keep_sims`` for timing
    (``kept[sim]``)."""

    def __init__(self, keep_sims, check_sims=None):
        super().__init__(-1)
        from minizero_tpu_torch.ops.tree_kernel_v2 import fused_tree_step_v2, tree_step_v2_reference

        self.kernel = fused_tree_step_v2
        self.plain = tree_step_v2_reference
        self.keep_sims = set(keep_sims)
        self.check_sims = check_sims
        self.kept = {}
        self.caps = set()

    def __call__(self, spec, packed, sel, *rest):
        node_idx, phase = rest[-2], rest[-1]
        leaf = rest[:-2]
        if node_idx in self.keep_sims and node_idx not in self.kept:
            self.kept[node_idx] = (spec, packed.clone(), sel.clone(),
                                   tuple(x.clone() for x in leaf), node_idx, phase)
        if self.check_sims is not None and node_idx not in self.check_sims:
            return self.kernel(spec, packed, sel, *leaf, node_idx, phase)
        ref_sel = sel.clone()
        want_p, want_s = self.plain(spec, packed, ref_sel, *leaf, node_idx, phase)
        got_p, got_s = self.kernel(spec, packed, sel, *leaf, node_idx, phase)
        where = f"v2 sim {node_idx} (phase {phase}, cap {packed.visits.shape[1]})"
        _compare_fields(self, got_p, want_p, where)
        _compare_fields(self, got_s, want_s, where)
        self.caps.add(packed.visits.shape[1])
        self.calls += 1
        return got_p, got_s


class GatherCheck:
    """Wraps the engine's row gather: each call runs the CUDA kernel and the
    plain version and compares the rows (the main path skips no game, so
    every row is defined), and counts the calls on the aligned path. Keeps
    the index of gather ``keep_call`` (call k gathers for simulation
    k + 1)."""

    def __init__(self, keep_call: int):
        from minizero_tpu_torch.ops.gather_rows import gather_rows, gather_rows_reference

        self.kernel = gather_rows
        self.plain = gather_rows_reference
        self.keep_call = keep_call
        self.kept_idx = None
        self.calls = 0
        self.aligned_calls = 0
        self.elems = 0
        self.max_abs_err = 0.0

    def __call__(self, x, idx):
        if self.calls == self.keep_call:
            self.kept_idx = idx.clone()
        before = self.kernel.launches_aligned
        got = self.kernel(x, idx)
        self.aligned_calls += self.kernel.launches_aligned - before
        want = self.plain(x, idx)
        if not torch.equal(got, want):
            bad = int((got != want).sum())
            fail(f"gather_rows call {self.calls}: {bad} of {got.numel()} words differ")
        self.max_abs_err = max(self.max_abs_err,
                               float((got.long() - want.long()).abs().max()) if got.numel() else 0.0)
        self.elems += got.numel()
        self.calls += 1
        return got


def time_each(fn, reps: int = 50, flush: bool = True) -> float:
    """Mean ms of one call of ``fn()`` with CUDA events around each call
    alone (card clock). With ``flush`` a 128 MB buffer is written before
    each call, so that the call finds L2 cold. The card is held on a sleep
    kernel while the host enqueues, as in ``time_events``."""
    buf = torch.empty(FLUSH_BYTES // 4, dtype=torch.int32, device="cuda")
    fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(reps)]
    torch.cuda._sleep(50_000_000)
    for i, (start, end) in enumerate(events):
        if flush:
            buf.fill_(i)
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / reps


def gather_rows_timings(sets, floor_lib, games: int):
    """B3 at the main path's shapes beside the library call
    ``x[arange(B), idx]`` and the floor of its grid (``games`` games a
    block, indices read, nothing written). ``sets`` maps a name to (blob,
    idx); the first set is the warm one. B3 and the library call are first
    held word for word against the plain version on every set; then each
    candidate is timed warm (back to back, as ``time_events``) and cold (L2
    flushed, as ``time_each``) on every set, in ``B3_ROUNDS`` round-robin
    rounds; each number is the median of its rounds. Returns a dict of ms."""
    from minizero_tpu_torch.ops.gather_rows import gather_rows, gather_rows_reference

    floor = floor_lib.gather_rows_floor_launch
    floor.argtypes, floor.restype = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3, ctypes.c_int
    sink = torch.empty(1, dtype=torch.int32, device="cuda")

    def floor_run(x, idx):
        rc = floor(x.shape[0], games, idx.data_ptr(), sink.data_ptr(),
                   torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            fail(f"gather_rows_floor: launch refused (cudaError {rc})")

    # the library call's index tensors, made once per set as a caller would
    # keep them
    long_idx = {id(j): (torch.arange(x.shape[0], device=x.device), j.long())
                for x, j in sets.values()}

    def library(x, idx):
        return x[long_idx[id(idx)]]

    cands = {"B3": gather_rows, "library": library, "floor": floor_run}
    for name in ("B3", "library"):
        for k, (x, j) in sets.items():
            if not torch.equal(cands[name](x, j), gather_rows_reference(x, j)):
                fail(f"B3 {name}: rows differ from the plain version on the {k} indices")
    samples = {name: {"warm": [], **{k: [] for k in sets}} for name in cands}
    x0, j0 = next(iter(sets.values()))
    for _ in range(B3_ROUNDS):
        for name, run in cands.items():
            samples[name]["warm"].append(time_events(lambda i: run(x0, j0), 50))
            for k, (x, j) in sets.items():
                samples[name][k].append(time_each(lambda x=x, j=j: run(x, j)))
    r = {name: {key: sorted(v)[len(v) // 2] for key, v in d.items()} for name, d in samples.items()}
    r["B3"]["warm_each"] = time_each(lambda: gather_rows(x0, j0), flush=False)
    r["plain"] = time_events(lambda i: gather_rows_reference(x0, j0), 20, hold=False)
    return r


def tree_step_v2_work(kept, nsel, after):
    """(bytes, flops) that one v2 tree step must move / do for these inputs:
    each input read once and each output written once, counting only what
    this run's data needs: the new leaves' rows, the backed-up path nodes,
    and per node of the next walk its cix row, the prior of its lanes with
    no child and the three statistics of each of its children."""
    spec, packed, sel, _, _, _ = kept
    b, cap, lanes = packed.prior.shape
    a = spec.action_size
    new = int(sel.is_new.sum())
    path_nodes = int(sel.path.sum()) + b
    byts = b * (4 * 4 + 1 + cap)             # selection in (parent, action, leaf, prior, is_new, path)
    byts += b * (1 + 4 + 4)                  # leaf terminal, value, turn
    byts += new * a * 5                      # policy and legal rows of new leaves
    byts += new * (lanes * 8 + 5 * 4 + 4)    # the new rows, node scalars, parent edge
    byts += (b - new) * 4                    # the stored value of a revisited leaf
    byts += path_nodes * 16                  # backup: visits and means, read and written
    walked = nsel.path.clone()
    rows = torch.arange(b, device=walked.device)
    has_leaf = nsel.leaf >= 0
    walked[rows[has_leaf], nsel.leaf[has_leaf].long()] = False
    cix_rows = after.cix[:, :, :a]
    on_walk = walked[:, :, None]
    children = int((((cix_rows >= 0) | (cix_rows <= -3)) & on_walk).sum())
    open_lanes = int(((cix_rows == -1) & on_walk).sum())
    nodes = int(walked.sum())
    byts += nodes * lanes * 4 + open_lanes * 4 + children * 12
    byts += b * (4 * 4 + 1 + cap)            # selection out
    flops = children * 8 + open_lanes * 4 + nodes * 12
    return byts, flops


def time_tree_step_v2(kept, reps: int = 20):
    """(kernel ms, plain ms) per launch at the kept state; the kernel runs
    on ``reps`` fresh copies of it."""
    from minizero_tpu_torch.ops.tree_kernel_v2 import fused_tree_step_v2, tree_step_v2_reference

    spec, packed, sel, leaf, node_idx, phase = kept
    copies = [packed.clone() for _ in range(reps + 1)]
    k_ms = time_events(lambda i: fused_tree_step_v2(spec, copies[i], sel, *leaf, node_idx, phase),
                       reps)
    del copies
    p_ms = time_events(lambda i: tree_step_v2_reference(spec, packed, sel, *leaf, node_idx, phase),
                       3, hold=False)
    return k_ms, p_ms


def tree_step_v2_numbers(kept, reps: int = 20):
    """(kernel ms, plain ms, bound ms, bound_by, bytes, flops, deepest next
    path in nodes) of the CUDA v2 tree step at the kept state; the kernel
    timed over ``reps`` fresh copies of it."""
    from minizero_tpu_torch.ops.tree_kernel_v2 import fused_tree_step_v2

    k_ms, p_ms = time_tree_step_v2(kept, reps)
    spec, packed, sel, leaf, idx, phase = kept
    after = packed.clone()
    _, nsel = fused_tree_step_v2(spec, after, sel, *leaf, idx, phase)
    depth = int(nsel.path.sum(1).max())
    byts, flops = tree_step_v2_work(kept, nsel, after)
    t_bytes, t_ops = byts / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    return (k_ms, p_ms, max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            byts, flops, depth)


# ---------------------------------------------------------------------------
# phase 3b: the same small search on the card and on the CPU
# ---------------------------------------------------------------------------

def integer_net(spec, seed: int):
    """A linear policy/value net with small integer weights: its logits are
    sums of integers below 2^24, exact in float32 in any order, so the card
    and the CPU evaluate it identically (up to ~1 ulp in the softmax). With
    a discrete value (2048, Tetris) the value is one of 8 bins picked by an
    integer sum."""
    from torch import nn

    c, h, w, a = spec.num_input_channels, spec.input_height, spec.input_width, spec.action_size
    d = spec.discrete_value_size

    class IntegerNet(nn.Module):
        def __init__(self):
            super().__init__()
            rng = np.random.default_rng(seed)
            self.register_buffer("wp", torch.from_numpy(
                rng.integers(-7, 8, size=(h * w * c, a)).astype(np.float32)))
            self.register_buffer("wv", torch.from_numpy(
                rng.integers(-3, 4, size=(h * w * c, 1)).astype(np.float32)))
            self.register_buffer("offset", torch.arange(a, dtype=torch.float32) * 2.0 ** -16)

        def forward(self, state):
            x = state.float().reshape(state.shape[0], -1)
            logits = (x @ self.wp) / 32.0 + self.offset
            t = x @ self.wv
            if d > 1:  # a score's distribution: one bin of d // 2 - 4 .. d // 2 + 3
                idx = (t[:, 0] - 8.0 * torch.floor(t[:, 0] / 8.0)).long() + (d // 2 - 4)
                value = (idx[:, None] == torch.arange(d, device=t.device)).float()
            else:
                value = torch.clamp(t / 64.0, -0.96875, 0.96875)
            return {"policy_logit": logits, "policy": torch.softmax(logits, -1), "value": value}

    return IntegerNet()


def integer_muzero_net(spec, seed: int):
    """A MuZero net whose hidden states stay integers (mod 16) and whose
    logits, values and rewards are sums of small integers (exact in float32
    in any order), so the card and the CPU evaluate it identically (up to
    ~1 ulp in the softmax). Board features (0/1) go through an integer
    matrix; Atari features (bytes / 255) through a gather of K pixels.
    Hidden states are flat [B, K], K = 4 * hidden H * W."""
    from torch import nn

    c, h, w, a = spec.num_input_channels, spec.input_height, spec.input_width, spec.action_size
    k = 4 * spec.hidden_height * spec.hidden_width
    ca = spec.num_action_feature_channels * spec.hidden_height * spec.hidden_width
    d = spec.discrete_value_size
    atari_mode = "atari" in spec.name

    class IntegerMuZeroNet(nn.Module):
        def __init__(self):
            super().__init__()
            rng = np.random.default_rng(seed)

            def ints(lo, hi, shape):
                return torch.from_numpy(rng.integers(lo, hi + 1, size=shape).astype(np.float32))

            if atari_mode:
                self.register_buffer("ridx", torch.from_numpy(rng.integers(0, h * w * c, size=k)))
            else:
                self.register_buffer("wr", ints(-3, 3, (h * w * c, k)))
            self.register_buffer("wd", ints(-2, 2, (k, k)))
            self.register_buffer("wa", ints(-7, 7, (ca, k)))
            self.register_buffer("wp", ints(-7, 7, (k, a)))
            self.register_buffer("wv", ints(-3, 3, (k,)))
            self.register_buffer("wvd", ints(-2, 2, (k,)))
            self.register_buffer("wrd", ints(-2, 2, (k,)))
            self.register_buffer("offset", torch.arange(a, dtype=torch.float32) * 2.0 ** -16)

        @staticmethod
        def _mod(t, m):
            return t - m * torch.floor(t / m)

        def _bins(self, t):
            # two-hot head on bins d//2 - 4 .. d//2 + 3 (values -4 .. 3)
            idx = self._mod(t, 8.0).long() + (d // 2 - 4)
            return (idx[:, None] == torch.arange(d, device=t.device)).float()

        def _predict(self, hidden):
            logits = (hidden @ self.wp) / 256.0 + self.offset
            out = {"policy_logit": logits, "policy": torch.softmax(logits, -1),
                   "hidden_state": hidden}
            if d > 1:
                out["value"] = self._bins(hidden @ self.wvd)
            else:
                out["value"] = torch.clamp((hidden @ self.wv) / 16384.0, -0.96875, 0.96875)[:, None]
            return out

        def initial_inference(self, state):
            x = state.float().reshape(state.shape[0], -1)
            if atari_mode:
                return self._predict(self._mod(torch.round(x[:, self.ridx] * 255.0), 16.0))
            return self._predict(self._mod(x @ self.wr, 16.0))

        def recurrent_inference(self, hidden_state, action_plane):
            ap = action_plane.float().reshape(action_plane.shape[0], -1)
            out = self._predict(self._mod(hidden_state @ self.wd + ap @ self.wa, 16.0))
            if atari_mode:
                out["reward"] = self._bins(out["hidden_state"] @ self.wrd)
            return out

    return IntegerMuZeroNet()


def profile_run(fn, ms_per_run: float, kernel_names=(), what: str = "move"):
    """One profiled call of ``fn`` (a move or a search): device busy time
    (the summed durations of the kernels and copies that ran on the card)
    against the unprofiled time of one call, kernel launches per call, and
    the kernels that take the most device time. Returns the summary line and
    a dict of the device ms of each kernel whose name contains one of
    ``kernel_names``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    # device-side events only: a CPU operator also reports the device time
    # of the kernels it launched, which would count them twice
    dev = [(e.key, e.self_device_time_total / 1e3, e.count) for e in events
           if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(d for _, d, _ in dev)
    if busy_ms <= 0:
        fail("profile: the profiler saw no device activity")
    named = {n: sum(d for k, d, _ in dev if n in k) for n in kernel_names}
    launches = sum(e.count for e in events if e.key.startswith(("cudaLaunchKernel", "cuLaunchKernel")))
    top = sorted(dev, key=lambda x: -x[1])[:8]
    parts = "; ".join(f"{k[:60]} {d:.2f} ms x{c}" for k, d, c in top)
    own = "; ".join(f"{n} {d:.3f} ms ({d / ms_per_run:.4f} of the {what})"
                    for n, d in named.items())
    return (f"device busy {busy_ms:.2f} ms of {ms_per_run:.1f} ms/{what} "
            f"(idle share {1 - busy_ms / ms_per_run:.3f}), {launches} kernel launches/{what}; "
            f"top device time: {parts}" + (f"; kernels of the port: {own}" if own else "")), named


def check_scan(engine, start_states, scan, end_states, moves: int, what: str) -> None:
    """Every action of a ``move_scan`` was legal where it was played, the
    replayed states equal the scan's, and the policy targets and root
    values are finite distributions and values (in [-1, 1] for games won
    or lost). Where the env starts its games at random (2048, Tetris,
    Rubik's), a slot reset in the scan drew from the engine's generator
    between the searches' draws: such a slot is followed up to its reset."""
    from minizero_tpu_torch.envs.base import Env

    env = engine.env
    st = start_states
    rows = torch.arange(BATCH, device=scan.action.device)
    random_init = type(env).init_random is not Env.init_random
    live = torch.ones((BATCH,), dtype=torch.bool, device=scan.action.device)
    for mv in range(moves):
        a = scan.action[mv].long()
        if not bool((env.legal_mask(st)[rows, a] | ~live).all()):
            fail(f"{what}: an illegal action at move {mv}")
        reset = scan.resigned[mv] | scan.ended[mv]
        st = engine.reset_slots(env.step(st, a), reset)
        if random_init:
            live &= ~reset
    for f in dataclasses.fields(st):
        got, want = getattr(st, f.name)[live], getattr(end_states, f.name)[live]
        if not torch.equal(got, want):
            fail(f"{what}: replayed states differ from move_scan's in {f.name}")
    if int(live.sum()) < BATCH // 2:
        fail(f"{what}: only {int(live.sum())} games followed through the scan")
    pt = scan.policy_target.float()
    if not (bool(torch.isfinite(pt).all()) and bool(torch.isfinite(scan.root_value).all())):
        fail(f"{what}: non-finite policy target or root value")
    if float((pt.sum(-1) - 1.0).abs().max()) > 1e-2:
        fail(f"{what}: policy targets do not sum to 1")
    # win / loss outcomes bound the root values; a score (2048, Tetris) does not
    if env.spec.discrete_value_size == 1 and float(scan.root_value.abs().max()) > 1.0:
        fail(f"{what}: root values leave [-1, 1]")


def small_search_card_vs_cpu(algo: str, over: dict, moves: int, what: str) -> str:
    """A small search (B=64, f32, integer-exact net, noise and rotation
    off) played on the card and on the CPU from the same random openings:
    actions equal, policy targets and root values within 1e-4 / 1e-5. A
    MuZero ``algo`` takes the integer-exact MuZero net."""
    from minizero_tpu_torch.config import algorithm_preset, default_config
    from minizero_tpu_torch.envs import make_env
    from minizero_tpu_torch.selfplay.engine import SelfPlayEngine

    small = dict(algorithm_preset(algo))
    small.update(actor_use_gumbel_noise=False, actor_use_dirichlet_noise=False,
                 actor_use_random_rotation_features=False, actor_select_action_by_count=True,
                 **over)
    scfg = default_config("go", **small)
    senv = make_env(scfg)
    make_net = integer_muzero_net if algo.endswith("mz") else integer_net
    gpu_eng = SelfPlayEngine(senv, scfg, make_net(senv.spec, 7), use_bf16=False, device="cuda")
    cpu_eng = SelfPlayEngine(senv, scfg, make_net(senv.spec, 7), use_bf16=False, device="cpu")
    gs, cs = gpu_eng.init_batch(64), cpu_eng.init_batch(64)
    rng = np.random.default_rng(0)
    for _ in range(6):  # distinct random openings, the same on both devices
        legal = senv.legal_mask(cs).numpy()
        a = torch.from_numpy((rng.random(legal.shape) * legal).argmax(-1).astype(np.int32))
        gs, cs = senv.step(gs, a.cuda()), senv.step(cs, a)
    perr = verr = 0.0
    for mv in range(moves):
        go, co = gpu_eng.move(gs), cpu_eng.move(cs)
        if not torch.equal(go.action.cpu(), co.action):
            fail(f"{what}, move {mv}: card and CPU actions differ")
        perr = max(perr, float((go.policy_target.cpu() - co.policy_target).abs().max()))
        verr = max(verr, float((go.root_value.cpu() - co.root_value).abs().max()))
        if not (perr <= 1e-4 and verr <= 1e-5):
            fail(f"{what}, move {mv}: policy target diff {perr}, root value diff {verr}")
        gs, cs = go.states, co.states
    return (f"card == CPU actions over {moves} moves of 64 games (f32, v2 loop: "
            f"{gpu_eng.use_tree_kernel_v2}), policy target diff <= {perr:.2g}, "
            f"root value diff <= {verr:.2g}")


def atari_search(net, cfg, batch: int, compute_dtype, seed: int):
    """The Atari MuZero search of ``bench.py:143-188`` on the card: the
    search, random features in [0, 1) from ``seed`` (no ALE: the env is
    host-side), all actions legal, one player."""
    from minizero_tpu_torch.envs import atari
    from minizero_tpu_torch.selfplay.engine import search_spec_from_config
    from minizero_tpu_torch.selfplay.muzero_search import make_muzero_search

    spec = atari.atari_spec()
    search = make_muzero_search(net, search_spec_from_config(cfg, spec),
                                lambda a: atari.action_features(a, spec), num_players=1,
                                discrete_value=True, compute_dtype=compute_dtype)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    feats = torch.rand((batch, spec.input_height, spec.input_width, spec.num_input_channels),
                       generator=gen, device="cuda")
    if compute_dtype == torch.float32:  # whole bytes, as the ALE's frames / 255
        feats = torch.floor(feats * 256.0) / 255.0
    legal = torch.ones((batch, spec.action_size), dtype=torch.bool, device="cuda")
    turns = torch.ones((batch,), dtype=torch.int32, device="cuda")
    return search, feats, legal, turns


def check_search_result(res, batch: int, actions: int, what: str) -> None:
    """Actions in range, finite policy targets that sum to 1, finite root
    values."""
    if tuple(res.action.shape) != (batch,) or not bool(((res.action >= 0) & (res.action < actions)).all()):
        fail(f"{what}: actions out of range or of the wrong shape")
    pt = res.policy_target
    if tuple(pt.shape) != (batch, actions) or not bool(torch.isfinite(pt).all()):
        fail(f"{what}: policy targets of the wrong shape or not finite")
    if float((pt.sum(-1) - 1.0).abs().max()) > 1e-4 or not bool(torch.isfinite(res.root_value).all()):
        fail(f"{what}: policy targets do not sum to 1 or root values are not finite")


def small_atari_card_vs_cpu(cfg) -> str:
    """The Atari MuZero search (B=64, n=50, f32, integer-exact MuZero net,
    noise off, select by count) on the card and on the CPU from the same
    features: actions and root visits equal, policy targets within 1e-4,
    root values within 1e-5 relative."""
    from minizero_tpu_torch.envs import atari
    from minizero_tpu_torch.search import mcts

    search, feats, legal, turns = atari_search(
        integer_muzero_net(atari.atari_spec(), 11).cuda(), cfg, 64, torch.float32, seed=12)
    with torch.no_grad():
        gt = search.search_trees(feats, legal, turns)
        search.network = search.network.cpu()
        ct = search.search_trees(feats.cpu(), legal.cpu(), turns.cpu())
    gv, cv = mcts.root_children_visits(gt).cpu(), mcts.root_children_visits(ct)
    if not torch.equal(gv, cv):
        fail("small Atari search: card and CPU root visits differ")
    ga, ca = mcts.select_action_by_max_count(gt).cpu(), mcts.select_action_by_max_count(ct)
    if not torch.equal(ga, ca):
        fail("small Atari search: card and CPU actions differ")
    perr = float((mcts.mcts_policy_target(gt).cpu() - mcts.mcts_policy_target(ct)).abs().max())
    gm, cm = gt.mean[:, 0].cpu(), ct.mean[:, 0]
    verr = float(((gm - cm).abs() / cm.abs().clamp(min=1.0)).max())
    if not (perr <= 1e-4 and verr <= 1e-5):
        fail(f"small Atari search: policy target diff {perr}, relative root value diff {verr}")
    if not bool((gt.reward != 0).any()):
        fail("small Atari search: no reward reached the trees")
    return (f"card == CPU root visits and actions of 64 searches (f32, n={cfg.actor_num_simulation}), "
            f"policy target diff <= {perr:.2g}, relative root value diff <= {verr:.2g}, "
            f"|root value| up to {float(cm.abs().max()):.3g}")


# ---------------------------------------------------------------------------
# phase 6 helpers: a zero iteration through ZeroLoop, the train step on the
# card against the CPU, the record codec against its plain version
# ---------------------------------------------------------------------------

class StepTimer:
    """Wraps a loop's train step: a CUDA event before step ``first`` (1 is
    the first step) and one after step ``last``, so that ms per step comes
    from the card's clock over steps first..last."""

    def __init__(self, fn, first: int, last: int):
        self.fn, self.first, self.last = fn, first, last
        self.calls = 0
        self.start = torch.cuda.Event(enable_timing=True)
        self.end = torch.cuda.Event(enable_timing=True)

    def __call__(self, *args, **kwargs):
        if self.calls + 1 == self.first:
            self.start.record()
        out = self.fn(*args, **kwargs)
        self.calls += 1
        if self.calls == self.last:
            self.end.record()
        return out

    def ms_per_step(self) -> float:
        return self.start.elapsed_time(self.end) / (self.last - self.first + 1)


def same_tensors(a, b) -> bool:
    """Nested dicts and lists of tensors and plain values, equal exactly."""
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and torch.equal(a, b.to(a.device))
    if isinstance(a, dict):
        return sorted(a) == sorted(b) and all(same_tensors(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(same_tensors(x, y) for x, y in zip(a, b))
    return a == b


def as_reloaded(policy) -> np.ndarray:
    """Self-play's f16 policy rows as a record reloads them: the parser
    (``selfplay/record.py``, as the JAX package's) divides each row by its
    float32 sum and rounds back to f16, which moves a few rows by one f16
    step."""
    p = np.asarray(policy, np.float32)
    return (p / p.sum(-1, keepdims=True)).astype(np.float16)


def same_muzero_batches(loop_buffer, resumed_buffer, batch: int, seed: int = 6):
    """One ``sample_muzero`` batch of ``batch`` from each buffer, each from
    ``RandomState(seed)``: equal, the loop's policy targets inside its
    games as a record reloads them (``as_reloaded``; past a game's end both
    are uniform). True, or the first key that differs."""
    a = loop_buffer.sample_muzero(batch, np.random.RandomState(seed))
    b = resumed_buffer.sample_muzero(batch, np.random.RandomState(seed))
    lengths = np.array([g.length for g in loop_buffer.games])
    idx = a["sampled_index"]
    inside = idx[:, 1:] + np.arange(a["policy"].shape[1]) < lengths[idx[:, 0]][:, None]
    a["policy"] = np.where(inside[..., None], as_reloaded(a["policy"]), a["policy"])
    if sorted(a) != sorted(b):
        return f"keys {sorted(a)} against {sorted(b)}"
    for key in sorted(a):
        if a[key].dtype != b[key].dtype or not np.array_equal(a[key], b[key]):
            return key
    return True


def zero_iteration(algo: str, seed: int, zero_counts, counts, codec_games: int = 0,
                   run_dir: str = "", env_name: str = "go", games: int = ZERO_GAMES,
                   steps: int = ZERO_STEPS, parallel: int = BATCH,
                   resume_check: bool = False) -> dict:
    """One iteration of the zero loop at the flagship's widths: ``ZeroLoop``
    on the card (``algorithm_preset(algo)``, ``env_name`` (Go 9x9 by
    default) at its default size, 1 x 256, 1024 games in
    lock-step, 500 SGD steps at batch 1024), ``run()`` from a seeded random
    init in a temporary run directory. The first ``move_scan`` chunk runs
    every tree step beside its plain version; every launch counter is 0
    just before ``run()`` and read just after. Checks the records, the step
    count, the logs, and a checkpoint reload into a fresh loop; with
    ``codec_games``, the native codec against the plain writer on that many
    of the iteration's games. ``run_dir`` keeps the run (checkpoints,
    records) for later phases; by default it goes to a temporary directory
    removed at the end. ``games``, ``steps`` and ``parallel`` (games in
    lock-step) cut another run's recipe. The records are parsed back to
    their games' actions and rewards. With ``resume_check``, a fresh loop
    on the run directory calls ``resume()``: the newest checkpoint, and the
    replay window rebuilt from the records with the features replayed on
    the card, equal to the loop's byte for byte (the policy targets as a
    record reloads them); for MuZero also one ``sample_muzero`` batch of
    each buffer from the same ``RandomState`` (``same_muzero_batches``).
    Returns the numbers and the config."""
    import contextlib

    from minizero_tpu_torch import native
    from minizero_tpu_torch.config import algorithm_preset, default_config
    from minizero_tpu_torch.ops.tree_kernel import fused_tree_step
    from minizero_tpu_torch.selfplay.record import game_record_from_string, parse_game, serialize_game
    from minizero_tpu_torch.zero.loop import ZeroLoop

    over = dict(algorithm_preset(algo))
    over.update(zero_num_parallel_games=parallel, zero_num_games_per_iteration=games,
                learner_batch_size=ZERO_BATCH, learner_training_step=steps,
                zero_end_iteration=1, program_seed=seed)
    cfg = default_config(env_name, **over)
    what = f"zero iteration ({env_name} {algo})"
    out = {}
    place = (contextlib.nullcontext(run_dir) if run_dir
             else tempfile.TemporaryDirectory(prefix=f"zero_{algo}_"))
    with place as run_dir:
        loop = ZeroLoop(cfg, run_dir)
        engine = loop.engine
        if engine.network is not loop.network or loop.device.type != "cuda":
            fail(f"{what}: the engine does not play the trained module on the card")
        n = engine.spec.num_simulations
        check = TreeStepCheck(keep_sim=n // 2)
        scan = engine.move_scan

        def first_chunk_checked(*args, **kwargs):
            del engine.move_scan  # later chunks take the method itself
            engine.tree_step = check
            try:
                return scan(*args, **kwargs)
            finally:
                engine.tree_step = fused_tree_step

        engine.move_scan = first_chunk_checked
        timer = StepTimer(loop._train_step, SGD_TIMED_FROM, steps)
        loop._train_step = timer
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t = time.perf_counter()
        loop.run()
        torch.cuda.synchronize()
        out["wall_s"] = time.perf_counter() - t
        launches = counts()
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        timing = dict(loop.last_selfplay_timing)
        moves = timing["chunks"] * timing["moves_per_chunk"]
        if check.calls != cfg.zero_moves_per_dispatch * (n + 1) or check.reward_calls:
            fail(f"{what}: {check.calls} tree steps checked in the first chunk "
                 f"({check.reward_calls} in the reward regime)")
        want = {"tree_step": moves * (n + 1), "tree_step_rewards": 0, "tree_step_v2": 0,
                "gather_rows": 0, "gather_rows_aligned": 0}
        if launches != want:
            fail(f"{what}: launches {launches}, expected {want} ({moves} moves)")
        (row,) = [json.loads(x) for x in open(os.path.join(run_dir, "perf.jsonl"))]
        # records: exactly the target, each parsed back to the actions the
        # replay buffer holds
        lines = open(os.path.join(run_dir, "sgf", "1.sgf")).read().splitlines()
        if len(lines) != games or len(loop.buffer) != games:
            fail(f"{what}: {len(lines)} record lines, {len(loop.buffer)} games in the buffer, "
                 f"expected {games}")
        a_size = loop.env.spec.action_size
        for i, (line, rec) in enumerate(zip(lines, loop.buffer.games)):
            parsed = game_record_from_string(line, a_size)[1]
            if not (np.array_equal(parsed.actions, rec.actions)
                    and np.array_equal(parsed.rewards, rec.rewards)):
                fail(f"{what}: record line {i} does not parse back to its game's actions and "
                     f"rewards")
        if loop.state.step != steps or timer.calls != steps:
            fail(f"{what}: step counter {loop.state.step}, {timer.calls} train steps")
        op = open(os.path.join(run_dir, "op.log")).read().splitlines()
        logged = [{k: float(v) for k, v in re.findall(r"(\w+): (\S+)", ln.split(" lr: ")[-1])}
                  for ln in op]
        if len(op) != steps // cfg.learner_training_display_step or not all(
                "loss" in d for d in logged):
            fail(f"{what}: {len(op)} op.log lines, or one without its loss")
        losses = [v for d in logged for k, v in d.items() if k.startswith("loss")]
        if not all(np.isfinite(losses)):
            fail(f"{what}: a logged loss is not finite: {op}")
        train_log = open(os.path.join(run_dir, "Training.log")).read()
        for needle in ("[SelfPlay Timing] chunks:", f"Optimization_Done {steps}",
                       "[Iteration] 1: self-play"):
            if needle not in train_log:
                fail(f"{what}: Training.log has no {needle!r} line")
        # the checkpoint, saved again to time it, into a fresh loop
        t = time.perf_counter()
        path = loop.save_checkpoint()
        out["save_s"] = time.perf_counter() - t
        out["ckpt_mib"] = os.path.getsize(path) / 2**20
        fresh = ZeroLoop(cfg, run_dir)
        t = time.perf_counter()
        fresh.load_checkpoint(path)
        torch.cuda.synchronize()
        out["load_s"] = time.perf_counter() - t
        if not (fresh.state.step == steps
                and same_tensors(loop.network.state_dict(), fresh.network.state_dict())
                and same_tensors(loop.state.optimizer.state_dict(),
                                 fresh.state.optimizer.state_dict())):
            fail(f"{what}: the reloaded checkpoint differs from the loop's state")
        if resume_check:
            again = ZeroLoop(cfg, run_dir)
            t = time.perf_counter()
            start = again.resume()
            torch.cuda.synchronize()
            out["resume_s"] = time.perf_counter() - t
            rebuilt = again.buffer.games
            same = [a.features.dtype == b.features.dtype and a.features.shape == b.features.shape
                    and a.features.tobytes() == b.features.tobytes()
                    and np.array_equal(a.actions, b.actions)
                    and np.array_equal(as_reloaded(a.policy), b.policy)
                    and a.result == b.result for a, b in zip(loop.buffer.games, rebuilt)]
            if not (start == 1 and again.state.step == steps and len(rebuilt) == games
                    and again.buffer.num_data == loop.buffer.num_data and all(same)
                    and same_tensors(loop.network.state_dict(), again.network.state_dict())
                    and same_tensors(loop.state.optimizer.state_dict(),
                                     again.state.optimizer.state_dict())):
                fail(f"{what}: resume() gave iteration {start}, step {again.state.step}, "
                     f"{len(rebuilt)} games ({sum(same)} equal to the loop's) and "
                     f"{again.buffer.num_data} positions against {loop.buffer.num_data}")
            out["resume_bytes"] = sum(g.features.nbytes for g in rebuilt)
            if loop.is_muzero:
                same = same_muzero_batches(loop.buffer, again.buffer, ZERO_BATCH)
                if same is not True:
                    fail(f"{what}: the resumed window's sample_muzero batch differs: {same}")
            again.close()
            del again, rebuilt
        # one more SGD step of the loop under the profiler, on a fresh
        # sample of its replay buffer (the loop's own sampling and upload)
        from minizero_tpu_torch.zero.loop import _to_device

        def one_step():
            sample = (loop.buffer.sample_muzero if loop.is_muzero else loop.buffer.sample_alphazero)
            b = sample(ZERO_BATCH, loop.np_rng)
            b.pop("sampled_index")
            timer.fn(loop.state, _to_device(b, loop.device), loop.generator)

        out["profile"], _ = profile_run(one_step, timer.ms_per_step(), what="SGD step")
        if codec_games:
            # 6d: the native codec and the plain writer give the line the
            # loop wrote, for the first games of the iteration
            if native.load() is None:
                fail(f"the native record codec did not load: {native.load_error()}")
            spec = loop.env.spec
            t_native = t_plain = 0.0
            for i in range(codec_games):
                players = tuple(1 if m["player"] == "B" else 2
                                for m in parse_game(lines[i], a_size)[1])
                args = (spec.name, loop.buffer.games[i], spec.board_size, players)
                t = time.perf_counter()
                got = serialize_game(*args, model_file="weight_iter_0")
                t_native += time.perf_counter() - t
                t = time.perf_counter()
                plain = serialize_game(*args, model_file="weight_iter_0", plain=True)
                t_plain += time.perf_counter() - t
                if not got == plain == lines[i]:
                    fail(f"codec: game {i}: the native and the plain record strings differ")
            out["codec"] = (codec_games, t_native, t_plain, sum(len(x) for x in lines[:codec_games]))
        out.update(
            cfg=cfg, games=games, steps=steps, parallel=parallel, moves=moves, launches=launches["tree_step"], checked=check.calls,
            check_err=check.max_abs_err, selfplay_s=row["selfplay_s"],
            optimize_s=row["optimize_s"], timing=timing,
            ms_per_step=timer.ms_per_step(), lengths=[r.length for r in loop.buffer.games],
            results=[float(r.result) for r in loop.buffer.games],
            first_loss=logged[0]["loss"], last_loss=logged[-1]["loss"],
            record_mib=os.path.getsize(os.path.join(run_dir, "sgf", "1.sgf")) / 2**20)
        loop.close()
        fresh.close()
        del loop, fresh, engine
    torch.cuda.empty_cache()
    return out


def zero_line(z: dict) -> str:
    t = z["timing"]
    env_steps = z["moves"] * z["parallel"]
    lengths = np.asarray(z["lengths"])
    return (f"{z['games']} games in {z['selfplay_s']:.2f} s ({z['games'] / z['selfplay_s']:.1f} "
            f"games/s, {env_steps / z['selfplay_s']:.1f} env-steps/s over {z['moves']} moves x "
            f"{z['parallel']} slots; game length {lengths.min()}-{lengths.max()}, mean "
            f"{lengths.mean():.1f}); [SelfPlay Timing] chunks {t['chunks']} x "
            f"{t['moves_per_chunk']} moves, dispatch {t['dispatch_s']:.2f} s, collect "
            f"{t['collect_s']:.2f} s, records {t['records_s']:.2f} s; B1 launches {z['launches']} "
            f"(= {z['moves']} moves x 17), {z['checked']} of them beside the plain version "
            f"(max |diff| {z['check_err']:.3g}); optimize {z['steps']} steps at batch "
            f"{ZERO_BATCH} in {z['optimize_s']:.2f} s wall, {z['ms_per_step']:.3f} ms/step = "
            f"{1e3 / z['ms_per_step']:.1f} SGD steps/s by CUDA events over steps "
            f"{SGD_TIMED_FROM}-{z['steps']}; loss {z['first_loss']:.4f} (first op.log line) -> "
            f"{z['last_loss']:.4f} (last); records {z['record_mib']:.1f} MiB; checkpoint "
            f"{z['ckpt_mib']:.2f} MiB, save {z['save_s']:.3f} s, load {z['load_s']:.3f} s; "
            f"iteration wall {z['wall_s']:.2f} s; peak device memory {z['peak_gib']:.2f} GiB; "
            f"one profiled SGD step: {z['profile']}")


def _random_train_batch(rng, spec, cfg, b: int) -> dict:
    """A replay-shaped batch: bit-packed 0/1 planes, f16 policies, values in
    {-1, 0, 1}; MuZero's K unroll actions and targets."""
    from minizero_tpu_torch.utils.bitpack import pack_planes

    planes = rng.random((b, spec.input_height, spec.input_width, spec.num_input_channels)) > 0.5
    k, a = cfg.learner_muzero_unrolling_step, spec.action_size

    def policy(shape):
        p = rng.random(shape) * (rng.random(shape) > 0.3) + 1e-3
        return (p / p.sum(-1, keepdims=True)).astype(np.float16)

    batch = {"features": pack_planes(torch.from_numpy(planes)).numpy(),
             "loss_scale": np.ones(b, np.float32)}
    if cfg.nn_type_name == "muzero":
        batch.update(policy=policy((b, k + 1, a)),
                     value=rng.choice([-1.0, 0.0, 1.0], (b, k + 1)).astype(np.float32),
                     actions=rng.integers(0, a, (b, k)).astype(np.int32),
                     reward=np.zeros((b, k), np.float32))
    else:
        batch.update(policy=policy((b, a)),
                     value=rng.choice([-1.0, 0.0, 1.0], b).astype(np.float32))
    return batch


def train_step_card_vs_cpu(algo: str, seed: int) -> str:
    """The train step on the card and on the CPU (TF32 off): Go 9x9, 1 x 32,
    batch 64, 3 SGD steps, each from the same weights, running statistics,
    momentum and rotation ids. The metrics, parameters and running
    statistics agree within TRAIN_ATOL: the card sums the convolutions in
    another order, and a ReLU input within float noise of 0 can land on
    either side of its kink (seen once in a K=5 unroll at batch 64: a raw
    gradient 2% apart, the parameters 1.1e-5 apart after the step); the
    state carried over each step keeps such a flip from compounding. The
    momentum, one step's raw gradient, is not compared."""
    from minizero_tpu_torch.config import algorithm_preset, default_config
    from minizero_tpu_torch.envs import make_env
    from minizero_tpu_torch.learner.train import init_train_state, make_train_step
    from minizero_tpu_torch.models.factory import create_network, init_network

    over = dict(algorithm_preset(algo))
    over.update(nn_num_hidden_channels=32, nn_num_value_hidden_channels=32, learner_batch_size=64)
    cfg = default_config("go", **over)
    env = make_env(cfg)
    cpu_net = init_network(create_network(cfg, env.spec), seed=seed)
    card_net = copy.deepcopy(cpu_net).cuda()
    cpu_state, card_state = init_train_state(cfg, cpu_net), init_train_state(cfg, card_net)
    cpu_step, card_step = make_train_step(cfg, env, cpu_net), make_train_step(cfg, env, card_net)
    rng = np.random.default_rng(seed)
    loss_err = state_err = 0.0
    for s in range(3):
        card_net.load_state_dict(cpu_net.state_dict())
        card_state.optimizer.load_state_dict(copy.deepcopy(cpu_state.optimizer.state_dict()))
        card_state.step = cpu_state.step
        batch = _random_train_batch(rng, env.spec, cfg, 64)
        rots = torch.from_numpy(rng.integers(0, 8, 64))
        m_cpu = cpu_step(cpu_state, batch, rotations=rots)
        m_card = card_step(card_state, batch, rotations=rots.cuda())
        for k in m_cpu:
            loss_err = max(loss_err, float((m_card[k].cpu() - m_cpu[k]).abs().max()))
        sd_cpu, sd_card = cpu_net.state_dict(), card_net.state_dict()
        for k in sd_cpu:
            if sd_cpu[k].is_floating_point():
                state_err = max(state_err, float((sd_card[k].cpu() - sd_cpu[k]).abs().max()))
        if not (loss_err <= TRAIN_ATOL and state_err <= TRAIN_ATOL):
            fail(f"train step ({algo}) step {s}: card and CPU differ: metrics {loss_err}, "
                 f"state {state_err} (tol {TRAIN_ATOL})")
        if card_net.training or cpu_net.training:
            fail(f"train step ({algo}): the net was left in train mode")
    return (f"3 steps equal: metrics max |diff| {loss_err:.3g}, parameters and running "
            f"statistics max |diff| {state_err:.3g} (tol {TRAIN_ATOL})")


def fixed_batch_loss_falls(algo: str, seed: int) -> str:
    """30 SGD steps of the full-width net (1 x 256) on one fixed batch of
    1024 with fixed rotation ids lower its loss (``tests/test_train.py``'s
    learning check, on the card)."""
    from minizero_tpu_torch.config import algorithm_preset, default_config
    from minizero_tpu_torch.envs import make_env
    from minizero_tpu_torch.learner.train import init_train_state, make_train_step
    from minizero_tpu_torch.models.factory import create_network, init_network

    cfg = default_config("go", **algorithm_preset(algo))
    env = make_env(cfg)
    net = init_network(create_network(cfg, env.spec), seed=seed).cuda()
    state, step = init_train_state(cfg, net), make_train_step(cfg, env, net)
    rng = np.random.default_rng(seed)
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in _random_train_batch(rng, env.spec, cfg, ZERO_BATCH).items()}
    rots = torch.from_numpy(rng.integers(0, 8, ZERO_BATCH)).cuda()
    losses = [float(step(state, batch, rotations=rots)["loss"]) for _ in range(30)]
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        fail(f"train step ({algo}): 30 steps on a fixed batch did not lower its loss: {losses}")
    return f"loss {losses[0]:.4f} -> {losses[-1]:.4f} over 30 steps"


# ---------------------------------------------------------------------------
# phase 7 helpers: eval, the GTP console and the other CLI modes, through
# the port's CLI
# ---------------------------------------------------------------------------

class FirstCallsChecked:
    """A tree step that holds its first ``n`` calls against the plain
    version (``TreeStepCheck``) and runs the kernel alone after them."""

    def __init__(self, n: int):
        self.check = TreeStepCheck(keep_sim=-1)
        self.n = n

    def __call__(self, *args, **kwargs):
        if self.check.calls < self.n:
            return self.check(*args, **kwargs)
        return self.check.kernel(*args, **kwargs)


def run_cli(argv):
    """``python -m minizero_tpu_torch`` in this process on the card:
    (its standard output, wall seconds to the card's last work)."""
    import contextlib
    import io

    from minizero_tpu_torch.__main__ import main as cli

    buf = io.StringIO()
    torch.cuda.synchronize()
    t = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    if rc != 0:
        fail(f"{' '.join(argv)} returned {rc}")
    return buf.getvalue(), seconds


def eval_phase(run_dir: str, cfg_path: str, zero_counts, counts) -> dict:
    """``-mode eval`` on phase 6's gaz run: its iteration-1 checkpoint
    against its bootstrap one, EVAL_GAMES games in lock-step at B=1024 on
    the synchronized path, the first EVAL_CHECKED_PLIES plies' tree steps
    beside their plain version; then a self-match of the iteration-1 net,
    SELF_MATCH_GAMES games, rotation off, two random opening plies, whose
    result must split evenly. Launch counters are 0 just before each and read just after."""
    import minizero_tpu_torch.selfplay.engine as engine_mod
    from minizero_tpu_torch.config import default_config
    from minizero_tpu_torch.eval.match import load_checkpoint_variables, play_match

    cfg = default_config("go").load_file(cfg_path)
    sims = cfg.actor_num_simulation
    per_check = (sims + 1) * EVAL_PLIES_PER_CHECK
    checked = FirstCallsChecked(EVAL_CHECKED_PLIES * (sims + 1))
    engine_mod.fused_tree_step = checked
    zero_counts()
    try:
        text, seconds = run_cli(["-mode", "eval", "-run_dir", run_dir, "-conf_file", cfg_path,
                                 "-num_games", str(EVAL_GAMES)])
    finally:
        engine_mod.fused_tree_step = checked.check.kernel
    launches = counts()
    b1 = launches.pop("tree_step")
    if b1 == 0 or b1 % per_check or any(launches.values()):
        fail(f"eval: {b1} B1 launches (expected a multiple of {per_check}), others {launches}")
    if checked.check.calls != checked.n or checked.check.reward_calls:
        fail(f"eval: {checked.check.calls} tree steps checked, expected {checked.n}")
    rows = open(os.path.join(run_dir, "eval.csv")).read().splitlines()
    cells = dict(zip(rows[0].split(","), rows[1].split(","))) if len(rows) == 2 else {}
    games = sum(int(cells.get(k, -1)) for k in ("wins", "losses", "draws"))
    if games != EVAL_GAMES or not np.isfinite(float(cells["elo"])):
        fail(f"eval: eval.csv holds {rows}, expected one row of {EVAL_GAMES} games")
    out = {"line": text.strip(), "seconds": seconds, "plies": b1 // (sims + 1), "launches": b1,
           "check_err": checked.check.max_abs_err, "checked": checked.check.calls,
           "elo": float(cells["elo"]), "wld": (cells["wins"], cells["losses"], cells["draws"])}
    ckpt = os.path.join(run_dir, "model", cells["new"])
    net = load_checkpoint_variables(ckpt, cfg)
    zero_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    r = play_match(cfg.replace(actor_use_random_rotation_features=False), net, net,
                   num_games=SELF_MATCH_GAMES, seed=5, opening_random_plies=2)
    torch.cuda.synchronize()
    out["self_seconds"] = time.perf_counter() - t
    b1 = counts()["tree_step"]
    if r.games != SELF_MATCH_GAMES or r.p1_wins != r.p2_wins or b1 % per_check:
        fail(f"eval self-match: {r} ({b1} B1 launches); a net against itself with "
             f"mirrored openings must split its wins evenly")
    out.update(self_result=r, self_plies=b1 // (sims + 1), ckpt=ckpt)
    return out


CONSOLE_SCRIPT = ["name", "load_model {ckpt}", "clear_board", "play b E5", "genmove w",
                  "genmove b", "genmove w", "genmove b", "genmove w", "pv", "tree_string",
                  "showboard", "final_score", "quit"]


def console_phase(cfg_path: str, ckpt: str) -> dict:
    """``python -m minizero_tpu_torch -mode console`` as a subprocess, a GTP
    script on its standard input, three times: plain, with a think time
    limit, with think batches of 8. Every reply must be ``=``. Returns ms
    per ``genmove`` (the console's own ``Spent Time``) for each, first
    ``genmove`` apart (it pays for the first forward)."""
    script = "\n".join(CONSOLE_SCRIPT).format(ckpt=ckpt) + "\n"
    out = {}
    for label, extra in (("plain", ""), ("timed", f"actor_mcts_think_time_limit={CONSOLE_TIME_LIMIT}"),
                         ("think-batch", "actor_mcts_think_batch_size=8")):
        argv = [sys.executable, "-m", "minizero_tpu_torch", "-mode", "console",
                "-conf_file", cfg_path] + (["-conf_str", extra] if extra else [])
        t = time.perf_counter()
        proc = subprocess.run(argv, input=script, capture_output=True, text=True, timeout=600,
                              cwd=ROOT)
        seconds = time.perf_counter() - t
        if proc.returncode != 0:
            fail(f"console ({label}): exit {proc.returncode}: {proc.stderr[-2000:]}")
        replies = [r.strip() for r in proc.stdout.split("\n\n") if r.strip()]
        if len(replies) != len(CONSOLE_SCRIPT) or not all(r.startswith("=") for r in replies):
            fail(f"console ({label}): {len(replies)} replies, not all '=': {proc.stdout[-2000:]}")
        spent = [1e3 * float(x) for x in re.findall(r"Spent Time = ([0-9.]+) \(s\)", proc.stderr)]
        if len(spent) != 5:
            fail(f"console ({label}): {len(spent)} genmove times in its stderr")
        moves = [r.split(" ", 1)[1] for r in replies[4:9]]
        out[label] = {"first_ms": spent[0], "ms": float(np.mean(spent[1:])), "seconds": seconds,
                      "moves": moves}
    return out


def console_b1_check(cfg_path: str, ckpt: str) -> dict:
    """One console ``genmove`` in this process (``ConsoleActor``, B=1,
    float32) with each of its tree steps beside the plain version, and B1's
    numbers at B=1 from its kept state."""
    from minizero_tpu_torch.config import default_config
    from minizero_tpu_torch.console.gtp import ConsoleActor
    from minizero_tpu_torch.eval.match import load_checkpoint_variables

    cfg = default_config("go").load_file(cfg_path)
    actor = ConsoleActor(cfg, network=load_checkpoint_variables(ckpt, cfg))
    check = TreeStepCheck(keep_sim=cfg.actor_num_simulation // 2)
    actor.engine.tree_step = check
    actor.act(40)
    action, _ = actor.think()
    torch.cuda.synchronize()
    if check.calls != cfg.actor_num_simulation + 1 or actor.device.type != "cuda":
        fail(f"console genmove: {check.calls} tree steps checked on {actor.device}")
    k_ms, p_ms, bound_ms, bound_by, _, _, _ = tree_step_numbers(check.kept)
    return {"calls": check.calls, "err": check.max_abs_err, "action": action, "ms": k_ms,
            "plain_ms": p_ms, "bound_ms": bound_ms, "bound_by": bound_by}


def other_modes_phase(run_dir: str, cfg_path: str, zero_counts, counts) -> dict:
    """``-mode sp`` (the flagship config, B=1024, SP_GAMES records that
    ``parse_game`` reads back), ``-mode env_test`` on Go 9x9 and
    ``-mode zero_training_name``, each timed."""
    from minizero_tpu_torch.config import default_config
    from minizero_tpu_torch.selfplay.record import parse_game

    cfg = default_config("go").load_file(cfg_path)
    records = os.path.join(run_dir, "sp.sgf")
    zero_counts()
    _, sp_s = run_cli(["-mode", "sp", "-conf_file", cfg_path, "-num_games", str(SP_GAMES),
                       "-output", records])
    launches = counts()
    lines = open(records).read().splitlines()
    for i, line in enumerate(lines):
        tags, moves = parse_game(line, 82)
        if tags.get("GM") != "go_9x9" or tags.get("SZ") != "9" or not moves:
            fail(f"-mode sp: record {i} does not parse: {line[:200]}")
    chunk = cfg.zero_moves_per_dispatch * (cfg.actor_num_simulation + 1)
    if len(lines) != SP_GAMES or launches["tree_step"] == 0 or launches["tree_step"] % chunk:
        fail(f"-mode sp: {len(lines)} records (expected {SP_GAMES}), launches {launches}")
    text, env_s = run_cli(["-mode", "env_test", "-conf_str", "env_name=go"])
    if "replay determinism check passed" not in text:
        fail(f"-mode env_test: {text}")
    name, name_s = run_cli(["-mode", "zero_training_name", "-conf_file", cfg_path])
    if name.strip() != "go_9x9_gaz_1bx256_n16":
        fail(f"-mode zero_training_name printed {name!r}")
    return {"sp_s": sp_s, "sp_launches": launches["tree_step"], "sp_records": len(lines),
            "sp_mib": os.path.getsize(records) / 2**20, "env_test": text.strip().splitlines()[0],
            "env_s": env_s, "name": name.strip(), "name_s": name_s}


# ---------------------------------------------------------------------------
# phase 8: the tree steps past 384 actions, and the families Othello (with
# its trained net), NoGo, Kill-All-Go, Clobber, Gomoku and Hex at full width
# ---------------------------------------------------------------------------

# 8a: synthetic searches at these action counts and node counts; a shape
# whose [B, N, A] tree would pass 4 GB runs at B = WIDE_SMALL_BATCH (A=3040,
# N=201: 8 GB a tree at B=1024); an N=17 search is held against the plain
# version at every step, an N=201 one at WIDE_CHECKED_STEPS
WIDE_ACTIONS = (385, 801, 3040)
WIDE_NODES = (17, 201)
WIDE_TREE_BYTES = 4 << 30
WIDE_SMALL_BATCH = 256
WIDE_CHECKED_STEPS = (0, 1, 2, 100, 199, 200)
TRAINED_FAMILY_MOVES = 8  # Othello's and 2048's trained nets (8b, 9a)
# the untrained family paths (8c-8e, 9c-9e, 10d): 4 moves since the script
# passed 900 s with phase 11 (8 before)
FAMILY_MOVES = 4
CLOBBER_AZ_SIMS = 50
CLOBBER_AZ_MOVES = 4
OTHELLO_NPZ = os.path.join("minizero_tpu_torch", "assets", "oth8_gaz_r5_iter60000.npz")
OTHELLO_TRAINED_STEP = 60000
# phase 9: the trained 2048 net (runs/p2048_gmz_r5's last checkpoint), the
# cap on a whole game's moves (the JAX run's longest games took 266-279),
# the trained net's least edge over a seeded init in mean return, and the
# run's recipe for one zero iteration (512 games in lock-step, 200 SGD
# steps an iteration)
P2048_NPZ = os.path.join("minizero_tpu_torch", "assets", "p2048_gmz_r5_iter30000.npz")
WHOLE_GAME_CAP = 4000
TRAINED_EDGE = 1.5
P2048_GAMES = 512
P2048_STEPS = 200


def _tree_bytes(x) -> int:
    return sum(getattr(x, f.name).numel() * getattr(x, f.name).element_size()
               for f in dataclasses.fields(x) if getattr(x, f.name) is not None)


def _timing_reps(x) -> int:
    """Fresh copies a kernel timing can afford for a tree of this size."""
    return max(3, min(20, int((6 << 30) // max(_tree_bytes(x), 1))))


def wide_batch(a: int, n: int) -> int:
    return BATCH if BATCH * n * a * 13 <= WIDE_TREE_BYTES else WIDE_SMALL_BATCH


def wide_b1_case(a: int, n: int, regime: str, seed: int, zero_counts, counts,
                 keep: bool = False) -> dict:
    """A search of ``n - 1`` simulations at ``a`` actions on random leaves,
    every step on the tree step's wide kernel (B1), the checked steps
    beside the plain version: the board regime with the Gumbel root (m=16),
    or the reward regime with PUCT, leaf rewards, discount 0.997 and value
    rescale. Returns the case's numbers (and with ``keep`` the timed step's
    inputs under "kept")."""
    from minizero_tpu_torch.ops.tree_kernel import fused_tree_step
    from minizero_tpu_torch.search import gumbel as gz
    from minizero_tpu_torch.search import mcts

    board = regime == "board"
    b, sims = wide_batch(a, n), n - 1
    spec = mcts.SearchSpec(action_size=a, num_simulations=sims, use_gumbel=board,
                           use_gumbel_noise=False, use_dirichlet_noise=False,
                           gumbel_sample_size=16, flip_player2_value=board,
                           discount=1.0 if board else 0.997, value_rescale=not board,
                           init_q_average=not board)
    g = torch.Generator(device="cuda").manual_seed(seed)

    def leaf():
        logit = torch.randn((b, a), generator=g, device="cuda") * 2.0
        value = torch.rand((b,), generator=g, device="cuda") * 2.0 - 1.0
        return torch.softmax(logit, -1), logit, value

    turns = torch.ones((b,), dtype=torch.int32, device="cuda")
    zeros = torch.zeros((b,), dtype=torch.int32, device="cuda")
    legal = torch.ones((b, a), dtype=torch.bool, device="cuda")
    no_term = torch.zeros((b,), dtype=torch.bool, device="cuda")
    policy, logit, value = leaf()
    trees = mcts.init_tree(spec, turns)
    trees = mcts.expand_node(spec, trees, 0, zeros - 1, zeros, turns, policy, logit, legal, no_term)
    trees = mcts.backup(spec, trees, zeros, value, torch.zeros_like(value))
    if board:
        trees = gz.init_candidates(spec, trees)
    sel = mcts.empty_selection(spec, b, "cuda")
    checked = set(range(n)) if n <= 17 else set(WIDE_CHECKED_STEPS)
    check = TreeStepCheck(keep_sim=sims // 2 if n <= 17 else 100)
    torch.cuda.synchronize()
    zero_counts()
    for sim in range(n):
        policy, logit, value = leaf()
        reward = None if board or sim == 0 else torch.rand((b,), generator=g, device="cuda") - 0.5
        step = check if sim in checked else fused_tree_step
        trees, sel = step(spec, trees, sel, policy, logit, legal, no_term, value, turns, sim,
                          0 if sim == 0 else 1, leaf_reward=reward)
    torch.cuda.synchronize()
    launches = counts()
    key = "tree_step" if board else "tree_step_rewards"
    if launches[key] != n or sum(launches.values()) != n or check.calls != len(checked):
        fail(f"8a B1 A={a} N={n} {regime}: launches {launches}, {check.calls} checked")
    k_ms, p_ms, bound, bound_by, byts, _, depth = tree_step_numbers(check.kept,
                                                                    _timing_reps(check.kept[1]))
    del trees, sel
    return {"name": f"tree_step_wide A={a} N={n} {regime}", "kernel": key, "batch": b,
            "launches": n, "checked": check.calls, "err": check.max_abs_err, "ms": k_ms,
            "plain_ms": p_ms, "bound_ms": bound, "bound_by": bound_by, "bytes": byts,
            "depth": depth, **({"kept": check.kept} if keep else {})}


def wide_b2_case(a: int, n: int, seed: int, zero_counts, counts, keep: bool = False) -> dict:
    """A staged v2 search (capacity 65 -> 129 -> 201, or one stage below 65)
    of ``n - 1`` simulations at ``a`` actions on random leaves, a third of
    them terminal, every step on B2's wide kernel, the checked steps beside
    the plain version (with ``keep``, the timed step's inputs under
    "kept")."""
    from minizero_tpu_torch.ops import tree_kernel_v2 as tv2
    from minizero_tpu_torch.search import mcts

    b, sims = wide_batch(a, n), n - 1
    spec = mcts.SearchSpec(action_size=a, num_simulations=sims, use_gumbel=False,
                           flip_player2_value=True, init_q_average=False)
    g = torch.Generator(device="cuda").manual_seed(seed)

    def leaf():
        policy = torch.softmax(torch.randn((b, a), generator=g, device="cuda") * 3.0, -1)
        legal = torch.rand((b, a), generator=g, device="cuda") < 0.9
        legal[:, 0] = True
        terminal = torch.rand((b,), generator=g, device="cuda") < 0.3
        value = torch.rand((b,), generator=g, device="cuda") * 2.0 - 1.0
        turn = (1 + (torch.rand((b,), generator=g, device="cuda") < 0.5)).to(torch.int32)
        return policy, legal.contiguous(), terminal, value, turn

    policy, legal, _, value, _ = leaf()
    turns = torch.ones((b,), dtype=torch.int32, device="cuda")
    zeros = torch.zeros((b,), dtype=torch.int32, device="cuda")
    trees = mcts.init_tree(spec, turns)
    trees = mcts.expand_node(spec, trees, 0, zeros - 1, zeros, turns, policy, policy.log(), legal,
                             torch.zeros((b,), dtype=torch.bool, device="cuda"))
    trees = mcts.backup(spec, trees, zeros, value, torch.zeros_like(value))
    caps, c = [], 65
    while c < n:
        caps.append(c)
        c = (c - 1) * 2 + 1
    caps.append(n)
    packed = tv2.pack_trees(spec, trees, caps[0])
    sel = tv2.empty_selection_v2(spec, b, caps[0], "cuda")
    checked = set(range(n)) if n <= 17 else set(WIDE_CHECKED_STEPS)
    keep = sims // 2 if n <= 17 else 100
    check = TreeStepV2Check(keep_sims=[keep], check_sims=checked)
    torch.cuda.synchronize()
    zero_counts()
    cap_i = 0
    for sim in range(n):
        if sim >= caps[cap_i]:
            cap_i += 1
            packed = tv2.grow(packed, caps[cap_i])
            pad = torch.zeros((b, caps[cap_i] - sel.path.shape[1]), dtype=torch.bool, device="cuda")
            sel.path = torch.cat([sel.path, pad], dim=1)
        packed, sel = check(spec, packed, sel, *leaf(), sim, 0 if sim == 0 else 1)
    torch.cuda.synchronize()
    launches = counts()
    if launches["tree_step_v2"] != n or sum(launches.values()) != n or check.calls != len(checked):
        fail(f"8a B2 A={a} N={n}: launches {launches}, {check.calls} checked")
    kept = check.kept[keep]
    k_ms, p_ms, bound, bound_by, byts, _, depth = tree_step_v2_numbers(kept, _timing_reps(kept[1]))
    del packed, sel, trees
    return {"name": f"tree_step_v2_wide A={a} cap={n}", "kernel": "tree_step_v2", "batch": b,
            "launches": n, "checked": check.calls, "err": check.max_abs_err, "ms": k_ms,
            "plain_ms": p_ms, "bound_ms": bound, "bound_by": bound_by, "bytes": byts,
            "depth": depth, **({"kept": kept} if keep else {})}


def family_path(env_name: str, algo: str, over: dict, moves: int, seed: int, zero_counts, counts,
                state_dict=None) -> dict:
    """A family's self-play at full width (1 x 256, bf16, B=1024, a net
    from ``seed`` or ``state_dict``): one move with every tree step (and on
    the large-N loop every row gather) beside its plain version, one
    warm-up move, then ``move_scan`` of ``moves`` moves with every launch
    counter 0 just before and read just after, each action's legality,
    ms/move and env-steps/s; the tree step's time at the kept state. The
    checked move tells the tree step's regime: every step of a search on
    an env with rewards (2048, Tetris AlphaZero) runs B1', every other
    B1 (or B2); a MuZero engine's search takes the same tree step."""
    from minizero_tpu_torch.config import algorithm_preset, default_config
    from minizero_tpu_torch.envs import make_env
    from minizero_tpu_torch.models.factory import create_network, init_network
    from minizero_tpu_torch.ops.gather_rows import gather_rows
    from minizero_tpu_torch.ops.tree_kernel import fused_tree_step
    from minizero_tpu_torch.ops.tree_kernel_v2 import fused_tree_step_v2
    from minizero_tpu_torch.selfplay.engine import SelfPlayEngine

    cfg = default_config(env_name, **{**dict(algorithm_preset(algo)), **over})
    env = make_env(cfg)
    net = create_network(cfg, env.spec)
    if state_dict is None:
        init_network(net, seed=seed)
    else:
        net.load_state_dict(state_dict)
    engine = SelfPlayEngine(env, cfg, net, use_bf16=True, device="cuda", seed=seed)
    spec = engine.spec
    n = spec.num_simulations
    what = f"{env_name} {algo} n={n}"
    v2 = engine.use_tree_kernel_v2
    if v2:
        check, gcheck = TreeStepV2Check(keep_sims=[n // 2]), GatherCheck(keep_call=n // 2 - 1)
        engine.tree_step_v2, engine.gather_rows = check, gcheck
    else:
        check, gcheck = TreeStepCheck(keep_sim=n // 2), None
        engine.tree_step = check
    t = time.perf_counter()
    out = engine.move(engine.init_batch(BATCH))
    torch.cuda.synchronize()
    check_s = time.perf_counter() - t
    engine.tree_step, engine.tree_step_v2, engine.gather_rows = (fused_tree_step,
                                                                 fused_tree_step_v2, gather_rows)
    rewards = check.reward_calls == check.calls
    if (check.calls != n + 1 or check.reward_calls not in (0, check.calls)
            or (gcheck and gcheck.calls != n) or rewards != engine.env_rewards and not engine.is_muzero):
        fail(f"{what}: {check.calls} tree steps checked in a move ({check.reward_calls} in the "
             f"reward regime)")
    warm = engine.move(out.states)
    torch.cuda.synchronize()
    if hasattr(env, "benson_checks"):
        env.benson_checks = 0  # Kill-All-Go's host checks of Benson's fixpoint
    zero_counts()
    t = time.perf_counter()
    scan, end_states, _, _ = engine.move_scan(warm.states, num_moves=moves)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t
    launches = counts()
    if v2:
        want = {"tree_step": 0, "tree_step_rewards": 0, "tree_step_v2": moves * (n + 1),
                "gather_rows": moves * n, "gather_rows_aligned": moves * n}
    else:
        want = {"tree_step": 0, "tree_step_rewards": 0, "tree_step_v2": 0,
                "gather_rows": 0, "gather_rows_aligned": 0}
        want["tree_step_rewards" if rewards else "tree_step"] = moves * (n + 1)
    if launches != want:
        fail(f"{what}: launches {launches}, expected {want}")
    check_scan(engine, warm.states, scan, end_states, moves, what)
    res = {"what": what, "moves": moves, "A": spec.action_size, "N": spec.max_nodes,
           "host_checks": getattr(env, "benson_checks", None),
           "ms_per_move": 1e3 * elapsed / moves, "steps_per_s": BATCH * moves / elapsed,
           "launches": launches, "checked": check.calls, "err": check.max_abs_err,
           "check_s": check_s, "finished": int((scan.resigned | scan.ended).sum()),
           "cfg": cfg, "rewards": rewards, "kernel": "tree_step_rewards" if rewards else "tree_step"}
    if v2:
        kept = check.kept[n // 2]
        res["b2"] = tree_step_v2_numbers(kept, _timing_reps(kept[1]))
        res["b3_checked"], res["b3_err"] = gcheck.calls, gcheck.max_abs_err
        blob = engine._blob
        idx = gcheck.kept_idx
        from minizero_tpu_torch.ops.gather_rows import gather_rows_reference

        rows_idx = torch.arange(BATCH, device="cuda")
        k3 = time_events(lambda i: gather_rows(blob, idx), 50)
        p3 = time_events(lambda i: gather_rows_reference(blob, idx), 20, hold=False)
        l3 = time_events(lambda i: blob[rows_idx, idx.long()], 50)
        byts = BATCH * blob.shape[2] * 4 * 2 + BATCH * 4
        res["b3"] = (k3, p3, byts / HBM_BYTES_PER_S * 1e3, l3, blob.shape[2])
    else:
        res["b1"] = tree_step_numbers(check.kept, _timing_reps(check.kept[1]))
    del engine, net
    torch.cuda.empty_cache()
    return res


def family_line(r: dict) -> str:
    line = (f"{r['what']} (A={r['A']}, N={r['N']}, 1x256 bf16, B={BATCH}): first move's "
            f"{r['checked']} tree steps equal to the plain version (max |diff| {r['err']:.3g}; "
            f"{r['check_s']:.2f} s); move_scan {r['moves']} "
            f"moves: {r['ms_per_move']:.1f} ms/move, {r['steps_per_s']:.1f} env-steps/s, "
            f"launches {r['launches']}, all actions legal, {r['finished']} games finished")
    if "b1" in r:
        k, p, bound, by, byts, _, depth = r["b1"]
        b1 = "B1'" if r["rewards"] else "B1"
        line += (f"; {b1} {k:.5f} ms, plain {p:.3f} ms, bound {bound:.6f} ms ({by}, {byts} "
                 f"bytes), deepest walk {depth}")
    else:
        k, p, bound, by, byts, _, depth = r["b2"]
        k3, p3, b3, l3, width = r["b3"]
        line += (f"; B2 {k:.4f} ms, plain {p:.2f} ms, bound {bound:.6f} ms ({by}), deepest walk "
                 f"{depth}; B3 ({r['b3_checked']} gathers equal, {width}-word rows) {k3:.5f} ms, "
                 f"plain {p3:.4f} ms, x[arange(B), idx] {l3:.5f} ms, bound {b3:.6f} ms")
    return line


def othello_eval(cfg, trained: dict, zero_counts, counts) -> dict:
    """``-mode eval`` of the trained Othello net against a seeded random
    init: a run directory holding the init as ``weight_iter_0`` and the
    trained weights as ``weight_iter_60000`` (``ZeroLoop`` checkpoints),
    EVAL_GAMES games at B=1024; launch counters 0 just before and read just
    after."""
    from minizero_tpu_torch.zero.loop import ZeroLoop

    with tempfile.TemporaryDirectory(prefix="oth8_eval_") as run_dir:
        loop = ZeroLoop(cfg.replace(program_seed=21), run_dir)
        loop.save_checkpoint()
        loop.network.load_state_dict(trained)
        loop.state.step = OTHELLO_TRAINED_STEP
        loop.save_checkpoint()
        loop.close()
        del loop
        cfg_path = os.path.join(run_dir, "oth8.cfg")
        cfg.save_file(cfg_path)
        zero_counts()
        text, seconds = run_cli(["-mode", "eval", "-run_dir", run_dir, "-conf_file", cfg_path,
                                 "-num_games", str(EVAL_GAMES)])
        launches = counts()
        b1 = launches.pop("tree_step")
        sims = cfg.actor_num_simulation
        if b1 == 0 or b1 % ((sims + 1) * EVAL_PLIES_PER_CHECK) or any(launches.values()):
            fail(f"othello eval: {b1} B1 launches, others {launches}")
        rows = open(os.path.join(run_dir, "eval.csv")).read().splitlines()
        cells = dict(zip(rows[0].split(","), rows[1].split(","))) if len(rows) == 2 else {}
        wld = tuple(int(cells.get(k, -1)) for k in ("wins", "losses", "draws"))
        if sum(wld) != EVAL_GAMES or cells.get("new") != f"weight_iter_{OTHELLO_TRAINED_STEP}.ckpt":
            fail(f"othello eval: eval.csv holds {rows}")
    return {"line": text.strip(), "seconds": seconds, "plies": b1 // (sims + 1), "launches": b1,
            "wld": wld, "elo": float(cells["elo"])}


def phase8(zero_counts, counts) -> dict:
    """Phase 8 (see the module's docstring); returns the kernel rows and the
    paths' numbers."""
    from minizero_tpu_torch.config import algorithm_preset, default_config
    from minizero_tpu_torch.envs import make_env
    from minizero_tpu_torch.models.factory import create_network
    from minizero_tpu_torch.weights import from_jax_variables, load_variables_npz

    out = {"rows": [], "paths": {}}
    # ---- 8a. the wide kernels on synthetic trees ----------------------------
    for a in WIDE_ACTIONS:
        for n in WIDE_NODES:
            t = time.perf_counter()
            for case in (wide_b1_case(a, n, "board", 30 + a + n, zero_counts, counts),
                         wide_b1_case(a, n, "reward", 31 + a + n, zero_counts, counts),
                         wide_b2_case(a, n, 32 + a + n, zero_counts, counts)):
                out["rows"].append(case)
                log(f"phase 8a {case['name']} (B={case['batch']}): {case['checked']} of "
                    f"{case['launches']} steps equal to the plain version (max |diff| "
                    f"{case['err']:.3g}); {case['ms']:.5f} ms, plain {case['plain_ms']:.3f} ms, "
                    f"bound {case['bound_ms']:.6f} ms ({case['bound_by']}, {case['bytes']} "
                    f"bytes), deepest walk {case['depth']}")
            torch.cuda.empty_cache()
            log(f"phase 8a A={a} N={n} in {time.perf_counter() - t:.2f} s")

    # ---- 8b. Othello: the trained net, a zero iteration, eval --------------
    t = time.perf_counter()
    ocfg = default_config("othello", **algorithm_preset("gaz"))
    onet = create_network(ocfg, make_env(ocfg).spec)
    onet.load_state_dict(from_jax_variables(load_variables_npz(os.path.join(ROOT, OTHELLO_NPZ)),
                                            hidden_hw=64))
    trained = {k: v.clone() for k, v in onet.state_dict().items()}
    r = family_path("othello", "gaz", {}, TRAINED_FAMILY_MOVES, 40, zero_counts, counts, trained)
    out["paths"]["othello"] = r
    log(f"phase 8b {family_line(r)} (trained net {OTHELLO_NPZ})")
    oth_zero = zero_iteration("gaz", 41, zero_counts, counts, env_name="othello")
    log(f"phase 8b zero iteration (othello gaz n=16, 1x256, B={BATCH}, the runs/oth8_gaz_r5 "
        f"recipe at {ZERO_GAMES} games): {zero_line(oth_zero)}")
    out["paths"]["othello_zero"] = oth_zero
    ev = othello_eval(ocfg.replace(zero_num_parallel_games=BATCH), trained, zero_counts, counts)
    out["paths"]["othello_eval"] = ev
    log(f"phase 8b eval (-mode eval, othello gaz n=16, 1x256 bf16, {EVAL_GAMES} games at "
        f"B={BATCH}): {ev['line']} | trained iter {OTHELLO_TRAINED_STEP} against a seeded init: "
        f"W/L/D {'/'.join(map(str, ev['wld']))}, Elo {ev['elo']:.1f}; {ev['plies']} plies in "
        f"{ev['seconds']:.2f} s: {1e3 * ev['seconds'] / ev['plies']:.1f} ms/ply, "
        f"{EVAL_GAMES / ev['seconds']:.1f} games/s, B1 launches {ev['launches']}; phase in "
        f"{time.perf_counter() - t:.2f} s")
    if not ev["wld"][0] > ev["wld"][1]:
        fail(f"othello eval: the trained net did not beat the seeded init: {ev['wld']}")

    # ---- 8c-8e. NoGo, Kill-All-Go, Clobber, Gomoku and Hex ------------------
    for label, env_name, algo, over, moves, seed in (
            ("8c", "nogo", "gaz", {}, FAMILY_MOVES, 42),
            ("8c", "killallgo", "gaz", {"env_killallgo_use_seki": True}, FAMILY_MOVES, 43),
            ("8d", "clobber", "gaz", {}, FAMILY_MOVES, 44),
            ("8d", "clobber", "az", {"actor_num_simulation": CLOBBER_AZ_SIMS}, CLOBBER_AZ_MOVES, 45),
            ("8e", "gomoku", "gaz", {}, FAMILY_MOVES, 46),
            ("8e", "hex", "gaz", {}, FAMILY_MOVES, 47)):
        t = time.perf_counter()
        r = family_path(env_name, algo, over, moves, seed, zero_counts, counts)
        extra = ""
        if r["host_checks"] is not None:
            extra = (f"; Benson's fixpoint checked on the host {r['host_checks']} times over the "
                     f"scan ({r['host_checks'] / moves:.1f} a move, use_seki=True)")
        out["paths"][f"{env_name}_{algo}"] = r
        log(f"phase {label} {family_line(r)}{extra}; in {time.perf_counter() - t:.2f} s")
    return out


# ---------------------------------------------------------------------------
# phase 9: 2048 (its trained Gumbel MuZero net, a zero iteration, AlphaZero
# with the env's rewards in the tree), Tetris Block Puzzle on the wide
# kernel, and Rubik's, Connect6, Dots and Boxes, Breakthrough, ConHex and
# Havannah at full width
# ---------------------------------------------------------------------------

def whole_games(engine, states, what: str) -> dict:
    """Play every game of ``states`` to its end with ``engine.move`` (a
    finished game's slot keeps moving, unread): each game's return (its
    eval score when it ended) and length, and the wall time."""
    env = engine.env
    b = env.turn(states).shape[0]
    dev = engine.device
    done = env.is_terminal(states)
    returns = torch.where(done, env.eval_score(states), 0.0)
    lengths = torch.zeros((b,), dtype=torch.int32, device=dev)
    torch.cuda.synchronize()
    t = time.perf_counter()
    moves = 0
    while not bool(done.all()):
        if moves >= WHOLE_GAME_CAP:
            fail(f"{what}: {int((~done).sum())} games still running after {moves} moves")
        out = engine.move(states)
        moves += 1
        ended = out.done & ~done
        returns = torch.where(ended, out.eval_score, returns)
        lengths = torch.where(ended, moves, lengths)
        done |= out.done
        states = out.states
    torch.cuda.synchronize()
    r, n = returns.cpu().numpy(), lengths.cpu().numpy()
    if not (np.isfinite(r).all() and (r >= 0).all() and (n > 0).all()):
        fail(f"{what}: returns or lengths out of range")
    return {"mean": float(r.mean()), "min": float(r.min()), "max": float(r.max()),
            "len_mean": float(n.mean()), "len_min": int(n.min()), "len_max": int(n.max()),
            "moves": moves, "seconds": time.perf_counter() - t}


def games_line(g: dict) -> str:
    return (f"return mean {g['mean']:.1f} (min {g['min']:.0f}, max {g['max']:.0f}), length mean "
            f"{g['len_mean']:.1f} (min {g['len_min']}, max {g['len_max']}); {g['moves']} moves "
            f"in {g['seconds']:.2f} s")


def phase9(zero_counts, counts) -> dict:
    """Phase 9 (see the module's docstring); returns the paths' numbers."""
    from minizero_tpu_torch.config import algorithm_preset, default_config
    from minizero_tpu_torch.envs import make_env
    from minizero_tpu_torch.models.factory import create_network, init_network
    from minizero_tpu_torch.selfplay.engine import SelfPlayEngine
    from minizero_tpu_torch.weights import from_jax_muzero_variables, load_variables_npz

    out = {}
    # ---- 9a. 2048 gmz n=16 with the trained net ------------------------------
    t = time.perf_counter()
    cfg = default_config("puzzle2048", **algorithm_preset("gmz"))
    env = make_env(cfg)
    trained = create_network(cfg, env.spec)
    trained.load_state_dict(from_jax_muzero_variables(
        load_variables_npz(os.path.join(ROOT, P2048_NPZ)), hidden_hw=16))
    trained_sd = {k: v.clone() for k, v in trained.state_dict().items()}
    r = family_path("puzzle2048", "gmz", {}, TRAINED_FAMILY_MOVES, 50, zero_counts, counts,
                    trained_sd)
    out["puzzle2048_gmz"] = r
    log(f"phase 9a {family_line(r)} (trained net {P2048_NPZ}, value rescale "
        f"{r['cfg'].actor_mcts_value_rescale}; the board-game MuZero net has no reward head, "
        f"so the search runs B1's board regime)")
    seeded = init_network(create_network(cfg, env.spec), seed=51)
    played = {}
    for label, net in (("trained", trained), ("seeded init", seeded)):
        engine = SelfPlayEngine(env, cfg, net, use_bf16=True, device="cuda", seed=52)
        start = engine.init_batch(BATCH, torch.Generator(device="cuda").manual_seed(53))
        played[label] = whole_games(engine, start, f"2048 whole games ({label})")
        del engine
        log(f"phase 9a whole games (2048 gmz n=16, {label} net, {BATCH} games from the same "
            f"initial boards): {games_line(played[label])}")
    out["puzzle2048_games"] = played
    edge = played["trained"]["mean"] / max(played["seeded init"]["mean"], 1e-9)
    if not edge >= TRAINED_EDGE:
        fail(f"2048: the trained net's mean return is {edge:.2f}x the seeded init's "
             f"(< {TRAINED_EDGE})")
    log(f"phase 9a trained / seeded mean return {edge:.2f} (>= {TRAINED_EDGE}); in "
        f"{time.perf_counter() - t:.2f} s")
    del trained, seeded
    torch.cuda.empty_cache()

    # ---- 9b. one 2048 zero iteration at runs/p2048_gmz_r5's recipe ---------
    t = time.perf_counter()
    z = zero_iteration("gmz", 54, zero_counts, counts, env_name="puzzle2048", games=P2048_GAMES,
                       steps=P2048_STEPS, parallel=P2048_GAMES)
    res = np.asarray(z["results"])
    out["puzzle2048_zero"] = z
    log(f"phase 9b zero iteration (2048 gmz n=16, 1x256, the runs/p2048_gmz_r5 recipe: "
        f"{P2048_GAMES} games in lock-step, {P2048_STEPS} SGD steps; records parsed back with "
        f"their rewards): {zero_line(z)}; returns mean {res.mean():.1f} (min {res.min():.0f}, "
        f"max {res.max():.0f}); phase in {time.perf_counter() - t:.2f} s")

    # ---- 9c-9e. 2048 gaz, Tetris, and the rest of group 3 ------------------
    for label, env_name, algo, over, seed in (
            ("9c", "puzzle2048", "gaz", {}, 55),
            ("9d", "tetrisblockpuzzle", "gmz", {}, 56),
            ("9d", "tetrisblockpuzzle", "gaz", {}, 57),
            ("9e", "rubiks", "gaz", {}, 58),
            ("9e", "connect6", "gaz", {}, 59),
            ("9e", "dotsandboxes", "gaz", {}, 60),
            ("9e", "breakthrough", "gaz", {}, 61),
            ("9e", "conhex", "gaz", {}, 62),
            ("9e", "havannah", "gaz", {}, 63)):
        t = time.perf_counter()
        r = family_path(env_name, algo, over, FAMILY_MOVES, seed, zero_counts, counts)
        out[f"{env_name}_{algo}"] = r
        log(f"phase {label} {family_line(r)}; in {time.perf_counter() - t:.2f} s")
    return out


# ---------------------------------------------------------------------------
# phase 10: Atari over the host env (runs/atari_gmz_r5_b128's widths), and
# group 5 (Lines of Action, Surakarta, Santorini, Amazons)
# ---------------------------------------------------------------------------

# runs/atari_gmz_r5_b128 (scripts/run_atari_gmz.py:28-55): Gumbel MuZero
# n=18, 128 games in lock-step on FakeALE(length=900), 128 sequences and
# 200 SGD steps at batch 128 an iteration, OBS records, a replay window of 7
# iterations (its frames fit the card: learner/frame_window.py)
ATARI_HOST_BATCH = 128
ATARI_FAKE_LENGTH = 900
ATARI_RING_CHECKS = 10
ATARI_TIMED_MOVES = 32
ATARI_FORCED_RESETS = 8
ATARI_ZERO_STEPS = 200
ATARI_ZERO_BATCH = 128
ATARI_REPLAY = 7
ATARI_SAMPLED = 256
ATARI_OBS_CHECKED = 16  # records whose OBS tag is held against the window's rows
ATARI_SP_BATCH = 32
ATARI_SP_LENGTH = 200  # -mode sp's episodes: 50 moves each, one terminal record
GROUP5 = (("linesofaction", 80), ("surakarta", 81), ("santorini", 82), ("amazons", 83))


def _fake_ale(seed: int):
    from minizero_tpu_torch.envs.atari import FakeALE

    return FakeALE(seed=seed, length=ATARI_FAKE_LENGTH)


def atari_cfg(seed: int, **over):
    from minizero_tpu_torch.config import algorithm_preset, default_config

    base = dict(algorithm_preset("gmz", is_atari=True))
    base.update(zero_num_parallel_games=ATARI_HOST_BATCH,
                zero_num_games_per_iteration=ATARI_HOST_BATCH,
                learner_training_step=ATARI_ZERO_STEPS, learner_training_display_step=100,
                learner_batch_size=ATARI_ZERO_BATCH, zero_actor_record_observations=True,
                zero_replay_buffer=ATARI_REPLAY, zero_end_iteration=1, program_seed=seed,
                program_auto_seed=False)
    base.update(over)
    return default_config("atari", **base)


def atari_host_selfplay(zero_counts, counts) -> dict:
    """10a: the host engine at the r5 widths (bf16). The first move runs
    every B1' launch beside its plain version; on the first
    ATARI_RING_CHECKS moves, and on a move after ATARI_FORCED_RESETS
    episodes are ended and reset, the card ring's stack must equal
    ``AtariVecEnv.features_u8`` byte for byte and its f32 action planes the
    ids / 18; then ATARI_TIMED_MOVES moves with every launch counter 0 just
    before and read just after, split into the search (the engine's move
    without its env step) and the host (env step and collector)."""
    from minizero_tpu_torch.envs.atari import AtariVecEnv
    from minizero_tpu_torch.models.factory import create_network, init_network
    from minizero_tpu_torch.ops.tree_kernel import fused_tree_step
    from minizero_tpu_torch.selfplay.host_engine import (
        AtariTrajectoryCollector, HostSelfPlayEngine)

    cfg = atari_cfg(70)
    vec = AtariVecEnv(ATARI_HOST_BATCH, seed=70, ale_factory=_fake_ale)
    net = init_network(create_network(cfg, vec.spec), seed=70)
    engine = HostSelfPlayEngine(vec, cfg, net, use_bf16=True, device="cuda", seed=71)
    collector = AtariTrajectoryCollector(cfg, vec.spec, ATARI_HOST_BATCH)
    spec = engine.search_spec
    n = spec.num_simulations
    rows = np.arange(ATARI_HOST_BATCH)

    def checked_move(what):
        want = vec.features_u8().reshape(ATARI_HOST_BATCH, 96, 96, 8, 4)
        ids = np.stack([e._action_history for e in vec.envs])  # f32 id / 18
        legal = vec.legal_masks()
        out = engine.move()
        # the ring's RGB planes before the 1/255 scaling, byte for byte
        got = engine._ring.permute(0, 2, 3, 1, 4).cpu().numpy()
        if not np.array_equal(got, want[..., 1:]):
            fail(f"Atari host engine, {what}: the card ring's stack differs from "
                 f"AtariVecEnv.features_u8 ({int((got != want[..., 1:]).sum())} bytes)")
        planes = engine.features()[..., 0::4].cpu().numpy()
        if not (np.array_equal(planes, np.broadcast_to(ids[:, None, None, :], planes.shape))
                and np.array_equal(np.clip(planes * 255.0, 0, 255).astype(np.uint8),
                                   want[..., 0])):
            fail(f"Atari host engine, {what}: the action planes are not the ids / 18")
        if not legal[rows, out.action].all():
            fail(f"Atari host engine, {what}: an illegal action")
        return out

    check = TreeStepCheck(keep_sim=n // 2)
    engine.search.tree_step = check
    t = time.perf_counter()
    out = checked_move("move 1")
    engine.search.tree_step = fused_tree_step
    check_s = time.perf_counter() - t
    if check.calls != n + 1 or check.reward_calls != n + 1:
        fail(f"Atari host engine: {check.calls} tree steps checked in a move "
             f"({check.reward_calls} in the reward regime), expected {n + 1} B1'")
    collector.add_moves(out)
    for m in range(2, ATARI_RING_CHECKS + 1):  # the warm-up moves
        collector.add_moves(checked_move(f"move {m}"))
    env_s = 0.0
    vec_step = vec.step

    def timed_step(actions):
        nonlocal env_s
        ts = time.perf_counter()
        r = vec_step(actions)
        env_s += time.perf_counter() - ts
        return r

    vec.step = timed_step
    move_s = collect_s = 0.0
    torch.cuda.synchronize()
    zero_counts()
    t = time.perf_counter()
    for _ in range(ATARI_TIMED_MOVES):
        tm = time.perf_counter()
        out = engine.move()
        move_s += time.perf_counter() - tm
        tc = time.perf_counter()
        _, reset = collector.add_moves(out)
        if reset:
            vec.reset_done()
        collect_s += time.perf_counter() - tc
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t
    launches = counts()
    vec.step = vec_step
    want = {"tree_step": 0, "tree_step_rewards": ATARI_TIMED_MOVES * (n + 1), "tree_step_v2": 0,
            "gather_rows": 0, "gather_rows_aligned": 0}
    if launches != want:
        fail(f"Atari host engine: launches {launches}, expected {want}")
    if not (np.isfinite(out.root_value).all() and np.isfinite(out.policy_target).all()):
        fail("Atari host engine: root values or policy targets not finite")
    # end some episodes now (their FakeALE frame counters at the length):
    # the next move zeroes their slots of the ring
    for e in vec.envs[:ATARI_FORCED_RESETS]:
        e.ale.frame = e.ale.length
    reset = vec.reset_done()
    if reset != list(range(ATARI_FORCED_RESETS)):
        fail(f"Atari host engine: reset slots {reset}")
    checked_move("the move after reset_done")
    return {"cfg": cfg, "n": n, "A": spec.action_size, "N": spec.max_nodes,
            "checked": check.calls, "err": check.max_abs_err, "check_s": check_s,
            "ring_checks": ATARI_RING_CHECKS + 1, "ms_per_move": 1e3 * elapsed / ATARI_TIMED_MOVES,
            "search_ms": 1e3 * (move_s - env_s) / ATARI_TIMED_MOVES,
            "env_ms": 1e3 * env_s / ATARI_TIMED_MOVES,
            "collect_ms": 1e3 * collect_s / ATARI_TIMED_MOVES, "launches": launches,
            "b1": tree_step_numbers(check.kept)}


def _rebuilt_stack(rec, pos: int) -> np.ndarray:
    """``rebuild_features_from_frames`` at one position of a record (its
    lead history included): the 9 frames up to it are enough."""
    from minizero_tpu_torch.envs.atari import rebuild_features_from_frames

    lead = rec.frame_lead
    acts = np.concatenate([np.asarray(rec.lead_actions if rec.lead_actions is not None else [],
                                      np.int32), rec.actions])
    p = lead + pos
    s = max(0, p - 8)
    return rebuild_features_from_frames(rec.frames[s:p + 1], acts[s:p + 1])[-1]


def atari_zero_iteration(zero_counts, counts) -> dict:
    """10b: one iteration of ``ZeroLoop.run`` at runs/atari_gmz_r5_b128's
    recipe: the frame window on the card, records with OBS tags parsed back
    and equal to the window's rows, ATARI_SAMPLED sampled stacks assembled
    on the card equal to the host's rebuild, SGD ms/step and one profiled
    step's idle share, then a fresh loop's ``resume`` (checkpoint, buffer,
    window)."""
    from minizero_tpu_torch.selfplay.record import game_record_from_string
    from minizero_tpu_torch.tools.obs import unpack_observations
    from minizero_tpu_torch.zero.loop import ZeroLoop, _to_device

    cfg = atari_cfg(72)
    what = "Atari zero iteration"
    out = {}
    with tempfile.TemporaryDirectory(prefix="zero_atari_") as run_dir:
        loop = ZeroLoop(cfg, run_dir, ale_factory=_fake_ale)
        fw = loop.frame_window
        if not (fw.on_device and fw.frames.device.type == "cuda"):
            fail(f"{what}: the frame window is not on the card")
        out["window_gb"], out["window_rows"] = fw.nbytes / 1e9, fw.rows
        n = loop.engine.search_spec.num_simulations
        timer = StepTimer(loop._train_step, SGD_TIMED_FROM, ATARI_ZERO_STEPS)
        loop._train_step = timer
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t = time.perf_counter()
        loop.run()
        torch.cuda.synchronize()
        out["wall_s"] = time.perf_counter() - t
        launches = counts()
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        timing = dict(loop.last_selfplay_timing)
        moves = timing["moves"]
        want = {"tree_step": 0, "tree_step_rewards": moves * (n + 1), "tree_step_v2": 0,
                "gather_rows": 0, "gather_rows_aligned": 0}
        if launches != want:
            fail(f"{what}: launches {launches}, expected {want} ({moves} moves)")
        (row,) = [json.loads(x) for x in open(os.path.join(run_dir, "perf.jsonl"))]
        lines = open(os.path.join(run_dir, "sgf", "1.sgf")).read().splitlines()
        games = cfg.zero_num_games_per_iteration
        if len(lines) != games or len(loop.buffer) != games:
            fail(f"{what}: {len(lines)} records, {len(loop.buffer)} in the buffer, expected {games}")
        # the first records' OBS against the window's rows here; resume below
        # parses every record and holds its frames against the buffer's
        for i, (line, rec) in enumerate(zip(lines[:ATARI_OBS_CHECKED], loop.buffer.games)):
            tags, parsed = game_record_from_string(line, 18)
            if not all(k in tags for k in ("SD", "LL", "OBS")):
                fail(f"{what}: record {i} lacks an SD, LL or OBS tag")
            frames = unpack_observations(tags["OBS"])
            e = fw._games.get(id(rec))
            if e is None:
                fail(f"{what}: record {i} is not in the frame window")
            rows = fw.frames[e["base"] + e["lead"]:e["base"] + e["lead"] + rec.length].cpu().numpy()
            if not (np.array_equal(parsed.actions, rec.actions) and np.array_equal(frames, rows)
                    and np.array_equal(frames, rec.frames[rec.frame_lead:])):
                fail(f"{what}: record {i}'s actions or OBS frames differ from the buffer's or "
                     f"the window's")
        sample = loop.buffer.sample_muzero(ATARI_SAMPLED, np.random.RandomState(73))
        idx = sample["sampled_index"]
        recs = [loop.buffer.games[g] for g in idx[:, 0]]
        got = fw.assemble(fw.lookup(recs, idx[:, 1])).cpu().numpy()
        for j, (rec, pos) in enumerate(zip(recs, idx[:, 1])):
            if not np.array_equal(got[j], _rebuilt_stack(rec, int(pos))):
                fail(f"{what}: sampled stack {j} differs from rebuild_features_from_frames")
        out["leads"] = sum(r.frame_lead > 0 for r in recs)

        def one_step():
            b = loop.buffer.sample_muzero(ATARI_ZERO_BATCH, loop.np_rng)
            si = b.pop("sampled_index")
            batch = _to_device(b, loop.device)
            batch["features"] = fw.assemble(fw.lookup([loop.buffer.games[g] for g in si[:, 0]],
                                                      si[:, 1]))
            timer.fn(loop.state, batch, loop.generator)

        out["profile"], _ = profile_run(one_step, timer.ms_per_step(), what="SGD step")
        path = loop.save_checkpoint()
        out["ckpt_mib"] = os.path.getsize(path) / 2**20
        fresh = ZeroLoop(cfg, run_dir, ale_factory=_fake_ale)
        t = time.perf_counter()
        start = fresh.resume()
        torch.cuda.synchronize()
        out["resume_s"] = time.perf_counter() - t
        if not (start == 1 and fresh.state.step == loop.state.step
                and same_tensors(loop.network.state_dict(), fresh.network.state_dict())):
            fail(f"{what}: resume did not reload the checkpoint")
        if len(fresh.buffer) != games or not all(
                r in fresh.frame_window and np.array_equal(r.frames, a.frames[a.frame_lead:])
                and np.array_equal(r.actions, a.actions)
                for r, a in zip(fresh.buffer.games, loop.buffer.games)):
            fail(f"{what}: resume did not rebuild the buffer and the window from the records")
        lengths = np.asarray([r.length for r in loop.buffer.games])
        out["obs_records"] = lines[:OBS_RECOVERED]
        out.update(cfg=cfg, games=games, moves=moves, launches=launches["tree_step_rewards"],
                   selfplay_s=row["selfplay_s"], optimize_s=row["optimize_s"], timing=timing,
                   ms_per_step=timer.ms_per_step(), len_min=int(lengths.min()),
                   len_max=int(lengths.max()),
                   returns=float(np.mean([r.result for r in loop.buffer.games])),
                   record_mib=os.path.getsize(os.path.join(run_dir, "sgf", "1.sgf")) / 2**20)
        loop.close()
        fresh.close()
        del loop, fresh
    torch.cuda.empty_cache()
    return out


def atari_sp_mode(zero_counts, counts) -> dict:
    """10c: ``run_selfplay_host`` (``-mode sp`` on Atari) at B=32 over
    FakeALE episodes of ATARI_SP_LENGTH frames: 32 records with SD, LL and
    OBS tags that parse back."""
    from minizero_tpu_torch.envs.atari import FakeALE
    from minizero_tpu_torch.__main__ import run_selfplay_host
    from minizero_tpu_torch.selfplay.record import game_record_from_string
    from minizero_tpu_torch.tools.obs import unpack_observations

    cfg = atari_cfg(74, zero_num_parallel_games=ATARI_SP_BATCH)
    with tempfile.TemporaryDirectory(prefix="sp_atari_") as d:
        path = os.path.join(d, "atari.sgf")
        zero_counts()
        t = time.perf_counter()
        run_selfplay_host(cfg, ATARI_SP_BATCH, path,
                          ale_factory=lambda s: FakeALE(seed=s, length=ATARI_SP_LENGTH))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        launches = counts()["tree_step_rewards"]
        lines = open(path).read().splitlines()
        if len(lines) != ATARI_SP_BATCH:
            fail(f"-mode sp (Atari): {len(lines)} records, expected {ATARI_SP_BATCH}")
        for i, line in enumerate(lines):
            tags, rec = game_record_from_string(line, 18)
            if not all(k in tags for k in ("SD", "LL", "OBS")) or len(tags["LL"]) != rec.length:
                fail(f"-mode sp (Atari): record {i} lacks an SD, LL or OBS tag")
            if unpack_observations(tags["OBS"]).shape != (rec.length, 96, 96, 3):
                fail(f"-mode sp (Atari): record {i}'s OBS frames do not match its moves")
        mib = os.path.getsize(path) / 2**20
    return {"records": len(lines), "seconds": seconds, "launches": launches, "mib": mib,
            "length": rec.length}


def phase10(zero_counts, counts) -> dict:
    """Phase 10 (see the module's docstring); returns the paths' numbers."""
    out = {}
    t = time.perf_counter()
    a = atari_host_selfplay(zero_counts, counts)
    out["atari_host"] = a
    k, p, bound, by, byts, _, depth = a["b1"]
    log(f"phase 10a Atari host self-play (gmz n={a['n']}, A={a['A']}, N={a['N']}, the r5 net "
        f"widths {a['cfg'].nn_num_blocks}x{a['cfg'].nn_num_hidden_channels} bf16, "
        f"B={ATARI_HOST_BATCH}, FakeALE length {ATARI_FAKE_LENGTH}): first move's {a['checked']} "
        f"B1' steps equal to the plain version (max |diff| {a['err']:.3g}; {a['check_s']:.2f} s); "
        f"{a['ring_checks']} moves with the card ring's stack byte-equal to features_u8 (the "
        f"last after {ATARI_FORCED_RESETS} resets); {ATARI_TIMED_MOVES} moves: "
        f"{a['ms_per_move']:.1f} ms/move (search {a['search_ms']:.1f}, host env step "
        f"{a['env_ms']:.1f}, collector {a['collect_ms']:.2f}), launches {a['launches']}; B1' "
        f"{k:.5f} ms, plain {p:.3f} ms, bound {bound:.6f} ms ({by}, {byts} bytes), deepest walk "
        f"{depth}; in {time.perf_counter() - t:.2f} s")
    t = time.perf_counter()
    z = atari_zero_iteration(zero_counts, counts)
    out["atari_zero"] = z
    tm = z["timing"]
    log(f"phase 10b Atari zero iteration (runs/atari_gmz_r5_b128's recipe: {z['games']} "
        f"sequences at B={ATARI_HOST_BATCH}, {ATARI_ZERO_STEPS} SGD steps at batch "
        f"{ATARI_ZERO_BATCH}, zero_replay_buffer={ATARI_REPLAY}, OBS on): frame window on the "
        f"card, {z['window_rows']} rows = {z['window_gb']:.3f} GB; self-play {z['moves']} moves "
        f"in {z['selfplay_s']:.2f} s ({z['games'] / z['selfplay_s']:.2f} records/s; search and "
        f"env {tm['search_s']:.2f} s, records {tm['records_s']:.2f} s; record lengths "
        f"{z['len_min']}-{z['len_max']}, returns mean {z['returns']:.1f}); B1' launches "
        f"{z['launches']} (= {z['moves']} x {z['launches'] // max(z['moves'], 1)}); "
        f"{z['games']} records ({z['record_mib']:.1f} MiB), the first {ATARI_OBS_CHECKED} parsed "
        f"back with OBS equal to the window's rows; {ATARI_SAMPLED} sampled stacks ({z['leads']} in continuation chunks) assembled on "
        f"the card equal to rebuild_features_from_frames; optimize {z['optimize_s']:.2f} s, "
        f"{z['ms_per_step']:.3f} ms/step = {1e3 / z['ms_per_step']:.1f} SGD steps/s (CUDA "
        f"events, steps {SGD_TIMED_FROM}-{ATARI_ZERO_STEPS}); checkpoint {z['ckpt_mib']:.2f} MiB; "
        f"resume (checkpoint, buffer and window from the OBS tags) {z['resume_s']:.2f} s; "
        f"iteration wall {z['wall_s']:.2f} s; peak device memory {z['peak_gib']:.2f} GiB; one "
        f"profiled SGD step: {z['profile']}; phase in {time.perf_counter() - t:.2f} s")
    t = time.perf_counter()
    s = atari_sp_mode(zero_counts, counts)
    out["atari_sp"] = s
    log(f"phase 10c run_selfplay_host (-mode sp, Atari gmz n=18, B={ATARI_SP_BATCH}): "
        f"{s['records']} records of {s['length']} moves ({s['mib']:.1f} MiB) with SD, LL and OBS "
        f"parsed back in {s['seconds']:.2f} s; B1' launches {s['launches']}")
    for env_name, seed in GROUP5:
        t = time.perf_counter()
        r = family_path(env_name, "gaz", {}, FAMILY_MOVES, seed, zero_counts, counts)
        out[f"{env_name}_gaz"] = r
        log(f"phase 10d {family_line(r)}; in {time.perf_counter() - t:.2f} s")
    return out


# ---------------------------------------------------------------------------
# phase 11: the tools and the data-parallel zero loop
# ---------------------------------------------------------------------------

OBS_RECOVERED = 16  # phase 10b's records stripped of OBS and recovered
PROFILE_MOVES = 8
PROFILE_TRAIN_STEPS = 20
DP_GAMES_NCCL = 256  # 11c: games in lock-step on one NCCL rank
DP_STEPS_NCCL = 50
DP_GAMES_GLOO = 128  # 11d: games a rank, two gloo ranks on the card
DP_STEPS_GLOO = 20
DP_BATCH_GLOO = 256  # the global batch of 11d
TP_STEPS = 20  # 11e: SGD steps of the dp 1 x mp 2 run (its games are 11c's)
DP_TIMEOUT = 300
PHASE5_BUSY_MS = (34.3, 34.5)  # PERF.md §5: one gaz move's device busy time
B1_PERF_MS = 0.0076  # PERF.md §6: B1 at sim 8, B=1024

# one rank of ``-mode zero -multi_device`` under torch.distributed.run:
# joins the group with the backend asked for (or the CLI's default), runs the
# CLI, then writes what the rank ended with: its flat parameters, its B1
# launches, its moves and the group it ran in
DP_RANK_SCRIPT = r"""
import os, sys
sys.path.insert(0, sys.argv[1])
import torch
import torch.distributed as dist
from minizero_tpu_torch.__main__ import main
from minizero_tpu_torch.ops.tree_kernel import fused_tree_step
from minizero_tpu_torch.parallel.distributed import init_distributed
import minizero_tpu_torch.zero.loop as zero_loop
backend, out_dir, argv = sys.argv[2], sys.argv[3], sys.argv[4:]
if backend != "default":
    init_distributed(backend=backend)
loops = []
run = zero_loop.ZeroLoop.run
zero_loop.ZeroLoop.run = lambda self: (loops.append(self), run(self))[1]
rc = main(argv)
loop = loops[0]
torch.cuda.synchronize()
timing = loop.last_selfplay_timing
torch.save({"rc": rc, "rank": loop.pid, "world": loop.num_procs, "backend": dist.get_backend(),
            "device": str(loop.device), "launches": fused_tree_step.launches,
            "moves": timing["chunks"] * timing["moves_per_chunk"],
            "flat": torch.cat([p.detach().reshape(-1) for p in loop.network.parameters()]).cpu()},
           os.path.join(out_dir, f"rank{loop.pid}.pt"))
dist.destroy_process_group()
print(f"RANK_{loop.pid}_DONE", flush=True)
"""


# one of two gloo ranks of a dp 1 x mp 2 zero loop on the card: the dense
# heads split over mp (there is no CLI flag for mp, as in JAX; the mesh is
# built in code, as __graft_entry__.py's dry run builds its own), then
# writes what the rank ended with: its local head shapes, its whole weights
# (gathered) and self-play's, its B1 launches and moves
TP_RANK_SCRIPT = r"""
import json, os, sys
sys.path.insert(0, sys.argv[1])
import torch
import torch.distributed as dist
from minizero_tpu_torch.config import default_config
from minizero_tpu_torch.ops.tree_kernel import fused_tree_step
from minizero_tpu_torch.parallel.distributed import init_distributed
from minizero_tpu_torch.parallel.mesh import make_mesh, whole_state
from minizero_tpu_torch.zero.loop import ZeroLoop
out_dir, run_dir, over = sys.argv[2], sys.argv[3], json.loads(sys.argv[4])
init_distributed(backend="gloo")
mesh = make_mesh(model_parallel=2)
loop = ZeroLoop(default_config("go", **over), run_dir, mesh=mesh)
fused_tree_step.launches = 0
loop.run()
whole, _ = whole_state(mesh, loop.network)
torch.cuda.synchronize()
timing = loop.last_selfplay_timing
cpu = lambda sd: {k: v.cpu() for k, v in sd.items()}
torch.save({"rank": mesh.rank, "coords": (mesh.dp_rank, mesh.mp_rank, mesh.dp, mesh.mp),
            "backend": dist.get_backend(), "device": str(loop.device),
            "shapes": {k: tuple(v.shape) for k, v in loop.network.state_dict().items()},
            "launches": fused_tree_step.launches,
            "moves": timing["chunks"] * timing["moves_per_chunk"],
            "whole": cpu(whole), "play": cpu(loop.play_network.state_dict())},
           os.path.join(out_dir, f"rank{mesh.rank}.pt"))
dist.destroy_process_group()
print(f"RANK_{mesh.rank}_DONE", flush=True)
"""


def tools_phase(gaz_dir: str, atari_records, games: int = ZERO_GAMES) -> dict:
    """11a: the analysis parsers, the plots (or their skip line) and the SGF
    conversion on phase 6's gaz run; ``-mode remove_obs`` on phase 10b's
    first records, then ``recover_obs_file`` with an ``AtariObsReplayer``
    over FakeALE: every recovered OBS tag equal to the stripped one."""
    from minizero_tpu_torch.__main__ import main as cli
    from minizero_tpu_torch.tools.analysis import analysis, parse_op_log, parse_training_log
    from minizero_tpu_torch.tools.obs import AtariObsReplayer, recover_obs_file
    from minizero_tpu_torch.tools.to_sgf import convert_file

    what = "tools"
    out = {}
    tl = parse_training_log(os.path.join(gaz_dir, "Training.log"))
    if tl.get("iteration") != [1] or not all(len(tl.get(k, [])) == 1 for k in (
            "sp_time_s", "length_avg", "return_avg", "op_time_s")):
        fail(f"{what}: parse_training_log of the gaz run gave {dict(tl)}")
    op_lines = open(os.path.join(gaz_dir, "op.log")).read().splitlines()
    logged = [re.search(r"nn step (\d+), lr: \S+\. (.*)", ln) for ln in op_lines]
    op = parse_op_log(os.path.join(gaz_dir, "op.log"))
    if op.get("step") != [int(m.group(1)) for m in logged] or not op_lines:
        fail(f"{what}: parse_op_log's steps {op.get('step')} are not the op.log lines'")
    for key in ("loss", "loss_policy", "loss_value", "accuracy_policy"):
        want = [float(dict(kv.split(": ") for kv in re.findall(r"\w+: \S+", m.group(2)))[key])
                for m in logged]
        if op.get(key) != want:
            fail(f"{what}: parse_op_log's {key} differs from the op.log lines")
    out["iterations"], out["op_steps"] = tl["iteration"], op["step"]
    train_log = open(os.path.join(gaz_dir, "Training.log")).read()
    try:
        import matplotlib  # noqa: F401
        written = analysis(gaz_dir)
        if not written or not all(os.path.getsize(f) > 0 for f in written):
            fail(f"{what}: analysis wrote {written}")
        out["plots"] = f"{len(written)} PNGs"
    except ImportError:
        if train_log.count("[Analysis] skipped:") != 1:
            fail(f"{what}: no matplotlib, and Training.log lacks its one [Analysis] skipped line")
        out["plots"] = "matplotlib absent: one [Analysis] skipped line in Training.log"
    with tempfile.TemporaryDirectory(prefix="tools_") as d:
        sgf = os.path.join(d, "gaz.sgf")
        t = time.perf_counter()
        n = convert_file(os.path.join(gaz_dir, "sgf", "1.sgf"), sgf)
        out["sgf_s"] = time.perf_counter() - t
        lines = open(sgf).read().splitlines()
        if n != games or len(lines) != n or not all(
                ln.startswith("(;FF[4]GM[1]SZ[9]") for ln in lines):
            fail(f"{what}: convert_file gave {n} records, {len(lines)} lines")
        out["sgf"] = n
        with_obs = os.path.join(d, "atari.sgf")
        with open(with_obs, "w") as f:
            f.write("".join(ln + "\n" for ln in atari_records))
        stripped, recovered = with_obs + ".noobs", with_obs + ".obs"
        t = time.perf_counter()
        text, _ = run_cli(["-mode", "remove_obs", "-input", with_obs, "-output", stripped])
        out["remove_s"] = time.perf_counter() - t
        kept = open(stripped).read().splitlines()
        if f"stripped OBS from {len(atari_records)} records" not in text or any(
                "OBS[" in ln for ln in kept) or len(kept) != len(atari_records):
            fail(f"{what}: -mode remove_obs: {text.strip()}")
        t = time.perf_counter()
        n = recover_obs_file(stripped, recovered, AtariObsReplayer(ale_factory=_fake_ale))
        out["recover_s"] = time.perf_counter() - t
        back = open(recovered).read().splitlines()
        tag = re.compile(r"OBS\[([0-9a-f]*)\]")
        for i, (a, b) in enumerate(zip(atari_records, back)):
            if tag.search(b) is None or tag.search(a).group(1) != tag.search(b).group(1):
                fail(f"{what}: record {i}'s recovered OBS differs from the stripped one")
        if n != len(atari_records) or len(back) != n:
            fail(f"{what}: recover_obs_file handled {n} of {len(atari_records)} records")
        out["obs"] = n
        out["obs_mib"] = sum(len(tag.search(a).group(1)) for a in atari_records) / 2**20
    return out


def profile_phase(zero_counts, counts) -> dict:
    """11b: ``tools/profile.py`` at the flagship's widths with a trace,
    then ``tools/trace_report.py`` on the steady self-play window: B1's
    launches there exactly 17 a move, its mean time and the window's device
    time a move."""
    from minizero_tpu_torch.config import algorithm_preset, default_config
    from minizero_tpu_torch.tools import profile, trace_report

    what = "profile"
    over = dict(algorithm_preset("gaz"))
    over.update(learner_batch_size=ZERO_BATCH, program_seed=31)
    cfg = default_config("go", **over)
    with tempfile.TemporaryDirectory(prefix="trace_") as trace_dir:
        zero_counts()
        t = time.perf_counter()
        rows = profile.profile_selfplay(cfg, moves=PROFILE_MOVES, batch=BATCH, trace_dir=trace_dir,
                                        train_steps=PROFILE_TRAIN_STEPS)
        seconds = time.perf_counter() - t
        launches = counts()
        per_move = cfg.actor_num_simulation + 1
        if launches["tree_step"] != per_move * (PROFILE_MOVES + 1):
            fail(f"{what}: launches {launches}, expected {per_move} x {PROFILE_MOVES + 1} moves")
        phases = {r["phase"]: r for r in rows}
        if sorted(phases) != ["selfplay_compile", "selfplay_steady", "train_compile",
                              "train_steady"]:
            fail(f"{what}: phases {sorted(phases)}")
        t = time.perf_counter()
        sp_trace = os.path.join(trace_dir, profile.SELFPLAY_TRACE)
        by_op, total_us = trace_report.aggregate(sp_trace)
        by_source, _ = trace_report.aggregate(sp_trace, by="source")
        train_rows, train_us = trace_report.aggregate(os.path.join(trace_dir, profile.TRAIN_TRACE))
        report_s = time.perf_counter() - t
        b1 = [(k, us, c) for k, us, c in by_op if "tree_step_kernel<" in k]
        b1_count = sum(c for _, _, c in b1)
        if b1_count != per_move * PROFILE_MOVES:
            fail(f"{what}: the trace's steady window has {b1_count} B1 launches, expected "
                 f"{per_move} x {PROFILE_MOVES}: {b1}")
        trace_mib = sum(os.path.getsize(os.path.join(trace_dir, f))
                        for f in os.listdir(trace_dir)) / 2**20
    return {"rows": rows, "seconds": seconds, "b1_launches": b1_count,
            "b1_ms": sum(us for _, us, _ in b1) / 1e3 / b1_count,
            "device_ms_per_move": total_us / 1e3 / PROFILE_MOVES,
            "steady_ms_per_move": 1e3 * phases["selfplay_steady"]["seconds"] / PROFILE_MOVES,
            "train_device_ms_per_step": train_us / 1e3 / PROFILE_TRAIN_STEPS,
            "train_ms_per_step": 1e3 * phases["train_steady"]["seconds"] / PROFILE_TRAIN_STEPS,
            "top": by_op[:5], "top_source": by_source[:5], "train_top": train_rows[:3],
            "report_s": report_s, "trace_mib": trace_mib}


def data_parallel_run(nproc: int, backend: str, games_per_rank: int, steps: int,
                      batch: int) -> dict:
    """``-mode zero -multi_device`` for one flagship iteration (gaz n=16,
    1 x 256) under ``python -m torch.distributed.run --standalone
    --nproc_per_node=nproc``, the ranks on this card; checks each rank's
    record shard, the checkpoint, the hosts line, the B1 launches of each
    rank, and that every rank ends with bitwise the same parameters."""
    from minizero_tpu_torch.config import algorithm_preset

    what = f"-multi_device ({nproc} rank(s), {backend})"
    over = dict(algorithm_preset("gaz"))
    over.update(zero_num_parallel_games=games_per_rank * nproc,
                zero_num_games_per_iteration=games_per_rank * nproc,
                learner_batch_size=batch, learner_training_step=steps,
                learner_training_display_step=10, zero_end_iteration=1, program_seed=41)
    conf = "env_name=go:" + ":".join(f"{k}={v}" for k, v in over.items())
    with tempfile.TemporaryDirectory(prefix="dp_") as d:
        script = os.path.join(d, "rank.py")
        with open(script, "w") as f:
            f.write(DP_RANK_SCRIPT)
        run_dir = os.path.join(d, "run")
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               f"--nproc_per_node={nproc}", script, ROOT, backend, d, "-mode", "zero",
               "-multi_device", "-run_dir", run_dir, "-conf_str", conf]
        t = time.perf_counter()
        try:
            proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                                  timeout=DP_TIMEOUT)
        except subprocess.TimeoutExpired as e:
            fail(f"{what}: no end within {DP_TIMEOUT} s: {(e.stdout or '')[-3000:]}")
        seconds = time.perf_counter() - t
        if proc.returncode != 0:
            fail(f"{what}: exit {proc.returncode}:\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        ranks = [torch.load(os.path.join(d, f"rank{r}.pt"), weights_only=False)
                 for r in range(nproc)]
        for r, rk in enumerate(ranks):
            want_backend = "nccl" if backend == "default" else backend
            if (rk["rc"], rk["rank"], rk["world"], rk["backend"]) != (0, r, nproc, want_backend):
                fail(f"{what}: rank {r} ran as {rk}")
            if rk["launches"] != rk["moves"] * 17 or rk["moves"] == 0:
                fail(f"{what}: rank {r}: {rk['launches']} B1 launches over {rk['moves']} moves")
            if not torch.equal(rk["flat"], ranks[0]["flat"]):
                fail(f"{what}: rank {r}'s parameters differ from rank 0's")
        shards = sorted(os.listdir(os.path.join(run_dir, "sgf")))
        want_shards = sorted(["1.sgf"] + [f"1.p{r}.sgf" for r in range(1, nproc)])
        if shards != want_shards:
            fail(f"{what}: record shards {shards}, expected {want_shards}")
        for name in shards:
            lines = open(os.path.join(run_dir, "sgf", name)).read().splitlines()
            if len(lines) != games_per_rank or not all(ln.startswith("(;GM[go")
                                                       for ln in lines):
                fail(f"{what}: {name} holds {len(lines)} records, expected {games_per_rank}")
        ckpts = sorted(os.listdir(os.path.join(run_dir, "model")))
        if ckpts != ["weight_iter_0.ckpt", f"weight_iter_{steps}.ckpt"]:
            fail(f"{what}: checkpoints {ckpts}")
        saved = torch.load(os.path.join(run_dir, "model", f"weight_iter_{steps}.ckpt"),
                           map_location="cpu", weights_only=True)["model"]
        flat = torch.cat([v.reshape(-1).float() for k, v in saved.items()
                          if not k.endswith(("running_mean", "running_var", "num_batches_tracked"))])
        if not torch.equal(flat, ranks[0]["flat"].float()):
            fail(f"{what}: the checkpoint is not the ranks' final parameters")
        logs = ["Training.log"] + [f"Training.p{r}.log" for r in range(1, nproc)]
        lines = [ln for ln in open(os.path.join(run_dir, "Training.log"))
                 if f"games/s, {nproc} hosts)" in ln]
        if len(lines) != 1 or not all(os.path.exists(os.path.join(run_dir, x)) for x in logs):
            fail(f"{what}: no one '({nproc} hosts)' line, or a rank's log is missing")
        perf = json.loads(open(os.path.join(run_dir, "perf.jsonl")).readline())
        return {"seconds": seconds, "hosts_line": lines[0].split("] ", 1)[1].strip(),
                "moves": [rk["moves"] for rk in ranks],
                "launches": [rk["launches"] for rk in ranks], "selfplay_s": perf["selfplay_s"],
                "optimize_s": perf["optimize_s"], "params": ranks[0]["flat"].numel(),
                "devices": [rk["device"] for rk in ranks],
                "records": open(os.path.join(run_dir, "sgf", "1.sgf")).read()}


def tensor_parallel_run(games: int, steps: int, batch: int) -> dict:
    """11e: one flagship iteration (gaz n=16, 1 x 256, value hidden 256) of
    ``ZeroLoop(cfg, run_dir, mesh=make_mesh(model_parallel=2))``, dp 1 x mp
    2, as two gloo ranks on the card under ``torch.distributed.run``, with
    11c's self-play settings and seed. Checks each rank's local head shapes
    (the policy layer 82 -> 41 a rank, the hidden value layer 256 -> 128,
    the scalar value layer whole), its B1 launches, that both ranks end
    with bitwise the same whole weights and self-play's network equal to
    them, that rank 0 alone wrote the run's files, and that the checkpoint
    is the one-process format: it loads into a plain network, equal to the
    ranks' whole weights. Returns the record file for the comparison with
    11c's."""
    from minizero_tpu_torch.config import algorithm_preset, default_config
    from minizero_tpu_torch.envs import make_env
    from minizero_tpu_torch.models.factory import create_network

    what = "dp 1 x mp 2 (two gloo ranks)"
    over = dict(algorithm_preset("gaz"))
    over.update(zero_num_parallel_games=games, zero_num_games_per_iteration=games,
                learner_batch_size=batch, learner_training_step=steps,
                learner_training_display_step=10, zero_end_iteration=1, program_seed=41)
    with tempfile.TemporaryDirectory(prefix="tp_") as d:
        script = os.path.join(d, "rank.py")
        with open(script, "w") as f:
            f.write(TP_RANK_SCRIPT)
        run_dir = os.path.join(d, "run")
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc_per_node=2", script, ROOT, d, run_dir, json.dumps(over)]
        t = time.perf_counter()
        try:
            proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                                  timeout=DP_TIMEOUT)
        except subprocess.TimeoutExpired as e:
            fail(f"{what}: no end within {DP_TIMEOUT} s: {(e.stdout or '')[-3000:]}")
        seconds = time.perf_counter() - t
        if proc.returncode != 0:
            fail(f"{what}: exit {proc.returncode}:\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        ranks = [torch.load(os.path.join(d, f"rank{r}.pt"), weights_only=False) for r in range(2)]
        heads = {"policy_head.fc.weight": (41, 2 * 81), "value_head.fc1.weight": (128, 81),
                 "value_head.fc2.weight": (1, 256)}
        for r, rk in enumerate(ranks):
            if (rk["rank"], rk["coords"], rk["backend"]) != (r, (0, r, 1, 2), "gloo") or not \
                    rk["device"].startswith("cuda"):
                fail(f"{what}: rank {r} ran as {rk['coords']} on {rk['device']} ({rk['backend']})")
            shapes = {k: rk["shapes"][k] for k in heads}
            if shapes != heads:
                fail(f"{what}: rank {r}'s local heads {shapes}, expected {heads}")
            if rk["launches"] != rk["moves"] * 17 or rk["moves"] == 0:
                fail(f"{what}: rank {r}: {rk['launches']} B1 launches over {rk['moves']} moves")
            if not same_tensors(rk["whole"], ranks[0]["whole"]):
                fail(f"{what}: rank {r}'s whole weights differ from rank 0's")
            if not same_tensors(rk["play"], rk["whole"]):
                fail(f"{what}: rank {r}'s self-play network is not its gathered weights")
        files = sorted(os.path.relpath(os.path.join(p, f), run_dir)
                       for p, _, fs in os.walk(run_dir) for f in fs)
        want_files = sorted(["Training.log", "op.log", "perf.jsonl", os.path.join("sgf", "1.sgf"),
                             os.path.join("model", "weight_iter_0.ckpt"),
                             os.path.join("model", f"weight_iter_{steps}.ckpt")])
        if [f for f in files if not f.startswith("analysis")] != want_files:
            fail(f"{what}: the run wrote {files}, expected rank 0's {want_files}")
        records = open(os.path.join(run_dir, "sgf", "1.sgf")).read()
        if len(records.splitlines()) != games:
            fail(f"{what}: {len(records.splitlines())} records, expected {games}")
        cfg = default_config("go", **over)
        net = create_network(cfg, make_env(cfg).spec)
        t = time.perf_counter()
        saved = torch.load(os.path.join(run_dir, "model", f"weight_iter_{steps}.ckpt"),
                           map_location="cpu", weights_only=True)
        net.load_state_dict(saved["model"])  # strict: the one-process names and shapes
        load_s = time.perf_counter() - t
        if not same_tensors(net.state_dict(), ranks[0]["whole"]):
            fail(f"{what}: the checkpoint loaded into a plain network is not the ranks' weights")
        line = [ln for ln in open(os.path.join(run_dir, "Training.log"))
                if "games/s, 1 hosts)" in ln]
        if len(line) != 1:
            fail(f"{what}: no one '(1 hosts)' line in Training.log")
        perf = json.loads(open(os.path.join(run_dir, "perf.jsonl")).readline())
    return {"seconds": seconds, "hosts_line": line[0].split("] ", 1)[1].strip(),
            "moves": [rk["moves"] for rk in ranks], "launches": [rk["launches"] for rk in ranks],
            "selfplay_s": perf["selfplay_s"], "optimize_s": perf["optimize_s"],
            "devices": [rk["device"] for rk in ranks], "records": records, "load_s": load_s}


def phase11(gaz_dir: str, atari_records, zero_counts, counts) -> dict:
    """Phase 11 (see the module's docstring); returns its numbers."""
    out = {}
    t = time.perf_counter()
    a = tools_phase(gaz_dir, atari_records)
    out["tools"] = a
    log(f"phase 11a tools: parse_training_log of phase 6's gaz run: iterations {a['iterations']}; "
        f"parse_op_log: {len(a['op_steps'])} nn step lines equal to op.log's; plots: "
        f"{a['plots']}; to_sgf.convert_file: {a['sgf']} records as (;FF[4]GM[1]SZ[9] lines in "
        f"{a['sgf_s']:.2f} s; -mode remove_obs on {a['obs']} of phase 10b's records "
        f"({a['obs_mib']:.1f} MiB of OBS) in {a['remove_s']:.2f} s, recover_obs_file with "
        f"AtariObsReplayer over FakeALE in {a['recover_s']:.2f} s: every OBS tag equal to the "
        f"stripped one; in {time.perf_counter() - t:.2f} s")
    t = time.perf_counter()
    p = profile_phase(zero_counts, counts)
    out["profile"] = p
    log("phase 11b tools/profile.py (gaz n=16, 1x256 bf16, B=" + str(BATCH)
        + f", {PROFILE_MOVES} steady moves, {PROFILE_TRAIN_STEPS} SGD steps at batch "
        f"{ZERO_BATCH}, -trace_dir): " + " ".join(json.dumps(r) for r in p["rows"])
        + f"; trace_report of the steady self-play window ({p['trace_mib']:.1f} MiB of traces, "
        f"read in {p['report_s']:.2f} s): B1 {p['b1_launches']} launches (= 17 x "
        f"{PROFILE_MOVES}), mean {p['b1_ms']:.5f} ms (PERF.md: {B1_PERF_MS} ms); device time "
        f"{p['device_ms_per_move']:.2f} ms a move of {p['steady_ms_per_move']:.1f} ms under the "
        f"profiler (phase 5 busy {PHASE5_BUSY_MS[0]}-{PHASE5_BUSY_MS[1]} ms); SGD device "
        f"{p['train_device_ms_per_step']:.2f} ms a step of {p['train_ms_per_step']:.2f} ms; top "
        f"kernels: " + "; ".join(f"{k[:50]} {us / 1e3:.2f} ms x{c}" for k, us, c in p["top"])
        + "; by source: " + "; ".join(f"{k[:40]} {us / 1e3:.2f} ms x{c}"
                                      for k, us, c in p["top_source"])
        + f"; in {time.perf_counter() - t:.2f} s")
    # 11c, 11d and 11e run at the same time: five host-bound processes on
    # the card and on separate cores (11c and 11d each alone took 58-69 s,
    # mostly start-up and ~176 host-bound moves)
    from concurrent.futures import ThreadPoolExecutor

    runs = (("nccl1", 1, "default", DP_GAMES_NCCL, DP_STEPS_NCCL, ZERO_BATCH),
            ("gloo2", 2, "gloo", DP_GAMES_GLOO, DP_STEPS_GLOO, DP_BATCH_GLOO))
    t = time.perf_counter()
    with ThreadPoolExecutor(len(runs) + 1) as pool:
        futures = [pool.submit(data_parallel_run, *args[1:]) for args in runs]
        tp_future = pool.submit(tensor_parallel_run, DP_GAMES_NCCL, TP_STEPS, ZERO_BATCH)
        done = [f.result() for f in futures]  # a failed check's exit comes through here
        tp = tp_future.result()
    log(f"phase 11c, 11d and 11e side by side in {time.perf_counter() - t:.2f} s")
    if tp["records"] != done[0]["records"]:
        fail("phase 11e: the dp 1 x mp 2 run's records differ from 11c's one process's, "
             "same seed and games")
    for (key, nproc, backend, games, steps, batch), r in zip(runs, done):
        out[key] = r
        log(f"phase 11{'c' if nproc == 1 else 'd'} -mode zero -multi_device under "
            f"torch.distributed.run --nproc_per_node={nproc} ({backend if nproc > 1 else 'nccl'}"
            f"; ranks on {', '.join(r['devices'])}; gaz n=16, 1x256, {games} games a rank in "
            f"lock-step, {steps} SGD steps at global batch {batch}): '{r['hosts_line']}'; record "
            f"shards, one checkpoint from rank 0 equal to every rank's {r['params']} parameters "
            f"(bitwise equal across ranks); B1 launches {r['launches']} = 17 x moves "
            f"{r['moves']}; self-play {r['selfplay_s']:.2f} s, optimize {r['optimize_s']:.2f} s; "
            f"command {r['seconds']:.2f} s (beside the other runs)")
        r.pop("records")
    out["tp2"] = tp
    log(f"phase 11e ZeroLoop(mesh=make_mesh(model_parallel=2)) under torch.distributed.run "
        f"--nproc_per_node=2 (gloo; ranks on {', '.join(tp['devices'])}; gaz n=16, 1x256, value "
        f"hidden 256, dp 1 x mp 2: policy 82 -> 41 and value hidden 256 -> 128 rows a rank; "
        f"{DP_GAMES_NCCL} games in lock-step, {TP_STEPS} SGD steps at batch {ZERO_BATCH}): "
        f"'{tp['hosts_line']}'; {DP_GAMES_NCCL} records equal to 11c's one process's byte for "
        f"byte; rank 0 alone wrote the run's files; the checkpoint loads into a plain network "
        f"({tp['load_s']:.2f} s) equal to both ranks' gathered weights (bitwise equal across "
        f"ranks, and to self-play's network); B1 launches {tp['launches']} = 17 x moves "
        f"{tp['moves']}; self-play {tp['selfplay_s']:.2f} s, optimize {tp['optimize_s']:.2f} s; "
        f"command {tp['seconds']:.2f} s (beside 11c and 11d)")
    tp.pop("records")
    return out


# ---------------------------------------------------------------------------
# phase 12: the README's strength protocol at n=800
# ---------------------------------------------------------------------------

# scripts/n800_pair.py:47-52 and scripts/elo_curve.py:16: 800 simulations,
# the most visited action, no noise, eval mode, 4 uniform opening plies,
# min(games, 96) games in lock-step; each path plays N800_PLIES searched
# plies after the openings
N800_PROTOCOL = ("actor_num_simulation=800:actor_select_action_by_count=true:"
                 "actor_select_action_by_softmax_count=false:actor_use_dirichlet_noise=false:"
                 "actor_use_gumbel_noise=false")
N800_BATCH = 96
N800_OPENING_PLIES = 4
N800_PLIES = 4
# the first searched ply's tree steps at these simulations run beside the
# plain version (a plain step on an 801-node tree is slow); those at
# N800_TIMED_SIMS are kept and timed
N800_CHECKED_SIMS = (0, 1, 2, 100, 400, 800)
N800_TIMED_SIMS = (100, 400, 800)


class SimsChecked(TreeStepCheck):
    """B1 for phase 12: the tree steps of simulations ``check_sims`` beside
    the plain version, copies of those at ``keep_sims`` kept
    (``kept_at[sim]``); every other step runs the kernel alone."""

    def __init__(self, check_sims, keep_sims):
        super().__init__(-1)
        self.check_sims, self.keep_sims = set(check_sims), set(keep_sims)
        self.kept_at = {}

    def __call__(self, spec, trees, sel, *rest, leaf_reward=None):
        node_idx = rest[-2]
        if node_idx not in self.check_sims:
            return self.kernel(spec, trees, sel, *rest, leaf_reward=leaf_reward)
        self.keep_sim, self.kept = (node_idx if node_idx in self.keep_sims else -1), None
        out = super().__call__(spec, trees, sel, *rest, leaf_reward=leaf_reward)
        if self.kept is not None:
            self.kept_at[node_idx] = self.kept
        return out


def n800_path(algo: str, net_a, net_b, seed: int, zero_counts, counts) -> dict:
    """One path of the protocol: net A (Player 1) against net B in two eval
    engines (bf16, as ``play_match`` builds them), ``N800_BATCH`` games from
    ``N800_OPENING_PLIES`` uniform plies (``eval.match._random_openings``),
    then ``N800_PLIES`` plies, each one search by the mover's engine, the
    games' finished flags and scores kept as ``play_match`` keeps them. The
    first searched ply runs its tree steps at ``N800_CHECKED_SIMS`` (and on
    the large-N loop every row gather) beside the plain versions; the launch
    counters are 0 just before the searched plies and read just after."""
    from minizero_tpu_torch.config import algorithm_preset, default_config
    from minizero_tpu_torch.envs import make_env
    from minizero_tpu_torch.envs.base import select_states
    from minizero_tpu_torch.eval.match import _random_openings
    from minizero_tpu_torch.ops.gather_rows import gather_rows
    from minizero_tpu_torch.ops.tree_kernel import fused_tree_step
    from minizero_tpu_torch.ops.tree_kernel_v2 import fused_tree_step_v2
    from minizero_tpu_torch.selfplay.engine import SelfPlayEngine

    cfg = default_config("go", **algorithm_preset(algo)).load_string(N800_PROTOCOL)
    cfg = cfg.replace(zero_num_parallel_games=N800_BATCH)
    env = make_env(cfg)
    eng_a = SelfPlayEngine(env, cfg, net_a, eval_mode=True, device="cuda", seed=seed)
    eng_b = SelfPlayEngine(env, cfg, net_b, eval_mode=True, device="cuda", seed=seed + 1)
    spec = eng_a.spec
    n = spec.num_simulations
    v2 = eng_a.use_tree_kernel_v2
    if (n, spec.max_nodes, spec.action_size) != (800, 801, 82) or spec.use_dirichlet_noise \
            or spec.use_gumbel_noise or not spec.select_by_count or v2 != (algo == "az"):
        fail(f"n=800 {algo}: spec {spec}, large-N loop {v2}")
    what = f"{algo} n={n}"
    gen = torch.Generator(device="cuda").manual_seed(seed)
    states = eng_a.init_batch(N800_BATCH, gen)
    states = _random_openings(env, states, N800_OPENING_PLIES,
                              torch.Generator(device="cuda").manual_seed(seed * 1_000_003))
    if v2:
        check = TreeStepV2Check(keep_sims=N800_TIMED_SIMS, check_sims=set(N800_CHECKED_SIMS))
        gcheck = GatherCheck(keep_call=n - 1)
        eng_a.tree_step_v2, eng_a.gather_rows = check, gcheck
    else:
        check, gcheck = SimsChecked(N800_CHECKED_SIMS, N800_TIMED_SIMS), None
        eng_a.tree_step = check
    done = torch.zeros((N800_BATCH,), dtype=torch.bool, device="cuda")
    score = torch.zeros((N800_BATCH,), dtype=torch.float32, device="cuda")
    movers = (eng_a, eng_b)
    ply_s = []
    torch.cuda.synchronize()
    zero_counts()
    for ply in range(N800_PLIES):
        legal = env.legal_mask(states)
        t = time.perf_counter()
        out = movers[(ply + N800_OPENING_PLIES) % 2].move(states, 1.0, gen)
        torch.cuda.synchronize()
        ply_s.append(time.perf_counter() - t)
        if ply == 0:
            eng_a.tree_step, eng_a.tree_step_v2, eng_a.gather_rows = (
                fused_tree_step, fused_tree_step_v2, gather_rows)
        rows = torch.arange(N800_BATCH, device="cuda")
        if not bool((legal[rows, out.action.long()] | done).all()):
            fail(f"{what}: an illegal action at ply {ply}")
        states = select_states(done, states, out.states)
        score = torch.where(done, score, out.eval_score)
        done = done | out.done
    launches = counts()
    if v2:
        want = {"tree_step": 0, "tree_step_rewards": 0, "tree_step_v2": N800_PLIES * (n + 1),
                "gather_rows": N800_PLIES * n, "gather_rows_aligned": N800_PLIES * n}
        ok = check.calls == len(N800_CHECKED_SIMS) and 801 in check.caps and gcheck.calls == n \
            and gcheck.aligned_calls == n
    else:
        want = {"tree_step": N800_PLIES * (n + 1), "tree_step_rewards": 0, "tree_step_v2": 0,
                "gather_rows": 0, "gather_rows_aligned": 0}
        ok = check.calls == len(N800_CHECKED_SIMS) and not check.reward_calls
    if launches != want or not ok:
        fail(f"{what}: launches {launches}, expected {want}; {check.calls} tree steps checked")
    outcome = score[done].cpu().numpy()
    wld = (int((outcome > 0).sum()), int((outcome < 0).sum()), int((outcome == 0).sum()))
    res = {"what": what, "launches": launches, "checked": check.calls, "err": check.max_abs_err,
           "first_ply_s": ply_s[0], "ms_per_ply": 1e3 * sum(ply_s[1:]) / (N800_PLIES - 1),
           "launches_per_ply": {k: v // N800_PLIES for k, v in launches.items() if v},
           "wld": wld, "running": N800_BATCH - int(done.sum()), "timed": {}}
    for sim in N800_TIMED_SIMS:
        if v2:
            kept = check.kept[sim]
            res["timed"][sim] = (*tree_step_v2_numbers(kept, _timing_reps(kept[1])),
                                 kept[1].visits.shape[1])
        else:
            kept = check.kept_at[sim]
            res["timed"][sim] = (*tree_step_numbers(kept, _timing_reps(kept[1])),
                                 kept[1].visits.shape[1])
    res["warm_selection_ms"] = warm_selection_ms(
        check.kept[N800_TIMED_SIMS[-1]] if v2 else check.kept_at[N800_TIMED_SIMS[-1]])
    if v2:
        from minizero_tpu_torch.ops.gather_rows import gather_rows_reference
        from minizero_tpu_torch.ops.state_blob import blob_spec

        blob, idx = eng_a._blob, gcheck.kept_idx
        rows_idx = torch.arange(N800_BATCH, device="cuda")
        state_w = blob_spec(states).width
        byts = 2 * int((idx >= 0).sum()) * state_w * 4 + N800_BATCH * 4
        res["b3"] = (time_events(lambda i: gather_rows(blob, idx), 50),
                     time_events(lambda i: gather_rows_reference(blob, idx), 20, hold=False),
                     byts / HBM_BYTES_PER_S * 1e3,
                     time_events(lambda i: blob[rows_idx, idx.long()], 50),
                     tuple(blob.shape), state_w)
        res["b3_checked"], res["b3_err"] = gcheck.calls, gcheck.max_abs_err
    del eng_a, eng_b
    torch.cuda.empty_cache()
    return res


def n800_line(r: dict) -> str:
    w, l, d = r["wld"]
    line = (f"{r['what']} (go 9x9, 1x256 bf16, B={N800_BATCH}, {N800_OPENING_PLIES} opening "
            f"plies): {N800_PLIES} plies, the first in {r['first_ply_s']:.2f} s ({r['checked']} "
            f"tree steps at sims {list(N800_CHECKED_SIMS)} beside the plain version, max |diff| "
            f"{r['err']:.3g}), then {r['ms_per_ply']:.1f} ms/ply; launches {r['launches']} "
            f"({r['launches_per_ply']} a ply); finished W/L/D {w}/{l}/{d} of the first net, "
            f"{r['running']} running")
    kernel = "B2" if "b3" in r else "B1"
    for sim, (k, p, bound, by, byts, _, depth, cap) in r["timed"].items():
        line += (f"; {kernel} at sim {sim} ({'cap' if kernel == 'B2' else 'N'} {cap}, deepest "
                 f"next path {depth}): {k:.4f} ms, plain {p:.2f} ms, bound {bound:.6f} ms ({by}, "
                 f"{byts} bytes)")
    line += f"; selection only, warm, at sim {N800_TIMED_SIMS[-1]}: {r['warm_selection_ms']:.4f} ms"
    if "b3" in r:
        k3, p3, b3, l3, shape, state_w = r["b3"]
        line += (f"; B3 ({r['b3_checked']} gathers equal, blob {list(shape)}, state {state_w} "
                 f"words) {k3:.5f} ms, plain {p3:.4f} ms, x[arange(B), idx] {l3:.5f} ms, bound "
                 f"{b3:.6f} ms")
    return line


def phase12(zero_counts, counts) -> dict:
    """12a az n=800: the trained ``runs/go9_az200_r3b`` net (iteration 25000,
    ``minizero_tpu_torch/assets/``) against a seeded init, the pair of
    ``runs/go9_az200_r3b.n800_pair.log``; 12b gaz n=800: two seeded inits.
    Returns each path's numbers and its three kernel rows."""
    from minizero_tpu_torch.config import algorithm_preset, default_config
    from minizero_tpu_torch.envs import make_env
    from minizero_tpu_torch.models.factory import create_network, init_network
    from minizero_tpu_torch.weights import from_jax_variables, load_variables_npz

    out = {}
    for key, algo, seed in (("az", "az", 120), ("gaz", "gaz", 121)):
        cfg = default_config("go", **algorithm_preset(algo))
        spec = make_env(cfg).spec
        net_a = create_network(cfg, spec)
        if algo == "az":
            net_a.load_state_dict(from_jax_variables(
                load_variables_npz(os.path.join(ROOT, TRAINED_NPZ)), hidden_hw=81))
        else:
            init_network(net_a, seed=seed + 1000)
        net_b = init_network(create_network(cfg, spec), seed=seed)
        t = time.perf_counter()
        out[key] = n800_path(algo, net_a, net_b, seed, zero_counts, counts)
        log(f"phase 12{'a' if algo == 'az' else 'b'} {n800_line(out[key])}; in "
            f"{time.perf_counter() - t:.2f} s")
    az, gaz = out["az"], out["gaz"]

    def row(name, source, replaces, launches, err, numbers, library_ms=None):
        k, p, bound, by = numbers[:4]
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "max_abs_err": err, "ms": k, "plain_ms": p,
                "bound_ms": bound, "bound_by": by, "library_ms": library_ms}

    last = N800_TIMED_SIMS[-1]
    out["rows"] = [
        row(f"tree_step (gaz n=800, N=801, A=82, B={N800_BATCH})",
            "minizero_tpu_torch/csrc/tree_step.cu", "minizero_tpu/ops/tree_kernel.py:136",
            gaz["launches"]["tree_step"], gaz["err"], gaz["timed"][last]),
        row("tree_step_v2 (az n=800, cap 801)", "minizero_tpu_torch/csrc/tree_step_v2.cu",
            "minizero_tpu/ops/tree_kernel_v2.py:240", az["launches"]["tree_step_v2"], az["err"],
            az["timed"][last]),
        row("gather_rows (az n=800, 801 rows)", "minizero_tpu_torch/csrc/gather_rows.cu",
            "minizero_tpu/ops/gather_rows.py:33", az["launches"]["gather_rows"], az["b3_err"],
            (az["b3"][0], az["b3"][1], az["b3"][2], "bytes"), library_ms=az["b3"][3]),
    ]
    return out


def main() -> None:
    sys.path.insert(0, ROOT)
    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is False)")
    import minizero_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)
    from minizero_tpu_torch.config import algorithm_preset, default_config
    from minizero_tpu_torch.envs import make_env
    from minizero_tpu_torch.envs.atari import atari_spec
    from minizero_tpu_torch.models.factory import create_network, init_network
    from minizero_tpu_torch.ops import _build
    from minizero_tpu_torch.ops.gather_rows import gather_rows
    from minizero_tpu_torch.ops.state_blob import blob_spec
    from minizero_tpu_torch.ops.tree_kernel import fused_tree_step
    from minizero_tpu_torch.ops.tree_kernel_v2 import fused_tree_step_v2
    from minizero_tpu_torch.selfplay.engine import SelfPlayEngine
    from minizero_tpu_torch.weights import from_jax_variables, load_variables_npz

    # float32 comparisons run in full float32 on the card
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    def counts():
        return {"tree_step": fused_tree_step.launches,
                "tree_step_rewards": fused_tree_step.launches_rewards,
                "tree_step_v2": fused_tree_step_v2.launches,
                "gather_rows": gather_rows.launches,
                "gather_rows_aligned": gather_rows.launches_aligned}

    def zero_counts():
        fused_tree_step.launches = fused_tree_step.launches_rewards = 0
        fused_tree_step_v2.launches = gather_rows.launches = gather_rows.launches_aligned = 0

    # ---- 1. device -----------------------------------------------------------
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    log(f"phase 1 device: {card} | torch {torch.__version__} cuda {torch.version.cuda} | "
        f"{count} device(s), using {kind}")

    # ---- 2. build --------------------------------------------------------------
    # gather_rows_floor: B3's floor, timed beside it in phase 4b'
    kernels = ["tree_step", "tree_step_v2", "gather_rows", "gather_rows_floor"]
    t = time.perf_counter()
    for res in _build.build(kernels):
        usage = "; ".join(re.sub(r"\s+", " ", line.split(":", 1)[1]).strip()
                          for line in res.log.splitlines() if "Used" in line)
        log(f"phase 2 build: {res.name}.cu in {res.seconds:.2f} s (ptxas: {usage or 'n/a'})")
    # registers and shared memory per block (cudaFuncGetAttributes; the
    # dynamic size is what a launch at these shapes asks for): the tree
    # steps' register kernels run 128-thread blocks of four games, their
    # wide kernels (A > 384) one game a block of ceil(A / 384) warps (2 to
    # 8), B3 one warp per game
    def attrs(d):
        return (f"{d['registers']} registers, {d['static_smem']} bytes static + "
                f"{d['dynamic_smem']} bytes dynamic shared memory per block")

    games_per_block = _build.load("gather_rows").gather_rows_games_per_block
    games_per_block.argtypes, games_per_block.restype = [], ctypes.c_int
    b3_games = games_per_block()
    for what, name, shape in (("tree_step (gaz/gmz: A=82, N=17; 128 threads)", "tree_step", (82, 17)),
                              ("tree_step (gaz n=800: A=82, N=801; 128 threads)", "tree_step",
                               (82, 801)),
                              ("tree_step (Atari: A=18, N=51; 128 threads)", "tree_step", (18, 51)),
                              *((f"tree_step, wide kernel (A={a}, N={n})", "tree_step", (a, n))
                                for a, n in ((400, 17), (3040, 17), (3040, 201), (3040, 801))),
                              *((f"tree_step_v2, wide kernel (A={a}, cap {c})", "tree_step_v2", (a, c))
                                for a, c in ((400, 51), (3040, 201))),
                              *((f"tree_step_v2 (A=82, cap {c}; 128 threads)", "tree_step_v2", (82, c))
                                for c in (65, 129, AZ_SIMS + 1, 801)),
                              *((f"gather_rows, {path} path ({b3_games} games, {32 * b3_games} "
                                 f"threads)", "gather_rows", (flag,))
                                for path, flag in (("aligned", 1), ("generic", 0)))):
        log(f"phase 2 {what}: {attrs(_build.kernel_attributes(name, *shape))}")
    log(f"phase 2 build done in {time.perf_counter() - t:.2f} s (nvcc processes in parallel)")

    # ---- 3. kernel vs plain version at full width ----------------------------
    cfg = default_config("go", **algorithm_preset("gaz"))
    env = make_env(cfg)
    net = init_network(create_network(cfg, env.spec), seed=0)
    engine = SelfPlayEngine(env, cfg, net, use_bf16=True, device="cuda", seed=0)
    spec = engine.spec
    log(f"config: go 9x9 gaz n={spec.num_simulations} m={spec.gumbel_sample_size} "
        f"net {cfg.nn_num_blocks}x{cfg.nn_num_hidden_channels} bf16, B={BATCH}, "
        f"N={spec.max_nodes}, A={spec.action_size}")
    check = TreeStepCheck(keep_sim=spec.num_simulations // 2)
    engine.tree_step = check
    t = time.perf_counter()
    states = engine.init_batch(BATCH)
    out = engine.move(states)
    torch.cuda.synchronize()
    engine.tree_step = fused_tree_step
    if check.calls != spec.num_simulations + 1 or check.reward_calls:
        fail(f"expected {spec.num_simulations + 1} board-regime tree steps in a move, saw "
             f"{check.calls} ({check.reward_calls} in the reward regime)")
    log(f"phase 3 kernel vs plain: {check.calls} tree steps equal; {check.int_elems} integer "
        f"elements exact, {check.float_elems} float elements, max |diff| {check.max_abs_err:.3g} "
        f"(tol {FLOAT_ATOL}), in {time.perf_counter() - t:.2f} s")

    # 3b. a small search on the card and on the CPU, integer-exact net
    t = time.perf_counter()
    msg = small_search_card_vs_cpu("gaz", {}, 3, "small gaz search")
    log(f"phase 3b small gaz search: {msg}, in {time.perf_counter() - t:.2f} s")

    # 3c. the large-N path: B2 and B3 beside their plain versions on every
    # launch of one full-width az n=200 move (all three capacity stages)
    az_over = dict(algorithm_preset("az"))
    az_over.update(actor_num_simulation=AZ_SIMS)
    az_cfg = default_config("go", **az_over)
    az_env = make_env(az_cfg)
    az_net = init_network(create_network(az_cfg, az_env.spec), seed=1)
    az = SelfPlayEngine(az_env, az_cfg, az_net, use_bf16=True, device="cuda", seed=1)
    az_spec = az.spec
    if not az.use_tree_kernel_v2:
        fail("az n=200 did not take the large-N (v2) loop")
    log(f"config: go 9x9 az n={az_spec.num_simulations} net {az_cfg.nn_num_blocks}x"
        f"{az_cfg.nn_num_hidden_channels} bf16, B={BATCH}, N={az_spec.max_nodes}, "
        f"A={az_spec.action_size}, state row {az_env.spec.name}")
    v2check = TreeStepV2Check(keep_sims=V2_TIMED_SIMS)
    gcheck = GatherCheck(keep_call=B3_TIMED_SIM - 1)
    az.tree_step_v2, az.gather_rows = v2check, gcheck
    t = time.perf_counter()
    az_states = az.init_batch(BATCH)
    az_out = az.move(az_states)
    torch.cuda.synchronize()
    az.tree_step_v2, az.gather_rows = fused_tree_step_v2, gather_rows
    if v2check.calls != AZ_SIMS + 1 or gcheck.calls != AZ_SIMS:
        fail(f"expected {AZ_SIMS + 1} v2 tree steps and {AZ_SIMS} gathers in a move, saw "
             f"{v2check.calls} and {gcheck.calls}")
    if v2check.caps != {65, 129, AZ_SIMS + 1}:
        fail(f"v2 capacity stages {sorted(v2check.caps)}, expected [65, 129, {AZ_SIMS + 1}]")
    if gcheck.aligned_calls != gcheck.calls:
        fail(f"{gcheck.calls - gcheck.aligned_calls} of {gcheck.calls} row gathers left the "
             f"aligned path")
    # the bound counts the state's own words, not the row stride's pad
    state_w, stride_w = blob_spec(az_states).width, az._blob.shape[-1]
    log(f"phase 3c kernel vs plain (az n={AZ_SIMS}): {v2check.calls} v2 tree steps equal at caps "
        f"{sorted(v2check.caps)}; {v2check.int_elems} integer elements exact, "
        f"{v2check.float_elems} float elements, max |diff| {v2check.max_abs_err:.3g} "
        f"(tol {FLOAT_ATOL}); {gcheck.calls} row gathers equal, {gcheck.elems} words exact, "
        f"{gcheck.aligned_calls} on the aligned path (state row {state_w} words at a stride of "
        f"{stride_w}); in {time.perf_counter() - t:.2f} s")

    # 3d. a small large-N search (n=50: the v2 loop) on the card and the CPU
    t = time.perf_counter()
    msg = small_search_card_vs_cpu("az", {"actor_num_simulation": 50}, 2, "small az search")
    log(f"phase 3d small az search: {msg}, in {time.perf_counter() - t:.2f} s")

    # 3e. the Atari MuZero search (bench.py:143-188): B1' beside its plain
    # version on every launch of one full-width search
    at_cfg = default_config("atari", **algorithm_preset("mz"), actor_num_simulation=ATARI_SIMS)
    at_net = init_network(create_network(at_cfg, atari_spec()), seed=2).cuda().eval()
    at_search, at_feats, at_legal, at_turns = atari_search(
        copy.deepcopy(at_net).to(torch.bfloat16), at_cfg, ATARI_BATCH, torch.bfloat16, seed=3)
    at_spec = at_search.spec
    if not (at_spec.value_rescale and at_spec.discount != 1.0 and at_spec.init_q_average):
        fail("the Atari config lost its value rescale, discount or average init-Q")
    log(f"config: atari mz n={at_spec.num_simulations} net {at_cfg.nn_num_blocks}x"
        f"{at_cfg.nn_num_hidden_channels} bf16, B={ATARI_BATCH}, N={at_spec.max_nodes}, "
        f"A={at_spec.action_size}, discount {at_spec.discount}, value rescale, average init-Q")
    at_check = TreeStepCheck(keep_sim=ATARI_SIMS // 2)
    at_search.tree_step = at_check
    at_gen = torch.Generator(device="cuda").manual_seed(4)
    t = time.perf_counter()
    with torch.no_grad():
        at_res = at_search(at_feats, at_legal, at_turns, at_gen)
    torch.cuda.synchronize()
    at_search.tree_step = fused_tree_step
    if at_check.calls != ATARI_SIMS + 1 or at_check.reward_calls != ATARI_SIMS + 1:
        fail(f"expected {ATARI_SIMS + 1} reward-regime tree steps in an Atari search, saw "
             f"{at_check.calls} ({at_check.reward_calls} in the reward regime)")
    check_search_result(at_res, ATARI_BATCH, at_spec.action_size, "Atari search")
    log(f"phase 3e kernel vs plain (atari mz n={ATARI_SIMS}, B1'): {at_check.calls} reward-regime "
        f"tree steps equal; {at_check.int_elems} integer elements exact, {at_check.float_elems} "
        f"float elements, max |diff| {at_check.max_abs_err:.3g} (tol {FLOAT_ATOL}); root values "
        f"{float(at_res.root_value.min()):.4g} .. {float(at_res.root_value.max()):.4g}; in "
        f"{time.perf_counter() - t:.2f} s")

    # 3f. small MuZero searches on the card and on the CPU, integer-exact
    # MuZero nets: Go Gumbel MuZero through the engine, the Atari search
    t = time.perf_counter()
    msg = small_search_card_vs_cpu("gmz", {}, 3, "small gmz search")
    log(f"phase 3f small gmz search: {msg}, in {time.perf_counter() - t:.2f} s")
    t = time.perf_counter()
    small_at_cfg = at_cfg.replace(actor_use_dirichlet_noise=False, actor_select_action_by_count=True)
    msg = small_atari_card_vs_cpu(small_at_cfg)
    log(f"phase 3f small Atari search: {msg}, in {time.perf_counter() - t:.2f} s")

    # ---- 4. main paths ---------------------------------------------------------
    states = out.states
    warm = engine.move(states)  # warm-up move
    torch.cuda.synchronize()
    start_states = warm.states
    zero_counts()
    t = time.perf_counter()
    scan, end_states, _, _ = engine.move_scan(start_states, num_moves=SCAN_MOVES)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t
    gaz_launches = counts()
    want = {"tree_step": SCAN_MOVES * (spec.num_simulations + 1), "tree_step_rewards": 0,
            "tree_step_v2": 0, "gather_rows": 0, "gather_rows_aligned": 0}
    if gaz_launches != want:
        fail(f"gaz main path launches {gaz_launches}, expected {want}")
    check_scan(engine, start_states, scan, end_states, SCAN_MOVES, "gaz main path")
    steps_per_s = BATCH * SCAN_MOVES / elapsed
    log(f"phase 4 main path (gaz n={spec.num_simulations}): move_scan {SCAN_MOVES} moves x "
        f"{BATCH} games in {elapsed:.3f} s: {steps_per_s:.1f} env-steps/s, "
        f"{1e3 * elapsed / SCAN_MOVES:.1f} ms/move; launches {gaz_launches} "
        f"(= {SCAN_MOVES} x {spec.num_simulations + 1} tree steps); all actions legal; "
        f"{int((scan.resigned | scan.ended).sum())} games finished")

    # kernel time beside its plain version and its bound, at the main path's
    # shapes (the kept full-width state of phase 3)
    k_ms, p_ms, bound_ms, bound_by, byts, flops, depth = tree_step_numbers(check.kept)
    floor_ms = time_events(lambda i: torch.zeros(1024, device="cuda"), 50)
    log(f"tree_step at sim {check.kept[4]} (deepest next path {depth} nodes): kernel {k_ms:.4f} ms, "
        f"selection only on a warm state {warm_selection_ms(check.kept):.4f} ms, plain "
        f"{p_ms:.3f} ms, bound {bound_ms:.5f} ms ({byts} bytes, {flops} flops); a launch's floor "
        f"(torch.zeros of 1024 floats, back to back) {floor_ms:.4f} ms")

    # 4b. the large-N path
    az_warm = az.move(az_out.states)  # warm-up move
    torch.cuda.synchronize()
    az_start = az_warm.states
    zero_counts()
    t = time.perf_counter()
    az_scan, az_end, _, _ = az.move_scan(az_start, num_moves=AZ_SCAN_MOVES)
    torch.cuda.synchronize()
    az_elapsed = time.perf_counter() - t
    az_launches = counts()
    # every gather of the az path on the aligned path
    want = {"tree_step": 0, "tree_step_rewards": 0, "tree_step_v2": AZ_SCAN_MOVES * (AZ_SIMS + 1),
            "gather_rows": AZ_SCAN_MOVES * AZ_SIMS, "gather_rows_aligned": AZ_SCAN_MOVES * AZ_SIMS}
    if az_launches != want:
        fail(f"az main path launches {az_launches}, expected {want}")
    check_scan(az, az_start, az_scan, az_end, AZ_SCAN_MOVES, "az main path")
    az_steps_per_s = BATCH * AZ_SCAN_MOVES / az_elapsed
    az_ms_per_move = 1e3 * az_elapsed / AZ_SCAN_MOVES
    log(f"phase 4b main path (az n={AZ_SIMS}): move_scan {AZ_SCAN_MOVES} moves x {BATCH} games in "
        f"{az_elapsed:.3f} s: {az_steps_per_s:.1f} env-steps/s, {az_ms_per_move:.1f} ms/move; "
        f"launches {az_launches} (= {AZ_SCAN_MOVES} x {AZ_SIMS + 1} v2 tree steps, "
        f"{AZ_SCAN_MOVES} x {AZ_SIMS} gathers, all aligned); all actions legal; "
        f"{int((az_scan.resigned | az_scan.ended).sum())} games finished")

    # B2 at one simulation of each capacity stage (the last: cap 201, deep
    # walks), beside its plain version and its bound
    for sim in V2_TIMED_SIMS:
        kept2 = v2check.kept[sim]
        k2_ms, p2_ms, bound2_ms, bound2_by, byts2, flops2, depth = tree_step_v2_numbers(kept2)
        log(f"tree_step_v2 at sim {sim} (cap {kept2[1].visits.shape[1]}, deepest next path "
            f"{depth} nodes): kernel {k2_ms:.4f} ms, selection only on a warm state "
            f"{warm_selection_ms(kept2):.4f} ms, plain {p2_ms:.3f} ms, bound {bound2_ms:.5f} ms "
            f"({byts2} bytes, {flops2} flops)")

    # 4b'. B2 on a trained net's walks: the az n=200 net of runs/go9_az200_r3b
    # (iteration 25000) plays a few moves, then one move whose simulation
    # 190 is held against the plain version and timed
    tr_net = create_network(az_cfg, az_env.spec)
    tr_net.load_state_dict(from_jax_variables(load_variables_npz(os.path.join(ROOT, TRAINED_NPZ)),
                                              hidden_hw=81))
    tr = SelfPlayEngine(az_env, az_cfg, tr_net, use_bf16=True, device="cuda", seed=7)
    t = time.perf_counter()
    _, tr_states, _, _ = tr.move_scan(tr.init_batch(BATCH), num_moves=TRAINED_WARM_MOVES)
    tr_check = TreeStepV2Check(keep_sims=(AZ_SIMS - 10,), check_sims={AZ_SIMS - 10})
    tr_gcheck = GatherCheck(keep_call=B3_TIMED_SIM - 1)
    tr.tree_step_v2, tr.gather_rows = tr_check, tr_gcheck
    tr.move(tr_states)
    torch.cuda.synchronize()
    tr.tree_step_v2, tr.gather_rows = fused_tree_step_v2, gather_rows
    if tr_check.calls != 1 or AZ_SIMS - 10 not in tr_check.kept:
        fail(f"trained az move: {tr_check.calls} checked v2 tree steps, expected 1")
    if tr_gcheck.calls != AZ_SIMS or tr_gcheck.aligned_calls != AZ_SIMS:
        fail(f"trained az move: {tr_gcheck.calls} row gathers ({tr_gcheck.aligned_calls} "
             f"aligned), expected {AZ_SIMS}, all aligned")
    kt_ms, pt_ms, boundt_ms, _, bytst, flopst, deptht = tree_step_v2_numbers(
        tr_check.kept[AZ_SIMS - 10])
    log(f"phase 4b' trained az n={AZ_SIMS} ({TRAINED_NPZ}), move {TRAINED_WARM_MOVES + 1}: "
        f"tree_step_v2 at sim {AZ_SIMS - 10} equal to its plain version (max |diff| "
        f"{tr_check.max_abs_err:.3g}); deepest next path {deptht} nodes: kernel {kt_ms:.4f} ms, "
        f"plain {pt_ms:.3f} ms, bound {boundt_ms:.5f} ms ({bytst} bytes, {flopst} flops); "
        f"{tr_gcheck.calls} row gathers equal to the plain version, all aligned; in "
        f"{time.perf_counter() - t:.2f} s")

    # B3 at the gather of simulation 190: warm on the random-init move's
    # indices, cold on those and on the trained net's, beside the floor of
    # its grid, its plain version and the library call; the bound counts the
    # state's own words (2 * valid rows * 697 * 4 + B * 4 bytes)
    t = time.perf_counter()
    sets = {"random-init": (az._blob, gcheck.kept_idx), "trained": (tr._blob, tr_gcheck.kept_idx)}
    b3 = gather_rows_timings(sets, _build.load("gather_rows_floor"), b3_games)
    byts3 = 2 * int((gcheck.kept_idx >= 0).sum()) * state_w * 4 + BATCH * 4
    bound3_ms = byts3 / HBM_BYTES_PER_S * 1e3
    k3_ms, p3_ms, l3_ms = b3["B3"]["warm"], b3["plain"], b3["library"]["warm"]
    log(f"gather_rows [{BATCH}, {az._blob.shape[1]}, {stride_w}] int32 (state {state_w} words), "
        f"{b3_games} games a block, aligned path, gather of sim {B3_TIMED_SIM} (median of "
        f"{B3_ROUNDS} rounds): warm {k3_ms:.5f} ms back to back ({b3['B3']['warm_each']:.5f} ms "
        f"with events around each launch), cold {b3['B3']['random-init']:.5f} ms (random-init "
        f"indices, {int(gcheck.kept_idx.unique().numel())} distinct node indices) and "
        f"{b3['B3']['trained']:.5f} ms (trained net's, {int(tr_gcheck.kept_idx.unique().numel())} "
        f"distinct node indices); floor of the grid warm {b3['floor']['warm']:.5f} ms, cold "
        f"{b3['floor']['random-init']:.5f} ms; plain {p3_ms:.4f} ms; library x[arange(B), idx] "
        f"warm {l3_ms:.5f} ms, cold {b3['library']['random-init']:.5f} / "
        f"{b3['library']['trained']:.5f} ms; bound {bound3_ms:.5f} ms ({byts3} bytes); in "
        f"{time.perf_counter() - t:.2f} s")

    # 4c. Go 9x9 Gumbel MuZero: a warm-up move with every tree step beside
    # its plain version, then move_scan
    mz_cfg = default_config("go", **algorithm_preset("gmz"))
    mz_net = init_network(create_network(mz_cfg, env.spec), seed=5)
    mz = SelfPlayEngine(env, mz_cfg, mz_net, use_bf16=True, device="cuda", seed=5)
    mz_spec = mz.spec
    if not mz.is_muzero or mz.use_tree_kernel_v2:
        fail("Go gmz did not take the MuZero search on tree step B1")
    mz_check = TreeStepCheck(keep_sim=mz_spec.num_simulations // 2)
    mz.tree_step = mz_check
    t = time.perf_counter()
    mz_warm = mz.move(mz.init_batch(BATCH))
    torch.cuda.synchronize()
    mz.tree_step = fused_tree_step
    if mz_check.calls != mz_spec.num_simulations + 1 or mz_check.reward_calls:
        fail(f"expected {mz_spec.num_simulations + 1} board-regime tree steps in a gmz move, saw "
             f"{mz_check.calls} ({mz_check.reward_calls} in the reward regime)")
    log(f"config: go 9x9 gmz n={mz_spec.num_simulations} net {mz_cfg.nn_num_blocks}x"
        f"{mz_cfg.nn_num_hidden_channels} bf16, B={BATCH}, N={mz_spec.max_nodes}; warm-up move: "
        f"{mz_check.calls} tree steps equal to the plain version, max |diff| "
        f"{mz_check.max_abs_err:.3g}, in {time.perf_counter() - t:.2f} s")
    mz_start = mz_warm.states
    zero_counts()
    t = time.perf_counter()
    mz_scan, mz_end, _, _ = mz.move_scan(mz_start, num_moves=SCAN_MOVES)
    torch.cuda.synchronize()
    mz_elapsed = time.perf_counter() - t
    mz_launches = counts()
    want = {"tree_step": SCAN_MOVES * (mz_spec.num_simulations + 1), "tree_step_rewards": 0,
            "tree_step_v2": 0, "gather_rows": 0, "gather_rows_aligned": 0}
    if mz_launches != want:
        fail(f"gmz main path launches {mz_launches}, expected {want}")
    check_scan(mz, mz_start, mz_scan, mz_end, SCAN_MOVES, "gmz main path")
    mz_steps_per_s = BATCH * SCAN_MOVES / mz_elapsed
    mz_ms_per_move = 1e3 * mz_elapsed / SCAN_MOVES
    log(f"phase 4c main path (gmz n={mz_spec.num_simulations}): move_scan {SCAN_MOVES} moves x "
        f"{BATCH} games in {mz_elapsed:.3f} s: {mz_steps_per_s:.1f} env-steps/s, "
        f"{mz_ms_per_move:.1f} ms/move; launches {mz_launches} (= {SCAN_MOVES} x "
        f"{mz_spec.num_simulations + 1} board-regime tree steps); all actions legal; "
        f"{int((mz_scan.resigned | mz_scan.ended).sum())} games finished")

    # 4d. the Atari search: a warm-up, then timed searches
    with torch.no_grad():
        at_search(at_feats, at_legal, at_turns, at_gen)
        torch.cuda.synchronize()
        zero_counts()
        t = time.perf_counter()
        for _ in range(ATARI_SEARCHES):
            at_res = at_search(at_feats, at_legal, at_turns, at_gen)
        torch.cuda.synchronize()
    at_elapsed = time.perf_counter() - t
    at_launches = counts()
    want = {"tree_step": 0, "tree_step_rewards": ATARI_SEARCHES * (ATARI_SIMS + 1),
            "tree_step_v2": 0, "gather_rows": 0, "gather_rows_aligned": 0}
    if at_launches != want:
        fail(f"Atari search launches {at_launches}, expected {want}")
    check_search_result(at_res, ATARI_BATCH, at_spec.action_size, "timed Atari search")
    at_ms_per_search = 1e3 * at_elapsed / ATARI_SEARCHES
    log(f"phase 4d Atari search (mz n={ATARI_SIMS}, B={ATARI_BATCH}): {ATARI_SEARCHES} searches in "
        f"{at_elapsed:.3f} s: {at_ms_per_search:.1f} ms/search, "
        f"{ATARI_BATCH * 1e3 / at_ms_per_search:.1f} searches/s over the batch; launches "
        f"{at_launches} (= {ATARI_SEARCHES} x {ATARI_SIMS + 1} reward-regime tree steps)")

    # B1' at the middle of the Atari search, beside its plain version and its
    # bound
    k4_ms, p4_ms, bound4_ms, bound4_by, byts4, flops4, depth4 = tree_step_numbers(at_check.kept)
    log(f"tree_step (reward regime) at sim {at_check.kept[4]} of the Atari search (deepest "
        f"next path {depth4} nodes): kernel "
        f"{k4_ms:.4f} ms, selection only on a warm state {warm_selection_ms(at_check.kept):.4f} "
        f"ms, plain {p4_ms:.3f} ms, bound {bound4_ms:.5f} ms ({byts4} bytes, {flops4} flops)")

    # ---- 5. where the device time goes ----------------------------------------
    line, _ = profile_run(lambda: engine.move(end_states), 1e3 * elapsed / SCAN_MOVES,
                          ("tree_step_kernel",))
    log(f"phase 5 one profiled gaz move: {line}")
    line, named = profile_run(lambda: az.move(az_end), az_ms_per_move,
                              ("tree_step_v2_kernel", "gather_rows_kernel"))
    log(f"phase 5 one profiled az n={AZ_SIMS} move: {line}")
    log(f"phase 5 tree_step_v2 per az move: {named['tree_step_v2_kernel']:.3f} ms over "
        f"{AZ_SIMS + 1} launches, {named['tree_step_v2_kernel'] / (AZ_SIMS + 1):.4f} ms per launch "
        f"on average")
    log(f"phase 5 gather_rows per az move (in situ): {named['gather_rows_kernel']:.3f} ms over "
        f"{AZ_SIMS} launches, {named['gather_rows_kernel'] / AZ_SIMS:.4f} ms per launch on average")
    line, _ = profile_run(lambda: mz.move(mz_end), mz_ms_per_move, ("tree_step_kernel",))
    log(f"phase 5 one profiled gmz move: {line}")
    with torch.no_grad():
        line, _ = profile_run(lambda: at_search(at_feats, at_legal, at_turns, at_gen),
                              at_ms_per_search, ("tree_step_kernel",), what="search")
    log(f"phase 5 one profiled Atari search: {line}")

    # ---- 6. the zero iteration: self-play, records, replay, SGD, checkpoint --
    # the timed training runs with PyTorch's defaults: cuDNN convolutions in
    # TF32, matrix products in float32 (self-play is bf16 either way)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    t = time.perf_counter()
    # the gaz run stays for phase 7 and goes at exit, a failed check's too
    gaz_dir = tempfile.mkdtemp(prefix="zero_gaz_")
    atexit.register(shutil.rmtree, gaz_dir, ignore_errors=True)
    gaz_zero = zero_iteration("gaz", 11, zero_counts, counts, codec_games=CODEC_GAMES,
                              run_dir=gaz_dir, resume_check=True)
    log(f"phase 6 zero iteration (gaz n=16, 1x256, B={BATCH}; TF32 convolutions): "
        f"{zero_line(gaz_zero)}; phase in {time.perf_counter() - t:.2f} s")
    n_codec, t_native, t_plain, codec_bytes = gaz_zero["codec"]
    log(f"phase 6e resume: a fresh ZeroLoop's resume() on the gaz run: iteration 1, step "
        f"{ZERO_STEPS}, {ZERO_GAMES} games reloaded, their features replayed on the card "
        f"({gaz_zero['resume_bytes']} bytes) equal to the loop's byte for byte, network and "
        f"optimizer state equal, in {gaz_zero['resume_s']:.2f} s")
    log(f"phase 6d codec: native library loaded; {n_codec} games ({codec_bytes} bytes of "
        f"records) equal to the plain writer's and to the loop's lines; native "
        f"{1e3 * t_native:.1f} ms, plain {1e3 * t_plain:.1f} ms")
    t = time.perf_counter()
    gmz_dir = tempfile.mkdtemp(prefix="zero_gmz_")
    atexit.register(shutil.rmtree, gmz_dir, ignore_errors=True)
    gmz_zero = zero_iteration("gmz", 12, zero_counts, counts, steps=GMZ_ZERO_STEPS,
                              run_dir=gmz_dir, resume_check=True)
    log(f"phase 6b zero iteration (gmz n=16, K=5, 1x256, B={BATCH}; TF32 convolutions): "
        f"{zero_line(gmz_zero)}; phase in {time.perf_counter() - t:.2f} s")
    log(f"phase 6f resume: a fresh ZeroLoop's resume() on the gmz run: iteration 1, step "
        f"{GMZ_ZERO_STEPS}, {ZERO_GAMES} games reloaded, their features replayed on the card "
        f"({gmz_zero['resume_bytes']} bytes) equal to the loop's byte for byte, network and "
        f"optimizer state equal, one sample_muzero batch of {ZERO_BATCH} equal to the loop's, "
        f"in {gmz_zero['resume_s']:.2f} s")
    shutil.rmtree(gmz_dir, ignore_errors=True)

    # 6c. the train step on the card against the CPU, TF32 off
    torch.backends.cudnn.allow_tf32 = False
    t = time.perf_counter()
    for algo in ("gaz", "gmz"):
        msg = train_step_card_vs_cpu(algo, 13)
        log(f"phase 6c train step card vs CPU ({algo}, Go 9x9 1x32, batch 64, f32): {msg}; "
            f"full width (1x256, batch {ZERO_BATCH}): {fixed_batch_loss_falls(algo, 14)}")
    log(f"phase 6c done in {time.perf_counter() - t:.2f} s")

    # ---- 7. eval, console and the other CLI modes on the gaz run ----------
    torch.backends.cudnn.allow_tf32 = True
    cfg_path = os.path.join(gaz_dir, "gaz.cfg")
    gaz_zero["cfg"].save_file(cfg_path)
    ev = eval_phase(gaz_dir, cfg_path, zero_counts, counts)
    eval_ms_per_ply = 1e3 * ev["seconds"] / ev["plies"]
    self_ms_per_ply = 1e3 * ev["self_seconds"] / ev["self_plies"]
    log(f"phase 7 eval (-mode eval, gaz n=16, 1x256 bf16, {EVAL_GAMES} games at B={BATCH}, "
        f"synchronized): {ev['line']} | W/L/D {'/'.join(ev['wld'])}, Elo {ev['elo']:.1f}; "
        f"{ev['plies']} plies in {ev['seconds']:.2f} s: {eval_ms_per_ply:.1f} ms/ply, "
        f"{EVAL_GAMES / ev['seconds']:.1f} games/s; B1 launches {ev['launches']} "
        f"(= {ev['plies']} plies x 17), the first {ev['checked']} beside the plain version "
        f"(max |diff| {ev['check_err']:.3g}); self-match (rotation off, 2 random opening "
        f"plies): {ev['self_result']}, {ev['self_plies']} plies in {ev['self_seconds']:.2f} s: "
        f"{self_ms_per_ply:.1f} ms/ply, {SELF_MATCH_GAMES / ev['self_seconds']:.1f} games/s")
    t = time.perf_counter()
    con = console_phase(cfg_path, ev["ckpt"])
    b1c = console_b1_check(cfg_path, ev["ckpt"])
    log(f"phase 7b console (-mode console subprocess, f32, B=1, checkpoint "
        f"{os.path.basename(ev['ckpt'])}): " + "; ".join(
            f"{label}: every reply '=', genmove {c['ms']:.1f} ms (first {c['first_ms']:.1f} ms), "
            f"moves {' '.join(c['moves'])}, process {c['seconds']:.1f} s"
            for label, c in con.items())
        + f" (time limit {CONSOLE_TIME_LIMIT} s); in process: {b1c['calls']} tree steps of one "
        f"genmove at B=1 equal to the plain version (max |diff| {b1c['err']:.3g}); B1 at B=1 "
        f"{b1c['ms']:.5f} ms, plain {b1c['plain_ms']:.3f} ms, bound {b1c['bound_ms']:.6f} ms "
        f"({b1c['bound_by']}); phase in {time.perf_counter() - t:.2f} s")
    om = other_modes_phase(gaz_dir, cfg_path, zero_counts, counts)
    log(f"phase 7c -mode sp (gaz n=16, B={BATCH}): {om['sp_records']} records "
        f"({om['sp_mib']:.2f} MiB) parsed back, in {om['sp_s']:.2f} s, B1 launches "
        f"{om['sp_launches']}; -mode env_test (Go 9x9): {om['env_test']} in {om['env_s']:.2f} s; "
        f"-mode zero_training_name: {om['name']} in {om['name_s']:.3f} s")

    # ---- 8. the tree steps past 384 actions; Othello, NoGo, Kill-All-Go,
    # Clobber, Gomoku and Hex at full width -----------------------------------
    t = time.perf_counter()
    p8 = phase8(zero_counts, counts)
    log(f"phase 8 done in {time.perf_counter() - t:.2f} s")
    cg, ca = p8["paths"]["clobber_gaz"], p8["paths"]["clobber_az"]
    wide_rows = [{
        "name": row["name"], "route": "cuda",
        "source": ("minizero_tpu_torch/csrc/tree_step_v2.cu" if row["kernel"] == "tree_step_v2"
                   else "minizero_tpu_torch/csrc/tree_step.cu"),
        "replaces": {"tree_step": "minizero_tpu/ops/tree_kernel.py:136",
                     "tree_step_rewards": "minizero_tpu/ops/tree_kernel.py:136 (reward regime)",
                     "tree_step_v2": "minizero_tpu/ops/tree_kernel_v2.py:240"}[row["kernel"]],
        "launches": row["launches"], "max_abs_err": row["err"], "ms": row["ms"],
        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
        "library_ms": None} for row in p8["rows"]]
    wide_rows += [{
        "name": "tree_step_wide (clobber gaz n=16, A=400, N=17)", "route": "cuda",
        "source": "minizero_tpu_torch/csrc/tree_step.cu",
        "replaces": "minizero_tpu/ops/tree_kernel.py:136",
        "launches": cg["launches"]["tree_step"], "max_abs_err": cg["err"], "ms": cg["b1"][0],
        "plain_ms": cg["b1"][1], "bound_ms": cg["b1"][2], "bound_by": cg["b1"][3],
        "library_ms": None,
    }, {
        "name": "tree_step_v2_wide (clobber az n=50, A=400, cap 51)", "route": "cuda",
        "source": "minizero_tpu_torch/csrc/tree_step_v2.cu",
        "replaces": "minizero_tpu/ops/tree_kernel_v2.py:240",
        "launches": ca["launches"]["tree_step_v2"], "max_abs_err": ca["err"], "ms": ca["b2"][0],
        "plain_ms": ca["b2"][1], "bound_ms": ca["b2"][2], "bound_by": ca["b2"][3],
        "library_ms": None,
    }, {
        "name": f"gather_rows (clobber az n=50, {ca['b3'][4]}-word rows)", "route": "cuda",
        "source": "minizero_tpu_torch/csrc/gather_rows.cu",
        "replaces": "minizero_tpu/ops/gather_rows.py:33",
        "launches": ca["launches"]["gather_rows"], "max_abs_err": ca["b3_err"], "ms": ca["b3"][0],
        "plain_ms": ca["b3"][1], "bound_ms": ca["b3"][2], "bound_by": "bytes",
        "library_ms": ca["b3"][3],
    }]
    # ---- 9. 2048, Tetris Block Puzzle and the rest of group 3 ---------------
    t = time.perf_counter()
    p9 = phase9(zero_counts, counts)
    log(f"phase 9 done in {time.perf_counter() - t:.2f} s")
    for key, name in (("puzzle2048_gmz", "puzzle2048 gmz n=16, trained net, A=4, N=17"),
                      ("puzzle2048_gaz", "puzzle2048 gaz n=16, A=4, N=17"),
                      ("tetrisblockpuzzle_gmz", "tetrisblockpuzzle gmz n=16, A=801, N=17"),
                      ("tetrisblockpuzzle_gaz", "tetrisblockpuzzle gaz n=16, A=801, N=17")):
        r = p9[key]
        wide = "_wide" if r["A"] > 384 else ""
        wide_rows.append({
            "name": f"{r['kernel'].replace('tree_step', 'tree_step' + wide)} ({name})",
            "route": "cuda", "source": "minizero_tpu_torch/csrc/tree_step.cu",
            "replaces": "minizero_tpu/ops/tree_kernel.py:136" + (" (reward regime)"
                                                                 if r["rewards"] else ""),
            "launches": r["launches"][r["kernel"]], "max_abs_err": r["err"], "ms": r["b1"][0],
            "plain_ms": r["b1"][1], "bound_ms": r["b1"][2], "bound_by": r["b1"][3],
            "library_ms": None})
    # ---- 10. Atari over the host env; group 5 --------------------------------
    t = time.perf_counter()
    p10 = phase10(zero_counts, counts)
    log(f"phase 10 done in {time.perf_counter() - t:.2f} s")
    ah, az_ = p10["atari_host"], p10["atari_zero"]
    wide_rows.append({
        "name": (f"tree_step_rewards (atari gmz n=18 host self-play, A=18, N={ah['N']}, "
                 f"B={ATARI_HOST_BATCH})"),
        "route": "cuda", "source": "minizero_tpu_torch/csrc/tree_step.cu",
        "replaces": "minizero_tpu/ops/tree_kernel.py:136 (reward regime)",
        "launches": ah["launches"]["tree_step_rewards"], "max_abs_err": ah["err"],
        "ms": ah["b1"][0], "plain_ms": ah["b1"][1], "bound_ms": ah["b1"][2],
        "bound_by": ah["b1"][3], "library_ms": None})
    for env_name, _ in GROUP5:
        r = p10[f"{env_name}_gaz"]
        wide_rows.append({
            "name": f"tree_step_wide ({env_name} gaz n=16, A={r['A']}, N={r['N']})",
            "route": "cuda", "source": "minizero_tpu_torch/csrc/tree_step.cu",
            "replaces": "minizero_tpu/ops/tree_kernel.py:136",
            "launches": r["launches"]["tree_step"], "max_abs_err": r["err"], "ms": r["b1"][0],
            "plain_ms": r["b1"][1], "bound_ms": r["b1"][2], "bound_by": r["b1"][3],
            "library_ms": None})
    # ---- 11. the tools; the data-parallel zero loop -------------------------
    t = time.perf_counter()
    p11 = phase11(gaz_dir, p10["atari_zero"].pop("obs_records"), zero_counts, counts)
    log(f"phase 11 done in {time.perf_counter() - t:.2f} s")
    # ---- 12. the README's strength protocol at n=800 -------------------------
    t = time.perf_counter()
    p12 = phase12(zero_counts, counts)
    log(f"phase 12 done in {time.perf_counter() - t:.2f} s")
    wide_rows += p12["rows"]
    families = {key: {"ms_per_move": r["ms_per_move"], "env_steps_per_s": r["steps_per_s"]}
                for key, r in {**p8["paths"], **p9, **p10}.items()
                if isinstance(r, dict) and "steps_per_s" in r}
    pz, pg = p9["puzzle2048_zero"], p9["puzzle2048_games"]
    oz, oe = p8["paths"]["othello_zero"], p8["paths"]["othello_eval"]

    result = {"kernels": [{
        "name": "tree_step",
        "route": "cuda",
        "source": "minizero_tpu_torch/csrc/tree_step.cu",
        "replaces": "minizero_tpu/ops/tree_kernel.py:136",
        "launches": gaz_launches["tree_step"],
        "max_abs_err": check.max_abs_err,
        "ms": k_ms,
        "plain_ms": p_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }, {
        "name": "tree_step_v2",
        "route": "cuda",
        "source": "minizero_tpu_torch/csrc/tree_step_v2.cu",
        "replaces": "minizero_tpu/ops/tree_kernel_v2.py:240",
        "launches": az_launches["tree_step_v2"],
        "max_abs_err": v2check.max_abs_err,
        "ms": k2_ms,
        "plain_ms": p2_ms,
        "bound_ms": bound2_ms,
        "bound_by": bound2_by,
        "library_ms": None,
    }, {
        "name": "gather_rows",
        "route": "cuda",
        "source": "minizero_tpu_torch/csrc/gather_rows.cu",
        "replaces": "minizero_tpu/ops/gather_rows.py:33",
        "launches": az_launches["gather_rows"],
        "max_abs_err": gcheck.max_abs_err,
        "ms": k3_ms,
        "plain_ms": p3_ms,
        "bound_ms": bound3_ms,
        "bound_by": "bytes",
        "library_ms": l3_ms,
    }, {
        "name": "tree_step_rewards",
        "route": "cuda",
        "source": "minizero_tpu_torch/csrc/tree_step.cu",
        "replaces": "minizero_tpu/ops/tree_kernel.py:136 (reward regime)",
        "launches": at_launches["tree_step_rewards"],
        "max_abs_err": at_check.max_abs_err,
        "ms": k4_ms,
        "plain_ms": p4_ms,
        "bound_ms": bound4_ms,
        "bound_by": bound4_by,
        "library_ms": None,
    }, *wide_rows], "env_steps_per_s": steps_per_s, "ms_per_move": 1e3 * elapsed / SCAN_MOVES,
        "az200_env_steps_per_s": az_steps_per_s, "az200_ms_per_move": az_ms_per_move,
        "gmz_env_steps_per_s": mz_steps_per_s, "gmz_ms_per_move": mz_ms_per_move,
        "atari_mz50_ms_per_search": at_ms_per_search,
        "eval_ms_per_ply": eval_ms_per_ply, "eval_games_per_s": EVAL_GAMES / ev["seconds"],
        "eval_plies": ev["plies"], "eval_b1_launches": ev["launches"],
        "eval_self_match_ms_per_ply": self_ms_per_ply,
        "eval_self_match_games_per_s": SELF_MATCH_GAMES / ev["self_seconds"],
        "console_ms_per_genmove": con["plain"]["ms"],
        "console_timed_ms_per_genmove": con["timed"]["ms"],
        "console_think_batch_ms_per_genmove": con["think-batch"]["ms"],
        "console_b1_ms": b1c["ms"], "console_b1_plain_ms": b1c["plain_ms"],
        "console_b1_bound_ms": b1c["bound_ms"], "sp_seconds": om["sp_s"],
        "sp_b1_launches": om["sp_launches"], "zero_gaz_resume_s": gaz_zero["resume_s"],
        **{f"zero_{algo}_{key}": val for algo, z in (("gaz", gaz_zero), ("gmz", gmz_zero))
           for key, val in (("sgd_steps_per_s", 1e3 / z["ms_per_step"]),
                            ("ms_per_sgd_step", z["ms_per_step"]),
                            ("selfplay_games_per_s", z["games"] / z["selfplay_s"]),
                            ("selfplay_s", z["selfplay_s"]), ("optimize_s", z["optimize_s"]),
                            ("b1_launches", z["launches"]))},
        "families": families, "othello_zero_sgd_steps_per_s": 1e3 / oz["ms_per_step"],
        "othello_zero_selfplay_s": oz["selfplay_s"], "othello_eval_wld": list(oe["wld"]),
        "othello_eval_ms_per_ply": 1e3 * oe["seconds"] / oe["plies"],
        "othello_eval_games_per_s": EVAL_GAMES / oe["seconds"],
        "puzzle2048_trained_mean_return": pg["trained"]["mean"],
        "puzzle2048_seeded_mean_return": pg["seeded init"]["mean"],
        "puzzle2048_zero_sgd_steps_per_s": 1e3 / pz["ms_per_step"],
        "puzzle2048_zero_selfplay_s": pz["selfplay_s"],
        "atari_host_ms_per_move": ah["ms_per_move"], "atari_host_search_ms": ah["search_ms"],
        "atari_host_env_ms": ah["env_ms"], "atari_zero_selfplay_s": az_["selfplay_s"],
        "atari_zero_b1_launches": az_["launches"],
        "atari_zero_sgd_steps_per_s": 1e3 / az_["ms_per_step"],
        "atari_zero_window_gb": az_["window_gb"],
        "profile_b1_launches": p11["profile"]["b1_launches"],
        "profile_b1_ms": p11["profile"]["b1_ms"],
        "profile_device_ms_per_move": p11["profile"]["device_ms_per_move"],
        **{f"multi_device_{key}_{k}": p11[key][k] for key in ("nccl1", "gloo2", "tp2")
           for k in ("seconds", "selfplay_s", "optimize_s")},
        **{f"n800_{key}_{k}": p12[key][k] for key in ("az", "gaz")
           for k in ("ms_per_ply", "first_ply_s")},
        "n800_az_wld_running": [*p12["az"]["wld"], p12["az"]["running"]]}
    print(json.dumps(result), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}),
          flush=True)


if __name__ == "__main__":
    main()

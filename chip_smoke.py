"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's two self-play paths (``minizero_tpu_torch``) at full
width, with 1 x 256 nets made from a seed, bf16 inference and 1024 games in
lock-step, and holds every CUDA kernel of them against its plain PyTorch
version on the card:

- the flagship Go 9x9 Gumbel AlphaZero path, n=16 (tree step B1,
  ``csrc/tree_step.cu``);
- the large-N Go 9x9 AlphaZero path, n=200 (tree step B2,
  ``csrc/tree_step_v2.cu``, and the parent-state row gather B3,
  ``csrc/gather_rows.cu``).

Phases:

  1. device: the card's name and power limit;
  2. build: every kernel with nvcc (seconds, registers, shared memory);
  3. kernel vs plain version: one full-width move of each path in which
     every kernel launch runs beside its plain version from the same state;
     integers must match exactly, floats within 1e-5; then a small input of
     each path played on the card and on the CPU;
  4. main paths: ``move_scan`` of each path (8 gaz moves, 4 az moves) after
     a warm-up move, with every launch counter set to 0 just before and
     read just after, legality of every action, env-steps/s, and each
     kernel's time beside its plain version's, its bound and (where one
     PyTorch call computes the same function) that call's;
  5. where a move's device time goes: one move of each path under
     ``torch.profiler``.

Prints one progress line per phase, then a JSON line of kernel numbers, the
card's name and power limit, and last ``{"ok": true, "device": {...}}``.
Exits non-zero, printing no result, when anything fails or no CUDA device
is present. Imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# flagship self-play config (bench.py:1-12) and the large-N AlphaZero
# config (bench.py:54-67: az n=200)
BATCH = 1024
SCAN_MOVES = 8
AZ_SIMS = 200
AZ_SCAN_MOVES = 4
FLOAT_ATOL = 1e-5
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
    Keeps a copy of the inputs of simulation ``keep_sim`` for timing."""

    def __init__(self, keep_sim: int):
        from minizero_tpu_torch.ops.tree_kernel import fused_tree_step, tree_step_reference

        self.kernel = fused_tree_step
        self.plain = tree_step_reference
        self.keep_sim = keep_sim
        self.kept = None
        self.calls = 0
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

    def __call__(self, spec, trees, sel, *rest):
        node_idx, phase = rest[-2], rest[-1]
        leaf = rest[:-2]
        ref_in = trees.clone()
        ref_sel = dataclasses.replace(sel, **{f.name: getattr(sel, f.name).clone()
                                              for f in dataclasses.fields(sel)})
        if node_idx == self.keep_sim and self.kept is None:
            self.kept = (spec, trees.clone(), ref_sel, tuple(x.clone() for x in leaf),
                         node_idx, phase)
        want_t, want_s = self.plain(spec, ref_in, ref_sel, *leaf, node_idx, phase)
        got_t, got_s = self.kernel(spec, trees, sel, *leaf, node_idx, phase)
        where = f"sim {node_idx} (phase {phase})"
        for f in dataclasses.fields(got_t):
            self._compare(f.name, getattr(got_t, f.name), getattr(want_t, f.name), where)
        for name in ("parent", "action", "leaf", "is_new", "path"):
            self._compare(f"selection.{name}", getattr(got_s, name), getattr(want_s, name), where)
        self.calls += 1
        return got_t, got_s


def tree_step_work(kept, nsel, trees_after):
    """(bytes, flops) that one tree step must move / do for these inputs:
    each input read once and each output written once, counting only what
    this run's data needs (the rows of new leaves, the path nodes backed
    up, the root row, the rows of the nodes the walk passes through)."""
    spec, trees, sel, leaf, _, _ = kept
    b, n = trees.visits.shape
    a = spec.action_size
    new = int(sel.is_new.sum())
    path_nodes = int(sel.path.sum()) + new
    byts = b * (4 * 3 + 1 + n)            # selection in
    byts += b * (1 + 4 + 4)               # leaf terminal, value, turn
    byts += new * a * 9                   # policy/logit/legal rows of new leaves
    byts += new * (a * 9 + 2 + 4 * 4 + 4)  # the new node's row, scalars, parent edge
    byts += path_nodes * 16               # backup: visits and mean, read and written
    # root statistics (children_index, logit, legal, gumbel_active; the
    # root children's visits and means; gumbel state)
    root_children = int((trees_after.children_index[:, 0] >= 0).sum())
    byts += b * a * 10 + root_children * 8 + b * 16
    halved = int((trees_after.gumbel_sample_size != trees.gumbel_sample_size).sum())
    byts += halved * a
    # PUCT rows read by the walk: nodes on the next path that were descended
    # through (not the leaf; not the root when the Gumbel root step chose),
    # plus the visits and mean of each of their children
    walked = nsel.path.clone()
    rows = torch.arange(b, device=walked.device)
    has_leaf = nsel.leaf >= 0
    walked[rows[has_leaf], nsel.leaf[has_leaf].long()] = False
    if spec.use_gumbel:
        walked[:, 0] = False
    children = int(((trees_after.children_index >= 0) & walked[:, :, None]).sum())
    walked = int(walked.sum())
    byts += walked * (a * 9 + 8) + children * 8
    byts += b * (4 * 3 + 1 + n)           # selection out
    flops = walked * a * 12 + halved * a * a * 3 + b * a * 6
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

    spec, trees, sel, leaf, node_idx, phase = kept
    copies = [trees.clone() for _ in range(reps + 1)]
    return time_events(lambda i: fused_tree_step(spec, copies[i], sel, *leaf, node_idx, phase),
                       reps)


def time_plain(kept, reps: int = 5):
    from minizero_tpu_torch.ops.tree_kernel import tree_step_reference

    spec, trees, sel, leaf, node_idx, phase = kept
    return time_events(lambda i: tree_step_reference(spec, trees, sel, *leaf, node_idx, phase),
                       reps, hold=False)


# ---------------------------------------------------------------------------
# phase 3c helpers: tree step B2 and row gather B3 held against their plain
# versions
# ---------------------------------------------------------------------------

def _compare_fields(check, got, want, where):
    for f in dataclasses.fields(got):
        check._compare(f.name, getattr(got, f.name), getattr(want, f.name), where)


class TreeStepV2Check(TreeStepCheck):
    """Wraps the engine's v2 tree step: each call runs the CUDA kernel and
    the plain version from the same state and compares every output. Keeps
    a copy of the inputs of simulation ``keep_sim`` for timing."""

    def __init__(self, keep_sim: int):
        super().__init__(keep_sim)
        from minizero_tpu_torch.ops.tree_kernel_v2 import fused_tree_step_v2, tree_step_v2_reference

        self.kernel = fused_tree_step_v2
        self.plain = tree_step_v2_reference
        self.caps = set()

    def __call__(self, spec, packed, sel, *rest):
        node_idx, phase = rest[-2], rest[-1]
        leaf = rest[:-2]
        ref_sel = sel.clone()
        if node_idx == self.keep_sim and self.kept is None:
            self.kept = (spec, packed.clone(), sel.clone(), tuple(x.clone() for x in leaf),
                         node_idx, phase)
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
    every row is defined). Keeps the index of gather ``keep_call``."""

    def __init__(self, keep_call: int):
        from minizero_tpu_torch.ops.gather_rows import gather_rows, gather_rows_reference

        self.kernel = gather_rows
        self.plain = gather_rows_reference
        self.keep_call = keep_call
        self.kept_idx = None
        self.calls = 0
        self.elems = 0
        self.max_abs_err = 0.0

    def __call__(self, x, idx):
        if self.calls == self.keep_call:
            self.kept_idx = idx.clone()
        got = self.kernel(x, idx)
        want = self.plain(x, idx)
        if not torch.equal(got, want):
            bad = int((got != want).sum())
            fail(f"gather_rows call {self.calls}: {bad} of {got.numel()} words differ")
        self.max_abs_err = max(self.max_abs_err,
                               float((got.long() - want.long()).abs().max()) if got.numel() else 0.0)
        self.elems += got.numel()
        self.calls += 1
        return got


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


# ---------------------------------------------------------------------------
# phase 3b: the same small search on the card and on the CPU
# ---------------------------------------------------------------------------

def integer_net(spec, seed: int):
    """A linear policy/value net with small integer weights: its logits are
    sums of integers below 2^24, exact in float32 in any order, so the card
    and the CPU evaluate it identically (up to ~1 ulp in the softmax)."""
    from torch import nn

    c, h, w, a = spec.num_input_channels, spec.input_height, spec.input_width, spec.action_size

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
            value = torch.clamp((x @ self.wv) / 64.0, -0.96875, 0.96875)
            return {"policy_logit": logits, "policy": torch.softmax(logits, -1), "value": value}

    return IntegerNet()


def profile_move(engine, states, ms_per_move: float, kernel_names=()):
    """One profiled move: device busy time (the summed durations of the
    kernels and copies that ran on the card) against the unprofiled move
    time, kernel launches per move, and the kernels that take the most
    device time. Returns the summary line and the device ms of each kernel
    whose name contains one of ``kernel_names``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        engine.move(states)
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
    own = "; ".join(f"{n} {d:.3f} ms ({d / ms_per_move:.4f} of the move)" for n, d in named.items())
    return (f"device busy {busy_ms:.2f} ms of {ms_per_move:.1f} ms/move "
            f"(idle share {1 - busy_ms / ms_per_move:.3f}), {launches} kernel launches/move; "
            f"top device time: {parts}" + (f"; kernels of the port: {own}" if own else ""))


def check_scan(engine, start_states, scan, end_states, moves: int, what: str) -> None:
    """Every action of a ``move_scan`` was legal where it was played, the
    replayed boards equal the scan's, and the policy targets and root
    values are finite distributions and values in [-1, 1]."""
    env = engine.env
    st = start_states
    for mv in range(moves):
        a = scan.action[mv].long()
        if not bool(env.legal_mask(st)[torch.arange(BATCH, device=a.device), a].all()):
            fail(f"{what}: an illegal action at move {mv}")
        st = engine.reset_slots(env.step(st, a), scan.resigned[mv] | scan.ended[mv])
    if not torch.equal(st.board, end_states.board):
        fail(f"{what}: replayed boards differ from move_scan's states")
    pt = scan.policy_target.float()
    if not (bool(torch.isfinite(pt).all()) and bool(torch.isfinite(scan.root_value).all())):
        fail(f"{what}: non-finite policy target or root value")
    if float((pt.sum(-1) - 1.0).abs().max()) > 1e-2 or float(scan.root_value.abs().max()) > 1.0:
        fail(f"{what}: policy targets do not sum to 1 or root values leave [-1, 1]")


def small_search_card_vs_cpu(algo: str, over: dict, moves: int, what: str) -> str:
    """A small search (B=64, f32, integer-exact net, noise and rotation
    off) played on the card and on the CPU from the same random openings:
    actions equal, policy targets and root values within 1e-4 / 1e-5."""
    from minizero_tpu_torch.config import algorithm_preset, default_config
    from minizero_tpu_torch.envs import make_env
    from minizero_tpu_torch.selfplay.engine import SelfPlayEngine

    small = dict(algorithm_preset(algo))
    small.update(actor_use_gumbel_noise=False, actor_use_dirichlet_noise=False,
                 actor_use_random_rotation_features=False, actor_select_action_by_count=True,
                 **over)
    scfg = default_config("go", **small)
    senv = make_env(scfg)
    gpu_eng = SelfPlayEngine(senv, scfg, integer_net(senv.spec, 7), use_bf16=False, device="cuda")
    cpu_eng = SelfPlayEngine(senv, scfg, integer_net(senv.spec, 7), use_bf16=False, device="cpu")
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


def main() -> None:
    sys.path.insert(0, ROOT)
    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is False)")
    import minizero_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)
    from minizero_tpu_torch.config import algorithm_preset, default_config
    from minizero_tpu_torch.envs import make_env
    from minizero_tpu_torch.models.factory import create_network, init_network
    from minizero_tpu_torch.ops import _build
    from minizero_tpu_torch.ops.gather_rows import gather_rows, gather_rows_reference
    from minizero_tpu_torch.ops.tree_kernel import fused_tree_step
    from minizero_tpu_torch.ops.tree_kernel_v2 import fused_tree_step_v2
    from minizero_tpu_torch.selfplay.engine import SelfPlayEngine

    # float32 comparisons run in full float32 on the card
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    def counts():
        return {"tree_step": fused_tree_step.launches,
                "tree_step_v2": fused_tree_step_v2.launches,
                "gather_rows": gather_rows.launches}

    def zero_counts():
        fused_tree_step.launches = fused_tree_step_v2.launches = gather_rows.launches = 0

    # ---- 1. device -----------------------------------------------------------
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    log(f"phase 1 device: {card} | torch {torch.__version__} cuda {torch.version.cuda} | "
        f"{count} device(s), using {kind}")

    # ---- 2. build --------------------------------------------------------------
    kernels = ["tree_step", "tree_step_v2", "gather_rows"]
    t = time.perf_counter()
    builds = _build.build(kernels)
    for res in builds:
        usage = "; ".join(re.sub(r"\s+", " ", line.split(":", 1)[1]).strip()
                          for line in res.log.splitlines() if "Used" in line)
        log(f"phase 2 build: {res.name}.cu in {res.seconds:.2f} s (ptxas: {usage or 'n/a'})")
    # tree_step.cu: 128 threads per block, 3 scratch rows of A floats per warp
    # in dynamic shared memory (none static); tree_step_v2.cu and
    # gather_rows.cu use no shared memory
    log(f"phase 2 tree_step shared memory: {4 * 3 * 82 * 4} bytes per 128-thread block at A=82 "
        f"({3 * 82 * 4 // 32} bytes per thread); tree_step_v2 and gather_rows: none")
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
    if check.calls != spec.num_simulations + 1:
        fail(f"expected {spec.num_simulations + 1} tree steps in a move, saw {check.calls}")
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
    v2check = TreeStepV2Check(keep_sim=AZ_SIMS - 10)
    gcheck = GatherCheck(keep_call=AZ_SIMS - 10)
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
    blob_w = az._blob.shape[-1]
    log(f"phase 3c kernel vs plain (az n={AZ_SIMS}): {v2check.calls} v2 tree steps equal at caps "
        f"{sorted(v2check.caps)}; {v2check.int_elems} integer elements exact, "
        f"{v2check.float_elems} float elements, max |diff| {v2check.max_abs_err:.3g} "
        f"(tol {FLOAT_ATOL}); {gcheck.calls} row gathers equal, {gcheck.elems} words exact "
        f"(row {blob_w} words); in {time.perf_counter() - t:.2f} s")

    # 3d. a small large-N search (n=50: the v2 loop) on the card and the CPU
    t = time.perf_counter()
    msg = small_search_card_vs_cpu("az", {"actor_num_simulation": 50}, 2, "small az search")
    log(f"phase 3d small az search: {msg}, in {time.perf_counter() - t:.2f} s")

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
    want = {"tree_step": SCAN_MOVES * (spec.num_simulations + 1), "tree_step_v2": 0,
            "gather_rows": 0}
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
    kept = check.kept
    k_ms = time_kernel(kept)
    p_ms = time_plain(kept)
    spec_k, trees_k, sel_k, leaf_k, idx_k, ph_k = kept
    after = trees_k.clone()
    _, nsel = fused_tree_step(spec_k, after, sel_k, *leaf_k, idx_k, ph_k)
    byts, flops = tree_step_work(kept, nsel, after)
    t_bytes, t_ops = byts / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    bound_ms = max(t_bytes, t_ops)
    log(f"tree_step at sim {idx_k}: kernel {k_ms:.4f} ms, plain {p_ms:.3f} ms, bound "
        f"{bound_ms:.5f} ms ({byts} bytes, {flops} flops)")

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
    want = {"tree_step": 0, "tree_step_v2": AZ_SCAN_MOVES * (AZ_SIMS + 1),
            "gather_rows": AZ_SCAN_MOVES * AZ_SIMS}
    if az_launches != want:
        fail(f"az main path launches {az_launches}, expected {want}")
    check_scan(az, az_start, az_scan, az_end, AZ_SCAN_MOVES, "az main path")
    az_steps_per_s = BATCH * AZ_SCAN_MOVES / az_elapsed
    az_ms_per_move = 1e3 * az_elapsed / AZ_SCAN_MOVES
    log(f"phase 4b main path (az n={AZ_SIMS}): move_scan {AZ_SCAN_MOVES} moves x {BATCH} games in "
        f"{az_elapsed:.3f} s: {az_steps_per_s:.1f} env-steps/s, {az_ms_per_move:.1f} ms/move; "
        f"launches {az_launches} (= {AZ_SCAN_MOVES} x {AZ_SIMS + 1} v2 tree steps, "
        f"{AZ_SCAN_MOVES} x {AZ_SIMS} gathers); all actions legal; "
        f"{int((az_scan.resigned | az_scan.ended).sum())} games finished")

    # B2 at a late simulation (cap 201, deep walks), beside its plain version
    # and its bound
    v2kept = v2check.kept
    k2_ms, p2_ms = time_tree_step_v2(v2kept)
    spec2, packed2, sel2, leaf2, idx2, ph2 = v2kept
    after2 = packed2.clone()
    _, nsel2 = fused_tree_step_v2(spec2, after2, sel2, *leaf2, idx2, ph2)
    depth = int(nsel2.path.sum(1).max())
    byts2, flops2 = tree_step_v2_work(v2kept, nsel2, after2)
    t2_bytes, t2_ops = byts2 / HBM_BYTES_PER_S * 1e3, flops2 / F32_FLOPS * 1e3
    bound2_ms = max(t2_bytes, t2_ops)
    log(f"tree_step_v2 at sim {idx2} (cap {packed2.visits.shape[1]}, deepest next path "
        f"{depth} nodes): kernel {k2_ms:.4f} ms, plain {p2_ms:.3f} ms, bound {bound2_ms:.5f} ms "
        f"({byts2} bytes, {flops2} flops)")

    # B3 on the engine's blob at the kept gather's indices, beside its plain
    # version, the library call and its bound
    blob, gidx = az._blob, gcheck.kept_idx
    k3_ms = time_events(lambda i: gather_rows(blob, gidx), 50)
    p3_ms = time_events(lambda i: gather_rows_reference(blob, gidx), 20, hold=False)
    rows_b, gidx_l = torch.arange(BATCH, device=blob.device), gidx.long()
    l3_ms = time_events(lambda i: blob[rows_b, gidx_l], 50)
    byts3 = 2 * int((gidx >= 0).sum()) * blob_w * 4 + BATCH * 4
    bound3_ms = byts3 / HBM_BYTES_PER_S * 1e3
    log(f"gather_rows [{BATCH}, {blob.shape[1]}, {blob_w}] int32: kernel {k3_ms:.4f} ms, plain "
        f"{p3_ms:.4f} ms, library x[arange(B), idx] {l3_ms:.4f} ms, bound {bound3_ms:.5f} ms "
        f"({byts3} bytes)")

    # ---- 5. where a move's device time goes -----------------------------------
    log(f"phase 5 one profiled gaz move: "
        f"{profile_move(engine, end_states, 1e3 * elapsed / SCAN_MOVES, ('tree_step_kernel',))}")
    log(f"phase 5 one profiled az n={AZ_SIMS} move: "
        f"{profile_move(az, az_end, az_ms_per_move, ('tree_step_v2_kernel', 'gather_rows_kernel'))}")

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
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
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
        "bound_by": "bytes" if t2_bytes >= t2_ops else "operations",
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
    }], "env_steps_per_s": steps_per_s, "ms_per_move": 1e3 * elapsed / SCAN_MOVES,
        "az200_env_steps_per_s": az_steps_per_s, "az200_ms_per_move": az_ms_per_move}
    print(json.dumps(result), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}),
          flush=True)


if __name__ == "__main__":
    main()

"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's self-play path (``minizero_tpu_torch``) at the flagship
config — Go 9x9 Gumbel AlphaZero, n=16, a 1 x 256 net made from a seed,
bf16 inference, 1024 games in lock-step — and holds every CUDA kernel of
that path against its plain PyTorch version on the card:

  1. device: the card's name and power limit;
  2. build: every kernel with nvcc (seconds, registers, shared memory);
  3. kernel vs plain version: one full-width move in which every tree step
     runs both from the same state; integers must match exactly, floats
     within 1e-5; then a small input played on the card and on the CPU;
  4. main path: ``move_scan`` for 8 moves after a warm-up move, with the
     launch counters read around it, legality of every action, env-steps/s,
     and each kernel's time beside its plain version's and its bound;
  5. where a move's device time goes: one move under ``torch.profiler``.

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

# flagship self-play config (bench.py:1-12)
BATCH = 1024
SCAN_MOVES = 8
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


def time_kernel(kept, reps: int = 20):
    """Mean ms per launch of the CUDA tree step on ``reps`` fresh copies of
    the kept state, by CUDA events."""
    from minizero_tpu_torch.ops.tree_kernel import fused_tree_step

    spec, trees, sel, leaf, node_idx, phase = kept
    copies = [trees.clone() for _ in range(reps + 1)]
    fused_tree_step(spec, copies[0], sel, *leaf, node_idx, phase)  # warm-up
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for t in copies[1:]:
        fused_tree_step(spec, t, sel, *leaf, node_idx, phase)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_plain(kept, reps: int = 5):
    from minizero_tpu_torch.ops.tree_kernel import tree_step_reference

    spec, trees, sel, leaf, node_idx, phase = kept
    tree_step_reference(spec, trees, sel, *leaf, node_idx, phase)  # warm-up
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        tree_step_reference(spec, trees, sel, *leaf, node_idx, phase)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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


def profile_move(engine, states, ms_per_move: float) -> str:
    """One profiled move: device busy time (the summed durations of the
    kernels and copies that ran on the card) against the unprofiled move
    time, kernel launches per move, and the kernels that take the most
    device time."""
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
        return "device time not measured (the profiler saw no device activity)"
    launches = sum(e.count for e in events if e.key.startswith(("cudaLaunchKernel", "cuLaunchKernel")))
    top = sorted(dev, key=lambda x: -x[1])[:8]
    parts = "; ".join(f"{k[:60]} {d:.2f} ms x{c}" for k, d, c in top)
    return (f"device busy {busy_ms:.2f} ms of {ms_per_move:.1f} ms/move "
            f"(idle share {1 - busy_ms / ms_per_move:.3f}), {launches} kernel launches/move; "
            f"top device time: {parts}")


def main() -> None:
    sys.path.insert(0, ROOT)
    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is False)")
    import minizero_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)
    from minizero_tpu_torch.config import algorithm_preset, default_config
    from minizero_tpu_torch.envs import make_env
    from minizero_tpu_torch.models.factory import create_network, init_network
    from minizero_tpu_torch.ops import _build
    from minizero_tpu_torch.ops.tree_kernel import fused_tree_step
    from minizero_tpu_torch.selfplay.engine import SelfPlayEngine

    # float32 comparisons run in full float32 on the card
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # ---- 1. device -----------------------------------------------------------
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    log(f"phase 1 device: {card} | torch {torch.__version__} cuda {torch.version.cuda} | "
        f"{count} device(s), using {kind}")

    # ---- 2. build --------------------------------------------------------------
    kernels = ["tree_step"]
    t = time.perf_counter()
    builds = _build.build(kernels)
    for res in builds:
        usage = "; ".join(re.sub(r"\s+", " ", line.split(":", 1)[1]).strip()
                          for line in res.log.splitlines() if "Used" in line)
        log(f"phase 2 build: {res.name}.cu in {res.seconds:.2f} s (ptxas: {usage or 'n/a'})")
    # tree_step.cu: 128 threads per block, 3 scratch rows of A floats per warp
    # in dynamic shared memory (none static)
    log(f"phase 2 tree_step shared memory: {4 * 3 * 82 * 4} bytes per 128-thread block at A=82 "
        f"({3 * 82 * 4 // 32} bytes per thread)")
    log(f"phase 2 build done in {time.perf_counter() - t:.2f} s")

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
    small = dict(algorithm_preset("gaz"))
    small.update(actor_use_gumbel_noise=False, actor_use_random_rotation_features=False,
                 actor_select_action_by_count=True)
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
    for mv in range(3):
        go, co = gpu_eng.move(gs), cpu_eng.move(cs)
        if not torch.equal(go.action.cpu(), co.action):
            fail(f"small search, move {mv}: card and CPU actions differ")
        perr = max(perr, float((go.policy_target.cpu() - co.policy_target).abs().max()))
        verr = max(verr, float((go.root_value.cpu() - co.root_value).abs().max()))
        if not (perr <= 1e-4 and verr <= 1e-5):
            fail(f"small search, move {mv}: policy target diff {perr}, root value diff {verr}")
        gs, cs = go.states, co.states
    log(f"phase 3b small search (B=64, 3 moves, f32): card == CPU actions, policy target "
        f"diff <= {perr:.2g}, root value diff <= {verr:.2g}, in {time.perf_counter() - t:.2f} s")

    # ---- 4. main path --------------------------------------------------------
    states = out.states
    warm = engine.move(states)  # warm-up move
    torch.cuda.synchronize()
    start_states = warm.states
    fused_tree_step.launches = 0
    t = time.perf_counter()
    scan, end_states, _, _ = engine.move_scan(start_states, num_moves=SCAN_MOVES)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t
    launches = {"tree_step": fused_tree_step.launches}
    want = SCAN_MOVES * (spec.num_simulations + 1)
    if launches["tree_step"] != want:
        fail(f"tree_step launched {launches['tree_step']} times on the main path, expected {want}")
    # replay the actions: each must be legal in the state it was played in
    st = start_states
    for mv in range(SCAN_MOVES):
        a = scan.action[mv].long()
        if not bool(env.legal_mask(st)[torch.arange(BATCH, device=a.device), a].all()):
            fail(f"main path: an illegal action at move {mv}")
        st = engine.reset_slots(env.step(st, a), scan.resigned[mv] | scan.ended[mv])
    if not torch.equal(st.board, end_states.board):
        fail("main path: replayed boards differ from move_scan's states")
    pt = scan.policy_target.float()
    if not (bool(torch.isfinite(pt).all()) and bool(torch.isfinite(scan.root_value).all())):
        fail("main path: non-finite policy target or root value")
    if float((pt.sum(-1) - 1.0).abs().max()) > 1e-2 or float(scan.root_value.abs().max()) > 1.0:
        fail("main path: policy targets do not sum to 1 or root values leave [-1, 1]")
    steps_per_s = BATCH * SCAN_MOVES / elapsed
    log(f"phase 4 main path: move_scan {SCAN_MOVES} moves x {BATCH} games in {elapsed:.3f} s: "
        f"{steps_per_s:.1f} env-steps/s, {1e3 * elapsed / SCAN_MOVES:.1f} ms/move; "
        f"tree_step launches {launches['tree_step']} (= {SCAN_MOVES} x {spec.num_simulations + 1}); "
        f"all actions legal; {int((scan.resigned | scan.ended).sum())} games finished")

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

    log(f"phase 5 one profiled move: {profile_move(engine, end_states, 1e3 * elapsed / SCAN_MOVES)}")

    result = {"kernels": [{
        "name": "tree_step",
        "route": "cuda",
        "source": "minizero_tpu_torch/csrc/tree_step.cu",
        "replaces": "minizero_tpu/ops/tree_kernel.py:136",
        "launches": launches["tree_step"],
        "max_abs_err": check.max_abs_err,
        "ms": k_ms,
        "plain_ms": p_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
    }], "env_steps_per_s": steps_per_s, "ms_per_move": 1e3 * elapsed / SCAN_MOVES}
    print(json.dumps(result), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}),
          flush=True)


if __name__ == "__main__":
    main()

"""Time the port's wide tree-step kernels (A > 384) of another commit and of
the working tree on the same states, in turns, on one card.

    python3 scripts/wide_tree_step_ab.py PARENT_CSRC [--reps 20] [--out FILE]

PARENT_CSRC is a directory that holds another commit's ``tree_step.cu`` and
``tree_step_v2.cu`` (``git show <commit>:minizero_tpu_torch/csrc/tree_step.cu``
and the same for ``tree_step_v2.cu``). Both builds use the port's nvcc flags
(``minizero_tpu_torch/ops/_build.py``) and go under
``minizero_tpu_torch/_build/``. The states are ``chip_smoke.py``'s: each
wide family path's kept tree step (a seeded 1 x 256 net's first move at
B=1024, simulation n/2: Clobber gaz n=16 and az n=50, Tetris Block Puzzle
gmz and gaz, Lines of Action, Surakarta, Santorini and Amazons gaz) and phase
8a's synthetic searches (A = 385, 801, 3040; N = 17, 201; the board regime
with the Gumbel root, the reward regime with PUCT, and B2). At every state
the two builds run from the same copy and must give equal outputs (integers
exact, floats within 1e-5); then each is timed by CUDA events over fresh
copies with the card held on a sleep kernel (``chip_smoke.time_events``),
in the order other, working tree, working tree, other, beside the plain
version's time and the bound (``chip_smoke.tree_step_work`` /
``tree_step_v2_work``). With ``--profile`` each state also gives the working
build's own duration by the profiler (CUPTI), its time on the selection
alone (phase 0, rows warm) and on one game (B = 1). Prints the card's name
and power limit, one line a state, and a JSON object last; exits non-zero
without a CUDA device or when the builds disagree.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import hashlib
import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

# (path name, env, algorithm, overrides, seed): the seeds of chip_smoke.py's
# phases 8d, 9d and 10d
FAMILIES = (("clobber gaz n=16", "clobber", "gaz", {}, 44),
            ("clobber az n=50", "clobber", "az", {"actor_num_simulation": cs.CLOBBER_AZ_SIMS}, 45),
            ("tetrisblockpuzzle gmz n=16", "tetrisblockpuzzle", "gmz", {}, 56),
            ("tetrisblockpuzzle gaz n=16", "tetrisblockpuzzle", "gaz", {}, 57),
            *((f"{env} gaz n=16", env, "gaz", {}, seed) for env, seed in cs.GROUP5))


def build_other(csrc: str, name: str) -> ctypes.CDLL:
    """``csrc/<name>.cu`` built with the port's flags, loaded."""
    from minizero_tpu_torch.ops import _build

    src = os.path.join(csrc, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(_build.NVCC_FLAGS).encode()).hexdigest()[:16]
    out = os.path.join(_build.BUILD_DIR, f"other_{name}-{digest}.so")
    if not os.path.exists(out):
        os.makedirs(_build.BUILD_DIR, exist_ok=True)
        res = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", out, src],
                             capture_output=True, text=True)
        if res.returncode != 0:
            sys.exit(f"nvcc failed for {src}:\n{res.stdout}{res.stderr}")
    return ctypes.CDLL(out)


def launcher(lib: ctypes.CDLL, name: str, argtypes):
    fn = getattr(lib, f"{name}_launch")
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn


def family_kept(env_name: str, algo: str, over: dict, seed: int):
    """("b1" or "v2", the kept inputs of simulation n/2 of a seeded net's
    first move), each step of the move beside the plain version."""
    from minizero_tpu_torch.config import algorithm_preset, default_config
    from minizero_tpu_torch.envs import make_env
    from minizero_tpu_torch.models.factory import create_network, init_network
    from minizero_tpu_torch.selfplay.engine import SelfPlayEngine

    cfg = default_config(env_name, **{**dict(algorithm_preset(algo)), **over})
    env = make_env(cfg)
    net = init_network(create_network(cfg, env.spec), seed=seed)
    engine = SelfPlayEngine(env, cfg, net, use_bf16=True, device="cuda", seed=seed)
    n = engine.spec.num_simulations
    if engine.use_tree_kernel_v2:
        check = cs.TreeStepV2Check(keep_sims=[n // 2])
        engine.tree_step_v2 = check
        engine.move(engine.init_batch(cs.BATCH))
        return "v2", check.kept[n // 2]
    check = cs.TreeStepCheck(keep_sim=n // 2)
    engine.tree_step = check
    engine.move(engine.init_batch(cs.BATCH))
    return "b1", check.kept


def run_once(kind: str, kept):
    """One launch from a copy of the kept state: (trees, selection)."""
    from minizero_tpu_torch.ops.tree_kernel import fused_tree_step
    from minizero_tpu_torch.ops.tree_kernel_v2 import fused_tree_step_v2

    if kind == "b1":
        spec, trees, sel, leaf, idx, phase, reward = kept
        return fused_tree_step(spec, trees.clone(), sel.clone(), *leaf, idx, phase,
                               leaf_reward=reward)
    spec, packed, sel, leaf, idx, phase = kept
    return fused_tree_step_v2(spec, packed.clone(), sel.clone(), *leaf, idx, phase)


def same(got, want) -> bool:
    for x, y in zip(got, want):
        for f in dataclasses.fields(x):
            a, b = getattr(x, f.name), getattr(y, f.name)
            if a is None and b is None:
                continue
            if a.dtype.is_floating_point:
                if a.numel() and float((a - b).abs().max()) > cs.FLOAT_ATOL:
                    return False
            elif not torch.equal(a, b):
                return False
    return True


def kernel_ms(kind: str, kept, reps: int) -> float:
    if kind == "b1":
        return cs.time_kernel(kept, reps)
    from minizero_tpu_torch.ops.tree_kernel_v2 import fused_tree_step_v2

    spec, packed, sel, leaf, idx, phase = kept
    copies = [packed.clone() for _ in range(reps + 1)]
    return cs.time_events(lambda i: fused_tree_step_v2(spec, copies[i], sel, *leaf, idx, phase),
                          reps)


def plain_and_bound(kind: str, kept):
    """(plain ms, bound ms, bound_by, deepest next path) at the kept state."""
    from minizero_tpu_torch.ops.tree_kernel import fused_tree_step
    from minizero_tpu_torch.ops.tree_kernel_v2 import fused_tree_step_v2, tree_step_v2_reference

    if kind == "b1":
        spec, trees, sel, leaf, idx, phase, reward = kept
        plain = cs.time_plain(kept, 3)
        after = trees.clone()
        _, nsel = fused_tree_step(spec, after, sel, *leaf, idx, phase, leaf_reward=reward)
        byts, flops = cs.tree_step_work(kept, nsel, after)
    else:
        spec, packed, sel, leaf, idx, phase = kept
        plain = cs.time_events(lambda i: tree_step_v2_reference(spec, packed, sel, *leaf, idx,
                                                                phase), 3, hold=False)
        after = packed.clone()
        _, nsel = fused_tree_step_v2(spec, after, sel, *leaf, idx, phase)
        byts, flops = cs.tree_step_v2_work(kept, nsel, after)
    t_bytes, t_ops = byts / cs.HBM_BYTES_PER_S * 1e3, flops / cs.F32_FLOPS * 1e3
    return (plain, max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            int(nsel.path.sum(1).max()))


def one_game(kept):
    """The kept state cut to its first game (B = 1)."""
    def cut(x):
        if x is None:
            return None
        if dataclasses.is_dataclass(x):
            return type(x)(**{f.name: cut(getattr(x, f.name)) for f in dataclasses.fields(x)})
        return x[:1].clone() if isinstance(x, torch.Tensor) else x
    return tuple(tuple(cut(y) for y in v) if isinstance(v, tuple) else cut(v) for v in kept)


def cupti_ms(kind: str, kept, reps: int = 10) -> float:
    """Mean device time of the working build's kernel by the profiler
    (CUPTI: the kernel's own duration, without the launch gap)."""
    from torch.profiler import ProfilerActivity, profile

    outs = []  # the launches' outputs, alive until the trace ends
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            outs.append(run_once(kind, kept))
        torch.cuda.synchronize()
    times = [e.device_time for e in prof.events() if "wide_kernel" in e.name]
    return sum(times) / len(times) / 1e3 if times else float("nan")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other_csrc")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default=None, help="also write the JSON object here")
    ap.add_argument("--profile", action="store_true",
                    help="also the working build's CUPTI duration, its selection-only time "
                         "and its time on one game")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from minizero_tpu_torch.ops import _build, tree_kernel, tree_kernel_v2
    from minizero_tpu_torch.ops.tree_kernel import fused_tree_step
    from minizero_tpu_torch.ops.tree_kernel_v2 import fused_tree_step_v2

    card = cs.card_line()
    print(f"card: {card}", flush=True)
    _build.build(["tree_step", "tree_step_v2"])
    fns = {
        "other": (launcher(build_other(args.other_csrc, "tree_step"), "tree_step",
                           tree_kernel._ARGTYPES),
                  launcher(build_other(args.other_csrc, "tree_step_v2"), "tree_step_v2",
                           tree_kernel_v2._ARGTYPES)),
        "working": (tree_kernel._library(), tree_kernel_v2._library()),
    }

    def use(which: str) -> None:
        b1, b2 = fns[which]
        tree_kernel._library = lambda: b1
        tree_kernel_v2._library = lambda: b2

    def counts():
        return {"tree_step": fused_tree_step.launches,
                "tree_step_rewards": fused_tree_step.launches_rewards,
                "tree_step_v2": fused_tree_step_v2.launches, "gather_rows": 0,
                "gather_rows_aligned": 0}

    def zero_counts():
        fused_tree_step.launches = fused_tree_step.launches_rewards = 0
        fused_tree_step_v2.launches = 0

    def states():
        for name, env_name, algo, over, seed in FAMILIES:
            use("working")
            kind, kept = family_kept(env_name, algo, over, seed)
            yield f"{name} (A={kept[0].action_size})", kind, kept
        for a in cs.WIDE_ACTIONS:
            for n in cs.WIDE_NODES:
                use("working")
                for regime in ("board", "reward"):
                    r = cs.wide_b1_case(a, n, regime, 30 + a + n + (regime == "reward"),
                                        zero_counts, counts, keep=True)
                    yield f"8a B1 A={a} N={n} {regime} (B={r['batch']})", "b1", r["kept"]
                r = cs.wide_b2_case(a, n, 32 + a + n, zero_counts, counts, keep=True)
                yield f"8a B2 A={a} cap={n} (B={r['batch']})", "v2", r["kept"]

    rows = []
    t0 = time.perf_counter()
    for name, kind, kept in states():
        outs = {}
        for which in ("other", "working"):
            use(which)
            outs[which] = run_once(kind, kept)
        torch.cuda.synchronize()
        if not same(outs["working"], outs["other"]):
            sys.exit(f"{name}: the two builds disagree")
        del outs
        reps = min(args.reps, cs._timing_reps(kept[1]))
        ms = {"other": [], "working": []}
        for which in ("other", "working", "working", "other"):
            use(which)
            ms[which].append(kernel_ms(kind, kept, reps))
        use("working")
        plain, bound, by, depth = plain_and_bound(kind, kept)
        row = {"state": name, "kernel": "B2" if kind == "v2" else "B1",
               "other_ms": ms["other"], "working_ms": ms["working"], "plain_ms": plain,
               "bound_ms": bound, "bound_by": by, "deepest_walk": depth}
        if args.profile:
            # where the working build's time goes: its own duration on the
            # card (CUPTI), the selection alone (phase 0, rows warm in L2),
            # and one game alone (the block's latency chain)
            row["cupti_ms"] = cupti_ms(kind, kept)
            row["selection_ms"] = cs.warm_selection_ms(kept)
            row["one_game_ms"] = kernel_ms(kind, one_game(kept), 20)
        rows.append(row)
        extra = (f"; working CUPTI {row['cupti_ms']:.5f} ms, selection only "
                 f"{row['selection_ms']:.5f} ms, B=1 {row['one_game_ms']:.5f} ms"
                 if args.profile else "")
        print(f"{name}: other {ms['other'][0]:.5f} / {ms['other'][1]:.5f} ms, working "
              f"{ms['working'][0]:.5f} / {ms['working'][1]:.5f} ms, plain {plain:.3f} ms, bound "
              f"{bound:.6f} ms ({by}), deepest walk {depth}, speed-up "
              f"{min(ms['other']) / min(ms['working']):.2f}x{extra}", flush=True)
        del kept
        torch.cuda.empty_cache()
    out = {"card": card, "seconds": time.perf_counter() - t0, "rows": rows}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()

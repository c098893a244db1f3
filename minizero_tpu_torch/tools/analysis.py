"""Training-run analysis plots (a copy of ``minizero_tpu/tools/analysis.py``;
reference ``tools/analysis.py``).

Parses ``Training.log`` / ``op.log`` written by the zero loop into loss /
accuracy / game-length / return / timing curves and writes PNGs into
``<run_dir>/analysis/`` — the reference regenerates these after every
optimization phase (``learner/train.py:231``). The port's loop writes the
JAX loop's line formats, so the parsers are the same. Matplotlib is
imported inside ``analysis`` only: a machine without it still imports this
module, and the zero loop logs one ``[Analysis] skipped`` line there.

    python -m minizero_tpu_torch.tools.analysis RUN_DIR
"""

from __future__ import annotations

import os
import re
from collections import defaultdict
from typing import Dict, List


def parse_op_log(path: str) -> Dict[str, List]:
    """nn step lines: ``nn step <s>, lr: <lr>. k: v k: v ...``
    (zero/loop.py op_log; reference train.py:222-226)."""
    out: Dict[str, List] = defaultdict(list)
    if not os.path.exists(path):
        return out
    pat = re.compile(r"nn step (\d+), lr: ([0-9.e-]+)\. (.*)")
    for line in open(path):
        m = pat.search(line)
        if not m:
            continue
        out["step"].append(int(m.group(1)))
        for key, val in re.findall(r"(\w+): ([0-9.+-eE]+)", m.group(3)):
            out[key].append(float(val))
    return out


def parse_training_log(path: str) -> Dict[str, List]:
    """Self-play statistics lines written per iteration
    (zero/loop.py; reference zero_server.cpp:240-263).

    A crash-resumed run replays its in-flight iteration, appending a second
    ``[Iteration] N`` block to the same log (runs/atari_gmz_r3_b128 has four
    iteration-1 blocks from OBS resumes). Blocks are therefore keyed by
    iteration number and the LAST occurrence wins, so resumed runs plot one
    point per iteration instead of one per attempt."""
    out: Dict[str, List] = defaultdict(list)
    if not os.path.exists(path):
        return out
    len_pat = re.compile(r"\[SelfPlay Game Lengths\].*avg: ([0-9.-]+)")
    ret_pat = re.compile(r"\[SelfPlay Game Returns\].*avg: ([0-9.-]+)")
    it_pat = re.compile(r"\[Iteration\] (\d+): self-play (\d+) games in ([0-9.]+)s")
    opt_pat = re.compile(r"\[Optimization\] iteration (\d+): \d+ steps in ([0-9.]+)s")
    blocks: Dict[int, Dict[str, float]] = {}
    cur: Dict[str, float] = {}
    for line in open(path):
        m = it_pat.search(line)
        if m:
            cur = blocks.setdefault(int(m.group(1)), {})
            cur["sp_time_s"] = float(m.group(3))
        m = len_pat.search(line)
        if m:
            cur["length_avg"] = float(m.group(1))
        m = ret_pat.search(line)
        if m:
            cur["return_avg"] = float(m.group(1))
        m = opt_pat.search(line)
        if m:
            blocks.setdefault(int(m.group(1)), cur)["op_time_s"] = float(m.group(2))
    for it in sorted(blocks):
        blk = blocks[it]
        out["iteration"].append(it)
        for key in ("sp_time_s", "length_avg", "return_avg", "op_time_s"):
            if key in blk:
                out[key].append(blk[key])
    return out


def analysis(run_dir: str) -> List[str]:
    """Write PNG curves; returns the files written (reference
    tools/analysis.py:155-226)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    out_dir = os.path.join(run_dir, "analysis")
    os.makedirs(out_dir, exist_ok=True)
    written = []

    op = parse_op_log(os.path.join(run_dir, "op.log"))
    for key in sorted(op):
        if key == "step" or not op[key]:
            continue
        fig, ax = plt.subplots(figsize=(6, 4))
        n = min(len(op["step"]), len(op[key]))
        ax.plot(op["step"][:n], op[key][:n])
        ax.set_xlabel("training step")
        ax.set_ylabel(key)
        ax.set_title(key)
        path = os.path.join(out_dir, f"{os.path.basename(run_dir)}_{key}.png")
        fig.savefig(path, dpi=100, bbox_inches="tight")
        plt.close(fig)
        written.append(path)

    tl = parse_training_log(os.path.join(run_dir, "Training.log"))
    for key in ("length_avg", "return_avg", "sp_time_s", "op_time_s"):
        if not tl.get(key):
            continue
        fig, ax = plt.subplots(figsize=(6, 4))
        ax.plot(tl[key])
        ax.set_xlabel("iteration")
        ax.set_ylabel(key)
        ax.set_title(key)
        path = os.path.join(out_dir, f"{os.path.basename(run_dir)}_{key}.png")
        fig.savefig(path, dpi=100, bbox_inches="tight")
        plt.close(fig)
        written.append(path)
    return written


if __name__ == "__main__":
    import sys

    for f in analysis(sys.argv[1]):
        print(f)

"""Trace report: device time by kernel from a ``torch.profiler`` trace (port
of ``minizero_tpu/tools/trace_report.py``, which reads the JAX profiler's
XPlane files).

Reads the Chrome trace JSON that ``torch.profiler`` exports
(``tools/profile.py -trace_dir``: ``*.pt.trace.json``, or any ``*.json``
under the directory, or one such file) and prints the top-k keys by total
time:

- ``device_filter="cuda"`` (the default) sums the card's events: kernels,
  memcpy and memset;
- ``device_filter="cpu"`` sums ``cpu_op`` events by self time (an op's time
  less that of the ops it calls), for traces taken on the CPU.

``by="op"`` groups by kernel (or op) name. ``by="source"`` groups each
kernel under what launched it: the innermost CPU op or annotation open on
the launching thread when the launch call was made, linked through the
trace's correlation ids. Kernels launched outside any op (the tree-step
and gather kernels, launched through ``ctypes``) keep their own name; a CPU
op groups under its direct caller, or itself at the top level.

    python -m minizero_tpu_torch.tools.trace_report -trace_dir /tmp/mz_trace
    python -m minizero_tpu_torch.tools.trace_report -trace_dir /tmp/mz_trace -by source
"""

from __future__ import annotations

import argparse
import collections
import glob
import json
import os
from typing import Dict, List, Tuple

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
# what may enclose a launch or an op on the CPU side
CALLER_CATEGORIES = ("cpu_op", "user_annotation", "python_function")


def _trace_files(trace_dir: str) -> List[str]:
    if os.path.isfile(trace_dir):
        return [trace_dir]
    return sorted(glob.glob(os.path.join(trace_dir, "**", "*.json"), recursive=True))


def _load_events(trace_dir: str) -> List[List[dict]]:
    """The complete ("X") events of each trace file."""
    out = []
    for path in _trace_files(trace_dir):
        with open(path) as f:
            trace = json.load(f)
        events = trace["traceEvents"] if isinstance(trace, dict) else trace
        out.append([e for e in events if e.get("ph") == "X" and "dur" in e])
    return out


def _thread(e: dict):
    return (e.get("pid"), e.get("tid"))


def _nesting(spans: List[Tuple[float, float, int]], queries: List[Tuple[float, int]]):
    """One thread's spans ``(start, end, id)`` and query times ``(t, id)``:
    returns ``{span id: id of the narrowest span enclosing it}`` and
    ``{query id: id of the narrowest span open at t}`` (None where there is
    none). Spans of one thread nest, so one sweep in time order with a
    stack of open spans answers both."""
    parent: Dict[int, object] = {}
    answer: Dict[int, object] = {}
    spans = sorted(spans, key=lambda s: (s[0], -s[1]))
    queries = sorted(queries)
    stack: List[Tuple[float, float, int]] = []
    qi = 0
    for start, end, sid in spans + [(float("inf"), float("inf"), None)]:
        while qi < len(queries) and queries[qi][0] < start:
            t, qid = queries[qi]
            while stack and stack[-1][1] <= t:
                stack.pop()
            answer[qid] = stack[-1][2] if stack else None
            qi += 1
        if sid is None:
            break
        while stack and stack[-1][1] <= start:
            stack.pop()
        parent[sid] = stack[-1][2] if stack and stack[-1][1] >= end else None
        stack.append((start, end, sid))
    return parent, answer


def _caller_spans(events: List[dict]):
    """Per thread, the CPU-side spans (ops, annotations) as ``(start, end,
    index into events)``."""
    spans = collections.defaultdict(list)
    for i, e in enumerate(events):
        if e.get("cat") in CALLER_CATEGORIES:
            spans[_thread(e)].append((float(e["ts"]), float(e["ts"]) + float(e["dur"]), i))
    return spans


def aggregate(trace_dir: str, by: str = "op", device_filter: str = "cuda"):
    """Return ``(rows, total_us)``: ``rows = [(key, total_us, count)]``
    sorted by time, descending; times in microseconds. ``trace_dir`` is a
    directory of trace files or one file."""
    if device_filter not in ("cuda", "cpu"):
        raise ValueError(f"device_filter {device_filter!r}: expected 'cuda' or 'cpu'")
    totals: collections.Counter = collections.Counter()
    counts: collections.Counter = collections.Counter()
    for events in _load_events(trace_dir):
        spans = _caller_spans(events)
        if device_filter == "cuda":
            device = [e for e in events if e.get("cat") in DEVICE_CATEGORIES]
            caller: Dict[int, object] = {}
            if by == "source":
                # correlation id -> the runtime call that launched the work
                launch = {e["args"]["correlation"]: i for i, e in enumerate(events)
                          if e.get("cat") in ("cuda_runtime", "cuda_driver")
                          and "correlation" in e.get("args", {})}
                queries = collections.defaultdict(list)
                for e in device:
                    i = launch.get(e.get("args", {}).get("correlation"))
                    if i is not None:
                        queries[_thread(events[i])].append((float(events[i]["ts"]), i))
                for thread, qs in queries.items():
                    caller.update(_nesting(spans.get(thread, []), qs)[1])
            for e in device:
                key = e["name"]
                if by == "source":
                    i = launch.get(e.get("args", {}).get("correlation"))
                    if caller.get(i) is not None:
                        key = events[caller[i]]["name"]
                totals[key] += float(e["dur"])
                counts[key] += 1
        else:
            parent: Dict[int, object] = {}
            for thread, ss in spans.items():
                parent.update(_nesting(ss, [])[0])
            child_us: collections.Counter = collections.Counter()
            for i, p in parent.items():
                if p is not None:
                    child_us[p] += float(events[i]["dur"])
            for i, e in enumerate(events):
                if e.get("cat") != "cpu_op":
                    continue
                key = e["name"]
                if by == "source" and parent.get(i) is not None:
                    key = events[parent[i]]["name"]
                totals[key] += max(float(e["dur"]) - child_us[i], 0.0)
                counts[key] += 1
    rows = [(k, v, counts[k]) for k, v in totals.most_common()]
    return rows, sum(totals.values())


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("-trace_dir", required=True)
    parser.add_argument("-by", choices=["op", "source"], default="op")
    parser.add_argument("-device", choices=["cuda", "cpu"], default="cuda")
    parser.add_argument("-top", type=int, default=40)
    args = parser.parse_args(argv)

    rows, total_us = aggregate(args.trace_dir, by=args.by, device_filter=args.device)
    if not rows:
        print("no device op events found (is this a device trace?)")
        return 1
    print(f"total device op time: {total_us / 1e3:.3f} ms over {len(rows)} keys")
    for key, us, cnt in rows[: args.top]:
        print(f"{us / 1e3:10.3f} ms  {cnt:7d}x  {key}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Self-play and training profiling (port of ``minizero_tpu/tools/profile.py``).

The reference has wall-clock instrumentation only (per-move think time,
``console.cpp:160-163``; per-phase log mining, ``tools/analysis.py:75-87``).
This tool drives the port's self-play engine (``SelfPlayEngine.move``) and
train step (``make_train_step``) from a seeded net and prints one JSON row a
phase, with the JAX tool's phase names and keys:

- ``selfplay_compile`` / ``train_compile``: the first call. On the card that
  is where the CUDA kernels are built (at first use) and cuDNN picks its
  plans; there is no trace-and-compile step as in JAX;
- ``selfplay_steady`` / ``train_steady``: ``moves`` moves and
  ``train_steps`` SGD steps after it.

Every timed window ends in ``torch.cuda.synchronize`` on the card. With
``trace_dir`` each steady window runs under ``torch.profiler`` (CPU and,
on the card, CUDA activities) and its Chrome trace is written to
``<trace_dir>/selfplay_steady.pt.trace.json`` and
``<trace_dir>/train_steady.pt.trace.json``, which Perfetto or
``chrome://tracing`` open and ``tools/trace_report.py`` sums by kernel.

    python -m minizero_tpu_torch.tools.profile -conf_str env_name=go:... \\
        -moves 16 -batch 64 -trace_dir /tmp/mz_trace
"""

from __future__ import annotations

import contextlib
import json
import os
import time

import numpy as np
import torch

SELFPLAY_TRACE = "selfplay_steady.pt.trace.json"
TRAIN_TRACE = "train_steady.pt.trace.json"


def _profiled(trace_dir: str, name: str, device: torch.device):
    """A ``torch.profiler`` session that exports its Chrome trace to
    ``trace_dir/name`` on exit; a null context without ``trace_dir``."""
    if not trace_dir:
        return contextlib.nullcontext()
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, name)
    return profile(activities=activities, on_trace_ready=lambda p: p.export_chrome_trace(path))


def profile_selfplay(cfg, moves: int = 16, batch: int = 64, trace_dir: str = "",
                     train_steps: int = 4, device=None) -> list:
    """Time (and with ``trace_dir`` trace) self-play moves and SGD steps at
    ``cfg``'s widths; returns the printed rows. Runs on the card unless
    ``device="cpu"``; the network evaluates in bf16 on the card."""
    from minizero_tpu_torch import resolve_device
    from minizero_tpu_torch.envs import make_env
    from minizero_tpu_torch.learner.replay import GameRecord, ReplayBuffer
    from minizero_tpu_torch.learner.train import init_train_state, make_train_step
    from minizero_tpu_torch.models.factory import create_network, init_network
    from minizero_tpu_torch.selfplay.engine import SelfPlayEngine

    dev = resolve_device(device)
    env = make_env(cfg)
    net = init_network(create_network(cfg, env.spec), seed=0).to(dev)
    engine = SelfPlayEngine(env, cfg, net, device=dev, seed=1, use_bf16=dev.type == "cuda")
    states = engine.init_batch(batch)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    rows = []

    def record(phase, seconds, extra=None):
        row = {"phase": phase, "seconds": round(seconds, 4)}
        if extra:
            row.update(extra)
        rows.append(row)
        print(json.dumps(row), flush=True)

    sync()
    t0 = time.time()
    out = engine.move(states)
    sync()
    record("selfplay_compile", time.time() - t0)
    states = out.states

    with _profiled(trace_dir, SELFPLAY_TRACE, dev):
        t0 = time.time()
        for _ in range(moves):
            states = engine.move(states).states
        sync()
        dt = time.time() - t0
    record("selfplay_steady", dt, {
        "moves": moves, "batch": batch,
        "env_steps_per_sec": round(moves * batch / dt, 1),
        "sims_per_sec": round(moves * batch * cfg.actor_num_simulation / dt, 1),
    })

    spec = env.spec
    buf = ReplayBuffer(cfg, spec)
    n = min(spec.max_game_length, 32)
    buf.add_game(GameRecord(
        actions=np.zeros(n, np.int32),
        policy=np.full((n, spec.action_size), 1.0 / spec.action_size, np.float16),
        values=np.zeros(n, np.float32),
        rewards=np.zeros(n, np.float32),
        features=np.zeros((n, spec.input_height, spec.input_width, spec.num_input_channels),
                          np.uint8),
        result=0.0,
    ))
    state = init_train_state(cfg, net)
    step = make_train_step(cfg, env, net)
    generator = torch.Generator(device=dev).manual_seed(2)
    np_rng = np.random.RandomState(0)
    sample = (buf.sample_muzero if cfg.nn_type_name.lower() != "alphazero"
              else buf.sample_alphazero)

    def one():
        batch_data = sample(cfg.learner_batch_size, np_rng)
        batch_data.pop("sampled_index")
        return step(state, batch_data, generator)

    t0 = time.time()
    one()
    sync()
    record("train_compile", time.time() - t0)
    with _profiled(trace_dir, TRAIN_TRACE, dev):
        t0 = time.time()
        for _ in range(train_steps):
            one()
        sync()
        dt = time.time() - t0
    record("train_steady", dt, {
        "steps": train_steps,
        "steps_per_sec": round(train_steps / dt, 2),
        "samples_per_sec": round(train_steps * cfg.learner_batch_size / dt, 1),
    })
    if trace_dir:
        print(json.dumps({"trace_dir": trace_dir}), flush=True)
    return rows


def main(argv=None, device=None) -> int:
    """The CLI; ``device`` (for callers such as the tests) takes the place
    of ``-platform``."""
    import argparse

    from minizero_tpu_torch.__main__ import _device_for, build_config

    parser = argparse.ArgumentParser(description="minizero_tpu_torch profiler")
    parser.add_argument("-conf_file", default="")
    parser.add_argument("-conf_str", default="")
    parser.add_argument("-moves", type=int, default=16)
    parser.add_argument("-batch", type=int, default=64)
    parser.add_argument("-train_steps", type=int, default=4)
    parser.add_argument("-trace_dir", default="")
    parser.add_argument("-platform", default="", help="cpu, or gpu / cuda (the default)")
    args = parser.parse_args(argv)
    if device is None:
        device = _device_for(args.platform)
    profile_selfplay(build_config(args), moves=args.moves, batch=args.batch,
                     trace_dir=args.trace_dir, train_steps=args.train_steps, device=device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Replay Atari records into videos (port of
``minizero_tpu/tools/to_video.py``; reference ``tools/to-video.py``).

The reference rebuilds each episode in gym from the record's SD seed, checks
the replayed return against the RE tag, and writes an mp4 per record. Here
the replay runs through the port's host env,
:class:`minizero_tpu_torch.envs.atari.AtariEnv` (the same deterministic seed
reset, ``atari.cpp:41-46``; ``ale_factory`` injects the ALE), and the writer
uses whichever matplotlib animation backend is available (ffmpeg -> mp4,
else pillow -> gif). Matplotlib is imported inside ``write_video`` only.

    python -m minizero_tpu_torch.tools.to_video -in_file RECORDS.sgf -out_dir videos
"""

from __future__ import annotations

import os
from typing import Callable, List, Optional

import numpy as np


def replay_frames(record: str, rom_dir: str = "/opt/atari57/",
                  ale_factory=None, frame_hook: Optional[Callable] = None):
    """Replay one record; returns (frames, replayed_score, record_score).

    ``frames`` are the raw full-resolution screens, one per env step (the
    reference collects ``env.render()`` per act, to-video.py:50-55)."""
    from minizero_tpu_torch.envs.atari import ACTION_SIZE, AtariEnv
    from minizero_tpu_torch.selfplay.record import parse_game

    tags, moves = parse_game(record, ACTION_SIZE)
    game = tags.get("GM", "")
    if not game.startswith("atari") or "SD" not in tags:
        raise ValueError("not an atari record with an SD seed tag")
    env = AtariEnv(
        game_name=game[len("atari_"):] if game.startswith("atari_") else game,
        rom_dir=rom_dir, seed=int(tags["SD"]), ale_factory=ale_factory,
    )
    frames: List[np.ndarray] = [np.asarray(env.ale.getScreenRGB())]
    for m in moves:
        env.step(int(m["action"]))
        frames.append(np.asarray(env.ale.getScreenRGB()))
        if frame_hook:
            frame_hook(frames[-1])
    return frames, env.eval_score(), float(tags.get("RE", 0.0))


def write_video(frames: List[np.ndarray], out_path: str, fps: int = 60) -> str:
    """Write frames with the best available matplotlib animation writer;
    returns the actual output path (extension may switch to .gif)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.animation import FFMpegWriter, PillowWriter, writers

    if writers.is_available("ffmpeg"):
        writer = FFMpegWriter(fps=fps)
    else:
        writer = PillowWriter(fps=min(fps, 50))
        base, _ = os.path.splitext(out_path)
        out_path = base + ".gif"
    h, w = frames[0].shape[:2]
    fig = plt.figure(figsize=(w / 100, h / 100), dpi=100)
    ax = fig.add_axes([0, 0, 1, 1])
    ax.set_axis_off()
    im = ax.imshow(frames[0])
    with writer.saving(fig, out_path, dpi=100):
        for f in frames:
            im.set_data(f)
            writer.grab_frame()
    plt.close(fig)
    return out_path


def record_to_video(record: str, out_dir: str, index: int = 0, fps: int = 60,
                    rom_dir: str = "/opt/atari57/", ale_factory=None,
                    force: bool = False) -> Optional[str]:
    """One record -> one video file named ``<game>-<index>.<ext>``
    (reference to-video.py:64-89, including the replay-consistency check)."""
    from minizero_tpu_torch.selfplay.record import parse_game

    tags, _ = parse_game(record, 18)
    game = tags.get("GM", "atari").replace("atari_", "")
    base = os.path.join(out_dir, f"{game}-{index}")
    for ext in (".mp4", ".gif"):
        if not force and os.path.isfile(base + ext):
            print(f"*** {base}{ext} exists! Use --force to overwrite it. ***")
            return None
    frames, score, record_score = replay_frames(record, rom_dir, ale_factory)
    if score != record_score:
        print(f"replay mismatch, score: {score}, record_score: {record_score}")
    os.makedirs(out_dir, exist_ok=True)
    return write_video(frames, base + ".mp4", fps=fps)


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description="minizero record -> video")
    parser.add_argument("-in_file", required=True, help="record file (one per line)")
    parser.add_argument("-out_dir", default="videos")
    parser.add_argument("-fps", type=int, default=60)
    parser.add_argument("-rom_dir", default="/opt/atari57/")
    parser.add_argument("--force", action="store_true")
    args = parser.parse_args(argv)
    written = 0
    with open(args.in_file) as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            out = record_to_video(line, args.out_dir, index=i, fps=args.fps,
                                  rom_dir=args.rom_dir, force=args.force)
            if out:
                print(f"wrote {out}")
                written += 1
    return 0 if written else 1


if __name__ == "__main__":
    raise SystemExit(main())

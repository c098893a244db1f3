"""Board position renders (port of ``minizero_tpu/tools/plot_board.py``;
reference ``tools/plot_board.py``): matplotlib images of go/othello/hex-family
positions from record files. The record is replayed into the port's env on
the CPU (a batch of one game); matplotlib is imported inside the drawing
functions only.

    python -m minizero_tpu_torch.tools.plot_board RECORDS.sgf [OUT.png]
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from minizero_tpu_torch.selfplay.record import parse_game


def board_from_record(content: str, env_name: Optional[str] = None, move_limit: Optional[int] = None):
    """Replay a record's actions into the named env on the CPU; returns
    (env, state), the state a batch of one game."""
    from minizero_tpu_torch.config import default_config
    from minizero_tpu_torch.envs import make_env

    tags, moves = parse_game(content, action_size=1 << 20)
    name = env_name or tags.get("GM", "go").split("_")[0]
    size = int(tags.get("SZ", 0) or 0)
    cfg = default_config(name)
    if size:
        cfg = cfg.replace(env_board_size=size)
    env = make_env(cfg)
    state = env.init(1, device="cpu")
    for mv in moves[: move_limit if move_limit is not None else len(moves)]:
        state = env.step(state, torch.tensor([int(mv["action"])], dtype=torch.int32))
    return env, state


def _board_cells(state) -> np.ndarray:
    """The first game's board as a flat numpy row."""
    board = state.board
    if isinstance(board, torch.Tensor):
        board = board[0].cpu().numpy() if board.dim() > 1 else board.cpu().numpy()
    return np.asarray(board).reshape(-1)


def plot_board(env, state, out_path: str, title: str = "") -> str:
    """Stone-diagram PNG; dispatches to hex-family geometry where the env
    is hex-connected (reference tools/plot_board.py:10-21 dispatches
    go/othello/hex the same way)."""
    if env.spec.name.startswith(("hex", "havannah")):
        return plot_hex_board(env, state, out_path, title)
    return plot_square_board(env, state, out_path, title)


def plot_hex_board(env, state, out_path: str, title: str = "") -> str:
    """Hex-family PNG: hexagonal cells in the sheared-rhombus layout with
    the two players' border edges (reference plot_hex_board,
    tools/plot_board.py:148-249). For havannah the hexagonal outline (the
    cells with |r - c| below the base size) is drawn instead of rhombus
    borders."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.patches as mpatches
    import matplotlib.pyplot as plt

    is_hex = env.spec.name.startswith("hex")
    side = env.spec.board_size  # havannah's spec uses the extended grid
    board = _board_cells(state)[: side * side].reshape(side, side)
    valid = np.ones((side, side), bool)
    if not is_hex:
        # havannah's hexagonal outline: cells with |r - c| < base size
        base = (side + 1) // 2
        r, c = np.mgrid[0:side, 0:side]
        valid = np.abs(r - c) <= base - 1

    radius = 1.0 / np.sqrt(3.0)
    fig, ax = plt.subplots(figsize=(side / 1.6 + 1.5, side / 1.8 + 1.5))
    coords = {}
    for r in range(side):
        for c in range(side):
            if not valid[r, c]:
                continue
            # axial layout: each row shifts half a cell (reference
            # transform_cartesian_coords, tools/plot_board.py:258-267).
            # hex's rhombus shears right; havannah's |r-c|-bounded grid
            # shears left so the board renders as a regular hexagon
            x = c + 0.5 * r if is_hex else c - 0.5 * r
            y = -r * np.sqrt(3.0) / 2.0
            coords[(r, c)] = (x, y)
            ax.add_patch(mpatches.RegularPolygon(
                (x, y), numVertices=6, radius=radius,
                orientation=0.0, facecolor="#deb06f", edgecolor="k", lw=0.8,
                zorder=1))
            v = int(board[r, c])
            if v == 1:
                ax.scatter(x, y, s=210, c="black", zorder=3)
            elif v == 2:
                ax.scatter(x, y, s=210, c="white", edgecolors="black", zorder=3)

    if is_hex:
        # player border edges (reference draws half-hexagons per edge cell,
        # tools/plot_board.py:182-203): black owns top/bottom, white the sides
        lw = 6.0
        for c in range(side):
            x0, y0 = coords[(0, c)]
            ax.plot([x0 - 0.5, x0 + 0.5], [y0 + radius * 0.9] * 2, c="black", lw=lw, zorder=2)
            x1, y1 = coords[(side - 1, c)]
            ax.plot([x1 - 0.5, x1 + 0.5], [y1 - radius * 0.9] * 2, c="black", lw=lw, zorder=2)
        for r in range(side):
            x0, y0 = coords[(r, 0)]
            x1, y1 = coords[(r, side - 1)]
            # white edges get a black key-line so they read on white paper
            ax.plot([x0 - 0.62, x0 - 0.32], [y0 + 0.25, y0 - 0.25], c="black", lw=lw + 2, zorder=2)
            ax.plot([x0 - 0.62, x0 - 0.32], [y0 + 0.25, y0 - 0.25], c="white", lw=lw - 1, zorder=2.1)
            ax.plot([x1 + 0.32, x1 + 0.62], [y1 + 0.25, y1 - 0.25], c="black", lw=lw + 2, zorder=2)
            ax.plot([x1 + 0.32, x1 + 0.62], [y1 + 0.25, y1 - 0.25], c="white", lw=lw - 1, zorder=2.1)

    xs = [p[0] for p in coords.values()]
    ax.set_xlim(min(xs) - 1.2, max(xs) + 1.2)
    ax.set_ylim(-side * np.sqrt(3.0) / 2.0 - 1.2, 1.2)
    ax.set_aspect("equal")
    ax.axis("off")
    if title:
        ax.set_title(title)
    fig.savefig(out_path, dpi=100, bbox_inches="tight", facecolor="white")
    plt.close(fig)
    return out_path


def plot_square_board(env, state, out_path: str, title: str = "") -> str:
    """Stone-diagram PNG for square-board envs."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n = env.spec.board_size
    board = _board_cells(state)[: n * n].reshape(n, n)
    fig, ax = plt.subplots(figsize=(n / 2 + 1, n / 2 + 1))
    ax.set_facecolor("#deb06f")
    for i in range(n):
        ax.plot([0, n - 1], [i, i], color="k", lw=0.5, zorder=1)
        ax.plot([i, i], [0, n - 1], color="k", lw=0.5, zorder=1)
    for r in range(n):
        for c in range(n):
            v = int(board[r, c])
            if v == 1:
                ax.scatter(c, r, s=220, c="black", zorder=2)
            elif v == 2:
                ax.scatter(c, r, s=220, c="white", edgecolors="black", zorder=2)
            elif v == 3:
                ax.scatter(c, r, s=150, c="red", marker="x", zorder=2)
    ax.set_xlim(-0.7, n - 0.3)
    ax.set_ylim(-0.7, n - 0.3)
    ax.set_xticks(range(n))
    ax.set_xticklabels(chr(ord("A") + c + (1 if c >= 8 else 0)) for c in range(n))
    ax.set_yticks(range(n))
    ax.set_yticklabels(str(r + 1) for r in range(n))
    ax.set_aspect("equal")
    if title:
        ax.set_title(title)
    fig.savefig(out_path, dpi=100, bbox_inches="tight")
    plt.close(fig)
    return out_path


if __name__ == "__main__":
    import sys

    with open(sys.argv[1]) as f:
        first = f.readline().strip()
    env, state = board_from_record(first)
    print(plot_board(env, state, sys.argv[2] if len(sys.argv) > 2 else "board.png"))

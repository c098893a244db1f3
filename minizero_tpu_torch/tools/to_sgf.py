"""Convert minizero-format game records to standard SGF (port of
``minizero_tpu/tools/to_sgf.py``; reference ``tools/to-sgf.py``): action ids
become SGF board coordinates so records open in GoGui/Sabaki.

    python -m minizero_tpu_torch.tools.to_sgf IN.sgf OUT.sgf
"""

from __future__ import annotations

import sys
from typing import List

from minizero_tpu_torch.selfplay.record import parse_game

_GM_NUMBER = {"go": 1, "othello": 2, "hex": 11}


def action_to_sgf_coord(action_id: int, board_size: int) -> str:
    """reference SGFLoader::actionIDToSGFString: 'a'+x, 'a'+(size-1-y)."""
    if action_id >= board_size * board_size:
        return ""  # pass
    x = action_id % board_size
    y = action_id // board_size
    return chr(ord("a") + x) + chr(ord("a") + (board_size - 1 - y))


def record_to_sgf(content: str) -> str:
    tags, moves = parse_game(content, action_size=1 << 20)
    board_size = int(tags.get("SZ", 9))
    game = tags.get("GM", "go").split("_")[0]
    gm = _GM_NUMBER.get(game, 1)
    parts: List[str] = [f"(;FF[4]GM[{gm}]SZ[{board_size}]"]
    if "RE" in tags:
        parts.append(f"RE[{tags['RE']}]")
    for mv in moves:
        coord = action_to_sgf_coord(int(mv["action"]), board_size)
        parts.append(f";{mv['player']}[{coord}]")
        if "V" in mv:
            parts.append(f"C[V: {mv['V']}]")
    parts.append(")")
    return "".join(parts)


def convert_file(in_path: str, out_path: str) -> int:
    """Each non-empty record line of ``in_path`` as one SGF line of
    ``out_path``; returns the number of records."""
    n = 0
    with open(in_path) as fin, open(out_path, "w") as fout:
        for line in fin:
            line = line.strip()
            if not line:
                continue
            fout.write(record_to_sgf(line) + "\n")
            n += 1
    return n


if __name__ == "__main__":
    print(convert_file(sys.argv[1], sys.argv[2]), "games converted")

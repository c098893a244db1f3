"""Self-play game records (port of ``minizero_tpu/selfplay/record.py``; a
copy: the same strings, byte for byte).

Serialises finished games in the reference's SGF-like schema
(``minizero/environment/base/base_env.h:207-233``):

    (;GM[tictactoe]RE[1]SZ[3];B[4]P[4:10,0:6]V[0.5]R[0];W[0]P[...]...)

with per-move ``P`` (search policy distribution ``action:weight`` pairs), ``V``
(root mean value) and ``R`` (env reward) tags — so records interoperate with
the reference's tooling conventions and round-trip into training targets. The
parser accepts reference-generated records too (actions stored as ids).
The move stream is written by the native codec (``native/codec.cpp``) where
it loads; the pure-Python writer below (``serialize_moves_plain``) is its
plain version and gives the same string.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

import numpy as np

from minizero_tpu_torch import native
from minizero_tpu_torch.learner.replay import GameRecord

_PLAYER_CHARS = {1: "B", 2: "W"}
_CHAR_PLAYERS = {"B": 1, "W": 2}


def _escape(s: str) -> str:
    return re.sub(r"([()\[\]\\])", r"\\\1", s)


def _policy_string(policy: np.ndarray) -> str:
    """Sparse ``action:weight`` pairs for nonzero entries (reference
    ``MCTS::getSearchDistributionString``, mcts.cpp:126-137), each weight as
    C's ``%g`` prints it, as the native codec does. (The JAX package's
    pure-Python fallback prints 4 significant digits, its native codec 6:
    its two writers disagree, and this one follows the codec.)"""
    idx = np.nonzero(policy > 0)[0]
    return ",".join(f"{i}:{float(policy[i]):g}" for i in idx)


def serialize_moves_plain(record: GameRecord, player_arr: np.ndarray) -> str:
    """The move stream in pure Python: the native codec's plain version."""
    chunks = []
    for i in range(record.length):
        chunks.append(f";{_PLAYER_CHARS[int(player_arr[i])]}[{record.actions[i]}]")
        chunks.append(f"P[{_policy_string(np.asarray(record.policy[i], np.float32))}]")
        chunks.append(f"V[{float(record.values[i]):g}]")
        chunks.append(f"R[{float(record.rewards[i]):g}]")
    return "".join(chunks)


def serialize_game(
    name: str,
    record: GameRecord,
    board_size: int,
    players: Tuple[int, ...] = (),
    model_file: str = "",
    extra_tags: Optional[Dict[str, str]] = None,
    plain: bool = False,
) -> str:
    """One-line record (newline-free, like the reference's outputGame);
    ``plain`` takes the pure-Python move writer even where the native codec
    loads."""
    tags = {"GM": name, "RE": f"{record.result:g}", "SZ": str(board_size)}
    if model_file:
        tags["EV"] = model_file
    lo, hi = record.data_range
    if (lo, hi) != (0, max(0, record.length - 1)):
        tags["DLEN"] = f"{lo}-{hi}"
    if extra_tags:
        tags.update(extra_tags)
    parts = ["(;"]
    parts.extend(f"{k}[{_escape(v)}]" for k, v in tags.items())
    player_arr = np.asarray(
        players if players else [(1 if i % 2 == 0 else 2) for i in range(record.length)],
        np.int8,
    )
    moves = None if plain else native.serialize_moves(
        np.asarray(record.actions, np.int32),
        player_arr,
        np.asarray(record.policy, np.float32),
        np.asarray(record.values, np.float32),
        np.asarray(record.rewards, np.float32),
    )
    if moves is None:  # the plain version (no native toolchain, or asked for)
        moves = serialize_moves_plain(record, player_arr)
    parts.append(moves)
    parts.append(")")
    return "".join(parts)


# "unrolled loop" escape pattern: the naive ((?:\\.|[^\]\\])*) alternation
# tries the escape branch per character, which crawls over multi-megabyte
# Atari OBS hex payloads (~1.5 s/record -> 20+ min window resumes); the
# unrolled form scans the common no-escape run with one character class
_TOKEN = re.compile(r"(;?)([A-Za-z]+)\[([^\]\\]*(?:\\.[^\]\\]*)*)\]")


def parse_game(content: str, action_size: int) -> Tuple[Dict[str, str], List[Dict[str, str]]]:
    """Parse a record into (tags, move list with player/action/P/V/R)."""
    tags: Dict[str, str] = {}
    moves: List[Dict[str, str]] = []
    for semi, key, value in _TOKEN.findall(content):
        if "\\" in value:
            value = re.sub(r"\\(.)", r"\1", value)
        if key in _CHAR_PLAYERS and semi == ";":
            moves.append({"player": key, "action": value})
        elif moves and key not in ("OBS", "LL"):
            moves[-1][key] = value
        else:
            # game-level tags; OBS/LL are appended after the move list
            tags[key] = value
    return tags, moves


def game_record_from_string(
    content: str,
    action_size: int,
    feature_builder=None,
) -> Tuple[Dict[str, str], GameRecord]:
    """Rebuild a GameRecord (without feature planes unless ``feature_builder``
    replays them) — used for resume-from-disk (reference rebuilds its buffer
    from the last ``zero_replay_buffer`` sgf files, train.py:40-48)."""
    tags, moves = parse_game(content, action_size)
    length = len(moves)
    actions = np.zeros(length, np.int32)
    policy = np.zeros((length, action_size), np.float16)
    values = np.zeros(length, np.float32)
    rewards = np.zeros(length, np.float32)
    for i, m in enumerate(moves):
        actions[i] = int(m["action"])
        p_str = m.get("P", "")
        if p_str:
            for pair in p_str.split(","):
                a, _, w = pair.partition(":")
                policy[i, int(a)] = float(w)
            total = policy[i].astype(np.float32).sum()
            if total > 0:
                policy[i] = (policy[i].astype(np.float32) / total).astype(np.float16)
        else:
            policy[i, actions[i]] = 1.0
        values[i] = float(m.get("V", 0.0))
        rewards[i] = float(m.get("R", 0.0))
    dlen = tags.get("DLEN", "")
    if dlen:
        lo, _, hi = dlen.partition("-")
        data_range = (int(lo), int(hi))
    else:
        data_range = (0, max(0, length - 1))
    features = feature_builder(actions) if feature_builder else np.zeros((length, 1, 1, 1), np.uint8)
    return tags, GameRecord(
        actions=actions,
        policy=policy,
        values=values,
        rewards=rewards,
        features=features,
        result=float(tags.get("RE", 0.0)),
        data_range=data_range,
    )

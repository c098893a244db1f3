"""Observation (OBS tag) handling for long-episode records (port of
``minizero_tpu/tools/obs.py``).

Reference: ``minizero/utils/utils.h:35-91`` (gzip + hex-string
compression) and the ``-mode remove_obs / recover_obs`` tools
(``minizero/environment/atari/obs_{remover,recover}.{h,cpp}``,
``tools/handle_obs.sh``). An OBS tag keeps an Atari record's per-step u8
frames inside the record, so a resumed run rebuilds its frame window from
the records alone. The zero loop and ``-mode sp`` write the tags with
``pack_observations``; ``ZeroLoop.resume`` reads them back with
``unpack_observations``. ``remove_obs`` strips them to shrink archives;
``recover_obs`` with an ``AtariObsReplayer`` puts them back by replaying
each episode from its SD seed (envs reset deterministically from it,
``atari.cpp:41-46``).
"""

from __future__ import annotations

import re
import zlib
from typing import Callable, Optional

import numpy as np

# an OBS tag whose payload may hold escaped characters; the unrolled form
# scans the (megabytes long) unescaped runs with one character class
_OBS_TAG = re.compile(r"OBS\[([^\]\\]*(?:\\.[^\]\\]*)*)\]")


def compress_obs(data: bytes) -> str:
    """gzip + hex (reference compressString / binaryToHexString,
    utils.h:35-68)."""
    return zlib.compress(data, level=6).hex()


def decompress_obs(text: str) -> bytes:
    return zlib.decompress(bytes.fromhex(text))


def pack_observations(obs: np.ndarray) -> str:
    """A u8 observation stack as an OBS tag payload: ndim, shape (int32)
    and the bytes, compressed."""
    arr = np.ascontiguousarray(obs, np.uint8)
    header = np.asarray(arr.shape, np.int32).tobytes()
    return compress_obs(np.asarray([arr.ndim], np.int32).tobytes() + header + arr.tobytes())


def unpack_observations(payload: str) -> np.ndarray:
    raw = decompress_obs(payload)
    ndim = int(np.frombuffer(raw[:4], np.int32)[0])
    shape = tuple(np.frombuffer(raw[4:4 + 4 * ndim], np.int32))
    return np.frombuffer(raw[4 + 4 * ndim:], np.uint8).reshape(shape)


def remove_obs(record: str) -> str:
    """Strip OBS tags (reference obs_remover.cpp:17-50)."""
    return _OBS_TAG.sub("", record)


def remove_obs_file(in_path: str, out_path: str) -> int:
    n = 0
    with open(in_path) as fin, open(out_path, "w") as fout:
        for line in fin:
            fout.write(remove_obs(line.rstrip("\n")) + "\n")
            n += 1
    return n


def recover_obs(record: str, replay_observations: Callable[[str], Optional[np.ndarray]]) -> str:
    """Re-attach an OBS tag by deterministic replay (reference
    obs_recover.h:19-83). ``replay_observations(record)`` regenerates the
    u8 observation stack from the record's seed and actions; records it
    cannot handle (None) pass through unchanged, as do records that still
    carry a tag."""
    if _OBS_TAG.search(record):
        return record
    obs = replay_observations(record)
    if obs is None:
        return record
    idx = record.rfind(")")
    return record[:idx] + f"OBS[{pack_observations(obs)}]" + record[idx:]


class AtariObsReplayer:
    """Regenerates newest-frame observations for (possibly chunked) Atari
    records by replaying each episode from its SD seed (reference
    obs_recover.h:19-83). A chunk is aligned against the episode's replay so
    far by its OFF tag (the absolute position of its first move) where it
    has one, else by the offset where its actions continue the replay's
    action stream (the reference's prefix matching). Consumed prefixes are
    trimmed, and a session ends with its episode. ``ale_factory(seed)``
    builds the ALE handle (default: ``ale_py``'s, which raises
    ``ImportError`` where it is not installed)."""

    def __init__(self, rom_dir: str = "/opt/atari57/", ale_factory=None):
        self.rom_dir = rom_dir
        self.ale_factory = ale_factory
        self._sessions: dict = {}

    def __call__(self, record: str) -> Optional[np.ndarray]:
        from minizero_tpu_torch.envs.atari import ACTION_SIZE, AtariEnv
        from minizero_tpu_torch.selfplay.record import parse_game

        tags, moves = parse_game(record, ACTION_SIZE)
        game = tags.get("GM", "")
        if not game.startswith("atari") or "SD" not in tags:
            return None
        seed = int(tags["SD"])
        key = (game, seed)
        actions = [int(m["action"]) for m in moves]
        sess = self._sessions.get(key)
        if sess is None:
            env = AtariEnv(game_name=game[len("atari_"):] if game.startswith("atari_") else game,
                           rom_dir=self.rom_dir, seed=seed, ale_factory=self.ale_factory)
            # "base" is the episode position of actions[0] and frames[0]
            sess = {"env": env, "actions": [], "frames": [env.newest_frame().copy()], "base": 0}
            self._sessions[key] = sess
        played = sess["actions"]
        base = sess["base"]
        end = base + len(played)  # episode positions played so far
        offset = None
        if "OFF" in tags:
            o = int(tags["OFF"])
            if base <= o <= end and actions[: end - o] == played[o - base:]:
                offset = o
        if offset is None:
            for o in range(max(base, end - len(actions)), end + 1):
                if actions[: end - o] == played[o - base:]:
                    offset = o
                    break
        if offset is None:
            return None  # not a continuation of this episode's replay
        for a in actions[end - offset:]:
            sess["env"].step(a)
            played.append(a)
            sess["frames"].append(sess["env"].newest_frame().copy())
        out = np.stack(sess["frames"][offset - base: offset - base + len(actions)])
        drop = offset - base
        if drop > 0:
            del played[:drop]
            del sess["frames"][:drop]
            sess["base"] = offset
        if sess["env"].is_terminal():
            del self._sessions[key]
        return out


def recover_obs_file(in_path: str, out_path: str, replayer) -> int:
    n = 0
    with open(in_path) as fin, open(out_path, "w") as fout:
        for line in fin:
            line = line.rstrip("\n")
            if line:
                line = recover_obs(line, replayer)
            fout.write(line + "\n")
            n += 1
    return n

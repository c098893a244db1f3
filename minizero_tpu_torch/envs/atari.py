"""Atari (ALE), the one host-side env family (port of
``minizero_tpu/envs/atari.py``; reference
``minizero/environment/atari/atari.{h,cpp}``).

Semantics kept: the 18-action full set with the game's minimal set defining
legality; frameskip 4 with summed rewards (``atari.cpp:79-83``); sticky
actions p=0.25 and a 108k frame cap set on the ALE (``atari.cpp:53-56``);
96 x 96 RGB observations; features = 8 history steps x [1 action plane
(id/18) + 3 RGB planes] in NHWC (``atari.cpp:112-122``); a lives history per
step for the episodic-life n-step returns (``atari.cpp:259-277``);
deterministic replay from the episode seed (``atari.cpp:41-46``).

The ALE runs on the host (numpy: ``AtariEnv``, ``AtariVecEnv`` with its
batched frame ring); the MuZero search runs on the device
(``selfplay/host_engine.py``), consulting the env at the root only. Here in
torch: the static spec and the dynamics net's action planes. The ALE handle
is injectable (``ale_factory``), so tests and the smoke run use
``FakeALE``; the real backend needs the optional ``ale_py`` package and its
ROMs, and without it ``make_ale`` raises ``ImportError``.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np
import torch

from minizero_tpu_torch.config import Config
from minizero_tpu_torch.envs.base import EnvSpec

ACTION_SIZE = 18
RESOLUTION = 96
FRAME_SKIP = 4
HISTORY = 8
MAX_FRAMES = 108000
STICKY_PROB = 0.25


def atari_spec(game_name: str = "ms_pacman") -> EnvSpec:
    return EnvSpec(
        name=f"atari_{game_name}",
        num_players=1,
        board_size=RESOLUTION,
        action_size=ACTION_SIZE,
        num_input_channels=HISTORY * 4,
        input_height=RESOLUTION,
        input_width=RESOLUTION,
        binary_features=False,
        hidden_height=6,
        hidden_width=6,
        num_action_feature_channels=ACTION_SIZE,
        discrete_value_size=601,
        max_game_length=MAX_FRAMES // FRAME_SKIP,
    )


def action_features(action: torch.Tensor, spec: EnvSpec) -> torch.Tensor:
    """f32[B, 18, hidden_H, hidden_W]: the chosen action's channel filled
    with ones, NCHW (reference ``atari.cpp`` getActionFeatures)."""
    onehot = (torch.arange(ACTION_SIZE, device=action.device)[None, :]
              == action.long()[:, None]).to(torch.float32)
    return onehot[:, :, None, None].expand(-1, -1, spec.hidden_height, spec.hidden_width)


def make_ale(rom_path: str, seed: int):
    """A real ALE handle (needs the optional ``ale_py`` package)."""
    try:
        from ale_py import ALEInterface
    except ImportError as e:
        raise ImportError(
            "Atari support needs the optional 'ale_py' package; inject a "
            "custom ale_factory (e.g. FakeALE) or install ale_py") from e
    ale = ALEInterface()
    ale.setInt("random_seed", seed)
    ale.setInt("max_num_frames_per_episode", MAX_FRAMES)
    ale.setFloat("repeat_action_probability", STICKY_PROB)
    ale.loadROM(rom_path)
    return ale


class FakeALE:
    """A small ALE stand-in: deterministic pseudo-screens, reward = the
    action id's parity, 3 lives, the episode ends after ``length`` frames.
    Screen shifts accumulate and are applied once per ``getScreenRGB``
    (consecutive rolls compose additively)."""

    def __init__(self, seed: int = 0, length: int = 64, minimal_actions=(0, 1, 2, 3)):
        self.rng = np.random.RandomState(seed)
        self.frame = 0
        self.length = length
        self._minimal = list(minimal_actions)
        self._base = self.rng.randint(0, 255, (210, 160, 3), np.uint8)
        self._shift = 0

    def act(self, action: int) -> float:
        self.frame += 1
        self._shift = (self._shift + int(action) + 1) % self._base.shape[0]
        return float(int(action) % 2)

    def game_over(self, *_args, **_kwargs) -> bool:
        return self.frame >= self.length

    def lives(self) -> int:
        return 3 - min(2, self.frame // max(1, self.length // 3))

    def getMinimalActionSet(self):
        return list(self._minimal)

    def getScreenRGB(self):
        return np.roll(self._base, self._shift, axis=0) if self._shift else self._base

    def reset_game(self):
        # the screen is not restored, only the frame counter (a fresh
        # episode builds a fresh FakeALE)
        self.frame = 0


def _resize_rgb(screen: np.ndarray, res: int = RESOLUTION) -> np.ndarray:
    """Nearest-neighbour resize to u8[res, res, 3] (the reference
    interpolates with OpenCV). Kept as bytes: the history ring, the records
    and the device upload all take u8; the 1/255 scaling happens once on the
    device."""
    h, w = screen.shape[:2]
    ri = (np.arange(res) * h // res).astype(np.int32)
    ci = (np.arange(res) * w // res).astype(np.int32)
    return screen[ri][:, ci]


class AtariEnv:
    """One host-side Atari episode (numpy)."""

    def __init__(self, game_name: str = Config.env_atari_name,
                 rom_dir: str = Config.env_atari_rom_dir, seed: int = 0,
                 ale_factory: Optional[Callable[[int], object]] = None):
        self.spec = atari_spec(game_name)
        self.game_name = game_name
        self.rom_dir = rom_dir
        self._ale_factory = ale_factory or (
            lambda s: make_ale(f"{rom_dir.rstrip('/')}/{game_name}.bin", s))
        self.reset(seed)

    def reset(self, seed: int) -> None:
        """reference atari.cpp:47-74."""
        self.seed = seed
        self.ale = self._ale_factory(seed)
        self.ale.reset_game()
        self.minimal_actions = set(int(a) for a in self.ale.getMinimalActionSet())
        self.actions: List[int] = []
        self.rewards: List[float] = []
        self.lives_history: List[int] = [self.ale.lives()]
        self.total_reward = 0.0
        self.reward = 0.0
        self._obs_history = np.zeros((HISTORY, RESOLUTION, RESOLUTION, 3), np.uint8)
        self._obs_history[-1] = _resize_rgb(np.asarray(self.ale.getScreenRGB()))
        self._action_history = np.zeros((HISTORY,), np.float32)

    def legal_mask(self) -> np.ndarray:
        mask = np.zeros(ACTION_SIZE, bool)
        mask[list(self.minimal_actions)] = True
        return mask

    def step(self, action: int) -> float:
        """Frameskip-4 step (atari.cpp:76-104)."""
        reward = 0.0
        for _ in range(FRAME_SKIP):
            reward += float(self.ale.act(int(action)))
        self.reward = reward
        self.total_reward += reward
        self.actions.append(int(action))
        self.rewards.append(reward)
        self.lives_history.append(self.ale.lives())
        self._obs_history = np.roll(self._obs_history, -1, axis=0)
        self._obs_history[-1] = _resize_rgb(np.asarray(self.ale.getScreenRGB()))
        self._action_history = np.roll(self._action_history, -1)
        self._action_history[-1] = int(action) / ACTION_SIZE
        return reward

    def is_terminal(self) -> bool:
        return (len(self.actions) * FRAME_SKIP >= MAX_FRAMES) or bool(self.ale.game_over(False))

    def features(self) -> np.ndarray:
        """f32[96, 96, 32] NHWC: 8 x [action plane, R, G, B]
        (atari.cpp:112-122; the reference emits CHW, the same content)."""
        planes = np.empty((RESOLUTION, RESOLUTION, HISTORY * 4), np.float32)
        for i in range(HISTORY):
            planes[:, :, 4 * i] = self._action_history[i]
            planes[:, :, 4 * i + 1: 4 * i + 4] = self._obs_history[i].astype(np.float32) / 255.0
        return planes

    def features_u8(self) -> np.ndarray:
        """u8[96, 96, 32] record-schema features: RGB planes as the ring
        holds them, action planes quantised as clip(id/18*255), the bytes
        ``rebuild_features_from_frames`` rebuilds."""
        planes = np.empty((RESOLUTION, RESOLUTION, HISTORY * 4), np.uint8)
        aplane = np.clip(self._action_history * 255.0, 0, 255).astype(np.uint8)
        for i in range(HISTORY):
            planes[:, :, 4 * i] = aplane[i]
            planes[:, :, 4 * i + 1: 4 * i + 4] = self._obs_history[i]
        return planes

    def newest_frame(self) -> np.ndarray:
        """u8[96, 96, 3]: the latest observation, the per-move upload (the
        8-frame stack lives on the device as a ring)."""
        return self._obs_history[-1]

    def eval_score(self) -> float:
        return self.total_reward

    def action_features(self, action: torch.Tensor) -> torch.Tensor:
        """The dynamics net's action planes (``action_features``), for the
        train step's unroll."""
        return action_features(action, self.spec)

    def num_rotations(self) -> int:
        return 1


def rebuild_features_from_frames(frames: np.ndarray, actions: np.ndarray) -> np.ndarray:
    """u8 feature stacks from per-position newest frames.

    ``frames[i]`` is the newest RGB frame of position ``i``'s pre-move
    features (what a record's OBS tag stores); the 8-deep stack with its
    action planes is rebuilt as ``AtariEnv.features_u8`` builds it
    (atari.cpp:112-122). Positions before the first frame are zero, as the
    reference pads before the episode start."""
    length = frames.shape[0]
    feats = np.zeros((length, RESOLUTION, RESOLUTION, HISTORY * 4), np.uint8)
    pos = np.arange(length)
    for k in range(HISTORY):
        j = pos - (HISTORY - 1) + k  # history slot k shows frame j
        valid = j >= 0
        feats[valid, :, :, 4 * k + 1: 4 * k + 4] = frames[j[valid]]
        aj = j - 1  # slot k's action plane: the action that led to frame j
        avalid = aj >= 0
        plane = np.clip(actions[aj[avalid]].astype(np.float32) / ACTION_SIZE * 255.0,
                        0, 255).astype(np.uint8)
        feats[avalid, :, :, 4 * k] = plane[:, None, None]
    return feats


class AtariVecEnv:
    """A batch of host Atari episodes, stepped array in, array out.

    A batched circular frame and action ring mirrors the per-env histories,
    so ``features_u8`` and ``newest_frames`` are a few whole-batch slice
    copies. Slot k (0 = oldest, HISTORY-1 = newest) lives at ring index
    ``(head + k) % HISTORY``."""

    def __init__(self, batch_size: int, seed: int = 0, **env_kwargs):
        self.envs = [AtariEnv(seed=seed * 7919 + i, **env_kwargs) for i in range(batch_size)]
        self.spec = self.envs[0].spec
        self._next_seed = seed * 7919 + batch_size
        b = batch_size
        self._ring = np.zeros((b, HISTORY, RESOLUTION, RESOLUTION, 3), np.uint8)
        self._ahist = np.zeros((b, HISTORY), np.float32)
        self._head = 0  # ring index of the oldest slot
        for i, e in enumerate(self.envs):
            self._ring[i, (self._head - 1) % HISTORY] = e.newest_frame()

    def num_rotations(self) -> int:
        return 1

    def features(self) -> np.ndarray:
        return np.stack([e.features() for e in self.envs])

    def features_u8(self) -> np.ndarray:
        b = len(self.envs)
        planes = np.empty((b, RESOLUTION, RESOLUTION, HISTORY * 4), np.uint8)
        aplane = np.clip(self._ahist * 255.0, 0, 255).astype(np.uint8)
        for k in range(HISTORY):
            src = (self._head + k) % HISTORY
            planes[:, :, :, 4 * k] = aplane[:, src, None, None]
            planes[:, :, :, 4 * k + 1: 4 * k + 4] = self._ring[:, src]
        return planes

    def newest_frames(self) -> np.ndarray:
        return self._ring[:, (self._head - 1) % HISTORY]

    def legal_masks(self) -> np.ndarray:
        return np.stack([e.legal_mask() for e in self.envs])

    def step(self, actions: np.ndarray) -> np.ndarray:
        rewards = np.asarray([e.step(int(a)) for e, a in zip(self.envs, actions)], np.float32)
        for i, e in enumerate(self.envs):
            self._ring[i, self._head] = e.newest_frame()
        self._ahist[:, self._head] = np.asarray(actions, np.float32) / ACTION_SIZE
        self._head = (self._head + 1) % HISTORY
        return rewards

    def terminals(self) -> np.ndarray:
        return np.asarray([e.is_terminal() for e in self.envs])

    def reset_done(self) -> List[int]:
        """Reset finished episodes with fresh seeds; returns their slots."""
        done = []
        for i, e in enumerate(self.envs):
            if e.is_terminal():
                e.reset(self._next_seed)
                self._next_seed += 1
                self._ring[i] = 0
                self._ahist[i] = 0.0
                self._ring[i, (self._head - 1) % HISTORY] = e.newest_frame()
                done.append(i)
        return done

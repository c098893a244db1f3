"""Host-env self-play (Atari): the ALE steps on the host, the MuZero search
runs on the device (port of ``minizero_tpu/selfplay/host_engine.py``).

The reference's MuZero actor consults the env at the root only
(``actor/zero_actor.cpp:58-68``). So per move the engine uploads the
batch's newest frames, updates the 8-frame history ring that lives on the
device, builds the feature stack there, runs the batched search
(``selfplay/muzero_search.py``; on the card every tree step is kernel B1 in
its reward regime, B1'), and steps the host envs with the chosen actions.

The collector repeats the reference's intermediate-sequence chunking of
long episodes (``actor/actor_group.cpp:52-64, 125-132``): with
``zero_actor_intermediate_sequence_length`` > 0, a record chunk is emitted
every seqlen trainable positions with a ``learner_muzero_unrolling_step +
learner_n_step_return`` margin, and the per-move lives-lost flags feed the
episodic-life n-step cut (``atari.cpp calculateNStepValue``).
"""

from __future__ import annotations

import copy
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from minizero_tpu_torch import resolve_device, upload
from minizero_tpu_torch.config import Config
from minizero_tpu_torch.envs import atari
from minizero_tpu_torch.learner.replay import GameRecord
from minizero_tpu_torch.selfplay.collector import FinishedGame
from minizero_tpu_torch.selfplay.engine import search_spec_from_config
from minizero_tpu_torch.selfplay.muzero_search import make_muzero_search
from minizero_tpu_torch.selfplay.record import serialize_game
from minizero_tpu_torch.tools.obs import pack_observations


class HostMoveOutput(NamedTuple):
    action: np.ndarray  # i32[B]
    policy_target: np.ndarray  # f32[B, A]
    root_value: np.ndarray  # f32[B]
    reward: np.ndarray  # f32[B]
    frames: np.ndarray  # u8[B, H, W, 3]: the pre-move newest frames (a copy),
    # what records store (learner/frame_window.py)
    done: np.ndarray  # bool[B]
    eval_score: np.ndarray  # f32[B]
    lives_lost: np.ndarray  # bool[B]


def atari_record_line(spec, fg: FinishedGame, seed: int, record_observations: bool,
                      model_file: str = "") -> str:
    """One record line of the reference's Atari schema (atari.cpp:106-110,
    base_env.h:215-219): the moves, then SD (the seed that made the
    episode), OFF (the chunk's first move in the episode, when not 0), LL
    (the lives-lost flags) and, with ``record_observations``, OBS (the
    newest frame a position: the stacks rebuild from consecutive frames)."""
    extra = {"SD": str(seed)}
    if fg.abs_start:
        extra["OFF"] = str(fg.abs_start)
    if fg.record.lives_lost is not None:
        extra["LL"] = "".join("1" if x else "0" for x in fg.record.lives_lost)
    line = serialize_game(spec.name, fg.record, spec.board_size, fg.players,
                          model_file=model_file, extra_tags=extra)
    if record_observations:
        obs = fg.record.frames[fg.record.frame_lead:]
        line = line[:-1] + f"OBS[{pack_observations(obs)}]" + line[-1:]
    return line


class HostSelfPlayEngine:
    """Batched MuZero self-play over a host vec env (``envs/atari.py``).

    ``network`` is a MuZero ``nn.Module``; the engine moves it to ``device``
    (the card by default) and searches with a bf16 copy (``use_bf16``) that
    follows its weights at every move, as ``SelfPlayEngine`` does. The
    8-frame history lives on the device as ``u8[B, 8, 96, 96, 3]`` plus the
    action ids ``i32[B, 8]``; a move uploads only the newest frames (3.5 MB
    at B=128), the last actions, the fresh-episode flags and the legal
    masks, through pinned memory, and reads back the action, the policy
    target and the root value. Draws come from ``generator`` where a call
    passes one, else from the engine's own, seeded with ``seed``."""

    def __init__(self, vec_env, cfg: Config, network: torch.nn.Module, eval_mode: bool = False,
                 use_bf16: bool = True, device=None, seed: int = 0):
        self.vec_env = vec_env
        self.cfg = cfg
        self.device = resolve_device(device)
        self.network = network.to(self.device).eval()
        spec = vec_env.spec
        self.search_spec = search_spec_from_config(cfg, spec, eval_mode=eval_mode)
        self.compute_dtype = torch.bfloat16 if use_bf16 else torch.float32
        self._infer_net = (copy.deepcopy(self.network).to(self.compute_dtype)
                           if use_bf16 else self.network)
        self.search = make_muzero_search(
            self._infer_net, self.search_spec, lambda a: atari.action_features(a, spec),
            spec.num_players, discrete_value=spec.discrete_value_size > 1,
            compute_dtype=self.compute_dtype, resign_threshold=cfg.actor_resign_threshold)
        self.generator = torch.Generator(device=self.device).manual_seed(int(seed))
        batch = len(vec_env.envs)
        self._ring = torch.zeros((batch, atari.HISTORY, spec.input_height, spec.input_width, 3),
                                 dtype=torch.uint8, device=self.device)
        self._ahist = torch.zeros((batch, atari.HISTORY), dtype=torch.int32, device=self.device)
        self._turns = torch.ones((batch,), dtype=torch.int32, device=self.device)
        # byte / 255 and id / 18, divided on the CPU: CUDA divides by a
        # scalar as a product with its reciprocal, an ulp away at times, so
        # the stacks gather these quotients on every device
        self._pixel_scale = (torch.arange(256, dtype=torch.float32) / 255.0).to(self.device)
        self._action_scale = (torch.arange(atari.ACTION_SIZE, dtype=torch.float32)
                              / atari.ACTION_SIZE).to(self.device)

    def _sync_inference_net(self) -> None:
        if self._infer_net is not self.network:
            self._infer_net.load_state_dict(self.network.state_dict())

    def _update_ring(self, frames: torch.Tensor, last_actions: torch.Tensor,
                     fresh: torch.Tensor) -> None:
        """Zero the fresh episodes' history, shift the ring one slot and put
        the newest frames and actions last (the JAX ``update_and_search``)."""
        ring = torch.where(fresh[:, None, None, None, None], 0, self._ring)
        ahist = torch.where(fresh[:, None], 0, self._ahist)
        self._ring = torch.cat([ring[:, 1:], frames[:, None]], dim=1)
        self._ahist = torch.cat([ahist[:, 1:], last_actions[:, None]], dim=1)

    def features(self) -> torch.Tensor:
        """f32[B, H, W, 32]: the search features the ring holds now,
        channels 4i..4i+3 = [action_i / 18, R_i, G_i, B_i] / 255
        (``AtariEnv.features``; the same values on every device)."""
        ring = self._ring
        b, h, r = ring.shape[0], ring.shape[1], ring.shape[2]
        obs = self._pixel_scale[ring.long()]
        aplane = self._action_scale[self._ahist.long()][:, :, None, None, None]
        stacked = torch.cat([aplane.expand(b, h, r, r, 1), obs], dim=-1)  # [B, 8, H, W, 4]
        return stacked.permute(0, 2, 3, 1, 4).reshape(b, r, r, h * 4)

    @torch.no_grad()
    def move(self, temperature: float = 1.0,
             generator: Optional[torch.Generator] = None) -> HostMoveOutput:
        vec = self.vec_env
        envs = vec.envs
        # the pre-move newest frames, copied out of the vec env's ring (which
        # the step below overwrites 8 moves later): the records keep them
        frames = np.ascontiguousarray(vec.newest_frames())
        fresh = np.asarray([len(e.actions) == 0 for e in envs])
        last_actions = np.asarray([e.actions[-1] if e.actions else 0 for e in envs], np.int32)
        legal = vec.legal_masks()
        lives_before = np.asarray([e.lives_history[-1] for e in envs])
        dev = self.device
        self._update_ring(upload(frames, dev), upload(last_actions, dev), upload(fresh, dev))
        self._sync_inference_net()
        res = self.search(self.features(), upload(legal, dev), self._turns,
                          generator or self.generator, temperature)
        actions = res.action.cpu().numpy()
        rewards = vec.step(actions)
        lives_after = np.asarray([e.lives_history[-1] for e in envs])
        return HostMoveOutput(
            action=actions,
            policy_target=res.policy_target.cpu().numpy(),
            root_value=res.root_value.cpu().numpy(),
            reward=rewards,
            frames=frames,
            done=vec.terminals(),
            eval_score=np.asarray([e.eval_score() for e in envs], np.float32),
            lives_lost=lives_after < lives_before,
        )


class AtariTrajectoryCollector:
    """Accumulates host-engine moves into (possibly chunked) GameRecords."""

    #: history depth of the feature stack (atari.h)
    HISTORY = 8

    def __init__(self, cfg: Config, env_spec, batch_size: int):
        self.cfg = cfg
        self.spec = env_spec
        self.batch = batch_size
        self._slots: List[dict] = [self._new_slot() for _ in range(batch_size)]

    def _new_slot(self) -> dict:
        # "offset" counts moves already trimmed from the front: list index i
        # is episode position offset + i (the reference frees old
        # observations in place, atari.cpp:86-91)
        return {"actions": [], "policy": [], "values": [], "rewards": [],
                "frames": [], "lives_lost": [], "offset": 0}

    def _margin(self) -> int:
        return self.cfg.learner_muzero_unrolling_step + self.cfg.learner_n_step_return

    def add_moves(self, out: HostMoveOutput) -> Tuple[List[FinishedGame], List[int]]:
        """Returns (finished chunks or games, slots that need a reset)."""
        finished: List[FinishedGame] = []
        reset_slots: List[int] = []
        seqlen = self.cfg.zero_actor_intermediate_sequence_length
        for i in range(self.batch):
            slot = self._slots[i]
            slot["actions"].append(int(out.action[i]))
            slot["policy"].append(out.policy_target[i].astype(np.float16))
            slot["values"].append(float(out.root_value[i]))
            slot["rewards"].append(float(out.reward[i]))
            slot["frames"].append(out.frames[i])
            slot["lives_lost"].append(bool(out.lives_lost[i]))
            length = slot["offset"] + len(slot["actions"])
            if out.done[i]:
                finished.append(self._emit(i, terminal=True, score=float(out.eval_score[i])))
                self._slots[i] = self._new_slot()
                reset_slots.append(i)
            elif seqlen > 0 and length >= seqlen and (length - self._margin()) % seqlen == 0:
                finished.append(self._emit(i, terminal=False, score=float(out.eval_score[i])))
        return finished, reset_slots

    def _emit(self, slot_idx: int, terminal: bool, score: float) -> FinishedGame:
        """Chunk emission (reference calculateTrainingDataRange,
        actor_group.cpp:52-64) into dense arrays; emitted prefixes are
        trimmed so memory stays bounded over 27k-move episodes."""
        cfg = self.cfg
        slot = self._slots[slot_idx]
        offset = slot["offset"]
        length = offset + len(slot["actions"])  # absolute episode positions
        seqlen = cfg.zero_actor_intermediate_sequence_length
        margin = self._margin()
        data_end = length - 1
        data_start = 0
        if seqlen > 0:
            data_end = max(0, data_end if terminal else data_end - margin)
            data_start = max(
                0, (data_end - data_end % seqlen) if terminal else data_end + 1 - seqlen)
            if terminal and data_end % seqlen < margin:
                data_start = max(0, data_start - seqlen)
        # store [data_start .. min(len-1, data_end + margin)] so unroll and
        # n-step targets stay inside the chunk
        store_end = min(length - 1, data_end + margin)
        # frames schema: up to HISTORY frames and actions of pre-chunk
        # history go first, so every position's 8-deep stack and action
        # planes assemble as features_u8 showed them to the search
        lead = min(self.HISTORY, data_start)
        assert data_start - lead >= offset, "chunk start trimmed too aggressively"
        sl = slice(data_start - offset, store_end + 1 - offset)
        fsl = slice(data_start - lead - offset, store_end + 1 - offset)
        lsl = slice(data_start - lead - offset, data_start - offset)
        record = GameRecord(
            actions=np.asarray(slot["actions"][sl], np.int32),
            policy=np.stack(slot["policy"][sl]),
            values=np.asarray(slot["values"][sl], np.float32),
            rewards=np.asarray(slot["rewards"][sl], np.float32),
            features=None,
            frames=np.stack(slot["frames"][fsl]),
            frame_lead=lead,
            lead_actions=np.asarray(slot["actions"][lsl], np.int32),
            result=score,
            data_range=(0, data_end - data_start),
            lives_lost=np.asarray(slot["lives_lost"][sl], bool),
        )
        if not terminal and seqlen > 0:
            # positions before the next chunk's earliest start are never
            # needed again (next data_start >= data_end + 1 - seqlen); keep
            # one more seqlen + margin for the terminal back-extension, and
            # HISTORY positions of lead history
            keep_from = max(offset, data_end + 1 - seqlen - margin - self.HISTORY)
            drop = keep_from - offset
            if drop > 0:
                for key in ("actions", "policy", "values", "rewards", "frames", "lives_lost"):
                    del slot[key][:drop]
                slot["offset"] = keep_from
        return FinishedGame(record=record, players=tuple([1] * record.length),
                            slot=slot_idx, abs_start=data_start)

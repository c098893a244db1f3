"""Replay buffer (port of ``minizero_tpu/learner/replay.py``, a numpy copy:
the same records, value targets, sampling and PER arithmetic, draw for draw).

Re-design of the reference's SGF-string replay buffer + data loader
(``minizero/learner/data_loader.{h,cpp}``): the reference stores raw SGF
strings and re-plays the whole game on 8 CPU threads for every sampled
position (``base_env.h:235-241`` — the trainer's CPU hot spot). Here finished
games arrive as dense numpy arrays (the self-play engine already computed the
feature planes per move, stored as uint8), so sampling is pure array gathers
and the device receives ready batches; rotation augmentation moves into the
train step on the device.

Semantics preserved: capacity of ``zero_replay_buffer x
zero_num_games_per_iteration`` games (``data_loader.cpp:43-50``), two-level
game->position sampling by priority (``data_loader.cpp:53-64``), PER
priority^alpha weighting and ``(N * p)^-beta`` importance scaling
(``data_loader.cpp:24-33, 66-74``), sampling restricted to each game's
trainable DLEN range, and the reference's absorbing-state targets (uniform
policy, zero reward, random absorbing action features).

Frames-schema records (Atari) carry per-position frames instead of stacked
planes: sampling returns the (game, position) pairs and the targets, and the
zero loop assembles the stacks on the device from its frame window
(``learner/frame_window.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclass
class GameRecord:
    """One finished game (or intermediate sequence chunk, reference
    ``actor_group.cpp:52-64``)."""

    actions: np.ndarray  # i32[L]
    policy: np.ndarray  # f16[L, A] normalised search policy (P tags)
    values: np.ndarray  # f32[L] root mean value per move (V tags)
    rewards: np.ndarray  # f32[L] env reward per move (R tags)
    features: Optional[np.ndarray]  # u8[L, H, W, C] pre-move feature planes;
    # None for frames-schema records (Atari): the stack is assembled at
    # sample time from ``frames`` (learner/frame_window.py)
    result: float  # RE tag (eval score / return)
    data_range: Tuple[int, int] = (-1, -1)  # DLEN; (-1,-1) -> full game
    priorities: Optional[np.ndarray] = None  # f32[L]; None -> uniform
    lives_lost: Optional[np.ndarray] = None  # bool[L]; episodic-life cuts (L tags)
    value_targets: Optional[np.ndarray] = None  # f32[L] cache (set by add_game)
    # frames schema (Atari): per-position newest RGB frame, u8[lead+L, H, W, 3]
    # with ``frame_lead`` rows of pre-chunk history and the actions that led
    # to those lead frames, so continuation chunks assemble bit-exact stacks
    frames: Optional[np.ndarray] = None
    frame_lead: int = 0
    lead_actions: Optional[np.ndarray] = None  # i32[frame_lead]

    def __post_init__(self):
        if self.data_range == (-1, -1):
            self.data_range = (0, max(0, len(self.actions) - 1))

    @property
    def length(self) -> int:
        return len(self.actions)


class ReplayBuffer:
    def __init__(self, cfg, env_spec):
        self.cfg = cfg
        self.spec = env_spec
        # annealed by the zero loop per iteration (reference
        # zero_server.cpp:304-306)
        self.per_beta = cfg.learner_per_init_beta
        self.capacity = cfg.zero_replay_buffer * cfg.zero_num_games_per_iteration
        self.games: List[GameRecord] = []
        self.game_priorities: List[float] = []
        self.position_priorities: List[np.ndarray] = []
        self.num_data = 0
        self._start = 0  # ring start
        # flat PER caches (vectorized sampling: one searchsorted over the
        # concatenated position priorities replaces per-sample rng.choice —
        # the two-level game→position sampling of the reference
        # (data_loader.cpp:53-64) is distribution-identical to flat sampling
        # because P(game) ∝ Σ pos-pri and P(pos | game) ∝ pos-pri)
        self._games_version = 0  # bumped on add/pop
        self._flat_version = -1
        self._cum_dirty = True
        self._flat_pri: Optional[np.ndarray] = None  # f32 concat of position_priorities
        self._flat_cum: Optional[np.ndarray] = None  # f64 cumsum
        self._flat_vt: Optional[np.ndarray] = None  # f32 concat of value_targets
        self._flat_offsets: Optional[np.ndarray] = None  # i64[G] game starts
        # flat DATA caches (vectorized batch assembly: one fancy-index gather
        # per batch replaces the per-sample python copy loop, which measured
        # ~90 ms/step at b=1024 on the training host). Rebuilt once per
        # iteration (first sample after the window changed); records are
        # re-pointed at views into the flat arrays so memory stays ~1x.
        self._data_version = -1
        self._flat_ok = False  # flat data caches usable (features may still
        # be absent under the frames schema — see frames_mode)
        self._flat_feats: Optional[np.ndarray] = None  # u8[T, H, W, C]
        self._flat_policy: Optional[np.ndarray] = None  # f16[T, A]
        self._flat_actions: Optional[np.ndarray] = None  # i32[T]
        self._flat_rewards: Optional[np.ndarray] = None  # f32[T]
        self._flat_lengths: Optional[np.ndarray] = None  # i64[G]
        self._flat_results: Optional[np.ndarray] = None  # f32[G]
        self._dr_starts: Optional[np.ndarray] = None  # i64[G] data_range lo
        self._dr_sizes: Optional[np.ndarray] = None  # i64[G] data_range sizes
        self._dr_cum: Optional[np.ndarray] = None  # i64[G] cumsum of range sizes

    def __len__(self) -> int:
        return len(self.games)

    @property
    def frames_mode(self) -> bool:
        """True when records carry per-position frames instead of stacked
        feature planes (Atari; see learner/frame_window.py)."""
        return bool(self.games) and self.games[0].features is None

    def _n_step_values_all(self, rec: GameRecord) -> np.ndarray:
        """Episodic-life n-step return with root-value bootstrap for EVERY
        position at once (reference AtariEnvLoader::calculateNStepValue,
        atari.cpp) — n vectorized passes over the record instead of a
        per-sample python loop."""
        n = self.cfg.learner_n_step_return
        disc = self.cfg.actor_mcts_reward_discount
        length = rec.length
        r = np.asarray(rec.rewards, np.float64)
        v = np.asarray(rec.values, np.float64)
        cut = (np.asarray(rec.lives_lost, bool) if rec.lives_lost is not None
               else np.zeros(length, bool))
        tgt = np.zeros(length, np.float64)
        alive = np.ones(length, bool)  # no life-loss cut hit yet
        base = np.arange(length)
        for d in range(n):
            idx = base + d
            ok = idx < length
            idxc = np.minimum(idx, length - 1)
            # a cut AT idx stops before adding r[idx] and kills the bootstrap
            alive = alive & ~(ok & cut[idxc])
            tgt += np.where(ok & alive, (disc ** d) * r[idxc], 0.0)
        bidx = base + n
        ok = bidx < length
        bidxc = np.minimum(bidx, max(length - 1, 0))
        tgt += np.where(ok & alive & ~cut[bidxc], (disc ** n) * v[bidxc], 0.0)
        return tgt.astype(np.float32)

    def _ensure_value_targets(self, rec: GameRecord) -> np.ndarray:
        if rec.value_targets is None:
            if self.cfg.learner_n_step_return <= 0:
                rec.value_targets = np.full(rec.length, rec.result, np.float32)
            else:
                rec.value_targets = self._n_step_values_all(rec)
        return rec.value_targets

    def value_target(self, rec: GameRecord, pos: int) -> float:
        """Board games: the game return; n-step games: the n-step value
        (0 past the end in BOTH cases — reference base_env.h:278 /
        atari.h:115)."""
        if self.cfg.learner_n_step_return <= 0:
            return rec.result if pos < rec.length else 0.0
        vt = self._ensure_value_targets(rec)
        return float(vt[pos]) if pos < rec.length else 0.0

    def add_game(self, record: GameRecord) -> None:
        lo, hi = record.data_range
        if (
            self.cfg.learner_use_per
            and record.priorities is None
            and self.cfg.learner_n_step_return > 0
        ):
            # priority = |n-step value - root value| (reference atari.h:117)
            vt = self._ensure_value_targets(record)
            record.priorities = np.abs(
                vt - np.asarray(record.values, np.float32)) + 1e-6
        pri = np.zeros(record.length, np.float32)
        if self.cfg.learner_use_per and record.priorities is not None:
            pri[lo : hi + 1] = np.power(record.priorities[lo : hi + 1], self.cfg.learner_per_alpha)
        else:
            pri[lo : hi + 1] = 1.0
        self.games.append(record)
        self.position_priorities.append(pri)
        self.game_priorities.append(float(pri.sum()))
        self.num_data += hi - lo + 1
        while len(self.games) > self.capacity:
            old = self.games.pop(0)
            self.position_priorities.pop(0)
            self.game_priorities.pop(0)
            lo2, hi2 = old.data_range
            self.num_data -= hi2 - lo2 + 1
        self._games_version += 1

    # ------------------------------------------------------- flat PER cache
    def _ensure_flat(self) -> None:
        """(Re)build the concatenated priority/value-target caches; the
        cumsum alone is refreshed after in-place priority updates."""
        if self._flat_version != self._games_version:
            if self.games:
                self._flat_offsets = np.concatenate(
                    [[0], np.cumsum([g.length for g in self.games])[:-1]]
                ).astype(np.int64)
                self._flat_pri = np.concatenate(self.position_priorities).astype(np.float32)
                self._flat_vt = np.concatenate(
                    [self._ensure_value_targets(g) for g in self.games]
                ).astype(np.float32)
            else:
                self._flat_offsets = np.zeros(0, np.int64)
                self._flat_pri = np.zeros(0, np.float32)
                self._flat_vt = np.zeros(0, np.float32)
            self._flat_version = self._games_version
            self._cum_dirty = True
        if self._cum_dirty:
            self._flat_cum = np.cumsum(self._flat_pri, dtype=np.float64)
            self._cum_dirty = False

    # ------------------------------------------------------ flat data caches
    #: games whose concatenated features exceed this are sampled through the
    #: per-game fallback loop (Atari pixel windows can reach hundreds of GB;
    #: board-game windows are ~1 GB bit-packed)
    FLAT_FEATURE_CACHE_MAX_BYTES = 32 << 30

    def _ensure_flat_data(self) -> bool:
        """(Re)build the concatenated feature/policy/action/reward caches.

        Returns True when the flat feature cache is usable. After the concat,
        every record's ``features``/``policy`` become views into the flat
        arrays, so the per-game originals free and steady-state memory is one
        copy plus a transient during the rebuild."""
        self._ensure_flat()
        if self._data_version == self._games_version:
            return self._flat_ok
        # invalidate BEFORE rebuilding: a mid-rebuild exception (e.g.
        # MemoryError on the concat transient) must not leave stale arrays
        # paired with new offsets behind a version that claims validity
        self._flat_ok = False
        self._flat_feats = self._flat_policy = None
        self._flat_actions = self._flat_rewards = None
        self._data_version = self._games_version
        games = self.games
        self._flat_lengths = np.array([g.length for g in games], np.int64)
        self._flat_results = np.array([g.result for g in games], np.float32)
        self._dr_starts = np.array([g.data_range[0] for g in games], np.int64)
        self._dr_sizes = np.array(
            [g.data_range[1] - g.data_range[0] + 1 for g in games], np.int64)
        self._dr_cum = np.cumsum(self._dr_sizes)
        # frames-schema records (Atari) carry no stacked features: the flat
        # metadata caches below still vectorize sampling; the stack itself is
        # assembled from frames at sample time (learner/frame_window.py)
        frames_mode = bool(games) and games[0].features is None
        if not frames_mode:
            feat_shapes = {g.features.shape[1:] for g in games}
            total_bytes = sum(g.features.nbytes for g in games)
            if (not games or len(feat_shapes) != 1
                    or total_bytes > self.FLAT_FEATURE_CACHE_MAX_BYTES):
                return False
        # build into locals and publish _flat_feats LAST: a mid-build
        # exception (e.g. MemoryError) must leave the cache invalid (feats
        # None -> callers fall back to the per-game path) rather than half
        # built behind a version that claims validity
        flat_feats = (None if frames_mode
                      else np.concatenate([g.features for g in games]))
        self._flat_policy = np.concatenate(
            [np.asarray(g.policy, np.float16) for g in games])
        self._flat_actions = np.concatenate(
            [np.asarray(g.actions, np.int32) for g in games])
        self._flat_rewards = np.concatenate(
            [np.asarray(g.rewards, np.float32) for g in games])
        self._flat_feats = flat_feats
        for i, g in enumerate(games):
            o = int(self._flat_offsets[i])
            if not frames_mode:
                g.features = self._flat_feats[o:o + g.length]
            g.policy = self._flat_policy[o:o + g.length]
        self._flat_ok = True
        return True

    # ------------------------------------------------------------- sampling
    def sample_indices(self, batch_size: int, rng: np.random.RandomState):
        """Two-level (game, position) sampling (reference
        ``data_loader.cpp:53-64``) + PER loss scales
        (``data_loader.cpp:66-74``)."""
        if not self.cfg.learner_use_per:
            # fast uniform path: every in-range position equally likely, so
            # sample flat position indices and invert via cumulative lengths
            self._ensure_flat_data()
            cum, starts = self._dr_cum, self._dr_starts
            flat = rng.randint(cum[-1], size=batch_size)
            game_ids = np.searchsorted(cum, flat, side="right")
            pos_ids = flat - (cum[game_ids] - self._dr_sizes[game_ids]) + starts[game_ids]
            return game_ids, pos_ids, np.ones(batch_size, np.float32)

        # flat weighted sampling (distribution-identical to the reference's
        # two-level scheme; see _ensure_flat): ONE searchsorted for the
        # whole batch instead of batch_size rng.choice calls
        self._ensure_flat()
        total = float(self._flat_cum[-1])
        u = rng.random_sample(batch_size) * total
        flat_idx = np.minimum(
            np.searchsorted(self._flat_cum, u, side="right"),
            len(self._flat_pri) - 1)
        game_ids = (np.searchsorted(self._flat_offsets, flat_idx, side="right") - 1).astype(np.int64)
        pos_ids = flat_idx - self._flat_offsets[game_ids]
        prob = self._flat_pri[flat_idx].astype(np.float64) / total
        loss_scale = np.power(self.num_data * prob, -self.per_beta).astype(np.float32)
        # normalise by batch max (reference train.py:63)
        loss_scale = loss_scale / max(loss_scale.max(), 1e-12)
        return game_ids, pos_ids, loss_scale

    def sample_alphazero(self, batch_size: int, rng: np.random.RandomState) -> Dict[str, np.ndarray]:
        """(features u8, policy, value, loss_scale) — rotation augmentation is
        applied later on device."""
        if self.frames_mode:
            raise NotImplementedError(
                "frames-schema records (Atari) train through sample_muzero")
        game_ids, pos_ids, loss_scale = self.sample_indices(batch_size, rng)
        spec = self.spec
        if self._ensure_flat_data():
            flat = self._flat_offsets[game_ids] + pos_ids
            # f16 end to end: records store f16 and the train step upcasts
            # on device, so the host->device batch stream stays half-width
            feats = self._flat_feats[flat]
            policy = self._flat_policy[flat]
            # board-game value target = game return from P1's perspective
            # (reference TicTacToeEnvLoader::getValue -> getReturn())
            value = self._flat_results[game_ids]
        else:
            # records may hold bit-packed planes — follow their channel count
            feat_c = self.games[game_ids[0]].features.shape[-1]
            feats = np.empty((batch_size, spec.input_height, spec.input_width, feat_c), np.uint8)
            policy = np.empty((batch_size, spec.action_size), np.float16)
            value = np.empty((batch_size,), np.float32)
            for i, (g, p) in enumerate(zip(game_ids, pos_ids)):
                rec = self.games[g]
                feats[i] = rec.features[p]
                policy[i] = rec.policy[p]
                value[i] = rec.result
        return {
            "features": feats,
            "policy": policy,
            "value": value,
            "loss_scale": loss_scale,
            "sampled_index": np.stack([game_ids, pos_ids], axis=1),
        }

    def sample_muzero(self, batch_size: int, rng: np.random.RandomState) -> Dict[str, np.ndarray]:
        """Features at pos + K unroll steps of (action, policy, value, reward)
        (reference ``data_loader.cpp:157-200``)."""
        game_ids, pos_ids, loss_scale = self.sample_indices(batch_size, rng)
        spec = self.spec
        k = self.cfg.learner_muzero_unrolling_step
        a = spec.action_size
        uniform = np.full((a,), 1.0 / a, np.float16)
        hidden_positions = spec.hidden_height * spec.hidden_width
        if self._ensure_flat_data():
            offs = self._flat_offsets[game_ids]
            length = self._flat_lengths[game_ids]
            pos = pos_ids[:, None] + np.arange(k + 1)[None, :]  # [B, k+1]
            inside = pos < length[:, None]
            flat = offs[:, None] + np.minimum(pos, np.maximum(length - 1, 0)[:, None])
            # frames schema: no stacked features to gather; the caller
            # assembles them on the device from the sampled (game, pos) pairs
            feats = (None if self.frames_mode
                     else self._flat_feats[offs + pos_ids])
            # absorbing policy is uniform (reference base_env.h:262-264);
            # absorbing action features use a random action
            # (reference tictactoe.cpp:147-152)
            policy = np.where(inside[..., None], self._flat_policy[flat], uniform)
            actions = np.where(
                inside[:, :k], self._flat_actions[flat[:, :k]],
                rng.randint(hidden_positions, size=(batch_size, k))
            ).astype(np.int32)
            reward = np.where(
                inside[:, :k], self._flat_rewards[flat[:, :k]], 0.0
            ).astype(np.float32)
            if self.cfg.learner_n_step_return <= 0:
                # absorbing positions train toward 0, not the game result
                # (reference base_env.h:278 getValue: pos past the end -> 0)
                value = np.where(
                    inside, self._flat_results[game_ids][:, None], 0.0
                ).astype(np.float32)
            else:
                value = np.where(inside, self._flat_vt[flat], 0.0).astype(np.float32)
        else:
            frames_mode = self.frames_mode
            feats = None
            if not frames_mode:
                feat_c = self.games[game_ids[0]].features.shape[-1]
                feats = np.empty((batch_size, spec.input_height, spec.input_width, feat_c),
                                 np.uint8)
            actions = np.empty((batch_size, k), np.int32)
            policy = np.empty((batch_size, k + 1, a), np.float16)
            value = np.empty((batch_size, k + 1), np.float32)
            reward = np.zeros((batch_size, k), np.float32)
            for i, (g, p) in enumerate(zip(game_ids, pos_ids)):
                rec = self.games[g]
                if not frames_mode:
                    feats[i] = rec.features[p]
                for step in range(k + 1):
                    pos = p + step
                    inside = pos < rec.length
                    if step < k:
                        actions[i, step] = rec.actions[pos] if inside else rng.randint(hidden_positions)
                        reward[i, step] = rec.rewards[pos] if inside else 0.0
                    policy[i, step] = rec.policy[pos] if inside else uniform
                    value[i, step] = self.value_target(rec, pos)
        out = {
            "actions": actions,
            "policy": policy,
            "value": value,
            "reward": reward,
            "loss_scale": loss_scale,
            "sampled_index": np.stack([game_ids, pos_ids], axis=1),
        }
        if feats is not None:
            out["features"] = feats
        return out

    # -------------------------------------------------------------- PER sync
    def update_priority(self, sampled_index: np.ndarray, new_priorities: np.ndarray) -> None:
        """Refresh position priorities from new network values (reference
        ``data_loader.cpp:233-253``) — vectorized scatter (duplicates: last
        write wins, like the reference's sequential loop)."""
        if not self.cfg.learner_use_per or len(sampled_index) == 0:
            return
        g = np.asarray(sampled_index[:, 0], np.int64)
        p = np.asarray(sampled_index[:, 1], np.int64)
        pr = np.power(np.asarray(new_priorities, np.float64),
                      self.cfg.learner_per_alpha).astype(np.float32)
        valid = g < len(self.games)
        g, p, pr = g[valid], p[valid], pr[valid]
        for ug in np.unique(g):
            m = g == ug
            pp = self.position_priorities[ug]
            pp[p[m]] = pr[m]
            self.game_priorities[ug] = float(pp.sum())
        if self._flat_version == self._games_version and len(g):
            self._flat_pri[self._flat_offsets[g] + p] = pr
            self._cum_dirty = True

    def refresh_priorities(self, sampled_index: np.ndarray, new_values: np.ndarray) -> None:
        """PER refresh from freshly-trained network values: priority =
        |value target − new value| + ε (reference train.py:208-209 +
        data_loader.cpp:233-253), fully vectorized via the flat
        value-target cache."""
        if not self.cfg.learner_use_per or len(sampled_index) == 0:
            return
        self._ensure_flat()
        g = np.asarray(sampled_index[:, 0], np.int64)
        p = np.asarray(sampled_index[:, 1], np.int64)
        valid = g < len(self.games)
        tgt = np.zeros(len(g), np.float32)
        gv, pv = g[valid], p[valid]
        tgt[valid] = self._flat_vt[self._flat_offsets[gv] + pv]
        pri = np.abs(tgt - np.asarray(new_values, np.float32)) + 1e-6
        self.update_priority(np.stack([g, p], axis=1)[valid], pri[valid])

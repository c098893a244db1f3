"""Zero training loop (port of ``minizero_tpu/zero/loop.py``).

The reference's distributed triangle — TCP ``ZeroServer`` state machine,
self-play workers, optimization worker, NFS
(``minizero/zero/zero_server.cpp:159-323``) — is one in-process loop on one
card, or one such loop a card under ``torch.distributed`` (``mesh``), with
the same iteration semantics:

    for iteration: self-play 2000 games -> train 500 steps -> checkpoint

per-game resign disabling, the temperature decay schedule (1 / 0.5 / 0.25 at
50% / 75% of total iterations, ``zero_server.cpp:301-323``), PER beta
annealing, a replay window of ``zero_replay_buffer`` iterations, one record
file per iteration, and ``Training.log`` / ``op.log`` lines shaped like the
reference's, which the analysis tooling parses.

The loop hands the engine the very module the optimizer updates: the engine
keeps its bf16 inference copy in step with it at every move, and the train
step leaves it in eval mode, so self-play after an optimize plays the new
weights with running statistics. Under a mesh whose dense heads split over
``mp`` the engine plays a whole copy instead, refreshed from the gathered
heads after each optimize, so no collective runs inside a move.

Atari runs its env on the host (``envs/atari.py``, the ALE injectable as
``ale_factory``): ``selfplay/host_engine.py`` searches on the device and
chunks long episodes into records that store one frame a position, the
frame window (``learner/frame_window.py``) keeps the replay window's frames
on the device, and each SGD step's stacks are assembled there.

With a ``mesh`` (``parallel/mesh.py``: this process's rank, the number of
ranks, its card and its ``(dp, mp)`` coordinates) the loop is one rank of a
data-parallel run, as the JAX loop's mesh and multi-host paths are: each
``dp`` row plays ``ceil(games / dp)`` games on its card
(``parallel/distributed.ShardedSelfPlay``) into its own record shard
(``sgf/{it}.sgf`` on row 0, ``sgf/{it}.p{row}.sgf`` on the others; the logs
likewise), the self-play statistics are gathered over the rows, each rank
samples ``batch // dp`` rows from its own replay buffer for the
data-parallel train step, rank 0 writes the checkpoint, and every
collective outside a move runs under the collective watchdog
(``zero_collective_timeout``). With ``mp > 1`` the ranks of an ``mp`` group
play the same games and sample the same rows (one ``dp`` row, as JAX
replicates its batch over ``mp``); its rank 0 alone writes the row's
files, so a ``dp = 1`` run writes what one process writes, and the
checkpoint holds whole heads and momentum (gathered over ``mp``; a load
splits them again). Atari under a mesh is refused, as in JAX.

Rank 0 redraws the analysis plots (``tools/analysis.py``) every 5
iterations and at the last one; where that fails (no matplotlib) it logs
one ``[Analysis] skipped`` line and training goes on.
"""

from __future__ import annotations

import copy
import gzip
import json
import os
import pickle
import time
import uuid
from typing import Dict, List

import numpy as np
import torch
import torch.distributed as dist

from minizero_tpu_torch import resolve_device, upload
from minizero_tpu_torch.config import Config
from minizero_tpu_torch.envs import make_env
from minizero_tpu_torch.envs.atari import AtariVecEnv
from minizero_tpu_torch.learner.frame_window import FrameWindow, rows_needed
from minizero_tpu_torch.learner.replay import GameRecord, ReplayBuffer
from minizero_tpu_torch.learner.train import init_train_state, make_train_step
from minizero_tpu_torch.models.factory import create_network, init_network
from minizero_tpu_torch.parallel.distributed import (
    ShardedSelfPlay, all_gather_rows, global_batch_from_local, make_sharded_train_chunk)
from minizero_tpu_torch.parallel.mesh import local_state, replicated, whole_state
from minizero_tpu_torch.parallel.watchdog import collective_watchdog
from minizero_tpu_torch.selfplay.collector import TrajectoryCollector
from minizero_tpu_torch.selfplay.engine import SelfPlayEngine
from minizero_tpu_torch.selfplay.host_engine import (
    AtariTrajectoryCollector, HostSelfPlayEngine, atari_record_line)
from minizero_tpu_torch.selfplay.record import game_record_from_string, serialize_game
from minizero_tpu_torch.tools.analysis import analysis
from minizero_tpu_torch.tools.obs import unpack_observations
from minizero_tpu_torch.utils.bitpack import pack_planes, packed_channels


def per_beta_for_iteration(cfg: Config, iteration: int) -> float:
    """Linear anneal of the PER importance exponent toward 1
    (reference zero_server.cpp:304-306)."""
    if not (cfg.learner_use_per and cfg.learner_per_beta_anneal):
        return cfg.learner_per_init_beta
    b0 = cfg.learner_per_init_beta
    return min(b0 + (iteration / max(cfg.zero_end_iteration, 1)) * (1.0 - b0), 1.0)


def temperature_for_iteration(cfg: Config, iteration: int) -> float:
    """1.0 / 0.5 / 0.25 for 0-50% / 50-75% / 75-100% of total iterations
    (reference zero_server.cpp:301-315)."""
    t = cfg.actor_select_action_softmax_temperature
    if not cfg.actor_select_action_softmax_temperature_decay:
        return t
    frac = iteration / max(cfg.zero_end_iteration, 1)
    if frac < 0.5:
        return t
    if frac < 0.75:
        return t * 0.5
    return t * 0.25


def _to_device(batch: Dict[str, np.ndarray], device: torch.device) -> Dict[str, torch.Tensor]:
    """A sampled batch onto the device. On the card the copies do not block
    the host (``upload``), so the next batch is sampled while the card runs
    this step."""
    return {k: upload(v, device) for k, v in batch.items()}


class ZeroLoop:
    """Self-play, replay, SGD and checkpoints for one run directory.

    ``device`` is the CUDA card by default (``resolve_device``: without a
    card it raises) and the CPU only when asked for. Self-play evaluates
    the net in bf16 on the card (the JAX engine's default) and in float32
    on the CPU. For Atari, ``ale_factory(seed)`` builds the episodes' ALE
    handles (default: the real ALE of ``ale_py``). With ``mesh``
    (``parallel/mesh.make_mesh`` in a joined process group) the loop is
    that rank of a data-parallel run, on ``mesh.device``; ``pid`` and
    ``num_procs`` are its ``dp`` row and the number of rows, and
    ``writes`` says whether it writes the row's files (``mp`` rank 0)."""

    def __init__(self, cfg: Config, run_dir: str, device=None, ale_factory=None, mesh=None):
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else resolve_device(device)
        self.pid = mesh.dp_rank if mesh is not None else 0
        self.num_procs = mesh.dp if mesh is not None else 1
        self.writes = mesh is None or mesh.mp_rank == 0
        self.is_main = self.pid == 0 and self.writes
        self.cfg = cfg
        self.run_dir = run_dir
        os.makedirs(os.path.join(run_dir, "model"), exist_ok=True)
        os.makedirs(os.path.join(run_dir, "sgf"), exist_ok=True)
        # row 0 keeps the unsuffixed file names; row r appends .p{r}
        self.shard = "" if self.pid == 0 else f".p{self.pid}"
        self._log_file = open(self._row_file(f"Training{self.shard}.log"), "a")
        self._op_log = open(self._row_file(f"op{self.shard}.log"), "a")
        self.is_host_env = cfg.env_name == "atari"
        self.vec_env = self.frame_window = None
        if self.is_host_env and mesh is not None:
            raise NotImplementedError("mesh-sharded self-play is device-env only; "
                                      "run atari workers one process per host")
        if self.is_host_env:
            # the ALE on the host, the search on the device: the reference's
            # Atari actor consults the env at the root only
            # (actor/zero_actor.cpp:58-68)
            self.vec_env = AtariVecEnv(
                cfg.zero_num_parallel_games, seed=cfg.program_seed,
                game_name=cfg.env_atari_name, rom_dir=cfg.env_atari_rom_dir,
                ale_factory=ale_factory)
            self.env = self.vec_env.envs[0]
            spec = self.env.spec
            rows = rows_needed(cfg, spec.max_game_length)
            window_bytes = rows * spec.input_height * spec.input_width * 3
            on_device = window_bytes <= cfg.learner_device_feature_window_gb * (1 << 30)
            self.frame_window = FrameWindow(rows, spec.input_height, spec.input_width,
                                            device=self.device, on_device=on_device)
            if not on_device:
                print(f"[FrameWindow] {window_bytes / 1e9:.1f} GB exceeds "
                      f"learner_device_feature_window_gb="
                      f"{cfg.learner_device_feature_window_gb}; the frames stay in host "
                      "memory and each batch's stacks are assembled there", flush=True)
        else:
            self.env = make_env(cfg)
        seed = cfg.program_seed if not cfg.program_auto_seed else int(time.time())
        # the network lives on the device before the optimizer takes its
        # parameters; the engine gets this same module
        self.network = init_network(create_network(cfg, self.env.spec), seed=seed).to(self.device)
        if mesh is not None:
            # every rank starts from rank 0's weights (an auto seed differs)
            with self._watchdog("replicate_weights"):
                replicated(mesh, self.network)
        # self-play's whole network: the trained one, or under split heads a
        # whole copy that follows it (refresh_play_network)
        self.play_network = (copy.deepcopy(self.network) if mesh is not None and mesh.mp > 1
                             else self.network)
        self.state = init_train_state(cfg, self.network)
        if self.is_host_env:
            self.engine = HostSelfPlayEngine(
                self.vec_env, cfg, self.network, device=self.device, seed=seed,
                use_bf16=self.device.type == "cuda")
            # the collector persists across iterations: episodes keep running
            # while the loop alternates self-play and optimize, as the
            # reference's actors keep their episode state between iterations
            self._atari_collector = AtariTrajectoryCollector(
                cfg, self.env.spec, cfg.zero_num_parallel_games)
        else:
            self.engine = SelfPlayEngine(
                self.env, cfg, self.play_network, device=self.device, seed=seed,
                use_bf16=self.device.type == "cuda")
        self.sharded = None
        if mesh is not None:
            # this rank's games and rows; the gradient averaged over ranks,
            # K steps a synchronise; with mp > 1 the chunk splits the heads
            self.sharded = ShardedSelfPlay(self.engine, mesh, seed)
            self._train_chunk = make_sharded_train_chunk(
                cfg, self.env, self.network, mesh, cfg.zero_collective_timeout, self.log)
        else:
            self._train_step = make_train_step(cfg, self.env, self.network)
        self.buffer = ReplayBuffer(cfg, self.env.spec)
        # the train step's rotation draws (each rank's for its own rows); the
        # replay's draws stay on numpy
        self.generator = torch.Generator(device=self.device).manual_seed(seed + 2 + self.pid)
        self.np_rng = np.random.RandomState(cfg.program_seed + 1)
        self.is_muzero = cfg.nn_type_name.lower() != "alphazero"
        self.last_selfplay_timing: Dict[str, float] = {}

    def close(self) -> None:
        self._log_file.close()
        self._op_log.close()

    # ------------------------------------------------------------------- log
    def log(self, message: str) -> None:
        line = f"[{time.strftime('%Y-%m-%d %H:%M:%S')}] {message}"
        print(line, flush=True)
        self._log_file.write(line + "\n")
        self._log_file.flush()

    def op_log(self, message: str) -> None:
        self._op_log.write(f"[{time.strftime('%Y-%m-%d %H:%M:%S')}] {message}\n")
        self._op_log.flush()

    def _watchdog(self, name: str):
        """The collective watchdog around a collective of the mesh path."""
        return collective_watchdog(name, self.cfg.zero_collective_timeout, self.log)

    def _row_file(self, name: str) -> str:
        """The path of a file of this rank's row in the run directory, or
        ``os.devnull`` on an ``mp`` rank other than 0 (it writes nothing)."""
        return os.path.join(self.run_dir, name) if self.writes else os.devnull

    def refresh_play_network(self) -> None:
        """Under split heads, load the trained heads, gathered over ``mp``,
        into self-play's whole network (a no-op otherwise)."""
        if self.play_network is self.network:
            return
        with self._watchdog(f"gather_heads_{self.state.step}"):
            model, _ = whole_state(self.mesh, self.network)
        self.play_network.load_state_dict(model)

    # -------------------------------------------------------------- selfplay
    def self_play_iteration(self, iteration: int) -> Dict[str, float]:
        if self.is_host_env:
            return self._host_self_play_iteration(iteration)
        cfg = self.cfg
        spec = self.env.spec
        temperature = temperature_for_iteration(cfg, iteration)
        sp = self.sharded or self.engine
        batch = (sp.local_batch(cfg.zero_num_parallel_games) if self.sharded
                 else cfg.zero_num_parallel_games)
        collector = TrajectoryCollector(cfg, spec, batch,
                                        seed=cfg.program_seed + iteration * self.num_procs + self.pid)
        states = sp.init_batch(cfg.zero_num_parallel_games)
        num_games, lengths, returns = 0, [], []
        # each rank plays its share of the iteration's games into its shard
        games_target = -(-cfg.zero_num_games_per_iteration // self.num_procs)
        record_path = self._row_file(os.path.join("sgf", f"{iteration}{self.shard}.sgf"))
        model_file = f"weight_iter_{self.state.step}"
        t0 = time.time()
        # chunked collection: move_scan advances every game M moves (with
        # slot resets and resign gating on the device); the host collects a
        # whole chunk at a time
        scan_moves = max(1, int(cfg.zero_moves_per_dispatch))
        enable = torch.as_tensor(collector.enable_resign_flags(), device=self.device)
        msr = None
        pending = None
        # per-phase wall attribution, logged as [SelfPlay Timing]
        t_dispatch = t_collect = t_host = 0.0
        chunks = 0
        with open(record_path, "a") as record_file:
            while num_games < games_target:
                tp = time.time()
                stacked, states, enable, msr = sp.move_scan(
                    states, temperature, scan_moves, enable, msr)
                t_dispatch += time.time() - tp
                chunks += 1
                # collect the PREVIOUS chunk after this one is enqueued: its
                # copy to the host waits only for work already queued
                if pending is None:
                    pending = stacked
                    continue
                tp = time.time()
                finished = collector.add_scan(pending)
                t_collect += time.time() - tp
                pending = stacked
                tp = time.time()
                for fg in finished:
                    if num_games >= games_target:
                        # exact cutoff like the reference server, which stops
                        # accepting SelfPlay lines at the target
                        # (zero_server.cpp:191-213) — the chunk may overshoot
                        break
                    self.buffer.add_game(fg.record)
                    record_file.write(serialize_game(spec.name, fg.record, spec.board_size,
                                                     fg.players, model_file=model_file) + "\n")
                    lengths.append(fg.record.length)
                    returns.append(fg.record.result)
                    num_games += 1
                t_host += time.time() - tp
        self.log(
            f"[SelfPlay Timing] chunks: {chunks} x {scan_moves} moves, "
            f"dispatch: {t_dispatch:.1f}s, collect: {t_collect:.1f}s, "
            f"records: {t_host:.1f}s"
        )
        self.last_selfplay_timing = {"chunks": chunks, "moves_per_chunk": scan_moves,
                                     "dispatch_s": t_dispatch, "collect_s": t_collect,
                                     "records_s": t_host}
        return self._selfplay_stats(iteration, num_games, lengths, returns, time.time() - t0)

    def _gathered_selfplay_stats(self, iteration, num_games, lengths, returns,
                                 dt) -> Dict[str, float]:
        """The mesh path's statistics over every rank's games: the ranks'
        moments (count, sum, sum of squares, min, max) gathered under the
        watchdog, so every rank logs the global lines (the reference server
        aggregates its workers' lines, zero_server.cpp:240-263)."""
        def mom(x):
            x = np.asarray(x, np.float64)
            if x.size == 0:
                return [0.0, 0.0, np.inf, -np.inf]
            return [float(x.sum()), float((x * x).sum()), float(x.min()), float(x.max())]

        local = np.array([float(num_games)] + mom(lengths) + mom(returns) + [dt])
        with self._watchdog("selfplay_stats_allgather"):
            g = all_gather_rows(self.mesh, local)
        n = g[:, 0].sum()

        def comb(col):
            s, sq = g[:, col].sum(), g[:, col + 1].sum()
            avg = s / max(n, 1.0)
            std = float(np.sqrt(max(sq / max(n, 1.0) - avg * avg, 0.0)))
            return avg, std, float(g[:, col + 2].min()), float(g[:, col + 3].max())

        l_avg, l_std, l_min, l_max = comb(1)
        r_avg, r_std, r_min, r_max = comb(5)
        dt = float(g[:, 9].max())
        stats = {
            "games": int(n), "time_s": dt,
            "games_per_sec": n / max(dt, 1e-9),
            "length_avg": l_avg, "length_std": l_std,
            "return_avg": r_avg, "return_std": r_std,
        }
        self.log(
            f"[Iteration] {iteration}: self-play {int(n)} games in {dt:.1f}s "
            f"({stats['games_per_sec']:.2f} games/s, {self.num_procs} hosts)"
        )
        self.log(
            f"[SelfPlay Game Lengths] min: {l_min:g}, max: {l_max:g}, "
            f"avg: {l_avg:.2f}, std: {l_std:.2f}"
        )
        self.log(
            f"[SelfPlay Game Returns] min: {r_min:g}, max: {r_max:g}, "
            f"avg: {r_avg:.2f}, std: {r_std:.2f}"
        )
        return stats

    def _host_self_play_iteration(self, iteration: int) -> Dict[str, float]:
        """Self-play over the host vec env (Atari): the search on the
        device, the ALE on the host, intermediate-sequence chunks, and per
        record the SD seed tag, OFF, LL and (``zero_actor_record_observations``)
        OBS tags (the reference's Atari record schema, atari.cpp:106-110,
        base_env.h:215-219). Each record goes to the replay buffer and the
        frame window as it is emitted."""
        cfg = self.cfg
        spec = self.env.spec
        temperature = temperature_for_iteration(cfg, iteration)
        collector = self._atari_collector
        num_games, lengths, returns = 0, [], []
        record_path = os.path.join(self.run_dir, "sgf", f"{iteration}.sgf")
        model_file = f"weight_iter_{self.state.step}"
        t_search = t_records = 0.0
        moves = 0
        t0 = time.time()
        with open(record_path, "a") as record_file:
            while num_games < cfg.zero_num_games_per_iteration:
                tp = time.time()
                out = self.engine.move(temperature)
                t_search += time.time() - tp
                moves += 1
                tp = time.time()
                finished, reset_slots = collector.add_moves(out)
                for fg in finished:
                    self.buffer.add_game(fg.record)
                    self.frame_window.add(fg.record)
                    # slots reset only after emission, so this is the seed
                    # that made the record (obs recovery replays from it)
                    record_file.write(atari_record_line(
                        spec, fg, self.vec_env.envs[fg.slot].seed,
                        cfg.zero_actor_record_observations, model_file) + "\n")
                    lengths.append(fg.record.length)
                    returns.append(fg.record.result)
                    num_games += 1
                if reset_slots:
                    self.vec_env.reset_done()
                t_records += time.time() - tp
        # drop the window's bookkeeping of records the buffer evicted
        self.frame_window.retain(self.buffer.games)
        self.log(f"[SelfPlay Timing] moves: {moves}, search and env steps: {t_search:.1f}s, "
                 f"records: {t_records:.1f}s")
        self.last_selfplay_timing = {"moves": moves, "search_s": t_search,
                                     "records_s": t_records}
        return self._selfplay_stats(iteration, num_games, lengths, returns, time.time() - t0)

    def _selfplay_stats(self, iteration, num_games, lengths, returns, dt) -> Dict[str, float]:
        if self.mesh is not None:
            return self._gathered_selfplay_stats(iteration, num_games, lengths, returns, dt)
        stats = {
            "games": num_games,
            "time_s": dt,
            "games_per_sec": num_games / max(dt, 1e-9),
            "length_avg": float(np.mean(lengths)) if lengths else 0.0,
            "length_std": float(np.std(lengths)) if lengths else 0.0,
            "return_avg": float(np.mean(returns)) if returns else 0.0,
            "return_std": float(np.std(returns)) if returns else 0.0,
        }
        # reference-style stats lines (zero_server.cpp:240-263)
        self.log(
            f"[Iteration] {iteration}: self-play {num_games} games in {dt:.1f}s "
            f"({stats['games_per_sec']:.2f} games/s)"
        )
        self.log(
            f"[SelfPlay Game Lengths] min: {min(lengths) if lengths else 0}, max: {max(lengths) if lengths else 0}, "
            f"avg: {stats['length_avg']:.2f}, std: {stats['length_std']:.2f}"
        )
        self.log(
            f"[SelfPlay Game Returns] min: {min(returns) if returns else 0}, max: {max(returns) if returns else 0}, "
            f"avg: {stats['return_avg']:.2f}, std: {stats['return_std']:.2f}"
        )
        latest = self.cfg.zero_display_latest_games
        if latest > 0 and returns:
            lr = returns[-latest:]
            ll = lengths[-latest:]
            self.log(
                f"[SelfPlay Latest {len(lr)} Games] "
                f"lengths avg: {float(np.mean(ll)):.2f}, std: {float(np.std(ll)):.2f}; "
                f"returns avg: {float(np.mean(lr)):.2f}, std: {float(np.std(lr)):.2f}"
            )
        return stats

    # ------------------------------------------------------------ optimizing
    def optimize_iteration(self, iteration: int) -> Dict[str, float]:
        """``learner_training_step`` SGD steps, one after another on the
        device. Batches are sampled on the host while the card runs the
        previous step; the metrics stay on the device and are read once every
        ``learner_training_display_step`` steps (with PER, the fresh values
        are read after every step to refresh the sampled priorities: the
        reference's per-step refresh, train.py:208-209)."""
        cfg = self.cfg
        self.buffer.per_beta = per_beta_for_iteration(cfg, iteration)
        t0 = time.time()
        if self.mesh is not None:
            self._optimize_sharded()
        else:
            self._optimize_steps()
        self.refresh_play_network()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dt = time.time() - t0
        self.log(f"[Optimization] iteration {iteration}: {cfg.learner_training_step} steps in {dt:.1f}s")
        self.log(f"Optimization_Done {self.state.step}")
        return {"time_s": dt}

    def _log_metrics(self, step: int, sums: Dict[str, float], n: int) -> None:
        """One op.log line of the metrics averaged over ``n`` steps."""
        self.op_log(
            f"nn step {step}, lr: {self.cfg.learner_learning_rate}. "
            + " ".join(f"{k}: {v / n:.5f}" for k, v in sorted(sums.items()))
        )

    def _optimize_sharded(self) -> None:
        """The mesh path: chunks of K data-parallel steps (K the display
        period, at most 100), each rank sampling ``batch // dp`` rows of
        every step from its own buffer up front (the ranks of an ``mp``
        group the same rows: the same buffer and seeds); the chunk
        synchronises once under the watchdog. With PER each rank refreshes
        its own rows after the chunk, so sampling lags the refresh by fewer
        than K steps (the JAX loop's chunked optimizer)."""
        cfg = self.cfg
        local_bs = cfg.learner_batch_size // self.num_procs
        chunk = max(1, min(cfg.learner_training_display_step, 100))
        base_step = self.state.step
        done = shown = 0
        sums: Dict[str, float] = {}
        while done < cfg.learner_training_step:
            k_steps = min(chunk, cfg.learner_training_step - done)
            batches, indices = [], []
            for _ in range(k_steps):
                b = (self.buffer.sample_muzero(local_bs, self.np_rng) if self.is_muzero
                     else self.buffer.sample_alphazero(local_bs, self.np_rng))
                indices.append(b.pop("sampled_index"))
                batches.append(global_batch_from_local(self.mesh, b))
            metrics = self._train_chunk(self.state, batches, self.generator)
            done += k_steps
            new_values = metrics.pop("_new_values", None)
            if new_values is not None:
                for idx, nv in zip(indices, new_values.cpu().numpy()):
                    self.buffer.refresh_priorities(idx, nv)
            for k, v in metrics.items():
                sums[k] = sums.get(k, 0.0) + float(v.sum())
            if done - shown >= cfg.learner_training_display_step:
                self._log_metrics(base_step + done, sums, done - shown)
                sums, shown = {}, done

    def _optimize_steps(self) -> None:
        """One device: the steps one after another, each batch sampled on the
        host while the card runs the previous step."""
        cfg = self.cfg
        bs = cfg.learner_batch_size
        base_step = self.state.step
        totals: Dict[str, torch.Tensor] = {}
        shown = 0
        for done in range(1, cfg.learner_training_step + 1):
            if self.is_muzero:
                b = self.buffer.sample_muzero(bs, self.np_rng)
            else:
                b = self.buffer.sample_alphazero(bs, self.np_rng)
            sampled_index = b.pop("sampled_index")
            batch = _to_device(b, self.device)
            if self.frame_window is not None:
                # frames schema: the stacks are assembled from the window
                recs = [self.buffer.games[g] for g in sampled_index[:, 0]]
                batch["features"] = self.frame_window.assemble(
                    self.frame_window.lookup(recs, sampled_index[:, 1]))
            metrics = self._train_step(self.state, batch, self.generator)
            new_values = metrics.pop("_new_values", None)
            if new_values is not None:  # PER
                self.buffer.refresh_priorities(sampled_index, new_values.cpu().numpy())
            for k, v in metrics.items():
                totals[k] = totals[k] + v if k in totals else v
            if done - shown >= cfg.learner_training_display_step:
                keys = sorted(totals)
                vals = torch.stack([totals[k] for k in keys]).cpu().numpy()
                self._log_metrics(base_step + done, dict(zip(keys, vals)), done - shown)
                totals = {}
                shown = done

    # ------------------------------------------------------------ checkpoint
    def save_checkpoint(self) -> str:
        """Model and optimizer state, step and config in one ``torch.save``,
        written to a temporary name and renamed: a crash mid-write never
        leaves a truncated newest checkpoint. Under a mesh the state is the
        same on every rank: rank 0 alone writes it, then every rank waits at
        a barrier (under the watchdog). Split heads and their momentum are
        gathered over ``mp`` first, so the file is the one one process
        writes."""
        step = self.state.step
        path = os.path.join(self.run_dir, "model", f"weight_iter_{step}.ckpt")
        model, optimizer = self.network.state_dict(), self.state.optimizer.state_dict()
        if self.play_network is not self.network:
            with self._watchdog(f"ckpt_gather_{step}"):
                model, optimizer = whole_state(self.mesh, self.network, self.state.optimizer)
        if self.is_main:
            payload = {
                "training_step": step,
                "model": model,
                "optimizer": optimizer,
                "config": self.cfg.to_string(),
            }
            tmp = path + ".tmp"
            torch.save(payload, tmp)
            os.replace(tmp, path)
        if self.mesh is not None:
            with self._watchdog(f"ckpt_barrier_{step}"):
                dist.barrier()
        return path

    def load_checkpoint(self, path: str) -> None:
        """One process's checkpoint; under split heads, self-play's network
        takes it whole and the trained one this rank's rows."""
        payload = torch.load(path, map_location=self.device, weights_only=True)
        model, optimizer = payload["model"], payload["optimizer"]
        if self.play_network is not self.network:
            self.play_network.load_state_dict(model)
            self.play_network.eval()
            model, optimizer = local_state(self.mesh, self.network, model, optimizer)
        self.network.load_state_dict(model)
        self.state.optimizer.load_state_dict(optimizer)
        self.state.step = int(payload["training_step"])
        self.network.eval()

    # ---------------------------------------------------------------- resume
    def _rebuild_features_batch(self, action_lists: List[np.ndarray]) -> List[np.ndarray]:
        """Replay recorded actions through the batched env on the device, all
        games at once in one padded batch, to regenerate each position's
        pre-move feature planes (records store targets only; the reference
        rebuilds its buffer by re-parsing sgf files, train.py:40-48). Padded
        moves (action 0; env.step is safe on illegal or terminal states) are
        sliced off."""
        spec = self.env.spec
        lens = [len(a) for a in action_lists]
        max_len = max(lens, default=0)
        if max_len == 0:
            c = (packed_channels(spec.num_input_channels) if spec.binary_features
                 else spec.num_input_channels)
            return [np.zeros((0, spec.input_height, spec.input_width, c), np.uint8)
                    for _ in action_lists]
        acts = np.zeros((len(action_lists), max_len), np.int32)
        for i, a in enumerate(action_lists):
            acts[i, : len(a)] = np.asarray(a, np.int32)
        acts_t = torch.as_tensor(acts, device=self.device)
        state = self.env.init(len(action_lists), device=self.device)
        rows = []
        for t in range(max_len):
            f = self.env.features(state)
            rows.append(pack_planes(f) if spec.binary_features else f.to(torch.uint8))
            state = self.env.step(state, acts_t[:, t])
        feats = torch.stack(rows).cpu().numpy()  # [L, B, H, W, C']
        return [np.ascontiguousarray(feats[: lens[i], i]) for i in range(len(action_lists))]

    def resume(self) -> int:
        """Continue mode (reference zero-server.sh:116-128): load the latest
        checkpoint and rebuild the replay window from the last
        ``zero_replay_buffer`` iterations' record files (``.sgf`` or
        ``.sgf.gz``). Returns the iteration to continue from."""
        model_dir = os.path.join(self.run_dir, "model")
        ckpts = sorted(
            (f for f in os.listdir(model_dir) if f.endswith(".ckpt")),
            key=lambda f: int(f.split("_")[-1].split(".")[0]),
        ) if os.path.isdir(model_dir) else []
        if not ckpts:
            return self.cfg.zero_start_iteration
        # newest first; skip unloadable files instead of wedging a
        # supervisor's relaunch loop on a permanent load error
        for name in reversed(ckpts):
            try:
                self.load_checkpoint(os.path.join(model_dir, name))
                break
            except (OSError, RuntimeError, KeyError, ValueError, EOFError,
                    pickle.UnpicklingError) as exc:
                self.log(f"[Resume] skipping unreadable checkpoint {name}: {exc}")
        else:
            return self.cfg.zero_start_iteration
        start_iter = self.state.step // max(self.cfg.learner_training_step, 1)
        sgf_dir = os.path.join(self.run_dir, "sgf")
        lo = max(1, start_iter - self.cfg.zero_replay_buffer + 1)
        records: List[GameRecord] = []
        for it in range(lo, start_iter + 1):
            path = os.path.join(sgf_dir, f"{it}{self.shard}.sgf")  # this rank's shard
            if os.path.exists(path):
                opener = open(path)
            elif os.path.exists(path + ".gz"):
                opener = gzip.open(path + ".gz", "rt")
            else:
                continue
            with opener:
                for line in opener:
                    line = line.strip()
                    if not line:
                        continue
                    tags, rec = game_record_from_string(line, self.env.spec.action_size)
                    if self.is_host_env:
                        # Atari: frames from the OBS tag, the episodic-life
                        # cuts from LL (a host env cannot be replayed on the
                        # device). OBS holds the record's own positions only,
                        # so a resumed continuation chunk zero-pads its
                        # pre-chunk history (frame_lead 0), the JAX loop's
                        # documented approximation
                        if "OBS" not in tags:
                            continue  # stripped records are not trainable
                        rec.features = None
                        rec.frames = unpack_observations(tags["OBS"])
                        rec.frame_lead = 0
                        rec.lead_actions = None
                        if "LL" in tags:
                            rec.lives_lost = np.asarray([c == "1" for c in tags["LL"]], bool)
                        self.buffer.add_game(rec)
                        self.frame_window.add(rec)
                    records.append(rec)
        if self.is_host_env:
            self.frame_window.retain(self.buffer.games)
        else:
            # replayed 256 games at a time (the JAX loop's flush size)
            for i in range(0, len(records), 256):
                part = records[i:i + 256]
                for rec, f in zip(part, self._rebuild_features_batch([r.actions for r in part])):
                    rec.features = f
                    self.buffer.add_game(rec)
        self.cfg = self.cfg.replace(zero_start_iteration=start_iter)
        self.log(f"[Resume] iteration {start_iter}, {len(records)} games reloaded")
        return start_iter

    # -------------------------------------------------------------- the loop
    def run(self) -> None:
        """Iterations ``zero_start_iteration + 1 .. zero_end_iteration``, each
        self-play, optimize and a checkpoint, after the bootstrap checkpoint
        weight_iter_{step} (zero-server.sh:113-115). Each iteration appends
        one row to ``perf.jsonl`` (``perf.p{rank}.jsonl`` on rank r > 0):
        wall-clock stamps (``time.time()``), the phase seconds, and this
        process's run token, so rows of resumed runs are told apart."""
        cfg = self.cfg
        self.save_checkpoint()
        run_token = uuid.uuid4().hex[:12]
        with open(self._row_file(f"perf{self.shard}.jsonl"), "a") as perf_log:
            for iteration in range(cfg.zero_start_iteration + 1, cfg.zero_end_iteration + 1):
                w0, p0 = time.time(), time.perf_counter()
                self.self_play_iteration(iteration)
                w1, p1 = time.time(), time.perf_counter()
                self.optimize_iteration(iteration)
                w2, p2 = time.time(), time.perf_counter()
                perf_log.write(json.dumps({
                    "iteration": iteration, "run": run_token, "pid": os.getpid(),
                    "wall_start": w0, "wall_selfplay_done": w1, "wall_end": w2,
                    "selfplay_s": p1 - p0, "optimize_s": p2 - p1}) + "\n")
                perf_log.flush()
                self.save_checkpoint()
                if self.is_main and (iteration % 5 == 0 or iteration == cfg.zero_end_iteration):
                    self._plot()

    def _plot(self) -> None:
        """Redraw the analysis plots; plotting never stops training (the
        reference's analysis is a manual tool; redrawing every iteration
        would re-parse the growing logs)."""
        try:
            analysis(self.run_dir)
        except Exception as e:  # noqa: BLE001 - no matplotlib, a bad log line: go on
            self.log(f"[Analysis] skipped: {e}")

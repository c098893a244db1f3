"""The reference training recipes through the PyTorch port: the port's
counterparts of the JAX runs ``runs/go9_gaz_full`` (``gaz``, the default)
and ``runs/go9_gmz_r4`` (``gmz``).

``gaz``: Go 9x9 Gumbel AlphaZero at n=16, from ``runs/go9_gaz_full.cfg``.
``gmz``: Go 9x9 Gumbel MuZero at n=16 with K=5 unroll steps, from the
``config`` entry of ``runs/go9_gmz_r4/model/weight_iter_12500.ckpt`` (its
Dirichlet root noise included). Both: a net of 1 block x 256 channels,
1,024 games in lock-step, 2,000 games and 500 SGD steps (batch 1,024; SGD
at lr 0.02, momentum 0.9, weight decay 1e-4) an iteration, a replay window
of 20 iterations and random rotation of the features, from iteration 0
with ``program_seed=0``. The config is built from ``default_config("go",
**algorithm_preset(recipe))`` and the recipe's overrides (``RECIPE``,
``RECIPE_GMZ``), written to ``recipe.cfg`` in the run directory and handed
to the port's CLI (``python -m minizero_tpu_torch -mode zero -conf_file
... -conf_str zero_end_iteration=E -run_dir DIR``) in one process for
iterations ``first``..``split`` and in a second one, the same command with
``zero_end_iteration=last``, which resumes the run from its newest
checkpoint (``ZeroLoop.resume``: the replay window's features rebuilt on
the device from the record files).

Each process calls the CLI's ``main`` with that argument list inside this
script (``--process``), which wraps the loop's methods to measure each
iteration and check it: exactly ``zero_num_games_per_iteration`` games;
tree step B1 launched 17 times a move (n + 1) in its board regime and B1',
B2, B3 never; finite losses (``loss_reward`` 0 for MuZero on a board
game); the replay window holding exactly the games of the last 20
iterations (each game tagged with the iteration that played it); on
resume, a digest of every rebuilt game (actions, feature planes, policy
targets as a record reloads them, result) and of the network and optimizer
state equal to what the previous process held at its end. For MuZero,
after the iterations of ``UNROLL_CHECKED`` (and ``split``, ``last`` and
the resume), ``unroll_check``: one ``sample_muzero`` batch of the
learner's size from the flat caches against the per-record branch on the
same draws, and every game of the window as self-play (or the reload)
added it.

After the run the matches follow through ``eval.match.play_match``, the
protocol of ``scripts/elo_curve.py`` (the run's config, at most 96 games
in lock-step, 96 games, eval mode; ``gmz``: 4 uniform opening plies as
``runs/go9_gmz_r4/elo_curve.json``): for ``gmz`` first the port's own
ladder, step 2,500 i against 2,500 (i - 1) at seed 1000 + i up to the last
step; then (a) the JAX run's step-12,500 net against its step-0 net
(``minizero_tpu_torch/assets/go9_{gaz_full,gmz_r4}_iter*.npz``, exported
by ``scripts/export_trained_weights.py``); (b) the port's own
step-``last x 500`` net against its step-0 net; (c) the port's against the
JAX run's, reported only; (a) to (c) at seed 1001. For ``gmz`` on the card
(a) and (b) must each win at least ``MIN_WINS`` of the 96 games.

Prints one JSON line an iteration, one a process, one a match, then a
summary line with the card's name and power limit from ``nvidia-smi``.
Each process's output goes to ``out_dir/process{i}.log`` and the run's
logs (``Training.log``, ``op.log``, ``perf.jsonl``, ``recipe.cfg``) are
copied to ``out_dir`` (default ``run_dir/out``).

    python3 scripts/zero_recipe_torch.py [gaz|gmz] [run_dir] [first=1] [last=25] \
        [split=12 (gaz), 8 (gmz)] [out_dir] [cpu]

``run_dir`` defaults to ``_runs/go9_{gaz,gmz}_recipe`` (git-ignored). With
``first`` > 1 the run directory must hold the checkpoint of iteration
``first - 1``. ``cpu`` runs everything on the CPU (the tree step's plain
version) at a tiny size: a 1 x 16 net, 2 simulations, 4 games an
iteration, 4 SGD steps at batch 8, iterations 1-2 split after 1, 2 games a
match capped at 8 plies (match (a) at the JAX nets' full width), and for
``gmz`` a ladder rung an iteration.
"""
import hashlib
import json
import os
import resource
import shutil
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# runs/go9_gaz_full.cfg over default_config("go", **algorithm_preset("gaz"))
RECIPE = dict(
    env_board_size=9, actor_num_simulation=16, actor_gumbel_sample_size=16,
    actor_use_random_rotation_features=True, nn_num_blocks=1, nn_num_hidden_channels=256,
    nn_num_value_hidden_channels=256, zero_num_parallel_games=1024,
    zero_num_games_per_iteration=2000, zero_replay_buffer=20, learner_training_step=500,
    learner_training_display_step=100, learner_batch_size=1024, learner_optimizer="SGD",
    learner_learning_rate=0.02, learner_momentum=0.9, learner_weight_decay=1e-4,
    program_seed=0, zero_start_iteration=0)
# the config entry of runs/go9_gmz_r4/model/weight_iter_12500.ckpt over
# default_config("go", **algorithm_preset("gmz")), but for the iteration
# that run was resumed at (8): this run starts from 0. The run kept the
# config's Dirichlet noise on, and under it the root takes Dirichlet noise
# in place of Gumbel noise (search/mcts.py add_root_noise, as the JAX
# package's)
RECIPE_GMZ = dict(
    env_board_size=9, actor_num_simulation=16, actor_gumbel_sample_size=16,
    actor_use_dirichlet_noise=True, actor_use_random_rotation_features=True,
    nn_num_blocks=1, nn_num_hidden_channels=256, nn_num_value_hidden_channels=256,
    learner_muzero_unrolling_step=5, zero_num_parallel_games=1024,
    zero_num_games_per_iteration=2000, zero_replay_buffer=20, learner_training_step=500,
    learner_training_display_step=100, learner_batch_size=1024, learner_optimizer="SGD",
    learner_learning_rate=0.02, learner_momentum=0.9, learner_weight_decay=1e-4,
    program_seed=0, zero_start_iteration=0, zero_end_iteration=50)
RECIPES = {"gaz": RECIPE, "gmz": RECIPE_GMZ}
# the CPU form, cut to seconds: a narrow net, 2 simulations, 4 games
CPU_TINY = dict(actor_num_simulation=2, actor_gumbel_sample_size=2, nn_num_hidden_channels=16,
                nn_num_value_hidden_channels=16, zero_num_parallel_games=4,
                zero_num_games_per_iteration=4, learner_training_step=4,
                learner_training_display_step=2, learner_batch_size=8)
LAST = 25
# the process split: the JAX gmz run was itself resumed at iteration 8
# (runs/go9_gmz_r4/Training.log:53)
SPLIT = {"gaz": 12, "gmz": 8}
MATCH_GAMES = 96
# scripts/elo_curve.py: seed 1000 + i for the ladder's i-th pair; at an
# interval of 25 iterations (runs/go9_gaz_full/elo_curve.json) the pair of
# iterations 25 and 0 is i = 1
MATCH_SEED = 1001
CPU_MATCH_GAMES, CPU_MATCH_PLIES = 2, 8
# runs/go9_gmz_r4/elo_curve.json: 4 uniform opening plies, a rung every 5
# iterations
OPENING_PLIES = {"gaz": 0, "gmz": 4}
LADDER_EVERY = {"gaz": 0, "gmz": 5}
ASSETS = os.path.join(ROOT, "minizero_tpu_torch", "assets")
JAX_RUN = {"gaz": "go9_gaz_full", "gmz": "go9_gmz_r4"}
# the JAX runs' ladders at this protocol (runs/*/elo_curve.json): gaz's
# pair of iterations 25 and 0; gmz's first five rungs (W, L, D)
JAX_LADDER = {"wins": 87, "losses": 9, "draws": 0}
JAX_LADDER_GMZ = {2500: (63, 33, 0), 5000: (79, 17, 0), 7500: (78, 18, 0),
                  10000: (64, 32, 0), 12500: (76, 20, 0)}
# gmz on the card: matches (a) and (b) each win at least this many of 96
MIN_WINS = 80
# gmz: the iterations after which unroll_check runs
UNROLL_CHECKED = (1, 8, 20, 21, 25)
UNROLL_SEED = 19
SGD_TIMED_FROM = 11


def jax_net_path(recipe: str, step: int) -> str:
    return os.path.join(ASSETS, f"{JAX_RUN[recipe]}_iter{step}.npz")


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def recipe_config(cpu: bool = False, recipe: str = "gaz"):
    from minizero_tpu_torch.config import algorithm_preset, default_config

    cfg = default_config("go", **algorithm_preset(recipe)).replace(**RECIPES[recipe])
    return cfg.replace(**CPU_TINY) if cpu else cfg


def fail(msg: str) -> None:
    print(f"zero_recipe_torch: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def rss_mib() -> float:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 1024
    return float("nan")


def as_reloaded(policy):
    """Self-play's f16 policy rows as a record reloads them: the parser
    (``selfplay/record.py``, as the JAX package's) divides each row by its
    float32 sum and rounds back to f16, which moves about 2% of a gaz
    iteration's rows by one f16 step."""
    p = np.asarray(policy, np.float32)
    return (p / p.sum(-1, keepdims=True)).astype(np.float16)


def game_digest(rec) -> str:
    """A game as the replay window trains on it after a reload: actions,
    feature planes, policy targets (``as_reloaded`` unless the game was
    reloaded) and result. The root values, printed to 6 digits in the
    records, are left out: board games train on the result."""
    policy = rec.policy if getattr(rec, "reloaded", False) else as_reloaded(rec.policy)
    h = hashlib.sha1()
    for a in (rec.actions, rec.features, policy):
        h.update(memoryview(np.ascontiguousarray(a).tobytes()))
    h.update(repr(float(rec.result)).encode())
    return h.hexdigest()


def state_digest(loop) -> str:
    """The network's and the optimizer's state and the step counter."""
    import torch

    h = hashlib.sha1(str(loop.state.step).encode())

    def feed(x):
        if isinstance(x, torch.Tensor):
            h.update(x.detach().cpu().contiguous().view(-1).view(torch.uint8).numpy().tobytes())
        elif isinstance(x, dict):
            for k in sorted(x, key=str):
                h.update(str(k).encode())
                feed(x[k])
        elif isinstance(x, (list, tuple)):
            for v in x:
                feed(v)
        else:
            h.update(repr(x).encode())

    feed(loop.network.state_dict())
    feed(loop.state.optimizer.state_dict())
    return h.hexdigest()


def record_digest(rec) -> str:
    """A game's arrays as the replay window holds them: actions, policy
    targets, rewards, feature planes and result."""
    h = hashlib.sha1()
    for a in (rec.actions, rec.policy, rec.rewards, rec.features):
        h.update(memoryview(np.ascontiguousarray(a).tobytes()))
    h.update(repr(float(rec.result)).encode())
    return h.hexdigest()


def unroll_check(buffer, batch: int, seed: int = UNROLL_SEED) -> dict:
    """MuZero's unrolled targets as the learner draws them, against the
    games' own records. One ``sample_muzero`` batch from the flat caches
    and one from the per-record branch (``learner/replay.py``), each from
    ``RandomState(seed)``, so the same (game, position) draws. Inside a
    game the two give equal features, actions, policies, values and
    rewards; past its end both give the uniform policy, value and reward 0
    and an action on the hidden plane (drawn in another order, so not
    compared). The flat caches must span the window, and every game that
    carries an ``added_digest`` must still hold the arrays it was added
    with (``record_digest``). Raises ``AssertionError`` at the first
    difference; returns the counts."""
    flat = buffer.sample_muzero(batch, np.random.RandomState(seed))
    assert buffer._flat_ok, "the flat caches are not in use"
    lengths = np.array([g.length for g in buffer.games], np.int64)
    np.testing.assert_array_equal(buffer._flat_lengths, lengths, "the flat caches' games")
    assert len(buffer._flat_policy) == len(buffer._flat_actions) == lengths.sum()
    ensure = buffer._ensure_flat_data

    def per_record():
        ensure()
        return False

    buffer._ensure_flat_data = per_record
    try:
        per = buffer.sample_muzero(batch, np.random.RandomState(seed))
    finally:
        del buffer._ensure_flat_data
    idx = flat["sampled_index"]
    np.testing.assert_array_equal(idx, per["sampled_index"], "sampled (game, position)")
    k = flat["actions"].shape[1]
    inside = idx[:, 1:] + np.arange(k + 1) < lengths[idx[:, 0]][:, None]  # [B, k+1]
    assert inside[:, 0].all(), "a sampled position past its game's end"
    np.testing.assert_array_equal(flat["features"], per["features"], "features")
    for key, mask in (("policy", inside), ("value", inside), ("actions", inside[:, :k]),
                      ("reward", inside[:, :k])):
        np.testing.assert_array_equal(flat[key][mask], per[key][mask], f"{key} inside the games")
    past = ~inside
    spec = buffer.spec
    for b in (flat, per):
        assert (b["policy"][past] == np.float16(1.0 / spec.action_size)).all(), "absorbing policy"
        assert (b["value"][past] == 0).all() and (b["reward"][past[:, :k]] == 0).all()
        acts = b["actions"][past[:, :k]]
        assert ((acts >= 0) & (acts < spec.hidden_height * spec.hidden_width)).all()
    tagged = [g for g in buffer.games if getattr(g, "added_digest", None) is not None]
    changed = sum(record_digest(g) != g.added_digest for g in tagged)
    assert not changed, f"{changed} of the window's games differ from what was added"
    return {"positions": batch, "absorbing_steps": int(past.sum()),
            "past_end": int(past[:, -1].sum()),
            "short_games": int((lengths[idx[:, 0]] <= k).sum()),
            "window_games": len(buffer.games), "games_unchanged": len(tagged)}


# ------------------------------------------------------------------ process

class StepEvents:
    """The loop's train step, with a CUDA event recorded before step
    ``SGD_TIMED_FROM`` of each iteration: ``take`` gives ms per step over
    steps ``SGD_TIMED_FROM``..last on the card's clock (None on the CPU)."""

    def __init__(self, fn, cuda: bool):
        import torch

        self.fn, self.torch, self.cuda = fn, torch, cuda
        self.calls, self.start = 0, None

    def __call__(self, *args, **kwargs):
        self.calls += 1
        if self.cuda and self.calls == SGD_TIMED_FROM:
            self.start = self.torch.cuda.Event(enable_timing=True)
            self.start.record()
        return self.fn(*args, **kwargs)

    def take(self):
        """ms per step of the iteration just optimized, then reset."""
        ms = None
        if self.start is not None:
            end = self.torch.cuda.Event(enable_timing=True)
            end.record()
            end.synchronize()
            ms = self.start.elapsed_time(end) / (self.calls - SGD_TIMED_FROM + 1)
        self.calls, self.start = 0, None
        return ms


def run_process(run_dir: str, conf_file: str, end: int, platform: str, index: int,
                unroll_at=()) -> None:
    """One process of the run: the CLI's ``-mode zero`` in this process, the
    loop's methods wrapped to measure and check each iteration; for MuZero
    ``unroll_check`` after the iterations of ``unroll_at`` and the
    resume."""
    import torch

    from minizero_tpu_torch.__main__ import main as cli
    from minizero_tpu_torch.learner.replay import ReplayBuffer
    from minizero_tpu_torch.ops.gather_rows import gather_rows
    from minizero_tpu_torch.ops.tree_kernel import fused_tree_step
    from minizero_tpu_torch.ops.tree_kernel_v2 import fused_tree_step_v2
    from minizero_tpu_torch.zero import loop as zl

    cuda = platform != "cpu"
    loops = []
    now = {"iteration": 0}
    it_stats = {}

    def counts():
        return (fused_tree_step.launches, fused_tree_step.launches_rewards,
                fused_tree_step_v2.launches, gather_rows.launches)

    init, resume = zl.ZeroLoop.__init__, zl.ZeroLoop.resume
    self_play, optimize = zl.ZeroLoop.self_play_iteration, zl.ZeroLoop.optimize_iteration
    selfplay_stats, log_metrics = zl.ZeroLoop._selfplay_stats, zl.ZeroLoop._log_metrics
    add_game = ReplayBuffer.add_game

    def tagged_add(self, record):
        # the iteration whose self-play made the game; a reloaded game
        # takes its tag from the previous process's digest file
        record.iteration = now["iteration"]
        if self.cfg.nn_type_name == "muzero":
            record.added_digest = record_digest(record)
        add_game(self, record)

    def checked_unroll(loop, when):
        t = time.perf_counter()
        try:
            out = unroll_check(loop.buffer, loop.cfg.learner_batch_size)
        except AssertionError as e:
            fail(f"{when}: the unrolled targets: {e}")
        return {**out, "seconds": time.perf_counter() - t}

    def wrapped_init(self, *args, **kwargs):
        init(self, *args, **kwargs)
        if (self.device.type == "cuda") != cuda:
            fail(f"the loop runs on {self.device}, expected {'cuda' if cuda else 'cpu'}")
        self._train_step = StepEvents(self._train_step, cuda)
        loops.append(self)

    def wrapped_resume(self):
        t = time.perf_counter()
        now["iteration"] = -1
        start = resume(self)
        for g in self.buffer.games:
            g.reloaded = True
        if cuda:
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        games = len(self.buffer)
        line = {"process": index, "resumed_iteration": start, "resume_s": seconds,
                "resume_games": games, "resume_positions": self.buffer.num_data}
        previous = os.path.join(run_dir, f"digest_step{self.state.step}.json")
        if start > 0:
            if not os.path.exists(previous):
                fail(f"resume: no digest of the previous process at {previous}")
            with open(previous) as f:
                want = json.load(f)
            got = [game_digest(g) for g in self.buffer.games]
            if got != want["games"]:
                bad = sum(a != b for a, b in zip(got, want["games"]))
                fail(f"resume: {len(got)} games rebuilt against {len(want['games'])} held at the "
                     f"end of the previous process, {bad} of them different")
            if state_digest(self) != want["state"]:
                fail("resume: the network, optimizer state or step differ from the previous "
                     "process's at its end")
            for g, tag in zip(self.buffer.games, want["iterations"]):
                g.iteration = tag
            line.update(games_equal=True, state_equal=True)
            if self.is_muzero:
                line["unroll"] = checked_unroll(self, f"resume at iteration {start}")
        print(json.dumps(line), flush=True)
        return start

    def wrapped_selfplay_stats(self, iteration, num_games, lengths, returns, dt):
        it_stats["lengths"] = list(lengths)
        return selfplay_stats(self, iteration, num_games, lengths, returns, dt)

    def wrapped_log_metrics(self, step, sums, n):
        it_stats["losses"] = {k: float(v) / n for k, v in sums.items()}
        it_stats["losses_step"] = step
        return log_metrics(self, step, sums, n)

    def wrapped_self_play(self, iteration):
        now["iteration"] = iteration
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        before = counts()
        stats = self_play(self, iteration)
        if cuda:
            torch.cuda.synchronize()
        b1, b1r, b2, b3 = (a - b for a, b in zip(counts(), before))
        timing = dict(self.last_selfplay_timing)
        moves = timing["chunks"] * timing["moves_per_chunk"]
        lengths = it_stats.pop("lengths")
        it_stats.update(
            iteration=iteration, process=index, games=stats["games"],
            selfplay_s=stats["time_s"], games_per_s=stats["games_per_sec"],
            timing=timing, moves=moves, length_min=min(lengths), length_max=max(lengths),
            length_avg=stats["length_avg"], return_avg=stats["return_avg"],
            launches={"tree_step": b1, "tree_step_rewards": b1r, "tree_step_v2": b2,
                      "gather_rows": b3})
        if stats["games"] != self.cfg.zero_num_games_per_iteration:
            fail(f"iteration {iteration}: {stats['games']} games")
        if cuda and (b1 != moves * (self.engine.spec.num_simulations + 1) or b1r or b2 or b3):
            fail(f"iteration {iteration}: launches {it_stats['launches']} over {moves} moves")
        return stats

    def wrapped_optimize(self, iteration):
        out = optimize(self, iteration)
        cfg = self.cfg
        ms = self._train_step.take()
        losses = it_stats.get("losses", {})
        if not losses or not np.isfinite(list(losses.values())).all():
            fail(f"iteration {iteration}: losses {losses}")
        if self.is_muzero and losses.get("loss_reward") != 0:
            # a board game trains no reward head (learner/train.py muzero_loss)
            fail(f"iteration {iteration}: loss_reward {losses.get('loss_reward')}")
        tags = [g.iteration for g in self.buffer.games]
        lo = max(1, iteration - cfg.zero_replay_buffer + 1)
        want = [it for it in range(lo, iteration + 1)
                for _ in range(cfg.zero_num_games_per_iteration)]
        if tags != want:
            fail(f"iteration {iteration}: the replay window holds the games of iterations "
                 f"{sorted(set(tags))} ({len(tags)} games), expected {lo}-{iteration}")
        it_stats.update(
            optimize_s=out["time_s"], sgd_ms_per_step=ms, step=self.state.step,
            buffer_games=len(self.buffer), buffer_positions=self.buffer.num_data,
            window_iterations=[lo, iteration],
            peak_device_gib=(torch.cuda.max_memory_allocated() / 2**30 if cuda else None),
            host_rss_mib=rss_mib(),
            host_peak_rss_mib=resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024)
        if self.is_muzero and iteration in unroll_at:
            it_stats["unroll"] = checked_unroll(self, f"iteration {iteration}")
        print(json.dumps(it_stats), flush=True)
        it_stats.clear()
        return out

    zl.ZeroLoop.__init__, zl.ZeroLoop.resume = wrapped_init, wrapped_resume
    zl.ZeroLoop.self_play_iteration = wrapped_self_play
    zl.ZeroLoop.optimize_iteration = wrapped_optimize
    zl.ZeroLoop._selfplay_stats = wrapped_selfplay_stats
    zl.ZeroLoop._log_metrics = wrapped_log_metrics
    ReplayBuffer.add_game = tagged_add
    argv = ["-mode", "zero", "-conf_file", conf_file, "-conf_str", f"zero_end_iteration={end}",
            "-run_dir", run_dir] + (["-platform", "cpu"] if not cuda else [])
    t = time.perf_counter()
    if cli(argv) != 0:
        fail(f"the CLI returned non-zero: {argv}")
    (loop,) = loops
    if loop.state.step != end * loop.cfg.learner_training_step:
        fail(f"step counter {loop.state.step} after iteration {end}")
    # what the next process must rebuild on resume
    with open(os.path.join(run_dir, f"digest_step{loop.state.step}.json"), "w") as f:
        json.dump({"games": [game_digest(g) for g in loop.buffer.games],
                   "iterations": [g.iteration for g in loop.buffer.games],
                   "state": state_digest(loop)}, f)
    print(json.dumps({"process": index, "end_iteration": end, "step": loop.state.step,
                      "seconds": time.perf_counter() - t,
                      "host_peak_rss_mib":
                          resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024}), flush=True)


# -------------------------------------------------------------------- matches

def match(cfg, net_a, net_b, games: int, plies, device: str, seed: int = MATCH_SEED,
          opening_plies: int = 0) -> dict:
    import torch

    from minizero_tpu_torch.eval.match import elo_from_win_rate, play_match
    from minizero_tpu_torch.ops.tree_kernel import fused_tree_step

    before = fused_tree_step.launches
    if device == "cuda":
        torch.cuda.synchronize()
    t = time.perf_counter()
    r = play_match(cfg, net_a, net_b, num_games=games, seed=seed, max_moves=plies,
                   opening_random_plies=opening_plies, device=device)
    if device == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    launches = fused_tree_step.launches - before
    searched = launches // (cfg.actor_num_simulation + 1) if device == "cuda" else None
    return {"wins": r.p1_wins, "losses": r.p2_wins, "draws": r.draws,
            "win_rate": r.p1_win_rate, "elo": elo_from_win_rate(r.p1_win_rate),
            "seconds": seconds, "seed": seed, "plies": searched, "b1_launches": launches,
            "ms_per_ply": 1e3 * seconds / searched if searched else None}


def matches(recipe: str, run_cfg, run_dir: str, last_step: int, cpu: bool) -> list:
    from minizero_tpu_torch.envs import make_env
    from minizero_tpu_torch.eval.match import load_checkpoint_variables
    from minizero_tpu_torch.models.factory import create_network
    from minizero_tpu_torch.weights import (from_jax_muzero_variables, from_jax_variables,
                                            load_variables_npz)

    device = "cpu" if cpu else "cuda"
    games = CPU_MATCH_GAMES if cpu else MATCH_GAMES
    plies = CPU_MATCH_PLIES if cpu else None
    opening = OPENING_PLIES[recipe]
    full = recipe_config(recipe=recipe).replace(zero_num_parallel_games=min(games, 96))
    cfg = run_cfg.replace(zero_num_parallel_games=min(games, 96))
    convert = from_jax_muzero_variables if recipe == "gmz" else from_jax_variables

    def jax_net(step):
        net = create_network(full, make_env(full).spec)
        net.load_state_dict(convert(load_variables_npz(jax_net_path(recipe, step)), hidden_hw=81))
        return net.eval()

    def port_net(step):
        return load_checkpoint_variables(
            os.path.join(run_dir, "model", f"weight_iter_{step}.ckpt"), cfg)

    pairs = []
    # the port's own ladder (scripts/elo_curve.py; the CPU form a rung an
    # iteration), each rung beside the JAX run's at the same steps
    every = (1 if cpu else LADDER_EVERY[recipe]) * cfg.learner_training_step
    rungs = last_step // every if LADDER_EVERY[recipe] else 0
    for i in range(1, rungs + 1):
        jax_rung = None if cpu else JAX_LADDER_GMZ.get(i * every)
        pairs.append((f"r{i}", f"port {i * every} vs port {(i - 1) * every}", cfg,
                      port_net(i * every), port_net((i - 1) * every), 1000 + i,
                      jax_rung and dict(zip(("wins", "losses", "draws"), jax_rung))))
    pairs += [("a", "JAX run 12500 vs JAX run 0", full, jax_net(12500), jax_net(0), MATCH_SEED,
               JAX_LADDER if recipe == "gaz" else None),
              ("b", f"port {last_step} vs port 0", cfg, port_net(last_step), port_net(0),
               MATCH_SEED, None)]
    if not cpu:
        # the CPU form's run trains a narrower net than the JAX run's
        pairs.append(("c", f"port {last_step} vs JAX run 12500", cfg, port_net(last_step),
                      jax_net(12500), MATCH_SEED, None))
    out = []
    for key, name, mcfg, a, b, seed, jax_ladder in pairs:
        r = {"match": key, "pair": name,
             **match(mcfg, a, b, games, plies, device, seed, opening)}
        if jax_ladder:
            r["jax_ladder"] = jax_ladder
        print(json.dumps(r), flush=True)
        out.append(r)
    return out


# ---------------------------------------------------------------------- main

def main(recipe: str = "gaz", run_dir: str = "", first: int = 1, last: int = LAST,
         split: int = 0, out_dir: str = "", platform: str = "gpu") -> None:
    cpu = platform == "cpu"
    split = int(split) or SPLIT[recipe]
    if cpu and (int(first), int(last), split) == (1, LAST, SPLIT[recipe]):
        last, split = 2, 1
    first, last = int(first), int(last)
    run_dir = os.path.abspath(run_dir or os.path.join(ROOT, "_runs", f"go9_{recipe}_recipe"))
    out_dir = os.path.abspath(out_dir or os.path.join(run_dir, "out"))
    os.makedirs(out_dir, exist_ok=True)
    if not cpu:
        import torch

        if not torch.cuda.is_available():
            fail("no CUDA device (torch.cuda.is_available() is False)")
    cfg = recipe_config(cpu, recipe)
    steps = cfg.learner_training_step
    newest = os.path.join(run_dir, "model", f"weight_iter_{(first - 1) * steps}.ckpt")
    if first > 1 and not os.path.exists(newest):
        fail(f"first={first} needs {newest}")
    if first == 1 and os.path.isdir(os.path.join(run_dir, "model")):
        fail(f"{run_dir} already holds a run; remove it or pass first > 1")
    os.makedirs(run_dir, exist_ok=True)
    conf_file = os.path.join(run_dir, "recipe.cfg")
    cfg.save_file(conf_file)
    ends = sorted({e for e in (split, last) if first <= e <= last})
    unroll_at = ",".join(str(i) for i in sorted(set(UNROLL_CHECKED) | {split, last}))
    train_log = os.path.join(run_dir, "Training.log")
    log_from = os.path.getsize(train_log) if os.path.exists(train_log) else 0
    t0 = time.perf_counter()
    for index, end in enumerate(ends, 1):
        log_path = os.path.join(out_dir, f"process{index}.log")
        cmd = [sys.executable, os.path.abspath(__file__), "--process", run_dir, conf_file,
               str(end), platform, str(index), unroll_at]
        with open(log_path, "w") as log:
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True, cwd=ROOT)
            for line in proc.stdout:
                log.write(line)
                if line.startswith("{"):
                    print(line, end="", flush=True)
            if proc.wait() != 0:
                log.flush()
                tail = open(log_path).read()[-3000:]
                fail(f"process {index} (iterations to {end}) exited {proc.returncode}:\n{tail}")
    train_s = time.perf_counter() - t0

    # the run's files: every iteration's records, the resume lines, no
    # checkpoint skipped
    games = cfg.zero_num_games_per_iteration
    for it in range(1, last + 1):
        n = sum(1 for line in open(os.path.join(run_dir, "sgf", f"{it}.sgf")) if line.strip())
        if n != games:
            fail(f"sgf/{it}.sgf holds {n} records, expected {games}")
    with open(train_log) as f:
        f.seek(log_from)
        log_text = f.read()  # this call's lines
    resumes = [line.split("] ", 1)[1] for line in log_text.splitlines() if "[Resume]" in line]
    want = [f"[Resume] iteration {e}, {min(e, cfg.zero_replay_buffer) * games} games reloaded"
            for e in ([first - 1] if first > 1 else []) + ends[:-1]]
    if resumes != want:
        fail(f"Training.log's resume lines {resumes}, expected {want}")
    last_step = last * steps
    ckpts = sorted(int(f.split("_")[-1].split(".")[0])
                   for f in os.listdir(os.path.join(run_dir, "model")) if f.endswith(".ckpt"))
    if ckpts[-1] != last_step:
        fail(f"newest checkpoint at step {ckpts[-1]}, expected {last_step}")
    for name in ("Training.log", "op.log", "perf.jsonl", "recipe.cfg"):
        shutil.copy(os.path.join(run_dir, name), out_dir)
    analysis_skipped = log_text.count("[Analysis] skipped")

    results = matches(recipe, cfg, run_dir, last_step, cpu)
    wld = {r["match"]: [r["wins"], r["losses"], r["draws"]] for r in results}
    print(json.dumps({
        "summary": "zero recipe", "recipe": recipe, "iterations": [first, last],
        "processes": len(ends),
        "train_s": train_s, "step": last_step, "records_per_iteration": games,
        "resume_lines": resumes, "analysis_skipped": analysis_skipped, "matches": wld,
        "seconds": time.perf_counter() - t0,
        "device": card() if not cpu else "cpu"}), flush=True)
    if recipe == "gmz" and not cpu:
        weak = {k: wld[k] for k in ("a", "b") if wld[k][0] < MIN_WINS}
        if weak:
            fail(f"matches {weak}: fewer than {MIN_WINS} wins of {MATCH_GAMES}")


if __name__ == "__main__":
    if sys.argv[1:2] == ["--process"]:
        d, conf, end, plat, idx, unroll = sys.argv[2:8]
        run_process(d, conf, int(end), plat, int(idx),
                    unroll_at={int(i) for i in unroll.split(",") if i})
    else:
        args = [a for a in sys.argv[1:] if a != "cpu"]
        name = args.pop(0) if args[:1] and args[0] in RECIPES else "gaz"
        main(name, *args, platform="cpu" if "cpu" in sys.argv[1:] else "gpu")

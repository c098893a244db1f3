"""The reference training recipes through the PyTorch port: the port's
counterparts of the JAX runs ``runs/go9_gaz_full`` (``gaz``, the default),
``runs/go9_gmz_r4`` (``gmz``) and ``runs/go9_az200_r3b`` (``az``).

``gaz``: Go 9x9 Gumbel AlphaZero at n=16, from ``runs/go9_gaz_full.cfg``.
``gmz``: Go 9x9 Gumbel MuZero at n=16 with K=5 unroll steps, from the
``config`` entry of ``runs/go9_gmz_r4/model/weight_iter_12500.ckpt`` (its
Dirichlet root noise included). Both: 2,000 games and 500 SGD steps an
iteration. ``az``: Go 9x9 plain AlphaZero at n=200, from the ``config``
entry of ``runs/go9_az200_r3b/model/weight_iter_3125.ckpt``: Dirichlet
root noise (alpha 0.03, epsilon 0.25), actions drawn from the softmax of
the counts, resignation at -0.9 with 10% of the games kept playing, 500
games and 125 SGD steps an iteration; its searches run on the packed trees
(tree step B2, parent states gathered by B3). All three: a net of 1 block
x 256 channels, 1,024 games in lock-step, batch 1,024, SGD at lr 0.02,
momentum 0.9, weight decay 1e-4, a replay window of 20 iterations and
random rotation of the features, from iteration 0 with
``program_seed=0``. The config is built from ``default_config("go",
**algorithm_preset(recipe))`` and the recipe's overrides (``RECIPE``,
``RECIPE_GMZ``, ``RECIPE_AZ``), written to ``recipe.cfg`` in the run
directory and handed to the port's CLI (``python -m minizero_tpu_torch
-mode zero -conf_file ... -conf_str zero_end_iteration=E -run_dir DIR``)
in one process for
iterations ``first``..``split`` and in a second one, the same command with
``zero_end_iteration=last``, which resumes the run from its newest
checkpoint (``ZeroLoop.resume``: the replay window's features rebuilt on
the device from the record files).

Each process calls the CLI's ``main`` with that argument list inside this
script (``--process``), which wraps the loop's methods to measure each
iteration and check it: exactly ``zero_num_games_per_iteration`` games;
for ``gaz`` and ``gmz`` tree step B1 launched 17 times a move (n + 1) in
its board regime and B1', B2, B3 never, for ``az`` B2 201 times a move and
B3 200 times, every B3 launch on its aligned path, and B1, B1' never;
finite losses (``loss_reward`` 0 for MuZero on a board
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
``runs/go9_gmz_r4/elo_curve.json``): for ``gmz`` and ``az`` first the
port's own ladder, a rung every 5 iterations (step s i against s (i - 1)
at seed 1000 + i up to the last step), each beside the JAX run's rung;
then (a) the JAX run's newest exported net (step 12,500; ``az``: 3,125)
against its step-0 net (``minizero_tpu_torch/assets/{JAX_RUN}_iter*.npz``,
exported by ``scripts/export_trained_weights.py``); for ``gaz`` and
``gmz`` (b) the port's own last net against its step-0 net; (c) the port's
last net against the JAX run's newest, reported only (``az``: beside the
wins the JAX ladder's Elo gap between the two steps predicts); (a) to (c)
at seed 1001. On the card the matches of ``MIN_WINS`` must win at least
that many of the 96 games, and those of ``MORE_WINS`` more than they lose.

``atari``: the port's counterpart of ``runs/atari_gmz_r5_b128``, Atari
Gumbel MuZero at n=18 from the ``config`` entry of its
``model/weight_iter_6000.ckpt`` (``RECIPE_ATARI``), over
``FakeALE(seed=s, length=900)`` as ``scripts/run_atari_gmz.py`` ran it: 128
games in lock-step and 128 records an iteration (chunks of 200 positions),
200 SGD steps at batch 128, K=5, n-step 10, PER, a replay window of 7
iterations whose frames live on the card (``learner/frame_window.py``).
Each process builds ``ZeroLoop(cfg, run_dir, ale_factory=...)`` itself,
then ``resume`` and ``run`` (the CLI builds the real ALE), for iterations
1-19, 20-25, 26-30 and 31, the JAX run's resumes. ``zero_end_iteration``
stays 30 (31 in the last process), as the temperature and PER schedules
read it, and a process stops before the iteration after its last one. The
checks differ from the board games': every record's length equal to what
the episodes give (``atari_lengths``: 215 and 25 moves, alternating from
each fresh start) and, in the full run, to the JAX run's (``JAX_ATARI``);
B1' (the reward regime) 19 times a move and B1, B2, B3 never; a finite
``loss_reward``; the frame window on the card and holding exactly the
buffer's records; after each iteration whose window wrapped, after the
last one and after each resume, ``STACKS_CHECKED`` sampled stacks
assembled from the window equal to ``rebuild_features_from_frames`` of
their records on the host; on resume every record equal to what its file
holds of the one self-play added (``game_digest``), each continuation
chunk with its lead frames dropped (``frame_lead`` 0, the JAX loop's
documented approximation). After the run, on the card, the return gates
of ``ATARI_GATES``; no match is played.

Prints one JSON line an iteration, one a process, one a match, then a
summary line with the card's name and power limit from ``nvidia-smi``.
Each process's output goes to ``out_dir/process{i}.log`` and the run's
logs (``Training.log``, ``op.log``, ``perf.jsonl``, ``recipe.cfg``) are
copied to ``out_dir`` (default ``run_dir/out``).

    python3 scripts/zero_recipe_torch.py [gaz|gmz|az|atari] [run_dir] [first=1] \
        [last=25 (gaz, gmz), 10 (az), 31 (atari)] \
        [split=12 (gaz), 8 (gmz), 5 (az), 19,25,30 (atari)] [out_dir] [cpu]

``run_dir`` defaults to ``_runs/go9_{recipe}_recipe`` (``atari``:
``_runs/atari_gmz_recipe``; git-ignored). With
``first`` > 1 the run directory must hold the checkpoint of iteration
``first - 1``. ``cpu`` runs everything on the CPU (the kernels' plain
versions) at a tiny size: a 1 x 16 net, 2 simulations, 4 games an
iteration, 4 SGD steps at batch 8, iterations 1-2 split after 1, 2 games a
match capped at 8 plies a round (match (a) at the JAX nets' full width and
the CPU form's simulations), and for ``gmz`` and ``az`` a ladder rung an
iteration; ``az`` with the changes of ``CPU_RECIPE`` (47 simulations, the
fewest that take the packed trees; games resigned at their second move)
and 2 plies a round; ``atari`` with those of ``CPU_RECIPE`` (the JAX
runner's ``ATARI_SMOKE_TINY`` sizes, FakeALE episodes of 64 moves in chunks
of 32, a window of one iteration, which wraps) over iterations 1-4 split
after 2.
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
# the config entry of runs/go9_az200_r3b/model/weight_iter_3125.ckpt over
# default_config("go", **algorithm_preset("az")), but for the iteration
# that run was resumed at (25): this run starts from 0
RECIPE_AZ = dict(
    env_board_size=9, actor_num_simulation=200, actor_use_dirichlet_noise=True,
    actor_dirichlet_noise_alpha=0.03, actor_dirichlet_noise_epsilon=0.25,
    actor_select_action_by_softmax_count=True, actor_select_action_softmax_temperature=1.0,
    actor_use_random_rotation_features=True, actor_resign_threshold=-0.9,
    zero_disable_resign_ratio=0.1, nn_num_blocks=1, nn_num_hidden_channels=256,
    nn_num_value_hidden_channels=256, zero_num_parallel_games=1024,
    zero_num_games_per_iteration=500, zero_replay_buffer=20, learner_training_step=125,
    learner_training_display_step=100, learner_batch_size=1024, learner_optimizer="SGD",
    learner_learning_rate=0.02, learner_momentum=0.9, learner_weight_decay=1e-4,
    program_seed=0, zero_start_iteration=0, zero_end_iteration=50)
# the config entry of runs/atari_gmz_r5_b128/model/weight_iter_6000.ckpt over
# default_config("atari", **algorithm_preset("gmz", is_atari=True)), but for
# the iteration that run was last resumed at (30): this run starts from 0
RECIPE_ATARI = dict(
    actor_num_simulation=18, actor_gumbel_sample_size=18, actor_mcts_value_rescale=True,
    actor_mcts_reward_discount=0.997, actor_mcts_init_q_average=True,
    actor_select_action_by_softmax_count=True, actor_select_action_softmax_temperature_decay=True,
    nn_num_blocks=1, nn_num_hidden_channels=256, nn_num_value_hidden_channels=256,
    zero_num_parallel_games=128, zero_num_games_per_iteration=128, zero_replay_buffer=7,
    zero_actor_intermediate_sequence_length=200, zero_actor_record_observations=True,
    learner_use_per=True, learner_training_step=200, learner_training_display_step=100,
    learner_batch_size=128, learner_muzero_unrolling_step=5, learner_n_step_return=10,
    learner_optimizer="SGD", learner_learning_rate=0.02, learner_momentum=0.9,
    learner_weight_decay=1e-4, program_seed=0, program_auto_seed=False,
    zero_start_iteration=0, zero_end_iteration=31)
RECIPES = {"gaz": RECIPE, "gmz": RECIPE_GMZ, "az": RECIPE_AZ, "atari": RECIPE_ATARI}
# the CPU form, cut to seconds: a narrow net, 2 simulations, 4 games; az
# keeps 47 simulations, the fewest whose trees (48 nodes) the engine packs
# (selfplay/engine.py use_tree_kernel_v2), so that it runs B2's and B3's
# plain versions, at about 1 s a move: so every game resigns at its
# second move (a threshold above any value) but the 10% kept playing, a
# dispatch is 2 moves (an iteration dispatches one more than it collects)
# and a match plays 2 plies a round
CPU_TINY = dict(actor_num_simulation=2, actor_gumbel_sample_size=2, nn_num_hidden_channels=16,
                nn_num_value_hidden_channels=16, zero_num_parallel_games=4,
                zero_num_games_per_iteration=4, learner_training_step=4,
                learner_training_display_step=2, learner_batch_size=8)
# atari: scripts/run_atari_gmz.py's ATARI_SMOKE_TINY sizes; episodes of 64
# moves (CPU_FAKE_LENGTH frames) in chunks of 32, so a chunk of 36
# positions (32 and the K + n margin) then the episode's last 32, and a
# window of one iteration, whose frame ring (rows_needed: 300 rows) wraps
# in the second iteration of each process
CPU_RECIPE = {"az": dict(actor_num_simulation=47, actor_resign_threshold=1.0,
                        zero_moves_per_dispatch=2),
              "atari": dict(nn_num_hidden_channels=8, nn_num_value_hidden_channels=8,
                            actor_num_simulation=3, actor_gumbel_sample_size=3,
                            learner_training_step=2, learner_batch_size=4,
                            learner_muzero_unrolling_step=2, learner_n_step_return=2,
                            zero_actor_intermediate_sequence_length=32, zero_replay_buffer=1)}
LAST = {"gaz": 25, "gmz": 25, "az": 10, "atari": 31}
# the process split: the JAX gmz run was itself resumed at iteration 8
# (runs/go9_gmz_r4/Training.log:53); az at the middle of its 10 iterations;
# atari at the JAX run's resumes (runs/atari_gmz_r5_b128/Training.log)
SPLIT = {"gaz": (12,), "gmz": (8,), "az": (5,), "atari": (19, 25, 30)}
# the CPU form's iterations and split
CPU_RUN = {"atari": (4, (2,))}
# FakeALE's episode length in frames: the JAX runner's (4 frames a move:
# 225 moves), and the CPU form's (64 moves)
FAKE_LENGTH, CPU_FAKE_LENGTH = 900, 256
# the zero_end_iteration of every atari process but the last, which takes
# the run's last iteration (scripts/run_atari_gmz.py:87); the JAX run's
# first process did not record its own, and README.md calls the run a
# 30-iteration run
ATARI_SCHEDULE_END = 30
# runs/atari_gmz_r5_b128/Training.log: each iteration's game length (min =
# max) and returns (min, max, mean), the last lines logged for it (the
# first process had played an iteration 20 before the resume at 19)
JAX_ATARI = {
    1: (215, 356, 512, 435.66), 2: (25, 380, 548, 461.97), 3: (215, 544, 684, 607.09),
    4: (25, 584, 720, 645.88), 5: (215, 536, 684, 602.31), 6: (25, 572, 724, 638.12),
    7: (215, 704, 840, 779.84), 8: (25, 744, 880, 819.66), 9: (215, 804, 860, 844.62),
    10: (25, 840, 900, 884.06), 11: (215, 840, 860, 854.62), 12: (25, 880, 900, 894.56),
    13: (215, 800, 860, 845.72), 14: (25, 820, 900, 880.41), 15: (215, 848, 860, 858.81),
    16: (25, 888, 900, 898.81), 17: (215, 844, 860, 857.75), 18: (25, 884, 900, 897.59),
    19: (215, 852, 860, 858.97), 20: (215, 852, 860, 859.31), 21: (25, 892, 900, 899.28),
    22: (215, 672, 844, 779.62), 23: (25, 700, 876, 808.34), 24: (215, 856, 860, 859.72),
    25: (25, 896, 900, 899.53), 26: (215, 840, 860, 853.06), 27: (25, 880, 900, 892.06),
    28: (215, 836, 860, 856.66), 29: (25, 876, 900, 895.91), 30: (215, 796, 856, 833.84),
    31: (215, 836, 860, 853.84)}
# its [Resume] lines: the iteration and the records reloaded (1,024 at 25:
# sgf/20.sgf held the first process's iteration 20 as well)
JAX_ATARI_RESUMES = {19: 896, 25: 1024, 30: 896}
# on the card: iteration 1's mean return within 15 of the JAX run's (about
# 6 standard errors of a 128-game mean at its std of 28.61), and the mean
# over the 215-move iterations from 9 on at least 820 (JAX: about 846.6)
ATARI_GATES = {"first_return": (435.66, 15.0), "learned_from": 9, "learned_min": 820.0}
# sampled stacks held against the host's rebuild (the CPU form's fewer)
STACKS_CHECKED, CPU_STACKS_CHECKED = 256, 32
MATCH_GAMES = 96
# scripts/elo_curve.py: seed 1000 + i for the ladder's i-th pair; at an
# interval of 25 iterations (runs/go9_gaz_full/elo_curve.json) the pair of
# iterations 25 and 0 is i = 1
MATCH_SEED = 1001
CPU_MATCH_GAMES = 2
CPU_MATCH_PLIES = {"gaz": 8, "gmz": 8, "az": 2}
# runs/go9_gmz_r4/elo_curve.json: 4 uniform opening plies, a rung every 5
# iterations; runs/go9_az200_r3b/elo_curve.json: no opening plies, a rung
# every 5 iterations
OPENING_PLIES = {"gaz": 0, "gmz": 4, "az": 0}
LADDER_EVERY = {"gaz": 0, "gmz": 5, "az": 5}
ASSETS = os.path.join(ROOT, "minizero_tpu_torch", "assets")
JAX_RUN = {"gaz": "go9_gaz_full", "gmz": "go9_gmz_r4", "az": "go9_az200_r3b",
           "atari": "atari_gmz_r5_b128"}
# the newest step of each JAX run (match (a), and (c)'s opponent; atari's
# checkpoint holds its config entry and plays no match)
JAX_STEP = {"gaz": 12500, "gmz": 12500, "az": 3125, "atari": 6000}
# the JAX runs' ladders at this protocol (runs/*/elo_curve.json): gaz's
# pair of iterations 25 and 0; gmz's first five rungs and az's first two
# (W, L, D)
JAX_LADDER = {"wins": 87, "losses": 9, "draws": 0}
JAX_LADDERS = {"gmz": {2500: (63, 33, 0), 5000: (79, 17, 0), 7500: (78, 18, 0),
                       10000: (64, 32, 0), 12500: (76, 20, 0)},
               "az": {625: (91, 5, 0), 1250: (75, 21, 0)}}
# the az ladder's Elo at the steps this script reaches and at JAX_STEP
# (runs/go9_az200_r3b/elo_curve.json "points")
JAX_ELO_AZ = {625: 504.0, 1250: 725.2, 3125: 1360.9}
# on the card: the matches that must each win at least this many of 96,
# and those that must win more games than they lose
MIN_WINS = {"gaz": {}, "gmz": {"a": 80, "b": 80}, "az": {"r1": 80, "a": 90}}
MORE_WINS = {"gaz": (), "gmz": (), "az": ("r2",)}
# the recipes that play (b), the port's last net against its first; az's
# rungs are the port's own steps already
PORT_PAIR = ("gaz", "gmz")
# gmz: the iterations after which unroll_check runs
UNROLL_CHECKED = (1, 8, 20, 21, 25)
UNROLL_SEED = 19
SGD_TIMED_FROM = 11


def expected_wins(elo_gap: float, games: int = MATCH_GAMES) -> float:
    """The wins of ``games`` that an Elo lead of ``elo_gap`` predicts."""
    return games / (1.0 + 10.0 ** (-elo_gap / 400.0))


def jax_net_path(recipe: str, step: int) -> str:
    return os.path.join(ASSETS, f"{JAX_RUN[recipe]}_iter{step}.npz")


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def recipe_config(cpu: bool = False, recipe: str = "gaz"):
    from minizero_tpu_torch.config import algorithm_preset, default_config

    atari = recipe == "atari"  # Gumbel MuZero; the others play Go
    cfg = default_config("atari" if atari else "go", **algorithm_preset(
        "gmz" if atari else recipe, is_atari=atari)).replace(**RECIPES[recipe])
    if not cpu:
        return cfg
    return cfg.replace(**{**CPU_TINY, **CPU_RECIPE.get(recipe, {})})


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


def as_printed(x):
    """Floats as a record prints them (``%g``) and its parser reads them
    back into float32."""
    return np.asarray([float(f"{float(v):g}") for v in np.ravel(x)], np.float32)


def game_digest(rec) -> str:
    """A game as the replay window trains on it after a reload: actions,
    feature planes, policy targets (``as_reloaded`` unless the game was
    reloaded) and result. The root values, printed to 6 digits in the
    records, are left out: board games train on the result. An Atari
    record (frames schema) gives every field its line holds: actions,
    policy, values, rewards and result as printed, the lives-lost flags,
    the trained range and the frames of its own positions (OBS); not its
    lead frames, which the line does not hold."""
    policy = rec.policy if getattr(rec, "reloaded", False) else as_reloaded(rec.policy)
    if rec.frames is None:
        arrays = (rec.actions, rec.features, policy)
    else:
        arrays = (rec.actions, policy, as_printed(rec.values), as_printed(rec.rewards),
                  np.asarray(rec.lives_lost, bool), np.asarray(rec.data_range, np.int64),
                  rec.frames[rec.frame_lead:])
    h = hashlib.sha1()
    for a in arrays:
        h.update(memoryview(np.ascontiguousarray(a).tobytes()))
    h.update(repr(float(as_printed(rec.result)[0])).encode())
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


def atari_lengths(cfg, frames: int, iterations: int) -> list:
    """The record length of each of ``iterations`` iterations that one
    process plays from fresh episodes of ``frames`` FakeALE frames (4 a
    move), every game in lock-step and one record a game an iteration: the
    collector's chunking rule (``actor_group.cpp:52-64``) followed by hand.
    A chunk leaves every ``seqlen`` positions once ``seqlen`` and the
    margin are played; the episode's end leaves its last chunk, reaching
    back one more ``seqlen`` when fewer than the margin remain."""
    seqlen = cfg.zero_actor_intermediate_sequence_length
    margin = cfg.learner_muzero_unrolling_step + cfg.learner_n_step_return
    episode = -(-frames // 4)
    out, t = [], 0
    while len(out) < iterations:
        t += 1
        if t == episode:
            start = (t - 1) - (t - 1) % seqlen
            if (t - 1) % seqlen < margin:
                start -= seqlen
            out.append(t - max(start, 0))
            t = 0
        elif t >= seqlen and (t - margin) % seqlen == 0:
            out.append(seqlen + margin)
    return out


def stacks_check(loop, count: int, seed: int) -> dict:
    """``count`` (game, position) draws of the replay buffer, their stacks
    assembled from the frame window against ``rebuild_features_from_frames``
    of their records on the host (lead frames included: the 9 frames up to
    the position). Fails at the first difference."""
    from minizero_tpu_torch.envs.atari import rebuild_features_from_frames

    fw, buffer = loop.frame_window, loop.buffer
    games, pos, _ = buffer.sample_indices(count, np.random.RandomState(seed))
    recs = [buffer.games[g] for g in games]
    got = fw.assemble(fw.lookup(recs, pos)).cpu().numpy()
    for j, (rec, p) in enumerate(zip(recs, pos)):
        lead = np.zeros(0, np.int32) if rec.lead_actions is None else rec.lead_actions
        acts = np.concatenate([lead, rec.actions])
        q = rec.frame_lead + int(p)
        s = max(0, q - 8)
        if not np.array_equal(got[j], rebuild_features_from_frames(rec.frames[s:q + 1],
                                                                    acts[s:q + 1])[-1]):
            fail(f"stack {j} (record {games[j]}, position {p}) assembled from the frame window "
                 f"differs from rebuild_features_from_frames")
    return {"stacks": count, "with_lead": int(sum(r.frame_lead > 0 for r in recs))}


# ------------------------------------------------------------------ process

class StopProcess(Exception):
    """Raised before the iteration after a process's last one."""


class KeptStep:
    """The search's tree step, keeping a copy of the inputs of the middle
    simulation's launch of each iteration's first move; ``ms`` times the
    kernel on fresh copies of them (``chip_smoke.time_events``: CUDA
    events, the card held on a sleep kernel while the launches are
    enqueued)."""

    def __init__(self, fn, sim: int):
        self.fn, self.sim, self.kept = fn, sim, None

    def __call__(self, spec, trees, sel, *args, **kwargs):
        if self.kept is None and args[-2] == self.sim:
            self.kept = (spec, trees.clone(), sel, args, kwargs)
        return self.fn(spec, trees, sel, *args, **kwargs)

    def ms(self, reps: int = 20) -> float:
        from chip_smoke import time_events

        spec, trees, sel, args, kwargs = self.kept
        copies = [trees.clone() for _ in range(reps + 1)]
        self.kept = None
        return time_events(lambda i: self.fn(spec, copies[i], sel, *args, **kwargs), reps)


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
                unroll_at=(), recipe: str = "gaz", schedule_end: int = 0) -> None:
    """One process of the run: the CLI's ``-mode zero`` in this process (for
    ``atari`` the loop built here over FakeALE, resumed and run, with
    ``zero_end_iteration`` at ``schedule_end`` and a stop before iteration
    ``end + 1``), the loop's methods wrapped to measure and check each
    iteration; for board-game MuZero ``unroll_check`` after the iterations
    of ``unroll_at`` and the resume. ``az`` searches on the packed trees
    (B2, B3), ``atari`` on B1' and the others on B1."""
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

    packed = recipe == "az"
    atari = recipe == "atari"
    fake_length = FAKE_LENGTH if cuda else CPU_FAKE_LENGTH
    stacks = STACKS_CHECKED if cuda else CPU_STACKS_CHECKED

    def counts():
        return (fused_tree_step.launches, fused_tree_step.launches_rewards,
                fused_tree_step_v2.launches, gather_rows.launches, gather_rows.launches_aligned)

    init, resume = zl.ZeroLoop.__init__, zl.ZeroLoop.resume
    self_play, optimize = zl.ZeroLoop.self_play_iteration, zl.ZeroLoop.optimize_iteration
    selfplay_stats, log_metrics = zl.ZeroLoop._selfplay_stats, zl.ZeroLoop._log_metrics
    add_game = ReplayBuffer.add_game

    def tagged_add(self, record):
        # the iteration whose self-play made the game; a reloaded game
        # takes its tag from the previous process's digest file
        record.iteration = now["iteration"]
        if atari:
            t = time.perf_counter()
            record.reloaded = now["iteration"] == -1
            record.file_digest = game_digest(record)
            record.added_lead = record.frame_lead
            # inside the loop's records seconds: reported apart
            it_stats["digest_s"] = it_stats.get("digest_s", 0.0) + time.perf_counter() - t
        elif self.cfg.nn_type_name == "muzero":
            record.added_digest = record_digest(record)
        add_game(self, record)

    def checked_unroll(loop, when):
        t = time.perf_counter()
        try:
            out = unroll_check(loop.buffer, loop.cfg.learner_batch_size)
        except AssertionError as e:
            fail(f"{when}: the unrolled targets: {e}")
        return {**out, "seconds": time.perf_counter() - t}

    def checked_window(loop, when):
        """The frame window on the card, holding exactly the buffer's
        records."""
        fw = loop.frame_window
        if cuda and not (fw.on_device and fw.frames.device.type == "cuda"):
            fail(f"{when}: the frame window is not on the card")
        if list(fw._games) != [id(g) for g in loop.buffer.games]:
            fail(f"{when}: the frame window holds {len(fw._games)} records, the buffer "
                 f"{len(loop.buffer)}, or in another order")

    def wrapped_init(self, *args, **kwargs):
        init(self, *args, **kwargs)
        if (self.device.type == "cuda") != cuda:
            fail(f"the loop runs on {self.device}, expected {'cuda' if cuda else 'cpu'}")
        if getattr(self.engine, "use_tree_kernel_v2", False) != packed:
            fail(f"the engine's use_tree_kernel_v2 is {self.engine.use_tree_kernel_v2} for "
                 f"{recipe}")
        if atari and cuda:
            n = self.engine.search_spec.num_simulations
            self.engine.search.tree_step = KeptStep(self.engine.search.tree_step, (n + 1) // 2)
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
        if atari:
            line["digest_s"] = it_stats.pop("digest_s", 0.0)
        previous = os.path.join(run_dir, f"digest_step{self.state.step}.json")
        if start > 0:
            if not os.path.exists(previous):
                fail(f"resume: no digest of the previous process at {previous}")
            with open(previous) as f:
                want = json.load(f)
            got = [g.file_digest if atari else game_digest(g) for g in self.buffer.games]
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
            if atari:
                # continuation chunks come back without their lead frames
                # (zero_start pads their pre-chunk history with zeros)
                if any(g.frame_lead or g.lead_actions is not None for g in self.buffer.games):
                    fail("resume: a reloaded record kept lead frames")
                line["leads_dropped"] = sum(1 for lead in want["leads"] if lead)
                checked_window(self, f"resume at iteration {start}")
                line["stacks"] = stacks_check(self, stacks, seed=self.state.step)
            elif self.is_muzero:
                line["unroll"] = checked_unroll(self, f"resume at iteration {start}")
        print(json.dumps(line), flush=True)
        return start

    def wrapped_selfplay_stats(self, iteration, num_games, lengths, returns, dt):
        it_stats["lengths"] = list(lengths)
        it_stats["returns"] = [min(returns), max(returns)]
        return selfplay_stats(self, iteration, num_games, lengths, returns, dt)

    def wrapped_log_metrics(self, step, sums, n):
        it_stats["losses"] = {k: float(v) / n for k, v in sums.items()}
        it_stats["losses_step"] = step
        return log_metrics(self, step, sums, n)

    def wrapped_self_play(self, iteration):
        if iteration > end:
            raise StopProcess
        if "first" not in now and atari:
            now["first"] = iteration
            now["lengths"] = atari_lengths(self.cfg, fake_length, end - iteration + 1)
        now["iteration"] = iteration
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        cursor = self.frame_window._cursor if atari else 0
        before = counts()
        stats = self_play(self, iteration)
        if cuda:
            torch.cuda.synchronize()
        b1, b1r, b2, b3, b3_aligned = (a - b for a, b in zip(counts(), before))
        timing = dict(self.last_selfplay_timing)
        moves = timing["moves"] if atari else timing["chunks"] * timing["moves_per_chunk"]
        lengths = it_stats.pop("lengths")
        return_min, return_max = it_stats.pop("returns")
        it_stats.update(
            iteration=iteration, process=index, games=stats["games"],
            selfplay_s=stats["time_s"], games_per_s=stats["games_per_sec"],
            timing=timing, moves=moves, length_min=min(lengths), length_max=max(lengths),
            length_avg=stats["length_avg"], return_avg=stats["return_avg"],
            return_min=return_min, return_max=return_max,
            launches={"tree_step": b1, "tree_step_rewards": b1r, "tree_step_v2": b2,
                      "gather_rows": b3, "gather_rows_aligned": b3_aligned})
        if stats["games"] != self.cfg.zero_num_games_per_iteration:
            fail(f"iteration {iteration}: {stats['games']} games")
        n = (self.engine.search_spec if atari else self.engine.spec).num_simulations
        want = ((0, 0, moves * (n + 1), moves * n, moves * n) if packed else
                (0, moves * (n + 1), 0, 0, 0) if atari else (moves * (n + 1), 0, 0, 0, 0))
        if cuda and (b1, b1r, b2, b3, b3_aligned) != want:
            fail(f"iteration {iteration}: launches {it_stats['launches']} over {moves} moves")
        if atari:
            length = now["lengths"][iteration - now["first"]]
            if (min(lengths), max(lengths)) != (length, length):
                fail(f"iteration {iteration}: record lengths {min(lengths)}-{max(lengths)}, "
                     f"expected {length}")
            fw = self.frame_window
            it_stats.update(
                temperature=zl.temperature_for_iteration(self.cfg, iteration),
                window_cursor=fw._cursor, window_rows=fw.rows, wrapped=fw._cursor < cursor,
                b1r_ms=self.engine.search.tree_step.ms() if cuda else None)
            if cuda:
                it_stats["jax"] = dict(zip(("length", "return_min", "return_max", "return_avg"),
                                           JAX_ATARI.get(iteration, ()))) or None
        return stats

    def wrapped_optimize(self, iteration):
        out = optimize(self, iteration)
        cfg = self.cfg
        ms = self._train_step.take()
        losses = it_stats.get("losses", {})
        if not losses or not np.isfinite(list(losses.values())).all():
            fail(f"iteration {iteration}: losses {losses}")
        reward = losses.get("loss_reward")
        # a board game trains no reward head (learner/train.py muzero_loss);
        # Atari trains it
        if self.is_muzero and (reward is None or (not atari and reward != 0)):
            fail(f"iteration {iteration}: loss_reward {reward}")
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
        if atari:
            checked_window(self, f"iteration {iteration}")
            if it_stats["wrapped"] or iteration == end:
                it_stats["stacks"] = stacks_check(self, stacks, seed=self.state.step)
        elif self.is_muzero and iteration in unroll_at:
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
    t = time.perf_counter()
    if atari:
        from minizero_tpu_torch.config import default_config
        from minizero_tpu_torch.envs.atari import FakeALE

        cfg = default_config("atari").load_file(conf_file).replace(zero_end_iteration=schedule_end)
        loop = zl.ZeroLoop(cfg, run_dir, device=None if cuda else "cpu",
                           ale_factory=lambda s: FakeALE(seed=s, length=fake_length))
        loop.resume()
        try:
            loop.run()
        except StopProcess:
            pass
        loop.close()
    else:
        argv = ["-mode", "zero", "-conf_file", conf_file, "-conf_str",
                f"zero_end_iteration={end}", "-run_dir", run_dir] + (
                    ["-platform", "cpu"] if not cuda else [])
        if cli(argv) != 0:
            fail(f"the CLI returned non-zero: {argv}")
    (loop,) = loops
    if loop.state.step != end * loop.cfg.learner_training_step:
        fail(f"step counter {loop.state.step} after iteration {end}")
    # what the next process must rebuild on resume
    games = loop.buffer.games
    with open(os.path.join(run_dir, f"digest_step{loop.state.step}.json"), "w") as f:
        json.dump({"games": [g.file_digest if atari else game_digest(g) for g in games],
                   "iterations": [g.iteration for g in games],
                   "leads": [getattr(g, "added_lead", 0) for g in games],
                   "state": state_digest(loop)}, f)
    print(json.dumps({"process": index, "end_iteration": end, "step": loop.state.step,
                      "seconds": time.perf_counter() - t,
                      "host_peak_rss_mib":
                          resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024}), flush=True)


# -------------------------------------------------------------------- matches

def match(cfg, net_a, net_b, games: int, plies, device: str, seed: int = MATCH_SEED,
          opening_plies: int = 0) -> dict:
    """One ``play_match``; on the card its searched plies from the tree
    steps' launches (n + 1 a ply, B1's or B2's) and the kernels' counts,
    which must show one path: B1 alone, or B2 with B3 n times a ply, every
    B3 launch aligned."""
    import torch

    from minizero_tpu_torch.eval.match import elo_from_win_rate, play_match
    from minizero_tpu_torch.ops.gather_rows import gather_rows
    from minizero_tpu_torch.ops.tree_kernel import fused_tree_step
    from minizero_tpu_torch.ops.tree_kernel_v2 import fused_tree_step_v2

    def counts():
        return (fused_tree_step.launches, fused_tree_step_v2.launches, gather_rows.launches,
                gather_rows.launches_aligned)

    before = counts()
    if device == "cuda":
        torch.cuda.synchronize()
    t = time.perf_counter()
    r = play_match(cfg, net_a, net_b, num_games=games, seed=seed, max_moves=plies,
                   opening_random_plies=opening_plies, device=device)
    if device == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    b1, b2, b3, b3_aligned = (a - b for a, b in zip(counts(), before))
    n = cfg.actor_num_simulation
    searched = (b1 + b2) // (n + 1) if device == "cuda" else None
    if device == "cuda" and (b1 + b2 != searched * (n + 1) or (b1 and b2) or
                             (b3, b3_aligned) != ((searched * n,) * 2 if b2 else (0, 0))):
        fail(f"match at seed {seed}: launches B1 {b1}, B2 {b2}, B3 {b3} ({b3_aligned} aligned)")
    return {"wins": r.p1_wins, "losses": r.p2_wins, "draws": r.draws,
            "win_rate": r.p1_win_rate, "elo": elo_from_win_rate(r.p1_win_rate),
            "seconds": seconds, "seed": seed, "plies": searched, "b1_launches": b1,
            "b2_launches": b2, "b3_launches": b3,
            "ms_per_ply": 1e3 * seconds / searched if searched else None}


def matches(recipe: str, run_cfg, run_dir: str, last_step: int, cpu: bool) -> list:
    from minizero_tpu_torch.envs import make_env
    from minizero_tpu_torch.eval import match as tmatch
    from minizero_tpu_torch.eval.match import load_checkpoint_variables
    from minizero_tpu_torch.models.factory import create_network
    from minizero_tpu_torch.weights import (from_jax_muzero_variables, from_jax_variables,
                                            load_variables_npz)

    device = "cpu" if cpu else "cuda"
    games = CPU_MATCH_GAMES if cpu else MATCH_GAMES
    plies = CPU_MATCH_PLIES[recipe] if cpu else None
    if cpu:
        # a round ends at the cap, not at the next multiple of the
        # finished-games check
        tmatch.PLIES_PER_CHECK = plies
    opening = OPENING_PLIES[recipe]
    full = recipe_config(recipe=recipe).replace(zero_num_parallel_games=min(games, 96))
    cfg = run_cfg.replace(zero_num_parallel_games=min(games, 96))
    if cpu:
        # the JAX nets at their width, searching as the CPU form does
        full = full.replace(actor_num_simulation=cfg.actor_num_simulation,
                            actor_gumbel_sample_size=cfg.actor_gumbel_sample_size)
    top = JAX_STEP[recipe]
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
        jax_rung = None if cpu else JAX_LADDERS[recipe].get(i * every)
        pairs.append((f"r{i}", f"port {i * every} vs port {(i - 1) * every}", cfg,
                      port_net(i * every), port_net((i - 1) * every), 1000 + i,
                      jax_rung and dict(zip(("wins", "losses", "draws"), jax_rung))))
    pairs.append(("a", f"JAX run {top} vs JAX run 0", full, jax_net(top), jax_net(0), MATCH_SEED,
                  JAX_LADDER if recipe == "gaz" else None))
    if recipe in PORT_PAIR:
        pairs.append(("b", f"port {last_step} vs port 0", cfg, port_net(last_step), port_net(0),
                      MATCH_SEED, None))
    if not cpu:
        # the CPU form's run trains a narrower net than the JAX run's
        pairs.append(("c", f"port {last_step} vs JAX run {top}", cfg, port_net(last_step),
                      jax_net(top), MATCH_SEED, None))
    out = []
    for key, name, mcfg, a, b, seed, jax_ladder in pairs:
        r = {"match": key, "pair": name,
             **match(mcfg, a, b, games, plies, device, seed, opening)}
        if jax_ladder:
            r["jax_ladder"] = jax_ladder
        if key == "c" and recipe == "az" and last_step in JAX_ELO_AZ:
            # the JAX ladder's own nets at these two steps
            gap = JAX_ELO_AZ[last_step] - JAX_ELO_AZ[top]
            r["jax_expectation"] = {"elo": gap, "wins": expected_wins(gap)}
        print(json.dumps(r), flush=True)
        out.append(r)
    return out


# ---------------------------------------------------------------------- main

def atari_gates(iterations: list, full: bool) -> dict:
    """The card's gates over the run's iteration lines: iteration 1's mean
    return near the JAX run's, the mean over the 215-move iterations from
    ``learned_from`` on, and in the full run (the JAX run's processes)
    every iteration's record length equal to the JAX run's. Returns what
    failed."""
    want, spread = ATARI_GATES["first_return"]
    bad = {}
    first = [ln["return_avg"] for ln in iterations if ln["iteration"] == 1]
    if first and abs(first[0] - want) > spread:
        bad["first_return"] = first[0]
    learned = [ln["return_avg"] for ln in iterations
               if ln["iteration"] >= ATARI_GATES["learned_from"] and ln["length_max"] == 215]
    if learned and np.mean(learned) < ATARI_GATES["learned_min"]:
        bad["learned_return"] = float(np.mean(learned))
    if full:
        other = [ln["iteration"] for ln in iterations
                 if ln["length_max"] != JAX_ATARI[ln["iteration"]][0]]
        if other or len(iterations) != len(JAX_ATARI):
            bad["lengths_unlike_jax"] = other
    return bad


def run_dir_bytes(run_dir: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, files in os.walk(run_dir)
               for f in files)


def main(recipe: str = "gaz", run_dir: str = "", first: int = 1, last: int = 0,
         split: str = "", out_dir: str = "", platform: str = "gpu") -> None:
    cpu = platform == "cpu"
    splits = tuple(int(s) for s in str(split).split(",") if s.strip()) or SPLIT[recipe]
    last = int(last) or LAST[recipe]
    if cpu and (int(first), last, splits) == (1, LAST[recipe], SPLIT[recipe]):
        last, splits = CPU_RUN.get(recipe, (2, (1,)))
    first, last = int(first), int(last)
    atari = recipe == "atari"
    name = "atari_gmz_recipe" if atari else f"go9_{recipe}_recipe"
    run_dir = os.path.abspath(run_dir or os.path.join(ROOT, "_runs", name))
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
    ends = sorted({e for e in (*splits, last) if first <= e <= last})
    if atari:
        # the OBS tags hold every frame of every record, gzip+hex (FakeALE's
        # frames do not compress), and a checkpoint an iteration
        frames = CPU_FAKE_LENGTH if cpu else FAKE_LENGTH
        starts = [first] + [e + 1 for e in ends[:-1]]
        moves = sum(sum(atari_lengths(cfg, frames, e - s + 1)) for s, e in zip(starts, ends))
        need = (moves * cfg.zero_num_games_per_iteration * 96 * 96 * 3 * 2 * 1.05
                + (last + 1) * 128 * 2**20 + 2**30)
        free = shutil.disk_usage(run_dir).free
        if free < need:
            fail(f"{free / 2**30:.1f} GiB free under {run_dir}, the run writes about "
                 f"{need / 2**30:.1f} GiB")
    unroll_at = ",".join(str(i) for i in sorted(set(UNROLL_CHECKED) | set(ends))
                         if recipe == "gmz")
    train_log = os.path.join(run_dir, "Training.log")
    log_from = os.path.getsize(train_log) if os.path.exists(train_log) else 0
    t0 = time.perf_counter()
    lines = []
    for index, end in enumerate(ends, 1):
        log_path = os.path.join(out_dir, f"process{index}.log")
        schedule = (last if end == last else min(ATARI_SCHEDULE_END, last)) if atari else end
        cmd = [sys.executable, os.path.abspath(__file__), "--process", run_dir, conf_file,
               str(end), platform, str(index), unroll_at, recipe, str(schedule)]
        with open(log_path, "w") as log:
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True, cwd=ROOT)
            for line in proc.stdout:
                log.write(line)
                if line.startswith("{"):
                    print(line, end="", flush=True)
                    lines.append(json.loads(line))
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

    summary = {"summary": "zero recipe", "recipe": recipe, "iterations": [first, last],
               "processes": len(ends), "train_s": train_s, "step": last_step,
               "records_per_iteration": games, "resume_lines": resumes,
               "analysis_skipped": analysis_skipped}
    if atari:
        iterations = [ln for ln in lines if "iteration" in ln]
        full = (first, last, tuple(ends[:-1])) == (1, LAST[recipe], SPLIT[recipe])
        bad = atari_gates(iterations, full) if not cpu else {}
        learned = [ln["return_avg"] for ln in iterations
                   if ln["iteration"] >= ATARI_GATES["learned_from"] and ln["length_max"] == 215]
        summary.update(
            process_s=[ln["seconds"] for ln in lines if "end_iteration" in ln],
            resume_s=[ln["resume_s"] for ln in lines if "resume_s" in ln],
            resume_games=[ln["resume_games"] for ln in lines if "resume_s" in ln],
            wraps=[ln["iteration"] for ln in iterations if ln["wrapped"]],
            learned_return=float(np.mean(learned)) if learned else None,
            run_dir_bytes=run_dir_bytes(run_dir), gates_failed=bad)
    else:
        results = matches(recipe, cfg, run_dir, last_step, cpu)
        wld = {r["match"]: [r["wins"], r["losses"], r["draws"]] for r in results}
        summary["matches"] = wld
    summary.update(seconds=time.perf_counter() - t0, device=card() if not cpu else "cpu")
    print(json.dumps(summary), flush=True)
    if cpu:
        return
    if atari:
        if bad:
            fail(f"the gates {bad}: {ATARI_GATES}")
        return
    # the gates of the matches this run played (a run shorter than a rung
    # plays no ladder)
    weak = {k: wld[k] for k, need in MIN_WINS[recipe].items() if k in wld and wld[k][0] < need}
    weak.update({k: wld[k] for k in MORE_WINS[recipe] if k in wld and wld[k][0] <= wld[k][1]})
    if weak:
        fail(f"matches {weak}: fewer wins of {MATCH_GAMES} than {MIN_WINS[recipe]}, or "
             f"no more wins than losses in {MORE_WINS[recipe]}")


if __name__ == "__main__":
    if sys.argv[1:2] == ["--process"]:
        d, conf, end, plat, idx, unroll, name, schedule = sys.argv[2:10]
        run_process(d, conf, int(end), plat, int(idx),
                    unroll_at={int(i) for i in unroll.split(",") if i}, recipe=name,
                    schedule_end=int(schedule))
    else:
        args = [a for a in sys.argv[1:] if a != "cpu"]
        name = args.pop(0) if args[:1] and args[0] in RECIPES else "gaz"
        main(name, *args, platform="cpu" if "cpu" in sys.argv[1:] else "gpu")

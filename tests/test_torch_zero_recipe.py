"""The reference training recipes on the port (``scripts/zero_recipe_torch.py``:
``gaz``, the JAX run ``runs/go9_gaz_full``; ``gmz``, ``runs/go9_gmz_r4``;
``az``, ``runs/go9_az200_r3b``), held against the JAX package on the CPU,
each case for every recipe.

* The script's config is the JAX run's (``runs/go9_gaz_full.cfg``; the
  ``config`` entry of ``runs/go9_gmz_r4/model/weight_iter_12500.ckpt`` and
  of ``runs/go9_az200_r3b/model/weight_iter_3125.ckpt``) as both packages
  parse it, but for the iterations it runs.
* The JAX run's step-0 and newest exported nets (step 12,500; ``az``
  3,125), exported to ``minizero_tpu_torch/assets/``, play the first plies
  of ``play_match`` on the port as the JAX engine plays them (``gmz`` after
  the ladder's 4 uniform opening plies; ``az`` at 47 simulations, where
  both engines search on the packed trees): float32, rotation off, root
  visits and actions exact, the root children's Q within 2e-4 and the root
  value within 1e-4 (``docs/Parity.md``), completed-Q targets within 2e-3.
* A run of the CLI's ``-mode zero`` to iteration 2 and a second call to
  iteration 4 (TicTacToe, a window of 2 iterations; AlphaZero, Gumbel
  MuZero with K=5, and AlphaZero with the az recipe's Dirichlet noise,
  softmax-count actions and resignation): after each iteration the window holds the games of the
  last two iterations' record files, as a JAX ``ReplayBuffer`` fed the
  same records holds them; the second call reloads iterations 1-2 with the
  feature planes self-play stored (the policy targets as the record parser
  renormalizes them), and the network, optimizer state and step the first
  call ended with.
* The script's CPU form prints its lines (``az`` on the packed trees: B2's
  and B3's plain versions).
* The script's ``unroll_check`` on a window with evicted games and games
  shorter than K: the flat caches' ``sample_muzero`` equals the per-record
  branch's and the JAX buffer's, and a stale cache fails the check.
"""

import copy
import importlib.util
import json
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import minizero_tpu_torch.eval.match as tmatch
from minizero_tpu.config import default_config as j_default
from minizero_tpu.envs import make_env as j_make_env
from minizero_tpu.eval.match import load_checkpoint_variables as j_load_checkpoint
from minizero_tpu.learner.replay import ReplayBuffer as JReplayBuffer
from minizero_tpu.models.factory import create_network as j_create_network
from minizero_tpu.search import mcts as jmcts
from minizero_tpu.selfplay.engine import SelfPlayEngine as JEngine
from minizero_tpu.selfplay.record import game_record_from_string as j_record
from minizero_tpu_torch.__main__ import main
from minizero_tpu_torch.config import algorithm_preset, default_config
from minizero_tpu_torch.envs import make_env
from minizero_tpu_torch.models.factory import create_network
from minizero_tpu_torch.search import mcts
from minizero_tpu_torch.selfplay.engine import SelfPlayEngine
from minizero_tpu_torch.selfplay.record import game_record_from_string
from minizero_tpu_torch.weights import (from_jax_muzero_variables, from_jax_variables,
                                        load_variables_npz)
from minizero_tpu_torch.zero import loop as tloop

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_zero_loop import _assert_same_tensors, _state  # noqa: E402
from torch_env_parity import jax_batch  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "scripts", "zero_recipe_torch.py")
RUNS = {"gaz": os.path.join(ROOT, "runs", "go9_gaz_full"),
        "gmz": os.path.join(ROOT, "runs", "go9_gmz_r4"),
        "az": os.path.join(ROOT, "runs", "go9_az200_r3b")}
RECIPES = sorted(RUNS)
# play_match's case: (games, plies a round, simulations); az at 47, the
# fewest that take the packed trees, over 2 games of 2 plies
PLAY = {"gaz": (4, 6, None), "gmz": (4, 6, None), "az": (2, 2, 47)}


def _script():
    spec = importlib.util.spec_from_file_location("zero_recipe_torch", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_run_config(recipe):
    """The JAX run's config text: gaz's ``.cfg``; the others' entry in the
    checkpoint of the newest exported step."""
    if recipe == "gaz":
        return open(RUNS[recipe] + ".cfg").read()
    step = _script().JAX_STEP[recipe]
    with open(os.path.join(RUNS[recipe], "model", f"weight_iter_{step}.ckpt"), "rb") as f:
        return pickle.load(f)["config"]


@pytest.mark.parametrize("recipe", RECIPES)
def test_recipe_config_is_the_jax_runs(recipe):
    text = _jax_run_config(recipe)
    ours = _script().recipe_config(recipe=recipe)
    port, jax_ = (default_config("go").load_string(text, sep="\n"),
                  j_default("go").load_string(text, sep="\n"))
    runs_own = {"zero_start_iteration", "zero_end_iteration"}
    fields = set(vars(port)) | set(vars(jax_)) | set(vars(ours))
    assert fields == set(vars(ours)) == set(vars(jax_))
    for key in sorted(fields - runs_own):
        assert getattr(ours, key) == getattr(port, key) == getattr(jax_, key), key
    # the JAX runs were resumed at iterations 10, 8 and 25; the script
    # starts at 0 and passes its end on the command line
    assert (ours.zero_start_iteration, ours.zero_end_iteration) == (0, {"gaz": 100, "gmz": 50,
                                                                      "az": 50}[recipe])
    assert jax_.zero_start_iteration == {"gaz": 10, "gmz": 8, "az": 25}[recipe]
    assert ours.nn_type_name == {"gaz": "alphazero", "gmz": "muzero", "az": "alphazero"}[recipe]
    assert ours.use_gumbel == (recipe != "az")


def _root_children(visits, mean, cidx):
    has = cidx >= 0
    idx = np.where(has, cidx, 0)
    return (np.where(has, np.take_along_axis(visits, idx, 1), 0.0),
            np.where(has, np.take_along_axis(mean, idx, 1), 0.0))


@pytest.mark.parametrize("recipe", RECIPES)
def test_exported_nets_play_the_jax_plies_through_play_match(recipe, monkeypatch):
    """The port's ``play_match`` (4 games, 6 plies a round, the JAX run's
    step-12,500 net as A against its step-0 net; gmz after the ladder's 4
    uniform opening plies; az 2 games, 2 plies a round, step 3,125 against
    step 0 at 47 simulations on the packed trees) and the JAX engine
    driven as its synchronized match drives it: the same searches, ply by
    ply, in both colour rounds, from the openings the port drew."""
    script = _script()
    games, plies, sims = PLAY[recipe]
    top = script.JAX_STEP[recipe]
    cfg = script.recipe_config(recipe=recipe).replace(actor_use_random_rotation_features=False,
                                                      zero_num_parallel_games=games)
    if sims:
        cfg = cfg.replace(actor_num_simulation=sims)
    packed = recipe == "az"
    opening = script.OPENING_PLIES[recipe]
    jcfg = j_default("go").load_string(cfg.to_string(), sep="\n")
    assert jcfg.to_string() == cfg.to_string()
    spec = make_env(cfg).spec
    convert = from_jax_muzero_variables if recipe == "gmz" else from_jax_variables
    nets = {}
    for step in (top, 0):
        nets[step] = create_network(cfg, spec)
        nets[step].load_state_dict(convert(load_variables_npz(script.jax_net_path(recipe, step)),
                                           hidden_hw=81))
    searches, decisions, openings = [], [], []

    class Recording(SelfPlayEngine):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **{**kwargs, "use_bf16": False})
            assert not self.spec.use_gumbel_noise and not self.use_rotation
            assert self.is_muzero == (recipe == "gmz")
            assert self.use_tree_kernel_v2 == packed

        def _search(self, states, turns, feats, generator):
            trees = super()._search(states, turns, feats, generator)
            searches.append((self.network, states, trees))
            return trees

        def _decide(self, trees, temperature, generator):
            decisions.append(super()._decide(trees, temperature, generator))
            return decisions[-1]

    random_openings = tmatch._random_openings

    def recorded_openings(env, states, plies, generator):
        step, taken = env.step, []

        def recorded_step(s, a):
            taken.append(a.numpy().copy())
            return step(s, a)

        env.step = recorded_step
        try:
            return random_openings(env, states, plies, generator)
        finally:
            del env.step
            openings.append(taken)

    monkeypatch.setattr(tmatch, "SelfPlayEngine", Recording)
    monkeypatch.setattr(tmatch, "PLIES_PER_CHECK", plies)
    monkeypatch.setattr(tmatch, "_random_openings", recorded_openings)
    r = tmatch.play_match(cfg, nets[top], nets[0], num_games=games, seed=1001, max_moves=plies,
                          opening_random_plies=opening, device="cpu")
    assert (r.p1_wins, r.p2_wins, r.draws) == (0, 0, games)  # no game ends so soon
    assert len(searches) == len(decisions) == 2 * plies
    assert len(openings) == (2 if opening else 0)
    if opening:
        # both colour rounds start from the same openings, distinct games
        assert all(len(o) == opening for o in openings)
        np.testing.assert_array_equal(np.stack(openings[0]), np.stack(openings[1]))
        assert len({tuple(col) for col in np.stack(openings[0]).T}) > 1

    jenv = j_make_env(jcfg)
    jnet = j_create_network(jcfg, jenv.spec)
    jvars = {step: j_load_checkpoint(os.path.join(RUNS[recipe], "model",
                                                  f"weight_iter_{step}.ckpt"),
                                     jcfg, jnet, jenv.spec) for step in (top, 0)}
    jeng = JEngine(jenv, jcfg, jnet, eval_mode=True, use_bf16=False)
    assert not jeng.spec.use_gumbel_noise and jeng.is_muzero == (recipe == "gmz")
    assert jeng.use_tree_kernel_v2 == packed
    jstep = jax.vmap(jenv.step)
    ply_searches = iter(zip(searches, decisions))
    # A plays Player 1 in the first round, Player 2 in the second; after
    # an even number of opening plies Player 1 moves first
    for round_, movers in enumerate(((top, 0), (0, top))):
        js = jax_batch(jenv, games)
        for actions in (openings[round_] if opening else ()):
            js = jstep(js, jnp.asarray(actions))
        for ply in range(plies):
            step = movers[ply % 2]
            (net, states, trees), (action, target, root, _) = next(ply_searches)
            where = f"round {movers}, ply {ply}"
            assert net is nets[step], where
            np.testing.assert_array_equal(states.board.numpy(), np.asarray(js.board), where)
            jtrees = jeng.search_trees(jvars[step], js, jax.random.PRNGKey(ply))
            jaction, jtarget, jroot, _ = jeng._decide(jtrees, jax.random.PRNGKey(7), 1.0)
            jvisits, jmean = _root_children(np.asarray(jtrees.visits), np.asarray(jtrees.mean),
                                            np.asarray(jtrees.children_index)[:, 0])
            visits, mean = _root_children(trees.visits.numpy(), trees.mean.numpy(),
                                          trees.children_index[:, 0].numpy())
            np.testing.assert_array_equal(visits, jvisits, err_msg=f"root visits, {where}")
            np.testing.assert_array_equal(
                mcts.root_children_visits(trees).numpy(),
                np.asarray(jax.vmap(jmcts.root_children_visits)(jtrees)), err_msg=where)
            np.testing.assert_array_equal(action.numpy(), np.asarray(jaction), f"action, {where}")
            np.testing.assert_allclose(mean, jmean, rtol=0, atol=2e-4, err_msg=f"root Q, {where}")
            np.testing.assert_allclose(root.numpy(), np.asarray(jroot), rtol=0, atol=1e-4,
                                       err_msg=f"root value, {where}")
            np.testing.assert_allclose(target.numpy(), np.asarray(jtarget), rtol=0, atol=2e-3,
                                       err_msg=f"policy target, {where}")
            js = jstep(js, jaction)


# the az recipe's self-play settings that the AlphaZero defaults lack
AZ_ACTOR = ("actor_use_dirichlet_noise", "actor_dirichlet_noise_alpha",
            "actor_dirichlet_noise_epsilon", "actor_select_action_by_softmax_count",
            "actor_resign_threshold", "zero_disable_resign_ratio")


def _tiny(recipe="gaz"):
    # gaz: the AlphaZero loop; gmz: Gumbel MuZero with K=5 unroll steps; az:
    # the az recipe's root noise, softmax-count actions and resignation
    algo = {"gaz": {},
            "gmz": dict(algorithm_preset("gmz"), actor_gumbel_sample_size=8,
                        learner_muzero_unrolling_step=5),
            "az": {k: _script().RECIPE_AZ[k] for k in AZ_ACTOR}}[recipe]
    return {**algo, **dict(
        env_name="tictactoe", nn_num_blocks=1, nn_num_hidden_channels=8,
        nn_num_value_hidden_channels=8, actor_num_simulation=8, learner_batch_size=16,
        learner_training_step=4, learner_training_display_step=2, zero_num_games_per_iteration=8,
        zero_num_parallel_games=8, zero_replay_buffer=2)}


@pytest.mark.parametrize("recipe", RECIPES)
def test_window_and_state_survive_a_resume_across_cli_calls(recipe, tmp_path, monkeypatch):
    """``-mode zero`` to iteration 2, then a second call to iteration 4, with
    a window of 2 iterations: after every iteration the window is the last
    two record files' games (as a JAX ``ReplayBuffer`` fed those records in
    order holds them); the second call rebuilds iterations 1-2 exactly and
    continues from the first call's network, optimizer state (the
    momentum) and step."""
    conf = ":".join(f"{k}={v}" for k, v in _tiny(recipe).items())
    run_dir = str(tmp_path / "run")
    jcfg = j_default("tictactoe", **{k: v for k, v in _tiny(recipe).items() if k != "env_name"})
    jbuffer = JReplayBuffer(jcfg, j_make_env(jcfg).spec)
    a_size = make_env(default_config("tictactoe")).spec.action_size
    loops, after_resume = [], []

    class Watched(tloop.ZeroLoop):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            loops.append(self)

        def resume(self):
            start = super().resume()
            after_resume.append((start, copy.deepcopy(_state(self)), self.state.step,
                                 [(g.actions.copy(), g.features.copy(), g.policy.copy(), g.result)
                                  for g in self.buffer.games]))
            return start

        def optimize_iteration(self, iteration):
            out = super().optimize_iteration(iteration)
            lines = open(os.path.join(run_dir, "sgf", f"{iteration}.sgf")).read().splitlines()
            assert len(lines) == 8
            for line in lines:
                jbuffer.add_game(j_record(line, a_size)[1])
            want = [game_record_from_string(ln, a_size)[1].actions
                    for it in range(max(1, iteration - 1), iteration + 1)
                    for ln in open(os.path.join(run_dir, "sgf", f"{it}.sgf")).read().splitlines()]
            got = [g.actions for g in self.buffer.games]
            assert len(got) == len(want) == len(jbuffer) == min(16, 8 * iteration), iteration
            assert self.buffer.num_data == jbuffer.num_data
            for g, w, j in zip(got, want, jbuffer.games):
                np.testing.assert_array_equal(g, w)
                np.testing.assert_array_equal(g, j.actions)
            return out

    monkeypatch.setattr(tloop, "ZeroLoop", Watched)
    for end in (2, 4):
        assert main(["-mode", "zero", "-run_dir", run_dir, "-conf_str",
                     f"{conf}:zero_end_iteration={end}"], device="cpu") == 0
    first, second = loops
    assert first.state.step == 8 and second.state.step == 16
    assert first.is_muzero == second.is_muzero == (recipe == "gmz")
    assert "momentum_buffer" in str(first.state.optimizer.state_dict())
    (_, _, _, nothing), (start, state, step, window) = after_resume
    assert nothing == [] and start == 2 and step == 8
    _assert_same_tensors(state, _state(first), "resumed state")
    # the second call rebuilt the first call's window at its end: iterations
    # 1-2, the features replayed from the records equal to self-play's
    first_window = first.buffer.games
    assert len(window) == len(first_window) == 16
    for (actions, features, policy, result), g in zip(window, first_window):
        np.testing.assert_array_equal(actions, g.actions)
        assert features.dtype == g.features.dtype and features.tobytes() == g.features.tobytes()
        # a record holds the f16 rows; the parser divides each by its sum
        np.testing.assert_array_equal(policy, _script().as_reloaded(g.policy))
        assert result == g.result
    log = open(os.path.join(run_dir, "Training.log")).read()
    assert log.count("[Resume] iteration 2, 16 games reloaded") == 1


@pytest.mark.parametrize("recipe", RECIPES)
def test_the_script_prints_its_lines_on_the_cpu(recipe, tmp_path):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, SCRIPT, recipe, str(tmp_path / "run"), "cpu"],
                         capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [json.loads(ln) for ln in out.stdout.splitlines()]
    iterations = [ln for ln in lines if "iteration" in ln]
    assert [ln["iteration"] for ln in iterations] == [1, 2]
    for ln in iterations:
        assert ln["games"] == 4 and ln["buffer_games"] == 4 * ln["iteration"]
        assert np.isfinite(list(ln["losses"].values())).all()
        assert ln["length_min"] <= ln["length_avg"] <= ln["length_max"]
        if recipe == "gmz":
            # board-game MuZero trains no reward; the unroll checked each
            # iteration (K=5 past a few games' ends)
            assert ln["losses"]["loss_reward"] == 0
            unroll = ln["unroll"]
            assert unroll["positions"] == 8 and unroll["window_games"] == ln["buffer_games"]
            assert unroll["games_unchanged"] == ln["buffer_games"]
        else:
            assert "loss_reward" not in ln["losses"] and "unroll" not in ln
    (resumed,) = [ln for ln in lines if ln.get("resumed_iteration") == 1]
    assert resumed["resume_games"] == 4 and resumed["games_equal"] and resumed["state_equal"]
    assert ("unroll" in resumed) == (recipe == "gmz")
    ladder = ["r1", "r2"] if recipe != "gaz" else []
    port_pair = ["b"] if recipe != "az" else []
    assert [ln["match"] for ln in lines if "match" in ln] == ladder + ["a"] + port_pair
    summary = lines[-1]
    assert summary["step"] == 8 and summary["device"] == "cpu" and summary["recipe"] == recipe
    assert summary["resume_lines"] == ["[Resume] iteration 1, 4 games reloaded"]
    assert all(sum(wld) == 2 for wld in summary["matches"].values())


def _game(rng, length, a_size=9, channels=4):
    from minizero_tpu_torch.learner.replay import GameRecord

    policy = rng.random((length, a_size)).astype(np.float32)
    return GameRecord(actions=rng.integers(0, a_size, length).astype(np.int32),
                      policy=(policy / policy.sum(1, keepdims=True)).astype(np.float16),
                      values=rng.uniform(-1, 1, length).astype(np.float32),
                      rewards=np.zeros(length, np.float32),
                      features=rng.integers(0, 256, (length, 3, 3, channels)).astype(np.uint8),
                      result=float(rng.choice([-1.0, 0.0, 1.0])))


def test_unroll_check_holds_the_flat_branch_to_the_per_record_branch():
    """``unroll_check`` on a MuZero window (TicTacToe, K=5, a window of 2
    iterations of 6 games) that has evicted games and games shorter than
    K: the flat caches, rebuilt after each iteration, give the per-record
    branch's targets and the JAX buffer's batch draw for draw; a cache
    left stale fails the check."""
    from minizero_tpu.learner.replay import GameRecord as JGameRecord
    from minizero_tpu_torch.learner.replay import ReplayBuffer

    script = _script()
    over = dict(algorithm_preset("gmz"), learner_muzero_unrolling_step=5,
                zero_num_games_per_iteration=6, zero_replay_buffer=2)
    cfg = default_config("tictactoe", **over)
    jcfg = j_default("tictactoe", **over)
    buffer = ReplayBuffer(cfg, make_env(cfg).spec)
    jbuffer = JReplayBuffer(jcfg, j_make_env(jcfg).spec)
    rng = np.random.default_rng(19)
    counts = []
    for iteration in range(4):
        for length in rng.integers(1, 10, 6):
            rec = _game(rng, int(length))
            jbuffer.add_game(JGameRecord(**{k: getattr(rec, k) for k in (
                "actions", "policy", "values", "rewards", "features", "result")}))
            rec.added_digest = script.record_digest(rec)
            buffer.add_game(rec)
        counts.append(script.unroll_check(buffer, 64, seed=iteration))
        want = jbuffer.sample_muzero(64, np.random.RandomState(iteration))
        got = buffer.sample_muzero(64, np.random.RandomState(iteration))
        assert sorted(got) == sorted(want)
        for key in got:
            np.testing.assert_array_equal(got[key], want[key], key)
    assert len(buffer) == 12  # 24 games added: the first 12 evicted
    assert all(c["window_games"] == c["games_unchanged"] == min(6 * (i + 1), 12)
               for i, c in enumerate(counts))
    # games shorter than K were drawn, and draws unrolled past their ends
    assert all(c["short_games"] > 0 and c["past_end"] > 0 for c in counts)
    # a flat cache that no longer matches the records fails the check
    buffer._flat_actions[:] = (buffer._flat_actions + 1) % 9
    with pytest.raises(AssertionError, match="actions inside the games"):
        script.unroll_check(buffer, 64)


def test_a_reload_renormalizes_policy_rows_as_the_jax_parser_does():
    """Self-play keeps each policy row in f16 as the search gave it; a record
    reloads it divided by its f32 sum, so a few rows of a peaked gaz policy
    move by one f16 step. Both packages' writers and parsers agree on every
    row, and ``as_reloaded`` predicts them."""
    from minizero_tpu.learner.replay import GameRecord as JGameRecord
    from minizero_tpu.selfplay.record import serialize_game as j_serialize
    from minizero_tpu_torch.learner.replay import GameRecord
    from minizero_tpu_torch.selfplay.record import serialize_game

    rng = np.random.default_rng(18)
    length, actions = 400, 82
    logits = rng.normal(size=(length, actions)) * rng.uniform(0.5, 8, size=(length, 1))
    p = np.exp(logits - logits.max(1, keepdims=True))
    policy = (p / p.sum(1, keepdims=True)).astype(np.float16)
    fields = dict(actions=rng.integers(0, 81, length).astype(np.int32), policy=policy,
                  values=np.zeros(length, np.float32), rewards=np.zeros(length, np.float32),
                  features=np.zeros((length, 9, 9, 3), np.uint8), result=1.0)
    players = tuple([1, 2] * (length // 2))
    line = serialize_game("go", GameRecord(**fields), 9, players, model_file="weight_iter_0")
    assert line == j_serialize("go", JGameRecord(**fields), 9, players,
                               model_file="weight_iter_0")
    got = game_record_from_string(line, actions)[1].policy
    np.testing.assert_array_equal(got, j_record(line, actions)[1].policy)
    np.testing.assert_array_equal(got, _script().as_reloaded(policy))
    moved = (got != policy).any(1)
    assert 0 < moved.sum() < length // 10
    step = np.abs(got.astype(np.float32) - policy.astype(np.float32)).max(1)[moved]
    ulp = np.spacing(np.maximum(got, policy).astype(np.float16)).astype(np.float32).max(1)[moved]
    assert (step <= ulp).all()

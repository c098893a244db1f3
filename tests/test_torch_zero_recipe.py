"""The reference training recipe on the port (``scripts/zero_recipe_torch.py``),
held against the JAX package on the CPU.

* The script's config is ``runs/go9_gaz_full.cfg`` as both packages parse
  it, but for the iterations it runs.
* The JAX run's iteration-0 and iteration-25 nets, exported to
  ``minizero_tpu_torch/assets/``, play the first plies of ``play_match``
  on the port as the JAX engine plays them: float32, rotation off, root
  visits and actions exact, the root children's Q within 2e-4 and the root
  value within 1e-4 (``docs/Parity.md``), completed-Q targets within 2e-3.
* A run of the CLI's ``-mode zero`` to iteration 2 and a second call to
  iteration 4 (TicTacToe, a window of 2 iterations): after each iteration
  the window holds the games of the last two iterations' record files, as a
  JAX ``ReplayBuffer`` fed the same records holds them; the second call
  reloads iterations 1-2 with the feature planes self-play stored (the
  policy targets as the record parser renormalizes them), and the network,
  optimizer state and step the first call ended with.
* The script's CPU form prints its lines.
"""

import copy
import importlib.util
import json
import os
import subprocess
import sys

import jax
import numpy as np

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
from minizero_tpu_torch.config import default_config
from minizero_tpu_torch.envs import make_env
from minizero_tpu_torch.models.factory import create_network
from minizero_tpu_torch.search import mcts
from minizero_tpu_torch.selfplay.engine import SelfPlayEngine
from minizero_tpu_torch.selfplay.record import game_record_from_string
from minizero_tpu_torch.weights import from_jax_variables, load_variables_npz
from minizero_tpu_torch.zero import loop as tloop

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_zero_loop import _assert_same_tensors, _state  # noqa: E402
from torch_env_parity import jax_batch  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "scripts", "zero_recipe_torch.py")
RUN = os.path.join(ROOT, "runs", "go9_gaz_full")


def _script():
    spec = importlib.util.spec_from_file_location("zero_recipe_torch", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_recipe_config_is_the_jax_runs():
    text = open(RUN + ".cfg").read()
    ours = _script().recipe_config()
    port, jax_ = (default_config("go").load_string(text, sep="\n"),
                  j_default("go").load_string(text, sep="\n"))
    runs_own = {"zero_start_iteration", "zero_end_iteration"}
    fields = set(vars(port)) | set(vars(jax_)) | set(vars(ours))
    assert fields == set(vars(ours)) == set(vars(jax_))
    for key in sorted(fields - runs_own):
        assert getattr(ours, key) == getattr(port, key) == getattr(jax_, key), key
    assert (ours.zero_start_iteration, ours.zero_end_iteration) == (0, 100)
    assert jax_.zero_start_iteration == 10


def _root_children(visits, mean, cidx):
    has = cidx >= 0
    idx = np.where(has, cidx, 0)
    return (np.where(has, np.take_along_axis(visits, idx, 1), 0.0),
            np.where(has, np.take_along_axis(mean, idx, 1), 0.0))


def test_exported_nets_play_the_jax_plies_through_play_match(monkeypatch):
    """The port's ``play_match`` (4 games, 6 plies a round, the JAX run's
    iteration-25 net as A against its iteration-0 net) and the JAX engine
    driven as its synchronized match drives it: the same searches, ply by
    ply, in both colour rounds."""
    cfg = _script().recipe_config().replace(actor_use_random_rotation_features=False,
                                            zero_num_parallel_games=4)
    jcfg = j_default("go").load_string(cfg.to_string(), sep="\n")
    assert jcfg.to_string() == cfg.to_string()
    spec = make_env(cfg).spec
    nets = {}
    for step in (12500, 0):
        nets[step] = create_network(cfg, spec)
        nets[step].load_state_dict(from_jax_variables(load_variables_npz(os.path.join(
            ROOT, "minizero_tpu_torch", "assets", f"go9_gaz_full_iter{step}.npz")), hidden_hw=81))
    searches, decisions = [], []

    class Recording(SelfPlayEngine):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **{**kwargs, "use_bf16": False})
            assert not self.spec.use_gumbel_noise and not self.use_rotation

        def _search(self, states, turns, feats, generator):
            trees = super()._search(states, turns, feats, generator)
            searches.append((self.network, states, trees))
            return trees

        def _decide(self, trees, temperature, generator):
            decisions.append(super()._decide(trees, temperature, generator))
            return decisions[-1]

    monkeypatch.setattr(tmatch, "SelfPlayEngine", Recording)
    monkeypatch.setattr(tmatch, "PLIES_PER_CHECK", 6)
    r = tmatch.play_match(cfg, nets[12500], nets[0], num_games=4, seed=1001, max_moves=6,
                          device="cpu")
    assert (r.p1_wins, r.p2_wins, r.draws) == (0, 0, 4)  # no game ends in 6 plies
    assert len(searches) == len(decisions) == 12

    jenv = j_make_env(jcfg)
    jnet = j_create_network(jcfg, jenv.spec)
    jvars = {step: j_load_checkpoint(os.path.join(RUN, "model", f"weight_iter_{step}.ckpt"),
                                     jcfg, jnet, jenv.spec) for step in (12500, 0)}
    jeng = JEngine(jenv, jcfg, jnet, eval_mode=True, use_bf16=False)
    assert not jeng.spec.use_gumbel_noise
    jstep = jax.vmap(jenv.step)
    ply_searches = iter(zip(searches, decisions))
    # A plays Player 1 in the first round, Player 2 in the second
    for movers in ((12500, 0), (0, 12500)):
        js = jax_batch(jenv, 4)
        for ply in range(6):
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


def _tiny(**over):
    return dict(env_name="tictactoe", nn_num_blocks=1, nn_num_hidden_channels=8,
                nn_num_value_hidden_channels=8, actor_num_simulation=8, learner_batch_size=16,
                learner_training_step=4, learner_training_display_step=2,
                zero_num_games_per_iteration=8, zero_num_parallel_games=8, zero_replay_buffer=2,
                **over)


def test_window_and_state_survive_a_resume_across_cli_calls(tmp_path, monkeypatch):
    """``-mode zero`` to iteration 2, then a second call to iteration 4, with
    a window of 2 iterations: after every iteration the window is the last
    two record files' games (as a JAX ``ReplayBuffer`` fed those records in
    order holds them); the second call rebuilds iterations 1-2 exactly and
    continues from the first call's network, optimizer state and step."""
    conf = ":".join(f"{k}={v}" for k, v in _tiny().items())
    run_dir = str(tmp_path / "run")
    jcfg = j_default("tictactoe", **{k: v for k, v in _tiny().items() if k != "env_name"})
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


def test_the_script_prints_its_lines_on_the_cpu(tmp_path):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, SCRIPT, str(tmp_path / "run"), "cpu"],
                         capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [json.loads(ln) for ln in out.stdout.splitlines()]
    iterations = [ln for ln in lines if "iteration" in ln]
    assert [ln["iteration"] for ln in iterations] == [1, 2]
    for ln in iterations:
        assert ln["games"] == 4 and ln["buffer_games"] == 4 * ln["iteration"]
        assert np.isfinite(list(ln["losses"].values())).all()
        assert ln["length_min"] <= ln["length_avg"] <= ln["length_max"]
    (resumed,) = [ln for ln in lines if ln.get("resumed_iteration") == 1]
    assert resumed["resume_games"] == 4 and resumed["games_equal"] and resumed["state_equal"]
    assert [ln["match"] for ln in lines if "match" in ln] == ["a", "b"]
    summary = lines[-1]
    assert summary["step"] == 8 and summary["device"] == "cpu"
    assert summary["resume_lines"] == ["[Resume] iteration 1, 4 games reloaded"]
    assert all(sum(wld) == 2 for wld in summary["matches"].values())


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

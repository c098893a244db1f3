"""The port's tools (``minizero_tpu_torch/tools/``) held against their JAX
twins (``minizero_tpu/tools/``) on the same inputs, on the CPU, at tiny
sizes. Strings, parsed logs, replayed frames and board states are compared
exactly; the PNGs and the GIF by their existence and size, as
``tests/test_tools.py`` checks them.
"""

import os
import sys

import numpy as np
import pytest

import minizero_tpu
import minizero_tpu.tools.analysis as janalysis
import minizero_tpu.tools.dependency_graph as jdeps
import minizero_tpu.tools.obs as jobs
import minizero_tpu.tools.plot_board as jplot
import minizero_tpu.tools.to_sgf as jsgf
import minizero_tpu.tools.to_video as jvideo
import minizero_tpu_torch
from minizero_tpu.envs.atari import FakeALE as JFakeALE
from minizero_tpu_torch.__main__ import main, run_selfplay
from minizero_tpu_torch.config import algorithm_preset, default_config
from minizero_tpu_torch.envs import make_env
from minizero_tpu_torch.envs.atari import AtariEnv, FakeALE
from minizero_tpu_torch.tools import (
    analysis, dependency_graph, obs, plot_board, profile, to_sgf, to_video, trace_report)
from minizero_tpu_torch.zero.loop import ZeroLoop

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_threads import one_torch_thread  # noqa: E402,F401

TINY = dict(nn_num_blocks=1, nn_num_hidden_channels=8, nn_num_value_hidden_channels=8,
            actor_num_simulation=4, actor_gumbel_sample_size=4)


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """One TicTacToe iteration of the port's loop (8 games, 4 SGD steps)."""
    d = str(tmp_path_factory.mktemp("tools") / "run")
    cfg = default_config("tictactoe", **dict(
        TINY, zero_num_parallel_games=8, zero_num_games_per_iteration=8, zero_end_iteration=1,
        learner_training_step=4, learner_training_display_step=1, learner_batch_size=8))
    loop = ZeroLoop(cfg, d, device="cpu")
    loop.run()
    loop.close()
    return d


def test_log_parsers_match_jax_and_the_loop_plots(run_dir):
    for name, parse in (("op.log", "parse_op_log"), ("Training.log", "parse_training_log")):
        path = os.path.join(run_dir, name)
        got = dict(getattr(analysis, parse)(path))
        assert got == dict(getattr(janalysis, parse)(path)) and got, name
    assert analysis.parse_op_log(os.path.join(run_dir, "op.log"))["step"] == [1, 2, 3, 4]
    assert analysis.parse_training_log(os.path.join(run_dir, "Training.log"))["iteration"] == [1]
    # the loop redrew the plots at its last iteration
    pngs = os.listdir(os.path.join(run_dir, "analysis"))
    assert "run_loss.png" in pngs and "run_length_avg.png" in pngs
    assert all(os.path.getsize(os.path.join(run_dir, "analysis", p)) > 0 for p in pngs)
    assert sorted(analysis.analysis(run_dir)) == sorted(
        os.path.join(run_dir, "analysis", p) for p in pngs)


def test_parse_training_log_dedupes_resumed_iterations_as_jax(tmp_path):
    log = tmp_path / "Training.log"
    block = (
        "[t] [Iteration] {it}: self-play 8 games in {sp}s (0.1 games/s)\n"
        "[t] [SelfPlay Game Lengths] min: 1, max: 9, avg: {length}, std: 1.0\n"
        "[t] [SelfPlay Game Returns] min: -1, max: 1, avg: {ret}, std: 0.5\n"
        "[t] [Optimization] iteration {it}: 2 steps in {op}s\n"
    )
    log.write_text(
        block.format(it=1, sp=10.0, length=5.0, ret=0.1, op=2.0)
        + block.format(it=1, sp=12.0, length=6.0, ret=0.2, op=3.0)
        + block.format(it=1, sp=14.0, length=7.0, ret=0.3, op=4.0)
        + block.format(it=2, sp=20.0, length=8.0, ret=0.4, op=5.0))
    tl = analysis.parse_training_log(str(log))
    assert tl == janalysis.parse_training_log(str(log))
    assert tl["iteration"] == [1, 2] and tl["sp_time_s"] == [14.0, 20.0]
    assert tl["op_time_s"] == [4.0, 5.0]


def test_record_to_sgf_matches_jax(run_dir, tmp_path):
    lines = open(os.path.join(run_dir, "sgf", "1.sgf")).read().splitlines()
    go = str(tmp_path / "go.sgf")
    over = dict(algorithm_preset("gaz"), **TINY)
    run_selfplay(default_config("go", **dict(over, actor_num_simulation=2,
                                             actor_gumbel_sample_size=2,
                                             zero_num_parallel_games=2)), 2, go, device="cpu")
    lines += open(go).read().splitlines()
    lines.append("(;GM[go_9x9]RE[1]SZ[9];B[40]P[40:1]V[0.5]R[0];W[81]P[81:1]V[0.25]R[0])")
    for line in lines:
        assert to_sgf.record_to_sgf(line) == jsgf.record_to_sgf(line)
    assert ";B[ee]C[V: 0.5];W[]" in to_sgf.record_to_sgf(lines[-1])
    for a in (0, 40, 80, 81):
        assert to_sgf.action_to_sgf_coord(a, 9) == jsgf.action_to_sgf_coord(a, 9)
    out = str(tmp_path / "out.sgf")
    assert to_sgf.convert_file(go, out) == 2
    assert all(x.startswith("(;FF[4]GM[1]SZ[9]") for x in open(out).read().splitlines())


def test_remove_and_recover_obs_match_jax():
    frames = (np.arange(3 * 4 * 4 * 3) % 251).astype(np.uint8).reshape(3, 4, 4, 3)
    payload = obs.pack_observations(frames)
    assert payload == jobs.pack_observations(frames)
    rec = f"(;GM[atari_pong]SD[7];B[3]P[3:1]V[0]R[1];W[2]OBS[{payload}])"
    stripped = obs.remove_obs(rec)
    assert stripped == jobs.remove_obs(rec) and "OBS[" not in stripped
    back = obs.recover_obs(stripped, lambda r: frames)
    assert back == jobs.recover_obs(stripped, lambda r: frames) == rec
    assert obs.recover_obs(rec, lambda r: None) == rec  # a tagged record passes through
    assert obs.recover_obs(stripped, lambda r: None) == stripped


def _episode(seed, length):
    """A FakeALE episode played with seeded random actions: the actions and
    the newest frame before each of them."""
    env = AtariEnv(seed=seed, ale_factory=lambda s: FakeALE(seed=s, length=length))
    rng = np.random.RandomState(seed)
    actions, frames = [], []
    while not env.is_terminal():
        frames.append(env.newest_frame().copy())
        actions.append(int(rng.randint(4)))
        env.step(actions[-1])
    return actions, np.stack(frames)


def _chunk(seed, actions, off=None):
    tag = f"OFF[{off}]" if off is not None else ""
    return f"(;GM[atari_ms_pacman]SD[{seed}]{tag}" + "".join(f";B[{a}]" for a in actions) + ")"


@pytest.mark.parametrize("with_off", [True, False])
def test_atari_obs_replayer_matches_jax_on_chunked_records(with_off):
    """Two episodes' records in chunks that overlap (the reference's
    intermediate sequences), interleaved, with and without OFF tags. The
    frames equal JAX's and the episode's own. (Without OFF a chunk is
    aligned at the first offset where its actions continue the replay's, the
    reference's prefix matching: a chunk that merely follows the last one
    can match an earlier offset of a repetitive action stream, in both
    packages alike; the OFF tag exists for that.)"""
    length = 80
    eps = {seed: _episode(seed, length) for seed in (11, 12)}
    spans = [(0, 8), (6, 14), (12, 20)]  # moves of each chunk
    records, want = [], []
    for lo, hi in spans:
        for seed, (actions, frames) in eps.items():
            records.append(_chunk(seed, actions[lo:hi], lo if with_off and lo else None))
            want.append(frames[lo:hi])
    port = obs.AtariObsReplayer(ale_factory=lambda s: FakeALE(seed=s, length=length))
    ref = jobs.AtariObsReplayer(ale_factory=lambda s: JFakeALE(seed=s, length=length))
    for rec, w in zip(records, want):
        got = port(rec)
        np.testing.assert_array_equal(got, ref(rec))
        np.testing.assert_array_equal(got, w)
    # the episodes ended: their sessions are gone; a record that is not
    # Atari's has no replay
    assert port._sessions == {}
    assert port("(;GM[go_9x9]SZ[9];B[40])") is None


def test_recover_obs_file_and_the_cli_modes(tmp_path):
    actions, frames = _episode(5, 40)
    full = _chunk(5, actions)
    tagged = full[:-1] + f"OBS[{obs.pack_observations(frames)}])"
    src = tmp_path / "atari.sgf"
    src.write_text(tagged + "\n")
    assert main(["-mode", "remove_obs", "-input", str(src), "-platform", "cpu"]) == 0
    assert open(str(src) + ".noobs").read() == full + "\n"
    n = obs.recover_obs_file(str(src) + ".noobs", str(tmp_path / "back.sgf"),
                             obs.AtariObsReplayer(ale_factory=lambda s: FakeALE(seed=s, length=40)))
    assert n == 1 and open(tmp_path / "back.sgf").read() == tagged + "\n"
    try:
        import ale_py  # noqa: F401
    except ImportError:
        # without an injected ALE the replayer builds the real one
        with pytest.raises(ImportError, match="ale_py"):
            main(["-mode", "recover_obs", "-input", str(src) + ".noobs", "-platform", "cpu"])


def _legal_moves(name, count):
    """``count`` moves of a seeded playout: each the 3rd legal action."""
    env = make_env(default_config(name))
    import torch

    s = env.init(1, device="cpu")
    moves = []
    for _ in range(count):
        legal = np.nonzero(env.legal_mask(s)[0].numpy())[0]
        moves.append(int(legal[min(2, len(legal) - 1)]))
        s = env.step(s, torch.tensor(moves[-1:], dtype=torch.int32))
    return moves


@pytest.mark.parametrize("name", ["go", "hex", "havannah", "tictactoe"])
def test_board_from_record_matches_jax_and_plots(name, tmp_path):
    moves = _legal_moves(name, 5)
    size = "SZ[5]" if name == "go" else ""
    gm = "go_5x5" if name == "go" else name
    rec = f"(;GM[{gm}]{size}" + "".join(
        f";{'BW'[i % 2]}[{a}]" for i, a in enumerate(moves)) + ")"
    env, state = plot_board.board_from_record(rec)
    jenv, jstate = jplot.board_from_record(rec)
    np.testing.assert_array_equal(state.board[0].numpy(), np.asarray(jstate.board).reshape(-1))
    assert int(state.num_moves[0]) == int(jstate.num_moves) == len(moves)
    env2, state2 = plot_board.board_from_record(rec, move_limit=2)
    assert int(state2.num_moves[0]) == 2
    out = plot_board.plot_board(env, state, str(tmp_path / f"{name}.png"), title=name)
    assert os.path.getsize(out) > 5000


def test_replay_frames_matches_jax_and_writes_a_gif(tmp_path):
    actions, _ = _episode(9, 12)
    env = AtariEnv(seed=9, ale_factory=lambda s: FakeALE(seed=s, length=12))
    for a in actions:
        env.step(a)
    rec = _chunk(9, actions)[:-1].replace("SD[9]", f"SD[9]RE[{env.eval_score():g}]") + ")"
    frames, score, rec_score = to_video.replay_frames(
        rec, ale_factory=lambda s: FakeALE(seed=s, length=12))
    jframes, jscore, jrec_score = jvideo.replay_frames(
        rec, ale_factory=lambda s: JFakeALE(seed=s, length=12))
    assert len(frames) == len(jframes) == len(actions) + 1
    for f, g in zip(frames, jframes):
        np.testing.assert_array_equal(f, g)
    assert score == jscore == rec_score == jrec_score
    out = to_video.write_video(frames, str(tmp_path / "ep.mp4"), fps=30)
    assert os.path.getsize(out) > 0 and out.endswith((".mp4", ".gif"))
    with pytest.raises(ValueError, match="atari"):
        to_video.replay_frames("(;GM[go_9x9];B[1])")


def test_dependency_graph_and_every_jax_module_has_a_namesake(tmp_path):
    pkg = os.path.dirname(minizero_tpu_torch.__file__)
    modules, edges = dependency_graph.collect_edges(pkg)
    assert "minizero_tpu_torch.search.mcts" in modules
    assert ("minizero_tpu_torch.selfplay.engine", "minizero_tpu_torch.search.mcts") in edges
    assert all(a.startswith("minizero_tpu_torch") and b.startswith("minizero_tpu_torch")
               for a, b in edges)
    assert dependency_graph.to_graphml(modules, edges).count("<node ") == len(modules)
    assert dependency_graph.to_dot(modules, edges).count(" -> ") == len(edges)
    out = str(tmp_path / "deps.dot")
    assert dependency_graph.main(["-format", "dot", "-out", out]) == 0
    assert open(out).read() == dependency_graph.to_dot(modules, edges)
    # every module of the JAX package has one of the same name in the port;
    # a module that has none must be named here with the reason (none is)
    exceptions = {}
    jax_modules, _ = jdeps.collect_edges(os.path.dirname(minizero_tpu.__file__))
    port = {m.replace("minizero_tpu_torch", "minizero_tpu", 1) for m in modules}
    assert sorted(set(jax_modules) - port - set(exceptions)) == []
    assert len(modules) >= len(jax_modules)


def test_profile_phases_and_the_cpu_trace_report(tmp_path, capsys):
    over = dict(algorithm_preset("gaz"), **dict(TINY, actor_num_simulation=2,
                                                actor_gumbel_sample_size=2, learner_batch_size=4))
    cfg = default_config("tictactoe", **over)
    rows = profile.profile_selfplay(cfg, moves=2, batch=4, train_steps=1,
                                    trace_dir=str(tmp_path), device="cpu")
    phases = {r["phase"]: r for r in rows}
    assert sorted(phases) == ["selfplay_compile", "selfplay_steady", "train_compile",
                              "train_steady"]
    assert phases["selfplay_steady"]["env_steps_per_sec"] > 0
    assert phases["train_steady"]["steps"] == 1
    for name in (profile.SELFPLAY_TRACE, profile.TRAIN_TRACE):
        assert os.path.getsize(tmp_path / name) > 0
    for by in ("op", "source"):
        found, total_us = trace_report.aggregate(str(tmp_path), by=by, device_filter="cpu")
        assert found and total_us > 0
        assert abs(sum(us for _, us, _ in found) - total_us) < 1e-6 * total_us
    # self times: the convolution's own kernel, not its wrappers, holds its time
    names = [k for k, _, _ in trace_report.aggregate(
        str(tmp_path / profile.TRAIN_TRACE), device_filter="cpu")[0]]
    assert any("convolution" in k for k in names)
    assert trace_report.aggregate(str(tmp_path))[0] == []  # no card events in a CPU trace
    assert trace_report.main(["-trace_dir", str(tmp_path), "-device", "cpu", "-top", "3"]) == 0
    assert "total device op time" in capsys.readouterr().out
    assert trace_report.main(["-trace_dir", str(tmp_path)]) == 1
    assert "no device op events found" in capsys.readouterr().out
    assert profile.main(["-conf_str", "env_name=tictactoe:nn_num_hidden_channels=8:"
                         "nn_num_value_hidden_channels=8:actor_num_simulation=2:learner_batch_size=4",
                         "-moves", "1", "-batch", "2", "-train_steps", "1"], device="cpu") == 0

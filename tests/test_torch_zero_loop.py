"""The port's zero loop (``zero/loop.py``) and its CLI on the CPU, on
TicTacToe, whose games finish in at most 9 moves; and the port's TicTacToe
env held against its JAX twin.

The loop is checked in the shape of ``tests/test_train.py``'s iteration
test: one iteration plays exactly ``zero_num_games_per_iteration`` records,
takes ``learner_training_step`` SGD steps, writes its checkpoint, log lines
and a ``perf.jsonl`` row, and a second loop reloads the checkpoint to
identical model and optimizer tensors. ``resume()`` rebuilds the replay
window from the record file with the feature planes that self-play
recorded, exactly. The env comparison is exact (integers and 0/1 planes).
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minizero_tpu.config import default_config as jdefault_config
from minizero_tpu.envs import make_env as jmake_env
from minizero_tpu_torch.__main__ import main
from minizero_tpu_torch.config import algorithm_preset, default_config
from minizero_tpu_torch.envs import make_env
from minizero_tpu_torch.selfplay.engine import SelfPlayEngine
from minizero_tpu_torch.zero.loop import ZeroLoop, per_beta_for_iteration, temperature_for_iteration

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_threads import one_torch_thread  # noqa: E402,F401


def tiny_cfg(**overrides):
    base = dict(
        nn_num_blocks=1,
        nn_num_hidden_channels=8,
        nn_num_value_hidden_channels=8,
        actor_num_simulation=8,
        learner_batch_size=16,
        learner_training_step=10,
        learner_training_display_step=5,
        zero_num_games_per_iteration=8,
        zero_num_parallel_games=8,
        zero_end_iteration=1,
    )
    base.update(overrides)
    return default_config("tictactoe", **base)


def test_tictactoe_env_matches_jax_on_random_playouts():
    b = 64
    jenv = jmake_env(jdefault_config("tictactoe"))
    tenv = make_env(default_config("tictactoe"))
    rng = np.random.default_rng(0)
    js = jax.vmap(lambda _: jenv.init())(jnp.zeros(b))
    ts = tenv.init(b, device="cpu")
    jstep = jax.jit(jax.vmap(jenv.step))
    for move in range(10):
        np.testing.assert_array_equal(ts.board.numpy(), np.asarray(js.board))
        np.testing.assert_array_equal(tenv.turn(ts).numpy(), np.asarray(jax.vmap(jenv.turn)(js)))
        legal = np.asarray(jax.vmap(jenv.legal_mask)(js))
        np.testing.assert_array_equal(tenv.legal_mask(ts).numpy(), legal)
        np.testing.assert_array_equal(tenv.is_terminal(ts).numpy(),
                                      np.asarray(jax.vmap(jenv.is_terminal)(js)))
        np.testing.assert_array_equal(tenv.eval_score(ts).numpy(),
                                      np.asarray(jax.vmap(jenv.eval_score)(js)))
        np.testing.assert_array_equal(tenv.features(ts).numpy(),
                                      np.asarray(jax.vmap(jenv.features)(js)))
        if move == 9:
            break
        # a random legal action where there is one (terminal games keep
        # stepping, as the batched engine steps them)
        scores = rng.random(legal.shape) + legal
        actions = scores.argmax(-1).astype(np.int32)
        js = jstep(js, jnp.asarray(actions))
        ts = tenv.step(ts, torch.as_tensor(actions))
    assert tenv.is_terminal(ts).all()


def test_anneals_match_the_reference_schedule():
    cfg = tiny_cfg(actor_select_action_softmax_temperature_decay=True, zero_end_iteration=100,
                   learner_use_per=True, learner_per_init_beta=0.4)
    assert [temperature_for_iteration(cfg, i) for i in (10, 60, 90)] == [1.0, 0.5, 0.25]
    assert per_beta_for_iteration(cfg, 50) == pytest.approx(0.7)
    assert per_beta_for_iteration(cfg, 200) == 1.0


def _state(loop):
    return loop.network.state_dict(), loop.state.optimizer.state_dict()


def _assert_same_tensors(a, b, what):
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b), what
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b), what
        for k in a:
            _assert_same_tensors(a[k], b[k], f"{what}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same_tensors(x, y, f"{what}[{i}]")
    else:
        assert a == b, what


def test_zero_loop_iteration_checkpoint_and_reload(tmp_path):
    """One miniature full iteration: self-play -> train -> checkpoint, then
    a second loop loads the checkpoint."""
    cfg = tiny_cfg()
    loop = ZeroLoop(cfg, str(tmp_path), device="cpu")
    assert loop.engine.network is loop.network
    loop.run()
    lines = (tmp_path / "sgf" / "1.sgf").read_text().strip().splitlines()
    assert len(lines) == cfg.zero_num_games_per_iteration
    assert all(ln.startswith("(;GM[tictactoe]") and "EV[weight_iter_0]" in ln for ln in lines)
    assert loop.state.step == cfg.learner_training_step
    assert not loop.network.training
    ckpt = tmp_path / "model" / f"weight_iter_{loop.state.step}.ckpt"
    assert ckpt.exists() and (tmp_path / "model" / "weight_iter_0.ckpt").exists()
    op = (tmp_path / "op.log").read_text().strip().splitlines()
    assert len(op) == cfg.learner_training_step // cfg.learner_training_display_step
    assert "nn step 10, lr: 0.02. accuracy_policy:" in op[-1] and "loss_value:" in op[-1]
    log = (tmp_path / "Training.log").read_text()
    assert "[SelfPlay Timing] chunks:" in log and "Optimization_Done 10" in log
    (row,) = [json.loads(x) for x in (tmp_path / "perf.jsonl").read_text().splitlines()]
    assert row["iteration"] == 1 and row["wall_end"] >= row["wall_selfplay_done"] >= row["wall_start"]
    assert len(row["run"]) == 12 and row["pid"] == os.getpid()
    loop2 = ZeroLoop(cfg, str(tmp_path), device="cpu")
    loop2.load_checkpoint(str(ckpt))
    assert loop2.state.step == cfg.learner_training_step
    _assert_same_tensors(_state(loop2), _state(loop), "reloaded")
    loop.close()
    loop2.close()


def test_resume_rebuilds_the_replay_window(tmp_path):
    cfg = tiny_cfg(zero_end_iteration=2, zero_replay_buffer=2)
    loop = ZeroLoop(cfg, str(tmp_path), device="cpu")
    loop.run()
    assert loop.state.step == 2 * cfg.learner_training_step
    loop2 = ZeroLoop(cfg, str(tmp_path), device="cpu")
    assert loop2.resume() == 2
    assert loop2.cfg.zero_start_iteration == 2 and loop2.state.step == loop.state.step
    assert len(loop2.buffer) == len(loop.buffer) == 16
    for want, got in zip(loop.buffer.games, loop2.buffer.games):
        np.testing.assert_array_equal(got.actions, want.actions)
        np.testing.assert_array_equal(got.features, want.features)
        assert got.result == want.result
    _assert_same_tensors(_state(loop2), _state(loop), "resumed")
    loop.close()
    loop2.close()


def test_gumbel_muzero_iteration_with_per_and_the_bf16_copy(tmp_path):
    """Gumbel MuZero on the loop, with PER (per-step refresh) and the
    engine's bf16 inference copy: after the optimize, the next move plays
    the updated weights."""
    over = dict(algorithm_preset("gmz"))
    over.update(actor_num_simulation=4, actor_gumbel_sample_size=4, learner_use_per=True,
                learner_muzero_unrolling_step=2, zero_num_games_per_iteration=4,
                zero_num_parallel_games=4, learner_training_step=4, learner_training_display_step=2)
    cfg = tiny_cfg(**over)
    loop = ZeroLoop(cfg, str(tmp_path), device="cpu")
    # the card's engine: bf16 inference on a copy that follows the net
    loop.engine = SelfPlayEngine(loop.env, cfg, loop.network, use_bf16=True, device="cpu")
    assert loop.engine._infer_net is not loop.network
    loop.self_play_iteration(1)
    loop.optimize_iteration(1)
    assert loop.state.step == 4 and not loop.network.training
    loop.engine.move(loop.engine.init_batch(4))
    want = {k: v.to(torch.bfloat16) if v.is_floating_point() else v
            for k, v in loop.network.state_dict().items()}
    _assert_same_tensors(loop.engine._infer_net.state_dict(), want, "bf16 copy")
    assert len((tmp_path / "op.log").read_text().splitlines()) == 2
    loop.close()


def test_cli_zero_mode_runs_and_continues(tmp_path, capsys):
    conf = ("env_name=tictactoe:nn_num_hidden_channels=8:nn_num_value_hidden_channels=8:"
            "actor_num_simulation=8:learner_batch_size=16:learner_training_step=4:"
            "learner_training_display_step=2:zero_num_games_per_iteration=4:"
            "zero_num_parallel_games=4:zero_end_iteration=1")
    run_dir = str(tmp_path / "run")
    assert main(["-mode", "zero", "-run_dir", run_dir, "-conf_str", conf], device="cpu") == 0
    assert os.path.exists(os.path.join(run_dir, "model", "weight_iter_4.ckpt"))
    # a second call continues from iteration 1 and has nothing left to do
    conf2 = conf.replace("zero_end_iteration=1", "zero_end_iteration=2")
    assert main(["-mode", "zero", "-run_dir", run_dir, "-conf_str", conf2], device="cpu") == 0
    assert os.path.exists(os.path.join(run_dir, "model", "weight_iter_8.ckpt"))
    assert "[Resume] iteration 1, 4 games reloaded" in capsys.readouterr().out
    gen = str(tmp_path / "gen.cfg")
    assert main(["-gen", gen, "-conf_str", conf]) == 0
    assert "env_name=tictactoe" in open(gen).read()
    # the loop's records carry no OBS tag: remove_obs copies them unchanged
    sgf = os.path.join(run_dir, "sgf", "1.sgf")
    assert main(["-mode", "remove_obs", "-input", sgf, "-output", sgf + ".noobs",
                 "-conf_str", conf]) == 0
    assert open(sgf + ".noobs").read() == open(sgf).read()


def test_the_card_is_the_default(tmp_path):
    """Without a card, and without device="cpu", the loop and the CLI raise
    instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ZeroLoop(tiny_cfg(), str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["-mode", "zero", "-run_dir", str(tmp_path), "-conf_str", "env_name=tictactoe"])


def test_atari_loop_is_refused(tmp_path):
    """The Atari loop refuses to start without an ALE: with no
    ``ale_factory`` it builds the real one, which needs ``ale_py``
    (tests/test_torch_atari.py drives it over FakeALE)."""
    try:
        import ale_py  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError, match="ale_py"):
            ZeroLoop(default_config("atari"), str(tmp_path), device="cpu")

"""Eval matches, the GTP console and the CLI modes of the port, held against
the JAX package on the CPU.

Weights go across with ``weights.from_jax_variables``. Tolerances: match
results exact (float32 on both sides, rotation off, no random openings, so
both packages play the same deterministic games); GTP replies equal line
for line (``pv_string``'s full-precision value aside: the two frameworks'
float32 convolutions differ in the last bits); ``zero_training_name`` and
``env_test``'s moves exact. The JAX console's own scenarios
(``tests/test_console_eval.py``) run on the port.
"""

import functools
import io
import os
import sys

import jax
import pytest
import torch

import minizero_tpu.eval.match as jmatch
import minizero_tpu_torch.eval.match as tmatch
from minizero_tpu.config import algorithm_preset as j_preset
from minizero_tpu.config import default_config as j_default
from minizero_tpu.console.gtp import ConsoleActor as JConsoleActor
from minizero_tpu.console.gtp import GTPConsole as JGTPConsole
from minizero_tpu.envs import make_env as j_make_env
from minizero_tpu.models.factory import create_network as j_create_network
from minizero_tpu.models.factory import init_network as j_init_network
from minizero_tpu_torch.__main__ import main, run_env_test, training_name
from minizero_tpu_torch.config import algorithm_preset, default_config
from minizero_tpu_torch.console.gtp import (
    ConsoleActor, GTPConsole, action_to_gtp, gtp_to_action)
from minizero_tpu_torch.envs import make_env
from minizero_tpu_torch.eval.match import (
    elo_from_win_rate, fight_eval, load_checkpoint_variables, play_match, self_eval)
from minizero_tpu_torch.models.factory import create_network
from minizero_tpu_torch.weights import from_jax_variables
from minizero_tpu_torch.zero.loop import ZeroLoop

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_threads import one_torch_thread  # noqa: E402,F401

_TINY = dict(actor_num_simulation=4, actor_gumbel_sample_size=4, nn_num_blocks=1,
             nn_num_hidden_channels=8, nn_num_value_hidden_channels=8)
# deterministic searches: no root noise, no rotation, the most visited action
_DETERMINISTIC = dict(actor_use_dirichlet_noise=False, actor_use_gumbel_noise=False,
                      actor_use_random_rotation_features=False,
                      actor_select_action_by_count=True)


def _carried(cfg, jcfg, seed):
    """JAX variables from ``seed`` and the port's network holding them."""
    jenv = j_make_env(jcfg)
    jvars = j_init_network(j_create_network(jcfg, jenv.spec), jenv.spec, jax.random.PRNGKey(seed))
    spec = make_env(cfg).spec
    net = create_network(cfg, spec)
    net.load_state_dict(from_jax_variables(jvars, hidden_hw=spec.hidden_height * spec.hidden_width))
    return jvars, net.eval()


def _console(env="tictactoe", **over):
    out = io.StringIO()
    return GTPConsole(default_config(env, **{**_TINY, **over}), out=out, device="cpu"), out


# ------------------------------------------------------------------ console

def test_gtp_coordinates():
    assert action_to_gtp(0, 9, True) == "A1"
    assert action_to_gtp(8, 9, True) == "J1"  # I skipped
    assert action_to_gtp(81, 9, True) == "PASS"
    assert gtp_to_action("pass", 9) == 81
    assert gtp_to_action("D4", 9) == 3 * 9 + 3
    for a in range(81):
        assert gtp_to_action(action_to_gtp(a, 9, True), 9) == a


def test_console_scenarios():
    """``tests/test_console_eval.py``'s console scenarios on the port."""
    console, out = _console()
    for line in ("name", "protocol_version", "list_commands", "7 name", "bogus_cmd"):
        console.execute(line)
    text = out.getvalue()
    assert "= minizero_tpu" in text and "= 2" in text and "genmove" in text
    assert "=7 minizero_tpu" in text and "? Unknown command" in text
    assert len(console.commands) == 20

    console, out = _console()
    for line in ("play b A1", "genmove w", "showboard", "final_score", "pv", "play w A1"):
        console.execute(line)
    text = out.getvalue()
    assert text.count("=") >= 5 and "O" in text and "%" in text
    assert 'Invalid action: "A1"' in text  # occupied

    console, out = _console()
    console.execute("play b A1")
    console.execute("tree_string")
    text = out.getvalue()
    assert "[root]C[count:" in text and text.count("(;") >= 2


def test_console_load_game_and_model(tmp_path):
    rec = tmp_path / "game.sgf"
    rec.write_text("(;GM[tictactoe]RE[0]SZ[3];B[4]P[4:1]V[0]R[0];W[0]P[0:1]V[0]R[0])\n")
    console, out = _console()
    console.execute(f"load_game {rec}")
    console.execute("game_string")
    text = out.getvalue()
    assert "?" not in text.splitlines()[0] and "B[4]" in text and "W[0]" in text
    console, out = _console()
    console.execute("load_game /nonexistent/file.sgf")
    console.execute("load_model /nonexistent/weight_iter_0.ckpt")
    lines = [x for x in out.getvalue().splitlines() if x]
    assert lines[0].startswith("?") and lines[1].startswith("? Failed to load model")

    cfg = default_config("tictactoe", **_TINY)
    net = tmatch.create_network(cfg, make_env(cfg).spec)
    torch.save({"model": net.state_dict()}, tmp_path / "w.ckpt")
    console, out = _console()
    console.execute(f"load_model {tmp_path / 'w.ckpt'}")
    assert out.getvalue() == "= \n\n"
    for k, v in net.state_dict().items():
        assert torch.equal(console.actor.network.state_dict()[k], v), k


@pytest.mark.parametrize("over", [dict(actor_mcts_think_time_limit=1e-6),
                                  dict(actor_mcts_think_batch_size=4, actor_num_simulation=16)],
                         ids=["timed", "think-batch"])
def test_console_timed_and_think_batch(over):
    console, out = _console(**over)
    assert console._ensure_actor().engine.spec.think_batch == over.get(
        "actor_mcts_think_batch_size", 1)
    for line in ("genmove b", "genmove w", "tree_string", "showboard"):
        console.execute(line)
    replies = [x.strip() for x in out.getvalue().split("\n\n") if x.strip()]
    assert len(replies) == 4 and all(r.startswith("=") for r in replies), replies


def test_console_timed_think_stops_at_the_clock():
    """With a limit of ~0 s the think stops after its first chunk of n // 8
    simulations; with a long limit it runs the whole budget."""
    cfg = default_config("tictactoe", **{**_TINY, **_DETERMINISTIC, "actor_num_simulation": 16,
                                         "actor_mcts_think_time_limit": 1e-9})
    actor = ConsoleActor(cfg, device="cpu")
    seen = []
    finish = actor.engine.az_finish_timed

    def spy(carry, *a):
        seen.append(int(carry.trees.visits[0, 0]))
        return finish(carry, *a)

    actor.engine.az_finish_timed = spy
    assert 0 <= actor.think(play=False)[0] < 9
    actor.cfg = cfg.replace(actor_mcts_think_time_limit=1e3)
    action, _ = actor.think(play=False)
    assert seen == [1 + 2, 1 + 16]
    assert action == int(actor.engine.move(actor.states).action[0])


_SCRIPT = ["name", "protocol_version", "list_commands", "play b B2", "genmove w", "showboard",
           "pv", "tree_string", "genmove b", "game_string", "final_score",
           "get_conf_str actor_num_simulation:env_name", "clear_board", "genmove b", "pv",
           "play w A1", "play w A1", "bogus", "3 genmove w", "showboard", "quit"]


@pytest.mark.parametrize("algo", ["gaz", "az"])
def test_gtp_replies_match_jax_line_for_line(algo):
    """One GTP script through the JAX console and the port's, on carried
    weights: the same replies, line for line."""
    over = {**_TINY, **dict(algorithm_preset(algo)), **_DETERMINISTIC, "actor_num_simulation": 8}
    assert dict(algorithm_preset(algo)) == dict(j_preset(algo))
    cfg, jcfg = default_config("tictactoe", **over), j_default("tictactoe", **over)
    jvars, net = _carried(cfg, jcfg, seed=1)
    jout, out = io.StringIO(), io.StringIO()
    jconsole, console = JGTPConsole(jcfg, out=jout), GTPConsole(cfg, out=out, device="cpu")
    jconsole.actor = JConsoleActor(jcfg, variables=jvars)
    console.actor = ConsoleActor(cfg, network=net, device="cpu")
    for line in _SCRIPT:
        jconsole.execute(line)
        console.execute(line)
    assert out.getvalue().splitlines() == jout.getvalue().splitlines()
    assert not console.running


# ------------------------------------------------------------------- eval

def _float32(monkeypatch):
    for mod in (jmatch, tmatch):
        monkeypatch.setattr(mod, "SelfPlayEngine",
                            functools.partial(mod.SelfPlayEngine, use_bf16=False))


@pytest.mark.parametrize("synchronized", [True, False], ids=["synchronized", "general"])
def test_play_match_matches_jax(monkeypatch, synchronized):
    """Both paths give the JAX ``MatchResult`` exactly (float32, rotation
    off, no openings); the general path is reached by emptying
    ``_ALTERNATING`` in both packages."""
    _float32(monkeypatch)
    if not synchronized:
        for mod in (jmatch, tmatch):
            monkeypatch.setattr(mod, "_ALTERNATING", ())
    over = {**_TINY, **_DETERMINISTIC, "zero_num_parallel_games": 4}
    cfg, jcfg = default_config("tictactoe", **over), j_default("tictactoe", **over)
    jva, na = _carried(cfg, jcfg, seed=0)
    jvb, nb = _carried(cfg, jcfg, seed=1)
    want = jmatch.play_match(jcfg, jva, jvb, num_games=10, seed=0)
    got = play_match(cfg, na, nb, num_games=10, seed=0, device="cpu")
    assert (got.p1_wins, got.p2_wins, got.draws) == (want.p1_wins, want.p2_wins, want.draws)
    assert got.games == 10 and got.p1_win_rate == want.p1_win_rate


def test_self_match_is_colour_symmetric():
    """A net against itself, rotation off, random openings: every A-as-P1
    game has its colour-mirrored twin, so wins split exactly even."""
    cfg = default_config("tictactoe", **_TINY, zero_num_parallel_games=4,
                         actor_use_random_rotation_features=False)
    net = tmatch.create_network(cfg, make_env(cfg).spec)
    r = play_match(cfg, net, net, num_games=8, seed=3, opening_random_plies=2, device="cpu")
    assert r.games == 8 and r.p1_wins == r.p2_wins, r
    assert elo_from_win_rate(0.5) == 0.0
    assert elo_from_win_rate(0.64) == pytest.approx(100, abs=2)
    assert elo_from_win_rate(1.0) == 1000.0 and elo_from_win_rate(0.0) == -1000.0


def test_self_eval_and_fight_eval_on_zero_loop_checkpoints(tmp_path, capsys):
    """A 2-iteration TicTacToe ``ZeroLoop`` of the port, then its ladder
    through ``-mode eval`` (``eval.csv``) and a cross-run match."""
    conf = ("env_name=tictactoe:nn_num_hidden_channels=8:nn_num_value_hidden_channels=8:"
            "actor_num_simulation=8:learner_batch_size=16:learner_training_step=4:"
            "learner_training_display_step=2:zero_num_games_per_iteration=4:"
            "zero_num_parallel_games=4:zero_end_iteration=2")
    run = str(tmp_path / "run")
    assert main(["-mode", "zero", "-run_dir", run, "-conf_str", conf], device="cpu") == 0
    assert sorted(os.listdir(os.path.join(run, "model"))) == [
        "weight_iter_0.ckpt", "weight_iter_4.ckpt", "weight_iter_8.ckpt"]
    capsys.readouterr()
    assert main(["-mode", "eval", "-run_dir", run, "-conf_str", conf, "-num_games", "6",
                 "-platform", "cpu"]) == 0
    printed = capsys.readouterr().out.splitlines()
    assert [x.split(":")[0] for x in printed] == ["weight_iter_4.ckpt vs weight_iter_0.ckpt",
                                                  "weight_iter_8.ckpt vs weight_iter_4.ckpt"]
    rows = open(os.path.join(run, "eval.csv")).read().splitlines()
    assert rows[0] == "new,old,win_rate,elo,wins,losses,draws" and len(rows) == 3
    cfg = default_config().load_string(conf)
    ladder = self_eval(cfg, run, num_games=6, device="cpu")
    assert [sum(r[k] for k in ("wins", "losses", "draws")) for r in ladder] == [6, 6]
    assert [r["new"] for r in ladder] == ["weight_iter_4.ckpt", "weight_iter_8.ckpt"]
    row = fight_eval(cfg, run, run, "weight_iter_4.ckpt", num_games=4, device="cpu")
    assert row["a"] == row["b"] == os.path.join(run, "model", "weight_iter_4.ckpt")
    assert row["wins"] + row["losses"] + row["draws"] == 4
    loaded = load_checkpoint_variables(os.path.join(run, "model", "weight_iter_8.ckpt"), cfg)
    loop = ZeroLoop(cfg, run, device="cpu")
    loop.load_checkpoint(os.path.join(run, "model", "weight_iter_8.ckpt"))
    for k, v in loop.network.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k
    loop.close()


# -------------------------------------------------------------------- CLI

@pytest.mark.parametrize("env,algo", [("go", "gaz"), ("go", "mz"), ("tictactoe", "az")])
def test_zero_training_name_matches_jax(env, algo, capsys):
    from minizero_tpu.__main__ import main as j_main
    from minizero_tpu.__main__ import training_name as j_training_name

    cfg = default_config(env, **algorithm_preset(algo))
    assert training_name(cfg) == j_training_name(j_default(env, **j_preset(algo)))
    conf = f"env_name={env}:nn_type_name={'muzero' if 'mz' in algo else 'alphazero'}"
    assert j_main(["-mode", "zero_training_name", "-conf_str", conf]) == 0
    want = capsys.readouterr().out
    assert main(["-mode", "zero_training_name", "-conf_str", conf]) == 0
    assert capsys.readouterr().out == want


@pytest.mark.parametrize("env,over", [("tictactoe", {}), ("go", {"env_board_size": 5})],
                         ids=["tictactoe", "go5x5"])
def test_env_test_plays_the_jax_moves(env, over, monkeypatch, capsys):
    """``env_test`` draws the same moves as the JAX package's (the JAX
    env's step recorded through ``jax.jit``) and prints the same line."""
    from minizero_tpu.__main__ import run_env_test as j_run_env_test

    played = []
    real_jit = jax.jit

    def recording_jit(fn, *args, **kwargs):
        compiled = real_jit(fn, *args, **kwargs)

        def step(state, action):
            played.append(int(action))
            return compiled(state, action)
        return step

    with monkeypatch.context() as m:
        m.setattr(jax, "jit", recording_jit)
        j_run_env_test(j_default(env, **over))
    jlines = capsys.readouterr().out.splitlines()
    actions = run_env_test(default_config(env, **over), device="cpu")
    assert actions == played[: len(played) // 2] and len(actions) > 0
    assert capsys.readouterr().out.splitlines() == jlines


def test_cli_modes_devices_and_unported_modes(tmp_path, capsys):
    conf = "env_name=tictactoe:" + ":".join(f"{k}={v}" for k, v in _TINY.items())
    gen = str(tmp_path / "gen.cfg")
    assert main(["-mode", "env_test", "-conf_str", conf, "-gen", gen]) == 0
    assert "env_name=tictactoe" in open(gen).read()
    assert main(["-mode", "env_test", "-conf_str", conf, "-platform", "cpu"]) == 0
    assert "replay determinism check passed" in capsys.readouterr().out
    out = str(tmp_path / "sp.sgf")
    assert main(["-mode", "sp", "-conf_str", conf + ":zero_num_parallel_games=4",
                 "-num_games", "5", "-output", out, "-platform", "cpu"]) == 0
    from minizero_tpu_torch.selfplay.record import parse_game

    lines = open(out).read().splitlines()
    assert len(lines) == 5 and all(parse_game(x, 9)[1] for x in lines)
    # -multi_device without a launcher and without cards is the plain loop
    run_dir = str(tmp_path / "run")
    assert main(["-mode", "zero", "-multi_device", "-run_dir", run_dir, "-platform", "cpu",
                 "-conf_str", conf + ":zero_num_games_per_iteration=4:zero_num_parallel_games=4"
                 ":learner_batch_size=8:learner_training_step=2:zero_end_iteration=1"]) == 0
    assert os.path.exists(os.path.join(run_dir, "model", "weight_iter_2.ckpt"))
    assert "games/s)" in open(os.path.join(run_dir, "Training.log")).read()
    try:  # Atari sp runs over the host env; without ale_py its real ALE raises
        import ale_py  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError, match="ale_py"):
            main(["-mode", "sp", "-conf_str", "env_name=atari", "-platform", "cpu"])
    # the OBS tools: remove_obs strips the tags; recover_obs replays Atari
    # records, whose real ALE needs ale_py
    records = str(tmp_path / "atari.sgf")
    with open(records, "w") as f:
        f.write("(;GM[atari_pong]SD[7];B[3]P[3:1]V[0]R[1]OBS[00ff])\n")
    assert main(["-mode", "remove_obs", "-input", records, "-platform", "cpu"]) == 0
    assert open(records + ".noobs").read() == "(;GM[atari_pong]SD[7];B[3]P[3:1]V[0]R[1])\n"
    try:
        import ale_py  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError, match="ale_py"):
            main(["-mode", "recover_obs", "-input", records + ".noobs", "-platform", "cpu"])
    with pytest.raises(ValueError, match="-platform tpu"):
        main(["-mode", "env_test", "-platform", "tpu"])


def test_console_mode_reads_gtp_from_stdin(monkeypatch, capsys):
    conf = "env_name=tictactoe:" + ":".join(f"{k}={v}" for k, v in _TINY.items())
    monkeypatch.setattr("sys.stdin", io.StringIO("play b A1\ngenmove w\nquit\nname\n"))
    assert main(["-mode", "console", "-conf_str", conf, "-platform", "cpu"]) == 0
    replies = [x.strip() for x in capsys.readouterr().out.split("\n\n") if x.strip()]
    assert len(replies) == 3 and all(r.startswith("=") for r in replies), replies

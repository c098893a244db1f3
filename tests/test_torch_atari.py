"""The port's Atari host path held against the JAX package: the env over
the FakeALE stub, the host self-play engine, its collector, the OBS
payloads, the Atari zero loop and ``-mode sp``.

Exact where the JAX package is deterministic: ``FakeALE``, ``AtariEnv``
and ``AtariVecEnv`` (frames, rewards, lives, terminals, ``features_u8``),
``rebuild_features_from_frames``, the device ring's stacks (against JAX's
``_features_from_ring``), the collector's records given the same moves, and
the OBS bytes. The engines' moves are compared on the integer MuZero parity
net of ``tests/parity_common.py`` with noise off and select by count:
actions exact, policy targets 2e-4 and root values 1e-3 (Atari's values
are ``invertValue`` outputs up to ~100; ``tests/test_torch_muzero_search.py``
holds the search to the same bounds). Both engines draw from their own
generators, so no test relies on equal random streams.

The JAX engine hands the collector a view of its vec env's frame ring as a
move's frames, which the ring overwrites 8 moves later; the port copies
them (``tests/test_torch_frame_window.py`` checks engine-made records), so
the collectors are compared here on copies.
"""

import os
import re
import sys

import jax
import numpy as np
import pytest

from minizero_tpu.config import algorithm_preset as j_preset
from minizero_tpu.config import default_config as j_default
from minizero_tpu.envs import atari as jatari
from minizero_tpu.selfplay.host_engine import AtariTrajectoryCollector as JCollector
from minizero_tpu.selfplay.host_engine import HostMoveOutput as JMove
from minizero_tpu.selfplay.host_engine import HostSelfPlayEngine as JHostEngine
from minizero_tpu.selfplay.record import serialize_game as jserialize_game
from minizero_tpu.tools import obs as jobs
from minizero_tpu_torch.__main__ import main, run_selfplay_host
from minizero_tpu_torch.config import algorithm_preset, default_config
from minizero_tpu_torch.envs import atari, make_env
from minizero_tpu_torch.learner.frame_window import rows_needed
from minizero_tpu_torch.ops.tree_kernel import fused_tree_step
from minizero_tpu_torch.selfplay.host_engine import (
    AtariTrajectoryCollector, HostMoveOutput, HostSelfPlayEngine, atari_record_line)
from minizero_tpu_torch.selfplay.record import game_record_from_string
from minizero_tpu_torch.tools import obs
from minizero_tpu_torch.zero.loop import ZeroLoop

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from parity_common import jax_muzero_parity_network  # noqa: E402
from test_torch_muzero_search import TorchMuZeroParityNet  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401


def _fake(length):
    return lambda s: atari.FakeALE(seed=s, length=length)


def _jfake(length):
    return lambda s: jatari.FakeALE(seed=s, length=length)


_TINY = dict(actor_num_simulation=2, nn_num_blocks=1, nn_num_hidden_channels=8,
             nn_num_value_hidden_channels=8)


# ---------------------------------------------------------------------- env
@pytest.mark.parametrize("seed,length", [(0, 64), (7, 30)])
def test_env_matches_jax(seed, length):
    """FakeALE and AtariEnv step for step: screens, rewards, lives,
    terminal, the f32 and u8 features and the newest frame, through a
    reset."""
    ja = jatari.FakeALE(seed=seed, length=length)
    ta = atari.FakeALE(seed=seed, length=length)
    np.testing.assert_array_equal(ta.getScreenRGB(), ja.getScreenRGB())
    np.testing.assert_array_equal(atari._resize_rgb(ta.getScreenRGB()),
                                  jatari._resize_rgb(ja.getScreenRGB()))
    jenv = jatari.AtariEnv(seed=seed, ale_factory=_jfake(length))
    env = atari.AtariEnv(seed=seed, ale_factory=_fake(length))
    assert vars(env.spec) == vars(jenv.spec) and env.num_rotations() == 1
    rng = np.random.RandomState(seed)
    for t in range(length // atari.FRAME_SKIP + 6):
        np.testing.assert_array_equal(env.legal_mask(), jenv.legal_mask())
        np.testing.assert_array_equal(env.features(), jenv.features())
        np.testing.assert_array_equal(env.features_u8(), jenv.features_u8())
        np.testing.assert_array_equal(env.newest_frame(), jenv.newest_frame())
        assert env.is_terminal() == jenv.is_terminal()
        if env.is_terminal():
            env.reset(seed + 100 + t)
            jenv.reset(seed + 100 + t)
            continue
        a = int(rng.randint(0, 4))
        assert env.step(a) == jenv.step(a)
        assert env.lives_history == jenv.lives_history and env.eval_score() == jenv.eval_score()


def test_vec_env_matches_jax():
    """The batched ring across steps and mid-batch resets."""
    vec = atari.AtariVecEnv(3, seed=2, ale_factory=_fake(12))
    jvec = jatari.AtariVecEnv(3, seed=2, ale_factory=_jfake(12))
    rs = np.random.RandomState(5)
    resets = 0
    for _ in range(10):
        np.testing.assert_array_equal(vec.features_u8(), jvec.features_u8())
        np.testing.assert_array_equal(vec.features_u8(), np.stack([e.features_u8() for e in vec.envs]))
        np.testing.assert_array_equal(vec.features(), jvec.features())
        np.testing.assert_array_equal(vec.newest_frames(), jvec.newest_frames())
        np.testing.assert_array_equal(vec.legal_masks(), jvec.legal_masks())
        a = rs.randint(0, 4, (3,))
        np.testing.assert_array_equal(vec.step(a), jvec.step(a))
        np.testing.assert_array_equal(vec.terminals(), jvec.terminals())
        done = vec.reset_done()
        assert done == jvec.reset_done()
        resets += len(done)
    assert resets > 0 and [e.seed for e in vec.envs] == [e.seed for e in jvec.envs]


def test_rebuild_features_from_frames_matches_jax():
    env = atari.AtariEnv(seed=3, ale_factory=_fake(60))
    feats, actions = [], [1, 3, 0, 2, 1, 1, 0, 3, 2, 1, 2, 0]
    for a in actions:
        feats.append(env.features_u8())
        env.step(a)
    feats = np.stack(feats)
    acts = np.array(actions, np.int32)
    got = atari.rebuild_features_from_frames(feats[:, :, :, -3:], acts)
    np.testing.assert_array_equal(got, feats)
    np.testing.assert_array_equal(got, jatari.rebuild_features_from_frames(feats[:, :, :, -3:], acts))


def test_make_env_builds_atari_and_wants_ale_py():
    """``make_env`` builds the JAX registry's AtariEnv; without ``ale_py``
    the real ALE raises ImportError naming it, as in JAX."""
    cfg = default_config("atari")
    try:
        import ale_py  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError, match="ale_py"):
            make_env(cfg)
        with pytest.raises(ImportError, match="ale_py"):
            atari.make_ale("/nowhere/ms_pacman.bin", 0)


# ------------------------------------------------------------------- engine
def _engines(batch, sims, length, seed=0):
    over = dict(algorithm_preset("mz", is_atari=True))
    over.update(actor_num_simulation=sims, actor_select_action_by_count=True,
                actor_use_dirichlet_noise=False, actor_use_gumbel_noise=False,
                zero_actor_intermediate_sequence_length=4, learner_n_step_return=2,
                learner_muzero_unrolling_step=2)
    assert dict(j_preset("mz", is_atari=True)) == dict(algorithm_preset("mz", is_atari=True))
    jcfg, cfg = j_default("atari", **over), default_config("atari", **over)
    jvec = jatari.AtariVecEnv(batch, seed=seed, ale_factory=_jfake(length))
    vec = atari.AtariVecEnv(batch, seed=seed, ale_factory=_fake(length))
    jnet, jvars = jax_muzero_parity_network("atari", atari_mode=True)
    jeng = JHostEngine(jvec, jcfg, jnet, use_bf16=False)
    eng = HostSelfPlayEngine(vec, cfg, TorchMuZeroParityNet("atari", atari_mode=True),
                             use_bf16=False, device="cpu")
    return jeng, jvars, eng, cfg


def test_host_engine_moves_match_jax():
    """Moves of both engines over their own vec envs (the same seeds),
    across episode resets: actions, rewards, lives, done exact; the ring's
    stack equal to JAX's ``_features_from_ring`` and to the env's features
    before every move; no kernel launch on the CPU."""
    jeng, jvars, eng, _ = _engines(3, 8, 28)
    before = (fused_tree_step.launches, fused_tree_step.launches_rewards)
    key = jax.random.PRNGKey(3)
    resets = 0
    for mv in range(10):
        host = eng.vec_env.features()
        key, k = jax.random.split(key)
        jout = jeng.move(jvars, k)
        out = eng.move()
        np.testing.assert_array_equal(out.action, np.asarray(jout.action), err_msg=f"move {mv}")
        np.testing.assert_allclose(out.policy_target, np.asarray(jout.policy_target), rtol=0,
                                   atol=2e-4, err_msg=f"move {mv} policy target")
        np.testing.assert_allclose(out.root_value, np.asarray(jout.root_value), rtol=0,
                                   atol=1e-3, err_msg=f"move {mv} root value")
        for name in ("reward", "done", "eval_score", "lives_lost"):
            np.testing.assert_array_equal(getattr(out, name), np.asarray(getattr(jout, name)),
                                          err_msg=f"move {mv} {name}")
        want = np.asarray(jeng._features_from_ring(jeng._ring, jeng._ahist))
        np.testing.assert_array_equal(eng.features().numpy(), want)
        np.testing.assert_allclose(eng.features().numpy(), host, rtol=0, atol=1e-6)
        np.testing.assert_array_equal(eng._ring.numpy(), np.asarray(jeng._ring))
        np.testing.assert_array_equal(eng._ahist.numpy(), np.asarray(jeng._ahist))
        done = eng.vec_env.reset_done()
        assert done == jeng.vec_env.reset_done()
        resets += len(done)
    assert resets > 0
    assert (fused_tree_step.launches, fused_tree_step.launches_rewards) == before


def test_first_moves_follow_the_nets_action_preference():
    """FakeALE pays an action's parity, so an iteration's returns count its
    odd actions. A seeded net already prefers some actions (the min-max
    rescaled Q turns a small preference into a large one), so the first
    iteration's returns follow the initial net. Through the port's host
    engine at the Atari recipe's search and full width (float32, 16 games,
    10 moves): the port's seeded init (``init_network``, seed 0) plays odd
    actions on well over half of the moves; the JAX run
    ``runs/atari_gmz_r5_b128``'s own step-0 net, carried over, on about
    half, as that run's iteration 1 did (mean return 435.66 of 860); its
    step-6,000 net on nearly all."""
    import pickle

    from minizero_tpu.eval.match import load_checkpoint_variables
    from minizero_tpu.models.factory import create_network as j_create_network
    from minizero_tpu_torch.models.factory import create_network, init_network
    from minizero_tpu_torch.weights import from_jax_muzero_variables

    run = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "runs",
                       "atari_gmz_r5_b128", "model")
    with open(os.path.join(run, "weight_iter_6000.ckpt"), "rb") as f:
        text = pickle.load(f)["config"]
    cfg = default_config("atari").load_string(text, sep="\n")
    jcfg = j_default("atari").load_string(text, sep="\n")
    jnet = j_create_network(jcfg, jatari.atari_spec())

    def odd_share(net):
        vec = atari.AtariVecEnv(16, seed=0, ale_factory=_fake(900))
        eng = HostSelfPlayEngine(vec, cfg.replace(zero_num_parallel_games=16), net,
                                 device="cpu", use_bf16=False, seed=0)
        return float(np.mean([eng.move(1.0).action % 2 for _ in range(10)]))

    def jax_net(step):
        variables = load_checkpoint_variables(os.path.join(run, f"weight_iter_{step}.ckpt"),
                                              jcfg, jnet, jatari.atari_spec())
        net = create_network(cfg, atari.atari_spec())
        net.load_state_dict(from_jax_muzero_variables(jax.device_get(variables), hidden_hw=36))
        return net

    assert odd_share(init_network(create_network(cfg, atari.atari_spec()), seed=0)) > 0.6
    assert 0.4 < odd_share(jax_net(0)) < 0.6
    assert odd_share(jax_net(6000)) > 0.95


def test_ring_stacks_equal_the_vec_env_bytes():
    """Before every move, across resets: the ring holds
    ``AtariVecEnv.features_u8``'s RGB bytes, and the search stack's action
    planes are the ids / 18 of the host env, whose quantised bytes are
    ``features_u8``'s action planes."""
    _, _, eng, _ = _engines(2, 2, 12, seed=4)
    vec = eng.vec_env
    for _ in range(8):
        want = vec.features_u8().reshape(2, 96, 96, 8, 4)
        ids = np.stack([e._action_history for e in vec.envs])
        eng.move()
        np.testing.assert_array_equal(eng._ring.permute(0, 2, 3, 1, 4).numpy(), want[..., 1:])
        planes = eng.features().numpy()[..., 0::4]
        np.testing.assert_array_equal(planes, np.broadcast_to(ids[:, None, None, :], planes.shape))
        np.testing.assert_array_equal(np.clip(planes * 255.0, 0, 255).astype(np.uint8),
                                      want[..., 0])
        vec.reset_done()


# ---------------------------------------------------------------- collector
def _moves(batch, length, moves, seed):
    """A FakeALE drive's moves as (port, JAX) HostMoveOutputs."""
    vec = atari.AtariVecEnv(batch, seed=seed, ale_factory=_fake(length))
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(moves):
        frames = vec.newest_frames().copy()
        lives = np.asarray([e.lives_history[-1] for e in vec.envs])
        actions = rs.randint(0, 4, (batch,)).astype(np.int32)
        rewards = vec.step(actions)
        fields = dict(
            action=actions,
            policy_target=rs.random_sample((batch, 18)).astype(np.float32),
            root_value=rs.random_sample(batch).astype(np.float32),
            reward=rewards, frames=frames, done=vec.terminals(),
            eval_score=np.asarray([e.eval_score() for e in vec.envs], np.float32),
            lives_lost=np.asarray([e.lives_history[-1] for e in vec.envs]) < lives)
        out.append((HostMoveOutput(**fields), JMove(**fields)))
        vec.reset_done()
    return out


@pytest.mark.parametrize("seqlen,length", [(8, 240), (4, 48), (0, 40)])
def test_collector_matches_jax(seqlen, length):
    """The same moves into both collectors: the same records, field by
    field (continuation chunks with their lead frames and actions, terminal
    chunks, resets), the same slots to reset; every record's trainable
    range inside its stored arrays (``tests/test_atari.py``'s chunking
    check)."""
    over = dict(zero_actor_intermediate_sequence_length=seqlen, learner_n_step_return=2,
                learner_muzero_unrolling_step=2)
    cfg, jcfg = default_config("atari", **over), j_default("atari", **over)
    col = AtariTrajectoryCollector(cfg, atari.atari_spec(), 2)
    jcol = JCollector(jcfg, jatari.atari_spec(), 2)
    records = 0
    leads = set()
    for mv, (out, jout) in enumerate(_moves(2, length, 90, seed=seqlen)):
        got, reset = col.add_moves(out)
        want, jreset = jcol.add_moves(jout)
        assert reset == jreset and len(got) == len(want), f"move {mv}"
        for fg, jfg in zip(got, want):
            assert (fg.slot, fg.abs_start, fg.players) == (jfg.slot, jfg.abs_start, jfg.players)
            r, jr = fg.record, jfg.record
            for name in ("actions", "policy", "values", "rewards", "frames", "lead_actions",
                         "lives_lost"):
                np.testing.assert_array_equal(getattr(r, name), getattr(jr, name),
                                              err_msg=f"move {mv} {name}")
                assert getattr(r, name).dtype == getattr(jr, name).dtype
            assert (r.frame_lead, r.result, r.data_range, r.features) == (
                jr.frame_lead, jr.result, jr.data_range, jr.features)
            lo, hi = r.data_range
            assert 0 <= lo <= hi < r.length
            leads.add(r.frame_lead > 0)
            records += 1
            # the record line: the JAX loop's tags in its order and format
            extra = {"SD": str(7 + fg.slot)}
            if jfg.abs_start:
                extra["OFF"] = str(jfg.abs_start)
            extra["LL"] = "".join("1" if x else "0" for x in jr.lives_lost)
            want_line = jserialize_game(jatari.atari_spec().name, jr, 96, jfg.players,
                                        model_file="weight_iter_3", extra_tags=extra)
            obs_tag = f"OBS[{jobs.pack_observations(jr.frames[jr.frame_lead:])}]"
            want_line = want_line[:-1] + obs_tag + want_line[-1:]
            assert atari_record_line(atari.atari_spec(), fg, 7 + fg.slot, True,
                                     "weight_iter_3") == want_line
    assert records >= 3
    if seqlen:
        assert leads == {True, False}


# ---------------------------------------------------------------------- obs
def test_obs_payload_is_byte_equal_to_jax():
    frames = np.random.default_rng(0).integers(0, 256, size=(5, 96, 96, 3)).astype(np.uint8)
    payload = obs.pack_observations(frames)
    assert payload == jobs.pack_observations(frames)
    np.testing.assert_array_equal(obs.unpack_observations(payload), frames)
    np.testing.assert_array_equal(jobs.unpack_observations(payload), frames)
    assert obs.compress_obs(b"abc") == jobs.compress_obs(b"abc")
    assert obs.decompress_obs(obs.compress_obs(b"abc")) == b"abc"


def test_rows_needed_follows_the_env_length():
    """With chunks: seqlen + 2 margins + 10 rows a record; without
    (seqlen 0): the env's longest game, not a fixed 30,000 rows."""
    cfg = default_config("atari", zero_actor_intermediate_sequence_length=200,
                         learner_muzero_unrolling_step=5, learner_n_step_return=10,
                         zero_replay_buffer=7, zero_num_games_per_iteration=128)
    assert rows_needed(cfg, 27000) == 240 * (7 * 128 + 2)
    flat = cfg.replace(zero_actor_intermediate_sequence_length=0)
    assert rows_needed(flat, 27000) == 27010 * (7 * 128 + 2)
    assert rows_needed(flat, 100) == 110 * (7 * 128 + 2)


# -------------------------------------------------------------- zero loop
def _loop_cfg(**over):
    base = dict(_TINY, zero_num_parallel_games=2, zero_num_games_per_iteration=2,
                zero_end_iteration=1, learner_training_step=2, learner_training_display_step=2,
                learner_batch_size=4, learner_muzero_unrolling_step=2, learner_n_step_return=2,
                zero_actor_intermediate_sequence_length=0, program_auto_seed=False)
    base.update(over)
    return default_config("atari", **base)


def test_zero_loop_atari_smoke(tmp_path):
    """One iteration over FakeALE: records with SD, OBS and LL tags, SGD on
    stacks assembled from the frame window, a checkpoint; ``resume`` in a
    fresh loop rebuilds the buffer and the window from the OBS tags
    (``tests/test_atari.py::test_zero_loop_atari_smoke``)."""
    cfg = _loop_cfg()
    run_dir = str(tmp_path / "run")
    loop = ZeroLoop(cfg, run_dir, device="cpu", ale_factory=_fake(24))
    assert loop.frame_window is not None and loop.buffer is not None
    loop.run()
    loop.close()
    lines = open(f"{run_dir}/sgf/1.sgf").read().strip().splitlines()
    assert len(lines) == 2
    for line in lines:
        assert "SD[" in line and "OBS[" in line and "LL[" in line
        tags, rec = game_record_from_string(line, 18)
        frames = obs.unpack_observations(tags["OBS"])
        assert frames.shape == (rec.length, 96, 96, 3)
    assert os.path.exists(f"{run_dir}/model/weight_iter_2.ckpt")
    loop2 = ZeroLoop(cfg, run_dir, device="cpu", ale_factory=_fake(24))
    assert loop2.resume() == 1
    assert len(loop2.buffer) == len(loop.buffer)
    for a, b in zip(loop.buffer.games, loop2.buffer.games):
        np.testing.assert_array_equal(a.actions, b.actions)
        assert a.frame_lead == b.frame_lead == 0
        np.testing.assert_array_equal(a.frames, b.frames)
        np.testing.assert_array_equal(a.lives_lost, b.lives_lost)
        assert b in loop2.frame_window
    loop2.optimize_iteration(2)  # trains on the rebuilt window
    loop2.close()


def test_zero_loop_atari_collector_persists_across_iterations(tmp_path):
    """Episodes that span an iteration keep their prefix: iteration 2 emits
    the terminal chunks of iteration 1's episodes with OFF[4], 8 moves each
    (``tests/test_atari.py``'s round-4 regression)."""
    cfg = _loop_cfg(zero_num_games_per_iteration=4, zero_end_iteration=2,
                    zero_actor_intermediate_sequence_length=4)
    run_dir = str(tmp_path / "run")
    loop = ZeroLoop(cfg, run_dir, device="cpu", ale_factory=_fake(48))
    loop.run()
    loop.close()
    it1 = open(f"{run_dir}/sgf/1.sgf").read().strip().splitlines()
    it2 = open(f"{run_dir}/sgf/2.sgf").read().strip().splitlines()
    assert len(it1) == 4 and len(it2) == 4
    assert all("OFF[" not in line for line in it1)
    terminal = [ln for ln in it2 if "OFF[4]" in ln]
    assert len(terminal) == 2
    assert all(len(re.findall(r";B\[", ln)) == 8 for ln in terminal)


def test_run_selfplay_host_mode(tmp_path):
    """``-mode sp`` for Atari: records with SD, LL and OBS tags that parse
    back, exactly ``num_games`` of them; through the CLI without ``ale_py``
    the real ALE's ImportError."""
    cfg = _loop_cfg()
    out = tmp_path / "games.sgf"
    run_selfplay_host(cfg, 3, str(out), ale_factory=_fake(16), device="cpu")
    lines = open(out).read().strip().splitlines()
    assert len(lines) == 3
    for line in lines:
        assert "SD[" in line and "OBS[" in line and "LL[" in line
        tags, rec = game_record_from_string(line, 18)
        assert obs.unpack_observations(tags["OBS"]).shape == (rec.length, 96, 96, 3)
    try:
        import ale_py  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError, match="ale_py"):
            main(["-mode", "sp", "-conf_str", "env_name=atari", "-platform", "cpu"])

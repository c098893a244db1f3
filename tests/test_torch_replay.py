"""The port's records and replay held against the JAX package's:
``selfplay/collector.py``, ``selfplay/record.py``, the native codec and
``learner/replay.py``, plus the small helpers the train step takes from
``utils/`` (plane unpacking, value transforms, the trainer's rotations).

Everything here is exact: the same ``ScanMoves`` chunks (numpy, and for
the port also CPU tensors) give identical ``GameRecord``s, the record
strings are byte-identical — the port's native codec, the port's plain
writer, and the JAX package's native codec, which its zero loop writes
with — and the same ``RandomState`` gives identical sampled batches, with
PER off and on, after a priority refresh, with n-step targets, and on the
per-game path that windows past the flat cache's size take. The value transforms are
float32 arithmetic on both sides, held within 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minizero_tpu import native as jnative
from minizero_tpu.config import default_config as jdefault_config
from minizero_tpu.learner.replay import GameRecord as JGameRecord
from minizero_tpu.learner.replay import ReplayBuffer as JReplayBuffer
from minizero_tpu.learner.train import _augment_rotation as j_augment_rotation
from minizero_tpu.selfplay.collector import TrajectoryCollector as JCollector
from minizero_tpu.selfplay.record import game_record_from_string as jgame_record_from_string
from minizero_tpu.selfplay.record import serialize_game as jserialize_game
from minizero_tpu.utils.bitpack import pack_planes_np
from minizero_tpu.utils.bitpack import unpack_planes as junpack_planes
from minizero_tpu.utils.transforms import to_discrete_value as jto_discrete_value
from minizero_tpu.utils.transforms import transform_value as jtransform_value
from minizero_tpu_torch import native
from minizero_tpu_torch.config import default_config
from minizero_tpu_torch.envs import make_env
from minizero_tpu_torch.learner.replay import GameRecord, ReplayBuffer
from minizero_tpu_torch.selfplay.collector import TrajectoryCollector
from minizero_tpu_torch.selfplay.engine import MoveOutput, ScanMoves
from minizero_tpu_torch.selfplay.record import game_record_from_string, serialize_game
from minizero_tpu_torch.utils import rotation as trot
from minizero_tpu_torch.utils.bitpack import unpack_planes
from minizero_tpu_torch.utils.transforms import to_discrete_value, transform_value

GO = dict(env_board_size=5, zero_disable_resign_ratio=0.3)


def _cfgs(env_name="go", **over):
    over = dict(GO if env_name == "go" else {}, **over)
    return jdefault_config(env_name, **over), default_config(env_name, **over)


def _chunks(spec, batch, moves, n_chunks, seed):
    """Synthetic ``move_scan`` chunks with finish events inside chunks and
    games that run across chunk boundaries; some resign (the move is not
    recorded), some end, some slots finish twice in a chunk."""
    rng = np.random.default_rng(seed)
    a = spec.action_size
    pc = -(-spec.num_input_channels // 8)
    out = []
    for _ in range(n_chunks):
        policy = rng.random((moves, batch, a)) * (rng.random((moves, batch, a)) > 0.6)
        policy[..., 0] += 1e-3
        policy = (policy / policy.sum(-1, keepdims=True)).astype(np.float16)
        events = rng.random((moves, batch))
        resigned = events < 0.08
        ended = (events > 0.85) & ~resigned
        resigned[0, 0] = True  # a resignation as the first move of a chunk
        out.append(ScanMoves(
            action=rng.integers(0, a, (moves, batch)).astype(np.int32),
            turn=rng.integers(1, 3, (moves, batch)).astype(np.int32),
            policy_target=policy,
            root_value=rng.uniform(-1, 1, (moves, batch)).astype(np.float32),
            reward=np.zeros((moves, batch), np.float32),
            resign=resigned | (rng.random((moves, batch)) < 0.05),
            features=rng.integers(0, 256, (moves, batch, spec.input_height, spec.input_width, pc),
                                  dtype=np.uint8),
            done=ended,
            eval_score=rng.choice([-1.0, 0.0, 1.0], (moves, batch)).astype(np.float32),
            resign_score=rng.choice([-1.0, 1.0], (moves, batch)).astype(np.float32),
            resigned=resigned,
            ended=ended,
        ))
    return out


def _as_tensors(sm):
    return ScanMoves(*[torch.as_tensor(x) for x in sm])


def _assert_same_record(got, want, what):
    for f in ("actions", "policy", "values", "rewards", "features"):
        g, w = getattr(got, f), getattr(want, f)
        assert g.dtype == w.dtype and g.shape == w.shape, f"{what}: {f}"
        np.testing.assert_array_equal(g, w, err_msg=f"{what}: {f}")
    assert got.result == want.result and got.data_range == want.data_range, what


def _collected(tensors):
    jcfg, tcfg = _cfgs()
    spec = make_env(tcfg).spec
    jcol = JCollector(jcfg, spec, 6, seed=3)
    tcol = TrajectoryCollector(tcfg, spec, 6, seed=3)
    np.testing.assert_array_equal(jcol.enable_resign_flags(), tcol.enable_resign_flags())
    games = []
    for i, sm in enumerate(_chunks(spec, 6, 5, 4, seed=1)):
        want = jcol.add_scan(sm)
        got = tcol.add_scan(_as_tensors(sm) if tensors else sm)
        assert len(got) == len(want), f"chunk {i}"
        for g, w in zip(got, want):
            assert (g.slot, g.players) == (w.slot, w.players), f"chunk {i}"
            _assert_same_record(g.record, w.record, f"chunk {i} slot {g.slot}")
            games.append(g)
    return spec, games


@pytest.mark.parametrize("tensors", [False, True])
def test_add_scan_gives_the_jax_records(tensors):
    _, games = _collected(tensors)
    assert len(games) > 10
    lengths = {g.record.length for g in games}
    assert 0 in lengths or min(lengths) <= 1  # resign at the start of a game
    assert max(lengths) > 5  # games that ran across chunk boundaries


def test_add_moves_gives_the_jax_records():
    jcfg, tcfg = _cfgs()
    spec = make_env(tcfg).spec
    jcol = JCollector(jcfg, spec, 6, seed=4)
    tcol = TrajectoryCollector(tcfg, spec, 6, seed=4)
    (sm,) = _chunks(spec, 6, 12, 1, seed=2)
    n = 0
    for m in range(12):
        out = MoveOutput(action=sm.action[m], turn=sm.turn[m], policy_target=sm.policy_target[m],
                         root_value=sm.root_value[m], reward=sm.reward[m], resign=sm.resign[m],
                         features=sm.features[m], states=None, done=sm.done[m],
                         eval_score=sm.eval_score[m], resign_score=sm.resign_score[m])
        want, want_reset = jcol.add_moves(out)
        got, got_reset = tcol.add_moves(MoveOutput(*[
            torch.as_tensor(x) if isinstance(x, np.ndarray) else x for x in out]))
        np.testing.assert_array_equal(got_reset, want_reset)
        for g, w in zip(got, want):
            assert (g.slot, g.players) == (w.slot, w.players)
            _assert_same_record(g.record, w.record, f"move {m}")
        n += len(got)
    assert n > 3


def test_record_strings_are_byte_identical():
    """The port's native codec, the port's plain writer and the JAX
    package's native codec write the same line; both parsers read it back
    to the same record."""
    assert native.load() is not None, native.load_error()
    assert jnative.load() is not None
    spec, games = _collected(False)
    for i, g in enumerate(games):
        rec = g.record
        if i % 3 == 0:
            rec = dataclasses.replace(rec, data_range=(1, max(1, rec.length - 1)))
        kwargs = dict(model_file=f"weight_iter_{i}", extra_tags={"SD": str(i)} if i % 4 == 0 else None)
        jrec = JGameRecord(**{f.name: getattr(rec, f.name) for f in dataclasses.fields(rec)})
        want = jserialize_game(spec.name, jrec, spec.board_size, g.players, **kwargs)
        got = serialize_game(spec.name, rec, spec.board_size, g.players, **kwargs)
        plain = serialize_game(spec.name, rec, spec.board_size, g.players, plain=True, **kwargs)
        assert got == want, f"game {i}: native"
        assert plain == want, f"game {i}: plain"
        jtags, jparsed = jgame_record_from_string(want, spec.action_size)
        tags, parsed = game_record_from_string(got, spec.action_size)
        assert tags == jtags
        for f in ("actions", "policy", "values", "rewards", "features"):
            np.testing.assert_array_equal(getattr(parsed, f), getattr(jparsed, f), err_msg=f)
        assert (parsed.result, parsed.data_range) == (jparsed.result, jparsed.data_range)
        np.testing.assert_array_equal(parsed.actions, rec.actions)
        # the native parser reads the move stream the same way
        starts = [k for k in (got.find(";B["), got.find(";W[")) if k >= 0]
        moves = got[min(starts):-1] if starts else ""
        acts, players, pol, vals, rews = native.parse_moves(moves, rec.length + 1, spec.action_size)
        np.testing.assert_array_equal(acts, rec.actions)
        np.testing.assert_array_equal(players, np.asarray(g.players, np.int8))
        np.testing.assert_array_equal(vals, parsed.values)  # %g keeps 6 digits
        np.testing.assert_array_equal(pol.astype(np.float16), rec.policy)


def test_codec_builds_into_the_build_dir():
    lib = native.load()
    assert lib is not None, native.load_error()
    path = native.library_path()
    assert path.startswith(native.BUILD_DIR) and path.endswith(".so")


# ------------------------------------------------------------------ replay
def _random_record(rng, spec, length):
    a = spec.action_size
    policy = rng.random((length, a)).astype(np.float32)
    policy /= policy.sum(-1, keepdims=True)
    c = -(-spec.num_input_channels // 8)
    return GameRecord(
        actions=rng.integers(0, a, length).astype(np.int32),
        policy=policy.astype(np.float16),
        values=rng.uniform(-1, 1, length).astype(np.float32),
        rewards=rng.uniform(0, 2, length).astype(np.float32),
        features=rng.integers(0, 256, (length, spec.input_height, spec.input_width, c),
                              dtype=np.uint8),
        result=float(rng.choice([-1.0, 0.0, 1.0])),
    )


def _buffers(over, n_games=7, per_game_path=False, seed=0):
    jcfg, tcfg = _cfgs(**over)
    spec = make_env(tcfg).spec
    jbuf, tbuf = JReplayBuffer(jcfg, spec), ReplayBuffer(tcfg, spec)
    if per_game_path:  # the path of windows past the flat cache's size
        jbuf.FLAT_FEATURE_CACHE_MAX_BYTES = tbuf.FLAT_FEATURE_CACHE_MAX_BYTES = 0
    rng = np.random.default_rng(seed)
    for i in range(n_games):
        length = int(rng.integers(1, 12))
        rec = _random_record(rng, spec, length)
        if i % 3 == 1:
            rec.data_range = (min(1, length - 1), length - 1)
        if over.get("learner_use_per") and i % 2 == 0:
            rec.priorities = rng.uniform(0.1, 1, length).astype(np.float32)
        fields = {f.name: getattr(rec, f.name) for f in dataclasses.fields(rec)}
        if over.get("learner_n_step_return"):
            fields["lives_lost"] = rng.random(length) < 0.2
        tbuf.add_game(GameRecord(**fields))
        jbuf.add_game(JGameRecord(**{k: v.copy() if isinstance(v, np.ndarray) else v
                                     for k, v in fields.items()}))
    return jbuf, tbuf


def _assert_same_batch(got, want, what):
    assert sorted(got) == sorted(want), what
    for k in want:
        assert got[k].dtype == want[k].dtype, f"{what}: {k}"
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{what}: {k}")


SAMPLING = {
    "uniform": {},
    "per": dict(learner_use_per=True, learner_per_alpha=0.6, learner_per_init_beta=0.4),
    "per_nstep": dict(learner_use_per=True, learner_n_step_return=3,
                      actor_mcts_reward_discount=0.9, learner_muzero_unrolling_step=3),
    "capacity": dict(zero_replay_buffer=1, zero_num_games_per_iteration=4),
}


@pytest.mark.parametrize("per_game_path", [False, True])
@pytest.mark.parametrize("case", sorted(SAMPLING))
def test_sampled_batches_are_identical(case, per_game_path):
    over = SAMPLING[case]
    jbuf, tbuf = _buffers(over, per_game_path=per_game_path)
    assert len(tbuf) == len(jbuf) and tbuf.num_data == jbuf.num_data
    jrng, trng = np.random.RandomState(5), np.random.RandomState(5)
    for rnd in range(3):
        for kind in ("sample_alphazero", "sample_muzero"):
            want = getattr(jbuf, kind)(9, jrng)
            got = getattr(tbuf, kind)(9, trng)
            _assert_same_batch(got, want, f"{case} round {rnd} {kind}")
            if over.get("learner_use_per"):
                new_values = np.random.default_rng(rnd).uniform(-1, 1, 9).astype(np.float32)
                jbuf.refresh_priorities(want["sampled_index"], new_values)
                tbuf.refresh_priorities(got["sampled_index"], new_values)
                for pj, pt in zip(jbuf.position_priorities, tbuf.position_priorities):
                    np.testing.assert_array_equal(pt, pj)
                assert tbuf.game_priorities == jbuf.game_priorities
    jbuf.update_priority(np.array([[0, 0], [1, 0]]), np.array([0.5, 2.0]))
    tbuf.update_priority(np.array([[0, 0], [1, 0]]), np.array([0.5, 2.0]))
    _assert_same_batch(tbuf.sample_muzero(5, trng), jbuf.sample_muzero(5, jrng), f"{case} last")


def test_frames_schema_sampling_raises():
    """Frames-schema records (Atari) sample like JAX's: ``sample_muzero``
    returns the targets and the (game, position) pairs without features
    (the loop assembles them from its frame window), on the flat and on the
    per-game path; ``sample_alphazero`` raises, as in JAX."""
    for per_game_path in (False, True):
        jcfg, tcfg = _cfgs(learner_n_step_return=3, learner_muzero_unrolling_step=3)
        spec = make_env(tcfg).spec
        jbuf, tbuf = JReplayBuffer(jcfg, spec), ReplayBuffer(tcfg, spec)
        if per_game_path:
            jbuf.FLAT_FEATURE_CACHE_MAX_BYTES = tbuf.FLAT_FEATURE_CACHE_MAX_BYTES = 0
        rng = np.random.default_rng(0)
        for i in range(5):
            rec = _random_record(rng, spec, 4 + i)
            rec.features = None
            rec.frames = np.zeros((4 + i, 5, 5, 3), np.uint8)
            jbuf.add_game(JGameRecord(**dataclasses.asdict(rec)))
            tbuf.add_game(rec)
        assert tbuf.frames_mode and jbuf.frames_mode
        got = tbuf.sample_muzero(6, np.random.RandomState(1))
        want = jbuf.sample_muzero(6, np.random.RandomState(1))
        assert "features" not in got
        _assert_same_batch(got, want, f"frames schema, per-game path {per_game_path}")
        with pytest.raises(NotImplementedError, match="sample_muzero"):
            tbuf.sample_alphazero(2, np.random.RandomState(0))


# ----------------------------------------------------- the trainer's helpers
@pytest.mark.parametrize("channels", [4, 18, 17])
def test_unpack_planes_matches_jax(channels):
    rng = np.random.default_rng(channels)
    planes = (rng.random((3, 5, 5, channels)) > 0.5).astype(np.uint8)
    packed = pack_planes_np(planes)
    want = np.asarray(junpack_planes(jnp.asarray(packed), channels))
    got = unpack_planes(torch.as_tensor(packed), channels)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), planes.astype(np.float32))


@pytest.mark.parametrize("value_size", [601, 21])
def test_value_transforms_match_jax(value_size):
    rng = np.random.default_rng(value_size)
    v = np.concatenate([rng.uniform(-500, 500, 64), [0.0, -0.0, 1.0, -3.0, 2.5]]).astype(np.float32)
    np.testing.assert_allclose(transform_value(torch.as_tensor(v)).numpy(),
                               np.asarray(jtransform_value(jnp.asarray(v))), rtol=0, atol=1e-6)
    h = np.asarray(jtransform_value(jnp.asarray(v)))
    np.testing.assert_allclose(to_discrete_value(torch.as_tensor(h), value_size).numpy(),
                               np.asarray(jto_discrete_value(jnp.asarray(h), value_size)),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("env_name", ["go", "tictactoe"])
def test_training_rotations_match_jax(env_name):
    """Features, policy targets ([B, A] and [B, K+1, A]) and MuZero actions
    rotated as the JAX step's ``_augment_rotation`` rotates them."""
    from minizero_tpu.envs import make_env as jmake_env

    jcfg, tcfg = _cfgs(env_name)
    jenv, tenv = jmake_env(jcfg), make_env(tcfg)
    spec = tenv.spec
    b, a = 16, spec.action_size
    rng = np.random.default_rng(7)
    feats = rng.random((b, spec.input_height, spec.input_width, spec.num_input_channels)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    rots = torch.as_tensor(np.asarray(jax.random.randint(key, (b,), 0, 8)))
    for pshape in ((b, a), (b, 3, a)):
        policy = rng.random(pshape).astype(np.float32)
        actions = rng.integers(0, a, (b, 2)).astype(np.int32)
        jf, jp, ja = j_augment_rotation(jenv, key, jnp.asarray(feats), jnp.asarray(policy),
                                        jnp.asarray(actions))
        np.testing.assert_array_equal(
            trot.rotate_planes_batch(torch.as_tensor(feats), rots, spec.board_size).numpy(),
            np.asarray(jf))
        np.testing.assert_array_equal(
            trot.rotate_policy_labels_batch(torch.as_tensor(policy), rots, spec.board_size).numpy(),
            np.asarray(jp))
        np.testing.assert_array_equal(
            trot.rotate_actions_batch(torch.as_tensor(actions), rots, spec.board_size, a).numpy(),
            np.asarray(ja))

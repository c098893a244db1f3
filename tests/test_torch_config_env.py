"""The PyTorch port's config, utils and Go env held against the JAX package.

Every comparison here is exact: config presets and their ``.cfg`` text,
the rotation / bit-packing helpers, and Go random playouts (board, legal
mask, features, Zobrist hashes, block labels, liberties, terminal flag and
Tromp-Taylor score after every move). The port runs on the CPU.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minizero_tpu import config as jcfg
from minizero_tpu.envs.go import GoEnv as JGoEnv
from minizero_tpu.utils import bitpack as jbitpack
from minizero_tpu.utils import rotation as jrot
from minizero_tpu_torch import config as tcfg
from minizero_tpu_torch.envs import available_envs, make_env
from minizero_tpu_torch.envs.go import GoEnv as TGoEnv
from minizero_tpu_torch.utils import bitpack as tbitpack
from minizero_tpu_torch.utils import rotation as trot


@pytest.mark.parametrize("algo", ["az", "mz", "gaz", "gmz"])
@pytest.mark.parametrize("env_name", ["go", "tictactoe", "atari", "puzzle2048", "othello"])
def test_config_presets_and_to_string_match(algo, env_name):
    is_atari = env_name == "atari"
    over_j = dict(jcfg.algorithm_preset(algo, is_atari=is_atari))
    over_t = dict(tcfg.algorithm_preset(algo, is_atari=is_atari))
    assert over_j == over_t
    cj = jcfg.default_config(env_name, **over_j)
    ct = tcfg.default_config(env_name, **over_t)
    assert dataclasses.asdict(cj) == dataclasses.asdict(ct)
    assert cj.to_string() == ct.to_string()
    conf = "actor_num_simulation=32:learner_batch_size=64:actor_use_gumbel=true:env_go_komi=6.5"
    assert (dataclasses.asdict(cj.load_string(conf))
            == dataclasses.asdict(ct.load_string(conf)))


def test_env_registry_go_only():
    # every family of the JAX registry builds; Atari's real ALE needs the
    # optional ale_py package, and without it raises ImportError as in JAX
    from minizero_tpu.envs import _TABLE as j_table
    from minizero_tpu.envs import make_env as j_make_env

    assert available_envs() == sorted(j_table) and len(available_envs()) == 22
    for name in available_envs():
        cfg = tcfg.default_config(name)
        if name == "atari":
            try:
                import ale_py  # noqa: F401
            except ImportError:
                with pytest.raises(ImportError, match="ale_py"):
                    make_env(cfg)
            continue
        assert make_env(cfg).spec.action_size == j_make_env(jcfg.default_config(name)).spec.action_size
    env = make_env(tcfg.default_config("go"))
    assert env.spec.action_size == 82 and env.spec.num_input_channels == 18


@pytest.mark.parametrize("board_size", [5, 9])
def test_rotation_and_bitpack_match(board_size):
    rng = np.random.default_rng(board_size)
    np.testing.assert_array_equal(jrot.position_rotation_table(board_size),
                                  trot.position_rotation_table(board_size))
    a = board_size * board_size + 1
    np.testing.assert_array_equal(jrot.action_rotation_table(board_size, a),
                                  trot.action_rotation_table(board_size, a))
    b = 16
    planes = rng.integers(0, 2, size=(b, board_size, board_size, 18)).astype(np.float32)
    rots = rng.integers(0, 8, size=(b,)).astype(np.int32)
    want = np.asarray(jrot.rotate_planes_batch(jnp.asarray(planes), jnp.asarray(rots), board_size))
    got = trot.rotate_planes_batch(torch.from_numpy(planes), torch.from_numpy(rots), board_size)
    np.testing.assert_array_equal(want, got.numpy())
    pol = rng.normal(size=(b, a)).astype(np.float32)
    want = np.asarray(jrot.rotate_action_array_batch(jnp.asarray(pol), jnp.asarray(rots), board_size))
    got = trot.rotate_action_array_batch(torch.from_numpy(pol), torch.from_numpy(rots), board_size)
    np.testing.assert_array_equal(want, got.numpy())
    want = np.asarray(jbitpack.pack_planes(jnp.asarray(planes)))
    np.testing.assert_array_equal(want, tbitpack.pack_planes(torch.from_numpy(planes)).numpy())


def _jax_batch(env, batch):
    one = env.init()
    return jax.tree_util.tree_map(lambda x: jnp.broadcast_to(x, (batch,) + x.shape), one)


def _check_state(js, ts, step):
    for f in dataclasses.fields(ts):
        want = np.asarray(getattr(js, f.name))
        got = getattr(ts, f.name).numpy()
        assert want.shape == got.shape, f"move {step}: {f.name} shape"
        np.testing.assert_array_equal(want.astype(np.int64), got.astype(np.int64),
                                      err_msg=f"move {step}: field {f.name}")


@pytest.mark.parametrize("board_size,moves,batch", [(5, 150, 24), (9, 120, 24)])
def test_go_random_playouts_exact(board_size, moves, batch):
    """Random legal playouts (passes included, so games end and get scored)
    step both envs in lock-step; every state field, the features, the
    terminal flag and the score must be equal after every move."""
    jenv, tenv = JGoEnv(board_size=board_size), TGoEnv(board_size=board_size)
    rng = np.random.default_rng(1000 + board_size)
    jstep = jax.jit(jax.vmap(jenv.step))
    jfeat = jax.jit(jax.vmap(jenv.features))
    jterm = jax.jit(jax.vmap(jenv.is_terminal))
    jscore = jax.jit(jax.vmap(jenv.eval_score))
    js = _jax_batch(jenv, batch)
    ts = tenv.init(batch, device="cpu")
    _check_state(js, ts, 0)
    nn = board_size * board_size
    for step in range(1, moves + 1):
        legal = tenv.legal_mask(ts).numpy()
        # random legal move; pass with probability 0.1 (always legal)
        scores = rng.random(legal.shape) * legal
        scores[:, nn] = np.where(rng.random(batch) < 0.1, 2.0, 1e-3)
        action = scores.argmax(-1).astype(np.int32)
        js = jstep(js, jnp.asarray(action))
        ts = tenv.step(ts, torch.from_numpy(action))
        _check_state(js, ts, step)
        np.testing.assert_array_equal(np.asarray(jfeat(js)), tenv.features(ts).numpy(),
                                      err_msg=f"move {step}: features")
        np.testing.assert_array_equal(np.asarray(jterm(js)), tenv.is_terminal(ts).numpy(),
                                      err_msg=f"move {step}: terminal")
        np.testing.assert_array_equal(np.asarray(jscore(js)), tenv.eval_score(ts).numpy(),
                                      err_msg=f"move {step}: score")


@pytest.mark.parametrize("method", ["init", "init_random"])
def test_go_init_puts_states_on_the_card_by_default(method):
    """``GoEnv.init`` and ``init_random`` resolve their device as every
    entry point of the port does: the card by default, raising where there
    is none (the message names ``device='cpu'``); the CPU when asked for by
    name, with the JAX package's initial state."""
    env = TGoEnv(board_size=5)
    make = getattr(env, method)
    cpu = make(2, device="cpu")
    assert {getattr(cpu, f.name).device.type for f in dataclasses.fields(cpu)} == {"cpu"}
    _check_state(_jax_batch(JGoEnv(board_size=5), 2), cpu, 0)
    if torch.cuda.is_available():
        card = make(2)
        assert {getattr(card, f.name).device.type for f in dataclasses.fields(card)} == {"cuda"}
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make(2)

"""The port's MuZero search held against the JAX package's
``make_muzero_search`` (the Pallas tree kernel in interpret mode), and the
port's MuZero self-play engine against the JAX engine, on the integer-exact
MuZero parity net of ``tests/parity_common.py`` built in both frameworks.

Noise and rotation off, select by count, float32. Three searches: Go 9x9
Gumbel MuZero n=16 and MuZero n=50 (N=51: MuZero stays on tree step B1 at
any N), both in the kernel's board regime, and the Atari regime (reward
head, discount 0.997, value rescale, average init-Q, one player) at n=50.
Tolerances (``docs/Parity.md``): root visit counts and actions exact; child
and root means 2e-4 / 1e-4 and policy targets 2e-4 (visit counts) or 2e-3
(Gumbel completed-Q) for Go; for Atari, whose values are ``invertValue``
outputs up to ~100, means within 1e-3 (~1e-5 relative), as
``tests/test_reference_parity.py:224`` holds them.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from minizero_tpu.config import algorithm_preset as j_preset
from minizero_tpu.config import default_config as j_default
from minizero_tpu.envs import make_env as j_make_env
from minizero_tpu.envs.atari import atari_spec as j_atari_spec
from minizero_tpu.search import gumbel as jgz
from minizero_tpu.search import mcts as jmcts
from minizero_tpu.selfplay.engine import SelfPlayEngine as JEngine
from minizero_tpu.selfplay.engine import search_spec_from_config as j_search_spec
from minizero_tpu.selfplay.muzero_search import make_muzero_search as j_make_muzero_search
from minizero_tpu_torch.config import algorithm_preset, default_config
from minizero_tpu_torch.envs import atari, make_env
from minizero_tpu_torch.envs.base import select_states
from minizero_tpu_torch.ops.tree_kernel import fused_tree_step
from minizero_tpu_torch.search import gumbel as gz
from minizero_tpu_torch.search import mcts
from minizero_tpu_torch.selfplay.engine import SelfPlayEngine, search_spec_from_config
from minizero_tpu_torch.selfplay.muzero_search import make_muzero_search

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from parity_common import (  # noqa: E402
    ACTION_FEATURE_CHANNELS, ACTION_OFFSET, GAME_DIMS, HIDDEN_DIMS, MZ_BIN_MOD,
    MZ_DISCRETE_SIZE, MZ_HIDDEN_CHANNELS, MZ_MOD, MZ_POLICY_SCALE, MZ_VALUE_SCALE,
    VALUE_CLAMP, jax_muzero_parity_network, muzero_parity_weights)
from test_torch_engine import _compare_moves  # noqa: E402


class TorchMuZeroParityNet(nn.Module):
    """The MuZero parity net of ``parity_common.jax_muzero_parity_network``
    in torch: integer weights, hidden states that stay integer-valued
    (mod 16), so both frameworks compute them exactly. Hidden states are
    flat ``[B, K]`` on the canonical (NCHW-flatten) index space; action
    planes come in NCHW."""

    def __init__(self, game: str = "go", atari_mode: bool = False):
        super().__init__()
        c, h, w, a = GAME_DIMS[game]
        hh, wh = HIDDEN_DIMS.get(game, (h, w))
        ca = ACTION_FEATURE_CHANNELS.get(game, 1)
        k = int(MZ_HIDDEN_CHANNELS) * hh * wh
        self.atari_mode = atari_mode
        self.in_size = c * h * w
        ws = muzero_parity_weights(game)

        def buf(name, x):
            self.register_buffer(name, torch.from_numpy(np.asarray(x)))

        if game == "atari":
            buf("ridx", ws["Ridx"])
        else:
            buf("wr", ws["Wr"].astype(np.float32).reshape(c * h * w, k))
        buf("wd", ws["Wd"].astype(np.float32))
        buf("wa", ws["Wa"].astype(np.float32).reshape(ca * hh * wh, k))
        buf("wp", ws["Wp"].astype(np.float32).reshape(k, a))
        buf("wv", ws["Wv"].astype(np.float32).reshape(k))
        buf("wvd", ws["Wvd"].astype(np.float32).reshape(k))
        buf("wrd", ws["Wrd"].astype(np.float32).reshape(k))
        buf("offset", np.arange(a, dtype=np.float32) * ACTION_OFFSET)

    @staticmethod
    def _mod16(t):
        return t - MZ_MOD * torch.floor(t / MZ_MOD)

    @staticmethod
    def _two_hot(t):
        bins = torch.clamp(t - MZ_BIN_MOD * torch.floor(t / MZ_BIN_MOD), 0, MZ_DISCRETE_SIZE - 1)
        return (bins.long()[:, None] == torch.arange(MZ_DISCRETE_SIZE, device=t.device)).float()

    def _predict(self, hidden):
        logits = (hidden @ self.wp) / MZ_POLICY_SCALE + self.offset
        out = {"policy_logit": logits, "policy": torch.softmax(logits, -1), "hidden_state": hidden}
        if self.atari_mode:
            out["value"] = self._two_hot(hidden @ self.wvd)
        else:
            out["value"] = torch.clamp((hidden @ self.wv) / MZ_VALUE_SCALE,
                                       -VALUE_CLAMP, VALUE_CLAMP)[:, None]
        return out

    def initial_inference(self, state):
        x = state.float().permute(0, 3, 1, 2).reshape(state.shape[0], self.in_size)
        if self.atari_mode:
            hidden = self._mod16(torch.round(x[:, self.ridx] * 255.0))
        else:
            hidden = self._mod16(x @ self.wr)
        return self._predict(hidden)

    def recurrent_inference(self, hidden_state, action_plane):
        ap = action_plane.float().reshape(action_plane.shape[0], -1)
        out = self._predict(self._mod16(hidden_state @ self.wd + ap @ self.wa))
        if self.atari_mode:
            out["reward"] = self._two_hot(out["hidden_state"] @ self.wrd)
        return out


def _deterministic(algo, sims, is_atari=False):
    over = dict(algorithm_preset(algo, is_atari=is_atari))
    over.update(actor_num_simulation=sims, actor_select_action_by_count=True,
                actor_use_gumbel_noise=False, actor_use_dirichlet_noise=False,
                actor_use_random_rotation_features=False)
    return over


def _go_positions(env, batch, seed):
    """Random Go openings of 0-14 moves, one per game."""
    rng = np.random.default_rng(seed)
    states = env.init(batch, device="cpu")
    lengths = rng.integers(0, 15, size=batch)
    for ply in range(int(lengths.max())):
        legal = env.legal_mask(states).numpy()
        pick = (rng.random(legal.shape) * legal).argmax(-1).astype(np.int32)
        states = select_states(torch.from_numpy(lengths > ply),
                               env.step(states, torch.from_numpy(pick)), states)
    return env.features(states), env.legal_mask(states), env.turn(states).to(torch.int32)


@pytest.mark.parametrize("game,algo,sims", [("go", "gmz", 16), ("go", "mz", 50), ("atari", "mz", 50)],
                         ids=["go-gmz16", "go-mz50", "atari-mz50"])
def test_muzero_search_matches_jax(game, algo, sims):
    is_atari = game == "atari"
    over = _deterministic(algo, sims, is_atari)
    cfg, jcfg = default_config(game, **over), j_default(game, **over)
    b = 6
    if is_atari:
        spec, jspec_env = atari.atari_spec(), j_atari_spec()
        rng = np.random.default_rng(5)
        feats = torch.from_numpy((rng.integers(0, 256, size=(b, 96, 96, 32)) / 255.0).astype(np.float32))
        legal = torch.from_numpy(rng.random((b, 18)) < 0.5)
        legal[:, 0] = True
        turns = torch.ones((b,), dtype=torch.int32)

        def planes(a):
            return atari.action_features(a, spec)

        def jplanes(a):
            return jnp.broadcast_to((jnp.arange(18) == a).astype(jnp.float32)[None, None, :],
                                    (6, 6, 18))
    else:
        env, jenv = make_env(cfg), j_make_env(jcfg)
        spec, jspec_env = env.spec, jenv.spec
        feats, legal, turns = _go_positions(env, b, seed=sims)
        planes, jplanes = env.action_features, jenv.action_features
    tspec = search_spec_from_config(cfg, spec)
    jspec = j_search_spec(jcfg, jspec_env)
    assert tspec.max_nodes == sims + 1 and tspec.value_rescale == is_atari
    assert (tspec.discount != 1.0) == is_atari and tspec.init_q_average == is_atari

    jnet, jvars = jax_muzero_parity_network(game, atari_mode=is_atari)
    jsearch = j_make_muzero_search(jnet, jspec, jplanes, spec.num_players,
                                   discrete_value=is_atari, compute_dtype=jnp.float32)
    jt = jax.jit(jsearch.search_trees)(jvars, jnp.asarray(feats.numpy()), jnp.asarray(legal.numpy()),
                                      jnp.asarray(turns.numpy()), jax.random.PRNGKey(0))

    search = make_muzero_search(TorchMuZeroParityNet(game, atari_mode=is_atari), tspec, planes,
                                spec.num_players, discrete_value=is_atari)
    before = (fused_tree_step.launches, fused_tree_step.launches_rewards)
    with torch.no_grad():
        tt = search.search_trees(feats, legal, turns)
        res = search(feats, legal, turns)
    assert (fused_tree_step.launches, fused_tree_step.launches_rewards) == before  # CPU: no kernel

    np.testing.assert_array_equal(mcts.root_children_visits(tt).numpy(),
                                  np.asarray(jax.vmap(jmcts.root_children_visits)(jt)))
    np.testing.assert_array_equal(tt.children_index.numpy(), np.asarray(jt.children_index))
    if tspec.use_gumbel:
        want_a = jax.vmap(lambda t: jgz.decide_action(jspec, t))(jt)
        want_p = jax.vmap(lambda t: jgz.improved_policy_target(jspec, t))(jt)
        np.testing.assert_array_equal(gz.decide_action(tspec, tt).numpy(), np.asarray(want_a))
    else:
        want_a = jax.vmap(jmcts.select_action_by_max_count)(jt)
        want_p = jax.vmap(jmcts.mcts_policy_target)(jt)
    np.testing.assert_array_equal(res.action.numpy(), np.asarray(want_a))
    np.testing.assert_allclose(res.policy_target.numpy(), np.asarray(want_p), rtol=0,
                               atol=2e-3 if tspec.use_gumbel else 2e-4)
    child_tol, root_tol = (1e-3, 1e-3) if is_atari else (2e-4, 1e-4)
    visited = tt.visits.numpy() > 0
    np.testing.assert_array_equal(visited, np.asarray(jt.visits) > 0)
    np.testing.assert_allclose(tt.mean.numpy()[visited], np.asarray(jt.mean)[visited], rtol=0,
                               atol=child_tol)
    np.testing.assert_allclose(res.root_value.numpy(), np.asarray(jt.mean[:, 0]), rtol=0,
                               atol=root_tol)
    np.testing.assert_allclose(tt.reward.numpy(), np.asarray(jt.reward), rtol=0, atol=1e-5)
    if is_atari:  # the reward regime was exercised
        assert np.abs(tt.reward.numpy()).max() > 0


def test_muzero_engine_moves_match_jax_engine():
    """The whole slice on the CPU: Go 9x9 Gumbel MuZero (n=6, sample size 4)
    through both engines' ``move``: actions, stepped boards, features and
    finish signals equal, policy targets and root values within the bounds
    of ``tests/test_torch_engine.py``."""
    over = _deterministic("gmz", 6)
    over.update(actor_gumbel_sample_size=4)
    assert dict(j_preset("gmz")) == dict(algorithm_preset("gmz"))
    jcfg = j_default("go", **over)
    jnet, jvars = jax_muzero_parity_network("go")
    jeng = JEngine(j_make_env(jcfg), jcfg, jnet, use_bf16=False)
    assert jeng.is_muzero and not jeng.use_rotation

    cfg = default_config("go", **over)
    eng = SelfPlayEngine(make_env(cfg), cfg, TorchMuZeroParityNet(), use_bf16=False, device="cpu")
    assert eng.is_muzero and not eng.use_tree_kernel_v2 and not eng.use_rotation
    _compare_moves(jeng, jvars, eng, 3)


def test_muzero_engine_stays_on_tree_step_b1_at_large_n():
    """MuZero never takes the large-N (v2) loop, whatever N is, and its
    ``move_scan`` plays legal moves; rotation is never drawn for MuZero."""
    over = _deterministic("mz", 60)
    over.update(actor_use_random_rotation_features=True)
    cfg = default_config("go", **over)
    env = make_env(cfg)
    eng = SelfPlayEngine(env, cfg, TorchMuZeroParityNet(), use_bf16=False, device="cpu",
                         _force_kernel_v2=True)
    assert eng.is_muzero and not eng.use_tree_kernel_v2 and not eng.use_rotation
    states = eng.init_batch(3)
    legal = env.legal_mask(states)
    scan, _, _, _ = eng.move_scan(states, num_moves=2)
    assert bool(legal[torch.arange(3), scan.action[0].long()].all())
    trees = eng.search_trees(states)
    assert trees.visits.shape == (3, 61) and bool((trees.visits[:, 0] == 61).all())

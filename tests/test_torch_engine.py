"""The whole slice: the port's ``SelfPlayEngine`` against the JAX engine's
kernel path (the Pallas tree kernel in interpret mode), move by move.

Config of ``tests/test_tree_kernel.py:163-165`` (Gumbel AlphaZero, n=6,
sample size 4, Go 9x9, select by count), and the same with plain AlphaZero,
with root noise and feature rotation off, float32, and the integer-exact parity net
(``tests/parity_common.py``) built in both frameworks. Actions and the
stepped boards must be equal; policy targets and root values within the
bounds of that test (the two paths sum in different orders).

The large-N loop (tree step B2 + row gather B3 over the packed state blob)
is held against the JAX engine's v2 path in the same way: forced at n=10
(``tests/test_tree_kernel_v2.py:147``) and taken by dispatch at n=50.
"""

import os
import sys

import jax
import numpy as np
import pytest
import torch
from torch import nn

from minizero_tpu.config import algorithm_preset as j_preset
from minizero_tpu.config import default_config as j_default
from minizero_tpu.envs import make_env as j_make_env
from minizero_tpu.selfplay.engine import SelfPlayEngine as JEngine
from minizero_tpu_torch.config import algorithm_preset, default_config
from minizero_tpu_torch.envs import make_env
from minizero_tpu_torch.models.factory import create_network, init_network
from minizero_tpu_torch.ops.gather_rows import gather_rows
from minizero_tpu_torch.ops.tree_kernel import fused_tree_step
from minizero_tpu_torch.ops.tree_kernel_v2 import fused_tree_step_v2
from minizero_tpu_torch.selfplay.engine import SelfPlayEngine

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from parity_common import (  # noqa: E402
    ACTION_OFFSET, POLICY_SCALE, VALUE_CLAMP, VALUE_SCALE, jax_parity_network, parity_weights)


class TorchParityNet(nn.Module):
    """The parity net of ``parity_common.jax_parity_network`` in torch:
    integer weights, so both frameworks' logits and values are exact."""

    def __init__(self, game: str = "go"):
        super().__init__()
        wp, wv = parity_weights(game)
        self.register_buffer("wp", torch.from_numpy(wp.astype(np.float32)))
        self.register_buffer("wv", torch.from_numpy(wv.astype(np.float32)))

    def forward(self, state):
        x = state.float()
        a = self.wp.shape[-1]
        logits = (torch.einsum("bhwc,chwa->ba", x, self.wp) / POLICY_SCALE
                  + torch.arange(a, dtype=torch.float32) * ACTION_OFFSET)
        value = torch.clamp(torch.einsum("bhwc,chw->b", x, self.wv) / VALUE_SCALE,
                            -VALUE_CLAMP, VALUE_CLAMP)
        return {"policy_logit": logits, "policy": torch.softmax(logits, -1),
                "value": value[:, None]}


def _over(algo):
    over = dict(algorithm_preset(algo))
    over.update(actor_num_simulation=6, actor_gumbel_sample_size=4, env_board_size=9,
                actor_select_action_by_count=True, actor_use_gumbel_noise=False,
                actor_use_dirichlet_noise=False, actor_use_random_rotation_features=False)
    return over


def _compare_moves(jeng, jvars, eng, num_moves):
    jstates = jeng.init_batch(4)
    states = eng.init_batch(4)
    rng = jax.random.PRNGKey(7)
    for mv in range(num_moves):
        rng, k = jax.random.split(rng)
        jout = jeng.move(jvars, jstates, k)
        out = eng.move(states)
        np.testing.assert_array_equal(out.action.numpy(), np.asarray(jout.action),
                                      err_msg=f"move {mv} action")
        np.testing.assert_allclose(out.policy_target.numpy(), np.asarray(jout.policy_target),
                                   rtol=0.05, atol=0.02, err_msg=f"move {mv} policy target")
        np.testing.assert_allclose(out.root_value.numpy(), np.asarray(jout.root_value),
                                   rtol=1e-2, atol=5e-3, err_msg=f"move {mv} root value")
        np.testing.assert_array_equal(out.features.numpy(), np.asarray(jout.features),
                                      err_msg=f"move {mv} features")
        for name in ("resign", "done", "eval_score", "resign_score", "turn"):
            np.testing.assert_array_equal(getattr(out, name).numpy(),
                                          np.asarray(getattr(jout, name)), err_msg=f"move {mv} {name}")
        np.testing.assert_array_equal(out.states.board.numpy(), np.asarray(jout.states.board))
        jstates, states = jout.states, out.states


@pytest.mark.parametrize("algo", ["gaz", "az"])
def test_engine_moves_match_jax_engine(algo):
    """Gumbel (the flagship's search) and plain AlphaZero PUCT (n=6, so the
    JAX engine also takes its v1 tree kernel)."""
    over = _over(algo)
    assert dict(j_preset(algo)) == dict(algorithm_preset(algo))
    jcfg = j_default("go", **over)
    jnet, jvars = jax_parity_network("go")
    jeng = JEngine(j_make_env(jcfg), jcfg, jnet, use_bf16=False)
    assert jeng.use_tree_kernel and not jeng.use_tree_kernel_v2

    cfg = default_config("go", **over)
    eng = SelfPlayEngine(make_env(cfg), cfg, TorchParityNet(), use_bf16=False, device="cpu")
    assert not eng.use_tree_kernel_v2
    _compare_moves(jeng, jvars, eng, 3)


@pytest.mark.parametrize("sims,force,num_moves", [(10, True, 3), (50, False, 2)],
                         ids=["forced-v2-n10", "dispatch-n50"])
def test_engine_v2_moves_match_jax_engine(sims, force, num_moves):
    """The large-N loop: packed trees on the v2 tree step, parent states
    gathered from the packed blob; both engines must take it."""
    over = _over("az")
    over.update(actor_num_simulation=sims)
    jcfg = j_default("go", **over)
    jnet, jvars = jax_parity_network("go")
    jeng = JEngine(j_make_env(jcfg), jcfg, jnet, use_bf16=False, _force_kernel_v2=force)
    assert jeng.use_tree_kernel_v2

    cfg = default_config("go", **over)
    eng = SelfPlayEngine(make_env(cfg), cfg, TorchParityNet(), use_bf16=False, device="cpu",
                         _force_kernel_v2=force)
    assert eng.use_tree_kernel_v2 and eng.spec.max_nodes == sims + 1
    before = (fused_tree_step.launches, fused_tree_step_v2.launches, gather_rows.launches)
    _compare_moves(jeng, jvars, eng, num_moves)
    # no kernel launches on the CPU
    assert (fused_tree_step.launches, fused_tree_step_v2.launches, gather_rows.launches) == before


def test_v2_blob_rows_have_a_16_byte_stride():
    """After a move of the large-N loop the blob's rows are 4-word (16-byte)
    aligned: the 5x5 state's 221 words sit at a stride of 224, the pad
    words stay zero, and node 0's row unpacks to the root state."""
    from minizero_tpu_torch.ops.state_blob import blob_spec, unpack_rows

    over = _over("az")
    over.update(actor_num_simulation=8, env_board_size=5, nn_num_blocks=1,
                nn_num_hidden_channels=8, nn_num_value_hidden_channels=8)
    cfg = default_config("go", **over)
    env = make_env(cfg)
    eng = SelfPlayEngine(env, cfg, init_network(create_network(cfg, env.spec), seed=2),
                         use_bf16=False, device="cpu", _force_kernel_v2=True)
    assert eng.use_tree_kernel_v2
    states = eng.init_batch(3)
    eng.move(states)
    width = blob_spec(states).width
    assert width == 221 and width % 4 != 0
    assert tuple(eng._blob.shape) == (3, eng.spec.max_nodes, 224)
    assert eng._blob.shape[-1] % 4 == 0
    assert not eng._blob[:, :, width:].any()
    root = unpack_rows(blob_spec(states), eng._blob[:, 0])
    assert torch.equal(root.board, states.board) and torch.equal(root.turn, states.turn)


def test_az200_takes_the_v2_path_and_gaz16_stays_on_v1():
    """The flagship AlphaZero config (n=200) builds and dispatches to the
    large-N loop; the Gumbel n=16 config keeps the v1 loop."""
    tiny = dict(nn_num_hidden_channels=8, nn_num_value_hidden_channels=8)
    for algo, sims, want_v2 in (("az", 200, True), ("gaz", 16, False)):
        over = dict(algorithm_preset(algo))
        over.update(actor_num_simulation=sims, **tiny)
        cfg = default_config("go", **over)
        env = make_env(cfg)
        eng = SelfPlayEngine(env, cfg, init_network(create_network(cfg, env.spec), seed=0),
                             use_bf16=False, device="cpu")
        assert eng.use_tree_kernel_v2 == want_v2, algo


def test_move_scan_on_cpu_plays_legal_moves_with_resets():
    """``move_scan`` at a tiny width: legal actions, the in-scan bookkeeping
    (moves since reset, finish flags), and no kernel launch on the CPU."""
    over = dict(algorithm_preset("gaz"))
    over.update(actor_num_simulation=4, actor_gumbel_sample_size=4, env_board_size=5,
                nn_num_blocks=1, nn_num_hidden_channels=8, nn_num_value_hidden_channels=8)
    cfg = default_config("go", **over)
    env = make_env(cfg)
    eng = SelfPlayEngine(env, cfg, init_network(create_network(cfg, env.spec), seed=1),
                         use_bf16=False, device="cpu", seed=3)
    states = eng.init_batch(6)
    before = fused_tree_step.launches
    msr = None
    enable = None
    for _ in range(2):
        legal = env.legal_mask(states)
        scan, states, enable, msr = eng.move_scan(states, num_moves=3, enable_resign=enable,
                                                  moves_since_reset=msr)
        assert scan.action.shape == (3, 6) and scan.policy_target.dtype == torch.float16
        assert bool(legal[torch.arange(6), scan.action[0].long()].all())
        assert bool((scan.resigned & scan.ended).logical_not().all())
    finished = (scan.resigned | scan.ended).any(0)
    assert bool(((msr == 0) | ~finished).all())
    assert fused_tree_step.launches == before

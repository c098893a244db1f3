"""The README's strength protocol at n=800 on the port, held against the JAX
package on the CPU.

The protocol of ``scripts/n800_pair.py`` and ``scripts/elo_curve.py``: 800
simulations, the most visited action, no Dirichlet or Gumbel noise, eval
mode, 4 random opening plies. Go 9x9 with a narrow net (1 block x 16
channels, made from a seed by the JAX package and carried into the port by
``weights.from_jax_variables``), B = 2, one searched ply, float32, feature
rotation off (the two packages draw rotations from different streams).

* Gumbel AlphaZero: ``[B, 801, 82]`` trees on tree step B1 (the JAX Pallas
  kernel in interpret mode), sequential halving of 16 candidates over 800
  simulations.
* Plain AlphaZero: the large-N loop, packed trees grown 65 -> 129 -> 257 ->
  513 -> 801 on tree step B2, parent states fetched by the row gather B3
  (both JAX kernels in interpret mode).

Root visit counts and the actions are exact; the root children's mean
values, the root value and the policy targets within ``docs/Parity.md``'s
tolerances (per-child Q 2e-4, root mean 1e-4, count targets 2e-4,
completed-Q targets 2e-3): the two frameworks' float32 convolutions differ
in the last bits, and the tree sums run in different orders.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minizero_tpu.config import algorithm_preset as j_preset
from minizero_tpu.config import default_config as j_default
from minizero_tpu.envs import make_env as j_make_env
from minizero_tpu.models.factory import create_network as j_create_network
from minizero_tpu.models.factory import init_network as j_init_network
from minizero_tpu.search import mcts as jmcts
from minizero_tpu.selfplay.engine import SelfPlayEngine as JEngine
from minizero_tpu_torch.config import algorithm_preset, default_config
from minizero_tpu_torch.envs import make_env
from minizero_tpu_torch.models.factory import create_network
from minizero_tpu_torch.search import mcts
from minizero_tpu_torch.selfplay.engine import SelfPlayEngine
from minizero_tpu_torch.weights import from_jax_variables

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_env_parity import jax_batch  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

# scripts/elo_curve.py:16's override; n800_pair.py sets the simulations
# and plays in eval mode, which turns the noise off
PROTOCOL = ("actor_num_simulation=800:actor_select_action_by_count=true:"
            "actor_select_action_by_softmax_count=false:actor_use_dirichlet_noise=false:"
            "actor_use_gumbel_noise=false")
OPENING_PLIES = 4
BATCH = 2
NARROW = dict(nn_num_blocks=1, nn_num_hidden_channels=16, nn_num_value_hidden_channels=16,
              actor_use_random_rotation_features=False)


def _configs(algo):
    assert dict(algorithm_preset(algo)) == dict(j_preset(algo))
    over = {**dict(algorithm_preset(algo)), **NARROW}
    cfg = default_config("go", **over).load_string(PROTOCOL)
    jcfg = j_default("go", **over).load_string(PROTOCOL)
    assert cfg.to_string() == jcfg.to_string()
    assert cfg.actor_num_simulation == 800 and cfg.actor_select_action_by_count
    return cfg.replace(zero_num_parallel_games=BATCH), jcfg.replace(zero_num_parallel_games=BATCH)


def _openings(jenv, tenv, seed):
    """The same ``OPENING_PLIES`` uniform legal plies from the start in both
    packages' batches."""
    js, ts = jax_batch(jenv, BATCH), tenv.init(BATCH, device="cpu")
    jstep = jax.vmap(jenv.step)
    rng = np.random.default_rng(seed)
    for _ in range(OPENING_PLIES):
        legal = tenv.legal_mask(ts).numpy()
        action = (rng.random(legal.shape) * legal + 1e-9 * legal).argmax(-1).astype(np.int32)
        js = jstep(js, jnp.asarray(action))
        ts = tenv.step(ts, torch.from_numpy(action))
    np.testing.assert_array_equal(np.asarray(js.board), ts.board.numpy())
    return js, ts


def _root_children(tree_visits, tree_mean, cidx):
    has = cidx >= 0
    idx = np.where(has, cidx, 0)
    visits = np.where(has, np.take_along_axis(tree_visits, idx, 1), 0.0)
    mean = np.where(has, np.take_along_axis(tree_mean, idx, 1), 0.0)
    return visits, mean


@pytest.mark.parametrize("algo", ["gaz", "az"])
def test_n800_search_matches_jax(algo):
    cfg, jcfg = _configs(algo)
    jenv, tenv = j_make_env(jcfg), make_env(cfg)
    jnet = j_create_network(jcfg, jenv.spec)
    jvars = j_init_network(jnet, jenv.spec, jax.random.PRNGKey(800))
    net = create_network(cfg, tenv.spec)
    net.load_state_dict(from_jax_variables(jvars, hidden_hw=81))
    jeng = JEngine(jenv, jcfg, jnet, eval_mode=True, use_bf16=False)
    eng = SelfPlayEngine(tenv, cfg, net, eval_mode=True, use_bf16=False, device="cpu")
    assert eng.spec.max_nodes == jeng.spec.max_nodes == 801
    assert not eng.spec.use_dirichlet_noise and not eng.spec.use_gumbel_noise
    if algo == "gaz":
        assert jeng.use_tree_kernel and not eng.use_tree_kernel_v2
        assert eng.spec.gumbel_sample_size == 16
    else:
        assert jeng.use_tree_kernel_v2 and eng.use_tree_kernel_v2

    js, ts = _openings(jenv, tenv, seed=41)
    jtrees = jeng.search_trees(jvars, js, jax.random.PRNGKey(3))
    jaction, jtarget, jroot, _ = jeng._decide(jtrees, jax.random.PRNGKey(4), 1.0)
    trees = eng.search_trees(ts)
    action, target, root, _ = eng._decide(trees, 1.0, eng.generator)

    jvisits, jmean = _root_children(np.asarray(jtrees.visits), np.asarray(jtrees.mean),
                                    np.asarray(jtrees.children_index)[:, 0])
    visits, mean = _root_children(trees.visits.numpy(), trees.mean.numpy(),
                                  trees.children_index[:, 0].numpy())
    np.testing.assert_array_equal(visits, jvisits, err_msg="root visits")
    np.testing.assert_array_equal(mcts.root_children_visits(trees).numpy(),
                                  np.asarray(jax.vmap(jmcts.root_children_visits)(jtrees)))
    assert visits.sum(1).tolist() == [800.0] * BATCH
    np.testing.assert_array_equal(action.numpy(), np.asarray(jaction), err_msg="action")
    np.testing.assert_allclose(mean, jmean, rtol=0, atol=2e-4, err_msg="root children's Q")
    np.testing.assert_allclose(root.numpy(), np.asarray(jroot), rtol=0, atol=1e-4,
                               err_msg="root value")
    np.testing.assert_allclose(target.numpy(), np.asarray(jtarget), rtol=0,
                               atol=2e-3 if algo == "gaz" else 2e-4, err_msg="policy target")
    if algo == "gaz":
        # sequential halving ran its phases: 16 -> 8 -> 4 -> 2 candidates
        np.testing.assert_array_equal(trees.gumbel_sample_size.numpy(),
                                      np.asarray(jtrees.gumbel_sample_size))
        assert trees.gumbel_sample_size.tolist() == [2] * BATCH
        assert int(trees.gumbel_active.sum()) == 2 * BATCH

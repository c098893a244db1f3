"""The port's MuZero network held against the JAX package's, on the same
weights carried over by ``weights.from_jax_muzero_variables``: the initial
and the recurrent inference, in board mode (Go 9x9 shapes) and in Atari mode
(stride-2 convolutions, average pools, the 601-bin value and reward heads),
plus the pieces they are built from: ``scale_hidden_state``, flax's "SAME"
padding, and the action planes of the dynamics net.

float32 on the CPU at a few channels. Tolerance 1e-4 absolute, as for the
AlphaZero net (``tests/test_torch_model.py``): the frameworks sum the
convolutions and dense products in different orders. The Atari inputs have
even sizes, where flax pads a stride-2 3x3 window 0 before and 1 after.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from minizero_tpu.envs.atari import AtariEnv
from minizero_tpu.envs.go import GoEnv as JGoEnv
from minizero_tpu.models.blocks import scale_hidden_state as j_scale_hidden_state
from minizero_tpu.models.muzero import MuZeroNetwork as JMuZeroNetwork
from minizero_tpu_torch.config import algorithm_preset, default_config
from minizero_tpu_torch.envs import atari, make_env
from minizero_tpu_torch.models.blocks import same_pad, scale_hidden_state
from minizero_tpu_torch.models.factory import create_network, init_network
from minizero_tpu_torch.models.muzero import MuZeroNetwork
from minizero_tpu_torch.weights import from_jax_muzero_variables

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from parity_common import ParityFakeALE  # noqa: E402

ATOL = 1e-4


def _jax_variables(jnet, dims, seed):
    """All of the flax net's variables (initial and recurrent inference),
    with non-trivial BatchNorm statistics and affine terms."""
    def init_all(module, state):
        out = module.initial_inference(state, train=False)
        plane = jnp.zeros((1, dims["hidden_height"], dims["hidden_width"],
                           dims["num_action_feature_channels"]))
        return module.recurrent_inference(out["hidden_state"], plane, train=False)

    dummy = jnp.zeros((1, dims["input_height"], dims["input_width"], dims["num_input_channels"]))
    variables = jax.tree_util.tree_map(
        np.asarray, jnet.init(jax.random.PRNGKey(seed), dummy, method=init_all))
    rng = np.random.default_rng(seed)

    def perturb(tree, low, high):
        return jax.tree_util.tree_map(
            lambda x: (x + rng.uniform(low, high, size=x.shape)).astype(np.float32), tree)

    return {"params": perturb(variables["params"], -0.05, 0.05),
            "batch_stats": perturb(variables["batch_stats"], 0.0, 0.5)}


def _compare(got, want, what):
    assert sorted(got) == sorted(want), what
    for key in want:
        g = got[key]
        if key == "hidden_state":  # NCHW here, NHWC in the JAX package
            g = g.permute(0, 2, 3, 1)
        np.testing.assert_allclose(g.numpy(), np.asarray(want[key]), rtol=0, atol=ATOL,
                                   err_msg=f"{what}: {key}")


BOARD = dict(num_input_channels=18, input_height=9, input_width=9, hidden_height=9,
             hidden_width=9, num_action_feature_channels=1, action_size=82,
             discrete_value_size=1, atari_mode=False)
# Atari at two even input sizes: 32 (-> 16 -> 8 -> 4 -> 2) at a small value
# support, and the real 96 (-> 6) with the real 601-bin heads
ATARI_32 = dict(num_input_channels=32, input_height=32, input_width=32, hidden_height=2,
                hidden_width=2, num_action_feature_channels=18, action_size=18,
                discrete_value_size=11, atari_mode=True)
ATARI_96 = dict(ATARI_32, input_height=96, input_width=96, hidden_height=6, hidden_width=6,
                discrete_value_size=601)


@pytest.mark.parametrize("dims,blocks,channels", [
    (BOARD, 1, 8), (BOARD, 2, 4), (ATARI_32, 1, 8), (ATARI_96, 1, 8)],
    ids=["board-1x8", "board-2x4", "atari32-1x8", "atari96-1x8"])
def test_muzero_forward_matches_jax_with_carried_weights(dims, blocks, channels):
    dims = dict(dims, num_blocks=blocks, num_hidden_channels=channels,
                num_value_hidden_channels=channels)
    jnet = JMuZeroNetwork(**dims)
    variables = _jax_variables(jnet, dims, seed=blocks * 10 + channels)
    net = MuZeroNetwork(**dims)
    net.load_state_dict(from_jax_muzero_variables(
        variables, hidden_hw=dims["hidden_height"] * dims["hidden_width"]))
    net.eval()

    rng = np.random.default_rng(channels)
    b = 5
    if dims["atari_mode"]:
        feats = (rng.integers(0, 256, size=(b, dims["input_height"], dims["input_width"],
                                            dims["num_input_channels"])) / 255.0)
    else:
        feats = rng.integers(0, 2, size=(b, 9, 9, 18))
    feats = feats.astype(np.float32)
    want0 = jnet.apply(variables, jnp.asarray(feats), train=False, method=jnet.initial_inference)
    with torch.no_grad():
        got0 = net.initial_inference(torch.from_numpy(feats))
    _compare(got0, want0, "initial inference")

    # recurrent inference from the JAX hidden state and one action per game
    # (the action planes are held against JAX in test_action_planes_match_jax)
    actions = torch.from_numpy(rng.integers(0, dims["action_size"], size=b).astype(np.int32))
    if dims["atari_mode"]:
        spec = dataclasses.replace(atari.atari_spec(), hidden_height=dims["hidden_height"],
                                   hidden_width=dims["hidden_width"])
        planes = atari.action_features(actions, spec)
    else:
        planes = make_env(default_config("go")).action_features(actions)
    jplanes = jnp.asarray(planes.permute(0, 2, 3, 1).numpy())
    hidden = np.array(want0["hidden_state"])
    want1 = jnet.apply(variables, jnp.asarray(hidden), jplanes, train=False,
                       method=jnet.recurrent_inference)
    with torch.no_grad():
        got1 = net.recurrent_inference(torch.from_numpy(hidden).permute(0, 3, 1, 2), planes)
    _compare(got1, want1, "recurrent inference")
    assert ("reward" in got1) == dims["atari_mode"]


def test_action_planes_match_jax():
    """Go: one one-hot plane per action, all zeros for the pass; Atari: the
    action's channel of 18 filled with ones, at the real 6 x 6 hidden size."""
    actions = np.arange(82, dtype=np.int32)
    jgo = JGoEnv(board_size=9)
    want = np.asarray(jax.vmap(jgo.action_features)(jnp.asarray(actions)))
    got = make_env(default_config("go")).action_features(torch.from_numpy(actions))
    assert got.shape == (82, 1, 9, 9)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)
    assert float(got[81].abs().sum()) == 0.0  # pass

    jatari = AtariEnv(seed=0, ale_factory=lambda s: ParityFakeALE(s))
    actions = np.arange(18, dtype=np.int32)
    want = np.stack([np.asarray(jatari.action_features(jnp.int32(a))) for a in actions])
    got = atari.action_features(torch.from_numpy(actions), atari.atari_spec())
    assert got.shape == (18, 18, 6, 6)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)
    assert atari.atari_spec() == dataclasses.replace(atari.atari_spec(), **{
        f.name: getattr(jatari.spec, f.name) for f in dataclasses.fields(jatari.spec)})


def test_scale_hidden_state_matches_jax():
    """Per-sample min-max to [0, 1]; a constant sample (range below 1e-5)
    takes the widened range and maps to 0."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 6, 5, 5)).astype(np.float32)
    x[1] = 0.25  # constant
    x[2] = x[2] * 1e-7  # range below 1e-5
    want = np.asarray(j_scale_hidden_state(jnp.asarray(x.transpose(0, 2, 3, 1))))
    got = scale_hidden_state(torch.from_numpy(x)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert float(np.abs(got[1]).max()) == 0.0


def test_same_padding_matches_flax():
    """flax pads a stride-2 3x3 window 0 before and 1 after on an even size
    (and 1 and 1 on an odd one): the average pool of a 4x4 ramp gives
    [[5, 4.33], [7.33, 5.56]] there, while torch's symmetric padding=1 gives
    [[1.11, 2.67], [5.67, 10.0]]."""
    import flax.linen as fnn

    for n in (4, 5, 6):
        x = np.arange(n * n, dtype=np.float32).reshape(1, 1, n, n)
        want = np.asarray(fnn.avg_pool(jnp.asarray(x.transpose(0, 2, 3, 1)), (3, 3),
                                       strides=(2, 2), padding="SAME"))
        got = F.avg_pool2d(same_pad(torch.from_numpy(x), 3, 2), 3, 2)
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=0, atol=1e-5)
    x = torch.arange(16, dtype=torch.float32).reshape(1, 1, 4, 4)
    np.testing.assert_allclose(F.avg_pool2d(same_pad(x, 3, 2), 3, 2)[0, 0].numpy(),
                               [[5.0, 13.0 / 3.0], [22.0 / 3.0, 50.0 / 9.0]], atol=1e-5)
    assert not torch.allclose(F.avg_pool2d(x, 3, 2, padding=1), F.avg_pool2d(same_pad(x, 3, 2), 3, 2))


def test_factory_builds_muzero_for_board_and_atari():
    cfg = default_config("go", **algorithm_preset("gmz"), nn_num_hidden_channels=8,
                         nn_num_value_hidden_channels=8)
    env = make_env(cfg)
    net = init_network(create_network(cfg, env.spec), seed=3)
    assert isinstance(net, MuZeroNetwork) and net.dynamics.reward_head is None
    with torch.no_grad():
        out = net.initial_inference(torch.zeros((2, 9, 9, 18)))
        rec = net.recurrent_inference(out["hidden_state"], env.action_features(
            torch.tensor([3, 81], dtype=torch.int32)))
    assert out["hidden_state"].shape == (2, 8, 9, 9) and "reward" not in rec
    assert rec["policy"].shape == (2, 82) and rec["value"].shape == (2, 1)

    acfg = default_config("atari", **algorithm_preset("mz"), nn_num_hidden_channels=8,
                          nn_num_value_hidden_channels=8)
    anet = init_network(create_network(acfg, atari.atari_spec()), seed=3)
    assert anet.dynamics.reward_head is not None
    with torch.no_grad():
        out = anet.initial_inference(torch.zeros((2, 96, 96, 32)))
        rec = anet.recurrent_inference(out["hidden_state"], atari.action_features(
            torch.tensor([0, 17], dtype=torch.int32), atari.atari_spec()))
    assert out["hidden_state"].shape == (2, 8, 6, 6)
    assert rec["reward"].shape == (2, 601) and rec["value"].shape == (2, 601)
    torch.testing.assert_close(rec["reward"].sum(-1), torch.ones(2))

"""The port's AlphaZero network held against the JAX package's, on the same
weights carried over by ``minizero_tpu_torch.weights``.

float32 on the CPU, at narrow widths (1 block x 16 channels, 2 x 8), at the
flagship width (1 x 256), and with the distributional value head. Tolerance 1e-4 absolute: the two frameworks sum
the convolutions and dense products in different orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minizero_tpu.models.alphazero import AlphaZeroNetwork as JAlphaZeroNetwork
from minizero_tpu_torch.config import algorithm_preset, default_config
from minizero_tpu_torch.envs import make_env
from minizero_tpu_torch.models.alphazero import AlphaZeroNetwork
from minizero_tpu_torch.models.factory import create_network, init_network
from minizero_tpu_torch.weights import from_jax_muzero_variables, from_jax_variables

ATOL = 1e-4


def _cfg_over(blocks, channels):
    over = dict(algorithm_preset("gaz"))
    over.update(nn_num_blocks=blocks, nn_num_hidden_channels=channels,
                nn_num_value_hidden_channels=channels)
    return over


@pytest.mark.parametrize("blocks,channels,value_size", [(1, 16, 1), (2, 8, 1), (1, 256, 1), (1, 16, 11)])
def test_forward_matches_jax_with_carried_weights(blocks, channels, value_size):
    """Scalar value head at three widths (1 x 256 is the flagship), and the
    distributional (two-hot) value head."""
    dims = dict(num_input_channels=18, input_height=9, input_width=9,
                num_hidden_channels=channels, hidden_height=9, hidden_width=9,
                num_blocks=blocks, action_size=82, num_value_hidden_channels=channels,
                discrete_value_size=value_size)
    jnet = JAlphaZeroNetwork(**dims)
    variables = jax.tree_util.tree_map(
        np.asarray, jnet.init(jax.random.PRNGKey(3), jnp.zeros((1, 9, 9, 18)), train=False))
    # non-trivial BatchNorm statistics and affine terms, so their mapping is
    # exercised (a fresh init has mean 0, var 1, scale 1, shift 0)
    rng = np.random.default_rng(channels + value_size)

    def perturb(tree, low, high):
        return jax.tree_util.tree_map(
            lambda x: (x + rng.uniform(low, high, size=x.shape)).astype(np.float32), tree)

    variables = {
        "params": perturb(variables["params"], -0.05, 0.05),
        "batch_stats": perturb(variables["batch_stats"], 0.0, 0.5),
    }
    feats = rng.integers(0, 2, size=(6, 9, 9, 18)).astype(np.float32)
    want = jnet.apply(variables, jnp.asarray(feats), train=False)

    net = AlphaZeroNetwork(**dims)
    net.load_state_dict(from_jax_variables(variables, hidden_hw=81))
    net.eval()
    with torch.no_grad():
        got = net(torch.from_numpy(feats))
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=0, atol=ATOL,
                                   err_msg=key)


def test_init_network_is_seeded_and_torch_default():
    cfg = default_config("go", **_cfg_over(1, 16))
    env = make_env(cfg)
    a = init_network(create_network(cfg, env.spec), seed=5)
    b = init_network(create_network(cfg, env.spec), seed=5)
    c = init_network(create_network(cfg, env.spec), seed=6)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["conv.weight"], sc["conv.weight"])
    lim = 1.0 / np.sqrt(18 * 9)
    assert float(sa["conv.weight"].abs().max()) <= lim
    assert float(sa["conv.bias"].abs().max()) <= lim
    feats = torch.zeros((2, 9, 9, 18))
    with torch.no_grad():
        out = a(feats)
    assert out["policy"].shape == (2, 82) and out["value"].shape == (2, 1)
    torch.testing.assert_close(out["policy"].sum(-1), torch.ones(2))


# the trained nets the port reads from ``minizero_tpu_torch/assets/``: the az
# n=200 run's last checkpoint and its steps 0 and 3,125 (the plain AlphaZero
# recipe), and the Gumbel AlphaZero run's (the reference recipe,
# ``runs/go9_gaz_full``) iterations 0 and 25
TRAINED_ASSETS = {
    "go9_az200_r3b_iter25000": ("go9_az200_r3b/model/weight_iter_25000.ckpt", "az", 200),
    "go9_az200_r3b_iter0": ("go9_az200_r3b/model/weight_iter_0.ckpt", "az", 200),
    "go9_az200_r3b_iter3125": ("go9_az200_r3b/model/weight_iter_3125.ckpt", "az", 200),
    "go9_gaz_full_iter0": ("go9_gaz_full/model/weight_iter_0.ckpt", "gaz", 16),
    "go9_gaz_full_iter12500": ("go9_gaz_full/model/weight_iter_12500.ckpt", "gaz", 16),
    "go9_gmz_r4_iter0": ("go9_gmz_r4/model/weight_iter_0.ckpt", "gmz", 16),
    "go9_gmz_r4_iter12500": ("go9_gmz_r4/model/weight_iter_12500.ckpt", "gmz", 16),
}


@pytest.mark.parametrize("asset", sorted(TRAINED_ASSETS))
def test_trained_az200_weights_match_the_jax_checkpoint(asset):
    """A trained Go 9x9 net that the port reads from
    ``minizero_tpu_torch/assets/`` (exported by
    ``scripts/export_trained_weights.py``) against the JAX net loaded from
    its ``.ckpt`` under ``runs/``: the same variables, and the same forward
    pass within 1e-4 on random boards; for a MuZero net (``gmz``) the
    initial inference and one recurrent inference step on random actions,
    the hidden states too. The name is kept from its first asset, the
    az n=200 net."""
    import os

    from minizero_tpu.config import algorithm_preset as jpreset
    from minizero_tpu.config import default_config as jdefault
    from minizero_tpu.envs import make_env as jmake_env
    from minizero_tpu.eval.match import load_checkpoint_variables
    from minizero_tpu.models.factory import create_network as jcreate
    from minizero_tpu_torch.weights import load_variables_npz

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ckpt_path, preset, sims = TRAINED_ASSETS[asset]
    ckpt = os.path.join(root, "runs", ckpt_path)
    npz = os.path.join(root, "minizero_tpu_torch", "assets", f"{asset}.npz")
    jcfg = jdefault("go", **jpreset(preset)).replace(actor_num_simulation=sims)
    jenv = jmake_env(jcfg)
    jnet = jcreate(jcfg, jenv.spec)
    variables = load_checkpoint_variables(ckpt, jcfg, jnet, jenv.spec)
    feats = np.random.default_rng(25).integers(0, 2, size=(8, 9, 9, 18)).astype(np.float32)
    want = jnet.apply(variables, jnp.asarray(feats), train=False)

    loaded = load_variables_npz(npz)
    flat_j = jax.tree_util.tree_leaves_with_path(variables)
    assert len(flat_j) == sum(1 for _ in jax.tree_util.tree_leaves(loaded))
    for path, leaf in flat_j:
        node = loaded
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(node, np.asarray(leaf))

    cfg = default_config("go", **algorithm_preset(preset)).replace(actor_num_simulation=sims)
    env = make_env(cfg)
    net = create_network(cfg, env.spec)
    muzero = preset == "gmz"
    convert = from_jax_muzero_variables if muzero else from_jax_variables
    net.load_state_dict(convert(loaded, hidden_hw=81))
    net.eval()
    with torch.no_grad():
        got = net(torch.from_numpy(feats))
    pairs = [(got, want)]
    if muzero:
        actions = np.random.default_rng(26).integers(0, 82, 8).astype(np.int32)
        jplanes = jax.vmap(jenv.action_features)(jnp.asarray(actions))
        with torch.no_grad():
            rec = net.recurrent_inference(got["hidden_state"],
                                          env.action_features(torch.from_numpy(actions)))
        pairs.append((rec, jnet.apply(variables, want["hidden_state"], jplanes,
                                      method=jnet.recurrent_inference)))
    for step, (g, w) in enumerate(pairs):
        keys = ("policy", "policy_logit", "value") + (("hidden_state",) if muzero else ())
        for key in keys:
            value = g[key].permute(0, 2, 3, 1) if key == "hidden_state" else g[key]
            np.testing.assert_allclose(value.numpy(), np.asarray(w[key]), rtol=0, atol=ATOL,
                                       err_msg=f"{key}, step {step}")


def test_trained_atari_net_matches_the_jax_checkpoint():
    """The JAX Atari Gumbel MuZero run's last net
    (``runs/atari_gmz_r5_b128/model/weight_iter_6000.ckpt``, 1 x 256, the
    601-bin value and reward heads), read from its ``.ckpt`` and carried
    over by ``from_jax_muzero_variables`` with no export: the initial
    inference on FakeALE stacks and one recurrent inference step on random
    actions match the JAX net's within 1e-4, the hidden states too."""
    import os
    import pickle

    from minizero_tpu.config import default_config as jdefault
    from minizero_tpu.envs.atari import atari_spec as jatari_spec
    from minizero_tpu.eval.match import load_checkpoint_variables
    from minizero_tpu.models.factory import create_network as jcreate
    from minizero_tpu_torch.envs import atari

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ckpt = os.path.join(root, "runs", "atari_gmz_r5_b128", "model", "weight_iter_6000.ckpt")
    with open(ckpt, "rb") as f:
        text = pickle.load(f)["config"]
    jcfg = jdefault("atari").load_string(text, sep="\n")
    jnet = jcreate(jcfg, jatari_spec())
    variables = load_checkpoint_variables(ckpt, jcfg, jnet, jatari_spec())

    cfg = default_config("atari").load_string(text, sep="\n")
    spec = atari.atari_spec()
    net = create_network(cfg, spec)
    net.load_state_dict(from_jax_muzero_variables(jax.device_get(variables), hidden_hw=36))
    net.eval()
    # the stacks of 4 FakeALE episodes 12 moves in, random actions
    vec = atari.AtariVecEnv(4, seed=5, ale_factory=lambda s: atari.FakeALE(seed=s, length=900))
    rng = np.random.default_rng(27)
    for _ in range(12):
        vec.step(rng.integers(0, 4, 4))
    feats = vec.features()
    want0 = jnet.apply(variables, jnp.asarray(feats), train=False, method=jnet.initial_inference)
    actions = rng.integers(0, 18, 4).astype(np.int32)
    planes = atari.action_features(torch.from_numpy(actions), spec)
    want1 = jnet.apply(variables, want0["hidden_state"],
                       jnp.asarray(planes.permute(0, 2, 3, 1).numpy()), train=False,
                       method=jnet.recurrent_inference)
    with torch.no_grad():
        got0 = net.initial_inference(torch.from_numpy(feats))
        got1 = net.recurrent_inference(
            torch.from_numpy(np.array(want0["hidden_state"])).permute(0, 3, 1, 2), planes)
    for what, got, want in (("initial", got0, want0), ("recurrent", got1, want1)):
        assert sorted(got) == sorted(want), what
        for key in want:
            g = got[key].permute(0, 2, 3, 1) if key == "hidden_state" else got[key]
            np.testing.assert_allclose(g.numpy(), np.asarray(want[key]), rtol=0, atol=ATOL,
                                       err_msg=f"{what} inference: {key}")
    assert "reward" in got1

"""The port's train step held against the JAX package's
(``minizero_tpu/learner/train.py``) on the same numpy batches, plus the
pieces it is built from: the min-max backward of the MuZero hidden state,
flax's BatchNorm running statistics and the step-decay schedule.

Each step starts both sides from the same state: the JAX package's
parameters, BatchNorm statistics and optimizer state are carried into the
port (``weights.from_jax_variables`` / ``from_jax_muzero_variables``; the
optimizer's param-shaped trees go through the same map) before every one of
3 steps, with the rotation ids the JAX step draws from its key
(``jax.random.randint(key, (b,), 0, n)``). After each step the loss, every
metric, the parameters, the running statistics and the optimizer state
(SGD's momentum, Adam's moments) agree within 1e-5 absolute in float32
(PER's distributional root values within 1e-4 relative, see
``_compare_metrics``): the
frameworks sum in different orders, so values agree to a few ulps (2e-7 to
1e-6 measured), and a state carried over rather than chained keeps a ReLU
input that lands within float noise of 0 (seen at 2.6e-6 in the MuZero
unroll) from flipping a kink between the two and compounding.

One named exception: with Adam and AdamW the bias of a convolution that
feeds a BatchNorm in training has an exact gradient of 0, so each side
moves it by ``lr * noise / (|noise| + eps)`` of its own rounding noise; for
those biases the check is that the two ended at most twice the step's
learning rate apart (each Adam step is at most lr long).
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from minizero_tpu.config import default_config as jdefault_config
from minizero_tpu.envs import make_env as jmake_env
from minizero_tpu.envs.atari import atari_spec as jatari_spec
from minizero_tpu.learner.train import init_train_state as jinit_train_state
from minizero_tpu.learner.train import make_train_step as jmake_train_step
from minizero_tpu.models.blocks import scale_hidden_state as jscale_hidden_state
from minizero_tpu.models.factory import create_network as jcreate_network
from minizero_tpu.models.factory import init_network as jinit_network
from minizero_tpu.utils.bitpack import pack_planes_np
from minizero_tpu.utils.bitpack import unpack_planes as junpack_planes
from minizero_tpu_torch.config import default_config
from minizero_tpu_torch.envs import atari, make_env
from minizero_tpu_torch.learner.train import (
    init_train_state, learning_rate, make_train_step)
from minizero_tpu_torch.models.blocks import BatchNorm2d, minmax_normalize, scale_hidden_state
from minizero_tpu_torch.models.factory import create_network
from minizero_tpu_torch.weights import from_jax_muzero_variables, from_jax_variables

ATOL = 1e-5


# ----------------------------------------------------------------- helpers
def _jax_atari_env():
    spec = jatari_spec()

    def action_features(a):
        onehot = (jnp.arange(spec.action_size) == a).astype(jnp.float32)
        return jnp.broadcast_to(onehot[None, None, :],
                                (spec.hidden_height, spec.hidden_width, spec.action_size))

    return types.SimpleNamespace(spec=spec, action_features=action_features,
                                 num_rotations=lambda: 1)


def _torch_atari_env():
    spec = atari.atari_spec()
    return types.SimpleNamespace(spec=spec, num_rotations=lambda: 1,
                                 action_features=lambda a: atari.action_features(a, spec))


def _envs(env_name, jcfg, tcfg, value_size):
    if env_name == "atari":
        return _jax_atari_env(), _torch_atari_env()
    jenv, tenv = jmake_env(jcfg), make_env(tcfg)
    if value_size:  # a distributional value head on a board game
        jenv.spec = dataclasses.replace(jenv.spec, discrete_value_size=value_size)
        tenv.spec = dataclasses.replace(tenv.spec, discrete_value_size=value_size)
    return jenv, tenv


def _perturbed_variables(jnet, jenv, seed):
    """The flax net's variables with non-trivial BatchNorm statistics."""
    spec = jenv.spec
    if hasattr(jnet, "recurrent_inference"):
        def init_all(module, state):
            out = module.initial_inference(state, train=False)
            plane = jnp.zeros((1, spec.hidden_height, spec.hidden_width,
                               spec.num_action_feature_channels))
            return module.recurrent_inference(out["hidden_state"], plane, train=False)

        dummy = jnp.zeros((1, spec.input_height, spec.input_width, spec.num_input_channels))
        variables = jnet.init(jax.random.PRNGKey(seed), dummy, method=init_all)
    else:
        variables = jinit_network(jnet, spec, jax.random.PRNGKey(seed))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    rng = np.random.default_rng(seed)
    return {
        "params": jax.tree_util.tree_map(
            lambda x: (x + rng.uniform(-0.05, 0.05, x.shape)).astype(np.float32),
            variables["params"]),
        "batch_stats": jax.tree_util.tree_map(
            lambda x: (x + rng.uniform(0.0, 0.5, x.shape)).astype(np.float32),
            variables["batch_stats"]),
    }


class _Pair:
    """The JAX package's and the port's train state on the same weights."""

    def __init__(self, env_name, over, value_size=0, seed=0):
        self.jcfg = jdefault_config(env_name, **over)
        self.tcfg = default_config(env_name, **over)
        self.jenv, self.tenv = _envs(env_name, self.jcfg, self.tcfg, value_size)
        self.spec = self.tenv.spec
        self.muzero = self.tcfg.nn_type_name != "alphazero"
        self.jnet = jcreate_network(self.jcfg, self.jenv.spec)
        variables = _perturbed_variables(self.jnet, self.jenv, seed)
        self.jstate = jinit_train_state(self.jcfg, variables)
        self.jstep = jax.jit(jmake_train_step(self.jcfg, self.jenv, self.jnet))
        self.tnet = create_network(self.tcfg, self.spec)
        self.tstate = init_train_state(self.tcfg, self.tnet)
        self.tstep = make_train_step(self.tcfg, self.tenv, self.tnet)
        self.hw = self.spec.hidden_height * self.spec.hidden_width
        self.opt = self.tcfg.learner_optimizer.lower()

    # --- the JAX state in the port's names
    def _convert(self, params, stats):
        conv = from_jax_muzero_variables if self.muzero else from_jax_variables
        return conv({"params": jax.tree_util.tree_map(np.asarray, params),
                     "batch_stats": jax.tree_util.tree_map(np.asarray, stats)}, self.hw)

    def jax_model(self):
        return self._convert(self.jstate.params, self.jstate.batch_stats)

    def jax_optimizer(self):
        """{name: {buffer: tensor}} and the optimizer's step count."""
        s = self.jstate.opt_state
        if self.opt == "sgd":
            trees = {"momentum_buffer": s[1].trace}
            count = int(s[2].count)
        else:
            adam = s[1] if self.opt == "adam" else s[0]
            trees = {"exp_avg": adam.mu, "exp_avg_sq": adam.nu}
            count = int(adam.count)
        names = dict(self.tnet.named_parameters())
        out = {n: {} for n in names}
        for buf, tree in trees.items():
            sd = self._convert(tree, self.jstate.batch_stats)
            for n in names:
                out[n][buf] = sd[n]
        return out, count

    def sync(self):
        """Carry the JAX state into the port."""
        self.tnet.load_state_dict(self.jax_model())
        bufs, count = self.jax_optimizer()
        params = dict(self.tnet.named_parameters())
        opt = self.tstate.optimizer
        for n, p in params.items():
            st = {k: v.clone() for k, v in bufs[n].items()}
            if self.opt != "sgd":
                st["step"] = torch.tensor(float(count))
            opt.state[p] = st
        self.tstate.step = int(self.jstate.step)

    # --- batches
    def batch(self, rng, b, k):
        spec = self.spec
        a = spec.action_size
        shape = (b, spec.input_height, spec.input_width, spec.num_input_channels)
        if spec.binary_features:
            packed = pack_planes_np((rng.random(shape) > 0.5).astype(np.uint8))
            jfeats = np.asarray(junpack_planes(jnp.asarray(packed), spec.num_input_channels))
        else:
            packed = rng.integers(0, 256, shape).astype(np.uint8)
            jfeats = packed

        def policy(shape):
            p = rng.random(shape) * (rng.random(shape) > 0.3)
            p[..., 0] += 1e-3
            return (p / p.sum(-1, keepdims=True)).astype(np.float16)

        scale = rng.uniform(0.5, 1.0, b).astype(np.float32)
        if self.muzero:
            value = (rng.uniform(-3, 3, (b, k + 1)) if spec.discrete_value_size > 1
                     else rng.choice([-1.0, 0.0, 1.0], (b, k + 1)))
            batch = {"policy": policy((b, k + 1, a)), "value": value.astype(np.float32),
                     "actions": rng.integers(0, a, (b, k)).astype(np.int32),
                     "reward": rng.uniform(-2, 5, (b, k)).astype(np.float32),
                     "loss_scale": scale}
        else:
            value = (rng.uniform(-1, 1, b) if spec.discrete_value_size > 1
                     else rng.choice([-1.0, 0.0, 1.0], b))
            batch = {"policy": policy((b, a)), "value": value.astype(np.float32),
                     "loss_scale": scale}
        tbatch = dict(batch, features=packed)
        jbatch = {k: jnp.asarray(v) for k, v in dict(batch, features=jfeats).items()}
        return tbatch, jbatch

    def step(self, tbatch, jbatch, key):
        n = self.jenv.num_rotations()
        rots = np.asarray(jax.random.randint(key, (tbatch["features"].shape[0],), 0, n))
        self.jstate, jm = self.jstep(self.jstate, jbatch, key)
        tm = self.tstep(self.tstate, tbatch, rotations=torch.as_tensor(rots) if n > 1 else None)
        return jm, tm

    def compare(self, what):
        """Parameters, running statistics and optimizer state after a step."""
        want = self.jax_model()
        got = self.tnet.state_dict()
        lr = learning_rate(self.tcfg, int(self.jstate.step) - 1)
        for name, w in want.items():
            if name.endswith("num_batches_tracked"):
                continue
            err = float((got[name] - w).abs().max())
            if self.opt != "sgd" and _feeds_batchnorm(name):
                # each side's Adam step is at most lr: two steps of opposite
                # sign end at most 2 lr apart (the weight decay is the same)
                assert err <= 2 * lr + 1e-6, f"{what}: {name} moved {err} apart (> 2 lr)"
            else:
                assert err <= ATOL, f"{what}: {name} differs by {err}"
        bufs, count = self.jax_optimizer()
        params = dict(self.tnet.named_parameters())
        for name, p in params.items():
            st = self.tstate.optimizer.state[p]
            if self.opt != "sgd":
                assert int(st["step"]) == count, what
                if _feeds_batchnorm(name):
                    continue
            for buf, w in bufs[name].items():
                err = float((st[buf] - w).abs().max())
                assert err <= ATOL, f"{what}: {name}.{buf} differs by {err}"
        assert self.tstate.step == int(self.jstate.step), what
        assert not self.tnet.training, f"{what}: the net was left in train mode"


def _feeds_batchnorm(name):
    """The bias of a convolution followed by a BatchNorm (every conv of the
    nets): its exact gradient in training is 0."""
    return name.endswith(".bias") and name.split(".")[-2].startswith("conv")


def _compare_metrics(jm, tm, what, value_size=1):
    assert sorted(jm) == sorted(tm), what
    for key in jm:
        # a distributional root value is h^-1 of an expectation over bins
        # of support +/-(value_size // 2), which scales a probability's
        # rounding error by up to 300 (601 bins) and h^-1's slope (~10 at
        # |v| = 17) again: held to 1e-4 of its size
        rtol = 1e-4 if key == "_new_values" and value_size > 1 else 0
        np.testing.assert_allclose(tm[key].numpy(), np.asarray(jm[key]), rtol=rtol, atol=ATOL,
                                   err_msg=f"{what}: {key}")


SMALL = dict(nn_num_blocks=1, nn_num_hidden_channels=16, nn_num_value_hidden_channels=16)
CASES = {
    # name: (env, overrides, batch size, distributional value bins)
    "go_az_sgd": ("go", dict(SMALL), 8, 0),
    "go_gumbel_kl_sgd": ("go", dict(SMALL, actor_use_gumbel=True), 8, 0),
    "ttt_az_adam": ("tictactoe", dict(SMALL, learner_optimizer="Adam", learner_learning_rate=0.001,
                                      learner_weight_decay=1e-4), 8, 0),
    "ttt_az_adamw": ("tictactoe", dict(SMALL, learner_optimizer="AdamW",
                                       learner_learning_rate=0.001, learner_weight_decay=0.01), 8, 0),
    "ttt_az_discrete_value_per": ("tictactoe", dict(SMALL, learner_use_per=True,
                                                    learner_value_loss_scale=0.5), 8, 21),
    "go_muzero_k2_sgd": ("go", dict(SMALL, nn_type_name="muzero", learner_muzero_unrolling_step=2),
                         8, 0),
    "ttt_gumbel_muzero_k2_adam": ("tictactoe", dict(
        SMALL, nn_type_name="muzero", learner_muzero_unrolling_step=2, actor_use_gumbel=True,
        learner_optimizer="Adam", learner_learning_rate=0.001), 8, 0),
    # Atari mode on a synthetic batch: 601-bin value and reward heads, the
    # reward CE, u8 pixels scaled by 1/255, PER's fresh values
    "atari_muzero_reward_k2": ("atari", dict(nn_num_blocks=1, nn_num_hidden_channels=8,
                                             nn_num_value_hidden_channels=8,
                                             learner_muzero_unrolling_step=2), 2, 0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_train_step_matches_jax(case):
    env_name, over, b, value_size = CASES[case]
    pair = _Pair(env_name, over, value_size=value_size)
    rng = np.random.default_rng(1)
    k = pair.tcfg.learner_muzero_unrolling_step
    for s in range(3):
        pair.sync()
        tbatch, jbatch = pair.batch(rng, b, k)
        jm, tm = pair.step(tbatch, jbatch, jax.random.PRNGKey(100 + s))
        if env_name == "atari":
            assert float(tm["loss_reward"]) > 0, "the reward loss did not run"
        _compare_metrics(jm, tm, f"{case} step {s}", pair.spec.discrete_value_size)
        pair.compare(f"{case} step {s}")


@pytest.mark.parametrize("count", [999_999, 1_000_000])
def test_step_decay_schedule_matches_jax(count):
    """StepLR(1e6, 0.1): the update at optimizer step 999,999 takes lr0, at
    1,000,000 lr0 / 10 — on both sides, from the same state."""
    pair = _Pair("tictactoe", dict(SMALL))
    js = pair.jstate
    sched = js.opt_state[2]._replace(count=jnp.asarray(count, js.opt_state[2].count.dtype))
    pair.jstate = js.replace(opt_state=(js.opt_state[0], js.opt_state[1], sched),
                             step=jnp.asarray(count, js.step.dtype))
    pair.sync()
    assert pair.tstate.step == count
    before = {k: v.clone() for k, v in pair.tnet.state_dict().items()}
    tbatch, jbatch = pair.batch(np.random.default_rng(2), 8, 0)
    jm, tm = pair.step(tbatch, jbatch, jax.random.PRNGKey(7))
    _compare_metrics(jm, tm, f"count {count}")
    pair.compare(f"count {count}")
    lr = learning_rate(pair.tcfg, count)
    assert lr == pytest.approx(0.02 if count < 1_000_000 else 0.002)
    # the first momentum step moves a weight by lr * (grad + wd * w)
    w = "policy_head.fc.weight"
    moved = float((pair.tnet.state_dict()[w] - before[w]).abs().max())
    assert 0 < moved < 10 * lr


# ----------------------------------------------------------- min-max backward
def _rows_with_ties(rng, shape):
    """Values on a coarse grid, so every row holds tied minima and maxima."""
    x = np.round(rng.uniform(0, 1, shape) * 4) / 4
    return x.astype(np.float32)


def test_minmax_backward_matches_jax_vjp_with_ties():
    rng = np.random.default_rng(3)
    x = _rows_with_ties(rng, (5, 4, 4, 6))  # NHWC, as the JAX package holds it
    x[1] = 0.5  # a constant row: the range is widened by 1e-5
    g = rng.normal(size=x.shape).astype(np.float32)
    y_j, vjp = jax.vjp(jscale_hidden_state, jnp.asarray(x))
    (gx_j,) = vjp(jnp.asarray(g))
    xt = torch.tensor(x).permute(0, 3, 1, 2).contiguous().requires_grad_(True)
    yt = scale_hidden_state(xt)
    yt.backward(torch.tensor(g).permute(0, 3, 1, 2))
    np.testing.assert_allclose(yt.detach().permute(0, 2, 3, 1).numpy(), np.asarray(y_j),
                               rtol=0, atol=1e-6)
    # the constant row's gradients are ~1e5 (divided by the 1e-5 range):
    # held to float32 rounding of their size
    np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 1).numpy(), np.asarray(gx_j),
                               rtol=1e-6, atol=1e-5)
    # the plain (inference) forward gives the same values
    with torch.no_grad():
        plain = scale_hidden_state(xt.detach())
    assert torch.equal(plain, yt.detach())


def test_minmax_backward_single_index_not_spread():
    """The gradient of a tied minimum goes to its first element only, as
    the JAX VJP does (torch's own amin backward splits it over the ties)."""
    x = torch.tensor([[0.0, 0.0, 1.0, 0.5]], requires_grad=True)
    y = minmax_normalize(x)
    y.backward(torch.tensor([[0.0, 0.0, 0.0, 1.0]]))
    y_j, vjp = jax.vjp(jscale_hidden_state, jnp.asarray(x.detach().numpy()))
    (gx_j,) = vjp(jnp.asarray([[0.0, 0.0, 0.0, 1.0]], jnp.float32))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(gx_j), rtol=0, atol=1e-7)
    assert float(x.grad[0, 1]) == 0.0 and float(x.grad[0, 0]) != 0.0


def test_minmax_gradcheck_float64():
    rng = np.random.default_rng(4)
    x = torch.tensor(rng.normal(size=(3, 7)), dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(minmax_normalize, (x,), eps=1e-6, atol=1e-7)


# ------------------------------------------------------------- BatchNorm
@pytest.mark.parametrize("shape", [(4, 3, 2, 2), (2, 5, 3, 3)])
def test_batchnorm_running_statistics_match_flax(shape):
    """Two train-mode updates: running mean and the BIASED running variance
    as flax's BatchNorm(momentum=0.9) keeps them; outputs equal; eval mode
    is torch's own."""
    rng = np.random.default_rng(5)
    c = shape[1]
    fbn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    x0 = rng.normal(size=shape).astype(np.float32)
    variables = fbn.init(jax.random.PRNGKey(0), jnp.asarray(x0.transpose(0, 2, 3, 1)))
    bn = BatchNorm2d(c, eps=1e-5, momentum=0.1)
    ref = torch.nn.BatchNorm2d(c, eps=1e-5, momentum=0.1)
    bn.train()
    for i in range(2):
        x = (rng.normal(size=shape) * (i + 1) + i).astype(np.float32)
        y_f, mutated = fbn.apply(variables, jnp.asarray(x.transpose(0, 2, 3, 1)),
                                 mutable=["batch_stats"])
        variables = {"params": variables["params"], "batch_stats": mutated["batch_stats"]}
        y_t = bn(torch.tensor(x))
        np.testing.assert_allclose(y_t.detach().permute(0, 2, 3, 1).numpy(), np.asarray(y_f),
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(bn.running_mean.numpy(),
                                   np.asarray(variables["batch_stats"]["mean"]), rtol=0, atol=1e-6)
        np.testing.assert_allclose(bn.running_var.numpy(),
                                   np.asarray(variables["batch_stats"]["var"]), rtol=0, atol=1e-6)
    ref.load_state_dict(bn.state_dict())
    bn.eval()
    ref.eval()
    x = torch.tensor(rng.normal(size=shape).astype(np.float32))
    assert torch.equal(bn(x), ref(x))


def test_train_step_leaves_the_net_in_eval_mode_and_lowers_the_loss():
    """30 steps on one fixed batch lower its loss (as
    ``tests/test_train.py::test_train_step_reduces_loss`` holds the JAX
    step); the net is in eval mode after every step."""
    cfg = default_config("tictactoe", **SMALL, learner_batch_size=16)
    env = make_env(cfg)
    net = create_network(cfg, env.spec)
    state = init_train_state(cfg, net)
    step = make_train_step(cfg, env, net)
    rng = np.random.default_rng(6)
    pair = types.SimpleNamespace(spec=env.spec, muzero=False)
    tbatch, _ = _Pair.batch(pair, rng, 16, 0)
    rots = torch.zeros(16, dtype=torch.int64)
    first = None
    for _ in range(30):
        m = step(state, tbatch, rotations=rots)
        assert not net.training
        first = float(m["loss"]) if first is None else first
    assert float(m["loss"]) < first
    assert state.step == 30

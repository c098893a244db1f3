"""Helpers of the port's env-family tests (``tests/test_torch_envs_*.py``):
random playouts stepped through a JAX env and its port in lock-step, and a
parity net with integer weights in both frameworks at any env's shapes.

Not a test module: import the names."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch
from torch import nn

from parity_common import ACTION_OFFSET, POLICY_SCALE, VALUE_CLAMP, VALUE_SCALE


def jax_batch(env, batch):
    one = env.init()
    return jax.tree_util.tree_map(lambda x: jnp.broadcast_to(x, (batch,) + x.shape), one)


def check_state(js, ts, what, skip=()):
    """Every field of the port's batched state but those in ``skip`` equals
    the JAX one's."""
    for f in dataclasses.fields(ts):
        if f.name in skip:
            continue
        want = np.asarray(getattr(js, f.name))
        got = getattr(ts, f.name).numpy()
        assert want.shape == got.shape, f"{what}: {f.name} shape {got.shape} != {want.shape}"
        np.testing.assert_array_equal(want.astype(np.int64), got.astype(np.int64),
                                      err_msg=f"{what}: field {f.name}")


def stone_labels(env, board):
    """i32[B, NN]: from-scratch block labels of a batch of boards on the
    port's Go-family ``env`` (its ``step`` keeps them incrementally)."""
    tb = env._tables(board.device)
    active = board > 0
    connected = (board[:, tb["nbr"]] == board[:, :, None]) & tb["nbr_valid"] & active[:, :, None]
    return env._cc_labels(active, connected)


def playout_parity(jenv, tenv, moves, batch, seed, choose=None, on_step=None, chance=None):
    """Random legal playouts through both envs in lock-step, a finished game
    restarting in its slot. After every move the state's fields, the legal
    mask, the features, ``is_terminal``, ``eval_score`` and ``turn`` must be
    equal. ``choose(step, legal, rng, ts)`` may override the random action
    (i32[B]); ``on_step(step, js, ts)`` sees each pair of states. Returns
    the number of finished games and the eval scores they ended with.

    ``chance`` = (stream fields, init, step) for the stochastic envs, whose
    chance streams differ between the packages: the port's state fields of
    its stream are not compared, ``init(js)`` builds the port's states from
    JAX states and ``step(ts, action, js_next)`` steps the port's states
    with the chance events read off the JAX env's stepped states."""
    jstep = jax.jit(jax.vmap(jenv.step))
    jlegal = jax.jit(jax.vmap(jenv.legal_mask))
    jfeat = jax.jit(jax.vmap(jenv.features))
    jterm = jax.jit(jax.vmap(jenv.is_terminal))
    jscore = jax.jit(jax.vmap(jenv.eval_score))
    jturn = jax.jit(jax.vmap(jenv.turn))
    skip, tinit, tstep = chance if chance is not None else ((), None, None)
    j0 = jax_batch(jenv, batch)
    t0 = tenv.init(batch, device="cpu") if tinit is None else tinit(j0)
    js, ts = j0, t0
    rng = np.random.default_rng(seed)
    ended, scores = 0, []
    for step in range(moves + 1):
        what = f"move {step}"
        check_state(js, ts, what, skip)
        legal = tenv.legal_mask(ts).numpy()
        np.testing.assert_array_equal(np.asarray(jlegal(js)), legal, err_msg=f"{what}: legal")
        np.testing.assert_array_equal(np.asarray(jfeat(js)), tenv.features(ts).numpy(),
                                      err_msg=f"{what}: features")
        term = tenv.is_terminal(ts).numpy()
        np.testing.assert_array_equal(np.asarray(jterm(js)), term, err_msg=f"{what}: terminal")
        score = tenv.eval_score(ts).numpy()
        np.testing.assert_array_equal(np.asarray(jscore(js)), score, err_msg=f"{what}: score")
        np.testing.assert_array_equal(np.asarray(jturn(js)), tenv.turn(ts).numpy(),
                                      err_msg=f"{what}: turn")
        if on_step is not None:
            on_step(step, js, ts)
        if step == moves:
            break
        ended += int(term.sum())
        scores += score[term].tolist()
        # a finished game restarts in its slot, on both sides
        done = jnp.asarray(term)
        js = jax.tree_util.tree_map(
            lambda x, y: jnp.where(done.reshape((-1,) + (1,) * (x.ndim - 1)), y, x), js, j0)
        keep = torch.from_numpy(~term)
        ts = type(ts)(**{f.name: torch.where(keep.reshape((-1,) + (1,) * (getattr(ts, f.name).dim() - 1)),
                                             getattr(ts, f.name), getattr(t0, f.name))
                         for f in dataclasses.fields(ts)})
        legal = tenv.legal_mask(ts).numpy()
        action = (rng.random(legal.shape) * legal + 1e-9 * legal).argmax(-1).astype(np.int32)
        if choose is not None:
            action = choose(step, legal, rng, ts, action)
        js = jstep(js, jnp.asarray(action))
        if tstep is None:
            ts = tenv.step(ts, torch.from_numpy(action))
        else:
            ts = tstep(ts, torch.from_numpy(action), js)
    return ended, scores


def parity_weights_for(dims, seed=20260820):
    """Integer parity weights (``parity_common.parity_weights``' recipe) at
    ``dims`` = (C, H, W, A)."""
    c, h, w, a = dims
    rng = np.random.Generator(np.random.PCG64(seed + a * 1009))
    return (rng.integers(-7, 8, size=(c, h, w, a), dtype=np.int8),
            rng.integers(-3, 4, size=(c, h, w), dtype=np.int8))


def jax_parity_network_for(dims):
    """``parity_common.jax_parity_network`` at any env's ``dims``: exact
    integer sums, so both frameworks' logits and values are equal."""
    from flax import linen as fnn

    from minizero_tpu.models.alphazero import AlphaZeroNetwork

    c, h, w, a = dims

    class ParityNet(AlphaZeroNetwork):
        @fnn.compact
        def __call__(self, state, train: bool = False):
            wp = self.param("Wp", lambda k: jnp.zeros((c, h, w, a), jnp.float32))
            wv = self.param("Wv", lambda k: jnp.zeros((c, h, w), jnp.float32))
            x = state.astype(jnp.float32)
            logits = (jnp.einsum("bhwc,chwa->ba", x, wp) / POLICY_SCALE
                      + jnp.arange(a, dtype=jnp.float32) * ACTION_OFFSET)
            value = jnp.clip(jnp.einsum("bhwc,chw->b", x, wv) / VALUE_SCALE,
                             -VALUE_CLAMP, VALUE_CLAMP)
            return {"policy_logit": logits, "policy": fnn.softmax(logits, axis=-1),
                    "value": value[:, None]}

    net = ParityNet(num_input_channels=c, input_height=h, input_width=w, num_hidden_channels=1,
                    hidden_height=h, hidden_width=w, num_blocks=0, action_size=a,
                    num_value_hidden_channels=1, discrete_value_size=1)
    wp, wv = parity_weights_for(dims)
    return net, {"params": {"Wp": jnp.asarray(wp, jnp.float32), "Wv": jnp.asarray(wv, jnp.float32)}}


class TorchParityNetFor(nn.Module):
    """The same parity net in torch."""

    def __init__(self, dims):
        super().__init__()
        wp, wv = parity_weights_for(dims)
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


def engine_parity(env_name, algo, sims, moves=3, batch=4, opening=4, seed=5, over=None,
                  jenv=None, tenv=None, nets=None, force_v2=False, stream_fields=(),
                  root_visits=False):
    """Self-play moves of the port's engine against the JAX engine's on the
    parity net of ``env_name``'s shapes, noise and rotation off, select by
    count: both start from ``opening`` random legal plies from the envs'
    ``init`` states (the same actions on both sides); then each move's
    action, features, done, eval score, resign score, turn, reward and
    stepped state (but ``stream_fields``) are exact, policy targets and root
    values within ``tests/test_torch_engine.py``'s bounds. ``jenv``/``tenv``
    replace the envs ``make_env`` builds, ``nets`` = (JAX net, its
    variables, torch net) the parity nets; ``force_v2`` takes the large-N
    loop on both sides; with ``root_visits`` each move's search trees are
    also compared: the root children's visit counts exact. Returns the
    port's engine."""
    from minizero_tpu.config import default_config as j_default
    from minizero_tpu.envs import make_env as j_make_env
    from minizero_tpu.selfplay.engine import SelfPlayEngine as JEngine
    from minizero_tpu_torch.config import algorithm_preset, default_config
    from minizero_tpu_torch.envs import make_env
    from minizero_tpu_torch.selfplay.engine import SelfPlayEngine

    o = dict(algorithm_preset(algo))
    o.update(actor_num_simulation=sims, actor_gumbel_sample_size=4,
             actor_select_action_by_count=True, actor_use_gumbel_noise=False,
             actor_use_dirichlet_noise=False, actor_use_random_rotation_features=False,
             **(over or {}))
    jcfg = j_default(env_name, **o)
    jenv = jenv or j_make_env(jcfg)
    spec = jenv.spec
    dims = (spec.num_input_channels, spec.input_height, spec.input_width, spec.action_size)
    jnet, jvars, tnet = nets or (*jax_parity_network_for(dims), TorchParityNetFor(dims))
    jeng = JEngine(jenv, jcfg, jnet, use_bf16=False, _force_kernel_v2=force_v2)
    cfg = default_config(env_name, **o)
    tenv = tenv or make_env(cfg)
    eng = SelfPlayEngine(tenv, cfg, tnet, use_bf16=False, device="cpu",
                         _force_kernel_v2=force_v2)
    assert eng.use_tree_kernel_v2 == jeng.use_tree_kernel_v2
    js, ts = jax_batch(jenv, batch), tenv.init(batch, device="cpu")
    jstep = jax.jit(jax.vmap(jenv.step))
    rng = np.random.default_rng(seed)
    for _ in range(opening):
        legal = tenv.legal_mask(ts).numpy()
        a = (rng.random(legal.shape) * legal + 1e-9 * legal).argmax(-1).astype(np.int32)
        js, ts = jstep(js, jnp.asarray(a)), tenv.step(ts, torch.from_numpy(a))
    key = jax.random.PRNGKey(7)
    for mv in range(moves):
        key, k = jax.random.split(key)
        if root_visits:
            from minizero_tpu.search import mcts as jmcts
            from minizero_tpu_torch.search import mcts

            want = jax.vmap(jmcts.root_children_visits)(jeng.search_trees(jvars, js, k))
            got = mcts.root_children_visits(eng.search_trees(ts))
            np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                          err_msg=f"move {mv} root visits")
        jout = jeng.move(jvars, js, k)
        out = eng.move(ts)
        np.testing.assert_array_equal(out.action.numpy(), np.asarray(jout.action),
                                      err_msg=f"move {mv} action")
        np.testing.assert_allclose(out.policy_target.numpy(), np.asarray(jout.policy_target),
                                   rtol=0.05, atol=0.02, err_msg=f"move {mv} policy target")
        np.testing.assert_allclose(out.root_value.numpy(), np.asarray(jout.root_value),
                                   rtol=1e-2, atol=5e-3, err_msg=f"move {mv} root value")
        np.testing.assert_array_equal(out.features.numpy(), np.asarray(jout.features),
                                      err_msg=f"move {mv} features")
        for name in ("done", "eval_score", "resign_score", "turn", "reward"):
            np.testing.assert_array_equal(getattr(out, name).numpy(),
                                          np.asarray(getattr(jout, name)),
                                          err_msg=f"move {mv} {name}")
        check_state(jout.states, out.states, f"move {mv}", stream_fields)
        js, ts = jout.states, out.states
    return eng

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


def check_state(js, ts, what):
    """Every field of the port's batched state equals the JAX one's."""
    for f in dataclasses.fields(ts):
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


def playout_parity(jenv, tenv, moves, batch, seed, choose=None, on_step=None):
    """Random legal playouts through both envs in lock-step, a finished game
    restarting in its slot. After every move the state's fields, the legal
    mask, the features, ``is_terminal``, ``eval_score`` and ``turn`` must be
    equal. ``choose(step, legal, rng, ts)`` may override the random action
    (i32[B]); ``on_step(step, js, ts)`` sees each pair of states. Returns
    the number of finished games and the eval scores they ended with."""
    jstep = jax.jit(jax.vmap(jenv.step))
    jlegal = jax.jit(jax.vmap(jenv.legal_mask))
    jfeat = jax.jit(jax.vmap(jenv.features))
    jterm = jax.jit(jax.vmap(jenv.is_terminal))
    jscore = jax.jit(jax.vmap(jenv.eval_score))
    jturn = jax.jit(jax.vmap(jenv.turn))
    j0 = jax_batch(jenv, batch)
    t0 = tenv.init(batch, device="cpu")
    js, ts = j0, t0
    rng = np.random.default_rng(seed)
    ended, scores = 0, []
    for step in range(moves + 1):
        what = f"move {step}"
        check_state(js, ts, what)
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
        ts = tenv.step(ts, torch.from_numpy(action))
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

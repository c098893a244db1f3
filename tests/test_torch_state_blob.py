"""The port's state blob and row gather held against the JAX package.

``pack_rows`` / ``unpack_rows`` must round-trip Go states exactly, and the
port's row must equal the JAX package's row for the same state word for
word (the field order of the state dataclass is the flax pytree order).
``gather_rows_reference`` (what ``gather_rows`` runs on the CPU) must equal
the JAX ``gather_rows`` (Pallas, interpret mode) on every row whose index
is in range, for odd batches, node counts that are not a multiple of 8 and
skip lanes (-1). All comparisons are exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minizero_tpu.envs.go import GoEnv as JGoEnv
from minizero_tpu.ops.gather_rows import gather_rows as j_gather_rows
from minizero_tpu.ops.state_blob import blob_spec as j_blob_spec
from minizero_tpu.ops.state_blob import pack_rows as j_pack_rows
from minizero_tpu_torch.envs.go import GoEnv as TGoEnv
from minizero_tpu_torch.ops.gather_rows import gather_rows, gather_rows_reference
from minizero_tpu_torch.ops.state_blob import blob_spec, pack_rows, unpack_rows


def _playout(board_size, moves, batch, seed):
    """Random legal playouts in both packages from the same numpy draws;
    returns the final (jax, torch) batched states."""
    jenv, tenv = JGoEnv(board_size=board_size), TGoEnv(board_size=board_size)
    rng = np.random.default_rng(seed)
    jstep = jax.jit(jax.vmap(jenv.step))
    one = jenv.init()
    js = jax.tree_util.tree_map(lambda x: jnp.broadcast_to(x, (batch,) + x.shape), one)
    ts = tenv.init(batch, device="cpu")
    nn = board_size * board_size
    for _ in range(moves):
        legal = tenv.legal_mask(ts).numpy()
        scores = rng.random(legal.shape) * legal
        scores[:, nn] = np.where(rng.random(batch) < 0.1, 2.0, 1e-3)
        action = scores.argmax(-1).astype(np.int32)
        js = jstep(js, jnp.asarray(action))
        ts = tenv.step(ts, torch.from_numpy(action))
    return js, ts


@pytest.mark.parametrize("board_size,moves", [(5, 40), (9, 60)])
def test_blob_roundtrip_and_jax_layout(board_size, moves):
    batch = 7
    js, ts = _playout(board_size, moves, batch, seed=board_size)
    spec = blob_spec(ts)
    blob = pack_rows(spec, ts)
    assert blob.dtype == torch.int32 and blob.shape == (batch, spec.width)
    back = unpack_rows(spec, blob)
    for f in dataclasses.fields(ts):
        want, got = getattr(ts, f.name), getattr(back, f.name)
        assert got.dtype == want.dtype and got.shape == want.shape, f.name
        assert torch.equal(got, want), f.name
    # word for word the JAX package's row of the same state
    jspec = j_blob_spec(jax.tree_util.tree_map(lambda x: x[0], js))
    assert jspec.width == spec.width
    np.testing.assert_array_equal(blob.numpy(), np.asarray(j_pack_rows(jspec, js)))
    if board_size == 9:
        assert spec.width == 697  # 2,788 bytes per Go 9x9 state


@pytest.mark.parametrize("board_size,moves", [(5, 40), (9, 60)])
def test_unpack_rows_ignores_a_padded_stride(board_size, moves):
    """The large-N engine stores rows at a stride rounded up to 4 words:
    a row followed by random pad words unpacks to the same state as the
    bare row."""
    tenv = TGoEnv(board_size=board_size)
    rng = np.random.default_rng(board_size)
    ts = tenv.init(6, device="cpu")
    for _ in range(moves):
        legal = tenv.legal_mask(ts).numpy()
        ts = tenv.step(ts, torch.from_numpy((rng.random(legal.shape) * legal).argmax(-1)
                                            .astype(np.int32)))
    spec = blob_spec(ts)
    bare = pack_rows(spec, ts)
    stride = -(-spec.width // 4) * 4
    assert stride > spec.width  # 221 -> 224 (5x5), 697 -> 700 (9x9)
    pad = torch.from_numpy(rng.integers(-2**31, 2**31, (6, stride - spec.width),
                                        dtype=np.int64).astype(np.int32))
    padded = torch.cat([bare, pad], dim=1)
    want, got = unpack_rows(spec, bare), unpack_rows(spec, padded)
    for f in dataclasses.fields(ts):
        assert torch.equal(getattr(got, f.name), getattr(want, f.name)), f.name
        assert torch.equal(getattr(got, f.name), getattr(ts, f.name)), f.name
    # a padded row gathered from a [B, N, stride] blob unpacks the same way
    blob = torch.stack([padded, torch.zeros_like(padded)], dim=1)
    again = unpack_rows(spec, gather_rows(blob, torch.zeros(6, dtype=torch.int32)))
    for f in dataclasses.fields(ts):
        assert torch.equal(getattr(again, f.name), getattr(ts, f.name)), f.name


@pytest.mark.parametrize("b,n,w", [(5, 7, 697), (13, 12, 128), (8, 8, 128), (12, 40, 256),
                                   (64, 208, 768)])
def test_gather_rows_reference_matches_jax(b, n, w):
    rng = np.random.default_rng(b * 1000 + n)
    x = rng.integers(-2**31, 2**31, (b, n, w), dtype=np.int64).astype(np.int32)
    idx = rng.integers(0, n, (b,)).astype(np.int32)
    idx[rng.random(b) < 0.3] = -1  # skip lanes
    got = gather_rows_reference(torch.from_numpy(x), torch.from_numpy(idx)).numpy()
    assert (got[idx < 0] == 0).all()
    # the Pallas kernel needs N % 8 == 0 and W % 128 == 0: pad for it only
    npad, wpad = -(-n // 8) * 8, -(-w // 128) * 128
    xj = np.zeros((b, npad, wpad), np.int32)
    xj[:, :n, :w] = x
    want = np.asarray(j_gather_rows(jnp.asarray(xj), jnp.asarray(idx), interpret=True))[:, :w]
    keep = idx >= 0
    np.testing.assert_array_equal(got[keep], want[keep])
    # on CPU tensors the wrapper is the plain version
    np.testing.assert_array_equal(gather_rows(torch.from_numpy(x), torch.from_numpy(idx)).numpy(),
                                  got)


def test_gather_rows_parent_states_of_a_blob():
    """The engine's use: a [B, N, W] blob of Go states, a per-game node
    index, and the gathered rows unpack to exactly those nodes' states."""
    batch, nodes = 5, 9
    _, ts = _playout(9, 30, batch * nodes, seed=3)
    spec = blob_spec(ts)
    blob = pack_rows(spec, ts).reshape(batch, nodes, spec.width)
    idx = torch.tensor([0, 8, 3, 3, 5], dtype=torch.int32)
    got = unpack_rows(spec, gather_rows(blob, idx))
    flat = torch.arange(batch) * nodes + idx.long()
    for f in dataclasses.fields(ts):
        assert torch.equal(getattr(got, f.name), getattr(ts, f.name)[flat]), f.name
    # an index outside [0, N) skips the game: the plain version gives zeros
    skipped = gather_rows(blob, torch.tensor([-1, nodes, 2, -5, nodes + 3], dtype=torch.int32))
    assert not skipped[[0, 1, 3, 4]].any() and torch.equal(skipped[2], blob[2, 2])

"""The plain tree steps past 384 actions held against the JAX package, and
the rank identity that the wide CUDA tree step's halving tick relies on.

The CUDA tree steps keep a row of up to 384 actions in a lane's registers
and take a wide kernel above (``csrc/tree_step.cu``,
``csrc/tree_step_v2.cu``); on the card each is held against the plain
version, which is what runs here. These cases run the plain versions at
A = 400 (Clobber's action count), 801 (Tetris Block Puzzle) and 3040
(Amazons) against the JAX package's Pallas kernels in interpret mode, with
the inputs and checks of ``tests/test_torch_search_kernel.py`` and
``tests/test_torch_tree_kernel_v2.py`` (integers exact, floats within their
stated tolerances), at a few games and simulations past 400 actions. The
shared memory that the CUDA launchers size a block by, and the shapes they
refuse, are checked on the card
(``tests/test_torch_gpu.py::test_shared_memory_ceilings``).
"""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import test_torch_search_kernel as b1_parity  # noqa: E402
import test_torch_tree_kernel_v2 as b2_parity  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401


@pytest.mark.parametrize("regime", ["board", "atari"])
def test_plain_tree_step_at_400_actions_matches_jax_kernel(regime, monkeypatch):
    """The Gumbel search of ``test_tree_step_reference_matches_jax_kernel``
    at A = 400, in the board regime and in the MuZero Atari regime."""
    monkeypatch.setattr(b1_parity, "A", 400)
    b1_parity.test_tree_step_reference_matches_jax_kernel(True, regime)


def test_plain_tree_step_v2_at_400_actions_matches_jax_kernel(monkeypatch):
    """The staged v2 search of ``test_tree_step_v2_reference_matches_jax_kernel``
    at A = 400, with many terminal leaves."""
    monkeypatch.setattr(b2_parity, "A", 400)
    b2_parity.test_tree_step_v2_reference_matches_jax_kernel(True, False, 0.45)


@pytest.mark.parametrize("regime", ["board", "atari"])
@pytest.mark.parametrize("a", [801, 3040])
def test_plain_tree_step_wide_matches_jax_kernel(a, regime, monkeypatch):
    """The Gumbel search of ``test_tree_step_reference_matches_jax_kernel``
    at A = 801 and 3040 (2 games, 6 simulations, m = 4: a halving tick), in
    the board regime and in the MuZero Atari regime."""
    for name, value in (("A", a), ("B", 2), ("SIMS", 6)):
        monkeypatch.setattr(b1_parity, name, value)
    b1_parity.test_tree_step_reference_matches_jax_kernel(True, regime)


@pytest.mark.parametrize("a", [801, 3040])
def test_plain_tree_step_v2_wide_matches_jax_kernel(a, monkeypatch):
    """The v2 search of ``test_tree_step_v2_reference_matches_jax_kernel``
    at A = 801 and 3040 (3 games, 8 simulations), with many terminal
    leaves."""
    for name, value in (("A", a), ("B", 3), ("SIMS", 8)):
        monkeypatch.setattr(b2_parity, name, value)
    b2_parity.test_tree_step_v2_reference_matches_jax_kernel(False, False, 0.45)


def test_active_set_rank_equals_the_jax_whole_row_rank():
    """The wide CUDA tree step's halving tick ranks the active actions among
    themselves (pairwise, ties to the lower index) and adds the inactive
    actions, which all score NEG_INF, that a whole-row rank counts: for an
    active score of NEG_INF those of lower index (its index less its
    position among the active), for one below NEG_INF all of them. It then
    keeps the first maximum of the kept scores over the row, every other
    action at NEG_INF: the first kept maximum, or the lowest action not
    kept when NEG_INF reaches the maximum. Both equal the JAX package's
    whole-row pairwise rank (``search/gumbel.py::_top_k_mask``) and its
    argmax, for every k, on rows full of ties, -0.0 against +0.0, NEG_INF
    and values below it."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from minizero_tpu.search import gumbel as jgz

    top_k_all = jax.jit(jax.vmap(jgz._top_k_mask, in_axes=(None, None, 0)))
    neg = np.float32(-3.4e38)
    below = np.nextafter(neg, np.float32(-np.inf))
    pool = np.array([-0.0, 0.0, 0.5, -1.0, 2.0, neg, neg, below, -np.inf], np.float32)
    rng = np.random.default_rng(1456)
    for a in (7, 40, 402):
        for row in range(24):
            vals = pool[rng.integers(0, len(pool), size=a)]
            if row % 4 == 3:
                vals = rng.normal(size=a).astype(np.float32)
            mask = rng.random(a) < (0.1, 0.5, 0.95)[row % 3]
            active = np.flatnonzero(mask)
            s = vals[active]
            m = len(active)
            pos = np.arange(m)
            rank = np.array([np.sum((s > s[i]) | ((s == s[i]) & (pos < i))) for i in range(m)],
                            dtype=np.int64)
            rank += np.where(s == neg, active - pos, np.where(s < neg, a - m, 0))
            wants = top_k_all(jnp.asarray(vals), jnp.asarray(mask), jnp.arange(a + 2))
            want_bests = np.asarray(jnp.argmax(jnp.where(wants, jnp.asarray(vals), neg), axis=1))
            wants = np.asarray(wants)
            for k in range(m + 2):
                keep = np.zeros(a, bool)
                keep[active[rank < k]] = True
                np.testing.assert_array_equal(keep, wants[k], err_msg=f"A={a} row {row} k={k}")
                kept = active[rank < k]
                best = None
                if len(kept):
                    top = vals[kept].max()
                    best = int(kept[vals[kept] == top][0])
                if len(kept) < a and (best is None or vals[best] <= neg):
                    clear = int(np.flatnonzero(~keep)[0])
                    best = clear if best is None or vals[best] < neg else min(best, clear)
                assert best == int(want_bests[k]), (a, row, k)


def test_gumbel_top_k_by_sort_equals_the_jax_pairwise_rank():
    """The port ranks the Gumbel candidates by a stable sort (O(A) a row);
    the JAX package by a pairwise table. Equal on rows full of ties, -0.0
    against +0.0, masked entries and every k, at A up to 3040."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from minizero_tpu.search import gumbel as jgz
    from minizero_tpu_torch.search import gumbel as tgz

    rng = np.random.default_rng(3040)
    pool = np.array([-0.0, 0.0, 0.5, -1.0, 2.0, -3.4e38], np.float32)
    for a in (7, 82, 400, 3040):
        vals = pool[rng.integers(0, len(pool), size=(8, a))]
        vals[4:] = rng.normal(size=(4, a)).astype(np.float32)
        mask = rng.random((8, a)) < 0.7
        k = rng.integers(0, a + 2, size=8).astype(np.int32)
        want = jax.vmap(jgz._top_k_mask)(jnp.asarray(vals), jnp.asarray(mask), jnp.asarray(k))
        got = tgz._top_k_mask(torch.from_numpy(vals), torch.from_numpy(mask), torch.from_numpy(k))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=f"A={a}")

"""The plain tree steps past 384 actions held against the JAX package, and
the CUDA wrappers' shared-memory ceiling.

The CUDA tree steps keep a row of up to 384 actions in a lane's registers
and take a wide kernel above (``csrc/tree_step.cu``,
``csrc/tree_step_v2.cu``); on the card each is held against the plain
version, which is what runs here. These cases run the plain versions at
A = 400 (Clobber's action count) against the JAX package's Pallas kernels in
interpret mode, with the inputs and checks of
``tests/test_torch_search_kernel.py`` and ``tests/test_torch_tree_kernel_v2.py``
(integers exact, floats within their stated tolerances). The shared memory
that the CUDA launchers size a block by, and the shapes they refuse, are
checked on the card (``tests/test_torch_gpu.py::test_shared_memory_ceilings``).
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

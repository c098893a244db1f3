"""Card-only tests of the port's CUDA kernels, and the port's import guard.

The ``gpu`` tests need a CUDA device: a CUDA kernel has no CPU mode, so they
skip without one (decided inside the test). Run them on a card with
``python -m pytest tests/test_torch_gpu.py -m gpu``.
"""

import dataclasses
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA tree-step kernel has no CPU mode")


@pytest.mark.gpu
@pytest.mark.parametrize("use_gumbel", [True, False])
def test_tree_step_kernel_matches_plain_on_card(use_gumbel):
    """Every tree step of two moves at B=256 (Go 9x9, n=16, a 1 x 64 net):
    the CUDA kernel and the plain version run from the same state; integer
    outputs exact, float outputs within 1e-5."""
    _need_card()
    from minizero_tpu_torch.config import algorithm_preset, default_config
    from minizero_tpu_torch.envs import make_env
    from minizero_tpu_torch.models.factory import create_network, init_network
    from minizero_tpu_torch.ops.tree_kernel import fused_tree_step, tree_step_reference
    from minizero_tpu_torch.selfplay.engine import SelfPlayEngine

    over = dict(algorithm_preset("gaz")) if use_gumbel else dict(algorithm_preset("az"))
    over.update(actor_num_simulation=16, nn_num_hidden_channels=64, nn_num_value_hidden_channels=64)
    cfg = default_config("go", **over)
    env = make_env(cfg)
    eng = SelfPlayEngine(env, cfg, init_network(create_network(cfg, env.spec), seed=2),
                         device="cuda", seed=4)
    calls = []

    def checked(spec, trees, sel, *rest):
        ref_sel = dataclasses.replace(sel, **{f.name: getattr(sel, f.name).clone()
                                              for f in dataclasses.fields(sel)})
        want_t, want_s = tree_step_reference(spec, trees.clone(), ref_sel, *rest)
        before = fused_tree_step.launches
        got_t, got_s = fused_tree_step(spec, trees, sel, *rest)
        assert fused_tree_step.launches == before + 1
        for f in dataclasses.fields(got_t):
            got, want = getattr(got_t, f.name), getattr(want_t, f.name)
            if got.dtype.is_floating_point:
                torch.testing.assert_close(got, want, rtol=0, atol=1e-5, msg=f.name)
            else:
                assert torch.equal(got, want), f.name
        for name in ("parent", "action", "leaf", "is_new", "path"):
            assert torch.equal(getattr(got_s, name), getattr(want_s, name)), name
        calls.append(rest[-2])
        return got_t, got_s

    eng.tree_step = checked
    states = eng.init_batch(256)
    for _ in range(2):
        states = eng.move(states).states
    torch.cuda.synchronize()
    assert calls == list(range(17)) * 2


def test_port_and_chip_smoke_import_without_jax():
    """``minizero_tpu_torch`` (every module) and ``chip_smoke`` import with
    jax, flax, msgpack and the JAX package blocked."""
    code = "\n".join([
        "import importlib, pkgutil, sys",
        "for name in ('jax', 'jaxlib', 'flax', 'optax', 'msgpack', 'minizero_tpu', 'tests'):",
        "    sys.modules[name] = None",
        "import minizero_tpu_torch",
        "for m in pkgutil.walk_packages(minizero_tpu_torch.__path__, 'minizero_tpu_torch.'):",
        "    importlib.import_module(m.name)",
        "import chip_smoke",
        "assert not any(k.split('.')[0] in ('jax', 'flax', 'minizero_tpu') and sys.modules[k] is not None",
        "               for k in list(sys.modules))",
    ])
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=300)


def test_entry_points_raise_without_a_card():
    """Entry points default to CUDA and raise where there is none; the CPU
    runs only when asked for."""
    from minizero_tpu_torch import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device()

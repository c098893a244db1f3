"""Export a ZeroLoop checkpoint's inference variables to an ``.npz`` that
the PyTorch port reads with numpy alone.

    python scripts/export_trained_weights.py [CKPT] [OUT] [ENV] [PRESET]

Defaults: ``runs/go9_az200_r3b/model/weight_iter_25000.ckpt`` (the net the
JAX ``bench.py`` times az n=200 with) into
``minizero_tpu_torch/assets/go9_az200_r3b_iter25000.npz``, with the env
``go`` and the preset ``az``. The trained Othello net of ``runs/oth8_gaz_r5``
(Gumbel AlphaZero, 1 x 256) is exported with

    python scripts/export_trained_weights.py \
        runs/oth8_gaz_r5/model/weight_iter_60000.ckpt \
        minizero_tpu_torch/assets/oth8_gaz_r5_iter60000.npz othello gaz

and the trained 2048 net of ``runs/p2048_gmz_r5`` (Gumbel MuZero, 1 x 256,
the board-game MuZero net: no reward head) with

    python scripts/export_trained_weights.py \
        runs/p2048_gmz_r5/model/weight_iter_30000.ckpt \
        minizero_tpu_torch/assets/p2048_gmz_r5_iter30000.npz puzzle2048 gmz

The checkpoint is
a pickle of flax msgpack bytes (``eval/match.py::load_checkpoint_variables``
reads it); the ``.npz`` holds ``params`` and ``batch_stats`` flattened to
"/"-joined keys, which ``minizero_tpu_torch.weights.load_variables_npz``
nests again for ``weights.from_jax_variables``. The net's shape comes from
``default_config(ENV, **algorithm_preset(PRESET))``: the default is the
Go 9x9 ``az`` preset at n=200 (``bench.py:60``). Runs on the CPU.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from minizero_tpu.config import algorithm_preset, default_config  # noqa: E402
from minizero_tpu.envs import make_env  # noqa: E402
from minizero_tpu.eval.match import load_checkpoint_variables  # noqa: E402
from minizero_tpu.models.factory import create_network  # noqa: E402

CKPT = os.path.join(ROOT, "runs", "go9_az200_r3b", "model", "weight_iter_25000.ckpt")
OUT = os.path.join(ROOT, "minizero_tpu_torch", "assets", "go9_az200_r3b_iter25000.npz")


def flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(flatten(v, key))
        else:
            out[key] = np.asarray(v, dtype=np.float32)
    return out


def main(ckpt: str = CKPT, out: str = OUT, env_name: str = "go", preset: str = "az") -> None:
    cfg = default_config(env_name, **algorithm_preset(preset))
    if (env_name, preset) == ("go", "az"):
        cfg = cfg.replace(actor_num_simulation=200)
    env = make_env(cfg)
    net = create_network(cfg, env.spec)
    variables = load_checkpoint_variables(ckpt, cfg, net, env.spec)
    flat = flatten(jax.tree_util.tree_map(np.asarray, variables))
    os.makedirs(os.path.dirname(out), exist_ok=True)
    np.savez_compressed(out, **flat)
    print(f"{out}: {len(flat)} arrays, {sum(v.size for v in flat.values())} floats, "
          f"{os.path.getsize(out)} bytes")


if __name__ == "__main__":
    main(*sys.argv[1:5])

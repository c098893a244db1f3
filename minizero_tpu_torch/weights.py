"""JAX (flax) AlphaZero variables -> the port's ``state_dict``.

``from_jax_variables`` takes the flax variable tree as nested dicts of numpy
arrays (``{"params": ..., "batch_stats": ...}``, as
``minizero_tpu.models.factory.init_network`` returns it after
``jax.tree_util.tree_map(np.asarray, ...)``) and returns a ``state_dict`` for
``models.alphazero.AlphaZeroNetwork``:

  * conv kernels HWIO -> OIHW; dense kernels (in, out) -> (out, in)
  * BatchNorm scale/bias/mean/var -> weight/bias/running_mean/running_var
  * the first dense layer of each head reads a flattened NHWC map in flax
    and an NCHW map here, so its input rows are permuted
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _conv(p: Mapping) -> Dict[str, np.ndarray]:
    return {"weight": np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1)),
            "bias": np.asarray(p["bias"])}


def _dense(p: Mapping, nhwc_hw: int = 0) -> Dict[str, np.ndarray]:
    """(in, out) -> (out, in); with ``nhwc_hw`` = H*W the input index goes
    from flax's (h, w, c) flattening to torch's (c, h, w)."""
    k = np.asarray(p["kernel"])
    if nhwc_hw:
        c = k.shape[0] // nhwc_hw
        k = k.reshape(nhwc_hw, c, k.shape[1]).transpose(1, 0, 2).reshape(k.shape)
    return {"weight": k.T, "bias": np.asarray(p["bias"])}


def _bn(params: Mapping, stats: Mapping) -> Dict[str, np.ndarray]:
    return {"weight": np.asarray(params["scale"]), "bias": np.asarray(params["bias"]),
            "running_mean": np.asarray(stats["mean"]), "running_var": np.asarray(stats["var"])}


def from_jax_variables(variables: Mapping, hidden_hw: int) -> Dict[str, torch.Tensor]:
    """flax AlphaZeroNetwork variables -> ``AlphaZeroNetwork.state_dict()``
    (``hidden_hw`` = hidden height * width, 81 for Go 9x9)."""
    params, stats = variables["params"], variables["batch_stats"]
    out: Dict[str, np.ndarray] = {}

    def put(prefix: str, d: Dict[str, np.ndarray]):
        for k, v in d.items():
            out[f"{prefix}.{k}"] = v

    put("conv", _conv(params["Conv_0"]))
    put("bn", _bn(params["BatchNorm_0"], stats["BatchNorm_0"]))
    i = 0
    while f"ResidualBlock_{i}" in params:
        p, s = params[f"ResidualBlock_{i}"], stats[f"ResidualBlock_{i}"]
        put(f"blocks.{i}.conv1", _conv(p["Conv_0"]))
        put(f"blocks.{i}.bn1", _bn(p["BatchNorm_0"], s["BatchNorm_0"]))
        put(f"blocks.{i}.conv2", _conv(p["Conv_1"]))
        put(f"blocks.{i}.bn2", _bn(p["BatchNorm_1"], s["BatchNorm_1"]))
        i += 1
    p, s = params["PolicyHead_0"], stats["PolicyHead_0"]
    put("policy_head.conv", _conv(p["Conv_0"]))
    put("policy_head.bn", _bn(p["BatchNorm_0"], s["BatchNorm_0"]))
    put("policy_head.fc", _dense(p["Dense_0"], nhwc_hw=hidden_hw))
    vname = "ValueHead_0" if "ValueHead_0" in params else "DiscreteValueHead_0"
    p, s = params[vname], stats[vname]
    put("value_head.conv", _conv(p["Conv_0"]))
    put("value_head.bn", _bn(p["BatchNorm_0"], s["BatchNorm_0"]))
    put("value_head.fc1", _dense(p["Dense_0"], nhwc_hw=hidden_hw))
    put("value_head.fc2", _dense(p["Dense_1"]))
    sd = {k: torch.from_numpy(np.array(v, dtype=np.float32))
          for k, v in out.items()}
    for k in [k for k in sd if k.endswith(".running_var")]:
        sd[k[: -len("running_var")] + "num_batches_tracked"] = torch.tensor(0)
    return sd

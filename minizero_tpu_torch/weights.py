"""JAX (flax) network variables -> the port's ``state_dict``.

``from_jax_variables`` (AlphaZero) and ``from_jax_muzero_variables`` take the
flax variable tree as nested dicts of numpy arrays (``{"params": ...,
"batch_stats": ...}``, as ``minizero_tpu.models.factory.init_network``
returns it after ``jax.tree_util.tree_map(np.asarray, ...)``) and return a
``state_dict`` for ``models.alphazero.AlphaZeroNetwork`` or
``models.muzero.MuZeroNetwork``:

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


class _StateDict:
    """Collects torch parameters under dotted names."""

    def __init__(self):
        self.out: Dict[str, np.ndarray] = {}

    def put(self, prefix: str, d: Dict[str, np.ndarray]) -> None:
        for k, v in d.items():
            self.out[f"{prefix}.{k}"] = v

    def conv_bn(self, conv: str, bn: str, params: Mapping, stats: Mapping,
                conv_name: str = "Conv_0", bn_name: str = "BatchNorm_0") -> None:
        self.put(conv, _conv(params[conv_name]))
        self.put(bn, _bn(params[bn_name], stats[bn_name]))

    def residual(self, prefix: str, params: Mapping, stats: Mapping) -> None:
        self.conv_bn(f"{prefix}.conv1", f"{prefix}.bn1", params, stats)
        self.conv_bn(f"{prefix}.conv2", f"{prefix}.bn2", params, stats, "Conv_1", "BatchNorm_1")

    def residuals(self, prefix: str, params: Mapping, stats: Mapping, first: int = 0) -> None:
        """``ResidualBlock_{first}``, ``ResidualBlock_{first + 1}``, ... ->
        ``{prefix}.0``, ``{prefix}.1``, ..."""
        i = first
        while f"ResidualBlock_{i}" in params:
            name = f"ResidualBlock_{i}"
            self.residual(f"{prefix}.{i - first}", params[name], stats[name])
            i += 1

    def head(self, prefix: str, params: Mapping, stats: Mapping, hidden_hw: int) -> None:
        """A policy, value or discrete value head: 1x1 conv, BatchNorm, and
        one or two dense layers (the first reads a flattened map)."""
        self.conv_bn(f"{prefix}.conv", f"{prefix}.bn", params, stats)
        if "Dense_1" in params:
            self.put(f"{prefix}.fc1", _dense(params["Dense_0"], nhwc_hw=hidden_hw))
            self.put(f"{prefix}.fc2", _dense(params["Dense_1"]))
        else:
            self.put(f"{prefix}.fc", _dense(params["Dense_0"], nhwc_hw=hidden_hw))

    def value_heads(self, prefix: str, params: Mapping, stats: Mapping, hidden_hw: int) -> None:
        """``PolicyHead_0`` and ``ValueHead_0`` or ``DiscreteValueHead_0``."""
        self.head(f"{prefix}policy_head", params["PolicyHead_0"], stats["PolicyHead_0"], hidden_hw)
        vname = "ValueHead_0" if "ValueHead_0" in params else "DiscreteValueHead_0"
        self.head(f"{prefix}value_head", params[vname], stats[vname], hidden_hw)

    def state_dict(self) -> Dict[str, torch.Tensor]:
        sd = {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in self.out.items()}
        for k in [k for k in sd if k.endswith(".running_var")]:
            sd[k[: -len("running_var")] + "num_batches_tracked"] = torch.tensor(0)
        return sd


def load_variables_npz(path: str) -> Dict[str, Dict]:
    """An ``.npz`` of flax variables with "/"-joined keys (as
    ``scripts/export_trained_weights.py`` writes them) -> the nested dict
    that ``from_jax_variables`` takes."""
    out: Dict[str, Dict] = {}
    with np.load(path) as z:
        for key in z.files:
            *path_, leaf = key.split("/")
            node = out
            for part in path_:
                node = node.setdefault(part, {})
            node[leaf] = z[key]
    return out


def from_jax_variables(variables: Mapping, hidden_hw: int) -> Dict[str, torch.Tensor]:
    """flax AlphaZeroNetwork variables -> ``AlphaZeroNetwork.state_dict()``
    (``hidden_hw`` = hidden height * width, 81 for Go 9x9)."""
    params, stats = variables["params"], variables["batch_stats"]
    sd = _StateDict()
    sd.conv_bn("conv", "bn", params, stats)
    sd.residuals("blocks", params, stats)
    sd.value_heads("", params, stats, hidden_hw)
    return sd.state_dict()


def from_jax_muzero_variables(variables: Mapping, hidden_hw: int) -> Dict[str, torch.Tensor]:
    """flax MuZeroNetwork variables (board or Atari mode) ->
    ``MuZeroNetwork.state_dict()`` (``hidden_hw`` = hidden height * width:
    81 for Go 9x9, 36 for Atari). Includes the 601-bin discrete value and
    reward heads and every BatchNorm's running statistics."""
    params, stats = variables["params"], variables["batch_stats"]
    sd = _StateDict()
    rp, rs = params["representation"], stats["representation"]
    if "Conv_1" in rp:  # the Atari representation
        sd.conv_bn("representation.conv1", "representation.bn1", rp, rs)
        sd.residual("representation.block1", rp["ResidualBlock_0"], rs["ResidualBlock_0"])
        sd.conv_bn("representation.conv2", "representation.bn2", rp, rs, "Conv_1", "BatchNorm_1")
        sd.residual("representation.block2", rp["ResidualBlock_1"], rs["ResidualBlock_1"])
        sd.residual("representation.block3", rp["ResidualBlock_2"], rs["ResidualBlock_2"])
        sd.residuals("representation.blocks", rp, rs, first=3)
    else:
        sd.conv_bn("representation.conv", "representation.bn", rp, rs)
        sd.residuals("representation.blocks", rp, rs)
    dp, ds = params["dynamics"], stats["dynamics"]
    sd.conv_bn("dynamics.conv", "dynamics.bn", dp, ds)
    sd.residuals("dynamics.blocks", dp, ds)
    if "DiscreteValueHead_0" in dp:
        sd.head("dynamics.reward_head", dp["DiscreteValueHead_0"], ds["DiscreteValueHead_0"],
                hidden_hw)
    sd.value_heads("prediction.", params["prediction"], stats["prediction"], hidden_hw)
    return sd.state_dict()

"""Network factory (port of ``minizero_tpu/models/factory.py``; reference
``minizero/network/py/create_network.py:6-63``): "alphazero", "muzero", and
the Atari MuZero variant when the env is Atari (the reference keys on
``"atari" in game_name``)."""

from __future__ import annotations

import math

import torch
from torch import nn

from minizero_tpu_torch.envs.base import EnvSpec
from minizero_tpu_torch.models.alphazero import AlphaZeroNetwork
from minizero_tpu_torch.models.muzero import MuZeroNetwork


def create_network(cfg, spec: EnvSpec) -> nn.Module:
    nn_type = cfg.nn_type_name.lower()
    if nn_type == "alphazero":
        return AlphaZeroNetwork(
            num_input_channels=spec.num_input_channels,
            input_height=spec.input_height,
            input_width=spec.input_width,
            num_hidden_channels=cfg.nn_num_hidden_channels,
            hidden_height=spec.hidden_height,
            hidden_width=spec.hidden_width,
            num_blocks=cfg.nn_num_blocks,
            action_size=spec.action_size,
            num_value_hidden_channels=cfg.nn_num_value_hidden_channels,
            discrete_value_size=spec.discrete_value_size,
        )
    if nn_type == "muzero":
        return MuZeroNetwork(
            num_input_channels=spec.num_input_channels,
            input_height=spec.input_height,
            input_width=spec.input_width,
            num_hidden_channels=cfg.nn_num_hidden_channels,
            hidden_height=spec.hidden_height,
            hidden_width=spec.hidden_width,
            num_action_feature_channels=spec.num_action_feature_channels,
            num_blocks=cfg.nn_num_blocks,
            action_size=spec.action_size,
            num_value_hidden_channels=cfg.nn_num_value_hidden_channels,
            discrete_value_size=spec.discrete_value_size,
            atari_mode="atari" in spec.name,
        )
    raise ValueError(f"unknown nn_type_name {cfg.nn_type_name!r}")


@torch.no_grad()
def init_network(network: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded torch-default initialisation, in place: every conv and dense
    kernel and bias ~ U(+/-1/sqrt(fan_in)) (kaiming_uniform(a=sqrt(5)), the
    init the JAX package copies), BatchNorm at scale 1, shift 0, running
    statistics (0, 1). The draws come from a CPU generator, so a seed gives
    the same weights on every device. Returns ``network``."""
    gen = torch.Generator(device="cpu").manual_seed(int(seed))
    for module in network.modules():
        if isinstance(module, (nn.Conv2d, nn.Linear)):
            w = module.weight
            fan_in = w[0].numel()
            lim = 1.0 / math.sqrt(fan_in)
            for p in (module.weight, module.bias):
                draw = torch.rand(p.shape, generator=gen, dtype=torch.float32) * (2 * lim) - lim
                p.copy_(draw)
        elif isinstance(module, nn.BatchNorm2d):
            module.reset_parameters()
    return network

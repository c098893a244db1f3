"""Training step (port of ``minizero_tpu/learner/train.py``).

The reference trainer's losses (``minizero/learner/train.py``): policy
cross-entropy (KL for Gumbel), value MSE (scalar) or CE (distributional),
reward CE, per-sample PER loss scaling, the MuZero k-step unroll with the
gradient halved on the hidden state — with the rotation augmentation on the
device (the reference rotates on the CPU in its data loader,
``data_loader.cpp:140,167``), and torch's own SGD, Adam and AdamW, which the
JAX package's optax chains reproduce, under the reference's
``StepLR(1e6, 0.1)`` schedule (``train.py:100-117``).

One call of the step is one optimizer update, run eagerly on the card; the
JAX package's ``lax.scan`` of K steps per dispatch is a host round-trip
workaround with no counterpart here. The step's metrics stay on the device
until the caller reads them.

Not ported: the JAX package's ``jax.checkpoint`` (remat) of the Atari
unroll, a workaround for a 16 GB TPU chip's memory; the card's 80 GB hold
the activations.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from minizero_tpu_torch.config import Config
from minizero_tpu_torch.utils import rotation as rot
from minizero_tpu_torch.utils.bitpack import unpack_planes
from minizero_tpu_torch.utils.transforms import (
    from_discrete_value, to_discrete_value, transform_value)


def learning_rate(cfg: Config, step: int) -> float:
    """StepLR(step_size=1e6, gamma=0.1) over optimizer steps (reference
    train.py:100-117)."""
    return cfg.learner_learning_rate * 0.1 ** (int(step) // 1_000_000)


def make_optimizer(cfg: Config, params) -> torch.optim.Optimizer:
    """torch's SGD (momentum, no dampening), Adam and AdamW, as the
    reference builds them (train.py:100-117): weight decay added to the raw
    gradient for SGD and Adam, decoupled for AdamW. The learning rate is set
    before every step by ``learning_rate``."""
    name = cfg.learner_optimizer.lower()
    lr, wd = cfg.learner_learning_rate, cfg.learner_weight_decay
    if name == "adam":
        return torch.optim.Adam(params, lr=lr, weight_decay=wd)
    if name == "adamw":
        return torch.optim.AdamW(params, lr=lr, weight_decay=wd)
    return torch.optim.SGD(params, lr=lr, momentum=cfg.learner_momentum, weight_decay=wd)


@dataclass
class TrainState:
    """The network the optimizer updates, the optimizer and the number of
    updates done (``training_step`` in the reference)."""

    network: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def init_train_state(cfg: Config, network: nn.Module) -> TrainState:
    return TrainState(network, make_optimizer(cfg, network.parameters()), 0)


def scale_gradient(x: torch.Tensor, scale: float) -> torch.Tensor:
    """Identity forward, gradient scaled backward (reference train.py:207
    ``register_hook(lambda grad: grad / 2)``)."""
    return x * scale + (x * (1.0 - scale)).detach()


def _policy_loss(use_gumbel: bool, logits, label, loss_scale):
    logp = F.log_softmax(logits, dim=-1)
    if use_gumbel:
        # KL(label || p) summed over actions (reference train.py:133)
        safe = torch.where(label > 0, label, 1.0)
        per = torch.sum(label * (torch.log(safe) - logp), dim=-1)
    else:
        per = -torch.sum(label * logp, dim=-1)
    return torch.mean(per * loss_scale)


def _value_loss(out, label_value, loss_scale, value_size: int):
    if value_size == 1:
        # label [B] scalar vs net [B, 1] (reference train.py:139)
        err = (out["value"][:, 0] - label_value) ** 2
        return torch.mean(err * loss_scale)
    # distributional: label [B, value_size] two-hot
    logp = F.log_softmax(out["value_logit"], dim=-1)
    return torch.mean(-torch.sum(label_value * logp, dim=-1) * loss_scale)


def _policy_accuracy(logits, label):
    return torch.mean((logits.argmax(-1) == label.argmax(-1)).to(torch.float32))


def make_train_step(cfg: Config, env, network: nn.Module,
                    grad_hook: Optional[Callable[[], None]] = None):
    """Returns ``train_step(state, batch, generator=None, rotations=None) ->
    metrics``: one optimizer update of ``state`` in place (the reference's
    per-step body, train.py:163-219); ``state.network`` is ``network``.
    ``grad_hook()``, where given, runs between the backward pass and the
    optimizer step (the data-parallel step averages the gradients there,
    ``parallel/distributed.py``).

    ``batch`` holds the replay's sample (``learner/replay.py``) as tensors
    or numpy arrays; features may be bit-packed u8 planes, which the step
    unpacks on the device. Each sample is rotated by an id drawn from
    ``generator`` (on the network's device), or by ``rotations`` (i32[B])
    where the caller gives them. The metrics are 0-d tensors on the device
    (with PER, ``_new_values`` holds the fresh root values, [B], for the
    priority refresh, reference train.py:208-209). The network is in train
    mode during the step and in eval mode after it."""
    spec = env.spec
    value_size = spec.discrete_value_size
    is_muzero = cfg.nn_type_name.lower() != "alphazero"
    k_unroll = cfg.learner_muzero_unrolling_step
    n_rot = env.num_rotations()
    use_gumbel = cfg.use_gumbel
    # replay stores u8 planes; atari's encode real values scaled by 255,
    # board games store 0/1 (bit-packed 8 to a byte where binary)
    feat_scale = 1.0 / 255.0 if spec.name.startswith("atari") else 1.0

    def features(x: torch.Tensor) -> torch.Tensor:
        if x.shape[-1] != spec.num_input_channels:
            return unpack_planes(x, spec.num_input_channels)
        return x.to(torch.float32) * feat_scale

    def prepare_value_label(value):
        """Scalar targets for scalar heads; transformed two-hot for
        distributional heads (reference atari.cpp:279-294)."""
        if value_size == 1:
            return value
        return to_discrete_value(transform_value(value), value_size)

    def scalar_value(out):
        if value_size == 1:
            return out["value"][:, 0].detach()
        return from_discrete_value(out["value"].detach())

    def augment(rots, feats, policy, actions=None):
        """Per-sample rotation of features and policy targets (and MuZero
        action ids) (reference data_loader.cpp:140-146, 166-177)."""
        if rots is None:
            return feats, policy, actions
        feats = rot.rotate_planes_batch(feats, rots, spec.board_size)
        policy = rot.rotate_policy_labels_batch(policy, rots, spec.board_size)
        if actions is not None:
            actions = rot.rotate_actions_batch(actions, rots, spec.board_size, spec.action_size)
        return feats, policy, actions

    def alphazero_loss(batch, rots):
        feats, policy_label, _ = augment(rots, features(batch["features"]),
                                         batch["policy"].to(torch.float32))
        out = network(feats)
        ls = batch["loss_scale"].to(torch.float32)
        loss_p = _policy_loss(use_gumbel, out["policy_logit"], policy_label, ls)
        loss_v = _value_loss(out, prepare_value_label(batch["value"].to(torch.float32)), ls,
                             value_size)
        loss = loss_p + cfg.learner_value_loss_scale * loss_v
        metrics = {
            "loss": loss,
            "loss_policy": loss_p,
            "loss_value": loss_v,
            "accuracy_policy": _policy_accuracy(out["policy_logit"], policy_label),
        }
        if cfg.learner_use_per:
            metrics["_new_values"] = scalar_value(out)
        return loss, metrics

    def muzero_loss(batch, rots):
        feats, policy_label, actions = augment(
            rots, features(batch["features"]), batch["policy"].to(torch.float32),
            batch["actions"])
        ls = batch["loss_scale"].to(torch.float32)
        value_label = prepare_value_label(batch["value"].to(torch.float32))  # [B, K+1(, V)]
        has_reward = "reward" in batch and spec.name.startswith("atari")
        reward_label = (prepare_value_label(batch["reward"].to(torch.float32))
                        if has_reward else None)

        out = network.initial_inference(feats)
        loss_p = _policy_loss(use_gumbel, out["policy_logit"], policy_label[:, 0], ls)
        loss_v = _value_loss(out, value_label[:, 0], ls, value_size)
        loss_r = torch.zeros((), dtype=torch.float32, device=feats.device)
        acc0 = _policy_accuracy(out["policy_logit"], policy_label[:, 0])
        root_value = scalar_value(out) if cfg.learner_use_per else None
        hidden = out["hidden_state"]
        # k-step unroll through dynamics (reference train.py:195-210)
        for i in range(k_unroll):
            hidden = scale_gradient(hidden, 0.5)
            out = network.recurrent_inference(hidden, env.action_features(actions[:, i]))
            hidden = out["hidden_state"]
            loss_p = loss_p + _policy_loss(use_gumbel, out["policy_logit"],
                                           policy_label[:, i + 1], ls) / k_unroll
            loss_v = loss_v + _value_loss(out, value_label[:, i + 1], ls, value_size) / k_unroll
            if has_reward:
                logp = F.log_softmax(out["reward_logit"], dim=-1)
                step_r = torch.mean(-torch.sum(reward_label[:, i] * logp, dim=-1) * ls)
                loss_r = loss_r + step_r / k_unroll
        loss = loss_p + cfg.learner_value_loss_scale * loss_v + loss_r
        metrics = {
            "loss": loss,
            "loss_policy": loss_p,
            "loss_value": loss_v,
            "loss_reward": loss_r,
            "accuracy_policy": acc0,
        }
        if root_value is not None:
            metrics["_new_values"] = root_value
        return loss, metrics

    loss_fn = muzero_loss if is_muzero else alphazero_loss

    def train_step(state: TrainState, batch: Dict, generator: Optional[torch.Generator] = None,
                   rotations: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        dev = next(network.parameters()).device
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()
                 if k != "sampled_index"}
        rots = None
        if n_rot > 1:
            b = batch["features"].shape[0]
            rots = (torch.as_tensor(rotations, device=dev) if rotations is not None else
                    torch.randint(0, n_rot, (b,), generator=generator, device=dev))
        lr = learning_rate(cfg, state.step)
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        network.train()
        try:
            loss, metrics = loss_fn(batch, rots)
            state.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            if grad_hook is not None:
                grad_hook()
            state.optimizer.step()
        finally:
            network.eval()
        state.step += 1
        return {k: v.detach() for k, v in metrics.items()}

    return train_step

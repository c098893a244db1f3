"""Network building blocks in NCHW (port of ``minizero_tpu/models/blocks.py``;
reference ``minizero/network/py/network_unit.py``).

ResidualBlock (2x conv3x3 + BN), PolicyHead (1x1 conv -> FC logits),
ValueHead (1x1 conv -> FC -> tanh), DiscreteValueHead (bin logits). Layers
keep torch's default initialisation, which the JAX package copies
(``blocks.py:21-53``). BatchNorm: eps 1e-5, momentum 0.1 (flax's 0.9), with
flax's running-variance update in training (``BatchNorm2d`` below).

The heads flatten NCHW, as the reference does. The JAX package flattens
NHWC, so ``weights.from_jax_variables`` permutes the input rows of the first
dense layer of each head. ``ColumnParallelLinear`` is a head's dense layer
split over the ranks of an ``mp`` group (``parallel/mesh.shard_heads``).
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn


class _AllReduceSum(torch.autograd.Function):
    """A sum over the ranks of ``group`` (None: the default group) whose
    gradient is the sum of the ranks' gradients, as
    ``torch.distributed.nn.functional.all_reduce`` (deprecated in recent
    torch releases) computes it."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group=None) -> torch.Tensor:
        ctx.group = group
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return _AllReduceSum.apply(grad, ctx.group), None


def _split_batch(group) -> bool:
    """Whether a process group of more than one rank splits the batch."""
    return dist.is_available() and dist.is_initialized() and dist.get_world_size(group) > 1


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose training step updates the running variance
    with the BIASED batch variance, as flax's ``BatchNorm`` does; torch's
    own update takes the unbiased one. On one process the forward is
    torch's in both modes, and eval mode is untouched.

    torch leaves ``v' = (1 - m) v + m * var_u`` with ``var_u = var_b * n /
    (n - 1)`` (n values per channel); the wanted ``(1 - m) v + m * var_b``
    is ``v' (n - 1) / n + (1 - m) v / n``, two small per-channel ops after
    the fused kernel instead of a second pass over the activations.

    In training under a process group of more than one rank (the
    data-parallel train step, ``parallel/distributed.py``), the batch mean
    and variance are those of the global batch, every rank's rows, as XLA
    computes them in the JAX package's sharded step: the per-channel count
    and sum, then the centred sum of squares, are summed over the ranks of
    ``group`` (the mesh's dp group: the ranks of an mp group hold the same
    rows) by a differentiable all-reduce. (``nn.SyncBatchNorm`` does the
    same on a card only; the CPU tests run on gloo.)"""

    # the process group whose ranks hold the batch's rows (None: the default
    # group); the sharded train step sets the mesh's dp group
    group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not (self.training and self.track_running_stats):
            return super().forward(x)
        if _split_batch(self.group):
            return self._global_batch_forward(x)
        old_var = self.running_var.clone()
        y = super().forward(x)
        n = x.numel() // x.shape[1]
        # a new tensor, not an in-place update: autograd saved this one
        with torch.no_grad():
            self.running_var = self.running_var * ((n - 1) / n) + old_var * ((1.0 - self.momentum) / n)
        return y

    def _global_batch_forward(self, x: torch.Tensor) -> torch.Tensor:
        c = x.shape[1]
        dims = (0, 2, 3)
        head = _AllReduceSum.apply(torch.cat([x.sum(dims), x.new_full((1,), x.numel() // c)]),
                                   self.group)
        n = head[c]
        mean = head[:c] / n
        xc = x - mean[None, :, None, None]
        var = _AllReduceSum.apply((xc * xc).sum(dims), self.group) / n
        y = xc * torch.rsqrt(var + self.eps)[None, :, None, None]
        if self.affine:
            y = y * self.weight[None, :, None, None] + self.bias[None, :, None, None]
        with torch.no_grad():
            self.running_mean.mul_(1.0 - self.momentum).add_(mean, alpha=self.momentum)
            self.running_var.mul_(1.0 - self.momentum).add_(var, alpha=self.momentum)
            self.num_batches_tracked.add_(1)
        return y


def _bn(channels: int) -> nn.BatchNorm2d:
    return BatchNorm2d(channels, eps=1e-5, momentum=0.1)


class ResidualBlock(nn.Module):
    """reference network_unit.py:6-22"""

    def __init__(self, channels: int):
        super().__init__()
        self.conv1 = nn.Conv2d(channels, channels, 3, padding=1, bias=True)
        self.bn1 = _bn(channels)
        self.conv2 = nn.Conv2d(channels, channels, 3, padding=1, bias=True)
        self.bn2 = _bn(channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return F.relu(x + y)


class PolicyHead(nn.Module):
    """reference network_unit.py:25-42: 1x1 conv to ceil(A/(H*W)) channels,
    BN, relu, FC to action logits."""

    def __init__(self, in_channels: int, height: int, width: int, action_size: int):
        super().__init__()
        out_channels = math.ceil(action_size / (height * width))
        self.conv = nn.Conv2d(in_channels, out_channels, 1, bias=True)
        self.bn = _bn(out_channels)
        self.fc = nn.Linear(out_channels * height * width, action_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn(self.conv(x)))
        return self.fc(x.flatten(1))


class ValueHead(nn.Module):
    """Scalar tanh value head (reference network_unit.py:45-66)."""

    def __init__(self, in_channels: int, height: int, width: int, hidden_channels: int):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, 1, 1, bias=True)
        self.bn = _bn(1)
        self.fc1 = nn.Linear(height * width, hidden_channels)
        self.fc2 = nn.Linear(hidden_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn(self.conv(x)))
        x = F.relu(self.fc1(x.flatten(1)))
        return torch.tanh(self.fc2(x))


class DiscreteValueHead(nn.Module):
    """Distributional value head returning bin logits
    (reference network_unit.py:69-87)."""

    def __init__(self, in_channels: int, height: int, width: int,
                 hidden_channels: int, value_size: int):
        super().__init__()
        out_channels = math.ceil(value_size / (height * width))
        self.conv = nn.Conv2d(in_channels, out_channels, 1, bias=True)
        self.bn = _bn(out_channels)
        self.fc1 = nn.Linear(out_channels * height * width, hidden_channels)
        self.fc2 = nn.Linear(hidden_channels, value_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn(self.conv(x)))
        x = F.relu(self.fc1(x.flatten(1)))
        return self.fc2(x)


class _SumGradient(torch.autograd.Function):
    """The identity whose gradient is summed over the ranks of ``group``:
    the input of a column-parallel layer is the same on every rank, and
    each rank's gradient holds only its own columns' part of it."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _GatherColumns(torch.autograd.Function):
    """``[B, out / size]``, the columns of rank ``rank``, to the whole
    ``[B, out]`` on every rank of ``group``: an all-reduce of a zero-filled
    ``[B, out]`` that holds this rank's columns (gloo reduces tensors on a
    card, but gathers only on the CPU). Every rank computes the same loss
    from the whole output, so the gradient is this rank's columns of the
    incoming one."""

    @staticmethod
    def forward(ctx, y: torch.Tensor, rank: int, size: int, group) -> torch.Tensor:
        cols = y.shape[-1]
        ctx.cols = slice(rank * cols, (rank + 1) * cols)
        out = y.new_zeros(y.shape[:-1] + (cols * size,))
        out[..., ctx.cols] = y
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return grad[..., ctx.cols].contiguous(), None, None, None


class ColumnParallelLinear(nn.Module):
    """An ``nn.Linear`` whose output features are split over the ``size``
    ranks of ``group`` (the JAX package's ``P(None, "mp")`` on a dense
    kernel, ``minizero_tpu/parallel/mesh.py:41-54``): rank ``rank`` holds
    rows ``rows`` of the weight and the bias, ``[out // size, in]`` and
    ``[out // size]``. The forward computes this rank's columns and gathers
    the whole ``[B, out]`` on every rank; the input's gradient is summed
    over the group.

    Built from a whole ``linear``, whose Parameters it takes over, cut to
    this rank's rows: an optimizer built on them steps the shards."""

    def __init__(self, linear: nn.Linear, rank: int, size: int, group):
        super().__init__()
        if linear.out_features % size:
            raise ValueError(f"{linear.out_features} output features do not split over {size} ranks")
        self.in_features, self.out_features = linear.in_features, linear.out_features
        self.rank, self.size, self.group = rank, size, group
        local = linear.out_features // size
        self.rows = slice(rank * local, (rank + 1) * local)
        with torch.no_grad():
            for name in ("weight", "bias"):
                p = getattr(linear, name)
                if p is not None:
                    p.data = p.data[self.rows].clone()
                setattr(self, name, p)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.linear(_SumGradient.apply(x, self.group), self.weight, self.bias)
        return _GatherColumns.apply(y, self.rank, self.size, self.group)


class _MinMaxNormalize(torch.autograd.Function):
    """Per-row ``(x - min) / guarded(max - min)`` over ``[B, K]`` with the JAX
    package's backward (``minizero_tpu/models/blocks.py:130-174``): the
    gradient of the min and the max goes to the single arg-min and arg-max
    index (the first one on ties, as torch's and jax's argmin pick), not
    spread over the ties as torch's own ``amin``/``amax`` backward does."""

    @staticmethod
    def forward(ctx, flat: torch.Tensor) -> torch.Tensor:
        amin = flat.argmin(-1, keepdim=True)
        amax = flat.argmax(-1, keepdim=True)
        mn = flat.gather(-1, amin)
        s = flat.gather(-1, amax) - mn
        s = torch.where(s < 1e-5, s + 1e-5, s)
        y = (flat - mn) / s
        ctx.save_for_backward(y, s, amin, amax)
        return y

    @staticmethod
    def backward(ctx, gy: torch.Tensor):
        y, s, amin, amax = ctx.saved_tensors
        # y = (x - mn)/s with mn = x[amin], s = x[amax] - x[amin]:
        #   dx = dy/s - e_min sum(dy)/s - (e_max - e_min) sum(dy y)/s
        gsum = gy.sum(-1, keepdim=True)
        gysum = (gy * y).sum(-1, keepdim=True)
        e_min = torch.zeros_like(gy).scatter_(-1, amin, 1.0)
        e_max = torch.zeros_like(gy).scatter_(-1, amax, 1.0)
        return (gy - e_min * gsum - (e_max - e_min) * gysum) / s


def minmax_normalize(flat: torch.Tensor) -> torch.Tensor:
    """``[B, K]`` rows min-max scaled to [0, 1] (range widened by 1e-5 where
    it is below 1e-5), differentiable with the JAX package's backward."""
    return _MinMaxNormalize.apply(flat)


def scale_hidden_state(hidden_state: torch.Tensor) -> torch.Tensor:
    """Min-max scale each sample's NCHW hidden state to [0, 1], with the
    range widened by 1e-5 where it is below 1e-5 (reference
    ``muzero_network.py:154-164``; JAX ``blocks.py:131-182``). Where a
    gradient is wanted the rows are taken in the JAX package's NHWC order,
    so that the arg-min and arg-max of a tie are the same element as there
    (``minmax_normalize``); inference takes the plain min and max."""
    if torch.is_grad_enabled() and hidden_state.requires_grad:
        nhwc = hidden_state.permute(0, 2, 3, 1)
        y = minmax_normalize(nhwc.reshape(hidden_state.shape[0], -1))
        return y.reshape(nhwc.shape).permute(0, 3, 1, 2)
    flat = hidden_state.reshape(hidden_state.shape[0], -1)
    mn = flat.amin(-1, keepdim=True)
    mx = flat.amax(-1, keepdim=True)
    s = mx - mn
    s = torch.where(s < 1e-5, s + 1e-5, s)
    return ((flat - mn) / s).reshape(hidden_state.shape)


def same_pad(x: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """Zero-pad an NCHW map as flax's (TensorFlow's) "SAME" padding does for
    a ``kernel`` x ``kernel`` window at ``stride``: the total padding
    ``max((ceil(n / stride) - 1) * stride + kernel - n, 0)`` per dimension,
    its smaller half before and the larger after. For a stride-2 3x3 window
    on an even size that is 0 before and 1 after, which ``padding=1`` of a
    torch conv or pool (1 on both sides) does not give."""
    pads = []
    for n in (x.shape[3], x.shape[2]):  # F.pad's order: last dimension first
        total = max((-(-n // stride) - 1) * stride + kernel - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)

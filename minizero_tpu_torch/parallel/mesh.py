"""The ``(dp, mp)`` layout of a multi-GPU run (port of
``minizero_tpu/parallel/mesh.py``).

The JAX package lays its devices out as a ``jax.sharding.Mesh`` with a data
axis ``dp`` and a model axis ``mp``, driven by one controller a host. The
port follows PyTorch's idiom instead (the reference's own multi-GPU
plumbing, ``nn.DataParallel`` in the trainer, ``learner/train.py:119``, and
one network replica a GPU in the self-play worker,
``actor_group.cpp:168-177``): one process a card, joined by
``torch.distributed`` (``parallel/distributed.py``). A :class:`Mesh` is that
process's place in the job: its rank, the number of ranks, its device, and
its coordinates in the ``(dp, mp)`` grid, rank ``r`` at ``(r // mp, r %
mp)`` as JAX's ``reshape(dp, mp)`` lays the devices out, with the process
groups of its ``dp`` column and its ``mp`` row.

- ``batch_sharding(mesh, n)`` is what the JAX ``P("dp")`` sharding means
  here: the rows of an ``n``-row batch that this rank's ``dp`` row holds
  (the ranks of an ``mp`` group hold the same rows);
- ``replicated(mesh, module)`` is what ``P()`` means: every rank holds a
  whole copy, the same bytes as rank 0's;
- ``param_shardings(mesh, network)`` names the dense layers that split
  over ``mp`` (JAX ``mesh.py:41-54``): every ``nn.Linear`` whose output
  features divide by ``mp``; ``shard_heads`` splits them into
  ``models.blocks.ColumnParallelLinear``s, and ``whole_state`` /
  ``local_state`` turn a split network's state (and its optimizer's) into
  the one-process form and back, as a checkpoint holds it.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from minizero_tpu_torch.models.blocks import ColumnParallelLinear


@dataclass(frozen=True)
class Mesh:
    """One rank's place in a ``(dp, mp)`` job. ``dp_group`` and
    ``mp_group`` are the process groups of this rank's ``dp`` column and
    ``mp`` row (None: the default group; with ``mp == 1`` the column is the
    whole job and no group is built)."""

    rank: int
    world_size: int
    device: torch.device
    mp: int = 1
    dp_group: Any = None
    mp_group: Any = None

    @property
    def dp(self) -> int:
        return self.world_size // self.mp

    @property
    def dp_rank(self) -> int:
        return self.rank // self.mp

    @property
    def mp_rank(self) -> int:
        return self.rank % self.mp


def local_device(device=None) -> torch.device:
    """The card of this process: ``cuda:LOCAL_RANK`` (modulo the visible
    cards, so that ranks may share a card over gloo) unless the caller asks
    for the CPU."""
    from minizero_tpu_torch import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0"))
                           % torch.cuda.device_count())
    return dev


def make_mesh(n_devices: Optional[int] = None, model_parallel: int = 1, device=None) -> Mesh:
    """This process's :class:`Mesh` in the active process group (a group of
    one without one), laid out as ``(dp, mp)`` with ``mp = model_parallel``
    and ``dp = world // mp``. ``n_devices``, where given, must be the
    group's size; ``model_parallel`` must divide it (the JAX ``assert n %
    model_parallel == 0``). With ``mp > 1`` every rank builds every row's
    and every column's process group, in the same order."""
    rank, world = ((dist.get_rank(), dist.get_world_size()) if dist.is_initialized()
                   else (0, 1))
    if n_devices is not None and n_devices != world:
        raise ValueError(f"requested {n_devices} devices, the process group has {world} ranks")
    if model_parallel < 1 or world % model_parallel:
        raise ValueError(f"model_parallel={model_parallel} does not divide the process group's "
                         f"{world} rank(s)")
    dp_group = mp_group = None
    if model_parallel > 1:
        mp = model_parallel
        for row in range(world // mp):
            group = dist.new_group(list(range(row * mp, (row + 1) * mp)))
            if rank // mp == row:
                mp_group = group
        for col in range(mp):
            group = dist.new_group(list(range(col, world, mp)))
            if rank % mp == col:
                dp_group = group
    return Mesh(rank, world, local_device(device), model_parallel, dp_group, mp_group)


def batch_sharding(mesh: Mesh, batch_size: int) -> slice:
    """The rows of a ``batch_size``-row batch that this rank's ``dp`` row
    holds."""
    if batch_size % mesh.dp:
        raise ValueError(f"batch {batch_size} must divide over dp={mesh.dp}")
    local = batch_size // mesh.dp
    return slice(mesh.dp_rank * local, (mesh.dp_rank + 1) * local)


@torch.no_grad()
def replicated(mesh: Mesh, module: nn.Module) -> nn.Module:
    """Make every rank's ``module`` (parameters and buffers) a copy of rank
    0's; returns it. For a whole module: before ``shard_heads``."""
    if mesh.world_size > 1:
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src=0)
    return module


def param_shardings(mesh: Mesh, network: nn.Module) -> Dict[str, nn.Linear]:
    """The dense layers of ``network`` that split over ``mp``, by module
    name: every ``nn.Linear`` whose output features divide by ``mp`` (the
    JAX rule, a 2-D ``Dense`` kernel whose output dim divides by ``mp``;
    a torch weight is ``[out, in]``). Everything else is replicated. Empty
    with ``mp == 1``."""
    if mesh.mp == 1:
        return {}
    return {name: m for name, m in network.named_modules()
            if isinstance(m, nn.Linear) and m.out_features % mesh.mp == 0}


def shard_heads(mesh: Mesh, network: nn.Module) -> nn.Module:
    """Split, in place, each layer ``param_shardings`` names into a
    ``ColumnParallelLinear`` over this rank's ``mp`` group that holds its
    rows; returns ``network``. The Parameters keep their identity, so an
    optimizer built on them steps the shards. A split network has no
    ``nn.Linear`` left to split: a second call changes nothing."""
    for name, linear in param_shardings(mesh, network).items():
        parent, _, child = name.rpartition(".")
        setattr(network.get_submodule(parent), child,
                ColumnParallelLinear(linear, mesh.mp_rank, mesh.mp, mesh.mp_group))
    return network


def _split_parameters(network: nn.Module) -> Dict[str, ColumnParallelLinear]:
    """``{parameter name: its ColumnParallelLinear}`` of a split network."""
    return {f"{name}.{p}": m for name, m in network.named_modules()
            if isinstance(m, ColumnParallelLinear) for p, _ in m.named_parameters(recurse=False)}


def _map_state(network: nn.Module, model: Dict[str, torch.Tensor],
               optimizer: Optional[Dict[str, Any]], fn) -> Tuple[Dict, Optional[Dict]]:
    """``model`` and ``optimizer`` (state dicts) with ``fn(tensor, module)``
    applied to every tensor of a split parameter: its entry in ``model``
    and its optimizer buffers (momentum, moments; a 0-d step count stays)."""
    split = _split_parameters(network)
    model = dict(model)
    for name, m in split.items():
        model[name] = fn(model[name], m)
    if optimizer is not None:
        names = [n for n, _ in network.named_parameters()]
        state = {}
        for i, bufs in optimizer["state"].items():
            m = split.get(names[i])
            state[i] = bufs if m is None else {
                k: fn(v, m) if torch.is_tensor(v) and v.dim() > 0 else v for k, v in bufs.items()}
        optimizer = dict(optimizer, state=state)
    return model, optimizer


def whole_state(mesh: Mesh, network: nn.Module, optimizer: Optional[torch.optim.Optimizer] = None
                ) -> Tuple[Dict[str, torch.Tensor], Optional[Dict[str, Any]]]:
    """The state dicts of a split ``network`` and of its ``optimizer`` (where
    given) as one process holds them: every split tensor gathered over the
    ``mp`` group (a collective: every rank of the group calls it, in the
    same order). With ``mp == 1`` the state dicts as they are."""
    def gather(t: torch.Tensor, m: ColumnParallelLinear) -> torch.Tensor:
        whole = t.new_zeros((m.out_features,) + tuple(t.shape[1:]))
        whole[m.rows] = t
        dist.all_reduce(whole, group=mesh.mp_group)
        return whole

    return _map_state(network, network.state_dict(),
                      optimizer.state_dict() if optimizer is not None else None, gather)


def local_state(mesh: Mesh, network: nn.Module, model: Dict[str, torch.Tensor],
                optimizer: Optional[Dict[str, Any]] = None
                ) -> Tuple[Dict[str, torch.Tensor], Optional[Dict[str, Any]]]:
    """The inverse of ``whole_state``: one process's state dicts (a
    checkpoint's) cut to this rank's rows of each split tensor of
    ``network``, for its ``load_state_dict`` and its optimizer's."""
    return _map_state(network, model, optimizer, lambda t, m: t[m.rows].clone())

"""The data-parallel layout of a multi-GPU run (port of
``minizero_tpu/parallel/mesh.py``).

The JAX package lays its devices out as a ``jax.sharding.Mesh`` with a data
axis ``dp`` and a model axis ``mp``, driven by one controller a host. The
port follows PyTorch's idiom instead (the reference's own multi-GPU
plumbing, ``nn.DataParallel`` in the trainer, ``learner/train.py:119``, and
one network replica a GPU in the self-play worker,
``actor_group.cpp:168-177``): one process a card, joined by
``torch.distributed`` (``parallel/distributed.py``). A :class:`Mesh` is that
process's place in the job: its rank, the number of ranks and its device.

- ``batch_sharding(mesh, n)`` is what the JAX ``P("dp")`` sharding means
  here: the rows of an ``n``-row batch that this rank holds;
- ``replicated(mesh, module)`` is what ``P()`` means: every rank holds a
  whole copy, the same bytes as rank 0's.

The tensor-parallel split of the dense heads over ``mp``
(``param_shardings``, JAX ``mesh.py:41-54``) is not ported: no entry point
of the JAX package reaches it (only ``__graft_entry__.py``'s dry run), and
``make_mesh(model_parallel > 1)`` raises (ROADMAP A11b).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist
from torch import nn


@dataclass(frozen=True)
class Mesh:
    """One rank's place in a data-parallel job."""

    rank: int
    world_size: int
    device: torch.device


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
    one without one). ``n_devices``, where given, must be the group's
    size."""
    if model_parallel > 1:
        raise NotImplementedError(
            "model_parallel > 1 (the dense heads split over an mp axis) is not ported "
            "(ROADMAP.md, A11b)")
    rank, world = ((dist.get_rank(), dist.get_world_size()) if dist.is_initialized()
                   else (0, 1))
    if n_devices is not None and n_devices != world:
        raise ValueError(f"requested {n_devices} devices, the process group has {world} ranks")
    return Mesh(rank, world, local_device(device))


def batch_sharding(mesh: Mesh, batch_size: int) -> slice:
    """The rows of a ``batch_size``-row batch that ``mesh.rank`` holds."""
    if batch_size % mesh.world_size:
        raise ValueError(f"batch {batch_size} must divide over dp={mesh.world_size}")
    local = batch_size // mesh.world_size
    return slice(mesh.rank * local, (mesh.rank + 1) * local)


@torch.no_grad()
def replicated(mesh: Mesh, module: nn.Module) -> nn.Module:
    """Make every rank's ``module`` (parameters and buffers) a copy of rank
    0's; returns it."""
    if mesh.world_size > 1:
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src=0)
    return module

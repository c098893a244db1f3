"""Multi-GPU and multi-host plumbing (port of
``minizero_tpu/parallel/distributed.py``).

The reference distributes a run over a TCP server, self-play workers and
NFS (SURVEY.md §2.6). The JAX package replaces that with one SPMD program
over a device mesh; the port follows PyTorch's idiom: one process a card,
joined by ``torch.distributed`` (NCCL between cards, gloo on the CPU), each
rank playing its slice of the games on its own card, and the train step's
gradient averaged over the ranks after every backward pass.

- ``init_distributed`` joins the process group that a launcher
  (``python -m torch.distributed.run``) describes in the environment, and
  is a no-op otherwise;
- ``ShardedSelfPlay`` plays a rank's slice of the self-play batch; no
  collective runs inside a move;
- ``global_batch_from_local`` / ``global_stacked_from_local``: each rank
  uploads its own rows of the global batch;
- ``make_sharded_train_step`` / ``make_sharded_train_chunk``: the port's
  train step with the gradient (and the metrics) averaged over ranks;
  BatchNorm's batch statistics are taken over the global batch
  (``models/blocks.py``), as XLA's sharded step takes them. The chunk form
  runs K steps and synchronises once, under the watchdog: the JAX package
  measured the per-step form 4.4x slower distributed than solo. On a mesh
  with ``mp > 1`` the step splits the dense heads over ``mp``
  (``mesh.param_shardings``, ``models.blocks.ColumnParallelLinear``), as
  the JAX step shards its state: the batch splits over ``dp`` only, and the
  ranks of an ``mp`` group hold the same rows.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from minizero_tpu_torch import upload
from minizero_tpu_torch.models.blocks import BatchNorm2d, ColumnParallelLinear
from minizero_tpu_torch.parallel.mesh import Mesh, batch_sharding, local_device, shard_heads
from minizero_tpu_torch.parallel.watchdog import collective_watchdog

LAUNCHER_VARIABLES = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "LOCAL_RANK")


def under_launcher() -> bool:
    """Whether a launcher set this process's rank, world size and
    rendezvous in the environment (as ``torch.distributed.run`` does)."""
    return all(v in os.environ for v in LAUNCHER_VARIABLES)


def init_distributed(backend: Optional[str] = None, device=None) -> Tuple[int, int]:
    """Join the process group a launcher describes (even a group of one);
    returns ``(rank, world size)``. Without a launcher (and without a group
    already joined) it is a no-op returning ``(0, 1)``.

    The backend is ``nccl`` for a card and ``gloo`` for the CPU (``device``
    as ``resolve_device`` reads it); ``backend`` chooses another (gloo on a
    card, where NCCL cannot run, e.g. two ranks sharing one card). A
    backend that cannot run raises; there is no silent fallback."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if not under_launcher():
        return 0, 1
    dev = local_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl":
        if dev.type != "cuda" or not dist.is_nccl_available():
            raise RuntimeError(f"the nccl backend needs a card (device {dev})")
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method="env://")
    return dist.get_rank(), dist.get_world_size()


def all_gather_rows(mesh: Mesh, row: np.ndarray) -> np.ndarray:
    """``[dp, n]``: the float64 ``row`` of every rank of this rank's ``dp``
    column, in ``dp`` order (the ranks of an ``mp`` group hold the same
    games). An all-reduce of a matrix that holds this rank's row (gloo
    reduces tensors on a card, but gathers only on the CPU)."""
    rows = torch.zeros((mesh.dp, len(row)), dtype=torch.float64, device=mesh.device)
    rows[mesh.dp_rank] = torch.as_tensor(row, dtype=torch.float64)
    if mesh.dp > 1:
        dist.all_reduce(rows, group=mesh.dp_group)
    return rows.cpu().numpy()


class ShardedSelfPlay:
    """A self-play engine playing this rank's slice of the global batch.

    The engine runs unchanged on ``mesh.device``, on whole weights. Its
    generator is seeded ``seed + dp_rank`` (the counterpart of the JAX
    package's ``fold_in(rng, axis_index("dp"))``), so the ``dp`` rows draw
    different noise, resets and samples and the ranks of an ``mp`` group
    play the same games (JAX replicates them over ``mp``); no collective
    runs inside a move."""

    def __init__(self, engine, mesh: Mesh, seed: int = 0):
        self.engine = engine
        self.mesh = mesh
        engine.generator.manual_seed(int(seed) + mesh.dp_rank)

    def local_batch(self, batch_size: int) -> int:
        rows = batch_sharding(self.mesh, batch_size)
        return rows.stop - rows.start

    def init_batch(self, batch_size: int, generator: Optional[torch.Generator] = None):
        """This rank's games of a ``batch_size``-game global batch."""
        return self.engine.init_batch(self.local_batch(batch_size), generator)

    def move(self, states, temperature: float = 1.0, generator=None):
        return self.engine.move(states, temperature, generator)

    def move_scan(self, states, temperature: float = 1.0, num_moves: int = 8,
                  enable_resign=None, moves_since_reset=None, generator=None):
        return self.engine.move_scan(states, temperature, num_moves, enable_resign,
                                     moves_since_reset, generator)


def global_batch_from_local(mesh: Mesh, local_batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """This rank's rows of a training batch (``[b_local, ...]`` host arrays,
    ``b_local = B // dp``) on its device; the global batch is the ``dp``
    rows' rows in ``dp`` order."""
    return {k: upload(np.asarray(v), mesh.device) for k, v in local_batch.items()}


def global_stacked_from_local(mesh: Mesh, stacked: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """The chunked form: ``[K, b_local, ...]`` arrays of K batches."""
    return global_batch_from_local(mesh, stacked)


def _average(grads: List[torch.Tensor], size: int, group=None) -> None:
    """Average ``grads`` in place over the ``size`` ranks of ``group``: one
    all-reduce of the flattened tensors."""
    if size == 1 or not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    flat /= size
    offset = 0
    for g in grads:
        n = g.numel()
        g.copy_(flat[offset:offset + n].view_as(g))
        offset += n


def average_gradients(network: torch.nn.Module, mesh: Mesh) -> None:
    """Average the parameters' gradients over the ``dp`` rows. A shard of a
    split head averages with its ``dp`` column. A replicated parameter's
    gradient is the same on the ranks of an ``mp`` group (they hold the
    same rows and gather the same heads), so it is averaged over every
    rank, which is its mean over ``dp`` and leaves every rank bitwise the
    same gradient even where a card's backward pass sums in another order
    from one process to the next."""
    split = {id(p) for m in network.modules() if isinstance(m, ColumnParallelLinear)
             for p in m.parameters()}
    params = [p for p in network.parameters() if p.grad is not None]
    _average([p.grad for p in params if id(p) not in split], mesh.world_size)
    _average([p.grad for p in params if id(p) in split], mesh.dp, mesh.dp_group)


def _average_metrics(metrics: Dict[str, torch.Tensor], mesh: Mesh) -> Dict[str, torch.Tensor]:
    """Scalar metrics averaged over the ranks (the means over the global
    batch: the ranks of an ``mp`` group hold the same ones); per-sample
    entries (``_new_values``) stay this rank's."""
    if mesh.world_size == 1:
        return metrics
    keys = sorted(k for k, v in metrics.items() if v.dim() == 0)
    vals = torch.stack([metrics[k] for k in keys])
    dist.all_reduce(vals)
    vals /= mesh.world_size
    return dict(metrics, **{k: vals[i] for i, k in enumerate(keys)})


def make_sharded_train_step(cfg, env, network: torch.nn.Module, mesh: Mesh) -> Callable:
    """The port's train step (``learner/train.make_train_step``) on this
    rank's rows: the gradient is averaged over the ranks before the
    optimizer steps, so every rank applies the same update to the same
    weights (the replicated state of the JAX sharded step), and the scalar
    metrics are averaged too. On one rank it is the plain step.

    With ``mesh.mp > 1`` it first splits ``network``'s dense heads in place
    (``mesh.shard_heads``; the JAX step places its state by
    ``param_shardings``): an optimizer built on ``network`` steps the
    shards, and a whole state loaded afterwards goes through
    ``mesh.local_state``. BatchNorm's statistics are taken over the ``dp``
    column."""
    from minizero_tpu_torch.learner.train import make_train_step

    shard_heads(mesh, network)
    for m in network.modules():
        if isinstance(m, BatchNorm2d):
            m.group = mesh.dp_group
    step = make_train_step(cfg, env, network,
                           grad_hook=lambda: average_gradients(network, mesh))

    def sharded_step(state, batch, generator=None, rotations=None):
        return _average_metrics(step(state, batch, generator, rotations), mesh)

    return sharded_step


def make_sharded_train_chunk(cfg, env, network: torch.nn.Module, mesh: Mesh,
                             timeout_s: float = 0.0, logger=None) -> Callable:
    """``chunk(state, batches, generator) -> metrics``: K sharded steps over
    the list ``batches`` (this rank's rows each) and one synchronise, all
    under the collective watchdog (``timeout_s``; 0 disables it), so a
    wedged peer aborts this rank within the timeout whether the block comes
    in a collective (gloo) or in the synchronise (NCCL's collectives are
    asynchronous). The metrics come back stacked, ``[K]``
    (``_new_values``: ``[K, b_local]``)."""
    step = make_sharded_train_step(cfg, env, network, mesh)

    def chunk(state, batches: List[Dict], generator=None) -> Dict[str, torch.Tensor]:
        with collective_watchdog(f"train_chunk_{state.step + len(batches)}", timeout_s, logger):
            rows = [step(state, b, generator) for b in batches]
            if mesh.device.type == "cuda":
                torch.cuda.synchronize(mesh.device)
        return {k: torch.stack([r[k] for r in rows]) for k in rows[0]}

    return chunk

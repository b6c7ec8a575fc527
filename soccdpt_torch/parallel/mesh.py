"""The (data, model) mesh over the ranks of a process group (the port of
``soccdpt_tpu/parallel/mesh.py``).

The JAX package lays a ``jax.sharding.Mesh`` over the chips and lets XLA
insert the collectives. Here a rank is a process (``torchrun`` starts one
a card) and the mesh says which ranks sum what: the ranks fill it row by
row, ``rank = data_index * tp + model_index``. Ranks that differ along
``data`` hold other rows of the global batch; ranks that differ along
``model`` hold the same rows and each its slice of the sharded optimizer
state (``parallel/sharding.py``). A rank that the mesh does not cover
(the data axis shrinks until it divides the batch) takes no part.

With no process group (one process, no ``torchrun`` environment) the mesh
is ``{"data": 1}`` with no groups, and the trainer runs no collective.
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Any, Dict, Mapping, Optional, Tuple, Union

import torch
import torch.distributed as dist

from ..core.device import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``shape`` maps each axis to its size, in axis order, as
    ``jax.sharding.Mesh.shape`` does. ``data_group`` holds the ranks that
    differ from this one along ``data`` only (gradients, BatchNorm's moments
    and the loss's divisors are summed over it), ``model_group`` those that
    differ along ``model`` only (the sharded update is gathered over it).
    Both are ``None`` without a process group and on a rank outside the
    mesh."""

    shape: Mapping[str, int]
    rank: int = 0
    data_group: Any = None
    model_group: Any = None

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @property
    def dp(self) -> int:
        return self.shape.get(DATA_AXIS, 1)

    @property
    def tp(self) -> int:
        return self.shape.get(MODEL_AXIS, 1)

    @property
    def active(self) -> bool:
        return self.rank < self.size

    @property
    def data_index(self) -> int:
        return self.rank // self.tp

    @property
    def model_index(self) -> int:
        return self.rank % self.tp

    @property
    def distributed(self) -> bool:
        return self.data_group is not None


@dataclasses.dataclass(frozen=True)
class Distributed:
    """This process's rank, the world's size and this rank's device."""

    rank: int
    world_size: int
    device: torch.device


def _rank_device(device, local_rank: int) -> torch.device:
    dev = torch.device(device) if device is not None else torch.device("cuda", local_rank)
    if dev.type != "cuda":
        return dev
    if dev.index is None:
        dev = torch.device("cuda", local_rank)
    resolve_device(dev)  # raises without a card
    if dev.index >= torch.cuda.device_count():
        raise RuntimeError(
            f"no CUDA device {dev.index}: {torch.cuda.device_count()} visible to this rank"
        )
    return dev


def init_distributed(device: Union[str, torch.device, None] = None) -> Distributed:
    """Join the process group of this run and pick this rank's device.

    Under ``torchrun`` (``RANK`` and ``WORLD_SIZE`` set; ``MASTER_ADDR`` and
    ``MASTER_PORT`` too) it initialises the default group, over NCCL for a
    CUDA device and gloo for the CPU. A default group that the caller made
    already (say, on a ``FileStore``) is taken as it is. Without either it
    is one process, with no group, exactly as a single-process run.
    The device is ``cuda:LOCAL_RANK`` unless ``device`` names one; a card
    that is missing raises."""
    env = os.environ
    local = int(env.get("LOCAL_RANK", 0))
    if dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
        return Distributed(rank, world, _rank_device(device, local))
    if "RANK" not in env or "WORLD_SIZE" not in env:
        return Distributed(0, 1, resolve_device(device))
    rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
    dev = _rank_device(device, local)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", rank=rank,
                            world_size=world)
    return Distributed(rank, world, dev)


def world_and_rank() -> Tuple[int, int]:
    if dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def make_mesh(
    shape: Optional[Tuple[int, ...]] = None,
    axes: Tuple[str, ...] = (DATA_AXIS,),
) -> Mesh:
    """A mesh over the ranks of the default process group (one rank without
    one). Default: every rank on a 1-D ``data`` axis. It creates the groups
    of both axes, so every rank of the world calls it, in the same order."""
    world, rank = world_and_rank()
    if shape is None:
        shape, axes = (world,), tuple(axes[:1])
    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    if axes not in ((DATA_AXIS,), (DATA_AXIS, MODEL_AXIS)) or len(axes) != len(shape):
        raise ValueError(f"mesh axes {axes} of shape {shape}: expected ('data',) or "
                         "('data', 'model')")
    n = math.prod(shape)
    if n > world:
        raise ValueError(f"mesh shape {shape} needs {n} ranks, have {world}")
    mesh = Mesh(dict(zip(axes, shape)), rank)
    if not dist.is_initialized():
        return mesh
    dp, tp = mesh.dp, mesh.tp
    groups = {}
    for m in range(tp):
        g = dist.new_group([d * tp + m for d in range(dp)])
        if mesh.active and mesh.model_index == m:
            groups["data_group"] = g
    for d in range(dp):
        g = dist.new_group([d * tp + m for m in range(tp)])
        if mesh.active and mesh.data_index == d:
            groups["model_group"] = g
    return dataclasses.replace(mesh, **groups)


def mesh_for_batch(batch_size: int, tp: int = 1) -> Mesh:
    """The mesh of a global batch of ``batch_size`` rows: a 1-D data mesh
    over the largest rank count that divides it when ``tp`` is 1, else a
    (data, model) mesh with ``model = tp`` whose data axis shrinks from
    ``world / tp`` until it divides the batch. The ranks it leaves out lie
    outside the mesh."""
    tp = max(int(tp), 1)
    world, _ = world_and_rank()
    if world % tp != 0:
        raise ValueError(f"tp={tp} does not divide the world size {world}")
    n = world // tp
    while n > 1 and batch_size % n != 0:
        n -= 1
    if tp == 1:
        return make_mesh(shape=(n,))
    return make_mesh(shape=(n, tp), axes=(DATA_AXIS, MODEL_AXIS))


def local_batch_size(global_batch: int, mesh: Mesh) -> int:
    n = mesh.shape.get(DATA_AXIS, 1)
    if global_batch % n != 0:
        raise ValueError(
            f"global batch {global_batch} not divisible by data axis {n}"
        )
    return global_batch // n


def batch_sharding(mesh: Mesh, global_batch: int) -> slice:
    """The rows of the global batch that this rank holds: its data index's
    share, the same on every rank along ``model``."""
    local = local_batch_size(global_batch, mesh)
    return slice(mesh.data_index * local, (mesh.data_index + 1) * local)


def shard_batch(batch: Mapping[str, Any], mesh: Mesh, global_batch: int) -> Dict[str, Any]:
    """This rank's rows of a batch dict (numpy arrays or tensors). A batch
    of ``global_batch`` rows is cut to :func:`batch_sharding`; one of
    ``global_batch / dp`` rows already is this rank's share (a feed that
    reads only it, ``iterate_batches(..., process_index, process_count)``)
    and passes. With one data index every batch passes."""
    if mesh.dp == 1:
        return dict(batch)
    rows = batch_sharding(mesh, global_batch)
    local = rows.stop - rows.start
    out = {}
    for key, value in batch.items():
        n = len(value)
        if n == global_batch:
            out[key] = value[rows]
        elif n == local:
            out[key] = value
        else:
            raise ValueError(f"batch {key!r} has {n} rows: neither the global batch "
                             f"{global_batch} nor this rank's share {local}")
    return out

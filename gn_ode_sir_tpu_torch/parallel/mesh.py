"""Device meshes and placements (port of ``gn_ode_sir_tpu.parallel.mesh``).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the processes
of the group, one device each; each named axis has its own sub-group, which
the collectives of :mod:`~gn_ode_sir_tpu_torch.parallel.spmd` reduce over.
Where the JAX package returns ``NamedSharding``s, :func:`data_sharding` and
:func:`replicated_sharding` return the DTensor placements that stand for
them.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Replicate, Shard

from gn_ode_sir_tpu_torch.parallel.distributed import default_device_type, init_single_process


def make_mesh(shape=None, axis_names=("data",), device_type: str | None = None) -> DeviceMesh:
    """A mesh over every process of the group. ``shape=None`` puts them all
    on the first axis; multi-axis layouts (``shape=(2, 2), axis_names=
    ('data', 'edge')``) give each axis its sub-groups. Without a process
    group (a single process, no launcher) a group of this process alone is
    started first. ``device_type`` defaults to CUDA and raises RuntimeError
    where no card is visible; ``"cpu"`` builds the mesh over gloo."""
    device_type = device_type or default_device_type()
    init_single_process(device_type)
    world = dist.get_world_size()
    if shape is None:
        shape = (world,) + (1,) * (len(axis_names) - 1)
    shape = tuple(int(s) for s in shape)
    if int(np.prod(shape)) != world:
        raise ValueError(f"mesh shape {shape} does not cover the {world} processes")
    return init_device_mesh(device_type, shape, mesh_dim_names=tuple(axis_names))


def axis_dim(mesh: DeviceMesh, axis: str) -> int:
    names = mesh.mesh_dim_names or ()
    if axis not in names:
        raise ValueError(f"mesh has no axis {axis!r} (axes {names})")
    return names.index(axis)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(axis_dim(mesh, axis))


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    """This process's coordinate on ``axis`` (``jax.lax.axis_index``)."""
    return mesh.get_local_rank(axis_dim(mesh, axis))


def axis_group(mesh: DeviceMesh, axis: str):
    """The process group of ``axis`` that holds this process."""
    return mesh.get_group(axis_dim(mesh, axis))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this process's collectives and tensors use."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def data_sharding(mesh: DeviceMesh, axis: str = "data", rank: int = 1) -> list:
    """Placements that shard the leading (batch) dimension over ``axis`` and
    replicate over the other axes. ``rank`` (the array rank the JAX
    ``PartitionSpec`` spells out) is accepted for the same call; a ``Shard(0)``
    placement leaves the trailing dimensions whole whatever their number."""
    del rank
    dim = axis_dim(mesh, axis)
    return [Shard(0) if d == dim else Replicate() for d in range(mesh.ndim)]


def replicated_sharding(mesh: DeviceMesh) -> list:
    return [Replicate()] * mesh.ndim


def local_block(n: int, mesh: DeviceMesh, axis: str) -> slice:
    """This process's contiguous block of ``n`` rows split over ``axis``
    (``n`` must divide by the axis size, as a JAX ``P(axis)`` requires)."""
    size = axis_size(mesh, axis)
    if n % size:
        raise ValueError(f"{n} rows do not divide over axis {axis!r} of size {size}")
    b = n // size
    r = axis_index(mesh, axis)
    return slice(r * b, (r + 1) * b)

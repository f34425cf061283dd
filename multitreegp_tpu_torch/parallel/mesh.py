"""Meshes of ranks and the island sharding, on ``torch.distributed``.

Port of ``multitreegp_tpu/parallel/mesh.py``. A mesh is one process per
device over the default process group: NCCL ranks on ``cuda:{LOCAL_RANK}``
(launched by ``torchrun`` or ``torch.multiprocessing.spawn``), or gloo ranks
on the CPU. It wraps PyTorch's own ``DeviceMesh``
(``torch.distributed.device_mesh.init_device_mesh``). The island axis is the
sharded one: rank ``r`` of ``W`` holds the contiguous block of islands
``[r * I / W, (r + 1) * I / W)``, and the migration ring runs over the ranks
in their flattened (dcn-major) order, as the JAX package's collectives run
over the mesh's flattened axes.

Where no process group is initialised, :func:`make_mesh` starts a one-rank
group on the caller's device (NCCL on a card, gloo on the CPU, its store in
this process): the counterpart of JAX's one-device mesh.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from ..core.trees import TreeTensors


@dataclass(frozen=True)
class Mesh:
    """This rank's view of a mesh: PyTorch's ``DeviceMesh``, the axis names,
    the rank's device, its rank and the world size (the number of ranks)."""

    device_mesh: object  # torch.distributed.device_mesh.DeviceMesh
    axis_names: Tuple[str, ...]
    device: torch.device
    rank: int
    size: int

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.device_mesh.mesh.shape)

    @property
    def group(self):
        """The process group of the flattened mesh: the default one."""
        return dist.group.WORLD


def _rank_device(backend: str, device=None) -> torch.device:
    """The device of this rank: ``cuda:{LOCAL_RANK}`` under NCCL (the rank
    modulo the visible cards without ``LOCAL_RANK``), the CPU otherwise."""
    if backend != "nccl":
        return torch.device("cpu")
    if device is not None and torch.device(device).index is not None:
        return torch.device(device)
    local = os.environ.get("LOCAL_RANK")
    index = int(local) if local is not None else dist.get_rank() % torch.cuda.device_count()
    return torch.device("cuda", index)


def _ensure_group(device=None) -> str:
    """The default group's backend; starts a one-rank group on ``device``
    (the card by default, the CPU if asked) where none is initialised."""
    if dist.is_initialized():
        return dist.get_backend()
    dev = torch.device(device if device is not None else "cuda")
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    return backend


def _mesh(shape: Sequence[int], axis_names: Tuple[str, ...], device) -> Mesh:
    from torch.distributed.device_mesh import init_device_mesh

    backend = _ensure_group(device)
    dev = _rank_device(backend, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    world = dist.get_world_size()
    size = 1
    for s in shape:
        size *= s
    if size != world:
        raise ValueError(f"a mesh of {tuple(shape)} = {size} ranks over a group of {world}")
    dm = init_device_mesh(dev.type, tuple(shape), mesh_dim_names=axis_names)
    return Mesh(dm, axis_names, dev, dist.get_rank(), world)


def make_mesh(num_devices: Optional[int] = None, axis_name: str = "i", device=None) -> Mesh:
    """1-D mesh over the default process group, one rank per device
    (reference: ``create_device_mesh`` over the devices). ``num_devices``,
    if given, must be the world size. Without a process group it starts a
    one-rank group on ``device`` (the card unless the CPU is asked for)."""
    _ensure_group(device)
    world = dist.get_world_size()
    if num_devices is not None and num_devices != world:
        raise ValueError(f"num_devices {num_devices} != the process group's {world} ranks")
    return _mesh((world,), (axis_name,), device)


def make_mesh_2d(num_slices: int, devices_per_slice: Optional[int] = None,
                 axis_names=("dcn", "i"), device=None) -> Mesh:
    """2-D (slices x devices of a slice) mesh over the default group. The
    migration ring runs over the flattened rank order, slice-major, so it
    leaves a slice once per slice boundary."""
    _ensure_group(device)
    world = dist.get_world_size()
    if devices_per_slice is None:
        devices_per_slice = world // num_slices
    return _mesh((num_slices, devices_per_slice), tuple(axis_names), device)


def mesh_axes(mesh: Mesh) -> Union[str, Tuple[str, ...]]:
    """The axis name of a 1-D mesh, the tuple of names of a 2-D one."""
    return mesh.axis_names if len(mesh.axis_names) > 1 else mesh.axis_names[0]


def island_sharding(mesh: Mesh, num_islands: int) -> slice:
    """This rank's contiguous block of the island axis; the islands must
    divide over the ranks."""
    if num_islands % mesh.size:
        raise ValueError(f"{num_islands} islands do not divide over {mesh.size} ranks")
    k = num_islands // mesh.size
    return slice(mesh.rank * k, (mesh.rank + 1) * k)


def fitness_sharding(mesh: Mesh, num_islands: int) -> slice:
    """The block of the fitness ``(islands, pop)``: the islands'."""
    return island_sharding(mesh, num_islands)


def shard_population(populations: TreeTensors, fitness_or_none, mesh: Mesh):
    """This rank's block of the island-major populations (and fitness)."""
    block = island_sharding(mesh, populations.ops.shape[0])
    local = populations.map(lambda x: x[block])
    if fitness_or_none is None:
        return local
    return local, fitness_or_none[fitness_sharding(mesh, fitness_or_none.shape[0])]


def all_gather_cat(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's ``x`` (the same shape on each), concatenated along dim 0
    in rank order."""
    if mesh.size == 1:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x, group=mesh.group)
    return torch.cat(parts)


def gather_population(populations: TreeTensors, fitness_or_none, mesh: Mesh):
    """The full ``(islands, pop, ...)`` tensors from every rank's block, on
    every rank."""
    full = populations.map(lambda x: all_gather_cat(x, mesh))
    if fitness_or_none is None:
        return full
    return full, all_gather_cat(fitness_or_none, mesh)

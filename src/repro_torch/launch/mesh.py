"""Mesh construction (counterpart of ``repro/launch/mesh.py``).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks
of the default process group, its ``mesh_dim_names`` taken from
``("pod", "data", "model")``. Production target, as the reference's:

  single-pod: (16, 16)      axes ("data", "model")
  multi-pod:  (2, 16, 16)   axes ("pod", "data", "model")

Building a mesh needs a default process group of as many ranks as the
mesh has (``torch.distributed.init_process_group`` with its address, world
size and rank, NCCL on the card, gloo on the host); a shape whose product
differs from the world size raises. The one exception is a one-rank mesh:
:func:`make_test_mesh` starts a one-rank group itself when none exists.
``device=None`` means the CUDA card and raises without one; nothing falls
back to the host.
"""

from __future__ import annotations

import math

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..compat import mesh_axes, resolve_device
from ..core.collective_fabric import single_rank_group

__all__ = ["make_production_mesh", "make_test_mesh", "batch_axes", "dp_size"]


def _mesh(shape, axes, device) -> DeviceMesh:
    dev = resolve_device(device)
    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in rank")
    n = math.prod(shape)
    if not dist.is_initialized():
        if n != 1:
            raise RuntimeError(
                f"a mesh of {n} ranks needs a default process group of {n} "
                "ranks (torch.distributed.init_process_group)")
        single_rank_group(dev)
    world = dist.get_world_size()
    if world != n:
        raise ValueError(f"a mesh of shape {shape} needs {n} ranks; the "
                         f"default process group has {world}")
    return init_device_mesh(dev.type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device=None) -> DeviceMesh:
    """The (16, 16) ("data", "model") mesh over 256 ranks, or the (2, 16,
    16) ("pod", "data", "model") one over 512; any other world raises."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device)


def make_test_mesh(shape=(1, 1), axes=("data", "model"),
                   device=None) -> DeviceMesh:
    """A small mesh: one rank (starting a one-rank group when none
    exists) or the ranks of the default process group."""
    return _mesh(shape, axes, device)


def batch_axes(mesh) -> tuple[str, ...]:
    """Mesh axes the global batch is sharded over."""
    names = mesh_axes(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def dp_size(mesh) -> int:
    axes = mesh_axes(mesh)
    return math.prod(axes[a] for a in batch_axes(mesh))

"""Device meshes (the reference's ``dist/mesh.py``) on
``torch.distributed``'s ``DeviceMesh``.  Functions, not module constants:
importing this module touches no process group and no device.

Two mesh vocabularies are in play, and ``dist/sharding.py``'s rule table
lists alternatives for both (absent axis names drop out):

* the fixed production pod meshes, axes ``("pod", "data", "model")``;
* generic ``("data", "fsdp", "tensor")`` meshes sized to the world, with
  a fall-back to pure data parallelism, so the same code runs on one
  rank.

A ``DeviceMesh`` spans the ranks of an initialised process group, one
device a rank.  A single-process caller gets a world of one from
:func:`init_world_of_one` (an in-process store, rank 0 of 1), set up
explicitly: nothing here reads ``MASTER_ADDR`` or ``RANK`` from the
environment.  :class:`AbstractMesh` carries only axis names and sizes,
so placement arithmetic can price the 256- and 512-rank production
meshes without a rank (the reference's ``AbstractMesh``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.models.layers import resolve_device


@dataclass(frozen=True)
class AbstractMesh:
    """A mesh's axis names and sizes, without ranks or devices."""

    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))


def axis_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh``, an :class:`AbstractMesh`
    or any mesh-like record with ``axis_names`` and ``axis_sizes``."""
    if hasattr(mesh, "mesh_dim_names"):
        return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    return dict(zip(mesh.axis_names, mesh.axis_sizes))


def _production_axes(multi_pod: bool):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return shape, axes


def init_world_of_one(device=None) -> torch.device:
    """Initialise the default process group as a world of one (rank 0 of
    1, an in-process ``HashStore``; NCCL on ``cuda``, gloo on the CPU) for
    ``device`` (``cuda`` unless the caller names one), unless a group is
    already initialised.  Returns the device."""
    import torch.distributed as dist

    dev = resolve_device(device)
    if not dist.is_initialized():
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        backend = "nccl" if dev.type == "cuda" else "gloo"
        dist.init_process_group(backend, store=dist.HashStore(),
                                rank=0, world_size=1,
                                device_id=dev if dev.type == "cuda" else None)
    return dev


def _world_size() -> int:
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError(
            "no process group: initialise one (init_process_group with its "
            "address, world size and rank, or init_world_of_one for a "
            "single process) before building a mesh")
    return dist.get_world_size()


def _mesh(device: torch.device, shape, axes, ranks=None):
    from torch.distributed.device_mesh import DeviceMesh

    world = _world_size()
    n = 1
    for s in shape:
        n *= s
    ranks = list(range(world)) if ranks is None else list(ranks)
    if len(ranks) != n:
        raise ValueError(f"a {dict(zip(axes, shape))} mesh needs {n} ranks, "
                         f"not {len(ranks)}")
    grid = torch.tensor(ranks, dtype=torch.int64).reshape(shape)
    return DeviceMesh(device.type, grid, mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """Single pod: (data=16, model=16) = 256 ranks.  Multi-pod: (pod=2,
    data=16, model=16) = 512 ranks; the pod axis is pure data parallelism.
    Needs a process group of that world size."""
    shape, axes = _production_axes(multi_pod)
    return _mesh(resolve_device(device), shape, axes)


def make_abstract_production_mesh(*, multi_pod: bool = False
                                  ) -> AbstractMesh:
    """The :class:`AbstractMesh` twin of :func:`make_production_mesh`:
    axis names and sizes only, for placement arithmetic on one host."""
    shape, axes = _production_axes(multi_pod)
    return AbstractMesh(axes, shape)


def make_host_mesh(device=None):
    """A 1 x 1 ``("data", "model")`` mesh over this process's one device
    (``cuda`` unless the caller names one).  Needs an initialised world of
    one (:func:`init_world_of_one`)."""
    world = _world_size()
    if world != 1:
        raise ValueError(f"the host mesh is one rank; the process group "
                         f"has {world}")
    return _mesh(resolve_device(device), (1, 1), ("data", "model"))


def make_device_mesh(*, data: Optional[int] = None, fsdp: int = 1,
                     tensor: int = 1, ranks: Optional[Sequence[int]] = None,
                     device=None):
    """A ``(data, fsdp, tensor)`` mesh over ``ranks`` (every rank of the
    initialised process group by default), each rank on its ``device``
    (``cuda`` unless the caller names one).

    ``data=None`` takes whatever ranks remain after fsdp × tensor.  If the
    request does not fit the rank count the mesh falls back to pure data
    parallelism over every rank, as the reference's does."""
    n = _world_size() if ranks is None else len(ranks)
    if data is None:
        data = max(1, n // (fsdp * tensor))
    if data * fsdp * tensor != n:
        data, fsdp, tensor = n, 1, 1
    return _mesh(resolve_device(device), (data, fsdp, tensor),
                 ("data", "fsdp", "tensor"), ranks)

"""Device meshes: the production mesh, the host mesh, the scenario mesh.

Port of ``repro.launch.mesh``.  Single pod: (data=16, model=16), 256
devices; multi-pod: (pod=2, data=16, model=16), 512 devices.

The reference's meshes are JAX meshes, driven from one controller
(``shard_map``, ``jit`` with shardings).  torch's ``DeviceMesh`` is one
process per device (SPMD), so the port keeps its own small
:class:`Mesh`: axis names, a shape and, for a mesh that runs work, one
``torch.device`` an entry.  The sweep engine splits a chunk's scenarios
over such a mesh from one process, and the dry-run planner
(``launch.dryrun``) reads only names and sizes, so neither needs
``torch.distributed``.  :func:`device_mesh` gives the ``DeviceMesh`` of
the same shape where a process group is initialised (the DTensor
placements of ``sharding.rules.placements``).

A model runs on a mesh from one process a rank: :func:`init_mesh`
brings up the process group (``nccl`` on the card, ``gloo`` on the CPU)
through a ``torch.distributed`` store the caller passes in (a
``HashStore`` for one rank, a ``FileStore`` for ranks on one host), and
returns the mesh with its ``DeviceMesh``; :func:`destroy_mesh` takes
the group down.

Functions only: importing this module touches no device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Axis names, the size of each axis and, in row-major order over
    the axes, each entry's device; ``devices=None`` for an abstract mesh
    that only plans (the production meshes)."""

    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]
    devices: Optional[Tuple[torch.device, ...]] = None
    # The DeviceMesh of a mesh a model runs on (:func:`init_mesh`).
    device_mesh: Any = dataclasses.field(default=None, compare=False,
                                         repr=False)

    def __post_init__(self):
        if len(self.axis_names) != len(self.shape):
            raise ValueError(f"{len(self.axis_names)} axis names for "
                             f"{len(self.shape)} dims")
        if self.devices is not None and len(self.devices) != self.size:
            raise ValueError(f"{len(self.devices)} devices for a mesh of "
                             f"{self.size} entries")

    @property
    def size(self) -> int:
        """The number of entries (devices)."""
        return math.prod(self.shape)

    def axis_size(self, name: str) -> int:
        """The size of axis ``name`` (1 for an axis the mesh lacks)."""
        if name not in self.axis_names:
            return 1
        return self.shape[self.axis_names.index(name)]

    def describe(self) -> str:
        """The shape as the reference's records write it, ``16x16``."""
        return "x".join(str(s) for s in self.shape)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The abstract 16x16 or 2x16x16 mesh the planner lays work on."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def _present(device: DeviceLike) -> Tuple[torch.device, ...]:
    """The devices a mesh over the present devices spans: every CUDA
    card (``device=None``), the one named, or the CPU by name."""
    if device is None:
        resolve_device(None)
        return tuple(torch.device("cuda", i)
                     for i in range(torch.cuda.device_count()))
    return (resolve_device(device),)


def make_host_mesh(model_axis: int = 1, device: DeviceLike = None) -> Mesh:
    """(data, model) mesh over the present devices (tests, examples):
    every card by default, raising without one; ``device="cpu"`` for a
    one-entry CPU mesh."""
    devs = _present(device)
    data = max(1, len(devs) // model_axis)
    return Mesh(("data", "model"), (data, model_axis),
                devs[:data * model_axis])


def make_scenario_mesh(max_devices: int = 0, axis: str = "scenario",
                       device: DeviceLike = None) -> Mesh:
    """1-D mesh over the present devices for Monte-Carlo scenario
    sharding (``sweep.engine``): every card (at most ``max_devices`` when
    positive), raising without one; ``device`` names one device, and
    ``device="cpu"`` gives a one-entry CPU mesh.  With one entry the
    engine's sharded chunk is the unsharded call."""
    devs = _present(device)
    if max_devices > 0:
        devs = devs[:max_devices]
    return Mesh((axis,), (len(devs),), devs)


def scenario_shard_count(mesh: Mesh, axis: str = "scenario") -> int:
    return mesh.axis_size(axis)


def data_parallel_size(mesh: Mesh) -> int:
    return mesh.axis_size("pod") * mesh.axis_size("data")


def device_mesh(mesh: Mesh):
    """The ``torch.distributed`` ``DeviceMesh`` of ``mesh``'s shape and
    axis names (an initialised process group of ``mesh.size`` ranks is
    needed), on the device type of its entries (the CPU for an abstract
    mesh)."""
    from torch.distributed.device_mesh import init_device_mesh
    kind = mesh.devices[0].type if mesh.devices else "cpu"
    return init_device_mesh(kind, mesh.shape, mesh_dim_names=mesh.axis_names)


def init_mesh(mesh: Mesh, store, rank: int = 0,
              device: DeviceLike = None) -> Mesh:
    """Bring up the process group of ``mesh``'s ``mesh.size`` ranks as
    rank ``rank``, rendezvousing through the ``torch.distributed`` store
    ``store`` (no network address), and return ``mesh`` with its
    entries' devices and its ``DeviceMesh``.  On the card by default
    (``nccl``, rank ``r`` on card ``r`` modulo the cards present),
    raising without one; ``device="cpu"`` runs ``gloo`` on the CPU."""
    import torch.distributed as dist
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        devices = tuple(torch.device("cuda", r % torch.cuda.device_count())
                        for r in range(mesh.size))
    else:
        devices = (dev,) * mesh.size
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            store=store, rank=rank, world_size=mesh.size)
    up = dataclasses.replace(mesh, devices=devices)
    return dataclasses.replace(up, device_mesh=device_mesh(up))


def destroy_mesh() -> None:
    """Take down the process group :func:`init_mesh` brought up (a no-op
    when none is up); its mesh is not used after."""
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()

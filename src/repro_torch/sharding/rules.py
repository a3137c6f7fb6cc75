"""Logical-axis sharding rules for the production mesh.

Port of ``repro.sharding.rules``.  Mesh axes: ``("pod", "data",
"model")`` multi-pod or ``("data", "model")`` single-pod.  Logical axes
used by the model zoo:

* ``batch``  -> ("pod", "data")   — data parallel
* ``fsdp``   -> ("pod", "data")   — parameter / optimizer sharding (2-D
                                    with ``tensor``)
* ``tensor`` -> ("model",)        — head / d_ff / expert / vocab dim
* ``expert`` -> ("model",)        — MoE expert-parallel (when divisible)
* ``cache_seq`` -> ("data",)      — decode KV-cache sequence sharding
* ``seq``    -> ("model",)        — Megatron-style sequence parallelism
* everything else -> replicated

A :class:`PartitionSpec` has one entry a tensor dim: ``None``
(replicated), an axis name, or a tuple of axis names (the dim split over
their product, major to minor); it compares entry for entry with the
reference's ``jax.sharding.PartitionSpec``.  :func:`placements` turns one
into the DTensor ``Shard`` / ``Replicate`` list of each mesh dim.

Inside a model that runs on a mesh, :func:`constrain`,
:func:`constrain_pad` and :func:`residual_constrain` lay a DTensor out
by logical names, as the reference's ``with_sharding_constraint`` does:
``x.redistribute`` to the placements of the spec.  :func:`constrain`
drops an axis whose dim does not divide by its shards
(:func:`constrain_spec`); :func:`constrain_pad` keeps it, DTensor's
uneven ``Shard`` (``torch.chunk``'s split: the last shards short or
empty) taking the place of GSPMD's padding.  With ``mesh=None`` each
returns its input itself.  A mesh that lays tensors out carries its
``DeviceMesh`` (``launch.mesh.init_mesh``).  :func:`is_dtensor`,
:func:`local` and :func:`like` let one code path take a tensor on one
device or a DTensor's shard.
"""

from __future__ import annotations

import dataclasses
import math
import sys
from typing import Callable, Optional, Sequence, Tuple, Union

import torch

from repro_torch.launch.mesh import Mesh

Entry = Union[None, str, Tuple[str, ...]]

# Logical name -> mesh axis names (those present in the mesh are used,
# in this order).
LOGICAL_RULES: dict[str, tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "fsdp": ("pod", "data"),
    "tensor": ("model",),
    "expert": ("model",),
    "cache_seq": ("data",),
    "seq": ("model",),
}


class PartitionSpec(tuple):
    """One entry a tensor dim: None, an axis name or a tuple of them."""

    def __new__(cls, *entries: Entry) -> "PartitionSpec":
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


def entry_axes(entry: Entry) -> Tuple[str, ...]:
    """The axis names of one spec entry."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def entry_size(entry: Entry, mesh: Mesh) -> int:
    """The number of shards one spec entry splits its dim into."""
    return math.prod(mesh.axis_size(a) for a in entry_axes(entry))


def mesh_axes(mesh: Mesh) -> tuple[str, ...]:
    return tuple(mesh.axis_names)


def resolve(logical: Optional[str], mesh: Mesh) -> Entry:
    """Logical axis name -> mesh axes entry for a PartitionSpec."""
    if logical is None:
        return None
    axes = tuple(a for a in LOGICAL_RULES.get(logical, ())
                 if a in mesh.axis_names)
    if not axes:
        return None
    return axes if len(axes) > 1 else axes[0]


def spec(mesh: Mesh, *logical: Optional[str]) -> PartitionSpec:
    """Build a PartitionSpec from logical axis names."""
    return P(*(resolve(name, mesh) for name in logical))


def tree_spec(tree, fn: Callable) -> object:
    """Map ``fn(path_str, leaf) -> PartitionSpec`` over a nested dict."""
    def walk(path, node):
        if isinstance(node, dict):
            return {k: walk(f"{path}/{k}", v) for k, v in node.items()}
        return fn(path, node)
    return walk("", tree)


def divisible(n: int, mesh: Mesh, axes: Sequence[str]) -> bool:
    """Whether ``n`` splits over the product of ``axes`` (those the mesh
    lacks count 1)."""
    return n % math.prod(mesh.axis_size(a) for a in axes) == 0


def shard_shape(shape: Sequence[int], pspec: PartitionSpec,
                mesh: Mesh) -> Tuple[int, ...]:
    """Each device's shard of a ``shape`` tensor laid out by ``pspec``
    (as ``NamedSharding.shard_shape``); raises where an entry does not
    divide its dim."""
    out = []
    for dim, entry in zip(shape, tuple(pspec) + (None,) * len(shape)):
        n = entry_size(entry, mesh)
        if dim % n:
            raise ValueError(f"dim {dim} does not split into {n} shards "
                             f"({pspec} on {mesh.describe()})")
        out.append(dim // n)
    return tuple(out)


def placements(pspec: PartitionSpec, mesh: Mesh) -> list:
    """The DTensor placement of each mesh dim for ``pspec``: ``Shard(d)``
    where tensor dim ``d``'s entry names the mesh axis, else
    ``Replicate()``.  A dim split over several axes shards on each of
    them in mesh order, major to minor, as the entry orders them (the
    rules list axes in mesh order)."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for axis in mesh.axis_names:
        dims = [d for d, entry in enumerate(pspec)
                if axis in entry_axes(entry)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return out


# ---------------------------------------------------------------------------
# Constraints inside a model on a mesh
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and a spec: the counterpart of ``jax.sharding.
    NamedSharding``.  :attr:`placements` are the DTensor placements of
    ``spec`` on ``mesh.device_mesh``."""

    mesh: Mesh
    spec: PartitionSpec

    @property
    def placements(self) -> list:
        return placements(self.spec, self.mesh)


def named(mesh: Mesh, *logical: Optional[str]) -> NamedSharding:
    return NamedSharding(mesh, spec(mesh, *logical))


def constrain_spec(shape: Sequence[int], mesh: Mesh,
                   *logical: Optional[str]) -> PartitionSpec:
    """The spec :func:`constrain` lays a ``shape`` tensor out by: each
    dim's logical name, or None where the name resolves to no axis of
    ``mesh`` or the dim does not divide by the product of its axes (a
    batch of 1, 12 heads on a 16-way axis): those dims replicate."""
    names = []
    for dim, name in zip(shape, logical):
        size = entry_size(resolve(name, mesh), mesh)
        names.append(name if size > 1 and dim % size == 0 else None)
    return spec(mesh, *names)


def is_dtensor(t) -> bool:
    """Whether ``t`` is a DTensor (no DTensor exists before
    ``torch.distributed.tensor`` is imported)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(t, mod.DTensor)


def local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's shard on this rank; a plain tensor itself."""
    return t.to_local() if is_dtensor(t) else t


def like(shard: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """``shard``, this rank's block of a tensor laid out as ``t``, as a
    DTensor in ``t``'s placements where ``t`` is one; else ``shard``."""
    if not is_dtensor(t):
        return shard
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(shard, t.device_mesh, t.placements,
                              run_check=False, shape=t.shape,
                              stride=t.stride())


def _lay_out(x: torch.Tensor, sharding: NamedSharding) -> torch.Tensor:
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        raise TypeError(f"a tensor constrained on mesh "
                        f"{sharding.mesh.describe()} must be a DTensor, got "
                        f"{type(x).__name__}")
    if sharding.mesh.device_mesh is None:
        raise ValueError("the mesh has no DeviceMesh: bring it up with "
                         "launch.mesh.init_mesh")
    return x.redistribute(sharding.mesh.device_mesh, sharding.placements)


def constrain(x: torch.Tensor, mesh: Optional[Mesh],
              *logical: Optional[str]) -> torch.Tensor:
    """Lay the DTensor ``x`` out by logical names (:func:`constrain_spec`:
    dims that do not divide replicate); ``x`` itself without a mesh."""
    if mesh is None:
        return x
    return _lay_out(x, NamedSharding(mesh, constrain_spec(x.shape, mesh,
                                                          *logical)))


def constrain_pad(x: torch.Tensor, mesh: Optional[Mesh],
                  *logical: Optional[str]) -> torch.Tensor:
    """Like :func:`constrain`, but a dim that does not divide stays
    sharded, unevenly (40 heads on a 16-way axis: 3 a shard, the last
    shards short); used for attention's head dims."""
    if mesh is None:
        return x
    return _lay_out(x, named(mesh, *logical))


def residual_constrain(x: torch.Tensor, mesh: Optional[Mesh],
                       seq_shard: bool) -> torch.Tensor:
    """Constrain a (B, S, D) residual-stream tensor between blocks:
    batch over ``data``, the sequence over ``model`` when ``seq_shard``
    (Megatron-style sequence parallelism)."""
    return constrain(x, mesh, "batch", "seq" if seq_shard else None, None)


def replicated(t: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """A tensor every rank holds whole (positions, RoPE tables) as a
    DTensor replicated over ``mesh``, so that it meets the model's
    DTensors in one operation; ``t`` itself without a mesh."""
    if mesh is None:
        return t
    from torch.distributed.tensor import DTensor, Replicate
    return DTensor.from_local(t, mesh.device_mesh,
                              [Replicate()] * len(mesh.shape),
                              run_check=False)


def distribute(t: torch.Tensor, mesh: Mesh,
               *logical: Optional[str]) -> torch.Tensor:
    """A tensor every rank holds whole (the same inputs on every rank) as
    a DTensor laid out by :func:`constrain_spec`: each rank keeps its
    shard, and nothing is sent."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(t, mesh.device_mesh, placements(
        constrain_spec(t.shape, mesh, *logical), mesh), src_data_rank=None)

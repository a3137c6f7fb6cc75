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

The reference's ``constrain``, ``constrain_pad``, ``residual_constrain``
and ``named`` constrain tensors inside a model that runs on a mesh; the
port's models run on one device, so they wait for a model path over
several devices (ROADMAP queue 1).
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple, Union

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

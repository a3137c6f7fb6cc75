"""Msgpack pytree checkpoints, in the reference's file format.

Port of ``repro.checkpoint.msgpack_ckpt``.  A file is one msgpack map
``{"__version__": int, "__meta__": {...}, "leaves": {path: {"dtype":
str, "shape": [...], "data": bytes}}}``, the leaves keyed by
:func:`_flatten_with_paths`' paths (``a/b`` for nested dicts, ``x[0]``
for list items) and their bytes in C order, so either implementation
reads the other's files.  The bytes go through the port's own codec
(:mod:`repro_torch.checkpoint._msgpack`), which writes what msgpack
writes.

Leaves may be torch tensors on any device or numpy arrays; :func:`save`
copies each to the host once.  A bf16 tensor is written with dtype
``"bfloat16"`` and its raw 2-byte payload, as the reference writes an
``ml_dtypes`` bfloat16 array.  :func:`load_flat` returns CPU torch
tensors; :func:`restore` places them on a device.

The versioned header (:data:`FORMAT_VERSION`) lets the sweep runner's
resume checkpoints (``repro_torch.sweep.runner``) refuse a file from an
incompatible future writer; a file from before the header loads as
version 0.  A damaged file raises ``ValueError`` naming it "corrupt or
truncated": the atomic writer (tmp file, fsync, ``os.replace``) never
leaves one.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.checkpoint import _msgpack
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.sharding.rules import is_dtensor

Tensor = torch.Tensor

# Bump when the on-disk layout changes incompatibly.  Readers accept any
# version <= FORMAT_VERSION; newer-versioned files fail loudly.
FORMAT_VERSION = 1

# The file's dtype names (numpy's, and "bfloat16") and their torch dtypes.
_DTYPES = {"bool": torch.bool, "uint8": torch.uint8, "int8": torch.int8,
           "int16": torch.int16, "int32": torch.int32, "int64": torch.int64,
           "float16": torch.float16, "bfloat16": torch.bfloat16,
           "float32": torch.float32, "float64": torch.float64}
_NAMES = {dt: name for name, dt in _DTYPES.items()}


def _flatten_with_paths(tree: Any) -> Dict[str, Any]:
    """The leaves of a nested dict / list tree by path, in the
    reference's order (dict keys sorted)."""
    out: Dict[str, Any] = {}

    def walk(path: str, node):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(f"{path}/{k}" if path else str(k), node[k])
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(f"{path}[{i}]", v)
        else:
            out[path] = node

    walk("", tree)
    return out


def _leaf_record(leaf) -> dict:
    """One leaf's ``{dtype, shape, data}``: a tensor copied to the host
    once (a bf16 one through its int16 view), anything else through
    ``np.asarray``."""
    if isinstance(leaf, Tensor):
        t = leaf.detach().contiguous().cpu()
        if t.dtype not in _NAMES:
            raise TypeError(f"unsupported checkpoint dtype {t.dtype}")
        raw = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
        return {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                "data": raw.numpy().tobytes()}
    a = np.asarray(leaf)
    return {"dtype": str(a.dtype), "shape": list(a.shape),
            "data": a.tobytes()}              # C order, as the reference


def save(path: str, tree: Any, meta: Optional[dict] = None) -> None:
    """Write ``tree``'s leaves and ``meta`` to ``path`` atomically: a
    sibling ``.tmp`` file, fsynced, then renamed over ``path``, so a kill
    at any point leaves the old complete file or the new one.  A tree of
    DTensors (a model on a device mesh) is gathered, every rank taking
    part, and rank 0 alone writes the file, the same bytes as the tree
    on one device."""
    flat = _flatten_with_paths(tree)
    if any(is_dtensor(v) for v in flat.values()):
        import torch.distributed as dist
        flat = {k: v.full_tensor() if is_dtensor(v) else v
                for k, v in flat.items()}
        if dist.get_rank() != 0:
            return
    payload = {
        "__version__": FORMAT_VERSION,
        "__meta__": meta or {},
        "leaves": {k: _leaf_record(v) for k, v in flat.items()},
    }
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(_msgpack.packb(payload))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _leaf(rec: dict) -> Tensor:
    if rec["dtype"] not in _DTYPES:
        raise ValueError(f"unsupported leaf dtype {rec['dtype']!r}")
    dtype = _DTYPES[rec["dtype"]]
    shape = [int(n) for n in rec["shape"]]
    data = rec["data"]
    width = torch.empty((), dtype=dtype).element_size()
    if len(data) != width * int(np.prod(shape, dtype=np.int64)):
        raise ValueError(f"{len(data)} bytes for a {rec['dtype']} leaf of "
                         f"shape {shape}")
    if not data:
        return torch.empty(shape, dtype=dtype)
    raw = torch.int16 if dtype == torch.bfloat16 else dtype
    return torch.frombuffer(bytearray(data), dtype=raw).view(dtype) \
        .reshape(shape)


def load_flat(path: str) -> tuple[Dict[str, Tensor], dict]:
    """``(leaves by path as CPU tensors, meta)`` of a checkpoint file."""
    with open(path, "rb") as f:
        raw = f.read()
    try:
        payload = _msgpack.unpackb(raw)
        if not isinstance(payload, dict) or "leaves" not in payload:
            raise ValueError("not a checkpoint container")
        version = payload.get("__version__", 0)   # pre-header files: 0
        leaves = None
        if version <= FORMAT_VERSION:
            leaves = {k: _leaf(v) for k, v in payload["leaves"].items()}
    except (ValueError, TypeError, KeyError, AttributeError,
            RecursionError) as e:
        raise ValueError(
            f"{path}: corrupt or truncated checkpoint "
            f"({type(e).__name__}: {e}); the atomic writer never "
            f"produces this — the file was damaged after the fact") from e
    if leaves is None:
        raise ValueError(
            f"{path}: checkpoint format version {version} is newer than "
            f"this reader ({FORMAT_VERSION})")
    return leaves, payload.get("__meta__", {})


def restore(path: str, like: Any, device: DeviceLike = None) -> Any:
    """The checkpoint in the structure of ``like`` (a nested dict of
    tensors or arrays, whose shapes each leaf must have), every leaf on
    ``resolve_device(device)``: the card unless the caller asks for the
    CPU."""
    dev = resolve_device(device)
    flat, _ = load_flat(path)

    def walk(prefix: str, node):
        if isinstance(node, dict):
            return {k: walk(f"{prefix}/{k}" if prefix else str(k), node[k])
                    for k in sorted(node)}
        t = flat[prefix]
        want = tuple(node.shape)
        if tuple(t.shape) != want:
            raise ValueError(f"{prefix}: shape {tuple(t.shape)} != {want}")
        return t.to(dev)

    return walk("", like)


__all__ = ["FORMAT_VERSION", "save", "load_flat", "restore"]

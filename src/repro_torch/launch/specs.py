"""Shape, dtype and placement of every model input (dry run, no storage).

Port of ``repro.launch.specs``.  ``input_specs(cfg, shape, mesh)`` gives
the tree the step functions consume, each leaf an :class:`ArgSpec` (a
shape, a dtype and its PartitionSpec on ``mesh``):

* train:   {"inputs", "labels" (+"positions" for M-RoPE,
            +"encoder_inputs" for enc-dec)}
* prefill: {"inputs" (+extras as above)}
* decode:  {"tokens", "index", "cache"}

Batch dims shard over (pod, data) when divisible (long_500k's batch of
1 stays replicated); token and embedding feature dims replicate; decode
caches shard batch over (pod, data) and KV heads over model when they
divide it, else the head dim, else nothing.  Token ids are int32 and the
decode position an int32 scalar, as the reference's inputs (the port's
decode step takes the position as a host int; it is counted here as the
reference's argument).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.shapes import InputShape
from repro_torch.launch.mesh import Mesh
from repro_torch.models import common, transformer
from repro_torch.models.config import ModelConfig
from repro_torch.sharding import rules
from repro_torch.sharding.rules import P, PartitionSpec

Params = Any


@dataclasses.dataclass(frozen=True)
class ArgSpec:
    """One input leaf: its global shape and dtype, and its placement."""

    shape: Tuple[int, ...]
    dtype: torch.dtype
    spec: PartitionSpec

    def meta(self) -> torch.Tensor:
        """A shape-only tensor standing for the leaf."""
        return torch.empty(self.shape, dtype=self.dtype, device="meta")

    def shard_shape(self, mesh: Mesh) -> Tuple[int, ...]:
        return rules.shard_shape(self.shape, self.spec, mesh)

    def shard_bytes(self, mesh: Mesh) -> int:
        """The bytes one device holds of the leaf."""
        return math.prod(self.shard_shape(mesh)) * self.dtype.itemsize


def _batch_spec(batch: int, mesh: Mesh, extra_dims: int) -> PartitionSpec:
    axes = rules.resolve("batch", mesh)
    size = rules.entry_size(axes, mesh)
    lead = axes if (axes and batch % size == 0 and batch >= size) else None
    return P(lead, *([None] * extra_dims))


def token_specs(cfg: ModelConfig, batch: int, seq: int,
                mesh: Mesh) -> Dict[str, ArgSpec]:
    """Training / prefill inputs."""
    bf16, i32 = torch.bfloat16, torch.int32
    out: Dict[str, ArgSpec] = {}
    if cfg.input_mode == "embeddings" and not cfg.is_encdec:
        out["inputs"] = ArgSpec((batch, seq, cfg.d_model), bf16,
                                _batch_spec(batch, mesh, 2))
    else:
        out["inputs"] = ArgSpec((batch, seq), i32,
                                _batch_spec(batch, mesh, 1))
    out["labels"] = ArgSpec((batch, seq), i32, _batch_spec(batch, mesh, 1))
    if cfg.mrope_sections:
        out["positions"] = ArgSpec((3, batch, seq), i32,
                                   P(None, *_batch_spec(batch, mesh, 1)))
    if cfg.is_encdec:
        # Audio stub: precomputed frame embeddings, same sequence length.
        out["encoder_inputs"] = ArgSpec((batch, seq, cfg.d_model), bf16,
                                        _batch_spec(batch, mesh, 2))
    return out


def cache_specs(cfg: ModelConfig, batch: int, max_len: int, mesh: Mesh,
                enc_len: int = 0) -> Params:
    """The leaves of ``transformer.init_cache`` with their placements.
    (The port's cache keeps a sliding-window layer's whole ring where the
    reference trims it to ``max_len``; every assigned shape is longer
    than every window, so the two agree there.)"""
    dtype = common.dtype_of(cfg.dtype_compute)
    shapes = transformer.init_cache(cfg, batch, max_len, dtype, "meta",
                                    enc_len or None)
    b_axis = _batch_spec(batch, mesh, 0)[0]
    tensor = rules.resolve("tensor", mesh)
    tp = rules.entry_size(tensor, mesh)

    def _div(dim: int) -> bool:
        # Input placements must divide exactly (no padding).
        return tp > 1 and dim % tp == 0

    def leaf_spec(path: str, shape: Tuple[int, ...]) -> PartitionSpec:
        nd = len(shape)
        name = path.rsplit("/", 1)[-1]
        # (G, B, S, KV, hd) attention k / v: KV heads over `model` when
        # divisible, else the head dim, else replicate.
        if name in ("k", "v", "cross_k", "cross_v") and nd == 5:
            if _div(shape[3]):
                return P(None, b_axis, None, tensor, None)
            if _div(shape[4]):
                return P(None, b_axis, None, None, tensor)
            return P(None, b_axis, None, None, None)
        if name == "h" and nd == 5:          # mamba (G, B, nh, n, p)
            return P(None, b_axis, tensor if _div(shape[2]) else None,
                     None, None)
        if name == "conv" and nd == 4:       # (G, B, K, din)
            return P(None, b_axis, None,
                     tensor if _div(shape[3]) else None)
        if nd >= 2:
            return P(None, b_axis, *([None] * (nd - 2)))
        return P(None)

    def walk(path, node):
        if isinstance(node, dict):
            return {k: walk(f"{path}/{k}", v) for k, v in node.items()}
        shape = tuple(node.shape)
        return ArgSpec(shape, node.dtype, leaf_spec(path, shape))

    return walk("", shapes)


def decode_specs(cfg: ModelConfig, shape: InputShape,
                 mesh: Mesh) -> Dict[str, Any]:
    batch = shape.global_batch
    enc_len = shape.seq_len if cfg.is_encdec else 0
    return {
        "tokens": ArgSpec((batch, 1), torch.int32,
                          _batch_spec(batch, mesh, 1)),
        "index": ArgSpec((), torch.int32, P()),
        "cache": cache_specs(cfg, batch, shape.seq_len, mesh, enc_len),
    }


def input_specs(cfg: ModelConfig, shape: InputShape,
                mesh: Mesh) -> Dict[str, Any]:
    if shape.kind in ("train", "prefill"):
        return token_specs(cfg, shape.global_batch, shape.seq_len, mesh)
    return decode_specs(cfg, shape, mesh)

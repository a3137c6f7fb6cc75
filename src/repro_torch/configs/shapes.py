"""Assigned input shapes and per-(arch x shape) applicability.

  train_4k     seq=  4,096  global_batch=256  -> train_step
  prefill_32k  seq= 32,768  global_batch= 32  -> prefill_step
  decode_32k   seq= 32,768  global_batch=128  -> serve_step (1 new token,
                                                cache of seq_len)
  long_500k    seq=524,288  global_batch=  1  -> serve_step; requires
                                                sub-quadratic attention

``long_500k`` runs only for architectures with recurrent state or a
sliding window (xlstm, jamba, h2o-danube, mixtral); pure full-attention
archs skip it (DESIGN.md §4).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                   # train | prefill | decode


SHAPES: Tuple[InputShape, ...] = (
    InputShape("train_4k", 4_096, 256, "train"),
    InputShape("prefill_32k", 32_768, 32, "prefill"),
    InputShape("decode_32k", 32_768, 128, "decode"),
    InputShape("long_500k", 524_288, 1, "decode"),
)


def get_shape(name: str) -> InputShape:
    for s in SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)


def applicable(cfg: ModelConfig, shape: InputShape) -> Tuple[bool, str]:
    """Whether (arch, shape) is in the assigned matrix; reason if not."""
    if shape.name == "long_500k" and not cfg.supports_long_context():
        return False, ("full quadratic attention — long-context decode "
                       "skipped per DESIGN.md §4")
    return True, ""

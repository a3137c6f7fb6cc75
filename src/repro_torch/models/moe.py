"""Feed-forward layers: the dense MLP (SwiGLU / GELU).

Port of the dense part of ``repro.models.moe`` (``mlp_init``,
``mlp_apply``).  The top-k router and the expert dispatch are not ported
yet (ROADMAP item 17b).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import common
from repro_torch.models.config import ModelConfig

Params = Dict[str, torch.Tensor]


def mlp_init(gen: torch.Generator, cfg: ModelConfig,
             groups: Tuple[int, ...] = ()) -> Params:
    d, f = cfg.d_model, cfg.d_ff
    dt = common.dtype_of(cfg.dtype_params)
    p = {"wi": common.dense_init(gen, groups + (d, f), d, dt)}
    if cfg.mlp_activation == "swiglu":
        p["wg"] = common.dense_init(gen, groups + (d, f), d, dt)
    p["wo"] = common.dense_init(gen, groups + (f, d), f, dt)
    if cfg.use_bias:
        p["bi"] = common.filled(groups + (f,), 0.0, dt)
        p["bo"] = common.filled(groups + (d,), 0.0, dt)
    return p


def mlp_apply(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    dt = x.dtype
    h = x @ p["wi"].to(dt)
    if cfg.use_bias:
        h = h + p["bi"].to(dt)
    if cfg.mlp_activation == "swiglu":
        h = F.silu(h) * (x @ p["wg"].to(dt))
    else:
        h = F.gelu(h, approximate="tanh")   # jax.nn.gelu's default
    out = h @ p["wo"].to(dt)
    if cfg.use_bias:
        out = out + p["bo"].to(dt)
    return out

"""Tree optimizers: SGD (+momentum) and AdamW, built from scratch.

Port of ``repro.optim.optimizers``, over nested dicts of tensors
(:mod:`repro_torch.tree`).  AdamW's moment dtype is configurable
(``state_dtype``: f32 or bf16); the update computes in f32 and stores
each leaf back in its own dtype, as the reference does.

The step count is an int32 tensor on the parameters' device, and the
learning rate, the global norm and the clip scale are computed there
from it: an optimizer step reads nothing back to the host.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Tuple

import torch

from repro_torch.tree import tree_leaves, tree_map

Params = Any
Tensor = torch.Tensor
F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"            # adamw | sgd
    learning_rate: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    momentum: float = 0.9          # sgd
    grad_clip: float = 1.0         # global-norm clip; 0 disables
    state_dtype: str = "float32"   # float32 | bfloat16
    warmup_steps: int = 100
    schedule: str = "constant"     # constant | cosine
    total_steps: int = 10_000


def _sdtype(cfg: OptimizerConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.state_dtype == "bfloat16" else F32


def init_state(params: Params, cfg: OptimizerConfig) -> dict:
    """Zero moments shaped like ``params`` and a zero int32 step count,
    on the parameters' device."""
    device = tree_leaves(params)[0].device
    count = torch.zeros((), dtype=torch.int32, device=device)

    def zeros():
        return tree_map(lambda p: torch.zeros(p.shape, dtype=_sdtype(cfg),
                                              device=p.device), params)

    if cfg.name == "sgd":
        if cfg.momentum > 0.0:
            return {"mu": zeros(), "count": count}
        return {"count": count}
    return {"mu": zeros(), "nu": zeros(), "count": count}


def global_norm(tree: Params) -> Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(F32)))
                          for x in tree_leaves(tree)))


def _lr_at(cfg: OptimizerConfig, step: Tensor) -> Tensor:
    """The learning rate at ``step`` (an int32 device tensor), computed
    on its device."""
    lr = torch.full((), cfg.learning_rate, dtype=F32, device=step.device)
    if cfg.warmup_steps > 0:
        lr = lr * torch.clamp_max((step + 1) / cfg.warmup_steps, 1.0)
    if cfg.schedule == "cosine":
        frac = torch.clamp((step - cfg.warmup_steps)
                           / max(cfg.total_steps - cfg.warmup_steps, 1),
                           0.0, 1.0)
        lr = lr * 0.5 * (1.0 + torch.cos(math.pi * frac))
    return lr


def apply_updates(params: Params, grads: Params, state: dict,
                  cfg: OptimizerConfig) -> Tuple[Params, dict, dict]:
    """One optimizer step.  Returns (params, state, metrics), every
    metric a device tensor."""
    step = state["count"]
    gnorm = global_norm(grads)
    if cfg.grad_clip > 0.0:
        scale = torch.clamp_max(
            cfg.grad_clip / torch.clamp_min(gnorm, 1e-9), 1.0)
        grads = tree_map(lambda g: (g.to(F32) * scale).to(g.dtype), grads)
    lr = _lr_at(cfg, step)
    metrics = {"grad_norm": gnorm, "lr": lr}

    if cfg.name == "sgd":
        if cfg.momentum > 0.0:
            mu = tree_map(lambda m, g: (cfg.momentum * m.to(F32)
                                        + g.to(F32)).to(m.dtype),
                          state["mu"], grads)
            params = tree_map(lambda p, m: (p.to(F32) - lr * m.to(F32)
                                            ).to(p.dtype), params, mu)
            return params, {"mu": mu, "count": step + 1}, metrics
        params = tree_map(lambda p, g: (p.to(F32) - lr * g.to(F32)
                                        ).to(p.dtype), params, grads)
        return params, {"count": step + 1}, metrics

    # AdamW
    b1, b2 = cfg.beta1, cfg.beta2
    t = (step + 1).to(F32)
    bc1 = 1.0 - torch.pow(b1, t)
    bc2 = 1.0 - torch.pow(b2, t)

    def upd(p, g, m, v):
        gf = g.to(F32)
        mf = b1 * m.to(F32) + (1 - b1) * gf
        vf = b2 * v.to(F32) + (1 - b2) * gf * gf
        mhat = mf / bc1
        vhat = vf / bc2
        pf = p.to(F32)
        pf = pf - lr * (mhat / (torch.sqrt(vhat) + cfg.eps)
                        + cfg.weight_decay * pf)
        return pf.to(p.dtype), mf.to(m.dtype), vf.to(v.dtype)

    out = tree_map(upd, params, grads, state["mu"], state["nu"])
    new_p, new_m, new_v = (tree_map(lambda o, i=i: o[i], out)
                           for i in range(3))
    return new_p, {"mu": new_m, "nu": new_v, "count": step + 1}, metrics

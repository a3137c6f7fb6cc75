"""Label histogram -> diversity measures: (K, N) -> (K, 3).

Replaces the TPU kernel ``diversity_kernel`` of
``src/repro/kernels/diversity.py``.  CUDA source: ``csrc/diversity.cu``
— one 128-thread block per client reads its row in one round of loads
(16-byte vectors where :func:`route` allows), each thread counts its own
labels class by class into a private column of shared memory (no
atomics: label-sorted rows would pile every add onto one or two
addresses), the columns are summed in a fixed order, then Gini-Simpson,
Shannon (log2, ``0 log 0 := 0``) and the count.  Bound on the H100 by
bytes: the (K, N) labels and mask are read once; in practice by launch
latency.  The wrapper counts its launches in ``launches`` and by route
in ``route_launches``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, _check

MAX_CLASSES = 64
# Labels a load, by route (``diversity_route`` of the C source returns
# the same).
ROUTE_VEC = {"vec4": 4, "scalar": 1}


def route(n: int, *addresses: int) -> str:
    """``vec4`` where rows of ``n`` labels at these addresses (the labels'
    and the mask's) take 16-byte loads: ``n`` a multiple of 4 and each
    operand's first row 16-byte aligned (then every row is); else
    ``scalar``."""
    if n % 4 == 0 and all(a % 16 == 0 for a in addresses):
        return "vec4"
    return "scalar"


def diversity_stats_plain(labels: torch.Tensor, mask: torch.Tensor,
                          num_classes: int) -> torch.Tensor:
    """Plain version (port of ``kernels/ref.py::diversity``)."""
    classes = torch.arange(num_classes, device=labels.device)
    onehot = (labels[..., None] == classes).to(torch.float32)
    hist = torch.sum(onehot * mask.to(torch.float32)[..., None], dim=1)
    total = torch.sum(hist, dim=-1)
    p = hist / torch.clamp_min(total, 1.0)[..., None]
    gini = 1.0 - torch.sum(p * p, dim=-1)
    logp = torch.where(p > 0.0, torch.log2(torch.clamp_min(p, 1e-30)),
                       torch.zeros_like(p))
    shannon = -torch.sum(p * logp, dim=-1)
    return torch.stack([gini, shannon, total], dim=-1)


def diversity_stats(labels: torch.Tensor, mask: torch.Tensor,
                    num_classes: int) -> torch.Tensor:
    """(K, N) labels/mask -> (K, 3) [gini-simpson, shannon, count].

    CPU tensors take :func:`diversity_stats_plain`; CUDA tensors launch
    the kernel (int32 labels, f32 mask, C <= 64) or raise.
    """
    _check.local_only("diversity_stats", labels, mask)
    if labels.device.type == "cpu":
        return diversity_stats_plain(labels, mask, num_classes)
    if not 1 <= num_classes <= MAX_CLASSES:
        raise ValueError(f"num_classes must be in [1, {MAX_CLASSES}], "
                         f"got {num_classes}")
    k, n = labels.shape
    dev = labels.device
    _check.cuda_operand("labels", labels, torch.int32, (k, n), dev)
    _check.cuda_operand("mask", mask, torch.float32, (k, n), dev)
    which = route(n, labels.data_ptr(), mask.data_ptr())
    out = torch.empty((k, 3), dtype=torch.float32, device=dev)
    code = _build.library().diversity_stats(
        labels.data_ptr(), mask.data_ptr(), out.data_ptr(), k, n,
        num_classes, _check.stream_handle(dev))
    _build.check(code, "diversity")
    diversity_stats.launches += 1
    diversity_stats.route_launches[which] += 1
    return out


diversity_stats.launches = 0
diversity_stats.route_launches = dict.fromkeys(ROUTE_VEC, 0)

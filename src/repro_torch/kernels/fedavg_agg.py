"""FedAvg weighted aggregation (Alg. 1 line 12): (K, P) x (K,) -> (P,),
or S scenarios at once: (S, K, P) x (S, K) -> (S, P).

Replaces the TPU kernels ``fedavg_agg_kernel``,
``fedavg_agg_masked_kernel`` and ``fedavg_agg_stale_kernel`` of
``src/repro/kernels/fedavg_agg.py``.
CUDA source: ``csrc/fedavg_agg.cu`` — a split-K streaming reduction:
each block splits the K rows over 16 row groups, each thread keeps 8
rows' loads of its columns in flight, and the groups' partial sums meet
in shared memory in one fixed order (no atomics, and the same order on
every route, so a launch's bits depend on the inputs alone).  Bound on
the H100 by bytes: the (K, P) f32 matrix is read once at HBM rate.  The
masked form folds the upload-success mask into the weights and shares
the unmasked kernel's reduction, so an all-ones mask is bitwise
:func:`fedavg_agg`; the stale form folds the staleness multiplier in
after the mask, so an all-ones multiplier is bitwise
:func:`fedavg_agg_masked`.  A batch of S scenarios is one launch with
the scenario on the grid's second axis; each scenario's block runs the
single problem's reduction on its own rows, so scenario s of a batched
launch is bit for bit a launch on its rows alone.

:func:`route` picks the width of each load (``vec4``, ``vec2`` or
``scalar``) from P and the matrix's address alone; each wrapper counts
its launches in ``launches`` and by route in ``route_launches``.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build, _check

# Floats per load of each route.
ROUTE_VEC = {"vec4": 4, "vec2": 2, "scalar": 1}


def route(p: int, address: int, stride: int = 0) -> str:
    """The widest load every row of a contiguous ``(K, p)`` f32 matrix at
    ``address`` allows: ``p`` a multiple of the width and the first row
    aligned to it (then every row is).  ``stride`` is the scenario
    stride ``K * p`` of an ``(S, K, p)`` batch, which must keep every
    scenario's first row aligned too (it does whenever ``p`` is a
    multiple of the width).  K does not enter otherwise."""
    for name, vec in ROUTE_VEC.items():
        if p % vec == 0 and stride % vec == 0 and address % (4 * vec) == 0:
            return name
    raise AssertionError("an f32 pointer is 4-byte aligned")


def _launch(wrapper, entry: str, updates: torch.Tensor,
            rows: tuple) -> torch.Tensor:
    """Check the operands, launch ``entry`` with the route of
    ``updates`` and count it on ``wrapper``.  ``rows`` are the (K,) or
    (S, K) operands in the C entry's order."""
    lead, (k, p) = updates.shape[:-2], updates.shape[-2:]
    dev = updates.device
    _check.cuda_operand("updates", updates, torch.float32, lead + (k, p),
                        dev)
    for name, t in rows:
        _check.cuda_operand(name, t, torch.float32, lead + (k,), dev)
    # One problem is a batch of one: the same pointers, no views.
    out = torch.empty(lead + (p,), dtype=torch.float32, device=dev)
    which = route(p, updates.data_ptr(), k * p)
    code = getattr(_build.library(), entry)(
        updates.data_ptr(), *(t.data_ptr() for _, t in rows),
        out.data_ptr(), math.prod(lead), k, p, ROUTE_VEC[which],
        _check.stream_handle(dev))
    _build.check(code, wrapper.__name__)
    wrapper.launches += 1
    wrapper.route_launches[which] += 1
    return out


def _reduce(updates: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``sum_k w[..., k] * updates[..., k, p]`` in f32, per scenario: a
    product and a sum over the K axis, which adds the rows in order
    whatever the leading axes, so each scenario of a batch is its single
    reduction bit for bit (a batched matrix product is not)."""
    out = torch.sum(w[..., None] * updates.to(torch.float32), dim=-2)
    return out.to(updates.dtype)


def fedavg_agg_plain(updates: torch.Tensor,
                     weights: torch.Tensor) -> torch.Tensor:
    """Plain version (port of ``kernels/ref.py::fedavg_agg``), per
    scenario of a batch."""
    return _reduce(updates, weights.to(torch.float32))


def fedavg_agg(updates: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """``out[p] = sum_k weights[k] * updates[k, p]`` in f32; with (S, K,
    P) updates and (S, K) weights, the same per scenario -> (S, P).

    CPU tensors take :func:`fedavg_agg_plain`; CUDA tensors launch the
    kernel once (f32, contiguous) or raise.
    """
    _check.local_only("fedavg_agg", updates, weights)
    if updates.device.type == "cpu":
        return fedavg_agg_plain(updates, weights)
    return _launch(fedavg_agg, "fedavg_agg_f32", updates,
                   (("weights", weights),))


fedavg_agg.launches = 0
fedavg_agg.route_launches = dict.fromkeys(ROUTE_VEC, 0)


def fedavg_agg_masked_plain(updates: torch.Tensor, weights: torch.Tensor,
                            mask: torch.Tensor) -> torch.Tensor:
    """Plain version (port of ``kernels/ref.py::fedavg_agg_masked``): the
    mask multiplies the weights before the reduction, nothing
    renormalises."""
    return _reduce(updates,
                   weights.to(torch.float32) * mask.to(torch.float32))


def fedavg_agg_masked(updates: torch.Tensor, weights: torch.Tensor,
                      mask: torch.Tensor) -> torch.Tensor:
    """``out[p] = sum_k (weights[k] * mask[k]) * updates[k, p]`` in f32,
    per scenario of an (S, K, P) batch.

    CPU tensors take :func:`fedavg_agg_masked_plain`; CUDA tensors launch
    the kernel (f32, contiguous) or raise.
    """
    _check.local_only("fedavg_agg_masked", updates, weights, mask)
    if updates.device.type == "cpu":
        return fedavg_agg_masked_plain(updates, weights, mask)
    return _launch(fedavg_agg_masked, "fedavg_agg_masked_f32", updates,
                   (("weights", weights), ("mask", mask)))


fedavg_agg_masked.launches = 0
fedavg_agg_masked.route_launches = dict.fromkeys(ROUTE_VEC, 0)


def fedavg_agg_stale_plain(updates: torch.Tensor, weights: torch.Tensor,
                           mask: torch.Tensor,
                           stale: torch.Tensor) -> torch.Tensor:
    """Plain version (port of ``kernels/ref.py::fedavg_agg_stale``): mask
    and staleness multiplier fold into the weights, ``(w * m) * s``,
    before the reduction; nothing renormalises."""
    return _reduce(updates, weights.to(torch.float32)
                   * mask.to(torch.float32) * stale.to(torch.float32))


def fedavg_agg_stale(updates: torch.Tensor, weights: torch.Tensor,
                     mask: torch.Tensor, stale: torch.Tensor) -> torch.Tensor:
    """``out[p] = sum_k ((weights[k] * mask[k]) * stale[k]) * updates[k, p]``
    in f32, per scenario of an (S, K, P) batch: the event driver's
    buffered flush.

    CPU tensors take :func:`fedavg_agg_stale_plain`; CUDA tensors launch
    the kernel (f32, contiguous) or raise.
    """
    _check.local_only("fedavg_agg_stale", updates, weights, mask, stale)
    if updates.device.type == "cpu":
        return fedavg_agg_stale_plain(updates, weights, mask, stale)
    return _launch(fedavg_agg_stale, "fedavg_agg_stale_f32", updates,
                   (("weights", weights), ("mask", mask), ("stale", stale)))


fedavg_agg_stale.launches = 0
fedavg_agg_stale.route_launches = dict.fromkeys(ROUTE_VEC, 0)

"""FedAvg weighted aggregation (Alg. 1 line 12): (K, P) x (K,) -> (P,).

Replaces the TPU kernels ``fedavg_agg_kernel``,
``fedavg_agg_masked_kernel`` and ``fedavg_agg_stale_kernel`` of
``src/repro/kernels/fedavg_agg.py``.
CUDA source: ``csrc/fedavg_agg.cu`` — one thread per coordinate p, a
loop over the K clients in order, f32 accumulation, the ragged tail
masked.  Bound on the H100 by bytes: the (K, P) f32 matrix is read once
at HBM rate.  The masked form folds the upload-success mask into the
weights and shares the unmasked kernel's loop, so an all-ones mask is
bitwise :func:`fedavg_agg`; the stale form folds the staleness
multiplier in after the mask, so an all-ones multiplier is bitwise
:func:`fedavg_agg_masked`.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, _check


def fedavg_agg_plain(updates: torch.Tensor,
                     weights: torch.Tensor) -> torch.Tensor:
    """Plain version (port of ``kernels/ref.py::fedavg_agg``)."""
    out = torch.einsum("kp,k->p", updates.to(torch.float32),
                       weights.to(torch.float32))
    return out.to(updates.dtype)


def fedavg_agg(updates: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """``out[p] = sum_k weights[k] * updates[k, p]`` in f32.

    CPU tensors take :func:`fedavg_agg_plain`; CUDA tensors launch the
    kernel (f32, contiguous) or raise.
    """
    if updates.device.type == "cpu":
        return fedavg_agg_plain(updates, weights)
    k, p = updates.shape
    dev = updates.device
    _check.cuda_operand("updates", updates, torch.float32, (k, p), dev)
    _check.cuda_operand("weights", weights, torch.float32, (k,), dev)
    out = torch.empty((p,), dtype=torch.float32, device=dev)
    code = _build.library().fedavg_agg_f32(
        updates.data_ptr(), weights.data_ptr(), out.data_ptr(), k, p,
        _check.stream_handle(dev))
    _build.check(code, "fedavg_agg")
    fedavg_agg.launches += 1
    return out


fedavg_agg.launches = 0


def fedavg_agg_masked_plain(updates: torch.Tensor, weights: torch.Tensor,
                            mask: torch.Tensor) -> torch.Tensor:
    """Plain version (port of ``kernels/ref.py::fedavg_agg_masked``): the
    mask multiplies the weights before the reduction, nothing
    renormalises."""
    w = weights.to(torch.float32) * mask.to(torch.float32)
    out = torch.einsum("kp,k->p", updates.to(torch.float32), w)
    return out.to(updates.dtype)


def fedavg_agg_masked(updates: torch.Tensor, weights: torch.Tensor,
                      mask: torch.Tensor) -> torch.Tensor:
    """``out[p] = sum_k (weights[k] * mask[k]) * updates[k, p]`` in f32.

    CPU tensors take :func:`fedavg_agg_masked_plain`; CUDA tensors launch
    the kernel (f32, contiguous) or raise.
    """
    if updates.device.type == "cpu":
        return fedavg_agg_masked_plain(updates, weights, mask)
    k, p = updates.shape
    dev = updates.device
    _check.cuda_operand("updates", updates, torch.float32, (k, p), dev)
    _check.cuda_operand("weights", weights, torch.float32, (k,), dev)
    _check.cuda_operand("mask", mask, torch.float32, (k,), dev)
    out = torch.empty((p,), dtype=torch.float32, device=dev)
    code = _build.library().fedavg_agg_masked_f32(
        updates.data_ptr(), weights.data_ptr(), mask.data_ptr(),
        out.data_ptr(), k, p, _check.stream_handle(dev))
    _build.check(code, "fedavg_agg_masked")
    fedavg_agg_masked.launches += 1
    return out


fedavg_agg_masked.launches = 0


def fedavg_agg_stale_plain(updates: torch.Tensor, weights: torch.Tensor,
                           mask: torch.Tensor,
                           stale: torch.Tensor) -> torch.Tensor:
    """Plain version (port of ``kernels/ref.py::fedavg_agg_stale``): mask
    and staleness multiplier fold into the weights, ``(w * m) * s``,
    before the reduction; nothing renormalises."""
    w = weights.to(torch.float32) * mask.to(torch.float32) \
        * stale.to(torch.float32)
    out = torch.einsum("kp,k->p", updates.to(torch.float32), w)
    return out.to(updates.dtype)


def fedavg_agg_stale(updates: torch.Tensor, weights: torch.Tensor,
                     mask: torch.Tensor, stale: torch.Tensor) -> torch.Tensor:
    """``out[p] = sum_k ((weights[k] * mask[k]) * stale[k]) * updates[k, p]``
    in f32: the event driver's buffered flush.

    CPU tensors take :func:`fedavg_agg_stale_plain`; CUDA tensors launch
    the kernel (f32, contiguous) or raise.
    """
    if updates.device.type == "cpu":
        return fedavg_agg_stale_plain(updates, weights, mask, stale)
    k, p = updates.shape
    dev = updates.device
    _check.cuda_operand("updates", updates, torch.float32, (k, p), dev)
    _check.cuda_operand("weights", weights, torch.float32, (k,), dev)
    _check.cuda_operand("mask", mask, torch.float32, (k,), dev)
    _check.cuda_operand("stale", stale, torch.float32, (k,), dev)
    out = torch.empty((p,), dtype=torch.float32, device=dev)
    code = _build.library().fedavg_agg_stale_f32(
        updates.data_ptr(), weights.data_ptr(), mask.data_ptr(),
        stale.data_ptr(), out.data_ptr(), k, p, _check.stream_handle(dev))
    _build.check(code, "fedavg_agg_stale")
    fedavg_agg_stale.launches += 1
    return out


fedavg_agg_stale.launches = 0

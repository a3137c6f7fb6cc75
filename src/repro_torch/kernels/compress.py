"""Fused uplink compression with error feedback: (…, K, P) rows.

Replaces the TPU kernel ``compress_update_kernel`` of
``src/repro/kernels/compress.py``.  CUDA source: ``csrc/compress.cu`` —
one block per (scenario, device) row, walking P in strides with the row
max and the top-k threshold carried across them (the P-blocked variant
the TPU kernel's docstring asks for).  Bound on the H100 by bytes.

Contract (``kernels/ref.py::compress_update``): ``v = u + r``; then
``mode="quant"`` — stochastic ``widths``-bit quantization of each row
scaled by its max, rounded with the caller's uniform ``noise`` — or
``mode="topk"`` — the ``keep`` largest magnitudes by a ``thresh_iters``
trip threshold bisection; decode; ``r' = selected ? v - c : r``.
Returns ``(c, r')``.  ``topk`` never reads ``noise``: a ``(…, K)``
placeholder row does.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, _check

MODES = ("quant", "topk")
DEFAULT_THRESH_ITERS = 32


def compress_update_plain(updates: torch.Tensor, residual: torch.Tensor,
                          widths: torch.Tensor, selected: torch.Tensor,
                          noise: torch.Tensor, *, mode: str, keep: int = 0,
                          thresh_iters: int = DEFAULT_THRESH_ITERS
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version (port of ``kernels/ref.py::compress_update``)."""
    f32 = torch.float32
    v = updates.to(f32) + residual.to(f32)
    av = torch.abs(v)
    if mode == "quant":
        m = torch.amax(av, dim=-1, keepdim=True)
        levels = torch.clamp_min(torch.exp2(widths.to(f32)[..., None]) - 1.0,
                                 1.0)
        scaled = av / torch.clamp_min(m, 1e-12) * levels
        fl = torch.floor(scaled)
        q = fl + (noise < (scaled - fl)).to(f32)
        c = torch.sign(v) * q / levels * m
    elif mode == "topk":
        lo = torch.zeros(av.shape[:-1] + (1,), dtype=f32, device=av.device)
        hi = torch.amax(av, dim=-1, keepdim=True)
        for _ in range(thresh_iters):
            mid = 0.5 * (lo + hi)
            cnt = torch.sum((av >= mid).to(f32), dim=-1, keepdim=True)
            over = cnt > keep
            lo, hi = torch.where(over, mid, lo), torch.where(over, hi, mid)
        c = torch.where(av >= hi, v, torch.zeros_like(v))
    else:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    new_r = torch.where(selected[..., None] > 0.0, v - c, residual.to(f32))
    return c, new_r


def compress_update(updates: torch.Tensor, residual: torch.Tensor,
                    widths: torch.Tensor, selected: torch.Tensor,
                    noise: torch.Tensor, *, mode: str, keep: int = 0,
                    thresh_iters: int = DEFAULT_THRESH_ITERS
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """One round's lossy uplink: ``(K, P)`` rows with ``(K,)`` widths and
    selection, or a batch ``(S, K, P)`` / ``(S, K)``.

    CPU tensors take :func:`compress_update_plain`; CUDA tensors launch
    the kernel (f32, contiguous) or raise.
    """
    kw = dict(mode=mode, keep=keep, thresh_iters=thresh_iters)
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if updates.device.type == "cpu":
        return compress_update_plain(updates, residual, widths, selected,
                                     noise, **kw)
    batched = updates.dim() == 3
    if not batched:
        updates, residual, widths, selected, noise = (
            x[None] for x in (updates, residual, widths, selected, noise))
    s, k, p = updates.shape
    dev = updates.device
    f32 = torch.float32
    for name, t in (("updates", updates), ("residual", residual)):
        _check.cuda_operand(name, t, f32, (s, k, p), dev)
    for name, t in (("widths", widths), ("selected", selected)):
        _check.cuda_operand(name, t, f32, (s, k), dev)
    noise_shapes = ((s, k, p),) if mode == "quant" else ((s, k, p), (s, k))
    if tuple(noise.shape) not in noise_shapes:
        raise ValueError(f"{mode} noise must be one of {noise_shapes}, got "
                         f"{tuple(noise.shape)}")
    _check.cuda_operand("noise", noise, f32, tuple(noise.shape), dev)
    if mode == "topk" and not 0 < keep <= p:
        raise ValueError(f"topk keep must be in (0, {p}], got {keep}")
    c = torch.empty((s, k, p), dtype=f32, device=dev)
    r_new = torch.empty((s, k, p), dtype=f32, device=dev)
    code = _build.library().compress_update_f32(
        updates.data_ptr(), residual.data_ptr(), widths.data_ptr(),
        selected.data_ptr(), noise.data_ptr(), c.data_ptr(),
        r_new.data_ptr(), s * k, p, MODES.index(mode), keep, thresh_iters,
        _check.stream_handle(dev))
    _build.check(code, "compress_update")
    compress_update.launches += 1
    if not batched:
        return c[0], r_new[0]
    return c, r_new


compress_update.launches = 0

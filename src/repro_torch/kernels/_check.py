"""Argument checks shared by the kernel wrappers, and the check of a
bf16 result against its f32 answer."""

from __future__ import annotations

import torch


def cuda_operand(name: str, t: torch.Tensor, dtype: torch.dtype,
                 shape: tuple, device: torch.device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape``
    on ``device`` (the kernel reads it through a raw pointer)."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def stream_handle(device: torch.device) -> int:
    """PyTorch's current CUDA stream on ``device``, as a raw handle."""
    return torch.cuda.current_stream(device).cuda_stream


def bf16_rounding_ratio(got: torch.Tensor, want: torch.Tensor,
                        slack: float) -> float:
    """Largest ``|got - want| / (half a bf16 ulp of want + slack)``.

    ``got`` is a bf16 result and ``want`` the f32 answer on the same
    input values.  A result rounded to nearest from an f32 value within
    ``slack`` of ``want`` reads at most 1; one that truncates, or that
    rounds an intermediate to bf16, reads up to about 2 where the ulp
    outweighs ``slack``."""
    want = want.float()
    _, exp = torch.frexp(want)      # |want| in [2**(exp-1), 2**exp)
    half_ulp = torch.ldexp(torch.ones_like(want), exp - 9)  # 8-bit mantissa
    half_ulp = torch.where(want == 0, torch.zeros_like(want), half_ulp)
    return float(((got.float() - want).abs() / (half_ulp + slack)).max())

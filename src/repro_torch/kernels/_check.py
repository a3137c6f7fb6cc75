"""Argument checks shared by the kernel wrappers, and the check of a
bf16 result against its f32 answer."""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.sharding.rules import is_dtensor

# Two bf16 NaNs side by side, and one f32 NaN: shared memory filled with
# it reads as NaN in either type.
NAN_WORD = 0x7FC07FC0


def local_only(label: str, *tensors) -> None:
    """Raise if any of ``tensors`` is a DTensor: a kernel wrapper takes
    each rank's local tensors, and a DTensor reaches the flash kernel
    only through its mesh entry (``flash_attention``'s ``local_map``);
    a DTensor computed here on its own would run the plain version or
    the kernel on the wrong shard."""
    if any(is_dtensor(t) for t in tensors):
        raise TypeError(f"{label} takes local tensors, not DTensors")


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


def fill_shared_memory(device: torch.device, word: int = NAN_WORD,
                       blocks_per_sm: int = 4) -> None:
    """Fill every SM's shared memory with ``word`` (``csrc/
    shared_fill.cu``) on the current stream, so that a kernel launched
    next that reads shared memory it has not written reads NaN."""
    _build.check(_build.library().shared_fill(word, blocks_per_sm,
                                              stream_handle(device)),
                 "shared_fill")


def launch_floor(device: torch.device) -> None:
    """Launch the empty kernel (``csrc/launch_floor.cu``) on the current
    stream: what one launch costs the card with no work in it."""
    _build.check(_build.library().launch_floor(stream_handle(device)),
                 "launch_floor")


def half_bf16_ulp(want: torch.Tensor) -> torch.Tensor:
    """Half a bf16 ulp of each f32 value (0 where the value is 0)."""
    want = want.float()
    _, exp = torch.frexp(want)      # |want| in [2**(exp-1), 2**exp)
    half_ulp = torch.ldexp(torch.ones_like(want), exp - 9)  # 8-bit mantissa
    return torch.where(want == 0, torch.zeros_like(want), half_ulp)


def bf16_rounding_ratio(got: torch.Tensor, want: torch.Tensor,
                        slack: float) -> float:
    """Largest ``|got - want| / (half a bf16 ulp of want + slack)``.

    ``got`` is a bf16 result and ``want`` the f32 answer on the same
    input values.  A result rounded to nearest from an f32 value within
    ``slack`` of ``want`` reads at most 1; one that truncates, or that
    rounds an intermediate to bf16, reads up to about 2 where the ulp
    outweighs ``slack``."""
    want = want.float()
    return float(((got.float() - want).abs()
                  / (half_bf16_ulp(want) + slack)).max())


# bf16 keeps 8 significant bits: rounding p to nearest moves it by at most
# 2**-8 of itself.
P_ROUNDING = 2.0 ** -8


def bf16_prefill_ratio(got: torch.Tensor, want: torch.Tensor,
                       want_abs_v: torch.Tensor, slack: float) -> float:
    """Largest ``|got - want| / (half_ulp(want) + 2**-8 * want_abs_v +
    slack)``: check (a) of the tensor-core prefill, which rounds each
    softmax weight p to bf16 before ``p . v``.

    ``want`` is the plain version's f32 answer and ``want_abs_v`` the same
    plain attention applied to ``|v|`` (the softmax-weighted mean of
    ``|v|``).  Rounding each p by at most 2**-8 of itself moves
    ``sum p v / l`` by at most 2**-8 of ``sum p |v| / l``; the store adds
    half an ulp.  A missing rescale, a wrong mask or a wrong tile reads
    far above 1."""
    want = want.float()
    bound = half_bf16_ulp(want) + P_ROUNDING * want_abs_v.float() + slack
    return float(((got.float() - want).abs() / bound).max())


def bf16_rounding_bias(got: torch.Tensor, want: torch.Tensor) -> float:
    """Median of ``(got - want) * sign(want) / half_ulp(want)`` over the
    non-zero answers: check (b).  A store that rounds to nearest reads
    about 0 (the p roundings are unbiased too); one that truncates reads
    about -1 (its error is uniform in (-2, 0] half ulps).

    The median, not the mean: half an ulp shrinks with ``|want|`` while
    the p roundings' error does not, so outputs near 0 give ratios with a
    tail like 1 / |want| that swamps a mean.  The median keeps both
    readings."""
    want = want.float()
    keep = want != 0
    err = (got.float() - want) * torch.sign(want)
    return float((err[keep] / half_bf16_ulp(want)[keep]).median())

"""Compressed-uplink subsystem: lossy per-device uploads with error feedback.

Port of ``repro.core.compression``.  The uplink payload becomes a
per-device, codec-dependent quantity that the scheduler and every Sub2
solver price (Eq. 6/9/10), and the upload itself is lossy: what a round
fails to transmit is kept in a ``(K, P)`` error-feedback residual and
added back into the next round's update.

* :class:`CompressionConfig` — the reference's knobs and defaults,
  carried on ``FLConfig.compression``.
* the **codecs**, registered by name: ``none`` (identity), ``quant``
  (stochastic ``bit_width``-bit quantization), ``topk`` (magnitude
  sparsification with index-cost accounting) and ``adaptive`` (per-device
  bit width from channel gain and diversity rank).  A codec prices
  ``payload_bits(ccfg, wcfg, gains, index)`` and runs ``apply(updates,
  residual, selected, noise, ccfg, gains, index)``.  Randomness is an
  input: the stochastic codecs (``stochastic = True``) take a ``(K, P)``
  uniform ``noise`` block from the caller.
* :func:`apply_codec` — the driver's entry: the codec round trip, the
  fold-back of failed uploads and the ``error_feedback=False`` gate.

Payloads scale the paper's nominal ``model_bits`` (Table I), decoupled
from the simulated model's parameter count, as in the reference.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Protocol, Tuple, \
    runtime_checkable

import torch

from repro_torch.core import wireless
from repro_torch.kernels import compress as compress_kernel

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    """Uplink-codec knobs (rides on ``FLConfig.compression``)."""

    codec: str = "quant"          # codec registry name
    bit_width: int = 8            # b: quantization levels = 2^b - 1
    topk_frac: float = 0.05       # fraction of coordinates topk keeps
    full_bits: float = 32.0       # uncompressed bits per coordinate
    value_bits: float = 0.0       # topk bits per kept value (0: full)
    index_bits: float = 0.0       # topk bits per index (0: ceil(log2 n))
    error_feedback: bool = True   # carry the EF residual across rounds
    adaptive_min_bits: int = 4    # adaptive: floor bit width
    adaptive_max_bits: int = 12   # adaptive: ceiling bit width
    adaptive_channel_weight: float = 0.5  # channel vs diversity mix
    thresh_iters: int = 32        # topk threshold-bisection trips


def nominal_coords(ccfg: CompressionConfig,
                   wcfg: wireless.WirelessConfig) -> float:
    """Coordinate count of the nominal payload: model_bits / full_bits."""
    return max(wcfg.model_bits / ccfg.full_bits, 1.0)


def topk_index_bits(ccfg: CompressionConfig,
                    wcfg: wireless.WirelessConfig) -> float:
    """Per-kept-entry index cost: configured, or ceil(log2(n_coords))."""
    if ccfg.index_bits > 0.0:
        return ccfg.index_bits
    return float(math.ceil(math.log2(max(nominal_coords(ccfg, wcfg),
                                         2.0))))


def rank01(x: Tensor) -> Tensor:
    """Rank-normalise to [0, 1] along the device axis, ties broken by
    position (the reference's stable double argsort)."""
    k = x.shape[-1]
    first = torch.sort(x, dim=-1, stable=True).indices
    order = torch.sort(first, dim=-1, stable=True).indices
    return order.to(torch.float32) / max(k - 1, 1)


def adaptive_bit_widths(ccfg: CompressionConfig, gains: Tensor,
                        index: Tensor) -> Tensor:
    """Per-device bit width from channel gain + diversity rank:
    ``w * rank(gain) + (1-w) * rank(index)`` mapped onto
    ``[adaptive_min_bits, adaptive_max_bits]`` and rounded (float)."""
    w = ccfg.adaptive_channel_weight
    score = w * rank01(gains) + (1.0 - w) * rank01(index)
    span = float(ccfg.adaptive_max_bits - ccfg.adaptive_min_bits)
    bits = torch.round(ccfg.adaptive_min_bits + score * span)
    return torch.clamp(bits, ccfg.adaptive_min_bits, ccfg.adaptive_max_bits)


@runtime_checkable
class Codec(Protocol):
    """The uplink-codec protocol the FEEL driver consumes."""

    stochastic: bool      # apply() reads a (K, P) uniform noise block

    def payload_bits(self, ccfg: CompressionConfig,
                     wcfg: wireless.WirelessConfig, gains: Tensor,
                     index: Tensor) -> Optional[Tensor]:
        """Per-device uplink bits ``(K,)``, or ``None`` for the nominal
        scalar ``wcfg.model_bits``."""
        ...

    def apply(self, updates: Tensor, residual: Tensor, selected: Tensor,
              noise: Optional[Tensor], ccfg: CompressionConfig,
              gains: Tensor, index: Tensor) -> Tuple[Tensor, Tensor]:
        """Lossy round trip over the flattened ``(K, P)`` updates ->
        ``(decoded values, new residual)``; only selected devices consume
        their backlog."""
        ...


def _roundtrip(updates: Tensor, residual: Tensor, selected: Tensor,
               widths: Tensor, noise: Optional[Tensor],
               ccfg: CompressionConfig, *, mode: str,
               keep: int = 0) -> Tuple[Tensor, Tensor]:
    """The fused pass: the ``compress_update`` kernel on a CUDA tensor,
    its plain version on a CPU one."""
    if mode == "topk":
        # Never read: a (K,) placeholder row instead of a dead block.
        noise = torch.zeros(updates.shape[:-1], dtype=torch.float32,
                            device=updates.device)
    elif noise is None:
        raise ValueError("the quant round trip needs its (K, P) noise")
    return compress_kernel.compress_update(
        updates, residual, widths, selected, noise, mode=mode, keep=keep,
        thresh_iters=ccfg.thresh_iters)


def _full_row(like: Tensor, value: float) -> Tensor:
    return torch.full(like.shape, value, dtype=torch.float32,
                      device=like.device)


@dataclasses.dataclass(frozen=True)
class NoneCodec:
    """Identity uplink: full payload, no loss, no residual."""

    stochastic = False

    def payload_bits(self, ccfg, wcfg, gains, index):
        return None

    def apply(self, updates, residual, selected, noise, ccfg, gains, index):
        return updates, residual


@dataclasses.dataclass(frozen=True)
class Quant:
    """Stochastic ``bit_width``-bit quantization (QSGD-style): payload
    shrinks by ``bit_width / full_bits``."""

    stochastic = True

    def payload_bits(self, ccfg, wcfg, gains, index):
        return _full_row(gains,
                         wcfg.model_bits * ccfg.bit_width / ccfg.full_bits)

    def apply(self, updates, residual, selected, noise, ccfg, gains, index):
        widths = _full_row(updates[..., 0], float(ccfg.bit_width))
        return _roundtrip(updates, residual, selected, widths, noise, ccfg,
                          mode="quant")


def _topk_keep(ccfg: CompressionConfig, num_coords: int) -> int:
    return max(1, min(num_coords, int(round(ccfg.topk_frac * num_coords))))


@dataclasses.dataclass(frozen=True)
class TopK:
    """Magnitude top-k sparsification: each kept entry ships its value
    (``value_bits``, default full) plus its index."""

    stochastic = False

    def payload_bits(self, ccfg, wcfg, gains, index):
        vb = ccfg.value_bits or ccfg.full_bits
        per_entry = vb + topk_index_bits(ccfg, wcfg)
        return _full_row(gains, wcfg.model_bits * ccfg.topk_frac * per_entry
                         / ccfg.full_bits)

    def apply(self, updates, residual, selected, noise, ccfg, gains, index):
        keep = _topk_keep(ccfg, updates.shape[-1])
        widths = _full_row(updates[..., 0], ccfg.full_bits)
        return _roundtrip(updates, residual, selected, widths, None, ccfg,
                          mode="topk", keep=keep)


@dataclasses.dataclass(frozen=True)
class Adaptive:
    """Channel- and data-aware bit allocation: per-device widths from
    :func:`adaptive_bit_widths` set both payload and loss."""

    stochastic = True

    def payload_bits(self, ccfg, wcfg, gains, index):
        widths = adaptive_bit_widths(ccfg, gains, index)
        return wcfg.model_bits * widths / ccfg.full_bits

    def apply(self, updates, residual, selected, noise, ccfg, gains, index):
        widths = adaptive_bit_widths(ccfg, gains, index)
        return _roundtrip(updates, residual, selected, widths, noise, ccfg,
                          mode="quant")


_CODECS: Dict[str, Callable[[], Codec]] = {}


def register_codec(name: str, factory: Callable[[], Codec],
                   overwrite: bool = False) -> None:
    """Register an uplink-codec factory (zero-arg -> codec)."""
    if name in _CODECS and not overwrite:
        raise ValueError(f"codec {name!r} already registered")
    _CODECS[name] = factory


def codec_names() -> tuple[str, ...]:
    return tuple(sorted(_CODECS))


def get_codec(name: str) -> Codec:
    """Build the named uplink codec."""
    try:
        factory = _CODECS[name]
    except KeyError:
        raise ValueError(f"unknown codec {name!r}; registered: "
                         f"{codec_names()}") from None
    return factory()


register_codec("none", NoneCodec)
register_codec("quant", Quant)
register_codec("topk", TopK)
register_codec("adaptive", Adaptive)


def apply_codec(codec: Codec, updates: Tensor, residual: Tensor,
                selected: Tensor, noise: Optional[Tensor],
                ccfg: CompressionConfig, gains: Tensor, index: Tensor,
                success: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """Driver entry: codec round trip + the error-feedback gate.

    ``success`` is the per-device upload-landed mask: only delivered
    devices consume their backlog, and a selected device whose upload
    failed folds its whole raw update back into the residual.  With
    ``error_feedback=False`` the residual returns to zero after the round.
    """
    transmitted = selected if success is None else selected * success
    c, res = codec.apply(updates, residual, transmitted, noise, ccfg, gains,
                         index)
    if success is not None and ccfg.error_feedback:
        failed = selected * (1.0 - success)
        res = res + updates * failed[..., None]
    if not ccfg.error_feedback:
        res = torch.zeros_like(res)
    return c, res

"""Streaming-data refresh: counts, diversity stats and staleness per round.

Replaces the TPU kernel ``stream_update_kernel`` of
``src/repro/kernels/stream_update.py``.  CUDA source:
``csrc/stream_update.cu`` — the S * K device rows as one flat set over
128-thread blocks, a group of G lanes a row (G = 8, 16 or 32 by C, two
classes a lane past 32, a compile-time width), lane c of a group on
class c of its row so that each warp access covers one contiguous span
of rows, and the row sums as ``__shfl_xor_sync`` butterflies inside the
group.  Bound on the H100 by
bytes (a few KB at K = 100, C = 10), in practice by launch latency.
:func:`route` names the group width C takes; the wrapper counts its
launches in ``launches`` and by route in ``route_launches``.

``h' = max(h + delta, 0)``, rescaled to ``size_cap`` where a device
overflows it (``size_cap > 0``); ``stats`` packs ``[gini, shannon,
size]`` of the new counts like the ``diversity`` kernel; ``stale' =
[selected ? 0 : decay * stale] + arrivals`` with ``selected`` the
previous round's delivered set.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, _check

MAX_CLASSES = 64
# Lanes a row times classes a lane, by route (``stream_update_route`` of
# the C source returns the same product).
ROUTE_LANES = {"g8": 8, "g16": 16, "g32": 32, "g32x2": 64}

Result = tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def route(c: int) -> str:
    """The group a row of ``c`` classes takes: the narrowest of 8, 16 or
    32 lanes that holds it, two classes a lane for 32 < c <= 64."""
    if not 1 <= c <= MAX_CLASSES:
        raise ValueError(f"stream_update takes 1 <= C <= {MAX_CLASSES}, "
                         f"got {c}")
    return next(name for name, lanes in ROUTE_LANES.items() if c <= lanes)


def stream_update_plain(hists: torch.Tensor, deltas: torch.Tensor,
                        arrivals: torch.Tensor, staleness: torch.Tensor,
                        selected: torch.Tensor, *, decay: float,
                        size_cap: float = 0.0) -> Result:
    """Plain version (port of ``kernels/ref.py::stream_update``).

    ``(…, K, C)`` counts/deltas with ``(…, K)`` rows; every reduction
    runs over the trailing axis.
    """
    f32 = torch.float32
    h = torch.clamp_min(hists.to(f32) + deltas.to(f32), 0.0)
    if size_cap > 0.0:
        total = torch.sum(h, dim=-1, keepdim=True)
        scale = torch.where(total > size_cap,
                            size_cap / torch.clamp_min(total, 1.0),
                            torch.ones_like(total))
        h = h * scale
    sizes = torch.sum(h, dim=-1)
    p = h / torch.clamp_min(sizes[..., None], 1.0)
    gini = 1.0 - torch.sum(p * p, dim=-1)
    logp = torch.where(p > 0.0, torch.log2(torch.clamp_min(p, 1e-30)),
                       torch.zeros_like(p))
    shannon = -torch.sum(p * logp, dim=-1)
    stats = torch.stack([gini, shannon, sizes], dim=-1)
    stale = torch.where(selected > 0.0, torch.zeros_like(staleness,
                                                         dtype=f32),
                        decay * staleness.to(f32)) + arrivals.to(f32)
    return h, stats, stale


def stream_update(hists: torch.Tensor, deltas: torch.Tensor,
                  arrivals: torch.Tensor, staleness: torch.Tensor,
                  selected: torch.Tensor, *, decay: float,
                  size_cap: float = 0.0) -> Result:
    """One round's fused refresh: ``(hists', stats, staleness')``.

    ``(K, C)`` counts with ``(K,)`` rows, or a batch ``(S, K, C)`` /
    ``(S, K)``.  CPU tensors take :func:`stream_update_plain`; CUDA
    tensors launch the kernel (f32, contiguous, C <= 64) or raise.
    """
    _check.local_only("stream_update", hists, deltas)
    if hists.device.type == "cpu":
        return stream_update_plain(hists, deltas, arrivals, staleness,
                                   selected, decay=decay, size_cap=size_cap)
    batched = hists.dim() == 3
    if not batched:
        hists, deltas, arrivals, staleness, selected = (
            x[None] for x in (hists, deltas, arrivals, staleness, selected))
    s, k, c = hists.shape
    which = route(c)
    dev = hists.device
    for name, t in (("hists", hists), ("deltas", deltas)):
        _check.cuda_operand(name, t, torch.float32, (s, k, c), dev)
    for name, t in (("arrivals", arrivals), ("staleness", staleness),
                    ("selected", selected)):
        _check.cuda_operand(name, t, torch.float32, (s, k), dev)
    h = torch.empty((s, k, c), dtype=torch.float32, device=dev)
    stats = torch.empty((s, k, 3), dtype=torch.float32, device=dev)
    stale = torch.empty((s, k), dtype=torch.float32, device=dev)
    code = _build.library().stream_update_f32(
        hists.data_ptr(), deltas.data_ptr(), arrivals.data_ptr(),
        staleness.data_ptr(), selected.data_ptr(), h.data_ptr(),
        stats.data_ptr(), stale.data_ptr(), s, k, c, decay, size_cap,
        _check.stream_handle(dev))
    _build.check(code, "stream_update")
    stream_update.launches += 1
    stream_update.route_launches[which] += 1
    if not batched:
        return h[0], stats[0], stale[0]
    return h, stats, stale


stream_update.launches = 0
stream_update.route_launches = dict.fromkeys(ROUTE_LANES, 0)

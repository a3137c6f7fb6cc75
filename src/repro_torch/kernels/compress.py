"""Fused uplink compression with error feedback: (…, K, P) rows.

Replaces the TPU kernel ``compress_update_kernel`` of
``src/repro/kernels/compress.py``.  CUDA source: ``csrc/compress.cu``.
Bound on the H100 by bytes.  Two routes, chosen by P alone
(:func:`route`):

- ``onchip`` (P up to :data:`MAX_CLUSTER` x :data:`MAX_CHUNK`): each
  (scenario, device) row is read from device memory once and held in
  shared memory, split over a thread block cluster of
  :func:`cluster_blocks` blocks, through the row max, the quantization
  or the whole top-k bisection, and the final write.  topk counts the
  whole row for its first :data:`FULL_TRIPS` trips, then only the
  magnitudes left inside the bracket, :data:`SPEC_DEPTH` trips a pass
  (every midpoint they can visit, counted at once): the trip-by-trip
  threshold bit for bit.
- ``stream`` (longer rows): one block a row walks it in strides and
  re-reads it on every pass.

``compress_update.launches`` counts every launch and
``compress_update.route_launches`` each ``"<mode>/<route>"``.

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
ROUTES = ("onchip", "stream")
# Floats of a row one block of the on-chip route holds in shared memory
# (csrc/compress.cu kMaxChunk, 96 KB, so two blocks share an SM), and the
# most blocks of a cluster (the portable cluster size).
MAX_CHUNK = 24576
MAX_CLUSTER = 8
# The on-chip topk counts the whole chunk for its first FULL_TRIPS trips,
# one a pass, then keeps the magnitudes left inside the bracket and
# bisects them SPEC_DEPTH trips a pass (1 is the trip-by-trip loop): the
# fastest of the (depth, full trips) pairs swept on the card.
FULL_TRIPS = 4
SPEC_DEPTH = 2
MAX_SPEC_DEPTH = 4
# Threads of an on-chip block (csrc/compress.cu kThreads).
ONCHIP_THREADS = 512


def route(p: int) -> str:
    """The kernel route for rows of ``p`` coordinates."""
    return "onchip" if p <= MAX_CLUSTER * MAX_CHUNK else "stream"


def cluster_blocks(p: int) -> int:
    """Blocks a row of ``p`` coordinates takes on the on-chip route: the
    least power of two whose share of the row, ``ceil(p / nb)``, fits one
    block's :data:`MAX_CHUNK` (fewer blocks, cheaper barriers: chip_smoke's
    compress phase times every cluster size that fits)."""
    if route(p) != "onchip":
        raise ValueError(f"a row of {p} > {MAX_CLUSTER * MAX_CHUNK} floats "
                         f"takes the stream route")
    nb = 1
    while _cdiv(p, nb) > MAX_CHUNK:
        nb *= 2
    return nb


def onchip_smem_bytes(p: int, nb: int, mode: str) -> int:
    """Dynamic shared memory of an on-chip block for rows of ``p`` floats
    over ``nb`` blocks, or 0 where the route refuses them: its share of
    the row padded to whole float4s and, for topk, each thread's slots
    for the magnitudes it keeps (an eighth of its share).  Mirrors
    ``csrc/compress.cu``'s ``compress_update_smem``."""
    share = _cdiv(p, nb)
    if p < 1 or not 1 <= nb <= MAX_CLUSTER or share > MAX_CHUNK:
        return 0
    floats = 4 * _cdiv(share, 4)
    if mode == "topk":
        per_thread = _cdiv(_cdiv(share, 4), ONCHIP_THREADS)
        floats += ONCHIP_THREADS * _cdiv(4 * per_thread, 8)
    return 4 * floats


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


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
    _check.local_only("compress_update", updates, residual, widths,
                      selected, noise)
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
    which = route(p)
    c, r_new = launch(updates, residual, widths, selected, noise,
                      mode=mode, keep=keep, thresh_iters=thresh_iters,
                      which=which)
    compress_update.launches += 1
    compress_update.route_launches[f"{mode}/{which}"] += 1
    if not batched:
        return c[0], r_new[0]
    return c, r_new


compress_update.launches = 0
compress_update.route_launches = {f"{m}/{r}": 0 for m in MODES
                                  for r in ROUTES}


def launch(updates: torch.Tensor, residual: torch.Tensor,
           widths: torch.Tensor, selected: torch.Tensor, noise: torch.Tensor,
           *, mode: str, keep: int, thresh_iters: int, which: str,
           nb: int = 0, depth: int = SPEC_DEPTH,
           full_trips: int = FULL_TRIPS
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """One launch of route ``which`` on checked ``(S, K, P)`` operands,
    uncounted: :func:`compress_update` calls it with the route of P, the
    card checks with every route, cluster size ``nb`` (0: the one P
    gives), depth and count of full trips."""
    s, k, p = updates.shape
    if which == "onchip" and not nb:
        nb = cluster_blocks(p)
    c = torch.empty((s, k, p), dtype=torch.float32, device=updates.device)
    r_new = torch.empty_like(c)
    code = _build.library().compress_update_f32(
        updates.data_ptr(), residual.data_ptr(), widths.data_ptr(),
        selected.data_ptr(), noise.data_ptr(), c.data_ptr(),
        r_new.data_ptr(), s * k, p, MODES.index(mode), keep, thresh_iters,
        ROUTES.index(which), nb, depth, full_trips,
        _check.stream_handle(updates.device))
    _build.check(code, "compress_update")
    return c, r_new

"""Fused Sub2 projected-gradient descent (paper Eq. 15 inner solve).

Replaces the TPU kernel ``sub2_pgd_kernel`` of
``src/repro/kernels/sub2_pgd.py``.  CUDA source: ``csrc/sub2_pgd.cu``.
Bound on the H100 by neither bytes nor operations but by the latency of
a chain of dependent steps: every PGD step waits on about six
reductions, the simplex projection's 32 bisection trips, and the
divisions and transcendentals between them.  The design shortens that
chain:

- the warp route (K <= 256) gives each (instance, start) pair its own
  warp, 4 (K <= 128) or 8 (K <= 256) coordinates per lane in registers,
  so every reduction is a shuffle butterfly with no shared memory and no
  barrier, and divides without the compiler's per-division branch;
- its projection takes the next :data:`SPEC_DEPTH` bisection trips at
  once: every midpoint they can visit, summed over the packed active set
  by groups of lanes, one ballot, then the bracket -- the trip-by-trip
  loop's theta, bit for bit;
- the block route (256 < K <= 1024) keeps one thread per coordinate and
  block reductions, where the rows no longer fit a warp's registers.

:func:`route` picks the route by K alone; ``sub2_pgd.launches`` counts
every launch and ``sub2_pgd.route_launches`` each route's.  Rows are
``(S, K)`` from the start (the scenario-batched driver needs no other
kernel); :func:`sub2_pgd_solve` is the entry the ``fused_pgd``
allocator calls with one row or a batch's stack, one launch either way.
"""

from __future__ import annotations

import math
from typing import Union

import torch

from repro_torch.kernels import _build, _check

N_STARTS = 2          # water-filling + uniform
DEFAULT_PROJ_ITERS = 32
MAX_K = 1024
# Coordinates per lane of each route (0: the block route, one thread per
# coordinate), and the largest K each takes.
ROUTE_COORDS = {"warp4": 4, "warp8": 8, "block": 0}
ROUTE_MAX_K = {"warp4": 128, "warp8": 256, "block": MAX_K}
# Bisection trips per speculative round of the warp route's projection
# (1 is the trip-by-trip loop); the fastest of 1 to 4 in the depth sweep
# of ``chip_smoke.py``'s sub2 phase (see csrc/sub2_pgd.cu).
SPEC_DEPTH = 3
MAX_SPEC_DEPTH = 4


def route(k: int) -> str:
    """The kernel route for rows of ``k`` devices (``1 <= k <= 1024``)."""
    if not 1 <= k <= MAX_K:
        raise ValueError(f"sub2_pgd kernel takes 1 <= K <= {MAX_K}, got {k}")
    return next(name for name, top in ROUTE_MAX_K.items() if k <= top)


def sub2_pgd_plain(selected: torch.Tensor, t_train: torch.Tensor,
                   snr_coeff: torch.Tensor, tx_power: torch.Tensor,
                   payload_bits: torch.Tensor, alpha0: torch.Tensor, *,
                   rho: float, lr: float, tau: float, iters: int,
                   bandwidth_hz: float, min_alpha: float,
                   proj_iters: int = DEFAULT_PROJ_ITERS
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version (port of ``kernels/ref.py::sub2_pgd``), batched.

    ``(S, K)`` rows and ``(S, 2, K)`` starts -> ``((S, K) alpha, (S,)
    objective)``.  As in the reference oracle, the gradient is derived
    independently of the kernel's analytic one: autograd of the
    logsumexp-smoothed objective at the floored point.
    """
    mask = selected[:, None, :]
    tt, c, pw, bits = (x[:, None, :] for x in (t_train, snr_coeff,
                                               tx_power, payload_bits))
    act = mask > 0.0
    msum = torch.sum(selected, dim=-1)[:, None, None]
    n_act = torch.clamp_min(msum, 1.0)
    any_act = msum > 0.5
    scale = bandwidth_hz / math.log(2.0)
    zero = torch.zeros((), dtype=selected.dtype, device=selected.device)

    def upload(av):
        rate = scale * av * torch.log1p(c / av)
        return torch.where(act, bits / torch.clamp_min(rate, 1e-12), zero)

    def exact_obj(av):                                  # (S, 2, K) -> (S, 2)
        tu = upload(torch.clamp_min(av, min_alpha))
        tot = torch.where(act, tt + tu, zero)
        return (rho * torch.sum(pw * tu, dim=-1)
                + (1.0 - rho) * torch.amax(tot, dim=-1))

    def smooth_obj(av):
        tu = upload(av)
        tot = torch.where(act, tt + tu, zero)
        return (rho * torch.sum(pw * tu, dim=-1)
                + (1.0 - rho) * tau * torch.logsumexp(tot / tau, dim=-1))

    def tangent_grad(av):
        x = torch.clamp_min(av, min_alpha).detach().requires_grad_(True)
        with torch.enable_grad():
            (g,) = torch.autograd.grad(smooth_obj(x).sum(), x)
        g = g * mask
        return (g - torch.sum(g, dim=-1, keepdim=True) / n_act) * mask

    def project(v):
        vm = torch.where(act, v, zero)
        lo = torch.amin(torch.where(act, vm, math.inf), dim=-1,
                        keepdim=True) - 1.0
        hi = torch.amax(torch.where(act, vm, -math.inf), dim=-1,
                        keepdim=True)
        for _ in range(proj_iters):
            mid = 0.5 * (lo + hi)
            s = torch.sum(torch.where(act, torch.clamp_min(vm - mid, 0.0),
                                      zero), dim=-1, keepdim=True)
            over = s >= 1.0
            lo, hi = torch.where(over, mid, lo), torch.where(over, hi, mid)
        out = torch.clamp_min(vm - 0.5 * (lo + hi), 0.0)
        out = torch.where(act, out, zero)
        return torch.where(any_act, out, zero)

    a = project(alpha0)
    best_a, best_o = a, exact_obj(a)
    for i in range(iters):
        gt = tangent_grad(a)
        gmax = torch.amax(torch.abs(gt), dim=-1, keepdim=True)
        frac = torch.tensor(float(i)) / iters
        lr_i = (lr * (0.5 * (1.0 + torch.cos(math.pi * frac)))).item()
        a = project(a - lr_i * gt / torch.clamp_min(gmax, 1e-12))
        o = exact_obj(a)
        better = o < best_o
        best_a = torch.where(better[..., None], a, best_a)
        best_o = torch.where(better, o, best_o)
    pick = best_o[:, 0] <= best_o[:, 1]
    return (torch.where(pick[:, None], best_a[:, 0], best_a[:, 1]),
            torch.where(pick, best_o[:, 0], best_o[:, 1]))


def sub2_pgd(selected: torch.Tensor, t_train: torch.Tensor,
             snr_coeff: torch.Tensor, tx_power: torch.Tensor,
             payload_bits: torch.Tensor, alpha0: torch.Tensor, *,
             rho: float, lr: float, tau: float, iters: int,
             bandwidth_hz: float, min_alpha: float,
             proj_iters: int = DEFAULT_PROJ_ITERS
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched fused PGD: ``(S, K)`` rows + ``(S, 2, K)`` starts ->
    ``((S, K) alpha, (S,) objective)``.

    ``snr_coeff`` is c = g P / (B N0).  CPU tensors take
    :func:`sub2_pgd_plain`; CUDA tensors launch the kernel through
    :func:`route` (f32, contiguous, 1 <= K <= 1024) or raise.
    """
    kw = dict(rho=rho, lr=lr, tau=tau, iters=iters,
              bandwidth_hz=bandwidth_hz, min_alpha=min_alpha,
              proj_iters=proj_iters)
    _check.local_only("sub2_pgd", selected, t_train, snr_coeff, tx_power,
                      payload_bits, alpha0)
    if selected.device.type == "cpu":
        return sub2_pgd_plain(selected, t_train, snr_coeff, tx_power,
                              payload_bits, alpha0, **kw)
    return launch(selected, t_train, snr_coeff, tx_power, payload_bits,
                  alpha0, which=route(selected.shape[1]), **kw)


def launch(selected: torch.Tensor, t_train: torch.Tensor,
           snr_coeff: torch.Tensor, tx_power: torch.Tensor,
           payload_bits: torch.Tensor, alpha0: torch.Tensor, *, which: str,
           depth: int = SPEC_DEPTH, rho: float, lr: float, tau: float,
           iters: int, bandwidth_hz: float, min_alpha: float,
           proj_iters: int = DEFAULT_PROJ_ITERS
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """One launch on CUDA tensors through the route ``which`` (any route
    whose K limit holds) and ``depth`` trips per speculative round: what
    :func:`sub2_pgd` does with :func:`route`'s choice, open to the card
    checks that compare routes and depths."""
    s, k = selected.shape
    if which not in ROUTE_COORDS or not 1 <= k <= ROUTE_MAX_K[which]:
        raise ValueError(f"sub2_pgd route {which!r} does not take K = {k}")
    if not 1 <= depth <= MAX_SPEC_DEPTH:
        raise ValueError(f"sub2_pgd depth must be 1..{MAX_SPEC_DEPTH}, "
                         f"got {depth}")
    if which != "block" and not tau > 0.0:
        raise ValueError(f"sub2_pgd's warp route takes tau > 0, got {tau}")
    dev = selected.device
    rows = (("selected", selected), ("t_train", t_train),
            ("snr_coeff", snr_coeff), ("tx_power", tx_power),
            ("payload_bits", payload_bits))
    for name, t in rows:
        _check.cuda_operand(name, t, torch.float32, (s, k), dev)
    _check.cuda_operand("alpha0", alpha0, torch.float32, (s, N_STARTS, k),
                        dev)
    alpha = torch.empty((s, k), dtype=torch.float32, device=dev)
    obj = torch.empty((s,), dtype=torch.float32, device=dev)
    code = _build.library().sub2_pgd(
        *(t.data_ptr() for _, t in rows), alpha0.data_ptr(),
        alpha.data_ptr(), obj.data_ptr(), s, k, rho, 1.0 - rho, lr, tau,
        iters, bandwidth_hz / math.log(2.0), min_alpha, proj_iters,
        ROUTE_COORDS[which], depth, _check.stream_handle(dev))
    _build.check(code, f"sub2_pgd ({which})")
    sub2_pgd.launches += 1
    sub2_pgd.route_launches[which] += 1
    return alpha, obj


sub2_pgd.launches = 0
sub2_pgd.route_launches = dict.fromkeys(ROUTE_COORDS, 0)


def sub2_pgd_solve(selected: torch.Tensor, t_train: torch.Tensor,
                   gains: torch.Tensor, tx_power: torch.Tensor,
                   alpha0: torch.Tensor, *, rho: float, lr: float,
                   tau: float, iters: int, bandwidth_hz: float,
                   noise_psd: float,
                   model_bits: Union[float, torch.Tensor],
                   min_alpha: float,
                   proj_iters: int = DEFAULT_PROJ_ITERS
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The allocator's entry: ``(…, K)`` rows + ``(…, 2, K)`` starts ->
    ``((…, K) alpha, (…,) objective)`` (port of ``ops.sub2_pgd``), every
    lane in one :func:`sub2_pgd` launch on ``(S, K)`` rows (S = 1 for a
    single row).

    Gains and power fold into the SNR coefficient here; ``model_bits``
    (scalar or rows) is materialised as a bits row.
    """
    f32 = torch.float32
    c = gains * tx_power / (bandwidth_hz * noise_psd)
    if isinstance(model_bits, torch.Tensor):
        bits = torch.broadcast_to(model_bits, selected.shape)
    else:   # a fill, not a host-to-device copy of the scalar
        bits = torch.full(selected.shape, model_bits, dtype=f32,
                          device=selected.device)
    k, lead = selected.shape[-1], selected.shape[:-1]
    rows = [torch.broadcast_to(x, selected.shape).to(f32).reshape(-1, k)
            .contiguous() for x in (selected, t_train, c, tx_power, bits)]
    alpha, obj = sub2_pgd(*rows,
                          alpha0.to(f32).reshape(-1, N_STARTS, k).contiguous(),
                          rho=rho, lr=lr, tau=tau, iters=iters,
                          bandwidth_hz=bandwidth_hz, min_alpha=min_alpha,
                          proj_iters=proj_iters)
    return alpha.reshape(lead + (k,)), obj.reshape(lead)

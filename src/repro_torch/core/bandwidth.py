"""Sub2 — bandwidth allocation (paper Eq. 15).

Port of ``repro.core.bandwidth``:

* :func:`min_time_allocation` — the rho -> 0 water-filling limit as the
  fused joint bisection: a fixed-trip deadline bisection that carries a
  per-device Newton iterate of the rate inversion from probe to probe.
* :func:`pgd_allocation` — general rho by tangent-space projected
  gradient on the selected-coordinate simplex, the round time smoothed
  by a logsumexp (gradient from ``torch.autograd``);
* the oracles :func:`invert_rate_bisect` and
  :func:`min_time_allocation_reference` (nested bisections) the
  production solvers are tested against.

The loops are fixed-trip like the reference's, so the port follows its
iterates.  They run as plain PyTorch; the fused descent of the
``fused_pgd`` allocator is the ``sub2_pgd`` CUDA kernel.  Every solver
takes ``(K,)`` rows or ``(S, K)`` stacks of S scenarios and reduces per
lane over the trailing axis: each bisection's test, each sum and max.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from repro_torch.core import wireless

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class Sub2Params:
    rho: float = 0.5            # energy/time trade-off (paper: 1/2)
    time_bisect_iters: int = 60
    rate_bisect_iters: int = 50  # reference nested solver only
    newton_iters: int = 12       # standalone rate inversions + final polish
    joint_newton_steps: int = 2  # per-deadline-probe Newton refinement
    pgd_iters: int = 400
    pgd_lr: float = 0.05
    smooth_tau: float = 1e-3    # logsumexp temperature for max T (seconds)

    @classmethod
    def reference(cls, rho: float = 0.5) -> "Sub2Params":
        """Full-accuracy solve (the defaults)."""
        return cls(rho=rho)

    @classmethod
    def fast(cls, rho: float = 0.5) -> "Sub2Params":
        """Throughput preset: half the deadline bisection, 120 PGD steps."""
        return cls(rho=rho, time_bisect_iters=30, rate_bisect_iters=25,
                   newton_iters=8, pgd_iters=120)


# Ceiling and infeasibility sentinel of the inverted share (exceeds any
# feasible-within-band requirement).
ALPHA_CEIL = 4.0


def _rate_scale(bandwidth_hz: float) -> float:
    """B / ln 2 rounded as the reference computes it: ``jnp.log(2.0)``
    is f32, so the quotient is an f32 division.  A Python float (exact
    in f32), so no scalar tensor is copied to the device per call."""
    return float(np.float32(bandwidth_hz) / np.float32(math.log(2.0)))


def _rate_and_slope(a: Tensor, c: Tensor, bandwidth_hz: float
                    ) -> tuple[Tensor, Tensor]:
    """rate(a) = a*B*log2(1 + c/a) and its derivative (both > 0)."""
    scale = _rate_scale(bandwidth_hz)
    l = torch.log1p(c / a)
    return scale * a * l, scale * (l - c / (a + c))


def invert_rate_bisect(r_req: Tensor, gains: Tensor, tx_power: Tensor,
                       cfg: wireless.WirelessConfig,
                       iters: int = 50) -> Tensor:
    """Reference rate inversion (vectorized bisection): the oracle of the
    Newton solver and of :func:`min_time_allocation_reference`;
    production paths use :func:`invert_rate`."""
    c = gains * tx_power / (cfg.bandwidth_hz * cfg.noise_psd)

    def rate(a):
        a = torch.clamp_min(a, cfg.min_alpha)
        return a * cfg.bandwidth_hz * torch.log2(1.0 + c / a)

    lo = torch.zeros_like(r_req)
    hi = torch.full_like(r_req, ALPHA_CEIL)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        ok = rate(mid) >= r_req
        lo, hi = torch.where(ok, lo, mid), torch.where(ok, mid, hi)
    return hi


def _newton_refine(a: Tensor, r_req: Tensor, c: Tensor,
                   cfg: wireless.WirelessConfig, steps: int) -> Tensor:
    """``steps`` Newton iterations on rate(a) - r_req from ``a``, clipped
    into [min_alpha, ALPHA_CEIL] (global convergence on the concave
    rate)."""
    a = torch.clamp(a, cfg.min_alpha, ALPHA_CEIL)
    for _ in range(steps):
        r, slope = _rate_and_slope(a, c, cfg.bandwidth_hz)
        step = (r - r_req) / torch.clamp_min(slope, 1e-20)
        a = torch.clamp(a - step, cfg.min_alpha, ALPHA_CEIL)
    return a


def invert_rate(r_req: Tensor, gains: Tensor, tx_power: Tensor,
                cfg: wireless.WirelessConfig, iters: int = 12,
                alpha0: Optional[Tensor] = None) -> Tensor:
    """Minimal alpha achieving rate ``r_req`` (vectorized Newton); may
    exceed 1 (up to ``ALPHA_CEIL``) when infeasible inside the band."""
    c = gains * tx_power / (cfg.bandwidth_hz * cfg.noise_psd)
    if alpha0 is None:
        # Secant-style cold start: linearize the log factor at a = 1.
        denom = torch.clamp_min(cfg.bandwidth_hz * torch.log2(1.0 + c),
                                1e-20)
        alpha0 = r_req / denom
    return _newton_refine(alpha0, r_req, c, cfg, iters)


def effective_payload_bits(payload_bits: Optional[Tensor],
                           airtime_mult: float,
                           cfg: wireless.WirelessConfig,
                           like: Tensor) -> Optional[Tensor]:
    """Retry-priced payload for scheduling-time Sub2 solves.

    The fault subsystem's expected retransmission multiplier
    (``faults.expected_time_mult``) becomes effective uplink bits here,
    so every deadline function and Sub2 solver prices the retry tax
    alike.  ``airtime_mult == 1.0`` returns the input itself; with no
    per-device payload the scalar ``cfg.model_bits`` is materialised as
    a ``(K,)`` row shaped like ``like``.
    """
    if airtime_mult == 1.0:
        return payload_bits
    if payload_bits is None:
        return torch.full(like.shape, cfg.model_bits * airtime_mult,
                          dtype=torch.float32, device=like.device)
    return payload_bits * float(np.float32(airtime_mult))


def _required_rate(deadline: Tensor, t_train: Tensor,
                   cfg: wireless.WirelessConfig,
                   payload_bits: Optional[Tensor] = None) -> Tensor:
    """Upload rate needed to finish by ``deadline``; inf when the
    training alone already exceeds it."""
    s = cfg.model_bits if payload_bits is None else payload_bits
    slack = deadline - t_train
    r = s / torch.clamp_min(slack, 1e-9)
    return torch.where(slack > 0.0, r, torch.full_like(r, math.inf))


def alpha_for_deadline(deadline: Tensor, selected: Tensor, t_train: Tensor,
                       gains: Tensor, tx_power: Tensor,
                       cfg: wireless.WirelessConfig, rate_iters: int = 12,
                       solver: str = "newton",
                       payload_bits: Optional[Tensor] = None) -> Tensor:
    """Minimal alpha_k letting each selected device finish by
    ``deadline``; ``ALPHA_CEIL`` where training alone exceeds it.
    ``solver`` picks the Newton inversion (default) or the bisection
    oracle."""
    r_req = _required_rate(deadline, t_train, cfg, payload_bits)
    inf = torch.isinf(r_req)
    r_fin = torch.where(inf, torch.full_like(r_req, 1e30), r_req)
    invert = invert_rate if solver == "newton" else invert_rate_bisect
    a = invert(r_fin, gains, tx_power, cfg, iters=rate_iters)
    a = torch.where(inf, torch.full_like(a, ALPHA_CEIL), a)
    return torch.where(selected > 0.0, a, torch.zeros_like(a))


def _deadline_bracket(selected: Tensor, t_train: Tensor, gains: Tensor,
                      tx_power: Tensor, cfg: wireless.WirelessConfig,
                      payload_bits: Optional[Tensor] = None
                      ) -> tuple[Tensor, Tensor, Tensor]:
    """(lo, hi, equal_alpha): lo = max t_train, hi = completion time at
    the equal-share allocation (feasible); lo and hi ``(…, 1)`` per
    lane."""
    sel = selected > 0.0
    n_sel = torch.clamp_min(torch.sum(selected, dim=-1, keepdim=True), 1.0)
    equal_alpha = torch.where(sel, 1.0 / n_sel, torch.zeros_like(selected))
    t_up_equal = wireless.upload_time(equal_alpha, gains, tx_power, cfg,
                                      payload_bits)
    zero = torch.zeros_like(t_train)
    hi = torch.amax(torch.where(sel, t_train + t_up_equal, zero), dim=-1,
                    keepdim=True)
    lo = torch.amax(torch.where(sel, t_train, zero), dim=-1, keepdim=True)
    return lo, hi, equal_alpha


def min_time_allocation_reference(
        selected: Tensor, t_train: Tensor, gains: Tensor, tx_power: Tensor,
        cfg: wireless.WirelessConfig, params: Sub2Params = Sub2Params(),
        payload_bits: Optional[Tensor] = None) -> tuple[Tensor, Tensor]:
    """Nested reference deadline solve: returns (alpha, T*).

    A deadline bisection with a full rate bisection per device at every
    probe (``time_bisect_iters * rate_bisect_iters`` loop bodies): the
    oracle :func:`min_time_allocation` is held against.
    """
    any_sel = torch.sum(selected, dim=-1, keepdim=True) > 0.0
    lo, hi, _ = _deadline_bracket(selected, t_train, gains, tx_power, cfg,
                                  payload_bits)

    def shares(deadline):
        return alpha_for_deadline(deadline, selected, t_train, gains,
                                  tx_power, cfg,
                                  rate_iters=params.rate_bisect_iters,
                                  solver="bisect", payload_bits=payload_bits)

    for _ in range(params.time_bisect_iters):
        mid = 0.5 * (lo + hi)
        ok = torch.sum(shares(mid), dim=-1, keepdim=True) <= 1.0
        lo, hi = torch.where(ok, lo, mid), torch.where(ok, mid, hi)
    t_star = hi
    alpha = shares(t_star)
    # Normalize tiny bisection overshoot back inside the budget.
    total = torch.sum(alpha, dim=-1, keepdim=True)
    alpha = torch.where(total > 1.0, alpha / total, alpha)
    alpha = torch.where(any_sel, alpha, torch.zeros_like(alpha))
    t_star = torch.where(any_sel, t_star, torch.zeros_like(t_star))
    return alpha, t_star[..., 0]


def min_time_allocation(selected: Tensor, t_train: Tensor, gains: Tensor,
                        tx_power: Tensor, cfg: wireless.WirelessConfig,
                        params: Sub2Params = Sub2Params(),
                        alpha0: Optional[Tensor] = None,
                        payload_bits: Optional[Tensor] = None
                        ) -> tuple[Tensor, Tensor]:
    """Fused joint min-T solve: returns (alpha, T*).

    One fixed-trip deadline bisection carrying the per-device Newton
    iterate: each probe refines the previous probe's alpha with
    ``joint_newton_steps`` Newton steps, then ``newton_iters`` polish
    the allocation at T*.  ``alpha0`` seeds the carry.  T* is ``(…,)``,
    one per lane.
    """
    sel = selected > 0.0
    any_sel = torch.sum(selected, dim=-1, keepdim=True) > 0.0
    lo, hi, equal_alpha = _deadline_bracket(selected, t_train, gains,
                                            tx_power, cfg, payload_bits)
    c = gains * tx_power / (cfg.bandwidth_hz * cfg.noise_psd)
    seed = equal_alpha if alpha0 is None else alpha0
    a_carry = torch.clamp(seed, cfg.min_alpha, ALPHA_CEIL)
    ceil = torch.full_like(a_carry, ALPHA_CEIL)
    zero = torch.zeros_like(a_carry)

    def probe(deadline, a_carry, steps):
        r_req = _required_rate(deadline, t_train, cfg, payload_bits)
        finite = torch.isfinite(r_req)
        a_new = _newton_refine(a_carry, torch.where(finite, r_req, 1.0), c,
                               cfg, steps)
        a_eval = torch.where(sel, torch.where(finite, a_new, ceil), zero)
        return a_eval, torch.where(finite, a_new, a_carry)

    for _ in range(params.time_bisect_iters):
        mid = 0.5 * (lo + hi)
        a_eval, a_carry = probe(mid, a_carry, params.joint_newton_steps)
        ok = torch.sum(a_eval, dim=-1, keepdim=True) <= 1.0
        lo, hi = torch.where(ok, lo, mid), torch.where(ok, mid, hi)
    t_star = hi
    alpha, _ = probe(t_star, a_carry, params.newton_iters)
    # Normalize tiny bisection overshoot back inside the budget.
    total = torch.sum(alpha, dim=-1, keepdim=True)
    alpha = torch.where(total > 1.0, alpha / total, alpha)
    alpha = torch.where(any_sel, alpha, zero)
    t_star = torch.where(any_sel, t_star, torch.zeros_like(t_star))
    return alpha, t_star[..., 0]


def project_simplex(v: Tensor, mask: Tensor, radius: float = 1.0) -> Tensor:
    """Euclidean projection of ``v`` (masked coords) onto the simplex
    {a >= 0, sum a = radius, a_i = 0 off-mask} (Duchi et al., 2008), lane
    by lane over the trailing axis."""
    big_neg = -1e30
    n = v.shape[-1]
    n_active = torch.clamp_min(torch.sum(mask, dim=-1, keepdim=True), 1.0)
    vm = torch.where(mask > 0.0, v, torch.full_like(v, big_neg))
    u = torch.sort(vm, dim=-1, descending=True, stable=True).values
    css = torch.cumsum(u, dim=-1)
    k = torch.arange(1, n + 1, dtype=v.dtype, device=v.device)
    cond = (u * k > (css - radius)) & (u > big_neg / 2)
    rho_idx = torch.clamp(torch.sum(cond, dim=-1, keepdim=True) - 1, 0,
                          n - 1)
    theta = (torch.gather(css, -1, rho_idx) - radius) / (rho_idx + 1.0)
    out = torch.clamp_min(v - theta, 0.0)
    out = torch.where(mask > 0.0, out, torch.zeros_like(out))
    return torch.where(n_active > 0.5, out, torch.zeros_like(out))


def sub2_objective(alpha: Tensor, selected: Tensor, t_train: Tensor,
                   gains: Tensor, tx_power: Tensor,
                   cfg: wireless.WirelessConfig, rho: float,
                   smooth_tau: float = 0.0,
                   energy_weights: Optional[Tensor] = None,
                   payload_bits: Optional[Tensor] = None) -> Tensor:
    """rho * sum w_k E_k + (1-rho) * T (Eq. 15a); optionally smoothed max.

    ``energy_weights`` (default all ones) prices each device's energy
    term, the importance-weighted allocator's hook; the realized energy
    is unchanged, only the trade-off moves.
    """
    sel = selected > 0.0
    zero = torch.zeros_like(t_train)
    t_up = wireless.upload_time(alpha, gains, tx_power, cfg, payload_bits)
    t_up = torch.where(sel, t_up, zero)
    energy = torch.where(sel, tx_power * t_up, zero)
    if energy_weights is not None:
        energy = energy * energy_weights
    total = torch.where(sel, t_train + t_up, zero)
    if smooth_tau > 0.0:
        t_round = smooth_tau * torch.logsumexp(total / smooth_tau, dim=-1)
    else:
        t_round = torch.amax(total, dim=-1)
    return rho * torch.sum(energy, dim=-1) + (1.0 - rho) * t_round


def pgd_allocation(selected: Tensor, t_train: Tensor, gains: Tensor,
                   tx_power: Tensor, cfg: wireless.WirelessConfig,
                   params: Sub2Params = Sub2Params(),
                   alpha0: Optional[Tensor] = None,
                   energy_weights: Optional[Tensor] = None,
                   payload_bits: Optional[Tensor] = None
                   ) -> tuple[Tensor, Tensor]:
    """Sub2 for general rho by tangent-space projected gradient.

    Two starts — the water-filling solve (warm-started by ``alpha0``)
    and the uniform share — each descended with the mean-removed
    gradient under a cosine lr decay, tracking the best exact-max
    objective.  ``energy_weights`` reprices each device's energy in the
    objective (the importance-weighted allocator); the water-filling
    start ignores it.  Returns (alpha, objective).
    """
    mask = (selected > 0.0).to(torch.float32)
    n_act = torch.clamp_min(torch.sum(mask, dim=-1, keepdim=True), 1.0)

    def exact_obj(a):
        return sub2_objective(a, selected, t_train, gains, tx_power, cfg,
                              params.rho, smooth_tau=0.0,
                              energy_weights=energy_weights,
                              payload_bits=payload_bits)

    def grad(a):
        x = a.detach().requires_grad_(True)
        with torch.enable_grad():
            obj = sub2_objective(x, selected, t_train, gains, tx_power, cfg,
                                 params.rho, params.smooth_tau,
                                 energy_weights=energy_weights,
                                 payload_bits=payload_bits)
            (g,) = torch.autograd.grad(obj.sum(), x)
        return g

    def descend(a0):
        a = project_simplex(a0, mask)
        best_a, best_o = a, exact_obj(a)
        for i in range(params.pgd_iters):
            g = grad(a) * mask
            g_t = (g - torch.sum(g, dim=-1, keepdim=True) / n_act) \
                * mask                                  # tangent component
            gmax = torch.amax(torch.abs(g_t), dim=-1, keepdim=True)
            frac = torch.tensor(float(i)) / params.pgd_iters
            lr = (params.pgd_lr
                  * (0.5 * (1 + torch.cos(math.pi * frac)))).item()
            a = project_simplex(
                a - lr * g_t / torch.clamp_min(gmax, 1e-12), mask)
            o = exact_obj(a)
            better = o < best_o
            best_a = torch.where(better[..., None], a, best_a)
            best_o = torch.where(better, o, best_o)
        return best_a, best_o

    wf, _ = min_time_allocation(selected, t_train, gains, tx_power, cfg,
                                params, alpha0=alpha0,
                                payload_bits=payload_bits)
    a1, o1 = descend(wf)
    a2, o2 = descend(mask / n_act)
    pick = o1 <= o2
    return torch.where(pick[..., None], a1, a2), torch.where(pick, o1, o2)

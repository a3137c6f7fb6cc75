"""Scheduling policies for FEEL rounds (paper Alg. 2 + §VI baselines).

Port of ``repro.core.scheduler``: :func:`das_schedule` (Data-Aware
Scheduling, Sub1 <-> Sub2 until the (x, alpha) pair stabilises),
:func:`abs_schedule` (age-based), :func:`random_schedule`,
:func:`full_schedule` and :func:`topn_schedule`, behind one entry,
:func:`schedule` (its body :func:`schedule_impl`).  Every policy solves
Sub2 through the ``core.allocator`` registry.  :func:`score_trace`
recomputes the priority surface a policy ranked on, for the telemetry
frames.

Every policy takes ``(K,)`` rows or ``(S, K)`` stacks of S scenarios
(the network's leaves stacked alike) and works per lane along the
trailing axis.  The reference's DAS ``while_loop`` freezes a lane's
carry once that lane converges; here it is a Python loop with one host
sync per outer iteration for all lanes at once (the convergence test),
the converged lanes carried unchanged by ``torch.where`` while the
others iterate, and the loop stops when no lane changed.  The uniform
draw the abs/random policies rank on is an input (``sched_u``), so a
test can feed the reference's draw.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from repro_torch.core import allocator as alloc_lib
from repro_torch.core import bandwidth as bw
from repro_torch.core import diversity
from repro_torch.core import selection as sel
from repro_torch.core import wireless

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    method: str = "das"              # das | abs | random | full
    n_min: int = 1                   # N in (13e)
    n_fixed: Optional[int] = None    # paper Fig. 2/3 stress mode
    iterations_max: int = 8          # Alg. 2 outer iterations
    local_epochs: int = 1            # E, enters t_train (Eq. 8)
    sub1: sel.Sub1Params = sel.Sub1Params()
    sub2: bw.Sub2Params = bw.Sub2Params()
    allocator: str = "pgd"           # Sub2 solver (core.allocator registry)
    x_tol: float = 0.5               # convergence: selection unchanged
    alpha_tol: float = 1e-4          # convergence: allocation stable
    # Re-ranking weights of the streaming staleness boost and the fault
    # subsystem's reliability discount (DAS and ABS only).
    staleness_weight: float = 0.0
    reliability_weight: float = 0.0
    # How Sub1 prices a currently-unselected device's energy: "strict"
    # uses its current (~zero) share, "mean" the mean selected share.
    reentry: str = "strict"          # strict | mean


@dataclasses.dataclass
class ScheduleResult:
    """One round's schedule; every row ``(…, K)`` with a leading ``(S,)``
    for a stack of scenarios."""

    selected: Tensor     # (…, K) {0,1}
    alpha: Tensor        # (…, K) bandwidth shares, sum <= 1
    t_train: Tensor      # (…, K) seconds
    t_up: Tensor         # (…, K) seconds (inf if unselected)
    energy: Tensor       # (…, K) joules (0 if unselected)
    round_time: Tensor   # (…,) Eq. 7
    # DAS outer iterations used: a host int for one row, an (S,) int32
    # tensor for a stack (each lane's own count).
    iterations: Union[int, Tensor]


def staleness_boost(priority: Tensor, staleness: Optional[Tensor],
                    sch: SchedulerConfig) -> Tensor:
    """Streaming re-ranking hook: ``priority + gamma_s *
    normalize(log1p(staleness))``, so devices sitting on data the server
    has not trained on rise.  Identity without a signal or at weight 0."""
    if staleness is None or sch.staleness_weight == 0.0:
        return priority
    boost = diversity.normalize_metric(torch.log1p(staleness))
    return priority + sch.staleness_weight * boost


def reliability_discount(priority: Tensor, reliability: Optional[Tensor],
                         sch: SchedulerConfig) -> Tensor:
    """Fault re-ranking hook: ``priority * ((1 - gamma_r) + gamma_r *
    rel_k)`` with ``rel_k`` the per-device reliability EMA in [0, 1].
    Identity without a signal or at weight 0."""
    if reliability is None or sch.reliability_weight == 0.0:
        return priority
    w = sch.reliability_weight
    return priority * ((1.0 - w) + w * reliability)


def score_trace(sched_u: Optional[Tensor], index: Tensor, ages: Tensor,
                sch: SchedulerConfig,
                staleness: Optional[Tensor] = None,
                reliability: Optional[Tensor] = None) -> dict:
    """Per-device selection-score decomposition (telemetry frames).

    The priority each method ranks on, recomputed with the hooks the
    policies use: ``score_base`` (the diversity index for DAS,
    ``log1p(age)`` for abs, the round's uniform draw ``sched_u`` for
    random, ones for full), ``score_boosted`` (the staleness boost),
    ``score_final`` (the reliability discount; abs adds its ``1e-4 *
    sched_u`` tiebreak) and ``score_rank`` (0 = highest; equal
    priorities keep device order, as ``jnp.argsort``'s stable sort
    keeps them).  Reads the round's draw, draws nothing.  ``(S, K)``
    rows rank per lane.
    """
    if sch.method == "das":
        base = index
    elif sch.method == "abs":
        base = torch.log1p(ages.to(torch.float32))
    elif sch.method == "random":
        if sched_u is None:
            raise ValueError("the random method's score is the sched_u draw")
        base = sched_u
    elif sch.method == "full":
        base = torch.ones_like(index)
    else:
        raise ValueError(f"unknown scheduling method: {sch.method!r}")
    if sch.method in ("das", "abs"):
        boosted = staleness_boost(base, staleness, sch)
        final = reliability_discount(boosted, reliability, sch)
        if sch.method == "abs" and sched_u is not None:
            final = final + 1e-4 * sched_u
    else:
        boosted = final = base
    order = torch.argsort(-final, dim=-1, stable=True)
    rank = torch.argsort(order, dim=-1, stable=True).to(torch.int32)
    return {"score_base": base, "score_boosted": boosted,
            "score_final": final, "score_rank": rank}


def _finalize(selected: Tensor, alpha: Tensor, t_train: Tensor,
              gains: Tensor, net: wireless.NetworkState,
              cfg: wireless.WirelessConfig,
              iterations: Union[int, Tensor] = 0,
              payload_bits: Optional[Tensor] = None) -> ScheduleResult:
    sel_mask = selected > 0.0
    t_up = wireless.upload_time(alpha, gains, net.tx_power, cfg,
                                payload_bits)
    t_up = torch.where(sel_mask, t_up, torch.full_like(t_up, float("inf")))
    t_up_fin = torch.where(torch.isinf(t_up), torch.zeros_like(t_up), t_up)
    energy = torch.where(sel_mask, net.tx_power * t_up_fin,
                         torch.zeros_like(t_up))
    t_round = wireless.round_time(selected, t_train, t_up_fin)
    if not isinstance(iterations, Tensor):
        iterations = int(iterations)
    return ScheduleResult(selected, alpha, t_train, t_up, energy, t_round,
                          iterations)


# ---------------------------------------------------------------------------
# DAS — Algorithm 2
# ---------------------------------------------------------------------------

def das_schedule(index: Tensor, data_sizes: Tensor, gains: Tensor,
                 net: wireless.NetworkState, cfg: wireless.WirelessConfig,
                 sch: SchedulerConfig,
                 alloc: Optional[alloc_lib.Allocator] = None,
                 payload_bits: Optional[Tensor] = None) -> ScheduleResult:
    """Data-aware scheduling: iterate Sub1 <-> Sub2 (paper Alg. 2).

    Sub1 prices every device at the current allocation (floored, or
    re-priced at the mean share with ``reentry="mean"``); Sub2 runs
    through ``alloc`` warm-started with the previous allocation.  A lane
    stops once its selection and allocation stop moving, or after
    ``iterations_max`` iterations.  With ``(S, K)`` rows every lane runs
    each outer iteration (one Sub2 call, one ``sub2_pgd`` launch for all
    of them), and a lane that has converged keeps its ``(x, alpha,
    x_prev, alpha_prev, it)`` unchanged until none changed: each lane's
    result and count are its own run's.
    """
    alloc = alloc or alloc_lib.get(sch.allocator, sch.sub2)
    k, lead = index.shape[-1], index.shape[:-1]
    t_train = wireless.train_time(data_sizes, net, cfg, sch.local_epochs)
    sub1 = dataclasses.replace(sch.sub1, n_min=sch.n_min)

    dev = index.device
    x = torch.ones(lead + (k,), dtype=torch.float32, device=dev)
    alpha = torch.full(lead + (k,), 1.0 / k, dtype=torch.float32,
                       device=dev)
    x_prev, alpha_prev = torch.zeros_like(x), torch.zeros_like(alpha)
    its = torch.zeros(lead, dtype=torch.int32, device=dev) if lead \
        else None
    it = 0
    live = None
    while it < sch.iterations_max:
        if it > 0:
            # One host sync per outer iteration for every lane at once:
            # the convergence test.  Within it every live lane has taken
            # ``it`` iterations, so ``iterations_max`` binds them all.
            changed = ((torch.sum(torch.abs(x - x_prev), dim=-1)
                        >= sch.x_tol)
                       | (torch.amax(torch.abs(alpha - alpha_prev), dim=-1)
                          >= sch.alpha_tol))
            if not bool(torch.any(changed)):
                break
            live = changed if lead else None
        if sch.reentry == "mean":
            n_sel = torch.clamp_min(torch.sum(x, dim=-1, keepdim=True), 1.0)
            mean_share = torch.sum(alpha, dim=-1, keepdim=True) / n_sel
            alpha_eval = torch.where(
                alpha > cfg.min_alpha, alpha,
                torch.clamp_min(mean_share, 1.0 / k))
        else:  # strict: dropped devices keep their ~zero allocation
            alpha_eval = torch.clamp_min(alpha, cfg.min_alpha)
        t_up = wireless.upload_time(alpha_eval, gains, net.tx_power, cfg,
                                    payload_bits)
        energy = net.tx_power * t_up
        x_new, _, _ = sel.solve_sub1(energy, t_train + t_up, index, sub1)
        alpha_new, _ = alloc.solve(x_new, t_train, gains, net.tx_power,
                                   cfg, alpha0=alpha,
                                   data_sizes=data_sizes,
                                   payload_bits=payload_bits)
        if live is None:    # every lane live
            x_prev, alpha_prev = x, alpha
            x, alpha = x_new, alpha_new
        else:               # converged lanes keep their carry
            keep = live[..., None]
            x_prev = torch.where(keep, x, x_prev)
            alpha_prev = torch.where(keep, alpha, alpha_prev)
            x = torch.where(keep, x_new, x)
            alpha = torch.where(keep, alpha_new, alpha)
        if lead:
            its = its + (1 if live is None else live.to(torch.int32))
        it += 1
    return _finalize(x, alpha, t_train, gains, net, cfg,
                     its if lead else it, payload_bits)


# ---------------------------------------------------------------------------
# Priority-based baselines (ABS / random / fixed-n)
# ---------------------------------------------------------------------------

def _topn_by_priority(priority: Tensor, n: int) -> Tensor:
    return torch.zeros_like(priority).scatter_(
        -1, sel.top_indices(priority, n), 1.0)


def topn_schedule(priority: Tensor, n: int, data_sizes: Tensor,
                  gains: Tensor, net: wireless.NetworkState,
                  cfg: wireless.WirelessConfig, sch: SchedulerConfig,
                  alloc: Optional[alloc_lib.Allocator] = None,
                  payload_bits: Optional[Tensor] = None) -> ScheduleResult:
    """Select exactly ``n`` devices by ``priority``, then run Sub2."""
    alloc = alloc or alloc_lib.get(sch.allocator, sch.sub2)
    t_train = wireless.train_time(data_sizes, net, cfg, sch.local_epochs)
    x = _topn_by_priority(priority, n)
    alpha, _ = alloc.solve(x, t_train, gains, net.tx_power, cfg,
                           data_sizes=data_sizes, payload_bits=payload_bits)
    return _finalize(x, alpha, t_train, gains, net, cfg,
                     payload_bits=payload_bits)


def _median(t: Tensor) -> Tensor:
    """``jnp.median`` over the trailing axis, kept as a ``(…, 1)`` axis:
    the mean of the two middle values for even K (``torch.median``
    returns the lower one)."""
    s = torch.sort(t, dim=-1).values
    n = t.shape[-1]
    return (s[..., (n - 1) // 2:(n - 1) // 2 + 1]
            + s[..., n // 2:n // 2 + 1]) * 0.5


def abs_schedule(ages: Tensor, data_sizes: Tensor, gains: Tensor,
                 net: wireless.NetworkState, cfg: wireless.WirelessConfig,
                 sch: SchedulerConfig, sched_u: Optional[Tensor] = None,
                 deadline: Optional[float] = None,
                 alloc: Optional[alloc_lib.Allocator] = None,
                 staleness: Optional[Tensor] = None,
                 payload_bits: Optional[Tensor] = None,
                 reliability: Optional[Tensor] = None) -> ScheduleResult:
    """Age-based scheduling (paper §VI baselines, Yang et al. f(k)).

    Priority ``log(1 + age)``, re-ranked by :func:`staleness_boost` and
    :func:`reliability_discount`, plus ``1e-4 * sched_u`` as a tiebreak.
    With ``n_fixed`` a top-n policy; otherwise devices are admitted in
    priority order while the deadline's minimal bandwidth fits the band
    (the top ``n_min`` always, their infeasible shares kept out of the
    budget).
    """
    alloc = alloc or alloc_lib.get(sch.allocator, sch.sub2)
    t_train = wireless.train_time(data_sizes, net, cfg, sch.local_epochs)
    priority = torch.log1p(ages.to(torch.float32))
    priority = staleness_boost(priority, staleness, sch)
    priority = reliability_discount(priority, reliability, sch)
    if sched_u is not None:
        priority = priority + 1e-4 * sched_u
    if sch.n_fixed is not None:
        return topn_schedule(priority, sch.n_fixed, data_sizes, gains, net,
                             cfg, sch, alloc, payload_bits)
    if deadline is None:
        # Default deadline: median device at an equal 1/8 band share.
        a_ref = torch.full_like(priority, 1.0 / 8.0)
        t_ref = t_train + wireless.upload_time(a_ref, gains, net.tx_power,
                                               cfg, payload_bits)
        deadline_t = _median(t_ref)
    else:
        deadline_t = torch.tensor(deadline, dtype=torch.float32,
                                  device=priority.device)
    ones = torch.ones_like(priority)
    a_min = bw.alpha_for_deadline(deadline_t, ones, t_train, gains,
                                  net.tx_power, cfg,
                                  rate_iters=sch.sub2.newton_iters,
                                  payload_bits=payload_bits)
    # jnp.argsort is stable: equal priorities keep device order.
    order = torch.sort(-priority, dim=-1, stable=True).indices
    a_sorted = torch.gather(a_min, -1, order)
    forced = torch.arange(priority.shape[-1],
                          device=priority.device) < sch.n_min
    a_budget = torch.where(forced & (a_sorted > 1.0),
                           torch.zeros_like(a_sorted), a_sorted)
    admit_sorted = (torch.cumsum(a_budget, dim=-1) <= 1.0) | forced
    x = torch.zeros_like(priority).scatter_(
        -1, order, admit_sorted.to(torch.float32))
    alpha, _ = alloc.solve(x, t_train, gains, net.tx_power, cfg,
                           data_sizes=data_sizes, payload_bits=payload_bits)
    return _finalize(x, alpha, t_train, gains, net, cfg,
                     payload_bits=payload_bits)


def random_schedule(sched_u: Tensor, data_sizes: Tensor, gains: Tensor,
                    net: wireless.NetworkState,
                    cfg: wireless.WirelessConfig, sch: SchedulerConfig,
                    alloc: Optional[alloc_lib.Allocator] = None,
                    payload_bits: Optional[Tensor] = None
                    ) -> ScheduleResult:
    """Uniform-random selection baseline (paper §VI-B): the top n of the
    uniform draw ``sched_u``."""
    n = sch.n_fixed if sch.n_fixed is not None else sch.n_min
    return topn_schedule(sched_u, n, data_sizes, gains, net, cfg, sch,
                         alloc, payload_bits)


def full_schedule(data_sizes: Tensor, gains: Tensor,
                  net: wireless.NetworkState, cfg: wireless.WirelessConfig,
                  sch: SchedulerConfig,
                  alloc: Optional[alloc_lib.Allocator] = None,
                  payload_bits: Optional[Tensor] = None) -> ScheduleResult:
    """Paper's baseline: all devices participate; Sub2 optimizes alpha."""
    alloc = alloc or alloc_lib.get(sch.allocator, sch.sub2)
    t_train = wireless.train_time(data_sizes, net, cfg, sch.local_epochs)
    x = torch.ones_like(t_train)
    alpha, _ = alloc.solve(x, t_train, gains, net.tx_power, cfg,
                           data_sizes=data_sizes, payload_bits=payload_bits)
    return _finalize(x, alpha, t_train, gains, net, cfg,
                     payload_bits=payload_bits)


def schedule_impl(sched_u: Optional[Tensor], index: Tensor, ages: Tensor,
                  data_sizes: Tensor, gains: Tensor,
                  net: wireless.NetworkState,
                  cfg: wireless.WirelessConfig, sch: SchedulerConfig,
                  staleness: Optional[Tensor] = None,
                  payload_bits: Optional[Tensor] = None,
                  reliability: Optional[Tensor] = None) -> ScheduleResult:
    """Dispatch on ``sch.method``.  ``sched_u`` is the round's (K,)
    uniform draw, read by abs (tiebreak) and random (priority) only.
    ``staleness`` (streaming) and ``reliability`` (faults) re-rank DAS's
    index and ABS's age priority; random and full ignore them."""
    alloc = alloc_lib.get(sch.allocator, sch.sub2)
    if sch.method == "das":
        index = staleness_boost(index, staleness, sch)
        index = reliability_discount(index, reliability, sch)
        if sch.n_fixed is not None:
            return topn_schedule(index, sch.n_fixed, data_sizes, gains, net,
                                 cfg, sch, alloc, payload_bits)
        return das_schedule(index, data_sizes, gains, net, cfg, sch, alloc,
                            payload_bits)
    if sch.method == "abs":
        return abs_schedule(ages, data_sizes, gains, net, cfg, sch, sched_u,
                            alloc=alloc, staleness=staleness,
                            payload_bits=payload_bits,
                            reliability=reliability)
    if sch.method == "random":
        if sched_u is None:
            raise ValueError("random scheduling needs the sched_u draw")
        return random_schedule(sched_u, data_sizes, gains, net, cfg, sch,
                               alloc, payload_bits)
    if sch.method == "full":
        return full_schedule(data_sizes, gains, net, cfg, sch, alloc,
                             payload_bits)
    raise ValueError(f"unknown scheduling method: {sch.method!r}")


def schedule(draw: Union[Tensor, torch.Generator, None], index: Tensor,
             ages: Tensor, data_sizes: Tensor, gains: Tensor,
             net: wireless.NetworkState, cfg: wireless.WirelessConfig,
             sch: SchedulerConfig, staleness: Optional[Tensor] = None,
             payload_bits: Optional[Tensor] = None,
             reliability: Optional[Tensor] = None) -> ScheduleResult:
    """The round's decision, dispatched on ``sch.method`` (the public
    entry; :func:`schedule_impl` is its body).

    ``draw`` is the round's uniform draw that abs (tiebreak) and random
    (priority) rank on, shaped like ``index``: a tensor, or a
    ``torch.Generator`` to draw it from on ``index``'s device (only abs
    and random draw).  das and full read no draw; None leaves abs
    without its tiebreak.
    """
    sched_u = draw
    if isinstance(draw, torch.Generator):
        sched_u = None
        if sch.method in ("abs", "random"):
            sched_u = torch.rand(index.shape, generator=draw,
                                 device=index.device)
    return schedule_impl(sched_u, index, ages, data_sizes, gains, net, cfg,
                         sch, staleness, payload_bits, reliability)

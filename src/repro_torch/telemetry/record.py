"""Per-round telemetry frames.

Port of ``repro.telemetry.record``.  A *frame* is a flat ``dict[str,
Tensor]`` built inside a round; the drivers keep each round's frame on
the device and stack every leaf on a round axis at the end of the run
(after a batch's scenario axis: ``(S, R, ...)``).  The functions here
draw no randomness and feed nothing back into the round.

:func:`round_frame` is the one assembly point of the synchronous driver,
the event driver and the batch driver, so the recorded fields cannot
drift between them; :func:`event_frame` adds the event driver's.  Every
function takes ``(K,)`` rows or ``(S, K)`` lanes.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.core import bandwidth as bw
from repro_torch.core import scheduler as sched_lib

Tensor = torch.Tensor
Frame = Dict[str, Tensor]


def sub2_frame(result: "sched_lib.ScheduleResult", gains: Tensor, net,
               wcfg, sch: "sched_lib.SchedulerConfig",
               payload_bits: Optional[Tensor]) -> Frame:
    """Sub2's trace: the allocation, the DAS outer iterations, Eq. 15a at
    the solver's allocation (``sub2_obj``) and at the equal share over
    the admitted set (``sub2_obj_eq``), and ``sub2_gain = obj_eq - obj``,
    what the solve bought this round."""
    sel = result.selected
    alpha_eq = sel / torch.clamp_min(torch.sum(sel, dim=-1, keepdim=True),
                                     1.0)
    rho = sch.sub2.rho
    obj = bw.sub2_objective(result.alpha, sel, result.t_train, gains,
                            net.tx_power, wcfg, rho,
                            payload_bits=payload_bits)
    obj_eq = bw.sub2_objective(alpha_eq, sel, result.t_train, gains,
                               net.tx_power, wcfg, rho,
                               payload_bits=payload_bits)
    iters = result.iterations
    if not isinstance(iters, Tensor):   # one row: a host int
        iters = torch.full(sel.shape[:-1], iters, dtype=torch.int32,
                           device=sel.device)
    return {
        "alpha": result.alpha,
        "sub2_iters": iters,
        "sub2_obj": obj,
        "sub2_obj_eq": obj_eq,
        "sub2_gain": obj_eq - obj,
    }


def transport_frame(sel_eff: Tensor, result: "sched_lib.ScheduleResult",
                    energy: Tensor, payload_bits: Optional[Tensor],
                    wcfg) -> Frame:
    """Uplink accounting on the realized (post-cap) set: the payload
    (``wcfg.model_bits`` without a codec), the scheduler's upload time
    (its infinity for the unselected zeroed), the realized energy."""
    bits = torch.full_like(sel_eff, float(wcfg.model_bits)) \
        if payload_bits is None else payload_bits
    t_up = torch.where(torch.isinf(result.t_up),
                       torch.zeros_like(result.t_up), result.t_up)
    return {
        "payload_bits": bits * sel_eff,
        "t_up": t_up * sel_eff,
        "energy_up": energy,
    }


def fault_frame(draw, sel_eff: Tensor) -> Frame:
    """Fault events by type over the realized set, from the round's
    :class:`repro_torch.core.faults.FaultDraw`: an *outage* burned its
    whole retry budget, a *dropout* died before its first attempt, a
    *straggler* drew a compute multiplier above 1."""
    sel = sel_eff > 0.0
    return {
        "fault_outage": (sel & (draw.attempts > 0.0)
                         & (draw.success <= 0.0)).to(torch.float32),
        "fault_dropout": (sel & (draw.attempts <= 0.0)).to(torch.float32),
        "fault_straggler": (sel & (draw.compute_mult > 1.0))
        .to(torch.float32),
        "fault_attempts": draw.attempts * sel_eff,
    }


def round_frame(tel, *, result, admitted: Tensor, sel_eff: Tensor,
                ok: Tensor, energy: Tensor, payload_bits: Optional[Tensor],
                gains: Tensor, net, wcfg, sch, sched_u: Optional[Tensor],
                index: Tensor, ages: Tensor, staleness: Optional[Tensor],
                reliability: Optional[Tensor], draw,
                signals: Optional[Frame] = None) -> Frame:
    """One round's frame.

    ``admitted`` is the scheduler's selection before the dispatch cap,
    ``sel_eff`` the realized set, ``ok`` the uploads that landed;
    ``ages``, ``reliability`` and ``staleness`` the values the scheduler
    saw.  ``sched_u`` is the round's uniform draw (the reference reads
    its key instead).  ``draw`` is the round's fault draw, or None on a
    reliable edge (the fault group is recorded only when faults ran);
    ``signals`` the prebuilt signals group
    (:func:`repro_torch.telemetry.health.signals_frame`).
    """
    frame: Frame = {
        "admitted": admitted,
        "dispatched": sel_eff,
        "delivered": ok,
    }
    if tel.scores:
        frame.update(sched_lib.score_trace(
            sched_u, index, ages, sch, staleness=staleness,
            reliability=reliability))
        if staleness is not None:
            frame["staleness"] = staleness
    if tel.sub2:
        frame.update(sub2_frame(result, gains, net, wcfg, sch,
                                payload_bits))
    if tel.transport:
        frame.update(transport_frame(sel_eff, result, energy,
                                     payload_bits, wcfg))
    if tel.faults and draw is not None:
        frame.update(fault_frame(draw, sel_eff))
    if signals is not None:
        frame.update(signals)
    return frame


def event_frame(*, avail: Tensor, free: Tensor, in_flight: Tensor,
                buffer_fill: Tensor, flushed: Tensor, tau: Tensor,
                clock: Tensor, version: Tensor) -> Frame:
    """The event driver's extras: the availability gate, the pending
    mask at the end of the tick (``in_flight``), the buffer's fill and
    flush, each slot's model-version staleness at the flush, the clock
    and the model version after the tick."""
    return {
        "avail": avail,
        "free": free,
        "in_flight": in_flight,
        "buffer_fill": buffer_fill.to(torch.float32),
        "flushed": flushed.to(torch.float32),
        "staleness_tau": tau,
        "clock": clock,
        "model_version": version.to(torch.int32),
    }


def stack_frames(frames, dim: int = 0) -> Frame:
    """Per-round frames stacked on a round axis at ``dim`` (1 for a
    batch's ``(S, R, ...)``)."""
    return {name: torch.stack([f[name] for f in frames], dim=dim)
            for name in frames[0]}


__all__ = ["round_frame", "event_frame", "sub2_frame", "transport_frame",
           "fault_frame", "stack_frames"]

"""Event-driven asynchronous FEEL.

Port of ``repro.core.events``.  The synchronous rounds advance the world
one round at a time; here the simulation runs over *events*
(scheduling ticks):

1. **Availability** — a per-device availability process gates which
   devices the scheduler may admit this tick: ``always`` (the
   synchronous limit), ``churn`` (i.i.d. Bernoulli presence) and
   ``diurnal`` (a day/night activity wave with one shared phase and
   per-device jitter, drawn once per run).  Processes register by name
   (:func:`register_availability`).  Randomness is an input: each
   process splits into ``init_draw``/``draw`` (its raw random numbers,
   from a ``torch.Generator``) and the deterministic ``init``/``sample``,
   so a test can feed draws the reference made with ``jax.random``.
2. **Dispatch** — free (available, no update in flight) devices are
   ranked and admitted by the synchronous round's own scheduling stack,
   dispatch cap, fault pricing and codec payload bits.  Admitted devices
   train at once on the current global model; their flattened updates
   wait in a per-device pending slot with an arrival time ``now +
   t_train + t_up`` (retry-stretched under faults) and the model version
   they trained from.
3. **Buffered aggregation** — uploads whose arrival time has passed
   join the server's buffer; once it holds ``buffer_size`` of them the
   server flushes ``g' = g + sum_k w_k s(tau_k) (w^k - g)``, with
   ``s(tau) = (1 + tau)^-gamma`` discounting an update by the model
   versions since its dispatch (``staleness_decay`` is gamma).  The flush
   runs through the ``fedavg_agg_stale`` kernel with ``use_kernel_agg``.

The tick is a Python loop over the round helpers of
:mod:`repro_torch.core.federated`; the flush decision, the clock, the
model version and the pending slots stay on the device (the flush is
computed every tick and selected with ``torch.where``), so the loop adds
no host sync.  The same loop (:func:`drive_events`) runs a batch of S
scenarios for ``federated.run_federated_batch``: every tensor then
carries a leading ``(S,)`` axis, each scenario's clock, version, buffer
and flush are its own, and each kernel launches once a tick for all of
them.

**Synchronous limit**: with ``EventConfig()`` — every device always
available, whole-cohort ticks (``tick_horizon=0``), no staleness decay,
``buffer_size`` 1 — every upload lands and flushes within its own tick
at staleness 0, and the run equals the synchronous driver's bit for bit
(the fault-aware and compressed round bodies, whose aggregation is in
update form).  The arrival times use :func:`faults.apply_faults`'s
round-time expressions and the flush weights the synchronous
normalisation, op for op.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Protocol, \
    runtime_checkable

import torch

from repro_torch import telemetry as telemetry_lib
from repro_torch.core import compression, faults, wireless
from repro_torch.kernels import fedavg_agg as fedavg_kernel
from repro_torch.telemetry import health as telemetry_health
from repro_torch.telemetry import record as telemetry_record

Tensor = torch.Tensor
Draw = Dict[str, Tensor]
Params = Dict[str, Tensor]


@dataclasses.dataclass(frozen=True)
class EventConfig:
    """Event-driver knobs (rides on ``FLConfig.events``).

    ``tick_horizon`` is the wall-clock length of one tick in seconds:
    ``0.0`` means whole-cohort ticks (the clock advances by the
    dispatched cohort's makespan, so every upload lands within its own
    tick).  A positive horizon fixes the tick length: slow devices stay
    in flight across ticks and their updates arrive stale.
    ``num_events`` is the run's length (``None``: ``num_rounds``).
    """

    availability: str = "always"   # availability-process registry name
    avail_prob: float = 0.9        # churn: per-tick presence probability
    period: float = 24.0           # diurnal: ticks per activity cycle
    phase_spread: float = 0.5      # diurnal: per-device phase jitter (rad)
    duty: float = 0.5              # diurnal: mean availability fraction
    buffer_size: int = 1           # arrived updates needed to flush
    staleness_decay: float = 0.0   # gamma of the (1+tau)^-gamma weight
    tick_horizon: float = 0.0      # 0 = whole-cohort ticks (sync limit)
    num_events: Optional[int] = None

    def __post_init__(self):
        if self.buffer_size < 1:
            raise ValueError(f"buffer_size must be >= 1, got "
                             f"{self.buffer_size}")
        if self.tick_horizon < 0.0:
            raise ValueError(f"tick_horizon must be >= 0, got "
                             f"{self.tick_horizon}")
        if self.num_events is not None and self.num_events < 1:
            raise ValueError(f"num_events must be >= 1, got "
                             f"{self.num_events}")


# ---------------------------------------------------------------------------
# Availability processes
# ---------------------------------------------------------------------------

@runtime_checkable
class AvailabilityProcess(Protocol):
    """Per-device availability gate of the event driver.  ``stochastic``
    says whether ``init_draw``/``draw`` draw anything."""

    stochastic: bool

    def init_draw(self, gen: torch.Generator, k: int, cfg: EventConfig,
                  device: torch.device) -> Draw:
        """The raw random numbers :meth:`init` consumes."""
        ...

    def init(self, draw: Draw, k: int, cfg: EventConfig,
             device: torch.device, lead: tuple = ()) -> Tensor:
        """Once-per-run ``lead + (K,)`` state (diurnal: the device
        phases); ``lead`` is a batch's scenario axis."""
        ...

    def draw(self, gen: torch.Generator, k: int, cfg: EventConfig,
             device: torch.device) -> Draw:
        """One tick's raw random numbers."""
        ...

    def sample(self, draw: Draw, state: Tensor, tick: int,
               cfg: EventConfig) -> Tensor:
        """{0, 1} availability mask of one tick, shaped as ``state``."""
        ...


@dataclasses.dataclass(frozen=True)
class AlwaysOn:
    """Every device available every tick — the synchronous limit."""

    stochastic = False

    def init_draw(self, gen, k, cfg, device):
        return {}

    def init(self, draw, k, cfg, device, lead=()):
        return torch.zeros(tuple(lead) + (k,), dtype=torch.float32,
                           device=device)

    def draw(self, gen, k, cfg, device):
        return {}

    def sample(self, draw, state, tick, cfg):
        return torch.ones_like(state)


def _uniform_draw(gen: torch.Generator, k: int, cfg: EventConfig,
                  device: torch.device) -> Draw:
    return {"u": torch.rand((k,), generator=gen, device=device)}


@dataclasses.dataclass(frozen=True)
class Churn:
    """I.i.d. Bernoulli presence: each device is reachable with
    probability ``avail_prob`` each tick."""

    stochastic = True

    def init_draw(self, gen, k, cfg, device):
        return {}

    def init(self, draw, k, cfg, device, lead=()):
        return torch.zeros(tuple(lead) + (k,), dtype=torch.float32,
                           device=device)

    draw = staticmethod(_uniform_draw)

    def sample(self, draw, state, tick, cfg):
        return (draw["u"] < cfg.avail_prob).to(torch.float32)


@dataclasses.dataclass(frozen=True)
class Diurnal:
    """Correlated day/night activity: one shared cycle phase per run plus
    Gaussian per-device jitter (``phase_spread``), so the fleet wakes and
    sleeps together.  The per-tick availability probability is the
    sinusoidal activity level rescaled so its cycle mean is ``duty``
    (exact for ``duty <= 0.5``; clipped above)."""

    stochastic = True

    def init_draw(self, gen, k, cfg, device):
        return {"shared_u": torch.rand((), generator=gen, device=device),
                "z": torch.randn((k,), generator=gen, device=device)}

    def init(self, draw, k, cfg, device, lead=()):
        # A batch's draw holds (S,) shared phases beside (S, K) jitter:
        # each scenario's phase goes with its own row.
        shared = draw["shared_u"] * (2.0 * math.pi)
        return shared[..., None] + cfg.phase_spread * draw["z"]

    draw = staticmethod(_uniform_draw)

    def probability(self, state: Tensor, tick: int,
                    cfg: EventConfig) -> Tensor:
        """Availability probability at ``tick``, shaped as ``state``
        (f32 throughout)."""
        t = torch.full((), float(tick), dtype=torch.float32,
                       device=state.device)
        level = 0.5 * (1.0 + torch.sin(
            (2.0 * math.pi) * t / cfg.period + state))
        return torch.clamp(2.0 * cfg.duty * level, 0.0, 1.0)

    def sample(self, draw, state, tick, cfg):
        return (draw["u"] < self.probability(state, tick, cfg)).to(
            torch.float32)


_PROCESSES: Dict[str, Callable[[], AvailabilityProcess]] = {}


def register_availability(name: str,
                          factory: Callable[[], AvailabilityProcess],
                          overwrite: bool = False) -> None:
    """Register an availability-process factory (zero-arg -> process)."""
    if name in _PROCESSES and not overwrite:
        raise ValueError(f"availability process {name!r} already "
                         f"registered")
    _PROCESSES[name] = factory


def availability_names() -> tuple[str, ...]:
    return tuple(sorted(_PROCESSES))


def get_availability(name: str) -> AvailabilityProcess:
    """Build the named availability process."""
    try:
        factory = _PROCESSES[name]
    except KeyError:
        raise ValueError(
            f"unknown availability process {name!r}; registered: "
            f"{availability_names()}") from None
    return factory()


register_availability("always", AlwaysOn)
register_availability("churn", Churn)
register_availability("diurnal", Diurnal)


# ---------------------------------------------------------------------------
# Staleness-weighted buffered flush
# ---------------------------------------------------------------------------

def staleness_multiplier(staleness: Tensor, decay: float) -> Tensor:
    """FedBuff-style update discount ``(1 + tau)^-gamma``.

    ``decay == 0`` returns exact ones (no pow), which keeps the
    zero-decay flush weights bitwise the synchronous FedAvg weights."""
    if decay == 0.0:
        return torch.ones_like(staleness)
    return torch.pow(1.0 + staleness, -decay)


def buffered_flush(params: Params, rows: Tensor, weights: Tensor,
                   arrived: Tensor, stale_mult: Tensor,
                   use_kernel: bool = False) -> Params:
    """One buffer flush in update form over the (K, P) flattened rows:
    ``g' = g + sum_k (w_k * m_k * s_k) row_k``, ``weights`` normalised by
    the caller, ``arrived`` the buffer-membership mask and
    ``stale_mult`` the staleness discount.  A batch passes ``(S, K, P)``
    rows, ``(S, K)`` weights and ``(S, ...)`` params: one flush a lane.

    The kernel path launches ``fedavg_agg_stale``.  The other path is
    the fault-aware round's per-leaf update (``federated._masked_update``)
    on the rows cut back into leaves, the same arithmetic on the same
    shapes, so the synchronous limit holds bit for bit on it too.
    """
    from repro_torch.core import federated as fed
    if use_kernel:
        fed._uniform_dtype(params, "kernel FedAvg path")
        return fed._apply_flat(params, fedavg_kernel.fedavg_agg_stale(
            rows, weights.contiguous(), arrived.contiguous(),
            stale_mult.contiguous()))
    lead = weights.shape[:-1]
    deltas, offset = {}, 0
    for n, p in params.items():
        leaf = p.shape[len(lead):]
        size = math.prod(leaf)
        deltas[n] = rows[..., offset:offset + size].reshape(
            rows.shape[:-1] + leaf).contiguous()
        offset += size
    return fed._masked_update(params, deltas, weights * arrived * stale_mult)


# ---------------------------------------------------------------------------
# The event loop
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class EventLog:
    """What the server's buffer did each event, stacked on (E,): whether
    it flushed, how many updates had arrived, the mean model-version
    staleness of the updates a flush applied (0 without a flush), the
    simulated clock after the tick and the model version.  A batch's log
    holds one such list per scenario in each field."""

    flushed: List[bool]
    buffer_fill: List[int]
    tau_mean: List[float]
    clock: List[float]
    version: List[int]


def run_events(*, model, data, net, wcfg, scfg, fcfg, seed=0,
               draws=None, eval_every: int = 1, device=None):
    """Run ``sim_length(fcfg)`` events -> ``(params, records, EventLog)``.

    The arguments are :func:`federated.run_federated`'s, which calls this
    when ``fcfg.events`` is set and drops the log.  One record per event:
    ``round_time`` is the clock the tick consumed, ``n_selected`` the
    devices dispatched, ``n_success`` the uploads that will land.  With
    ``fcfg.telemetry`` the stacked frames follow the log.

    ``seed`` a sequence of S seeds over the stacked ``net`` runs a batch,
    as :func:`federated.run_federated_batch` does: ``(params (S, ...),
    RoundMetrics (S, E, ...), EventLog of S lists[, frames])``.
    """
    from repro_torch.core import federated as fed
    if fcfg.events is None:
        raise ValueError("FLConfig.events is None — use the synchronous "
                         "rounds (federated.run_federated)")
    get_availability(fcfg.events.availability)   # an unknown name raises
    run = fed._Run(model, data, net, wcfg, scfg, fcfg, seed, draws,
                   eval_every, device)
    params, metrics, log, frames = drive_events(run)
    out = (params, metrics if run.lead else fed.metrics_to_records(metrics),
           _event_log(log, run.lead))
    return out if frames is None else out + (frames,)


def _event_log(log: List[tuple], lead: tuple) -> EventLog:
    """The buffer's per-event tensors on the host, in one copy."""
    host = torch.stack([torch.stack([t.to(torch.float32) for t in e])
                        for e in log]).cpu()            # (E, 5, *lead)
    fields = host.reshape(host.shape[:2] + (-1,)).permute(2, 1, 0).tolist()

    def lane(f):
        flushed, fill, tau, clock, version = f
        return ([bool(x) for x in flushed], [int(x) for x in fill], tau,
                clock, [int(x) for x in version])
    lanes = [lane(f) for f in fields]
    if not lead:
        return EventLog(*lanes[0])
    return EventLog(*(list(col) for col in zip(*lanes)))


def drive_events(run):
    """The event loop of a run built by ``federated._Run``, one scenario
    or a batch (every tensor with ``run.lead`` in front) -> ``(params,
    RoundMetrics, log rows, frames or None)``, everything on the run's
    device.  Scenario ``s``'s clock, model version, buffer and flush are
    its own; the flush launches ``fedavg_agg_stale`` once for all
    scenarios."""
    from repro_torch.core import federated as fed
    fcfg = run.fcfg
    ecfg = fcfg.events
    proc = get_availability(ecfg.availability)
    stream, comp, flt, cdt = fcfg.stream, fcfg.compression, run.flt, run.cdt
    data, dev, k, lead = run.data, run.dev, run.k, run.lead
    gamma = ecfg.staleness_decay
    horizon = float(ecfg.tick_horizon)
    avail_state = proc.init(run.draws.avail_init, k, ecfg, dev, lead)
    params, st, residual, rel = run.params, run.st, run.residual, run.rel
    sig_fn, sigst = run.sig_fn, run.signal_init()
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    ages = torch.zeros(lead + (k,), **i32)
    clock = torch.zeros(lead, **f32)
    version = torch.zeros(lead, **i32)
    pend_rows = torch.zeros(lead + (k, run.n_coords),
                            dtype=cdt or torch.float32, device=dev)
    pend_mask = torch.zeros(lead + (k,), **f32)
    pend_size = torch.zeros(lead + (k,), **f32)
    pend_birth = torch.zeros(lead + (k,), **i32)
    pend_arrival = torch.zeros(lead + (k,), **f32)
    rows: List[tuple] = []
    log: List[tuple] = []
    frames: List[Dict[str, Tensor]] = []
    for t in range(run.length):
        if cdt is not None:
            pend_rows = pend_rows.to(torch.float32)
        index, sizes_r, stale, hists_r, st = run.index(t, st, ages)
        gains = run.draws.gains[t]
        # Availability x in-flight gate: busy devices (update pending or
        # buffered) cannot be dispatched again; unavailable ones rank at
        # zero priority and are masked out of the admitted set.  In the
        # synchronous limit both masks are all ones.
        avail = proc.sample(fed._round_of(run.draws.avail, t)
                            if proc.stochastic else {}, avail_state, t,
                            ecfg)
        free = avail * (1.0 - pend_mask)
        index_g = torch.where(free > 0.0, index, torch.zeros_like(index))
        result, payload = run.schedule(t, index_g, ages, sizes_r, gains,
                                       stale, rel)
        admitted = result.selected * free
        didx, selected, n_dropped = run.dispatch(admitted)
        ok, energy, round_time, draw = run.realize(t, result, selected,
                                                   gains, payload)
        # Each device's completion time, by the expressions of the
        # synchronous round time (faults.apply_faults, the scheduler's
        # round time), so the makespan and the arrivals agree bitwise.
        if flt is None:
            t_up = torch.where(torch.isinf(result.t_up),
                               torch.zeros_like(result.t_up), result.t_up)
            t_done = torch.where(selected > 0.0, result.t_train + t_up,
                                 torch.zeros_like(t_up))
        else:
            t_up = wireless.upload_time(
                result.alpha, gains, run.net.tx_power, run.wcfg, payload,
                airtime_mult=faults.time_mult(draw.attempts, flt))
            t_up = torch.where((selected > 0.0) & torch.isfinite(t_up),
                               t_up, torch.zeros_like(t_up))
            t_done = torch.where(
                selected > 0.0, result.t_train * draw.compute_mult + t_up,
                torch.zeros_like(t_up))
        # Local training happens at dispatch, on the current model; the
        # channel delay only decides when the server sees the update.
        client_params, _ = fed._masked_local_train(
            run.trainer, run.max_steps, fcfg, params, data.images,
            data.labels, data.mask, sizes_r, selected,
            run.draws.batch_idx[t], didx)
        updates = fed._flat_updates(params, client_params, lead)
        if comp is None:
            upd_rows = updates
        else:
            if cdt is not None:
                residual = residual.to(torch.float32)
            with telemetry_lib.phase_scope("aggregate"):
                upd_rows, residual = compression.apply_codec(
                    run.codec, updates, residual, selected, run.noise(t),
                    comp, gains, index_g,
                    success=None if draw is None else draw.success)
            if cdt is not None:
                residual = residual.to(cdt)
        # The signals group observes the raw updates against the model
        # the devices trained from, as the synchronous rounds do.
        obs = None
        if sig_fn is not None:
            obs = sig_fn(params, client_params, updates)
            sigst = telemetry_health.signal_update(sigst, ok, *obs, energy)
        # Enqueue the uploads that will land (a failed upload never
        # arrives; its energy is charged and, compressed, its update is
        # already folded back into the residual).
        enq = ok > 0.0
        pend_rows = torch.where(enq[..., None], upd_rows, pend_rows)
        pend_mask = torch.where(enq, torch.ones_like(pend_mask), pend_mask)
        pend_size = torch.where(enq, sizes_r.to(torch.float32), pend_size)
        pend_birth = torch.where(enq, fed._lane_flag(version, enq),
                                 pend_birth)
        pend_arrival = torch.where(enq, fed._lane_flag(clock, enq) + t_done,
                                   pend_arrival)
        dt = round_time if horizon <= 0.0 else torch.full(lead, horizon,
                                                          **f32)
        clock = clock + dt
        arrived = pend_mask * (pend_arrival <= fed._lane_flag(
            clock, pend_arrival)).to(torch.float32)
        buf_n = torch.sum(arrived, dim=-1)
        do_flush = buf_n >= float(ecfg.buffer_size)
        # Flush weights: FedAvg sizes over the arrived set, times the
        # staleness discount; at gamma = 0 the discount leaves the
        # program and this is the synchronous normalisation bitwise.
        tau = (fed._lane_flag(version, pend_birth)
               - pend_birth).to(torch.float32)
        s_mult = staleness_multiplier(tau, gamma)
        base = pend_size * arrived
        num = base * s_mult if gamma != 0.0 else base
        denom = torch.clamp_min(torch.sum(num, dim=-1, keepdim=True), 1.0)
        with telemetry_lib.phase_scope("aggregate"):
            if comp is None:
                # The kernel multiplies the discount in per row, so only
                # the normaliser is folded here.
                flushed = buffered_flush(params, pend_rows, base / denom,
                                         arrived, s_mult,
                                         fcfg.use_kernel_agg)
            else:
                # The compressed synchronous round's product, so the
                # compressed synchronous limit is bitwise too.
                flushed = fed._apply_flat(
                    params, fed._lane_dot(num / denom, pend_rows))
            params = {n: torch.where(fed._lane_flag(do_flush, p),
                                     flushed[n], p)
                      for n, p in params.items()}
        cleared = arrived * fed._lane_flag(do_flush, arrived).to(
            torch.float32)
        version = version + do_flush.to(torch.int32)
        # Applied updates leave the buffer; arrivals not yet flushed stay
        # (and keep their devices busy) until the buffer fills.
        pend_mask = pend_mask * (1.0 - cleared)
        if run.tel is not None:
            frame = run.frame(t, result, admitted, selected, ok, energy,
                              payload, gains, index_g, ages, stale, rel,
                              draw, sigst, obs)
            if run.tel.events:
                frame.update(telemetry_record.event_frame(
                    avail=avail, free=free, in_flight=pend_mask,
                    buffer_fill=buf_n, flushed=do_flush, tau=tau,
                    clock=clock, version=version))
            frames.append(frame)
        ages, rel = run.advance(ages, rel, selected, ok)
        if stream is not None:
            st = fed._stream_advance(st, hists_r, stale, ok, cdt)
        if cdt is not None:
            pend_rows = pend_rows.to(cdt)
        rows.append((run.evaluate(t, params),
                     torch.sum(selected, dim=-1).to(torch.int32), dt,
                     energy, torch.sum(energy, dim=-1), selected,
                     run.iterations(result),
                     torch.sum(ok, dim=-1).to(torch.int32), n_dropped))
        log.append((do_flush, buf_n,
                    torch.sum(tau * cleared, dim=-1)
                    / torch.clamp_min(torch.sum(cleared, dim=-1), 1.0),
                    clock, version))
    return (params, fed.stack_metrics(rows, dim=len(lead)), log,
            run.stack_frames(frames))


__all__ = ["EventConfig", "AvailabilityProcess", "AlwaysOn", "Churn",
           "Diurnal", "register_availability", "availability_names",
           "get_availability", "staleness_multiplier", "buffered_flush",
           "EventLog", "run_events", "drive_events"]

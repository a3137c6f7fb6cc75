"""Streaming-data FEEL subsystem: per-device data that changes every round.

Port of ``repro.core.streaming``.  The paper computes the diversity index
once from a frozen partition, but the data a device holds "depends on the
local environment and usage pattern".  Here per-device class counts and
sizes evolve round by round, and the scheduler re-ranks on the refreshed
statistics.

* :class:`StreamConfig` — the reference's knobs and defaults, carried on
  ``FLConfig.stream``.
* :class:`StreamState` — the per-round state: the live ``(K, C)``
  class-count matrix, the staleness signal, the previous round's
  delivered set (driver-owned), and the arrival process's own fields.
* the **arrival processes**, registered by name.  Randomness is an input:
  each process splits into ``init_draw``/``draw`` — the raw random
  numbers (rate uniforms, Poisson counts, Bernoulli redraws, class
  draws), from a ``torch.Generator`` — and the deterministic
  ``init(draw, hists0, cfg)`` / ``sample(draw, state, cfg)``, so a test
  can feed draws the reference made with ``jax.random``.  ``draw`` reads
  only the process-owned fields and the round counter.
* :func:`refresh` — the fused count-delta accumulation -> diversity
  stats -> staleness decay (the ``stream_update`` kernel).

The state of S scenarios stacks along a leading axis: ``(S, K, C)``
counts with ``(S, K)`` rows.  Every process's ``init``, ``draw`` and
``sample`` work on either shape, and :func:`refresh` hands the whole
stack to one ``stream_update`` launch.
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Callable, Dict, Optional, Protocol, Tuple, \
    runtime_checkable

import numpy as np
import torch

from repro_torch.data import partition as partition_lib
from repro_torch.data import synthetic
from repro_torch.kernels import stream_update as stream_kernel

Tensor = torch.Tensor
Draw = Dict[str, Tensor]


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    """Streaming knobs (rides on ``FLConfig.stream``)."""

    process: str = "poisson"      # arrival-process registry name
    rate: float = 20.0            # mean arrivals / device / round
    rate_spread: float = 0.5      # per-device rate heterogeneity (+- frac)
    mix_uniform: float = 0.1      # affinity floor (partition.arrival_affinity)
    burst_prob: float = 0.15      # drift: per-round class re-draw prob
    evict_frac: float = 0.05      # evict: buffer fraction dropped / round
    shift_period: float = 8.0     # shift: rounds per class-wave step
    shift_sharpness: float = 2.0  # shift: wave concentration (kappa)
    staleness_decay: float = 0.8  # lambda: backlog decay per round
    size_cap: float = 0.0         # per-device count cap (0: buffer capacity)


@dataclasses.dataclass
class StreamState:
    """Per-round streaming state.

    ``hists``/``staleness``/``selected_prev`` are driver-owned (advanced
    by :func:`refresh` and the round's delivered set); ``affinity``,
    ``rates``, ``drift_class`` and ``bank`` belong to the arrival
    process.  ``round`` counts the rounds elapsed, on the host.
    """

    hists: Tensor          # (…, K, C) live class-count matrix
    staleness: Tensor      # (…, K)   decayed not-yet-trained-on arrival mass
    selected_prev: Tensor  # (…, K)   previous round's delivered set {0,1}
    round: int             # rounds elapsed
    affinity: Tensor       # (…, K, C) arrival class distribution
    rates: Tensor          # (…, K)   mean arrivals / round
    drift_class: Tensor    # (…, K)   int64 current drift class
    # (…, R, K, C) trace replayed (Trace, TraceBank only)
    bank: Optional[Tensor] = None


def base_state(hists0: Tensor, affinity: Optional[Tensor] = None,
               rates: Optional[Tensor] = None,
               drift_class: Optional[Tensor] = None) -> StreamState:
    """Fresh :class:`StreamState` around the round-0 histograms; process
    fields not given take inert defaults."""
    hists0 = hists0.to(torch.float32)
    zeros_k = torch.zeros(hists0.shape[:-1], dtype=torch.float32,
                          device=hists0.device)
    if affinity is None:
        affinity = torch.full_like(hists0, 1.0 / hists0.shape[-1])
    if rates is None:
        rates = zeros_k
    if drift_class is None:
        drift_class = torch.zeros(hists0.shape[:-1], dtype=torch.int64,
                                  device=hists0.device)
    return StreamState(hists=hists0, staleness=zeros_k,
                       selected_prev=zeros_k.clone(), round=0,
                       affinity=affinity, rates=rates,
                       drift_class=drift_class)


@runtime_checkable
class ArrivalProcess(Protocol):
    """The arrival-process protocol the FEEL driver consumes."""

    def init_draw(self, gen: torch.Generator, num_devices: int,
                  cfg: StreamConfig, device: torch.device) -> Draw:
        """The raw random numbers :meth:`init` consumes."""
        ...

    def init(self, draw: Draw, hists0: Tensor,
             cfg: StreamConfig) -> StreamState:
        """The round-0 state from the initial ``(K, C)`` histograms."""
        ...

    def draw(self, gen: torch.Generator, state: StreamState,
             cfg: StreamConfig) -> Draw:
        """One round's raw random numbers (reads process fields only)."""
        ...

    def sample(self, draw: Draw, state: StreamState, cfg: StreamConfig
               ) -> Tuple[Tensor, Tensor, StreamState]:
        """One round's ``(K, C)`` count deltas, the ``(K,)`` arrival mass
        and the updated process fields.  Leaves the driver-owned fields
        alone."""
        ...


def _rate_draw(gen: torch.Generator, num_devices: int,
               device: torch.device) -> Draw:
    return {"u": torch.rand((num_devices,), generator=gen, device=device)}


def _rates(draw: Draw, cfg: StreamConfig) -> Tensor:
    return synthetic.sample_arrival_rates(draw["u"], cfg.rate,
                                          cfg.rate_spread)


def _poisson(gen: torch.Generator, lam: Tensor) -> Tensor:
    return torch.poisson(lam, generator=gen)


@dataclasses.dataclass(frozen=True)
class Static:
    """Zero deltas: streaming plumbing on, data frozen."""

    def init_draw(self, gen, num_devices, cfg, device):
        return {}

    def init(self, draw, hists0, cfg):
        return base_state(hists0)

    def draw(self, gen, state, cfg):
        return {}

    def sample(self, draw, state, cfg):
        return (torch.zeros_like(state.hists),
                torch.zeros_like(state.rates), state)


@dataclasses.dataclass(frozen=True)
class Poisson:
    """Per-class Poisson arrivals along each device's shard affinity."""

    def init_draw(self, gen, num_devices, cfg, device):
        return _rate_draw(gen, num_devices, device)

    def init(self, draw, hists0, cfg):
        return base_state(hists0, rates=_rates(draw, cfg),
                          affinity=partition_lib.arrival_affinity(
                              hists0, cfg.mix_uniform))

    def draw(self, gen, state, cfg):
        return {"counts": _poisson(gen, state.rates[..., None]
                                   * state.affinity)}

    def sample(self, draw, state, cfg):
        deltas = draw["counts"].to(torch.float32)
        return deltas, torch.sum(deltas, dim=-1), state


@dataclasses.dataclass(frozen=True)
class Drift:
    """Bursty label drift: arrivals pile onto one per-device class that
    re-draws uniformly with probability ``burst_prob`` each round."""

    def init_draw(self, gen, num_devices, cfg, device):
        return _rate_draw(gen, num_devices, device)

    def init(self, draw, hists0, cfg):
        return base_state(hists0, rates=_rates(draw, cfg),
                          drift_class=torch.argmax(hists0, dim=-1))

    def draw(self, gen, state, cfg):
        k = state.drift_class.shape
        dev = state.rates.device
        p = torch.full(k, cfg.burst_prob, device=dev)
        return {"redraw": torch.bernoulli(p, generator=gen) > 0.0,
                "fresh": torch.randint(0, state.affinity.shape[-1], k,
                                       generator=gen, device=dev),
                "counts": _poisson(gen, state.rates)}

    def sample(self, draw, state, cfg):
        num_classes = state.hists.shape[-1]
        drift_class = torch.where(draw["redraw"].to(torch.bool),
                                  draw["fresh"].to(torch.int64),
                                  state.drift_class)
        counts = draw["counts"].to(torch.float32)
        onehot = torch.nn.functional.one_hot(drift_class, num_classes)
        deltas = counts[..., None] * onehot.to(torch.float32)
        return deltas, counts, dataclasses.replace(state,
                                                   drift_class=drift_class)


@dataclasses.dataclass(frozen=True)
class Shift:
    """Global class-distribution shift: a von-Mises-style wave rotates
    through label space, one class every ``shift_period`` rounds."""

    def init_draw(self, gen, num_devices, cfg, device):
        return _rate_draw(gen, num_devices, device)

    def init(self, draw, hists0, cfg):
        return base_state(hists0, rates=_rates(draw, cfg))

    @staticmethod
    def intensity(state: StreamState, cfg: StreamConfig) -> Tensor:
        """The round's ``(K, C)`` Poisson means ``rates x wave``."""
        num_classes = state.hists.shape[-1]
        classes = torch.arange(num_classes, dtype=torch.float32,
                               device=state.rates.device)
        # f32 on the host, as the reference divides its int32 counter.
        centre = float(np.float32(state.round) / np.float32(cfg.shift_period))
        phase = 2.0 * math.pi * (classes - centre) / num_classes
        wave = torch.softmax(cfg.shift_sharpness * torch.cos(phase), dim=-1)
        return state.rates[..., None] * wave

    def draw(self, gen, state, cfg):
        return {"counts": _poisson(gen, self.intensity(state, cfg))}

    def sample(self, draw, state, cfg):
        deltas = draw["counts"].to(torch.float32)
        return deltas, torch.sum(deltas, dim=-1), state


@dataclasses.dataclass(frozen=True)
class Evict:
    """Poisson arrivals + proportional buffer eviction of ``evict_frac``
    of the held counts each round."""

    def init_draw(self, gen, num_devices, cfg, device):
        return _rate_draw(gen, num_devices, device)

    def init(self, draw, hists0, cfg):
        return Poisson().init(draw, hists0, cfg)

    def draw(self, gen, state, cfg):
        return {"arrived": _poisson(gen, state.rates[..., None]
                                    * state.affinity)}

    def sample(self, draw, state, cfg):
        arrived = draw["arrived"].to(torch.float32)
        deltas = arrived - cfg.evict_frac * state.hists
        # The arrival mass is the raw arrivals, not the positive net
        # deltas: eviction must not starve the staleness signal.
        return deltas, torch.sum(arrived, dim=-1), state


def _replay(d: Tensor, state: StreamState) -> Tuple[Tensor, Tensor]:
    """Round ``round % R`` of the ``(…, R, K, C)`` trace, as the state's
    ``(…, K, C)`` deltas (one shared trace fills every scenario)."""
    row = torch.broadcast_to(d[..., state.round % d.shape[-3], :, :],
                             state.hists.shape)
    return row, torch.sum(torch.clamp_min(row, 0.0), dim=-1)


@dataclasses.dataclass(frozen=True)
class Trace:
    """Replay per-round count deltas from a user-supplied ``(R, K, C)``
    array; round ``r`` takes row ``r % R``.  Register with data::

        streaming.register_process(
            "trace", lambda: streaming.Trace(deltas), overwrite=True)

    The built-in ``"trace"`` registration has no data and raises this
    recipe.
    """

    deltas: object = None        # (R, K, C) array-like

    def _array(self, device: torch.device) -> Tensor:
        if self.deltas is None:
            raise ValueError(
                "trace process has no data — register your trace first: "
                "streaming.register_process('trace', lambda: "
                "streaming.Trace(deltas), overwrite=True) with a "
                "(rounds, K, C) delta array")
        d = torch.as_tensor(np.asarray(self.deltas, np.float32),
                            device=device)
        if d.dim() != 3:
            raise ValueError(f"trace deltas must be (R, K, C), got shape "
                             f"{tuple(d.shape)}")
        return d

    def init_draw(self, gen, num_devices, cfg, device):
        return {}

    def init(self, draw, hists0, cfg):
        d = self._array(hists0.device)
        if d.shape[-2:] != hists0.shape[-2:]:
            raise ValueError(
                f"trace deltas {tuple(d.shape)} do not match the (K, C) "
                f"device histograms {tuple(hists0.shape)}")
        return dataclasses.replace(base_state(hists0), bank=d)

    def draw(self, gen, state, cfg):
        return {}

    def sample(self, draw, state, cfg):
        row, arrivals = _replay(state.bank, state)
        return row, arrivals, state


@dataclasses.dataclass(frozen=True)
class TraceBank:
    """Replay from a bank of traces: one ``(R, K, C)`` trace per run,
    drawn uniformly at ``init`` from an ``(S_bank, R, K, C)`` stack (e.g.
    :func:`trace_bank` over per-day usage logs).  Register with data::

        streaming.register_process(
            "trace_bank", lambda: streaming.TraceBank(bank),
            overwrite=True)

    The built-in ``"trace_bank"`` registration has no data and raises
    this recipe.
    """

    bank: object = None          # (S_bank, R, K, C) array-like

    def _array(self, device: torch.device) -> Tensor:
        if self.bank is None:
            raise ValueError(
                "trace_bank process has no data — register your bank "
                "first: streaming.register_process('trace_bank', "
                "lambda: streaming.TraceBank(bank), overwrite=True) "
                "with an (S_bank, rounds, K, C) delta stack (see "
                "streaming.trace_bank / usage_log_to_deltas)")
        b = torch.as_tensor(np.asarray(self.bank, np.float32),
                            device=device)
        if b.dim() != 4:
            raise ValueError(f"trace bank must be (S_bank, R, K, C), got "
                             f"shape {tuple(b.shape)}")
        return b

    def init_draw(self, gen, num_devices, cfg, device):
        n = self._array(torch.device("cpu")).shape[0]
        return {"row": torch.randint(0, n, (), generator=gen,
                                     device=device)}

    def init(self, draw, hists0, cfg):
        b = self._array(hists0.device)
        if b.shape[-2:] != hists0.shape[-2:]:
            raise ValueError(
                f"trace bank {tuple(b.shape)} does not match the (K, C) "
                f"device histograms {tuple(hists0.shape)}")
        # A () row picks one trace, an (S,) row one per scenario.
        return dataclasses.replace(base_state(hists0),
                                   bank=b[draw["row"].long()])

    def draw(self, gen, state, cfg):
        return {}

    def sample(self, draw, state, cfg):
        row, arrivals = _replay(state.bank, state)
        return row, arrivals, state


def usage_log_to_deltas(records, num_rounds: int, num_devices: int,
                        num_classes: int, t_start: Optional[float] = None,
                        t_end: Optional[float] = None) -> np.ndarray:
    """Bucket a usage log into the ``(R, K, C)`` delta array the
    ``trace`` / ``trace_bank`` processes replay.

    ``records`` are usage events — JSONL strings or decoded dicts — with
    a timestamp ``"t"``, a device id ``"device"``, a class ``"class"`` and
    an optional signed ``"count"`` (default 1; negative = eviction).  The
    span ``[t_start, t_end)`` (default: the log's own extent, closed at
    its right edge) is cut into ``num_rounds`` equal windows; events
    outside the span or the device/class range are dropped.  Host-side
    numpy, run once at set-up.
    """
    parsed = []
    for rec in records:
        if isinstance(rec, (str, bytes)):
            rec = rec.strip()
            if not rec:
                continue
            rec = json.loads(rec)
        parsed.append((float(rec["t"]), int(rec["device"]),
                       int(rec["class"]), float(rec.get("count", 1))))
    deltas = np.zeros((num_rounds, num_devices, num_classes), np.float32)
    if not parsed:
        return deltas
    times = np.array([p[0] for p in parsed])
    t0 = float(times.min()) if t_start is None else float(t_start)
    t1 = float(times.max()) if t_end is None else float(t_end)
    span = max(t1 - t0, 1e-12)
    for t, dev, cls, count in parsed:
        r = int((t - t0) / span * num_rounds)
        if t == t1 and t_end is None:
            r = num_rounds - 1       # closed right edge of the log span
        if not (0 <= r < num_rounds and 0 <= dev < num_devices
                and 0 <= cls < num_classes):
            continue
        deltas[r, dev, cls] += count
    return deltas


def trace_bank(logs, num_rounds: int, num_devices: int, num_classes: int,
               t_start: Optional[float] = None,
               t_end: Optional[float] = None) -> np.ndarray:
    """Stack per-run usage logs into the ``(S_bank, R, K, C)`` array
    :class:`TraceBank` draws from, one :func:`usage_log_to_deltas` each."""
    if not logs:
        raise ValueError("trace_bank needs at least one usage log")
    return np.stack([
        usage_log_to_deltas(log, num_rounds, num_devices, num_classes,
                            t_start=t_start, t_end=t_end)
        for log in logs])


_PROCESSES: Dict[str, Callable[[], ArrivalProcess]] = {}


def register_process(name: str, factory: Callable[[], ArrivalProcess],
                     overwrite: bool = False) -> None:
    """Register an arrival-process factory (zero-arg -> process)."""
    if name in _PROCESSES and not overwrite:
        raise ValueError(f"arrival process {name!r} already registered")
    _PROCESSES[name] = factory


def process_names() -> tuple[str, ...]:
    return tuple(sorted(_PROCESSES))


def get_process(name: str) -> ArrivalProcess:
    """Build the named arrival process."""
    try:
        factory = _PROCESSES[name]
    except KeyError:
        raise ValueError(f"unknown arrival process {name!r}; registered: "
                         f"{process_names()}") from None
    return factory()


register_process("static", Static)
register_process("poisson", Poisson)
register_process("drift", Drift)
register_process("shift", Shift)
register_process("evict", Evict)
# Data-less placeholders: users overwrite them with Trace(deltas) /
# TraceBank(bank) bound to real data.
register_process("trace", Trace)
register_process("trace_bank", TraceBank)


def refresh(hists: Tensor, deltas: Tensor, arrivals: Tensor,
            staleness: Tensor, selected_prev: Tensor, cfg: StreamConfig,
            size_cap: Optional[float] = None
            ) -> Tuple[Tensor, Tensor, Tensor]:
    """One round's fused data refresh: ``(hists', stats, staleness')``.

    ``stats`` packs ``[gini, shannon, size]`` per device.  A CUDA tensor
    launches the ``stream_update`` kernel (or raises); a CPU tensor runs
    its plain version.  ``size_cap`` overrides ``cfg.size_cap`` (the
    driver passes the padded-buffer capacity).
    """
    cap = cfg.size_cap if size_cap is None else size_cap
    return stream_kernel.stream_update(
        hists, deltas.contiguous(), arrivals.contiguous(), staleness,
        selected_prev, decay=cfg.staleness_decay, size_cap=cap)

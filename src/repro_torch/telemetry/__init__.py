"""Per-round telemetry of the FEEL drivers.

Port of ``repro.telemetry``.  The drivers surface nine aggregate
:class:`repro_torch.core.federated.RoundMetrics` leaves; the quantities
the paper argues from (diversity ranks, admission decisions, Sub2
allocations, the energy split, fault events, the event driver's buffer)
are computed inside a round and dropped.  This package records them:

* :class:`TelemetryConfig` rides on ``FLConfig.telemetry``.  When set,
  the synchronous driver, the event driver and the batch driver build a
  per-round *frame*, a flat dict of tensors
  (:mod:`repro_torch.telemetry.record`), kept on the device and stacked
  on a round axis at the end of the run, so telemetry adds no host sync
  per round.
* ``telemetry=None`` (the default) or an inert config runs today's code
  path: every frame computation sits behind ``if tel is not None``, and
  :func:`active` normalises an all-``False`` config to ``None``.
* :mod:`~repro_torch.telemetry.sinks` writes frames as JSONL;
  ``python -m repro_torch.telemetry.report`` renders a log and
  ``python -m repro_torch.telemetry.compare`` gates one run summary
  (:mod:`~repro_torch.telemetry.store`) against another, with the
  reference's schema and exit codes.
* :func:`phase_scope` wraps the four driver phases (``schedule``,
  ``local_train``, ``aggregate``, ``stream_refresh``) in
  ``torch.profiler.record_function``, so a profiler trace attributes
  time to them.

Frames only observe: they draw no randomness and nothing in them feeds
back into the round, so the primary outputs are bit for bit those of a
run without telemetry.
"""

from __future__ import annotations

import dataclasses
from typing import FrozenSet, Optional

from torch.profiler import record_function

# The four profiled driver phases, in round order.  ``stream_refresh``
# only appears in streaming runs; the other three are always present.
PHASES = ("schedule", "local_train", "aggregate", "stream_refresh")

_seen_phases: set = set()


def phase_scope(name: str):
    """``torch.profiler.record_function`` for one driver phase, its name
    recorded for tests.  The scope only names a range of the profiler's
    trace, so the drivers enter it whatever the telemetry config."""
    _seen_phases.add(name)
    return record_function(name)


def seen_phases() -> FrozenSet[str]:
    """Phase scopes entered since the process started."""
    return frozenset(_seen_phases)


@dataclasses.dataclass(frozen=True)
class TelemetryConfig:
    """Which frame groups to record (rides on ``FLConfig.telemetry``).

    The all-``False`` instance is inert: :func:`active` normalises it to
    ``None`` and the drivers run the code path of no telemetry.  The
    admission outcomes (``admitted``/``dispatched``/``delivered``) are
    recorded whenever any group is on.
    """

    scores: bool = True     # per-device scheduler score decomposition
    sub2: bool = True       # Sub2 allocation vector + objective trace
    transport: bool = True  # payload bits, realized upload time/energy
    faults: bool = True     # fault events by type (needs FLConfig.faults)
    events: bool = True     # event-mode availability/staleness state
    signals: bool = True    # per-device learning signals + fairness health


def is_inert(cfg: TelemetryConfig) -> bool:
    """True when the config records nothing at all."""
    return not (cfg.scores or cfg.sub2 or cfg.transport or cfg.faults
                or cfg.events or cfg.signals)


def active(cfg: Optional[TelemetryConfig]) -> Optional[TelemetryConfig]:
    """An inert config as ``None`` (the no-telemetry path), else ``cfg``."""
    if cfg is None or is_inert(cfg):
        return None
    return cfg


__all__ = ["TelemetryConfig", "is_inert", "active", "phase_scope",
           "seen_phases", "PHASES"]

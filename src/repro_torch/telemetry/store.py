"""Cross-run metrics store.

Port of ``repro.telemetry.store``: an **append-only JSONL run history**,
one *run summary* per run, keyed by the run manifest's config
fingerprint and git sha (:mod:`repro_torch.telemetry.sinks`).
:mod:`repro_torch.telemetry.compare` diffs two summaries with
per-metric tolerance bands, the regression gate.

Record schema (one JSON object per line, the reference's)::

    {"schema_version": 1, "kind": "run", "run": "<label>",
     "git_sha": ..., "config_fingerprint": ...,
     "metrics": {"final_acc": ..., "rounds_to_target": ...,
                 "total_energy_j": ..., "energy_per_device_j": ...,
                 "jain_participation": ..., "jain_energy": ...,
                 "steady_s_per_round": ..., "compile_s": ...}}

``schema_version`` is explicit so the gate can fail loud (exit 2) on
drift instead of silently comparing renamed metrics.  Non-finite floats
serialize as ``null`` (``sinks.jsonl_append`` sanitizes).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch.telemetry import sinks

SCHEMA_VERSION = 1

# Canonical metric names.  ``compare`` only gates on names it has a
# tolerance band for; unknown extras ride along un-gated.
METRIC_NAMES = (
    "final_acc", "rounds_to_target", "total_energy_j",
    "energy_per_device_j", "jain_participation", "jain_energy",
    "steady_s_per_round", "compile_s",
)


def _finite(x) -> Optional[float]:
    if x is None:
        return None
    x = float(x)
    return x if math.isfinite(x) else None


def run_summary(*, accuracy, selected, energy,
                target_accuracy: float = 0.85,
                timings: Optional[Dict[str, float]] = None
                ) -> Dict[str, Any]:
    """Host-side run summary from a run's stacked metrics.

    ``accuracy`` is the per-round ``(R,)`` accuracy trace (NaN on
    eval-skipped rounds), ``selected`` the ``(R, K)`` admission matrix,
    ``energy`` the ``(R, K)`` realized per-device energy.  Fairness
    indices are Jain over the cumulative per-device participation and
    energy — the same definition the frames record
    (:mod:`repro_torch.telemetry.health`), recomputed here in NumPy so
    summaries exist even for telemetry-off runs.  ``timings`` merges benchmark-
    measured wall-clock fields (``steady_s_per_round``, ``compile_s``).
    """
    acc = np.asarray(accuracy, np.float64).reshape(-1)
    sel = np.asarray(selected, np.float64)
    eng = np.asarray(energy, np.float64)
    evald = np.isfinite(acc)
    final_acc = float(acc[evald][-1]) if evald.any() else None
    reach = np.where(evald & (acc >= target_accuracy))[0]
    rounds_to_target = int(reach[0]) + 1 if reach.size else None
    part = sel.sum(axis=0)          # (K,) cumulative participation
    eng_dev = eng.sum(axis=0)       # (K,) cumulative energy

    def jain(x):
        ss = float((x * x).sum())
        if ss <= 0.0:
            return 1.0
        s = float(x.sum())
        return (s * s) / (x.size * ss)

    metrics: Dict[str, Any] = {
        "final_acc": _finite(final_acc),
        "rounds_to_target": rounds_to_target,
        "total_energy_j": _finite(eng.sum()),
        "energy_per_device_j": _finite(eng.sum() / max(sel.shape[-1], 1)),
        "jain_participation": _finite(jain(part)),
        "jain_energy": _finite(jain(eng_dev)),
    }
    for name, val in (timings or {}).items():
        metrics[name] = _finite(val)
    return metrics


def run_record(metrics: Dict[str, Any], *, run: str,
               configs=(), extra: Optional[dict] = None) -> dict:
    """Wrap a metrics dict in the store's keyed record envelope."""
    rec = {
        "schema_version": SCHEMA_VERSION,
        "kind": "run",
        "run": run,
        "git_sha": sinks._git_sha(),
        "config_fingerprint": sinks.config_fingerprint(*configs)
        if configs else None,
        "metrics": dict(metrics),
    }
    if extra:
        rec.update(extra)
    return rec


def append_run(path: str, metrics: Dict[str, Any], *, run: str,
               configs=(), extra: Optional[dict] = None,
               fsync: bool = True) -> dict:
    """Append one run summary to the store; returns the written record."""
    rec = run_record(metrics, run=run, configs=configs, extra=extra)
    sinks.jsonl_append(path, rec, fsync=fsync)
    return rec


def load_history(path: str, run: Optional[str] = None) -> List[dict]:
    """All run records in the store (optionally filtered by run label).

    Torn tails tolerated (``sinks.read_jsonl``); non-``run`` records
    are skipped so the store can co-host other record kinds later.
    """
    out = []
    for rec in sinks.read_jsonl(path):
        if rec.get("kind") != "run":
            continue
        if run is not None and rec.get("run") != run:
            continue
        out.append(rec)
    return out


def latest(path: str, run: Optional[str] = None) -> Optional[dict]:
    """The most recently appended run record, or None."""
    hist = load_history(path, run=run)
    return hist[-1] if hist else None


__all__ = ["SCHEMA_VERSION", "METRIC_NAMES", "run_summary", "run_record",
           "append_run", "load_history", "latest"]

"""Run-summary regression gate.

Port of ``repro.telemetry.compare``.  ``python -m
repro_torch.telemetry.compare BASELINE CURRENT`` diffs two run
summaries — each a single-record JSON file or a JSONL store
(:mod:`repro_torch.telemetry.store`; the latest matching record is
taken) — against per-metric tolerance bands, prints a verdict table,
and exits:

* **0** — every gated metric within tolerance,
* **1** — at least one gated metric regressed beyond tolerance,
* **2** — schema drift (``schema_version`` mismatch, a gated metric
  missing on either side, unreadable/empty input) or usage error.

Tolerance bands are directional: a metric only *regresses* in its bad
direction (accuracy down, energy up, fairness down, rounds-to-target
up); improvements of any size pass.  Timing metrics
(``steady_s_per_round``, ``compile_s``) are reported but **non-gating**
by default — machines vary too much for wall clock to gate a merge —
and can be promoted with ``--gate-timings``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import Any, Dict, List, Optional

from repro_torch.telemetry import sinks
from repro_torch.telemetry import store as store_lib

EXIT_OK = 0
EXIT_REGRESSION = 1
EXIT_SCHEMA = 2


@dataclasses.dataclass(frozen=True)
class Band:
    """One metric's tolerance band.

    ``direction`` is the *bad* direction: ``"down"`` means a drop
    beyond tolerance regresses (accuracy, fairness), ``"up"`` means a
    rise does (energy, rounds).  ``rel`` tolerances are relative to the
    baseline magnitude; ``abs_tol`` is additive.  ``gating=False``
    metrics are reported only.
    """

    direction: str           # "down" | "up"
    abs_tol: float = 0.0
    rel: float = 0.0
    gating: bool = True


# Default bands: loose enough for seed/PRNG jitter across quick CI
# runs, tight enough to catch a real break (accuracy collapse, energy
# blow-up, fairness cliff).
DEFAULT_BANDS: Dict[str, Band] = {
    "final_acc": Band("down", abs_tol=0.05),
    "rounds_to_target": Band("up", abs_tol=2.0),
    "total_energy_j": Band("up", rel=0.25),
    "energy_per_device_j": Band("up", rel=0.25),
    "jain_participation": Band("down", abs_tol=0.15),
    "jain_energy": Band("down", abs_tol=0.15),
    "steady_s_per_round": Band("up", rel=0.50, gating=False),
    "compile_s": Band("up", rel=0.50, gating=False),
}


class SchemaError(Exception):
    """Input unusable for comparison (drift, missing, unreadable)."""


def load_summary(path: str, run: Optional[str] = None) -> dict:
    """Load one run record from a JSON file or JSONL store.

    A ``.json`` file holds a single record; a JSONL store yields its
    latest ``kind == "run"`` record (optionally filtered by label).
    """
    try:
        with open(path) as f:
            first = f.read(1)
    except OSError as e:
        raise SchemaError(f"cannot read {path}: {e}")
    if not first:
        raise SchemaError(f"{path} is empty")
    try:
        records = sinks.read_jsonl(path)
    except OSError as e:
        raise SchemaError(f"cannot read {path}: {e}")
    runs = [r for r in records
            if r.get("kind") == "run"
            and (run is None or r.get("run") == run)]
    if not runs:
        raise SchemaError(
            f"{path} holds no usable run record"
            + (f" labeled {run!r}" if run else ""))
    rec = runs[-1]
    if rec.get("schema_version") != store_lib.SCHEMA_VERSION:
        raise SchemaError(
            f"{path}: schema_version {rec.get('schema_version')!r} != "
            f"supported {store_lib.SCHEMA_VERSION}")
    if not isinstance(rec.get("metrics"), dict):
        raise SchemaError(f"{path}: record has no metrics dict")
    return rec


def _delta_and_limit(name: str, band: Band, base: float, cur: float):
    """(signed regression amount, allowed amount). Positive = worse."""
    worse = (base - cur) if band.direction == "down" else (cur - base)
    limit = band.abs_tol + band.rel * abs(base)
    return worse, limit


@dataclasses.dataclass
class Verdict:
    metric: str
    baseline: Optional[float]
    current: Optional[float]
    status: str              # "ok" | "regressed" | "improved" |
    #                          "info" | "missing"
    gating: bool
    limit: Optional[float] = None


def compare_records(baseline: dict, current: dict,
                    bands: Optional[Dict[str, Band]] = None,
                    gate_timings: bool = False) -> List[Verdict]:
    """Per-metric verdicts for two run records.

    A gated metric present on one side but not the other is schema
    drift (raises :class:`SchemaError`) — a silently vanished metric
    must fail loud, not pass by omission.  Both-``None`` values (e.g.
    ``rounds_to_target`` when neither run reached target) compare ok.
    """
    bands = dict(bands or DEFAULT_BANDS)
    if gate_timings:
        bands = {k: dataclasses.replace(v, gating=True)
                 for k, v in bands.items()}
    bm = baseline["metrics"]
    cm = current["metrics"]
    verdicts: List[Verdict] = []
    for name, band in bands.items():
        in_b, in_c = name in bm, name in cm
        if not in_b and not in_c:
            continue
        if band.gating and (in_b != in_c):
            missing = "current" if in_b else "baseline"
            raise SchemaError(
                f"gated metric {name!r} missing from {missing} record")
        if not (in_b and in_c):
            verdicts.append(Verdict(name, bm.get(name), cm.get(name),
                                    "missing", band.gating))
            continue
        b, c = bm[name], cm[name]
        if b is None and c is None:
            verdicts.append(Verdict(name, None, None, "ok", band.gating))
            continue
        if b is None or c is None:
            # A metric that became unmeasurable (diverged to NaN →
            # null) regresses; one that became measurable improves.
            status = "regressed" if c is None else "improved"
            if not band.gating and status == "regressed":
                status = "info"
            verdicts.append(Verdict(name, b, c, status, band.gating))
            continue
        worse, limit = _delta_and_limit(name, band, float(b), float(c))
        if worse > limit:
            status = "regressed" if band.gating else "info"
        elif worse < 0.0:
            status = "improved"
        else:
            status = "ok"
        verdicts.append(Verdict(name, float(b), float(c), status,
                                band.gating, limit=limit))
    # Ungated extras both sides share: report only.
    for name in sorted(set(bm) & set(cm) - set(bands)):
        verdicts.append(Verdict(name, bm[name], cm[name], "info", False))
    return verdicts


def render_table(baseline: dict, current: dict,
                 verdicts: List[Verdict]) -> str:
    lines = []
    lines.append("== regression gate ==")
    lines.append(f"baseline: run={baseline.get('run')!r} "
                 f"sha={str(baseline.get('git_sha'))[:10]} "
                 f"fp={str(baseline.get('config_fingerprint'))[:10]}")
    lines.append(f"current : run={current.get('run')!r} "
                 f"sha={str(current.get('git_sha'))[:10]} "
                 f"fp={str(current.get('config_fingerprint'))[:10]}")
    hdr = (f"{'metric':<22} {'baseline':>12} {'current':>12} "
           f"{'limit':>10}  verdict")
    lines.append(hdr)
    lines.append("-" * len(hdr))

    def _fmt(x):
        if x is None:
            return "-"
        if isinstance(x, float):
            return f"{x:.4g}"
        return str(x)

    for v in verdicts:
        tag = v.status + ("" if v.gating else " (ungated)")
        lines.append(f"{v.metric:<22} {_fmt(v.baseline):>12} "
                     f"{_fmt(v.current):>12} {_fmt(v.limit):>10}  {tag}")
    n_reg = sum(1 for v in verdicts
                if v.gating and v.status == "regressed")
    lines.append("-" * len(hdr))
    lines.append("verdict: " + ("REGRESSED "
                                f"({n_reg} metric(s) out of band)"
                                if n_reg else "OK"))
    return "\n".join(lines)


def parse_tol(items: List[str]) -> Dict[str, Band]:
    """``--tol name=value`` overrides onto the default bands (value
    replaces the band's dominant tolerance, abs for abs-band metrics,
    rel for rel-band ones)."""
    bands = dict(DEFAULT_BANDS)
    for item in items:
        if "=" not in item:
            raise ValueError(f"--tol expects name=value, got {item!r}")
        name, val = item.split("=", 1)
        name = name.strip()
        if name not in bands:
            raise ValueError(f"unknown metric for --tol: {name!r}")
        band = bands[name]
        v = float(val)
        if band.rel and not band.abs_tol:
            bands[name] = dataclasses.replace(band, rel=v)
        else:
            bands[name] = dataclasses.replace(band, abs_tol=v)
    return bands


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.telemetry.compare",
        description="Diff two run summaries with tolerance bands; "
                    "exit 0 ok / 1 regression / 2 schema drift.")
    ap.add_argument("baseline", help="baseline record (.json or store)")
    ap.add_argument("current", help="current record (.json or store)")
    ap.add_argument("--run", default=None,
                    help="run label to select from JSONL stores")
    ap.add_argument("--tol", action="append", default=[],
                    metavar="NAME=VAL", help="override a tolerance band")
    ap.add_argument("--gate-timings", action="store_true",
                    help="promote timing metrics to gating")
    ap.add_argument("--json", action="store_true",
                    help="emit the verdicts as JSON instead of a table")
    try:
        args = ap.parse_args(argv)
    except SystemExit as e:
        return EXIT_SCHEMA if e.code else EXIT_OK
    try:
        bands = parse_tol(args.tol)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return EXIT_SCHEMA
    try:
        baseline = load_summary(args.baseline, run=args.run)
        current = load_summary(args.current, run=args.run)
        verdicts = compare_records(baseline, current, bands,
                                   gate_timings=args.gate_timings)
    except SchemaError as e:
        print(f"schema drift: {e}", file=sys.stderr)
        return EXIT_SCHEMA
    regressed = any(v.gating and v.status == "regressed"
                    for v in verdicts)
    if args.json:
        print(json.dumps({
            "baseline": {k: baseline.get(k) for k in
                         ("run", "git_sha", "config_fingerprint")},
            "current": {k: current.get(k) for k in
                        ("run", "git_sha", "config_fingerprint")},
            "verdicts": [dataclasses.asdict(v) for v in verdicts],
            "regressed": regressed,
        }, indent=2))
    else:
        print(render_table(baseline, current, verdicts))
    return EXIT_REGRESSION if regressed else EXIT_OK


if __name__ == "__main__":
    sys.exit(main())

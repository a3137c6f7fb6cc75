"""Run-report CLI: render a telemetry JSONL log as a text summary.

    PYTHONPATH=src python -m repro_torch.telemetry.report run.jsonl [...]

Port of ``repro.telemetry.report``.  Reads one or more JSONL round-event
logs written by :func:`repro_torch.telemetry.sinks.write_round_frames`
(or by the reference's sink: the schema is one; an inline ``"type":
"manifest"`` first line is picked up automatically; ``--manifest``
points at a standalone manifest JSON) and prints:

* a **run summary** — rounds, scenarios, device count, manifest
  identity (framework version, backend, git sha, config fingerprint);
* a **round table** — selection/success/drop counts, accuracy, round
  time, energy, Sub2 iterations and objective gain per round;
* an **admission heatmap** — device x round, ``#`` delivered, ``x``
  admitted but failed/dropped, ``.`` idle;
* an **energy / fault breakdown** — realized upload energy plus fault
  events by type when the fault group was recorded;
* **Sub2 convergence stats** — iteration and objective-gain summary;
* **learning signals** — delivered loss-delta / update-norm summary
  plus divergence sentinel counts (the signals group);
* **fairness** — end-of-run Jain indices over participation and energy
  and the starved-device count.

``--json`` emits the same content as a machine-readable dict
(:func:`summary_dict`, the reference's).

Exit status 0 on a parsed log with at least one round record, 2 on
usage/IO errors, 1 on a log with no round records.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional

import numpy as np

from repro_torch.telemetry import sinks

# Display caps: logs can hold hundreds of devices/rounds; the heatmap
# stays terminal-sized and says what it truncated.
_MAX_HEAT_DEVICES = 64
_MAX_HEAT_ROUNDS = 96
_MAX_TABLE_ROUNDS = 40


def _fmt(v, width: int = 8, prec: int = 3) -> str:
    if v is None:
        return " " * (width - 3) + "nan"
    if isinstance(v, float):
        return f"{v:{width}.{prec}f}"
    return f"{v:{width}d}"


def _scalar(rec: dict, name: str):
    v = rec.get(name)
    if isinstance(v, list):
        return None
    return v


def load_rounds(paths: List[str]) -> tuple[List[dict], Optional[dict]]:
    """All round records across the given logs + the first inline
    manifest found (if any)."""
    rounds: List[dict] = []
    manifest: Optional[dict] = None
    for path in paths:
        for rec in sinks.read_jsonl(path):
            kind = rec.get("type")
            if kind == "manifest" and manifest is None:
                manifest = rec
            elif kind == "round" or "round" in rec:
                rounds.append(rec)
    rounds.sort(key=lambda r: (r.get("scenario", 0), r.get("round", 0)))
    return rounds, manifest


def _summary(rounds: List[dict], manifest: Optional[dict]) -> List[str]:
    scenarios = sorted({r.get("scenario") for r in rounds
                        if r.get("scenario") is not None})
    k = None
    for r in rounds:
        adm = r.get("admitted") or r.get("dispatched")
        if isinstance(adm, list):
            k = len(adm)
            break
    lines = ["== Run summary =="]
    per_scn = max(r.get("round", 0) for r in rounds) + 1
    lines.append(f"rounds: {per_scn}   round records: {len(rounds)}   "
                 f"scenarios: {len(scenarios) or 1}   "
                 f"devices: {k if k is not None else '?'}")
    if manifest is not None:
        if manifest.get("torch_version") is not None:
            framework = (f"torch {manifest['torch_version']} (CUDA "
                         f"{manifest.get('cuda_version')}, "
                         f"{manifest.get('device_name', '?')})")
        else:
            framework = f"jax {manifest.get('jax_version', '?')}"
        lines.append(
            f"{framework} "
            f"({manifest.get('backend', '?')}, "
            f"{manifest.get('device_count', '?')} devices)   "
            f"git {str(manifest.get('git_sha'))[:12]}   "
            f"cfg {str(manifest.get('config_fingerprint'))[:12]}")
    return lines


def _round_table(rounds: List[dict]) -> List[str]:
    lines = ["== Round table ==",
             "round  n_sel  n_ok  n_drop       acc    time_s  energy_J"
             "  sub2_it  sub2_gain"]
    shown = rounds[:_MAX_TABLE_ROUNDS]
    for r in shown:
        disp = r.get("dispatched")
        deliv = r.get("delivered")
        n_sel = _scalar(r, "n_selected")
        if n_sel is None and isinstance(disp, list):
            n_sel = int(sum(1 for v in disp if v and v > 0))
        n_ok = _scalar(r, "n_success")
        if n_ok is None and isinstance(deliv, list):
            n_ok = int(sum(1 for v in deliv if v and v > 0))
        e_tot = _scalar(r, "energy_total")
        if e_tot is None and isinstance(r.get("energy_up"), list):
            e_tot = float(sum(v for v in r["energy_up"] if v))
        acc = _scalar(r, "accuracy")
        lines.append(
            f"{r.get('round', 0):5d}  "
            f"{_fmt(int(n_sel) if n_sel is not None else 0, 5)}  "
            f"{_fmt(int(n_ok) if n_ok is not None else 0, 4)}  "
            f"{_fmt(int(_scalar(r, 'n_dropped') or 0), 6)}  "
            f"{_fmt(float(acc) if acc is not None else None, 8)}  "
            f"{_fmt(float(_scalar(r, 'round_time') or 0.0), 8)}  "
            f"{_fmt(float(e_tot) if e_tot is not None else 0.0, 8)}  "
            f"{_fmt(int(_scalar(r, 'sub2_iters') or 0), 7)}  "
            f"{_fmt(float(_scalar(r, 'sub2_gain') or 0.0), 9, 4)}")
    if len(rounds) > len(shown):
        lines.append(f"... {len(rounds) - len(shown)} more round "
                     f"records not shown")
    return lines


def _heatmap(rounds: List[dict]) -> List[str]:
    # One scenario's texture: the first scenario present in the log.
    scn = rounds[0].get("scenario")
    rows = [r for r in rounds if r.get("scenario") == scn]
    rows = rows[:_MAX_HEAT_ROUNDS]
    disp0 = rows[0].get("dispatched") or rows[0].get("admitted")
    if not isinstance(disp0, list):
        return []
    k = len(disp0)
    k_shown = min(k, _MAX_HEAT_DEVICES)
    lines = ["== Admission heatmap (rows=devices, cols=rounds; "
             "'#'=delivered, 'x'=admitted w/o delivery, '.'=idle) =="]
    if scn is not None:
        lines[0] = lines[0][:-3] + f", scenario {scn} =="
    for d in range(k_shown):
        cells = []
        for r in rows:
            adm = (r.get("admitted") or r.get("dispatched") or [0] * k)[d]
            ok = (r.get("delivered") or [0] * k)[d]
            cells.append("#" if ok and ok > 0
                         else ("x" if adm and adm > 0 else "."))
        lines.append(f"dev {d:3d} " + "".join(cells))
    if k > k_shown:
        lines.append(f"... {k - k_shown} more devices not shown")
    return lines


def _energy_faults(rounds: List[dict]) -> List[str]:
    e_tot, n_dev_rounds = 0.0, 0
    outage = dropout = straggler = 0.0
    attempts, have_faults = [], False
    for r in rounds:
        e = r.get("energy_up")
        if isinstance(e, list):
            e_tot += float(sum(v for v in e if v))
            n_dev_rounds += sum(1 for v in e if v and v > 0)
        elif _scalar(r, "energy_total") is not None:
            e_tot += float(r["energy_total"])
        for name in ("fault_outage", "fault_dropout", "fault_straggler"):
            v = r.get(name)
            if isinstance(v, list):
                have_faults = True
        if have_faults:
            outage += float(sum(r.get("fault_outage") or []))
            dropout += float(sum(r.get("fault_dropout") or []))
            straggler += float(sum(r.get("fault_straggler") or []))
            att = r.get("fault_attempts")
            if isinstance(att, list):
                attempts.extend(v for v in att if v and v > 0)
    lines = ["== Energy / fault breakdown ==",
             f"upload energy: {e_tot:.4f} J"
             + (f" over {n_dev_rounds} device-rounds"
                if n_dev_rounds else "")]
    if have_faults:
        mean_att = float(np.mean(attempts)) if attempts else 0.0
        lines.append(f"fault events — outages: {int(outage)}, dropouts: "
                     f"{int(dropout)}, stragglers: {int(straggler)}; "
                     f"mean attempts (transmitting devices): "
                     f"{mean_att:.2f}")
    else:
        lines.append("fault events — none recorded (reliable edge or "
                     "fault group disabled)")
    return lines


def _sub2_stats(rounds: List[dict]) -> List[str]:
    iters = [r["sub2_iters"] for r in rounds
             if _scalar(r, "sub2_iters") is not None]
    gains = [r["sub2_gain"] for r in rounds
             if _scalar(r, "sub2_gain") is not None]
    if not iters and not gains:
        return ["== Sub2 convergence ==",
                "no Sub2 trace recorded (sub2 group disabled)"]
    lines = ["== Sub2 convergence =="]
    if iters:
        lines.append(f"outer iterations — mean {np.mean(iters):.2f}, "
                     f"max {int(np.max(iters))} over {len(iters)} rounds")
    if gains:
        lines.append(f"objective gain vs equal-share — mean "
                     f"{np.mean(gains):.5f}, min {np.min(gains):.5f}, "
                     f"max {np.max(gains):.5f}")
    return lines


def _last_per_scenario(rounds: List[dict]) -> List[dict]:
    """The final round record of each scenario (cumulative leaves —
    participation, energy, Jain — are end-of-run there)."""
    last: Dict = {}
    for r in rounds:
        last[r.get("scenario")] = r  # rounds are sorted by (scn, round)
    return list(last.values())


def _signals(rounds: List[dict]) -> List[str]:
    deltas, norms = [], []
    nonfinite = exploding = 0
    have = False
    for r in rounds:
        ld, un = r.get("sig_loss_delta"), r.get("sig_update_norm")
        deliv = r.get("delivered")
        if not isinstance(ld, list) or not isinstance(deliv, list):
            continue
        have = True
        for d, v in zip(deliv, ld):
            if d and d > 0 and v is not None:
                deltas.append(float(v))
        for d, v in zip(deliv, un or []):
            if d and d > 0 and v is not None:
                norms.append(float(v))
        nonfinite += int(_scalar(r, "div_nonfinite") or 0)
        exploding += int(_scalar(r, "div_exploding") or 0)
    if not have:
        return ["== Learning signals ==",
                "no signal trace recorded (signals group disabled)"]
    lines = ["== Learning signals =="]
    if deltas:
        lines.append(f"local loss delta (delivered) — mean "
                     f"{np.mean(deltas):+.5f}, min {np.min(deltas):+.5f}"
                     f", max {np.max(deltas):+.5f} over {len(deltas)} "
                     f"device-rounds")
    if norms:
        lines.append(f"update L2 norm (delivered) — mean "
                     f"{np.mean(norms):.5f}, max {np.max(norms):.5f}")
    lines.append(f"divergence sentinels — non-finite: {nonfinite}, "
                 f"exploding: {exploding}"
                 + ("  << CHECK RUN" if nonfinite or exploding else ""))
    return lines


def _fairness(rounds: List[dict]) -> List[str]:
    finals = [r for r in _last_per_scenario(rounds)
              if _scalar(r, "jain_participation") is not None]
    if not finals:
        return ["== Fairness ==",
                "no fairness trace recorded (signals group disabled)"]
    jp = [float(r["jain_participation"]) for r in finals]
    je = [float(r["jain_energy"]) for r in finals
          if _scalar(r, "jain_energy") is not None]
    starved = [int(r["starved"]) for r in finals
               if _scalar(r, "starved") is not None]
    lines = ["== Fairness (end of run) =="]
    lines.append(f"Jain(participation) — mean {np.mean(jp):.4f}, "
                 f"min {np.min(jp):.4f} over {len(jp)} scenario(s)")
    if je:
        lines.append(f"Jain(energy)        — mean {np.mean(je):.4f}, "
                     f"min {np.min(je):.4f}")
    if starved:
        lines.append(f"starved devices (never delivered) — mean "
                     f"{np.mean(starved):.1f}, max {int(np.max(starved))}")
    return lines


def render(rounds: List[dict],
           manifest: Optional[dict] = None) -> str:
    """The full text report for a list of round records."""
    blocks = [_summary(rounds, manifest), _round_table(rounds),
              _heatmap(rounds), _energy_faults(rounds),
              _sub2_stats(rounds), _signals(rounds), _fairness(rounds)]
    return "\n".join("\n".join(b) for b in blocks if b)


def summary_dict(rounds: List[dict],
                 manifest: Optional[dict] = None) -> dict:
    """Machine-readable report (the ``--json`` mode's payload).

    Mirrors the text sections: run identity, per-round scalar rows, the
    Sub2 / signal / fairness aggregates.  Consumed by the regression
    gate and external tooling so nothing screen-scrapes the table.
    """
    scenarios = sorted({r.get("scenario") for r in rounds
                        if r.get("scenario") is not None})
    out: dict = {
        "rounds": max(r.get("round", 0) for r in rounds) + 1,
        "round_records": len(rounds),
        "scenarios": len(scenarios) or 1,
        "manifest": {k: manifest.get(k) for k in
                     ("jax_version", "backend", "device_count",
                      "git_sha", "config_fingerprint")}
        if manifest else None,
        "round_table": [],
    }
    for r in rounds:
        out["round_table"].append({
            k: _scalar(r, k) for k in
            ("scenario", "round", "n_selected", "n_success", "n_dropped",
             "accuracy", "round_time", "energy_total", "sub2_iters",
             "sub2_gain", "jain_participation", "jain_energy", "starved",
             "div_nonfinite", "div_exploding")
            if r.get(k) is not None})
    iters = [r["sub2_iters"] for r in rounds
             if _scalar(r, "sub2_iters") is not None]
    gains = [r["sub2_gain"] for r in rounds
             if _scalar(r, "sub2_gain") is not None]
    out["sub2"] = {
        "mean_iterations": float(np.mean(iters)) if iters else None,
        "mean_gain": float(np.mean(gains)) if gains else None,
    }
    deltas, norms = [], []
    nonfinite = exploding = 0
    for r in rounds:
        ld, un = r.get("sig_loss_delta"), r.get("sig_update_norm")
        deliv = r.get("delivered")
        if not isinstance(ld, list) or not isinstance(deliv, list):
            continue
        deltas.extend(float(v) for d, v in zip(deliv, ld)
                      if d and d > 0 and v is not None)
        norms.extend(float(v) for d, v in zip(deliv, un or [])
                     if d and d > 0 and v is not None)
        nonfinite += int(_scalar(r, "div_nonfinite") or 0)
        exploding += int(_scalar(r, "div_exploding") or 0)
    out["signals"] = {
        "mean_loss_delta": float(np.mean(deltas)) if deltas else None,
        "mean_update_norm": float(np.mean(norms)) if norms else None,
        "div_nonfinite": nonfinite,
        "div_exploding": exploding,
    } if deltas or norms else None
    finals = [r for r in _last_per_scenario(rounds)
              if _scalar(r, "jain_participation") is not None]
    out["fairness"] = {
        "jain_participation": [float(r["jain_participation"])
                               for r in finals],
        "jain_energy": [float(r["jain_energy"]) for r in finals
                        if _scalar(r, "jain_energy") is not None],
        "starved": [int(r["starved"]) for r in finals
                    if _scalar(r, "starved") is not None],
    } if finals else None
    return out


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.telemetry.report",
        description="Render a telemetry JSONL round-event log.")
    ap.add_argument("logs", nargs="+", help="JSONL round-event file(s)")
    ap.add_argument("--manifest", default=None,
                    help="standalone run-manifest JSON to include")
    ap.add_argument("--json", action="store_true",
                    help="emit a machine-readable summary dict instead "
                         "of the text report")
    args = ap.parse_args(argv)
    manifest = None
    if args.manifest is not None:
        try:
            with open(args.manifest) as f:
                manifest = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            print(f"error: cannot read manifest {args.manifest}: {e}",
                  file=sys.stderr)
            return 2
    try:
        rounds, inline = load_rounds(args.logs)
    except OSError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if manifest is None:
        manifest = inline
    if not rounds:
        print("no round records found", file=sys.stderr)
        return 1
    if args.json:
        print(json.dumps(sinks.sanitize(summary_dict(rounds, manifest)),
                         indent=2))
    else:
        print(render(rounds, manifest))
    return 0


if __name__ == "__main__":
    sys.exit(main())

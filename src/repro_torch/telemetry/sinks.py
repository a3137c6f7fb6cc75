"""Durable host-side telemetry sinks.

Port of ``repro.telemetry.sinks`` (numpy and json, the same JSONL
schema), one home for the JSONL discipline:

* :func:`jsonl_append` — append one record, flush, optionally fsync
  (the reference's sweep runner streams its chunks through it).
* :func:`jsonl_rewind` — the resume-safe rewind contract of the
  reference's ``sweep/runner.py``: keep lines whose cursor is at or below the
  resumed checkpoint, drop torn tails and non-dict lines, and rewrite
  the file **fsync-before-replace** (temp file in the same directory,
  fsynced, then ``os.replace``) so a crash mid-rewind can never leave a
  half-truncated log.
* :func:`write_round_frames` — one JSON line per round from a stacked
  telemetry frame dict (:mod:`repro_torch.telemetry.record`), the format
  ``python -m repro_torch.telemetry.report`` renders (and the
  reference's report reads).
* :func:`run_manifest` / :func:`write_manifest` — the run's identity
  card: config fingerprint, the torch and CUDA versions and the card,
  git sha, under the reference manifest's keys.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
from typing import Any, Dict, Iterable, List, Optional

import numpy as np


# ---------------------------------------------------------------------------
# JSONL primitives
# ---------------------------------------------------------------------------

def sanitize(value):
    """Map non-finite floats to ``None`` recursively, deterministically.

    ``json.dumps`` emits literal ``NaN``/``Infinity`` for non-finite
    Python floats — invalid JSON that breaks every strict parser
    downstream.  All sink writers funnel dict records through this, so
    a NaN divergence sentinel round-trips through JSONL as ``null``
    (missing-not-invalid) instead of corrupting the line.
    """
    if isinstance(value, float):
        return value if np.isfinite(value) else None
    if isinstance(value, dict):
        return {k: sanitize(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [sanitize(v) for v in value]
    if isinstance(value, np.ndarray) or isinstance(value, np.generic):
        return _jsonify(value)
    return value


def jsonl_append(path: str, record: dict, fsync: bool = False) -> None:
    """Append one JSON line; flush always, fsync on request.

    Flush-only matches the sweep runner's historical behavior (a line
    is torn only if the process dies mid-``write``, which the rewind
    contract already tolerates); ``fsync=True`` additionally survives
    power loss, for round-event logs that feed offline analysis.
    Records pass through :func:`sanitize` so non-finite floats land as
    ``null`` rather than invalid bare ``NaN`` tokens.
    """
    with open(path, "a") as f:
        f.write(json.dumps(sanitize(record)) + "\n")
        f.flush()
        if fsync:
            os.fsync(f.fileno())


def jsonl_rewind(path: str, cursor: int, key: str = "cursor") -> None:
    """Drop lines past ``cursor`` (the resume-safe append contract).

    A killed run may have streamed records that were never
    checkpointed; those re-execute on resume, so their stale lines must
    go before the re-run appends duplicates.  Kept-line semantics are
    exactly the sweep runner's: stop at the first torn (non-JSON) line,
    the first non-dict line, or the first record past the cursor.  The
    rewrite goes through a same-directory temp file + fsync +
    ``os.replace`` so the log is never observable half-truncated.
    """
    if not os.path.exists(path):
        return
    kept: List[str] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                break                     # torn tail write: drop rest
            if not isinstance(rec, dict):
                break                     # valid JSON, wrong shape: ditto
            if rec.get(key, 0) > cursor:
                break
            kept.append(line)
    tmp = path + ".rewind.tmp"
    with open(tmp, "w") as f:
        for line in kept:
            f.write(line + "\n")
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def read_jsonl(path: str) -> List[dict]:
    """All well-formed dict records of a JSONL file (torn tail dropped,
    same tolerance as :func:`jsonl_rewind`)."""
    out: List[dict] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                break
            if not isinstance(rec, dict):
                break
            out.append(rec)
    return out


# ---------------------------------------------------------------------------
# Round-event frames -> JSONL
# ---------------------------------------------------------------------------

def frames_to_host(frames: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """A whole run's stacked frames as numpy arrays, in one
    device-to-host copy: every leaf's bytes are packed into one buffer
    on its device, copied once, and cut back into leaves on the host.
    Leaves already on the host (numpy or CPU tensors) cost no copy."""
    import torch
    names = list(frames)
    leaves = [torch.as_tensor(frames[n]) for n in names]
    if not leaves:
        return {}
    dev = leaves[0].device
    if any(t.device != dev for t in leaves):
        raise ValueError("frame leaves lie on more than one device")
    if dev.type == "cpu":
        return {n: t.numpy() for n, t in zip(names, leaves)}
    packed = torch.cat([t.contiguous().reshape(-1).view(torch.uint8)
                        for t in leaves]).cpu()
    out, offset = {}, 0
    for n, t in zip(names, leaves):
        size = t.numel() * t.element_size()
        out[n] = packed[offset:offset + size].view(t.dtype).reshape(
            t.shape).numpy()
        offset += size
    return out


def _jsonify(v: np.ndarray):
    a = np.asarray(v)
    if a.ndim == 0:
        x = a.item()
        if isinstance(x, float) and not np.isfinite(x):
            return None
        return x
    return [_jsonify(e) for e in a]


# RoundMetrics scalar leaves merged into each round line when the
# caller passes the run's metrics (the (R, K) leaves stay in the frame).
_METRIC_FIELDS = ("accuracy", "n_selected", "round_time", "energy_total",
                  "n_success", "n_dropped")


def write_round_frames(path: str, frames: Dict[str, Any],
                       metrics=None,
                       scenario: Optional[int] = None,
                       manifest: Optional[dict] = None,
                       fsync: bool = True) -> int:
    """Write a run's telemetry frames as one JSON line per round.

    ``frames`` leaves carry a leading round axis (a single run's
    frames, or one scenario's slice of a batch's); each line holds the
    round index, the optional scenario index (its global index,
    ``federated.scenario_seeds``), and every frame field for that
    round.  ``metrics`` (a
    :class:`repro_torch.core.federated.RoundMetrics`) merges the per-round
    scalar metrics — accuracy, round time, totals — into each line so
    the report CLI can render the round table from one file.  The file
    is written fresh (truncate, not append) — a scenario's log is a
    pure function of its run, so re-running overwrites rather than
    duplicating — and fsynced before close by default.  Returns the
    number of round lines written.
    """
    if metrics is not None:
        frames = {**{f: getattr(metrics, f) for f in _METRIC_FIELDS},
                  **frames}
    host = frames_to_host(frames)
    lengths = {v.shape[0] for v in host.values()}
    if len(lengths) != 1:
        raise ValueError(f"frame leaves disagree on round count: "
                         f"{sorted(lengths)}")
    rounds = lengths.pop()
    with open(path, "w") as f:
        if manifest is not None:
            f.write(json.dumps(sanitize({"type": "manifest", **manifest}))
                    + "\n")
        for r in range(rounds):
            rec: dict = {"type": "round", "round": r}
            if scenario is not None:
                rec["scenario"] = int(scenario)
            for name, arr in host.items():
                rec[name] = _jsonify(arr[r])
            f.write(json.dumps(rec) + "\n")
        f.flush()
        if fsync:
            os.fsync(f.fileno())
    return rounds


# ---------------------------------------------------------------------------
# Run manifest
# ---------------------------------------------------------------------------

def _git_sha() -> Optional[str]:
    try:
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"], capture_output=True, text=True,
            timeout=5, cwd=os.path.dirname(os.path.abspath(__file__)))
        sha = out.stdout.strip()
        return sha if out.returncode == 0 and sha else None
    except (OSError, subprocess.SubprocessError):
        return None


def config_fingerprint(*cfgs) -> str:
    """Stable digest of the run's static configs (same ``repr`` canon
    as ``SweepSpec.fingerprint``, so frozen-dataclass configs hash
    deterministically)."""
    return hashlib.sha1(repr(tuple(cfgs)).encode()).hexdigest()


def run_manifest(*cfgs, extra: Optional[dict] = None) -> dict:
    """The run's identity card: everything needed to tie a JSONL log
    back to the code, configs and machine that produced it.  The keys
    are the reference manifest's: ``backend`` names torch and
    ``device_platform`` ``cuda`` or ``cpu``; the JAX fields are None.
    ``torch_version``, ``cuda_version`` and ``device_name`` (the card's,
    ``torch.cuda.get_device_name``) join them."""
    import torch
    cuda = torch.cuda.is_available()
    man = {
        "config_fingerprint": config_fingerprint(*cfgs),
        "configs": {type(c).__name__: repr(c) for c in cfgs},
        "jax_version": None,
        "jaxlib_version": None,
        "xla_flags": "",
        "device_count": torch.cuda.device_count() if cuda else 1,
        "device_platform": "cuda" if cuda else "cpu",
        "backend": "torch",
        "git_sha": _git_sha(),
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "device_name": torch.cuda.get_device_name(0) if cuda else "cpu",
    }
    if extra:
        man.update(extra)
    return man


def write_manifest(path: str, *cfgs, extra: Optional[dict] = None) -> dict:
    """Write the manifest JSON (fsync-before-replace) and return it."""
    man = run_manifest(*cfgs, extra=extra)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(man, f, indent=2, sort_keys=True, default=str)
        f.write("\n")
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return man


__all__ = ["jsonl_append", "jsonl_rewind", "read_jsonl", "frames_to_host",
           "write_round_frames", "run_manifest", "write_manifest",
           "config_fingerprint", "sanitize"]

"""Monte-Carlo chunk execution and online Welford aggregation.

Port of ``repro.sweep.engine``.  The engine turns a
:class:`repro_torch.sweep.grid.SweepSpec` into work: each grid point's
scenarios run in chunks through ``federated.run_federated_batch`` (the
synchronous driver, or the event driver for a point with
``FLConfig.events``), and every chunk's ``(S, R)`` metrics fold into an
**online Welford aggregate** carried across chunks.  The carry is O(R)
per grid point however many scenarios run: per-round mean / variance /
min / max of accuracy, round time, energy and the counts, and the
per-scenario scalars a study reads (final accuracy, totals, rounds to a
target accuracy).

The fold is the Chan et al. parallel merge: a chunk's statistics over
the scenario axis merge into the carry in one step, NaN (the rounds
``eval_every`` skips) and masked entries excluded, in float32 as the
reference's.  It runs on the carry's device with no host sync; only
:func:`aggregate_summary` and :func:`aggregate_to_tree` bring the carry
to the host, each in one copy.

A chunk is the batch driver's leading S axis.  As the reference shards
it over a ``scenario`` mesh with ``shard_map``, the engine splits it over
a ``launch.mesh`` scenario mesh (``use_sharding``, by default every card
present): a chunk whose size the mesh's entry count divides runs as
contiguous equal groups of scenarios, one ``run_federated_batch`` call
an entry on that entry's device, their metrics (and frames) put back in
scenario order and folded once; a chunk it does not divide runs whole on
the engine's device, as the reference's ``_sim_for`` falls back.  The
groups run one after another from this process; on distinct cards they
overlap as far as their launches do not wait on the host.  With one
entry the split chunk is the unsplit call.  The reference's
``donate_params`` stays out: it donates XLA buffers, and the batch
driver always tiles fresh parameters.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.core import federated, wireless
from repro_torch.data import partition as partition_lib
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch import mesh as mesh_lib
from repro_torch.sweep import grid as grid_lib
from repro_torch.telemetry import sinks

Tensor = torch.Tensor

# Salts separating the two per-scenario seed families.
_NET_STREAM = 0
_SIM_STREAM = 1

_FIELDS = ("count", "mean", "m2", "min", "max")


def stream_bases(base_seed: int) -> Tuple[int, int]:
    """(net_base, sim_base) seeds of a sweep's two per-scenario streams.

    Scenario ``i`` draws its network from
    ``sample_networks_indexed(net_base, [i], ...)`` and its tape from
    ``scenario_seeds(sim_base, i, 1)``, whatever chunk it runs in.
    Public so a caller of ``run_federated_batch`` can build the same
    scenarios as the engine.
    """
    return (wireless.fold_seed(base_seed, _NET_STREAM),
            wireless.fold_seed(base_seed, _SIM_STREAM))


# ---------------------------------------------------------------------------
# Online Welford aggregation (masked, batched merge)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Welford:
    """Running mean / variance / min / max over the scenario population.

    Tensors on the run's device sharing a shape (``(R,)`` for per-round
    metrics, ``()`` for per-scenario scalars).  ``count`` is per element
    because masking (NaN accuracy on rounds not evaluated, targets never
    reached) makes the sample size element-dependent.
    """

    count: Tensor
    mean: Tensor
    m2: Tensor
    min: Tensor
    max: Tensor

    @property
    def variance(self) -> Tensor:
        """Population variance (ddof=0); NaN where nothing was folded."""
        return torch.where(self.count > 0,
                           self.m2 / torch.clamp_min(self.count, 1.0),
                           math.nan)

    @property
    def std(self) -> Tensor:
        return torch.sqrt(self.variance)


def welford_init(shape: Tuple[int, ...], device: DeviceLike = None
                 ) -> Welford:
    """An empty carry of ``shape`` on ``resolve_device(device)``."""
    dev = resolve_device(device)

    def full(v):
        return torch.full(shape, v, dtype=torch.float32, device=dev)

    return Welford(count=full(0.0), mean=full(0.0), m2=full(0.0),
                   min=full(math.inf), max=full(-math.inf))


def welford_fold(state: Welford, batch: Tensor,
                 mask: Optional[Tensor] = None) -> Welford:
    """Merge a ``(S, ...)`` batch into the carry (Chan et al. merge).

    ``mask`` (same shape, optional) excludes entries; NaNs are always
    excluded, so rounds not evaluated never poison the fold.
    """
    batch = batch.to(torch.float32)
    valid = torch.isfinite(batch)
    if mask is not None:
        valid = valid & mask.to(torch.bool)
    x = torch.where(valid, batch, 0.0)
    n_b = torch.sum(valid, dim=0).to(torch.float32)
    mean_b = torch.sum(x, dim=0) / torch.clamp_min(n_b, 1.0)
    m2_b = torch.sum(torch.where(valid, (x - mean_b) ** 2, 0.0), dim=0)
    n = state.count + n_b
    delta = mean_b - state.mean
    has = n_b > 0
    safe_n = torch.clamp_min(n, 1.0)
    mean = torch.where(has, state.mean + delta * n_b / safe_n, state.mean)
    m2 = torch.where(has, state.m2 + m2_b
                     + delta ** 2 * state.count * n_b / safe_n, state.m2)
    mn = torch.minimum(state.min, torch.amin(
        torch.where(valid, batch, math.inf), dim=0))
    mx = torch.maximum(state.max, torch.amax(
        torch.where(valid, batch, -math.inf), dim=0))
    return Welford(count=n, mean=mean, m2=m2, min=mn, max=mx)


# ---------------------------------------------------------------------------
# Per-point aggregate: per-round Welford + per-scenario scalar Welford
# ---------------------------------------------------------------------------

ROUND_METRICS = ("accuracy", "round_time", "energy_total", "n_selected",
                 "n_success", "n_dropped")
SCALAR_METRICS = ("final_accuracy", "time_total", "energy_total",
                  "energy_per_device", "mean_selected", "rounds_to_target",
                  "reached_target")

Aggregate = Dict[str, Dict[str, Welford]]


def aggregate_init(num_rounds: int, device: DeviceLike = None) -> Aggregate:
    return {
        "round": {m: welford_init((num_rounds,), device)
                  for m in ROUND_METRICS},
        "scalar": {m: welford_init((), device) for m in SCALAR_METRICS},
    }


def _scenario_scalars(metrics: federated.RoundMetrics, target: float):
    """Per-scenario (S,) summary scalars and their masks from ``(S, R)``
    metrics, on their device."""
    acc = metrics.accuracy                       # (S, R), NaN on skipped
    n_sel = metrics.n_selected.to(torch.float32)
    e_tot = torch.sum(metrics.energy_total, dim=1)
    t_tot = torch.sum(metrics.round_time, dim=1)
    sel_tot = torch.sum(n_sel, dim=1)
    hit = acc >= target                      # (S, R), False where NaN
    reached = torch.any(hit, dim=1)
    # argmax of the 0/1 rows: the first round that hit (torch.argmax has
    # no CUDA version for bool, and returns the first maximum).
    first = torch.argmax(hit.to(torch.int32), dim=1).to(torch.float32) + 1.0
    out = {
        "final_accuracy": acc[:, -1],
        "time_total": t_tot,
        "energy_total": e_tot,
        "energy_per_device": e_tot / torch.clamp_min(sel_tot, 1.0),
        "mean_selected": torch.mean(n_sel, dim=1),
        "rounds_to_target": first,
        "reached_target": reached.to(torch.float32),
    }
    masks = {m: None for m in out}
    masks["rounds_to_target"] = reached   # only scenarios that got there
    return out, masks


def aggregate_fold(agg: Aggregate, metrics: federated.RoundMetrics,
                   target: float) -> Aggregate:
    """Fold one chunk's ``(S, R)`` metrics into the O(R) carry."""
    per_round = {
        "accuracy": metrics.accuracy,
        "round_time": metrics.round_time,
        "energy_total": metrics.energy_total,
        "n_selected": metrics.n_selected,
        "n_success": metrics.n_success,
        "n_dropped": metrics.n_dropped,
    }
    scalars, masks = _scenario_scalars(metrics, target)
    return {
        "round": {m: welford_fold(agg["round"][m], per_round[m])
                  for m in ROUND_METRICS},
        "scalar": {m: welford_fold(agg["scalar"][m], scalars[m], masks[m])
                   for m in SCALAR_METRICS},
    }


def _flat(aggs: Dict[str, Aggregate]) -> Dict[str, Tensor]:
    """Every carry tensor of ``aggs`` by ``key/group/name/field``."""
    return {f"{key}/{group}/{name}/{field}": getattr(w, field)
            for key, agg in aggs.items()
            for group, metrics in agg.items()
            for name, w in metrics.items() for field in _FIELDS}


def aggregates_to_host(aggs: Dict[str, Aggregate]
                       ) -> Dict[str, Dict[str, Dict[str, Dict[str,
                                                              np.ndarray]]]]:
    """Several carries, keyed, as one nested numpy tree ``{key: {group:
    {name: {field: array}}}}``, in one device-to-host copy for all of
    them (``sinks.frames_to_host``)."""
    tree: dict = {}
    for path, leaf in sinks.frames_to_host(_flat(aggs)).items():
        key, group, name, field = path.split("/")
        tree.setdefault(key, {}).setdefault(group, {}).setdefault(
            name, {})[field] = leaf
    return tree


def aggregate_to_tree(agg: Aggregate
                      ) -> Dict[str, Dict[str, Dict[str, np.ndarray]]]:
    """The carry as a plain ``{group: {name: {field: array}}}`` numpy
    tree (the checkpoint's layout), in one copy."""
    return aggregates_to_host({"": agg})[""]


def aggregate_from_tree(tree, device: DeviceLike = None) -> Aggregate:
    """A carry from its tree (numpy arrays or tensors), on
    ``resolve_device(device)``."""
    dev = resolve_device(device)
    return {
        group: {
            name: Welford(**{f: torch.as_tensor(leaves[f]).to(
                dev, torch.float32) for f in _FIELDS})
            for name, leaves in metrics.items()
        }
        for group, metrics in tree.items()
    }


def aggregate_summary(agg: Aggregate) -> Dict[str, Dict[str, np.ndarray]]:
    """Host view, in one copy: ``{"round.accuracy": {count, mean, var,
    std, min, max}, ...}``, float32 arrays, NaN where nothing was
    folded."""
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for group, metrics in aggregate_to_tree(agg).items():
        for name, w in metrics.items():
            count = w["count"]
            valid = count > 0
            var = np.where(valid, w["m2"] / np.maximum(count, 1.0), np.nan
                           ).astype(np.float32)
            out[f"{group}.{name}"] = {
                "count": count,
                "mean": np.where(valid, w["mean"], np.nan),
                "var": var,
                "std": np.sqrt(var),
                "min": np.where(valid, w["min"], np.nan),
                "max": np.where(valid, w["max"], np.nan),
            }
    return out


# -- adaptive scenario counts (SweepSpec.ci_target) -----------------------

def final_accuracy_ci_halfwidth(agg: Aggregate) -> float:
    """95% CI half-width of the final-accuracy mean from the carry:
    ``1.96 * sqrt(m2 / (n-1)) / sqrt(n)``; ``inf`` below two scenarios.
    One copy of two numbers to the host."""
    w = agg["scalar"]["final_accuracy"]
    n, m2 = (float(v) for v in torch.stack([w.count, w.m2]).cpu())
    if n < 2.0:
        return float("inf")
    return 1.96 * np.sqrt(max(m2, 0.0) / (n - 1.0)) / np.sqrt(n)


def point_converged(agg: Aggregate, ci_target: float) -> bool:
    """True when adaptive stopping is on and the point's final-accuracy
    CI half-width is at or below the target."""
    if ci_target <= 0.0:
        return False
    return bool(final_accuracy_ci_halfwidth(agg) <= ci_target)


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------

class SweepEngine:
    """Runs a :class:`SweepSpec` chunk by chunk.

    Owns the problem: the model (its architecture and initial weights;
    never modified) and one copy of the dataset on each device it runs
    on, shared by every chunk.  A chunk runs scenarios ``[start, start +
    size)`` of a grid point as ``federated.run_federated_batch`` calls,
    the scenarios the batch's leading axis: split over the scenario mesh
    where its entry count divides ``size``, else one call on the
    engine's device.  ``device=None`` means the CUDA card and raises
    without one; pass ``device="cpu"`` for the plain path.  ``mesh``
    (a 1-D ``launch.mesh.Mesh``, its axis the scenarios') defaults, with
    ``use_sharding``, to ``make_scenario_mesh`` on the engine's device
    type: every card for ``"cuda"``, the one named for ``"cuda:i"``, one
    CPU entry for ``"cpu"``; the aggregates are folded on the engine's
    device.

    With ``telemetry_dir`` set, a grid point whose ``FLConfig.telemetry``
    is set writes each scenario's frames to
    ``point{p:03d}_scn{i:05d}.jsonl`` (global scenario index ``i``) and
    the sweep one ``manifest.json``: a resumed chunk rewrites its files
    with the same bytes.
    """

    def __init__(self, spec: grid_lib.SweepSpec, *, model: nn.Module,
                 data: partition_lib.ClientDataset,
                 target_accuracy: float = 0.85,
                 telemetry_dir: Optional[str] = None,
                 mesh: Optional[mesh_lib.Mesh] = None,
                 use_sharding: bool = True,
                 device: DeviceLike = None):
        self.spec = spec
        self.dev = resolve_device(device)
        if mesh is None and use_sharding:
            mesh = mesh_lib.make_scenario_mesh(
                device=None if self.dev == torch.device("cuda") else self.dev)
        if mesh is not None and len(mesh.shape) != 1:
            raise ValueError(f"the scenario mesh must be 1-D, got axes "
                             f"{mesh.axis_names}")
        self.mesh = mesh
        self.model = model
        self.data = data.to(self.dev)
        self._data = {self.dev: self.data}
        self.target_accuracy = float(target_accuracy)
        self.telemetry_dir = telemetry_dir
        self._manifest_written = False
        self.points = spec.expand()
        self._net_base, self._sim_base = stream_bases(spec.base_seed)

    # -- execution -------------------------------------------------------

    def groups(self, size: int) -> List[Tuple[int, int, torch.device]]:
        """A chunk of ``size`` scenarios as ``(offset, count, device)``
        groups: one a mesh entry where the entry count divides ``size``,
        else the whole chunk on the engine's device."""
        if self.mesh is None or self.mesh.devices is None or \
                size % self.mesh.size:
            return [(0, size, self.dev)]
        per = size // self.mesh.size
        return [(i * per, per, d) for i, d in enumerate(self.mesh.devices)]

    def _run_group(self, point: grid_lib.GridPoint, start: int, size: int,
                   dev: torch.device) -> tuple:
        """``run_federated_batch`` over scenarios ``[start, start + size)``
        on ``dev``: ``(metrics, frames or None)``."""
        if dev not in self._data:
            self._data[dev] = self.data.to(dev)
        data = self._data[dev]
        nets = wireless.sample_networks_indexed(
            self._net_base, range(start, start + size), data.num_devices,
            point.wireless)
        out = federated.run_federated_batch(
            model=self.model, data=data, nets=nets, wcfg=point.wireless,
            scfg=point.sched, fcfg=point.fl,
            seeds=federated.scenario_seeds(self._sim_base, start, size),
            eval_every=self.spec.eval_every, device=dev)
        return out[1], (out[2] if len(out) == 3 else None)

    def run_chunk(self, point: grid_lib.GridPoint, global_start: int,
                  size: int, agg: Aggregate) -> Aggregate:
        """Run scenarios ``[global_start, global_start + size)`` of a grid
        point, over the mesh where it divides them, and fold their
        metrics into ``agg`` once."""
        outs = [self._run_group(point, global_start + off, n, dev)
                for off, n, dev in self.groups(size)]

        def cat(ts: List[Tensor]) -> Tensor:
            ts = [t.to(self.dev) for t in ts]
            return ts[0] if len(ts) == 1 else torch.cat(ts)

        metrics = federated.RoundMetrics(*(
            cat([getattr(m, f.name) for m, _ in outs])
            for f in dataclasses.fields(federated.RoundMetrics)))
        frames = None if outs[0][1] is None else {
            n: cat([fr[n] for _, fr in outs]) for n in outs[0][1]}
        if frames is not None:
            self._sink_frames(point, global_start, metrics, frames)
        return aggregate_fold(agg, metrics, self.target_accuracy)

    def _sink_frames(self, point: grid_lib.GridPoint, global_start: int,
                     metrics: federated.RoundMetrics,
                     frames: Dict[str, Tensor]) -> None:
        """One JSONL round-event file per scenario of the chunk, named by
        grid-point index and global scenario index, and the sweep's
        manifest once; the chunk's frames and metrics reach the host in
        one copy."""
        if self.telemetry_dir is None:
            return
        os.makedirs(self.telemetry_dir, exist_ok=True)
        if not self._manifest_written:
            sinks.write_manifest(
                os.path.join(self.telemetry_dir, "manifest.json"),
                self.spec, extra={"kind": "sweep",
                                  "fingerprint": self.spec.fingerprint()})
            self._manifest_written = True
        names = [f.name for f in dataclasses.fields(metrics)]
        host = sinks.frames_to_host(
            {**{f"frame/{n}": t for n, t in frames.items()},
             **{f"metric/{n}": getattr(metrics, n) for n in names}})
        for s in range(metrics.accuracy.shape[0]):
            scn = global_start + s
            sinks.write_round_frames(
                os.path.join(self.telemetry_dir,
                             f"point{point.index:03d}_scn{scn:05d}.jsonl"),
                {n: host[f"frame/{n}"][s] for n in frames},
                metrics=federated.RoundMetrics(
                    *(host[f"metric/{n}"][s] for n in names)),
                scenario=scn)

    def run_point(self, point: grid_lib.GridPoint,
                  agg: Optional[Aggregate] = None) -> Aggregate:
        """All chunks of one grid point folded into one aggregate (a
        fresh one by default).  With ``spec.ci_target > 0`` the chunk loop
        stops once the final-accuracy CI half-width reaches the target."""
        if agg is None:
            agg = aggregate_init(federated.sim_length(point.fl), self.dev)
        base = self.spec.scenario_start(point.index)
        for off, size in self.spec.point_chunks():
            if off > 0 and point_converged(agg, self.spec.ci_target):
                break
            agg = self.run_chunk(point, base + off, size, agg)
        return agg

    def run(self) -> List[Tuple[grid_lib.GridPoint,
                                Dict[str, Dict[str, np.ndarray]]]]:
        """The whole grid without checkpoints (``runner.SweepRunner``
        resumes): per-point summaries, in grid order."""
        return [(p, aggregate_summary(self.run_point(p)))
                for p in self.points]


__all__ = ["Welford", "welford_init", "welford_fold", "aggregate_init",
           "aggregate_fold", "aggregate_summary", "aggregate_to_tree",
           "aggregate_from_tree", "aggregates_to_host", "SweepEngine",
           "ROUND_METRICS", "SCALAR_METRICS", "stream_bases",
           "final_accuracy_ci_halfwidth", "point_converged"]

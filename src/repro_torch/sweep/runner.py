"""Resumable sweep execution: chunk cursor + Welford carry on disk.

Port of ``repro.sweep.runner``.  The runner walks
:meth:`SweepSpec.schedule`, the flat ``(point, global_start, size)``
chunk list, and checkpoints the O(R) state through
``checkpoint.msgpack_ckpt`` every ``checkpoint_every`` chunks: every
point's Welford carry under ``aggs/<point index>/<group>/<metric>/
<count|mean|m2|min|max>``, and the cursor and spec fingerprint in the
meta, the reference's layout, so either implementation reads the
other's file.  A killed sweep resumes **bit for bit**: scenarios are
seeded by global index (chunking does not move them), the chunk
schedule is part of the fingerprint, and the fold re-enters at the
chunk the cursor names, so the resumed summaries equal an uninterrupted
run's exactly.

``jsonl_path`` streams one JSON line of scalar aggregates per chunk for
a dashboard; on resume the file is rewound to the checkpoint's cursor
before appending (``telemetry.sinks.jsonl_rewind``).  With
``SweepSpec.ci_target`` a point's remaining chunks are skipped once its
final-accuracy CI is tight enough.  ``store_path`` appends one record
per completed point to the metrics store (``telemetry.store``).

A checkpoint is refused, with ``ValueError``, when its container
version is newer (``msgpack_ckpt.FORMAT_VERSION``), its state version
is not :data:`STATE_VERSION`, its round-metric arity differs, its
fingerprint is another spec's, or its target accuracy is another one.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
from torch import nn

from repro_torch.checkpoint import msgpack_ckpt
from repro_torch.core import federated
from repro_torch.data import partition as partition_lib
from repro_torch.device import DeviceLike
from repro_torch.launch import mesh as mesh_lib
from repro_torch.sweep import engine as engine_lib
from repro_torch.sweep import grid as grid_lib
from repro_torch.telemetry import sinks
from repro_torch.telemetry import store as store_lib

# Version of the runner's resume-state layout inside the checkpoint
# meta/tree (independent of the msgpack container version).
STATE_VERSION = 1

Results = List[Tuple[grid_lib.GridPoint, Dict[str, Dict[str, np.ndarray]]]]


def _tree_from_flat(flat: dict) -> dict:
    """Rebuild the nested dict ``msgpack_ckpt`` flattened ('/'
    separator; the keys are point indices and metric names)."""
    tree: dict = {}
    for path, leaf in flat.items():
        parts = path.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf
    return tree


@dataclasses.dataclass
class SweepRunner:
    """Drives a :class:`SweepEngine` through its chunk schedule with
    checkpointed progress.

    ``max_chunks`` bounds how many chunks one :meth:`run` call executes
    (run until evicted, resume later); skipped chunks do not count.
    ``ckpt_path=None`` runs without checkpoints (JSONL streaming still
    works; resume does not).  Every JSONL line carries the post-chunk
    ``cursor``, so after the rewind on resume the lines always match the
    carry that produced them.  With ``spec.ci_target > 0`` a chunk whose
    point already reached the CI target is skipped: the cursor advances
    and a ``"skipped": true`` line is streamed.
    """

    engine: engine_lib.SweepEngine
    ckpt_path: Optional[str]
    checkpoint_every: int = 1
    jsonl_path: Optional[str] = None
    store_path: Optional[str] = None

    def __post_init__(self):
        self.spec = self.engine.spec
        self._schedule = self.spec.schedule()
        self._points = self.engine.points

    # -- JSONL streaming -------------------------------------------------

    def _jsonl_emit(self, cursor: int, point: grid_lib.GridPoint,
                    start: int, size: int, agg, skipped: bool) -> None:
        if self.jsonl_path is None:
            return

        def _num(x) -> Optional[float]:
            v = float(x)
            return v if math.isfinite(v) else None

        summary = engine_lib.aggregate_summary(agg)
        scalars = {
            name.split(".", 1)[1]: {
                "mean": _num(stats["mean"]),
                "std": _num(stats["std"]),
                "min": _num(stats["min"]),
                "max": _num(stats["max"]),
                "count": float(stats["count"]),
            }
            for name, stats in summary.items()
            if name.startswith("scalar.")
        }
        sinks.jsonl_append(self.jsonl_path, {
            "cursor": cursor,
            "point": point.index,
            "point_name": point.name,
            "global_start": start,
            "size": size,
            "skipped": skipped,
            "scalar": scalars,
        })

    # -- state <-> disk --------------------------------------------------

    def _save(self, aggs: Dict[int, engine_lib.Aggregate],
              cursor: int) -> None:
        if self.ckpt_path is None:
            return
        # Keyed by the stable point index, not the name (names can
        # collide and may contain '/'); every carry in one copy.
        tree = {"aggs": engine_lib.aggregates_to_host(
            {str(i): a for i, a in aggs.items()})}
        msgpack_ckpt.save(self.ckpt_path, tree, meta={
            "state_version": STATE_VERSION,
            "cursor": cursor,
            "fingerprint": self.spec.fingerprint(),
            # Shapes the folded rounds_to_target / reached_target.
            "target_accuracy": self.engine.target_accuracy,
            "total_chunks": len(self._schedule),
            # The per-round metrics folded: another count is another
            # carry layout.
            "round_metrics_arity": len(engine_lib.ROUND_METRICS),
            "point_names": {str(p.index): p.name for p in self._points},
        })

    def _load(self) -> Tuple[Dict[int, engine_lib.Aggregate], int]:
        flat, meta = msgpack_ckpt.load_flat(self.ckpt_path)
        version = meta.get("state_version", 0)
        if version != STATE_VERSION:
            raise ValueError(
                f"{self.ckpt_path}: sweep state version {version} != "
                f"supported {STATE_VERSION}")
        arity = meta.get("round_metrics_arity", -1)
        if arity != len(engine_lib.ROUND_METRICS):
            raise ValueError(
                f"{self.ckpt_path}: checkpoint was written with "
                f"{'an unstamped' if arity < 0 else arity} round-metric "
                f"arity but this build folds "
                f"{len(engine_lib.ROUND_METRICS)} per-round metrics "
                f"({', '.join(engine_lib.ROUND_METRICS)}) — the Welford "
                f"aggregate layout changed, so this checkpoint cannot "
                f"be resumed.  Delete it (or point ckpt_path elsewhere) "
                f"and re-run the sweep from scratch.")
        if meta.get("fingerprint") != self.spec.fingerprint():
            raise ValueError(
                f"{self.ckpt_path}: checkpoint was written for a "
                f"different SweepSpec (fingerprint mismatch) — refusing "
                f"to fold incompatible scenario populations")
        if meta.get("target_accuracy") != self.engine.target_accuracy:
            raise ValueError(
                f"{self.ckpt_path}: checkpoint target_accuracy "
                f"{meta.get('target_accuracy')} != engine's "
                f"{self.engine.target_accuracy} — the rounds_to_target "
                f"scalars would mix judgments against two targets")
        tree = _tree_from_flat(flat)
        aggs = {int(idx): engine_lib.aggregate_from_tree(sub,
                                                         self.engine.dev)
                for idx, sub in tree.get("aggs", {}).items()}
        return aggs, int(meta["cursor"])

    # -- execution -------------------------------------------------------

    def run(self, resume: bool = True,
            max_chunks: Optional[int] = None) -> Optional[Results]:
        """Execute (the rest of) the sweep.

        Returns per-point ``(GridPoint, summary)`` in grid order once
        every chunk has run; ``None`` if stopped early by ``max_chunks``
        (the state is checkpointed either way).
        """
        aggs: Dict[int, engine_lib.Aggregate] = {}
        cursor = 0
        if resume and self.ckpt_path is not None \
                and os.path.exists(self.ckpt_path):
            aggs, cursor = self._load()
        if self.jsonl_path is not None:
            sinks.jsonl_rewind(self.jsonl_path, cursor)
        executed = 0
        while cursor < len(self._schedule):
            if max_chunks is not None and executed >= max_chunks:
                self._save(aggs, cursor)
                return None
            point_idx, start, size = self._schedule[cursor]
            point = self._points[point_idx]
            agg = aggs.get(point_idx)
            skipped = agg is not None and engine_lib.point_converged(
                agg, self.spec.ci_target)
            if not skipped:
                if agg is None:
                    agg = engine_lib.aggregate_init(
                        federated.sim_length(point.fl), self.engine.dev)
                agg = self.engine.run_chunk(point, start, size, agg)
                aggs[point_idx] = agg
                executed += 1
            cursor += 1
            self._jsonl_emit(cursor, point, start, size, agg, skipped)
            if cursor % self.checkpoint_every == 0 \
                    or cursor == len(self._schedule):
                self._save(aggs, cursor)
        out = [(self._points[i], engine_lib.aggregate_summary(aggs[i]))
               for i in sorted(aggs)]
        self._store_append(out)
        return out

    # -- cross-run metrics store -----------------------------------------

    def _store_append(self, results: Results) -> None:
        """One store record per completed grid point: the scenario-mean
        scalars under the store's names (the carry holds no per-device
        arrays, so the fairness indices are absent)."""
        if self.store_path is None:
            return
        for point, summary in results:
            def _mean(name: str) -> Optional[float]:
                st = summary.get(f"scalar.{name}")
                if st is None or float(st["count"]) <= 0:
                    return None
                v = float(st["mean"])
                return v if math.isfinite(v) else None

            metrics = {
                "final_acc": _mean("final_accuracy"),
                "rounds_to_target": _mean("rounds_to_target"),
                "total_energy_j": _mean("energy_total"),
                "energy_per_device_j": _mean("energy_per_device"),
            }
            store_lib.append_run(
                self.store_path, metrics, run=f"sweep/{point.name}",
                configs=(self.spec,),
                extra={"point": point.index,
                       "spec_fingerprint": self.spec.fingerprint()})


def run_sweep(spec: grid_lib.SweepSpec, *, model: nn.Module,
              data: partition_lib.ClientDataset,
              ckpt_path: Optional[str] = None,
              target_accuracy: float = 0.85, resume: bool = True,
              jsonl_path: Optional[str] = None,
              telemetry_dir: Optional[str] = None,
              store_path: Optional[str] = None,
              mesh: Optional[mesh_lib.Mesh] = None,
              use_sharding: bool = True,
              device: DeviceLike = None) -> Optional[Results]:
    """One-call sweep: build the engine, optionally resume from
    ``ckpt_path``, stream per-chunk aggregates to ``jsonl_path``, write
    per-scenario telemetry under ``telemetry_dir`` and one store record
    per point to ``store_path``; returns per-point summaries.
    ``mesh`` / ``use_sharding``: the engine's scenario mesh.
    ``device=None`` means the CUDA card."""
    eng = engine_lib.SweepEngine(
        spec, model=model, data=data, target_accuracy=target_accuracy,
        telemetry_dir=telemetry_dir, mesh=mesh, use_sharding=use_sharding,
        device=device)
    if ckpt_path is None and jsonl_path is None and store_path is None:
        # run_point honours spec.ci_target itself: the runner is needed
        # only for checkpoints, the JSONL stream and the store.
        return eng.run()
    return SweepRunner(eng, ckpt_path, jsonl_path=jsonl_path,
                       store_path=store_path).run(resume=resume)


__all__ = ["SweepRunner", "run_sweep", "STATE_VERSION"]

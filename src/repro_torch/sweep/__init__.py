"""Resumable Monte-Carlo sweeps (port of ``repro.sweep``).

``grid``   — declarative scenario grids (SweepSpec / Axis / GridPoint),
             each scenario seeded by its global index, chunk-invariant.
``engine`` — chunks through ``run_federated_batch`` on one device and
             the online Welford fold (O(R) state per grid point).
``runner`` — resumable execution: the Welford carry and the grid cursor
             checkpointed through ``checkpoint.msgpack_ckpt``.
"""

from repro_torch.sweep.grid import Axis, GridPoint, SweepSpec
from repro_torch.sweep.engine import (SweepEngine, Welford,
                                      aggregate_summary, welford_fold,
                                      welford_init)
from repro_torch.sweep.runner import SweepRunner, run_sweep

__all__ = ["Axis", "GridPoint", "SweepSpec", "SweepEngine", "Welford",
           "aggregate_summary", "welford_fold", "welford_init",
           "SweepRunner", "run_sweep"]

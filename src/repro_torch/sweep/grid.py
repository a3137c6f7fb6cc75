"""Declarative scenario grids for Monte-Carlo sweeps.

Port of ``repro.sweep.grid`` on the port's configs.  A
:class:`SweepSpec` names the base configs (:class:`FLConfig`,
:class:`SchedulerConfig`, :class:`WirelessConfig`) and a tuple of
:class:`Axis` overrides; :meth:`SweepSpec.expand` takes their cartesian
product, one :class:`GridPoint` per combination.  Every grid point runs
``scenarios_per_point`` scenarios, numbered by a **global scenario
index**: slot ``j`` of every point under common random numbers (the
default: paired comparisons on the same channel draws), or the disjoint
``point.index * scenarios_per_point + j`` otherwise.

Scenario ``i``'s network comes from ``wireless.sample_networks_indexed``
and its random tape from ``federated.scenario_seeds``, both seeded by
``wireless.fold_seed`` of the sweep's base seeds and ``i``
(``engine.stream_bases``), so a scenario depends only on
``(SweepSpec.base_seed, i)``: chunk size and order never change it,
which is what makes a resumed sweep the same Monte-Carlo estimate.

The ``stream``, ``comp``, ``fault`` and ``async`` targets patch fields of
``fl.stream``, ``fl.compression``, ``fl.faults`` and ``fl.events``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools
from typing import Any, List, Tuple

from repro_torch.core import federated, scheduler, wireless

# Axis targets -> which base config the field override applies to.
TARGETS = ("fl", "sched", "wireless", "stream", "comp", "fault", "async")

# Sub-config targets: (FLConfig field, what to set to sweep its knobs).
_SUB = {"stream": ("stream", "a StreamConfig", "streaming knobs"),
        "comp": ("compression", "a CompressionConfig", "codec knobs"),
        "fault": ("faults", "a FaultConfig", "unreliable-edge knobs"),
        "async": ("events", "an EventConfig", "event-scan knobs")}


@dataclasses.dataclass(frozen=True)
class Axis:
    """One swept dimension: ``target.field`` ranging over ``values``."""

    target: str    # fl | sched | wireless | stream | comp | fault | async
    field: str
    values: Tuple[Any, ...]

    def __post_init__(self):
        if self.target not in TARGETS:
            raise ValueError(f"unknown axis target {self.target!r}; "
                             f"expected one of {TARGETS}")
        if not self.values:
            raise ValueError(f"axis {self.target}.{self.field}: empty "
                             f"value tuple")


@dataclasses.dataclass(frozen=True)
class GridPoint:
    """One fully-resolved configuration of the sweep grid."""

    index: int                      # row-major position in the grid
    name: str       # "method=das,n_fixed=3" ("base" if no axes)
    fl: federated.FLConfig
    sched: scheduler.SchedulerConfig
    wireless: wireless.WirelessConfig
    overrides: Tuple[Tuple[str, str, Any], ...]  # (target, field, value)


def _check_field(cfg: Any, target: str, field: str) -> None:
    names = {f.name for f in dataclasses.fields(cfg)}
    if field not in names:
        raise ValueError(f"axis {target}.{field}: {type(cfg).__name__} "
                         f"has no field {field!r}")


def _replace(cfg: Any, target: str, field: str, value: Any) -> Any:
    _check_field(cfg, target, field)
    return dataclasses.replace(cfg, **{field: value})


def _apply(fl: federated.FLConfig, sched: scheduler.SchedulerConfig,
           wcfg: wireless.WirelessConfig,
           overrides: Tuple[Tuple[str, str, Any], ...]):
    for target, field, value in overrides:
        if target == "fl":
            fl = _replace(fl, target, field, value)
        elif target == "sched":
            sched = _replace(sched, target, field, value)
        elif target == "wireless":
            wcfg = _replace(wcfg, target, field, value)
        else:
            name, what, knobs = _SUB[target]
            sub = getattr(fl, name)
            if sub is None:
                hint = ("; for sync-vs-async itself use Axis(target='fl', "
                        "field='events', values=(None, EventConfig(...)))"
                        if target == "async" else "")
                raise ValueError(
                    f"axis {target}.{field}: base FLConfig.{name} is None "
                    f"(set {what} to sweep {knobs}{hint})")
            fl = dataclasses.replace(
                fl, **{name: _replace(sub, target, field, value)})
    return fl, sched, wcfg


def _fmt(value: Any) -> str:
    if isinstance(value, float):
        return f"{value:g}"
    return str(value)


@dataclasses.dataclass(frozen=True)
class SweepSpec:
    """A Monte-Carlo sweep: config grid x scenarios, chunked for execution.

    ``chunk_scenarios`` bounds how many scenarios one
    ``run_federated_batch`` call runs (0 = all of a point's scenarios in
    one chunk).  Chunking is an execution detail (scenario streams do
    not depend on it) but it is part of the resume schedule, so it joins
    :meth:`fingerprint`.

    ``ci_target > 0`` stops a point early: once its final-accuracy 95%
    CI half-width (from the Welford carry) is at or below ``ci_target``,
    its remaining chunks are skipped.  It is deterministic given the
    folded chunks, so resumes reproduce it, and joins the fingerprint.

    ``common_random_numbers`` (the default): every grid point runs the
    same scenario indices ``0..S-1``, the same channel and random draws,
    for paired comparisons across points (DAS against random on the same
    fading draws).  False gives each point its own index range.
    """

    fl: federated.FLConfig = federated.FLConfig()
    sched: scheduler.SchedulerConfig = scheduler.SchedulerConfig()
    wireless: wireless.WirelessConfig = wireless.WirelessConfig()
    axes: Tuple[Axis, ...] = ()
    scenarios_per_point: int = 4
    chunk_scenarios: int = 0        # 0 -> one chunk per grid point
    base_seed: int = 0
    eval_every: int = 1
    ci_target: float = 0.0          # 0 -> fixed scenario counts
    common_random_numbers: bool = True

    # -- grid expansion -------------------------------------------------

    def expand(self) -> List[GridPoint]:
        points: List[GridPoint] = []
        combos = itertools.product(*[ax.values for ax in self.axes]) \
            if self.axes else [()]
        for index, combo in enumerate(combos):
            overrides = tuple(
                (ax.target, ax.field, v)
                for ax, v in zip(self.axes, combo))
            fl, sched, wcfg = _apply(self.fl, self.sched, self.wireless,
                                     overrides)
            name = ",".join(f"{f}={_fmt(v)}" for _, f, v in overrides) \
                or "base"
            points.append(GridPoint(index=index, name=name, fl=fl,
                                    sched=sched, wireless=wcfg,
                                    overrides=overrides))
        return points

    @property
    def num_points(self) -> int:
        n = 1
        for ax in self.axes:
            n *= len(ax.values)
        return n

    @property
    def total_scenarios(self) -> int:
        return self.num_points * self.scenarios_per_point

    # -- execution schedule ---------------------------------------------

    def scenario_start(self, point_index: int) -> int:
        """Global index of the first scenario of a grid point (0 for
        every point under common random numbers)."""
        if self.common_random_numbers:
            return 0
        return point_index * self.scenarios_per_point

    def point_chunks(self) -> List[Tuple[int, int]]:
        """(offset within point, size) chunk schedule, the same for every
        point.  The Welford fold visits chunks in this order, so the
        schedule is part of the resume contract."""
        size = self.chunk_scenarios or self.scenarios_per_point
        out = []
        off = 0
        while off < self.scenarios_per_point:
            out.append((off, min(size, self.scenarios_per_point - off)))
            off += size
        return out

    def schedule(self) -> List[Tuple[int, int, int]]:
        """Flat (point_index, global_start, size) chunk list: the unit of
        work the runner checkpoints between."""
        out = []
        for p in range(self.num_points):
            base = self.scenario_start(p)
            for off, size in self.point_chunks():
                out.append((p, base + off, size))
        return out

    # -- identity --------------------------------------------------------

    def fingerprint(self) -> str:
        """Stable digest of everything that shapes the results and the
        chunk / fold schedule; a resume checkpoint with another
        fingerprint is refused (``repro_torch.sweep.runner``).  It hashes
        the port's configs' ``repr``, so it differs from the reference's
        digest of the same grid."""
        canon = repr((self.fl, self.sched, self.wireless, self.axes,
                      self.scenarios_per_point, self.chunk_scenarios,
                      self.base_seed, self.eval_every,
                      self.common_random_numbers, self.ci_target))
        return hashlib.sha1(canon.encode()).hexdigest()


__all__ = ["Axis", "GridPoint", "SweepSpec", "TARGETS"]

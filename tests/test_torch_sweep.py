"""The port's Monte-Carlo sweeps against the JAX reference's.

``repro_torch.sweep``: the grid (expansion, schedule, refusals) against
``repro.sweep.grid`` on the same specs; the Welford fold against a
float64 numpy oracle and the reference's ``aggregate_fold`` on the same
numpy-made metrics; the engine against one ``run_federated_batch`` call
on the same scenarios, across chunk sizes and both drivers; the runner's
kill / resume, refusals, JSONL stream, adaptive skips, store records and
its checkpoint layout against the reference's.  A tiny world (K = 8, an
MLP of width 16, 3 rounds, 4 scenarios a point in chunks of 2) on the
CPU; the reference's engine is not run (its compiles are what make
``tests/test_sweep.py`` slow).
"""

import dataclasses
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint import msgpack_ckpt as jckpt  # noqa: E402
from repro.core import compression as jcomp  # noqa: E402
from repro.core import events as jev  # noqa: E402
from repro.core import faults as jf  # noqa: E402
from repro.core import federated as jfed  # noqa: E402
from repro.core import scheduler as jsch  # noqa: E402
from repro.core import streaming as jst  # noqa: E402
from repro.core import wireless as jw  # noqa: E402
from repro.sweep import engine as jeng  # noqa: E402
from repro.sweep import grid as jgrid  # noqa: E402
from repro_torch import telemetry  # noqa: E402
from repro_torch.checkpoint import msgpack_ckpt as tckpt  # noqa: E402
from repro_torch.core import bandwidth as tbw  # noqa: E402
from repro_torch.core import compression as tcomp  # noqa: E402
from repro_torch.core import events as tev  # noqa: E402
from repro_torch.core import faults as tf  # noqa: E402
from repro_torch.core import federated as tfed  # noqa: E402
from repro_torch.core import scheduler as tsch  # noqa: E402
from repro_torch.core import streaming as tst  # noqa: E402
from repro_torch.core import wireless as tw  # noqa: E402
from repro_torch.data import partition, synthetic  # noqa: E402
from repro_torch.models import paper_nets  # noqa: E402
from repro_torch.sweep import engine as teng  # noqa: E402
from repro_torch.sweep import grid as tgrid  # noqa: E402
from repro_torch.sweep import runner as trun  # noqa: E402
from repro_torch.telemetry import sinks  # noqa: E402
from repro_torch.telemetry import store  # noqa: E402

TARGET = 0.5
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


@pytest.fixture(autouse=True)
def one_thread():
    """Small tensors: one intra-op thread, so the test workers that share
    the machine do not oversubscribe its cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def world():
    """K = 8 devices over 100 shards of 50, an MLP of width 16 (width 8
    collapses to a class the test split lacks: accuracy 0 throughout)."""
    imgs, labels = synthetic.generate(0, samples_per_class=600)
    data = partition.partition(imgs, labels, seed=1,
                               spec=partition.PartitionSpec(
                                   num_devices=8, num_shards=100,
                                   shard_size=50))
    model = paper_nets.init(paper_nets.PaperNetSpec(kind="mlp",
                                                    mlp_hidden=16),
                            torch.Generator().manual_seed(3))
    return data, model


def _spec(**kw) -> tgrid.SweepSpec:
    base = dict(
        fl=tfed.FLConfig(num_rounds=3, batch_size=50, learning_rate=0.1),
        sched=tsch.SchedulerConfig(method="das", n_min=2, iterations_max=3,
                                   allocator="waterfilling"),
        wireless=tw.WirelessConfig(),
        scenarios_per_point=4, chunk_scenarios=2, base_seed=7)
    base.update(kw)
    return tgrid.SweepSpec(**base)


def _engine(world, spec=None, **kw):
    data, model = world
    return teng.SweepEngine(spec or _spec(), model=model, data=data,
                            target_accuracy=TARGET, device="cpu", **kw)


@pytest.fixture(scope="module")
def engine(world):
    return _engine(world)


@pytest.fixture(scope="module")
def full(engine, tmp_path_factory):
    """An uninterrupted runner's results on the module's engine."""
    ck = str(tmp_path_factory.mktemp("full") / "full.msgpack")
    return trun.SweepRunner(engine, ck).run()


def _assert_summaries_equal(a, b):
    for (p, s), (q, t) in zip(a, b):
        assert p.name == q.name
        assert s.keys() == t.keys()
        for metric in s:
            for field in s[metric]:
                np.testing.assert_array_equal(
                    s[metric][field], t[metric][field],
                    err_msg=f"{p.name}/{metric}/{field}")


# ---------------------------------------------------------------------------
# The grid
# ---------------------------------------------------------------------------

FAULTS = dict(drop_prob=0.1, max_retries=1)
EVENTS = dict(availability="churn", buffer_size=2, staleness_decay=0.5,
              tick_horizon=0.1)
# (target, field, values) of each of the 7 targets.
TARGET_AXES = {
    "fl": ("local_epochs", (1, 2)),
    "sched": ("method", ("das", "random")),
    "wireless": ("model_bits", (1e5, 1e6)),
    "stream": ("rate", (5.0, 25.0)),
    "comp": ("bit_width", (4, 8)),
    "fault": ("drop_prob", (0.1, 0.3)),
    "async": ("buffer_size", (1, 2)),
}
SUB = {"stream": "stream", "comp": "compression", "fault": "faults",
       "async": "events"}


def _subsystems(ref: bool) -> dict:
    st, co, fa, ev = (jst, jcomp, jf, jev) if ref else (tst, tcomp, tf, tev)
    return dict(stream=st.StreamConfig(process="poisson"),
                compression=co.CompressionConfig(codec="quant"),
                faults=fa.FaultConfig(**FAULTS),
                events=ev.EventConfig(**EVENTS))


def _pair(axes, subsystems=True, **kw):
    """The same spec on the reference's configs and the port's."""
    out = []
    for ref in (True, False):
        fed, sch, w, grid = (jfed, jsch, jw, jgrid) if ref else \
            (tfed, tsch, tw, tgrid)
        sub = _subsystems(ref) if subsystems else {}
        out.append(grid.SweepSpec(
            fl=fed.FLConfig(num_rounds=3, **sub),
            sched=sch.SchedulerConfig(n_min=2),
            wireless=w.WirelessConfig(),
            axes=tuple(grid.Axis(*a) for a in axes), **kw))
    return out


GRID_CASES = {
    **{f"target-{t}": dict(axes=[(t, *TARGET_AXES[t])])
       for t in TARGET_AXES},
    "two-axes-crn": dict(axes=[("sched", "n_fixed", (3, 5)),
                               ("sched", "method", ("das", "random"))],
                         scenarios_per_point=4, chunk_scenarios=2),
    "no-crn": dict(axes=[("sched", "method", ("das", "random"))],
                   scenarios_per_point=4, chunk_scenarios=2,
                   common_random_numbers=False),
    "remainder-chunk": dict(axes=[("fl", "learning_rate", (0.05, 0.1, 0.2))],
                            scenarios_per_point=5, chunk_scenarios=2,
                            common_random_numbers=False),
    "one-chunk": dict(axes=[], scenarios_per_point=3, chunk_scenarios=0),
}


@pytest.mark.parametrize("case", list(GRID_CASES))
def test_grid_expansion_and_schedule_match_reference(case):
    kw = dict(GRID_CASES[case])
    axes = kw.pop("axes")
    jspec, tspec = _pair(axes, **kw)
    jp, tp = jspec.expand(), tspec.expand()
    assert [p.name for p in tp] == [p.name for p in jp]
    assert [p.index for p in tp] == [p.index for p in jp]
    assert [p.overrides for p in tp] == [p.overrides for p in jp]
    for a, b in zip(jp, tp):
        for target, field, value in b.overrides:
            cfg = {"fl": b.fl, "sched": b.sched, "wireless": b.wireless}.get(
                target) or getattr(b.fl, SUB[target])
            jcfg = {"fl": a.fl, "sched": a.sched, "wireless": a.wireless
                    }.get(target) or getattr(a.fl, SUB[target])
            assert getattr(cfg, field) == getattr(jcfg, field) == value
    assert tspec.schedule() == jspec.schedule()
    assert tspec.point_chunks() == jspec.point_chunks()
    assert (tspec.num_points, tspec.total_scenarios) == \
        (jspec.num_points, jspec.total_scenarios)
    assert [tspec.scenario_start(p) for p in range(tspec.num_points)] == \
        [jspec.scenario_start(p) for p in range(jspec.num_points)]
    # The base configs are untouched by the expansion.
    assert tspec.sched.method == "das" and tspec.fl.local_epochs == 1


@pytest.mark.parametrize("mistake", [
    "unknown-target", "empty-axis", "unknown-field", *[
        f"none-{t}" for t in ("stream", "comp", "fault", "async")]])
def test_grid_refuses_what_the_reference_refuses(mistake):
    errors = []
    for ref in (True, False):
        grid = jgrid if ref else tgrid
        try:
            if mistake == "unknown-target":
                grid.Axis("nope", "x", (1,))
            elif mistake == "empty-axis":
                grid.Axis("sched", "method", ())
            else:
                if mistake == "unknown-field":
                    axes = [("sched", "no_such_knob", (1,))]
                else:
                    t = mistake.split("-")[1]
                    axes = [(t, TARGET_AXES[t][0], TARGET_AXES[t][1])]
                _pair(axes, subsystems=False)[0 if ref else 1].expand()
        except ValueError as e:
            errors.append(str(e))
    assert len(errors) == 2
    assert errors[1] == errors[0]


def test_fingerprint_is_stable_and_sensitive():
    spec = _spec(axes=(tgrid.Axis("sched", "method", ("das", "random")),),
                 fl=tfed.FLConfig(num_rounds=3, stream=tst.StreamConfig()))
    code = ("from repro_torch.sweep import grid; "
            "from repro_torch.core import federated, scheduler, streaming; "
            "print(grid.SweepSpec(fl=federated.FLConfig(num_rounds=3, "
            "stream=streaming.StreamConfig()), sched=scheduler."
            "SchedulerConfig(method='das', n_min=2, iterations_max=3, "
            "allocator='waterfilling'), axes=(grid.Axis('sched', 'method', "
            "('das', 'random')),), scenarios_per_point=4, chunk_scenarios=2, "
            "base_seed=7).fingerprint())")
    other = subprocess.run([sys.executable, "-c", code], capture_output=True,
                           text=True, check=True,
                           env=dict(os.environ, PYTHONPATH=SRC,
                                    PYTHONHASHSEED="123"))
    assert other.stdout.strip() == spec.fingerprint()
    changed = [
        dict(fl=dataclasses.replace(spec.fl, learning_rate=0.2)),
        dict(fl=dataclasses.replace(spec.fl, stream=tst.StreamConfig(
            rate=21.0))),
        dict(sched=dataclasses.replace(spec.sched, n_min=3)),
        dict(wireless=tw.WirelessConfig(model_bits=2e5)),
        dict(axes=(tgrid.Axis("sched", "method", ("das", "abs")),)),
        dict(scenarios_per_point=6), dict(chunk_scenarios=4),
        dict(base_seed=8), dict(eval_every=2),
        dict(common_random_numbers=False), dict(ci_target=0.01),
    ]
    prints = {dataclasses.replace(spec, **c).fingerprint() for c in changed}
    assert len(prints) == len(changed) and spec.fingerprint() not in prints
    assert dataclasses.replace(spec, chunk_scenarios=2).fingerprint() == \
        spec.fingerprint()


# ---------------------------------------------------------------------------
# The fold
# ---------------------------------------------------------------------------

def _fold_in_chunks(data, sizes, mask=None):
    state = teng.welford_init(data.shape[1:], "cpu")
    off = 0
    for s in sizes:
        m = None if mask is None else torch.from_numpy(mask[off:off + s])
        state = teng.welford_fold(state, torch.from_numpy(data[off:off + s]),
                                  m)
        off += s
    assert off == data.shape[0]
    return state


def _oracle_close(got, want):
    """rtol 1e-6 against the float64 oracle, atol 1e-6 near 0."""
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("sizes", [(12,), (4, 4, 4), (1, 11), (3, 1, 2, 6),
                                   (1,) * 12])
def test_welford_matches_float64_oracle_across_chunkings(sizes):
    """The reference's own check of this fold holds it at atol 1e-6 on a
    variance of ~14, one float32 ulp; here rtol 1e-6 against float64."""
    data = (np.random.default_rng(0).standard_normal((12, 5)) * 3.0 + 1.0
            ).astype(np.float32)
    st = _fold_in_chunks(data, sizes)
    d64 = data.astype(np.float64)
    _oracle_close(st.mean, d64.mean(axis=0))
    _oracle_close(st.variance, d64.var(axis=0))
    np.testing.assert_array_equal(st.min.numpy(), data.min(axis=0))
    np.testing.assert_array_equal(st.max.numpy(), data.max(axis=0))
    np.testing.assert_array_equal(st.count.numpy(), 12.0)


def test_welford_excludes_nan_and_masked_entries():
    data = np.random.default_rng(2).normal(size=(6, 4)).astype(np.float32)
    data[::2, 1] = np.nan
    data[:, 3] = np.nan
    st = _fold_in_chunks(data, (2, 1, 3))
    d64 = data[:, :2].astype(np.float64)
    _oracle_close(st.mean[:2], np.nanmean(d64, axis=0))
    _oracle_close(st.variance[:2], np.nanvar(d64, axis=0))
    np.testing.assert_array_equal(st.count.numpy(), [6.0, 3.0, 6.0, 0.0])
    assert np.isnan(st.variance.numpy()[3])
    mask = np.ones_like(data, dtype=bool)
    mask[4:, 0] = False
    st = _fold_in_chunks(data, (4, 2), mask)
    _oracle_close(st.mean[:1], d64[:4, 0].mean(keepdims=True))
    assert float(st.max[0]) == float(np.max(data[:4, 0]))
    assert float(st.count[0]) == 4.0


def _metrics(seed, s, r, k=5):
    """(S, R) round metrics made with numpy: NaN accuracy on the rounds
    an eval stride of 2 skips, and one scenario that never reaches
    TARGET."""
    rng = np.random.default_rng(seed)
    acc = np.clip(np.cumsum(rng.uniform(0.0, 0.3, (s, r)), axis=1), 0, 1)
    acc[0] = np.minimum(acc[0], TARGET - 0.1)
    acc[:, 1::2] = np.nan
    sel = (rng.random((s, r, k)) < 0.6).astype(np.float32)
    energy = rng.uniform(0.0, 2.0, (s, r, k)).astype(np.float32) * sel
    n_sel = sel.sum(-1).astype(np.int32)
    fields = dict(
        accuracy=acc.astype(np.float32), n_selected=n_sel,
        round_time=rng.uniform(0.1, 3.0, (s, r)).astype(np.float32),
        energy=energy, energy_total=energy.sum(-1), selected=sel,
        iterations=rng.integers(1, 4, (s, r)).astype(np.int32),
        n_success=np.maximum(n_sel - rng.integers(0, 2, (s, r)), 0
                             ).astype(np.int32),
        n_dropped=rng.integers(0, 2, (s, r)).astype(np.int32))
    return fields


def test_aggregate_fold_matches_reference():
    """The same numpy-made metrics through both folds, chunk by chunk:
    every summary field within rtol 1e-6, counts and rounds_to_target
    equal."""
    r = 5
    tagg, jagg = teng.aggregate_init(r, "cpu"), jeng.aggregate_init(r)
    jfold = jax.jit(jeng.aggregate_fold, static_argnums=(2,))
    for seed, s in ((0, 3), (1, 1), (2, 4)):
        m = _metrics(seed, s, r)
        tagg = teng.aggregate_fold(tagg, tfed.RoundMetrics(
            **{n: torch.from_numpy(v) for n, v in m.items()}), TARGET)
        jagg = jfold(jagg, jfed.RoundMetrics(
            **{n: jnp.asarray(v) for n, v in m.items()}), TARGET)
    got, want = teng.aggregate_summary(tagg), jeng.aggregate_summary(jagg)
    assert got.keys() == want.keys()
    for name in want:
        for field in want[name]:
            g, w = np.asarray(got[name][field]), np.asarray(want[name][field])
            assert g.shape == w.shape and g.dtype == w.dtype, (name, field)
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7,
                                       err_msg=f"{name}.{field}")
    assert float(want["scalar.rounds_to_target"]["count"]) < 8
    for name in ("scalar.rounds_to_target", "scalar.reached_target"):
        for field in ("count", "min", "max"):
            np.testing.assert_array_equal(got[name][field],
                                          want[name][field])
    np.testing.assert_array_equal(got["round.accuracy"]["count"],
                                  want["round.accuracy"]["count"])


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------

def _oracle_summary(metrics, target):
    """A float64 numpy fold of one batch's (S, R) metrics."""
    acc = metrics.accuracy.numpy().astype(np.float64)
    out = {}
    for name in ("accuracy", "round_time", "energy_total", "n_selected"):
        v = getattr(metrics, name).numpy().astype(np.float64)
        out[f"round.{name}"] = dict(mean=np.nanmean(v, 0), var=np.nanvar(v, 0),
                                    min=np.nanmin(v, 0), max=np.nanmax(v, 0))
    reached = (acc >= target).any(1)
    first = np.argmax(acc >= target, 1) + 1.0
    out["scalar.final_accuracy"] = dict(mean=acc[:, -1].mean(),
                                        var=acc[:, -1].var())
    out["scalar.time_total"] = dict(
        mean=metrics.round_time.numpy().astype(np.float64).sum(1).mean())
    out["scalar.reached_target"] = dict(mean=reached.mean())
    if reached.any():
        out["scalar.rounds_to_target"] = dict(mean=first[reached].mean())
    return out


def _point_against_batch(world, spec, point_index=0):
    """One point through the engine, and one run_federated_batch call on
    the same nets and seeds folded by the oracle."""
    data, model = world
    eng = _engine(world, spec)
    point = eng.points[point_index]
    got = teng.aggregate_summary(eng.run_point(point))
    net_base, sim_base = teng.stream_bases(spec.base_seed)
    s, start = spec.scenarios_per_point, spec.scenario_start(point_index)
    nets = tw.sample_networks_indexed(net_base, range(start, start + s),
                                      data.num_devices, point.wireless)
    _, metrics = tfed.run_federated_batch(
        model=model, data=data, nets=nets, wcfg=point.wireless,
        scfg=point.sched, fcfg=point.fl,
        seeds=tfed.scenario_seeds(sim_base, start, s), device="cpu")
    return got, _oracle_summary(metrics, TARGET), metrics


@pytest.mark.parametrize("stream", [False, True])
def test_point_equals_the_fold_of_one_batch_call(world, stream):
    """Two chunks of 2 against one batch of 4 on the same scenarios: on
    the CPU each batch scenario is bit for bit its own run, so only the
    fold's order differs (within 1e-6).  With streaming data the engine
    passes its one copy of the client histograms to every chunk."""
    spec = _spec()
    if stream:
        spec = _spec(fl=tfed.FLConfig(num_rounds=2, batch_size=50,
                                      learning_rate=0.1,
                                      stream=tst.StreamConfig()),
                     axes=(tgrid.Axis("stream", "rate", (15.0,)),))
    got, want, metrics = _point_against_batch(world, spec)
    assert float(metrics.accuracy.min()) > 0.0
    for name, fields in want.items():
        for field, value in fields.items():
            np.testing.assert_allclose(got[name][field], value, rtol=1e-6,
                                       atol=1e-6, err_msg=f"{name}.{field}")
    assert float(got["scalar.final_accuracy"]["count"]) == 4


def test_stream_bases_are_fold_seed_salts():
    assert teng.stream_bases(7) == (tw.fold_seed(7, 0), tw.fold_seed(7, 1))
    assert teng.stream_bases(7) != teng.stream_bases(8)


def test_chunk_size_does_not_move_the_point(world, engine):
    """Chunks of 1, 2 and 4 against each other within the reference's
    rtol 2e-5 / atol 1e-6."""
    base = teng.aggregate_summary(engine.run_point(engine.points[0]))
    for chunk in (1, 4):
        eng = _engine(world, dataclasses.replace(engine.spec,
                                                 chunk_scenarios=chunk))
        summary = teng.aggregate_summary(eng.run_point(eng.points[0]))
        for metric in base:
            for field in base[metric]:
                np.testing.assert_allclose(
                    summary[metric][field], base[metric][field], rtol=2e-5,
                    atol=1e-6, err_msg=f"{metric}.{field} chunk={chunk}")


def test_common_random_numbers_pair_the_points(world):
    """Under CRN every point runs the same scenarios: an axis that does
    not act (the staleness weight, with static data) gives bitwise-equal
    points."""
    eng = _engine(world, _spec(axes=(
        tgrid.Axis("sched", "staleness_weight", (0.0, 0.5)),)))
    s0 = teng.aggregate_summary(eng.run_point(eng.points[0]))
    s1 = teng.aggregate_summary(eng.run_point(eng.points[1]))
    for metric in s0:
        for field in s0[metric]:
            np.testing.assert_array_equal(s0[metric][field],
                                          s1[metric][field])


def test_event_axis_runs_both_drivers(world):
    """``fl.events`` None against an EventConfig: the synchronous point
    equals one batch call's fold, the event point runs the event driver
    (its round time is the tick)."""
    ecfg = tev.EventConfig(**dict(EVENTS, num_events=3))
    spec = _spec(axes=(tgrid.Axis("fl", "events", (None, ecfg)),),
                 scenarios_per_point=2, chunk_scenarios=1)
    got, want, _ = _point_against_batch(world, spec, point_index=1)
    np.testing.assert_allclose(got["round.round_time"]["mean"],
                               np.full(3, EVENTS["tick_horizon"]),
                               rtol=1e-6)
    for name in ("round.accuracy", "round.n_selected",
                 "round.energy_total"):
        for field, value in want[name].items():
            np.testing.assert_allclose(got[name][field], value, rtol=1e-6,
                                       atol=1e-6, err_msg=f"{name}.{field}")
    sync = teng.aggregate_summary(
        _engine(world, spec).run_point(spec.expand()[0]))
    assert not np.allclose(sync["round.round_time"]["mean"],
                           EVENTS["tick_horizon"])


def test_allocator_axis_runs_fused_pgd_and_importance(world):
    spec = _spec(sched=tsch.SchedulerConfig(method="full", n_min=2,
                                            sub2=tbw.Sub2Params.fast()),
                 axes=(tgrid.Axis("sched", "allocator",
                                  ("fused_pgd", "importance")),),
                 fl=tfed.FLConfig(num_rounds=1, batch_size=50,
                                  learning_rate=0.1),
                 scenarios_per_point=2, chunk_scenarios=2)
    results = _engine(world, spec).run()
    assert [p.name for p, _ in results] == ["allocator=fused_pgd",
                                            "allocator=importance"]
    times = []
    for _, summary in results:
        assert float(summary["scalar.final_accuracy"]["count"]) == 2
        assert np.all(np.isfinite(summary["round.energy_total"]["mean"]))
        times.append(summary["round.round_time"]["mean"])
    # The same devices (full), other energy prices: other allocations.
    assert not np.array_equal(times[0], times[1])


def test_telemetry_dir_writes_a_file_per_scenario(world, tmp_path):
    spec = _spec(fl=tfed.FLConfig(num_rounds=3, batch_size=50,
                                  learning_rate=0.1,
                                  telemetry=telemetry.TelemetryConfig()),
                 scenarios_per_point=3, chunk_scenarios=2)
    out = tmp_path / "tel"
    eng = _engine(world, spec, telemetry_dir=str(out))
    eng.run()
    names = sorted(os.listdir(out))
    assert names == ["manifest.json"] + [f"point000_scn{i:05d}.jsonl"
                                         for i in range(3)]
    manifest = json.loads((out / "manifest.json").read_text())
    assert manifest["kind"] == "sweep"
    assert manifest["fingerprint"] == spec.fingerprint()
    first = {n: (out / n).read_bytes() for n in names}
    for i in range(3):
        rows = sinks.read_jsonl(str(out / f"point000_scn{i:05d}.jsonl"))
        assert [r["round"] for r in rows] == [0, 1, 2]
        assert {r["scenario"] for r in rows} == {i}
        assert all(len(r["admitted"]) == 8 and "accuracy" in r
                   for r in rows)
    # A re-run (a resumed chunk) rewrites the same bytes.
    _engine(world, spec, telemetry_dir=str(out)).run_point(
        spec.expand()[0])
    assert {n: (out / n).read_bytes() for n in names} == first


# ---------------------------------------------------------------------------
# The runner
# ---------------------------------------------------------------------------

def test_runner_kill_resume_is_bitwise_and_rewinds_the_jsonl(engine, full,
                                                             tmp_path):
    ck, log = str(tmp_path / "sweep.msgpack"), str(tmp_path / "sweep.jsonl")
    r = trun.SweepRunner(engine, ck, jsonl_path=log)
    assert r.run(max_chunks=1) is None          # "killed" after chunk 1
    meta = tckpt.load_flat(ck)[1]
    assert meta["cursor"] == 1 and meta["state_version"] == 1
    # A line the killed run streamed past its last checkpoint.
    sinks.jsonl_append(log, {"cursor": 2, "stale": True})
    out = trun.SweepRunner(engine, ck, jsonl_path=log).run()
    _assert_summaries_equal(out, full)
    rows = sinks.read_jsonl(log)
    assert [row["cursor"] for row in rows] == [1, 2]
    assert all("stale" not in row for row in rows)
    assert rows[-1]["scalar"]["final_accuracy"]["count"] == 4.0
    assert rows[-1]["scalar"]["final_accuracy"]["mean"] == pytest.approx(
        float(full[0][1]["scalar.final_accuracy"]["mean"]))


def _rewrite(path, **meta):
    flat, old = tckpt.load_flat(path)
    tckpt.save(path, flat, meta=dict(old, **meta))


@pytest.mark.parametrize("what", ["state_version", "arity", "fingerprint",
                                  "target_accuracy", "format_version"])
def test_runner_refuses_incompatible_checkpoints(world, engine, tmp_path,
                                                 what):
    ck = str(tmp_path / "sweep.msgpack")
    trun.SweepRunner(engine, ck).run(max_chunks=0)
    runner = trun.SweepRunner(engine, ck)
    if what == "state_version":
        _rewrite(ck, state_version=0)
        match = "state version 0"
    elif what == "arity":
        _rewrite(ck, round_metrics_arity=5)
        match = "round-metric"
    elif what == "fingerprint":
        runner = trun.SweepRunner(_engine(world, dataclasses.replace(
            engine.spec, base_seed=999)), ck)
        match = "fingerprint"
    elif what == "target_accuracy":
        data, model = world
        runner = trun.SweepRunner(teng.SweepEngine(
            engine.spec, model=model, data=data, target_accuracy=0.9,
            device="cpu"), ck)
        match = "target_accuracy"
    else:
        raw = open(ck, "rb").read()
        assert raw[:1] == b"\x83" and raw[1:13] == b"\xab__version__"
        with open(ck, "wb") as f:
            f.write(raw[:13] + b"\x02" + raw[14:])
        match = "newer"
    with pytest.raises(ValueError, match=match):
        runner.run()


def test_completed_run_resumes_to_a_noop(engine, full, tmp_path,
                                         monkeypatch):
    ck = str(tmp_path / "sweep.msgpack")
    trun.SweepRunner(engine, ck).run()

    def no_chunks(*args, **kw):
        raise AssertionError("a completed sweep ran a chunk")

    monkeypatch.setattr(engine, "run_chunk", no_chunks)
    _assert_summaries_equal(trun.SweepRunner(engine, ck).run(), full)


def test_ci_target_skips_do_not_use_up_max_chunks(world, tmp_path):
    spec = _spec(axes=(tgrid.Axis("sched", "method", ("das", "random")),),
                 fl=tfed.FLConfig(num_rounds=1, batch_size=50,
                                  learning_rate=0.1),
                 sched=tsch.SchedulerConfig(method="das", n_min=2,
                                            n_fixed=3,
                                            allocator="waterfilling"),
                 ci_target=10.0)
    log = str(tmp_path / "ci.jsonl")
    runner = trun.SweepRunner(_engine(world, spec),
                              str(tmp_path / "ci.msgpack"), jsonl_path=log)
    assert runner.run(max_chunks=1) is None          # cursor 1
    # The skip of cursor 1 is free: this call runs cursor 2's chunk.
    assert runner.run(max_chunks=1) is None
    assert tckpt.load_flat(str(tmp_path / "ci.msgpack"))[1]["cursor"] == 3
    out = runner.run(max_chunks=1)                   # cursor 3 skips
    assert out is not None
    rows = sinks.read_jsonl(log)
    assert [row["cursor"] for row in rows] == [1, 2, 3, 4]
    assert [row["skipped"] for row in rows] == [False, True, False, True]
    for _, summary in out:
        assert float(summary["scalar.final_accuracy"]["count"]) == 2


def test_store_gets_one_record_per_point(world, tmp_path):
    spec = _spec(axes=(tgrid.Axis("sched", "method", ("das", "full")),),
                 fl=tfed.FLConfig(num_rounds=2, batch_size=50,
                                  learning_rate=0.1),
                 scenarios_per_point=2)
    path = str(tmp_path / "store.jsonl")
    out = trun.run_sweep(spec, model=world[1], data=world[0],
                         store_path=path, target_accuracy=TARGET,
                         device="cpu")
    recs = store.load_history(path)
    assert [r["run"] for r in recs] == ["sweep/method=das",
                                        "sweep/method=full"]
    for rec, (point, summary) in zip(recs, out):
        assert rec["point"] == point.index
        assert rec["spec_fingerprint"] == spec.fingerprint()
        assert rec["metrics"]["final_acc"] == pytest.approx(
            float(summary["scalar.final_accuracy"]["mean"]))


def test_checkpoint_layout_is_the_references(world, full, engine,
                                            tmp_path):
    """The port runner's file against one the reference writes for the
    same grid shape (its aggregate_init / aggregate_to_tree / save): the
    same keys, dtypes and shapes; and the reference's aggregate_from_tree
    and aggregate_summary of the port's file give the port's summary."""
    ck = str(tmp_path / "port.msgpack")
    trun.SweepRunner(engine, ck).run()
    ref = str(tmp_path / "ref.msgpack")
    r = jfed.sim_length(jfed.FLConfig(num_rounds=3))
    jckpt.save(ref, {"aggs": {"0": jeng.aggregate_to_tree(
        jeng.aggregate_init(r))}})
    port_flat, meta = jckpt.load_flat(ck)
    ref_flat, _ = jckpt.load_flat(ref)
    assert port_flat.keys() == ref_flat.keys()
    for key in ref_flat:
        assert port_flat[key].dtype == ref_flat[key].dtype, key
        assert port_flat[key].shape == ref_flat[key].shape, key
    assert list(meta) == ["state_version", "cursor", "fingerprint",
                          "target_accuracy", "total_chunks",
                          "round_metrics_arity", "point_names"]
    assert meta["point_names"] == {"0": "base"} and meta["cursor"] == 2
    tree = {}
    for path, leaf in port_flat.items():
        node = tree
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf
    want = jeng.aggregate_summary(jeng.aggregate_from_tree(
        tree["aggs"]["0"]))
    got = full[0][1]
    for name in want:
        for field in want[name]:
            np.testing.assert_array_equal(got[name][field],
                                          np.asarray(want[name][field]),
                                          err_msg=f"{name}.{field}")
    # And the port reads the reference's file into its carry.
    flat, _ = tckpt.load_flat(ref)
    agg = teng.aggregate_from_tree(trun._tree_from_flat(flat)["aggs"]["0"],
                                   "cpu")
    assert float(agg["round"]["accuracy"].min[0]) == np.inf

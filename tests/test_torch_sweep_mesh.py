"""The sweep engine's scenario mesh (``repro_torch.launch.mesh``).

A chunk whose size the mesh's entry count divides runs as contiguous
equal groups of scenarios, one ``run_federated_batch`` call an entry;
the metrics come back in scenario order and fold once.  On the CPU a
mesh whose four entries are all the CPU device runs the same split as
four cards would, and the batch driver's lanes are bit for bit
independent of the batch they run in, so the aggregates (and each
scenario's telemetry file) equal the unsharded engine's exactly.  A tiny
world (K = 8, an MLP of width 16, 3 rounds); no JAX.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import telemetry  # noqa: E402
from repro_torch.core import federated as tfed  # noqa: E402
from repro_torch.core import scheduler as tsch  # noqa: E402
from repro_torch.core import wireless as tw  # noqa: E402
from repro_torch.data import partition, synthetic  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.models import paper_nets  # noqa: E402
from repro_torch.sweep import engine as teng  # noqa: E402
from repro_torch.sweep import grid as tgrid  # noqa: E402
from repro_torch.sweep import runner as trun  # noqa: E402

CPU = torch.device("cpu")
MESH4 = mesh_lib.Mesh(("scenario",), (4,), (CPU,) * 4)


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
        scenarios_per_point=8, chunk_scenarios=8, base_seed=7)
    base.update(kw)
    return tgrid.SweepSpec(**base)


def _engine(world, spec, **kw):
    data, model = world
    return teng.SweepEngine(spec, model=model, data=data,
                            target_accuracy=0.5, device="cpu", **kw)


def _tree(agg):
    return {f"{g}/{n}/{f}": a for g, names in teng.aggregate_to_tree(
        agg).items() for n, fields in names.items() for f, a in fields.items()}


@pytest.fixture
def calls(monkeypatch):
    """The scenario count and device of each batch driver call."""
    seen = []
    real = tfed.run_federated_batch

    def spy(**kw):
        seen.append((len(kw["seeds"]), torch.device(kw["device"])))
        return real(**kw)

    monkeypatch.setattr(teng.federated, "run_federated_batch", spy)
    return seen


@pytest.mark.parametrize("frames", [False, True],
                         ids=["metrics", "telemetry"])
def test_four_entry_mesh_equals_unsharded(world, calls, tmp_path, frames):
    """A chunk of 8 over 4 entries runs as 4 calls of 2 scenarios, and
    its aggregates (and each scenario's telemetry file) equal one
    unsharded call's bit for bit."""
    fl = tfed.FLConfig(num_rounds=3, batch_size=50, learning_rate=0.1,
                       telemetry=telemetry.TelemetryConfig()
                       if frames else None)
    spec = _spec(fl=fl)
    point = spec.expand()[0]
    out = {}
    for name, kw in (("split", dict(mesh=MESH4)),
                     ("whole", dict(use_sharding=False))):
        tdir = tmp_path / name
        eng = _engine(world, spec, telemetry_dir=str(tdir), **kw)
        calls.clear()
        agg = eng.run_point(point)
        out[name] = (_tree(agg), calls[:], tdir)
    assert out["split"][1] == [(2, CPU)] * 4
    assert out["whole"][1] == [(8, CPU)]
    split, whole = out["split"][0], out["whole"][0]
    assert split.keys() == whole.keys()
    for k in whole:
        np.testing.assert_array_equal(split[k], whole[k], err_msg=k)
    names = sorted(os.listdir(out["whole"][2])) if frames else []
    assert len(names) == (9 if frames else 0)      # 8 scenarios + manifest
    for n in names:
        assert (out["split"][2] / n).read_bytes() == \
            (out["whole"][2] / n).read_bytes(), n


def test_chunk_the_mesh_does_not_divide_runs_unsplit(world, calls):
    """A chunk of 3 on a 4-entry mesh is one call on the engine's device,
    as the reference's ``_sim_for`` falls back to the unsharded program;
    a chunk of 8 is four groups of 2 in scenario order."""
    spec = _spec(scenarios_per_point=3, chunk_scenarios=3)
    eng = _engine(world, spec, mesh=MESH4)
    assert eng.groups(3) == [(0, 3, CPU)]
    assert eng.groups(8) == [(0, 2, CPU), (2, 2, CPU), (4, 2, CPU),
                             (6, 2, CPU)]
    eng.run_point(spec.expand()[0])
    assert calls == [(3, CPU)]
    with pytest.raises(ValueError, match="1-D"):
        _engine(world, spec, mesh=mesh_lib.Mesh(("data", "model"), (1, 1),
                                                (CPU,)))


def test_run_sweep_passes_the_mesh_through(world, monkeypatch):
    """``run_sweep(..., mesh=, use_sharding=)`` reaches the engine; with
    ``use_sharding`` and no mesh the engine builds a one-entry CPU
    scenario mesh on ``device="cpu"``."""
    seen = []

    class Spy(teng.SweepEngine):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            seen.append(self.mesh)

    monkeypatch.setattr(trun.engine_lib, "SweepEngine", Spy)
    data, model = world
    spec = _spec(fl=tfed.FLConfig(num_rounds=1, batch_size=50,
                                  learning_rate=0.1),
                 scenarios_per_point=2, chunk_scenarios=2)
    for kw in (dict(use_sharding=False), dict(mesh=MESH4), {}):
        trun.run_sweep(spec, model=model, data=data, device="cpu", **kw)
    assert seen[0] is None
    assert seen[1] is MESH4
    assert seen[2] == mesh_lib.Mesh(("scenario",), (1,), (CPU,))


def test_meshes_and_the_card():
    """The production meshes are abstract (no devices); the host and
    scenario meshes span the present devices, and raise without a card
    unless the CPU is named."""
    single = mesh_lib.make_production_mesh()
    multi = mesh_lib.make_production_mesh(multi_pod=True)
    assert (single.axis_names, single.shape, single.devices) == \
        (("data", "model"), (16, 16), None)
    assert (multi.axis_names, multi.shape, multi.size) == \
        (("pod", "data", "model"), (2, 16, 16), 512)
    assert mesh_lib.data_parallel_size(multi) == 32
    assert mesh_lib.scenario_shard_count(single) == 1
    assert mesh_lib.scenario_shard_count(MESH4) == 4
    assert mesh_lib.make_scenario_mesh(device="cpu") == \
        mesh_lib.Mesh(("scenario",), (1,), (CPU,))
    assert mesh_lib.make_host_mesh(device="cpu").shape == (1, 1)
    with pytest.raises(ValueError, match="devices for a mesh"):
        mesh_lib.Mesh(("scenario",), (2,), (CPU,))
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing raises")
    for make in (mesh_lib.make_scenario_mesh, mesh_lib.make_host_mesh):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()

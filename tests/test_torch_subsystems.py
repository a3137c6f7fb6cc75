"""The port's driver with streaming, compression and faults composed.

Streaming data (Poisson arrivals), unreliable uplinks (chronic
outages, retries, stragglers, the reliability EMA, overprovisioning)
and ``topk`` compressed uplinks together on the CNN and the MLP,
against the reference's ``make_feel_sim`` on one key schedule; seeding
and tape checks of composed runs; the card against the CPU.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.core import compression as jcomp  # noqa: E402
from repro.core import faults as jf  # noqa: E402
from repro.core import streaming as jst  # noqa: E402
from repro_torch.core import bandwidth as tbw  # noqa: E402
from repro_torch.core import compression as tcomp  # noqa: E402
from repro_torch.core import faults as tf  # noqa: E402
from repro_torch.core import federated as tfed  # noqa: E402
from repro_torch.core import scheduler as tsch  # noqa: E402
from repro_torch.core import streaming as tst  # noqa: E402
from repro_torch.core import wireless as tw  # noqa: E402
from repro_torch.kernels import compress as tcu  # noqa: E402
from repro_torch.kernels import fedavg_agg as tagg  # noqa: E402
from repro_torch.kernels import stream_update as tsu  # noqa: E402
from repro_torch.models import paper_nets as tnets  # noqa: E402
from test_torch_federated import (_tiny_world, assert_runs_agree,  # noqa
                                  run_pair)

FAULTS = dict(drop_prob=0.3, max_retries=2, straggler_prob=0.05,
              reliability_ema=0.2, chronic_spread=0.5, overprovision=2)
SCHED = dict(staleness_weight=0.25, reliability_weight=0.5)


def test_driver_with_all_three_subsystems_matches_reference():
    """Stream + faults + ``topk`` on the CNN at K = 16: equal
    selections, iterations and delivered counts; Sub2 objective 1e-4.
    Params atol 1e-2: the reference's own vmapped CNN trainer drifts on
    the CPU (``test_torch_federated.CASES``), here over three rounds of
    sparsified updates whose kept set follows the drifted magnitudes.
    A sound run reads 6.0e-3 against a largest parameter change of
    6.6e-2; the MLP case below holds the same path at 1e-4."""
    jp, jm, tp, recs = _composed_pair("cnn", 0.05)
    assert any(r.n_success < r.n_selected for r in recs)
    assert_runs_agree(jm, recs, jp, tp, atol=1e-2)


def test_driver_with_all_three_subsystems_on_the_mlp_matches_reference():
    """Stream + faults + ``topk`` on the MLP at K = 16: as above, params
    atol 1e-4 against a largest parameter change of 0.13 (a sound run
    reads 4.5e-8).  The world is one with no near-tie at a row's keep
    threshold: at K = 12 on network seed 0 a row has an exact tie there,
    and a coordinate within 7e-7 relative of it that the two trainers
    round apart flips into the kept set (3.3e-4 after one round, 6.9e-3
    after three), as any exact top-k does on inputs that differ by
    rounding.
    Failed uploads land in every round, so the fold-back is held too."""
    jp, jm, tp, recs = _composed_pair("mlp", 0.1)
    assert all(r.n_success < r.n_selected for r in recs)
    assert_runs_agree(jm, recs, jp, tp, atol=1e-4)


def _composed_pair(kind, lr):
    return run_pair(
        kind, 16, 3, lr,
        jsub=dict(stream=jst.StreamConfig(use_kernel=True),
                  faults=jf.FaultConfig(**FAULTS),
                  compression=jcomp.CompressionConfig(codec="topk")),
        tsub=dict(stream=tst.StreamConfig(),
                  faults=tf.FaultConfig(**FAULTS),
                  compression=tcomp.CompressionConfig(codec="topk")),
        sched_extra=SCHED)


def _composed(process, codec, **fl):
    return tfed.FLConfig(
        num_rounds=2, learning_rate=0.1, use_kernel_agg=True,
        stream=tst.StreamConfig(process=process),
        faults=tf.FaultConfig(**FAULTS),
        compression=tcomp.CompressionConfig(codec=codec),
        **fl)


@pytest.mark.parametrize("process,codec", [("drift", "adaptive"),
                                           ("evict", "quant"),
                                           ("shift", "none")])
def test_composed_run_without_tape_is_seeded(process, codec):
    """No tape: every draw comes from the seeded generator, so two runs
    agree bit for bit; the records account the faulty rounds."""
    data, net = _tiny_world()
    model = tnets.init(tnets.PaperNetSpec(kind="mlp"),
                       torch.Generator().manual_seed(1))
    kw = dict(model=model, data=data, net=net, wcfg=tw.WirelessConfig(),
              scfg=tsch.SchedulerConfig(allocator="fused_pgd",
                                        sub2=tbw.Sub2Params.fast(),
                                        iterations_max=3, **SCHED),
              fcfg=_composed(process, codec), seed=9, device="cpu")
    p1, r1 = tfed.run_federated(**kw)
    p2, r2 = tfed.run_federated(**kw)
    for n in p1:
        assert torch.equal(p1[n], p2[n])
        assert bool(torch.all(torch.isfinite(p1[n])))
    for a, b in zip(r1, r2):
        assert dataclasses.astuple(a)[:6] == dataclasses.astuple(b)[:6]
        assert 0 <= a.n_success <= a.n_selected
        assert a.round_time > 0.0 and a.energy_total >= 0.0


def test_tape_without_subsystem_draws_raises():
    data, net = _tiny_world()
    model = tnets.build(tnets.PaperNetSpec(kind="mlp"))
    fcfg = _composed("poisson", "topk")
    draws = tfed.draw_tape(torch.Generator().manual_seed(0), net, 2,
                           data.capacity,
                           tfed._max_local_steps(fcfg, data.capacity), 50)
    with pytest.raises(ValueError, match="stream_init"):
        tfed.run_federated(model=model, data=data, net=net,
                           wcfg=tw.WirelessConfig(),
                           scfg=tsch.SchedulerConfig(), fcfg=fcfg,
                           draws=draws, device="cpu")
    with pytest.raises(ValueError, match="histograms"):
        tfed.draw_tape(torch.Generator(), net, 2, data.capacity, 2, 50,
                       fcfg)


def test_overprovision_bumps_the_admission_floor():
    sch = tfed._sched_cfg(tsch.SchedulerConfig(n_min=3, n_fixed=4),
                          tfed.FLConfig(local_epochs=2, faults=tf.FaultConfig(
                              overprovision=2)))
    assert (sch.n_min, sch.n_fixed, sch.local_epochs) == (5, 6, 2)
    sch = tfed._sched_cfg(tsch.SchedulerConfig(n_min=3),
                          tfed.FLConfig(faults=tf.FaultConfig()))
    assert (sch.n_min, sch.n_fixed) == (3, None)


def test_composed_card_run_matches_cpu_run():
    """Card and CPU from one tape, TF32 off, ``topk`` (needs a CUDA
    device): equal selections and delivered counts; the kernels of the
    path launched."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA kernels have no CPU mode)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    data, net = _tiny_world(k=8)
    model = tnets.init(tnets.PaperNetSpec(kind="cnn"),
                       torch.Generator().manual_seed(1))
    fcfg = _composed("poisson", "topk")
    hists = tfed.client_histograms(data, 10)
    draws = tfed.draw_tape(torch.Generator().manual_seed(5), net, 2,
                           data.capacity,
                           tfed._max_local_steps(fcfg, data.capacity), 50,
                           fcfg, hists)
    kw = dict(model=model, data=data, net=net, wcfg=tw.WirelessConfig(),
              scfg=tsch.SchedulerConfig(allocator="fused_pgd",
                                        sub2=tbw.Sub2Params.fast(), **SCHED),
              fcfg=fcfg, draws=draws)
    before = (tsu.stream_update.launches, tcu.compress_update.launches,
              tagg.fedavg_agg_masked.launches)
    pg, rg = tfed.run_federated(device="cuda", **kw)
    assert (tsu.stream_update.launches, tcu.compress_update.launches,
            tagg.fedavg_agg_masked.launches) == (before[0] + 2,
                                                 before[1] + 2, before[2])
    pc, rc = tfed.run_federated(device="cpu", **kw)
    for a, b in zip(rg, rc):
        np.testing.assert_array_equal(a.selected, b.selected)
        assert a.n_success == b.n_success
    for n in pc:
        torch.testing.assert_close(pg[n].cpu(), pc[n], rtol=0, atol=1e-4)


def test_composed_entry_point_defaults_to_the_card(monkeypatch):
    """``device=None`` means CUDA with the subsystems on too; without a
    card the run raises instead of dropping to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data, net = _tiny_world()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfed.run_federated(model=tnets.build(tnets.PaperNetSpec(kind="mlp")),
                           data=data, net=net, wcfg=tw.WirelessConfig(),
                           scfg=tsch.SchedulerConfig(),
                           fcfg=_composed("poisson", "quant"))


def _meta_call(name):
    """(wrapper, call) of a kernel wrapper on meta-device tensors."""
    rows = torch.zeros((4,), device="meta")
    mat = torch.zeros((4, 8), device="meta")
    hist = torch.zeros((4, 10), device="meta")
    if name == "stream_update":
        return tsu.stream_update, lambda: tsu.stream_update(
            hist, hist, rows, rows, rows, decay=0.8)
    if name == "compress_update":
        return tcu.compress_update, lambda: tcu.compress_update(
            mat, mat, rows, rows, mat, mode="quant")
    return tagg.fedavg_agg_masked, lambda: tagg.fedavg_agg_masked(
        mat, rows, rows)


@pytest.mark.parametrize("name", ["stream_update", "compress_update",
                                  "fedavg_agg_masked"])
def test_non_cpu_tensors_never_take_the_plain_version(monkeypatch, name):
    """Only a CPU tensor takes the plain version: any other device goes
    to the kernel library, and a library that cannot load raises."""
    from repro_torch.kernels import _build

    def no_library():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")

    monkeypatch.setattr(_build, "library", no_library)
    wrapper, call = _meta_call(name)
    before = wrapper.launches
    with pytest.raises(RuntimeError, match="nvcc not found"):
        call()
    assert wrapper.launches == before

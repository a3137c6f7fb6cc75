"""The port's legacy per-round loop and ``faults.fault_step``.

``run_federated_loop`` runs the rounds of ``run_federated`` (one round
body, ``federated._rounds``) and makes each round's record on the host as
the round ends.  For each configuration the reference's own loop tests
use, the reference's ``run_federated_loop`` runs a few rounds on the CPU;
its key schedule is the scan driver's, so ``replay_tape`` builds the
port's tape from the same key, and the port's loop and its
``run_federated`` run on it.  The loop is held to the reference's loop at
the port's driver tolerances and to the port's ``run_federated`` bit for
bit: records, parameters and telemetry frames.

The reference's records carry no DAS iteration count; its loop runs with
the ``sub2`` frame group on (telemetry leaves the primary outputs as they
are) and the count comes from that group's ``sub2_iters``.
"""

import dataclasses
import functools
import math
import types

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro import telemetry as jtel  # noqa: E402
from repro.core import bandwidth as jbw  # noqa: E402
from repro.core import compression as jcomp  # noqa: E402
from repro.core import faults as jf  # noqa: E402
from repro.core import federated as jfed  # noqa: E402
from repro.core import scheduler as jsch  # noqa: E402
from repro.core import streaming as jst  # noqa: E402
from repro.core import wireless as jw  # noqa: E402
from repro.data import partition as jpart  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.models import paper_nets as jnets  # noqa: E402
from repro_torch import telemetry  # noqa: E402
from repro_torch.core import bandwidth as tbw  # noqa: E402
from repro_torch.core import compression as tcomp  # noqa: E402
from repro_torch.core import events as tev  # noqa: E402
from repro_torch.core import faults as tf  # noqa: E402
from repro_torch.core import federated as tfed  # noqa: E402
from repro_torch.core import scheduler as tsch  # noqa: E402
from repro_torch.core import streaming as tst  # noqa: E402
from repro_torch.core import wireless as tw  # noqa: E402
from repro_torch.models import paper_nets as tnets  # noqa: E402
from test_torch_faults import CONFIGS as FAULT_DRAWS  # noqa: E402
from test_torch_faults import _t, _world as fault_world  # noqa: E402
from test_torch_federated import (_port_world, _tiny_world,  # noqa: E402
                                  assert_runs_agree, coord_order,
                                  replay_tape)
from test_torch_telemetry import assert_frames_agree  # noqa: E402

ROUNDS = 3
FAULTS = dict(drop_prob=0.3, max_retries=2, straggler_prob=0.05,
              reliability_ema=0.2, chronic_spread=0.5, overprovision=2)
QUANT8 = dict(codec="quant", bit_width=8)
SUB2_ONLY = dict(scores=False, sub2=True, transport=False, faults=False,
                 events=False, signals=False)


def _stream(lib):
    return lib.StreamConfig(use_kernel=True) if lib is jst \
        else lib.StreamConfig()


def _faults(lib):
    return lib.FaultConfig(**FAULTS)


def _quant(lib):
    return lib.CompressionConfig(**QUANT8)


# name -> (model, K, network seed, learning rate, MLP width, samples per
# class, shards, subsystems (a function of the reference's or the port's
# modules), scheduler extras, eval_every, final-params atol).  The
# subsystems are those of the reference's loop tests: plain DAS
# (tests/test_federated.py) on the MLP and the CNN, Poisson streaming
# (test_streaming.py), chronic faults (test_faults.py), 8-bit quant under
# faults (test_faults.py, test_compression.py), a binding dispatch cap
# with the bf16 carry (test_dispatch.py), eval_every = 2, every telemetry
# group (test_telemetry.py).  The CNN's atol is the driver's
# (tests/test_torch_federated.py); quant's the compressed driver's 1e-3
# (tests/test_torch_compression.py: a stochastic rounding that flips on
# f32 differences of the two trainers moves a coordinate by one level).
SMALL = (8, 0, 0.1, 8, 200, 36)
K12 = (12, 0, 0.1, 16, 600, 100)
CASES = {
    "mlp": ("mlp", *K12, lambda m: {}, {}, 1, 1e-4),
    "cnn": ("cnn", 8, 3, 0.05, None, 200, 36, lambda m: {}, {}, 1, 5e-3),
    "stream": ("mlp", *SMALL, lambda m: dict(stream=_stream(m.st)),
               dict(staleness_weight=0.25), 1, 1e-4),
    "faults": ("mlp", *K12, lambda m: dict(faults=_faults(m.f)),
               dict(reliability_weight=0.5), 1, 1e-4),
    "quant-faults": ("mlp", *K12, lambda m: dict(
        faults=_faults(m.f), compression=_quant(m.comp)),
        dict(reliability_weight=0.5), 1, 1e-3),
    "cap-bf16": ("mlp", *SMALL, lambda m: dict(
        dispatch_cap=3, carry_dtype="bfloat16", stream=_stream(m.st),
        compression=_quant(m.comp)), dict(allocator="waterfilling"), 1,
        1e-3),
    "eval-every-2": ("mlp", *SMALL, lambda m: {}, {}, 2, 1e-4),
    "telemetry": ("mlp", *K12, lambda m: dict(
        stream=_stream(m.st), faults=_faults(m.f),
        telemetry=m.tel.TelemetryConfig()),
        dict(staleness_weight=0.25, reliability_weight=0.5), 1, 1e-4),
}
REF = types.SimpleNamespace(st=jst, f=jf, comp=jcomp, tel=jtel)
PORT = types.SimpleNamespace(st=tst, f=tf, comp=tcomp, tel=telemetry)


@pytest.fixture(autouse=True)
def one_thread():
    """The shapes here are tiny: one intra-op thread, so the test workers
    that share the machine do not oversubscribe its cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _reference_metrics(history, frames):
    """The reference loop's records as the (R, ...) fields
    ``assert_runs_agree`` reads, the DAS iterations from the frames."""
    return types.SimpleNamespace(
        selected=np.stack([h.selected for h in history]),
        iterations=np.asarray(frames["sub2_iters"]),
        **{f: np.asarray([getattr(h, f) for h in history])
           for f in ("n_selected", "n_success", "n_dropped",
                     "energy_total", "round_time")})


@pytest.fixture(scope="module", params=sorted(CASES))
def loop_runs(request):
    """One configuration through the reference's ``run_federated_loop``
    and, on its replayed tape, the port's loop and ``run_federated``."""
    torch.set_num_threads(1)
    (kind, k, net_seed, lr, hidden, spc, shards, subsystems, sched_extra,
     eval_every, atol) = CASES[request.param]
    imgs, labels = jsyn.generate(0, samples_per_class=spc)
    data = jpart.partition(imgs, labels, seed=1, spec=jpart.PartitionSpec(
        num_devices=k, num_shards=shards, shard_size=50))
    wcfg = jw.WirelessConfig()
    net = jw.sample_network(jax.random.key(net_seed), k, wcfg)
    spec = jnets.PaperNetSpec(kind=kind) if hidden is None \
        else jnets.PaperNetSpec(kind=kind, mlp_hidden=hidden)
    params = jnets.init(jax.random.key(3), spec)
    sched = {**dict(method="das", n_min=2, iterations_max=4,
                    allocator="fused_pgd"), **sched_extra}
    fl = dict(num_rounds=ROUNDS, batch_size=50, learning_rate=lr,
              use_kernel_agg=True)
    jsub, tsub = subsystems(REF), subsystems(PORT)
    jfcfg = jfed.FLConfig(**fl, **jsub)
    key = jax.random.key(4)
    jrun = jfcfg if "telemetry" in jsub else dataclasses.replace(
        jfcfg, telemetry=jtel.TelemetryConfig(**SUB2_ONLY))
    jparams, jhist, jframes = jfed.run_federated_loop(
        init_params=params, loss_fn=functools.partial(jnets.loss_fn,
                                                      spec=spec),
        eval_fn=functools.partial(jnets.accuracy, spec=spec), data=data,
        net=net, wcfg=wcfg,
        scfg=jsch.SchedulerConfig(sub2=jbw.Sub2Params.fast(), **sched),
        fcfg=jrun, key=key, eval_every=eval_every)
    hists = jfed.client_histograms(data, 10)
    draws = replay_tape(key, net, k, ROUNDS, data.capacity,
                        jfed._max_local_steps(jfcfg, data.capacity), 50,
                        fcfg=jfcfg, hists=hists,
                        coord_order=coord_order(params, kind, hidden))
    tdata, tnet, model = _port_world(data, net, params, kind, hidden)
    kw = dict(model=model, data=tdata, net=tnet, wcfg=tw.WirelessConfig(),
              scfg=tsch.SchedulerConfig(sub2=tbw.Sub2Params.fast(), **sched),
              fcfg=tfed.FLConfig(**fl, **tsub), draws=draws,
              eval_every=eval_every, device="cpu")
    return dict(name=request.param, atol=atol,
                telemetry="telemetry" in tsub,
                ref=(jax.device_get(jparams), jhist, jframes),
                loop=tfed.run_federated_loop(**kw),
                run=tfed.run_federated(**kw))


def test_loop_matches_the_reference_loop(loop_runs):
    """Equal selections, DAS iterations, delivered and dropped counts;
    the Sub2 objective at 1e-4, E and T at 5e-3; final parameters at the
    case's atol; the same rounds evaluated; frames at the telemetry
    tests' tolerances."""
    jparams, jhist, jframes = loop_runs["ref"]
    tparams, recs, *tframes = loop_runs["loop"]
    assert [r.round for r in recs] == list(range(ROUNDS))
    assert_runs_agree(_reference_metrics(jhist, jframes), recs, jparams,
                      tparams, atol=loop_runs["atol"])
    for rec, want in zip(recs, jhist):
        assert math.isnan(rec.accuracy) == math.isnan(want.accuracy)
    if loop_runs["name"] == "eval-every-2":
        assert math.isnan(recs[1].accuracy)
    if loop_runs["name"] == "cap-bf16":
        assert sum(r.n_dropped for r in recs) > 0
    if loop_runs["name"] in ("faults", "quant-faults", "telemetry"):
        assert any(r.n_success < r.n_selected for r in recs)
    assert len(tframes) == loop_runs["telemetry"]
    if tframes:
        assert all(isinstance(v, np.ndarray) for v in tframes[0].values())
        assert_frames_agree(jframes, tframes[0])


def _same_record(a, b) -> bool:
    return all(getattr(a, f.name) == getattr(b, f.name)
               or (f.name == "accuracy" and math.isnan(a.accuracy)
                   and math.isnan(b.accuracy))
               for f in dataclasses.fields(a) if f.name != "selected") \
        and np.array_equal(a.selected, b.selected)


def test_loop_equals_run_federated_bit_for_bit(loop_runs):
    """One round body: the loop's records, parameters and host frames are
    ``run_federated``'s on the same tape, bit for bit."""
    p_loop, r_loop, *f_loop = loop_runs["loop"]
    p_run, r_run, *f_run = loop_runs["run"]
    assert len(r_loop) == len(r_run) == ROUNDS
    assert all(_same_record(a, b) for a, b in zip(r_loop, r_run))
    assert p_loop.keys() == p_run.keys()
    assert all(torch.equal(p_loop[n], p_run[n]) for n in p_run)
    assert len(f_loop) == len(f_run)
    if f_run:
        assert f_loop[0].keys() == f_run[0].keys()
        for name, got in f_loop[0].items():
            want = f_run[0][name].numpy()
            assert got.dtype == want.dtype and got.shape == want.shape
            assert np.array_equal(got, want, equal_nan=True), name


# ---------------------------------------------------------------------------
# faults.fault_step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(FAULT_DRAWS))
def test_fault_step_matches_the_reference(name):
    """The reference's jitted ``fault_step`` from a key against the port's
    on the uniforms replayed from it: the draw's success and attempts and
    ``ok`` exactly, the multiplier, energy and round time at 1e-6; and the
    port's step is ``sample_faults`` then ``apply_faults``, bit for
    bit."""
    net, gains, tnet = fault_world(2)
    k = gains.shape[0]
    kw = FAULT_DRAWS[name]
    cfg_j, cfg_t = jf.FaultConfig(**kw), tf.FaultConfig(**kw)
    rates_j = jf.chronic_rates(jax.random.key(7), k, cfg_j)
    rates_t = tf.chronic_rates(_t(jax.random.normal(jax.random.key(7), (k,))),
                               cfg_t)
    key = jax.random.key(31)
    kd, ko, ks, kt = jax.random.split(key, 4)
    u = {n: _t(v) for n, v in dict(
        u_drop=jax.random.uniform(kd, (k, jf.attempt_budget(cfg_j))),
        u_dropout=jax.random.uniform(ko, (k,)),
        u_strag=jax.random.uniform(ks, (k,)),
        u_tail=jax.random.uniform(kt, (k,), minval=1e-6,
                                  maxval=1.0)).items()}
    rng = np.random.default_rng(5)
    sel = (rng.random(k) > 0.3).astype(np.float32)
    alpha = np.where(sel > 0, rng.random(k), 0).astype(np.float32)
    alpha /= alpha.sum()
    t_train = rng.random(k).astype(np.float32)
    wcfg_j, wcfg_t = jw.WirelessConfig(), tw.WirelessConfig()
    for bits in (None, np.full((k,), 30e3, np.float32)):
        tbits = None if bits is None else _t(bits)
        want = jf.fault_step(key, sel, alpha, t_train, gains, net, wcfg_j,
                             bits, cfg_j, rates_j)
        got = tf.fault_step(**u, selected=_t(sel), alpha=_t(alpha),
                            t_train=_t(t_train), gains=_t(gains), net=tnet,
                            wcfg=wcfg_t, payload_bits=tbits, cfg=cfg_t,
                            drop_rates=rates_t)
        (jdraw, *jrest), (tdraw, *trest) = want, got
        np.testing.assert_array_equal(tdraw.success.numpy(),
                                      np.asarray(jdraw.success))
        np.testing.assert_array_equal(tdraw.attempts.numpy(),
                                      np.asarray(jdraw.attempts))
        np.testing.assert_allclose(tdraw.compute_mult.numpy(),
                                   np.asarray(jdraw.compute_mult), rtol=1e-6)
        np.testing.assert_array_equal(trest[0].numpy(), np.asarray(jrest[0]))
        for g, w in zip(trest[1:], jrest[1:]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)
        draw = tf.sample_faults(**u, gains=_t(gains), net=tnet, cfg=cfg_t,
                                drop_rates=rates_t)
        apart = (draw,) + tf.apply_faults(draw, _t(sel), _t(alpha),
                                          _t(t_train), _t(gains), tnet,
                                          wcfg_t, tbits, cfg_t)
        for g, w in zip(dataclasses.astuple(tdraw) + tuple(trest),
                        dataclasses.astuple(apart[0]) + apart[1:]):
            assert torch.equal(g, w)


# ---------------------------------------------------------------------------
# Refusals and the seeded run
# ---------------------------------------------------------------------------

def _tiny_kw(**fl):
    data, net = _tiny_world()
    model = tnets.init(tnets.PaperNetSpec(kind="mlp"),
                       torch.Generator().manual_seed(1))
    return dict(model=model, data=data, net=net, wcfg=tw.WirelessConfig(),
                scfg=tsch.SchedulerConfig(allocator="waterfilling",
                                          iterations_max=3),
                fcfg=tfed.FLConfig(num_rounds=2, learning_rate=0.1, **fl),
                seed=3)


def test_loop_refuses_an_event_config():
    with pytest.raises(ValueError, match="legacy per-round loop"):
        tfed.run_federated_loop(**_tiny_kw(events=tev.EventConfig()),
                                device="cpu")


def test_loop_defaults_to_the_card(monkeypatch):
    """``device=None`` means CUDA; without a card the loop raises instead
    of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfed.run_federated_loop(**_tiny_kw())


def test_loop_without_tape_is_seeded_and_returns_two():
    """From a seed, no tape: two runs equal, and without telemetry the
    return is ``(params, records)``."""
    out1 = tfed.run_federated_loop(**_tiny_kw(), device="cpu")
    out2 = tfed.run_federated_loop(**_tiny_kw(), device="cpu")
    assert len(out1) == 2
    assert all(_same_record(a, b) for a, b in zip(out1[1], out2[1]))
    assert all(torch.equal(out1[0][n], out2[0][n]) for n in out1[0])

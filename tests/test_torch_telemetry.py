"""The port's telemetry frames against the JAX reference's.

The reference's ``make_feel_sim`` with ``TelemetryConfig()`` runs a few
rounds on the CPU (the synchronous driver with Poisson streaming, faults
and 8-bit ``quant``; the event driver in its asynchronous mode); its key
schedule is replayed (``replay_tape``) and the port runs the same rounds
with telemetry on.  Every frame leaf is held to the reference's: the
masks, ranks and counts equal, the floats within the FEEL run's own
tolerances (``FRAME_TOL``).  The batch driver's frames are held per
scenario against the reference's single run on that scenario's network
and key.  Also here: telemetry leaves the primary outputs bit for bit,
an inert config keeps today's return values, ``score_trace`` and
``jain_index`` on their own, and the config's validation.
"""

import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import telemetry as jtel  # noqa: E402
from repro.core import bandwidth as jbw  # noqa: E402
from repro.core import compression as jcomp  # noqa: E402
from repro.core import events as jev  # noqa: E402
from repro.core import faults as jf  # noqa: E402
from repro.core import federated as jfed  # noqa: E402
from repro.core import scheduler as jsch  # noqa: E402
from repro.core import streaming as jst  # noqa: E402
from repro.core import wireless as jw  # noqa: E402
from repro.data import partition as jpart  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.models import paper_nets as jnets  # noqa: E402
from repro.telemetry import health as jhealth  # noqa: E402
from repro_torch import convert, telemetry  # noqa: E402
from repro_torch.core import bandwidth as tbw  # noqa: E402
from repro_torch.core import compression as tcomp  # noqa: E402
from repro_torch.core import events as tev  # noqa: E402
from repro_torch.core import faults as tf  # noqa: E402
from repro_torch.core import federated as tfed  # noqa: E402
from repro_torch.core import scheduler as tsch  # noqa: E402
from repro_torch.core import streaming as tst  # noqa: E402
from repro_torch.core import wireless as tw  # noqa: E402
from repro_torch.models import paper_nets as tnets  # noqa: E402
from repro_torch.telemetry import health as thealth  # noqa: E402
from test_torch_events import _small_world as events_world  # noqa: E402
from test_torch_federated import (NET_FIELDS, _port_world,  # noqa: E402
                                  assert_runs_agree, coord_order,
                                  replay_tape, run_pair)

ROUNDS = 3
HIDDEN = 16
S = 3
FAULTS = dict(drop_prob=0.3, max_retries=2, straggler_prob=0.05,
              reliability_ema=0.2, chronic_spread=0.5, overprovision=2)
SCHED = dict(staleness_weight=0.25, reliability_weight=0.5)
QUANT8 = dict(codec="quant", bit_width=8)

# Leaves that must be equal: masks, ranks and counts.
EXACT = ("admitted", "dispatched", "delivered", "score_rank", "sub2_iters",
         "fault_outage", "fault_dropout", "fault_straggler",
         "fault_attempts", "sig_participation", "starved",
         "div_nonfinite", "div_exploding", "jain_participation", "avail",
         "free", "in_flight", "buffer_fill", "flushed", "staleness_tau",
         "model_version")
# The float leaves, each at the driver tolerance of what it measures
# (rtol, atol): the scheduler's inputs (index, staleness) at the params'
# 1e-4; the learning signals, whose trained weights are the quant case's,
# at quant's 1e-3 (one level of the row max); Sub2's objective and the
# realized energy at the 5e-3 of E and T along Sub2's flat valley
# (tests/test_torch_federated.py), the allocation at 5e-3 of the band; the
# payload at quant's 1e-3; the clock at f32 rounding.
FRAME_TOL = {
    "score_base": (0.0, 1e-4), "score_boosted": (0.0, 1e-4),
    "score_final": (0.0, 1e-4), "staleness": (0.0, 1e-4),
    "alpha": (0.0, 5e-3), "sub2_obj": (5e-3, 0.0),
    "sub2_obj_eq": (5e-3, 0.0), "jain_energy": (5e-3, 0.0),
    "payload_bits": (1e-3, 0.0), "sig_loss_delta": (0.0, 1e-3),
    "sig_update_norm": (1e-3, 1e-3), "sig_loss_delta_last": (0.0, 1e-3),
    "sig_update_norm_last": (1e-3, 1e-3), "clock": (1e-6, 0.0),
}
# Per-device energy and upload time at 5e-3 of the round's sum over the
# devices (cumulative for sig_energy_cum), the scale the records hold E
# at: the flat valley trades one device's share against another's, so a
# small share moves further alone (2.8e-2 relative in the synchronous
# case, 2.2e-3 of the row's sum).  sub2_gain, a difference of two
# objectives, at 5e-3 of the objective.
ROW_SCALED = {"energy_up": np.sum, "sig_energy_cum": np.sum,
              "t_up": np.sum, "sub2_gain": None}


@pytest.fixture(autouse=True)
def one_thread():
    """The shapes here are tiny: one intra-op thread, so the test workers
    that share the machine do not oversubscribe its cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def assert_frames_agree(jframes, tframes, where=""):
    """Every leaf of the reference's frames in the port's, with the same
    shape; EXACT leaves equal, the others within FRAME_TOL (the gain
    within 5e-3 of the objective)."""
    assert set(tframes) == set(jframes), set(tframes) ^ set(jframes)
    for name, want in jframes.items():
        want = np.asarray(want)
        got = tframes[name]
        got = got.numpy() if isinstance(got, torch.Tensor) else got
        assert got.shape == want.shape, (where, name, got.shape)
        if name in EXACT:
            np.testing.assert_array_equal(got, want, err_msg=where + name)
        elif name in ROW_SCALED:
            scale = np.abs(np.asarray(jframes["sub2_obj_eq"])) \
                if name == "sub2_gain" else ROW_SCALED[name](
                    np.abs(want), axis=-1, keepdims=True)
            assert np.all(np.abs(got - want) <= 5e-3 * scale), (where, name)
        else:
            rtol, atol = FRAME_TOL[name]
            np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                                       err_msg=where + name)


def _composed(tel=True):
    """(reference, port) FLConfig fields: Poisson streaming, faults and
    8-bit quant, with telemetry on."""
    j = dict(stream=jst.StreamConfig(use_kernel=True),
             faults=jf.FaultConfig(**FAULTS),
             compression=jcomp.CompressionConfig(**QUANT8))
    t = dict(stream=tst.StreamConfig(), faults=tf.FaultConfig(**FAULTS),
             compression=tcomp.CompressionConfig(**QUANT8))
    if tel:
        j["telemetry"] = jtel.TelemetryConfig()
        t["telemetry"] = telemetry.TelemetryConfig()
    return j, t


# ---------------------------------------------------------------------------
# The drivers' frames against the reference's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sync_runs():
    """The synchronous driver, composed, K = 16 (network seed 3, the
    batch tests' composed world), MLP of 16 hidden units."""
    torch.set_num_threads(1)
    jsub, tsub = _composed()
    return run_pair("mlp", 16, 3, 0.1, jsub=jsub, tsub=tsub,
                    sched_extra=SCHED, hidden=HIDDEN)


def test_sync_frames_match_the_reference(sync_runs):
    """The records at the frames' tolerances: params at quant's 1e-3, the
    realized objective at 5e-3 (under faults with 8-bit payloads this
    world reads 1.02e-4 at its worst round, past the 1e-4 the reliable
    rounds hold; energy and time 5e-3)."""
    jp, jm, tp, recs, tframes, jframes = sync_runs
    assert_runs_agree(jm, recs, jp, tp, atol=1e-3, obj_rtol=5e-3)
    assert_frames_agree(jframes, tframes)
    assert tframes["staleness"].shape == (ROUNDS, 16)
    # Faults fired, and the frame's realized set is the records'.
    assert tframes["fault_outage"].sum() + tframes["fault_dropout"].sum() > 0
    for r, rec in enumerate(recs):
        np.testing.assert_array_equal(tframes["dispatched"][r].numpy(),
                                      rec.selected)
        assert int(tframes["delivered"][r].sum()) == rec.n_success


@pytest.fixture(scope="module")
def async_runs():
    """The event driver in its asynchronous mode (diurnal availability,
    a buffer of 2, decay 0.5, 0.02 s ticks), K = 8, MLP of 8."""
    torch.set_num_threads(1)
    ev = dict(availability="diurnal", duty=0.6, buffer_size=2,
              staleness_decay=0.5, tick_horizon=0.02, num_events=6)
    jsub = dict(events=jev.EventConfig(**ev),
                faults=jf.FaultConfig(reliability_ema=0.3),
                telemetry=jtel.TelemetryConfig())
    tsub = dict(events=tev.EventConfig(**ev),
                faults=tf.FaultConfig(reliability_ema=0.3),
                telemetry=telemetry.TelemetryConfig())
    return run_pair("mlp", 8, 0, 0.1, jsub=jsub, tsub=tsub,
                    sched_extra=dict(reliability_weight=0.4,
                                     staleness_weight=0.25),
                    rounds=6, hidden=8, samples_per_class=200,
                    num_shards=36, with_log=True)


def test_event_frames_match_the_reference(async_runs):
    """Energy and the realized objective at the event driver's 5e-3
    (tests/test_torch_events.py); the event leaves against the buffer's
    log too."""
    jp, jm, tp, recs, log, tframes, jframes = async_runs
    assert_runs_agree(jm, recs, jp, tp, atol=1e-4, obj_rtol=5e-3)
    assert_frames_agree(jframes, tframes)
    assert tframes["flushed"].tolist() == [float(f) for f in log.flushed]
    assert tframes["model_version"].tolist() == log.version
    assert any(f and tau > 0.0 for f, tau in zip(log.flushed, log.tau_mean))


@pytest.fixture(scope="module")
def batch_runs():
    """S = 2 scenarios of the composed synchronous world through the
    port's batch driver, and each scenario through the reference's
    single ``make_feel_sim`` on its network and key."""
    torch.set_num_threads(1)
    k = 16
    imgs, labels = jsyn.generate(0, samples_per_class=600)
    data = jpart.partition(imgs, labels, seed=1, spec=jpart.PartitionSpec(
        num_devices=k, num_shards=100, shard_size=50))
    wcfg = jw.WirelessConfig()
    nets = jw.sample_networks(jax.random.key(3), S, k, wcfg)
    spec = jnets.PaperNetSpec(kind="mlp", mlp_hidden=HIDDEN)
    params = jnets.init(jax.random.key(3), spec)
    sched = dict(method="das", n_min=2, iterations_max=4,
                 allocator="fused_pgd", **SCHED)
    fl = dict(num_rounds=ROUNDS, batch_size=50, learning_rate=0.1,
              use_kernel_agg=True)
    jsub, tsub = _composed()
    jfcfg = jfed.FLConfig(**fl, **jsub)
    sim = jfed.make_feel_sim(
        loss_fn=functools.partial(jnets.loss_fn, spec=spec),
        eval_fn=functools.partial(jnets.accuracy, spec=spec), wcfg=wcfg,
        scfg=jsch.SchedulerConfig(sub2=jbw.Sub2Params.fast(), **sched),
        fcfg=jfcfg, capacity=data.capacity)
    hists = jfed.client_histograms(data, 10)
    keys = jfed.scenario_keys(jax.random.key(4), 0, S)
    order = coord_order(params, "mlp", HIDDEN)
    refs, tapes = [], []
    for s in range(S):
        net = jax.tree_util.tree_map(lambda a, s=s: a[s], nets)
        refs.append(jax.device_get(sim(
            params, data.images, data.labels, data.mask, data.sizes, hists,
            jsyn.to_float(data.test_images), data.test_labels, net,
            keys[s])))
        tapes.append(replay_tape(
            keys[s], net, k, ROUNDS, data.capacity,
            jfed._max_local_steps(jfcfg, data.capacity), 50, fcfg=jfcfg,
            hists=hists, coord_order=order))
    tdata, _, model = _port_world(
        data, jax.tree_util.tree_map(lambda a: a[0], nets), params, "mlp",
        HIDDEN)
    stacked = convert.network_from_numpy(
        **{f: np.asarray(getattr(nets, f)) for f in NET_FIELDS})
    out = tfed.run_federated_batch(
        model=model, data=tdata, nets=stacked, wcfg=tw.WirelessConfig(),
        scfg=tsch.SchedulerConfig(sub2=tbw.Sub2Params.fast(), **sched),
        fcfg=tfed.FLConfig(**fl, **tsub), seeds=list(range(S)),
        draws=tfed._stack_tapes(tapes), device="cpu")
    return refs, out


def test_batch_frames_match_the_reference_singles(batch_runs):
    refs, (tparams, tmet, tframes) = batch_runs
    recs = tfed.batch_metrics_to_records(tmet)
    for s, (jp, jm, jframes) in enumerate(refs):
        assert_runs_agree(jm, recs[s], jp,
                          {n: t[s] for n, t in tparams.items()}, atol=1e-3,
                          obj_rtol=5e-3)
        assert_frames_agree(jframes, {n: t[s] for n, t in tframes.items()},
                            f"scenario {s}: ")


# ---------------------------------------------------------------------------
# Telemetry only observes
# ---------------------------------------------------------------------------

def _small_world(k=8):
    """The event tests' world (K = 8, an MLP of 8), without its network
    and seed."""
    kw = events_world(k)
    del kw["net"], kw["seed"]
    return kw


FL = tfed.FLConfig(num_rounds=3, batch_size=50, learning_rate=0.1)
# The reference's compositions (tests/test_telemetry.py), with the port's
# configs, and every subsystem at once.
COMPOSITIONS = {
    "plain": {},
    "faulty": dict(faults=tf.FaultConfig(drop_prob=0.3, max_retries=2,
                                         reliability_ema=0.3)),
    "compressed": dict(compression=tcomp.CompressionConfig(
        codec="quant", bit_width=8)),
    "streaming": dict(stream=tst.StreamConfig()),
    "dispatch": dict(dispatch_cap=4),
    "kernel_agg": dict(use_kernel_agg=True),
    "async": dict(events=tev.EventConfig(availability="churn",
                                         buffer_size=2, tick_horizon=0.5,
                                         num_events=4),
                  faults=tf.FaultConfig(reliability_ema=0.3)),
    "all": dict(stream=tst.StreamConfig(), faults=tf.FaultConfig(
        drop_prob=0.3, max_retries=2, reliability_ema=0.3),
        compression=tcomp.CompressionConfig(codec="topk"), dispatch_cap=4,
        carry_dtype="bfloat16", events=tev.EventConfig(
            availability="diurnal", buffer_size=2, staleness_decay=0.5,
            tick_horizon=0.05, num_events=4)),
}


def _same_records(ha, hb):
    assert len(ha) == len(hb)
    for a, b in zip(ha, hb):
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if f.name == "selected":
                np.testing.assert_array_equal(x, y)
            else:
                assert x == y or (np.isnan(x) and np.isnan(y)), f.name


@pytest.mark.parametrize("comp", sorted(COMPOSITIONS))
def test_primary_outputs_bitwise_with_telemetry(comp):
    kw = _small_world()
    kw["net"] = tw.sample_network(torch.Generator().manual_seed(0), 8,
                                  kw["wcfg"])
    fcfg = dataclasses.replace(FL, **COMPOSITIONS[comp])
    p0, h0 = tfed.run_federated(fcfg=fcfg, seed=5, **kw)
    p1, h1, frames = tfed.run_federated(
        fcfg=dataclasses.replace(fcfg, telemetry=telemetry.TelemetryConfig()),
        seed=5, **kw)
    for n in p0:
        assert torch.equal(p0[n], p1[n]), n
    _same_records(h0, h1)
    n = tfed.sim_length(fcfg)
    assert all(v.shape[0] == n for v in frames.values())
    assert all(bool(torch.all(torch.isfinite(v.to(torch.float32))))
               for v in frames.values())
    if fcfg.events is not None:
        assert {"avail", "clock", "model_version"} <= set(frames)


def test_batch_primary_outputs_bitwise_with_telemetry():
    kw = _small_world()
    fcfg = dataclasses.replace(FL, **COMPOSITIONS["all"])
    nets = tw.sample_networks(torch.Generator().manual_seed(2), 3, 8,
                              kw["wcfg"])
    seeds = tfed.scenario_seeds(3, 0, 3)
    p0, m0 = tfed.run_federated_batch(nets=nets, seeds=seeds, fcfg=fcfg,
                                      **kw)
    p1, m1, frames = tfed.run_federated_batch(
        nets=nets, seeds=seeds, fcfg=dataclasses.replace(
            fcfg, telemetry=telemetry.TelemetryConfig()), **kw)
    for n in p0:
        assert torch.equal(p0[n], p1[n]), n
    for f in dataclasses.fields(m0):
        assert torch.equal(getattr(m0, f.name), getattr(m1, f.name)), f.name
    assert frames["avail"].shape == (3, 4, 8)
    assert frames["clock"].shape == (3, 4)


def _inert():
    return telemetry.TelemetryConfig(scores=False, sub2=False,
                                     transport=False, faults=False,
                                     events=False, signals=False)


def test_inert_config_keeps_todays_return_values():
    assert telemetry.active(None) is None
    assert telemetry.is_inert(_inert()) and telemetry.active(_inert()) is None
    tel = telemetry.TelemetryConfig()
    assert telemetry.active(tel) is tel and not telemetry.is_inert(tel)
    assert dataclasses.asdict(tel) == dataclasses.asdict(
        jtel.TelemetryConfig())
    kw = _small_world()
    fcfg = dataclasses.replace(FL, num_rounds=2, telemetry=_inert())
    net = tw.sample_network(torch.Generator().manual_seed(0), 8, kw["wcfg"])
    p, h = tfed.run_federated(fcfg=fcfg, net=net, **kw)
    p0, h0 = tfed.run_federated(fcfg=dataclasses.replace(fcfg,
                                                         telemetry=None),
                                net=net, **kw)
    assert all(torch.equal(p[n], p0[n]) for n in p)
    _same_records(h, h0)
    nets = tw.sample_networks(torch.Generator().manual_seed(2), 2, 8,
                              kw["wcfg"])
    assert len(tfed.run_federated_batch(nets=nets, seeds=[1, 2], fcfg=fcfg,
                                        **kw)) == 2
    ev = dataclasses.replace(fcfg, events=tev.EventConfig(num_events=2))
    assert len(tev.run_events(net=net, fcfg=ev, **kw)) == 3
    assert len(tfed.run_federated(net=net, fcfg=ev, **kw)) == 2


def test_phase_scopes_are_recorded():
    kw = _small_world()
    net = tw.sample_network(torch.Generator().manual_seed(0), 8, kw["wcfg"])
    tfed.run_federated(fcfg=dataclasses.replace(
        FL, num_rounds=1, stream=tst.StreamConfig()), net=net, **kw)
    assert set(telemetry.PHASES) <= telemetry.seen_phases()
    assert telemetry.PHASES == jtel.PHASES


# ---------------------------------------------------------------------------
# Pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", ["das", "abs", "random", "full"])
def test_score_trace_matches_the_reference(method):
    """The reference's surface from its key, the port's from the draw
    that key gives; on (S, K) rows each lane is its own row's."""
    k = 10
    rng = np.random.default_rng(0)
    index = rng.random(k).astype(np.float32)
    ages = rng.integers(0, 4, k).astype(np.int32)
    stale = rng.random(k).astype(np.float32) * 3.0
    rel = rng.random(k).astype(np.float32)
    key = jax.random.key(7)
    sched_u = np.array(jax.random.uniform(key, (k,)))
    kw = dict(method=method, staleness_weight=0.25, reliability_weight=0.5)
    want = jsch.score_trace(key, jnp.asarray(index), jnp.asarray(ages),
                            jsch.SchedulerConfig(**kw), jnp.asarray(stale),
                            jnp.asarray(rel))
    args = [torch.from_numpy(a) for a in (sched_u, index, ages)]
    got = tsch.score_trace(args[0], args[1], args[2],
                           tsch.SchedulerConfig(**kw),
                           torch.from_numpy(stale), torch.from_numpy(rel))
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   rtol=1e-6, atol=1e-7, err_msg=name)
    assert got["score_rank"].dtype == torch.int32
    two = tsch.score_trace(*(torch.stack([a, a.flip(0)]) for a in args),
                           tsch.SchedulerConfig(**kw),
                           torch.from_numpy(np.stack([stale, stale[::-1]])),
                           torch.from_numpy(np.stack([rel, rel[::-1]])))
    for name in want:
        assert torch.equal(two[name][0], got[name]), name


def test_score_trace_ties_keep_device_order():
    """``full`` ranks an all-ones priority: a tie on every device, which
    the stable double argsort ranks in device order, as the reference's
    ``jnp.argsort`` does; abs without a draw ties equal ages too."""
    k = 9
    index = torch.rand(2, k)
    ages = torch.tensor([[1, 0, 1, 2, 0, 1, 2, 0, 1]] * 2, dtype=torch.int32)
    full = tsch.score_trace(None, index, ages, tsch.SchedulerConfig(
        method="full"))
    assert torch.equal(full["score_rank"],
                       torch.arange(k, dtype=torch.int32).expand(2, k))
    want = jsch.score_trace(None, jnp.asarray(index[0].numpy()),
                            jnp.asarray(ages[0].numpy()),
                            jsch.SchedulerConfig(method="abs"))
    got = tsch.score_trace(None, index, ages, tsch.SchedulerConfig(
        method="abs"))
    np.testing.assert_array_equal(got["score_rank"][0].numpy(),
                                  np.asarray(want["score_rank"]))
    assert got["score_rank"][0].tolist() == [2, 6, 3, 0, 7, 4, 1, 8, 5]


@pytest.mark.parametrize("x", [[0.0, 0.0, 0.0], [1.0, 1.0, 1.0, 1.0],
                               [5.0, 0.0, 0.0, 0.0], [1.0, 2.0, 3.0, 4.5],
                               [[0.0, 3.0, 1.0], [0.0, 0.0, 0.0]]])
def test_jain_index_matches_numpy(x):
    x = np.asarray(x, np.float32)
    rows = x.reshape(-1, x.shape[-1]).astype(np.float64)
    want = [1.0 if (r * r).sum() == 0 else r.sum() ** 2
            / (r.size * (r * r).sum()) for r in rows]
    got = thealth.jain_index(torch.from_numpy(x))
    assert tuple(got.shape) == x.shape[:-1]
    np.testing.assert_allclose(got.reshape(-1).numpy(), want, rtol=1e-6)
    np.testing.assert_allclose(
        thealth.jain_index(torch.from_numpy(rows[0].astype(np.int32))),
        np.asarray(jhealth.jain_index(jnp.asarray(rows[0], jnp.int32))),
        rtol=1e-6)


def test_signal_carry_and_frame_match_the_reference():
    """Two rounds of ``signal_update`` and ``signals_frame`` on (S, K)
    lanes against the reference's, lane by lane, with a non-finite and an
    exploding loss delta among the delivered devices."""
    rng = np.random.default_rng(1)
    s, k = 3, 6
    tstate = thealth.signal_init(k, (s,))
    jstates = [jhealth.signal_init(k) for _ in range(s)]
    for _ in range(2):
        ok = (rng.random((s, k)) < 0.6).astype(np.float32)
        ld = rng.standard_normal((s, k)).astype(np.float32)
        ld[0, 0], ld[1, 1] = np.nan, 80.0
        ok[0, 0] = ok[1, 1] = 1.0
        un = rng.random((s, k)).astype(np.float32)
        en = (rng.random((s, k)) * ok).astype(np.float32)
        t = [torch.from_numpy(a) for a in (ok, ld, un, en)]
        tstate = thealth.signal_update(tstate, *t)
        frame = thealth.signals_frame(tstate, t[0], t[1], t[2])
        assert set(frame) == set(thealth.SIGNAL_LEAVES) == set(
            jhealth.SIGNAL_LEAVES)
        for i in range(s):
            jstates[i] = jhealth.signal_update(
                jstates[i], ok[i], ld[i], un[i], en[i])
            want = jhealth.signals_frame(jstates[i], ok[i], ld[i], un[i])
            for name, v in want.items():
                np.testing.assert_allclose(frame[name][i].numpy(),
                                           np.asarray(v), rtol=1e-6,
                                           err_msg=name)
    assert int(frame["div_nonfinite"][0]) == 1
    assert int(frame["div_exploding"][1]) == 1


def test_probe_lanes_are_their_single_runs():
    """The probe on (S, K) lanes: each scenario's row is the probe of its
    params alone, a lane at the global params reads exactly 0, and the
    loss delta is the reference formula's on the first window."""
    from repro_torch.data import synthetic as tsyn
    kw = _small_world(k=4)
    data, model = kw["data"], kw["model"]
    loss = functools.partial(tnets.loss_fn, model)
    probe = thealth.make_signal_probe(loss, 5)
    g = tnets.params_of(model)
    glob = {n: torch.stack([t, 1.5 * t + 0.01]) for n, t in g.items()}
    clients = {n: t.unsqueeze(1).expand((2, 4) + t.shape[1:]).clone()
               for n, t in glob.items()}
    for n in clients:
        clients[n][:, 1:] += 0.05 * torch.randn_like(clients[n][:, 1:])
    got = probe(glob, clients, data.images, data.labels, data.mask, (2,))
    assert tuple(got.shape) == (2, 4)
    assert torch.equal(got[:, 0], torch.zeros(2))
    for s in range(2):
        one = probe({n: t[s] for n, t in glob.items()},
                    {n: t[s] for n, t in clients.items()}, data.images,
                    data.labels, data.mask)
        torch.testing.assert_close(got[s], one, rtol=0, atol=1e-6)
        for c in range(4):
            x = tsyn.to_float(data.images[c, :5])
            y, m = data.labels[c, :5], data.mask[c, :5]
            want = loss({n: t[s] for n, t in glob.items()}, x, y, m) - loss(
                {n: t[s, c] for n, t in clients.items()}, x, y, m)
            assert float(got[s, c]) == pytest.approx(float(want), abs=1e-6)


def test_a_run_with_signals_is_freed_without_the_cycle_collector():
    """The signals observer holds no reference cycle, so a run's device
    tensors go when the run does, not when the cycle collector next runs
    (several full-width runs would otherwise hold their datasets)."""
    import gc
    import weakref
    kw = _small_world(k=4)
    net = tw.sample_network(torch.Generator().manual_seed(0), 4, kw["wcfg"])
    gc.disable()
    try:
        fcfg = dataclasses.replace(FL, num_rounds=1,
                                   telemetry=telemetry.TelemetryConfig())
        run = tfed._Run(kw["model"], kw["data"], net, kw["wcfg"], kw["scfg"],
                        fcfg, 0, None, 1, "cpu")
        assert run.sig_fn is not None
        ref = weakref.ref(run)
        del run
        assert ref() is None
    finally:
        gc.enable()

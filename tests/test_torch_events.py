"""The port's event-driven asynchronous driver against the JAX reference.

Availability processes on the reference's own draws, the staleness
discount, the ``fedavg_agg_stale`` plain version against the reference's
Pallas kernel (interpret mode) and oracle, the synchronous limit (the
port's event loop equal to its own synchronous driver bit for bit), and
the asynchronous mode against the reference's event scan on one key
schedule (``replay_tape``).
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import test_events as jtests  # noqa: E402
from repro.core import compression as jcomp  # noqa: E402
from repro.core import events as jev  # noqa: E402
from repro.core import faults as jf  # noqa: E402
from repro.core import streaming as jst  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core import compression as tcomp  # noqa: E402
from repro_torch.core import events as tev  # noqa: E402
from repro_torch.core import faults as tf  # noqa: E402
from repro_torch.core import federated as tfed  # noqa: E402
from repro_torch.core import scheduler as tsch  # noqa: E402
from repro_torch.core import streaming as tst  # noqa: E402
from repro_torch.core import wireless as tw  # noqa: E402
from repro_torch.data import partition as tpart  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.kernels import fedavg_agg as tagg  # noqa: E402
from repro_torch.models import paper_nets as tnets  # noqa: E402
from test_torch_federated import assert_runs_agree, run_pair  # noqa: E402


@pytest.fixture(autouse=True)
def one_thread():
    """The shapes here are tiny: one intra-op thread, so the test workers
    that share the machine do not oversubscribe its cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# EventConfig and the availability processes
# ---------------------------------------------------------------------------

def test_event_config_fields_and_defaults_match_reference():
    assert dataclasses.asdict(tev.EventConfig()) == \
        dataclasses.asdict(jev.EventConfig())


@pytest.mark.parametrize("field,value", [("buffer_size", 0),
                                         ("tick_horizon", -0.5),
                                         ("num_events", 0)])
def test_event_config_validation(field, value):
    with pytest.raises(ValueError, match=field):
        tev.EventConfig(**{field: value})


def test_availability_registry():
    assert set(tev.availability_names()) >= {"always", "churn", "diurnal"}
    with pytest.raises(ValueError, match="unknown availability"):
        tev.get_availability("no_such_process")
    with pytest.raises(ValueError, match="already registered"):
        tev.register_availability("always", tev.AlwaysOn)
    with pytest.raises(ValueError, match="unknown availability"):
        tfed.run_federated(
            model=None, data=None, net=None, wcfg=None, scfg=None,
            fcfg=tfed.FLConfig(events=tev.EventConfig(
                availability="no_such_process")), device="cpu")


def _ref_availability(name, k, ticks, cfg_kw):
    """The reference process's states and masks, with the draws it made
    (``init`` off one key, each tick's ``sample`` off a folded key)."""
    jcfg = jev.EventConfig(availability=name, **cfg_kw)
    proc = jev.get_availability(name)
    key0 = jax.random.key(11)
    state = proc.init(key0, k, jcfg)
    k_shared, k_dev = jax.random.split(key0)
    init_draw = {"shared_u": np.array(jax.random.uniform(k_shared, ())),
                 "z": np.array(jax.random.normal(k_dev, (k,)))}
    masks, us, probs = [], [], []
    for t in ticks:
        kt = jax.random.fold_in(jax.random.key(12), t)
        masks.append(np.asarray(proc.sample(kt, state,
                                            jnp.asarray(t, jnp.int32),
                                            jcfg)))
        us.append(np.array(jax.random.uniform(kt, (k,))))
        level = 0.5 * (1.0 + jnp.sin(2.0 * jnp.pi * jnp.float32(t)
                                     / jcfg.period + state))
        probs.append(np.asarray(jnp.clip(2.0 * jcfg.duty * level, 0.0,
                                         1.0)))
    return np.asarray(state), init_draw, masks, us, probs


@pytest.mark.parametrize("name", ["always", "churn", "diurnal"])
def test_availability_processes_match_reference(name):
    """Same draws, same masks: ``always`` and ``churn`` bit for bit; the
    diurnal phases and probabilities to 1e-6 (``sin`` of another
    library), and its masks equal wherever the uniform is not within
    1e-6 of the probability."""
    k, ticks = 16, range(30)
    cfg_kw = dict(avail_prob=0.6, duty=0.4, phase_spread=0.3)
    j_state, init_draw, j_masks, us, j_probs = _ref_availability(
        name, k, ticks, cfg_kw)
    proc = tev.get_availability(name)
    cfg = tev.EventConfig(availability=name, **cfg_kw)
    state = proc.init({n: torch.from_numpy(v) for n, v in init_draw.items()}
                      if name == "diurnal" else {}, k, cfg, "cpu")
    if name == "diurnal":
        np.testing.assert_allclose(state.numpy(), j_state, rtol=0,
                                   atol=1e-6)
    else:
        np.testing.assert_array_equal(state.numpy(), j_state)
    for t, j_mask, u, j_p in zip(ticks, j_masks, us, j_probs):
        mask = proc.sample({"u": torch.from_numpy(u)}, state, t,
                           cfg).numpy()
        if name != "diurnal":
            np.testing.assert_array_equal(mask, j_mask)
            continue
        p = proc.probability(state, t, cfg).numpy()
        np.testing.assert_allclose(p, j_p, rtol=0, atol=1e-6)
        clear = np.abs(u - j_p) > 1e-6
        np.testing.assert_array_equal(mask[clear], j_mask[clear])


def test_staleness_multiplier_matches_reference():
    tau = np.array([0.0, 1.0, 3.0, 7.0, 40.0], np.float32)
    ones = tev.staleness_multiplier(torch.from_numpy(tau), 0.0)
    assert torch.equal(ones, torch.ones(5))
    for decay in (0.5, 0.7, 2.0):
        np.testing.assert_allclose(
            tev.staleness_multiplier(torch.from_numpy(tau), decay).numpy(),
            np.asarray(jev.staleness_multiplier(jnp.asarray(tau), decay)),
            rtol=1e-6)


# ---------------------------------------------------------------------------
# fedavg_agg_stale and the buffered flush
# ---------------------------------------------------------------------------

def _stale_inputs(k, p, seed):
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((k, p)).astype(np.float32)
    w = rng.random(k).astype(np.float32)
    m = (rng.random(k) > 0.4).astype(np.float32)
    s = ((1.0 + rng.integers(0, 5, k)) ** -0.5).astype(np.float32)
    return u, w / w.sum(), m, s


@pytest.mark.parametrize("k,p", [(4, 64), (8, 1000), (16, 4096)])
def test_fedavg_agg_stale_plain_matches_reference(k, p):
    """K-term f32 sums in another order than XLA's: the reference's own
    kernel-vs-oracle tolerance."""
    args = _stale_inputs(k, p, k * 100 + p)
    got = tagg.fedavg_agg_stale(*map(torch.from_numpy, args)).numpy()
    np.testing.assert_allclose(got, np.asarray(jops.fedavg_agg_stale(*args)),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(jref.fedavg_agg_stale(*args)),
                               rtol=1e-5, atol=1e-5)


def test_fedavg_agg_stale_all_ones_is_masked_bitwise():
    """``w * m * 1.0 == w * m`` in f32 and nothing renormalises: an
    all-ones staleness row is the masked reduction bit for bit."""
    u, w, m, _ = map(torch.from_numpy, _stale_inputs(9, 1536, 5))
    before = tagg.fedavg_agg_stale.launches
    got = tagg.fedavg_agg_stale(u, w, m, torch.ones(9))
    assert tagg.fedavg_agg_stale.launches == before
    assert torch.equal(got, tagg.fedavg_agg_masked_plain(u, w, m))


def test_fedavg_agg_stale_kernel_on_card():
    """The CUDA kernel against its plain version, and the all-ones
    identity with the masked kernel (needs a CUDA device)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA kernels have no CPU mode)")
    for k, p in ((100, 21840), (7, 1001)):
        u, w, m, s = (torch.from_numpy(x).cuda()
                      for x in _stale_inputs(k, p, p))
        before = tagg.fedavg_agg_stale.launches
        got = tagg.fedavg_agg_stale(u, w, m, s)
        assert tagg.fedavg_agg_stale.launches == before + 1
        torch.testing.assert_close(
            got.cpu(), tagg.fedavg_agg_stale_plain(u, w, m, s).cpu(),
            rtol=1e-5, atol=1e-5)
        assert torch.equal(tagg.fedavg_agg_stale(u, w, m, torch.ones_like(s)),
                           tagg.fedavg_agg_masked(u, w, m))


def test_buffered_flush_paths_agree():
    """The kernel path (its plain version here) and the per-leaf path
    compute the same update-form flush."""
    rng = np.random.default_rng(3)
    params = {"w": torch.from_numpy(rng.standard_normal((3, 5)).astype(
        np.float32)), "b": torch.from_numpy(rng.standard_normal(5).astype(
            np.float32))}
    u, w, m, s = map(torch.from_numpy, _stale_inputs(6, 20, 4))
    a = tev.buffered_flush(params, u, w, m, s, use_kernel=True)
    b = tev.buffered_flush(params, u, w, m, s, use_kernel=False)
    flat = torch.cat([params[n].reshape(-1) for n in params])
    want = flat + tagg.fedavg_agg_stale_plain(u, w, m, s)
    for got in (a, b):
        torch.testing.assert_close(
            torch.cat([got[n].reshape(-1) for n in params]), want,
            rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# The synchronous limit: EventConfig() == the port's synchronous driver
# ---------------------------------------------------------------------------

_QUANT = tcomp.CompressionConfig(codec="quant", bit_width=4)
_STREAM = tst.StreamConfig(rate=6.0)
# The reference's SYNC_LIMIT_CASES (tests/test_events.py) with the port's
# configs, plus live faults.
SYNC_LIMIT_CASES = {
    "plain": {},
    "compressed": dict(compression=_QUANT),
    "streaming": dict(stream=_STREAM),
    "dispatch_cap": dict(dispatch_cap=3),
    "kernel_agg": dict(use_kernel_agg=True),
    "combined_bf16": dict(compression=_QUANT, stream=_STREAM,
                          dispatch_cap=3, carry_dtype="bfloat16"),
}
HARMLESS = tf.FaultConfig(reliability_ema=0.3)
LIVE_FAULTS = tf.FaultConfig(drop_prob=0.35, max_retries=2, backoff_base=0.5,
                             straggler_prob=0.3, straggler_scale=3.0,
                             dropout_prob=0.1, reliability_ema=0.3,
                             overprovision=1)


def test_sync_limit_cases_are_the_reference_cases():
    assert sorted(SYNC_LIMIT_CASES) == sorted(jtests.SYNC_LIMIT_CASES)
    for name, case in SYNC_LIMIT_CASES.items():
        ref = jtests.SYNC_LIMIT_CASES[name]
        assert sorted(case) == sorted(ref)
        for field, value in case.items():
            if dataclasses.is_dataclass(value):
                want = dataclasses.asdict(ref[field])
                want.pop("use_kernel", None)
                assert dataclasses.asdict(value) == want
            else:
                assert value == ref[field]


def _small_world(k=8):
    """The reference's event-test world: K = 8, MLP with 8 hidden units."""
    imgs, labels = tsyn.generate(0, samples_per_class=200)
    data = tpart.partition(imgs, labels, seed=1, spec=tpart.PartitionSpec(
        num_devices=k, num_shards=36, shard_size=50))
    net = tw.sample_network(torch.Generator().manual_seed(0), k,
                            tw.WirelessConfig())
    model = tnets.init(tnets.PaperNetSpec(kind="mlp", mlp_hidden=8),
                       torch.Generator().manual_seed(1))
    return dict(model=model, data=data, net=net, wcfg=tw.WirelessConfig(),
                scfg=tsch.SchedulerConfig(method="das", n_min=2,
                                          iterations_max=3,
                                          reliability_weight=0.4,
                                          allocator="waterfilling"),
                seed=5, device="cpu")


def _assert_same_run(pa, ha, pb, hb):
    for n in pa:
        assert torch.equal(pa[n], pb[n]), n
    assert len(ha) == len(hb)
    for a, b in zip(ha, hb):
        assert dataclasses.astuple(a)[:6] == dataclasses.astuple(b)[:6] \
            or np.isnan(a.accuracy) and np.isnan(b.accuracy)
        np.testing.assert_array_equal(a.selected, b.selected)
        assert (a.n_success, a.n_dropped, a.iterations) == \
            (b.n_success, b.n_dropped, b.iterations)


@pytest.mark.parametrize("case", sorted(SYNC_LIMIT_CASES) + ["live_faults"])
def test_sync_limit_is_the_sync_driver_bitwise(case):
    """``EventConfig()`` — always available, ``buffer_size`` 1, no decay,
    whole-cohort ticks — reproduces the port's synchronous driver bit for
    bit (params and every record), each subsystem riding along; with live
    faults, uploads fail and the arrival times follow ``apply_faults``'s
    round time op for op."""
    kw = _small_world()
    sub = SYNC_LIMIT_CASES.get(case, dict(faults=LIVE_FAULTS))
    fl = tfed.FLConfig(num_rounds=3, batch_size=50, learning_rate=0.1,
                       **{"faults": HARMLESS, **sub})
    p_sync, h_sync = tfed.run_federated(fcfg=fl, **kw)
    p_evt, h_evt = tfed.run_federated(
        fcfg=dataclasses.replace(fl, events=tev.EventConfig()), **kw)
    _assert_same_run(p_sync, h_sync, p_evt, h_evt)
    if case == "live_faults":
        assert any(r.n_success < r.n_selected for r in h_sync)
    if "dispatch_cap" in sub:
        assert sum(r.n_dropped for r in h_sync) > 0


# ---------------------------------------------------------------------------
# Asynchronous mode
# ---------------------------------------------------------------------------

ASYNC = dict(availability="diurnal", duty=0.6, buffer_size=2,
             staleness_decay=0.5, tick_horizon=0.02, num_events=6)


# (reference and port subsystem fields) of the asynchronous parity cases:
# the async mode alone (the kernel lane's flush), and composed as
# chip_smoke.py's path 4 composes it (streaming, live faults, a binding
# cap, the bf16 carry) with 8-bit ``quant`` uplinks on top (the
# compressed flush, whose discount sits in the weights of a plain
# product).
_LIVE = dict(drop_prob=0.35, max_retries=2, straggler_prob=0.3,
             straggler_scale=3.0, reliability_ema=0.3, overprovision=1)


def _async_case(name):
    j = dict(events=jev.EventConfig(**ASYNC))
    t = dict(events=tev.EventConfig(**ASYNC))
    if name == "diurnal":
        j["faults"] = jf.FaultConfig(reliability_ema=0.3)
        t["faults"] = tf.FaultConfig(reliability_ema=0.3)
        return j, t
    j.update(faults=jf.FaultConfig(**_LIVE), dispatch_cap=3,
             carry_dtype="bfloat16",
             stream=jst.StreamConfig(rate=6.0, use_kernel=True))
    t.update(faults=tf.FaultConfig(**_LIVE), dispatch_cap=3,
             carry_dtype="bfloat16", stream=tst.StreamConfig(rate=6.0))
    j["compression"] = jcomp.CompressionConfig(codec="quant", bit_width=8)
    t["compression"] = tcomp.CompressionConfig(codec="quant", bit_width=8)
    return j, t


@pytest.mark.parametrize("case", ["diurnal", "composed_quant"])
def test_async_mode_matches_reference(case):
    """Diurnal availability, buffer of 2, decay 0.5 and 0.02 s ticks on
    K = 8 and an MLP of 8 hidden units, against the reference's event
    scan on one key schedule: equal selections, drops, DAS iterations,
    landed counts and tick lengths; energy to rtol 5e-3 as in every
    driver case (Sub2's flat valley), and so ``0.5 E + 0.5 T`` too: T is
    the tick length here, not Sub2's round time, so that sum is no
    longer the objective Sub2 holds flat; params to atol 1e-4 (f32
    rounding of the two trainers and, composed, of the bf16 carry: sound
    runs read 1.8e-07 and 1.5e-08).  Some uploads straddle
    ticks, so a flush applies stale updates."""
    jsub, tsub = _async_case(case)
    sched = dict(reliability_weight=0.4, staleness_weight=0.25)
    if case != "diurnal":
        # Water-filling compiles faster than the fused descent.  (It
        # equalises the cohort's completion times, which is why the
        # diurnal case keeps the fused descent: there uploads straddle
        # ticks only through the spread the descent leaves.)
        sched["allocator"] = "waterfilling"
    jp, jm, tp, recs, log = run_pair(
        "mlp", 8, 0, 0.1, jsub=jsub, tsub=tsub, sched_extra=sched,
        rounds=6, hidden=8, samples_per_class=200, num_shards=36,
        with_log=True)
    assert len(recs) == 6
    assert all(r.round_time == np.float32(0.02) for r in recs)
    assert_runs_agree(jm, recs, jp, tp, atol=1e-4, obj_rtol=5e-3)
    assert any(f and tau > 0.0 for f, tau in zip(log.flushed, log.tau_mean))
    assert log.version[-1] == sum(log.flushed)
    if case == "composed_quant":
        assert sum(r.n_dropped for r in recs) > 0
        # A failed upload folds its update back into the EF residual.
        assert any(r.n_success < r.n_selected for r in recs)


def test_composed_event_run_is_seeded_and_accounted():
    """Events with streaming, live faults, ``quant`` uplinks, a binding
    dispatch cap and the bf16 carry through ``run_federated`` on the CPU:
    two runs from one seed agree bit for bit, and the records account the
    events."""
    kw = _small_world()
    fl = tfed.FLConfig(
        num_rounds=2, batch_size=50, learning_rate=0.1,
        stream=tst.StreamConfig(rate=6.0), faults=LIVE_FAULTS,
        compression=_QUANT, dispatch_cap=3, carry_dtype="bfloat16",
        events=tev.EventConfig(**ASYNC))
    p1, h1 = tfed.run_federated(fcfg=fl, **kw)
    p2, h2 = tfed.run_federated(fcfg=fl, **kw)
    _assert_same_run(p1, h1, p2, h2)
    assert len(h1) == tfed.sim_length(fl) == 6
    assert sum(r.n_dropped for r in h1) > 0
    for r in h1:
        assert r.n_selected <= 3 and 0 <= r.n_success <= r.n_selected
    for t in p1.values():
        assert bool(torch.all(torch.isfinite(t)))


def test_event_tape_checks():
    kw = _small_world()
    fl = tfed.FLConfig(num_rounds=3, events=tev.EventConfig(**ASYNC))
    draws = tfed.draw_tape(torch.Generator().manual_seed(0), kw["net"], 6,
                           kw["data"].capacity,
                           tfed._max_local_steps(fl, kw["data"].capacity), 50)
    with pytest.raises(ValueError, match="avail_init"):
        tfed.run_federated(fcfg=fl, draws=draws, **kw)
    short = tfed.draw_tape(torch.Generator().manual_seed(0), kw["net"], 3,
                           kw["data"].capacity,
                           tfed._max_local_steps(fl, kw["data"].capacity), 50,
                           fl)
    with pytest.raises(ValueError, match="batch_idx"):
        tfed.run_federated(fcfg=fl, draws=short, **kw)
    with pytest.raises(ValueError, match="events is None"):
        tev.run_events(fcfg=tfed.FLConfig(), **kw)


def test_sim_length():
    fl = tfed.FLConfig(num_rounds=3)
    assert tfed.sim_length(fl) == 3
    assert tfed.sim_length(dataclasses.replace(
        fl, events=tev.EventConfig())) == 3
    assert tfed.sim_length(dataclasses.replace(
        fl, events=tev.EventConfig(num_events=7))) == 7


def test_event_entry_point_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    kw = _small_world()
    kw.pop("device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfed.run_federated(fcfg=tfed.FLConfig(events=tev.EventConfig()),
                           **kw)


def test_event_card_run_matches_cpu_run():
    """Card and CPU from one tape, TF32 off, the asynchronous mode with
    the subsystems composed (needs a CUDA device): equal selections,
    landed counts and flushes; ``fedavg_agg_stale`` launched once per
    event."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA kernels have no CPU mode)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    kw = _small_world()
    kw.pop("device")
    fl = tfed.FLConfig(num_rounds=2, batch_size=50, learning_rate=0.1,
                       use_kernel_agg=True, stream=tst.StreamConfig(),
                       faults=LIVE_FAULTS, dispatch_cap=3,
                       carry_dtype="bfloat16",
                       events=tev.EventConfig(**ASYNC))
    draws = tfed.draw_tape(
        torch.Generator().manual_seed(5), kw["net"], 6, kw["data"].capacity,
        tfed._max_local_steps(fl, kw["data"].capacity), 50, fl,
        tfed.client_histograms(kw["data"], 10))
    before = tagg.fedavg_agg_stale.launches
    pg, rg, lg = tev.run_events(fcfg=fl, draws=draws, device="cuda", **kw)
    assert tagg.fedavg_agg_stale.launches == before + 6
    pc, rc, lc = tev.run_events(fcfg=fl, draws=draws, device="cpu", **kw)
    assert lg.flushed == lc.flushed
    for a, b in zip(rg, rc):
        np.testing.assert_array_equal(a.selected, b.selected)
        assert a.n_success == b.n_success
    for n in pc:
        torch.testing.assert_close(pg[n].cpu(), pc[n], rtol=0, atol=1e-4)


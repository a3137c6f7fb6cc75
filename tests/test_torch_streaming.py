"""The port's streaming-data subsystem against the JAX reference.

Arrival rates and affinities, every arrival process's deterministic
``sample`` fed the reference's own ``jax.random`` draws, the plain
``stream_update`` against ``ref.stream_update`` and the Pallas kernel in
interpret mode, the usage-log bucketing, the staleness boost, and the
driver with ``FLConfig.stream`` against ``make_feel_sim`` on one key
schedule.
"""

import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import scheduler as jsch  # noqa: E402
from repro.core import streaming as jst  # noqa: E402
from repro.data import partition as jpart  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core import scheduler as tsch  # noqa: E402
from repro_torch.core import streaming as tst  # noqa: E402
from repro_torch.data import partition as tpart  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.kernels import _build, _check  # noqa: E402
from repro_torch.kernels import stream_update as tsu  # noqa: E402
from test_torch_federated import assert_runs_agree, run_pair  # noqa: E402

K, C = 12, 10


def _hists(seed, k=K, c=C, zero_rows=(3,)):
    rng = np.random.default_rng(seed)
    h = rng.integers(0, 40, (k, c)).astype(np.float32)
    h[:, rng.integers(0, c)] *= 3.0
    for r in zero_rows:
        h[r] = 0.0
    return h


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture
def cuda_device():
    """The CUDA card, or a skip: these tests launch the CUDA kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("mix", [0.0, 0.1, 0.5])
def test_arrival_affinity_matches_reference(mix):
    """Same f32 arithmetic, elementwise after one row sum: 1 ulp."""
    h = _hists(1)
    got = tpart.arrival_affinity(_t(h), mix).numpy()
    want = np.asarray(jpart.arrival_affinity(jnp.asarray(h), mix))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-6)


@pytest.mark.parametrize("rate,spread", [(20.0, 0.5), (7.5, 0.2),
                                         (25.0, 0.0)])
def test_arrival_rates_from_the_reference_uniform(rate, spread):
    """The port maps the reference's [0, 1) draw onto [1-s, 1+s) as
    ``jax.random.uniform`` does (an FMA there may round once more)."""
    key = jax.random.key(11)
    want = np.asarray(jsyn.sample_arrival_rates(key, K, rate, spread))
    got = tsyn.sample_arrival_rates(_t(jax.random.uniform(key, (K,))),
                                    rate, spread).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-7, atol=0)


def _jax_draw(name, key, st_j, cfg):
    """The reference process's own random numbers, as the port's draw."""
    if name == "poisson":
        lam = st_j.rates[:, None] * st_j.affinity
        return {"counts": _t(jax.random.poisson(key, lam)).float()}
    if name == "evict":
        lam = st_j.rates[:, None] * st_j.affinity
        return {"arrived": _t(jax.random.poisson(key, lam)).float()}
    if name == "drift":
        kb, kc, kn = jax.random.split(key, 3)
        shape = st_j.drift_class.shape
        return {"redraw": _t(jax.random.bernoulli(kb, cfg.burst_prob,
                                                  shape)),
                "fresh": _t(jax.random.randint(kc, shape, 0, C, jnp.int32)),
                "counts": _t(jax.random.poisson(kn, st_j.rates)).float()}
    return {}


def _port_state(st_j, process, draw0, cfg, h):
    st = process.init(draw0, _t(h), cfg)
    return dataclasses.replace(st, round=int(st_j.round))


@pytest.mark.parametrize("name", ["static", "poisson", "drift", "shift",
                                  "evict"])
def test_process_sample_from_reference_draws(name):
    """``init`` and ``sample`` on the reference's draws give the
    reference's state, deltas and arrival mass (integer counts exact;
    rates, affinity and eviction to f32 rounding)."""
    cfg_j = jst.StreamConfig(process=name, burst_prob=0.4)
    cfg_t = tst.StreamConfig(process=name, burst_prob=0.4)
    h = _hists(2)
    k_init, k_round = jax.random.split(jax.random.key(5))
    proc_j = jst.get_process(name)
    st_j = dataclasses.replace(proc_j.init(k_init, jnp.asarray(h), cfg_j),
                               round=jnp.asarray(3, jnp.int32))
    proc_t = tst.get_process(name)
    draw0 = {"u": _t(jax.random.uniform(k_init, (K,)))} \
        if name != "static" else {}
    st_t = _port_state(st_j, proc_t, draw0, cfg_t, h)
    np.testing.assert_allclose(st_t.rates.numpy(), np.asarray(st_j.rates),
                               rtol=2e-7)
    np.testing.assert_allclose(st_t.affinity.numpy(),
                               np.asarray(st_j.affinity), rtol=1e-6)
    np.testing.assert_array_equal(st_t.drift_class.numpy(),
                                  np.asarray(st_j.drift_class))
    d_j, a_j, st_j2 = proc_j.sample(k_round, st_j, cfg_j)
    if name == "shift":
        # The port's wave, drawn by the reference's Poisson sampler.
        lam = tst.Shift.intensity(st_t, cfg_t).numpy()
        draw = {"counts": _t(jax.random.poisson(k_round, lam)).float()}
    else:
        draw = _jax_draw(name, k_round, st_j, cfg_j)
    d_t, a_t, st_t2 = proc_t.sample(draw, st_t, cfg_t)
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), rtol=1e-6)
    np.testing.assert_array_equal(st_t2.drift_class.numpy(),
                                  np.asarray(st_j2.drift_class))


def test_shift_intensity_matches_reference_wave():
    """The rotating wave itself, written as the reference's ``Shift``
    computes it, against the port's intensity (f32 softmax and cos: a
    few ulps)."""
    cfg_j = jst.StreamConfig(process="shift")
    cfg_t = tst.StreamConfig(process="shift")
    h = _hists(4)
    st_t = tst.base_state(_t(h), rates=torch.full((K,), 20.0))
    for r in (0, 5, 13):
        st_t = dataclasses.replace(st_t, round=r)
        classes = jnp.arange(C, dtype=jnp.float32)
        centre = jnp.asarray(r, jnp.int32).astype(jnp.float32) \
            / cfg_j.shift_period
        wave = jax.nn.softmax(cfg_j.shift_sharpness * jnp.cos(
            2.0 * jnp.pi * (classes - centre) / C))
        np.testing.assert_allclose(
            tst.Shift.intensity(st_t, cfg_t).numpy(),
            np.broadcast_to(20.0 * np.asarray(wave), (K, C)), rtol=1e-6)


@pytest.mark.parametrize("rows", [3, 40])
def test_trace_and_trace_bank_replay_the_reference(rows):
    rng = np.random.default_rng(rows)
    deltas = rng.integers(-5, 9, (rows, K, C)).astype(np.float32)
    bank = rng.integers(-3, 6, (4, rows, K, C)).astype(np.float32)
    h = _hists(6)
    key = jax.random.key(9)
    cfg_j, cfg_t = jst.StreamConfig(), tst.StreamConfig()
    tr_j, tr_t = jst.Trace(deltas), tst.Trace(deltas)
    tb_j, tb_t = jst.TraceBank(bank), tst.TraceBank(bank)
    st_tr = tr_t.init({}, _t(h), cfg_t)
    st_bj = tb_j.init(key, jnp.asarray(h), cfg_j)
    st_bt = tb_t.init({"row": _t(jax.random.randint(key, (), 0, 4))},
                      _t(h), cfg_t)
    np.testing.assert_array_equal(st_bt.bank.numpy(), np.asarray(st_bj.bank))
    for r in (0, 1, rows + 2):
        st_j = dataclasses.replace(tr_j.init(key, jnp.asarray(h), cfg_j),
                                   round=jnp.asarray(r, jnp.int32))
        for proc_j, proc_t, sj, stt in (
                (tr_j, tr_t, st_j, st_tr),
                (tb_j, tb_t, dataclasses.replace(
                    st_bj, round=jnp.asarray(r, jnp.int32)), st_bt)):
            d_j, a_j, _ = proc_j.sample(key, sj, cfg_j)
            d_t, a_t, _ = proc_t.sample({}, dataclasses.replace(stt, round=r),
                                        cfg_t)
            np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))
            np.testing.assert_array_equal(a_t.numpy(), np.asarray(a_j))


def test_placeholder_traces_raise_the_recipe():
    h = torch.zeros((K, C))
    with pytest.raises(ValueError, match="register_process"):
        tst.get_process("trace").init({}, h, tst.StreamConfig())
    with pytest.raises(ValueError, match="register_process"):
        tst.get_process("trace_bank").init_draw(
            torch.Generator(), K, tst.StreamConfig(), torch.device("cpu"))
    with pytest.raises(ValueError, match="unknown arrival process"):
        tst.get_process("nope")
    # Other test files register processes of their own in the
    # reference's registry; the built-in ones are the same.
    builtin = ("drift", "evict", "poisson", "shift", "static", "trace",
               "trace_bank")
    assert tst.process_names() == builtin
    assert set(builtin) <= set(jst.process_names())


def _refresh_inputs(seed, shape=(K,), c=C):
    rng = np.random.default_rng(seed)
    h = rng.integers(0, 60, shape + (c,)).astype(np.float32)
    d = rng.integers(-30, 30, shape + (c,)).astype(np.float32)
    arr = np.maximum(d, 0).sum(-1).astype(np.float32)
    stale = rng.random(shape).astype(np.float32) * 50
    sel = (rng.random(shape) > 0.5).astype(np.float32)
    return h, d, arr, stale, sel


@pytest.mark.parametrize("size_cap", [0.0, 120.0, 500.0])
@pytest.mark.parametrize("batch", [(), (3,)])
def test_stream_update_plain_matches_reference(size_cap, batch):
    """Against ``ref.stream_update`` and the Pallas kernel (interpret):
    sums over C classes in another order, 1e-6 relative."""
    args = _refresh_inputs(int(size_cap) + len(batch), batch + (K,))
    got = tsu.stream_update(*map(_t, args), decay=0.8, size_cap=size_cap)
    for want in (jref.stream_update(*args, decay=0.8, size_cap=size_cap),
                 jops.stream_update(*args, decay=0.8, size_cap=size_cap)):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-6)
    if size_cap > 0:
        assert float(got[1][..., 2].max()) <= size_cap * (1 + 1e-6)


def test_refresh_routes_and_cpu_wrapper_does_not_launch():
    args = [_t(a) for a in _refresh_inputs(7)]
    before = tsu.stream_update.launches
    got = tst.refresh(*args, tst.StreamConfig(), 90.0)
    want = tsu.stream_update_plain(*args, decay=0.8, size_cap=90.0)
    assert tsu.stream_update.launches == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_usage_log_to_deltas_matches_reference():
    rng = np.random.default_rng(3)
    recs = []
    for i in range(300):
        rec = {"t": float(rng.uniform(0, 100)),
               "device": int(rng.integers(-1, K + 1)),
               "class": int(rng.integers(0, C + 1))}
        if i % 7 == 0:
            rec["count"] = float(rng.integers(-3, 4))
        recs.append(json.dumps(rec) if i % 2 else rec)
    recs += ["", "  "]
    for kw in ({}, {"t_start": 10.0, "t_end": 90.0}):
        np.testing.assert_array_equal(
            tst.usage_log_to_deltas(recs, 6, K, C, **kw),
            jst.usage_log_to_deltas(recs, 6, K, C, **kw))
    np.testing.assert_array_equal(
        tst.trace_bank([recs[:100], recs[100:]], 4, K, C),
        jst.trace_bank([recs[:100], recs[100:]], 4, K, C))
    assert tst.usage_log_to_deltas([], 2, K, C).shape == (2, K, C)
    with pytest.raises(ValueError):
        tst.trace_bank([], 2, K, C)


@pytest.mark.parametrize("weight", [0.0, 0.25, 1.0])
def test_staleness_boost_matches_reference(weight):
    rng = np.random.default_rng(1)
    pri = rng.random(K).astype(np.float32)
    stale = (rng.random(K) * 80).astype(np.float32)
    got = tsch.staleness_boost(_t(pri), _t(stale),
                               tsch.SchedulerConfig(staleness_weight=weight))
    want = jsch.staleness_boost(jnp.asarray(pri), jnp.asarray(stale),
                                jsch.SchedulerConfig(
                                    staleness_weight=weight))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    assert tsch.staleness_boost(_t(pri), None, tsch.SchedulerConfig(
        staleness_weight=1.0)) is not None


def test_driver_with_streaming_matches_reference():
    """``FLConfig.stream`` (Poisson arrivals, the reference's refresh
    through its Pallas kernel, staleness boost 0.25) on the MLP: equal
    selections, iterations and delivered counts; Sub2 objective 1e-4;
    params atol 1e-4."""
    jp, jm, tp, recs = run_pair(
        "mlp", K, 0, 0.1,
        jsub=dict(stream=jst.StreamConfig(use_kernel=True)),
        tsub=dict(stream=tst.StreamConfig()),
        sched_extra=dict(staleness_weight=0.25))
    assert_runs_agree(jm, recs, jp, tp, atol=1e-4)


def test_stream_update_kernel_on_card(cuda_device):
    """The CUDA kernel against its plain version."""
    for batch in ((), (16,)):
        args = [_t(a) for a in _refresh_inputs(9, batch + (100,))]
        before = tsu.stream_update.launches
        got = tsu.stream_update(*(a.to(cuda_device) for a in args),
                                decay=0.8, size_cap=300.0)
        torch.cuda.synchronize()
        assert tsu.stream_update.launches == before + 1
        want = tsu.stream_update_plain(*args, decay=0.8, size_cap=300.0)
        for g, w in zip(got, want):
            torch.testing.assert_close(g.cpu(), w, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("c,want", [
    (1, "g8"), (8, "g8"), (9, "g16"), (10, "g16"), (16, "g16"),
    (17, "g32"), (32, "g32"), (33, "g32x2"), (64, "g32x2")])
def test_stream_update_route_by_classes(c, want):
    """The narrowest group of 8, 16 or 32 lanes that holds C classes, two
    classes a lane past 32; C out of [1, 64] has no route."""
    assert tsu.route(c) == want
    lanes = tsu.ROUTE_LANES[want]
    assert c <= lanes
    assert all(c > n for n in tsu.ROUTE_LANES.values() if n < lanes)
    for bad in (0, 65):
        with pytest.raises(ValueError, match="1 <= C <= 64"):
            tsu.route(bad)


def _refuse_library():
    raise AssertionError("the wrapper reached the kernel library")


def test_stream_update_rejects_before_any_launch(monkeypatch):
    """C > 64, a wrong dtype, a wrong shape and a non-contiguous operand
    raise before the library is loaded or a launch counted (meta tensors
    take the kernel's path without a card)."""
    monkeypatch.setattr(_build, "library", _refuse_library)
    meta = torch.device("meta")

    def args(c=C, **swap):
        out = dict(h=torch.zeros((2, K, c), device=meta),
                   d=torch.zeros((2, K, c), device=meta),
                   arr=torch.zeros((2, K), device=meta),
                   stale=torch.zeros((2, K), device=meta),
                   sel=torch.zeros((2, K), device=meta))
        out.update(swap)
        return out.values()

    before = (tsu.stream_update.launches,
              dict(tsu.stream_update.route_launches))
    cases = [
        (ValueError, "1 <= C <= 64", args(c=65)),
        (TypeError, "deltas must be torch.float32",
         args(d=torch.zeros((2, K, C), device=meta, dtype=torch.float64))),
        (TypeError, "selected must be torch.float32",
         args(sel=torch.zeros((2, K), device=meta, dtype=torch.int32))),
        (ValueError, "arrivals must have shape",
         args(arr=torch.zeros((2, K + 1), device=meta))),
        (ValueError, "hists must be contiguous",
         args(h=torch.zeros((C, K, 2), device=meta).transpose(0, 2))),
    ]
    for err, match, operands in cases:
        with pytest.raises(err, match=match):
            tsu.stream_update(*operands, decay=0.8, size_cap=0.0)
    assert (tsu.stream_update.launches,
            tsu.stream_update.route_launches) == before


@pytest.mark.parametrize("s", [1, 3, 16])
@pytest.mark.parametrize("c", [1, 10, 16, 17, 32, 33, 64])
def test_stream_update_routes_on_card(cuda_device, c, s):
    """Each side of every group width, K = 37 rows a scenario (S = 1 and
    3: a row count that fills no whole block at any width), with and
    without the cap: after every SM's shared memory is filled with NaN,
    two launches give the same bits through the route ``route(C)``
    predicts (the C source's own choice agrees), within 1e-6 of the plain
    version."""
    k = 37
    which = tsu.route(c)
    assert _build.library().stream_update_route(c) == tsu.ROUTE_LANES[which]
    args = [_t(a) for a in _refresh_inputs(100 * c + s, (s, k), c)]
    on_card = [a.to(cuda_device) for a in args]
    for size_cap in (0.0, 300.0):
        before = tsu.stream_update.route_launches[which]
        outs = []
        for _ in range(2):
            _check.fill_shared_memory(cuda_device)
            outs.append(tsu.stream_update(*on_card, decay=0.8,
                                          size_cap=size_cap))
        torch.cuda.synchronize()
        assert tsu.stream_update.route_launches[which] == before + 2
        for a, b in zip(*outs):
            assert torch.equal(a, b)
        want = tsu.stream_update_plain(*args, decay=0.8, size_cap=size_cap)
        for g, w in zip(outs[0], want):
            torch.testing.assert_close(g.cpu(), w, rtol=1e-6, atol=1e-6)

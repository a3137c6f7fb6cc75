"""The port's Sub2, Sub1 and scheduling policies against the JAX reference.

Bandwidth allocation (``core.bandwidth``, ``core.allocator``), selection
(``core.selection``) and every scheduling policy (``core.scheduler``) of
``repro_torch`` run on the same numpy-seeded inputs as their ``repro``
counterparts, on the CPU; each tolerance is stated with its reason.
"""

import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import allocator as jalloc  # noqa: E402
from repro.core import bandwidth as jbw  # noqa: E402
from repro.core import diversity as jdiv  # noqa: E402
from repro.core import scheduler as jsch  # noqa: E402
from repro.core import selection as jsel  # noqa: E402
from repro.core import wireless as jw  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import allocator as talloc  # noqa: E402
from repro_torch.core import bandwidth as tbw  # noqa: E402
from repro_torch.core import scheduler as tsch  # noqa: E402
from repro_torch.core import selection as tsel  # noqa: E402
from repro_torch.core import wireless as tw  # noqa: E402

JW = jw.WirelessConfig()
TW = tw.WirelessConfig()
NET_FIELDS = ("distance_m", "pathloss", "tx_power", "cpu_freq",
              "cycles_per_bit")


def _t(x, dtype=None):
    return torch.from_numpy(np.array(x, dtype))


@functools.lru_cache(maxsize=None)
def _world(seed, k):
    """A reference network, fading draw and sizes + the port's copies
    (cached: the tests only read them)."""
    jnet = jw.sample_network(jax.random.key(seed), k, JW)
    gains = jw.sample_fading(jax.random.key(seed + 1), jnet)
    sizes = jax.random.randint(jax.random.key(seed + 2), (k,), 50, 600)
    tnet = convert.network_from_numpy(
        **{f: np.asarray(getattr(jnet, f)) for f in NET_FIELDS})
    return jnet, gains, sizes, tnet, _t(gains, np.float32), \
        _t(sizes, np.int32)


def _hist_inputs(k=20, n=300, c=10, seed=0):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, c, (k, n)).astype(np.int32)
    # Non-IID rows: some devices hold one or two classes only.
    labels[:5] = labels[:5] % 2
    labels[5] = 3
    mask = (rng.random((k, n)) > 0.4).astype(np.float32)
    ages = rng.integers(0, 6, k).astype(np.int32)
    return labels, mask, ages


# ---------------------------------------------------------------------------
# Bandwidth (Sub2)
# ---------------------------------------------------------------------------

def _sub2_case(seed, k, frac=0.5):
    jnet, gains, sizes, tnet, tg, ts = _world(seed, k)
    tt = jw.train_time(sizes, jnet, JW)
    sel = (jax.random.uniform(jax.random.key(seed + 9), (k,)) < frac
           ).astype(jnp.float32).at[0].set(1.0)
    return (jnet, gains, tt, sel), (tnet, tg, _t(tt, np.float32),
                                    _t(sel, np.float32))


@pytest.mark.parametrize("k,seed", [(5, 0), (40, 2)])
@pytest.mark.parametrize("warm", [False, True])
def test_min_time_allocation_matches_reference(k, seed, warm):
    """Fixed-trip bisection + Newton in both: log1p and the sums round
    differently, well below the solver's own 1e-3 tolerance."""
    (jnet, gains, tt, sel), (tnet, tg, ttt, tsel) = _sub2_case(seed, k)
    a0 = np.full((k,), 1.0 / k, np.float32) if warm else None
    ja, jt = jbw.min_time_allocation(sel, tt, gains, jnet.tx_power, JW,
                                     alpha0=a0)
    ta, tt_ = tbw.min_time_allocation(tsel, ttt, tg, tnet.tx_power, TW,
                                      alpha0=None if a0 is None else _t(a0))
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-4,
                               atol=1e-7)
    assert float(tt_) == pytest.approx(float(jt), rel=1e-5)
    assert float(ta.sum()) <= 1.0 + 1e-6


def test_min_time_allocation_empty_and_payload_bits():
    (jnet, gains, tt, _), (tnet, tg, ttt, _) = _sub2_case(3, 10)
    zero = torch.zeros(10)
    a, t = tbw.min_time_allocation(zero, ttt, tg, tnet.tx_power, TW)
    assert torch.equal(a, zero) and float(t) == 0.0
    bits = np.linspace(2e4, 2e5, 10).astype(np.float32)
    sel = np.ones(10, np.float32)
    ja, _ = jbw.min_time_allocation(sel, tt, gains, jnet.tx_power, JW,
                                    payload_bits=bits)
    ta, _ = tbw.min_time_allocation(_t(sel), ttt, tg, tnet.tx_power, TW,
                                    payload_bits=_t(bits))
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-4)


def test_rate_inversion_and_deadline_shares_match_reference():
    (jnet, gains, tt, sel), (tnet, tg, ttt, tsel) = _sub2_case(4, 12)
    r_req = np.geomspace(1e4, 1e7, 12).astype(np.float32)
    np.testing.assert_allclose(
        tbw.invert_rate(_t(r_req), tg, tnet.tx_power, TW).numpy(),
        np.asarray(jbw.invert_rate(r_req, gains, jnet.tx_power, JW)),
        rtol=1e-5)
    deadline = float(np.max(np.asarray(tt))) * 1.5
    np.testing.assert_allclose(
        tbw.alpha_for_deadline(torch.tensor(deadline), tsel, ttt, tg,
                               tnet.tx_power, TW).numpy(),
        np.asarray(jbw.alpha_for_deadline(jnp.float32(deadline), sel, tt,
                                          gains, jnet.tx_power, JW)),
        rtol=1e-5)


def test_project_simplex_and_objective_match_reference():
    rng = np.random.default_rng(2)
    v = rng.standard_normal(9).astype(np.float32)
    mask = np.array([1, 1, 0, 1, 0, 1, 1, 1, 1], np.float32)
    np.testing.assert_allclose(
        tbw.project_simplex(_t(v), _t(mask)).numpy(),
        np.asarray(jbw.project_simplex(v, mask)), atol=1e-7)
    (jnet, gains, tt, sel), (tnet, tg, ttt, tsel) = _sub2_case(5, 9)
    a = np.asarray(jbw.project_simplex(v, np.asarray(sel)))
    for tau in (0.0, 1e-3):
        assert float(tbw.sub2_objective(_t(a), tsel, ttt, tg, tnet.tx_power,
                                        TW, 0.5, smooth_tau=tau)) == \
            pytest.approx(float(jbw.sub2_objective(
                a, sel, tt, gains, jnet.tx_power, JW, 0.5, smooth_tau=tau)),
                rel=1e-6)


@pytest.mark.parametrize("k,seed", [(20, 1)])
def test_pgd_allocation_matches_reference(k, seed):
    """Autograd and jax.grad of the same smoothed objective, 120
    normalised steps: the reference's kernel-vs-oracle tolerance (alpha
    atol 1e-2, objective rel 1e-3) — steps amplify last-bit differences
    along the flat valley, while the objective stays tight.  Every
    device is selected: see the next test for why."""
    (jnet, gains, tt, sel), (tnet, tg, ttt, tsel) = _sub2_case(seed, k,
                                                               frac=1.1)
    ja, jo = jbw.pgd_allocation(sel, tt, gains, jnet.tx_power, JW,
                                jbw.Sub2Params.fast())
    ta, to = tbw.pgd_allocation(tsel, ttt, tg, tnet.tx_power, TW,
                                tbw.Sub2Params.fast())
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=1e-2)
    assert float(to) == pytest.approx(float(jo), rel=1e-3)


def test_pgd_allocation_descends_where_the_reference_gradient_is_nan():
    """A fault of the reference: ``jax.grad`` of
    ``wireless.achievable_rate`` is NaN at alpha = 0, so with any device
    unselected ``bandwidth.pgd_allocation`` steps to NaN and returns its
    water-filling start.  The port's autograd gives 0 there and
    descends to a lower objective, as the reference's own objective
    function confirms."""
    (jnet, gains, tt, sel), (tnet, tg, ttt, tsel) = _sub2_case(0, 6)
    assert 0 < float(jnp.sum(sel)) < 6
    g = jax.grad(lambda a: jw.achievable_rate(a, gains[0], jnet.tx_power[0],
                                              JW))(jnp.float32(0.0))
    assert np.isnan(float(g))
    p = jbw.Sub2Params.fast()
    ja, jo = jbw.pgd_allocation(sel, tt, gains, jnet.tx_power, JW, p)
    wf, _ = jbw.min_time_allocation(sel, tt, gains, jnet.tx_power, JW, p)
    np.testing.assert_allclose(np.asarray(ja), np.asarray(wf), atol=1e-6)
    ta, _ = tbw.pgd_allocation(tsel, ttt, tg, tnet.tx_power, TW,
                               tbw.Sub2Params.fast())
    port_obj = float(jbw.sub2_objective(ta.numpy(), sel, tt, gains,
                                        jnet.tx_power, JW, p.rho))
    assert port_obj < float(jo) * (1 - 1e-3)


@pytest.mark.parametrize("name", ["waterfilling", "pgd", "fused_pgd"])
def test_allocators_match_reference(name):
    """Each registry entry against the reference's (same tolerance
    reasoning as above; water-filling has no descent and is tight)."""
    # Every device selected: the reference's ``pgd`` has a NaN gradient
    # on unselected devices (see above).
    (jnet, gains, tt, sel), (tnet, tg, ttt, tsel) = _sub2_case(
        6, 14, frac=1.1 if name == "pgd" else 0.5)
    p = jbw.Sub2Params.fast()
    ja, jo = jalloc.get(name, p).solve(sel, tt, gains, jnet.tx_power, JW)
    ta, to = talloc.get(name, tbw.Sub2Params.fast()).solve(
        tsel, ttt, tg, tnet.tx_power, TW)
    atol = 1e-6 if name == "waterfilling" else 1e-2
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=atol)
    assert float(to) == pytest.approx(float(jo), rel=1e-3)


def test_allocator_registry():
    assert talloc.names() == jalloc.names() == ("fused_pgd", "importance",
                                                "pgd", "waterfilling")
    assert isinstance(talloc.get("pgd"), talloc.Allocator)
    assert isinstance(talloc.get("importance"), talloc.ImportanceWeighted)
    with pytest.raises(ValueError):
        talloc.get("nope")
    with pytest.raises(ValueError, match="already registered"):
        talloc.register("pgd", talloc.PGD)
    try:
        talloc.register("pgd-again", talloc.PGD)
        talloc.register("pgd-again", talloc.WaterFilling, overwrite=True)
        assert isinstance(talloc.get("pgd-again"), talloc.WaterFilling)
    finally:
        del talloc._REGISTRY["pgd-again"]


# ---------------------------------------------------------------------------
# The importance-weighted allocator and the oracles
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sizes", [True, False])
def test_importance_weights_and_weighted_objective_match_reference(sizes):
    (jnet, gains, tt, sel), (tnet, tg, ttt, tsel) = _sub2_case(7, 12)
    _, _, js, _, _, ts = _world(7, 12)
    jw_ = jalloc.importance_weights(sel, tt, gains, jnet.tx_power, JW, 1.5,
                                    data_sizes=js if sizes else None)
    tw_ = talloc.importance_weights(tsel, ttt, tg, tnet.tx_power, TW, 1.5,
                                    data_sizes=ts if sizes else None)
    np.testing.assert_allclose(tw_.numpy(), np.asarray(jw_), rtol=1e-6)
    assert torch.equal(tw_[tsel == 0], torch.ones(int((tsel == 0).sum())))
    a = np.asarray(jbw.project_simplex(np.full(12, 0.3, np.float32),
                                       np.asarray(sel)))
    for tau in (0.0, 1e-3):
        assert float(tbw.sub2_objective(
            _t(a), tsel, ttt, tg, tnet.tx_power, TW, 0.5, smooth_tau=tau,
            energy_weights=tw_)) == pytest.approx(float(jbw.sub2_objective(
                a, sel, tt, gains, jnet.tx_power, JW, 0.5, smooth_tau=tau,
                energy_weights=jw_)), rel=1e-6)


def test_importance_allocator_matches_reference():
    """Every device selected (the reference's ``pgd`` descends only
    then, see above): the ``pgd`` parity tolerances, alpha atol 1e-2 and
    the objective rel 1e-3."""
    (jnet, gains, tt, sel), (tnet, tg, ttt, tsel) = _sub2_case(8, 14,
                                                               frac=1.1)
    _, _, js, _, _, ts = _world(8, 14)
    ja, jo = jalloc.get("importance", jbw.Sub2Params.fast()).solve(
        sel, tt, gains, jnet.tx_power, JW, data_sizes=js)
    ta, to = talloc.get("importance", tbw.Sub2Params.fast()).solve(
        tsel, ttt, tg, tnet.tx_power, TW, data_sizes=ts)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=1e-2)
    assert float(to) == pytest.approx(float(jo), rel=1e-3)
    assert float(ta.sum()) <= 1.0 + 1e-6


def test_importance_at_beta_zero_is_pgd():
    """beta = 0 prices every device at 1: the unweighted descent, bit for
    bit."""
    (_, _, _, _), (tnet, tg, ttt, tsel) = _sub2_case(9, 10, frac=1.1)
    p = tbw.Sub2Params(pgd_iters=30)
    ia, io = talloc.ImportanceWeighted(p, beta=0.0).solve(
        tsel, ttt, tg, tnet.tx_power, TW)
    pa, po = talloc.get("pgd", p).solve(tsel, ttt, tg, tnet.tx_power, TW)
    assert torch.equal(ia, pa) and torch.equal(io, po)


def test_importance_allocator_on_stacked_rows_is_per_lane():
    rows = [_sub2_case(seed, 9, frac=1.1)[1] for seed in (10, 11)]
    p = tbw.Sub2Params(pgd_iters=30)
    stack = [torch.stack(x) for x in zip(*[(r[1], r[2], r[3])
                                           for r in rows])]
    tx = torch.stack([r[0].tx_power for r in rows])
    sa, so = talloc.get("importance", p).solve(stack[2], stack[1], stack[0],
                                               tx, TW)
    for i, (tnet, tg, ttt, tsel) in enumerate(rows):
        a, o = talloc.get("importance", p).solve(tsel, ttt, tg,
                                                 tnet.tx_power, TW)
        np.testing.assert_allclose(sa[i].numpy(), a.numpy(), atol=1e-6)
        assert float(so[i]) == pytest.approx(float(o), rel=1e-6)


def test_bisection_oracles_match_reference():
    (jnet, gains, tt, sel), (tnet, tg, ttt, tsel) = _sub2_case(12, 10)
    r_req = np.geomspace(1e4, 1e7, 10).astype(np.float32)
    np.testing.assert_allclose(
        tbw.invert_rate_bisect(_t(r_req), tg, tnet.tx_power, TW).numpy(),
        np.asarray(jbw.invert_rate_bisect(r_req, gains, jnet.tx_power, JW)),
        rtol=1e-6)
    p = jbw.Sub2Params.fast()
    ja, jt = jbw.min_time_allocation_reference(sel, tt, gains,
                                               jnet.tx_power, JW, p)
    ta, tt_ = tbw.min_time_allocation_reference(tsel, ttt, tg,
                                                tnet.tx_power, TW,
                                                tbw.Sub2Params.fast())
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-6,
                               atol=1e-9)
    assert float(tt_) == pytest.approx(float(jt), rel=1e-6)
    # The production solve agrees with its oracle (the reference's own
    # 1e-3 claim).
    fa, ft = tbw.min_time_allocation(tsel, ttt, tg, tnet.tx_power, TW)
    assert float(ft) == pytest.approx(float(tt_), rel=1e-3)
    zero = torch.zeros(10)
    a0, t0 = tbw.min_time_allocation_reference(zero, ttt, tg,
                                               tnet.tx_power, TW)
    assert torch.equal(a0, zero) and float(t0) == 0.0


@pytest.mark.parametrize("name", ["approximate_entropy", "sample_entropy"])
def test_approximate_and_sample_entropy_match_reference(name):
    """Noise, a periodic series and a 4-level one (many exact ties at
    the tolerance r), m = 2 and 3: within 1e-5."""
    from repro_torch.core import diversity as tdiv
    rng = np.random.default_rng(0)
    ref = jax.jit(getattr(jdiv, name), static_argnums=(1,))
    for series in (rng.standard_normal(120).astype(np.float32),
                   np.sin(np.arange(120) / 3.0).astype(np.float32),
                   rng.integers(0, 4, 120).astype(np.float32)):
        for m in (2, 3):
            got = float(getattr(tdiv, name)(_t(series), m))
            want = float(ref(jnp.asarray(series), m))
            assert got == pytest.approx(want, abs=1e-5), (name, m)


@pytest.mark.parametrize("method", ["das", "abs", "random", "full"])
def test_public_schedule_takes_a_draw_or_a_generator(method):
    """``scheduler.schedule`` on the reference's draw equals the
    reference's ``schedule`` (selections and iterations), and on a
    generator draws that uniform row itself for abs and random only."""
    k = 12
    jnet, gains, sizes, tnet, tg, ts = _world(13, k)
    ages = np.random.default_rng(4).integers(0, 5, k).astype(np.int32)
    index = np.random.default_rng(5).random(k).astype(np.float32)
    key = jax.random.key(9)
    u = np.asarray(jax.random.uniform(key, (k,)))
    kw = dict(method=method, n_min=2, iterations_max=4,
              allocator="waterfilling",
              n_fixed=4 if method == "random" else None)
    jr = jsch.schedule(key, index, ages, sizes, gains, jnet, JW,
                       jsch.SchedulerConfig(**kw))
    tcfg = tsch.SchedulerConfig(**kw)
    args = (_t(index), _t(ages), ts, tg, tnet, TW, tcfg)
    tr = tsch.schedule(_t(u), *args)
    np.testing.assert_array_equal(tr.selected.numpy(),
                                  np.asarray(jr.selected))
    assert int(tr.iterations) == int(jr.iterations)
    np.testing.assert_allclose(tr.alpha.numpy(), np.asarray(jr.alpha),
                               rtol=1e-4, atol=1e-7)
    gen = torch.Generator().manual_seed(3)
    got = tsch.schedule(gen, *args)
    draws = method in ("abs", "random")
    want = tsch.schedule_impl(
        torch.rand(k, generator=torch.Generator().manual_seed(3))
        if draws else None, *args)
    assert torch.equal(got.selected, want.selected)
    assert torch.equal(got.alpha, want.alpha)
    # Only abs and random consume the generator.
    fresh = torch.rand(1, generator=torch.Generator().manual_seed(3))
    assert torch.equal(torch.rand(1, generator=gen), fresh) != draws


# ---------------------------------------------------------------------------
# Selection (Sub1)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("n_min", [1, 4])
def test_solve_sub1_matches_reference(seed, n_min):
    rng = np.random.default_rng(seed)
    k = 30
    energy = rng.exponential(0.5, k).astype(np.float32)
    times = rng.uniform(0.05, 0.3, k).astype(np.float32)
    index = rng.uniform(0, 1, k).astype(np.float32)
    if seed == 3:
        energy[:] = 10.0        # nothing beneficial: the fallback decides
    params = jsel.Sub1Params(n_min=n_min)
    jx, jr, jt = jsel.solve_sub1(energy, times, index, params)
    tx, tr, tt = tsel.solve_sub1(_t(energy), _t(times), _t(index),
                                 tsel.Sub1Params(n_min=n_min))
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-6)
    assert float(tt) == float(jt)


def test_top_n_ties_go_to_the_lower_index():
    """``jax.lax.top_k`` order, kept by a stable sort on every device."""
    pr = np.array([0.5, 0.9, 0.5, 0.9, 0.1, 0.5], np.float32)
    _, jtop = jax.lax.top_k(pr, 4)
    np.testing.assert_array_equal(tsel.top_indices(_t(pr), 4).numpy(),
                                  np.asarray(jtop))
    x = tsel.round_with_min(torch.zeros(6), _t(pr), 2)
    np.testing.assert_array_equal(
        x.numpy(), np.asarray(jsel.round_with_min(np.zeros(6, np.float32),
                                                  pr, 2)))


# ---------------------------------------------------------------------------
# Scheduling policies
# ---------------------------------------------------------------------------

_METHODS = [
    dict(method="das", allocator="waterfilling"),
    dict(method="das", allocator="fused_pgd"),
    dict(method="das", allocator="fused_pgd", reentry="mean"),
    dict(method="das", allocator="waterfilling", n_fixed=3),
    dict(method="abs", allocator="waterfilling"),
    dict(method="abs", allocator="fused_pgd", n_fixed=4),
    dict(method="random", allocator="waterfilling", n_fixed=5),
    dict(method="full", allocator="fused_pgd"),
    # The streaming staleness boost and the fault reliability discount.
    dict(method="das", allocator="fused_pgd", staleness_weight=0.25,
         reliability_weight=0.5),
    dict(method="abs", allocator="waterfilling", staleness_weight=1.0,
         reliability_weight=0.5),
]


@pytest.mark.parametrize("kw", _METHODS,
                         ids=lambda kw: "-".join(map(str, kw.values())))
def test_every_scheduling_method_matches_reference(kw):
    """Same inputs and the reference's uniform draw: equal selections and
    iteration counts; energy and time within rtol 1e-4 for water-filling,
    and for the PGD allocators the Sub2 objective rho*E + (1-rho)*T
    within rtol 1e-4 while E and T trade off along its flat valley
    (rtol 5e-3)."""
    k = 16
    jnet, gains, sizes, tnet, tg, ts = _world(11, k)
    ages = np.random.default_rng(1).integers(0, 5, k).astype(np.int32)
    labels, mask, _ = _hist_inputs(k=k, seed=2)
    jh = jax.vmap(lambda lab, m: jdiv.label_histogram(lab, m, 10))(labels,
                                                                    mask)
    index = np.asarray(jdiv.diversity_index(label_hists=jh,
                                            data_sizes=sizes, ages=ages))
    key = jax.random.key(5)
    sched_u = np.asarray(jax.random.uniform(key, (k,)))
    jcfg = jsch.SchedulerConfig(n_min=2, iterations_max=5,
                                sub2=jbw.Sub2Params.fast(), **kw)
    tcfg = tsch.SchedulerConfig(n_min=2, iterations_max=5,
                                sub2=tbw.Sub2Params.fast(), **kw)
    signals = {}
    if "staleness_weight" in kw:
        rng = np.random.default_rng(3)
        signals = dict(staleness=(rng.random(k) * 60).astype(np.float32),
                       reliability=rng.random(k).astype(np.float32))
    jr = jsch.schedule(key, index, ages, sizes, gains, jnet, JW, jcfg,
                       **signals)
    tr = tsch.schedule_impl(_t(sched_u), _t(index), _t(ages), ts, tg, tnet,
                            TW, tcfg,
                            **{n: _t(a) for n, a in signals.items()})
    np.testing.assert_array_equal(tr.selected.numpy(),
                                  np.asarray(jr.selected))
    assert tr.iterations == int(jr.iterations)
    e_j, e_t = float(jnp.sum(jr.energy)), float(tr.energy.sum())
    t_j, t_t = float(jr.round_time), float(tr.round_time)
    obj_j, obj_t = 0.5 * e_j + 0.5 * t_j, 0.5 * e_t + 0.5 * t_t
    assert obj_t == pytest.approx(obj_j, rel=1e-4)
    loose = 1e-4 if kw["allocator"] == "waterfilling" else 5e-3
    assert e_t == pytest.approx(e_j, rel=loose)
    assert t_t == pytest.approx(t_j, rel=loose)
    sel = tr.selected > 0
    assert torch.isinf(tr.t_up[~sel]).all()
    assert torch.equal(tr.energy[~sel], torch.zeros(int((~sel).sum())))


def test_abs_default_deadline_uses_the_midpoint_median():
    """``jnp.median`` averages the two middle values for even K."""
    t = torch.tensor([4.0, 1.0, 3.0, 2.0])
    assert float(tsch._median(t)) == float(jnp.median(t.numpy())) == 2.5
    assert float(tsch._median(t[:3])) == float(jnp.median(t[:3].numpy()))


def test_unknown_method_and_missing_draw_raise():
    _, _, _, tnet, tg, ts = _world(0, 4)
    args = (torch.rand(4), torch.zeros(4, dtype=torch.int32), ts, tg, tnet,
            TW)
    with pytest.raises(ValueError):
        tsch.schedule_impl(None, *args, tsch.SchedulerConfig(method="x"))
    with pytest.raises(ValueError):
        tsch.schedule_impl(None, *args,
                           tsch.SchedulerConfig(method="random"))


# ---------------------------------------------------------------------------
# Stacked rows: S scenarios at once, each lane its own (K,) call
# ---------------------------------------------------------------------------

LANE_SEEDS = (11, 12, 13, 14)
# A short descent: the stacked rows are held against the port's own
# (K,) calls.
SHORT_SUB2 = dataclasses.replace(tbw.Sub2Params.fast(), pgd_iters=30)


def _lanes(k=16):
    """S = 4 scenarios' networks, fading, sizes, ages, draws and
    re-ranking signals, stacked (S, K)."""
    worlds = [_world(seed, k) for seed in LANE_SEEDS]
    tnet = tw.stack_networks([w[3] for w in worlds])
    tg = torch.stack([w[4] for w in worlds])
    ts = torch.stack([w[5] for w in worlds])
    rng = np.random.default_rng(7)
    shape = (len(LANE_SEEDS), k)
    rows = dict(index=_t(rng.random(shape), np.float32),
                ages=_t(rng.integers(0, 5, shape), np.int32),
                sched_u=_t(rng.random(shape), np.float32),
                staleness=_t(rng.random(shape) * 60, np.float32),
                reliability=_t(rng.random(shape), np.float32))
    return tnet, tg, ts, rows


def _assert_lanes_equal(stacked, singles):
    for s, one in enumerate(singles):
        for got, want in zip(stacked, one):
            assert torch.equal(got[s], want), s


def test_sub1_on_stacked_rows_is_per_lane():
    rng = np.random.default_rng(4)
    shape = (5, 30)
    energy = _t(rng.exponential(0.5, shape), np.float32)
    times = _t(rng.uniform(0.05, 0.3, shape), np.float32)
    index = _t(rng.uniform(0, 1, shape), np.float32)
    energy[2] = 10.0            # nothing beneficial: the fallback decides
    params = tsel.Sub1Params(n_min=4)
    stacked = tsel.solve_sub1(energy, times, index, params)
    assert tuple(stacked[2].shape) == (5,)
    _assert_lanes_equal(stacked, [tsel.solve_sub1(energy[s], times[s],
                                                  index[s], params)
                                  for s in range(5)])


def test_min_time_allocation_and_projection_on_stacked_rows():
    tnet, tg, ts, rows = _lanes()
    tt = tw.train_time(ts, tnet, TW)
    sel = (rows["sched_u"] < 0.6).to(torch.float32)
    sel[1] = 0.0                # an empty lane
    a0 = torch.full_like(sel, 1.0 / sel.shape[-1])
    bits = torch.linspace(2e4, 2e5, sel.shape[-1]).expand_as(sel)
    for kw in ({}, dict(alpha0=a0), dict(payload_bits=bits)):
        stacked = tbw.min_time_allocation(sel, tt, tg, tnet.tx_power, TW,
                                          **kw)
        assert tuple(stacked[1].shape) == (sel.shape[0],)
        _assert_lanes_equal(stacked, [tbw.min_time_allocation(
            sel[s], tt[s], tg[s], tnet.tx_power[s], TW,
            **{n: v[s] for n, v in kw.items()}) for s in range(4)])
    v = rows["index"] - 0.3
    _assert_lanes_equal(
        (tbw.project_simplex(v, sel),),
        [(tbw.project_simplex(v[s], sel[s]),) for s in range(4)])


@pytest.mark.parametrize("name", ["waterfilling", "pgd", "fused_pgd"])
def test_allocators_on_stacked_rows_are_per_lane(name):
    """One call on (S, K) rows (``fused_pgd``: one kernel launch on the
    card) equals the stack of the (K,) calls."""
    tnet, tg, ts, rows = _lanes()
    tt = tw.train_time(ts, tnet, TW)
    sel = (rows["sched_u"] < 0.6).to(torch.float32)
    sel[:, 0] = 1.0
    alloc = talloc.get(name, SHORT_SUB2)
    alpha, obj = alloc.solve(sel, tt, tg, tnet.tx_power, TW,
                             alpha0=torch.full_like(sel, 1.0 / 16))
    assert tuple(obj.shape) == (4,)
    _assert_lanes_equal((alpha, obj), [alloc.solve(
        sel[s], tt[s], tg[s], tnet.tx_power[s], TW,
        alpha0=torch.full_like(sel[s], 1.0 / 16)) for s in range(4)])


@pytest.mark.parametrize("kw", _METHODS,
                         ids=lambda kw: "-".join(map(str, kw.values())))
def test_every_scheduling_method_on_stacked_rows_is_per_lane(kw):
    """``schedule_impl`` on S = 4 stacked scenarios equals each lane's
    own call: selections, shares, times, energies and DAS iteration
    counts (an (S,) tensor for a stack), whatever the other lanes do."""
    tnet, tg, ts, rows = _lanes()
    tcfg = tsch.SchedulerConfig(n_min=2, iterations_max=5,
                                sub2=SHORT_SUB2, **kw)
    signals = {n: rows[n] for n in ("staleness", "reliability")} \
        if "staleness_weight" in kw else {}
    tr = tsch.schedule_impl(rows["sched_u"], rows["index"], rows["ages"], ts,
                            tg, tnet, TW, tcfg, **signals)
    fields = ("selected", "alpha", "t_train", "t_up", "energy",
              "round_time")
    singles = [tsch.schedule_impl(
        rows["sched_u"][s], rows["index"][s], rows["ages"][s], ts[s], tg[s],
        tnet.scenario(s), TW, tcfg, **{n: a[s] for n, a in signals.items()})
        for s in range(4)]
    _assert_lanes_equal([getattr(tr, f) for f in fields],
                        [[getattr(o, f) for f in fields] for o in singles])
    its = [o.iterations for o in singles]
    if kw["method"] == "das" and "n_fixed" not in kw:
        assert tr.iterations.tolist() == its
    else:
        assert tr.iterations == 0 and its == [0] * 4


def test_das_freezes_lanes_that_converge_first():
    """Lanes that converge after different numbers of outer iterations
    (with ``reentry="mean"`` lane 1 flips its selection to the last
    iteration, the others converge in 2): a converged lane's result is
    its own run's while the others go on."""
    tnet, tg, ts, rows = _lanes()
    tcfg = tsch.SchedulerConfig(n_min=2, iterations_max=6,
                                allocator="waterfilling", reentry="mean")
    tr = tsch.das_schedule(rows["index"], ts, tg, tnet, TW, tcfg)
    its = tr.iterations.tolist()
    assert len(set(its)) > 1, its
    for s in range(4):
        one = tsch.das_schedule(rows["index"][s], ts[s], tg[s],
                                tnet.scenario(s), TW, tcfg)
        assert one.iterations == its[s]
        assert torch.equal(tr.alpha[s], one.alpha)
        assert torch.equal(tr.selected[s], one.selected)

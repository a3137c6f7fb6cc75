"""The port's unreliable-uplink subsystem against the JAX reference.

``sample_faults`` on the reference's uniforms, the chronic rates, the
retry airtime multipliers, the realized accounting of ``apply_faults``,
the reliability EMA and discount, the retry-priced payload, the masked
FedAvg (plain version, the update-form aggregate, the kernel on the
card), and the driver with ``FLConfig.faults`` against ``make_feel_sim``
on one key schedule.
"""

import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import bandwidth as jbw  # noqa: E402
from repro.core import faults as jf  # noqa: E402
from repro.core import federated as jfed  # noqa: E402
from repro.core import scheduler as jsch  # noqa: E402
from repro.core import wireless as jw  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import bandwidth as tbw  # noqa: E402
from repro_torch.core import faults as tf  # noqa: E402
from repro_torch.core import federated as tfed  # noqa: E402
from repro_torch.core import scheduler as tsch  # noqa: E402
from repro_torch.core import wireless as tw  # noqa: E402
from repro_torch.kernels import fedavg_agg as tagg  # noqa: E402
from repro_torch.models import paper_nets as tnets  # noqa: E402
from test_torch_federated import (NET_FIELDS, _tiny_world,  # noqa: E402
                                  assert_runs_agree, run_pair)

K = 12
WCFG_J, WCFG_T = jw.WirelessConfig(), tw.WirelessConfig()
CONFIGS = {
    "iid": dict(drop_prob=0.3, max_retries=2, straggler_prob=0.2,
                dropout_prob=0.1),
    "chronic": dict(drop_prob=0.2, max_retries=3, chronic_spread=0.8,
                    backoff_base=0.25),
    "fade": dict(deep_fade_threshold=0.5, max_retries=1, straggler_prob=0.5,
                 straggler_tail=1.5, straggler_scale=2.0),
    "one-shot": dict(drop_prob=0.5),
}


def _t(x):
    return torch.from_numpy(np.array(x))


def _world(seed=0):
    net = jw.sample_network(jax.random.key(seed), K, WCFG_J)
    gains = jw.sample_fading(jax.random.key(seed + 1), net)
    tnet = convert.network_from_numpy(
        **{f: np.asarray(getattr(net, f)) for f in NET_FIELDS})
    return net, gains, tnet


def _draw_pair(name, seed=0):
    """The reference's draw and the port's, from the same uniforms."""
    net, gains, tnet = _world(seed)
    kw = CONFIGS[name]
    cfg_j, cfg_t = jf.FaultConfig(**kw), tf.FaultConfig(**kw)
    rates_j = jf.chronic_rates(jax.random.key(7), K, cfg_j)
    z = jax.random.normal(jax.random.key(7), (K,))
    rates_t = tf.chronic_rates(_t(z), cfg_t)
    key = jax.random.key(seed + 20)
    want = jf.sample_faults(key, gains, net, cfg_j, rates_j)
    kd, ko, ks, kt = jax.random.split(key, 4)
    u = dict(u_drop=jax.random.uniform(kd, (K, jf.attempt_budget(cfg_j))),
             u_dropout=jax.random.uniform(ko, (K,)),
             u_strag=jax.random.uniform(ks, (K,)),
             u_tail=jax.random.uniform(kt, (K,), minval=1e-6, maxval=1.0))
    got = tf.sample_faults(**{n: _t(v) for n, v in u.items()},
                           gains=_t(gains), net=tnet, cfg=cfg_t,
                           drop_rates=rates_t)
    return (net, gains, tnet, cfg_j, cfg_t, rates_j, rates_t, want, got)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_sample_faults_from_reference_uniforms(name):
    """success and attempts exactly; the Pareto multiplier to f32 pow."""
    _, _, _, _, _, rates_j, rates_t, want, got = _draw_pair(name)
    if rates_j is None:
        assert rates_t is None
    else:
        np.testing.assert_allclose(rates_t.numpy(), np.asarray(rates_j),
                                   rtol=1e-6)
    np.testing.assert_array_equal(got.success.numpy(),
                                  np.asarray(want.success))
    np.testing.assert_array_equal(got.attempts.numpy(),
                                  np.asarray(want.attempts))
    np.testing.assert_allclose(got.compute_mult.numpy(),
                               np.asarray(want.compute_mult), rtol=1e-6)


def test_draw_uniforms_shapes_and_tail_interval():
    cfg = tf.FaultConfig(max_retries=3)
    u = tf.draw_uniforms(torch.Generator().manual_seed(0), 500, cfg,
                         torch.device("cpu"))
    assert u["u_drop"].shape == (500, 4)
    assert all(u[n].shape == (500,) for n in ("u_dropout", "u_strag",
                                              "u_tail"))
    assert float(u["u_tail"].min()) >= tf.TAIL_MIN
    assert float(u["u_tail"].max()) < 1.0


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_time_mults_and_apply_faults_match_reference(name):
    """Closed-form expectation exactly (the same float64 sum); realized
    accounting to f32 rounding."""
    net, gains, tnet, cfg_j, cfg_t, _, _, want, got = _draw_pair(name, 3)
    assert tf.expected_time_mult(cfg_t) == jf.expected_time_mult(cfg_j)
    np.testing.assert_allclose(tf.time_mult(got.attempts, cfg_t).numpy(),
                               np.asarray(jf.time_mult(want.attempts,
                                                       cfg_j)), rtol=1e-7)
    rng = np.random.default_rng(1)
    sel = (rng.random(K) > 0.3).astype(np.float32)
    alpha = np.where(sel > 0, rng.random(K), 0).astype(np.float32)
    alpha /= alpha.sum()
    t_train = rng.random(K).astype(np.float32)
    for bits in (None, np.full((K,), 30e3, np.float32)):
        ok_j, e_j, t_j = jf.apply_faults(want, sel, alpha, t_train, gains,
                                         net, WCFG_J, bits, cfg_j)
        ok_t, e_t, t_t = tf.apply_faults(
            got, _t(sel), _t(alpha), _t(t_train), _t(gains), tnet, WCFG_T,
            None if bits is None else _t(bits), cfg_t)
        np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
        np.testing.assert_allclose(e_t.numpy(), np.asarray(e_j), rtol=1e-5)
        assert float(t_t) == pytest.approx(float(t_j), rel=1e-5)


@pytest.mark.parametrize("beta,weight", [(0.0, 0.5), (0.2, 0.5), (0.5, 1.0)])
def test_reliability_update_and_discount_match_reference(beta, weight):
    rng = np.random.default_rng(int(beta * 10))
    rel = rng.random(K).astype(np.float32)
    sel = (rng.random(K) > 0.4).astype(np.float32)
    ok = sel * (rng.random(K) > 0.3).astype(np.float32)
    got = tf.reliability_update(_t(rel), _t(sel), _t(ok),
                                tf.FaultConfig(reliability_ema=beta))
    want = jf.reliability_update(rel, sel, ok,
                                 jf.FaultConfig(reliability_ema=beta))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-7)
    pri = rng.random(K).astype(np.float32)
    np.testing.assert_allclose(
        tsch.reliability_discount(_t(pri), got, tsch.SchedulerConfig(
            reliability_weight=weight)).numpy(),
        np.asarray(jsch.reliability_discount(pri, want, jsch.SchedulerConfig(
            reliability_weight=weight))), rtol=1e-6)


@pytest.mark.parametrize("mult", [1.0, 1.37])
@pytest.mark.parametrize("per_device", [False, True])
def test_effective_payload_bits_matches_reference(mult, per_device):
    gains = np.ones((K,), np.float32)
    bits = np.linspace(1e3, 9e4, K).astype(np.float32) if per_device \
        else None
    want = jbw.effective_payload_bits(bits, mult, WCFG_J, gains)
    got = tbw.effective_payload_bits(None if bits is None else _t(bits),
                                     mult, WCFG_T, _t(gains))
    if want is None:
        assert got is None
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_upload_time_and_energy_with_airtime_mult_match_reference():
    net, gains, tnet = _world(4)
    alpha = np.full((K,), 1.0 / K, np.float32)
    alpha[0] = 0.0
    mult = np.arange(K, dtype=np.float32) % 3
    for fn_j, fn_t in ((jw.upload_time, tw.upload_time),
                       (jw.upload_energy, tw.upload_energy)):
        want = fn_j(alpha, gains, net.tx_power, WCFG_J, airtime_mult=mult)
        got = fn_t(_t(alpha), _t(gains), tnet.tx_power, WCFG_T,
                   airtime_mult=_t(mult))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    assert float(got[0]) == 0.0          # no attempt: zero airtime


def test_inert_configs_normalise_to_none():
    assert tf.active(tf.FaultConfig()) is None
    assert tf.active(None) is None
    for kw in ({"drop_prob": 0.1}, {"reliability_ema": 0.1},
               {"overprovision": 1}, {"deep_fade_threshold": 0.1}):
        assert tf.active(tf.FaultConfig(**kw)) is not None
        assert jf.is_inert(jf.FaultConfig(**kw)) == \
            tf.is_inert(tf.FaultConfig(**kw))
    assert tf.attempt_budget(tf.FaultConfig(max_retries=-2)) == 1


def _stacked(k=5, seed=0):
    rng = np.random.default_rng(seed)
    params = {"w": rng.standard_normal((3, 4)).astype(np.float32),
              "b": rng.standard_normal((4,)).astype(np.float32)}
    client = {n: (a[None] + 0.1 * rng.standard_normal((k,) + a.shape)
                  ).astype(np.float32) for n, a in params.items()}
    mask = (np.arange(k) % 2).astype(np.float32)
    w = rng.random(k).astype(np.float32) * mask
    return params, client, w / w.sum(), mask


@pytest.mark.parametrize("use_kernel", [False, True])
def test_fedavg_aggregate_masked_matches_reference(use_kernel):
    """Update form g + sum_k w_k m_k (w^k - g); K-term sums in another
    order than XLA's."""
    params, client, w, mask = _stacked()
    want = jfed.fedavg_aggregate_masked(params, client, jnp.asarray(w),
                                        jnp.asarray(mask), use_kernel)
    got = tfed.fedavg_aggregate_masked(
        {n: _t(a) for n, a in params.items()},
        {n: _t(a) for n, a in client.items()}, _t(w), _t(mask), use_kernel)
    for n in params:
        np.testing.assert_allclose(got[n].numpy(), np.asarray(want[n]),
                                   rtol=1e-6, atol=1e-6)
    none = tfed.fedavg_aggregate_masked(
        {n: _t(a) for n, a in params.items()},
        {n: _t(a) for n, a in client.items()}, _t(w), torch.zeros(5),
        use_kernel)
    for n in params:                         # every upload failed
        assert torch.equal(none[n], _t(params[n]))


def test_all_ones_mask_is_the_unmasked_aggregate():
    """The masked reduction with an all-ones mask is the unmasked one
    bit for bit (w * 1.0 == w); the update-form aggregate equals the
    direct FedAvg to f32 rounding (the weights sum to one)."""
    rng = np.random.default_rng(2)
    u = _t(rng.standard_normal((9, 1000)).astype(np.float32))
    w = _t(rng.random(9).astype(np.float32))
    ones = torch.ones(9)
    assert torch.equal(tagg.fedavg_agg_masked(u, w, ones),
                       tagg.fedavg_agg(u, w))
    np.testing.assert_allclose(
        tagg.fedavg_agg_masked(u, w, ones).numpy(),
        np.asarray(jops.fedavg_agg_masked(u.numpy(), w.numpy(),
                                          ones.numpy())), rtol=1e-5,
        atol=1e-5)
    np.testing.assert_allclose(
        tagg.fedavg_agg_masked_plain(u, w, ones).numpy(),
        np.asarray(jref.fedavg_agg_masked(u.numpy(), w.numpy(),
                                          ones.numpy())), rtol=1e-5,
        atol=1e-5)
    params, client, wt, _ = _stacked(seed=3)
    full = np.ones(5, np.float32)
    wt = np.full(5, 0.2, np.float32)
    masked = tfed.fedavg_aggregate_masked(
        {n: _t(a) for n, a in params.items()},
        {n: _t(a) for n, a in client.items()}, _t(wt), _t(full), True)
    direct = tfed.fedavg_aggregate({n: _t(a) for n, a in client.items()},
                                   _t(wt), True)
    for n in params:
        np.testing.assert_allclose(masked[n].numpy(), direct[n].numpy(),
                                   rtol=0, atol=1e-6)


FAULTS = dict(drop_prob=0.3, max_retries=2, straggler_prob=0.05,
              reliability_ema=0.2, chronic_spread=0.5, overprovision=2)


def test_driver_with_faults_matches_reference():
    """``FLConfig.faults`` (chronic outages, retries, stragglers, the
    reliability EMA, overprovisioning, reliability weight 0.5) on the
    MLP: equal selections, iterations and delivered counts; the
    realized E and T as slice 1 holds them; params atol 1e-4."""
    jp, jm, tp, recs = run_pair(
        "mlp", K, 0, 0.1, jsub=dict(faults=jf.FaultConfig(**FAULTS)),
        tsub=dict(faults=tf.FaultConfig(**FAULTS)),
        sched_extra=dict(reliability_weight=0.5))
    assert any(r.n_success < r.n_selected for r in recs)
    assert_runs_agree(jm, recs, jp, tp, atol=1e-4)


def test_inert_fault_config_runs_as_no_faults():
    """An all-default FaultConfig is the reliable edge: the same run as
    ``faults=None``, bit for bit, from the same seed."""
    data, net = _tiny_world()
    model = tnets.init(tnets.PaperNetSpec(kind="mlp"),
                       torch.Generator().manual_seed(1))
    run = functools.partial(
        tfed.run_federated, model=model, data=data, net=net,
        wcfg=WCFG_T, scfg=tsch.SchedulerConfig(
            allocator="waterfilling", iterations_max=3,
            reliability_weight=0.5), seed=3, device="cpu")
    p0, r0 = run(fcfg=tfed.FLConfig(num_rounds=2, learning_rate=0.1))
    p1, r1 = run(fcfg=tfed.FLConfig(num_rounds=2, learning_rate=0.1,
                                    faults=tf.FaultConfig()))
    for n in p0:
        assert torch.equal(p0[n], p1[n])
    for a, b in zip(r0, r1):
        assert (a.selected == b.selected).all()
        assert a.energy_total == b.energy_total
        assert a.n_success == b.n_success == a.n_selected


def test_masked_fedavg_kernel_on_card():
    """The CUDA kernel against its plain version; with an all-ones mask,
    bit for bit the unmasked kernel (needs a CUDA device)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA kernels have no CPU mode)")
    rng = np.random.default_rng(4)
    dev = torch.device("cuda")
    for p in (21840, 159010, 1001):
        u = _t(rng.standard_normal((100, p)).astype(np.float32)).to(dev)
        w = torch.softmax(_t(rng.standard_normal(100).astype(np.float32)),
                          0).to(dev)
        m = _t((rng.random(100) > 0.2).astype(np.float32)).to(dev)
        before = tagg.fedavg_agg_masked.launches
        got = tagg.fedavg_agg_masked(u, w, m)
        torch.cuda.synchronize()
        assert tagg.fedavg_agg_masked.launches == before + 1
        torch.testing.assert_close(
            got.cpu(), tagg.fedavg_agg_masked_plain(u.cpu(), w.cpu(),
                                                    m.cpu()),
            rtol=1e-5, atol=1e-5)
        assert torch.equal(tagg.fedavg_agg_masked(u, w, torch.ones_like(m)),
                           tagg.fedavg_agg(u, w))

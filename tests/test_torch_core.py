"""The port's core modules against the JAX reference, on the CPU.

Wireless, data and diversity of ``repro_torch`` run on the same
numpy-seeded inputs as their ``repro`` counterparts; each tolerance is
stated with its reason.  Also: the port imports no JAX, and its
redefined config classes carry the reference's field names and
defaults.  Sub2, Sub1 and the scheduling policies are in
``test_torch_scheduling.py``.
"""

import dataclasses
import functools
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import bandwidth as jbw  # noqa: E402
from repro.core import compression as jcomp  # noqa: E402
from repro.core import diversity as jdiv  # noqa: E402
from repro.core import faults as jfaults  # noqa: E402
from repro.core import federated as jfed  # noqa: E402
from repro.core import scheduler as jsch  # noqa: E402
from repro.core import selection as jsel  # noqa: E402
from repro.core import streaming as jstream  # noqa: E402
from repro.core import wireless as jw  # noqa: E402
from repro.data import partition as jpart  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.models import paper_nets as jnets  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import bandwidth as tbw  # noqa: E402
from repro_torch.core import compression as tcomp  # noqa: E402
from repro_torch.core import diversity as tdiv  # noqa: E402
from repro_torch.core import faults as tfaults  # noqa: E402
from repro_torch.core import federated as tfed  # noqa: E402
from repro_torch.core import scheduler as tsch  # noqa: E402
from repro_torch.core import selection as tsel  # noqa: E402
from repro_torch.core import streaming as tstream  # noqa: E402
from repro_torch.core import wireless as tw  # noqa: E402
from repro_torch.data import partition as tpart  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.kernels import diversity as tdivk  # noqa: E402
from repro_torch.models import paper_nets as tnets  # noqa: E402

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


# ---------------------------------------------------------------------------
# Imports and configs
# ---------------------------------------------------------------------------

def test_port_imports_no_jax_and_no_reference():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import repro_torch
        for mod in pkgutil.walk_packages(repro_torch.__path__,
                                         "repro_torch."):
            importlib.import_module(mod.name)
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith(("jax.", "jaxlib"))
                     or m == "repro" or m.startswith("repro."))
        assert not bad, bad
        print(len([m for m in sys.modules if m.startswith("repro_torch")]))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15


def _defaults(cls):
    out = {}
    for f in dataclasses.fields(cls):
        d = f.default
        out[f.name] = dataclasses.asdict(d) if dataclasses.is_dataclass(d) \
            else d
    return out


PORT_DROPS = {jstream.StreamConfig: ("use_kernel",),
              jcomp.CompressionConfig: ("use_kernel",)}


@pytest.mark.parametrize("ref,port", [
    (jfed.FLConfig, tfed.FLConfig),
    (jsch.SchedulerConfig, tsch.SchedulerConfig),
    (jsel.Sub1Params, tsel.Sub1Params),
    (jbw.Sub2Params, tbw.Sub2Params),
    (jw.WirelessConfig, tw.WirelessConfig),
    (jdiv.IndexWeights, tdiv.IndexWeights),
    (jnets.PaperNetSpec, tnets.PaperNetSpec),
    (jpart.PartitionSpec, tpart.PartitionSpec),
    (jsyn.SyntheticSpec, tsyn.SyntheticSpec),
    (jstream.StreamConfig, tstream.StreamConfig),
    (jcomp.CompressionConfig, tcomp.CompressionConfig),
    (jfaults.FaultConfig, tfaults.FaultConfig),
])
def test_config_fields_and_defaults_match_reference(ref, port):
    """The port's configs carry the reference's fields and defaults, but
    for the ``use_kernel`` switches its kernel wrappers make redundant
    (they pick by the tensor's device)."""
    dropped = PORT_DROPS.get(ref, ())
    assert [f.name for f in dataclasses.fields(port)] == \
        [f.name for f in dataclasses.fields(ref) if f.name not in dropped]
    want = {n: d for n, d in _defaults(ref).items() if n not in dropped}
    assert _defaults(port) == want


@pytest.mark.parametrize("preset", ["fast", "reference"])
def test_sub2_presets_match_reference(preset):
    assert dataclasses.asdict(getattr(tbw.Sub2Params, preset)(0.3)) == \
        dataclasses.asdict(getattr(jbw.Sub2Params, preset)(0.3))


# ---------------------------------------------------------------------------
# Wireless
# ---------------------------------------------------------------------------

def test_wireless_models_match_reference_on_same_draws():
    """Same network and fading draws: Eq. 6-10 agree to float rounding
    (log2 in another implementation)."""
    k = 24
    jnet, gains, sizes, tnet, tg, ts = _world(0, k)
    alpha = np.random.default_rng(0).random(k).astype(np.float32)
    alpha[[2, 5]] = 0.0
    alpha /= alpha.sum()
    sel = (alpha > 0).astype(np.float32)
    ta = _t(alpha)
    pairs = [
        (jw.achievable_rate(alpha, gains, jnet.tx_power, JW),
         tw.achievable_rate(ta, tg, tnet.tx_power, TW)),
        (jw.upload_time(alpha, gains, jnet.tx_power, JW),
         tw.upload_time(ta, tg, tnet.tx_power, TW)),
        (jw.upload_energy(alpha, gains, jnet.tx_power, JW, 5e4),
         tw.upload_energy(ta, tg, tnet.tx_power, TW, 5e4)),
        (jw.train_time(sizes, jnet, JW, 2), tw.train_time(ts, tnet, TW, 2)),
    ]
    for want, got in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=2e-6)
    t_up = np.where(sel > 0, np.asarray(pairs[1][0]), 0.0)
    np.testing.assert_allclose(
        float(tw.round_time(_t(sel), pairs[3][1], _t(t_up, np.float32))),
        float(jw.round_time(sel, pairs[3][0], t_up)), rtol=2e-6)
    assert np.isinf(pairs[1][1].numpy()[[2, 5]]).all()


def test_sample_network_and_fading_follow_table_one():
    cfg = TW
    gen = torch.Generator().manual_seed(0)
    net = tw.sample_network(gen, 4000, cfg)
    lo, hi = cfg.tx_power_range
    assert float(net.tx_power.min()) >= lo and float(net.tx_power.max()) <= hi
    assert float(net.cpu_freq.min()) >= cfg.cpu_freq_range[0]
    assert float(net.distance_m.max()) <= cfg.cell_side_m / 2 * 2 ** 0.5
    np.testing.assert_allclose(net.pathloss.numpy(),
                               net.distance_m.numpy() ** -3.0, rtol=1e-5)
    h2 = tw.sample_fading(gen, net) / net.pathloss
    assert abs(float(h2.mean()) - 1.0) < 0.08      # Exp(1) mean, n = 4000


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------

def test_synthetic_generate_is_bitwise_the_reference():
    for seed in (0, 5):
        ji, jl = jsyn.generate(seed, samples_per_class=40)
        ti, tl = tsyn.generate(seed, samples_per_class=40)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tl, jl)
    for a, b in zip(tsyn.make_prototypes(3, tsyn.SyntheticSpec()),
                    jsyn.make_prototypes(3, jsyn.SyntheticSpec())):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("k,shards,seed", [(12, 100, 1), (100, 1200, 3)])
def test_partition_is_bitwise_the_reference(k, shards, seed):
    imgs, labels = jsyn.generate(0, samples_per_class=shards * 5)
    jd = jpart.partition(imgs, labels, seed=seed, spec=jpart.PartitionSpec(
        num_devices=k, num_shards=shards, shard_size=50))
    td = tpart.partition(imgs, labels, seed=seed, spec=tpart.PartitionSpec(
        num_devices=k, num_shards=shards, shard_size=50))
    for f in ("images", "labels", "mask", "sizes", "test_images",
              "test_labels"):
        got = getattr(td, f)
        want = np.array(getattr(jd, f))
        assert got.dtype == torch.from_numpy(want).dtype, f
        np.testing.assert_array_equal(got.numpy(), want)
    assert td.capacity == jd.capacity and td.num_devices == k
    np.testing.assert_array_equal(
        tfed.client_histograms(td, 10).numpy(),
        np.asarray(jfed.client_histograms(jd, 10)))


def test_draw_shard_counts_is_the_reference():
    spec = jpart.PartitionSpec()
    np.testing.assert_array_equal(
        tpart.draw_shard_counts(np.random.default_rng(9),
                                tpart.PartitionSpec()),
        jpart.draw_shard_counts(np.random.default_rng(9), spec))


# ---------------------------------------------------------------------------
# Diversity
# ---------------------------------------------------------------------------

def _hist_inputs(k=20, n=300, c=10, seed=0):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, c, (k, n)).astype(np.int32)
    # Non-IID rows: some devices hold one or two classes only.
    labels[:5] = labels[:5] % 2
    labels[5] = 3
    mask = (rng.random((k, n)) > 0.4).astype(np.float32)
    ages = rng.integers(0, 6, k).astype(np.int32)
    return labels, mask, ages


@pytest.mark.parametrize("measure", ["gini_simpson", "shannon"])
def test_diversity_index_matches_reference(measure):
    """Eq. 4 from histograms, and from the kernel's per-device stats
    (the port's per-round form): reductions in another order."""
    labels, mask, ages = _hist_inputs()
    sizes = mask.sum(axis=1).astype(np.int32)
    jh = jax.vmap(lambda lab, m: jdiv.label_histogram(lab, m, 10))(labels,
                                                                    mask)
    want = jdiv.diversity_index(label_hists=jh, data_sizes=sizes, ages=ages,
                                measure=measure)
    th = tdiv.label_histogram(_t(labels), _t(mask), 10)
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    got = tdiv.diversity_index(label_hists=th, data_sizes=_t(sizes),
                               ages=_t(ages), measure=measure)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)
    stats = tdivk.diversity_stats(_t(labels), _t(mask), 10)
    got2 = tdiv.diversity_index_from_stats(
        div=stats[:, tdiv.measure_column(measure)], data_sizes=_t(sizes),
        ages=_t(ages))
    np.testing.assert_allclose(got2.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)


def test_diversity_measures_match_reference():
    labels, mask, _ = _hist_inputs(seed=4)
    th = tdiv.label_histogram(_t(labels), _t(mask), 10)
    probs = tdiv.class_probs(th)
    jp = jdiv.class_probs(th.numpy())
    np.testing.assert_allclose(probs.numpy(), np.asarray(jp), rtol=1e-7)
    np.testing.assert_allclose(tdiv.gini_simpson(probs).numpy(),
                               np.asarray(jdiv.gini_simpson(jp)), atol=1e-6)
    np.testing.assert_allclose(tdiv.shannon_entropy(probs).numpy(),
                               np.asarray(jdiv.shannon_entropy(jp)),
                               atol=1e-6)
    assert float(tdiv.shannon_entropy(probs)[5]) == 0.0   # 0 log 0 := 0
    z = torch.zeros(4)
    assert torch.equal(tdiv.normalize_metric(z), z)
    with pytest.raises(ValueError):
        tdiv.measure_column("simpson")

"""The port's kernels: plain versions against the JAX reference, wrappers.

Each kernel module of ``repro_torch.kernels`` holds a CUDA wrapper and a
plain PyTorch version.  On the CPU the wrapper computes the plain
version; these tests hold that plain version against both the JAX
package's oracle (``repro.kernels.ref``) and its Pallas kernel in
interpret mode (``repro.kernels.ops``), on the same numpy-seeded inputs.
The CUDA launches are checked by the tests marked by the ``cuda_device``
fixture, which skip without a card (run them on one with
``python -m pytest -q tests/test_torch_kernels.py``).
"""

import re

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import bandwidth as jbw  # noqa: E402
from repro.core import wireless as jw  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core import bandwidth as tbw  # noqa: E402
from repro_torch.core import wireless as tw  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import diversity as tdiv  # noqa: E402
from repro_torch.kernels import fedavg_agg as tagg  # noqa: E402
from repro_torch.kernels import sub2_pgd as tpgd  # noqa: E402

WCFG = jw.WirelessConfig()


@pytest.fixture
def cuda_device():
    """The CUDA card, or a skip: these tests launch the CUDA kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA kernels have no CPU mode)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# fedavg_agg
# ---------------------------------------------------------------------------

def _fedavg_inputs(k, p, seed):
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((k, p)).astype(np.float32)
    w = rng.random(k).astype(np.float32)
    return u, w / w.sum()


@pytest.mark.parametrize("k,p", [(1, 128), (3, 1000), (17, 4096),
                                 (64, 21840)])
def test_fedavg_plain_matches_reference(k, p):
    """f32 sums of K products in another order than XLA's: a few ulps
    of the O(1) result (the reference's own kernel test uses 1e-5)."""
    u, w = _fedavg_inputs(k, p, k * 1000 + p)
    got = tagg.fedavg_agg(torch.from_numpy(u), torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(got, np.asarray(jref.fedavg_agg(u, w)),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(jops.fedavg_agg(u, w)),
                               rtol=1e-5, atol=1e-5)


def test_fedavg_cpu_wrapper_takes_plain_version():
    u, w = _fedavg_inputs(5, 300, 1)
    before = tagg.fedavg_agg.launches
    got = tagg.fedavg_agg(torch.from_numpy(u), torch.from_numpy(w))
    want = tagg.fedavg_agg_plain(torch.from_numpy(u), torch.from_numpy(w))
    assert tagg.fedavg_agg.launches == before
    assert torch.equal(got, want)


@pytest.mark.parametrize("k,p", [(100, 21840), (100, 159010), (7, 1001)])
def test_fedavg_kernel_on_card(cuda_device, k, p):
    u, w = _fedavg_inputs(k, p, 3)
    u_t, w_t = (torch.from_numpy(x).to(cuda_device) for x in (u, w))
    before = tagg.fedavg_agg.launches
    got = tagg.fedavg_agg(u_t, w_t)
    torch.cuda.synchronize()
    assert tagg.fedavg_agg.launches == before + 1
    torch.testing.assert_close(got.cpu(), tagg.fedavg_agg_plain(
        torch.from_numpy(u), torch.from_numpy(w)), rtol=1e-5, atol=1e-5)


def test_fedavg_kernel_rejects_bad_operands(cuda_device):
    u = torch.zeros((4, 10), device=cuda_device, dtype=torch.float64)
    w = torch.zeros((4,), device=cuda_device)
    with pytest.raises(TypeError):
        tagg.fedavg_agg(u, w)
    with pytest.raises(ValueError):
        tagg.fedavg_agg(torch.zeros((4, 10), device=cuda_device).t(),
                        torch.zeros((10,), device=cuda_device))


# ---------------------------------------------------------------------------
# diversity
# ---------------------------------------------------------------------------

def _div_inputs(k, n, c, seed):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, c, (k, n)).astype(np.int32)
    mask = (rng.random((k, n)) > 0.3).astype(np.float32)
    return labels, mask


@pytest.mark.parametrize("k,n,c", [(1, 64, 10), (7, 300, 10), (16, 128, 3),
                                   (5, 1024, 32), (100, 900, 10)])
def test_diversity_plain_matches_reference(k, n, c):
    """Counts are exact integers; gini/shannon are sums over C classes
    in another order (the reference's kernel test uses 1e-5)."""
    labels, mask = _div_inputs(k, n, c, k + n)
    got = tdiv.diversity_stats(torch.from_numpy(labels),
                               torch.from_numpy(mask), c).numpy()
    np.testing.assert_allclose(got, np.asarray(jref.diversity(labels, mask,
                                                              c)),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        got, np.asarray(jops.diversity_stats(labels, mask, c)),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got[:, 2], mask.sum(axis=1))


def test_diversity_ignores_out_of_range_labels():
    labels = torch.tensor([[0, 1, 5, -1]], dtype=torch.int32)
    mask = torch.ones((1, 4))
    got = tdiv.diversity_stats(labels, mask, 2)
    np.testing.assert_allclose(got.numpy(), [[0.5, 1.0, 2.0]], atol=1e-7)


@pytest.mark.parametrize("k,n,c", [(100, 900, 10), (3, 77, 64)])
def test_diversity_kernel_on_card(cuda_device, k, n, c):
    labels, mask = _div_inputs(k, n, c, 5)
    before = tdiv.diversity_stats.launches
    got = tdiv.diversity_stats(torch.from_numpy(labels).to(cuda_device),
                               torch.from_numpy(mask).to(cuda_device), c)
    torch.cuda.synchronize()
    assert tdiv.diversity_stats.launches == before + 1
    torch.testing.assert_close(got.cpu(), tdiv.diversity_stats_plain(
        torch.from_numpy(labels), torch.from_numpy(mask), c),
        rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# sub2_pgd
# ---------------------------------------------------------------------------

_PGD_KW = dict(rho=0.5, lr=0.05, tau=1e-3, iters=60,
               bandwidth_hz=WCFG.bandwidth_hz, min_alpha=WCFG.min_alpha)


def _pgd_instance(seed, k):
    """A Table-I instance as numpy: (sel, t_train, c, power, starts)."""
    net = jw.sample_network(jax.random.key(seed), k, WCFG)
    gains = jw.sample_fading(jax.random.key(seed + 1), net)
    sizes = jax.random.randint(jax.random.key(seed + 2), (k,), 50, 600)
    t_train = jw.train_time(sizes, net, WCFG)
    sel = (jax.random.uniform(jax.random.key(seed + 3), (k,)) > 0.4
           ).astype(jnp.float32).at[0].set(1.0)
    wf, _ = jbw.min_time_allocation(sel, t_train, gains, net.tx_power, WCFG)
    starts = jnp.stack([wf, sel / jnp.sum(sel)])
    c = gains * net.tx_power / (WCFG.bandwidth_hz * WCFG.noise_psd)
    return tuple(np.array(x, np.float32)
                 for x in (sel, t_train, c, net.tx_power, starts, gains))


@pytest.mark.parametrize("k,seed", [(2, 0), (24, 2), (48, 3)])
def test_sub2_plain_matches_reference(k, seed):
    """Against the autodiff oracle and the Pallas kernel (interpret).

    The descent takes normalised steps, which amplify last-bit
    differences along the objective's flat valley: tight on the
    objective, loose on alpha — the reference's own tolerance between
    its kernel and oracle (tests/test_allocator.py)."""
    sel, tt, c, pw, starts, gains = _pgd_instance(seed, k)
    bits = np.full((k,), WCFG.model_bits, np.float32)
    rows = [torch.from_numpy(x)[None] for x in (sel, tt, c, pw, bits)]
    a, o = tpgd.sub2_pgd(*rows, torch.from_numpy(starts)[None], **_PGD_KW)
    a_ref, o_ref = jref.sub2_pgd(sel, tt, c, pw, starts,
                                 model_bits=WCFG.model_bits, **_PGD_KW)
    a_krn, o_krn = jops.sub2_pgd(sel, tt, gains, pw, starts,
                                 noise_psd=WCFG.noise_psd,
                                 model_bits=WCFG.model_bits, **_PGD_KW)
    for a_j, o_j in ((a_ref, o_ref), (a_krn, o_krn)):
        np.testing.assert_allclose(a[0].numpy(), np.asarray(a_j), atol=1e-2)
        assert float(o[0]) == pytest.approx(float(o_j), rel=1e-3)
    assert float(a.sum()) == pytest.approx(1.0, abs=1e-5)
    assert float(a[0][sel == 0].abs().sum()) == 0.0


def test_sub2_plain_batched_rows_equal_single_rows():
    k = 12
    inst = [_pgd_instance(10 + i, k) for i in range(3)]
    bits = np.full((k,), WCFG.model_bits, np.float32)
    batch = [torch.from_numpy(np.stack([x[j] for x in inst]))
             for j in range(4)]
    starts = torch.from_numpy(np.stack([x[4] for x in inst]))
    bits_b = torch.from_numpy(np.stack([bits] * 3))
    a_b, o_b = tpgd.sub2_pgd(*batch, bits_b, starts, **_PGD_KW)
    for i in range(3):
        a_i, o_i = tpgd.sub2_pgd(*(t[i:i + 1] for t in batch),
                                 bits_b[i:i + 1], starts[i:i + 1],
                                 **_PGD_KW)
        torch.testing.assert_close(a_b[i], a_i[0], rtol=0, atol=1e-7)
        torch.testing.assert_close(o_b[i], o_i[0], rtol=1e-6, atol=0)


def test_sub2_empty_selection_gives_zeros():
    k = 8
    z = torch.zeros((1, k))
    a, o = tpgd.sub2_pgd(z, torch.ones((1, k)), torch.ones((1, k)),
                         torch.ones((1, k)), torch.ones((1, k)),
                         torch.zeros((1, 2, k)), **_PGD_KW)
    assert torch.equal(a, torch.zeros((1, k)))
    assert float(o[0]) == 0.0


def test_sub2_solve_entry_matches_ops_entry():
    """The single-instance entry folds gains into c like ``ops.sub2_pgd``
    (same tolerance reasoning as the reference test above)."""
    sel, tt, c, pw, starts, gains = _pgd_instance(7, 16)
    kw = dict(_PGD_KW, noise_psd=WCFG.noise_psd, model_bits=WCFG.model_bits)
    a, o = tpgd.sub2_pgd_solve(*(torch.from_numpy(x) for x in
                                 (sel, tt, gains, pw, starts)), **kw)
    a_j, o_j = jops.sub2_pgd(sel, tt, gains, pw, starts, **kw)
    np.testing.assert_allclose(a.numpy(), np.asarray(a_j), atol=1e-2)
    assert float(o) == pytest.approx(float(o_j), rel=1e-3)


@pytest.mark.parametrize("s", [1, 16])
def test_sub2_kernel_on_card(cuda_device, s):
    k = 100
    inst = [_pgd_instance(40 + i, k) for i in range(s)]
    bits = np.full((s, k), WCFG.model_bits, np.float32)
    args = [torch.from_numpy(np.stack([x[j] for x in inst]))
            for j in range(4)] + [torch.from_numpy(bits),
                                  torch.from_numpy(np.stack([x[4]
                                                             for x in inst]))]
    kw = dict(_PGD_KW, iters=400)
    before = tpgd.sub2_pgd.launches
    a, o = tpgd.sub2_pgd(*(t.to(cuda_device) for t in args), **kw)
    torch.cuda.synchronize()
    assert tpgd.sub2_pgd.launches == before + 1
    a_p, o_p = tpgd.sub2_pgd_plain(*args, **kw)
    torch.testing.assert_close(a.cpu(), a_p, rtol=0, atol=1e-2)
    torch.testing.assert_close(o.cpu(), o_p, rtol=1e-3, atol=0)


def test_min_time_start_is_the_reference_water_filling():
    """The port's water-filling start feeds the same descent: it matches
    the reference's fused joint bisection (Newton and log1p in another
    implementation: a few ulps)."""
    sel, tt, c, pw, starts, gains = _pgd_instance(3, 20)
    wf, t_star = tbw.min_time_allocation(
        torch.from_numpy(sel), torch.from_numpy(tt), torch.from_numpy(gains),
        torch.from_numpy(pw), tw.WirelessConfig())
    np.testing.assert_allclose(wf.numpy(), starts[0], rtol=1e-4, atol=1e-6)


# ---------------------------------------------------------------------------
# Build and binding
# ---------------------------------------------------------------------------

def test_ctypes_signatures_match_the_c_entries():
    """Every C entry of csrc/ is bound, with one ctypes type per C
    parameter (a missing one would pass garbage on the card)."""
    entries = {}
    for src in _build._sources():
        for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)',
                                       src.read_text()):
            entries[name] = len(params.split(","))
    assert entries == {name: len(types)
                       for name, types in _build.SIGNATURES.items()}


def test_build_fails_loudly_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "DEFAULT_NVCC", str(tmp_path / "nvcc"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    _build.check(0, "ok")
    with pytest.raises(RuntimeError, match="cudaError 9"):
        _build.check(9, "sub2_pgd")

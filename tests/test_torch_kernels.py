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

import math
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
def one_thread():
    """Small tensors: one intra-op thread, so the test workers that share
    the machine do not oversubscribe its cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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


@pytest.mark.parametrize("p,address,want", [
    (21840, 0, "vec4"), (21840, 256, "vec4"), (64, 4096, "vec4"),
    (159010, 0, "vec2"), (21840, 8, "vec2"), (21840, 24, "vec2"),
    (6, 16, "vec2"), (1001, 0, "scalar"), (21840, 4, "scalar"),
    (21840, 12, "scalar"), (159010, 4, "scalar"), (1, 16, "scalar")])
def test_fedavg_route_by_width_and_alignment(p, address, want):
    """The widest load every row allows: P a multiple of the width and the
    matrix's first row aligned to it (then every row is, at any K)."""
    assert tagg.route(p, address) == want
    vec = tagg.ROUTE_VEC[want]
    assert p % vec == 0 and address % (4 * vec) == 0
    wider = [v for v in tagg.ROUTE_VEC.values() if v > vec]
    assert all(p % v or address % (4 * v) for v in wider)


@pytest.mark.parametrize("k,p", [(100, 21840), (100, 159010), (7, 1001),
                                 (4096, 64)])
def test_fedavg_kernel_on_card(cuda_device, k, p):
    """Each entry point after every SM's shared memory is filled with NaN:
    within 1e-5 of its plain version, the same bits on a second launch,
    and the all-ones identities (mask: fedavg_agg; staleness: the masked
    form) bit for bit, all through the route of (P, address)."""
    from repro_torch.kernels import _check
    u, w = _fedavg_inputs(k, p, 3)
    rng = np.random.default_rng(k + p)
    m = (rng.random(k) < 0.7).astype(np.float32)
    st = rng.random(k).astype(np.float32)
    u_t, w_t, m_t, s_t = (torch.from_numpy(x).to(cuda_device)
                          for x in (u, w, m, st))
    ones = torch.ones_like(w_t)
    runs = {
        "plain": (tagg.fedavg_agg, (u_t, w_t)),
        "masked": (tagg.fedavg_agg_masked, (u_t, w_t, m_t)),
        "stale": (tagg.fedavg_agg_stale, (u_t, w_t, m_t, s_t)),
        "mask ones": (tagg.fedavg_agg_masked, (u_t, w_t, ones)),
        "stale ones": (tagg.fedavg_agg_stale, (u_t, w_t, m_t, ones)),
    }
    which = tagg.route(p, u_t.data_ptr())
    got = {}
    for name, (fn, args) in runs.items():
        before = (fn.launches, fn.route_launches[which])
        outs = []
        for _ in range(2):
            _check.fill_shared_memory(cuda_device)
            outs.append(fn(*args))
        torch.cuda.synchronize()
        assert (fn.launches, fn.route_launches[which]) == (
            before[0] + 2, before[1] + 2)
        assert torch.equal(outs[0], outs[1]), name
        got[name] = outs[0].cpu()
    cpu = [torch.from_numpy(x) for x in (u, w, m, st)]
    for name, want in (("plain", tagg.fedavg_agg_plain(*cpu[:2])),
                       ("masked", tagg.fedavg_agg_masked_plain(*cpu[:3])),
                       ("stale", tagg.fedavg_agg_stale_plain(*cpu))):
        torch.testing.assert_close(got[name], want, rtol=1e-5, atol=1e-5)
    assert torch.equal(got["mask ones"], got["plain"])
    assert torch.equal(got["stale ones"], got["masked"])


@pytest.mark.parametrize("offset,want", [(1, "scalar"), (2, "vec2"),
                                         (4, "vec4")])
def test_fedavg_kernel_takes_views_on_card(cuda_device, offset, want):
    """A matrix that starts ``offset`` floats into its buffer takes the
    load its address allows, and agrees with the aligned launch bit for
    bit (the reduction's order does not depend on the width)."""
    k, p = 9, 4096
    u, w = _fedavg_inputs(k, p, 5)
    buf = torch.zeros((k * p + 4,), device=cuda_device)
    buf[offset:offset + k * p] = torch.from_numpy(u.reshape(-1)).to(
        cuda_device)
    view = buf[offset:offset + k * p].view(k, p)
    w_t = torch.from_numpy(w).to(cuda_device)
    assert tagg.route(p, view.data_ptr()) == want
    aligned = tagg.fedavg_agg(torch.from_numpy(u).to(cuda_device), w_t)
    assert torch.equal(tagg.fedavg_agg(view, w_t), aligned)


def test_fedavg_kernel_refuses_k_over_its_shared_weights(cuda_device):
    u = torch.zeros((4097, 8), device=cuda_device)
    with pytest.raises(RuntimeError, match="failed to launch"):
        tagg.fedavg_agg(u, torch.zeros((4097,), device=cuda_device))


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


@pytest.mark.parametrize("n,addresses,want", [
    (900, (0, 0), "vec4"), (900, (256, 4096), "vec4"), (4, (16, 48), "vec4"),
    (900, (4, 0), "scalar"), (900, (0, 8), "scalar"), (901, (0, 0), "scalar"),
    (902, (0, 0), "scalar"), (1, (0, 0), "scalar")])
def test_diversity_route_by_width_and_alignment(n, addresses, want):
    """16-byte loads where N is a multiple of 4 and both operands' first
    rows are 16-byte aligned (then every row is); else scalar loads."""
    assert tdiv.route(n, *addresses) == want


def _refuse_library():
    raise AssertionError("the wrapper reached the kernel library")


def test_diversity_rejects_before_any_launch(monkeypatch):
    """C > 64, wrong dtypes, a wrong shape and a non-contiguous operand
    raise before the library is loaded or a launch counted (meta tensors
    take the kernel's path without a card)."""
    monkeypatch.setattr(_build, "library", _refuse_library)
    meta = torch.device("meta")
    lab = torch.zeros((4, 8), dtype=torch.int32, device=meta)
    mask = torch.zeros((4, 8), device=meta)
    before = (tdiv.diversity_stats.launches,
              dict(tdiv.diversity_stats.route_launches))
    cases = [
        (ValueError, "num_classes", (lab, mask, 65)),
        (ValueError, "num_classes", (lab, mask, 0)),
        (TypeError, "labels must be torch.int32", (lab.long(), mask, 10)),
        (TypeError, "mask must be torch.float32", (lab, mask.double(), 10)),
        (ValueError, "mask must have shape",
         (lab, torch.zeros((4, 9), device=meta), 10)),
        (ValueError, "labels must be contiguous",
         (torch.zeros((8, 4), dtype=torch.int32, device=meta).t(), mask,
          10)),
    ]
    for err, match, args in cases:
        with pytest.raises(err, match=match):
            tdiv.diversity_stats(*args)
    assert (tdiv.diversity_stats.launches,
            tdiv.diversity_stats.route_launches) == before


def _sorted_rows(k, n, classes_per_row, c, seed):
    """Label-sorted rows as the paper's shards make them: each row holds
    ``classes_per_row`` classes in runs, a {0, 1} mask with a padded
    tail."""
    rng = np.random.default_rng(seed)
    labels = np.zeros((k, n), np.int32)
    mask = np.zeros((k, n), np.float32)
    for r in range(k):
        cls = np.sort(rng.choice(c, classes_per_row, replace=False))
        size = int(rng.integers(n // 2, n + 1))
        labels[r, :size] = np.sort(rng.choice(cls, size))
        mask[r, :size] = 1.0
    return labels, mask


def _diversity_case(case):
    """(labels, mask, C, labels' offset into its buffer) of a card case."""
    rng = np.random.default_rng(len(case))
    if case == "one class":
        return (*_sorted_rows(100, 900, 1, 10, 1), 10, 0)
    if case == "two classes":
        return (*_sorted_rows(100, 900, 2, 10, 2), 10, 0)
    if case == "n % 4 != 0":
        return (*_sorted_rows(13, 901, 3, 10, 3), 10, 0)
    if case == "misaligned view":
        return (*_sorted_rows(13, 900, 3, 10, 4), 10, 1)
    if case == "out of range":
        labels = rng.integers(-3, 13, (9, 900)).astype(np.int32)
        return labels, np.ones((9, 900), np.float32), 10, 0
    if case == "K = 1":
        return (*_sorted_rows(1, 900, 4, 10, 5), 10, 0)
    if case == "C = 64":
        return (*_div_inputs(7, 900, 64, 6), 64, 0)
    if case == "float mask":
        labels, _ = _sorted_rows(11, 900, 3, 10, 7)
        return labels, rng.random((11, 900)).astype(np.float32), 10, 0
    raise KeyError(case)


@pytest.mark.parametrize("case", [
    "one class", "two classes", "n % 4 != 0", "misaligned view",
    "out of range", "K = 1", "C = 64", "float mask"])
def test_diversity_routes_on_card(cuda_device, case):
    """After every SM's shared memory is filled with NaN, two launches give
    the same bits through the route ``route`` predicts (the C source's own
    choice agrees), within 1e-5 of the plain version, with exact counts
    for a {0, 1} mask: label-sorted rows of one and two classes (every
    lane of a warp on one class), N % 4 != 0 and a view one label into
    its buffer (the scalar route), labels outside [0, C), K = 1, C = 64,
    and a mask in [0, 1)."""
    from repro_torch.kernels import _check
    labels, mask, c, offset = _diversity_case(case)
    k, n = labels.shape
    buf = torch.zeros((k * n + 4,), dtype=torch.int32, device=cuda_device)
    buf[offset:offset + k * n] = torch.from_numpy(labels.reshape(-1)).to(
        cuda_device)
    lab_t = buf[offset:offset + k * n].view(k, n)
    mask_t = torch.from_numpy(mask).to(cuda_device)
    which = tdiv.route(n, lab_t.data_ptr(), mask_t.data_ptr())
    assert which == ("scalar" if case in ("n % 4 != 0", "misaligned view")
                     else "vec4")
    assert _build.library().diversity_route(
        lab_t.data_ptr(), mask_t.data_ptr(), n) == tdiv.ROUTE_VEC[which]
    before = tdiv.diversity_stats.route_launches[which]
    outs = []
    for _ in range(2):
        _check.fill_shared_memory(cuda_device)
        outs.append(tdiv.diversity_stats(lab_t, mask_t, c))
    torch.cuda.synchronize()
    assert tdiv.diversity_stats.route_launches[which] == before + 2
    assert torch.equal(outs[0], outs[1])
    want = tdiv.diversity_stats_plain(torch.from_numpy(labels),
                                      torch.from_numpy(mask), c)
    got = outs[0].cpu()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    if case != "float mask":
        assert torch.equal(got[:, 2], want[:, 2])


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


# The warp route's projection, emulated in plain torch, one row at a time:
# the kernel's bisection layout (the active coordinates packed in
# coordinate order, -inf past them, packed entry i + G m on lane i of each
# group of G lanes, G the least power of two >= 2 with 16 G covering
# them), its balanced per-lane sums, its group butterfly and its round of
# speculative midpoints.

def _groups(v, act):
    """(K,) -> (16, G): packed entry i + G m at [m, i]."""
    packed = v[act]
    g = 2
    while 16 * g < packed.numel():
        g *= 2
    w = torch.full((16 * g,), -math.inf)
    w[:packed.numel()] = packed
    return w.view(16, g)


def _sums(w, mids):
    """group_sums: (16, G) x (N,) -> (N,) totals of max(v - mid, 0) (a
    balanced tree over each lane's 16, then the butterfly)."""
    t = torch.clamp_min(w[None] - mids[:, None, None], 0.0)
    while t.shape[1] > 1:
        t = t[:, 0::2] + t[:, 1::2]
    t = t[:, 0]
    lane = torch.arange(t.shape[-1])
    off = 1
    while off < t.shape[-1]:
        t = t + t[..., lane ^ off]
        off <<= 1
    return t[..., 0]


def _bracket(v, act):
    """(min - 1, max) over the active coordinates; (inf, -inf) for none."""
    return (torch.where(act, v, torch.tensor(math.inf)).min() - 1.0,
            torch.where(act, v, torch.tensor(-math.inf)).max())


def _theta_trips(v, act, proj_iters):
    """The trip-by-trip bisection."""
    w = _groups(v, act)
    lo, hi = _bracket(v, act)
    for _ in range(proj_iters):
        mid = 0.5 * (lo + hi)
        if _sums(w, mid[None])[0] >= 1.0:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def _ascending(depth):
    """Heap nodes of a bisection tree in ascending order of midpoint: the
    in-order walk (2n + 2, n, 2n + 1)."""
    n_cand = (1 << depth) - 1

    def walk(n):
        return [] if n >= n_cand else walk(2 * n + 2) + [n] + walk(2 * n + 1)
    return walk(0)


def _theta_speculative(v, act, proj_iters, depth):
    """bisect<G, D>: rounds of D trips (then one of the remainder), each
    the 2^D - 1 midpoints of its trips in heap order, summed at once; with
    t of them at s >= 1, lo and hi become the t-th and (t+1)-th of (lo,
    the midpoints in ascending order, hi)."""
    w = _groups(v, act)
    lo, hi = _bracket(v, act)
    trips = proj_iters
    while trips:
        d = min(depth, trips)
        trips -= d
        n_cand = (1 << d) - 1
        blo, bhi, mids = [lo], [hi], []
        for n in range(n_cand):
            mids.append(0.5 * (blo[n] + bhi[n]))
            if 2 * n + 2 < n_cand:
                blo += [mids[n], blo[n]]
                bhi += [bhi[n], mids[n]]
        t = int((_sums(w, torch.stack(mids)) >= 1.0).sum())
        ends = [lo] + [mids[n] for n in _ascending(d)] + [hi]
        lo, hi = ends[t], ends[t + 1]
    return 0.5 * (lo + hi)


@pytest.mark.parametrize("k", [1, 2, 31, 100, 256])
@pytest.mark.parametrize("depth", [2, 3, 4])
def test_sub2_speculative_bisection_is_the_trip_by_trip_theta(k, depth,
                                                              one_thread):
    """The kernel's speculative projection keeps the bisection's own
    iterates: theta bit for bit the 32-trip loop's, on random steps with
    random masks (1 to 256 active coordinates, so every group width),
    also with a trip count that is not a multiple of the depth.  An
    all-masked row gives NaN in both (the kernel then writes zeros)."""
    rng = np.random.default_rng(100 * k + depth)
    rows = 6
    v = (rng.random((rows, k)) * 2.0 / k
         + 0.3 * rng.standard_normal((rows, k)) / k).astype(np.float32)
    mask = rng.random((rows, k)) < rng.random((rows, 1))
    mask[:, 0] = True
    mask[0] = True
    v, act = torch.from_numpy(v), torch.from_numpy(mask)
    none = torch.zeros((k,), dtype=torch.bool)
    assert bool(torch.isnan(_theta_trips(v[0], none, 7)))
    assert bool(torch.isnan(_theta_speculative(v[0], none, 7, depth)))
    for row in range(rows):
        for proj_iters in (7, tpgd.DEFAULT_PROJ_ITERS):
            want = _theta_trips(v[row], act[row], proj_iters)
            got = _theta_speculative(v[row], act[row], proj_iters, depth)
            assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        # And it is the simplex projection's theta: the shares sum to 1.
        share = torch.clamp_min(v[row][act[row]] - want, 0.0).sum()
        assert float(share) == pytest.approx(1.0, abs=2e-6)


@pytest.mark.parametrize("k,want", [(1, "warp4"), (100, "warp4"),
                                    (128, "warp4"), (129, "warp8"),
                                    (256, "warp8"), (257, "block"),
                                    (1024, "block")])
def test_sub2_route_by_k(k, want):
    assert tpgd.route(k) == want
    assert k <= tpgd.ROUTE_MAX_K[want]


@pytest.mark.parametrize("k", [0, 1025])
def test_sub2_route_rejects_k_out_of_range(k):
    with pytest.raises(ValueError, match="1 <= K <= 1024"):
        tpgd.route(k)


def _sub2_rows(s, k, seed):
    """S Table-I instances of K devices on the CPU, from the port's own
    samplers: (sel, t_train, c, power, bits) rows and (S, 2, K) starts
    (water-filling, uniform).  About 40% selected; with S >= 3, row 1
    selects no device (its starts are zeros)."""
    gen = torch.Generator().manual_seed(seed)
    wcfg = tw.WirelessConfig()
    rows = {n: [] for n in ("sel", "tt", "c", "pw", "bits", "a0")}
    for i in range(s):
        net = tw.sample_network(gen, k, wcfg)
        gains = tw.sample_fading(gen, net)
        sizes = torch.randint(50, 901, (k,), generator=gen)
        tt = tw.train_time(sizes, net, wcfg)
        sel = (torch.rand((k,), generator=gen) < 0.4).float()
        sel[0] = 1.0
        if i == 1 and s >= 3:
            sel = torch.zeros((k,))
            a0 = torch.zeros((2, k))
        else:
            wf, _ = tbw.min_time_allocation(sel, tt, gains, net.tx_power,
                                            wcfg)
            a0 = torch.stack([wf, sel / sel.sum()])
        rows["sel"].append(sel)
        rows["tt"].append(tt)
        rows["c"].append(gains * net.tx_power
                         / (wcfg.bandwidth_hz * wcfg.noise_psd))
        rows["pw"].append(net.tx_power)
        rows["bits"].append(torch.full((k,), wcfg.model_bits))
        rows["a0"].append(a0)
    return [torch.stack(rows[n]).float().contiguous()
            for n in ("sel", "tt", "c", "pw", "bits", "a0")]


def _nan_padded(t, device):
    """``t`` on ``device`` at the front of a NaN-filled buffer running
    1024 - K floats past its end (at S = 1 the first K columns of a
    (1, 1024) row): a read past K reads NaN."""
    k = t.shape[-1]
    buf = torch.full((t.numel() + 1024 - k,), float("nan"), device=device)
    buf[:t.numel()] = t.reshape(-1).to(device)
    return buf[:t.numel()].view(t.shape)


@pytest.mark.parametrize("s", [1, 3, 16])
@pytest.mark.parametrize("k", [1, 31, 32, 33, 100, 128, 129, 256, 257, 1024])
def test_sub2_routes_on_card(cuda_device, k, s):
    """Every route at its edges of K, against the plain version (the
    existing limits), one launch through route(K), NaN past K and in
    shared memory: finite shares that sum to 1 over the selected set,
    zeros elsewhere and for the empty selection."""
    from repro_torch.kernels import _check
    args = _sub2_rows(s, k, 7000 + 100 * s + k)
    kw = dict(_PGD_KW, iters=200)
    on_card = [_nan_padded(t, cuda_device) for t in args]
    before = dict(tpgd.sub2_pgd.route_launches)
    launches = tpgd.sub2_pgd.launches
    _check.fill_shared_memory(cuda_device)
    a, o = tpgd.sub2_pgd(*on_card, **kw)
    torch.cuda.synchronize()
    a, o = a.cpu(), o.cpu()
    assert tpgd.sub2_pgd.launches == launches + 1
    assert {r: n - before[r] for r, n in tpgd.sub2_pgd.route_launches.items()
            } == {r: int(r == tpgd.route(k)) for r in tpgd.ROUTE_COORDS}
    assert bool(a.isfinite().all()) and bool(o.isfinite().all())
    sel = args[0] > 0
    assert bool((a[~sel] == 0).all())
    any_sel = sel.any(1)
    torch.testing.assert_close(torch.where(sel, a, 0.0).sum(1),
                               any_sel.float(), rtol=0, atol=1e-5)
    assert bool((o[~any_sel] == 0).all())
    a_p, o_p = tpgd.sub2_pgd_plain(*args, **kw)
    torch.testing.assert_close(a, a_p, rtol=0, atol=1e-2)
    torch.testing.assert_close(o, o_p, rtol=1e-3, atol=0)


def test_sub2_launch_rejects_what_its_route_does_not_take():
    """The checks before any launch: a route past its K, a depth out of
    range, and tau <= 0 on a warp route (whose softmax max is the max
    round time over tau)."""
    rows = [torch.ones((1, 200))] * 5 + [torch.ones((1, 2, 200))]
    kw = dict(_PGD_KW)
    with pytest.raises(ValueError, match="does not take K = 200"):
        tpgd.launch(*rows, which="warp4", **kw)
    with pytest.raises(ValueError, match="depth"):
        tpgd.launch(*rows, which="warp8", depth=5, **kw)
    with pytest.raises(ValueError, match="tau > 0"):
        tpgd.launch(*rows, which="warp8", **dict(kw, tau=0.0))


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

"""The port's compressed-uplink subsystem against the JAX reference.

The plain ``compress_update`` against ``ref.compress_update`` and the
Pallas kernel in interpret mode (``topk`` exactly; ``quant`` with the
share of stochastic roundings that flip stated), every codec's payload
bits, the adaptive bit widths, ``apply_codec``'s fold-back of failed
uploads and its ``error_feedback=False`` gate, and the driver with the
``quant`` codec on the MLP against ``make_feel_sim`` on one key schedule.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import compression as jcomp  # noqa: E402
from repro.core import wireless as jw  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core import compression as tcomp  # noqa: E402
from repro_torch.core import wireless as tw  # noqa: E402
from repro_torch.kernels import compress as tcu  # noqa: E402
from test_torch_federated import assert_runs_agree, run_pair  # noqa: E402

K = 12
# Quantization flips: the plain version rounds like the reference, but a
# coordinate whose scaled value sits within an ulp of its noise draw may
# round the other way.  At most this share of coordinates may flip, by
# exactly one level; every other coordinate agrees to f32 rounding.
QUANT_FLIP_SHARE = 1e-3


@pytest.fixture
def one_thread():
    """Small tensors: one intra-op thread, so the test workers that share
    the machine do not oversubscribe its cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(x):
    return torch.from_numpy(np.array(x))


def _inputs(seed, shape):
    rng = np.random.default_rng(seed)
    u = (rng.standard_normal(shape) * rng.random(shape[:-1] + (1,))
         ).astype(np.float32)
    r = (0.1 * rng.standard_normal(shape)).astype(np.float32)
    sel = (rng.random(shape[:-1]) > 0.3).astype(np.float32)
    noise = rng.random(shape).astype(np.float32)
    u[..., 0, :] = 0.0                      # an all-zero row
    r[..., 0, :] = 0.0
    return u, r, sel, noise


def assert_quant_close(c_got, c_want, v, widths):
    """Equal but for at most QUANT_FLIP_SHARE one-level flips."""
    m = np.abs(v).max(-1, keepdims=True)
    step = m / np.maximum(np.exp2(widths)[..., None] - 1.0, 1.0)
    diff = np.abs(c_got - c_want)
    flipped = diff > 0.5 * step
    assert flipped.mean() <= QUANT_FLIP_SHARE, flipped.mean()
    np.testing.assert_allclose(diff[flipped], step.repeat(
        v.shape[-1], -1)[flipped], rtol=1e-5)
    assert np.all(diff[~flipped]
                  <= 1e-6 * np.broadcast_to(m, diff.shape)[~flipped])


@pytest.mark.parametrize("shape,keep", [((K, 700), 35), ((K, 4096), 1),
                                        ((2, K, 1001), 50),
                                        ((K, 5000), 5000)])
def test_topk_plain_equals_reference(shape, keep):
    """Exact: a max, 32 exact count bisections and selects."""
    u, r, sel, _ = _inputs(keep, shape)
    widths = np.full(shape[:-1], 32.0, np.float32)
    noise = np.zeros(shape[:-1], np.float32)
    got = tcu.compress_update(*map(_t, (u, r, widths, sel, noise)),
                              mode="topk", keep=keep)
    for want in (jref.compress_update(u, r, widths, sel, noise, mode="topk",
                                      keep=keep),
                 jops.compress_update(u, r, widths, sel, noise, mode="topk",
                                      keep=keep)):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    kept = (got[0].numpy() != 0).sum(-1)
    assert np.all(kept[..., 1:] >= keep - 1)


@pytest.mark.parametrize("shape,bits", [((K, 700), 8), ((K, 3000), 4),
                                        ((2, K, 1001), 12),
                                        ((K, 2000), None)])
def test_quant_plain_matches_reference(shape, bits):
    u, r, sel, noise = _inputs(7 + shape[-1], shape)
    if bits is None:       # per-device widths, as the adaptive codec
        widths = np.random.default_rng(0).integers(4, 13, shape[:-1])
        widths = widths.astype(np.float32)
    else:
        widths = np.full(shape[:-1], float(bits), np.float32)
    c, r_new = tcu.compress_update(*map(_t, (u, r, widths, sel, noise)),
                                   mode="quant")
    v = u + r
    for c_w, r_w in (jref.compress_update(u, r, widths, sel, noise,
                                          mode="quant"),
                     jops.compress_update(u, r, widths, sel, noise,
                                          mode="quant")):
        assert_quant_close(c.numpy(), np.asarray(c_w), v, widths)
    np.testing.assert_allclose(
        r_new.numpy(), np.where(sel[..., None] > 0, v - c.numpy(), r),
        rtol=0, atol=0)
    assert np.all(c.numpy()[..., 0, :] == 0.0)


def test_compress_rejects_unknown_mode_and_cpu_wrapper_does_not_launch():
    u, r, sel, noise = _inputs(1, (K, 64))
    w = np.full((K,), 8.0, np.float32)
    with pytest.raises(ValueError, match="mode"):
        tcu.compress_update(*map(_t, (u, r, w, sel, noise)), mode="zip")
    before = tcu.compress_update.launches
    tcu.compress_update(*map(_t, (u, r, w, sel, noise)), mode="quant")
    assert tcu.compress_update.launches == before


def _codec_world(seed=0):
    rng = np.random.default_rng(seed)
    gains = (rng.exponential(size=K) * 1e-9).astype(np.float32)
    index = rng.random(K).astype(np.float32)
    index[3] = index[5]                         # a tie for the ranks
    return gains, index


@pytest.mark.parametrize("codec", ["none", "quant", "topk", "adaptive"])
@pytest.mark.parametrize("kw", [{}, dict(bit_width=4, topk_frac=0.2,
                                         value_bits=16.0, index_bits=9.0)])
def test_payload_bits_match_reference(codec, kw):
    gains, index = _codec_world()
    got = tcomp.get_codec(codec).payload_bits(
        tcomp.CompressionConfig(codec=codec, **kw), tw.WirelessConfig(),
        _t(gains), _t(index))
    want = jcomp.get_codec(codec).payload_bits(
        jcomp.CompressionConfig(codec=codec, **kw), jw.WirelessConfig(),
        jnp.asarray(gains), jnp.asarray(index))
    if want is None:
        assert got is None
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-7)
    ccfg_t = tcomp.CompressionConfig(**kw)
    ccfg_j = jcomp.CompressionConfig(**kw)
    assert tcomp.nominal_coords(ccfg_t, tw.WirelessConfig()) == \
        jcomp.nominal_coords(ccfg_j, jw.WirelessConfig())
    assert tcomp.topk_index_bits(ccfg_t, tw.WirelessConfig()) == \
        jcomp.topk_index_bits(ccfg_j, jw.WirelessConfig())


@pytest.mark.parametrize("weight", [0.0, 0.5, 1.0])
def test_adaptive_widths_and_ranks_match_reference(weight):
    """Stable ranks (ties by position) and half-to-even rounding."""
    gains, index = _codec_world(int(weight * 10))
    np.testing.assert_array_equal(tcomp.rank01(_t(index)).numpy(),
                                  np.asarray(jcomp.rank01(index)))
    np.testing.assert_array_equal(
        tcomp.rank01(torch.ones(5)).numpy(),
        np.asarray(jcomp.rank01(jnp.ones(5))))
    kw = dict(adaptive_channel_weight=weight)
    got = tcomp.adaptive_bit_widths(tcomp.CompressionConfig(**kw),
                                    _t(gains), _t(index))
    want = jcomp.adaptive_bit_widths(jcomp.CompressionConfig(**kw),
                                     jnp.asarray(gains), jnp.asarray(index))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("codec", ["quant", "topk", "adaptive", "none"])
@pytest.mark.parametrize("ef,with_success", [(True, True), (True, False),
                                             (False, True)])
def test_apply_codec_matches_reference(codec, ef, with_success):
    """Fold-back: a selected device whose upload failed keeps its whole
    update in the residual; ``error_feedback=False`` zeroes it."""
    p = 900
    u, r, sel, _ = _inputs(3, (K, p))
    success = (np.arange(K) % 3 != 1).astype(np.float32)
    gains, index = _codec_world()
    key = jax.random.key(2)
    noise = np.asarray(jax.random.uniform(key, (K, p)))
    ccfg_j = jcomp.CompressionConfig(codec=codec, error_feedback=ef)
    ccfg_t = tcomp.CompressionConfig(codec=codec, error_feedback=ef)
    codec_t = tcomp.get_codec(codec)
    c_j, r_j = jcomp.apply_codec(
        jcomp.get_codec(codec), u, r, sel, key, ccfg_j, gains, index,
        success=success if with_success else None)
    c_t, r_t = tcomp.apply_codec(
        codec_t, *map(_t, (u, r, sel)),
        _t(noise) if codec_t.stochastic else None, ccfg_t,
        *map(_t, (gains, index)),
        success=_t(success) if with_success else None)
    if codec_t.stochastic:
        widths = np.asarray(jcomp.adaptive_bit_widths(ccfg_j, gains, index)) \
            if codec == "adaptive" else np.full((K,), 8.0, np.float32)
        assert_quant_close(c_t.numpy(), np.asarray(c_j), u + r, widths)
        np.testing.assert_allclose(r_t.numpy(), np.asarray(r_j), atol=1e-3)
    else:
        np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))
        np.testing.assert_array_equal(r_t.numpy(), np.asarray(r_j))
    failed = (sel * (1 - success)) > 0 if with_success else np.zeros(K, bool)
    if ef and codec != "none":
        # The failed rows' residual is r + u: nothing was lost.
        np.testing.assert_array_equal(r_t.numpy()[failed], (r + u)[failed])
    if not ef:
        assert not r_t.any()


def test_quant_codec_needs_noise():
    u, r, sel, _ = _inputs(1, (K, 32))
    gains, index = _codec_world()
    with pytest.raises(ValueError, match="noise"):
        tcomp.apply_codec(tcomp.get_codec("quant"), *map(_t, (u, r, sel)),
                          None, tcomp.CompressionConfig(),
                          *map(_t, (gains, index)))
    # Other test files may register codecs of their own in the
    # reference's registry; the built-in ones are the same.
    assert tcomp.codec_names() == ("adaptive", "none", "quant", "topk")
    assert set(tcomp.codec_names()) <= set(jcomp.codec_names())


def test_driver_with_quant_matches_reference():
    """``quant`` at 8 bits on the MLP, the reference's noise replayed:
    equal selections, iterations and delivered counts; Sub2 objective
    1e-4.  Params atol 1e-3: a stochastic rounding that flips because
    the two trainers' updates differ by f32 rounding moves a coordinate
    by one level (row max / 255), and later rounds train on from it."""
    jp, jm, tp, recs = run_pair(
        "mlp", K, 0, 0.1,
        jsub=dict(compression=jcomp.CompressionConfig(codec="quant")),
        tsub=dict(compression=tcomp.CompressionConfig(codec="quant")))
    assert_runs_agree(jm, recs, jp, tp, atol=1e-3)


def test_compress_kernel_on_card():
    """The CUDA kernel against its plain version at the CNN's P (needs a
    CUDA device): topk exactly, quant with the flip share."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA kernels have no CPU mode)")
    u, r, sel, noise = _inputs(5, (100, 21840))
    dev = torch.device("cuda")
    widths = np.full((100,), 8.0, np.float32)
    args = [_t(x) for x in (u, r, widths, sel, noise)]
    c, r_new = tcu.compress_update(*(a.to(dev) for a in args), mode="quant")
    c_p, r_p = tcu.compress_update_plain(*args, mode="quant")
    assert_quant_close(c.cpu().numpy(), c_p.numpy(), u + r, widths)
    same = c.cpu() == c_p
    assert torch.equal(r_new.cpu()[same], r_p[same])
    assert float((r_new.cpu() != r_p).float().mean()) <= QUANT_FLIP_SHARE
    topk = [a.to(dev) for a in args[:4]] + [args[4][:, 0].to(dev)]
    got = tcu.compress_update(*topk, mode="topk", keep=1092)
    want = tcu.compress_update_plain(*args[:4], args[4][:, 0], mode="topk",
                                     keep=1092)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


# ---------------------------------------------------------------------------
# The on-chip route: its choice by P, and its bisection emulated in plain
# torch.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("p,nb", [
    (1, 1), (1001, 1), (21840, 1), (24576, 1), (24577, 2), (49152, 2),
    (49153, 4), (100003, 8), (159010, 8), (196608, 8)])
def test_compress_route_and_cluster_by_p(p, nb):
    """Rows up to 8 x 24576 floats stay on chip, over the least power of
    two of blocks whose share fits one block; every block's shared memory
    (topk's with its warps' pools) lets two blocks share an SM."""
    assert tcu.route(p) == "onchip"
    assert tcu.cluster_blocks(p) == nb
    for mode in tcu.MODES:
        smem = tcu.onchip_smem_bytes(p, nb, mode)
        assert 0 < smem <= 113 * 1024 and smem % 16 == 0
        assert 4 * -(-p // nb) <= smem
    if nb > 1:
        assert tcu.onchip_smem_bytes(p, nb // 2, "quant") == 0


@pytest.mark.parametrize("p", [196609, 300000])
def test_compress_long_rows_take_the_stream_route(p):
    assert tcu.route(p) == "stream"
    with pytest.raises(ValueError, match="stream route"):
        tcu.cluster_blocks(p)
    assert tcu.onchip_smem_bytes(p, tcu.MAX_CLUSTER, "topk") == 0


def _hi_trips(av, keep, iters):
    """The plain version's threshold bisection, trip by trip."""
    lo, hi = torch.zeros((), dtype=torch.float32), av.max()
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        if int((av >= mid).sum()) > keep:
            lo = mid
        else:
            hi = mid
    return hi


def _hi_onchip(av, keep, iters, depth, full_trips):
    """The on-chip kernel's bisection: full_trips trips over the whole
    row, then the magnitudes in [lo, hi) kept (those at or above hi
    counted once), then passes of `depth` trips: every midpoint of the
    tree of brackets in heap order, counted at once, and the bracket the
    largest midpoint whose count exceeds keep (or lo) and the least of the
    others (or hi)."""
    lo, hi = torch.zeros((), dtype=torch.float32), av.max()
    left = iters
    for _ in range(min(full_trips, iters)):
        mid = 0.5 * (lo + hi)
        if int((av >= mid).sum()) > keep:
            lo = mid
        else:
            hi = mid
        left -= 1
    above = int((av >= hi).sum())
    pool = av[(av >= lo) & (av < hi)]
    while left:
        d = min(depth, left)
        left -= d
        n = (1 << d) - 1
        blo, bhi, mids = [lo], [hi], []
        for j in range(n):
            mids.append(0.5 * (blo[j] + bhi[j]))
            if 2 * j + 2 < n:
                blo += [mids[j], blo[j]]
                bhi += [bhi[j], mids[j]]
        over = [above + int((pool >= mid).sum()) > keep for mid in mids]
        lo = max([lo] + [m for m, o in zip(mids, over) if o])
        hi = min([hi] + [m for m, o in zip(mids, over) if not o])
    return hi


@pytest.mark.parametrize("depth", [1, 2, 3, 4])
@pytest.mark.parametrize("full_trips", [0, 4, 32])
def test_onchip_bisection_is_the_trip_by_trip_threshold(depth, full_trips,
                                                        one_thread):
    """The kernel's bisection keeps the trip-by-trip iterates: hi bit for
    bit the 32-trip loop's (and a 7-trip loop's, a count that is not a
    multiple of the depth), so the kept set is compress_update_plain's,
    on Gaussian rows, rows of ties (at, above and below the threshold),
    an all-zero row and a single non-zero, with keep = 1, 5 %, half and
    P."""
    rng = np.random.default_rng(10 * depth + full_trips)
    p = 1500
    rows = [rng.standard_normal(p) * s for s in (1.0, 0.01, 30.0)]
    ties = np.round(rng.standard_normal(p) * 4.0) / 4.0
    rows += [ties, np.zeros(p), np.eye(1, p, 7)[0] * -2.5,
             np.where(rng.random(p) < 0.5, 0.75, rng.random(p))]
    v = torch.from_numpy(np.stack(rows).astype(np.float32))
    zeros = torch.zeros_like(v)
    for keep in (1, 75, p // 2, p):
        c, _ = tcu.compress_update_plain(
            v, zeros, torch.full((len(rows),), 32.0), torch.ones(len(rows)),
            torch.zeros(len(rows)), mode="topk", keep=keep)
        for row in range(len(rows)):
            av = v[row].abs()
            for iters in (7, tcu.DEFAULT_THRESH_ITERS):
                want = _hi_trips(av, keep, iters)
                got = _hi_onchip(av, keep, iters, depth, full_trips)
                assert torch.equal(got.view(torch.int32),
                                   want.view(torch.int32)), (row, keep, iters)
            kept = torch.where(av >= got, v[row], 0.0)
            assert torch.equal(kept, c[row])


@pytest.mark.parametrize("mode", ["quant", "topk"])
@pytest.mark.parametrize("s,k,p", [(1, 100, 21840), (1, 100, 159010),
                                   (1, 7, 100003), (16, 100, 21840),
                                   (1, 5, 1001), (1, 3, 200001)])
def test_compress_routes_on_card(mode, s, k, p):
    """Every launch after every SM's shared memory is filled with NaN:
    topk bit for bit the plain version (every depth on the on-chip
    route), quant within the flip share with r' bitwise wherever the codes
    agree; the same bits on a second launch; the stream route on the same
    rows alike (needs a CUDA device)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA kernels have no CPU mode)")
    from repro_torch.kernels import _check
    dev = torch.device("cuda")
    u, r, sel, noise = _inputs(p + s, (s, k, p))
    widths = np.full((s, k), 8.0 if mode == "quant" else 32.0, np.float32)
    if mode == "topk":
        noise = noise[..., 0]
    args = [_t(x) for x in (u, r, widths, sel, noise)]
    keep = max(1, round(0.05 * p))
    kw = dict(mode=mode, keep=keep, thresh_iters=tcu.DEFAULT_THRESH_ITERS)
    c_p, r_p = tcu.compress_update_plain(*args, **kw)
    on_card = [a.to(dev) for a in args]
    before = dict(tcu.compress_update.route_launches)
    _check.fill_shared_memory(dev)
    got = tcu.compress_update(*on_card, **kw)
    routed = {key: n - before[key]
              for key, n in tcu.compress_update.route_launches.items()}
    assert routed == {key: int(key == f"{mode}/{tcu.route(p)}")
                      for key in routed}
    runs = [((tcu.route(p), tcu.SPEC_DEPTH), got)]
    routes = [("stream", tcu.SPEC_DEPTH)]
    if tcu.route(p) == "onchip" and mode == "topk":
        routes += [("onchip", d) for d in range(1, tcu.MAX_SPEC_DEPTH + 1)]
    for which, depth in routes:
        _check.fill_shared_memory(dev)
        runs.append(((which, depth), tcu.launch(*on_card, which=which,
                                                depth=depth, **kw)))
    _check.fill_shared_memory(dev)
    again = tcu.compress_update(*on_card, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    for label, (c, r_new) in runs:
        c, r_new = c.cpu(), r_new.cpu()
        if mode == "topk":
            assert torch.equal(c, c_p) and torch.equal(r_new, r_p), label
            continue
        assert_quant_close(c.numpy(), c_p.numpy(), u + r, widths)
        same = c == c_p
        assert torch.equal(r_new[same], r_p[same]), label
        assert float((r_new != r_p).float().mean()) <= QUANT_FLIP_SHARE

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

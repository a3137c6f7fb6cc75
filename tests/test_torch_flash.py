"""The port's flash attention: plain version against the JAX reference.

``repro_torch.kernels.flash_attention`` holds the CUDA wrapper and its
plain PyTorch version.  On the CPU the wrapper computes the plain
version; these tests hold it against the reference's oracle
(``repro.kernels.ref.flash_attention``, f32 and bf16, causal / window /
non-causal, grouped-query heads, ``Sq != Skv``) and against the Pallas
kernel in interpret mode with a ``kv_len`` validity mask, on the same
numpy-seeded inputs.  The CUDA launches are checked by the test that
takes the ``cuda_device`` fixture, which skips without a card.

The bf16 prefill runs on the tensor cores and rounds each softmax weight
to bf16 before ``p . v``; its two checks (``_check.bf16_prefill_ratio``,
``_check.bf16_rounding_bias``) are shown here on a plain-torch emulation
of that arithmetic: they pass it and catch a truncating store and a
missing rescale.  The wrapper's own checks (route, shared memory, TMA
strides, decode splits) are plain Python and run here too.
"""

import math

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import flash_attention as jfa  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import _build, _check  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402


@pytest.fixture(autouse=True)
def one_thread():
    """Tiny shapes: one intra-op thread, so the test workers that share
    the machine do not oversubscribe its cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def cuda_device():
    """The CUDA card, or a skip: the test launches the CUDA kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _tol(dtype):
    """The reference's kernel-test limits (tests/test_kernels.py)."""
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" \
        else dict(rtol=1e-5, atol=1e-5)


def _inputs(b, sq, skv, h, kv, hd, dtype, seed):
    """q (B,Sq,H,hd), k, v (B,Skv,KV,hd) as numpy, rounded to dtype."""
    rng = np.random.default_rng(seed)
    np_dt = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32
    return tuple(rng.standard_normal(shape).astype(np.float32).astype(np_dt)
                 for shape in ((b, sq, h, hd), (b, skv, kv, hd),
                               (b, skv, kv, hd)))


def _torch(x):
    if x.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(x)


def _flat(x, heads):
    """(B, S, n, hd) -> (B*heads, S, hd), KV heads repeated to ``heads``."""
    b, s, n, hd = x.shape
    x = np.repeat(x, heads // n, axis=2)
    return x.transpose(0, 2, 1, 3).reshape(b * heads, s, hd)


def _unflat(x, b, h):
    bh, s, hd = x.shape
    return np.asarray(x, np.float32).reshape(b, h, s, hd).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 24),
                                           (False, 0)])
@pytest.mark.parametrize("sq,skv,h,kv", [(57, 57, 4, 2), (40, 72, 4, 1),
                                         (33, 33, 2, 2)])
def test_plain_matches_reference(dtype, causal, window, sq, skv, h, kv):
    """GQA by head index against the reference on repeated heads,
    Sq != Skv included; every row here sees at least one key."""
    b, hd = 2, 16
    q, k, v = _inputs(b, sq, skv, h, kv, hd, dtype, sq * 100 + skv)
    want = jref.flash_attention(jnp.asarray(_flat(q, h)),
                                jnp.asarray(_flat(k, h)),
                                jnp.asarray(_flat(v, h)), causal=causal,
                                window=window)
    got = tfa.flash_attention(_torch(q), _torch(k), _torch(v), causal=causal,
                              window=window)
    assert got.dtype == _torch(q).dtype
    np.testing.assert_allclose(got.float().numpy(), _unflat(want, b, h),
                               **_tol(dtype))


@pytest.mark.parametrize("sq,skv,kv_len,causal,window", [
    (128, 128, 100, False, 0),      # padded keys past kv_len
    (128, 128, 100, True, 48),      # causal + window + validity
    (64, 128, 77, False, 0),        # decode-like: rows share the keys
    (128, 64, 64, True, 0),         # Sq > Skv
])
def test_plain_matches_pallas_kernel_with_kv_len(sq, skv, kv_len, causal,
                                                 window):
    """The TPU kernel itself, interpret mode, blocks of 64, BH = 4."""
    bh, hd = 4, 32
    q, k, v = _inputs(1, sq, skv, bh, bh, hd, "float32", kv_len + sq)
    want = jfa.flash_attention_kernel(
        jnp.asarray(_flat(q, bh)), jnp.asarray(_flat(k, bh)),
        jnp.asarray(_flat(v, bh)), causal=causal, window=window,
        block_q=64, block_k=64, kv_len=kv_len, interpret=True)
    got = tfa.flash_attention(_torch(q), _torch(k), _torch(v), causal=causal,
                              window=window, kv_len=kv_len)
    np.testing.assert_allclose(got.numpy(), _unflat(want, 1, bh),
                               rtol=1e-5, atol=1e-5)


def test_fully_masked_row_gives_zero():
    """A row with no visible key is 0 (not NaN, not the mean of v)."""
    q, k, v = _inputs(1, 40, 8, 2, 1, 16, "float32", 5)
    out = tfa.flash_attention_plain(_torch(q), _torch(k), _torch(v),
                                    causal=True, window=4)
    assert torch.all(out[:, 11:] == 0)
    assert torch.all(out[:, :11].abs().sum(-1) > 0)


def test_visible_pairs_counts_the_mask():
    for sq, causal, window, kv_len in [(50, True, 0, 50), (50, True, 7, 50),
                                       (30, False, 0, 12), (1, False, 0, 9),
                                       (40, True, 5, 31)]:
        vis = tfa.visible_mask(sq, max(sq, kv_len), causal=causal,
                               window=window, kv_len=kv_len)
        assert tfa.visible_pairs(sq, causal=causal, window=window,
                                 kv_len=kv_len) == int(vis.sum())


def test_cpu_wrapper_takes_plain_version():
    q, k, v = _inputs(2, 20, 20, 4, 2, 16, "float32", 3)
    q, k, v = _torch(q), _torch(k), _torch(v)
    before = tfa.flash_attention.launches
    got = tfa.flash_attention(q, k, v, causal=True, window=5, kv_len=17)
    want = tfa.flash_attention_plain(q, k, v, causal=True, window=5,
                                     kv_len=17)
    assert tfa.flash_attention.launches == before
    assert torch.equal(got, want)


def test_bf16_rounding_check_catches_truncation():
    """The card test's bf16 check: the plain version's bf16 output (its
    f32 answer rounded to nearest) passes; the same answer truncated to
    bf16 fails, at the danube decode output's scale and at prefill's."""
    q, k, v = _inputs(2, 1, 4096, 32, 8, 120, "float32", 11)
    want = tfa.flash_attention_plain(_torch(q), _torch(k), _torch(v),
                                     causal=False, window=0)
    for scale in (1.0, 100.0):
        w = want * scale
        nearest = w.to(torch.bfloat16)
        truncated = (w.view(torch.int32) & ~0xFFFF).view(torch.float32) \
            .to(torch.bfloat16)
        assert _check.bf16_rounding_ratio(nearest, w, 1e-5) <= 1.0
        assert _check.bf16_rounding_ratio(truncated, w, 1e-5) > 1.5


def emulate_tc_prefill(q, k, v, *, causal, window, kv_len=None,
                       store="nearest", rescale=True):
    """The tensor-core prefill's arithmetic in plain torch: 64-key tiles,
    online softmax in f32 with the scale on the f32 scores (log2 units),
    the sum taken over the f32 p, p rounded to bf16 for ``p . v`` (f32
    sums), one division at the end and a bf16 store rounded to nearest
    (or truncated).  ``rescale=False`` drops the alpha rescale of the
    accumulator, the classic fault."""
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    kv_len = skv if kv_len is None else kv_len
    qf = q.float().reshape(b, sq, kvh, h // kvh, hd)
    kf, vf = k.float(), v.float()
    scale = hd ** -0.5 * math.log2(math.e)
    vis_all = tfa.visible_mask(sq, skv, causal=causal, window=window,
                               kv_len=kv_len)
    m = torch.full((b, kvh, h // kvh, sq, 1), tfa.NEG_INF)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, kvh, h // kvh, sq, hd))
    for k0 in range(0, skv, tfa.BLOCK_K):
        s = torch.einsum("bqngd,bknd->bngqk", qf,
                         kf[:, k0:k0 + tfa.BLOCK_K]) * scale
        s = s.masked_fill(~vis_all[:, k0:k0 + tfa.BLOCK_K], tfa.NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - torch.where(m_new == tfa.NEG_INF,
                                       torch.zeros_like(m_new), m_new))
        l = l * alpha + p.sum(-1, keepdim=True)
        if rescale:
            acc = acc * alpha
        acc = acc + torch.einsum("bngqk,bknd->bngqd",
                                 p.to(torch.bfloat16).float(),
                                 vf[:, k0:k0 + tfa.BLOCK_K])
        m = m_new
    out = (acc / l.clamp_min(1e-30)).permute(0, 3, 1, 2, 4)
    out = out.reshape(b, sq, h, hd).contiguous()
    if store == "truncate":
        out = (out.view(torch.int32) & ~0xFFFF).view(torch.float32)
    return out.to(torch.bfloat16)


def _prefill_checks(got, q, k, v, **kw):
    """(check (a) ratio, check (b) bias) of a bf16 prefill output."""
    qf, kf, vf = q.float(), k.float(), v.float()
    want = tfa.flash_attention_plain(qf, kf, vf, **kw)
    want_abs_v = tfa.flash_attention_plain(qf, kf, vf.abs(), **kw)
    return (_check.bf16_prefill_ratio(got, want, want_abs_v, 1e-5),
            _check.bf16_rounding_bias(got, want))


# |bias| limit of check (b): rounding to nearest reads about 0 and
# truncation about -1 (chip_smoke.py holds the same limit).
BIAS_LIMIT = 0.25
# danube's head width and group (hd = 120, G = 4) at a short window, and
# a ragged tail (S not a multiple of the 64-key tile) with kv_len < Skv.
EMULATED = [((1, 150, 150, 8, 2, 120), dict(causal=True, window=33)),
            ((2, 150, 150, 8, 2, 120), dict(causal=True, window=0,
                                            kv_len=131))]


@pytest.mark.parametrize("shape,kw", EMULATED)
def test_prefill_checks_pass_the_tensor_core_arithmetic(shape, kw):
    q, k, v = (_torch(x) for x in _inputs(*shape, "bfloat16", sum(shape)))
    ratio, bias = _prefill_checks(emulate_tc_prefill(q, k, v, **kw),
                                  q, k, v, **kw)
    assert ratio <= 1.0
    assert abs(bias) <= BIAS_LIMIT


@pytest.mark.parametrize("shape,kw", EMULATED)
def test_prefill_bias_check_catches_truncation(shape, kw):
    q, k, v = (_torch(x) for x in _inputs(*shape, "bfloat16", sum(shape)))
    _, bias = _prefill_checks(
        emulate_tc_prefill(q, k, v, store="truncate", **kw), q, k, v, **kw)
    assert bias < -BIAS_LIMIT


@pytest.mark.parametrize("shape,kw", EMULATED)
def test_prefill_ratio_check_catches_a_missing_rescale(shape, kw):
    q, k, v = (_torch(x) for x in _inputs(*shape, "bfloat16", sum(shape)))
    ratio, _ = _prefill_checks(
        emulate_tc_prefill(q, k, v, rescale=False, **kw), q, k, v, **kw)
    assert ratio > 1.0


@pytest.mark.parametrize("sq", [2, 63, 64, 5000])
def test_bf16_prefill_always_takes_the_tensor_cores(sq):
    """Every bf16 call with Sq > 1 routes to the tensor-core kernel, which
    takes every accepted head width within the shared-memory limit (the
    decode kernel's sizes come from the library: the card test checks
    them)."""
    assert tfa.route(torch.bfloat16, sq) == "prefill_tc"
    assert tfa.route(torch.float32, sq) == "prefill_f32"
    assert tfa.route(torch.bfloat16, 1) == tfa.route(torch.float32, 1) \
        == "decode"
    for hd in range(8, tfa.MAX_HEAD_DIM + 1, 8):
        tfa.check_smem(tfa.tc_smem_bytes(hd), "prefill_tc")


def test_f32_prefill_smem_fits_every_width():
    """The f32 prefill's shared memory (``f32_smem_bytes``, the mirror of
    the C entry ``flash_attention_fwd_f32_smem``, which the card checks)
    fits the H100 at every accepted width: two 64-row q tiles and two
    stages of 64 keys up to hd 128, one tile and three or two stages of
    32 keys past it."""
    for hd in range(8, tfa.MAX_HEAD_DIM + 1, 8):
        assert 0 < tfa.f32_smem_bytes(hd) <= tfa.SMEM_LIMIT, hd
        assert tfa.f32_boxes(hd) in (2, 4, 6, 8)
        assert 32 * tfa.f32_boxes(hd) >= hd
    assert tfa.f32_smem_bytes(64) == 164936
    assert tfa.f32_smem_bytes(120) == tfa.f32_smem_bytes(128) == 197672
    assert tfa.f32_smem_bytes(160) == 197688
    assert tfa.f32_smem_bytes(256) == 197672


def test_shared_memory_over_the_limit_raises():
    """The widest head fits the tensor-core prefill; a byte over 227 KB
    raises before any launch."""
    assert tfa.tc_smem_bytes(256) <= tfa.SMEM_LIMIT
    tfa.check_smem(tfa.SMEM_LIMIT, "prefill_tc")
    with pytest.raises(ValueError, match="shared memory"):
        tfa.check_smem(tfa.SMEM_LIMIT + 1, "prefill_tc")


def test_tma_strides_must_be_multiples_of_16_bytes():
    """danube's K/V (hd 120, 8 KV heads) is fine; a 12-wide bf16 row
    (24 bytes) cannot be described to TMA."""
    assert tfa.tma_strides((120, 8, 5000, 4), 2) == [240, 1920,
                                                      1920 * 5000]
    with pytest.raises(ValueError, match="multiple of 16"):
        tfa.tma_strides((12, 1, 5, 1), 2)


# Decode blocks an H100 SM holds (the occupancy calculator's answer for
# bf16, read on the card by chip_smoke.py): 3 at danube's G = 4, hd = 120;
# 2 with 8 query heads a block or wider rows; 4 at hd 64.
@pytest.mark.parametrize("b,kvh,kv_len,causal,grp,per_sm", [
    (4, 8, 4096, False, 4, 3),     # path 6's decode
    (3, 8, 61, False, 5, 2),
    (1, 1, 32768, False, 4, 2),
    (2, 8, 300, False, 4, 2),
    (1, 2, 100, True, 1, 4),
])
def test_decode_splits_cover_every_tile_once(b, kvh, kv_len, causal, grp,
                                             per_sm):
    sms = 132
    chunks = -(-grp // tfa.decode_rows(grp))
    splits, per = tfa.decode_splits(b, kvh, kv_len, causal, sms, chunks,
                                    per_sm)
    hi = min(kv_len, 1) if causal else kv_len
    tiles = math.ceil(hi / tfa.DECODE_BLOCK_K)
    covered = [t for s in range(splits) for t in range(s * per,
                                                       min(tiles,
                                                           (s + 1) * per))]
    assert covered == list(range(tiles))
    assert all(s * per < tiles for s in range(splits))   # none empty
    assert splits <= tfa.MAX_DECODE_SPLITS
    assert b * kvh * chunks * splits <= per_sm * sms     # one wave


def test_decode_splits_give_every_sm_two_blocks_at_path_6():
    """B = 4, 8 KV heads of 4 query heads, a 4096-slot bf16 cache on the
    H100's 132 SMs, which hold 3 such blocks each."""
    splits, per = tfa.decode_splits(4, 8, 4096, False, 132, 1, 3)
    assert 4 * 8 * splits >= 2 * 132
    assert splits * per * tfa.DECODE_BLOCK_K >= 4096


ON_CARD = [((2, 130, 130, 8, 2, 120), dict(causal=True, window=50)),
           ((1, 77, 200, 4, 4, 64), dict(causal=False, window=0,
                                         kv_len=150)),
           ((3, 1, 300, 32, 8, 160), dict(causal=False, window=0,
                                          kv_len=257))]
# hd 120 / 128 / 160 x G 1 / 4 / 5 at prefill (Sq not a tile multiple,
# a short window) and decode.
ON_CARD += [((1, 97, 97, 5 * g, 5, hd), dict(causal=True, window=33))
            for hd in (120, 128, 160) for g in (1, 4, 5)]
ON_CARD += [((2, 1, 333, 5 * g, 5, hd), dict(causal=False, window=0,
                                             kv_len=300))
            for hd in (120, 128, 160) for g in (1, 4, 5)]
# A cache shorter than the decode kernel's K ring (3 tiles of 32 keys):
# slots of the ring are never loaded, and at hd = 120 the mma's last
# k-step reads past each row.
ON_CARD += [((2, 1, 96, 8, 2, 120), dict(causal=False, window=0, kv_len=70)),
            ((1, 1, 40, 4, 1, 120), dict(causal=False, window=0))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_on_card(cuda_device, dtype):
    """Prefill (tail not a tile multiple, window), Sq != Skv with
    kv_len, and the decode kernel (Sq = 1, grouped heads), each launch
    through the kernel of its route.  f32 within 1e-5 of the plain
    version.  bf16 decode within half a bf16 ulp of the plain version's
    f32 answer plus that 1e-5 (f32 arithmetic, rounded to nearest once at
    the store).  bf16 prefill (tensor cores, p rounded to bf16): checks
    (a) and (b) of ``_check``.  Each launch follows a fill of every SM's
    shared memory with NaN, and the keys past ``kv_len`` are NaN, so a
    read of stale shared memory or of a masked key shows."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    for (b, sq, skv, h, kv, hd), kw in ON_CARD:
        q = torch.randn((b, sq, h, hd), generator=gen, device=cuda_device)
        k = torch.randn((b, skv, kv, hd), generator=gen, device=cuda_device)
        v = torch.randn((b, skv, kv, hd), generator=gen, device=cuda_device)
        q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
        k[:, kw.get("kv_len", skv):] = float("nan")
        route = tfa.route(dtype, sq)
        before = tfa.flash_attention.launches
        routed = tfa.flash_attention.route_launches[route]
        _check.fill_shared_memory(cuda_device)
        got = tfa.flash_attention(q, k, v, **kw)
        assert tfa.flash_attention.launches == before + 1
        assert tfa.flash_attention.route_launches[route] == routed + 1
        want = tfa.flash_attention_plain(q.float(), k.float(), v.float(),
                                         **kw)
        torch.cuda.synchronize()
        assert bool(got.isfinite().all())
        if dtype == torch.float32:
            assert float((got - want).abs().max()) <= 1e-5
        elif route == "prefill_tc":
            ratio, bias = _prefill_checks(got, q, k, v, **kw)
            assert ratio <= 1.0 and abs(bias) <= BIAS_LIMIT
        else:
            assert _check.bf16_rounding_ratio(got, want, 1e-5) <= 1.0
    with pytest.raises(ValueError):
        tfa.flash_attention(q[..., :12].contiguous(), k[..., :12].contiguous(),
                            v[..., :12].contiguous())


def test_decode_shared_memory_and_blocks_on_card(cuda_device):
    """The decode kernel's shared memory (asked of the library) fits at
    every accepted head width and group, an SM holds at least one block,
    and the SM counts the CPU tests of ``decode_splits`` assume hold."""
    lib = _build.library()
    for hd in range(8, tfa.MAX_HEAD_DIM + 1, 8):
        for grp in (1, 4, 5, 8, 64):
            for code in (0, 1):
                tfa.check_smem(lib.flash_attention_decode_smem(code, grp, hd),
                               "decode")
                assert lib.flash_attention_decode_blocks(code, grp, hd) >= 1
    assert lib.flash_attention_decode_blocks(1, 4, 120) == 3
    assert lib.flash_attention_decode_blocks(1, 4, 64) == 4
    assert lib.flash_attention_decode_blocks(1, 5, 128) == 2

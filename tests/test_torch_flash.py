"""The port's flash attention: plain version against the JAX reference.

``repro_torch.kernels.flash_attention`` holds the CUDA wrapper and its
plain PyTorch version.  On the CPU the wrapper computes the plain
version; these tests hold it against the reference's oracle
(``repro.kernels.ref.flash_attention``, f32 and bf16, causal / window /
non-causal, grouped-query heads, ``Sq != Skv``) and against the Pallas
kernel in interpret mode with a ``kv_len`` validity mask, on the same
numpy-seeded inputs.  The CUDA launches are checked by the test that
takes the ``cuda_device`` fixture, which skips without a card.
"""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import flash_attention as jfa  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import _check  # noqa: E402
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_on_card(cuda_device, dtype):
    """Prefill (tail not a tile multiple, window), Sq != Skv with
    kv_len, and the decode kernel (Sq = 1, grouped heads).  f32 within
    1e-5 of the plain version; bf16 within half a bf16 ulp of the plain
    version's f32 answer plus that 1e-5 (f32 arithmetic, rounded to
    nearest once at the store)."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    cases = [((2, 130, 130, 8, 2, 120), dict(causal=True, window=50)),
             ((1, 77, 200, 4, 4, 64), dict(causal=False, window=0,
                                           kv_len=150)),
             ((3, 1, 300, 32, 8, 160), dict(causal=False, window=0,
                                            kv_len=257))]
    for (b, sq, skv, h, kv, hd), kw in cases:
        q = torch.randn((b, sq, h, hd), generator=gen, device=cuda_device)
        k = torch.randn((b, skv, kv, hd), generator=gen, device=cuda_device)
        v = torch.randn((b, skv, kv, hd), generator=gen, device=cuda_device)
        q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
        before = tfa.flash_attention.launches
        got = tfa.flash_attention(q, k, v, **kw)
        assert tfa.flash_attention.launches == before + 1
        want = tfa.flash_attention_plain(q.float(), k.float(), v.float(),
                                         **kw)
        torch.cuda.synchronize()
        if dtype == torch.bfloat16:
            assert _check.bf16_rounding_ratio(got, want, 1e-5) <= 1.0
        else:
            assert float((got - want).abs().max()) <= 1e-5
    with pytest.raises(ValueError):
        tfa.flash_attention(q[..., :12].contiguous(), k[..., :12].contiguous(),
                            v[..., :12].contiguous())

"""The f32 flash kernels' split-precision TF32 arithmetic, on the CPU.

The f32 routes of ``repro_torch.kernels.flash_attention`` (``prefill_f32``
and ``backward``) take every product on the tensor cores as split TF32
(``csrc/flash_tf32.cuh``): each f32 operand x is split into hi =
tf32(x) and lo = tf32(x - hi), both rounded to nearest with ties away
from zero (``cvt.rna``), and a . b is hi_a hi_b + hi_a lo_b + lo_a hi_b,
three TF32 products summed in f32.  Softmax, the lse, D and every sum
stay f32.  These tests emulate that arithmetic in plain torch and hold
it against the plain versions within the f32 routes' limits: the
forward's output within 1e-5 and its lse within 1e-4, the gradients
within 1e-4 of each gradient's largest.  One TF32 product (hi_a hi_b
alone) misses the output's and the gradients' limits, which is why the
kernels split.

The emulated forward runs the prefill's key tiles (64 keys up to hd 128,
32 past it), its online softmax in log2 units and one division at the
end; the emulated backward takes each product over all keys at once (the
order of f32 sums is not what it checks).  Neither models the tensor
cores' accumulation inside one product, which truncates: the kernels
keep it to one tile and add the tiles in f32 registers, and only the
card can show that this holds (chip_smoke.py's 4,500-key window edge
check and the card tests hold the kernels themselves to the same
limits).  No JAX.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as tfa  # noqa: E402

# The f32 routes' limits (chip_smoke.py's FLASH_TOL, FLASH_LSE_TOL and
# FLASH_BWD_TOL["float32"]).
OUT_TOL = 1e-5
LSE_TOL = 1e-4
GRAD_TOL = 1e-4

# danube's heads (G = 4, hd 120) under a binding window; hd 256 with
# kv_len < Skv; G = 1 cross-attention at hd 64 (64 rows against 300 keys).
SHAPES = [((1, 300, 300, 8, 2, 120), dict(causal=True, window=64)),
          ((1, 200, 220, 4, 2, 256), dict(causal=True, window=0,
                                          kv_len=190)),
          ((2, 64, 300, 4, 4, 64), dict(causal=False, window=0))]


@pytest.fixture(autouse=True)
def one_thread():
    """Small shapes: one intra-op thread, so the test workers that share
    the machine do not oversubscribe its cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32's 10 mantissa bits, to nearest with ties away
    from zero (PTX ``cvt.rna.tf32.f32``): half of the 13 dropped bits'
    range added to the magnitude, then the 13 bits cleared."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    hi = round_tf32(x)
    return hi, round_tf32(x - hi)


def product(eq: str, a: torch.Tensor, b: torch.Tensor,
            terms: int = 3) -> torch.Tensor:
    """``einsum(eq, a, b)`` as the kernels take it: three TF32 products
    of the split operands (the small terms summed apart, as the kernels'
    second accumulator chain), or ``terms=1``, hi_a hi_b alone."""
    ah, al = split(a.float())
    bh, bl = split(b.float())
    big = torch.einsum(eq, ah, bh)
    if terms == 1:
        return big
    return big + (torch.einsum(eq, ah, bl) + torch.einsum(eq, al, bh))


def emulate_forward(q, k, v, *, causal, window, kv_len=None, terms=3):
    """The f32 prefill's arithmetic: (out, lse) in the plain version's
    layouts."""
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    grp = h // kvh
    kv_len = skv if kv_len is None else kv_len
    qf = q.float().reshape(b, sq, kvh, grp, hd)
    kf, vf = k.float(), v.float()
    scale_log2 = hd ** -0.5 * math.log2(math.e)
    vis_all = tfa.visible_mask(sq, skv, causal=causal, window=window,
                               kv_len=kv_len)
    # The prefill's key tiles: 64 keys up to hd 128 (four boxes), 32 past.
    block_k = 64 if tfa.f32_boxes(hd) <= 4 else 32
    m = torch.full((b, kvh, grp, sq, 1), tfa.NEG_INF)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, kvh, grp, sq, hd))
    for k0 in range(0, skv, block_k):
        s = product("bqngd,bknd->bngqk", qf, kf[:, k0:k0 + block_k],
                    terms) * scale_log2
        s = s.masked_fill(~vis_all[:, k0:k0 + block_k], tfa.NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - torch.where(m_new == tfa.NEG_INF,
                                       torch.zeros_like(m_new), m_new))
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + product("bngqk,bknd->bngqd", p,
                                    vf[:, k0:k0 + block_k], terms)
        m = m_new
    out = (acc / l.clamp_min(1e-30)).permute(0, 3, 1, 2, 4)
    lse = torch.where(l > 0, (m + torch.log2(l)) * math.log(2), math.inf)
    return (out.reshape(b, sq, h, hd).contiguous(),
            lse.reshape(b, h, sq))


def emulate_backward(q, k, v, o, lse, do, *, causal, window, kv_len=None,
                     terms=3):
    """The f32 backward's arithmetic: P = 2^(s scale log2 e - lse log2 e)
    where visible, D = rowsum(dO o) in f32, and the five products (the
    two score products again, dV, dK, dQ) split."""
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    grp = h // kvh
    kv_len = skv if kv_len is None else kv_len
    scale = hd ** -0.5
    qf = q.float().reshape(b, sq, kvh, grp, hd)
    dof = do.float().reshape(b, sq, kvh, grp, hd)
    kf, vf = k.float(), v.float()
    vis = tfa.visible_mask(sq, skv, causal=causal, window=window,
                           kv_len=kv_len)
    s = product("bqngd,bknd->bngqk", qf, kf, terms)
    lse2 = (lse * math.log2(math.e)).reshape(b, kvh, grp, sq, 1)
    p = torch.where(vis, torch.exp2(s * (scale * math.log2(math.e)) - lse2),
                    0.0)
    dv = product("bngqk,bqngd->bknd", p, dof, terms)
    delta = (dof * o.float().reshape(b, sq, kvh, grp, hd)).sum(-1)
    dp = product("bqngd,bknd->bngqk", dof, vf, terms)
    ds = torch.where(vis, p * (dp - delta.permute(0, 2, 3, 1)[..., None]),
                     0.0)
    dq = product("bngqk,bknd->bqngd", ds, kf, terms) * scale
    dk = product("bngqk,bqngd->bknd", ds, qf, terms) * scale
    return dq.reshape(b, sq, h, hd), dk, dv


def _inputs(shape, seed, grads=False):
    b, sq, skv, h, kvh, hd = shape
    rng = np.random.default_rng(seed)
    shapes = [(b, sq, h, hd), (b, skv, kvh, hd), (b, skv, kvh, hd)]
    if grads:
        shapes.append((b, sq, h, hd))
    return [torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
            for s in shapes]


def _forward_errors(shape, kw, terms):
    q, k, v = _inputs(shape, sum(shape))
    out, lse = emulate_forward(q, k, v, terms=terms, **kw)
    want, want_lse = tfa.flash_attention_plain(q, k, v, with_lse=True, **kw)
    blind = torch.isinf(want_lse)
    assert torch.equal(torch.isinf(lse), blind)
    lse_err = float(torch.where(blind, 0.0, lse - want_lse).abs().max())
    return float((out - want).abs().max()), lse_err


def test_round_tf32_is_round_to_nearest_ties_away():
    """10 mantissa bits kept; a tie (exactly half of the dropped range)
    goes away from zero; hi + lo holds x to about 2^-22 of it."""
    one = 1.0
    ulp = 2.0 ** -10
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 4,
                      one + 3 * ulp / 4, 3.0, -0.0])
    assert round_tf32(x).tolist() == [one + ulp, -(one + ulp), one,
                                      one + ulp, 3.0, -0.0]
    rng = np.random.default_rng(0)
    y = torch.from_numpy(rng.standard_normal(10000, dtype=np.float32) * 7)
    hi, lo = split(y)
    assert bool((hi.view(torch.int32) & 0x1FFF).eq(0).all())
    assert float(((hi + lo - y) / y).abs().max()) <= 2.0 ** -21


@pytest.mark.parametrize("shape,kw", SHAPES)
def test_split_forward_holds_the_f32_limits(shape, kw):
    out_err, lse_err = _forward_errors(shape, kw, terms=3)
    assert out_err <= OUT_TOL
    assert lse_err <= LSE_TOL


@pytest.mark.parametrize("shape,kw", SHAPES)
def test_split_backward_holds_the_f32_limit(shape, kw):
    """dq, dk, dv from the emulated forward's o and lse against the plain
    backward from the plain o and lse, each within 1e-4 of its largest
    magnitude."""
    q, k, v, do = _inputs(shape, sum(shape) + 1, grads=True)
    o, lse = emulate_forward(q, k, v, **kw)
    got = emulate_backward(q, k, v, o, lse, do, **kw)
    want_o, want_lse = tfa.flash_attention_plain(q, k, v, with_lse=True,
                                                 **kw)
    want = tfa.flash_attention_bwd_plain(q, k, v, want_o, want_lse, do,
                                         **kw)
    for g, w in zip(got, want):
        assert bool(g.isfinite().all())
        assert float((g - w).abs().max()) <= GRAD_TOL * float(w.abs().max())


def test_one_tf32_product_misses_the_limits():
    """hi_a hi_b alone (one rounded TF32 product, about what the tensor
    cores make of an f32 operand they truncate) misses the output limit
    at danube's heads by far, and the gradients' limit; the split holds
    both there."""
    shape, kw = SHAPES[0]
    one, _ = _forward_errors(shape, kw, terms=1)
    three, _ = _forward_errors(shape, kw, terms=3)
    assert one > 10 * OUT_TOL
    assert three <= OUT_TOL
    q, k, v, do = _inputs(shape, sum(shape) + 1, grads=True)
    o, lse = emulate_forward(q, k, v, terms=1, **kw)
    got = emulate_backward(q, k, v, o, lse, do, terms=1, **kw)
    want_o, want_lse = tfa.flash_attention_plain(q, k, v, with_lse=True,
                                                 **kw)
    want = tfa.flash_attention_bwd_plain(q, k, v, want_o, want_lse, do,
                                         **kw)
    assert max(float((g - w).abs().max()) / float(w.abs().max())
               for g, w in zip(got, want)) > GRAD_TOL

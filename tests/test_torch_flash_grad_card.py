"""The flash attention gradient on the card.

Every test needs a CUDA device and skips without one; the file imports
no JAX (``pytest tests/test_torch_flash_grad_card.py -k on_card``):

* the backward kernels against ``flash_attention_bwd_plain`` on the
  same q, k, v, o, lse and dO, in f32 and bf16, at the training shapes
  of the zoo: danube's (G = 4, hd 120, causal, a window that binds), G =
  8 at hd 128, whisper's cross-attention (G = 1, hd 64, Sq 64 != Skv
  1500, non-causal), hd 160 and 256, ``kv_len < Skv``, Sq below a tile
  and not a multiple of one, one query row (the prefill kernels, which
  write the lse, at any Sq) against G = 16 and G = 5, a ragged last
  packed tile at hd 120 (Sq 300, G = 4: 16 positions a tile) with
  ``kv_len`` 280, G = 64 at hd 64 (one position a packed tile), and the
  widths past 128 whose dK and dV come from two kernels: hd 136 (G = 5,
  a window, ``kv_len < Skv``), 192 (``kv_len < Skv``, Sq != Skv) and 256
  (G = 5, a window).  Each call launches once, through its
  ``bwd_route``: the tensor-core kernels
  (``csrc/flash_attention_bwd_tc.cu``, route ``backward_tc``) for bf16 at
  every width, the split-TF32 kernels (``csrc/flash_attention_bwd.cu``,
  route ``backward``) for f32.  The keys and values past ``kv_len`` are
  NaN for the kernels' forward (its output must stay finite) and
  backward, each launched after a NaN fill of shared memory (the plain
  version gets them zeroed: its products would carry the NaN through
  their zero weights).  f32 within 1e-4 and bf16 within 2e-2 of each
  gradient's largest magnitude;
* the forward's row log-sum-exp (both prefill kernels) against
  ``flash_attention_plain(..., with_lse=True)``, and +inf on rows that
  see no key;
* ``torch.autograd`` and ``torch.func.vmap(torch.func.grad(...))``
  through ``flash_attention``: one forward and one backward launch (the
  vmap rule folds the clients into the batch), equal to a loop of
  ``autograd.grad`` over the clients.
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _check  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402

# Of each gradient's largest magnitude: f32 sums in another order; bf16
# outputs rounded once (2^-9) plus P rounded to bf16 in dV.
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# The log-sum-exp in f32 from the two kernels' online max and sum.
LSE_TOL = 1e-4
# (B, Sq, Skv, H, KV, hd), masks.
SHAPES = [
    ((2, 256, 256, 32, 8, 120), dict(causal=True, window=0)),
    ((1, 256, 256, 8, 2, 120), dict(causal=True, window=64)),
    ((1, 200, 200, 16, 2, 128), dict(causal=True, window=0)),
    ((2, 64, 1500, 12, 12, 64), dict(causal=False, window=0)),
    ((1, 130, 130, 10, 2, 160), dict(causal=True, window=0)),
    ((1, 77, 100, 4, 1, 256), dict(causal=False, window=0, kv_len=90)),
    ((2, 40, 40, 6, 3, 64), dict(causal=True, window=0, kv_len=30)),
    ((1, 100, 100, 4, 4, 128), dict(causal=True, window=33)),
    ((2, 1, 50, 16, 1, 128), dict(causal=False, window=0)),
    ((3, 65, 65, 5, 1, 160), dict(causal=True, window=50)),
    ((2, 300, 300, 16, 4, 120), dict(causal=True, window=0, kv_len=280)),
    ((1, 70, 70, 64, 1, 64), dict(causal=True, window=0)),
    ((1, 150, 150, 10, 2, 136), dict(causal=True, window=40, kv_len=140)),
    ((2, 130, 140, 8, 2, 192), dict(causal=True, window=0, kv_len=120)),
    ((1, 200, 200, 10, 2, 256), dict(causal=True, window=64)),
]


@pytest.fixture
def cuda_device():
    """The CUDA card, or a skip: these tests run on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the flash kernels have no CPU "
                    "mode)")
    return torch.device("cuda")


def _inputs(dev, shape, dtype, seed):
    b, sq, skv, h, kv, hd = shape
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(s, generator=gen, device=dev).to(dtype)
            for s in ((b, sq, h, hd), (b, skv, kv, hd), (b, skv, kv, hd),
                      (b, sq, h, hd))]


def _rel(got, want) -> float:
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", range(len(SHAPES)))
def test_backward_kernel_matches_plain_on_card(cuda_device, dtype, case):
    shape, kw = SHAPES[case]
    q, k, v, do = _inputs(cuda_device, shape, dtype, case)
    kv_len = kw.get("kv_len", k.shape[1])
    k0, v0 = k.clone(), v.clone()
    k[:, kv_len:] = float("nan")
    v[:, kv_len:] = float("nan")
    _check.fill_shared_memory(cuda_device)
    o, lse = tfa._forward(q, k, v, kw["causal"], kw["window"], kv_len, True)
    assert bool(o.isfinite().all()) and not bool(lse.isnan().any())
    route = tfa.bwd_route(dtype, shape[-1])
    assert route == ("backward_tc" if dtype == torch.bfloat16
                     else "backward")
    routes = tfa.flash_attention.route_launches
    before = dict(routes)
    _check.fill_shared_memory(cuda_device)
    got = tfa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    assert {r: n - before[r] for r, n in routes.items()} == \
        {r: int(r == route) for r in routes}
    k0[:, kv_len:] = 0
    v0[:, kv_len:] = 0
    want = tfa.flash_attention_bwd_plain(q, k0, v0, o, lse, do, **kw)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == dtype and g.shape == w.shape, name
        assert bool(g.isfinite().all()), name
        assert _rel(g, w) <= TOL[dtype], (name, _rel(g, w))
    assert not bool(got[1][:, kv_len:].any())
    assert not bool(got[2][:, kv_len:].any())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_forward_lse_on_card(cuda_device, dtype):
    for i, (shape, kw) in enumerate(SHAPES):
        q, k, v, _ = _inputs(cuda_device, shape, dtype, 100 + i)
        kw = dict(kw, kv_len=kw.get("kv_len", k.shape[1]))
        _, lse = tfa._forward(q, k, v, kw["causal"], kw["window"],
                              kw["kv_len"], True)
        _, want = tfa.flash_attention_plain(q, k, v, with_lse=True, **kw)
        torch.testing.assert_close(lse, want, rtol=0, atol=LSE_TOL)
    # kv_len 0: no row sees a key.
    q, k, v, _ = _inputs(cuda_device, (1, 70, 70, 4, 2, 64), dtype, 7)
    _, lse = tfa._forward(q, k, v, True, 0, 0, True)
    assert bool((lse == float("inf")).all())


def test_autograd_and_vmap_grad_launch_once_on_card(cuda_device):
    n, b, s, h, kv, hd = 3, 2, 96, 8, 2, 64
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    x = torch.randn((n, b, s, h, hd), generator=gen, device=cuda_device)
    k = torch.randn((n, b, s, kv, hd), generator=gen, device=cuda_device)
    v = torch.randn((n, b, s, kv, hd), generator=gen, device=cuda_device)
    w = torch.randn((hd, hd), generator=gen, device=cuda_device) / 8

    def loss(w, x, k, v):
        out = tfa.flash_attention(x @ w, k, v, causal=True, window=40)
        return (out * out).sum()

    routes = tfa.flash_attention.route_launches
    before = dict(routes)
    got = torch.func.vmap(torch.func.grad(loss),
                          in_dims=(None, 0, 0, 0))(w, x, k, v)
    torch.cuda.synchronize()
    assert routes["prefill_f32"] == before["prefill_f32"] + 1
    assert routes["backward"] == before["backward"] + 1
    want = torch.stack([torch.autograd.grad(
        loss(w.requires_grad_(), x[i], k[i], v[i]), w)[0] for i in range(n)])
    assert routes["backward"] == before["backward"] + 1 + n
    assert _rel(got, want) <= 1e-5

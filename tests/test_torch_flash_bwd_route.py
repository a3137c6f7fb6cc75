"""The flash backward's two routes, on the CPU (no JAX).

``flash_attention.bwd_route`` names the kernel that serves a backward on
the card: ``backward_tc`` (``csrc/flash_attention_bwd_tc.cu``, wgmma)
for bf16 at every width the forward serves (multiples of 8 up to 256),
``backward`` (``csrc/flash_attention_bwd.cu``, split TF32 on the tensor
cores) for f32.  Both routes' shared memory (``bwd_tc_smem_bytes`` and
``bwd_smem_bytes``, the mirrors of the C entries
``flash_attention_bwd_tc_smem`` and ``flash_attention_bwd_smem``) fits
the H100 at every width, and each route has its launch count.  CPU tensors take the
plain backward whatever the route; the kernels themselves are held
against it on the card (``tests/test_torch_flash_grad_card.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as tfa  # noqa: E402

# Every width the forward serves.
HEAD_DIMS = tuple(range(8, 257, 8))


@pytest.fixture
def one_thread():
    """Tiny shapes: one intra-op thread, so the test workers that share
    the machine do not oversubscribe its cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("hd", HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_route_by_dtype_and_width(one_thread, dtype, hd):
    want = "backward_tc" if dtype == torch.bfloat16 else "backward"
    assert tfa.bwd_route(dtype, hd) == want


def test_bwd_tc_smem_fits_every_width_it_serves(one_thread):
    served = [hd for hd in range(8, tfa.MAX_HEAD_DIM + 1, 8)
              if tfa.bwd_route(torch.bfloat16, hd) == "backward_tc"]
    assert served == list(HEAD_DIMS)
    for hd in served:
        assert 0 < tfa.bwd_tc_smem_bytes(hd) <= tfa.SMEM_LIMIT, hd
    # One box of 64 columns: 4 stages; two boxes: 3 (one dK / dV kernel).
    assert tfa.bwd_tc_smem_bytes(64) == 101448
    assert tfa.bwd_tc_smem_bytes(120) == tfa.bwd_tc_smem_bytes(128) == 166456
    # Past two boxes the largest is the dV kernel's (K of two warpgroups):
    # 3 stages at three boxes, 2 at four.
    assert tfa.bwd_tc_smem_bytes(160) == 199224
    assert tfa.bwd_tc_smem_bytes(256) == 198696
    with pytest.raises(ValueError, match="up to 256"):
        tfa.bwd_tc_smem_bytes(264)


@pytest.mark.parametrize("which", ["prefill_tc", "prefill_f32",
                                   "backward_tc", "backward"])
def test_packed_routes_take_at_most_64_heads_a_group(which):
    """Every route but decode packs (position, head) pairs into 64-row
    tiles, the f32 ones as the bf16 ones: a group of 64 query heads per
    KV head fits, 65 raises before any launch; decode takes any group."""
    tfa.check_group(tfa.MAX_TC_GROUP, which)
    with pytest.raises(ValueError, match="query heads per KV head"):
        tfa.check_group(tfa.MAX_TC_GROUP + 1, which)
    tfa.check_group(tfa.MAX_TC_GROUP + 1, "decode")


def test_bwd_f32_smem_fits_every_width(one_thread):
    """The f32 backward's larger kernel fits at every width: up to hd 128
    the dK / dV kernel (K and V of 128 keys, three q + dO stages of 32
    positions with their (lse, D) pairs); past it K and V of 64 keys and
    stages of 16 positions, or the dQ kernel."""
    for hd in HEAD_DIMS:
        assert tfa.bwd_route(torch.float32, hd) == "backward"
        assert 0 < tfa.bwd_smem_bytes(hd) <= tfa.SMEM_LIMIT, hd
    assert tfa.bwd_smem_bytes(64) == 133192
    assert tfa.bwd_smem_bytes(120) == tfa.bwd_smem_bytes(128) == 231224
    assert tfa.bwd_smem_bytes(160) == 198216
    assert tfa.bwd_smem_bytes(256) == 230840
    # The (lse, D) scratch: Sq rounded up to 64 positions a (b, head).
    assert [tfa.lsd_rows(s) for s in (1, 64, 65, 1024)] == [64, 64, 128,
                                                            1024]


@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_bwd_tc_width_covers_hd(one_thread, hd):
    """Each width runs the instantiation of the next of 64, 128, 160, 192
    and 256 at or above it (columns past hd are zeros)."""
    width = tfa.bwd_tc_width(hd)
    assert width in (64, 128, 160, 192, 256) and width >= hd
    assert not [w for w in (64, 128, 160, 192, 256) if hd <= w < width]


def test_route_launches_count_both_backward_routes(one_thread):
    routes = tfa.flash_attention.route_launches
    assert {"backward", "backward_tc"} <= set(routes)
    assert set(routes) == {"prefill_tc", "prefill_f32", "decode", "backward",
                           "backward_tc"}


@pytest.mark.parametrize("hd", [64, 120, 160, 256])
def test_cpu_backward_is_the_plain_version_on_either_route(one_thread, hd):
    """A CPU call launches nothing and gives the plain backward, in bf16
    at widths the card serves with dK and dV in one kernel (64, 120) and
    in two (160, 256)."""
    rng = np.random.default_rng(hd)
    b, sq, h, kvh = 2, 37, 8, 2
    q, do = (torch.from_numpy(rng.standard_normal((b, sq, h, hd),
                                                  dtype=np.float32))
             .to(torch.bfloat16) for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((b, sq, kvh, hd),
                                                 dtype=np.float32))
            .to(torch.bfloat16) for _ in range(2))
    kw = dict(causal=True, window=0, kv_len=30)
    o, lse = tfa.flash_attention_plain(q, k, v, with_lse=True, **kw)
    before = dict(tfa.flash_attention.route_launches)
    got = tfa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    want = tfa.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    assert tfa.flash_attention.route_launches == before
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        assert torch.equal(g, w)
    # Keys past kv_len get no gradient.
    assert not bool(got[1][:, 30:].any()) and not bool(got[2][:, 30:].any())

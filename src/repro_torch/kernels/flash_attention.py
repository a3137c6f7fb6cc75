"""Flash attention forward: (B, Sq, H, hd) x (B, Skv, KV, hd) -> same as q.

Replaces the TPU kernel ``flash_attention_kernel`` (body ``_flash_kernel``)
of ``src/repro/kernels/flash_attention.py`` and the layout work of
``ops.flash_attention``.  It takes the model's layout directly and maps q
head ``h`` to KV head ``h // (H // KV)`` by index (no repeated K/V, no
transpose).  A key is visible where ``k < kv_len``, ``k <= q`` if
``causal`` and ``k > q - window`` if ``window > 0``, with q and k
positions both counted from 0: right for prefill (``Sq == Skv``); decode
passes ``causal=False`` and the cache's valid length as ``kv_len``.  A row
with no visible key gives 0.  Scores, softmax and sums are f32; the
output is in the input type (f32 or bf16).

Three routes on the card (:func:`route`), each with its launch count in
``flash_attention.route_launches``:

* ``prefill_tc`` — bf16, ``Sq > 1``: ``csrc/flash_attention_tc.cu``, on
  the tensor cores (``wgmma``; K/V by TMA into a ring of shared-memory
  stages, each tile shared by a KV head's query group).  Bound by
  operations.  p is rounded to bf16 for the ``p . v`` product, as the
  reference's model path does; :func:`repro_torch.kernels._check.
  bf16_prefill_ratio` and ``bf16_rounding_bias`` are its checks.
* ``prefill_f32`` — f32, ``Sq > 1``: ``csrc/flash_attention.cu``, on the
  CUDA cores in f32 (the 1e-5 limit rules out TF32 tensor cores).
* ``decode`` — ``Sq == 1``, either type: ``csrc/flash_attention.cu``, one
  block per KV head and kv split with the query group together, K/V tiles
  in the input type by TMA into a ring of stages (bf16 scores on the
  tensor cores, p . v in f32 on the CUDA cores); the splits of a KV head
  form one thread block cluster, which merges them.  Bound by bytes.

The gradient (training): with grad enabled and q, k or v requiring it,
:func:`flash_attention` goes through ``_FlashAttention``, a
``torch.autograd.Function`` whose forward is the prefill route of its
type with each row's log-sum-exp written beside the output, and whose
backward is :func:`flash_attention_bwd`, on one of two routes
(:func:`bwd_route`), both bound by operations:

* ``backward_tc`` — bf16, every width the forward serves:
  ``csrc/flash_attention_bwd_tc.cu``, every product on the tensor cores
  (``wgmma``), q / dO and K / V tiles by TMA, dS rounded to bf16 as a
  product's operand.  Past hd 128 dV and dK come from two kernels (a
  64-key warpgroup's two accumulators and two score tiles would exceed
  its 240 registers).
* ``backward`` — f32: ``csrc/flash_attention_bwd.cu``, on the CUDA cores
  in f32.

The reference has no backward kernel: it differentiates its plain
attention, which the CPU route here does in
:func:`flash_attention_bwd_plain`.  Both
Functions carry a ``vmap`` rule that folds the mapped axis into B, so the
federated step's ``torch.func.vmap(torch.func.grad(...))`` launches each
kernel once for all its clients.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import _build, _check

# Tensors that take the plain versions: the CPU's, and shape-only
# ``meta`` ones (the dry-run planner runs a step on them; they hold no
# data, so nothing is computed and nothing is hidden).  A CUDA tensor
# launches the kernel or raises.
PLAIN_DEVICES = ("cpu", "meta")

NEG_INF = -1e30
BLOCK_K = 64            # keys per prefill tile, as in the CUDA sources
DECODE_BLOCK_K = 32     # keys per decode tile
MAX_HEAD_DIM = 256
# The tensor-core prefill packs (q position, head) pairs into 64 rows.
MAX_TC_GROUP = 64
# Shared memory a block may ask for on the H100 (227 KB).
SMEM_LIMIT = 232448
# The decode kernel's most splits of one (batch, KV head): they form one
# thread block cluster.
MAX_DECODE_SPLITS = 16
# Strides of a TMA tensor map: multiples of 16 bytes, below 2**40.
TMA_STRIDE_ALIGN = 16
TMA_STRIDE_LIMIT = 2 ** 40
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def route(dtype: torch.dtype, sq: int, with_lse: bool = False) -> str:
    """The kernel that serves a call on the card: ``decode`` for one
    query row (unless the rows' log-sum-exp is wanted, which only the
    prefill kernels write), else ``prefill_tc`` in bf16 and
    ``prefill_f32`` in f32."""
    if sq == 1 and not with_lse:
        return "decode"
    return "prefill_tc" if dtype == torch.bfloat16 else "prefill_f32"


def bwd_route(dtype: torch.dtype, hd: int) -> str:
    """The backward kernel that serves a call on the card at any width
    ``hd`` the forward serves: ``backward_tc`` for bf16, ``backward`` for
    f32."""
    return "backward_tc" if dtype == torch.bfloat16 else "backward"


def tc_smem_bytes(hd: int) -> int:
    """Dynamic shared memory of the tensor-core prefill (its ``TcCfg``):
    1024 bytes of alignment slack, two warpgroups' q tiles and a ring of
    K + V stages (4, 3 or 2 as hd takes 1-2, 3 or 4 boxes), in boxes of 64
    rows x 128 bytes per 64 columns of hd, and the mbarriers."""
    boxes = -(-hd // 64)
    stages = 4 if boxes <= 2 else (3 if boxes == 3 else 2)
    box = 64 * 128
    return 1024 + 2 * boxes * box + stages * 2 * boxes * box \
        + 8 * (1 + 2 * stages)


def bwd_smem_bytes(hd: int) -> int:
    """Dynamic shared memory of the backward's dK / dV kernel, the larger
    of its two: f32 tiles of K and V (64 keys up to hd 128, 32 past it)
    and of q and dO (64 rows), rows of hd + 4 floats, the P and dS tiles
    (rows of 68 floats) and 64 lse and D values."""
    rows = 64 if hd <= 128 else 32
    return 4 * ((2 * rows + 2 * BLOCK_K) * (hd + 4)
                + 2 * rows * (BLOCK_K + 4) + 2 * BLOCK_K)


def bwd_tc_width(hd: int) -> int:
    """The width the tensor-core backward's instantiation for ``hd``
    covers (its ``Width``): 64, 128, 160, 192 or 256."""
    if not 0 < hd <= MAX_HEAD_DIM:
        raise ValueError(f"the tensor-core backward serves hd up to "
                         f"{MAX_HEAD_DIM}, not {hd}")
    return next(w for w in (64, 128, 160, 192, 256) if hd <= w)


def bwd_tc_smem_bytes(hd: int) -> int:
    """Dynamic shared memory of the tensor-core backward, the largest of
    its kernels at ``hd`` (the C entry ``flash_attention_bwd_tc_smem``):
    1024 bytes of alignment slack, resident tiles, a ring of stages and
    the mbarriers, in boxes of 64 rows x 128 bytes per 64 columns of
    :func:`bwd_tc_width`.  Up to hd 128 the dK / dV kernel (K and V of two
    warpgroups, 4 or 3 q + dO stages with 512 bytes of (lse, D) pairs
    each) and the dQ kernel (q and dO, as many K + V stages); past it the
    dV kernel (K only), the dK kernel (K and V) and the dQ kernel, each
    with the most stages, up to 3, that fit :data:`SMEM_LIMIT`."""
    boxes = -(-bwd_tc_width(hd) // 64)
    box, lsd = 64 * 128, 512
    stage = 2 * boxes * box

    def smem(fixed: int, per: int, stages: int) -> int:
        return 1024 + fixed + stages * per + 8 * (1 + 2 * stages)

    if boxes <= 2:
        return smem(4 * boxes * box, stage + lsd, 4 if boxes == 1 else 3)
    sizes = []
    for fixed, per in ((2 * boxes * box, stage + lsd),   # dV
                       (4 * boxes * box, stage + lsd),   # dK
                       (4 * boxes * box, stage)):        # dQ
        stages = 3
        while stages > 1 and smem(fixed, per, stages) > SMEM_LIMIT:
            stages -= 1
        sizes.append(smem(fixed, per, stages))
    return max(sizes)


def decode_rows(group: int) -> int:
    """Query heads per decode block: 4, or 8 where a KV head has more
    (then ``ceil(group / 8)`` blocks share its kv split)."""
    return 4 if group <= 4 else 8


def check_smem(n_bytes: int, what: str) -> None:
    """Raise before a launch that would ask for more than 227 KB."""
    if n_bytes > SMEM_LIMIT:
        raise ValueError(f"{what} needs {n_bytes} bytes of shared memory, "
                         f"over the H100's {SMEM_LIMIT}")


def tma_strides(dims: tuple, itemsize: int) -> list:
    """Byte strides of dims 1.. of a dense tensor map (dims innermost
    first); raise unless each is a multiple of 16 below 2**40."""
    strides, stride = [], itemsize
    for d in dims[:-1]:
        stride *= d
        strides.append(stride)
    for st in strides:
        if st % TMA_STRIDE_ALIGN or st >= TMA_STRIDE_LIMIT:
            raise ValueError(f"TMA stride {st} bytes of dims {dims} is not "
                             f"a multiple of {TMA_STRIDE_ALIGN} below 2**40")
    return strides


def visible_mask(sq: int, skv: int, *, causal: bool, window: int,
                 kv_len: int, device=None) -> torch.Tensor:
    """(Sq, Skv) bool: where a query row sees a key."""
    q_pos = torch.arange(sq, device=device)[:, None]
    k_pos = torch.arange(skv, device=device)[None, :]
    vis = (k_pos < kv_len).expand(sq, skv)
    if causal:
        vis = vis & (k_pos <= q_pos)
    if window > 0:
        vis = vis & (k_pos > q_pos - window)
    return vis


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int = 0,
                          kv_len: Optional[int] = None, with_lse: bool = False
                          ):
    """Plain version: a port of ``kernels/ref.py::flash_attention``
    extended to the kernel's signature (``kv_len``, grouped-query heads
    by index, ``Sq != Skv``); a row with no visible key gives 0.  With
    ``with_lse``, returns (out, lse): lse (B, H, Sq) f32 is each row's
    log-sum-exp of its visible scaled scores ``q . k / sqrt(hd)``, +inf
    for a row that sees no key (what the kernels write for the
    backward)."""
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    grp = h // kvh
    kv_len = skv if kv_len is None else kv_len
    qf = q.float().reshape(b, sq, kvh, grp, hd)
    s = torch.einsum("bqngd,bknd->bngqk", qf, k.float()) * hd ** -0.5
    vis = visible_mask(sq, skv, causal=causal, window=window, kv_len=kv_len,
                       device=q.device)
    s = s.masked_fill(~vis, NEG_INF)
    seen = vis.any(dim=-1)
    p = torch.softmax(s, dim=-1) * seen[:, None]
    out = torch.einsum("bngqk,bknd->bqngd", p, v.float())
    out = out.reshape(b, sq, h, hd).to(q.dtype)
    if not with_lse:
        return out
    lse = torch.where(seen, torch.logsumexp(s, dim=-1), math.inf)
    return out, lse.reshape(b, h, sq)


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, o: torch.Tensor,
                              lse: torch.Tensor, do: torch.Tensor, *,
                              causal: bool = True, window: int = 0,
                              kv_len: Optional[int] = None
                              ) -> tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """Plain version of the backward: (dq, dk, dv) in the inputs' types.
    ``P = exp(s - lse)`` where visible (0 elsewhere), ``D = rowsum(dO o)``,
    ``dv = P'^T dO`` with P' = P rounded to the input type (bf16: the
    reference rounds its probabilities to v's type before ``p . v``),
    ``dS = P (dO v^T - D)``, ``dq = dS k / sqrt(hd)``, ``dk = dS^T q /
    sqrt(hd)``, all in f32; a KV head's gradient sums its query group."""
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    grp = h // kvh
    kv_len = skv if kv_len is None else kv_len
    scale = hd ** -0.5
    qf = q.float().reshape(b, sq, kvh, grp, hd)
    dof = do.float().reshape(b, sq, kvh, grp, hd)
    kf, vf = k.float(), v.float()
    s = torch.einsum("bqngd,bknd->bngqk", qf, kf) * scale
    vis = visible_mask(sq, skv, causal=causal, window=window, kv_len=kv_len,
                       device=q.device)
    p = torch.where(vis, torch.exp(s - lse.reshape(b, kvh, grp, sq, 1)), 0.0)
    dv = torch.einsum("bngqk,bqngd->bknd", p.to(q.dtype).float(), dof)
    delta = (dof * o.float().reshape(b, sq, kvh, grp, hd)).sum(-1)
    dp = torch.einsum("bqngd,bknd->bngqk", dof, vf)
    ds = torch.where(vis, p * (dp - delta.permute(0, 2, 3, 1)[..., None]),
                     0.0)
    dq = torch.einsum("bngqk,bknd->bqngd", ds, kf) * scale
    dk = torch.einsum("bngqk,bqngd->bknd", ds, qf) * scale
    return (dq.reshape(b, sq, h, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def visible_pairs(sq: int, *, causal: bool, window: int, kv_len: int) -> int:
    """The number of visible (q, k) pairs of one head: the work the
    kernel must do for these inputs."""
    total = 0
    for qp in range(sq):
        hi = min(kv_len, qp + 1) if causal else kv_len
        lo = max(0, qp - window + 1) if window > 0 else 0
        total += max(0, hi - lo)
    return total


def decode_splits(batch: int, kv_heads: int, kv_len: int, causal: bool,
                  sms: int, chunks: int = 1, per_sm: int = 2,
                  max_splits: int = 16) -> tuple[int, int]:
    """(splits, tiles per split) of the decode kernel on a card of
    ``sms`` SMs that each hold ``per_sm`` blocks, with ``chunks`` blocks
    per (batch, KV head) and split: the kv tiles are split into as many
    blocks as the card holds at once (where there are the tiles), at most
    ``max_splits`` (the splits of a chunk are one thread block cluster:
    at most 16, and no more than lets every chunk's cluster be resident
    at once), every tile in exactly one split."""
    hi = min(kv_len, 1) if causal else kv_len
    tiles = max(1, math.ceil(hi / DECODE_BLOCK_K))
    want = max(1, min(max_splits,
                      per_sm * sms // (batch * kv_heads * chunks)))
    per = math.ceil(tiles / min(tiles, want))
    return math.ceil(tiles / per), per


_SMS: dict = {}
_BLOCKS_PER_SM: dict = {}
_MAX_SPLITS: dict = {}


def _sm_count(device: torch.device) -> int:
    """The card's SM count, read once per device."""
    key = device.index if device.index is not None \
        else torch.cuda.current_device()
    if key not in _SMS:
        _SMS[key] = torch.cuda.get_device_properties(key).multi_processor_count
    return _SMS[key]


def _decode_blocks_per_sm(lib, device: torch.device, dtype: torch.dtype,
                          grp: int, hd: int) -> int:
    """Decode blocks an SM holds at once, asked of the CUDA occupancy
    calculator once per shape after the kernel's shared memory is checked
    against :data:`SMEM_LIMIT`."""
    key = (_sm_count(device), dtype, grp, hd)
    if key not in _BLOCKS_PER_SM:
        code = _DTYPE_CODE[dtype]
        check_smem(lib.flash_attention_decode_smem(code, grp, hd), "decode")
        n = lib.flash_attention_decode_blocks(code, grp, hd)
        _build.check(max(0, -n), "flash_attention (block query)")
        if n == 0:
            raise RuntimeError(f"no decode block (G {grp}, hd {hd}, "
                               f"{dtype}) fits an SM")
        _BLOCKS_PER_SM[key] = n
    return _BLOCKS_PER_SM[key]


def _decode_max_splits(lib, device: torch.device, dtype: torch.dtype,
                       grp: int, hd: int, clusters: int) -> int:
    """The most splits (<= 16) whose ``clusters`` thread block clusters
    the card holds all at once, asked of the CUDA occupancy calculator
    once per shape; 1 if no cluster of two or more fits them all."""
    key = (_sm_count(device), dtype, grp, hd, clusters)
    if key not in _MAX_SPLITS:
        best = 1
        for splits in range(MAX_DECODE_SPLITS, 1, -1):
            fit = lib.flash_attention_decode_clusters(
                _DTYPE_CODE[dtype], grp, hd, splits)
            if fit < 0:
                _build.check(-fit, "flash_attention (cluster query)")
            if fit >= clusters:
                best = splits
                break
        _MAX_SPLITS[key] = best
    return _MAX_SPLITS[key]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    kv_len: Optional[int] = None) -> torch.Tensor:
    """Softmax attention with causal / sliding-window / validity masks.

    q: (B, Sq, H, hd); k, v: (B, Skv, KV, hd), ``H % KV == 0``;
    ``kv_len`` (default ``Skv``) is a host int.  CPU and meta tensors take
    :func:`flash_attention_plain`; CUDA tensors launch the kernel of
    :func:`route` (f32 or bf16, contiguous, 16-byte aligned, ``hd`` a
    multiple of 8 up to 256) or raise.  With grad enabled and q, k or v
    requiring grad the call is differentiable (``_FlashAttention``): on
    the card its forward takes the prefill route of its type, whatever
    Sq, and its backward :func:`flash_attention_bwd`.
    """
    kv_len = k.shape[1] if kv_len is None else int(kv_len)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, window, kv_len)[0]
    return _forward(q, k, v, causal, window, kv_len, False)[0]


def _check_shapes(q: torch.Tensor, k: torch.Tensor, kv_len: int) -> None:
    """Raise on what no flash kernel takes."""
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash_attention takes f32 or bf16, got {q.dtype}")
    if hd % 8 or not 0 < hd <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim {hd} must be a multiple of 8 up to "
                         f"{MAX_HEAD_DIM}")
    if kvh < 1 or h % kvh:
        raise ValueError(f"{h} query heads do not group over {kvh} KV heads")
    if not 0 <= kv_len <= skv:
        raise ValueError(f"kv_len {kv_len} outside [0, {skv}]")
    if b * h > 65535:
        raise ValueError(f"batch x heads {b * h} exceeds the grid's 65535")


def _check_operands(named: dict, q: torch.Tensor, k: torch.Tensor) -> None:
    """Raise unless each of ``named`` (name -> tensor, q-like or k-like by
    its name) is a contiguous, 16-byte aligned tensor of q's type on q's
    device."""
    for name, t in named.items():
        shape = q.shape if name in ("q", "o", "do") else k.shape
        _check.cuda_operand(name, t, q.dtype, tuple(shape), q.device)
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             causal: bool, window: int, kv_len: int, with_lse: bool
             ) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The output and, ``with_lse``, each row's log-sum-exp (B, H, Sq) f32
    (as :func:`flash_attention_plain` gives it): plain on the CPU; on the
    card one launch of :func:`route`'s kernel, or with the lse of the
    prefill kernel of the type at any Sq (the decode kernel writes
    none)."""
    if q.device.type in PLAIN_DEVICES:
        got = flash_attention_plain(q, k, v, causal=causal, window=window,
                                    kv_len=kv_len, with_lse=with_lse)
        return got if with_lse else (got, None)
    _check_shapes(q, k, kv_len)
    _check_operands({"q": q, "k": k, "v": v}, q, k)
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    dev = q.device
    grp = h // kvh
    which = route(q.dtype, sq, with_lse)
    if which == "decode":
        tma_strides((hd, kvh, skv, b), k.element_size())
    elif which == "prefill_tc":
        if grp > MAX_TC_GROUP:
            raise ValueError(f"{grp} query heads per KV head exceed the "
                             f"tensor-core kernel's {MAX_TC_GROUP}")
        tma_strides((hd, grp, kvh, sq, b), q.element_size())
        tma_strides((hd, kvh, skv, b), k.element_size())
        check_smem(tc_smem_bytes(hd), "prefill_tc")
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=dev) \
        if with_lse else None
    if out.numel() == 0:
        return out, lse
    lib = _build.library()
    stream = _check.stream_handle(dev)
    scale = hd ** -0.5
    if which == "decode":
        chunks = -(-grp // decode_rows(grp))
        splits, per = decode_splits(
            b, kvh, kv_len, causal, _sm_count(dev), chunks,
            _decode_blocks_per_sm(lib, dev, q.dtype, grp, hd),
            _decode_max_splits(lib, dev, q.dtype, grp, hd, b * kvh * chunks))
        err = lib.flash_attention_decode(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPE_CODE[q.dtype], b, skv, h, kvh, hd, kv_len, int(causal),
            int(window), scale, splits, per, stream)
    else:
        entry = lib.flash_attention_fwd_tc if which == "prefill_tc" \
            else lib.flash_attention_fwd_f32
        err = entry(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    None if lse is None else lse.data_ptr(), b, sq, skv, h,
                    kvh, hd, kv_len, int(causal), int(window), scale, stream)
    _build.check(err, f"flash_attention ({which})")
    flash_attention.launches += 1
    flash_attention.route_launches[which] += 1
    return out, lse


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        kv_len: Optional[int] = None
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of :func:`flash_attention` at (q, k, v) with output
    ``o``, its rows' log-sum-exp ``lse`` (B, H, Sq) f32 and the output's
    gradient ``do``.  CPU and meta tensors take
    :func:`flash_attention_bwd_plain`; CUDA tensors launch the kernel of
    :func:`bwd_route` (the checks of the forward; o and do as q,
    contiguous) or raise.  One launch on the
    card is counted in ``flash_attention.launches`` and under its
    route."""
    kv_len = k.shape[1] if kv_len is None else int(kv_len)
    if q.device.type in PLAIN_DEVICES:
        return flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                         window=window, kv_len=kv_len)
    _check_shapes(q, k, kv_len)
    _check_operands({"q": q, "k": k, "v": v, "o": o, "do": do}, q, k)
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    grp = h // kvh
    _check.cuda_operand("lse", lse, torch.float32, (b, h, sq), q.device)
    which = bwd_route(q.dtype, hd)
    if which == "backward_tc":
        if grp > MAX_TC_GROUP:
            raise ValueError(f"{grp} query heads per KV head exceed the "
                             f"tensor-core backward's {MAX_TC_GROUP}")
        tma_strides((hd, grp, kvh, sq, b), q.element_size())
        tma_strides((hd, kvh, skv, b), k.element_size())
        check_smem(bwd_tc_smem_bytes(hd), which)
    else:
        check_smem(bwd_smem_bytes(hd), which)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if q.numel() == 0 or k.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    lib = _build.library()
    pointers = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                do.data_ptr(), lse.data_ptr())
    outs = (dq.data_ptr(), dk.data_ptr(), dv.data_ptr())
    masks = (kv_len, int(causal), int(window), hd ** -0.5,
             _check.stream_handle(q.device))
    if which == "backward_tc":
        # (lse log2 e, D) of each packed row: 64 rows a tile of 64 // grp
        # positions x the grp heads of a KV head.
        tiles = -(-sq // (64 // grp))
        scratch = torch.empty((b, kvh, tiles, 64, 2), dtype=torch.float32,
                              device=q.device)
        err = lib.flash_attention_bwd_tc(*pointers, scratch.data_ptr(),
                                         *outs, b, sq, skv, h, kvh, hd,
                                         *masks)
    else:
        delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
        err = lib.flash_attention_bwd(*pointers, delta.data_ptr(), *outs,
                                      b, sq, skv, h, kvh, hd, *masks)
    _build.check(err, f"flash_attention ({which})")
    flash_attention.launches += 1
    flash_attention.route_launches[which] += 1
    return dq, dk, dv


def _fold(info, in_dims, tensors) -> list:
    """Under ``vmap``: each tensor with its mapped axis (broadcast where
    it has none) folded into its leading axis B."""
    n = info.batch_size
    out = []
    for t, d in zip(tensors, in_dims):
        t = t.expand((n,) + tuple(t.shape)) if d is None else t.movedim(d, 0)
        out.append(t.reshape((n * t.shape[1],) + tuple(t.shape[2:])))
    return out


def _unfold(t: torch.Tensor, n: int) -> torch.Tensor:
    return t.reshape((n, t.shape[0] // n) + tuple(t.shape[1:]))


class _FlashAttention(torch.autograd.Function):
    """(out, lse) of :func:`_forward`, differentiable in q, k and v
    (``setup_context`` form, as ``torch.func`` requires)."""

    @staticmethod
    def forward(q, k, v, causal, window, kv_len):
        return _forward(q, k, v, causal, window, kv_len, True)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, causal, window, kv_len = inputs
        out, lse = output
        ctx.mark_non_differentiable(lse)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.masks = (causal, window, kv_len)

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _FlashAttentionBwd.apply(q, k, v, out, lse, dout,
                                              *ctx.masks)
        return dq, dk, dv, None, None, None

    @staticmethod
    def vmap(info, in_dims, q, k, v, causal, window, kv_len):
        n = info.batch_size
        out, lse = _FlashAttention.apply(*_fold(info, in_dims[:3], (q, k, v)),
                                         causal, window, kv_len)
        return (_unfold(out, n), _unfold(lse, n)), (0, 0)


class _FlashAttentionBwd(torch.autograd.Function):
    """(dq, dk, dv) of :func:`flash_attention_bwd`: a Function so that
    the backward, which runs on batched tensors under ``vmap(grad)``, has
    a ``vmap`` rule too.  Not differentiable itself."""

    @staticmethod
    def forward(q, k, v, o, lse, do, causal, window, kv_len):
        return flash_attention_bwd(q, k, v, o, lse, do.contiguous(),
                                   causal=causal, window=window,
                                   kv_len=kv_len)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError("flash_attention has no second derivative")

    @staticmethod
    def vmap(info, in_dims, q, k, v, o, lse, do, causal, window, kv_len):
        n = info.batch_size
        grads = _FlashAttentionBwd.apply(
            *_fold(info, in_dims[:6], (q, k, v, o, lse, do)), causal, window,
            kv_len)
        return tuple(_unfold(g, n) for g in grads), (0, 0, 0)


flash_attention.launches = 0
flash_attention.route_launches = dict.fromkeys(
    ("prefill_tc", "prefill_f32", "decode", "backward", "backward_tc"), 0)

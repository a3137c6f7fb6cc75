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
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import _build, _check

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


def route(dtype: torch.dtype, sq: int) -> str:
    """The kernel that serves a call on the card: ``decode`` for one
    query row, else ``prefill_tc`` in bf16 and ``prefill_f32`` in f32."""
    if sq == 1:
        return "decode"
    return "prefill_tc" if dtype == torch.bfloat16 else "prefill_f32"


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
                          kv_len: Optional[int] = None) -> torch.Tensor:
    """Plain version: a port of ``kernels/ref.py::flash_attention``
    extended to the kernel's signature (``kv_len``, grouped-query heads
    by index, ``Sq != Skv``); a row with no visible key gives 0."""
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    grp = h // kvh
    kv_len = skv if kv_len is None else kv_len
    qf = q.float().reshape(b, sq, kvh, grp, hd)
    s = torch.einsum("bqngd,bknd->bngqk", qf, k.float()) * hd ** -0.5
    vis = visible_mask(sq, skv, causal=causal, window=window, kv_len=kv_len,
                       device=q.device)
    s = s.masked_fill(~vis, NEG_INF)
    p = torch.softmax(s, dim=-1) * vis.any(dim=-1, keepdim=True)
    out = torch.einsum("bngqk,bknd->bqngd", p, v.float())
    return out.reshape(b, sq, h, hd).to(q.dtype)


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
    ``kv_len`` (default ``Skv``) is a host int.  CPU tensors take
    :func:`flash_attention_plain`; CUDA tensors launch the kernel of
    :func:`route` (f32 or bf16, contiguous, 16-byte aligned, ``hd`` a
    multiple of 8 up to 256) or raise.
    """
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     kv_len=kv_len)
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    kv_len = skv if kv_len is None else int(kv_len)
    dev = q.device
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
    _check.cuda_operand("q", q, q.dtype, (b, sq, h, hd), dev)
    _check.cuda_operand("k", k, q.dtype, (b, skv, kvh, hd), dev)
    _check.cuda_operand("v", v, q.dtype, (b, skv, kvh, hd), dev)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    grp = h // kvh
    which = route(q.dtype, sq)
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
    if out.numel() == 0:
        return out
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
                    b, sq, skv, h, kvh, hd, kv_len, int(causal), int(window),
                    scale, stream)
    _build.check(err, f"flash_attention ({which})")
    flash_attention.launches += 1
    flash_attention.route_launches[which] += 1
    return out


flash_attention.launches = 0
flash_attention.route_launches = dict.fromkeys(
    ("prefill_tc", "prefill_f32", "decode"), 0)

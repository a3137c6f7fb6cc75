"""Flash attention forward: (B, Sq, H, hd) x (B, Skv, KV, hd) -> same as q.

Replaces the TPU kernel ``flash_attention_kernel`` (body ``_flash_kernel``)
of ``src/repro/kernels/flash_attention.py`` and the layout work of
``ops.flash_attention``.  CUDA source: ``csrc/flash_attention.cu``.  It
takes the model's layout directly and maps q head ``h`` to KV head
``h // (H // KV)`` by index (no repeated K/V, no transpose).  Scores
``(q * hd**-0.5) k^T``, softmax and ``p . v`` are f32; the output is in
the input type (f32 or bf16).  A key is visible where ``k < kv_len``,
``k <= q`` if ``causal`` and ``k > q - window`` if ``window > 0``, with
q and k positions both counted from 0: right for prefill (``Sq == Skv``);
decode passes ``causal=False`` and the cache's valid length as
``kv_len``.  A row with no visible key gives 0.

Two launches on the card: a prefill kernel (one block per 64-row q tile
of one head; kv tiles that hold no visible key are skipped) and, for
``Sq == 1``, a decode kernel (one block per KV head and kv split, all the
query heads of the group together) followed by a small combine kernel.
Bound on the H100: by operations at prefill, by bytes at decode.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import _build, _check

NEG_INF = -1e30
BLOCK_K = 64            # keys per tile, as in the CUDA source
MAX_HEAD_DIM = 256
# The decode kernel keeps at most 8 x 128 float4 accumulators per block.
MAX_GROUP_WIDTH = 8 * 128 * 4
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


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
                  device: torch.device) -> tuple[int, int]:
    """(splits, tiles per split) of the decode kernel: enough blocks of
    one (batch, KV head) each to give every SM two."""
    hi = min(kv_len, 1) if causal else kv_len
    tiles = max(1, math.ceil(hi / BLOCK_K))
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    want = max(1, math.ceil(2 * sms / (batch * kv_heads)))
    per = math.ceil(tiles / min(tiles, want))
    return math.ceil(tiles / per), per


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    kv_len: Optional[int] = None) -> torch.Tensor:
    """Softmax attention with causal / sliding-window / validity masks.

    q: (B, Sq, H, hd); k, v: (B, Skv, KV, hd), ``H % KV == 0``;
    ``kv_len`` (default ``Skv``) is a host int.  CPU tensors take
    :func:`flash_attention_plain`; CUDA tensors launch the kernel (f32 or
    bf16, contiguous, ``hd`` a multiple of 8 up to 256) or raise.
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
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = _build.library()
    stream = _check.stream_handle(dev)
    scale = hd ** -0.5
    code = _DTYPE_CODE[q.dtype]
    if sq == 1:
        grp = h // kvh
        if grp * hd > MAX_GROUP_WIDTH:
            raise ValueError(f"{grp} query heads of width {hd} per KV head "
                             f"exceed the decode kernel's {MAX_GROUP_WIDTH}")
        splits, per = decode_splits(b, kvh, kv_len, causal, dev)
        rows = b * kvh * splits * grp
        part_m = torch.empty((rows,), dtype=torch.float32, device=dev)
        part_l = torch.empty((rows,), dtype=torch.float32, device=dev)
        part_acc = torch.empty((rows, hd), dtype=torch.float32, device=dev)
        err = lib.flash_attention_decode(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            part_m.data_ptr(), part_l.data_ptr(), part_acc.data_ptr(), code,
            b, skv, h, kvh, hd, kv_len, int(causal), int(window), scale,
            splits, per, stream)
    else:
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), code,
            b, sq, skv, h, kvh, hd, kv_len, int(causal), int(window), scale,
            stream)
    _build.check(err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0

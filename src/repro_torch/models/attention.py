"""GQA attention: full-sequence (training/prefill) path + cached decode.

Port of ``repro.models.attention``:

* grouped-query attention (``num_kv_heads`` <= ``num_heads``)
* per-head q/k RMS normalization (Qwen3 ``qk_norm``) and projection bias
* RoPE, partial rotary (StableLM), M-RoPE (Qwen2-VL), or none (Whisper's
  absolute positions are added at the embedding)
* sliding-window masking (Mistral/Danube SWA)
* cross-attention (Whisper's decoder) against K/V computed once from the
  encoder output (:func:`cross_kv`)

Every path computes through the ``flash_attention`` kernel (the
reference's q-chunked softmax and its masked softmax over the cache are
the same function): on the card the CUDA kernel, on the CPU its plain
version.  The kernel maps query heads to KV heads by index, so K/V are
never repeated.

Decode attends one query token against a (B, S_max, KV, hd) cache and
writes the new K/V into it **in place** (the reference returns a new
cache): at full width a copy of every layer's cache per token would
move more bytes than the attention reads.  Cross-attention decode
attends the whole encoder K/V, which it never writes.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import common
from repro_torch.models.config import ModelConfig

Params = Dict[str, torch.Tensor]


def init(gen: torch.Generator, cfg: ModelConfig,
         groups: Tuple[int, ...] = (), cross: bool = False) -> Params:
    """Projection weights (``dtype_params``), with leading ``groups``
    dims when stacked over layers; ``cross`` (cross-attention) has no
    q/k norm."""
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    h, kv = cfg.num_heads, cfg.num_kv_heads
    dt = common.dtype_of(cfg.dtype_params)
    p: Params = {
        "wq": common.dense_init(gen, groups + (d, h * hd), d, dt),
        "wk": common.dense_init(gen, groups + (d, kv * hd), d, dt),
        "wv": common.dense_init(gen, groups + (d, kv * hd), d, dt),
        "wo": common.dense_init(gen, groups + (h * hd, d), h * hd, dt),
    }
    if cfg.use_bias:
        p["bq"] = common.filled(groups + (h * hd,), 0.0, dt)
        p["bk"] = common.filled(groups + (kv * hd,), 0.0, dt)
        p["bv"] = common.filled(groups + (kv * hd,), 0.0, dt)
        p["bo"] = common.filled(groups + (d,), 0.0, dt)
    if cfg.qk_norm and not cross:
        p["q_norm"] = common.filled(groups + (hd,), 1.0)
        p["k_norm"] = common.filled(groups + (hd,), 1.0)
    return p


def _project_qkv(p: Params, x: torch.Tensor, cfg: ModelConfig
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x -> q (B,S,H,hd), k, v (B,S,KV,hd)."""
    hd = cfg.resolved_head_dim
    dt = x.dtype
    q = x @ p["wq"].to(dt)
    k = x @ p["wk"].to(dt)
    v = x @ p["wv"].to(dt)
    if cfg.use_bias:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    q = q.reshape(*q.shape[:2], cfg.num_heads, hd)
    k = k.reshape(*k.shape[:2], cfg.num_kv_heads, hd)
    v = v.reshape(*v.shape[:2], cfg.num_kv_heads, hd)
    if cfg.qk_norm:
        q = common.rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = common.rmsnorm(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


def _project_q(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """x -> q (B,S,H,hd) of cross-attention: no RoPE and no q-norm."""
    q = x @ p["wq"].to(x.dtype)
    if cfg.use_bias:
        q = q + p["bq"].to(x.dtype)
    return q.reshape(*q.shape[:2], cfg.num_heads, cfg.resolved_head_dim)


def _maybe_rope(q: torch.Tensor, k: torch.Tensor,
                positions: Optional[torch.Tensor], cfg: ModelConfig
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """M-RoPE over (3, B, S) positions, (partial) RoPE over (B, S), or
    nothing under absolute positions."""
    if cfg.pos_embedding != "rope" or positions is None:
        return q, k
    hd = cfg.resolved_head_dim
    if cfg.mrope_sections:
        sin, cos = common.mrope_sin_cos(positions, hd, cfg.rope_theta,
                                        cfg.mrope_sections)
    else:
        sin, cos = common.rope_sin_cos(positions, hd, cfg.rope_theta,
                                       cfg.rope_fraction)
    return common.apply_rope(q, sin, cos), common.apply_rope(k, sin, cos)


def _out_proj(p: Params, out: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    out = out.reshape(*out.shape[:2], -1) @ p["wo"].to(out.dtype)
    if cfg.use_bias:
        out = out + p["bo"].to(out.dtype)
    return out


def attend_full(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                cfg: ModelConfig, causal: Optional[bool] = None,
                window: int = 0) -> torch.Tensor:
    """q: (B, Sq, H, hd); k, v: (B, Skv, KV, hd) -> (B, Sq, H, hd);
    ``causal`` defaults to ``cfg.causal``."""
    causal = cfg.causal if causal is None else causal
    return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           causal=causal, window=window)


def forward(p: Params, x: torch.Tensor, cfg: ModelConfig,
            positions: Optional[torch.Tensor], layer_window: bool,
            kv_override: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
            causal: Optional[bool] = None, return_kv: bool = False):
    """Attention over a full sequence.  Returns
    ``(out, (k, v) if return_kv else None)``; k is after RoPE.
    ``kv_override`` supplies precomputed (k, v) for cross-attention
    (:func:`cross_kv`): its query takes no RoPE and no q-norm, and
    ``causal`` defaults to False."""
    if kv_override is None:
        q, k, v = _project_qkv(p, x, cfg)
        q, k = _maybe_rope(q, k, positions, cfg)
    else:
        q = _project_q(p, x, cfg)
        k, v = kv_override
        causal = False if causal is None else causal
    window = cfg.sliding_window if layer_window else 0
    out = _out_proj(p, attend_full(q, k, v, cfg, causal=causal,
                                   window=window), cfg)
    return (out, (k, v)) if return_kv else (out, None)


def cross_kv(p: Params, enc_out: torch.Tensor, cfg: ModelConfig
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-attention K/V (B, S_enc, KV, hd) from the encoder output,
    computed once at prefill."""
    hd = cfg.resolved_head_dim
    dt = enc_out.dtype
    k = enc_out @ p["wk"].to(dt)
    v = enc_out @ p["wv"].to(dt)
    if cfg.use_bias:
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    return (k.reshape(*k.shape[:2], cfg.num_kv_heads, hd),
            v.reshape(*v.shape[:2], cfg.num_kv_heads, hd))


# ---------------------------------------------------------------------------
# Decode (one token, KV cache)
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
               device=None, groups: Tuple[int, ...] = ()
               ) -> Dict[str, torch.Tensor]:
    """Zero cache; SWA layers are given only the window by the caller."""
    shape = groups + (batch, max_len, cfg.num_kv_heads,
                      cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def decode(p: Params, x: torch.Tensor, cache: Dict[str, torch.Tensor],
           index: int, cfg: ModelConfig, layer_window: bool,
           cross_cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
           ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode.  x: (B, 1, D); ``index`` (a host int) is the
    absolute position of the new token.  SWA layers keep a ring buffer
    (slot ``index % max_len``), others a padded cache (slot
    ``min(index, max_len - 1)``).  Either way the valid slots are the
    first ``min(index + 1, max_len)``, and softmax over the cache does not
    care about slot order, so the kernel sees ``causal=False`` and that
    length as ``kv_len``.  The cache is updated in place and returned.
    With ``cross_cache`` (the encoder's (k, v)) the query attends all of
    it, non-causal, and ``cache`` is returned untouched."""
    if cross_cache is not None:
        k, v = cross_cache
        out = flash_attention(_project_q(p, x, cfg).contiguous(), k, v,
                              causal=False, window=0, kv_len=k.shape[1])
        return _out_proj(p, out, cfg), cache
    shape = (3, x.shape[0], 1) if cfg.mrope_sections else (x.shape[0], 1)
    positions = torch.full(shape, index, dtype=torch.long, device=x.device)
    q, k_new, v_new = _project_qkv(p, x, cfg)
    q, k_new = _maybe_rope(q, k_new, positions, cfg)
    k, v = cache["k"], cache["v"]
    max_len = k.shape[1]
    is_ring = bool(layer_window and cfg.sliding_window > 0)
    slot = index % max_len if is_ring else min(index, max_len - 1)
    k[:, slot] = k_new[:, 0].to(k.dtype)
    v[:, slot] = v_new[:, 0].to(v.dtype)
    out = flash_attention(q.contiguous(), k, v, causal=False, window=0,
                          kv_len=min(index + 1, max_len))
    return _out_proj(p, out, cfg), cache

"""Selective state-space mixer (Mamba) in the SSD formulation.

Port of ``repro.models.ssm``.  Plain PyTorch throughout: the reference
has no Pallas kernel here.  The SSD (Mamba-2) form has a scalar decay
per head, so the sequence mixing is chunked ``(L x L)`` products plus a
small state carried across chunks.  Recurrence per head (head dim ``p``,
state dim ``n``)::

    a_t = exp(-softplus(dt_t + dt_bias) * exp(A_log))        # scalar decay
    h_t = a_t * h_{t-1} + dt_t * B_t  x_t^T                  # (n, p) state
    y_t = C_t^T h_t + D * x_t

Block: in_proj -> [z | x | B | C | dt]; causal depthwise conv on x; SSD
mix; RMSNorm; gate by silu(z); out_proj.  ``dt_bias``, ``A_log``, ``D``
and ``norm`` are f32 and read in f32 (``D`` in the compute dtype in
:func:`forward`, in f32 in :func:`decode`, as the reference does).
Initializers take an explicit ``torch.Generator`` and leading ``groups``
dims for the layer stack, and make their tensors on the default device,
as ``transformer.init`` sets it.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import common
from repro_torch.models.config import ModelConfig

Params = Dict[str, torch.Tensor]
State = Dict[str, torch.Tensor]

# Masked (above-diagonal) log decays, set before exp: there they are
# positive and large, and exp would overflow.
MASKED_LOG_DECAY = -1e30


def init(gen: torch.Generator, cfg: ModelConfig,
         groups: Tuple[int, ...] = ()) -> Params:
    d = cfg.d_model
    din = cfg.ssm_d_inner
    n = cfg.ssm_state_dim
    nh = cfg.ssm_num_heads
    dt = common.dtype_of(cfg.dtype_params)
    # dt bias: softplus^-1 of U[1e-3, 1e-1] (the Mamba init).
    u = torch.empty(groups + (nh,)).uniform_(1e-3, 1e-1, generator=gen)
    return {
        "wz": common.dense_init(gen, groups + (d, din), d, dt),
        "wx": common.dense_init(gen, groups + (d, din), d, dt),
        "wB": common.dense_init(gen, groups + (d, n), d, dt),
        "wC": common.dense_init(gen, groups + (d, n), d, dt),
        "wdt": common.dense_init(gen, groups + (d, nh), d, dt),
        "dt_bias": u + torch.log(-torch.expm1(-u)),
        "A_log": torch.log(torch.empty(groups + (nh,)).uniform_(
            1.0, 16.0, generator=gen)),
        "D": common.filled(groups + (nh,), 1.0),
        "conv": common.dense_init(gen, groups + (cfg.ssm_conv_dim, din),
                                  cfg.ssm_conv_dim, dt),
        "norm": common.filled(groups + (din,), 1.0),
        "wo": common.dense_init(gen, groups + (din, d), din, dt),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv: x (B, S, C), w (K, C) -> (B, S, C), summed
    tap by tap in x's dtype as the reference does."""
    k, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros_like(x)
    for j in range(k):
        out = out + xp[:, j:j + s] * w[j].to(x.dtype)
    return out


def _ssd_chunked(xh: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                 log_a: torch.Tensor, dt_s: torch.Tensor, chunk: int,
                 h0: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked scalar-decay SSD.

    xh: (B, S, nh, p) head inputs; b, c: (B, S, n) input / output
    projections (shared across heads); log_a: (B, S, nh) per-step log
    decay (<= 0); dt_s: (B, S, nh) step sizes; h0: (B, nh, n, p) initial
    state.  Returns (y (B, S, nh, p) in xh's dtype, final state (B, nh,
    n, p) f32).  The chunk doubles while there are more than 64 chunks,
    and one chunk covers the sequence where the chunk does not divide it,
    as in the reference.
    """
    bsz, s, nh, p = xh.shape
    n = b.shape[-1]
    while s // chunk > 64:
        chunk *= 2
    if s % chunk:
        chunk = s
    f32 = torch.float32
    h = (torch.zeros((bsz, nh, n, p), dtype=f32, device=xh.device)
         if h0 is None else h0.to(f32))
    tri = torch.ones((chunk, chunk), dtype=torch.bool,
                     device=xh.device).tril()[None, :, :, None]
    ys = []
    for start in range(0, s, chunk):
        sl = slice(start, start + chunk)
        xc = xh[:, sl].to(f32)                       # (B, L, nh, p)
        bc = b[:, sl].to(f32)                        # (B, L, n)
        cc = c[:, sl].to(f32)                        # (B, L, n)
        dts = dt_s[:, sl].to(f32)                    # (B, L, nh)
        cum = torch.cumsum(log_a[:, sl].to(f32), dim=1)
        # Intra-chunk: M[t, s'] = (C_t . B_s') exp(cum_t - cum_s') dt_s'.
        cb = torch.einsum("btn,bsn->bts", cc, bc)    # (B, L, L)
        decay = cum[:, :, None, :] - cum[:, None, :, :]
        w = torch.exp(torch.where(tri, decay, MASKED_LOG_DECAY))
        m = cb[..., None] * w * dts[:, None, :, :]   # (B, L, L, nh)
        y_intra = torch.einsum("btsh,bshp->bthp", m, xc)
        # Inter-chunk: y[t] = C_t . (exp(cum_t) h_prev).
        y_inter = torch.einsum("btn,bhnp->bthp", cc, h) \
            * torch.exp(cum)[..., None]
        ys.append(y_intra + y_inter)
        # State: h = exp(cum_L) h + sum_s exp(cum_L - cum_s) dt_s B_s x_s^T.
        w_state = torch.exp(cum[:, -1:, :] - cum) * dts
        h = (torch.exp(cum[:, -1])[:, :, None, None] * h
             + torch.einsum("bsh,bsn,bshp->bhnp", w_state, bc, xc))
    y = torch.cat(ys, dim=1) if len(ys) > 1 else ys[0]
    return y.to(xh.dtype), h


def _step_sizes(p: Params, dt_raw: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """dt_raw (..., nh) -> (softplus(dt_raw + dt_bias), its log decay
    -dt * exp(A_log)), f32."""
    dt_s = F.softplus(dt_raw.float() + p["dt_bias"])
    return dt_s, -dt_s * torch.exp(p["A_log"])


def _gate_out(p: Params, y: torch.Tensor, z: torch.Tensor,
              cfg: ModelConfig) -> torch.Tensor:
    y = common.rmsnorm(y, p["norm"], cfg.norm_eps)
    return (y * F.silu(z)) @ p["wo"].to(y.dtype)


def forward(p: Params, x: torch.Tensor, cfg: ModelConfig,
            return_state: bool = False):
    """The full-sequence Mamba block.  x: (B, S, D) -> (out (B, S, D),
    ``{"h": (B, nh, n, p) f32, "conv": (B, K - 1, d_inner)}`` or None)."""
    bsz, s, _ = x.shape
    nh, hp = cfg.ssm_num_heads, cfg.ssm_head_dim
    dt = x.dtype
    z = x @ p["wz"].to(dt)
    xin = F.silu(_causal_conv(x @ p["wx"].to(dt), p["conv"]))
    b = x @ p["wB"].to(dt)
    c = x @ p["wC"].to(dt)
    dt_s, log_a = _step_sizes(p, x @ p["wdt"].to(dt))
    xh = xin.reshape(bsz, s, nh, hp)
    y, h = _ssd_chunked(xh, b, c, log_a, dt_s, cfg.ssm_chunk)
    y = y + xh * p["D"][:, None].to(dt)
    out = _gate_out(p, y.reshape(bsz, s, -1), z, cfg)
    if return_state:
        return out, {"h": h, "conv": xin_raw_tail(x, p, cfg)}
    return out, None


def xin_raw_tail(x: torch.Tensor, p: Params, cfg: ModelConfig
                 ) -> torch.Tensor:
    """The last ``conv_dim - 1`` pre-conv inputs, for decode."""
    return (x @ p["wx"].to(x.dtype))[:, -(cfg.ssm_conv_dim - 1):, :]


def init_state(cfg: ModelConfig, batch: int, dtype, device=None,
               groups: Tuple[int, ...] = ()) -> State:
    """The decode state's start: h zeros in f32, the conv buffer zeros in
    ``dtype``."""
    nh, hp, n = cfg.ssm_num_heads, cfg.ssm_head_dim, cfg.ssm_state_dim
    return {"h": torch.zeros(groups + (batch, nh, n, hp),
                             dtype=torch.float32, device=device),
            "conv": torch.zeros(groups + (batch, cfg.ssm_conv_dim - 1,
                                          cfg.ssm_d_inner),
                                dtype=dtype, device=device)}


def decode(p: Params, x: torch.Tensor, state: State, cfg: ModelConfig
           ) -> Tuple[torch.Tensor, State]:
    """Single-token step.  x: (B, 1, D); returns (out (B, 1, D), new
    state)."""
    bsz = x.shape[0]
    nh, hp = cfg.ssm_num_heads, cfg.ssm_head_dim
    dt = x.dtype
    f32 = torch.float32
    xt = x[:, 0]
    z = xt @ p["wz"].to(dt)
    conv_buf = torch.cat([state["conv"], (xt @ p["wx"].to(dt))[:, None]],
                         dim=1)                        # (B, K, din)
    xin = F.silu(torch.einsum("bkc,kc->bc", conv_buf, p["conv"].to(dt)))
    b = xt @ p["wB"].to(dt)                            # (B, n)
    c = xt @ p["wC"].to(dt)
    dt_s, log_a = _step_sizes(p, xt @ p["wdt"].to(dt))  # (B, nh)
    xh = xin.reshape(bsz, nh, hp).to(f32)
    h = (torch.exp(log_a)[:, :, None, None] * state["h"]
         + torch.einsum("bh,bn,bhp->bhnp", dt_s, b.to(f32), xh))
    y = torch.einsum("bn,bhnp->bhp", c.to(f32), h) + xh * p["D"][:, None]
    out = _gate_out(p, y.reshape(bsz, -1).to(dt), z, cfg)
    return out[:, None], {"h": h, "conv": conv_buf[:, 1:]}

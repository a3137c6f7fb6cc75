"""xLSTM mixers (arXiv:2405.04517): mLSTM (matrix memory) and sLSTM.

Port of ``repro.models.xlstm``.  Plain PyTorch throughout: the reference
has no Pallas kernel here.

**mLSTM** is a gated linear-attention recurrence with a matrix state per
head::

    C_t = f_t C_{t-1} + i_t v_t k_t^T        (d_v x d_k matrix memory)
    n_t = f_t n_{t-1} + i_t k_t              (normalizer)
    h_t = (C_t q_t) / max(|n_t^T q_t|, stab)

with exponential input gate ``i = exp(i~)`` and sigmoid-in-log-space
forget gate, stabilized by the running magnitude ``m_t``.  The
chunkwise-parallel form: within a chunk all pairwise terms are one
masked product in log-stabilized space; across chunks the (C, n, m)
state is carried.

**sLSTM** keeps scalar memories with block-diagonal recurrent mixing per
head, which is sequential: a Python loop over time with no in-place
operation, so autograd and ``torch.func`` run through it (one step's
operations are launched per position).

Both follow the xLSTM residual-block layout with the input up-projection
(mLSTM: expand 2x); the configuration has no separate FFN.  Every
initializer takes leading ``groups`` dims for the layer stack and makes
its tensors on the default device, as ``transformer.init`` sets it.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import common
from repro_torch.models.config import ModelConfig

Params = Dict[str, torch.Tensor]
State = Dict[str, torch.Tensor]

# The stabilizer's start: "no memory yet", finite so that sums with it
# stay finite (exp of it is 0, and so is its gradient).
M_START = -1e30


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def mlstm_init(gen: torch.Generator, cfg: ModelConfig,
               groups: Tuple[int, ...] = ()) -> Params:
    d = cfg.d_model
    din = 2 * d                       # xLSTM mLSTM block expansion = 2
    nh = cfg.xlstm_heads
    if din % nh:
        raise ValueError(f"2 * d_model = {din} is not a multiple of "
                         f"xlstm_heads = {nh}")
    dt = common.dtype_of(cfg.dtype_params)
    return {
        "wup": common.dense_init(gen, groups + (d, din), d, dt),
        "wgate": common.dense_init(gen, groups + (d, din), d, dt),
        "wq": common.dense_init(gen, groups + (din, din), din, dt),
        "wk": common.dense_init(gen, groups + (din, din), din, dt),
        "wv": common.dense_init(gen, groups + (din, din), din, dt),
        "wif": common.dense_init(gen, groups + (din, 2 * nh), din),
        # input gate 0, forget gate 3 (open)
        "if_bias": torch.cat([common.filled(groups + (nh,), 0.0),
                              common.filled(groups + (nh,), 3.0)], dim=-1),
        "norm": common.filled(groups + (din,), 1.0),
        "wo": common.dense_init(gen, groups + (din, d), din, dt),
    }


def _mlstm_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   ig: torch.Tensor, fg: torch.Tensor, chunk: int,
                   state: Optional[State] = None
                   ) -> Tuple[torch.Tensor, State]:
    """Chunkwise mLSTM.

    q, k, v: (B, S, nh, hd); ig, fg: (B, S, nh) raw gate pre-activations;
    state: {"C": (B, nh, hd, hd), "n": (B, nh, hd), "m": (B, nh)}.
    Returns (h (B, S, nh, hd) f32, new state).  Log-space stabilized.
    """
    bsz, s, nh, hd = q.shape
    while s // chunk > 64:   # the reference's compile-size guard
        chunk *= 2
    if s % chunk:
        chunk = s
    f32 = torch.float32
    if state is None:
        c_st = torch.zeros((bsz, nh, hd, hd), dtype=f32, device=q.device)
        n_st = torch.zeros((bsz, nh, hd), dtype=f32, device=q.device)
        m_st = torch.full((bsz, nh), M_START, dtype=f32, device=q.device)
    else:
        c_st, n_st, m_st = (state["C"].to(f32), state["n"].to(f32),
                            state["m"].to(f32))
    logf = F.logsigmoid(fg.to(f32))                       # (B,S,nh)
    scale = hd ** -0.5
    tri = torch.ones((chunk, chunk), dtype=torch.bool,
                     device=q.device).tril()[None, :, :, None]
    outs = []
    for start in range(0, s, chunk):
        sl = slice(start, start + chunk)
        qc = q[:, sl].to(f32) * scale
        kc = k[:, sl].to(f32)
        vc = v[:, sl].to(f32)
        ic = ig[:, sl].to(f32)                            # (B,L,nh)
        cum = torch.cumsum(logf[:, sl], dim=1)            # F_t
        # log weight of source s' at target t: F_t - F_s' + i_s' (s' <= t)
        lw = cum[:, :, None, :] - cum[:, None, :, :] + ic[:, None, :, :]
        lw = torch.where(tri, lw, -torch.inf)             # (B,L,L,nh)
        # inter-chunk log magnitude at t: F_t + m_prev
        inter_lm = cum + m_st[:, None, :]                 # (B,L,nh)
        # amax splits a max's gradient evenly among ties, as JAX does.
        m_t = torch.maximum(torch.amax(lw, dim=2), inter_lm)
        m_t = torch.clamp_min(m_t, M_START)
        w = torch.exp(lw - m_t[:, :, None, :])            # (B,L,L,nh)
        inter_w = torch.exp(inter_lm - m_t)               # (B,L,nh)
        qk = torch.einsum("blhd,bshd->blsh", qc, kc)      # (B,L,L,nh)
        num_intra = torch.einsum("blsh,blsh,bshd->blhd", qk, w, vc)
        num_inter = torch.einsum("blhd,bhde,blh->blhe", qc,
                                 c_st.transpose(-1, -2), inter_w)
        den_intra = torch.einsum("blsh,bshd,blhd->blh", w, kc, qc)
        den_inter = torch.einsum("bhd,blhd,blh->blh", n_st, qc, inter_w)
        den = torch.abs(den_intra + den_inter)
        den = torch.maximum(den, torch.exp(-m_t))
        outs.append((num_intra + num_inter) / den[..., None])
        # State update to the end of the chunk.
        f_total = cum[:, -1]                              # (B,nh)
        src = cum[:, -1:, :] - cum + ic                   # (B,L,nh)
        m_new = torch.maximum(f_total + m_st, torch.amax(src, dim=1))
        w_st = torch.exp(src - m_new[:, None, :])
        decay = torch.exp(f_total + m_st - m_new)
        c_st = (decay[:, :, None, None] * c_st
                + torch.einsum("bsh,bshd,bshe->bhde", w_st, vc, kc))
        n_st = (decay[:, :, None] * n_st
                + torch.einsum("bsh,bshd->bhd", w_st, kc))
        m_st = m_new
    h = torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]
    return h, {"C": c_st, "n": n_st, "m": m_st}


def _mlstm_gates(p: Params, up: torch.Tensor, nh: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    gif = (up.to(torch.float32) @ p["wif"]) + p["if_bias"]
    return gif[..., :nh], gif[..., nh:]


def _mlstm_out(p: Params, h: torch.Tensor, gate: torch.Tensor,
               cfg: ModelConfig) -> torch.Tensor:
    h = common.rmsnorm(h, p["norm"], cfg.norm_eps)
    return (h * F.silu(gate)) @ p["wo"].to(h.dtype)


def mlstm_forward(p: Params, x: torch.Tensor, cfg: ModelConfig,
                  return_state: bool = False):
    """x: (B, S, D) -> (out (B, S, D), final state or None)."""
    bsz, s, _ = x.shape
    nh = cfg.xlstm_heads
    dt = x.dtype
    up = x @ p["wup"].to(dt)
    gate = x @ p["wgate"].to(dt)
    din = up.shape[-1]
    hd = din // nh
    q = (up @ p["wq"].to(dt)).reshape(bsz, s, nh, hd)
    k = (up @ p["wk"].to(dt)).reshape(bsz, s, nh, hd)
    v = (up @ p["wv"].to(dt)).reshape(bsz, s, nh, hd)
    ig, fg = _mlstm_gates(p, up, nh)
    h, st = _mlstm_chunked(q, k, v, ig, fg, cfg.ssm_chunk)
    out = _mlstm_out(p, h.reshape(bsz, s, din).to(dt), gate, cfg)
    return out, (st if return_state else None)


def mlstm_init_state(cfg: ModelConfig, batch: int, device=None,
                     groups: Tuple[int, ...] = ()) -> State:
    din = 2 * cfg.d_model
    nh = cfg.xlstm_heads
    hd = din // nh
    lead = groups + (batch, nh)
    f32 = torch.float32
    return {"C": torch.zeros(lead + (hd, hd), dtype=f32, device=device),
            "n": torch.zeros(lead + (hd,), dtype=f32, device=device),
            "m": torch.full(lead, M_START, dtype=f32, device=device)}


def mlstm_decode(p: Params, x: torch.Tensor, state: State,
                 cfg: ModelConfig) -> Tuple[torch.Tensor, State]:
    """Single-token mLSTM step.  x: (B, 1, D); returns (out (B, 1, D),
    new state)."""
    bsz = x.shape[0]
    nh = cfg.xlstm_heads
    dt = x.dtype
    f32 = torch.float32
    xt = x[:, 0]
    up = xt @ p["wup"].to(dt)
    gate = xt @ p["wgate"].to(dt)
    din = up.shape[-1]
    hd = din // nh
    q = (up @ p["wq"].to(dt)).reshape(bsz, nh, hd).to(f32) * hd ** -0.5
    k = (up @ p["wk"].to(dt)).reshape(bsz, nh, hd).to(f32)
    v = (up @ p["wv"].to(dt)).reshape(bsz, nh, hd).to(f32)
    ig, fg = _mlstm_gates(p, up, nh)
    logf = F.logsigmoid(fg)
    m_new = torch.maximum(logf + state["m"], ig)
    f_eff = torch.exp(logf + state["m"] - m_new)
    i_eff = torch.exp(ig - m_new)
    c_st = (f_eff[:, :, None, None] * state["C"]
            + i_eff[:, :, None, None] * v[..., :, None] * k[..., None, :])
    n_st = f_eff[..., None] * state["n"] + i_eff[..., None] * k
    den = torch.abs(torch.einsum("bhd,bhd->bh", n_st, q))
    den = torch.maximum(den, torch.exp(-m_new))
    h = torch.einsum("bhde,bhe->bhd", c_st, q) / den[..., None]
    out = _mlstm_out(p, h.reshape(bsz, din).to(dt), gate, cfg)
    return out[:, None, :], {"C": c_st, "n": n_st, "m": m_new}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def slstm_init(gen: torch.Generator, cfg: ModelConfig,
               groups: Tuple[int, ...] = ()) -> Params:
    d = cfg.d_model
    nh = cfg.xlstm_heads
    hd = d // nh
    dt = common.dtype_of(cfg.dtype_params)
    return {
        # 4 gates (i, f, z, o) from the input ...
        "wx": common.dense_init(gen, groups + (d, 4 * d), d, dt),
        # ... and block-diagonal recurrent mixing per head.
        "wr": common.dense_init(gen, groups + (nh, hd, 4 * hd), hd, dt),
        "bias": torch.cat([common.filled(groups + (d,), 0.0),
                           common.filled(groups + (d,), 3.0),
                           common.filled(groups + (2 * d,), 0.0)], dim=-1),
        "norm": common.filled(groups + (d,), 1.0),
        "wo": common.dense_init(gen, groups + (d, d), d, dt),
    }


def _slstm_step(p: Params, cfg: ModelConfig, carry, gx_t: torch.Tensor):
    """carry: (c, n, h, m) each (B, d) f32; gx_t: (B, 4d) input part."""
    c, n, h, m = carry
    d = cfg.d_model
    nh = cfg.xlstm_heads
    hr = h.reshape(h.shape[0], nh, d // nh)
    gr = torch.einsum("bhd,hde->bhe", hr, p["wr"].to(torch.float32)
                      ).reshape(h.shape[0], 4 * d)
    g = gx_t + gr + p["bias"]
    gi, gf, gz, go = torch.split(g, d, dim=-1)
    logf = F.logsigmoid(gf)
    m_new = torch.maximum(logf + m, gi)
    i_eff = torch.exp(gi - m_new)
    f_eff = torch.exp(logf + m - m_new)
    c_new = f_eff * c + i_eff * torch.tanh(gz)
    n_new = f_eff * n + i_eff
    h_new = torch.sigmoid(go) * c_new / torch.clamp_min(n_new, 1e-6)
    return c_new, n_new, h_new, m_new


def _slstm_out(p: Params, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    h = common.rmsnorm(h, p["norm"], cfg.norm_eps)
    return h @ p["wo"].to(h.dtype)


def slstm_forward(p: Params, x: torch.Tensor, cfg: ModelConfig,
                  return_state: bool = False):
    """Sequential sLSTM over time.  x: (B, S, D) -> (out, state or None)."""
    bsz, s, d = x.shape
    gx = (x @ p["wx"].to(x.dtype)).to(torch.float32)        # (B,S,4d)
    zeros = torch.zeros((bsz, d), dtype=torch.float32, device=x.device)
    carry = (zeros, zeros, zeros,
             torch.full((bsz, d), M_START, dtype=torch.float32,
                        device=x.device))
    hs = []
    # On shape-only ``meta`` tensors (the dry run) every step has the
    # same shapes and no data: one step stands for all of them, and
    # ``launch.dryrun`` counts the other steps' products.
    meta = x.device.type == "meta"
    for t in range(min(s, 1) if meta else s):
        carry = _slstm_step(p, cfg, carry, gx[:, t])
        hs.append(carry[2])
    if meta:
        hs = hs * s
    out = _slstm_out(p, torch.stack(hs, dim=1).to(x.dtype), cfg)
    if not return_state:
        return out, None
    return out, dict(zip(("c", "n", "h", "m"), carry))


def slstm_init_state(cfg: ModelConfig, batch: int, device=None,
                     groups: Tuple[int, ...] = ()) -> State:
    shape = groups + (batch, cfg.d_model)
    f32 = torch.float32
    return {"c": torch.zeros(shape, dtype=f32, device=device),
            "n": torch.zeros(shape, dtype=f32, device=device),
            "h": torch.zeros(shape, dtype=f32, device=device),
            "m": torch.full(shape, M_START, dtype=f32, device=device)}


def slstm_decode(p: Params, x: torch.Tensor, state: State,
                 cfg: ModelConfig) -> Tuple[torch.Tensor, State]:
    gx = (x[:, 0] @ p["wx"].to(x.dtype)).to(torch.float32)
    carry = _slstm_step(p, cfg, (state["c"], state["n"], state["h"],
                                 state["m"]), gx)
    out = _slstm_out(p, carry[2].to(x.dtype), cfg)
    return out[:, None, :], dict(zip(("c", "n", "h", "m"), carry))

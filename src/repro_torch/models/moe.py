"""Feed-forward layers: the dense MLP (SwiGLU / GELU) and top-k MoE.

Port of ``repro.models.moe``.  The router takes its product in f32,
then softmax, top-k and renormalization, and returns the Switch
load-balance loss over the top-1 share.  Three expert dispatches,
selected by ``cfg.moe_impl``:

* ``dense_grouped`` (the default, what serving runs): GShard-style
  dispatch with a capacity per expert within token groups of
  ``cfg.moe_group_size``.  An assignment's slot is the count of the
  earlier tokens' assignments to its expert within the group; it is kept
  iff the slot is below the capacity.  The reference builds ``(gs, k, E,
  cap)`` one-hot tensors for this (about 128 GB at qwen3-moe's 20,000
  tokens a group); here the slots are counted per expert and the tokens
  gathered into ``(E, groups * cap, D)`` buffers by index, then the
  gated outputs are gathered back: the same drops and the same sums.
* ``ragged``: tokens sorted by expert, each expert's rows through its
  weights, scatter-added back with the gates; drops nothing.
* ``dense``: every expert on every token, combined by the gate mask
  (smoke scale only).

The expert products are plain ``torch.bmm`` / ``matmul``: the reference
computes them outside any Pallas kernel (``ragged_dot``, ``einsum``).
Expert weights are stacked ``(E, D, F)`` / ``(E, F, D)``, with leading
``groups`` dims for the layer stack; the router is ``(D, E)`` in f32.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import common
from repro_torch.models.config import ModelConfig

Params = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# Dense MLP
# ---------------------------------------------------------------------------

def mlp_init(gen: torch.Generator, cfg: ModelConfig,
             groups: Tuple[int, ...] = ()) -> Params:
    d, f = cfg.d_model, cfg.d_ff
    dt = common.dtype_of(cfg.dtype_params)
    p = {"wi": common.dense_init(gen, groups + (d, f), d, dt)}
    if cfg.mlp_activation == "swiglu":
        p["wg"] = common.dense_init(gen, groups + (d, f), d, dt)
    p["wo"] = common.dense_init(gen, groups + (f, d), f, dt)
    if cfg.use_bias:
        p["bi"] = common.filled(groups + (f,), 0.0, dt)
        p["bo"] = common.filled(groups + (d,), 0.0, dt)
    return p


def _activate(h: torch.Tensor, g, cfg: ModelConfig) -> torch.Tensor:
    """SwiGLU (``silu(h) * g``) or GELU (jax.nn.gelu's tanh form)."""
    if cfg.mlp_activation == "swiglu":
        return F.silu(h) * g
    return F.gelu(h, approximate="tanh")


def mlp_apply(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    dt = x.dtype
    h = x @ p["wi"].to(dt)
    if cfg.use_bias:
        h = h + p["bi"].to(dt)
    g = x @ p["wg"].to(dt) if cfg.mlp_activation == "swiglu" else None
    out = _activate(h, g, cfg) @ p["wo"].to(dt)
    if cfg.use_bias:
        out = out + p["bo"].to(dt)
    return out


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

def moe_init(gen: torch.Generator, cfg: ModelConfig,
             groups: Tuple[int, ...] = ()) -> Params:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    dt = common.dtype_of(cfg.dtype_params)
    p = {"router": common.dense_init(gen, groups + (d, e), d),
         "wi": common.dense_init(gen, groups + (e, d, f), d, dt),
         "wo": common.dense_init(gen, groups + (e, f, d), f, dt)}
    if cfg.mlp_activation == "swiglu":
        p["wg"] = common.dense_init(gen, groups + (e, d, f), d, dt)
    return p


def route(p: Params, x2d: torch.Tensor, cfg: ModelConfig
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k routing.  x2d: (T, D).  Returns (expert ids (T, k) int64,
    gates (T, k) in x2d's dtype, the aux loss, an f32 scalar)."""
    logits = x2d.float() @ p["router"].float()               # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate, ids = torch.topk(probs, cfg.num_experts_per_tok, dim=-1)
    gate = gate / torch.clamp_min(gate.sum(dim=-1, keepdim=True), 1e-9)
    # Switch load-balance loss: E * sum_e fraction_e * mean_prob_e, the
    # fraction over each token's top-1 expert.
    e = cfg.num_experts
    frac = torch.bincount(ids[:, 0], minlength=e).float() / x2d.shape[0]
    aux = e * torch.sum(frac * probs.mean(dim=0))
    return ids, gate.to(x2d.dtype), aux


def _experts(p: Params, xe: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Each expert's FFN on its rows: xe (E, M, D) -> (E, M, D)."""
    dt = xe.dtype
    h = torch.bmm(xe, p["wi"].to(dt))
    g = (torch.bmm(xe, p["wg"].to(dt)) if cfg.mlp_activation == "swiglu"
         else None)
    return torch.bmm(_activate(h, g, cfg), p["wo"].to(dt))


def group_size(t: int, cfg: ModelConfig) -> int:
    """Tokens per dispatch group: ``moe_group_size``, or all ``t`` tokens
    where it does not divide them."""
    gs = min(cfg.moe_group_size, t)
    return t if t % gs else gs


def capacity(gs: int, cfg: ModelConfig) -> int:
    """Slots per expert and group.  The floor keeps tiny groups (decode,
    T = batch tokens) dropless: at most ``gs * k`` assignments, capped at
    16."""
    k, e = cfg.num_experts_per_tok, cfg.num_experts
    return max(int(gs * k * cfg.moe_capacity_factor / e), min(gs * k, 16))


def dispatch_slots(ids: torch.Tensor, num_experts: int, cap: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """ids (G, gs, k) -> (slot, keep), both (G, gs, k): an assignment's
    slot is the number of assignments to its expert by the earlier tokens
    of its group (a token's k experts are distinct, so its own slots see
    the same count), and it is kept iff the slot is below ``cap``."""
    n_groups, gs, _ = ids.shape
    per_token = torch.zeros((n_groups, gs, num_experts), dtype=torch.int32,
                            device=ids.device).scatter(2, ids, 1)
    earlier = torch.cumsum(per_token, dim=1, dtype=torch.int32) - per_token
    slot = torch.gather(earlier, 2, ids)
    return slot, slot < cap


def moe_apply_dense_grouped(p: Params, x2d: torch.Tensor, cfg: ModelConfig
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Capacity dispatch within token groups, by index.  Out of place
    throughout, so that ``torch.func.vmap`` maps it (the federated
    step)."""
    t, d = x2d.shape
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    gs = group_size(t, cfg)
    n_groups = t // gs
    cap = capacity(gs, cfg)
    ids, gate, aux = route(p, x2d, cfg)
    slot, keep = dispatch_slots(ids.view(n_groups, gs, k), e, cap)
    # Row of each assignment in the (E, groups * cap) buffers.  A dropped
    # one goes to a spare last row and is read from row 0 with weight 0,
    # so no step depends on how many were dropped (no host sync).
    grp = torch.arange(n_groups, device=x2d.device)[:, None, None]
    row = (ids.view(n_groups, gs, k) * n_groups + grp) * cap + slot
    rows = e * n_groups * cap
    keep = keep.reshape(t, k)
    row = row.reshape(t, k)
    # The buffer is gathered, not scattered into: ``fill`` names the token
    # of each row, t (a zero row) where none comes, so x is read once and
    # the buffer written once, out of place (vmap maps it).
    tok = torch.arange(t, device=x2d.device).repeat_interleave(k)
    fill = torch.full((rows + 1,), t, dtype=tok.dtype,
                      device=x2d.device).index_put(
        (torch.where(keep, row, rows).reshape(-1),), tok)
    xe = torch.cat([x2d, x2d.new_zeros((1, d))])[fill[:rows]]
    ye = _experts(p, xe.view(e, n_groups * cap, d), cfg).view(rows, d)
    # Sum each token's gated outputs in f32 and round once, as the
    # reference's combine product does.  The sum starts from the first
    # expert's term, so it is batched under vmap and adds in place.
    w = gate.float() * keep
    src = torch.where(keep, row, 0)
    out = w[:, 0, None] * ye[src[:, 0]]
    for j in range(1, k):
        out += w[:, j, None] * ye[src[:, j]]
    return out.to(x2d.dtype), aux


def moe_apply_ragged(p: Params, x2d: torch.Tensor, cfg: ModelConfig
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort-based dispatch: each expert's tokens through its weights
    (active-parameter FLOPs, nothing dropped).  Reads the group sizes on
    the host (one sync)."""
    t, d = x2d.shape
    k = cfg.num_experts_per_tok
    ids, gate, aux = route(p, x2d, cfg)
    flat = ids.reshape(-1)
    order = torch.argsort(flat, stable=True)
    token_of = order // k
    x_sorted = x2d[token_of]
    sizes = torch.bincount(flat, minlength=cfg.num_experts).tolist()
    y_sorted = torch.empty_like(x_sorted)
    start = 0
    for ex, n in enumerate(sizes):
        if n:
            rows = slice(start, start + n)
            y_sorted[rows] = _experts(
                {name: w[ex:ex + 1] for name, w in p.items()
                 if name != "router"},
                x_sorted[None, rows], cfg)[0]
            start += n
    w_sorted = gate.reshape(-1)[order][:, None].to(y_sorted.dtype)
    out = torch.zeros_like(x2d).index_add_(0, token_of, y_sorted * w_sorted)
    return out, aux


def moe_apply_dense(p: Params, x2d: torch.Tensor, cfg: ModelConfig
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every expert on every token (smoke scale only)."""
    ids, gate, aux = route(p, x2d, cfg)
    dt = x2d.dtype
    h = torch.einsum("td,edf->tef", x2d, p["wi"].to(dt))
    g = (torch.einsum("td,edf->tef", x2d, p["wg"].to(dt))
         if cfg.mlp_activation == "swiglu" else None)
    y = torch.einsum("tef,efd->ted", _activate(h, g, cfg), p["wo"].to(dt))
    mask = F.one_hot(ids, cfg.num_experts).float()             # (T, k, E)
    comb = torch.einsum("tke,tk->te", mask, gate.float())
    return torch.einsum("te,ted->td", comb.to(dt), y), aux


_IMPLS = {"dense_grouped": moe_apply_dense_grouped,
          "ragged": moe_apply_ragged, "dense": moe_apply_dense}


def moe_apply(p: Params, x: torch.Tensor, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out (B, S, D), aux loss)."""
    b, s, d = x.shape
    out, aux = _IMPLS[cfg.moe_impl](p, x.reshape(b * s, d), cfg)
    return out.reshape(b, s, d), aux

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

On a device mesh (``mesh``; DTensor parameters) the MLP's hidden layer
lies on ``model`` and its output in the residual layout, at the
reference's sites.  ``dense_grouped`` dispatches each ``data`` shard's
tokens where its groups are the whole run's groups (else every rank
dispatches all of them), replicated over ``model``, and runs the expert
products on each rank's local experts (``E`` on ``model``, or ``F``
where ``E`` does not split) under ``local_map``; the outputs gather
before the combine, which is the one-device code on local tensors.
``ragged`` (it reads group sizes on the host) and ``dense`` raise on a
mesh.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import common
from repro_torch.models.config import ModelConfig
from repro_torch.sharding import rules

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


def mlp_apply(p: Params, x: torch.Tensor, cfg: ModelConfig,
              mesh=None) -> torch.Tensor:
    dt = x.dtype
    h = x @ p["wi"].to(dt)
    if cfg.use_bias:
        h = h + p["bi"].to(dt)
    g = x @ p["wg"].to(dt) if cfg.mlp_activation == "swiglu" else None
    h = rules.constrain(_activate(h, g, cfg), mesh, "batch", None, "tensor")
    out = h @ p["wo"].to(dt)
    if cfg.use_bias:
        out = out + p["bo"].to(dt)
    return rules.residual_constrain(out, mesh, cfg.sequence_sharding)


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


def _router(router: torch.Tensor, x2d: torch.Tensor, cfg: ModelConfig
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(expert ids (T, k), gates (T, k) in x2d's dtype, probabilities
    (T, E) f32)."""
    logits = x2d.float() @ router.float()                    # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate, ids = torch.topk(probs, cfg.num_experts_per_tok, dim=-1)
    gate = gate / torch.clamp_min(gate.sum(dim=-1, keepdim=True), 1e-9)
    return ids, gate.to(x2d.dtype), probs


def _top1_counts(ids: torch.Tensor, num_experts: int) -> torch.Tensor:
    """Tokens whose first choice is each expert, (E,) f32.  Counted by a
    scatter-add of ones (exact below 2^24 tokens), which also runs on
    shape-only ``meta`` tensors, unlike ``bincount``; out of place, so
    that ``vmap`` over clients maps it."""
    top1 = ids[:, 0]
    return torch.zeros(num_experts, dtype=torch.float32, device=ids.device
                       ).scatter_add(0, top1, torch.ones(
                           top1.shape, device=ids.device))


def route(p: Params, x2d: torch.Tensor, cfg: ModelConfig
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k routing.  x2d: (T, D).  Returns (expert ids (T, k) int64,
    gates (T, k) in x2d's dtype, the aux loss, an f32 scalar)."""
    ids, gate, probs = _router(p["router"], x2d, cfg)
    # Switch load-balance loss: E * sum_e fraction_e * mean_prob_e, the
    # fraction over each token's top-1 expert.
    e = cfg.num_experts
    frac = _top1_counts(ids, e) / x2d.shape[0]
    aux = e * torch.sum(frac * probs.mean(dim=0))
    return ids, gate, aux


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
    ids, gate, aux = route(p, x2d, cfg)
    xe, src, w = _dispatch(ids, gate, x2d, cfg)
    ye = _experts(p, xe, cfg)
    return _combine(ye.view(-1, x2d.shape[1]), src, w, x2d.dtype), aux


def _dispatch(ids: torch.Tensor, gate: torch.Tensor, x2d: torch.Tensor,
              cfg: ModelConfig
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The tokens gathered into each expert's capacity rows, (E, groups *
    cap, D), and each assignment's row in them (T, k) with its gate
    weight (T, k) f32 (0 where dropped)."""
    t, d = x2d.shape
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    gs = group_size(t, cfg)
    n_groups = t // gs
    cap = capacity(gs, cfg)
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
    return (xe.view(e, n_groups * cap, d), torch.where(keep, row, 0),
            gate.float() * keep)


def _combine(ye: torch.Tensor, src: torch.Tensor, w: torch.Tensor,
             dtype: torch.dtype) -> torch.Tensor:
    """Each token's gated expert outputs from the (rows, D) outputs ``ye``,
    summed in f32 and rounded once, as the reference's combine product
    does.  The sum starts from the first expert's term, so it is batched
    under vmap and adds in place."""
    out = w[:, 0, None] * ye[src[:, 0]]
    for j in range(1, src.shape[1]):
        out += w[:, j, None] * ye[src[:, j]]
    return out.to(dtype)


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


def moe_apply(p: Params, x: torch.Tensor, cfg: ModelConfig, mesh=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out (B, S, D), aux loss); on a ``mesh`` the
    output is in the residual layout and the aux loss replicates."""
    if mesh is not None:
        out, aux = _moe_on_mesh(p, x, cfg, mesh)
        return rules.residual_constrain(out, mesh,
                                        cfg.sequence_sharding), aux
    b, s, d = x.shape
    out, aux = _IMPLS[cfg.moe_impl](p, x.reshape(b * s, d), cfg)
    return out.reshape(b, s, d), aux


def _layout(mesh, batch, model) -> list:
    """A placement for each mesh axis: ``batch`` on the data axes,
    ``model`` on ``model``."""
    return [model if a == "model" else batch for a in mesh.axis_names]


def _moe_on_mesh(p: Params, x: torch.Tensor, cfg: ModelConfig, mesh
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`moe_apply` on DTensors (see the module docstring)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    if cfg.moe_impl != "dense_grouped":
        raise NotImplementedError(
            f"the {cfg.moe_impl} MoE dispatch has no mesh path (ragged "
            f"reads its group sizes on the host); use "
            f"moe_impl='dense_grouped'")
    b, s, d = x.shape
    t, e = b * s, cfg.num_experts
    dm, rep = mesh.device_mesh, Replicate()
    n_data = rules.entry_size(rules.resolve("batch", mesh), mesh)
    # Each data shard dispatches its own tokens where its groups are the
    # run's groups; otherwise every rank dispatches them all.
    split = b % n_data == 0 and (t // n_data) % group_size(t, cfg) == 0
    x2d = rules.constrain(x, mesh, "batch" if split else None, None,
                          None).reshape(t, d)
    tok = _layout(mesh, Shard(0) if split else rep, rep)
    everywhere = _layout(mesh, rep, rep)
    names = [n for n in ("wi", "wg", "wo") if n in p]

    def dispatch(xl, router):
        ids, gate, probs = _router(router, xl, cfg)
        xe, src, w = _dispatch(ids, gate, xl, cfg)
        return xe, src, w, _top1_counts(ids, e), probs.sum(dim=0)

    by_group = Shard(1) if split else rep     # the buffers' group rows
    rows = _layout(mesh, by_group, rep)
    summed = _layout(mesh, Partial() if split else rep, rep)
    # The router's gradient comes from the rank's tokens alone: partial
    # over data where each data shard dispatches its own.
    xe, src, w, counts, psum = local_map(
        dispatch, out_placements=(rows, tok, tok, summed, summed),
        in_placements=(tok, everywhere), in_grad_placements=(tok, summed),
        device_mesh=dm, redistribute_inputs=True)(x2d, p["router"])
    # Expert-parallel where E splits over `model` (each rank its experts'
    # buffers), else each expert's F (partial sums over `model`).
    m = mesh.axis_size("model")
    if e % m == 0:
        xe_plc = y_plc = Shard(0)
        w_plc = dict.fromkeys(names, Shard(0))
    elif cfg.d_ff % m == 0:
        xe_plc, y_plc = rep, Partial()
        w_plc = {"wi": Shard(2), "wg": Shard(2), "wo": Shard(1)}
    else:
        xe_plc = y_plc = rep
        w_plc = dict.fromkeys(names, rep)

    def experts(xl, *ws):
        return _experts(dict(zip(names, ws)), xl, cfg)

    # Gradients: the weights' from the rank's groups alone (partial over
    # data where the groups split), the buffers' from the rank's slice of
    # F alone (partial over model where F splits).
    by_data = Partial() if split else rep
    ye = local_map(
        experts, out_placements=_layout(mesh, by_group, y_plc),
        in_placements=(_layout(mesh, by_group, xe_plc),)
        + tuple(_layout(mesh, rep, w_plc[n]) for n in names),
        in_grad_placements=(_layout(mesh, by_group, y_plc),)
        + tuple(_layout(mesh, by_data, w_plc[n]) for n in names),
        device_mesh=dm, redistribute_inputs=True)(
        xe, *(p[n] for n in names)).redistribute(dm, rows)
    out = local_map(
        lambda yl, sl, wl: _combine(yl.reshape(-1, d), sl, wl, x.dtype),
        out_placements=tok, in_placements=(rows, tok, tok), device_mesh=dm,
        redistribute_inputs=True)(ye, src, w)
    aux = e * torch.sum((counts / t) * (psum / t))
    return out.reshape(b, s, d), aux

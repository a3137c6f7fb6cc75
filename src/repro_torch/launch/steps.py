"""Step builders: train_step / prefill_step / serve_step (+ FedAvg round).

Port of ``repro.launch.steps``.  ``make_train_step`` is the plain
training step: forward (+ MoE aux loss), token cross-entropy, backward,
optimizer update, with optional gradient accumulation over microbatches.

``make_federated_train_step`` is the paper's technique at datacenter
scale: the global batch is split into ``num_clients`` client shards, each
client's mean gradient is taken on its own shard, and the gradients are
FedAvg-weighted by the scheduler's selection and the clients' data sizes
before one update -- Alg. 1 with E = 1, the DAS decision entering as the
(selection, weight) inputs.  The weighted sum over clients is the
``fedavg_agg`` kernel (``kernels/fedavg_agg.py``), one launch a step over
the (K, P) matrix of flattened gradients.

How gradients are taken.  ``torch.utils.checkpoint`` does not compose
with ``torch.func`` (saved-tensor hooks), so the two steps take different
routes to the same numbers:

* the plain step differentiates with ``torch.autograd.grad`` and keeps
  the reference's rematerialized cross-entropy: each sequence chunk's
  logits are recomputed in the backward (non-reentrant checkpoint);
* the federated step takes a pass of clients' gradients at once,
  ``torch.func.vmap(torch.func.grad(loss))`` over the client axis, with
  the chunks not rematerialized (each client's logits stay for the
  backward).  A loop of ``autograd.grad`` over the clients would run the
  sLSTM's per-position launches K times; passes run them once a pass.

Attention layers differentiate through the ``flash_attention`` kernel's
gradient (``kernels/flash_attention.py``: its backward kernel, and a
``vmap`` rule that launches once a pass for all its clients).  The
federated step refuses, naming ROADMAP queue 3, what it cannot map over
clients: the encoder-decoder (the step carries only inputs and labels,
as the reference's) and ``moe_impl="ragged"`` (its group sizes are read
on the host).

On a device mesh (``mesh=``, a ``launch.mesh.init_mesh`` mesh) every
step builder, :func:`loss_fn`, :func:`chunked_xent` and
:func:`init_train_state` run as DTensors, one process a rank: the
parameters and the optimizer state are laid out by
``sharding.params.param_specs``, the inputs (tensors every rank holds
whole) batch over ``data``, each loss chunk's logits batch over
``data`` and vocabulary over ``model`` as the reference constrains
them, and the loss is taken vocabulary-parallel on each rank's shard
(:class:`_VocabParallelNLL`: the max, the sum of exponentials and the
gold logit all-reduced over ``model``; the vocabulary is never
gathered).  A gradient is laid out as its parameter.  The federated
step on a mesh takes its clients one at a time with ``autograd.grad``
(:func:`client_grads_by_autograd`: ``torch.func.vmap`` does not map over
a model that lays DTensors out); each rank copies its shard of every
gradient leaf (a leaf it holds whole, whole) into its own (K, P_local)
f32 matrix, and one ``fedavg_agg`` launch a step reduces that matrix on
each rank: FedAvg is column-wise, so it needs no collective.  Both
routes share the rest of the step (:func:`federated_step`).
``mesh=None`` runs the one-device code.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from repro_torch import optim
from repro_torch.kernels.fedavg_agg import fedavg_agg
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig
from repro_torch.sharding import rules
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

Params = Any
Tensor = torch.Tensor
F32 = torch.float32


def check_federated(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for what the federated step cannot
    map over its clients (ROADMAP queue 3)."""
    if cfg.is_encdec:
        raise NotImplementedError(
            f"{cfg.name}: the federated step carries only the clients' "
            f"inputs and labels, as the reference's, not the encoder "
            f"inputs an encoder-decoder needs (ROADMAP queue 3, "
            f"'federated encoder-decoder')")
    if cfg.moe_impl == "ragged" and any(s.ffn == "moe" for s in cfg.pattern):
        raise NotImplementedError(
            f"{cfg.name}: moe_impl='ragged' reads its group sizes on the "
            f"host, which torch.func.vmap over the clients cannot; use "
            f"'dense_grouped' (ROADMAP queue 3, 'federated ragged MoE')")


def cross_entropy(logits: Tensor, labels: Tensor,
                  mask: Optional[Tensor] = None) -> Tensor:
    """Mean token cross-entropy in f32."""
    logits = logits.to(F32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, labels[..., None], dim=-1)[..., 0]
    nll = lse - gold
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)
    return torch.mean(nll)


class _VocabParallelNLL(torch.autograd.Function):
    """Each position's ``logsumexp(logits) - logits[label]`` from one
    rank's vocabulary shard (B, S, V_local) f32, the shard's first word
    ``offset``: the max, the sum of exponentials and the gold logit
    (from the rank that holds it, 0 elsewhere) are all-reduced over
    ``group`` (None: the whole vocabulary is local).  The operations are
    ``torch.logsumexp``'s and ``take_along_dim``'s, and the backward
    their gradients', ``exp(logits - lse)`` less 1 at the label: one
    rank holding the whole vocabulary gives their bits."""

    @staticmethod
    def forward(ctx, logits, labels, offset: int, group):
        import torch.distributed as dist
        m = torch.amax(logits, dim=-1, keepdim=True)
        if group is not None:
            dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
        m = m.masked_fill(m.abs() == math.inf, 0.0)
        s = torch.sum(torch.exp(logits - m), dim=-1)
        if group is not None:
            dist.all_reduce(s, group=group)
        lse = torch.log(s) + m[..., 0]
        idx = labels.long() - offset
        held = (idx >= 0) & (idx < logits.shape[-1])
        idx = torch.clamp(idx, 0, logits.shape[-1] - 1)[..., None]
        gold = torch.take_along_dim(logits, idx, dim=-1)[..., 0]
        if group is not None:
            gold = torch.where(held, gold, 0.0)
            dist.all_reduce(gold, group=group)
        ctx.save_for_backward(logits, lse, idx, held)
        return lse - gold

    @staticmethod
    def backward(ctx, dnll):
        logits, lse, idx, held = ctx.saved_tensors
        d = dnll[..., None] * torch.exp(logits - lse[..., None])
        gold = torch.where(held, -dnll, 0.0)
        return d.scatter_add_(-1, idx, gold[..., None]), None, None, None


def _nll_on_mesh(logits: Tensor, labels: Tensor, mesh) -> Tensor:
    """Each position's NLL (B, S) of vocabulary-sharded DTensor logits,
    batch over ``data``: :class:`_VocabParallelNLL` under ``local_map``
    on each rank's block, the vocabulary never gathered."""
    from torch.distributed.tensor.experimental import local_map
    dm = mesh.device_mesh
    names = rules.constrain_spec(logits.shape, mesh, "batch", None,
                                 "tensor")
    plc = rules.placements(names, mesh)
    row = rules.placements(rules.P(*names[:2]), mesh)
    group, offset = None, 0
    if "model" in mesh.axis_names and names[2] is not None:
        axis = mesh.axis_names.index("model")
        group = dm.get_group("model")
        offset = (logits.shape[-1] // mesh.shape[axis]
                  * dm.get_coordinate()[axis])

    def local(lg, lb):
        return _VocabParallelNLL.apply(lg, lb, offset, group)

    return local_map(local, out_placements=row, in_placements=(plc, row),
                     device_mesh=dm, redistribute_inputs=True)(logits,
                                                               labels)


def _chunk_loss(xc: Tensor, lc: Tensor, head: Tensor,
                softcap: float, mesh=None) -> Tensor:
    logits = xc @ head.to(xc.dtype)
    if softcap > 0.0:
        logits = softcap * torch.tanh(logits / softcap)
    if mesh is not None:
        logits = rules.constrain(logits, mesh, "batch", None, "tensor")
        return torch.sum(_nll_on_mesh(logits.to(F32), lc, mesh))
    logits = logits.to(F32)
    lse = torch.logsumexp(logits, dim=-1)
    # Labels in int64, or the reference's int32 as the dry run feeds them.
    gold = torch.take_along_dim(logits, lc.long()[..., None], dim=-1)[..., 0]
    return torch.sum(lse - gold)


def chunked_xent(hidden: Tensor, head: Tensor, labels: Tensor,
                 cfg: ModelConfig, num_chunks: int = 8,
                 remat: bool = True, mesh=None) -> Tensor:
    """Sequence-chunked softmax cross-entropy, the LM head folded in.

    With ``remat`` each chunk's head product and loss run under a
    non-reentrant ``torch.utils.checkpoint``: only per-chunk scalars
    survive the forward and the backward recomputes one chunk's (B, S/n,
    V) logits at a time.  ``remat=False`` keeps every chunk's logits (the
    only form ``torch.func`` transforms).

    On a ``mesh`` (``hidden`` and ``head`` DTensors; ``labels`` a
    DTensor or every rank's whole tensor) the hidden states gather their
    sequence once, each chunk's logits lie batch over ``data`` and
    vocabulary over ``model``, and the loss is replicated.
    """
    b, s, _ = hidden.shape
    if s % num_chunks:
        num_chunks = 1
    cs = s // num_chunks
    if mesh is not None:
        hidden = rules.constrain(hidden, mesh, "batch", None, None)
        if not rules.is_dtensor(labels):
            labels = rules.distribute(labels, mesh, "batch")
    total = rules.replicated(torch.zeros((), dtype=F32, device=hidden.device),
                             mesh)
    for i in range(num_chunks):
        args = (hidden[:, i * cs:(i + 1) * cs], labels[:, i * cs:(i + 1) * cs],
                head, cfg.logits_softcap, mesh)
        total = total + (checkpoint(_chunk_loss, *args, use_reentrant=False)
                         if remat else _chunk_loss(*args))
    return rules.constrain(total / (b * s), mesh)


def loss_fn(params: Params, batch: Dict[str, Tensor], cfg: ModelConfig,
            remat: bool = True, mesh=None
            ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Token cross-entropy plus the weighted MoE aux loss; ``batch`` may
    carry ``positions`` (M-RoPE's (3, B, S)) and ``encoder_inputs``.  On
    a ``mesh`` the batch's tensors are every rank's whole tensors (or
    DTensors) and the losses are replicated DTensors."""
    hidden, aux = transformer.forward(
        params, batch["inputs"], cfg, positions=batch.get("positions"),
        encoder_inputs=batch.get("encoder_inputs"), return_hidden=True,
        mesh=mesh)
    ce = chunked_xent(hidden, transformer.head_matrix(params, cfg),
                      batch["labels"], cfg, remat=remat, mesh=mesh)
    total = ce + cfg.router_aux_weight * rules.constrain(aux, mesh)
    return total, {"loss": total, "ce": ce, "moe_aux": aux}


def init_train_state(gen: torch.Generator, cfg: ModelConfig,
                     ocfg: optim.OptimizerConfig, mesh=None
                     ) -> Dict[str, Any]:
    """Parameters drawn from ``gen`` on its device (on a ``mesh``, laid
    out by ``sharding.params.shard_params``: every rank draws the same
    tree and keeps its shards), and a fresh optimizer state."""
    params = transformer.init(gen, cfg)
    if mesh is not None:
        from repro_torch.sharding import params as sharding_params
        params = sharding_params.shard_params(params, cfg, mesh)
    return {"params": params, "opt": optim.init_state(params, ocfg)}


def _placed_like(g: Tensor, p: Tensor) -> Tensor:
    """A gradient in its parameter's placements (autograd may return a
    DTensor gradient ``Partial`` or laid out otherwise)."""
    if rules.is_dtensor(g) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def _grads(params: Params, batch: Dict[str, Tensor], cfg: ModelConfig,
           mesh=None) -> Tuple[Dict[str, Tensor], Params]:
    """``loss_fn``'s metrics and gradient at ``params`` (autograd, the
    chunks rematerialized); a leaf the loss does not read (the token
    table of a model fed embeddings) gets a zero gradient, as
    ``jax.grad`` gives it.  On a ``mesh`` each gradient is laid out as
    its parameter."""
    params_l = tree_leaves(params)
    leaves = [p.detach().requires_grad_() for p in params_l]
    with torch.enable_grad():
        total, metrics = loss_fn(tree_unflatten(params, leaves), batch, cfg,
                                 mesh=mesh)
        grads = torch.autograd.grad(total, leaves, allow_unused=True,
                                    materialize_grads=True)
    if mesh is not None:
        grads = [_placed_like(g, p) for g, p in zip(grads, params_l)]
    return ({k: v.detach() for k, v in metrics.items()},
            tree_unflatten(params, grads))


def _split(v: Tensor, m: int, axis: int = 0) -> Tensor:
    """(..., B, ...) -> (m, ..., B / m, ...), B at ``axis``."""
    shape = tuple(v.shape)
    v = v.reshape(shape[:axis] + (m, shape[axis] // m) + shape[axis + 1:])
    return v.movedim(axis, 0)


def make_train_step(cfg: ModelConfig, ocfg: optim.OptimizerConfig,
                    microbatches: int = 1, mesh=None) -> Callable:
    """The plain train step; ``microbatches > 1`` splits the batch on its
    leading dim and accumulates the microbatches' gradients in f32 before
    one optimizer update (the same mean gradient, less activation
    memory).  ``positions`` split on their axis 1, as the reference's.
    On a ``mesh`` the state is :func:`init_train_state`'s on that mesh
    and the batch's tensors are every rank's whole tensors: the split
    comes before they are laid out, so that no microbatch gathers a
    batch sharded over ``data``."""

    def train_step(state: Dict[str, Any], batch: Dict[str, Tensor]):
        params = state["params"]
        if microbatches <= 1:
            metrics, grads = _grads(params, batch, cfg, mesh)
        else:
            if any(rules.is_dtensor(v) for v in batch.values()):
                raise TypeError("with microbatches, pass the batch as every "
                                "rank's whole tensors, not DTensors: a "
                                "DTensor batch would gather to be split")
            stacked = {k: _split(v, microbatches, int(k == "positions"))
                       for k, v in batch.items()}
            grads = tree_map(lambda p: torch.zeros_like(p, dtype=F32),
                             params)
            metrics = dict.fromkeys(("loss", "ce", "moe_aux"), 0.0)
            for i in range(microbatches):
                m, g = _grads(params, {k: v[i] for k, v in stacked.items()},
                              cfg, mesh)
                grads = tree_map(lambda a, x: a + x.to(F32), grads, g)
                metrics = {k: metrics[k] + m[k] for k in metrics}
            inv = 1.0 / microbatches
            grads = tree_map(lambda x: x * inv, grads)
            metrics = {k: v * inv for k, v in metrics.items()}
        params, opt, opt_metrics = optim.apply_updates(
            params, grads, state["opt"], ocfg)
        metrics.update(opt_metrics)
        return {"params": params, "opt": opt}, metrics

    return train_step


def make_prefill_step(cfg: ModelConfig) -> Callable:
    def prefill_step(params: Params, batch: Dict[str, Tensor]):
        return transformer.prefill(
            params, batch["inputs"], cfg,
            encoder_inputs=batch.get("encoder_inputs"))

    return prefill_step


def make_serve_step(cfg: ModelConfig) -> Callable:
    def serve_step(params: Params, tokens: Tensor, cache: Params,
                   index: int):
        return transformer.decode_step(params, tokens, cache, index, cfg)

    return serve_step


# ---------------------------------------------------------------------------
# Federated (the paper's technique at pod scale)
# ---------------------------------------------------------------------------

# Tokens whose forward and backward share one pass of the federated step
# when the caller does not say: on the H100's 80 GB, four xlstm-125m
# clients of 8 x 512 tokens (16,384) peaked at 53.5 GiB in one pass, and
# eight (32,768) ran out of memory (chip_smoke.py, path 13).
PASS_TOKENS = 16_384


def pass_size(num_clients: int, tokens_per_client: int,
              budget: int = PASS_TOKENS) -> int:
    """The clients a pass: the fewest passes whose clients hold at most
    ``budget`` tokens (one client at least), shared out evenly."""
    cap = max(1, budget // max(tokens_per_client, 1))
    passes = -(-num_clients // cap)
    return -(-num_clients // passes)


def make_federated_train_step(cfg: ModelConfig, ocfg: optim.OptimizerConfig,
                              num_clients: int,
                              clients_per_pass: Optional[int] = None,
                              mesh=None) -> Callable:
    """FedAvg-weighted gradient step over client-sharded batches.

    batch["inputs"] / ["labels"]: (num_clients, per_client_batch, seq);
    batch["selected"]: (num_clients,) {0, 1} from the DAS scheduler;
    batch["sizes"]: (num_clients,) |D_k| for the FedAvg weights.

    The clients run in passes of ``clients_per_pass`` (None: the
    ``pass_size`` of the batch's tokens a client).  A pass takes its
    clients' gradients with one ``vmap(grad)`` and copies each leaf into
    its rows of one (K, P) f32 matrix (P the parameter count, each leaf a
    view at a fixed offset; one matrix a device, kept between steps),
    then frees them: the passes trade activation memory for the sLSTM's
    per-position launches, which run once a pass.  The rest of the step
    is :func:`federated_step`'s.  Raises for a configuration the clients
    cannot be mapped over (:func:`check_federated`).

    On a ``mesh`` (the state :func:`init_train_state`'s on it, the
    batch every rank's whole tensors) the clients run one at a time
    (:func:`client_grads_by_autograd`): ``clients_per_pass`` must then be
    None or 1.
    """
    check_federated(cfg)
    if mesh is None:
        grads = _client_grads_by_vmap(cfg, num_clients, clients_per_pass)
    elif clients_per_pass not in (None, 1):
        raise ValueError(f"on a mesh the federated step takes one client "
                         f"a pass, not {clients_per_pass}")
    else:
        grads = client_grads_by_autograd(cfg, mesh)
    return federated_step(ocfg, num_clients, grads, mesh)


# A client-gradient route: (params, inputs, labels, rows) -> (K,) ce.
# ``rows`` are each leaf's (K, n) f32 columns of the step's matrix, ``n``
# the numel of the leaf's shard on this rank (the leaf's on one device);
# the route writes client k's gradient of the leaf into row k.
ClientGrads = Callable[[Params, Tensor, Tensor, Tuple[Tensor, ...]], Tensor]


def _client_grads_by_vmap(cfg: ModelConfig, num_clients: int,
                          clients_per_pass: Optional[int]) -> ClientGrads:
    """Passes of clients, ``torch.func.vmap(torch.func.grad)`` a pass
    (the chunks not rematerialized)."""

    def client_loss(params, inputs, labels):
        total, metrics = loss_fn(params, {"inputs": inputs,
                                          "labels": labels}, cfg, remat=False)
        return total, metrics["ce"]

    client_grads = torch.func.vmap(torch.func.grad(client_loss, has_aux=True),
                                   in_dims=(None, 0, 0))

    def fill(params, inputs, labels, rows):
        n = clients_per_pass or pass_size(num_clients, inputs[0].numel())
        ces = []
        for lo in range(0, num_clients, n):
            hi = min(lo + n, num_clients)
            grads, ce = client_grads(params, inputs[lo:hi], labels[lo:hi])
            for row, g in zip(rows, tree_leaves(grads)):
                row[lo:hi].copy_(g.reshape(hi - lo, -1))
            del grads
            ces.append(ce)
        return torch.cat(ces)

    return fill


def client_grads_by_autograd(cfg: ModelConfig, mesh=None) -> ClientGrads:
    """One client at a time, :func:`_grads` (``autograd.grad``, the
    chunks rematerialized): the route on a ``mesh``, where
    ``torch.func.vmap`` cannot map a model whose layers lay DTensors out.
    Each client's gradient is laid out as its parameter, and this rank's
    shard of every leaf (a leaf it holds whole, whole) fills its row.
    Without a mesh it is the same route on one device."""

    def fill(params, inputs, labels, rows):
        ces = []
        for c in range(inputs.shape[0]):
            metrics, grads = _grads(
                params, {"inputs": inputs[c], "labels": labels[c]}, cfg,
                mesh)
            for row, g in zip(rows, tree_leaves(grads)):
                row[c].copy_(rules.local(g).reshape(-1))
            del grads
            ces.append(rules.local(metrics["ce"]).reshape(1))
        return torch.cat(ces)

    return fill


def federated_step(ocfg: optim.OptimizerConfig, num_clients: int,
                   client_grads: ClientGrads, mesh=None) -> Callable:
    """The federated step around a client-gradient route: the clients'
    gradients fill the rows of one (K, P) f32 matrix (on a ``mesh``, each
    rank's (K, P_local) of its shards), the weights ``w_k = selected_k
    |D_k| / max(sum(selected |D|), 1e-9)`` are formed on the device, and
    one ``fedavg_agg`` launch reduces the matrix to the update (on a mesh
    each rank's shard of it: FedAvg is column-wise, so it needs no
    collective; the wrapper takes the plain local matrix), whose views
    are the parameters' leaves (wrapped as DTensors in their placements
    on a mesh).  Unselected clients are computed and weighted 0, as in
    the reference.  Metrics: ``ce = sum_k ce_k w_k`` and ``n_selected``
    (replicated on a mesh), with the optimizer's."""
    mats: Dict[torch.device, Tensor] = {}

    def train_step(state: Dict[str, Any], batch: Dict[str, Tensor]):
        params = state["params"]
        leaves = tree_leaves(params)
        local = [rules.local(p) for p in leaves]
        sizes = [t.numel() for t in local]
        dev = local[0].device
        if dev not in mats:
            mats[dev] = torch.empty((num_clients, sum(sizes)), dtype=F32,
                                    device=dev)
        u = mats[dev]
        w = batch["selected"].to(F32) * batch["sizes"].to(F32)
        w = w / torch.clamp_min(torch.sum(w), 1e-9)
        with record_function("federated/client_grads"):
            ce = client_grads(params, batch["inputs"], batch["labels"],
                              torch.split(u, sizes, dim=1))
        with record_function("federated/fedavg_agg"):
            agg = fedavg_agg(u, w)
        mean = tree_unflatten(params, (
            rules.like(flat.view(t.shape).to(p.dtype), p)
            for flat, t, p in zip(torch.split(agg, sizes), local, leaves)))
        with record_function("federated/optimizer"):
            params, opt, opt_metrics = optim.apply_updates(
                params, mean, state["opt"], ocfg)
        metrics = {"ce": rules.replicated(torch.sum(ce * w), mesh),
                   **opt_metrics,
                   "n_selected": rules.replicated(
                       torch.sum(batch["selected"]), mesh)}
        return {"params": params, "opt": opt}, metrics

    return train_step

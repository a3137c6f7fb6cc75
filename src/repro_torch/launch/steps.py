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
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from repro_torch import optim
from repro_torch.kernels.fedavg_agg import fedavg_agg
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig
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


def _chunk_loss(xc: Tensor, lc: Tensor, head: Tensor,
                softcap: float) -> Tensor:
    logits = xc @ head.to(xc.dtype)
    if softcap > 0.0:
        logits = softcap * torch.tanh(logits / softcap)
    logits = logits.to(F32)
    lse = torch.logsumexp(logits, dim=-1)
    # Labels in int64, or the reference's int32 as the dry run feeds them.
    gold = torch.take_along_dim(logits, lc.long()[..., None], dim=-1)[..., 0]
    return torch.sum(lse - gold)


def chunked_xent(hidden: Tensor, head: Tensor, labels: Tensor,
                 cfg: ModelConfig, num_chunks: int = 8,
                 remat: bool = True) -> Tensor:
    """Sequence-chunked softmax cross-entropy, the LM head folded in.

    With ``remat`` each chunk's head product and loss run under a
    non-reentrant ``torch.utils.checkpoint``: only per-chunk scalars
    survive the forward and the backward recomputes one chunk's (B, S/n,
    V) logits at a time.  ``remat=False`` keeps every chunk's logits (the
    only form ``torch.func`` transforms).
    """
    b, s, _ = hidden.shape
    if s % num_chunks:
        num_chunks = 1
    cs = s // num_chunks
    total = torch.zeros((), dtype=F32, device=hidden.device)
    for i in range(num_chunks):
        args = (hidden[:, i * cs:(i + 1) * cs], labels[:, i * cs:(i + 1) * cs],
                head, cfg.logits_softcap)
        total = total + (checkpoint(_chunk_loss, *args, use_reentrant=False)
                         if remat else _chunk_loss(*args))
    return total / (b * s)


def loss_fn(params: Params, batch: Dict[str, Tensor], cfg: ModelConfig,
            remat: bool = True) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Token cross-entropy plus the weighted MoE aux loss; ``batch`` may
    carry ``positions`` (M-RoPE's (3, B, S)) and ``encoder_inputs``."""
    hidden, aux = transformer.forward(
        params, batch["inputs"], cfg, positions=batch.get("positions"),
        encoder_inputs=batch.get("encoder_inputs"), return_hidden=True)
    ce = chunked_xent(hidden, transformer.head_matrix(params, cfg),
                      batch["labels"], cfg, remat=remat)
    total = ce + cfg.router_aux_weight * aux
    return total, {"loss": total, "ce": ce, "moe_aux": aux}


def init_train_state(gen: torch.Generator, cfg: ModelConfig,
                     ocfg: optim.OptimizerConfig) -> Dict[str, Any]:
    """Parameters drawn from ``gen`` on its device, and a fresh optimizer
    state."""
    params = transformer.init(gen, cfg)
    return {"params": params, "opt": optim.init_state(params, ocfg)}


def _grads(params: Params, batch: Dict[str, Tensor], cfg: ModelConfig
           ) -> Tuple[Dict[str, Tensor], Params]:
    """``loss_fn``'s metrics and gradient at ``params`` (autograd, the
    chunks rematerialized); a leaf the loss does not read (the token
    table of a model fed embeddings) gets a zero gradient, as
    ``jax.grad`` gives it."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    with torch.enable_grad():
        total, metrics = loss_fn(tree_unflatten(params, leaves), batch, cfg)
        grads = torch.autograd.grad(total, leaves, allow_unused=True,
                                    materialize_grads=True)
    return ({k: v.detach() for k, v in metrics.items()},
            tree_unflatten(params, grads))


def _split(v: Tensor, m: int, axis: int = 0) -> Tensor:
    """(..., B, ...) -> (m, ..., B / m, ...), B at ``axis``."""
    shape = tuple(v.shape)
    v = v.reshape(shape[:axis] + (m, shape[axis] // m) + shape[axis + 1:])
    return v.movedim(axis, 0)


def make_train_step(cfg: ModelConfig, ocfg: optim.OptimizerConfig,
                    microbatches: int = 1) -> Callable:
    """The plain train step; ``microbatches > 1`` splits the batch on its
    leading dim and accumulates the microbatches' gradients in f32 before
    one optimizer update (the same mean gradient, less activation
    memory).  ``positions`` split on their axis 1, as the reference's."""

    def train_step(state: Dict[str, Any], batch: Dict[str, Tensor]):
        params = state["params"]
        if microbatches <= 1:
            metrics, grads = _grads(params, batch, cfg)
        else:
            stacked = {k: _split(v, microbatches, int(k == "positions"))
                       for k, v in batch.items()}
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=F32,
                                                   device=p.device), params)
            metrics = dict.fromkeys(("loss", "ce", "moe_aux"), 0.0)
            for i in range(microbatches):
                m, g = _grads(params, {k: v[i] for k, v in stacked.items()},
                              cfg)
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
                              clients_per_pass: Optional[int] = None
                              ) -> Callable:
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
    per-position launches, which run once a pass.
    The weights ``w_k = selected_k |D_k| / max(sum(selected |D|), 1e-9)``
    are formed on the device, and one ``fedavg_agg`` launch reduces the
    matrix to the update.  Unselected clients are computed and weighted
    0, as in the reference.  Metrics: ``ce = sum_k ce_k w_k`` and
    ``n_selected``, with the optimizer's.  Raises for a configuration
    the clients cannot be mapped over (:func:`check_federated`).
    """
    check_federated(cfg)

    def client_loss(params, inputs, labels):
        total, metrics = loss_fn(params, {"inputs": inputs,
                                          "labels": labels}, cfg, remat=False)
        return total, metrics["ce"]

    client_grads = torch.func.vmap(torch.func.grad(client_loss, has_aux=True),
                                   in_dims=(None, 0, 0))
    mats: Dict[torch.device, Tensor] = {}

    def train_step(state: Dict[str, Any], batch: Dict[str, Tensor]):
        params = state["params"]
        leaves = tree_leaves(params)
        sizes = [p.numel() for p in leaves]
        dev = leaves[0].device
        if dev not in mats:
            mats[dev] = torch.empty((num_clients, sum(sizes)), dtype=F32,
                                    device=dev)
        u = mats[dev]
        inputs, labels = batch["inputs"], batch["labels"]
        n = clients_per_pass or pass_size(num_clients, inputs[0].numel())
        w = batch["selected"].to(F32) * batch["sizes"].to(F32)
        w = w / torch.clamp_min(torch.sum(w), 1e-9)
        ces = []
        with record_function("federated/client_grads"):
            rows = torch.split(u, sizes, dim=1)
            for lo in range(0, num_clients, n):
                hi = min(lo + n, num_clients)
                grads, ce = client_grads(params, inputs[lo:hi],
                                         labels[lo:hi])
                for row, g in zip(rows, tree_leaves(grads)):
                    row[lo:hi].copy_(g.reshape(hi - lo, -1))
                del grads
                ces.append(ce)
        with record_function("federated/fedavg_agg"):
            agg = fedavg_agg(u, w)
        mean = tree_unflatten(params, (
            flat.view(p.shape).to(p.dtype)
            for flat, p in zip(torch.split(agg, sizes), leaves)))
        with record_function("federated/optimizer"):
            params, opt, opt_metrics = optim.apply_updates(
                params, mean, state["opt"], ocfg)
        metrics = {"ce": torch.sum(torch.cat(ces) * w), **opt_metrics,
                   "n_selected": torch.sum(batch["selected"])}
        return {"params": params, "opt": opt}, metrics

    return train_step

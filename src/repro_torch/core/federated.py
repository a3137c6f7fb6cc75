"""FEEL orchestration — the paper's Algorithm 1 (FedAvg + scheduling).

Port of the single-scenario driver of ``repro.core.federated`` and its
S-scenario batch (:func:`run_federated_batch`), with the
streaming-data, compressed-uplink and unreliable-uplink subsystems
(``FLConfig.stream`` / ``compression`` / ``faults``), dense-block
dispatch (``dispatch_cap``) and the reduced-precision carry
(``carry_dtype``), alone or together.  With ``FLConfig.events`` the run
is the event-driven asynchronous driver of :mod:`repro_torch.core.events`
instead (one scenario or a batch), built from the same round helpers.
Each synchronous round:

1. the diversity index (Eq. 4).  With static data the ``diversity``
   kernel computes the per-device label statistics once per run and
   :func:`diversity_index_from_stats` combines them with sizes and ages
   every round.  With ``stream`` the arrival process samples the round's
   count deltas and the ``stream_update`` kernel refreshes counts,
   statistics and staleness in one pass (:func:`_stream_round`);
2. a fading draw, and the codec's per-device payload bits (inflated by
   the expected retry multiplier with ``faults``);
3. scheduling (``core.scheduler``: DAS with the ``fused_pgd`` allocator
   runs the ``sub2_pgd`` kernel once per outer iteration), re-ranked by
   staleness and reliability;
4. with ``dispatch_cap``, the dense-block plan (:func:`dispatch_plan`):
   the admitted devices beyond the cap are dropped by schedule rank;
5. with ``faults``, the round's outages, retries, stragglers and
   dropouts, which decide which uploads land and the realized energy and
   round time;
6. masked local SGD of all K clients at once (``torch.func.vmap`` of
   ``grad``), unselected clients frozen; with ``dispatch_cap`` only the
   block's lanes train and scatter back to device order;
7. aggregation: FedAvg over the selected set (the ``fedavg_agg`` kernel
   with ``use_kernel_agg``); with ``faults``, over the uploads that
   landed (``fedavg_agg_masked``); with ``compression``, the updates go
   through the codec's lossy round trip with error feedback (the
   ``compress_update`` kernel) and are averaged by a plain product;
8. ages (reset by a delivered upload), reliability, streaming state,
   evaluation and per-round metrics.

With ``carry_dtype`` the state carried between rounds — the streaming
``hists``/``staleness`` and the ``(K, P)`` error-feedback residual — is
stored at reduced precision and upcast to f32 before any arithmetic, at
the reference's cast points.

:func:`run_federated_batch` runs S independent scenarios in lock step:
one dataset and initial model, each scenario its own network and random
tape.  Every tensor of a round carries a leading ``(S,)`` axis (the
scenarios' K clients train as S x K lanes of one ``vmap``), so each
kernel launches once a round for all of them, as often as in the single
driver's round: ``sub2_pgd`` once per DAS outer iteration (lanes that
converged are frozen, :func:`scheduler.das_schedule`), ``stream_update``,
``compress_update`` and the FedAvg kernels once, ``diversity`` once a
run.  The round's code is the single driver's (:func:`_rounds`).

:func:`run_federated_loop` is the reference's legacy per-round loop:
the same rounds (:func:`_rounds`), each round's record copied to the
host as the round ends, so it equals :func:`run_federated` bit for bit.

Each phase runs under a ``torch.profiler.record_function`` scope
(``stream_refresh``, ``schedule``, ``local_train``, ``aggregate`` through
:func:`repro_torch.telemetry.phase_scope`; ``evaluate``), so a profiler
trace splits a round by phase.  With ``FLConfig.telemetry`` every driver
also builds a per-round frame (:mod:`repro_torch.telemetry.record`),
kept on the device and returned stacked beside the metrics.

Randomness is an input: :class:`Draws` holds the fading gains, the
minibatch indices, the uniform draw abs/random rank on and the
subsystems' draws, one row per round (or event, :func:`sim_length`).
Without a tape they come from a ``torch.Generator`` seeded from
``seed``, on the run's device.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import math
from typing import (Callable, Dict, Iterator, List, Optional,
                    Sequence, Union)

import numpy as np
import torch
from torch import nn
from torch.profiler import record_function

from repro_torch import telemetry as telemetry_lib
from repro_torch.core import bandwidth, compression, diversity, faults, \
    scheduler, streaming, wireless
from repro_torch.core import events as events_lib
from repro_torch.data import partition as partition_lib
from repro_torch.data import synthetic
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import diversity as diversity_kernel
from repro_torch.kernels import fedavg_agg as fedavg_kernel
from repro_torch.models import paper_nets
from repro_torch.telemetry import health as telemetry_health
from repro_torch.telemetry import record as telemetry_record

Tensor = torch.Tensor
Params = Dict[str, Tensor]

# Storage dtypes of the reduced-precision carry (``FLConfig.carry_dtype``).
_CARRY_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class FLConfig:
    num_rounds: int = 15                  # paper: 15 rounds
    local_epochs: int = 1                 # E
    batch_size: int = 50                  # one shard per step
    learning_rate: float = 0.05
    momentum: float = 0.0
    num_classes: int = 10
    measure: str = "gini_simpson"
    index_weights: diversity.IndexWeights = diversity.IndexWeights()
    use_kernel_agg: bool = False          # FedAvg through the CUDA kernel
    # Streaming data: per-device counts evolve every round and the
    # scheduler re-ranks on the refreshed statistics.
    stream: Optional[streaming.StreamConfig] = None
    # Compressed uplinks: per-device payload bits price scheduling, the
    # lossy round trip shapes the aggregate, the EF residual carries.
    compression: Optional[compression.CompressionConfig] = None
    # Unreliable uplinks: outages, retries, stragglers, dropouts; FedAvg
    # keeps the uploads that landed.  An inert config equals None.
    faults: Optional[faults.FaultConfig] = None
    # Dense-block dispatch: train only an (n_cap, ...) block of the
    # admitted devices (stable rank order); the rest are dropped and
    # counted in ``n_dropped``.  None = the masked all-K path.
    dispatch_cap: Optional[int] = None
    # Storage dtype of the carried streaming stats and EF residual
    # ("bfloat16"/"float16"); arithmetic stays f32.  None or "float32" =
    # full precision.
    carry_dtype: Optional[str] = None
    # Event-driven asynchronous FEEL (core.events): availability-gated
    # dispatch, uploads landing after their compute + channel time, and
    # staleness-weighted buffered FedAvg.  None = synchronous rounds.
    events: Optional[events_lib.EventConfig] = None
    # Per-round telemetry frames (repro_torch.telemetry): when set and
    # not inert, every driver returns the stacked frames as a third
    # element.  They only observe; the primary outputs are unchanged.
    telemetry: Optional[telemetry_lib.TelemetryConfig] = None

    def __post_init__(self):
        if self.dispatch_cap is not None and self.dispatch_cap < 1:
            raise ValueError(f"dispatch_cap must be >= 1, got "
                             f"{self.dispatch_cap}")
        _carry_dtype(self)
        if self.events is not None and \
                not isinstance(self.events, events_lib.EventConfig):
            raise TypeError(f"FLConfig.events must be an "
                            f"events.EventConfig, got "
                            f"{type(self.events).__name__}")
        if self.telemetry is not None and not isinstance(
                self.telemetry, telemetry_lib.TelemetryConfig):
            raise TypeError(f"FLConfig.telemetry must be a "
                            f"telemetry.TelemetryConfig, got "
                            f"{type(self.telemetry).__name__}")


def sim_length(fcfg: FLConfig) -> int:
    """Rows of a run's metrics and tape: ``num_rounds`` for synchronous
    rounds, ``events.num_events`` (when set) for the event driver."""
    if fcfg.events is not None and fcfg.events.num_events is not None:
        return fcfg.events.num_events
    return fcfg.num_rounds


def _carry_dtype(fcfg: FLConfig) -> Optional[torch.dtype]:
    """Storage dtype of the dieted carry, or None (``"float32"``
    normalises to None: the state already is f32)."""
    if fcfg.carry_dtype is None or fcfg.carry_dtype == "float32":
        return None
    if fcfg.carry_dtype not in _CARRY_DTYPES:
        raise ValueError(
            f"carry_dtype must be one of bfloat16/float16/float32, got "
            f"{fcfg.carry_dtype!r}")
    return _CARRY_DTYPES[fcfg.carry_dtype]


@dataclasses.dataclass
class RoundRecord:
    round: int
    accuracy: float
    n_selected: int
    round_time: float
    energy_total: float
    energy_per_device: float
    selected: np.ndarray
    n_success: int = -1        # = n_selected on a reliable edge
    n_dropped: int = 0         # admitted but beyond the dispatch cap
    iterations: int = 0        # DAS outer iterations (0 for other methods)

    def __post_init__(self):
        if self.n_success < 0:
            self.n_success = self.n_selected


@dataclasses.dataclass
class RoundMetrics:
    """Per-round outputs stacked along a leading ``(R,)`` axis; the batch
    driver's carry ``(S, R, ...)``."""

    accuracy: Tensor      # (R,) NaN on rounds not evaluated
    n_selected: Tensor    # (R,) int32
    round_time: Tensor    # (R,)
    energy: Tensor        # (R, K) per-device joules (0 if unselected)
    energy_total: Tensor  # (R,)
    selected: Tensor      # (R, K) {0,1}
    iterations: Tensor    # (R,) int32 DAS outer iterations
    n_success: Tensor     # (R,) int32 uploads that landed
    n_dropped: Tensor     # (R,) int32 dropped by the dispatch cap


def _dict_to(d: Optional[Dict[str, Tensor]],
             dev: torch.device) -> Optional[Dict[str, Tensor]]:
    return None if d is None else {n: t.to(dev) for n, t in d.items()}


def _round_of(d: Dict[str, Tensor], r: int) -> Dict[str, Tensor]:
    return {n: t[r] for n, t in d.items()}


@dataclasses.dataclass
class Draws:
    """The run's random numbers, drawn up front or by the caller.

    ``gains`` (R, K) are the fading channel gains ``|g|^2`` (path loss
    included), ``batch_idx`` (R, K, max_steps, B) int64 the minibatch
    sample indices, ``sched_u`` (R, K) the uniform draw abs/random rank
    on (unused by DAS and full).  The subsystems' draws:

    * ``stream_init`` — the arrival process's ``init_draw``;
      ``stream`` — its per-round ``draw``, stacked on a leading (R,) axis;
    * ``faults`` — :func:`faults.draw_uniforms` stacked on (R,);
      ``chronic_z`` — the (K,) normal draw of :func:`faults.chronic_rates`;
    * ``comp_noise`` — (R, K, P) quantization noise, P in the order of
      the model's parameters.  Without it the stochastic codecs draw it
      one round at a time from the run's generator;
    * ``avail_init`` — the availability process's ``init_draw`` (diurnal:
      the shared phase uniform and the (K,) jitter normal); ``avail`` —
      its per-event ``draw`` (churn, diurnal: a (K,) uniform), stacked on
      (R,).  Event runs only.

    R is :func:`sim_length`: the rounds, or the events of an event run.
    A batch's tape (:func:`draw_tapes`) stacks S scenarios' tapes along a
    leading ``(S,)`` axis of every field and always holds the stochastic
    codecs' ``comp_noise``.
    """

    gains: Tensor
    batch_idx: Tensor
    sched_u: Optional[Tensor] = None
    stream_init: Optional[Dict[str, Tensor]] = None
    stream: Optional[Dict[str, Tensor]] = None
    faults: Optional[Dict[str, Tensor]] = None
    chronic_z: Optional[Tensor] = None
    comp_noise: Optional[Tensor] = None
    avail_init: Optional[Dict[str, Tensor]] = None
    avail: Optional[Dict[str, Tensor]] = None

    def to(self, dev: torch.device) -> "Draws":
        def move(t):
            return None if t is None else t.to(dev)
        return Draws(move(self.gains), move(self.batch_idx),
                     move(self.sched_u), _dict_to(self.stream_init, dev),
                     _dict_to(self.stream, dev), _dict_to(self.faults, dev),
                     move(self.chronic_z), move(self.comp_noise),
                     _dict_to(self.avail_init, dev),
                     _dict_to(self.avail, dev))


# ---------------------------------------------------------------------------
# Local training (vmapped over clients)
# ---------------------------------------------------------------------------

def make_local_trainer(loss_fn: Callable[[Params, Tensor, Tensor, Tensor],
                                         Tensor],
                       cfg: FLConfig) -> Callable:
    """Build the multi-step local SGD of all K clients at once.

    ``trainer(params, images, labels, mask, active, batch_idx, rows=None)``
    starts every client from the global ``params``, takes ``max_steps``
    steps with the minibatches ``batch_idx`` (K, max_steps, B) and
    freezes client k at step s where ``active[k, s] == 0`` — the
    reference's per-step ``active`` select.  Returns the stacked (K, ...)
    params.  ``rows`` (K,) names the data row each lane trains on (the
    dispatch block's devices); by default lane k trains on row k.

    A batch of S scenarios passes ``(S, ...)`` params (scenario s's
    global model), ``(S, K, max_steps)`` active, ``(S, K, max_steps, B)``
    minibatches and optionally ``(S, K)`` rows, over one shared dataset:
    the S x K clients train as one ``vmap`` and come back ``(S, K,
    ...)``.
    """
    vgrad = torch.func.vmap(torch.func.grad(loss_fn))

    def local_sgd(params: Params, images: Tensor, labels: Tensor,
                  mask: Tensor, active: Tensor, batch_idx: Tensor,
                  rows: Optional[Tensor] = None) -> Params:
        lead, n = active.shape[:-2], active.shape[-2]
        lanes = math.prod(lead) * n
        if rows is None:
            rows = torch.arange(n, device=images.device).expand(lead + (n,))
        rows = rows.reshape(lanes, 1)
        batch_idx = batch_idx.reshape((lanes,) + batch_idx.shape[-2:])
        active = active.reshape(lanes, -1)
        p = {}
        for name, t in params.items():
            leaf = t.shape[len(lead):]
            p[name] = t.reshape((-1, 1) + leaf).expand(
                (-1, n) + leaf).contiguous().view((lanes,) + leaf)
        vel = {name: torch.zeros_like(t) for name, t in p.items()}
        for s in range(active.shape[1]):
            idx = batch_idx[:, s]                       # (lanes, B)
            g = vgrad(p, synthetic.to_float(images[rows, idx]),
                      labels[rows, idx], mask[rows, idx])
            live = active[:, s] > 0.0
            for name in p:
                vel[name] = cfg.momentum * vel[name] + g[name]
                p_new = p[name] - cfg.learning_rate * vel[name]
                keep = live.view((lanes,) + (1,) * (p_new.dim() - 1))
                p[name] = torch.where(keep, p_new, p[name])
        return {name: t.reshape(lead + (n,) + t.shape[1:])
                for name, t in p.items()}

    return local_sgd


def _uniform_dtype(params: Params, what: str) -> None:
    dtypes = {t.dtype for t in params.values()}
    if len(dtypes) != 1:
        raise TypeError(f"{what} needs uniform leaf dtype, got "
                        f"{sorted(map(str, dtypes))}")


def _flat_updates(params: Params, client_params: Params,
                  lead: tuple = ()) -> Tensor:
    """The (K, P) client updates ``w_k - g``, leaves in ``params`` order;
    ``(S, K, P)`` for a batch whose leading axes are ``lead``."""
    k = next(iter(client_params.values())).shape[len(lead)]
    return torch.cat([(client_params[n] - t.unsqueeze(len(lead))).reshape(
        lead + (k, -1)) for n, t in params.items()], dim=-1)


def _apply_flat(params: Params, agg: Tensor) -> Params:
    """``g + agg`` with the (P,) ``agg`` cut back into ``params``'s leaves
    (an (S, P) ``agg`` into (S, ...) leaves)."""
    lead = agg.shape[:-1]
    out, offset = {}, 0
    for n, t in params.items():
        size = math.prod(t.shape[len(lead):])
        out[n] = t + agg[..., offset:offset + size].reshape(t.shape).to(
            t.dtype)
        offset += size
    return out


def _lane_dot(w: Tensor, t: Tensor) -> Tensor:
    """``sum_k w[k] t[k]`` over the K axis after ``w``'s lanes: a
    ``tensordot`` for (K,) weights, a batched product for (S, K)."""
    if w.dim() == 1:
        return torch.tensordot(w, t, dims=1)
    lead, k = w.shape[:-1], w.shape[-1]
    out = torch.matmul(w[..., None, :], t.reshape(lead + (k, -1)))
    return out.reshape(lead + t.shape[w.dim():])


def _lane_flag(flag: Tensor, t: Tensor) -> Tensor:
    """A per-lane flag shaped to broadcast against ``t``'s leaves."""
    return flag.reshape(flag.shape + (1,) * (t.dim() - flag.dim()))


def _lane_index(idx: Tensor) -> tuple:
    """The advanced index that picks ``idx``'s entries along the device
    axis lane by lane: ``(idx,)`` for (n,) indices, ``(scenario, idx)``
    for (S, n)."""
    if idx.dim() == 1:
        return (idx,)
    return (torch.arange(idx.shape[0], device=idx.device)[:, None], idx)


def fedavg_aggregate(client_params: Params, weights: Tensor,
                     use_kernel: bool = False) -> Params:
    """g <- sum_k (D_k / D_r) w_k (Alg. 1 line 12) over stacked params.

    ``weights`` are already normalised over the selected set.  The
    kernel path flattens every leaf into one (K, P) buffer, so the
    ``fedavg_agg`` kernel launches once per round.  (S, K) weights over
    (S, K, ...) client params aggregate each scenario: one (S, K, P)
    launch for all of them.
    """
    lead = weights.shape[:-1]
    if use_kernel:
        _uniform_dtype(client_params, "kernel FedAvg path")
        k = weights.shape[-1]
        flat = torch.cat([t.reshape(lead + (k, -1))
                          for t in client_params.values()], dim=-1)
        agg = fedavg_kernel.fedavg_agg(flat, weights.contiguous())
        out, offset = {}, 0
        for n, t in client_params.items():
            leaf = t.shape[len(lead) + 1:]
            size = math.prod(leaf)
            out[n] = agg[..., offset:offset + size].reshape(lead + leaf)
            offset += size
        return out
    return {n: _lane_dot(weights, t) for n, t in client_params.items()}


def fedavg_aggregate_masked(params: Params, client_params: Params,
                            weights: Tensor, mask: Tensor,
                            use_kernel: bool = False) -> Params:
    """Failure-aware FedAvg in update form: ``g' = g + sum_k w_k m_k
    (w^k - g)``, ``weights`` normalised by the caller over the success
    set and ``mask`` the upload-success indicator.  All-zero masked
    weights leave ``g`` unchanged with no branch.  The kernel path
    flattens the deltas once and launches ``fedavg_agg_masked`` (once
    for all scenarios of (S, K) rows)."""
    lead = weights.shape[:-1]
    if use_kernel:
        _uniform_dtype(params, "kernel FedAvg path")
        agg = fedavg_kernel.fedavg_agg_masked(
            _flat_updates(params, client_params, lead), weights.contiguous(),
            mask.contiguous())
        return _apply_flat(params, agg)
    return _masked_update(params, {n: client_params[n] - p.unsqueeze(
        len(lead)) for n, p in params.items()}, weights * mask)


def _masked_update(params: Params, deltas: Params, wm: Tensor) -> Params:
    """``g + sum_k wm_k delta_k`` leaf by leaf (broadcast-multiply-reduce
    over the stacked (K, ...) deltas): the plain update-form FedAvg of the
    fault-aware round and of the event driver's flush; (S, K) ``wm`` per
    scenario."""
    nl = wm.dim() - 1
    return {n: p + torch.sum(
        wm.reshape(wm.shape + (1,) * (p.dim() - nl)) * deltas[n],
        dim=nl).to(p.dtype) for n, p in params.items()}


# ---------------------------------------------------------------------------
# Dense-block dispatch
# ---------------------------------------------------------------------------

def dispatch_plan(selected: Tensor, n_cap: int
                  ) -> tuple[Tensor, Tensor, Tensor]:
    """Gather plan of the dense training block: ``(idx, sel_eff,
    n_dropped)``.

    ``idx`` holds the ``min(n_cap, K)`` devices that take the block's
    lanes, ``sel_eff`` the (K,) selection left after the cap, and
    ``n_dropped`` (int32) the admitted devices that did not fit.  The
    rank is a stable sort of ``-selected``: admitted devices first, in
    device order, as ``jnp.argsort``'s stable sort orders them.  No
    data-dependent shape, no host sync.  An (S, K) selection plans each
    scenario along its last axis: ``idx`` (S, n_cap), ``n_dropped`` (S,).
    """
    n_lanes = min(int(n_cap), selected.shape[-1])
    idx = torch.argsort(-selected, dim=-1, stable=True)[..., :n_lanes]
    sel_eff = torch.zeros_like(selected).scatter_(
        -1, idx, torch.gather(selected, -1, idx))
    n_dropped = (torch.sum(selected, dim=-1)
                 - torch.sum(sel_eff, dim=-1)).to(torch.int32)
    return idx, sel_eff, n_dropped


def _dispatch_accounting(result: scheduler.ScheduleResult,
                         sel_eff: Tensor) -> tuple[Tensor, Tensor]:
    """Re-price a scheduled round on the set left after the cap: dropped
    devices spend no energy, and the round lasts as long as the slowest
    device that trains."""
    energy = result.energy * sel_eff
    t_up = torch.where(torch.isinf(result.t_up),
                       torch.zeros_like(result.t_up), result.t_up)
    return energy, wireless.round_time(sel_eff, result.t_train, t_up)


def _masked_local_train(trainer: Callable, max_steps: int, cfg: FLConfig,
                        params: Params, images: Tensor, labels: Tensor,
                        mask: Tensor, sizes: Tensor, selected: Tensor,
                        batch_idx: Tensor,
                        dispatch_idx: Optional[Tensor] = None
                        ) -> tuple[Params, Tensor]:
    """Masked local SGD for all K clients -> (stacked params, FedAvg w).

    ``dispatch_idx`` (:func:`dispatch_plan`) trains only those lanes:
    the per-device operands are gathered into the block, and the trained
    params scatter back to the (K, ...) layout with the global model as
    filler, before FedAvg.  A device keeps its own minibatches
    (``batch_idx[idx]``) whatever its lane, so ``n_cap >= K`` gives the
    masked path's result.  With (S, K) rows (a batch; ``params`` (S,
    ...)) each scenario's clients start from its own model and every
    step runs the S x K lanes at once.
    """
    lead = selected.shape[:-1]
    with telemetry_lib.phase_scope("local_train"):
        steps_k = cfg.local_epochs * torch.ceil(
            sizes.to(torch.float32) / cfg.batch_size)
        step_idx = torch.arange(max_steps, dtype=torch.float32,
                                device=sizes.device)
        active = (step_idx < steps_k[..., None]).to(torch.float32)
        active = active * selected[..., None]       # frozen if unselected
        if dispatch_idx is None:
            client_params = trainer(params, images, labels, mask, active,
                                    batch_idx)
        else:
            lanes = _lane_index(dispatch_idx)
            block = trainer(params, images, labels, mask, active[lanes],
                            batch_idx[lanes], rows=dispatch_idx)
            k = selected.shape[-1]
            client_params = {}
            for n, t in params.items():
                full = t.unsqueeze(len(lead)).expand(
                    lead + (k,) + t.shape[len(lead):]).clone()
                full[lanes] = block[n]
                client_params[n] = full
    # FedAvg weights D_k / D_r over the selected set.
    w = sizes.to(torch.float32) * selected
    w = w / torch.clamp_min(torch.sum(w, dim=-1, keepdim=True), 1.0)
    return client_params, w


def _train_round(trainer: Callable, max_steps: int, cfg: FLConfig,
                 params: Params, images: Tensor, labels: Tensor,
                 mask: Tensor, sizes: Tensor, selected: Tensor,
                 batch_idx: Tensor,
                 dispatch_idx: Optional[Tensor] = None,
                 sig_fn: Optional[Callable] = None) -> Params:
    """Masked local training + FedAvg.  An empty selected set carries
    the previous model forward (the all-zero weights would replace it
    with zeros); the guard is a select per lane, no host sync.

    ``sig_fn`` (telemetry's signals group, :meth:`_Run.sig_fn`) observes
    the trained client params before the aggregation; with it the return
    grows a trailing ``(loss_delta, update_norm)`` pair."""
    client_params, w = _masked_local_train(
        trainer, max_steps, cfg, params, images, labels, mask, sizes,
        selected, batch_idx, dispatch_idx)
    obs = sig_fn(params, client_params) if sig_fn is not None else None
    with telemetry_lib.phase_scope("aggregate"):
        agg = fedavg_aggregate(client_params, w, cfg.use_kernel_agg)
        any_sel = torch.sum(selected, dim=-1) > 0.0
        new_params = {n: torch.where(_lane_flag(any_sel, p), agg[n], p)
                      for n, p in params.items()}
    return new_params if sig_fn is None else (new_params, obs)


def _train_round_faulty(trainer: Callable, max_steps: int, cfg: FLConfig,
                        params: Params, images: Tensor, labels: Tensor,
                        mask: Tensor, sizes: Tensor, selected: Tensor,
                        ok: Tensor, batch_idx: Tensor,
                        dispatch_idx: Optional[Tensor] = None,
                        sig_fn: Optional[Callable] = None) -> Params:
    """Fault-aware round: train the selected set (the failure comes at
    upload time), aggregate the ``ok`` set with weights renormalised
    over it (:func:`fedavg_aggregate_masked`).  ``sig_fn``: as in
    :func:`_train_round`."""
    client_params, _ = _masked_local_train(
        trainer, max_steps, cfg, params, images, labels, mask, sizes,
        selected, batch_idx, dispatch_idx)
    obs = sig_fn(params, client_params) if sig_fn is not None else None
    with telemetry_lib.phase_scope("aggregate"):
        w = sizes.to(torch.float32) * ok
        w = w / torch.clamp_min(torch.sum(w, dim=-1, keepdim=True), 1.0)
        new_params = fedavg_aggregate_masked(params, client_params, w, ok,
                                             cfg.use_kernel_agg)
    return new_params if sig_fn is None else (new_params, obs)


def flat_param_size(params: Params) -> int:
    """Total flattened coordinate count: the EF residual's width P."""
    return sum(t.numel() for t in params.values())


def _train_round_compressed(trainer: Callable, max_steps: int,
                            fcfg: FLConfig, codec: compression.Codec,
                            params: Params, images: Tensor, labels: Tensor,
                            mask: Tensor, sizes: Tensor, selected: Tensor,
                            batch_idx: Tensor, residual: Tensor,
                            gains: Tensor, index: Tensor,
                            noise: Optional[Tensor],
                            success: Optional[Tensor] = None,
                            dispatch_idx: Optional[Tensor] = None,
                            sig_fn: Optional[Callable] = None
                            ) -> tuple[Params, Tensor]:
    """Masked local training + compressed-uplink FedAvg.

    The (K, P) client updates go through the codec's round trip with
    error feedback (:func:`compression.apply_codec`); the decoded values
    are averaged onto the global model, ``g' = g + sum_k (D_k / D_r)
    c_k``, by a plain product as in the reference.  ``success`` renormalises
    the weights over the uploads that landed and folds a failed device's
    update back into its residual.  Under dispatch the off-block rows
    equal the global model, so their update is exactly zero.  With
    ``carry_dtype`` the residual arrives at storage precision, is upcast
    here and downcast after the codec.  Returns ``(params, residual)``,
    and the observation of ``sig_fn`` (as in :func:`_train_round`, on
    the raw updates before the codec) after them.
    """
    _uniform_dtype(params, "compressed uplink")
    cdt = _carry_dtype(fcfg)
    if cdt is not None:
        residual = residual.to(torch.float32)
    client_params, w = _masked_local_train(
        trainer, max_steps, fcfg, params, images, labels, mask, sizes,
        selected, batch_idx, dispatch_idx)
    updates = _flat_updates(params, client_params, selected.shape[:-1])
    obs = sig_fn(params, client_params, updates) if sig_fn is not None \
        else None
    with telemetry_lib.phase_scope("aggregate"):
        if success is not None:
            w = sizes.to(torch.float32) * selected * success
            w = w / torch.clamp_min(torch.sum(w, dim=-1, keepdim=True), 1.0)
        c, residual = compression.apply_codec(
            codec, updates, residual, selected, noise, fcfg.compression,
            gains, index, success=success)
        if cdt is not None:
            residual = residual.to(cdt)
        new_params = _apply_flat(params, _lane_dot(w, c))
    if sig_fn is None:
        return new_params, residual
    return new_params, residual, obs


def _max_local_steps(cfg: FLConfig, capacity: int) -> int:
    steps_per_epoch = max(1, -(-capacity // cfg.batch_size))
    return cfg.local_epochs * steps_per_epoch


def _sched_cfg(scfg: scheduler.SchedulerConfig,
               fcfg: FLConfig) -> scheduler.SchedulerConfig:
    """The round's scheduler config: ``local_epochs`` synced and, with
    faults, Sub1 admitting ``overprovision`` extra devices so the
    expected surviving set still meets the original floor."""
    sch = dataclasses.replace(scfg, local_epochs=fcfg.local_epochs)
    flt = faults.active(fcfg.faults)
    if flt is not None and flt.overprovision > 0:
        sch = dataclasses.replace(
            sch, n_min=sch.n_min + flt.overprovision,
            n_fixed=None if sch.n_fixed is None
            else sch.n_fixed + flt.overprovision)
    return sch


def _eval_mask(num_rounds: int, eval_every: int) -> np.ndarray:
    """Evaluate-or-skip schedule: every ``eval_every`` rounds + the last."""
    mask = np.zeros((num_rounds,), np.bool_)
    mask[::max(eval_every, 1)] = True
    mask[-1] = True
    return mask


# ---------------------------------------------------------------------------
# Streaming data
# ---------------------------------------------------------------------------

def _stream_size_cap(stream: streaming.StreamConfig, capacity: int) -> float:
    """Per-device count cap of a streaming run: streamed sizes drive the
    local step counts, so they stay within the padded sample buffers."""
    if stream.size_cap <= 0.0:
        return float(capacity)
    return min(float(stream.size_cap), float(capacity))


def _stream_round(process: streaming.ArrivalProcess, fcfg: FLConfig,
                  size_cap: float, measure_col: int,
                  draw: Dict[str, Tensor], st: streaming.StreamState,
                  ages: Tensor):
    """One round's data evolution: sample -> fused refresh -> index.

    Returns ``(index, sizes, staleness, refreshed hists, state)``.  With
    ``carry_dtype`` the carried hists and staleness arrive at storage
    precision and are upcast before any arithmetic.
    """
    with telemetry_lib.phase_scope("stream_refresh"):
        if _carry_dtype(fcfg) is not None:
            st = dataclasses.replace(
                st, hists=st.hists.to(torch.float32),
                staleness=st.staleness.to(torch.float32))
        deltas, arrivals, st = process.sample(draw, st, fcfg.stream)
        hists_r, stats, stale = streaming.refresh(
            st.hists, deltas, arrivals, st.staleness, st.selected_prev,
            fcfg.stream, size_cap=size_cap)
        sizes_r = stats[..., 2]
        index = diversity.diversity_index_from_stats(
            div=stats[..., measure_col], data_sizes=sizes_r, ages=ages,
            weights=fcfg.index_weights)
        return index, sizes_r, stale, hists_r, st


def _stream_advance(st: streaming.StreamState, hists_r: Tensor,
                    stale: Tensor, delivered: Tensor,
                    cdt: Optional[torch.dtype] = None
                    ) -> streaming.StreamState:
    """Post-decision update of the driver-owned streaming fields: the
    delivered set consumes the backlog on the next refresh.  ``cdt``
    (:func:`_carry_dtype`) downcasts the stored hists and staleness."""
    if cdt is not None:
        hists_r = hists_r.to(cdt)
        stale = stale.to(cdt)
    return dataclasses.replace(st, hists=hists_r, staleness=stale,
                               selected_prev=delivered, round=st.round + 1)


def _diet_stream_state(st: streaming.StreamState,
                       cdt: Optional[torch.dtype]) -> streaming.StreamState:
    """A fresh state's carried stats at storage precision, as
    :func:`_stream_advance` writes them."""
    if cdt is None:
        return st
    return dataclasses.replace(st, hists=st.hists.to(cdt),
                               staleness=st.staleness.to(cdt))


def client_histograms(data: partition_lib.ClientDataset,
                      num_classes: int) -> Tensor:
    """(K, C) per-device label histograms (Alg. 1 line 5)."""
    return diversity.label_histogram(data.labels, data.mask, num_classes)


def _host_metrics(metrics: RoundMetrics) -> RoundMetrics:
    return RoundMetrics(*(getattr(metrics, f.name).cpu().numpy()
                          for f in dataclasses.fields(metrics)))


def _records(m: RoundMetrics, start: int = 0) -> List[RoundRecord]:
    """Records from one run's metrics, already on the host as numpy, the
    first numbered ``start``."""
    history: List[RoundRecord] = []
    for r in range(m.selected.shape[0]):
        n_sel = int(m.n_selected[r])
        e_total = float(m.energy_total[r])
        history.append(RoundRecord(
            round=start + r, accuracy=float(m.accuracy[r]),
            n_selected=n_sel,
            round_time=float(m.round_time[r]), energy_total=e_total,
            energy_per_device=e_total / max(n_sel, 1),
            selected=np.asarray(m.selected[r]),
            n_success=int(m.n_success[r]), n_dropped=int(m.n_dropped[r]),
            iterations=int(m.iterations[r])))
    return history


def metrics_to_records(metrics: RoundMetrics) -> List[RoundRecord]:
    """One device->host transfer for the whole run's records."""
    return _records(_host_metrics(metrics))


def batch_metrics_to_records(metrics: RoundMetrics
                             ) -> List[List[RoundRecord]]:
    """Per-scenario record lists from ``(S, R, ...)`` stacked metrics:
    one device->host transfer for the whole batch, then scenario slices
    of the host copies."""
    host = _host_metrics(metrics)
    return [_records(RoundMetrics(*(getattr(host, f.name)[s]
                                    for f in dataclasses.fields(host))))
            for s in range(host.selected.shape[0])]


def _stack_draws(rounds: List[Dict[str, Tensor]]) -> Dict[str, Tensor]:
    if not rounds or not rounds[0]:
        return {}
    return {n: torch.stack([d[n] for d in rounds]) for n in rounds[0]}


def _stack_tapes(tapes: List[Draws]) -> Draws:
    """Scenario tapes stacked along a leading ``(S,)`` axis."""
    def stack(name):
        first = getattr(tapes[0], name)
        if first is None:
            return None
        if isinstance(first, dict):
            return _stack_draws([getattr(t, name) for t in tapes])
        return torch.stack([getattr(t, name) for t in tapes])
    return Draws(*(stack(f.name) for f in dataclasses.fields(Draws)))


# Fields of a tape with a round axis (the others are drawn once a run).
_PER_ROUND = ("gains", "batch_idx", "sched_u", "stream", "faults",
              "comp_noise", "avail")


def _round_major(draws: Draws) -> Draws:
    """A batch tape's ``(S, R, ...)`` per-round fields as contiguous
    ``(R, S, ...)``, so round ``r``'s rows are ``field[r]`` as in a
    single tape."""
    def move(t):
        return t.movedim(0, 1).contiguous()
    out = dataclasses.replace(draws)
    for name in _PER_ROUND:
        v = getattr(draws, name)
        if isinstance(v, dict):
            v = {n: move(t) for n, t in v.items()}
        elif v is not None:
            v = move(v)
        setattr(out, name, v)
    return out


def draw_tape(gen: torch.Generator, net: wireless.NetworkState,
              num_rounds: int, capacity: int, max_steps: int,
              batch_size: int, fcfg: Optional[FLConfig] = None,
              hists: Optional[Tensor] = None) -> Draws:
    """A whole run's :class:`Draws` from ``gen``, on ``net``'s device.

    ``num_rounds`` is the run's :func:`sim_length`.  ``fcfg`` adds the
    draws its subsystems need: with ``stream`` the arrival process's
    (``hists`` are the (K, C) initial histograms), with ``faults`` the
    fault uniforms and the chronic-rate normal draw, with ``events`` the
    availability process's.  The quantization noise is left out (the
    driver draws it per round).
    """
    dev = net.pathloss.device
    k = net.num_devices
    gains = torch.stack([wireless.sample_fading(gen, net)
                         for _ in range(num_rounds)])
    batch_idx = torch.randint(0, capacity,
                              (num_rounds, k, max_steps, batch_size),
                              generator=gen, device=dev)
    sched_u = torch.rand((num_rounds, k), generator=gen, device=dev)
    draws = Draws(gains, batch_idx, sched_u)
    if fcfg is None:
        return draws
    if fcfg.stream is not None:
        if hists is None:
            raise ValueError("stream draws need the (K, C) histograms")
        process = streaming.get_process(fcfg.stream.process)
        draws.stream_init = process.init_draw(gen, k, fcfg.stream, dev)
        st = process.init(draws.stream_init, hists.to(dev), fcfg.stream)
        per_round = []
        for _ in range(num_rounds):
            per_round.append(process.draw(gen, st, fcfg.stream))
            _, _, st = process.sample(per_round[-1], st, fcfg.stream)
            st = dataclasses.replace(st, round=st.round + 1)
        draws.stream = _stack_draws(per_round)
    flt = faults.active(fcfg.faults)
    if flt is not None:
        draws.faults = _stack_draws([faults.draw_uniforms(gen, k, flt, dev)
                                     for _ in range(num_rounds)])
        draws.chronic_z = torch.randn((k,), generator=gen, device=dev)
    if fcfg.events is not None:
        proc = events_lib.get_availability(fcfg.events.availability)
        draws.avail_init = proc.init_draw(gen, k, fcfg.events, dev)
        draws.avail = _stack_draws([proc.draw(gen, k, fcfg.events, dev)
                                    for _ in range(num_rounds)])
    return draws


def scenario_seeds(base_seed: int, start: int, count: int) -> List[int]:
    """Per-scenario generator seeds from global scenario indices:
    scenario ``i``'s seed is ``wireless.fold_seed(base_seed, i)`` for
    ``i`` in ``[start, start + count)``, so its tape depends only on
    ``(base_seed, i)``, never on the batch size or where a chunk starts
    (the port's counterpart of the reference's ``scenario_keys``)."""
    return [wireless.fold_seed(base_seed, i)
            for i in range(start, start + count)]


def tile_params(params: Params, num_scenarios: int) -> Params:
    """``num_scenarios`` copies of ``params`` stacked on a new axis 0:
    fresh ``(S, ...)`` buffers, the caller's params untouched."""
    return {n: t.expand((num_scenarios,) + t.shape).clone()
            for n, t in params.items()}


def draw_tapes(seeds: Sequence[int], nets: wireless.NetworkState,
               num_rounds: int, capacity: int, max_steps: int,
               batch_size: int, fcfg: Optional[FLConfig] = None,
               hists: Optional[Tensor] = None,
               num_coords: Optional[int] = None) -> Draws:
    """A batch's tape: scenario ``s``'s is exactly :func:`draw_tape` from a
    generator seeded with ``seeds[s]`` on ``nets.scenario(s)``, followed,
    for a stochastic codec, by the ``(K, num_coords)`` quantization noise
    a single run draws from the same generator round by round.  Every
    field stacked along a leading ``(S,)`` axis, on ``nets``'s device
    (set-up work: nothing here runs inside a round)."""
    dev = nets.pathloss.device
    comp = None if fcfg is None else fcfg.compression
    noisy = comp is not None and compression.get_codec(comp.codec).stochastic
    if noisy and num_coords is None:
        raise ValueError("a stochastic codec's tape needs num_coords (the "
                         "model's flat parameter count)")
    tapes = []
    for s, seed in enumerate(seeds):
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        net = nets.scenario(s)
        tape = draw_tape(gen, net, num_rounds, capacity, max_steps,
                         batch_size, fcfg, hists)
        if noisy:
            tape.comp_noise = torch.stack([
                torch.rand((net.num_devices, num_coords), generator=gen,
                           device=dev) for _ in range(num_rounds)])
        tapes.append(tape)
    return _stack_tapes(tapes)


def _check_tape(draws: Draws, fcfg: FLConfig, k_dev: int,
                max_steps: int, lead: tuple = ()) -> None:
    """``draws`` against the run: round-major, ``lead`` the batch's
    scenario axis after the rounds."""
    want = (sim_length(fcfg),) + lead + (k_dev, max_steps, fcfg.batch_size)
    if tuple(draws.batch_idx.shape) != want:
        raise ValueError(f"batch_idx must be (R, K, max_steps, B) = "
                         f"{want}, got {tuple(draws.batch_idx.shape)}")
    needs = []
    if fcfg.stream is not None:
        needs += ["stream_init", "stream"]
    flt = faults.active(fcfg.faults)
    if flt is not None:
        needs.append("faults")
        if flt.drop_prob > 0.0 and flt.chronic_spread > 0.0:
            needs.append("chronic_z")
    if fcfg.events is not None and events_lib.get_availability(
            fcfg.events.availability).stochastic:
        needs += ["avail_init", "avail"]
    comp = fcfg.compression
    if lead and comp is not None and \
            compression.get_codec(comp.codec).stochastic:
        needs.append("comp_noise")
    missing = [n for n in needs if getattr(draws, n) is None]
    if missing:
        raise ValueError(f"the tape lacks {missing} for the configured "
                         f"subsystems; build it with draw_tape(..., fcfg, "
                         f"hists) (a batch's with draw_tapes)")


# ---------------------------------------------------------------------------
# Full training driver (Alg. 1)
# ---------------------------------------------------------------------------

class _Run:
    """One run's set-up and the round steps the synchronous loop and the
    event loop (:mod:`repro_torch.core.events`) share.

    Holds the world on the run's device, the model's params, the local
    trainer, the round's scheduler config, the random tape and the
    subsystems' initial state (``st``, ``residual``, ``rel``).

    ``seed`` a sequence of S seeds makes it a batch of S scenarios over
    the stacked ``net``: ``lead = (S,)`` leads every per-device tensor,
    the params are tiled ``(S, ...)`` and the tape is
    :func:`draw_tapes`' (or the caller's, ``(S, R, ...)``), kept
    round-major.  One scenario has ``lead = ()``.

    With ``FLConfig.telemetry`` it also builds each round's frame
    (:meth:`frame`) and, for the signals group, observes each round's
    training (``sig_fn``, None without the group).
    """

    def __init__(self, model: nn.Module, data: partition_lib.ClientDataset,
                 net: wireless.NetworkState, wcfg: wireless.WirelessConfig,
                 scfg: scheduler.SchedulerConfig, fcfg: FLConfig,
                 seed: Union[int, Sequence[int]], draws: Optional[Draws],
                 eval_every: int, device: DeviceLike):
        dev = self.dev = resolve_device(device)
        batch = not isinstance(seed, (int, np.integer))
        self.lead = (len(seed),) if batch else ()
        self.fcfg, self.wcfg = fcfg, wcfg
        self.data = data = data.to(dev)
        self.net = net = net.to(dev)
        self.k, cap = data.num_devices, data.capacity
        if tuple(net.pathloss.shape) != self.lead + (self.k,):
            raise ValueError(f"the network's rows must be "
                             f"{self.lead + (self.k,)}, got "
                             f"{tuple(net.pathloss.shape)}")
        self.model = copy.deepcopy(model).to(dev)
        self.params = paper_nets.params_of(self.model)
        self.n_coords = n_coords = flat_param_size(self.params)
        if batch:
            self.params = tile_params(self.params, len(seed))
        loss_fn = functools.partial(paper_nets.loss_fn, self.model)
        self.length = sim_length(fcfg)
        self.max_steps = _max_local_steps(fcfg, cap)
        self.trainer = make_local_trainer(loss_fn, fcfg)
        self.sch = _sched_cfg(scfg, fcfg)
        self.do_eval = _eval_mask(self.length, eval_every)
        self.n_cap = fcfg.dispatch_cap
        self.cdt = _carry_dtype(fcfg)
        stream, comp = fcfg.stream, fcfg.compression
        self.flt = flt = faults.active(fcfg.faults)
        hists = client_histograms(data, fcfg.num_classes) \
            if stream is not None else None
        self.gen = None
        if batch:
            if draws is None:
                draws = draw_tapes(seed, net, self.length, cap,
                                   self.max_steps, fcfg.batch_size, fcfg,
                                   hists, n_coords)
            draws = _round_major(draws.to(dev))
        else:
            self.gen = torch.Generator(device=dev)
            self.gen.manual_seed(seed)
            if draws is None:
                draws = draw_tape(self.gen, net, self.length, cap,
                                  self.max_steps, fcfg.batch_size, fcfg,
                                  hists)
        self.draws = draws = draws.to(dev)
        _check_tape(draws, fcfg, self.k, self.max_steps, self.lead)
        self.sizes = data.sizes.expand(self.lead + (self.k,))

        self.st = None
        if stream is None:
            # The labels never change: one kernel launch per run.
            stats = diversity_kernel.diversity_stats(
                data.labels.to(torch.int32).contiguous(),
                data.mask.contiguous(), fcfg.num_classes)
            self.div = stats[:, diversity.measure_column(fcfg.measure)]
        else:
            self.process = streaming.get_process(stream.process)
            self.size_cap = _stream_size_cap(stream, cap)
            self.measure_col = diversity.measure_column(fcfg.measure)
            self.st = _diet_stream_state(self.process.init(
                draws.stream_init,
                hists.expand(self.lead + hists.shape).contiguous(), stream),
                self.cdt)
        self.residual = None
        if comp is not None:
            self.codec = compression.get_codec(comp.codec)
            self.residual = torch.zeros(
                self.lead + (self.k, n_coords),
                dtype=self.cdt or torch.float32, device=dev)
        self.rel = None
        if flt is not None:
            self.exp_mult = faults.expected_time_mult(flt)
            self.drop_rates = faults.chronic_rates(draws.chronic_z, flt)
            self.rel = torch.ones(self.lead + (self.k,),
                                  dtype=torch.float32, device=dev)
        self.test_x = synthetic.to_float(data.test_images)
        self.nan = torch.full(self.lead, math.nan, device=dev)
        self.accuracy = functools.partial(paper_nets.accuracy, self.model)
        if batch:
            self.accuracy = torch.func.vmap(self.accuracy,
                                            in_dims=(0, None, None))
        self.tel = tel = telemetry_lib.active(fcfg.telemetry)
        self.probe = None
        if tel is not None and tel.signals:
            self.probe = telemetry_health.make_signal_probe(
                loss_fn, min(fcfg.batch_size, cap,
                             telemetry_health.PROBE_CAP))

    @property
    def sig_fn(self) -> Optional[Callable]:
        """The signals group's observer of a round's training, or None
        without the group.  A property, not an attribute holding the
        bound method: that would make a reference cycle, and the run's
        device tensors would outlive it until the cycle collector ran."""
        return None if self.probe is None else self._observe

    def _observe(self, params: Params, client_params: Params,
                 updates: Optional[Tensor] = None) -> tuple[Tensor, Tensor]:
        """The signals group's observation of a round's training: each
        device's loss delta on its probe window and its update's norm
        (``updates`` the round's flat update matrix, built here when the
        round has none)."""
        if updates is None:
            updates = telemetry_health.flatten_updates(client_params,
                                                       params, self.lead)
        data = self.data
        return (self.probe(params, client_params, data.images, data.labels,
                           data.mask, self.lead),
                telemetry_health.update_norms(updates))

    def signal_init(self) -> Optional[telemetry_health.SignalState]:
        """The signals carry's start, or None without the group."""
        if self.sig_fn is None:
            return None
        return telemetry_health.signal_init(self.k, self.lead, self.dev)

    def frame(self, r: int, result: scheduler.ScheduleResult,
              admitted: Tensor, selected: Tensor, ok: Tensor,
              energy: Tensor, payload: Optional[Tensor], gains: Tensor,
              index: Tensor, ages: Tensor, stale: Optional[Tensor],
              rel: Optional[Tensor], draw,
              sigst: Optional[telemetry_health.SignalState],
              obs: Optional[tuple]) -> Dict[str, Tensor]:
        """Round ``r``'s telemetry frame, from the values the scheduler
        saw (``ages``, ``rel``, ``stale``) and the round's outcome."""
        sched_u = self.draws.sched_u
        return telemetry_record.round_frame(
            self.tel, result=result, admitted=admitted, sel_eff=selected,
            ok=ok, energy=energy, payload_bits=payload, gains=gains,
            net=self.net, wcfg=self.wcfg, sch=self.sch,
            sched_u=None if sched_u is None else sched_u[r], index=index,
            ages=ages, staleness=stale, reliability=rel, draw=draw,
            signals=None if obs is None
            else telemetry_health.signals_frame(sigst, ok, *obs))

    def index(self, r: int, st: Optional[streaming.StreamState],
              ages: Tensor):
        """The round's diversity index: ``(index, sizes, staleness,
        refreshed hists, stream state)`` (the last three None or
        unchanged with static data)."""
        if st is None:
            with telemetry_lib.phase_scope("schedule"):
                index = diversity.diversity_index_from_stats(
                    div=self.div, data_sizes=self.sizes, ages=ages,
                    weights=self.fcfg.index_weights)
            return index, self.sizes, None, None, None
        return _stream_round(self.process, self.fcfg, self.size_cap,
                             self.measure_col,
                             _round_of(self.draws.stream, r), st, ages)

    def schedule(self, r: int, index: Tensor, ages: Tensor,
                 sizes: Tensor, gains: Tensor, stale: Optional[Tensor],
                 rel: Optional[Tensor]
                 ) -> tuple[scheduler.ScheduleResult, Optional[Tensor]]:
        """Payload bits and the schedule -> ``(result, payload bits)``."""
        comp = self.fcfg.compression
        with telemetry_lib.phase_scope("schedule"):
            payload = self.codec.payload_bits(comp, self.wcfg, gains, index) \
                if comp is not None else None
            # Scheduling prices retry-inflated bits, so Sub2's deadline
            # reserves the retransmission window before it happens.
            payload_sched = bandwidth.effective_payload_bits(
                payload, self.exp_mult, self.wcfg, gains) \
                if self.flt is not None else payload
            sched_u = self.draws.sched_u
            result = scheduler.schedule_impl(
                None if sched_u is None else sched_u[r], index, ages, sizes,
                gains, self.net, self.wcfg, self.sch, staleness=stale,
                payload_bits=payload_sched, reliability=rel)
        return result, payload

    def dispatch(self, selected: Tensor
                 ) -> tuple[Optional[Tensor], Tensor, Tensor]:
        """The dispatch plan -> ``(lanes or None, selection, n_dropped)``."""
        if self.n_cap is None:
            return None, selected, torch.zeros(self.lead, dtype=torch.int32,
                                               device=self.dev)
        return dispatch_plan(selected, self.n_cap)

    def realize(self, r: int, result: scheduler.ScheduleResult,
                selected: Tensor, gains: Tensor, payload: Optional[Tensor]):
        """The round's fault draw and realized accounting -> ``(ok,
        energy, round_time, fault draw or None)``."""
        if self.flt is None:
            if self.n_cap is None:
                return selected, result.energy, result.round_time, None
            energy, round_time = _dispatch_accounting(result, selected)
            return selected, energy, round_time, None
        draw, ok, energy, round_time = faults.fault_step(
            **_round_of(self.draws.faults, r), selected=selected,
            alpha=result.alpha, t_train=result.t_train, gains=gains,
            net=self.net, wcfg=self.wcfg, payload_bits=payload, cfg=self.flt,
            drop_rates=self.drop_rates)
        return ok, energy, round_time, draw

    def noise(self, r: int) -> Optional[Tensor]:
        """The round's quantization noise (stochastic codecs only)."""
        if not self.codec.stochastic:
            return None
        if self.draws.comp_noise is not None:
            return self.draws.comp_noise[r]
        return torch.rand(self.residual.shape, generator=self.gen,
                          device=self.dev)

    def evaluate(self, r: int, params: Params) -> Tensor:
        if not self.do_eval[r]:
            return self.nan
        with torch.no_grad(), record_function("evaluate"):
            return self.accuracy(params, self.test_x, self.data.test_labels)

    def advance(self, ages: Tensor, rel: Optional[Tensor],
                selected: Tensor, ok: Tensor):
        """Participation = delivered: ages reset and the reliability EMA
        moves only for uploads that landed -> ``(ages, rel)``."""
        ages = torch.where(ok > 0.0, 0, ages + 1).to(torch.int32)
        if self.flt is not None:
            rel = faults.reliability_update(rel, selected, ok, self.flt)
        return ages, rel

    def iterations(self, result: scheduler.ScheduleResult) -> Tensor:
        """The round's DAS outer iterations as a ``lead``-shaped int32
        tensor (a batch's are already one, per lane)."""
        if isinstance(result.iterations, Tensor):
            return result.iterations
        return torch.full(self.lead, result.iterations, dtype=torch.int32,
                          device=self.dev)

    def stack_frames(self, frames: List[Dict[str, Tensor]]
                     ) -> Optional[Dict[str, Tensor]]:
        """The run's frames on a round axis after ``lead``, or None
        without telemetry."""
        if self.tel is None:
            return None
        return telemetry_record.stack_frames(frames, dim=len(self.lead))


def run_federated(*, model: nn.Module,
                  data: partition_lib.ClientDataset,
                  net: wireless.NetworkState,
                  wcfg: wireless.WirelessConfig,
                  scfg: scheduler.SchedulerConfig,
                  fcfg: FLConfig, seed: int = 0,
                  draws: Optional[Draws] = None, eval_every: int = 1,
                  device: DeviceLike = None
                  ) -> tuple[Params, List[RoundRecord]]:
    """Run ``fcfg.num_rounds`` of FEEL; returns final params + records,
    and with ``fcfg.telemetry`` the stacked frames (``(R, ...)``
    leaves, :mod:`repro_torch.telemetry.record`) as a third element.

    ``model`` supplies the architecture and the initial weights (it is
    not modified); the returned params are a dict of tensors by
    parameter name on the run's device.  ``device=None`` means the CUDA
    card and raises without one; pass ``device="cpu"`` for the plain
    PyTorch path.  ``draws`` (on any device) replaces the generator
    draws, e.g. to replay another implementation's random numbers.
    With ``fcfg.events`` the run is the event-driven driver
    (:func:`repro_torch.core.events.run_events`): one record per event.
    """
    kw = dict(model=model, data=data, net=net, wcfg=wcfg, scfg=scfg,
              fcfg=fcfg, seed=seed, draws=draws, eval_every=eval_every,
              device=device)
    if fcfg.events is not None:
        params, records, _, *frames = events_lib.run_events(**kw)
        return (params, records, *frames)
    params, metrics, frames = _drive(_Run(**kw))
    out = (params, metrics_to_records(metrics))
    return out if frames is None else out + (frames,)


def run_federated_batch(*, model: nn.Module,
                        data: partition_lib.ClientDataset,
                        nets: wireless.NetworkState,
                        wcfg: wireless.WirelessConfig,
                        scfg: scheduler.SchedulerConfig,
                        fcfg: FLConfig, seeds: Sequence[int],
                        draws: Optional[Draws] = None, eval_every: int = 1,
                        device: DeviceLike = None
                        ) -> tuple[Params, RoundMetrics]:
    """Run S independent FEEL scenarios in lock step on one device.

    The dataset and ``model``'s initial weights are shared; scenario
    ``s`` has its own network ``nets.scenario(s)`` (leaves ``(S, K)``,
    :func:`wireless.sample_networks`) and its own random tape: by default
    :func:`draw_tapes` from ``seeds[s]`` (:func:`scenario_seeds`), so
    scenario ``s`` equals ``run_federated(seed=seeds[s])`` on its
    network; ``draws`` (fields ``(S, R, ...)``, any device) replaces it.
    Every subsystem runs, alone or composed, the event driver too
    (``fcfg.events``: the event loop of :mod:`repro_torch.core.events`
    with the scenario axis, one row per event).  Each kernel launches
    once a round (event) for all scenarios.

    Returns the final params stacked ``(S, ...)`` per leaf and
    :class:`RoundMetrics` with leading ``(S, R, ...)`` axes
    (:func:`batch_metrics_to_records` gives per-scenario records), and
    with ``fcfg.telemetry`` the frames with ``(S, R, ...)`` leaves.
    ``device=None`` means the CUDA card and raises without one.
    """
    if len(seeds) < 1:
        raise ValueError("run_federated_batch needs at least one seed")
    run = _Run(model=model, data=data, net=nets, wcfg=wcfg, scfg=scfg,
               fcfg=fcfg, seed=list(seeds), draws=draws,
               eval_every=eval_every, device=device)
    if fcfg.events is not None:
        params, metrics, _, frames = events_lib.drive_events(run)
    else:
        params, metrics, frames = _drive(run)
    return (params, metrics) if frames is None else \
        (params, metrics, frames)


def _rounds(run: _Run) -> Iterator[tuple[Params, tuple,
                                         Optional[Dict[str, Tensor]]]]:
    """The synchronous rounds of a run, one scenario or a batch (every
    tensor with ``run.lead`` in front): yields each round's ``(params,
    metrics row, frame)`` as the round ends, the row a tuple of
    :class:`RoundMetrics` fields and the frame None without telemetry.
    The one round body of :func:`_drive` and :func:`run_federated_loop`;
    it syncs the host only where the round's own steps do."""
    fcfg = run.fcfg
    stream, comp = fcfg.stream, fcfg.compression
    data, trainer, max_steps = run.data, run.trainer, run.max_steps
    params, st, residual, rel = run.params, run.st, run.residual, run.rel
    sig_fn, sigst = run.sig_fn, run.signal_init()
    ages = torch.zeros(run.lead + (run.k,), dtype=torch.int32,
                       device=run.dev)
    for r in range(fcfg.num_rounds):
        index, sizes_r, stale, hists_r, st = run.index(r, st, ages)
        gains = run.draws.gains[r]
        result, payload = run.schedule(r, index, ages, sizes_r, gains,
                                       stale, rel)
        # The dispatch plan runs right after scheduling, so faults,
        # training, ages and metrics all see the selection left after
        # the cap.
        didx, selected, n_dropped = run.dispatch(result.selected)
        ok, energy, round_time, draw = run.realize(r, result, selected,
                                                   gains, payload)
        batch_idx = run.draws.batch_idx[r]
        obs = None
        if comp is not None:
            out = _train_round_compressed(
                trainer, max_steps, fcfg, run.codec, params, data.images,
                data.labels, data.mask, sizes_r, selected, batch_idx,
                residual, gains, index, run.noise(r),
                success=None if draw is None else draw.success,
                dispatch_idx=didx, sig_fn=sig_fn)
            params, residual = out[:2]
        elif run.flt is not None:
            out = _train_round_faulty(
                trainer, max_steps, fcfg, params, data.images, data.labels,
                data.mask, sizes_r, selected, ok, batch_idx, didx, sig_fn)
        else:
            out = _train_round(trainer, max_steps, fcfg, params,
                               data.images, data.labels, data.mask,
                               sizes_r, selected, batch_idx, didx, sig_fn)
        if comp is None:
            params = out if sig_fn is None else out[0]
        if sig_fn is not None:
            obs = out[-1]
            # The round's observations fold in before the frame, so the
            # frame holds the carry a signal-aware scheduler would see.
            sigst = telemetry_health.signal_update(sigst, ok, *obs, energy)
        frame = None
        if run.tel is not None:
            frame = run.frame(r, result, result.selected, selected, ok,
                              energy, payload, gains, index, ages, stale,
                              rel, draw, sigst, obs)
        ages, rel = run.advance(ages, rel, selected, ok)
        if stream is not None:
            st = _stream_advance(st, hists_r, stale, ok, run.cdt)
        row = (run.evaluate(r, params),
               torch.sum(selected, dim=-1).to(torch.int32), round_time,
               energy, torch.sum(energy, dim=-1), selected,
               run.iterations(result),
               torch.sum(ok, dim=-1).to(torch.int32), n_dropped)
        yield params, row, frame


def _drive(run: _Run) -> tuple[Params, RoundMetrics,
                               Optional[Dict[str, Tensor]]]:
    """The synchronous rounds of a run (:func:`_rounds`) -> ``(params,
    RoundMetrics, frames)``, the frames stacked like the metrics, or None
    without telemetry; nothing leaves the device."""
    params, rows, frames = run.params, [], []
    for params, row, frame in _rounds(run):
        rows.append(row)
        frames.append(frame)
    return params, stack_metrics(rows, dim=len(run.lead)), \
        run.stack_frames(frames)


def run_federated_loop(*, model: nn.Module,
                       data: partition_lib.ClientDataset,
                       net: wireless.NetworkState,
                       wcfg: wireless.WirelessConfig,
                       scfg: scheduler.SchedulerConfig,
                       fcfg: FLConfig, seed: int = 0,
                       draws: Optional[Draws] = None, eval_every: int = 1,
                       device: DeviceLike = None
                       ) -> tuple[Params, List[RoundRecord]]:
    """The legacy per-round loop: :func:`run_federated`'s rounds, each
    round's :class:`RoundRecord` made on the host as the round ends.

    Takes :func:`run_federated`'s arguments and runs the same round body
    (:func:`_rounds`), so from the same seed or ``draws`` its records and
    parameters are :func:`run_federated`'s bit for bit, with the same
    kernel launches; it syncs the host every round to copy the round's
    metrics (and frame).  With ``fcfg.telemetry`` the return grows a
    third element: the frames as host numpy arrays stacked ``(R, ...)``,
    each round's copied as it ends.  ``device=None`` means the CUDA card
    and raises without one.  An event config (``fcfg.events``) raises
    ``ValueError``: the event driver has no per-round loop.
    """
    if fcfg.events is not None:
        raise ValueError(
            "FLConfig.events is set: the event-driven drivers have no "
            "legacy per-round loop (their reference is the synchronous-"
            "limit parity contract) — use run_federated / "
            "run_federated_batch")
    run = _Run(model=model, data=data, net=net, wcfg=wcfg, scfg=scfg,
               fcfg=fcfg, seed=seed, draws=draws, eval_every=eval_every,
               device=device)
    params, records, frames = run.params, [], []
    for r, (params, row, frame) in enumerate(_rounds(run)):
        records += _records(_host_metrics(stack_metrics([row])), start=r)
        if frame is not None:
            frames.append({n: t.cpu().numpy() for n, t in frame.items()})
    if run.tel is None:
        return params, records
    return params, records, {n: np.stack([f[n] for f in frames])
                             for n in (frames[0] if frames else ())}


def stack_metrics(rows: List[tuple], dim: int = 0) -> RoundMetrics:
    """Stack per-round ``RoundMetrics`` field tuples on a round axis at
    ``dim`` (1 for a batch's ``(S, R, ...)``)."""
    return RoundMetrics(*(torch.stack([row[i] for row in rows], dim=dim)
                          for i in range(len(dataclasses.fields(
                              RoundMetrics)))))

"""FEEL orchestration — the paper's Algorithm 1 (FedAvg + scheduling).

Port of the synchronous single-scenario driver of
``repro.core.federated``, with the streaming-data, compressed-uplink and
unreliable-uplink subsystems (``FLConfig.stream`` / ``compression`` /
``faults``), alone or together.  Each round:

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
4. with ``faults``, the round's outages, retries, stragglers and
   dropouts, which decide which uploads land and the realized energy and
   round time;
5. masked local SGD of all K clients at once (``torch.func.vmap`` of
   ``grad``), unselected clients frozen;
6. aggregation: FedAvg over the selected set (the ``fedavg_agg`` kernel
   with ``use_kernel_agg``); with ``faults``, over the uploads that
   landed (``fedavg_agg_masked``); with ``compression``, the updates go
   through the codec's lossy round trip with error feedback (the
   ``compress_update`` kernel) and are averaged by a plain product;
7. ages (reset by a delivered upload), reliability, streaming state,
   evaluation and per-round metrics.

Each phase runs under a ``torch.profiler.record_function`` scope
(``stream_refresh``, ``schedule``, ``local_train``, ``aggregate``,
``evaluate``), so a profiler trace splits a round by phase.

Randomness is an input: :class:`Draws` holds the fading gains, the
minibatch indices, the uniform draw abs/random rank on and the
subsystems' draws.  Without a tape they come from a ``torch.Generator``
seeded from ``seed``, on the run's device.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import math
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from torch import nn
from torch.profiler import record_function

from repro_torch.core import bandwidth, compression, diversity, faults, \
    scheduler, streaming, wireless
from repro_torch.data import partition as partition_lib
from repro_torch.data import synthetic
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import diversity as diversity_kernel
from repro_torch.kernels import fedavg_agg as fedavg_kernel
from repro_torch.models import paper_nets

Tensor = torch.Tensor
Params = Dict[str, Tensor]

# FLConfig fields whose subsystems are not ported yet, with the
# ROADMAP.md queue-1 item that ports each.
_NOT_PORTED = {
    "dispatch_cap": 9,
    "carry_dtype": 9,
    "events": 13,
    "telemetry": 14,
}


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
    # Optional subsystems of the reference not ported yet; each must
    # stay None here.
    dispatch_cap: Optional[int] = None
    carry_dtype: Optional[str] = None
    events: Optional[object] = None
    telemetry: Optional[object] = None

    def __post_init__(self):
        for name, item in _NOT_PORTED.items():
            if getattr(self, name) is not None:
                raise NotImplementedError(
                    f"FLConfig.{name} is not ported yet (ROADMAP.md "
                    f"queue 1, item {item})")


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
    n_dropped: int = 0         # no dispatch capacity on this path
    iterations: int = 0        # DAS outer iterations (0 for other methods)

    def __post_init__(self):
        if self.n_success < 0:
            self.n_success = self.n_selected


@dataclasses.dataclass
class RoundMetrics:
    """Per-round outputs stacked along a leading ``(R,)`` axis."""

    accuracy: Tensor      # (R,) NaN on rounds not evaluated
    n_selected: Tensor    # (R,) int32
    round_time: Tensor    # (R,)
    energy: Tensor        # (R, K) per-device joules (0 if unselected)
    energy_total: Tensor  # (R,)
    selected: Tensor      # (R, K) {0,1}
    iterations: Tensor    # (R,) int32 DAS outer iterations
    n_success: Tensor     # (R,) int32 uploads that landed
    n_dropped: Tensor     # (R,) int32


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
      one round at a time from the run's generator.
    """

    gains: Tensor
    batch_idx: Tensor
    sched_u: Optional[Tensor] = None
    stream_init: Optional[Dict[str, Tensor]] = None
    stream: Optional[Dict[str, Tensor]] = None
    faults: Optional[Dict[str, Tensor]] = None
    chronic_z: Optional[Tensor] = None
    comp_noise: Optional[Tensor] = None

    def to(self, dev: torch.device) -> "Draws":
        def move(t):
            return None if t is None else t.to(dev)
        return Draws(move(self.gains), move(self.batch_idx),
                     move(self.sched_u), _dict_to(self.stream_init, dev),
                     _dict_to(self.stream, dev), _dict_to(self.faults, dev),
                     move(self.chronic_z), move(self.comp_noise))


# ---------------------------------------------------------------------------
# Local training (vmapped over clients)
# ---------------------------------------------------------------------------

def make_local_trainer(loss_fn: Callable[[Params, Tensor, Tensor, Tensor],
                                         Tensor],
                       cfg: FLConfig) -> Callable:
    """Build the multi-step local SGD of all K clients at once.

    ``trainer(params, images, labels, mask, active, batch_idx)`` starts
    every client from the global ``params``, takes ``max_steps`` steps
    with the minibatches ``batch_idx`` (K, max_steps, B) and freezes
    client k at step s where ``active[k, s] == 0`` — the reference's
    per-step ``active`` select.  Returns the stacked (K, ...) params.
    """
    vgrad = torch.func.vmap(torch.func.grad(loss_fn))

    def local_sgd(params: Params, images: Tensor, labels: Tensor,
                  mask: Tensor, active: Tensor, batch_idx: Tensor) -> Params:
        k = images.shape[0]
        rows = torch.arange(k, device=images.device)[:, None]
        p = {n: t.expand(k, *t.shape).clone() for n, t in params.items()}
        vel = {n: torch.zeros_like(t) for n, t in p.items()}
        for s in range(active.shape[1]):
            idx = batch_idx[:, s]                       # (K, B)
            g = vgrad(p, synthetic.to_float(images[rows, idx]),
                      labels[rows, idx], mask[rows, idx])
            live = active[:, s] > 0.0
            for n in p:
                vel[n] = cfg.momentum * vel[n] + g[n]
                p_new = p[n] - cfg.learning_rate * vel[n]
                keep = live.view((k,) + (1,) * (p_new.dim() - 1))
                p[n] = torch.where(keep, p_new, p[n])
        return p

    return local_sgd


def _uniform_dtype(params: Params, what: str) -> None:
    dtypes = {t.dtype for t in params.values()}
    if len(dtypes) != 1:
        raise TypeError(f"{what} needs uniform leaf dtype, got "
                        f"{sorted(map(str, dtypes))}")


def _flat_updates(params: Params, client_params: Params) -> Tensor:
    """The (K, P) client updates ``w_k - g``, leaves in ``params`` order."""
    k = next(iter(client_params.values())).shape[0]
    return torch.cat([(client_params[n] - t[None]).reshape(k, -1)
                      for n, t in params.items()], dim=1)


def _apply_flat(params: Params, agg: Tensor) -> Params:
    """``g + agg`` with the (P,) ``agg`` cut back into ``params``'s leaves."""
    out, offset = {}, 0
    for n, t in params.items():
        out[n] = t + agg[offset:offset + t.numel()].reshape(t.shape).to(
            t.dtype)
        offset += t.numel()
    return out


def fedavg_aggregate(client_params: Params, weights: Tensor,
                     use_kernel: bool = False) -> Params:
    """g <- sum_k (D_k / D_r) w_k (Alg. 1 line 12) over stacked params.

    ``weights`` are already normalised over the selected set.  The
    kernel path flattens every leaf into one (K, P) buffer, so the
    ``fedavg_agg`` kernel launches once per round.
    """
    if use_kernel:
        _uniform_dtype(client_params, "kernel FedAvg path")
        leaves = list(client_params.values())
        k = leaves[0].shape[0]
        flat = torch.cat([t.reshape(k, -1) for t in leaves], dim=1)
        agg = fedavg_kernel.fedavg_agg(flat, weights.contiguous())
        out, offset = {}, 0
        for n, t in client_params.items():
            size = math.prod(t.shape[1:])
            out[n] = agg[offset:offset + size].reshape(t.shape[1:])
            offset += size
        return out
    return {n: torch.tensordot(weights, t, dims=1)
            for n, t in client_params.items()}


def fedavg_aggregate_masked(params: Params, client_params: Params,
                            weights: Tensor, mask: Tensor,
                            use_kernel: bool = False) -> Params:
    """Failure-aware FedAvg in update form: ``g' = g + sum_k w_k m_k
    (w^k - g)``, ``weights`` normalised by the caller over the success
    set and ``mask`` the upload-success indicator.  All-zero masked
    weights leave ``g`` unchanged with no branch.  The kernel path
    flattens the deltas once and launches ``fedavg_agg_masked``."""
    if use_kernel:
        _uniform_dtype(params, "kernel FedAvg path")
        agg = fedavg_kernel.fedavg_agg_masked(
            _flat_updates(params, client_params), weights.contiguous(),
            mask.contiguous())
        return _apply_flat(params, agg)
    wm = weights * mask
    return {n: p + torch.sum(
        wm.reshape(wm.shape + (1,) * p.dim()) * (client_params[n] - p[None]),
        dim=0).to(p.dtype) for n, p in params.items()}


def _masked_local_train(trainer: Callable, max_steps: int, cfg: FLConfig,
                        params: Params, images: Tensor, labels: Tensor,
                        mask: Tensor, sizes: Tensor, selected: Tensor,
                        batch_idx: Tensor) -> tuple[Params, Tensor]:
    """Masked local SGD for all K clients -> (stacked params, FedAvg w)."""
    with record_function("local_train"):
        steps_k = cfg.local_epochs * torch.ceil(
            sizes.to(torch.float32) / cfg.batch_size)
        step_idx = torch.arange(max_steps, dtype=torch.float32,
                                device=sizes.device)[None, :]
        active = (step_idx < steps_k[:, None]).to(torch.float32)
        active = active * selected[:, None]         # frozen if unselected
        client_params = trainer(params, images, labels, mask, active,
                                batch_idx)
    # FedAvg weights D_k / D_r over the selected set.
    w = sizes.to(torch.float32) * selected
    w = w / torch.clamp_min(torch.sum(w), 1.0)
    return client_params, w


def _train_round(trainer: Callable, max_steps: int, cfg: FLConfig,
                 params: Params, images: Tensor, labels: Tensor,
                 mask: Tensor, sizes: Tensor, selected: Tensor,
                 batch_idx: Tensor) -> Params:
    """Masked local training + FedAvg.  An empty selected set carries
    the previous model forward (the all-zero weights would replace it
    with zeros); the guard is a select, no host sync."""
    client_params, w = _masked_local_train(
        trainer, max_steps, cfg, params, images, labels, mask, sizes,
        selected, batch_idx)
    with record_function("aggregate"):
        agg = fedavg_aggregate(client_params, w, cfg.use_kernel_agg)
        any_sel = torch.sum(selected) > 0.0
        return {n: torch.where(any_sel, agg[n], params[n]) for n in params}


def _train_round_faulty(trainer: Callable, max_steps: int, cfg: FLConfig,
                        params: Params, images: Tensor, labels: Tensor,
                        mask: Tensor, sizes: Tensor, selected: Tensor,
                        ok: Tensor, batch_idx: Tensor) -> Params:
    """Fault-aware round: train the selected set (the failure comes at
    upload time), aggregate the ``ok`` set with weights renormalised
    over it (:func:`fedavg_aggregate_masked`)."""
    client_params, _ = _masked_local_train(
        trainer, max_steps, cfg, params, images, labels, mask, sizes,
        selected, batch_idx)
    with record_function("aggregate"):
        w = sizes.to(torch.float32) * ok
        w = w / torch.clamp_min(torch.sum(w), 1.0)
        return fedavg_aggregate_masked(params, client_params, w, ok,
                                       cfg.use_kernel_agg)


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
                            success: Optional[Tensor] = None
                            ) -> tuple[Params, Tensor]:
    """Masked local training + compressed-uplink FedAvg.

    The (K, P) client updates go through the codec's round trip with
    error feedback (:func:`compression.apply_codec`); the decoded values
    are averaged onto the global model, ``g' = g + sum_k (D_k / D_r)
    c_k``, by a plain product as in the reference.  ``success`` renormalises
    the weights over the uploads that landed and folds a failed device's
    update back into its residual.  Returns ``(params, residual)``.
    """
    _uniform_dtype(params, "compressed uplink")
    client_params, w = _masked_local_train(
        trainer, max_steps, fcfg, params, images, labels, mask, sizes,
        selected, batch_idx)
    with record_function("aggregate"):
        updates = _flat_updates(params, client_params)
        if success is not None:
            w = sizes.to(torch.float32) * selected * success
            w = w / torch.clamp_min(torch.sum(w), 1.0)
        c, residual = compression.apply_codec(
            codec, updates, residual, selected, noise, fcfg.compression,
            gains, index, success=success)
        return _apply_flat(params, torch.tensordot(w, c, dims=1)), residual


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

    Returns ``(index, sizes, staleness, refreshed hists, state)``.
    """
    with record_function("stream_refresh"):
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
                    stale: Tensor, delivered: Tensor
                    ) -> streaming.StreamState:
    """Post-decision update of the driver-owned streaming fields: the
    delivered set consumes the backlog on the next refresh."""
    return dataclasses.replace(st, hists=hists_r, staleness=stale,
                               selected_prev=delivered, round=st.round + 1)


def client_histograms(data: partition_lib.ClientDataset,
                      num_classes: int) -> Tensor:
    """(K, C) per-device label histograms (Alg. 1 line 5)."""
    return diversity.label_histogram(data.labels, data.mask, num_classes)


def metrics_to_records(metrics: RoundMetrics) -> List[RoundRecord]:
    """One device->host transfer for the whole run's records."""
    m = RoundMetrics(*(getattr(metrics, f.name).cpu().numpy()
                       for f in dataclasses.fields(metrics)))
    history: List[RoundRecord] = []
    for r in range(m.selected.shape[0]):
        n_sel = int(m.n_selected[r])
        e_total = float(m.energy_total[r])
        history.append(RoundRecord(
            round=r, accuracy=float(m.accuracy[r]), n_selected=n_sel,
            round_time=float(m.round_time[r]), energy_total=e_total,
            energy_per_device=e_total / max(n_sel, 1),
            selected=np.asarray(m.selected[r]),
            n_success=int(m.n_success[r]), n_dropped=int(m.n_dropped[r]),
            iterations=int(m.iterations[r])))
    return history


def _stack_draws(rounds: List[Dict[str, Tensor]]) -> Dict[str, Tensor]:
    if not rounds or not rounds[0]:
        return {}
    return {n: torch.stack([d[n] for d in rounds]) for n in rounds[0]}


def draw_tape(gen: torch.Generator, net: wireless.NetworkState,
              num_rounds: int, capacity: int, max_steps: int,
              batch_size: int, fcfg: Optional[FLConfig] = None,
              hists: Optional[Tensor] = None) -> Draws:
    """A whole run's :class:`Draws` from ``gen``, on ``net``'s device.

    ``fcfg`` adds the draws its subsystems need: with ``stream`` the
    arrival process's (``hists`` are the (K, C) initial histograms), with
    ``faults`` the fault uniforms and the chronic-rate normal draw.  The
    quantization noise is left out (the driver draws it per round).
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
    return draws


def _check_tape(draws: Draws, fcfg: FLConfig, k_dev: int,
                max_steps: int) -> None:
    want = (fcfg.num_rounds, k_dev, max_steps, fcfg.batch_size)
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
    missing = [n for n in needs if getattr(draws, n) is None]
    if missing:
        raise ValueError(f"the tape lacks {missing} for the configured "
                         f"subsystems; build it with draw_tape(..., fcfg, "
                         f"hists)")


# ---------------------------------------------------------------------------
# Full training driver (Alg. 1)
# ---------------------------------------------------------------------------

def run_federated(*, model: nn.Module,
                  data: partition_lib.ClientDataset,
                  net: wireless.NetworkState,
                  wcfg: wireless.WirelessConfig,
                  scfg: scheduler.SchedulerConfig,
                  fcfg: FLConfig, seed: int = 0,
                  draws: Optional[Draws] = None, eval_every: int = 1,
                  device: DeviceLike = None
                  ) -> tuple[Params, List[RoundRecord]]:
    """Run ``fcfg.num_rounds`` of FEEL; returns final params + records.

    ``model`` supplies the architecture and the initial weights (it is
    not modified); the returned params are a dict of tensors by
    parameter name on the run's device.  ``device=None`` means the CUDA
    card and raises without one; pass ``device="cpu"`` for the plain
    PyTorch path.  ``draws`` (on any device) replaces the generator
    draws, e.g. to replay another implementation's random numbers.
    """
    dev = resolve_device(device)
    data = data.to(dev)
    net = net.to(dev)
    model = copy.deepcopy(model).to(dev)
    params = paper_nets.params_of(model)
    loss_fn = functools.partial(paper_nets.loss_fn, model)
    k_dev, cap = data.num_devices, data.capacity
    max_steps = _max_local_steps(fcfg, cap)
    trainer = make_local_trainer(loss_fn, fcfg)
    sch = _sched_cfg(scfg, fcfg)
    do_eval = _eval_mask(fcfg.num_rounds, eval_every)
    stream, comp = fcfg.stream, fcfg.compression
    flt = faults.active(fcfg.faults)
    hists = client_histograms(data, fcfg.num_classes) \
        if stream is not None else None
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    if draws is None:
        draws = draw_tape(gen, net, fcfg.num_rounds, cap, max_steps,
                          fcfg.batch_size, fcfg, hists)
    draws = draws.to(dev)
    _check_tape(draws, fcfg, k_dev, max_steps)

    if stream is None:
        # The labels never change: one kernel launch per run.
        stats = diversity_kernel.diversity_stats(
            data.labels.to(torch.int32).contiguous(),
            data.mask.contiguous(), fcfg.num_classes)
        div = stats[:, diversity.measure_column(fcfg.measure)]
    else:
        process = streaming.get_process(stream.process)
        size_cap = _stream_size_cap(stream, cap)
        measure_col = diversity.measure_column(fcfg.measure)
        st = process.init(draws.stream_init, hists, stream)
    if comp is not None:
        codec = compression.get_codec(comp.codec)
        residual = torch.zeros((k_dev, flat_param_size(params)),
                               dtype=torch.float32, device=dev)
    if flt is not None:
        exp_mult = faults.expected_time_mult(flt)
        drop_rates = faults.chronic_rates(draws.chronic_z, flt)
        rel = torch.ones((k_dev,), dtype=torch.float32, device=dev)
    test_x = synthetic.to_float(data.test_images)
    ages = torch.zeros((k_dev,), dtype=torch.int32, device=dev)
    nan = torch.full((), math.nan, device=dev)
    int32 = dict(dtype=torch.int32, device=dev)
    rows: List[tuple] = []
    for r in range(fcfg.num_rounds):
        if stream is not None:
            index, sizes_r, stale, hists_r, st = _stream_round(
                process, fcfg, size_cap, measure_col,
                _round_of(draws.stream, r), st, ages)
        else:
            sizes_r, stale = data.sizes, None
        gains = draws.gains[r]
        with record_function("schedule"):
            if stream is None:
                index = diversity.diversity_index_from_stats(
                    div=div, data_sizes=sizes_r, ages=ages,
                    weights=fcfg.index_weights)
            payload = codec.payload_bits(comp, wcfg, gains, index) \
                if comp is not None else None
            # Scheduling prices retry-inflated bits, so Sub2's deadline
            # reserves the retransmission window before it happens.
            payload_sched = bandwidth.effective_payload_bits(
                payload, exp_mult, wcfg, gains) if flt is not None \
                else payload
            result = scheduler.schedule_impl(
                None if draws.sched_u is None else draws.sched_u[r], index,
                ages, sizes_r, gains, net, wcfg, sch, staleness=stale,
                payload_bits=payload_sched,
                reliability=rel if flt is not None else None)
        selected = result.selected
        if flt is None:
            ok, energy, round_time, success = (
                selected, result.energy, result.round_time, None)
        else:
            draw = faults.sample_faults(
                **_round_of(draws.faults, r), gains=gains, net=net, cfg=flt,
                drop_rates=drop_rates)
            ok, energy, round_time = faults.apply_faults(
                draw, selected, result.alpha, result.t_train, gains, net,
                wcfg, payload, flt)
            success = draw.success
        batch_idx = draws.batch_idx[r]
        if comp is not None:
            noise = None
            if codec.stochastic:
                noise = draws.comp_noise[r] if draws.comp_noise is not None \
                    else torch.rand(residual.shape, generator=gen,
                                    device=dev)
            params, residual = _train_round_compressed(
                trainer, max_steps, fcfg, codec, params, data.images,
                data.labels, data.mask, sizes_r, selected, batch_idx,
                residual, gains, index, noise, success=success)
        elif flt is not None:
            params = _train_round_faulty(
                trainer, max_steps, fcfg, params, data.images, data.labels,
                data.mask, sizes_r, selected, ok, batch_idx)
        else:
            params = _train_round(trainer, max_steps, fcfg, params,
                                  data.images, data.labels, data.mask,
                                  sizes_r, selected, batch_idx)
        # Participation = delivered: ages reset and the streaming
        # backlog clears only for uploads that landed.
        ages = torch.where(ok > 0.0, 0, ages + 1).to(torch.int32)
        if flt is not None:
            rel = faults.reliability_update(rel, selected, ok, flt)
        if stream is not None:
            st = _stream_advance(st, hists_r, stale, ok)
        if do_eval[r]:
            with torch.no_grad(), record_function("evaluate"):
                acc = paper_nets.accuracy(model, params, test_x,
                                          data.test_labels)
        else:
            acc = nan
        rows.append((acc, torch.sum(selected).to(torch.int32), round_time,
                     energy, torch.sum(energy), selected,
                     torch.full((), result.iterations, **int32),
                     torch.sum(ok).to(torch.int32), torch.zeros((), **int32)))
    metrics = RoundMetrics(*(torch.stack([row[i] for row in rows])
                             for i in range(9)))
    return params, metrics_to_records(metrics)

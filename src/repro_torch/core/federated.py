"""FEEL orchestration — the paper's Algorithm 1 (FedAvg + scheduling).

Port of the synchronous single-scenario driver of
``repro.core.federated`` with every optional subsystem off.  Each round:

1. the diversity index (Eq. 4) from the per-device label statistics,
   which the ``diversity`` kernel computes once per run (on this path
   the labels never change) and :func:`diversity_index_from_stats`
   combines with sizes and ages every round;
2. a fading draw;
3. scheduling (``core.scheduler``: DAS with the ``fused_pgd`` allocator
   runs the ``sub2_pgd`` kernel once per outer iteration);
4. masked local SGD of all K clients at once (``torch.func.vmap`` of
   ``grad``), unselected clients frozen;
5. FedAvg over the selected set (the ``fedavg_agg`` kernel with
   ``use_kernel_agg``), carrying the model forward on an empty round;
6. ages, evaluation and per-round metrics.

Each phase runs under a ``torch.profiler.record_function`` scope
(``schedule``, ``local_train``, ``aggregate``, ``evaluate``), so a
profiler trace splits a round's host and device time by phase; outside
a profiler the scopes cost a few microseconds per round.

Randomness is an input: :class:`Draws` holds the fading gains, the
minibatch indices and the uniform draw the abs/random policies rank on.
Without a tape they come from a ``torch.Generator`` seeded from
``seed``, on the run's device.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import math
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
from torch import nn
from torch.profiler import record_function

from repro_torch.core import diversity, scheduler, wireless
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
    "stream": 10,
    "compression": 11,
    "faults": 12,
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
    # Optional subsystems of the reference; each must stay None here.
    stream: Optional[Any] = None
    compression: Optional[Any] = None
    faults: Optional[Any] = None
    dispatch_cap: Optional[int] = None
    carry_dtype: Optional[str] = None
    events: Optional[Any] = None
    telemetry: Optional[Any] = None

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
    n_success: Tensor     # (R,) int32
    n_dropped: Tensor     # (R,) int32


@dataclasses.dataclass
class Draws:
    """The run's random numbers, drawn up front or by the caller.

    ``gains`` (R, K) are the fading channel gains ``|g|^2`` (path loss
    included), ``batch_idx`` (R, K, max_steps, B) int64 the minibatch
    sample indices, ``sched_u`` (R, K) the uniform draw abs/random rank
    on (unused by DAS and full).
    """

    gains: Tensor
    batch_idx: Tensor
    sched_u: Optional[Tensor] = None


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


def fedavg_aggregate(client_params: Params, weights: Tensor,
                     use_kernel: bool = False) -> Params:
    """g <- sum_k (D_k / D_r) w_k (Alg. 1 line 12) over stacked params.

    ``weights`` are already normalised over the selected set.  The
    kernel path flattens every leaf into one (K, P) buffer, so the
    ``fedavg_agg`` kernel launches once per round.
    """
    if use_kernel:
        dtypes = {t.dtype for t in client_params.values()}
        if len(dtypes) != 1:
            raise TypeError(f"kernel FedAvg path needs uniform leaf dtype, "
                            f"got {sorted(map(str, dtypes))}")
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


def _masked_local_train(trainer: Callable, max_steps: int, cfg: FLConfig,
                        params: Params, images: Tensor, labels: Tensor,
                        mask: Tensor, sizes: Tensor, selected: Tensor,
                        batch_idx: Tensor) -> tuple[Params, Tensor]:
    """Masked local SGD for all K clients -> (stacked params, FedAvg w)."""
    steps_k = cfg.local_epochs * torch.ceil(
        sizes.to(torch.float32) / cfg.batch_size)
    step_idx = torch.arange(max_steps, dtype=torch.float32,
                            device=sizes.device)[None, :]
    active = (step_idx < steps_k[:, None]).to(torch.float32)
    active = active * selected[:, None]             # frozen if unselected
    client_params = trainer(params, images, labels, mask, active, batch_idx)
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
    with record_function("local_train"):
        client_params, w = _masked_local_train(
            trainer, max_steps, cfg, params, images, labels, mask, sizes,
            selected, batch_idx)
    with record_function("aggregate"):
        agg = fedavg_aggregate(client_params, w, cfg.use_kernel_agg)
        any_sel = torch.sum(selected) > 0.0
        return {n: torch.where(any_sel, agg[n], params[n]) for n in params}


def _max_local_steps(cfg: FLConfig, capacity: int) -> int:
    steps_per_epoch = max(1, -(-capacity // cfg.batch_size))
    return cfg.local_epochs * steps_per_epoch


def _eval_mask(num_rounds: int, eval_every: int) -> np.ndarray:
    """Evaluate-or-skip schedule: every ``eval_every`` rounds + the last."""
    mask = np.zeros((num_rounds,), np.bool_)
    mask[::max(eval_every, 1)] = True
    mask[-1] = True
    return mask


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


def draw_tape(gen: torch.Generator, net: wireless.NetworkState,
              num_rounds: int, capacity: int, max_steps: int,
              batch_size: int) -> Draws:
    """A whole run's :class:`Draws` from ``gen``, on ``net``'s device."""
    dev = net.pathloss.device
    k = net.num_devices
    gains = torch.stack([wireless.sample_fading(gen, net)
                         for _ in range(num_rounds)])
    batch_idx = torch.randint(0, capacity,
                              (num_rounds, k, max_steps, batch_size),
                              generator=gen, device=dev)
    sched_u = torch.rand((num_rounds, k), generator=gen, device=dev)
    return Draws(gains, batch_idx, sched_u)


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
    sch = dataclasses.replace(scfg, local_epochs=fcfg.local_epochs)
    do_eval = _eval_mask(fcfg.num_rounds, eval_every)
    if draws is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        draws = draw_tape(gen, net, fcfg.num_rounds, cap, max_steps,
                          fcfg.batch_size)
    draws = Draws(*(None if t is None else t.to(dev)
                    for t in (draws.gains, draws.batch_idx,
                              draws.sched_u)))
    if tuple(draws.batch_idx.shape) != (fcfg.num_rounds, k_dev, max_steps,
                                        fcfg.batch_size):
        raise ValueError(f"batch_idx must be (R, K, max_steps, B) = "
                         f"{(fcfg.num_rounds, k_dev, max_steps)} + "
                         f"({fcfg.batch_size},), got "
                         f"{tuple(draws.batch_idx.shape)}")

    # The labels never change on this path: one kernel launch per run.
    stats = diversity_kernel.diversity_stats(
        data.labels.to(torch.int32).contiguous(), data.mask.contiguous(),
        fcfg.num_classes)
    div = stats[:, diversity.measure_column(fcfg.measure)]
    test_x = synthetic.to_float(data.test_images)
    ages = torch.zeros((k_dev,), dtype=torch.int32, device=dev)
    nan = torch.full((), math.nan, device=dev)
    rows: List[tuple] = []
    for r in range(fcfg.num_rounds):
        with record_function("schedule"):
            index = diversity.diversity_index_from_stats(
                div=div, data_sizes=data.sizes, ages=ages,
                weights=fcfg.index_weights)
            result = scheduler.schedule_impl(
                None if draws.sched_u is None else draws.sched_u[r], index,
                ages, data.sizes, draws.gains[r], net, wcfg, sch)
        selected = result.selected
        params = _train_round(trainer, max_steps, fcfg, params,
                              data.images, data.labels, data.mask,
                              data.sizes, selected, draws.batch_idx[r])
        ages = torch.where(selected > 0.0, 0, ages + 1).to(torch.int32)
        if do_eval[r]:
            with torch.no_grad(), record_function("evaluate"):
                acc = paper_nets.accuracy(model, params, test_x,
                                          data.test_labels)
        else:
            acc = nan
        n_sel = torch.sum(selected).to(torch.int32)
        int32 = dict(dtype=torch.int32, device=dev)
        rows.append((acc, n_sel, result.round_time, result.energy,
                     torch.sum(result.energy), selected,
                     torch.full((), result.iterations, **int32),
                     n_sel, torch.zeros((), **int32)))
    metrics = RoundMetrics(*(torch.stack([row[i] for row in rows])
                             for i in range(9)))
    return params, metrics_to_records(metrics)

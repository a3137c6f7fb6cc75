"""Learning-signal and fairness health of a run (telemetry ``signals``).

Port of ``repro.telemetry.health``.  The frames of
:mod:`repro_torch.telemetry.record` say what the scheduler did; this
module says what the learning did.  A :class:`SignalState` is carried
from round to round by every driver when ``TelemetryConfig.signals`` is
on, and holds per device:

* ``loss_delta`` — the last observed local loss improvement: the loss
  at the global params minus the loss at the device's trained params,
  on a fixed window of its shard (no draws);
* ``update_norm`` — the last observed L2 norm of the device's model
  delta, from the flattened ``(K, P)`` update matrix, so the plain,
  compressed and event paths share one reduction;
* ``participation`` — delivered uploads so far;
* ``energy`` — realized upload energy so far (J).

:func:`signals_aggregates` derives the round's scalars (Jain fairness
over participation and energy, starved devices, divergence sentinels).
Nothing here draws randomness or feeds back into the round.  Every
function takes ``(K,)`` rows or ``(S, K)`` lanes of a batch and works
along the last axis.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Tuple

import torch

from repro_torch.data import synthetic

Tensor = torch.Tensor

# A local loss delta above this magnitude (or non-finite) marks a device
# as diverging in the frame's sentinel counts.  Softmax CE on the
# paper's 10-class problems lives in [0, ~2.3] at init; |delta| > 50 is a
# blow-up, not a large honest step.
EXPLODING_LOSS = 50.0

# Upper bound on the loss probe's window (samples per device): the probe
# costs two forward passes per device per round, and 16 samples still
# track the sign and scale of the local loss move.
PROBE_CAP = 16


def jain_index(x: Tensor) -> Tensor:
    """Jain's fairness index ``(sum x)^2 / (K sum x^2)`` along the last
    axis: 1 when every device holds an equal share, ``1/K`` when one
    holds everything, and 1 for the all-zero row (no uploads yet)."""
    x = x.to(torch.float32)
    s = torch.sum(x, dim=-1)
    ss = torch.sum(x * x, dim=-1)
    fair = (s * s) / (float(x.shape[-1]) * ss)
    return torch.where(ss > 0.0, fair, torch.ones_like(fair))


@dataclasses.dataclass
class SignalState:
    """Per-device learning-signal accumulators carried between rounds.
    ``loss_delta``/``update_norm`` hold each device's last observed value
    (unchanged while it sits out); ``participation`` and ``energy`` are
    cumulative since round 0."""

    loss_delta: Tensor     # (..., K) f32
    update_norm: Tensor    # (..., K) f32
    participation: Tensor  # (..., K) i32
    energy: Tensor         # (..., K) f32


def signal_init(k: int, lead: tuple = (), device=None) -> SignalState:
    """The zero state of ``k`` devices (``lead + (k,)`` for a batch)."""
    shape = tuple(lead) + (k,)
    f32 = dict(dtype=torch.float32, device=device)
    return SignalState(torch.zeros(shape, **f32), torch.zeros(shape, **f32),
                       torch.zeros(shape, dtype=torch.int32, device=device),
                       torch.zeros(shape, **f32))


def signal_update(state: SignalState, ok: Tensor, loss_delta: Tensor,
                  update_norm: Tensor, energy: Tensor) -> SignalState:
    """Fold one round's observations in: the last-observed fields move
    for the delivered devices (``ok``) only, the cumulative ones add the
    round (``energy`` is the realized vector, already 0 off the set)."""
    hit = ok > 0.0
    return SignalState(
        loss_delta=torch.where(hit, loss_delta, state.loss_delta),
        update_norm=torch.where(hit, update_norm, state.update_norm),
        participation=state.participation + hit.to(torch.int32),
        energy=state.energy + energy)


def update_norms(updates: Tensor) -> Tensor:
    """Per-device L2 norm of a flattened ``(..., K, P)`` update matrix:
    the one reduction every driver path uses."""
    u = updates.to(torch.float32)
    return torch.sqrt(torch.sum(u * u, dim=-1))


def flatten_updates(client_params: Dict[str, Tensor],
                    params: Dict[str, Tensor], lead: tuple = ()) -> Tensor:
    """The ``(K, P)`` update matrix (``lead + (K, P)``) of stacked client
    params against the globals, in the compressed path's ravel order
    (``federated._flat_updates``)."""
    from repro_torch.core import federated
    return federated._flat_updates(params, client_params, tuple(lead))


def make_signal_probe(loss_fn: Callable, probe_size: int) -> Callable:
    """The per-device loss-delta probe.

    Returns ``probe(params, client_params, images, labels, mask,
    lead=()) -> lead + (K,) f32``: each device's loss at the global
    params minus its loss at its trained params, both on the first
    ``probe_size`` samples of its shard, so the probe draws nothing.
    The S x K lanes run through ``loss_fn`` as the trainer's vmap runs
    them, each lane with its own weights (a batch's global params are
    ``lead + leaf``, its client params ``lead + (K,) + leaf``).  A lane
    whose weights equal the globals gets exactly 0.
    """
    vloss = torch.func.vmap(loss_fn)

    def probe(params, client_params, images, labels, mask, lead=()):
        lead = tuple(lead)
        k = images.shape[0]
        lanes = math.prod(lead) * k
        win = slice(0, probe_size)

        def per_lane(t):
            return t.expand(lead + t.shape).reshape((lanes,) + t.shape[1:])
        x = per_lane(synthetic.to_float(images[:, win]))
        y, m = per_lane(labels[:, win]), per_lane(mask[:, win])
        glob, own = {}, {}
        for name, t in params.items():
            leaf = t.shape[len(lead):]
            glob[name] = t.reshape((-1, 1) + leaf).expand(
                (-1, k) + leaf).reshape((lanes,) + leaf)
            own[name] = client_params[name].reshape((lanes,) + leaf)
        with torch.no_grad():
            before = vloss(glob, x, y, m)
            after = vloss(own, x, y, m)
        return (before - after).to(torch.float32).reshape(lead + (k,))

    return probe


def signals_frame(state: SignalState, ok: Tensor, loss_delta: Tensor,
                  update_norm: Tensor) -> Dict[str, Tensor]:
    """The signals group of one round's frame: this round's observations
    masked to the delivered set, the carry after the update, and the
    derived aggregates."""
    hit = ok > 0.0
    zero = torch.zeros_like(loss_delta)
    frame = {
        "sig_loss_delta": torch.where(hit, loss_delta, zero),
        "sig_update_norm": torch.where(hit, update_norm,
                                       torch.zeros_like(update_norm)),
        "sig_loss_delta_last": state.loss_delta,
        "sig_update_norm_last": state.update_norm,
        "sig_participation": state.participation,
        "sig_energy_cum": state.energy,
    }
    frame.update(signals_aggregates(state, loss_delta, hit))
    return frame


def signals_aggregates(state: SignalState, loss_delta: Tensor,
                       hit: Tensor) -> Dict[str, Tensor]:
    """Scalar health aggregates (one per lane) from the updated carry."""
    finite = torch.isfinite(loss_delta)
    nonfinite = hit & ~finite
    exploding = hit & finite & (torch.abs(loss_delta) > EXPLODING_LOSS)

    def count(mask):
        return torch.sum(mask.to(torch.int32), dim=-1, dtype=torch.int32)
    return {
        "jain_participation": jain_index(state.participation),
        "jain_energy": jain_index(state.energy),
        "starved": count(state.participation == 0),
        "div_nonfinite": count(nonfinite),
        "div_exploding": count(exploding),
    }


# Frame leaves the signals group adds (the report CLI and tests key off
# this).
SIGNAL_LEAVES: Tuple[str, ...] = (
    "sig_loss_delta", "sig_update_norm", "sig_loss_delta_last",
    "sig_update_norm_last", "sig_participation", "sig_energy_cum",
    "jain_participation", "jain_energy", "starved",
    "div_nonfinite", "div_exploding",
)


__all__ = ["SignalState", "signal_init", "signal_update", "update_norms",
           "flatten_updates", "make_signal_probe", "signals_frame",
           "signals_aggregates", "jain_index", "SIGNAL_LEAVES",
           "EXPLODING_LOSS", "PROBE_CAP"]

"""Unreliable-edge subsystem: fault injection and retransmission.

Port of ``repro.core.faults``.  An admitted device's upload can fail:

* **channel outages** — each attempt fails with ``drop_prob`` (or a
  chronic per-device rate, :func:`chronic_rates`), and a round whose
  fading power ``|h|^2`` is below ``deep_fade_threshold`` fails every
  attempt;
* **retransmission with exponential backoff** — up to ``max_retries``
  retries, attempt ``j`` waiting ``backoff_base * 2^(j-1)`` upload
  times; the expected airtime multiplier (:func:`expected_time_mult`)
  inflates the bits the scheduler prices;
* **heavy-tailed compute stragglers** — ``straggler_scale *
  Pareto(straggler_tail)`` with probability ``straggler_prob``;
* **mid-round dropouts** — zero attempts with ``dropout_prob``.

FedAvg keeps only the uploads that landed, and a per-device reliability
EMA (:func:`reliability_update`) feeds the scheduler's
``reliability_discount``.  Randomness is an input: :func:`sample_faults`
takes its uniforms and :func:`chronic_rates` its normal draw, so a test
can feed the reference's ``jax.random`` draws; :func:`draw_uniforms`
makes them from a ``torch.Generator``.  :func:`fault_step` is a round's
draw and realized accounting in one call.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core import wireless

Tensor = torch.Tensor

# The interval of the straggler-tail uniform (the reference's minval).
TAIL_MIN = 1e-6


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """Fault-process knobs (rides on ``FLConfig.faults``).  The defaults
    are inert: nothing can fail."""

    drop_prob: float = 0.0          # per-attempt Bernoulli upload failure
    deep_fade_threshold: float = 0.0  # |h|^2 floor; below it = block fade
    max_retries: int = 0            # retransmissions after the first try
    backoff_base: float = 0.5       # backoff before attempt j: base*2^(j-1)
    straggler_prob: float = 0.0     # P(device straggles this round)
    straggler_scale: float = 4.0    # compute-time multiplier floor
    straggler_tail: float = 2.0     # Pareto tail index of the multiplier
    dropout_prob: float = 0.0       # P(device dies before uploading)
    reliability_ema: float = 0.0    # EMA rate beta; 0 freezes rel at 1
    overprovision: int = 0          # extra devices Sub1 admits (n_min +=)
    chronic_spread: float = 0.0     # sigma of log-normal per-device rates


@dataclasses.dataclass
class FaultDraw:
    """One round's realized fault process over the K devices (f32):
    ``attempts == 0`` is a dropout; ``attempts > 0`` with ``success ==
    0`` burned the whole retry budget."""

    success: Tensor       # (K,) {0,1} upload eventually landed
    attempts: Tensor      # (K,) attempts transmitted (0 = dropout)
    compute_mult: Tensor  # (K,) >= 1 computation-time multiplier


def attempt_budget(cfg: FaultConfig) -> int:
    """Total transmission attempts a device may spend: 1 + retries."""
    return 1 + max(int(cfg.max_retries), 0)


def is_inert(cfg: FaultConfig) -> bool:
    """True when the config can never produce an observable fault (a
    live reliability EMA counts as observable, as in the reference)."""
    return (cfg.drop_prob <= 0.0 and cfg.deep_fade_threshold <= 0.0
            and cfg.straggler_prob <= 0.0 and cfg.dropout_prob <= 0.0
            and cfg.overprovision <= 0 and cfg.reliability_ema <= 0.0)


def active(cfg: Optional[FaultConfig]) -> Optional[FaultConfig]:
    """Normalise an inert config to ``None``: the driver then runs the
    reliable-edge round itself."""
    if cfg is None or is_inert(cfg):
        return None
    return cfg


def chronic_rates(z: Tensor, cfg: FaultConfig) -> Optional[Tensor]:
    """Once-per-run ``(K,)`` per-device drop rates, or ``None``.

    ``rate_k = drop_prob * exp(sigma * z_k - sigma^2 / 2)`` clipped to
    [0, 1] with ``z`` a ``(K,)`` standard-normal draw and ``sigma =
    chronic_spread``.  ``None`` (the i.i.d. path) when the spread or the
    nominal rate is zero.
    """
    if cfg.drop_prob <= 0.0 or cfg.chronic_spread <= 0.0:
        return None
    s = cfg.chronic_spread
    return torch.clamp(cfg.drop_prob * torch.exp(s * z - 0.5 * s * s),
                       0.0, 1.0)


def draw_uniforms(gen: torch.Generator, k: int, cfg: FaultConfig,
                  device: torch.device) -> Dict[str, Tensor]:
    """One round's uniforms for :func:`sample_faults`: ``u_drop`` (K,
    budget), ``u_dropout``, ``u_strag`` (K,) on [0, 1) and ``u_tail`` (K,)
    on [TAIL_MIN, 1)."""
    def rand(*shape):
        return torch.rand(shape, generator=gen, device=device)
    return {"u_drop": rand(k, attempt_budget(cfg)), "u_dropout": rand(k),
            "u_strag": rand(k),
            "u_tail": torch.clamp_min(rand(k) * (1.0 - TAIL_MIN) + TAIL_MIN,
                                      TAIL_MIN)}


def sample_faults(u_drop: Tensor, u_dropout: Tensor, u_strag: Tensor,
                  u_tail: Tensor, gains: Tensor, net: wireless.NetworkState,
                  cfg: FaultConfig,
                  drop_rates: Optional[Tensor] = None) -> FaultDraw:
    """One round's fault realization from its uniforms.

    The deep fade holds for all attempts of the round (block fading);
    the Bernoulli drops are independent per attempt.  The fading power
    is recovered as ``|h|^2 = gains / pathloss``.  ``drop_rates``
    (:func:`chronic_rates`) replaces ``drop_prob`` when given.
    """
    budget = attempt_budget(cfg)
    if tuple(u_drop.shape) != tuple(gains.shape) + (budget,):
        raise ValueError(f"u_drop must be {tuple(gains.shape) + (budget,)},"
                         f" got {tuple(u_drop.shape)}")
    rate = cfg.drop_prob if drop_rates is None else drop_rates[..., None]
    dropped = u_drop < rate
    h2 = gains / torch.clamp_min(net.pathloss, 1e-30)
    faded = h2 < cfg.deep_fade_threshold
    attempt_ok = (~dropped) & (~faded[..., None])
    any_ok = torch.any(attempt_ok, dim=-1)
    # First successful attempt (1-based); a device that never succeeds
    # spends the whole budget.
    first = torch.argmax(attempt_ok.to(torch.uint8), dim=-1).to(
        torch.float32) + 1.0
    dropout = u_dropout < cfg.dropout_prob
    success = (any_ok & (~dropout)).to(torch.float32)
    zero = torch.zeros_like(first)
    attempts = torch.where(dropout, zero,
                           torch.where(any_ok, first,
                                       torch.full_like(first, budget)))
    is_strag = u_strag < cfg.straggler_prob
    pareto = u_tail ** (-1.0 / max(cfg.straggler_tail, 1e-6))
    compute_mult = torch.where(is_strag, cfg.straggler_scale * pareto,
                               torch.ones_like(pareto))
    return FaultDraw(success=success, attempts=attempts,
                     compute_mult=compute_mult)


def time_mult(attempts: Tensor, cfg: FaultConfig) -> Tensor:
    """Realized airtime multiplier of ``n`` attempts with backoff: ``n +
    backoff_base * (2^(n-1) - 1)``; 0 for a dropout."""
    n = attempts
    waits = cfg.backoff_base * (torch.exp2(torch.clamp_min(n, 1.0) - 1.0)
                                - 1.0)
    return torch.where(n > 0.0, n + waits, torch.zeros_like(n))


def expected_time_mult(cfg: FaultConfig) -> float:
    """E[airtime multiplier] over the Bernoulli attempt distribution, in
    closed form: ``P(j) = q^(j-1) (1-q)`` for ``j < budget`` and
    ``q^(budget-1)`` for the last attempt.  Exactly 1.0 when nothing
    can be retried."""
    budget = attempt_budget(cfg)
    q = min(max(float(cfg.drop_prob), 0.0), 1.0)
    if q <= 0.0 or budget == 1:
        return 1.0

    def mult(n: int) -> float:
        return n + cfg.backoff_base * (2.0 ** (n - 1) - 1.0)

    exp = sum(q ** (j - 1) * (1.0 - q) * mult(j) for j in range(1, budget))
    exp += q ** (budget - 1) * mult(budget)
    return float(exp)


def apply_faults(draw: FaultDraw, selected: Tensor, alpha: Tensor,
                 t_train: Tensor, gains: Tensor, net: wireless.NetworkState,
                 wcfg: wireless.WirelessConfig,
                 payload_bits: Optional[Tensor], cfg: FaultConfig
                 ) -> Tuple[Tensor, Tensor, Tensor]:
    """Realized round accounting -> ``(ok, energy, round_time)``.

    Upload time at the actual payload stretches by :func:`time_mult`;
    energy bills ``attempts`` transmissions; the synchronous round waits
    for every admitted device's straggling compute plus its full retry
    window.  Rows are ``(K,)`` or ``(S, K)``; the round time is one per
    lane.
    """
    ok = selected * draw.success
    sel = selected > 0.0
    zero = torch.zeros_like(t_train)
    t_up = wireless.upload_time(alpha, gains, net.tx_power, wcfg,
                                payload_bits,
                                airtime_mult=time_mult(draw.attempts, cfg))
    t_up = torch.where(sel & torch.isfinite(t_up), t_up, zero)
    energy = wireless.upload_energy(alpha, gains, net.tx_power, wcfg,
                                    payload_bits,
                                    airtime_mult=draw.attempts)
    energy = torch.where(sel & torch.isfinite(energy), energy, zero)
    t_total = torch.where(sel, t_train * draw.compute_mult + t_up, zero)
    return ok, energy, torch.amax(t_total, dim=-1)


def fault_step(u_drop: Tensor, u_dropout: Tensor, u_strag: Tensor,
               u_tail: Tensor, selected: Tensor, alpha: Tensor,
               t_train: Tensor, gains: Tensor, net: wireless.NetworkState,
               wcfg: wireless.WirelessConfig, payload_bits: Optional[Tensor],
               cfg: FaultConfig, drop_rates: Optional[Tensor] = None
               ) -> Tuple[FaultDraw, Tensor, Tensor, Tensor]:
    """One round's fault draw and its realized accounting -> ``(draw, ok,
    energy, round_time)``: :func:`sample_faults` on the round's uniforms,
    then :func:`apply_faults`.  Every driver's round runs this one
    sequence."""
    draw = sample_faults(u_drop, u_dropout, u_strag, u_tail, gains, net, cfg,
                         drop_rates)
    ok, energy, round_time = apply_faults(draw, selected, alpha, t_train,
                                          gains, net, wcfg, payload_bits, cfg)
    return draw, ok, energy, round_time


def reliability_update(rel: Tensor, selected: Tensor, ok: Tensor,
                       cfg: FaultConfig) -> Tensor:
    """Per-device reliability EMA: ``rel' = (1-beta) rel + beta *
    success`` on the selected set, unchanged elsewhere; frozen at
    ``beta == 0``."""
    beta = cfg.reliability_ema
    if beta <= 0.0:
        return rel
    obs = (ok > 0.0).to(torch.float32)
    return torch.where(selected > 0.0, (1.0 - beta) * rel + beta * obs, rel)

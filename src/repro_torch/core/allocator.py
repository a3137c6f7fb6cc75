"""Allocator registry — the one interface every policy solves Sub2 through.

Port of ``repro.core.allocator`` with four entries:

* ``waterfilling`` — the rho -> 0 limit (``bandwidth.min_time_allocation``);
* ``pgd`` — tangent-space projected gradient (``bandwidth.pgd_allocation``);
* ``fused_pgd`` — the water-filling start, then the whole double descent
  in one launch of the ``sub2_pgd`` CUDA kernel (its plain PyTorch
  version on CPU tensors);
* ``importance`` — the Ren et al.-style objective: each device's energy
  priced by gradient importance x channel cost
  (:func:`importance_weights`), solved by the same tangent PGD.

New objectives plug in through :func:`register`; policies pick one by
name through ``SchedulerConfig.allocator``.

Every allocator takes ``(K,)`` rows or ``(S, K)`` stacks of S scenarios;
``fused_pgd`` hands the whole stack to one kernel launch.

``solve(selected, t_train, gains, tx_power, cfg, alpha0=None,
data_sizes=None, payload_bits=None) -> (alpha, objective)``; ``alpha0``
is the warm-start contract (``das_schedule`` passes the previous outer
iteration's allocation).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Protocol, runtime_checkable

import torch

from repro_torch.core import bandwidth as bw
from repro_torch.core import wireless
from repro_torch.kernels import sub2_pgd as sub2_pgd_kernel

Tensor = torch.Tensor


@runtime_checkable
class Allocator(Protocol):
    """Sub2 solver interface consumed by every scheduling policy."""

    params: bw.Sub2Params

    def solve(self, selected: Tensor, t_train: Tensor, gains: Tensor,
              tx_power: Tensor, cfg: wireless.WirelessConfig,
              alpha0: Optional[Tensor] = None,
              data_sizes: Optional[Tensor] = None,
              payload_bits: Optional[Tensor] = None
              ) -> tuple[Tensor, Tensor]:
        """Return (alpha, objective) for the given selection."""
        ...


@dataclasses.dataclass(frozen=True)
class WaterFilling:
    """rho -> 0 limit: every selected device finishes at T*.  Objective
    reported at the caller's rho so allocators are comparable."""

    params: bw.Sub2Params = bw.Sub2Params()

    def solve(self, selected, t_train, gains, tx_power, cfg, alpha0=None,
              data_sizes=None, payload_bits=None):
        del data_sizes
        alpha, _ = bw.min_time_allocation(selected, t_train, gains,
                                          tx_power, cfg, self.params,
                                          alpha0=alpha0,
                                          payload_bits=payload_bits)
        obj = bw.sub2_objective(alpha, selected, t_train, gains, tx_power,
                                cfg, self.params.rho,
                                payload_bits=payload_bits)
        return alpha, obj


@dataclasses.dataclass(frozen=True)
class PGD:
    """Tangent-space projected gradient (plain PyTorch)."""

    params: bw.Sub2Params = bw.Sub2Params()

    def solve(self, selected, t_train, gains, tx_power, cfg, alpha0=None,
              data_sizes=None, payload_bits=None):
        del data_sizes
        return bw.pgd_allocation(selected, t_train, gains, tx_power, cfg,
                                 self.params, alpha0=alpha0,
                                 payload_bits=payload_bits)


@dataclasses.dataclass(frozen=True)
class FusedPGD:
    """The PGD double descent in one ``sub2_pgd`` kernel launch for
    every lane.

    The joint-bisection water-filling solve supplies the first start
    (and consumes the warm start); the uniform share is the second.  The
    ``(…, K)`` rows go to the kernel as one ``(S, K)`` batch (S = 1 for
    a single row) with ``(S, 2, K)`` starts
    (``kernels.sub2_pgd.sub2_pgd_solve``).
    """

    params: bw.Sub2Params = bw.Sub2Params()

    def solve(self, selected, t_train, gains, tx_power, cfg, alpha0=None,
              data_sizes=None, payload_bits=None):
        del data_sizes
        mask = (selected > 0.0).to(torch.float32)
        n_act = torch.clamp_min(torch.sum(mask, dim=-1, keepdim=True), 1.0)
        bits = cfg.model_bits if payload_bits is None else payload_bits
        wf, _ = bw.min_time_allocation(selected, t_train, gains, tx_power,
                                       cfg, self.params, alpha0=alpha0,
                                       payload_bits=payload_bits)
        starts = torch.stack([wf, mask / n_act], dim=-2)
        p = self.params
        return sub2_pgd_kernel.sub2_pgd_solve(
            mask, t_train, gains, tx_power, starts, rho=p.rho,
            lr=p.pgd_lr, tau=p.smooth_tau, iters=p.pgd_iters,
            bandwidth_hz=cfg.bandwidth_hz, noise_psd=cfg.noise_psd,
            model_bits=bits, min_alpha=cfg.min_alpha)


def importance_weights(selected: Tensor, t_train: Tensor, gains: Tensor,
                       tx_power: Tensor, cfg: wireless.WirelessConfig,
                       beta: float = 1.0,
                       data_sizes: Optional[Tensor] = None) -> Tensor:
    """Per-device energy prices w_k: gradient importance x channel price.

    Importance is the device's share of the round's data, ``data_sizes``
    (|D_k|, FedAvg's own weight); without it the workload time
    ``t_train`` stands in.  The channel price is the inverse of the
    spectral efficiency at full band: a weak channel pays more energy
    per bit.  Both are normalised to mean 1 over the selected set (per
    lane), raised to ``beta`` and clipped to [0.05, 20], so ``beta = 0``
    is the unweighted objective exactly; unselected devices get 1.
    """
    mask = (selected > 0.0).to(torch.float32)
    n_act = torch.clamp_min(torch.sum(mask, dim=-1, keepdim=True), 1.0)

    def mean_norm(v):
        m = torch.sum(v * mask, dim=-1, keepdim=True) / n_act
        return v / torch.clamp_min(m, 1e-12)

    volume = t_train if data_sizes is None else data_sizes.to(torch.float32)
    imp = mean_norm(volume)
    snr_full = gains * tx_power / (cfg.bandwidth_hz * cfg.noise_psd)
    price = 1.0 / torch.clamp_min(mean_norm(torch.log1p(snr_full)), 1e-6)
    w = torch.clamp((imp * price) ** beta, 0.05, 20.0)
    return torch.where(mask > 0.0, w, torch.ones_like(w))


@dataclasses.dataclass(frozen=True)
class ImportanceWeighted:
    """Importance-weighted Sub2 (Ren et al. / Taik et al. style):
    ``min rho * sum_k w_k E_k + (1-rho) T`` with ``w_k`` from
    :func:`importance_weights`, by ``bandwidth.pgd_allocation``."""

    params: bw.Sub2Params = bw.Sub2Params()
    beta: float = 1.0

    def solve(self, selected, t_train, gains, tx_power, cfg, alpha0=None,
              data_sizes=None, payload_bits=None):
        w = importance_weights(selected, t_train, gains, tx_power, cfg,
                               self.beta, data_sizes=data_sizes)
        return bw.pgd_allocation(selected, t_train, gains, tx_power, cfg,
                                 self.params, alpha0=alpha0,
                                 energy_weights=w,
                                 payload_bits=payload_bits)


_REGISTRY: Dict[str, Callable[[bw.Sub2Params], Allocator]] = {}


def register(name: str, factory: Callable[[bw.Sub2Params], Allocator],
             overwrite: bool = False) -> None:
    """Register an allocator factory (``Sub2Params -> Allocator``)."""
    if name in _REGISTRY and not overwrite:
        raise ValueError(f"allocator {name!r} already registered")
    _REGISTRY[name] = factory


def names() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def get(name: str, params: bw.Sub2Params = bw.Sub2Params()) -> Allocator:
    """Build the named allocator around ``params``."""
    try:
        factory = _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown allocator {name!r}; registered: {names()}") from None
    return factory(params)


register("waterfilling", WaterFilling)
register("pgd", PGD)
register("fused_pgd", FusedPGD)
register("importance", ImportanceWeighted)

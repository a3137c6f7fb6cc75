"""Wireless edge channel / time / energy models (paper §IV-C, Eq. 6-10).

Port of ``repro.core.wireless``.  Single-cell OFDMA uplink: per-device
channel gain ``|g_k|^2 = d_k^{-beta} |h_k|^2`` with Rayleigh ``h_k``,
uplink rate (Eq. 6), upload time (Eq. 9), transmit energy (Eq. 10),
local training time (Eq. 8) and synchronous round time (Eq. 7).  Every
formula keeps the reference's form (``log2(1 + snr)`` here, unlike the
``log1p`` form of ``bandwidth._rate_and_slope``), since swapping forms
changes the float results.  Randomness comes from an explicit
``torch.Generator``.

A :class:`NetworkState` whose leaves carry a leading ``(S,)`` axis is S
scenarios' networks (:func:`sample_networks`); every formula works per
device along the trailing axis, and :func:`round_time` reduces per lane.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class WirelessConfig:
    """Static wireless-edge simulation parameters (paper Table I)."""

    bandwidth_hz: float = 1.0e6          # B: total OFDMA bandwidth
    noise_psd: float = 3.98e-21          # N0: -174 dBm/Hz
    pathloss_exp: float = 3.0            # beta (paper: alpha)
    cell_side_m: float = 500.0           # square side; BS at centre
    model_bits: float = 100e3            # s: update size (paper: 100 kbits)
    cpu_freq_range: tuple = (1.0e9, 3.0e9)      # f_k in [1, 3] GHz
    cycles_per_bit_range: tuple = (10.0, 30.0)  # C_k in [10, 30] cycles/bit
    tx_power_range: tuple = (1.0, 5.0)          # P_k in [1, 5] W
    bits_per_sample: float = 28.0 * 28.0 * 8.0  # MNIST-like greyscale image
    min_alpha: float = 1e-6              # numerical floor for bandwidth share


@dataclasses.dataclass
class NetworkState:
    """Per-device random draws for one simulation run (all (K,) f32, or
    ``(S, K)`` for S stacked scenarios).

    ``pathloss`` is static across rounds; fading is redrawn each round
    by :func:`sample_fading`.
    """

    distance_m: Tensor
    pathloss: Tensor       # d^-beta
    tx_power: Tensor       # P_k [W]
    cpu_freq: Tensor       # f_k [Hz]
    cycles_per_bit: Tensor  # C_k

    @property
    def num_devices(self) -> int:
        return self.distance_m.shape[-1]

    def to(self, device: torch.device) -> "NetworkState":
        return NetworkState(*(getattr(self, f.name).to(device)
                              for f in dataclasses.fields(self)))

    def scenario(self, s: int) -> "NetworkState":
        """Scenario ``s`` of a stacked state, as a (K,) state."""
        return NetworkState(*(getattr(self, f.name)[s]
                              for f in dataclasses.fields(self)))


def stack_networks(nets: Sequence[NetworkState]) -> NetworkState:
    """(K,) states stacked along a leading scenario axis."""
    return NetworkState(*(torch.stack([getattr(n, f.name) for n in nets])
                          for f in dataclasses.fields(NetworkState)))


_MASK64 = (1 << 64) - 1


def fold_seed(base_seed: int, index: int) -> int:
    """A generator seed for item ``index`` of a family rooted at
    ``base_seed``: splitmix64's finalizer over ``base_seed`` and
    ``index``, cut to 63 bits.  It depends on the pair alone, as
    ``jax.random.fold_in`` does (torch cannot reproduce that stream), so
    scenario ``i``'s draws never depend on how many scenarios share a
    batch or where a chunk starts."""
    z = (int(base_seed) * 0x9E3779B97F4A7C15 + int(index) + 1) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 1


def _uniform(gen: torch.Generator, shape, lo: float, hi: float,
             device: torch.device) -> Tensor:
    u = torch.rand(shape, generator=gen, device=device)
    return lo + (hi - lo) * u


def sample_network(gen: torch.Generator, num_devices: int,
                   cfg: WirelessConfig,
                   device: Union[str, torch.device] = "cpu") -> NetworkState:
    """Draw device placement and hardware capabilities (paper §VI-A.1).

    Same distributions as the reference; the numbers differ because the
    draws come from ``gen`` instead of a JAX key.
    """
    device = torch.device(device)
    pos = _uniform(gen, (num_devices, 2), 0.0, cfg.cell_side_m, device)
    centre = torch.tensor([cfg.cell_side_m / 2.0, cfg.cell_side_m / 2.0],
                          device=device)
    dist = torch.linalg.norm(pos - centre, dim=-1)
    dist = torch.clamp_min(dist, 1.0)  # 1 m exclusion zone
    pathloss = dist ** (-cfg.pathloss_exp)
    tx_power = _uniform(gen, (num_devices,), *cfg.tx_power_range, device)
    cpu_freq = _uniform(gen, (num_devices,), *cfg.cpu_freq_range, device)
    cycles = _uniform(gen, (num_devices,), *cfg.cycles_per_bit_range, device)
    return NetworkState(dist, pathloss, tx_power, cpu_freq, cycles)


def sample_networks(gen: torch.Generator, num_scenarios: int,
                    num_devices: int, cfg: WirelessConfig,
                    device: Union[str, torch.device] = "cpu"
                    ) -> NetworkState:
    """``S`` independent network realizations as one stacked state: each
    leaf ``(S, K)``, scenario ``s`` the ``s``-th :func:`sample_network`
    draw from ``gen`` (so the realizations depend on ``S``; see
    :func:`sample_networks_indexed`)."""
    return stack_networks([sample_network(gen, num_devices, cfg, device)
                           for _ in range(num_scenarios)])


def sample_networks_indexed(base_seed: int, indices: Sequence[int],
                            num_devices: int, cfg: WirelessConfig,
                            device: Union[str, torch.device] = "cpu"
                            ) -> NetworkState:
    """Network realizations for explicit global scenario indices:
    scenario ``i`` is :func:`sample_network` from a generator seeded
    with :func:`fold_seed` ``(base_seed, i)``, so it depends only on
    ``(base_seed, i)``, never on how many scenarios share the batch."""
    nets = []
    for i in indices:
        gen = torch.Generator(device=torch.device(device))
        gen.manual_seed(fold_seed(base_seed, int(i)))
        nets.append(sample_network(gen, num_devices, cfg, device))
    return stack_networks(nets)


def sample_fading(gen: torch.Generator, net: NetworkState) -> Tensor:
    """Per-round channel gains ``|g_k|^2 = d^-beta * |h|^2``, Rayleigh h.

    ``|h|^2`` for a unit Rayleigh variable is Exp(1)-distributed.
    """
    h2 = torch.empty_like(net.pathloss).exponential_(1.0, generator=gen)
    return net.pathloss * h2


def achievable_rate(alpha: Tensor, gains: Tensor, tx_power: Tensor,
                    cfg: WirelessConfig) -> Tensor:
    """Uplink rate r_k (Eq. 6), elementwise over devices.  bits/s.

    Safe at alpha -> 0 (rate -> 0): alpha is floored before the log and
    masked after, keeping the function differentiable for PGD.
    """
    a = torch.clamp_min(alpha, cfg.min_alpha)
    snr = gains * tx_power / (a * cfg.bandwidth_hz * cfg.noise_psd)
    rate = a * cfg.bandwidth_hz * torch.log2(1.0 + snr)
    return torch.where(alpha > 0.0, rate, torch.zeros_like(rate))


def upload_time(alpha: Tensor, gains: Tensor, tx_power: Tensor,
                cfg: WirelessConfig,
                model_bits: Optional[Union[float, Tensor]] = None,
                airtime_mult: Optional[Tensor] = None) -> Tensor:
    """t_up_k = s_k / r_k (Eq. 9).  Infinite when alpha_k == 0.

    ``model_bits`` overrides the config's scalar payload (a ``(K,)``
    tensor gives each device its own payload).  ``airtime_mult`` scales
    the single-shot time by a realized retransmission multiplier (the
    fault subsystem); a multiplier of 0 — a device that dropped out
    before transmitting — gives exactly 0 even where the single-shot
    time is infinite.
    """
    s = cfg.model_bits if model_bits is None else model_bits
    rate = achievable_rate(alpha, gains, tx_power, cfg)
    t = s / torch.clamp_min(rate, 1e-12)
    t = torch.where(rate > 0.0, t, torch.full_like(t, float("inf")))
    if airtime_mult is None:
        return t
    return torch.where(airtime_mult > 0.0, t * airtime_mult,
                       torch.zeros_like(t))


def upload_energy(alpha: Tensor, gains: Tensor, tx_power: Tensor,
                  cfg: WirelessConfig,
                  model_bits: Optional[Union[float, Tensor]] = None,
                  airtime_mult: Optional[Tensor] = None) -> Tensor:
    """E_k = P_k * t_up_k (Eq. 10).  For retransmissions ``airtime_mult``
    is the attempt count: the radio idles through backoff waits."""
    return tx_power * upload_time(alpha, gains, tx_power, cfg, model_bits,
                                  airtime_mult)


def train_time(data_sizes: Tensor, net: NetworkState, cfg: WirelessConfig,
               local_epochs: int = 1) -> Tensor:
    """t_train_k = E * |D_k| * C_k / f_k (Eq. 8), samples -> bits via
    ``cfg.bits_per_sample``."""
    bits = data_sizes.to(torch.float32) * cfg.bits_per_sample
    return local_epochs * bits * net.cycles_per_bit / net.cpu_freq


def round_time(selected: Tensor, t_train: Tensor, t_up: Tensor) -> Tensor:
    """T = max_k (t_train_k + t_up_k) x_k (Eq. 7) over the trailing axis
    (one value per lane); 0 if nothing selected."""
    total = torch.where(selected > 0.0, t_train + t_up,
                        torch.zeros_like(t_train))
    return torch.amax(total, dim=-1)

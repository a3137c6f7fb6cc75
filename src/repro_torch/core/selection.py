"""Sub1 — device selection via relaxation + rounding (paper Eq. 14/16).

Port of ``repro.core.selection``.  For fixed energies ``E_k``, times
``t_k`` and index ``I_k``, the relaxed program ``min lam_T T + sum_k
(lam_E E_k - lam_I I_k) x_k`` s.t. ``t_k x_k <= T, 0 <= x_k <= 1`` is
solved exactly by scanning its K breakpoints; rounding plus the top-N
fallback follow Algorithm 2 lines 6-9.  Inputs are ``(K,)`` rows or
``(S, K)`` stacks of S scenarios; every reduction runs per lane over the
trailing axis.
"""

from __future__ import annotations

import dataclasses

import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class Sub1Params:
    lambda_e: float = 0.25   # paper §VI-A: lam_E = lam_T = 1/4, lam_I = 1/2
    lambda_t: float = 0.25
    lambda_i: float = 0.5
    n_min: int = 1           # N: minimum devices per round (paper: 1)


def top_indices(priority: Tensor, n: int) -> Tensor:
    """Indices of the ``n`` largest values along the trailing axis, ties
    to the lower index (``jax.lax.top_k``'s order; a stable descending
    sort keeps it on every device)."""
    if n > priority.shape[-1]:
        raise ValueError(f"cannot take the top {n} of "
                         f"{priority.shape[-1]} devices")
    return torch.sort(priority, dim=-1, descending=True,
                      stable=True).indices[..., :n]


def solve_sub1_relaxed(energy: Tensor, times: Tensor, index: Tensor,
                       params: Sub1Params) -> tuple[Tensor, Tensor]:
    """Exact solution of the relaxed Sub1 (Eq. 16) ->
    (x_relaxed in [0, 1], t_star)."""
    c = params.lambda_e * energy - params.lambda_i * index      # (…, K)
    beneficial = c < 0.0
    t_safe = torch.clamp_min(times, 1e-9)

    # J(T) at every breakpoint T = t_j (plus T = 0): (…, K+1, K).
    cand = torch.cat([torch.zeros(t_safe.shape[:-1] + (1,),
                                  dtype=times.dtype, device=times.device),
                      t_safe], dim=-1)
    frac = torch.clamp_max(cand[..., :, None] / t_safe[..., None, :], 1.0)
    contrib = torch.where(beneficial[..., None, :], c[..., None, :] * frac,
                          torch.zeros_like(frac))
    j_vals = params.lambda_t * cand + torch.sum(contrib, dim=-1)
    # A per-lane gather keeps the lookup on the device (no host sync).
    t_star = torch.gather(cand, -1, torch.argmin(j_vals, dim=-1,
                                                 keepdim=True))

    x = torch.where(beneficial, torch.clamp_max(t_star / t_safe, 1.0),
                    torch.zeros_like(t_safe))
    return x, t_star[..., 0]


def round_with_min(x_relaxed: Tensor, index: Tensor, n_min: int) -> Tensor:
    """Round priorities to {0,1}; enforce (14c) via a top-N fallback that
    adds the ``n_min`` highest priorities (index as tiebreaker)."""
    x = (x_relaxed >= 0.5).to(torch.float32)
    need_fallback = torch.sum(x, dim=-1, keepdim=True) < n_min
    idx_norm = index / torch.clamp_min(
        torch.amax(index, dim=-1, keepdim=True), 1e-12)
    priority = x_relaxed + 1e-4 * idx_norm
    # scatter_ with a scalar: no host-to-device copy of the value.
    fallback = torch.zeros_like(x).scatter_(
        -1, top_indices(priority, n_min), 1.0)
    return torch.where(need_fallback, torch.maximum(x, fallback), x)


def solve_sub1(energy: Tensor, times: Tensor, index: Tensor,
               params: Sub1Params) -> tuple[Tensor, Tensor, Tensor]:
    """Full Sub1: relax -> round -> enforce minimum count.

    Returns (x_binary, x_relaxed, t_star).
    """
    x_rel, t_star = solve_sub1_relaxed(energy, times, index, params)
    x_bin = round_with_min(x_rel, index, params.n_min)
    return x_bin, x_rel, t_star

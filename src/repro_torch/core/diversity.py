"""Dataset-diversity measures and the paper's diversity index (§III, §IV-B).

Port of ``repro.core.diversity``.  The index
(Eq. 4) is ``I_k = sum_i gamma_i * metric_i(k) / max_k metric_i`` over
{dataset diversity, dataset size, age}; the diversity term is the
Gini-Simpson index (Eq. 2) or Shannon entropy (Eq. 3) of the device's
label histogram.  The ``diversity`` CUDA kernel
(``repro_torch.kernels.diversity``) computes the per-device measures in
one fused pass; :func:`diversity_index_from_stats` turns them into the
index each round.  Approximate and sample entropy (§III's sequence
measures, which no path calls) are here too.
"""

from __future__ import annotations

import dataclasses

import torch

Tensor = torch.Tensor


def label_histogram(labels: Tensor, mask: Tensor, num_classes: int) -> Tensor:
    """(…, n) labels + {0,1} mask -> (…, C) float class counts.

    Entries with mask 0, and labels outside [0, C), are ignored (the
    reference's ``one_hot`` gives them an all-zero row).
    """
    classes = torch.arange(num_classes, device=labels.device)
    one_hot = (labels[..., None] == classes).to(torch.float32)
    return torch.sum(one_hot * mask[..., None].to(torch.float32), dim=-2)


def class_probs(hist: Tensor) -> Tensor:
    total = torch.sum(hist, dim=-1, keepdim=True)
    return hist / torch.clamp_min(total, 1.0)


def simpson_index(probs: Tensor) -> Tensor:
    """lambda = sum_c p_c^2 (Eq. 2)."""
    return torch.sum(probs * probs, dim=-1)


def gini_simpson(probs: Tensor) -> Tensor:
    """1 - lambda: in [0, 1 - 1/C]."""
    return 1.0 - simpson_index(probs)


def shannon_entropy(probs: Tensor) -> Tensor:
    """H = -sum p log2 p (Eq. 3), with 0*log(0) := 0."""
    logp = torch.where(probs > 0.0,
                       torch.log2(torch.clamp_min(probs, 1e-30)),
                       torch.zeros_like(probs))
    return -torch.sum(probs * logp, dim=-1)


# ---------------------------------------------------------------------------
# Sequence diversity: approximate / sample entropy (§III)
# ---------------------------------------------------------------------------

def _template_matches(series: Tensor, m: int, r: Tensor) -> Tensor:
    """(nt, nt) 0/1 matrix of length-``m`` template pairs within
    Chebyshev distance ``r`` (O(n^2): callers pass a few hundred
    samples, as the paper advises)."""
    nt = series.shape[0] - m + 1
    idx = torch.arange(nt)[:, None] + torch.arange(m)[None, :]
    t = series[idx.to(series.device)]                       # (nt, m)
    dist = torch.amax(torch.abs(t[:, None, :] - t[None, :, :]), dim=-1)
    return (dist <= r).to(torch.float32)


def approximate_entropy(series: Tensor, m: int = 2,
                        r_factor: float = 0.2) -> Tensor:
    """ApEn(m, r) = Phi^m(r) - Phi^{m+1}(r) (Pincus); r = r_factor * std
    (population std), self-matches included."""
    r = r_factor * torch.std(series, correction=0)

    def phi(mm: int) -> Tensor:
        frac = torch.mean(_template_matches(series, mm, r), dim=-1)
        return torch.mean(torch.log(torch.clamp_min(frac, 1e-12)))

    return phi(m) - phi(m + 1)


def sample_entropy(series: Tensor, m: int = 2,
                   r_factor: float = 0.2) -> Tensor:
    """SampEn(m, r) = -log(A/B), self-matches excluded (length-robust)."""
    r = r_factor * torch.std(series, correction=0)

    def pair_count(mm: int) -> Tensor:
        match = _template_matches(series, mm, r)
        eye = torch.eye(match.shape[0], device=match.device)
        return torch.sum(match * (1.0 - eye))

    b = pair_count(m)
    a = pair_count(m + 1)
    return -torch.log(torch.clamp_min(a, 1e-12) / torch.clamp_min(b, 1e-12))


@dataclasses.dataclass(frozen=True)
class IndexWeights:
    """gamma_i weights; the paper's experiments use 1/3 each."""

    diversity: float = 1.0 / 3.0
    size: float = 1.0 / 3.0
    age: float = 1.0 / 3.0


def normalize_metric(values: Tensor) -> Tensor:
    """v_i = value / max_k value over the trailing axis; 0 if all zero."""
    m = torch.amax(values, dim=-1, keepdim=True)
    return torch.where(m > 0.0, values / torch.clamp_min(m, 1e-12),
                       torch.zeros_like(values))


def age_priority(ages: Tensor) -> Tensor:
    """Age-of-update term f(k) = log(1 + T(k)) (Yang et al. form, §VI)."""
    return torch.log1p(ages.to(torch.float32))


def diversity_index_from_stats(*, div: Tensor, data_sizes: Tensor,
                               ages: Tensor,
                               weights: IndexWeights = IndexWeights()
                               ) -> Tensor:
    """Eq. 4 from an already-computed per-device diversity measure.

    ``div`` (K,) Gini-Simpson or Shannon values, ``data_sizes`` (K,)
    sample counts, ``ages`` (K,) rounds since last selection.
    """
    return (normalize_metric(div) * weights.diversity
            + normalize_metric(data_sizes.to(torch.float32)) * weights.size
            + normalize_metric(age_priority(ages)) * weights.age)


def measure_column(measure: str) -> int:
    """Column of ``measure`` in the (K, 3) [gini, shannon, count] stats."""
    if measure == "gini_simpson":
        return 0
    if measure == "shannon":
        return 1
    raise ValueError(f"unknown diversity measure: {measure!r}")


def diversity_measure(label_hists: Tensor, measure: str) -> Tensor:
    """(…, C) histograms -> (…,) diversity values for the named measure."""
    probs = class_probs(label_hists)
    if measure == "gini_simpson":
        return gini_simpson(probs)
    if measure == "shannon":
        return shannon_entropy(probs)
    raise ValueError(f"unknown diversity measure: {measure!r}")


def diversity_index(*, label_hists: Tensor, data_sizes: Tensor,
                    ages: Tensor, weights: IndexWeights = IndexWeights(),
                    measure: str = "gini_simpson") -> Tensor:
    """Compute I_k for every device (Eq. 4) from (K, C) histograms."""
    div = diversity_measure(label_hists, measure)
    return diversity_index_from_stats(div=div, data_sizes=data_sizes,
                                      ages=ages, weights=weights)

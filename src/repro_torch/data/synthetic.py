"""Synthetic class-prototype image dataset (offline MNIST stand-in).

Port of ``repro.data.synthetic``.  The generator draws with
``np.random.default_rng`` exactly like the reference, so the same seed
gives the same arrays bit for bit.  Per class: a smooth random prototype
image plus a low-rank "style" subspace; a sample is ``prototype + style
@ coeffs + pixel noise``, clipped to [0, 1] and stored as uint8.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SyntheticSpec:
    num_classes: int = 10
    image_size: int = 28
    style_rank: int = 4        # intra-class variation components
    style_scale: float = 0.35
    noise_scale: float = 0.15
    smooth_passes: int = 2     # box-blur passes for spatial coherence


def _smooth(img: np.ndarray, passes: int) -> np.ndarray:
    """Cheap box blur so prototypes have spatial structure."""
    for _ in range(passes):
        padded = np.pad(img, ((1, 1), (1, 1)), mode="edge")
        img = (padded[:-2, 1:-1] + padded[2:, 1:-1] + padded[1:-1, :-2]
               + padded[1:-1, 2:] + padded[1:-1, 1:-1]) / 5.0
    return img


def make_prototypes(seed: int, spec: SyntheticSpec) -> tuple[np.ndarray,
                                                             np.ndarray]:
    """Returns (prototypes (C,H,W), styles (C,R,H,W)) as float32 in ~[0,1]."""
    rng = np.random.default_rng(seed)
    h = spec.image_size
    protos = []
    styles = []
    for _ in range(spec.num_classes):
        p = _smooth(rng.standard_normal((h, h)), spec.smooth_passes)
        p = (p - p.min()) / max(p.max() - p.min(), 1e-6)
        protos.append(p)
        s = np.stack([
            _smooth(rng.standard_normal((h, h)), spec.smooth_passes)
            for _ in range(spec.style_rank)
        ])
        styles.append(s)
    return (np.asarray(protos, np.float32), np.asarray(styles, np.float32))


def generate(seed: int, samples_per_class: int,
             spec: SyntheticSpec = SyntheticSpec()) -> tuple[np.ndarray,
                                                             np.ndarray]:
    """The full dataset: (images uint8 (N,H,W), labels int32 (N,)),
    ordered by class so the partitioner can slice shards directly."""
    protos, styles = make_prototypes(seed, spec)
    rng = np.random.default_rng(seed + 1)
    images = []
    labels = []
    for c in range(spec.num_classes):
        coeff = rng.standard_normal(
            (samples_per_class, spec.style_rank)).astype(np.float32)
        x = (protos[c][None]
             + spec.style_scale * np.einsum("nr,rhw->nhw", coeff, styles[c])
             + spec.noise_scale * rng.standard_normal(
                 (samples_per_class, spec.image_size, spec.image_size)
             ).astype(np.float32))
        x = np.clip(x, 0.0, 1.0)
        images.append((x * 255.0).astype(np.uint8))
        labels.append(np.full((samples_per_class,), c, np.int32))
    return np.concatenate(images), np.concatenate(labels)


def to_float(images: torch.Tensor) -> torch.Tensor:
    """uint8 -> float32 in [0, 1]."""
    return images.to(torch.float32) / 255.0


def sample_arrival_rates(u: torch.Tensor, rate: float,
                         spread: float = 0.5) -> torch.Tensor:
    """Per-device mean arrivals/round for the streaming subsystem.

    ``rate * U[1 - spread, 1 + spread]`` — heterogeneous device activity
    around the configured mean.  ``u`` is the (K,) draw on [0, 1) (a
    caller makes it with ``torch.rand``, or hands over the reference's
    ``jax.random.uniform``); it is mapped onto the interval as
    ``jax.random.uniform`` maps its own bits.
    """
    lo, hi = (float(np.float32(x)) for x in (1.0 - spread, 1.0 + spread))
    width = float(np.float32(hi - lo))      # the bounds are f32 there too
    return rate * torch.clamp_min(u * width + lo, lo)

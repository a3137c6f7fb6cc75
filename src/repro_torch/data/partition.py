"""Non-IID shard partitioner (paper §VI-A.2) + stacked client tensors.

Port of ``repro.data.partition``: sort by label, cut into ``num_shards``
single-class shards, hold out whole shards for test, and give each of
the K devices U[min, max] shards (rescaled to fit the pool).  The draws
use ``np.random.default_rng`` exactly like the reference, so the same
seed gives the same arrays; the result is a :class:`ClientDataset` of
CPU torch tensors that :meth:`ClientDataset.to` moves to a device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class PartitionSpec:
    num_devices: int = 100
    num_shards: int = 1200
    shard_size: int = 50
    min_shards: int = 1
    max_shards: int = 30
    test_fraction: float = 0.1  # paper: keep 10% for test


@dataclasses.dataclass
class ClientDataset:
    """Stacked per-client training data + global test split."""

    images: torch.Tensor       # (K, cap, H, W) uint8
    labels: torch.Tensor       # (K, cap) int32
    mask: torch.Tensor         # (K, cap) float32, 1 = valid sample
    sizes: torch.Tensor        # (K,) int32 = mask.sum(axis=1)
    test_images: torch.Tensor  # (T, H, W) uint8
    test_labels: torch.Tensor  # (T,) int32

    @property
    def num_devices(self) -> int:
        return self.images.shape[0]

    @property
    def capacity(self) -> int:
        return self.images.shape[1]

    def to(self, device: torch.device) -> "ClientDataset":
        return ClientDataset(*(getattr(self, f.name).to(device)
                               for f in dataclasses.fields(self)))


def arrival_affinity(label_hists: torch.Tensor,
                     mix_uniform: float = 0.1) -> torch.Tensor:
    """Per-device arrival class distribution for the streaming subsystem.

    A device keeps receiving data shaped like its shard partition: its
    initial (…, K, C) class profile, floored by a uniform mixture of
    weight ``mix_uniform`` so every class stays reachable.  Rows sum to 1.
    """
    h = label_hists.to(torch.float32)
    num_classes = h.shape[-1]
    total = torch.sum(h, dim=-1, keepdim=True)
    base = torch.where(total > 0.0, h / torch.clamp_min(total, 1.0),
                       torch.full_like(h, 1.0 / num_classes))
    return (1.0 - mix_uniform) * base + mix_uniform / num_classes


def draw_shard_counts(rng: np.random.Generator,
                      spec: PartitionSpec) -> np.ndarray:
    """Per-device shard counts, U[min,max] rescaled to fit the shard pool."""
    counts = rng.integers(spec.min_shards, spec.max_shards + 1,
                          size=spec.num_devices)
    total = int(counts.sum())
    if total > spec.num_shards:
        scaled = np.maximum(
            spec.min_shards,
            np.floor(counts * spec.num_shards / total).astype(np.int64))
        # Trim any residual overshoot from the largest holders.
        while scaled.sum() > spec.num_shards:
            i = int(np.argmax(scaled))
            scaled[i] -= 1
        counts = scaled
    return counts.astype(np.int64)


def partition(images: np.ndarray, labels: np.ndarray, seed: int,
              spec: PartitionSpec = PartitionSpec()) -> ClientDataset:
    """Apply the paper's shard protocol to a label-sorted dataset."""
    n = spec.num_shards * spec.shard_size
    if images.shape[0] < n:
        raise ValueError(
            f"need {n} samples for {spec.num_shards}x{spec.shard_size} "
            f"shards, got {images.shape[0]}")
    order = np.argsort(labels[:n], kind="stable")   # sort by digit label
    images, labels = images[:n][order], labels[:n][order]

    rng = np.random.default_rng(seed)
    # Hold out whole shards for test; the rest go to the devices.
    num_test_shards = max(1, int(round(spec.num_shards *
                                       spec.test_fraction)))
    shard_ids = rng.permutation(spec.num_shards)
    test_shards = shard_ids[:num_test_shards]
    train_shards = shard_ids[num_test_shards:]

    def shard_slice(s: int) -> slice:
        return slice(s * spec.shard_size, (s + 1) * spec.shard_size)

    test_images = np.concatenate([images[shard_slice(s)]
                                  for s in test_shards])
    test_labels = np.concatenate([labels[shard_slice(s)]
                                  for s in test_shards])

    pool_spec = dataclasses.replace(spec, num_shards=len(train_shards))
    counts = draw_shard_counts(rng, pool_spec)
    cap = int(counts.max()) * spec.shard_size

    h, w = images.shape[1:]
    cli_images = np.zeros((spec.num_devices, cap, h, w), np.uint8)
    cli_labels = np.zeros((spec.num_devices, cap), np.int32)
    cli_mask = np.zeros((spec.num_devices, cap), np.float32)

    cursor = 0
    for k in range(spec.num_devices):
        got = 0
        for _ in range(int(counts[k])):
            s = train_shards[cursor]
            cursor += 1
            sl = shard_slice(s)
            cli_images[k, got:got + spec.shard_size] = images[sl]
            cli_labels[k, got:got + spec.shard_size] = labels[sl]
            cli_mask[k, got:got + spec.shard_size] = 1.0
            got += spec.shard_size
    sizes = cli_mask.sum(axis=1).astype(np.int32)

    return ClientDataset(
        images=torch.from_numpy(cli_images),
        labels=torch.from_numpy(cli_labels),
        mask=torch.from_numpy(cli_mask),
        sizes=torch.from_numpy(sizes),
        test_images=torch.from_numpy(test_images),
        test_labels=torch.from_numpy(test_labels),
    )

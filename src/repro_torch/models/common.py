"""Shared model-zoo building blocks: norms, init, rotary embeddings.

Port of ``repro.models.common``.  Parameters are plain nested dicts of
tensors; the random initializers take an explicit ``torch.Generator``,
and every initializer makes its tensor on the default device, which
``transformer.init`` sets to the generator's (``meta`` when it only
counts parameters).  Norms and rotary
embeddings compute in f32 and cast back to the input's dtype, as the
reference does, and so do Qwen2-VL's M-RoPE and Whisper's sinusoidal
absolute positions.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, shape: Tuple[int, ...], fan_in: int,
               dtype=torch.float32) -> torch.Tensor:
    """Truncated normal at +-2 sigma, scaled by ``fan_in ** -0.5``."""
    t = torch.empty(shape)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    # In place: at full width a leaf's f32 draw is the init's peak.
    return t.mul_(fan_in ** -0.5).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, dim: int,
               dtype=torch.float32) -> torch.Tensor:
    """Normal scaled by ``dim ** -0.5``."""
    t = torch.empty((vocab, dim)).normal_(generator=gen)
    return (t * dim ** -0.5).to(dtype)


def filled(shape: Tuple[int, ...], value: float,
           dtype=torch.float32) -> torch.Tensor:
    return torch.full(shape, value, dtype=dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def norm_init(d: int, norm_type: str, groups: Tuple[int, ...] = ()) -> dict:
    """Norm parameters (f32), with leading ``groups`` dims if stacked."""
    p = {"scale": filled(groups + (d,), 1.0)}
    if norm_type != "rmsnorm":
        p["bias"] = filled(groups + (d,), 0.0)
    return p


def apply_norm(p: dict, x: torch.Tensor, norm_type: str,
               eps: float) -> torch.Tensor:
    if norm_type == "rmsnorm":
        return rmsnorm(x, p["scale"], eps)
    return layernorm(x, p["scale"], p["bias"], eps)


# ---------------------------------------------------------------------------
# Rotary embeddings (RoPE / partial rotary / M-RoPE)
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, fraction: float = 1.0,
               device=None) -> torch.Tensor:
    """Inverse frequencies for the rotated fraction of the head dim."""
    rot = int(head_dim * fraction) // 2 * 2
    exponent = torch.arange(0, rot, 2, dtype=torch.float32,
                            device=device) / max(rot, 1)
    return 1.0 / (theta ** exponent)        # (rot/2,)


def rope_sin_cos(positions: torch.Tensor, head_dim: int, theta: float,
                 fraction: float = 1.0
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions (..., S) -> sin/cos (..., S, rot/2)."""
    freqs = rope_freqs(head_dim, theta, fraction, positions.device)
    angles = positions[..., None].float() * freqs
    return torch.sin(angles), torch.cos(angles)


def mrope_axes(sections: Tuple[int, ...], slots: int) -> list:
    """The position axis (0 temporal, 1 height, 2 width) that drives each
    of ``slots`` frequency slots: ``sections[i]`` slots for axis i in
    order, as ``jnp.repeat(arange(3), sections, total_repeat_length=
    slots)`` gives them, which truncates past ``slots`` and pads a short
    repeat with the last axis (``reduced()``'s (4, 6, 6) covers 16 of 32
    slots, so slots 16-31 follow the width axis)."""
    axes = [i for i, n in enumerate(sections) for _ in range(n)][:slots]
    return axes + [len(sections) - 1] * (slots - len(axes))


def mrope_sin_cos(positions: torch.Tensor, head_dim: int, theta: float,
                  sections: Tuple[int, ...]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Qwen2-VL multimodal RoPE (arXiv:2409.12191).

    ``positions``: (3, B, S) temporal / height / width position ids
    (equal for text).  ``sections`` split the hd/2 frequency slots among
    the three axes (:func:`mrope_axes`).  Returns sin/cos (B, S, hd/2).
    """
    assert positions.shape[0] == len(sections) == 3
    freqs = rope_freqs(head_dim, theta, 1.0, positions.device)
    axes = torch.tensor(mrope_axes(sections, freqs.shape[0]),
                        device=positions.device)
    # Slot j's angle: its axis's position times freqs[j].
    angles = positions[axes].permute(1, 2, 0).float() * freqs
    return torch.sin(angles), torch.cos(angles)


def apply_rope(x: torch.Tensor, sin: torch.Tensor,
               cos: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, hd); sin/cos: (B, S, rot/2).  Rotates the first
    ``2*rot/2`` channels as interleaved pairs (partial rotary leaves the
    tail untouched)."""
    rot2 = sin.shape[-1]
    x_rot, x_pass = x[..., :2 * rot2], x[..., 2 * rot2:]
    x1 = x_rot[..., 0::2].float()
    x2 = x_rot[..., 1::2].float()
    s = sin[..., None, :].float()
    c = cos[..., None, :].float()
    o1 = x1 * c - x2 * s
    o2 = x2 * c + x1 * s
    out = torch.stack([o1, o2], dim=-1).reshape(x_rot.shape).to(x.dtype)
    return torch.cat([out, x_pass], dim=-1) if x_pass.shape[-1] else out


def sinusoid(positions: torch.Tensor, dim: int) -> torch.Tensor:
    """Rows of Whisper's absolute sinusoidal table at integer
    ``positions`` (N,): (N, dim), f32, sin of ``position * freqs`` then
    cos of it."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32,
                                     device=positions.device)
                      / max(half - 1, 1))
    angles = positions[:, None] * freqs[None, :]
    return torch.cat([torch.sin(angles), torch.cos(angles)], dim=-1)


def sinusoidal_positions(length: int, dim: int,
                         device=None) -> torch.Tensor:
    """Whisper's absolute sinusoidal embeddings (length, dim), f32."""
    return sinusoid(torch.arange(length, device=device), dim)

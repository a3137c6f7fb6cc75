"""Shared model-zoo building blocks: norms, init, rotary embeddings.

Port of ``repro.models.common``.  Parameters are plain nested dicts of
tensors; the random initializers take an explicit ``torch.Generator``,
and every initializer makes its tensor on the default device, which
``transformer.init`` sets to the generator's (``meta`` when it only
counts parameters).  Norms and rotary
embeddings compute in f32 and cast back to the input's dtype, as the
reference does.  ``mrope_sin_cos`` and ``sinusoidal_positions`` (the
VLM and Whisper paths) are not ported yet.
"""

from __future__ import annotations

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
# Rotary embeddings (RoPE / partial rotary)
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

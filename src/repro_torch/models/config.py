"""Unified model configuration for the architecture zoo.

A copy of ``repro.models.config`` (the JAX package's), with the same
fields, defaults, derived properties and ``reduced()``, so the port
never imports the reference.  One frozen dataclass describes every
architecture: dense / MoE / SSM / hybrid / VLM / audio enc-dec.  Layer
heterogeneity is a ``pattern`` of :class:`LayerSpec` entries cycled over
the depth; parameters are stacked per pattern position over
``num_layers / len(pattern)`` groups.  Fields that only the JAX
package's lowering reads (``layer_mode``, ``remat``,
``sequence_sharding``, ``attn_chunk``) are kept so configurations
compare equal field by field.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One position in the repeating layer pattern."""

    mixer: str = "attn"     # attn | mamba | mlstm | slstm
    ffn: str = "mlp"        # mlp | moe | none
    sliding_window: bool = False  # this attn layer uses the SWA window


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    arch_type: str = "dense"   # dense | moe | vlm | ssm | hybrid | audio
    num_layers: int = 2
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: int = 4
    d_ff: int = 1024
    vocab_size: int = 32000
    head_dim: int = 0          # 0 -> d_model // num_heads
    pattern: Tuple[LayerSpec, ...] = (LayerSpec(),)

    # Attention options
    qk_norm: bool = False
    rope_theta: float = 1.0e4
    rope_fraction: float = 1.0     # partial rotary (stablelm: 0.25)
    mrope_sections: Tuple[int, ...] = ()  # qwen2-vl M-RoPE (t, h, w) halves
    sliding_window: int = 0        # window size for SWA layers
    causal: bool = True
    attn_chunk: int = 1024         # q-chunk for blocked attention (unrolled)

    # FFN / MoE
    mlp_activation: str = "swiglu"   # swiglu | gelu
    num_experts: int = 0
    num_experts_per_tok: int = 0
    router_aux_weight: float = 0.01
    moe_impl: str = "dense_grouped"  # dense_grouped | ragged | dense
    # ragged (sort + lax.ragged_dot) is the TPU-target grouped-GEMM
    # path but does not partition under GSPMD today (it replicates
    # the gathered token matrix -> 705 GB/device at qwen3-moe
    # train_4k; EXPERIMENTS.md §Perf-hillclimb).  The GShard einsum
    # dispatch shards cleanly and is the lowering default.
    moe_group_size: int = 4096       # dense_grouped dispatch group
    moe_capacity_factor: float = 1.25

    # SSM (Mamba, SSD formulation — DESIGN.md hardware adaptation)
    ssm_state_dim: int = 128
    ssm_conv_dim: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256

    # xLSTM
    xlstm_heads: int = 4

    # Encoder-decoder (whisper)
    encoder_layers: int = 0
    cross_attention: bool = False

    # Input modality: "tokens" or "embeddings" (VLM/audio frontend stub)
    input_mode: str = "tokens"
    pos_embedding: str = "rope"    # rope | absolute (whisper)

    # Numerics / execution
    norm_type: str = "rmsnorm"     # rmsnorm | layernorm
    use_bias: bool = False
    norm_eps: float = 1.0e-6
    dtype_compute: str = "bfloat16"
    dtype_params: str = "float32"
    tie_embeddings: bool = False
    remat: bool = True
    layer_mode: str = "scan"       # scan | unroll (see EXPERIMENTS.md §Dry-run)
    sequence_sharding: bool = True # Megatron-SP residual stream (§Perf)
    logits_softcap: float = 0.0

    # ---- derived ----
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def pattern_period(self) -> int:
        return len(self.pattern)

    @property
    def num_groups(self) -> int:
        assert self.num_layers % self.pattern_period == 0, (
            f"{self.name}: num_layers={self.num_layers} not divisible by "
            f"pattern period {self.pattern_period}")
        return self.num_layers // self.pattern_period

    @property
    def is_moe(self) -> bool:
        return any(s.ffn == "moe" for s in self.pattern)

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_num_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    def supports_long_context(self) -> bool:
        """Sub-quadratic decode: SSM/hybrid state or sliding window."""
        mixers = {s.mixer for s in self.pattern}
        if mixers - {"attn"}:
            # Any recurrent mixer -> O(1) state; attn layers in hybrids use
            # the SWA cache policy for long contexts.
            return True
        return self.sliding_window > 0

    def reduced(self, **overrides) -> "ModelConfig":
        """Smoke-test variant: <=2 pattern periods, d_model<=512, <=4 experts."""
        small = dict(
            num_layers=self.pattern_period,
            d_model=min(self.d_model, 256),
            num_heads=min(self.num_heads, 4),
            num_kv_heads=min(self.num_kv_heads, min(self.num_heads, 4)),
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            head_dim=64 if self.resolved_head_dim >= 64 else
                     self.resolved_head_dim,
            num_experts=min(self.num_experts, 4),
            num_experts_per_tok=min(self.num_experts_per_tok, 2),
            # Dropless dispatch at smoke scale: the decode-parity oracle
            # (prefill+decode == forward) only holds exactly when no
            # assignment is dropped, and with e<=4 experts a capacity
            # factor of e makes even the all-tokens-on-one-expert worst
            # case fit (cap = gs*k*e/e = gs*k).
            moe_capacity_factor=4.0,
            encoder_layers=min(self.encoder_layers, 2),
            sliding_window=min(self.sliding_window, 128)
            if self.sliding_window else 0,
            ssm_state_dim=min(self.ssm_state_dim, 16),
            ssm_chunk=64,
            attn_chunk=128,
            mrope_sections=(4, 6, 6) if self.mrope_sections else (),
            dtype_compute="float32",
            dtype_params="float32",
            remat=False,
        )
        # Keep kv divides q heads.
        if small["num_heads"] % small["num_kv_heads"]:
            small["num_kv_heads"] = small["num_heads"]
        small.update(overrides)
        return dataclasses.replace(self, **small)

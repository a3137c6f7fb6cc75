"""jamba-1.5-large-398b [hybrid] — 72L d_model=8192 64H (GQA kv=8)
d_ff=24576, MoE 16 experts top-2; Mamba+attention 1:7 interleave, MoE
every other layer.  [arXiv:2403.19887]

Pattern period 8: one attention layer per 8 (position 0), Mamba
elsewhere; MoE on even positions, dense MLP on odd.  The Mamba mixer uses
the SSD (scalar-decay) formulation — the TPU adaptation recorded in
DESIGN.md §3.
"""

from repro_torch.models.config import LayerSpec, ModelConfig

_PATTERN = tuple(
    LayerSpec(mixer=("attn" if i == 0 else "mamba"),
              ffn=("moe" if i % 2 == 0 else "mlp"))
    for i in range(8)
)

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    arch_type="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65536,
    pattern=_PATTERN,
    num_experts=16,
    num_experts_per_tok=2,
    ssm_state_dim=16,
    ssm_expand=2,
    ssm_head_dim=64,
    rope_theta=1.0e6,
    mlp_activation="swiglu",
    norm_type="rmsnorm",
)

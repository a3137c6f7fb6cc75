"""mixtral-8x22b [moe] — 56L d_model=6144 48H (GQA kv=8) expert
d_ff=16384 vocab=32768, MoE 8 experts top-2, sliding-window attention.
[arXiv:2401.04088]"""

from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    arch_type="moe",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=32768,
    pattern=(LayerSpec("attn", "moe", sliding_window=True),),
    sliding_window=4096,
    num_experts=8,
    num_experts_per_tok=2,
    rope_theta=1.0e6,
    mlp_activation="swiglu",
    norm_type="rmsnorm",
)

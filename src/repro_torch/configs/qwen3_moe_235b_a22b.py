"""qwen3-moe-235b-a22b [moe] — 94L d_model=4096 64H (GQA kv=4) expert
d_ff=1536 vocab=151936, MoE 128 experts top-8; qk_norm.
[hf:Qwen/Qwen3-30B-A3B family]"""

from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    arch_type="moe",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    head_dim=128,
    d_ff=1536,
    vocab_size=151936,
    pattern=(LayerSpec("attn", "moe"),),
    num_experts=128,
    num_experts_per_tok=8,
    qk_norm=True,
    rope_theta=1.0e6,
    mlp_activation="swiglu",
    norm_type="rmsnorm",
)

"""qwen3-14b [dense] — 40L d_model=5120 40H (GQA kv=8) d_ff=17408
vocab=151936; qk_norm, GQA.  [hf:Qwen/Qwen3-8B family]"""

from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b",
    arch_type="dense",
    num_layers=40,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=17408,
    vocab_size=151936,
    pattern=(LayerSpec("attn", "mlp"),),
    qk_norm=True,
    rope_theta=1.0e6,
    mlp_activation="swiglu",
    norm_type="rmsnorm",
)

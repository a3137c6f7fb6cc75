"""stablelm-12b [dense] — 40L d_model=5120 32H (GQA kv=8) d_ff=13824
vocab=100352; LayerNorm + partial rotary (25%).
[hf:stabilityai/stablelm-2-1_6b family]"""

from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="stablelm-12b",
    arch_type="dense",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=160,
    d_ff=13824,
    vocab_size=100352,
    pattern=(LayerSpec("attn", "mlp"),),
    rope_theta=1.0e4,
    rope_fraction=0.25,
    mlp_activation="swiglu",
    norm_type="layernorm",
)

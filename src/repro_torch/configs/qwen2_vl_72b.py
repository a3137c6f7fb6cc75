"""qwen2-vl-72b [vlm] — 80L d_model=8192 64H (GQA kv=8) d_ff=29568
vocab=152064; M-RoPE, dynamic resolution.  [arXiv:2409.12191]

Backbone only: the ViT vision encoder + projector are a STUB —
``input_specs`` feeds precomputed patch embeddings of shape
(batch, seq, d_model) with 3-axis M-RoPE position ids (temporal, height,
width).  Decode consumes generated text tokens via the embed table.
"""

from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    arch_type="vlm",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=29568,
    vocab_size=152064,
    pattern=(LayerSpec("attn", "mlp"),),
    mrope_sections=(16, 24, 24),
    rope_theta=1.0e6,
    input_mode="embeddings",
    mlp_activation="swiglu",
    norm_type="rmsnorm",
)

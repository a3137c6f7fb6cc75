"""codeqwen1.5-7b [dense] — 32L d_model=4096 32H (MHA kv=32) d_ff=13440
vocab=92416; qwen1.5 architecture.  [hf:Qwen/CodeQwen1.5-7B]"""

from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="codeqwen1.5-7b",
    arch_type="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    head_dim=128,
    d_ff=13440,
    vocab_size=92416,
    pattern=(LayerSpec("attn", "mlp"),),
    rope_theta=1.0e6,
    mlp_activation="swiglu",
    norm_type="rmsnorm",
)

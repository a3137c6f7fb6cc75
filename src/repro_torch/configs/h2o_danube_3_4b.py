"""h2o-danube-3-4b [dense] — 24L d_model=3840 32H (GQA kv=8) d_ff=10240
vocab=32000; llama+mistral mix with sliding-window attention.
[arXiv:2401.16818]"""

from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-3-4b",
    arch_type="dense",
    num_layers=24,
    d_model=3840,
    num_heads=32,
    num_kv_heads=8,
    head_dim=120,
    d_ff=10240,
    vocab_size=32000,
    pattern=(LayerSpec("attn", "mlp", sliding_window=True),),
    sliding_window=4096,
    rope_theta=1.0e4,
    mlp_activation="swiglu",
    norm_type="rmsnorm",
)

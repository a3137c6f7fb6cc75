"""whisper-small [audio] — 12L (x2: encoder + decoder) d_model=768 12H
d_ff=3072 vocab=51865; encoder-decoder with conv frontend STUB.
[arXiv:2212.04356]

Backbone only: the mel-spectrogram + conv feature extractor is a stub —
``input_specs`` feeds precomputed frame embeddings (batch, frames,
d_model) to the encoder.  The decoder is a standard causal transformer
with cross-attention and absolute sinusoidal positions.
"""

from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    arch_type="audio",
    num_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab_size=51865,
    pattern=(LayerSpec("attn", "mlp"),),
    encoder_layers=12,
    cross_attention=True,
    pos_embedding="absolute",
    mlp_activation="gelu",
    norm_type="layernorm",
    use_bias=True,
)

"""xlstm-125m [ssm] — 12L d_model=768 4H d_ff=0 vocab=50304; alternating
sLSTM + mLSTM blocks (no separate FFN — blocks carry their own
projections).  [arXiv:2405.04517]"""

from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    arch_type="ssm",
    num_layers=12,
    d_model=768,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    pattern=(LayerSpec("slstm", "none"), LayerSpec("mlstm", "none")),
    xlstm_heads=4,
    norm_type="rmsnorm",
)

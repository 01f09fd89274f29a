"""gemma-7b [dense] — 28L d_model=3072 16H (MHA kv=16, head_dim=256)
d_ff=24576 vocab=256000; GeGLU.  [arXiv:2403.08295]
"""
from repro_torch.models.transformer import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="gemma-7b",
    n_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv_heads=16,
    head_dim=256,
    d_ff=24576,
    vocab_size=256000,
    pattern=(LayerSpec(mixer="attn"),),
    activation="geglu",
    tie_embeddings=True,
    sharding_mode="tp",
    source="arXiv:2403.08295",
)

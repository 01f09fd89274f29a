"""h2o-danube-3-4b [dense] — 24L d_model=3840 32H (GQA kv=8, head_dim=120)
d_ff=10240 vocab=32000; llama+mistral mix with sliding-window attention
(window 8192).  [arXiv:2401.16818]
"""
from repro_torch.models.transformer import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="h2o-danube-3-4b",
    n_layers=24,
    d_model=3840,
    n_heads=32,
    n_kv_heads=8,
    head_dim=120,
    d_ff=10240,
    vocab_size=32000,
    pattern=(LayerSpec(mixer="attn", window=8192),),
    activation="swiglu",
    tie_embeddings=False,
    sharding_mode="tp",
    source="arXiv:2401.16818",
)

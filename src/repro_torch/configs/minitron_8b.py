"""minitron-8b [dense] — 32L d_model=4096 32H (GQA kv=8, head_dim=128)
d_ff=16384 vocab=256000; pruned Nemotron-4 (squared-ReLU MLP).
[arXiv:2407.14679]
"""
from repro_torch.models.transformer import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="minitron-8b",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=256000,
    pattern=(LayerSpec(mixer="attn"),),
    activation="relu2",
    tie_embeddings=True,
    sharding_mode="tp",
    source="arXiv:2407.14679",
)

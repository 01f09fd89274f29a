"""rwkv6-3b [ssm] — 32L d_model=2560 (attention-free), channel-mix
d_ff=8960, vocab=65536; RWKV-6 "Finch" with data-dependent decay,
head_size 64 (40 heads).  [arXiv:2404.05892]
"""
from repro_torch.models.transformer import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="rwkv6-3b",
    n_layers=32,
    d_model=2560,
    n_heads=40,          # informational; rwkv_heads = d_model // rwkv_head_dim
    n_kv_heads=40,
    head_dim=64,
    d_ff=8960,
    vocab_size=65536,
    pattern=(LayerSpec(mixer="rwkv", rope=False),),
    activation="relu2",  # channel-mix uses squared ReLU internally
    rwkv_head_dim=64,
    rwkv_lora_rank=64,
    tie_embeddings=False,
    sharding_mode="tp",
    source="arXiv:2404.05892",
)

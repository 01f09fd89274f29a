"""grok-1-314b [moe] — 64L d_model=6144 48H (GQA kv=8, head_dim=128)
expert d_ff=32768 vocab=131072; 8 experts top-2, MoE every layer.
[hf:xai-org/grok-1]
"""
from repro_torch.models.transformer import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="grok-1-314b",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=32768,
    vocab_size=131072,
    pattern=(LayerSpec(mixer="attn", moe=True),),
    activation="geglu",   # gated MoE FFN — matches grok-1's 314B total at 8e×32768
    n_experts=8,
    moe_top_k=2,
    moe_d_ff=32768,
    tie_embeddings=True,
    sharding_mode="fsdp_tp",
    source="hf:xai-org/grok-1",
)

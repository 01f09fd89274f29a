"""llama4-maverick-400b-a17b [moe] — 48L d_model=5120 40H (GQA kv=8,
head_dim=128) expert d_ff=8192 vocab=202048; 128 experts top-1 + shared
expert, MoE on alternating layers; iRoPE (every 4th layer NoPE/global,
others chunked-local window 8192).  [hf:meta-llama/Llama-4-Scout-17B-16E]
"""
from repro_torch.models.transformer import ArchConfig, LayerSpec

DENSE_LOCAL = LayerSpec(mixer="attn", window=8192, rope=True, moe=False)
MOE_LOCAL = LayerSpec(mixer="attn", window=8192, rope=True, moe=True)
MOE_NOPE = LayerSpec(mixer="attn", window=0, rope=False, moe=True)

CONFIG = ArchConfig(
    name="llama4-maverick-400b-a17b",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    pattern=(DENSE_LOCAL, MOE_LOCAL, DENSE_LOCAL, MOE_NOPE),
    activation="swiglu",
    n_experts=128,
    moe_top_k=1,
    moe_d_ff=8192,
    moe_shared_expert=True,
    rope_theta=500_000.0,
    tie_embeddings=True,
    sharding_mode="fsdp_tp",
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
)

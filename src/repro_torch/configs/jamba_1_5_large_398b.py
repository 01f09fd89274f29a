"""jamba-1.5-large-398b [hybrid] — 72L d_model=8192 64H (GQA kv=8,
head_dim=128) d_ff=24576 vocab=65536; Mamba:attention 7:1 interleave
(one attention layer per 8-layer block), MoE 16e top-2 every other layer.
[arXiv:2403.19887]
"""
from repro_torch.models.transformer import ArchConfig, LayerSpec


def _spec(i: int) -> LayerSpec:
    mixer = "attn" if i == 3 else "mamba"          # 1 attn : 7 mamba per block
    return LayerSpec(mixer=mixer, moe=(i % 2 == 1), rope=False)


CONFIG = ArchConfig(
    name="jamba-1.5-large-398b",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65536,
    pattern=tuple(_spec(i) for i in range(8)),      # 72 = 9 × 8, exact
    activation="swiglu",
    n_experts=16,
    moe_top_k=2,
    moe_d_ff=24576,
    mamba_d_state=16,
    mamba_d_conv=4,
    mamba_expand=2,
    tie_embeddings=True,
    sharding_mode="fsdp_tp",
    source="arXiv:2403.19887",
)

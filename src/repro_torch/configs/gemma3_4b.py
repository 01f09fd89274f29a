"""gemma3-4b [dense] — 34L d_model=2560 8H (GQA kv=4, head_dim=256)
d_ff=10240 vocab=262144; 5:1 local(SWA-1024):global interleave, GeGLU,
QK-norm, 128k context.  [hf:google/gemma-3-1b-pt]
"""
from repro_torch.models.transformer import ArchConfig, LayerSpec

LOCAL = LayerSpec(mixer="attn", window=1024, rope=True)
GLOBAL = LayerSpec(mixer="attn", window=0, rope=True)

CONFIG = ArchConfig(
    name="gemma3-4b",
    n_layers=34,
    d_model=2560,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=10240,
    vocab_size=262144,
    pattern=(LOCAL, LOCAL, LOCAL, LOCAL, LOCAL, GLOBAL),   # 5:1 local:global
    activation="geglu",
    qk_norm=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    sharding_mode="tp",
    source="hf:google/gemma-3-1b-pt",
)

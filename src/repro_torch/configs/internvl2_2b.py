"""internvl2-2b [vlm] — 24L d_model=2048 16H (GQA kv=8, head_dim=128)
d_ff=8192 vocab=92553; InternLM2 language backbone; InternViT vision
encoder + projector are a STUB (input_specs provides patch embeddings).
[arXiv:2404.16821]
"""
from repro_torch.models.transformer import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="internvl2-2b",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=92553,
    pattern=(LayerSpec(mixer="attn"),),
    activation="swiglu",
    frontend="vision_stub",
    tie_embeddings=True,
    sharding_mode="tp",
    source="arXiv:2404.16821",
)

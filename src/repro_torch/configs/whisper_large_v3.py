"""whisper-large-v3 [audio] — enc-dec, 32+32L d_model=1280 20H (MHA kv=20,
head_dim=64) d_ff=5120 vocab=51866; mel-spectrogram conv frontend is a STUB
(input_specs provides 1500 frame embeddings).  [arXiv:2212.04356]
"""
from repro_torch.models.transformer import ArchConfig, EncoderConfig, LayerSpec

CONFIG = ArchConfig(
    name="whisper-large-v3",
    n_layers=32,                      # decoder layers
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    head_dim=64,
    d_ff=5120,
    vocab_size=51866,
    pattern=(LayerSpec(mixer="attn", rope=False, cross_attn=True),),
    activation="gelu",
    norm="layernorm",
    abs_pos=True,
    encoder=EncoderConfig(n_layers=32, n_heads=20, d_ff=5120, n_frames=1500),
    frontend="audio_stub",
    tie_embeddings=True,
    sharding_mode="tp",
    source="arXiv:2212.04356",
)

"""Architecture registry: the 10 assigned architectures.

Port of ``repro.configs``: the same configurations, field for field (each
``configs/<arch>.py`` is a copy of the reference's, as data), over the
port's :class:`~repro_torch.models.transformer.ArchConfig`.  All ten
construct and run; whisper's encoder takes the stub frontend's frame
embeddings (``forward(..., enc_embeds=...)``, ``decode.warm_cache``)."""
from __future__ import annotations

from repro_torch.configs import (
    gemma3_4b,
    gemma_7b,
    grok_1_314b,
    h2o_danube_3_4b,
    internvl2_2b,
    jamba_1_5_large_398b,
    llama4_maverick_400b_a17b,
    minitron_8b,
    rwkv6_3b,
    whisper_large_v3,
)
from repro_torch.configs.shapes import SHAPES, InputShape  # noqa: F401
from repro_torch.models.transformer import ArchConfig

ARCHS: dict[str, ArchConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (
        gemma3_4b,
        gemma_7b,
        llama4_maverick_400b_a17b,
        grok_1_314b,
        jamba_1_5_large_398b,
        internvl2_2b,
        h2o_danube_3_4b,
        rwkv6_3b,
        whisper_large_v3,
        minitron_8b,
    )
}

# long_500k applicability (see DESIGN.md §5): sub-quadratic decode only.
LONG_CONTEXT_OK = {
    "gemma3-4b": True,            # 5:1 SWA-1024 : global
    "gemma-7b": False,            # pure full attention
    "llama4-maverick-400b-a17b": True,   # iRoPE chunked-local 3:1
    "grok-1-314b": False,         # pure full attention
    "jamba-1.5-large-398b": True,  # mamba-dominant hybrid
    "internvl2-2b": False,        # full-attention LM backbone
    "h2o-danube-3-4b": True,      # SWA-8192
    "rwkv6-3b": True,             # recurrent, O(1) state
    "whisper-large-v3": False,    # enc-dec, 448-token decoder spec
    "minitron-8b": False,         # pure full attention
}


def get_config(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]


def shape_applicable(arch: str, shape: str) -> tuple[bool, str]:
    """Whether (arch, shape) is runnable; returns (ok, reason_if_not)."""
    if shape == "long_500k" and not LONG_CONTEXT_OK[arch]:
        return False, "full-attention arch: no sub-quadratic decode variant (DESIGN.md §5)"
    return True, ""

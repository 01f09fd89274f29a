"""Device resolution: the card unless the caller names another device."""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means ``"cuda"``.  A CUDA device without CUDA raises — the
    port never falls back to the CPU on its own; pass ``device="cpu"`` to
    run there."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: repro_torch runs on the GPU by default; "
            "pass device='cpu' to run on the CPU explicitly")
    if dev.type == "cuda" and dev.index is None:
        # the device tensors report: "cuda" and "cuda:0" must compare equal
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev

"""Eval / serve step builders for the LM zoo.

Port of ``repro.models.lm``.  ``make_eval_step`` is the forward-only loss the
reference lowers for its ``prefill`` shape; ``make_serve_step`` and
``greedy_generate`` are its serving loop.  Every entry runs under
``torch.inference_mode()``: the port's attention and wkv kernels have no
backward yet, so training (``make_train_step``) is ROADMAP queue 1 item 7b.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.models.decode import decode_step, init_cache  # noqa: F401 (re-export)
from repro_torch.models.transformer import ArchConfig, forward

Pytree = Any
AUX_WEIGHT = 0.01  # MoE load-balance coefficient


def lm_loss(cfg: ArchConfig, params: Pytree, batch: dict) -> torch.Tensor:
    """Next-token cross-entropy (+ MoE aux).  ``batch`` carries ``labels``
    and one of ``tokens`` / ``embeds``."""
    logits, _, aux = forward(cfg, params, tokens=batch.get("tokens"),
                             embeds=batch.get("embeds"),
                             enc_embeds=batch.get("enc_embeds"))
    labels = batch["labels"]
    logp = torch.log_softmax(logits.float(), dim=-1)
    del logits          # the model-dtype logits: 4.3 GB at gemma3's (2, 4096)
    nll = -torch.gather(logp, -1, labels[..., None].long())[..., 0]
    return torch.mean(nll) + AUX_WEIGHT * aux


def make_train_step(cfg: ArchConfig, opt: Any = None) -> Callable:
    raise NotImplementedError(
        f"{cfg.name}: LM training is not ported yet (ROADMAP queue 1 item 7b: "
        "the optimizer, schedule, checkpoints and the kernels' backward)")


def make_eval_step(cfg: ArchConfig) -> Callable[[Pytree, dict], torch.Tensor]:
    def eval_step(params, batch):
        with torch.inference_mode():
            return lm_loss(cfg, params, batch)

    return eval_step


def make_serve_step(cfg: ArchConfig):
    """serve_step(params, cache, token (B,1)) -> (logits (B,1,V), cache')."""

    def serve_step(params, cache, token):
        with torch.inference_mode():
            return decode_step(cfg, params, cache, token)

    return serve_step


def greedy_generate(cfg: ArchConfig, params: Pytree, prompt: torch.Tensor,
                    max_new: int, seq_len: int) -> torch.Tensor:
    """Host-loop greedy decoding (prompt (B, P) on the params' device)."""
    B, P = prompt.shape
    step = make_serve_step(cfg)
    with torch.inference_mode():
        cache = init_cache(cfg, B, seq_len, device=prompt.device)
        tok = prompt[:, :1]
        out = [tok]
        for i in range(P + max_new - 1):
            logits, cache = step(params, cache, tok)
            if i + 1 < P:
                tok = prompt[:, i + 1:i + 2]
            else:
                tok = torch.argmax(logits[:, -1:, :], dim=-1).to(prompt.dtype)
            out.append(tok)
        return torch.cat(out, dim=1)

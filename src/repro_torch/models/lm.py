"""Train / eval / serve step builders for the LM zoo.

Port of ``repro.models.lm``.  ``make_train_step`` is the reference's
``jax.value_and_grad`` of ``lm_loss`` followed by the optimizer's update:
autograd through the full forward (the attention and wkv kernels
differentiate through their backward kernels on the card), then
``opt.update`` under ``torch.no_grad()``.  ``make_eval_step`` is the
forward-only loss the reference lowers for its ``prefill`` shape;
``make_serve_step`` and ``greedy_generate`` are its serving loop; those
three run under ``torch.inference_mode()``.  Every configuration of
``configs/`` runs; whisper-large-v3 takes its frame embeddings as the
batch's ``enc_embeds`` (B, n_frames, d_model), and its serving loop is
``decode.init_cache`` -> ``decode.warm_cache(..., enc_embeds=...)`` ->
``decode_step`` (``greedy_generate`` keeps the reference's signature, which
takes no frames).  whisper trains on the card as on the CPU: the flash
backward kernels take the cross-attention's Sq != Sk.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.models.decode import decode_step, init_cache  # noqa: F401 (re-export)
from repro_torch.models.transformer import ArchConfig, forward
from repro_torch.optim import Optimizer
from repro_torch.utils.tree import tree_leaves, tree_map

Pytree = Any
AUX_WEIGHT = 0.01  # MoE load-balance coefficient


def lm_loss(cfg: ArchConfig, params: Pytree, batch: dict) -> torch.Tensor:
    """Next-token cross-entropy (+ MoE aux).  ``batch`` carries ``labels``
    and one of ``tokens`` / ``embeds`` (+ ``enc_embeds`` for an
    encoder-decoder configuration)."""
    logits, _, aux = forward(cfg, params, tokens=batch.get("tokens"),
                             embeds=batch.get("embeds"),
                             enc_embeds=batch.get("enc_embeds"))
    labels = batch["labels"]
    logp = torch.log_softmax(logits.float(), dim=-1)
    del logits          # the model-dtype logits: 4.3 GB at gemma3's (2, 4096)
    nll = -torch.gather(logp, -1, labels[..., None].long())[..., 0]
    return torch.mean(nll) + AUX_WEIGHT * aux


def make_train_step(cfg: ArchConfig, opt: Optimizer
                    ) -> Callable[[Pytree, Pytree, dict], tuple[torch.Tensor, Pytree, Pytree]]:
    """``train_step(params, opt_state, batch) -> (loss, params, opt_state)``:
    the loss of leaves detached with ``requires_grad_(True)``, its
    gradient over every leaf in the reference's leaf order (zeros for a
    leaf the loss does not use, as ``jax.grad`` gives), then the update.
    The parameters passed in are not modified."""
    def train_step(params, opt_state, batch):
        leaves = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
        with torch.enable_grad():
            loss = lm_loss(cfg, _with_leaves(params, leaves), batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        with torch.no_grad():
            params, opt_state = opt.update(
                _with_leaves(params, [t.detach() for t in leaves]),
                _with_leaves(params, grads), opt_state)
        return loss.detach(), params, opt_state

    return train_step


def _with_leaves(tree: Pytree, leaves: list) -> Pytree:
    """``tree``'s structure with ``leaves`` in its leaf order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


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

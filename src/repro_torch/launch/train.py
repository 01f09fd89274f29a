"""LM training launcher.

Port of ``repro.launch.train`` (``--mode local``, the reference's default):
real training steps of an LM configuration — the synthetic token stream
(``repro_torch.data.lm``) -> ``make_train_step`` with AdamW over a
warm-up-cosine schedule -> a trainer checkpoint.  On the card unless
``--device`` names another device; the reference's ``--mode dryrun`` (the
512-chip lower-and-compile proof) is not ported.

Examples:
    PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-3b --reduced \\
        --steps 20 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-4b --reduced \\
        --steps 20 --ckpt experiments/lm_ckpt.npz
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.checkpoint import save_trainer_state
from repro_torch.configs import get_config
from repro_torch.data.lm import batch_stream, make_token_stream
from repro_torch.device import resolve_device
from repro_torch.models.lm import make_train_step
from repro_torch.models.transformer import init_params
from repro_torch.optim import adamw, warmup_cosine_schedule


def main(argv: list[str] | None = None) -> dict:
    """Train as the options say; returns ``{"first_loss", "last_loss",
    "losses", "steps"}``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="h2o-danube-3-4b")
    ap.add_argument("--reduced", action="store_true",
                    help="train the reduced same-family variant (CPU-safe)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--device", default="cuda",
                    help="the device to train on (default: the card)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced(vocab_size=min(cfg.vocab_size, 512))
    if cfg.frontend != "tokens" or cfg.encoder is not None:
        raise SystemExit(f"{args.arch}: local LM training needs a token "
                         "frontend (vlm/audio archs train via the dry-run path)")
    device = resolve_device(args.device)

    params = init_params(cfg, seed=0, device=device)
    opt = adamw(warmup_cosine_schedule(args.lr, args.steps // 10 + 1, args.steps))
    step = make_train_step(cfg, opt)
    opt_state = opt.init(params)

    toks = make_token_stream(cfg.vocab_size, 50_000, seed=0)
    t0 = time.time()
    losses = []
    for i, (x, y) in enumerate(batch_stream(toks, args.batch, args.seq,
                                            args.steps, seed=0)):
        batch = {"tokens": torch.from_numpy(x).long().to(device),
                 "labels": torch.from_numpy(y).long().to(device)}
        loss, params, opt_state = step(params, opt_state, batch)
        losses.append(float(loss))
        if i % args.log_every == 0 or i == args.steps - 1:
            tps = args.batch * args.seq * (i + 1) / (time.time() - t0)
            print(f"step {i:4d}  loss {losses[-1]:.4f}  tok/s {tps:,.0f}")
    print(f"\nloss {losses[0]:.4f} -> {losses[-1]:.4f} over {args.steps} steps "
          f"({time.time()-t0:.0f}s)")
    if args.ckpt:
        save_trainer_state(args.ckpt, params, opt_state, args.steps,
                           {"arch": cfg.name})
        print(f"checkpoint -> {args.ckpt}")
    return {"first_loss": losses[0], "last_loss": losses[-1], "losses": losses,
            "steps": args.steps}


if __name__ == "__main__":
    main()

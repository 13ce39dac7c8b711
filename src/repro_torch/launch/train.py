"""Runnable trainer (one card): TEASQ-Fed rounds or plain AdamW steps on
any assigned architecture at reduced (smoke) or full scale.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
      --smoke --steps 50 --batch 8 --seq 128
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
      --smoke --mode fed --groups 4 --local-steps 2 --steps 30 --device cpu

It runs on the card unless ``--device`` names another device.  The batch
stream is the JAX package's trainer's: one ``np.random.RandomState(seed)``
draws each batch's tokens, then an encoder-decoder's frames, then a VLM's
patches.  ``--mode fed`` runs ``core/fed_step.py``'s round (its
``gather_q`` compressor is kernel B's channel form on the card);
``--mode plain`` runs ``lm_loss``, its gradient, ``clip_by_global_norm``
at 1.0 and AdamW.
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint import save_pytree
from repro_torch.configs.base import get_config, get_smoke_config
from repro_torch.core.fed_step import FedConfig, make_fed_train_step
from repro_torch.data import make_token_batch
from repro_torch.models import transformer as T
from repro_torch.optim import adamw, apply_updates, clip_by_global_norm
from repro_torch.utils.tree import leaves, resolve_device


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv: Optional[List[str]] = None, params: Any = None
         ) -> Tuple[Any, List[Dict[str, float]]]:
    """The command line (see the module docstring).  ``params`` replaces
    the seeded random initial weights (e.g. the JAX package's, carried
    across with ``utils.tree.from_numpy``; they are not modified).
    Returns the final params and each step's metrics."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-friendly)")
    ap.add_argument("--mode", default="plain", choices=["plain", "fed"])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--groups", type=int, default=4)
    ap.add_argument("--local-steps", type=int, default=1)
    ap.add_argument("--fed-schedule", default="gather_q")
    ap.add_argument("--mu", type=float, default=0.01)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    print(f"[train] {cfg.name}: {cfg.n_layers}L d={cfg.d_model} "
          f"vocab={cfg.vocab} family={cfg.family}")
    if params is None:
        params = T.init_model(
            cfg, torch.Generator(device=dev).manual_seed(args.seed), dev)
    n_params = sum(x.numel() for x in leaves(params))
    print(f"[train] {n_params/1e6:.2f}M params")

    rng = np.random.RandomState(args.seed)

    def make_batch():
        b = make_token_batch(rng, args.batch, args.seq, cfg.vocab)
        batch = {"tokens": torch.from_numpy(b["tokens"]).to(dev)}
        if cfg.is_encoder_decoder:
            batch["frames"] = torch.from_numpy(rng.randn(
                args.batch, cfg.enc_seq, cfg.d_model).astype(
                    np.float32)).to(dev)
        if cfg.n_patches:
            batch["patches"] = torch.from_numpy(rng.randn(
                args.batch, cfg.n_patches, cfg.d_model).astype(
                    np.float32)).to(dev)
        return batch

    history: List[Dict[str, float]] = []
    if args.mode == "fed":
        fed = FedConfig(n_groups=args.groups, local_steps=args.local_steps,
                        lr=args.lr, mu=args.mu, schedule=args.fed_schedule)
        step = make_fed_train_step(lambda p, b: T.lm_loss(p, b, cfg)[0], fed)
        stale = torch.zeros((args.groups,), dtype=torch.int32, device=dev)
        for i in range(args.steps):
            t0 = time.time()
            params, m = step(params, make_batch(), stale)
            _sync(dev)
            dt = time.time() - t0
            history.append({k: float(v) for k, v in m.items()} | {"s": dt})
            print(f"[fed round {i:3d}] loss={history[-1]['local_loss']:.4f} "
                  f"alpha_t={history[-1]['alpha_t']:.3f} "
                  f"({dt:.2f}s)", flush=True)
    else:
        opt = adamw(args.lr)
        opt_state = opt.init(params)
        value_and_grad = torch.func.grad_and_value(
            lambda q, batch: T.lm_loss(q, batch, cfg), has_aux=True)

        def step(p, s, batch):
            grads, (loss, _) = value_and_grad(p, batch)
            grads, gn = clip_by_global_norm(grads, 1.0)
            upd, s = opt.update(grads, s, p)
            return apply_updates(p, upd), s, loss, gn

        for i in range(args.steps):
            t0 = time.time()
            params, opt_state, loss, gn = step(params, opt_state,
                                               make_batch())
            _sync(dev)
            dt = time.time() - t0
            history.append({"loss": float(loss), "gnorm": float(gn),
                            "s": dt})
            print(f"[step {i:3d}] loss={history[-1]['loss']:.4f} "
                  f"gnorm={history[-1]['gnorm']:.2f} ({dt:.2f}s)",
                  flush=True)

    if args.ckpt:
        save_pytree(args.ckpt, params)
        print(f"[train] checkpoint -> {args.ckpt}")
    return params, history


if __name__ == "__main__":
    main()

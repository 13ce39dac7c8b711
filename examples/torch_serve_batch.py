"""Batched serving of a small model on the PyTorch port: prefill +
KV-cache decode, for a dense, an MoE and an SSM architecture (the SSM's
prefill runs kernel C on the card).

The twin of ``examples/serve_batch.py``; it runs on the card unless given
``--device cpu``.

  PYTHONPATH=src python examples/torch_serve_batch.py [--device cpu]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs.base import get_smoke_config
from repro_torch.launch.serve import generate
from repro_torch.models import transformer as T
from repro_torch.utils.tree import resolve_device

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None, help="cpu or cuda (default: cuda)")
args = ap.parse_args()
device = resolve_device(args.device)

for arch in ["qwen3-1.7b", "phi3.5-moe-42b-a6.6b", "mamba2-370m"]:
    cfg = get_smoke_config(arch)
    params = T.init_model(cfg, torch.Generator().manual_seed(0), device)
    rng = np.random.RandomState(0)
    prompts = torch.from_numpy(rng.randint(0, cfg.vocab, (4, 16)).astype(
        np.int32)).to(device)
    t0 = time.time()
    seqs = generate(params, cfg, prompts, gen=12, temperature=0.8,
                    generator=torch.Generator(device).manual_seed(0))
    dt = time.time() - t0
    print(f"[{cfg.name:28s}] {seqs.shape[0]}x{seqs.shape[1]} tokens "
          f"in {dt:5.2f}s — sample: {seqs[0, -6:].tolist()}")

"""Quickstart, on the PyTorch port: the TEASQ-Fed core API in ~60 lines.

The twin of ``examples/quickstart.py``; it runs on the card unless given
``--device cpu``.

  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.core.compression import pytree_dense_bytes, roundtrip_pytree
from repro_torch.core.dynamic import make_schedule
from repro_torch.core.server import ServerConfig, TeasqServer
from repro_torch.core.staleness import staleness_weight
from repro_torch.fl.protocols import (make_setup, profile_compression,
                                      run_method)
from repro_torch.utils.tree import resolve_device

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None, help="cpu or cuda (default: cuda)")
ap.add_argument("--budget", type=float, default=40.0,
                help="simulated seconds of the FL run")
ap.add_argument("--samples", type=int, default=2000,
                help="training samples of the FL run")
args = ap.parse_args()
device = resolve_device(args.device)

# 1. The compression operator (Alg. 3/4): Top-K + QSGD round trip ---------
w = {"layer": torch.from_numpy(np.random.randn(64, 64).astype(np.float32)
                               ).to(device)}
w_hat, wire_bytes = roundtrip_pytree(w, p_s=0.25, p_q=8)
print(f"[compress] dense {pytree_dense_bytes(w)}B -> wire {wire_bytes}B "
      f"({pytree_dense_bytes(w)/wire_bytes:.1f}x)")

# 2. Staleness weighting (Eq. 6) ------------------------------------------
print("[staleness] S(0..4) =",
      [round(float(staleness_weight(s, 0.5)), 3) for s in range(5)])

# 3. The server state machine (Algs. 1-2) ---------------------------------
srv = TeasqServer({"w": torch.zeros(3, device=device)},
                  ServerConfig(n_devices=20, c_fraction=0.1))
print("[server] dispatch granted:", srv.try_dispatch() is not None,
      "| parallel limit:", srv.cfg.max_parallel,
      "| cache size K:", srv.cfg.cache_size)

# 4. A small end-to-end async FL run ---------------------------------------
data, parts, w0 = make_setup(n_devices=10, n_train=args.samples,
                             n_test=args.samples // 4, device=device)
si, qi, _ = profile_compression(w0, data, theta=0.03)     # Algorithm 5
sched = make_schedule(si, qi, total_rounds=30)
hist = run_method("teasq", data, parts, w0, time_budget=args.budget,
                  epochs=1, schedule=sched, device=device)
best = max(h.accuracy for h in hist)
print(f"[teasq] {hist[-1].round} rounds, acc {hist[0].accuracy:.3f} -> "
      f"{best:.3f}, uploaded {hist[-1].bytes_up//1024}KB")

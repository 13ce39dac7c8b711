"""The paper's technique on a (simulated) pod, on the PyTorch port:
TEASQ-Fed rounds over a device mesh with compressed delta exchange.

The twin of ``examples/multipod_fed_round.py``.  The port runs one process
per rank: on the CPU the reference's 4x2 ``(data, model)`` mesh is a world
of 8 gloo ranks started by ``launch/mesh.py::spawn_world`` (rank 0
prints); on the card the world is one rank per card present, a
``(cards, 1)`` mesh under NCCL.  Each round's ``gather_q`` exchange is
kernel B's channel form with its wire, all-gathered over ``data``.  Each
rank holds its block of the params (``param_blocks``: Megatron tensor
parallelism over ``model``) and its groups' rows of the batch, and trains
on them.

  PYTHONPATH=src python examples/torch_multipod_fed_round.py [--device cpu]
"""
import argparse
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import get_smoke_config
from repro_torch.core.fed_step import (FedConfig, fed_wire_bytes,
                                       make_fed_train_step)
from repro_torch.launch.mesh import init_world, make_host_mesh, spawn_world
from repro_torch.models import transformer as T
from repro_torch.sharding.rules import (Rules, axis_index, param_blocks,
                                        use_rules)
from repro_torch.utils.tree import resolve_device

CPU_MESH = (4, 2)


def rank_main(device: torch.device) -> None:
    if device.type == "cpu":    # 8 ranks share the host's cores
        torch.set_num_threads(1)
    init_world("gloo" if device.type == "cpu" else None)
    world = dist.get_world_size()
    shape = CPU_MESH if device.type == "cpu" else (world, 1)
    mesh = make_host_mesh(*shape)
    rules = Rules(mesh)
    cfg = get_smoke_config("smollm-135m")
    params = T.init_model(cfg, torch.Generator().manual_seed(0), device)
    fed = FedConfig(n_groups=4, local_steps=2, lr=1e-2, schedule="gather_q",
                    p_s=0.25, p_q=8)
    step = make_fed_train_step(lambda p, b: T.lm_loss(p, b, cfg)[0], fed)

    rng = np.random.RandomState(0)
    batch = {"tokens": torch.from_numpy(rng.randint(
        0, cfg.vocab, (16, 64)).astype(np.int32)).to(device)}
    # groups at different staleness, as the async cache would present them
    stale = torch.tensor([0, 1, 0, 3], dtype=torch.int32, device=device)
    say = print if dist.get_rank() == 0 else (lambda *a, **k: None)

    wire = fed_wire_bytes(params, fed, 4)
    say(f"[wire] per-round exchange: dense f32 {wire['dense_f32']/1e6:.1f}MB "
        f"-> int8 {wire['dense_quant']/1e6:.1f}MB "
        f"-> packed sparse {wire['packed_sparse_quant']/1e6:.1f}MB "
        f"({wire['compression_x']:.1f}x)")
    params = param_blocks(params, rules)
    d, n_data = axis_index(mesh, "data")
    rows = batch["tokens"].shape[0] // n_data
    batch = {"tokens": batch["tokens"][d * rows:(d + 1) * rows]}
    with use_rules(rules):
        for i in range(5):
            t0 = time.time()
            params, m = step(params, batch, stale)
            if device.type == "cuda":
                torch.cuda.synchronize()
            say(f"[round {i}] loss={float(m['local_loss']):.4f} "
                f"alpha_t={float(m['alpha_t']):.3f} "
                f"|delta|={float(m['delta_norm']):.3f} "
                f"({time.time()-t0:.2f}s on {world} devices)", flush=True)
    dist.destroy_process_group()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cpu or cuda (default: cuda)")
    ap.add_argument("--rank", action="store_true",
                    help="run as one rank of a world (set by the launcher)")
    args = ap.parse_args()
    device = resolve_device(args.device)
    if args.rank or device.type == "cuda" and "WORLD_SIZE" in os.environ:
        rank_main(device)
    elif device.type == "cpu":
        procs = spawn_world([sys.executable, os.path.abspath(__file__),
                             "--device", "cpu", "--rank"],
                            CPU_MESH[0] * CPU_MESH[1])
        sys.stdout.write(procs[0].stdout)
    elif torch.cuda.device_count() == 1:
        rank_main(device)
    else:
        procs = spawn_world([sys.executable, os.path.abspath(__file__),
                             "--rank"], torch.cuda.device_count())
        sys.stdout.write(procs[0].stdout)


if __name__ == "__main__":
    main()

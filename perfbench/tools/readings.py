"""The readings that the limits of a cell's check are set from, many seeds
in one process (on the card; ``--device cpu`` at the configuration's
``test_model`` sizes for a rehearsal):

    python3 perfbench/tools/readings.py --workload <cell> \\
        --seeds 11 12 13 --sides program tf32_card half_batch

For each seed the reference follows the checked rounds in f32, and each
side named is compared with it as the harness compares the program:

* ``program``: the port's round (the lower readings);
* ``tf32_card``: the reference in the program's place with the card's
  TF32 switched on, the precision below the configuration's (the
  control); ``tf32``: the same with each product's operands rounded to
  TF32 (the control the CPU tests run);
* ``half_batch``: the reference in the program's place with half of each
  microbatch left out, the mean taken over the rest (a fault);
* ``leaf_unmoved``, ``leaf_double``, ``unchanged``: faults planted in the
  port's round.

One JSON line a seed and side; ``--out`` also writes them to a file.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]

from perfbench import use_checkout_caches  # noqa: E402

use_checkout_caches(ROOT)

from perfbench import check, harness  # noqa: E402
from perfbench.runners import fed_round as D  # noqa: E402
from perfbench.feed import RoundFeed, weight_generator  # noqa: E402


def program_side(spec, fault=None):
    import torch
    from perfbench import reference
    model, traffic = spec.config["model"], spec.traffic
    dev = torch.device(spec.device)
    step = D.Program(model, D.round_settings(traffic), fault)
    ref = reference.model(spec.config["reference"])
    params = ref.init_params(model, weight_generator(spec.seed, dev))
    feed = RoundFeed(spec.seed, traffic, model["vocab"], dev)
    params, r = D.program_readings(step, params, feed,
                                   D.CHECKED_ROUNDS,
                                   lambda: D._sync(dev))
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    del params, step, feed
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return r, peak


def leaf_gaps(got, ref):
    """Each leaf's gap of the update and of the change, over the larger of
    its reference norm and the median leaf's, and its reference norms."""
    import numpy as np
    out = {}
    for key in ("update", "change"):
        g, r = getattr(got, key), getattr(ref, key)
        med = float(np.median(r))
        out[key] = {n: abs(a - b) / max(b, med)
                    for n, a, b in zip(ref.names, g, r)}
    out["ref_update_norm"] = dict(zip(ref.names, ref.update))
    out["grad_norm"] = dict(zip(ref.names, ref.grad_norms))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--sides", nargs="+", default=["program"])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=0)
    ap.add_argument("--seq", type=int, default=0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bench = harness.load_benchmark()
    cell, traffic, config = harness.resolve(bench, args.workload)
    if args.device != "cuda":
        config = dict(config, model=config["test_model"])
    traffic = dict(traffic, batch=args.batch or traffic["batch"],
                   seq=args.seq or traffic["seq"])
    out = open(args.out, "a") if args.out else None
    for seed in args.seeds:
        spec = harness.Spec(args.workload, seed, 0.0, False, args.device,
                            cell, traffic, config, 0.0,
                            harness.make_log(time.perf_counter()))
        t = time.perf_counter()
        ref = D.reference_readings(spec, D.CHECKED_ROUNDS)
        ref_s = time.perf_counter() - t
        for side in args.sides:
            t = time.perf_counter()
            peak = 0
            if side in ("tf32", "tf32_card", "half_batch"):
                got = D.reference_readings(
                    spec, D.CHECKED_ROUNDS,
                    mode=side if side != "half_batch" else "f32",
                    fault="half_batch" if side == "half_batch" else None)
            else:
                got, peak = program_side(
                    spec, None if side == "program" else side)
            found = check.gaps(got, ref)
            line = {"workload": args.workload, "seed": seed, "side": side,
                    **{k: v["value"] for k, v in found.items()},
                    "at": {k: v["at"] for k, v in found.items()},
                    "losses": got.losses, "ref_losses": ref.losses,
                    "leaves": leaf_gaps(got, ref),
                    "excluded": check.excluded(ref),
                    "side_s": time.perf_counter() - t, "ref_s": ref_s,
                    "peak_bytes": peak}
            print(json.dumps(line), flush=True)
            if out:
                out.write(json.dumps(line) + "\n")
                out.flush()


if __name__ == "__main__":
    main()

"""Find a cell's batch on the card: step the batch up by ``--step``
sequences and run ``--rounds`` rounds of the port's fed round at each,
until ``torch.cuda.max_memory_allocated`` passes ``--share`` of the card
or the card runs out.  Prints one JSON line a batch (peak bytes, seconds
a round) and the largest batch under the share.

    python3 perfbench/tools/size.py --workload <cell> --batches 4 8 12 16
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]

from perfbench import harness, reference  # noqa: E402
from perfbench.runners import fed_round as D  # noqa: E402
from perfbench.feed import RoundFeed, weight_generator  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--batches", type=int, nargs="+", required=True)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--share", type=float, default=0.9)
    ap.add_argument("--seq", type=int, default=0)
    ap.add_argument("--loss", default=None,
                    help="lm_loss's keyword arguments as JSON (default: "
                         "the cell's)")
    args = ap.parse_args(argv)
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    total = torch.cuda.get_device_properties(dev).total_memory
    bench = harness.load_benchmark()
    cell, traffic, config = harness.resolve(bench, args.workload)
    model = config["model"]
    ref = reference.model(config["reference"])
    best = None
    for batch in args.batches:
        t = dict(traffic, batch=batch, seq=args.seq or traffic["seq"])
        if args.loss is not None:
            t["loss"] = json.loads(args.loss)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        line = {"workload": args.workload, "batch": batch, "seq": t["seq"],
                "loss": t.get("loss", {}),
                "card": torch.cuda.get_device_name(dev),
                "total_bytes": total}
        try:
            step = D.Program(model, D.round_settings(t))
            params = ref.init_params(model, weight_generator(1, dev))
            feed = RoundFeed(1, t, model["vocab"], dev)
            times = []
            for _ in range(args.rounds):
                tokens, stale = feed.next()
                t0 = time.perf_counter()
                params, m = step(params, tokens, stale)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            line.update(peak_bytes=torch.cuda.max_memory_allocated(dev),
                        round_s=times, loss=float(m["local_loss"]))
            del params, step, feed, m, tokens, stale
        except torch.cuda.OutOfMemoryError as e:
            line.update(oom=str(e).splitlines()[0])
        torch.cuda.empty_cache()
        print(json.dumps(line), flush=True)
        if "oom" in line or line["peak_bytes"] > args.share * total:
            break
        best = batch
    print(json.dumps({"workload": args.workload, "largest_batch": best}))


if __name__ == "__main__":
    main()

"""End-to-end example on the PyTorch port: the paper's full experiment at
laptop scale.  The twin of ``examples/fl_end_to_end.py``, with every flag
of it and ``--device`` (the card unless ``--device cpu``).

Trains the selected model family (``--task``: the Fashion-MNIST CNN by
default, or any other entry in ``repro_torch.fl.tasks.TASKS`` such as
``transformer_lm`` / ``fmnist_mlp``) with all the paper's methods for a few
hundred simulated seconds (several hundred aggregation rounds for the async
methods) and prints the Table-5-style comparison.  Runs on the
strategy-based ``FLEngine`` by default; ``--backend legacy`` selects the
monolithic reference simulator, ``--cohort 32`` enables vectorized
cohort training, ``--scheduler batched`` swaps in the array-backed
batched event scheduler (bit-identical histories), and ``--handler-mode
wave`` adds the vectorized per-wave handlers on top of it (documented
relaxed parity, built for 10^6-device fleets).

``--codec-policy tier_aware`` demos the adaptive per-device codec layer: a
heterogeneous 3-tier fleet where the per-tier Alg. 5 search gives each
bandwidth tier its own (p_s, p_q) operating point.

``--fleet`` switches to the multi-task fleet demo
(``repro_torch.fl.fleet.MultiTaskEngine``): four model families — the FMNIST
CNN, the transformer LM, the MoE LM and the SSM LM — train as concurrent
FL jobs over ONE shared device fleet and one event loop, each job with
its own protocol, admission gate, codec and byte meters; ``--assigner``
picks the device->job routing rule from ``ASSIGNERS``.

  PYTHONPATH=src python examples/torch_fl_end_to_end.py [--budget 120] [--noniid]
  PYTHONPATH=src python examples/torch_fl_end_to_end.py --task transformer_lm
  PYTHONPATH=src python examples/torch_fl_end_to_end.py --codec-policy tier_aware
  PYTHONPATH=src python examples/torch_fl_end_to_end.py --fleet --budget 4 --assigner adaptive
"""
import argparse
import time

from repro_torch.core.codecs import CODECS
from repro_torch.core.dynamic import make_schedule
from repro_torch.core.server import SERVERS
from repro_torch.fl.fleet import ASSIGNERS, FleetConfig, build_fleet
from repro_torch.fl.policies import POLICIES
from repro_torch.fl.protocols import (make_setup, profile_compression,
                                      run_method)
from repro_torch.fl.simulator import ScenarioConfig, SimConfig, TierSpec
from repro_torch.fl.tasks import TASKS
from repro_torch.utils.tree import resolve_device


def run_fleet_demo(args) -> None:
    """Four heterogeneous FL jobs co-training on one shared fleet."""
    specs = [
        SimConfig(method="teasq", task="fmnist_cnn", epochs=1,
                  p_s=0.25, p_q=8),
        SimConfig(method="teastatic", task="transformer_lm", epochs=1,
                  p_s=0.25, p_q=8),
        SimConfig(method="fedasync", task="moe_lm", epochs=1),
        SimConfig(method="teasq", task="ssm_lm", epochs=1,
                  p_s=0.25, p_q=8),
    ]
    cfg = FleetConfig(tasks=specs, n_devices=args.devices,
                      scheduler=args.scheduler, assigner=args.assigner,
                      handler_mode=args.handler_mode)
    fleet = build_fleet(cfg, iid=not args.noniid,
                        n_train=args.samples, n_test=args.samples // 5,
                        device=resolve_device(args.device))
    t0 = time.time()
    hists = fleet.run(time_budget=args.budget, eval_every=4)
    wall = time.time() - t0
    print(f"\n{args.assigner} assigner, {args.devices} shared devices, "
          f"{args.budget:.0f}s virtual budget, wall={wall:.0f}s")
    print("job             method     rounds  best_acc  upload_MB  grants")
    for spec, rt, hist in zip(specs, fleet.runtimes, hists):
        best = max(h.accuracy for h in hist)
        print(f"{spec.task:15s} {spec.method:10s} {hist[-1].round:5d}   "
              f"{best:.3f}   {hist[-1].bytes_up / 1e6:8.1f}  "
              f"{rt.stats.dispatches:6d}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--budget", type=float, default=120.0,
                    help="simulated seconds")
    ap.add_argument("--devices", type=int, default=40)
    ap.add_argument("--samples", type=int, default=12000)
    ap.add_argument("--noniid", action="store_true")
    ap.add_argument("--backend", choices=("engine", "legacy"),
                    default="engine",
                    help="strategy-based engine (default) or legacy sim")
    ap.add_argument("--cohort", type=int, default=0,
                    help="engine cohort size (>0 = vectorized local "
                         "training for the async methods)")
    ap.add_argument("--scheduler", choices=("heap", "batched"),
                    default="heap",
                    help="engine event loop (SimConfig.scheduler): the "
                         "reference one-event-at-a-time heap, or the "
                         "array-backed batched scheduler — bit-identical "
                         "histories, built for 10^4-10^5-device fleets "
                         "(default: %(default)s)")
    ap.add_argument("--handler-mode", choices=("serial", "wave"),
                    default="serial",
                    help="batched-scheduler event handlers "
                         "(SimConfig.handler_mode): 'serial' replays the "
                         "heap loop event-by-event (bit-identical, pinned); "
                         "'wave' dispatches each selected batch as arrays — "
                         "documented relaxed parity, built for 10^6-device "
                         "fleets; requires --scheduler batched "
                         "(default: %(default)s)")
    ap.add_argument("--server", choices=sorted(SERVERS), default="single",
                    help="engine aggregation backend (SimConfig.server, "
                         "repro_torch.core.server.SERVERS): 'single' is "
                         "the paper's one-host TeasqServer; 'sharded' runs "
                         "the stacked Eqs. 6-10 cache reduction over the "
                         "shards of the torch.distributed world (a world "
                         "of 1 here) (default: %(default)s)")
    ap.add_argument("--task", choices=sorted(TASKS), default="fmnist_cnn",
                    help="model family to train "
                         "(repro_torch.fl.tasks.TASKS): the paper's FMNIST "
                         "CNN, a tiny transformer LM on a synthetic token "
                         "stream, or the FMNIST MLP — every "
                         "task runs under every protocol (default: "
                         "%(default)s)")
    ap.add_argument("--codec", choices=sorted(CODECS), default="dense",
                    help="wire codec for the compressed methods: TEASQ "
                         "defaults to 'dense' (the Algs. 3-4 reference codec "
                         "priced as the packed stream); 'packed' transmits "
                         "the real bit-packed bytes (bit-identical result), "
                         "'threshold' the approximate in-graph channel, "
                         "'identity' disables compression (default: "
                         "%(default)s)")
    ap.add_argument("--codec-policy", choices=sorted(POLICIES),
                    default="static",
                    help="per-device codec policy (SimConfig.codec_policy, "
                         "repro_torch.fl.policies.POLICIES): 'static' keeps "
                         "each protocol's global Alg. 5 operating point; "
                         "'tier_aware' installs a heterogeneous 3-tier "
                         "fleet and runs the per-tier Alg. 5 search so "
                         "slow-bandwidth tiers ship aggressively packed "
                         "updates while full-rate tiers stay near-dense; "
                         "'staleness_aware' adds compression notches for "
                         "chronically stale devices (default: %(default)s)")
    ap.add_argument("--fleet", action="store_true",
                    help="multi-task fleet demo (repro_torch.fl.fleet): four "
                         "model families co-train as concurrent FL jobs "
                         "over one shared device fleet and one event loop "
                         "instead of the single-job method comparison")
    ap.add_argument("--assigner", choices=sorted(ASSIGNERS),
                    default="adaptive",
                    help="fleet device->job routing rule "
                         "(repro_torch.fl.fleet.ASSIGNERS); only used with "
                         "--fleet (default: %(default)s)")
    ap.add_argument("--device", default=None,
                    help="cpu or cuda (default: cuda)")
    args = ap.parse_args()
    device = resolve_device(args.device)

    if args.fleet:
        run_fleet_demo(args)
        return

    iid = not args.noniid
    data, parts, w0 = make_setup(n_devices=args.devices, iid=iid,
                                 n_train=args.samples,
                                 n_test=args.samples // 5, task=args.task,
                                 device=device)
    si, qi, trace = profile_compression(w0, data, theta=0.03, task=args.task)
    sched = make_schedule(si, qi, total_rounds=80)
    print(f"[alg5] searched static point: p_s={trace[-1][0] if trace else 1.0}"
          f" (idx {si}), p_q idx {qi}; {len(trace)} profile evals")

    policy_kw = {}
    if args.codec_policy != "static":
        # a demo heterogeneous fleet for the adaptive policies: a quarter of
        # devices at full rate, the rest on progressively slower links
        tiers = [TierSpec(0.25, 1.0, 1.0, "fast"),
                 TierSpec(0.375, 1.5, 0.5, "mid"),
                 TierSpec(0.375, 2.5, 0.125, "slow")]
        policy_kw = dict(codec_policy=args.codec_policy,
                         scenario=ScenarioConfig(tiers=tiers))
        if args.codec_policy == "tier_aware":
            tier_points, _ = profile_compression(w0, data, theta=0.03,
                                                 task=args.task, tiers=tiers)
            policy_kw["tier_points"] = tier_points
            print(f"[alg5] per-tier points "
                  f"{[t.name for t in tiers]}: {tier_points}")

    rows = []
    for method, kw in [("fedavg", {}),
                       ("fedasync", {}),
                       ("tea", {}),
                       ("teastatic", dict(p_s=0.25, p_q=8)),
                       ("teasq", dict(p_s=0.25, p_q=8, schedule=sched))]:
        t0 = time.time()
        hist = run_method(method, data, parts, w0, iid=iid,
                          time_budget=args.budget, epochs=1, eval_every=4,
                          backend=args.backend, cohort_size=args.cohort,
                          scheduler=args.scheduler,
                          handler_mode=args.handler_mode,
                          server=args.server,
                          codec=args.codec, task=args.task, device=device,
                          **policy_kw, **kw)
        best = max(h.accuracy for h in hist)
        rows.append((method, hist[-1].round, best,
                     hist[-1].bytes_up / 1e6, time.time() - t0))
        print(f"[{method:10s}] rounds={rows[-1][1]:4d} best_acc={best:.3f} "
              f"up={rows[-1][3]:.1f}MB wall={rows[-1][4]:.0f}s", flush=True)

    print("\nmethod      rounds  best_acc  upload_MB")
    for m, r, a, up, _ in rows:
        print(f"{m:10s}  {r:5d}   {a:.3f}    {up:8.1f}")


if __name__ == "__main__":
    main()

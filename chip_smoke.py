#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) once on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; the script exits nonzero if any of them fails:

1. Device and build: the card's name and power limit, the build of the
   CUDA kernels from ``src/repro_torch/kernels/csrc``, TF32 off.
2. Kernel A (``fused_pack``) against its plain PyTorch version on the card,
   over the Alg. 5 candidate grid: byte-identical streams, equal to the
   host pipeline, of the size the size model gives, decoding like the
   reference codec.
3. Kernel B (``topk_quant``) against its plain version: identical levels
   and scales at blocks of 4,096 and 16,384, f32 and bf16, 8 and 4 bits.
4. The main path at full width: TEASQ-Fed on the paper's CNN with 100
   devices and 60,000/10,000 synthetic samples, through ``make_sim(...).run``
   for 5 aggregation rounds, then the packed wire encode and the block
   channel of the trained global model, with every launch counter set to 0
   before and read after.
5. The card against the CPU: one small run (8 devices, 640 samples) on
   ``cuda`` and on ``cpu`` from the same weights; the time, round and byte
   columns of the two histories must be equal.
6. Kernel times against their plain versions and bounds, then one JSON
   line of kernels, the card's ``nvidia-smi`` line, and the last line
   ``{"ok": true, "device": {...}}``.

It needs one card, imports nothing of JAX, and runs from the root of a
checkout.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
PEAK_BYTES_PER_S = 3.35e12        # H100 SXM HBM3
PEAK_F32_OPS_PER_S = 67e12        # H100 SXM, f32 outside the tensor cores
ACC_TOL = 0.05                    # card vs CPU accuracy, absolute, per entry


def die(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(1)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else \
        "nvidia-smi: " + out.stderr.strip()


def time_cuda(fn, iters: int = 50, warmup: int = 3) -> float:
    """Milliseconds per call of ``fn`` on the card, from CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


class Smoke:
    """The phases, on ``dev`` with the main path at ``n_devices`` devices
    and ``n_train``/``n_test`` samples (the paper's fleet by default; a CPU
    rehearsal passes the CPU and a smaller fleet)."""

    def __init__(self, dev="cuda", n_devices=100, n_train=60000,
                 n_test=10000):
        import numpy as np
        import torch
        self.np, self.torch = np, torch
        self.failures = []
        self.kernels = {"fused_pack": {}, "topk_quant": {}}
        self.dev = torch.device(dev)
        self.fleet = (n_devices, n_train, n_test)

    def sync(self):
        if self.dev.type == "cuda":
            self.torch.cuda.synchronize()

    def phase(self, name, fn):
        t0 = time.perf_counter()
        print(f"== {name}", flush=True)
        try:
            fn()
        except Exception:                    # reported, and fails the run
            traceback.print_exc()
            self.failures.append(name)
        print(f"   ({time.perf_counter() - t0:.1f} s)", flush=True)

    def expect(self, cond: bool, what: str) -> None:
        if not cond:
            raise AssertionError(what)

    # -- inputs -----------------------------------------------------------
    def cnn_like(self, seed: int):
        """The CNN's 8 leaves (its shapes, seeded normal values)."""
        from repro_torch.models.cnn import init_cnn
        np, torch = self.np, self.torch
        rng = np.random.RandomState(seed)
        shapes = {k: tuple(v.shape) for k, v in
                  init_cnn(torch.Generator().manual_seed(0)).items()}
        return {k: torch.from_numpy(
            (rng.randn(*s) * 0.1).astype(np.float32)).to(self.dev)
            for k, s in shapes.items()}

    # -- phase 1 ------------------------------------------------------------
    def device_and_build(self):
        torch = self.torch
        from repro_torch.kernels import build
        print(f"   card: {nvidia_smi()}")
        print(f"   torch {torch.__version__}, CUDA {torch.version.cuda}, "
              f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
        t0 = time.perf_counter()
        build.library()
        print(f"   kernels built (nvcc, sm_90a) and loaded in "
              f"{time.perf_counter() - t0:.2f} s")
        for line in build.build_log().splitlines():
            if "registers" in line or "spill" in line:
                print("   ptxas:", line.strip())
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        print(f"   cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
              f"cuda.matmul.allow_tf32="
              f"{torch.backends.cuda.matmul.allow_tf32}")

    # -- phase 2 ------------------------------------------------------------
    def kernel_a(self):
        np, torch = self.np, self.torch
        from repro_torch.core.codecs import DenseRefCodec, PackedBitstreamCodec
        from repro_torch.core.compression import expected_pytree_wire_bytes
        from repro_torch.core.dynamic import DEFAULT_SET_Q, DEFAULT_SET_S
        from repro_torch.kernels.fused_pack import (fused_pack_plain,
                                                    stream_layout,
                                                    words_to_stream)
        tree = self.cnn_like(1)
        rng = np.random.RandomState(2)
        tree["zz_ties"] = torch.from_numpy(rng.choice(
            np.float32([0.5, -0.5, 0.25, -0.25, 0.0]), 3001)).to(self.dev)
        tree["zz_ragged"] = torch.from_numpy(
            rng.randn(1001).astype(np.float32)).to(self.dev)
        names = sorted(tree)
        points, max_err = 0, 0.0
        for p_s in DEFAULT_SET_S:
            for p_q in DEFAULT_SET_Q:
                if (p_s, p_q) == (1.0, 32):
                    continue
                codec = PackedBitstreamCodec(p_s, p_q)
                wire = codec.encode(tree)                     # the kernel
                xs = [tree[k] for k in names]
                _, total = stream_layout([x.numel() for x in xs], p_s, p_q)
                plain = words_to_stream(fused_pack_plain(xs, p_s, p_q), total)
                host = PackedBitstreamCodec(p_s, p_q, fused=False).encode(tree)
                where = f"(p_s={p_s}, p_q={p_q})"
                self.expect(wire.payload == plain,
                            f"kernel A != plain {where}")
                self.expect(wire.payload == host.payload,
                            f"kernel A != host pipeline {where}")
                self.expect(len(wire.payload) == expected_pytree_wire_bytes(
                    tree, p_s, p_q), f"kernel A size {where}")
                got = codec.decode(wire)
                ref = DenseRefCodec(p_s, p_q).roundtrip(tree)[0]
                for k in names:
                    self.expect(torch.equal(got[k], ref[k]),
                                f"kernel A decode of {k} {where}")
                dec_plain = codec.decode(dataclasses.replace(wire,
                                                             payload=plain))
                max_err = max(max_err, max(
                    float((got[k] - dec_plain[k]).abs().max()) for k in names))
                points += 1
        print(f"   {points} (p_s, p_q) points x {len(names)} leaves: streams "
              f"byte-identical to the plain version and the host pipeline, "
              f"sizes exact, decodes equal to DenseRefCodec (tolerance: "
              f"exact)")
        self.kernels["fused_pack"].update(max_abs_err=max_err,
                                          checked_points=points)

    # -- phase 3 ------------------------------------------------------------
    def kernel_b(self):
        np, torch = self.np, self.torch
        from repro_torch.kernels.topk_quant import (_pad_rows, dequant,
                                                    topk_quant,
                                                    topk_quant_plain)
        rng = np.random.RandomState(3)
        flat = torch.from_numpy(
            (rng.randn(206410) * 0.1).astype(np.float32)).to(self.dev)
        cases, max_err = 0, 0.0
        for block in (4096, 16384):
            for dtype in (torch.float32, torch.bfloat16):
                for bits in (8, 4):
                    x = flat.to(dtype)
                    lv, sc = topk_quant(x, p_s=0.25, bits=bits, block=block)
                    lp, sp = topk_quant_plain(_pad_rows(x, block), 0.25, bits)
                    where = f"(block={block}, {dtype}, bits={bits})"
                    self.expect(torch.equal(lv, lp), f"levels {where}")
                    self.expect(torch.equal(sc, sp), f"scales {where}")
                    n = x.numel()
                    err = (dequant(lv, sc, bits, n, (n,))
                           - dequant(lp, sp, bits, n, (n,))).abs().max()
                    max_err = max(max_err, float(err))
                    cases += 1
        print(f"   {cases} cases: levels and scales identical to the plain "
              f"version (tolerance: exact)")
        self.kernels["topk_quant"].update(max_abs_err=max_err,
                                          checked_cases=cases)

    # -- phase 4 ------------------------------------------------------------
    def main_path(self):
        np, torch = self.np, self.torch
        from repro_torch.core.codecs import DenseRefCodec, PackedBitstreamCodec
        from repro_torch.fl.protocols import make_setup, make_sim
        from repro_torch.fl.simulator import SimConfig
        from repro_torch.kernels import fused_pack, ops, topk_quant
        n_dev, n_train, n_test = self.fleet
        t0 = time.perf_counter()
        data, parts, w0 = make_setup(n_devices=n_dev, iid=True, seed=0,
                                     n_train=n_train, n_test=n_test,
                                     device=self.dev)
        print(f"   setup: {n_dev} devices, {n_train}/{n_test} samples, "
              f"{sum(v.numel() for v in w0.values())} params "
              f"({time.perf_counter() - t0:.1f} s)")
        # run_method's arguments, on the paper's SimConfig defaults
        cfg = SimConfig(method="teasq", n_devices=n_dev, c_fraction=0.1,
                        mu=0.01, alpha=0.6, p_s=0.25, p_q=8, seed=0,
                        codec="packed")
        sim = make_sim(data, parts, w0, cfg, device=self.dev)
        fused_pack.LAUNCHES = 0
        topk_quant.LAUNCHES = 0
        t0 = time.perf_counter()
        hist = sim.run(time_budget=1e9, max_rounds=5)
        self.sync()
        wall = time.perf_counter() - t0
        w = sim.server.w
        wire = PackedBitstreamCodec(0.25, 8).encode(w)
        channel = {k: ops.compress_roundtrip(v) for k, v in w.items()}
        self.sync()
        launches = {"fused_pack": fused_pack.LAUNCHES,
                    "topk_quant": topk_quant.LAUNCHES}
        rounds = hist[-1].round
        print(f"   rounds: {rounds}, dispatches {sim.stats.dispatches}, "
              f"completions {sim.stats.completions}")
        print("   accuracy curve: " + ", ".join(
            f"r{e.round}@{e.time:.3f}s={e.accuracy:.4f}" for e in hist))
        print(f"   metered bytes: up {sim.channel.bytes_up}, down "
              f"{sim.channel.bytes_down}, max up {sim.channel.max_up}, "
              f"max down {sim.channel.max_down}")
        print(f"   wall: {wall:.2f} s, {wall / max(rounds, 1):.3f} s per "
              f"round")
        print(f"   launches on the main path: {launches}")
        self.expect(rounds >= 5, f"only {rounds} aggregation rounds")
        self.expect(all(math.isfinite(e.accuracy) and 0 <= e.accuracy <= 1
                        for e in hist), "accuracy not finite in [0, 1]")
        self.expect(all(bool(torch.isfinite(v).all()) for v in w.values()),
                    "trained weights not finite")
        self.expect(all(n > 0 for n in launches.values()),
                    f"a kernel did not run on the main path: {launches}")
        # what the kernels produced on the trained model, checked on the host
        host = PackedBitstreamCodec(0.25, 8, fused=False).encode(w)
        self.expect(wire.payload == host.payload,
                    "trained-model stream != host pipeline")
        ref = DenseRefCodec(0.25, 8).roundtrip(w)[0]
        dec = PackedBitstreamCodec(0.25, 8).decode(wire)
        self.expect(all(torch.equal(dec[k], ref[k]) for k in w),
                    "trained-model decode != DenseRefCodec")
        for k, v in w.items():
            lp, sp = topk_quant.topk_quant_plain(
                topk_quant._pad_rows(v, topk_quant.DEFAULT_BLOCK))
            plain = topk_quant.dequant(lp, sp, 8, v.numel(), v.shape)
            self.expect(torch.equal(channel[k], plain),
                        f"compress_roundtrip of {k} != plain version")
            self.expect(bool(torch.isfinite(channel[k]).all()),
                        f"compress_roundtrip of {k} not finite")
        print("   trained model: kernel A's stream equals the host pipeline "
              "and decodes like DenseRefCodec; kernel B's channel equals its "
              "plain version on every leaf (tolerance: exact)")
        for name, n in launches.items():
            self.kernels[name]["launches"] = n
        self.trained = w

    # -- phase 5 ------------------------------------------------------------
    def card_vs_cpu(self):
        from repro_torch.fl.protocols import make_setup, run_method
        from repro_torch.utils.tree import to_numpy
        data, parts, w0 = make_setup(n_devices=8, iid=True, seed=3,
                                     n_train=640, n_test=320, device="cpu")
        w_np = to_numpy(w0)
        kw = dict(time_budget=4.0, epochs=1, seed=3, p_s=0.25, p_q=8,
                  codec="packed")
        hists = {}
        for dev in (self.dev.type, "cpu"):
            _, _, w = make_setup(n_devices=8, iid=True, seed=3, n_train=640,
                                 n_test=320, device=dev, init_params=w_np)
            hists[dev] = run_method("teasq", data, parts, w, device=dev,
                                    **kw)
        hc, hp = hists[self.dev.type], hists["cpu"]
        self.expect(len(hc) == len(hp), f"{len(hc)} vs {len(hp)} entries")
        cols = ("time", "round", "bytes_up", "bytes_down",
                "max_model_bytes_up", "max_model_bytes_down")
        for a, b in zip(hc, hp):
            for c in cols:
                self.expect(getattr(a, c) == getattr(b, c),
                            f"{c}: {getattr(a, c)} vs {getattr(b, c)}")
        d = max(abs(a.accuracy - b.accuracy) for a, b in zip(hc, hp))
        self.expect(d <= ACC_TOL, f"accuracy differs by {d} > {ACC_TOL}")
        print(f"   {len(hc)} entries, {hc[-1].round} rounds: time, round "
              f"and byte columns equal; max |accuracy diff| {d:.4f} "
              f"(tolerance {ACC_TOL})")

    # -- phase 6 ------------------------------------------------------------
    def timings(self):
        np, torch = self.np, self.torch
        from repro_torch.core.compression import topk_count
        from repro_torch.kernels import build
        from repro_torch.kernels.fused_pack import (fused_pack_plain,
                                                    stream_layout)
        from repro_torch.kernels.topk_quant import (DEFAULT_BLOCK, _pad_rows,
                                                    topk_quant_plain)
        from repro_torch.core.compression import index_bits
        lib = build.library()
        w = self.trained
        xs = [w[k].contiguous() for k in sorted(w)]
        sizes = [x.numel() for x in xs]
        n = sum(sizes)
        # kernel A at the main path's point (0.25, 8)
        offs, total = stream_layout(sizes, 0.25, 8)
        meta = torch.tensor([[x.data_ptr(), m, topk_count(m, 0.25), o,
                              index_bits(m)]
                             for x, m, o in zip(xs, sizes, offs)],
                            dtype=torch.int64).cuda()
        words = torch.zeros((total + 31) // 32 + 1, dtype=torch.int32,
                            device=self.dev)
        stream = torch.cuda.current_stream().cuda_stream

        def run_a():   # ORs into the same words again: same work, same time
            build.check(lib.fused_pack_launch(meta.data_ptr(), len(xs),
                                              words.data_ptr(), 8, stream),
                        "fused_pack")

        ms_a = time_cuda(run_a)
        plain_a = time_cuda(lambda: fused_pack_plain(xs, 0.25, 8), iters=10)
        bytes_a = 4 * n + (total + 7) // 8
        ops_a = 33 * n + 4 * sum(topk_count(m, 0.25) for m in sizes)
        # kernel B as the main path calls it: one launch per leaf
        rows = [_pad_rows(x, DEFAULT_BLOCK) for x in xs]
        outs = [(torch.empty(r.shape, dtype=torch.int8, device=self.dev),
                 torch.empty((r.shape[0], 1), dtype=torch.float32,
                             device=self.dev)) for r in rows]

        def run_b():
            for r, (lv, sc) in zip(rows, outs):
                build.check(lib.topk_quant_launch(
                    r.data_ptr(), 0, r.shape[0], r.shape[1], 0.25, 8, 16,
                    lv.data_ptr(), sc.data_ptr(), stream), "topk_quant")

        ms_b = time_cuda(run_b)
        plain_b = time_cuda(lambda: [topk_quant_plain(r, 0.25, 8)
                                     for r in rows], iters=10)
        n_pad = sum(r.numel() for r in rows)
        m_rows = sum(r.shape[0] for r in rows)
        bytes_b = 4 * n_pad + n_pad + 4 * m_rows
        ops_b = (16 + 5) * n_pad
        for name, ms, plain, nbytes, nops, src, repl in (
                ("fused_pack", ms_a, plain_a, bytes_a, ops_a,
                 "src/repro_torch/kernels/csrc/fused_pack.cu",
                 "src/repro/kernels/fused_pack.py:158"),
                ("topk_quant", ms_b, plain_b, bytes_b, ops_b,
                 "src/repro_torch/kernels/csrc/topk_quant.cu",
                 "src/repro/kernels/topk_quant.py:75")):
            t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
            t_ops = nops / PEAK_F32_OPS_PER_S * 1e3
            self.kernels[name].update({
                "name": name, "route": "cuda", "source": src,
                "replaces": repl, "ms": ms, "plain_ms": plain,
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": None, "bytes": nbytes, "operations": nops})
            print(f"   {name}: {ms * 1e3:.1f} us kernel, {plain * 1e3:.1f} us "
                  f"plain, bound {max(t_bytes, t_ops) * 1e3:.3f} us "
                  f"({nbytes} bytes, {nops} ops)")
        print("   fused_pack times one launch for the whole CNN dict at "
              "(0.25, 8); topk_quant "
              "the 8 per-leaf launches of compress_roundtrip at block "
              f"{DEFAULT_BLOCK}. No single PyTorch call computes either "
              "function: library_ms is null.")


def main() -> int:
    try:
        import torch
    except ImportError:
        die("PyTorch is not installed")
    if not torch.cuda.is_available():
        die("no CUDA device is available: this script runs on the card")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    try:
        import repro_torch  # noqa: F401
    except ImportError:
        die("src/repro_torch not found: run from the root of a checkout")

    s = Smoke()
    t0 = time.perf_counter()
    s.phase("1. device and build", s.device_and_build)
    if s.failures:
        die("the kernels did not build")
    s.phase("2. kernel A (fused_pack) against its plain version",
            s.kernel_a)
    s.phase("3. kernel B (topk_quant) against its plain version",
            s.kernel_b)
    s.phase("4. main path: TEASQ on the paper's CNN, 100 devices, on cuda",
            s.main_path)
    s.phase("5. the card against the CPU", s.card_vs_cpu)
    if "4. main path: TEASQ on the paper's CNN, 100 devices, on cuda" \
            not in s.failures:
        s.phase("6. kernel times", s.timings)
    print(f"total {time.perf_counter() - t0:.1f} s")
    if s.failures:
        die("failed phases: " + "; ".join(s.failures))
    print(json.dumps({"kernels": [s.kernels["fused_pack"],
                                  s.kernels["topk_quant"]]}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

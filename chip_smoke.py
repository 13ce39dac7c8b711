#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) once on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; the script exits nonzero if any of them fails:

1. Device and build: the card's name and power limit, the build of the
   CUDA kernels from ``src/repro_torch/kernels/csrc``, TF32 off.
2. Kernel A (``fused_pack``) against its plain PyTorch version on the card,
   over the Alg. 5 candidate grid, with four leaves large enough to be
   spread over a cluster (one ragged, one with ties at T in every slice,
   one whose slices are too long for shared memory and are read from
   device memory on every pass):
   byte-identical streams, equal to the host pipeline, of the size the
   size model gives, decoding like the reference codec.
3. Kernel B (``topk_quant``) against its plain version: identical levels
   and scales at blocks of 1,024 and 4,096 (one CTA a row) and of
   16,384, 32,768, 60,001, 65,536, 200,704 and 400,003 (a cluster a row;
   at 400,003 the slices are read from device memory), f32 and bf16, 8, 4
   and 2 bits, iters 16, 12 and 5, and the CNN's 8 leaves in one launch.
4. The main path at full width: TEASQ-Fed on the paper's CNN with 100
   devices and 60,000/10,000 synthetic samples, through ``make_sim(...).run``
   for 5 aggregation rounds, then the packed wire encode and the block
   channel (``compress_roundtrip_leaves``, one launch of kernel B) of the
   trained global model, with every launch counter set to 0 before and
   read after.
5. The card against the CPU: one small run (8 devices, 640 samples) on
   ``cuda`` and on ``cpu`` from the same weights; the time, round and byte
   columns of the two histories must be equal.
6. Kernel times of A and B against their plain versions and bounds (B
   also from the profiler's device durations, the block channel's wall,
   and fc1 as one row of 200,704).
7. Kernel C (``ssd_scan``) against its plain version: the JAX tests' grid
   (chunk 32/64/128 x N 16/32/128, b and c in f32 and bf16), ragged
   chunk lengths, head counts of 3 and 6, N = 8, and the full-width cell
   of Mamba2-370M (L=256, P=64, N=128, 64 cells); y, S and a, and the
   whole ``ops.ssd`` output and state against the plain ``ssd_chunked``.
8. The SSM serving path at full width: Mamba2-370M (48 layers, d_model
   1024) from seeded random weights, a ``ContinuousBatcher`` with 4 slots
   over 8 requests (prompt 512, gen 16) with every launch counter set to 0
   before and read after, then a solo ``generate`` of each request; the
   batcher's tokens must equal the solo ones (a difference passes only as
   a near tie of the solo logits, top-2 margin below 1e-3).
9. The card against the CPU for SSM serving, at the smoke config from the
   same weights: prefill logits within 1e-4, greedy tokens equal.
10. Kernel C's time at the admission shape against its plain version and
   its bound.
11. Kernel B's channel form (``ops.threshold_channel_leaves``, the cohort
   trainer's threshold channel) against its plain version: bit-identical
   outputs over Set_s x Set_q at iters 12 and 6, the CNN's 8 leaves
   stacked over C = 1, 2, 8, 16, 26, 32 and 64 devices in f32 (26 and 64
   span the wave runs' version counts, 32 their padded cohort), C = 8 in
   bf16, and a
   ragged list with a row of 140,001 tied magnitudes; 2 launches per
   application for the CNN, one per cluster size for the ragged list.
12. The cohort main path at full width: TEASQ on the paper's CNN with 100
   devices, 60,000/10,000 samples, ``cohort_size=8``, ``codec="packed"``
   and the schedule (p_s0_idx 4, p_q0_idx 3, step 2) through
   ``make_sim(...).run(max_rounds=8)``, every launch counter set to 0
   before and read after: kernel B's channel form must have run inside
   the simulated run.  Then one flush of 8 devices timed: training alone
   and the channel alone (host clock, synchronized).
13. The cohort path, card against CPU: 8 devices, 640 samples,
   ``cohort_size=4``, from the same weights.
14. The five other protocols (fedasync, port, asofed, fedavg, moon): each
   on the card at the full fleet for 3 rounds, then card against CPU at 8
   devices from the same weights.
15. Kernel B's channel form timed at the up-channel shape of a full cohort
   of 8 against its plain version and its byte bound.
16. The batched scheduler with serial handlers against the heap, on the
   card: the paper's fleet (100 devices, 60,000/10,000 samples), TEASQ on
   the cohort trainer at ``cohort_size=8``, 3 rounds each; the time, round
   and byte columns equal, accuracy within ``BATCHED_ACC_TOL``.
17. Wave mode at full width in the dispatch regime:
   ``benchmarks/engine_scale.py::scale_config`` at its ``--scheduler
   batched`` settings (100,000 devices on 100,000 samples, one sample each
   so no local step, ``cohort_size=256``, 6 bisection steps, a 200 kHz
   cell) with ``handler_mode="wave"``, run in steps of virtual time: 30 s
   of wall with nothing instrumented, every launch counter set to 0 before
   and read after (kernel B's channel form, ``_zero_step_round``, must
   have run inside ``sim.run``): wall, tasks, ms per task, rounds,
   flushes, B's launches.  Then 15 s with the flushes, the channel, the
   aggregations and the evaluations timed on a host clock synchronized
   around each (their shares of the wall), one step under the profiler
   (the device's busy share), and the inputs of the run's largest channel
   call and largest ``_zero_step_round`` through B's channel form against
   its plain version: bit-identical.
18. Wave mode with local steps: the same config at engine_scale's defaults
   (1,000 devices on 12,000 samples, ``cohort_size=32``; 20 s counted and
   10 s instrumented), the same numbers and the same check (the largest
   channel call is the up-channel of a cohort padded to 32).
19. Wave mode, the card against the CPU: 64 devices with a binding gate
   (``c_fraction=0.1``), cohort 8; the time, round and byte columns and
   ``stats`` equal, accuracy within ``ACC_TOL``.
20. The multi-task fleet at full width, through ``build_fleet`` and
   ``MultiTaskEngine.run(max_rounds=5)``: 100 devices and 60,000/10,000
   samples per job (per-job data seeds), job 0 TEASQ on the CNN with
   ``cohort_size=8``, (0.25, 8) and the packed wire, job 1 fedasync on the
   MLP in dense f32 on the serial trainer; the batched scheduler in wave
   mode with the adaptive assigner.  Every launch counter set to 0 before
   and read after: kernel B's channel form must have run inside
   ``MultiTaskEngine.run``.  Per job: rounds, completions, wall per round;
   for the fleet: ms per task and B's launches.  The run's largest channel
   input (cloned on the device during the run) through B's channel form
   against its plain version: bit-identical.
21. Checkpoint and resume on the card: phase 12's cohort engine on the
   heap, cut at round 4 of 8, and phase 20's fleet, cut at half its
   virtual time; each ``state_dict`` through ``save_blob`` into a
   temporary directory, a fresh instance restored with ``load_state`` and
   run on beside the never-serialized one: the time, round and byte
   columns, ``stats`` and the pending events equal, accuracy within
   ``BATCHED_ACC_TOL``, the largest weight difference printed; and
   ``load_sim_params(path, like, task=j, device="cpu")`` equal to job j's
   weights at the cut, bit for bit.
22. The fleet, the card against the CPU: phase 20's two jobs on 12 devices
   and 640 samples per job, in wave mode; the columns, ``stats`` and
   pending events equal, accuracy within ``ACC_TOL``.
23. Kernel C at the shape Jamba v0.1's prefill gives it (4 x 512 tokens:
   G = 1,024 cells, 128 heads per (batch, chunk), L = 256, P = 64, N =
   16), b and c in f32 and bf16, against its plain version within
   ``SSD_TOL_FULL``; then timed against its plain version and its bound.
24. LM serving at full width: Qwen3-1.7B (28 layers, d_model 2048, 16/8
   heads, qk-norm, tied vocab 151,936) from seeded random weights, the
   same batcher window as phase 8 (8 requests, prompt 512, gen 16, 4
   slots; no kernel of the port on this path, so every counter must stay
   0), solo ``generate`` of each (equal, or a near tie), prefill and
   decode timed with their busy shares; then one 4,096-token prefill (the
   flash branch) against the plain branch within ``FLASH_TOL``.
25. The hybrid at full width: Jamba v0.1 (d_model 4096, 16 experts top-2,
   Mamba N = 16 with 128 heads, vocab 65,536 untied) cut in depth to its
   first group of 8 layers (7 Mamba, 1 attention; 53 GB in f32), after
   the earlier phases' weights are gone: ``generate`` over 4 prompts of
   512 tokens, 16 tokens each, with every launch counter set to 0 before
   and read after (kernel C: 7 launches, one per Mamba layer of the
   prefill); solo ``generate`` of each row (equal, or a near tie); the
   prefill and a decode step timed, their busy shares, peak memory.
26. The card against the CPU for the seven decoder-only families at their
   smoke configs from the same weights: prefill logits within
   ``LOGIT_TOL``, greedy tokens equal, and for the dense and MoE ones the
   batcher's tokens equal to solo ``generate`` on the card.
27. Kernel C's gradient: ``torch.autograd.grad`` through the autograd
   Function (the kernel forward, the plain version's vector-Jacobian
   product backward) against autograd through the plain version, at
   ``ssm_lm``'s local-step shape (40 x 16 tokens: G = 320, 4 heads, L =
   8, P = 16, N = 8) within ``SSD_TOL`` and at Mamba2-370M's admission
   shape within ``SSD_TOL_FULL``; then the gradient of ``ssm_lm``'s whole
   loss, kernel against plain, within ``SSD_TOL``, and how far off it is
   with the kernel's outputs detached (the port before the Function);
   then the forward timed at ``ssm_lm``'s shape against its plain
   version and its bound.
28. The LM FL tasks (``transformer_lm``, ``moe_lm``, ``ssm_lm``) at the
   paper's scale (100 devices, 60,000/10,000 sequences): TEASQ (0.25, 8)
   through ``make_sim(...).run(max_rounds=5)`` on the serial trainer with
   the packed wire and on the cohort trainer at 8, every launch counter
   set to 0 before and read after: kernel B's channel form inside each
   cohort run, kernel C inside both ``ssm_lm`` runs.  Then kernels A and
   B's block form on ``transformer_lm``'s trained nested tree against
   their plain versions: exact.  One local step (loss and gradient of 40
   sequences) of each task timed, with its device busy share.
29. The four-family fleet: ``benchmarks/engine_scale.py::fleet_specs``
   (10,000 devices, cohort 128, one sample a device a job; re-created
   here), the batched scheduler with the weighted assigner in steps of
   virtual time for 40 s of wall, then the adaptive one to the same
   virtual budget; per job completions, rounds, the fleet's wall per
   task of its own and the kernels' launches in its flushes and
   evaluations; the adaptive/weighted ratio of aggregate
   tasks printed (the reference's bar is 1.2), every job at least one
   round.
30. The card against the CPU for the LM tasks: TEASQ serial (packed) and
   cohort 4 at 8 devices; columns equal, accuracy within ``LM_ACC_TOL``.
31. FL -> serve: phase 28's serial ``transformer_lm`` and ``ssm_lm``
   engines through ``save_blob``, then ``serve.main(["--from-sim", ...])``
   (8 requests of 16 tokens, 16 each, 4 slots): the served weights equal
   the engine's, batcher tokens equal solo ``generate`` (or a near tie),
   kernel C launched while serving ``ssm_lm``; a four-family fleet's blob
   with ``--job`` loading each job's own weights.
32. Whisper-tiny at full width and depth (4 + 4 layers, d_model 384,
   ``enc_seq`` 1,500, vocab 51,865): ``generate(frames=)`` of 4 prompts of
   32 tokens, 16 each; the encoder, ``encdec_prefill`` and a decode step
   timed; ``encdec_prefill``'s last logits within ``LOGIT_TOL`` of
   ``forward``'s.
33. InternVL2-2B at full width and depth (24 layers, d_model 2048, 16/8
   heads, vocab 92,553 untied, 7.6 GB in f32): ``prefill`` of 256 patch
   embeddings and 512 tokens, then 16 ``decode_step``s; timed; prefill's
   last logits within ``LOGIT_TOL`` of ``forward``'s.
34. The card against the CPU for Whisper and InternVL2 at their smoke
   configs: ``forward`` and prefill logits within ``LOGIT_TOL``, Whisper's
   greedy tokens equal.
35. Kernel B's channel form at the trainer's rows against its plain
   version: SmolLM-135M's leaves as (4, n) delta rows (seeded numpy; rows
   up to 28,311,552), Mamba2-370M's embedding as (4, 51,486,720), and one
   row of 80,000,000 values (past 2^24 / p_s): equal values; launches, ms
   on the card and the plain version's against the byte bound.
36. The federated round at full width: SmolLM-135M (30 layers, d_model
   576, vocab 49,152, seeded weights) through ``launch/train.py``'s
   ``main`` (``--mode fed``, 4 groups, 2 local steps, batch 16 x 128, 5
   rounds, lr 0.1) with every launch counter set to 0 before and read
   after: kernel B's channel form once per cluster size per round; the
   first round's combine equal to its deltas through the plain version;
   ``local_loss`` falling.  Then one round of each schedule from the same
   weights and batch: gather_f32 and psum within 1e-6, gather_q within its
   compression error of gather_f32 (a_t times the threshold plus a step,
   per leaf); one gather_q round profiled for the channel's share.
37. The federated round at full width: Mamba2-370M (48 layers, d_model
   1024), 4 groups, 1 local step, batch 8 x 256, 3 rounds: kernel C once
   per layer per local step (the groups folded into one launch by its vmap
   rule) and kernel B's channel form every round; the first round's 4
   group gradients with C's outputs through its autograd Function against
   the plain version, each leaf within ``SSD_TOL`` (absolute and
   relative, as phase 27 holds C's gradient).
38. Plain AdamW at full width: Qwen3-1.7B, 5 steps at batch 8 x 128 with
   ``--ckpt``: the loss on the first batch falls, peak memory and ms per
   step printed, no kernel of the port runs, and the checkpoint loads
   back equal.
39. The card against the CPU: SmolLM's smoke config, 3 fed rounds
   (gather_q) and 3 plain steps from the same weights (losses within
   1e-4; the fed params within a step, or a threshold flip on at most
   0.1% of the elements, as the CPU tests hold gather_q); and
   ``run_method("teasq", ..., backend="legacy")`` at 8 devices with
   ``codec="dense"`` and ``"threshold"`` (columns equal, accuracy within
   ``ACC_TOL``; kernel B's launches counted in the threshold run).
40. The sharded server in a world of 1 (``launch.mesh.init_world``: NCCL
   on an in-process store; every phase from 40 destroys its group at its
   end): phase 4's run (TEASQ, 100 devices, 60,000/10,000, 5 rounds) with
   ``server="sharded"`` against ``server="single"`` from the same weights,
   cuDNN deterministic: the time, round and byte columns, the accuracy and
   the weights equal, bit for bit.  Then the flat column-block body on the
   card: ``aggregate_cache_sharded_ref`` at 2 and 4 shards over the
   trained CNN and a cache of 10 updates, within 1 ulp of
   ``aggregate_cache_stacked``.
41. The federated round on a (1, 1) mesh: phase 36's SmolLM-135M round (4
   groups x 2 steps, batch 16 x 128, ``gather_q``) under
   ``use_rules(Rules(make_host_mesh(1, 1)))``, through the mesh branch and
   kernel B's channel form with its wire (launches counted): params equal
   to the no-mesh round's (bit for bit, or within the CPU tests' gather_q
   rule), at p_q 8 and at 4 (the wire's level bytes halved); ms per round
   beside the no-mesh round's.
42. The expert-parallel MoE on Jamba: phase 25's group (4 x 512) prefilled
   under a (1, 1) mesh, so every MoE layer takes the EP route; the first
   MoE layer's output on the prefill's hidden states against the dense
   route, within 1e-4 on every token whose k slots all fit the capacity
   (the dropped slots counted); prefill ms on both routes.
43. The sequence-sharded decode: Qwen3-1.7B (phase 24's weights), 4 rows
   of a 512-token prefill, then 16 greedy steps of
   ``decode_step(seq_shard_kv=True)`` under a (1, 1) mesh against plain
   ``decode_step``: logits within 1e-4, tokens equal; ms per step.  Then
   one JSON line of kernels, the card's ``nvidia-smi`` line, and the last
   line ``{"ok": true, "device": {...}}``.

Every card-against-CPU comparison asks for equal time, round and byte
columns and accuracy within ``ACC_TOL``.

It needs one card, imports nothing of JAX, and runs from the root of a
checkout.

    python3 chip_smoke.py --phases 35,36,37,38,39

runs only the phases named (phase 1, the build, always first) and prints
neither the kernels line nor the result line (phase 31 serves phase 28's
engines, so it needs 28 named too).

    python3 chip_smoke.py --world 4

runs, on a machine with 4 cards, the mesh slice's phases W1-W3 on a
(2, 2) NCCL mesh, one process a card (the kernels built once first): the
sharded server over 4 and 2 shards against the stacked form, the
federated round at SmolLM's smoke config against the same world's gloo
mesh on the CPU and at full width, and Qwen3-1.7B's sequence-sharded
decode against plain decode of the same rows.  It needs no card for
``--world-rank`` alone (a rank of a gloo world at the smoke configs: a
rehearsal).

    python3 chip_smoke.py --profile-b [CHECKOUT]

times only kernel B's block channel on the CNN's leaves, with the port of
CHECKOUT (default: this one), so that two trees compare on one card.

    python3 chip_smoke.py --profile-channel [CHECKOUT]

times kernel B's channel form at SmolLM-135M's federated-round rows
without its wire and, where CHECKOUT's port has it, with it, the same way.
"""
from __future__ import annotations

import contextlib
import ctypes
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
PEAK_TF32_OPS_PER_S = 495e12      # H100 SXM, TF32 on the tensor cores
ACC_TOL = 0.05                    # card vs CPU accuracy, absolute, per entry
# kernel C against its plain version: f32 sums in another order (split
# TF32 on the tensor cores against cuBLAS); at the test sizes the JAX
# tests' own tolerance, at full width (256-long sums of 128-long dot
# products) ten times that
SSD_TOL = 1e-5
SSD_TOL_FULL = 1e-4
NEAR_TIE = 1e-3                   # top-2 logit margin a token flip may have
# batched against heap scheduler on the card: the same ops in the same
# order, up to the card's own run-to-run float differences
BATCHED_ACC_TOL = 1e-4
COLUMNS = ("time", "round", "bytes_up", "bytes_down", "max_model_bytes_up",
           "max_model_bytes_down")
STATS = ("dispatches", "completions", "dropouts", "transient_failures",
         "redispatched", "flushes", "flushed_tasks")
LOGIT_TOL = 1e-4                  # smoke prefill logits, card against CPU
# Qwen3-1.7B's flash prefill against its plain branch, on the card: the
# same f32 math with the softmax summed chunk by chunk
FLASH_TOL = 1e-4
# the decoder-only architectures of the port, at their smoke configs in
# phase 26
LM_ARCHS = ("qwen3_1_7b", "smollm_135m", "granite_34b", "phi3_5_moe_42b",
            "moonshot_v1_16b", "llama4_scout_17b", "jamba_v0_1_52b")
# the LM FL tasks (phases 27-31); card against CPU, their accuracy within
# the port's CPU tests' tolerance against the JAX package
LM_TASKS = ("transformer_lm", "moe_lm", "ssm_lm")
LM_ACC_TOL = 0.025
# the EP MoE against its dense route on a token whose k slots all fit
EP_TOL = 1e-4
# the sequence-sharded decode against plain decode, on the card
SEQSHARD_TOL = 1e-4


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


def b_launch(leaves, block: int, iters: int, slices=None):
    """A raw launch of kernel B over ``leaves`` at (0.25, 8) into outputs
    of its own, ``slices`` CTAs a row (the wrapper's choice by default):
    -> (launch, levels, scales)."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels import topk_quant as B
    dev = leaves[0].device
    firsts, rows, _ = B.launch_plan([x.numel() for x in leaves], block)
    lv = torch.empty((rows, block), dtype=torch.int8, device=dev)
    sc = torch.empty((rows, 1), dtype=torch.float32, device=dev)
    k, i64 = len(leaves), ctypes.c_longlong
    args = (k, (i64 * k)(*[x.data_ptr() for x in leaves]),
            (i64 * k)(*[x.numel() for x in leaves]), (i64 * k)(*firsts),
            rows, 0, block, slices or B.slices_for(block),
            B.least_kept_count(block, 0.25), 8, iters, lv.data_ptr(),
            sc.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    lib = build.library()
    return (lambda: build.check(lib.topk_quant_launch(*args), "topk_quant"),
            lv, sc)


def kernel_device_ms(fn, name: str, reps: int = 20,
                     attempts: int = 3) -> float:
    """Milliseconds on the card per launch of the kernels whose name holds
    ``name``, from torch.profiler over ``reps`` calls of ``fn`` (the
    device's own kernel durations, whatever the host's pace).  A profiled
    window in which the profiler recorded no such kernel is taken again,
    up to ``attempts`` windows in all (one window of a run once came back
    without any device activity)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total, count = 0.0, 0
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA and \
                    name in e.key:
                total += e.self_device_time_total / 1e3
                count += e.count
        if count:
            return total / count
        print(f"   (the profiler recorded no kernel named {name!r} in a "
              f"window of {reps} calls)")
    raise RuntimeError(f"the profiler saw no kernel named {name!r}")


class Smoke:
    """The phases, on ``dev`` with the main path at ``n_devices`` devices
    and ``n_train``/``n_test`` samples (the paper's fleet by default; a CPU
    rehearsal passes the CPU and a smaller fleet)."""

    def __init__(self, dev="cuda", n_devices=100, n_train=60000,
                 n_test=10000, ssm_smoke=False,
                 channel_cs=(1, 2, 8, 16, 26, 32, 64),
                 wave_fleet=100_000, wave_walls=(45.0, 30.0),
                 fleet4=(10_000, 128, 40.0, 0.1, None)):
        import numpy as np
        import torch
        from repro_torch.configs.base import get_config, get_smoke_config
        self.np, self.torch = np, torch
        self.failures = []
        self.kernels = {"fused_pack": {}, "topk_quant": {}, "ssd_scan": {}}
        self.dev = torch.device(dev)
        self.fleet = (n_devices, n_train, n_test)
        # SSM serving: Mamba2-370M at full width (a CPU rehearsal passes
        # ssm_smoke=True for the smoke configs of every serving phase); 8
        # requests over 4 slots
        self.ssm_cfg = (get_smoke_config if ssm_smoke else get_config)(
            "mamba2-370m")
        self.serve_shape = dict(slots=4, requests=8, gen=16,
                                prompt_len=64 if ssm_smoke else 512)
        # phases 24 and 25: Qwen3-1.7B at full width and depth, 8 requests
        # over 4 slots and one long prompt past the flash threshold; Jamba
        # v0.1 at full width, cut in depth to its first group of 8 layers
        # (7 Mamba, 1 attention; the full model has 4 groups), 4 prompts
        self.qwen_cfg = (get_smoke_config if ssm_smoke else get_config)(
            "qwen3-1.7b")
        self.qwen_shape = dict(slots=4, requests=8, gen=16,
                               prompt_len=64 if ssm_smoke else 512,
                               long_prompt=2304 if ssm_smoke else 4096)
        jamba = (get_smoke_config if ssm_smoke else get_config)(
            "jamba-v0.1-52b")
        self.jamba_cfg = dataclasses.replace(jamba,
                                             n_layers=jamba.attn_every)
        self.jamba_shape = dict(batch=4, gen=4 if ssm_smoke else 16,
                                prompt_len=64 if ssm_smoke else 512)
        self.lm = {}
        # phases 28 and 31: the LM tasks' trained engines
        self.lm_sims = {}
        # phase 29: the four-family fleet (devices, cohort, the weighted
        # run's seconds of wall, virtual s per step, and a virtual budget
        # that replaces the wall cap when given)
        self.fleet4 = fleet4
        # phases 32 and 33: Whisper-tiny (4 prompts of 32 tokens, 16 each)
        # and InternVL2-2B (one row of 256 patches + 512 tokens, 16 decode
        # steps), at full width and depth
        self.whisper_cfg = (get_smoke_config if ssm_smoke else get_config)(
            "whisper-tiny")
        self.whisper_shape = dict(batch=4, prompt_len=32, gen=16)
        self.vlm_cfg = (get_smoke_config if ssm_smoke else get_config)(
            "internvl2-2b")
        self.vlm_shape = dict(batch=1, prompt_len=64 if ssm_smoke else 512,
                              gen=16)
        # phase 11: the cohort sizes of the channel form's sweep
        self.channel_cs = channel_cs
        # phases 35-39: the trainer (launch/train.py) at full width
        # (SmolLM-135M, Mamba2-370M, Qwen3-1.7B; a rehearsal takes the
        # smoke configs), and the long row of phase 35 (past 2^24 / p_s)
        self.trainer_smoke = ssm_smoke
        self.smollm_cfg = (get_smoke_config if ssm_smoke else get_config)(
            "smollm-135m")
        self.long_row = 100_003 if ssm_smoke else 80_000_000
        self.train_shapes = {
            "smollm": dict(batch=16, seq=32 if ssm_smoke else 128,
                           rounds=5, lr=0.1),
            "mamba": dict(batch=8, seq=32 if ssm_smoke else 256, rounds=3),
            "qwen": dict(batch=8, seq=32 if ssm_smoke else 128, steps=5)}
        self.train = {}
        # phases 17 and 18: the dispatch regime's fleet (the one with local
        # steps has a hundredth of it) and the seconds of wall of each
        self.wave_fleet = wave_fleet
        self.wave_walls = wave_walls
        self._full = None
        # phases 40-43: the mesh slice's numbers
        self.mesh = {}

    def sync(self):
        if self.dev.type == "cuda":
            self.torch.cuda.synchronize()

    def card(self) -> str:
        """The card's name and power limit (the device, on a rehearsal)."""
        return nvidia_smi() if self.dev.type == "cuda" else str(self.dev)

    def zero_counts(self):
        from repro_torch.kernels import fused_pack, ssd_scan, topk_quant
        fused_pack.LAUNCHES = topk_quant.LAUNCHES = ssd_scan.LAUNCHES = 0

    def read_counts(self):
        from repro_torch.kernels import fused_pack, ssd_scan, topk_quant
        return {"fused_pack": fused_pack.LAUNCHES,
                "topk_quant": topk_quant.LAUNCHES,
                "ssd_scan": ssd_scan.LAUNCHES}

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
                  init_cnn(torch.Generator().manual_seed(0),
                           device="cpu").items()}
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
        # leaves the kernel spreads over a cluster: fc1's size, ragged (the
        # last slice one shorter), and ties at T spanning every slice
        tree["zz_big"] = torch.from_numpy(
            (rng.randn(200704) * 0.1).astype(np.float32)).to(self.dev)
        tree["zz_big_ragged"] = torch.from_numpy(
            rng.randn(200703).astype(np.float32)).to(self.dev)
        tree["zz_big_ties"] = torch.from_numpy(rng.choice(
            np.float32([0.5, -0.5, 0.25, 0.0]), 60001)).to(self.dev)
        # slices of 50,001 elements, more than a CTA's shared memory holds
        # (kMaxSlice in csrc/fused_pack.cu): ragged, with ties
        tree["zz_huge"] = torch.from_numpy(
            (np.round(rng.randn(400003) * 8) / 8).astype(np.float32)).to(
                self.dev)
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
    def b_input(self, kind, n, seed):
        """Kernel B's inputs: normal values at scale 0.1, or few magnitudes
        (ties at every threshold the bisection tries)."""
        np, torch = self.np, self.torch
        rng = np.random.RandomState(seed)
        if kind == "ties":
            x = rng.choice(np.float32([0.5, -0.5, 0.25, -0.25, 0.0]), n)
        else:
            x = (rng.randn(n) * 0.1).astype(np.float32)
        return torch.from_numpy(x).to(self.dev)

    def kernel_b(self):
        torch = self.torch
        from repro_torch.kernels import topk_quant as B
        one = 1 if self.dev.type == "cuda" else 0    # launches per call
        flat = self.b_input("gauss", 206410, 3)
        # (input, block, dtype, bits, iters): the CNN's size at blocks of
        # one CTA a row (1,024, 4,096) and of a 4-CTA cluster (16,384),
        # then larger rows: fc1 as one row, a tie-heavy row of 60,001, a
        # ragged tie-heavy input of 400,003 at block 65,536 and as one row
        # (slices of 50,004 values, more than a CTA's shared memory holds:
        # read from device memory)
        cases = [(flat, b, d, bits, 16) for b in (4096, 16384)
                 for d in (torch.float32, torch.bfloat16) for bits in (8, 4)]
        fc1 = self.b_input("gauss", 200704, 4)
        huge = self.b_input("ties", 400003, 5)
        cases += [(flat, 1024, torch.float32, 8, 16),
                  (flat, 16384, torch.float32, 2, 16),
                  (flat, 16384, torch.float32, 8, 12),
                  (flat, 16384, torch.bfloat16, 8, 5),
                  (flat, 32768, torch.float32, 8, 16),
                  (self.b_input("ties", 60001, 6), 60001, torch.float32, 8,
                   16),
                  (fc1, 200704, torch.float32, 8, 12),
                  (fc1, 200704, torch.bfloat16, 4, 16),
                  (huge, 65536, torch.float32, 8, 16),
                  (huge, 400003, torch.float32, 8, 16)]
        checked, max_err = 0, 0.0
        for x, block, dtype, bits, iters in cases:
            x = x.to(dtype)
            where = (f"(n={x.numel()}, block={block}, {dtype}, bits={bits}, "
                     f"iters={iters})")
            before = B.LAUNCHES
            lv, sc = B.topk_quant(x, p_s=0.25, bits=bits, iters=iters,
                                  block=block)
            self.expect(B.LAUNCHES == before + one, f"launches {where}")
            lp, sp = B.topk_quant_plain(B._pad_rows(x, block), 0.25, bits,
                                        iters)
            self.expect(torch.equal(lv, lp), f"levels {where}")
            self.expect(torch.equal(sc, sp), f"scales {where}")
            n = x.numel()
            err = (B.dequant(lv, sc, bits, n, (n,))
                   - B.dequant(lp, sp, bits, n, (n,))).abs().max()
            max_err = max(max_err, float(err))
            checked += 1
        # the CNN's 8 leaves in one call: one launch at the default block
        leaves = [v for _, v in sorted(self.cnn_like(7).items())]
        before = B.LAUNCHES
        got = B.topk_quant_leaves(leaves)
        self.expect(B.LAUNCHES == before + one,
                    f"the 8 leaves took {B.LAUNCHES - before} launches")
        for i, (x, (lv, sc)) in enumerate(zip(leaves, got)):
            lp, sp = B.topk_quant_plain(B._pad_rows(x, B.DEFAULT_BLOCK))
            self.expect(torch.equal(lv, lp) and torch.equal(sc, sp),
                        f"topk_quant_leaves, leaf {i}")
        checked += 1
        print(f"   {checked} cases ({len(cases)} tensors at blocks 1,024 to "
              f"400,003, bits 8/4/2, iters 16/12/5; the CNN's 8 leaves in "
              f"one launch): levels and scales identical to the plain "
              f"version (tolerance: exact)")
        self.kernels["topk_quant"].update(max_abs_err=max_err,
                                          checked_cases=checked)

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
        self.zero_counts()
        t0 = time.perf_counter()
        hist = sim.run(time_budget=1e9, max_rounds=5)
        self.sync()
        wall = time.perf_counter() - t0
        w = sim.server.w
        wire = PackedBitstreamCodec(0.25, 8).encode(w)
        names = sorted(w)
        channel = dict(zip(names, ops.compress_roundtrip_leaves(
            [w[k] for k in names])))
        self.sync()
        launches = self.read_counts()
        del launches["ssd_scan"]          # not on this path
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
        self.expect(launches["topk_quant"] == 1,
                    f"the block channel took {launches['topk_quant']} "
                    f"launches of kernel B, not 1")
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
                        f"compress_roundtrip_leaves of {k} != plain version")
            self.expect(bool(torch.isfinite(channel[k]).all()),
                        f"compress_roundtrip_leaves of {k} not finite")
        print("   trained model: kernel A's stream equals the host pipeline "
              "and decodes like DenseRefCodec; kernel B's channel (one "
              "launch for the 8 leaves) equals its plain version on every "
              "leaf (tolerance: exact)")
        for name, n in launches.items():
            self.kernels[name]["launches"] = n
        self.trained = w

    # -- phase 5 ------------------------------------------------------------
    def compare_with_cpu(self, method, acc_tol=ACC_TOL, **kw):
        """One small run (8 devices, 640 samples) of ``method`` on the card
        and on the CPU from the same weights (of ``kw["task"]``, the CNN by
        default): the time, round and byte columns must be equal and the
        accuracy within ``acc_tol``.  Returns (entries, rounds, max
        |accuracy diff|)."""
        from repro_torch.fl.protocols import make_setup, run_method
        from repro_torch.utils.tree import to_numpy
        task = kw.get("task", "fmnist_cnn")
        data, parts, w0 = make_setup(n_devices=8, iid=True, seed=3,
                                     n_train=640, n_test=320, task=task,
                                     device="cpu")
        w_np = to_numpy(w0)
        kw = dict(dict(time_budget=4.0, epochs=1, seed=3, p_s=0.25, p_q=8),
                  **kw)
        hists = {}
        for dev in (self.dev.type, "cpu"):
            _, _, w = make_setup(n_devices=8, iid=True, seed=3, n_train=640,
                                 n_test=320, task=task, device=dev,
                                 init_params=w_np)
            hists[dev] = run_method(method, data, parts, w, device=dev,
                                    **kw)
        hc, hp = hists[self.dev.type], hists["cpu"]
        self.expect(len(hc) == len(hp), f"{method}: {len(hc)} vs {len(hp)} "
                    f"entries")
        cols = ("time", "round", "bytes_up", "bytes_down",
                "max_model_bytes_up", "max_model_bytes_down")
        for a, b in zip(hc, hp):
            for c in cols:
                self.expect(getattr(a, c) == getattr(b, c),
                            f"{method} {c}: {getattr(a, c)} vs "
                            f"{getattr(b, c)}")
        d = max(abs(a.accuracy - b.accuracy) for a, b in zip(hc, hp))
        self.expect(d <= acc_tol, f"{method}: accuracy differs by {d} > "
                    f"{acc_tol}")
        return len(hc), hc[-1].round, d

    def card_vs_cpu(self):
        n, rounds, d = self.compare_with_cpu("teasq", codec="packed")
        print(f"   {n} entries, {rounds} rounds: time, round "
              f"and byte columns equal; max |accuracy diff| {d:.4f} "
              f"(tolerance {ACC_TOL})")

    # -- phase 6 ------------------------------------------------------------
    def timings(self):
        np, torch = self.np, self.torch
        from repro_torch.core.compression import topk_count
        from repro_torch.kernels import build
        from repro_torch.kernels.fused_pack import (fused_pack_plain,
                                                    launch_meta,
                                                    stream_layout)
        from repro_torch.kernels import ops
        from repro_torch.kernels import topk_quant as B
        from repro_torch.kernels.topk_quant import topk_quant_plain
        lib = build.library()
        w = self.trained
        xs = [w[k].contiguous() for k in sorted(w)]
        sizes = [x.numel() for x in xs]
        n = sum(sizes)
        # kernel A at the main path's point (0.25, 8)
        _, total = stream_layout(sizes, 0.25, 8)
        meta = launch_meta(xs, 0.25, 8)
        words = torch.zeros((total + 31) // 32 + 1, dtype=torch.int32,
                            device=self.dev)
        stream = torch.cuda.current_stream().cuda_stream

        def run_a():   # ORs into the same words again: same work, same time
            build.check(lib.fused_pack_launch(meta.data_ptr(),
                                              meta.shape[0],
                                              words.data_ptr(), 8, stream),
                        "fused_pack")

        ms_a = time_cuda(run_a)
        plain_a = time_cuda(lambda: fused_pack_plain(xs, 0.25, 8), iters=10)
        bytes_a = 4 * n + (total + 7) // 8
        # a max and 4 radix passes over n, 3 emission passes (ties, ranks,
        # fields), 4 operations per survivor
        ops_a = 8 * n + 4 * sum(topk_count(m, 0.25) for m in sizes)
        # kernel B as the main path calls it: one launch for the 8
        # unpadded leaves (host walls first: the profiler leaves launches
        # slower after it)
        ops.compress_roundtrip_leaves(xs)
        wall_b, _ = self.timed(lambda: ops.compress_roundtrip_leaves(xs), 50)
        run_b = b_launch(xs, B.DEFAULT_BLOCK, 16)[0]
        ms_b = time_cuda(run_b)
        dev_b = kernel_device_ms(run_b, "topk_quant")
        rows = [B._pad_rows(x, B.DEFAULT_BLOCK) for x in xs]
        plain_b = time_cuda(lambda: [topk_quant_plain(r, 0.25, 8)
                                     for r in rows], iters=10)
        n_pad = sum(r.numel() for r in rows)
        m_rows = sum(r.shape[0] for r in rows)
        # each input value read once, each level and scale written once
        bytes_b = 4 * n + n_pad + 4 * m_rows
        ops_b = (16 + 5) * n_pad
        # the whole-tensor form of the next slice's threshold channel: fc1
        # as one row of 200,704 over a cluster, 12 steps (record only)
        fc1 = w["fc1"].contiguous().reshape(-1)
        run_fc1 = b_launch([fc1], fc1.numel(), 12)[0]
        ms_fc1 = time_cuda(run_fc1)
        dev_fc1 = kernel_device_ms(run_fc1, "topk_quant")
        print(f"   topk_quant, one launch for the 8 leaves: {ms_b * 1e3:.2f} "
              f"us per launch (events over 50), {dev_b * 1e3:.2f} us on the "
              f"card (profiler); the block channel through "
              f"compress_roundtrip_leaves, dequant included: "
              f"{wall_b * 1e3:.1f} us of wall (host clock, synchronized) "
              f"[{self.card()}]")
        print(f"   topk_quant on fc1 as one row (block 200,704, iters 12, "
              f"8-CTA cluster): {ms_fc1 * 1e3:.2f} us (events), "
              f"{dev_fc1 * 1e3:.2f} us on the card (profiler)")
        self.kernels["topk_quant"].update(device_ms=dev_b,
                                          channel_wall_ms=wall_b,
                                          fc1_row_ms=ms_fc1,
                                          fc1_row_device_ms=dev_fc1)
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
              "(0.25, 8); topk_quant one launch for its 8 leaves at block "
              f"{B.DEFAULT_BLOCK}, (0.25, 8, 16). No single PyTorch call "
              "computes either function: library_ms is null.")

    # -- phase 7 ------------------------------------------------------------
    def ssd_inputs(self, B, S, H, P, N, seed):
        """The JAX tests' SSD inputs (tests/test_kernels.py) on the device."""
        np, torch = self.np, self.torch
        rng = np.random.RandomState(seed)
        arrs = (rng.randn(B, S, H, P), rng.randn(B, S, N) * 0.3,
                rng.randn(B, S, N) * 0.3, np.abs(rng.randn(B, S, H)) * 0.1,
                -np.abs(rng.randn(B, S, H)) * 0.05)
        return [torch.from_numpy(a.astype(np.float32)).to(self.dev)
                for a in arrs]

    def ssd_cells(self, G, heads, L, P, N, seed, dtype):
        """Random intra-chunk cells: xb (G, L, P), b and c (G // heads, L,
        N) in ``dtype``, cum (G, 1, L) a decreasing cumulative log-decay."""
        np, torch = self.np, self.torch
        rng = np.random.RandomState(seed)
        t = lambda a: torch.from_numpy(a.astype(np.float32)).to(self.dev)
        xb = t(rng.randn(G, L, P))
        b = t(rng.randn(G // heads, L, N) * 0.3).to(dtype)
        c = t(rng.randn(G // heads, L, N) * 0.3).to(dtype)
        cum = t(np.cumsum(-np.abs(rng.randn(G, 1, L)) * 0.05, axis=-1))
        return xb, b, c, cum

    def kernel_c(self):
        torch = self.torch
        from repro_torch.kernels import ops
        from repro_torch.kernels import ssd_scan as K
        from repro_torch.models.ssm import ssd_chunked
        cfg = self.ssm_cfg
        # largest |kernel - plain| at the test sizes and at full width, and
        # largest |ops.ssd - ssd_chunked| (the whole SSD against its oracle)
        worst = {"test sizes": 0.0, "full width": 0.0, "ops.ssd": 0.0}

        def close(got, want, tol, where, key):
            err = float((got - want).abs().max())
            worst[key] = max(worst[key], err)
            self.expect(torch.allclose(got, want, atol=tol, rtol=tol),
                        f"kernel C {where}: max abs err {err}")

        def cells(G, heads, L, P, N, seed, dtype, tol, key):
            xb, b, c, cum = self.ssd_cells(G, heads, L, P, N, seed, dtype)
            got = K.ssd_intra_chunk(xb, b, c, cum, heads=heads)
            want = K.ssd_intra_chunk_plain(xb, b, c, cum, heads=heads)
            where = f"(G={G}, heads={heads}, L={L}, P={P}, N={N}, {dtype})"
            for name, g, w in zip(("y", "S", "a"), got, want):
                self.expect(bool(torch.isfinite(g).all()),
                            f"kernel C {name} {where} not finite")
                close(g, w, tol, f"{name} {where}", key)

        cases = 0
        for dtype in (torch.float32, torch.bfloat16):
            for chunk in (32, 64, 128):
                for N in (16, 32, 128):
                    # the intra-chunk step: B=2, H=2 cells of the JAX tests
                    cells(2 * 2 * (256 // chunk), 2, chunk, 64, N, chunk + N,
                          dtype, SSD_TOL, "test sizes")
                    # the whole SSD around it, against the plain oracle
                    xh, b, c, dt, la = self.ssd_inputs(2, 256, 2, 64, N,
                                                       chunk + N)
                    b, c = b.to(dtype), c.to(dtype)
                    y, h = ops.ssd(xh, b, c, dt, la, chunk)
                    y_ref, h_ref = ssd_chunked(xh, b, c, dt, la, chunk)
                    where = f"ops.ssd (chunk={chunk}, N={N}, {dtype})"
                    close(y, y_ref, SSD_TOL, "y of " + where, "ops.ssd")
                    close(h, h_ref, SSD_TOL, "state of " + where, "ops.ssd")
                    cases += 1
            # ragged chunk lengths and narrow heads
            cells(6, 3, 12, 64, 32, 5, dtype, SSD_TOL, "test sizes")
            cells(4, 2, 200, 16, 8, 6, dtype, SSD_TOL, "test sizes")
            # head counts the kernel's head group does not divide, N = 8
            cells(12, 6, 200, 64, 8, 9, dtype, SSD_TOL, "test sizes")
            cells(6, 3, 256, 32, 128, 10, dtype, SSD_TOL, "test sizes")
            # the full-width cell: one 512-token prompt of Mamba2-370M
            L, P, N, H = (cfg.ssm_chunk, cfg.ssm_head_dim, cfg.ssm_state,
                          cfg.ssm_heads)
            cells(2 * H, H, L, P, N, 7, dtype, SSD_TOL_FULL, "full width")
            cases += 5
        print(f"   {cases} cases: y, S and a of the kernel within "
              f"{SSD_TOL} (atol = rtol) of the plain version at the test "
              f"sizes, within {SSD_TOL_FULL} at full width "
              f"(L={cfg.ssm_chunk}, P={cfg.ssm_head_dim}, "
              f"N={cfg.ssm_state}, G={2 * cfg.ssm_heads}); ops.ssd output "
              f"and state within {SSD_TOL} of ssd_chunked; max abs err "
              f"of the kernel against its plain version "
              f"{worst['test sizes']:.3g} (test sizes), "
              f"{worst['full width']:.3g} (full width); of ops.ssd against "
              f"ssd_chunked {worst['ops.ssd']:.3g}")
        self.kernels["ssd_scan"].update(
            max_abs_err=max(worst["test sizes"], worst["full width"]),
            checked_cases=cases)

    # -- phase 8 ------------------------------------------------------------
    def margins(self, params, cfg, prompt, toks):
        """The solo run's top-2 logit margin before each generated token,
        replayed through prefill and decode_step along ``toks``."""
        torch = self.torch
        from repro_torch.models import transformer as T
        with torch.no_grad():
            logits, cache = T.prefill(params, {"tokens": torch.as_tensor(
                prompt[None], device=self.dev)}, cfg)
            cache = T.extend_cache(cache, len(prompt) + len(toks))
            out = []
            for i, t in enumerate(toks):
                top = logits[0, -1].topk(2).values
                out.append(float(top[0] - top[1]))
                logits, cache = T.decode_step(params, torch.tensor(
                    [[t]], device=self.dev), len(prompt) + i, cfg, cache)
        return out

    def near_ties(self, params, cfg, prompts, outs, solo, what="batcher"):
        """Hold each request's tokens ``outs[i]`` to its solo tokens: a
        difference passes only as a near tie of the solo logits (top-2
        margin below NEAR_TIE).  Returns the number of such flips."""
        flips = 0
        for i, (got, want) in enumerate(zip(outs, solo)):
            self.expect(len(got) == len(want) and
                        all(0 <= t < cfg.vocab for t in got),
                        f"request {i}: tokens {got}")
            if got == want:
                continue
            k = next(j for j, (a, b) in enumerate(zip(got, want)) if a != b)
            margin = self.margins(params, cfg, prompts[i], want)[k]
            print(f"   request {i}: {what} and solo differ first at token "
                  f"{k}; solo top-2 margin there {margin:.3g}")
            self.expect(margin < NEAR_TIE,
                        f"request {i}: {what} {got} != solo {want}, and "
                        f"the solo margin {margin} is no near tie")
            flips += 1
        print(f"   {what} tokens equal solo generate on "
              f"{len(outs) - flips} of {len(outs)} requests; near-tie "
              f"flips (solo top-2 margin < {NEAR_TIE}): {flips}")
        return flips

    def timed(self, fn, reps):
        """Host milliseconds per call of ``fn`` (synchronized)."""
        self.sync()
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn()
        self.sync()
        return (time.perf_counter() - t0) / reps * 1e3, out

    def init_lm(self, cfg, seed: int = 0):
        """Seeded random weights of ``cfg`` on the device, and a line that
        says what they are."""
        torch = self.torch
        from repro_torch.models import transformer as T
        t0 = time.perf_counter()
        params = T.init_model(
            cfg, torch.Generator(device=self.dev).manual_seed(seed),
            self.dev)
        self.sync()
        n = sum(a.numel() for a in _leaves(params))
        shape = (f"{cfg.ssm_heads} heads x P={cfg.ssm_head_dim}, "
                 f"N={cfg.ssm_state}, chunk {cfg.ssm_chunk}"
                 if cfg.is_ssm_only else
                 f"{cfg.n_heads}/{cfg.n_kv_heads} heads x {cfg.head_dim}, "
                 f"d_ff {cfg.d_ff}"
                 + (f", {cfg.n_experts} experts top-{cfg.moe_top_k}"
                    if cfg.is_moe else ""))
        print(f"   {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
              f"{shape}, vocab {cfg.vocab}: {n} parameters "
              f"({n * 4 / 1e9:.2f} GB in f32), seeded random "
              f"({time.perf_counter() - t0:.1f} s)")
        return params

    def serve_window(self, params, cfg, shp):
        """A ``ContinuousBatcher`` over ``shp['requests']`` seeded prompts
        with every launch counter set to 0 before and read after, the
        solo ``generate`` of each (tokens equal, or a near tie), then one
        admission's prefill and one decode step of all slots timed apart
        (their device busy share on the card).  -> the numbers."""
        np, torch = self.np, self.torch
        from repro_torch.launch.serve import ContinuousBatcher, generate
        from repro_torch.models import transformer as T
        from repro_torch.utils.tree import tree_map
        rng = np.random.RandomState(1)
        prompts = [rng.randint(0, cfg.vocab, shp["prompt_len"])
                   for _ in range(shp["requests"])]
        cache_len = shp["prompt_len"] + shp["gen"]
        # warm the paths once (cuBLAS plans, allocator) outside the window
        generate(params, cfg, prompts[0][None], 2)
        self.sync()

        self.zero_counts()
        cb = ContinuousBatcher(params, cfg, slots=shp["slots"],
                               cache_len=cache_len)
        t0 = time.perf_counter()
        outs, lat = cb.run(prompts, shp["gen"])
        self.sync()
        wall = time.perf_counter() - t0
        launches = self.read_counts()
        toks = sum(len(o) for o in outs)
        print(f"   launches on the serving path: {launches}")
        print(f"   continuous batching: {shp['requests']} requests x gen "
              f"{shp['gen']}, prompt {shp['prompt_len']}, {shp['slots']} "
              f"slots, {cb.steps} decode steps in {wall:.3f} s: "
              f"{toks / wall:.1f} tok/s over the window, its prefills "
              f"included, p50 latency "
              f"{np.percentile(lat, 50) * 1e3:.1f} ms [{self.card()}]")

        solo = [generate(params, cfg, p[None], shp["gen"])[0, len(p):]
                .tolist() for p in prompts]
        flips = self.near_ties(params, cfg, prompts, outs, solo)

        # the two halves of the loop, timed apart: one admission's prefill,
        # one decode step of every slot at its own position
        one = torch.as_tensor(prompts[0][None], device=self.dev)
        ms_prefill, (logits, cache) = self.timed(
            lambda: T.prefill(params, {"tokens": one}, cfg), 3)
        self.expect(bool(torch.isfinite(logits).all()),
                    "prefill logits not finite")
        tok = torch.zeros((shp["slots"], 1), dtype=torch.int32,
                          device=self.dev)
        pos = torch.full((shp["slots"],), shp["prompt_len"],
                         dtype=torch.int64, device=self.dev)
        state = tree_map(
            lambda a: a.repeat((1, shp["slots"]) + (1,) * (a.dim() - 2)),
            T.extend_cache(cache, cache_len))
        ms_decode, (logits, _) = self.timed(
            lambda: T.decode_step(params, tok, pos, cfg, state), 10)
        self.expect(bool(torch.isfinite(logits).all()),
                    "decode logits not finite")
        decode_tok_s = shp["slots"] / ms_decode * 1e3
        print(f"   prefill {ms_prefill:.2f} ms per admission (1 x "
              f"{shp['prompt_len']} tokens), decode {ms_decode:.2f} ms per "
              f"step ({shp['slots']} slots): {decode_tok_s:.1f} tok/s "
              f"decode only [{self.card()}]")
        busy = {}
        if self.dev.type == "cuda":
            for name, fn, wall_ms in (
                    ("prefill", lambda: T.prefill(params, {"tokens": one},
                                                  cfg), ms_prefill),
                    ("decode step", lambda: T.decode_step(params, tok, pos,
                                                          cfg, state),
                     ms_decode)):
                busy[name] = self.device_time(name, fn, wall_ms)
        return {"launches": launches, "tok_per_s": toks / wall,
                "prefill_ms": ms_prefill, "decode_ms": ms_decode,
                "decode_tok_per_s": decode_tok_s, "flips": flips,
                "busy": busy}

    def serve_ssm(self):
        cfg, shp = self.ssm_cfg, self.serve_shape
        params = self.init_lm(cfg)
        run = self.serve_window(params, cfg, shp)
        launches = run.pop("launches")
        self.expect(launches["ssd_scan"] >= cfg.n_layers * shp["requests"]
                    if self.dev.type == "cuda" else
                    launches["ssd_scan"] == 0,
                    f"kernel C launches on the serving path: {launches}")
        self.kernels["ssd_scan"]["launches"] = launches["ssd_scan"]
        self.kernels["ssd_scan"]["launches_by_path"] = {
            "mamba2_serving": launches["ssd_scan"]}
        self.serving = run

    def device_time(self, name, fn, wall_ms):
        """Kernel time on the card in one call of ``fn``, from
        torch.profiler, against the call's unprofiled wall time: the
        device's busy share, and the kernels that take the most of it."""
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile
        self.sync()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            self.sync()
        # the device's own events (kernels, copies); the CPU ops that
        # launched them carry the same time again
        rows = [(e.self_device_time_total / 1e3, e.count, e.key)
                for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        rows = sorted((r for r in rows if r[0] > 0), reverse=True)
        busy = sum(r[0] for r in rows)
        if not rows:
            print(f"   {name}: the profiler saw no device time (device "
                  f"busy share not measured)")
            return None
        print(f"   {name}: {busy:.3f} ms of kernels on the card in "
              f"{wall_ms:.2f} ms of wall: device busy "
              f"{busy / wall_ms:.1%}, idle {1 - busy / wall_ms:.1%}; "
              f"{sum(r[1] for r in rows)} kernel launches; top:")
        for ms, n, key in rows[:6]:
            print(f"     {ms:9.3f} ms  {n:5d} x  {key[:90]}")
        return {"kernel_ms": busy, "busy_share": busy / wall_ms,
                "kernel_launches": sum(r[1] for r in rows)}

    # -- phase 9 ------------------------------------------------------------
    def ssm_card_vs_cpu(self):
        np, torch = self.np, self.torch
        from repro_torch.configs.base import get_smoke_config
        from repro_torch.launch.serve import generate
        from repro_torch.models import transformer as T
        from repro_torch.utils.tree import tree_map
        cfg = get_smoke_config("mamba2-370m")
        p_cpu = T.init_model(cfg, torch.Generator().manual_seed(3), "cpu")
        p_dev = tree_map(lambda a: a.to(self.dev), p_cpu)
        toks = np.random.RandomState(4).randint(0, cfg.vocab, (2, 128))
        lg = {}
        for name, p in (("card", p_dev), ("cpu", p_cpu)):
            with torch.no_grad():
                lg[name], _ = T.prefill(p, {"tokens": torch.as_tensor(
                    toks, device=p["embed"].device)}, cfg)
        d = float((lg["card"].cpu() - lg["cpu"]).abs().max())
        self.expect(d <= LOGIT_TOL, f"prefill logits differ by {d}")
        g_dev = generate(p_dev, cfg, toks[:, :64], 12).cpu()
        g_cpu = generate(p_cpu, cfg, toks[:, :64], 12)
        self.expect(torch.equal(g_dev, g_cpu),
                    f"greedy tokens differ:\n{g_dev[:, 64:]}\n"
                    f"{g_cpu[:, 64:]}")
        print(f"   {cfg.name}: prefill logits (2 x 128 tokens) within "
              f"{d:.3g} (tolerance {LOGIT_TOL}); greedy tokens of 2 x 12 "
              f"equal")

    # -- phase 10 -----------------------------------------------------------
    def time_c(self, G, H, L, P, N, seed):
        """Kernel C's time at one shape (f32 b and c; CUDA events over a
        raw launch), its plain version's, and its bound."""
        torch = self.torch
        from repro_torch.kernels import build
        from repro_torch.kernels.ssd_scan import ssd_intra_chunk_plain
        lib = build.library()
        xb, b, c, cum = self.ssd_cells(G, H, L, P, N, seed, torch.float32)
        y = torch.empty((G, L, P), device=self.dev)
        s = torch.empty((G, N, P), device=self.dev)
        a = torch.empty((G, 1), device=self.dev)
        stream = torch.cuda.current_stream().cuda_stream

        def run():
            build.check(lib.ssd_scan_launch(
                xb.data_ptr(), b.data_ptr(), c.data_ptr(), cum.data_ptr(), 0,
                G, H, L, P, N, y.data_ptr(), s.data_ptr(), a.data_ptr(),
                stream), "ssd_scan")

        ms = time_cuda(run)
        plain = time_cuda(lambda: ssd_intra_chunk_plain(xb, b, c, cum, H),
                          iters=10)
        nbytes = 4 * (G * L * P + 2 * (G // H) * L * N + G * L
                      + G * L * P + G * N * P + G)
        # what the function needs: C B^T once per (batch, chunk) and only on
        # and below the diagonal, the masked product per cell on the same
        # triangle, and the chunk state per cell (the kernel itself forms
        # C B^T once per head group and on whole tiles; the JAX kernel
        # counts the full square, 2L^2N + 2L^2P + 2LNP per cell)
        nops = ((G // H) * L * (L + 1) * N + G * L * (L + 1) * P
                + G * 2 * L * N * P)
        # the kernel's products are split TF32 on the tensor cores: three
        # TF32 products for each f32 one.  The f32 rate outside the tensor
        # cores is kept as a note (bound_f32_ms), not as the bound.
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        t_ops = 3 * nops / PEAK_TF32_OPS_PER_S * 1e3
        t_f32 = max(t_bytes, nops / PEAK_F32_OPS_PER_S * 1e3)
        out = {"ms": ms, "plain_ms": plain, "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "bytes": nbytes, "operations": nops,
               "tf32_operations": 3 * nops, "bound_f32_ms": t_f32}
        print(f"   ssd_scan at G={G}, {H} heads, L={L}, P={P}, N={N}: "
              f"{ms * 1e3:.1f} us kernel, {plain * 1e3:.1f} us plain, bound "
              f"{max(t_bytes, t_ops) * 1e3:.2f} us ({t_bytes * 1e3:.2f} us "
              f"of bytes, {t_ops * 1e3:.2f} us of split-TF32 products; "
              f"{t_f32 * 1e3:.2f} us at the f32 rate), {nbytes} bytes, "
              f"{nops} ops [{self.card()}]")
        return out

    def timings_c(self):
        cfg = self.ssm_cfg
        # the admission prefill: one row of a 512-token prompt, all layers
        # alike: G = 1 x 2 chunks x 32 heads
        H, L, P, N = (cfg.ssm_heads, cfg.ssm_chunk, cfg.ssm_head_dim,
                      cfg.ssm_state)
        t = self.time_c(2 * H, H, L, P, N, 8)
        self.kernels["ssd_scan"].update({
            "name": "ssd_scan", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
            "replaces": "src/repro/kernels/ssd_scan.py:58",
            "library_ms": None, **t})
        print(f"   (the admission shape of {cfg.name}: "
              f"{cfg.n_layers * t['ms']:.2f} ms per admission)")
        print("   No single PyTorch call computes this function: library_ms "
              "is null.")

    # -- phase 11 -----------------------------------------------------------
    def cnn_stack(self, c: int, seed: int):
        """The CNN's 8 leaves (sorted by name) stacked over ``c`` devices,
        seeded normal values at scale 0.05."""
        np, torch = self.np, self.torch
        rng = np.random.RandomState(seed)
        return [torch.from_numpy((rng.randn(c, *v.shape) * 0.05).astype(
            np.float32)).to(self.dev)
            for _, v in sorted(self.cnn_like(0).items())]

    def channel_b(self):
        np, torch = self.np, self.torch
        from repro_torch.core.dynamic import DEFAULT_SET_Q, DEFAULT_SET_S
        from repro_torch.kernels import topk_quant as B
        from repro_torch.kernels.ops import threshold_channel_leaves
        card = self.dev.type == "cuda"
        checked, worst = 0, 0.0

        def check(xs, p_s, p_q, iters, launches, where):
            before = B.LAUNCHES
            got = threshold_channel_leaves(xs, p_s, p_q, iters)
            n = B.LAUNCHES - before
            want = launches if card and (p_s, p_q) != (1.0, 32) else 0
            self.expect(n == want, f"{n} launches, not {want}, {where}")
            plain = B.threshold_channel_plain(xs, p_s, p_q, iters)
            for i, (g, w) in enumerate(zip(got, plain)):
                view = torch.int16 if g.dtype == torch.bfloat16 else \
                    torch.int32
                self.expect(g.shape == w.shape and g.dtype == w.dtype
                            and torch.equal(g.view(view), w.view(view)),
                            f"channel form leaf {i} != plain {where}")
            if p_q <= 8:    # the wire: levels and scales beside the values
                before = B.LAUNCHES
                gw = threshold_channel_leaves(xs, p_s, p_q, iters, wire=True)
                n = B.LAUNCHES - before
                want = launches if card else 0
                self.expect(n == want, f"{n} wire launches, not {want}, "
                            f"{where}")
                pw = B.threshold_channel_plain(xs, p_s, p_q, iters,
                                               wire=True)
                for i in range(len(xs)):
                    self.expect(torch.equal(gw[1][i], pw[1][i])
                                and gw[1][i].dtype == torch.int8
                                and torch.equal(gw[2][i].view(torch.int32),
                                                pw[2][i].view(torch.int32))
                                and torch.equal(gw[0][i].view(view),
                                                got[i].view(view)),
                                f"channel wire leaf {i} != plain {where}")
                wire_checked[0] += 1
            return max(float((g.float() - w.float()).abs().max())
                       for g, w in zip(got, plain))

        wire_checked = [0]
        for c in self.channel_cs:
            xs = self.cnn_stack(c, 30 + c)
            for p_s in DEFAULT_SET_S:
                for p_q in DEFAULT_SET_Q:
                    for iters in (12, 6):
                        worst = max(worst, check(
                            xs, p_s, p_q, iters, 2,
                            f"(C={c}, p_s={p_s}, p_q={p_q}, iters={iters})"))
                        checked += 1
        xs = [x.to(torch.bfloat16) for x in self.cnn_stack(8, 40)]
        for p_s, p_q in ((0.25, 8), (0.05, 16), (1.0, 4), (0.5, 32)):
            worst = max(worst, check(xs, p_s, p_q, 12, 2,
                                     f"(bf16, C=8, p_s={p_s}, p_q={p_q})"))
            checked += 1
        # a ragged list: a row of 140,001 tied magnitudes (a cluster a row,
        # ties at every threshold), rows that take 2 and 3 CTAs, odd sizes
        rng = np.random.RandomState(41)
        ragged = [rng.choice(np.float32([0.5, -0.5, 0.25, -0.25, 0.125, 0.0]),
                             (2, 140001)),
                  (rng.randn(3, 5000) * 0.1).astype(np.float32),
                  (rng.randn(2, 12288) * 0.1).astype(np.float32),
                  (rng.randn(5, 7) * 0.1).astype(np.float32),
                  (rng.randn(1, 4, 3) * 0.1).astype(np.float32)]
        ragged = [torch.from_numpy(x).to(self.dev) for x in ragged]
        plan = B.channel_plan([x[0].numel() for x in ragged],
                              [x.shape[0] for x in ragged])
        for p_s, p_q, iters in ((0.25, 8, 12), (0.01, 16, 12), (0.5, 4, 6),
                                (0.1, 32, 12), (1.0, 8, 12)):
            worst = max(worst, check(
                ragged, p_s, p_q, iters, len(plan),
                f"(ragged, p_s={p_s}, p_q={p_q}, iters={iters})"))
            checked += 1
        print(f"   {checked} cases (Set_s x Set_q x iters 12/6 on the CNN's "
              f"8 leaves over C = {', '.join(map(str, self.channel_cs))}; "
              f"bf16 at C = 8; a ragged list of {len(plan)} launches with a "
              f"140,001-value row of ties): outputs bit-identical to the "
              f"plain version (tolerance: exact); 2 launches per "
              f"application for the CNN; in the {wire_checked[0]} cases at "
              f"p_q <= 8 also with the wire (int8 levels and f32 scales "
              f"per row, the federated round's compress_delta), "
              f"bit-identical to the plain version's")
        self.kernels["topk_quant"].update(channel_checked_cases=checked,
                                          channel_max_abs_err=worst,
                                          channel_wire_cases=wire_checked[0])

    # -- phase 12 -----------------------------------------------------------
    def full_setup(self):
        """The paper's fleet (data, partitions, seeded weights) on the
        device, made once for phases 12 and 14."""
        from repro_torch.fl.protocols import make_setup
        if self._full is None:
            n_dev, n_train, n_test = self.fleet
            t0 = time.perf_counter()
            self._full = make_setup(n_devices=n_dev, iid=True, seed=0,
                                    n_train=n_train, n_test=n_test,
                                    device=self.dev)
            print(f"   setup: {n_dev} devices, {n_train}/{n_test} samples "
                  f"({time.perf_counter() - t0:.1f} s)")
        return self._full

    def cohort_path(self):
        np, torch = self.np, self.torch
        from repro_torch.core.dynamic import CompressionSchedule
        from repro_torch.fl import engine as E
        from repro_torch.fl.protocols import make_sim
        from repro_torch.fl.simulator import SimConfig
        from repro_torch.kernels.ops import threshold_channel_leaves
        data, parts, w0 = self.full_setup()
        n_dev = len(parts)
        sched = CompressionSchedule(p_s0_idx=4, p_q0_idx=3, step_size=2)
        cfg = SimConfig(method="teasq", n_devices=n_dev, c_fraction=0.1,
                        mu=0.01, alpha=0.6, seed=0, codec="packed",
                        cohort_size=8, schedule=sched)
        sim = make_sim(data, parts, w0, cfg, device=self.dev)
        self.sync()
        self.zero_counts()
        t0 = time.perf_counter()
        hist = sim.run(time_budget=1e9, max_rounds=8)
        self.sync()
        wall = time.perf_counter() - t0
        launches = self.read_counts()
        st, rounds = sim.stats, hist[-1].round
        b = launches["topk_quant"]
        print(f"   launches inside sim.run: {launches}")
        print(f"   rounds: {rounds}, dispatches {st.dispatches}, completions "
              f"{st.completions}; flushes {st.flushes}, flushed tasks "
              f"{st.flushed_tasks}; kernel B {b} launches, "
              f"{b / max(st.flushes, 1):.2f} per flush")
        print("   schedule over the rounds: " + ", ".join(
            f"r{t}={sched.at_round(t)}" for t in range(rounds)))
        print("   accuracy curve: " + ", ".join(
            f"r{e.round}@{e.time:.3f}s={e.accuracy:.4f}" for e in hist))
        print(f"   metered bytes: up {sim.channel.bytes_up}, down "
              f"{sim.channel.bytes_down}")
        print(f"   wall: {wall:.3f} s, {wall / max(rounds, 1):.4f} s per "
              f"round [{self.card()}]")
        self.expect(rounds >= 8, f"only {rounds} aggregation rounds")
        self.expect(b > 0, "kernel B did not run inside sim.run")
        self.expect(4 * st.flushes <= b <= 8 * st.flushes,
                    f"{b} launches of kernel B for {st.flushes} flushes "
                    f"(2 down and 2 up per flush group)")
        self.expect(all(math.isfinite(e.accuracy) and 0 <= e.accuracy <= 1
                        for e in hist), "accuracy not finite in [0, 1]")
        w = sim.server.w
        self.expect(all(bool(torch.isfinite(v).all()) for v in w.values()),
                    "trained weights not finite")
        self.kernels["topk_quant"].update(
            channel_launches_in_sim_run=b, cohort_flushes=st.flushes,
            channel_launches_per_flush=b / max(st.flushes, 1),
            cohort_wall_s_per_round=wall / max(rounds, 1))
        # one flush of a full cohort, timed: 8 devices from the trained
        # model, 2 epochs of 15 steps padded to 32, at (0.25, 8)
        tr = sim.trainer
        names = sorted(w)
        wv = {k: w[k][None] for k in names}
        rng = np.random.RandomState(5)
        n_k, bs = len(parts[0]), cfg.batch_size
        steps = n_k // bs
        bidx = np.zeros((32, 8, bs), np.int64)
        valid = np.zeros((32, 8), np.float32)
        for i in range(8):
            rows = [rng.permutation(n_k)[s * bs:(s + 1) * bs]
                    for _ in range(cfg.epochs) for s in range(steps)]
            bidx[:len(rows), i] = rows
            valid[:len(rows), i] = 1.0
        dev = self.dev
        args = (wv, torch.zeros(8, dtype=torch.int64, device=dev), tr.xs,
                tr.ys, torch.arange(8, device=dev),
                torch.from_numpy(bidx).to(dev),
                torch.from_numpy(valid).to(dev))

        def flush(p_s, p_q):
            return E._cohort_round(*args, cohort_loss=sim.task.cohort_loss,
                                   lr=cfg.lr, mu=cfg.mu, p_s=p_s, p_q=p_q,
                                   iters=12)

        flush(0.25, 8)
        whole, up = self.timed(lambda: flush(0.25, 8), 5)
        train, _ = self.timed(lambda: flush(1.0, 32), 5)
        ups = [up[k] for k in names]
        down_in = [wv[k] for k in names]
        chan, _ = self.timed(lambda: (
            threshold_channel_leaves(down_in, 0.25, 8, 12),
            threshold_channel_leaves(ups, 0.25, 8, 12)), 20)
        print(f"   one flush of 8 devices (32 steps, (0.25, 8)): "
              f"{whole:.2f} ms of wall, of which training alone "
              f"{train:.2f} ms and the channel (down for 1 version, up for "
              f"8 devices: 4 launches) {chan:.3f} ms (host clock, "
              f"synchronized) [{self.card()}]")
        self.kernels["topk_quant"].update(flush_wall_ms=whole,
                                          flush_train_ms=train,
                                          flush_channel_ms=chan)
        self.cohort_up = ups

    # -- phase 13 -----------------------------------------------------------
    def cohort_card_vs_cpu(self):
        n, rounds, d = self.compare_with_cpu("teasq", cohort_size=4,
                                             codec="packed")
        print(f"   cohort_size=4: {n} entries, {rounds} rounds: time, round "
              f"and byte columns equal; max |accuracy diff| {d:.4f} "
              f"(tolerance {ACC_TOL})")

    # -- phase 14 -----------------------------------------------------------
    def protocols(self):
        torch = self.torch
        from repro_torch.fl.protocols import make_sim
        from repro_torch.fl.simulator import SimConfig
        data, parts, w0 = self.full_setup()
        for method in ("fedasync", "port", "asofed", "fedavg", "moon"):
            cfg = SimConfig(method=method, n_devices=len(parts), seed=0)
            sim = make_sim(data, parts, w0, cfg, device=self.dev)
            t0 = time.perf_counter()
            hist = sim.run(time_budget=1e9, max_rounds=3)
            self.sync()
            wall = time.perf_counter() - t0
            self.expect(hist[-1].round == 3, f"{method}: {hist[-1].round} "
                        f"rounds")
            self.expect(all(math.isfinite(e.accuracy)
                            and 0 <= e.accuracy <= 1 for e in hist),
                        f"{method}: accuracy not finite in [0, 1]")
            self.expect(all(bool(torch.isfinite(v).all())
                            for v in sim.server.w.values()),
                        f"{method}: weights not finite")
            n, rounds, d = self.compare_with_cpu(method)
            print(f"   {method}: {len(parts)} devices, 3 rounds in "
                  f"{wall:.3f} s, accuracy {hist[-1].accuracy:.4f}; card "
                  f"against CPU at 8 devices: {n} entries, {rounds} rounds, "
                  f"columns equal, max |accuracy diff| {d:.4f}")
        n, rounds, d = self.compare_with_cpu("fedavg", cohort_size=4)
        print(f"   fedavg with cohort_size=4 (the serial fallback): {n} "
              f"entries, columns equal, max |accuracy diff| {d:.4f}")

    # -- phase 15 -----------------------------------------------------------
    def timings_channel(self):
        from repro_torch.kernels import topk_quant as B
        from repro_torch.kernels.ops import threshold_channel_leaves
        xs = getattr(self, "cohort_up", None) or self.cnn_stack(8, 50)
        n = sum(x.numel() for x in xs)
        run = lambda: threshold_channel_leaves(xs, 0.25, 8, 12)  # noqa: E731
        before = B.LAUNCHES
        run()
        per_call = B.LAUNCHES - before
        ms = time_cuda(run)
        dev_ms = kernel_device_ms(run, "topk_quant") * per_call
        plain = time_cuda(lambda: B.threshold_channel_plain(xs, 0.25, 8, 12),
                          iters=10)
        # each value read once and its dequantized value written once; 12
        # bisection steps and 5 operations of quantization per value
        nbytes = 8 * n
        nops = (12 + 5) * n
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        t_ops = nops / PEAK_F32_OPS_PER_S * 1e3
        bound = max(t_bytes, t_ops)
        self.kernels["topk_quant"].update(
            channel_ms=ms, channel_device_ms=dev_ms, channel_plain_ms=plain,
            channel_bound_ms=bound,
            channel_bound_by="bytes" if t_bytes >= t_ops else "operations",
            channel_bytes=nbytes, channel_operations=nops,
            channel_launches_per_call=per_call)
        print(f"   threshold channel, up shape of a full cohort (8 x "
              f"{n // 8} values, (0.25, 8, 12), {per_call} launches): "
              f"{ms * 1e3:.2f} us per application (events over 50), "
              f"{dev_ms * 1e3:.2f} us on the card (profiler), plain "
              f"{plain * 1e3:.1f} us; bound {bound * 1e3:.3f} us ({nbytes} "
              f"bytes, {nops} ops) [{self.card()}]")
        print("   No single PyTorch call computes this function: "
              "library_ms is null.")

    # -- phase 16 -----------------------------------------------------------
    def batched_vs_heap(self):
        from repro_torch.fl.protocols import make_sim
        from repro_torch.fl.simulator import SimConfig
        data, parts, w0 = self.full_setup()
        hists, walls = {}, {}
        for scheduler in ("heap", "batched"):
            cfg = SimConfig(method="teasq", n_devices=len(parts),
                            c_fraction=0.1, mu=0.01, alpha=0.6, p_s=0.25,
                            p_q=8, seed=0, codec="packed", cohort_size=8,
                            scheduler=scheduler, handler_mode="serial")
            sim = make_sim(data, parts, w0, cfg, device=self.dev)
            t0 = time.perf_counter()
            hists[scheduler] = sim.run(time_budget=1e9, max_rounds=3)
            self.sync()
            walls[scheduler] = time.perf_counter() - t0
        hh, hb = hists["heap"], hists["batched"]
        self.expect(len(hh) == len(hb), f"{len(hh)} vs {len(hb)} entries")
        for a, b in zip(hh, hb):
            for c in ("time", "round", "bytes_up", "bytes_down",
                      "max_model_bytes_up", "max_model_bytes_down"):
                self.expect(getattr(a, c) == getattr(b, c),
                            f"{c}: heap {getattr(a, c)} vs batched "
                            f"{getattr(b, c)}")
        d = max(abs(a.accuracy - b.accuracy) for a, b in zip(hh, hb))
        self.expect(d <= BATCHED_ACC_TOL, f"accuracy differs by {d}")
        self.expect(hb[-1].round == 3, f"{hb[-1].round} rounds")
        print(f"   {len(parts)} devices, cohort 8, 3 rounds: heap "
              f"{walls['heap']:.3f} s, batched {walls['batched']:.3f} s of "
              f"wall; {len(hh)} entries, time, round and byte columns "
              f"equal, max |accuracy diff| {d:.2e} (tolerance "
              f"{BATCHED_ACC_TOL}) [{self.card()}]")

    # -- phases 17 and 18 ---------------------------------------------------
    def wave_run(self, key, n_dev, n_train, cohort, step, wall_cap):
        """TEASQ in wave mode at ``benchmarks/engine_scale.py``'s
        ``scale_config`` settings, run in steps of ``step`` virtual seconds
        through three windows of wall: two thirds of ``wall_cap`` with
        nothing instrumented (every launch counter set to 0 before and read
        after: ms per task, rounds, B's launches); a third with the
        flushes, the channel, the aggregations and the evaluations timed
        on a host clock synchronized around each (the layers' shares; the
        inputs of the largest channel call and of the largest
        ``_zero_step_round`` kept); then one step under the profiler (the
        device's busy share).  The kept inputs then go through kernel B's
        channel form and its plain version: bit-identical, or the phase
        fails."""
        np, torch = self.np, self.torch
        from repro_torch.core.latency import WirelessConfig
        from repro_torch.fl import engine as E
        from repro_torch.fl.protocols import make_setup, make_sim
        from repro_torch.fl.simulator import SimConfig
        t0 = time.perf_counter()
        data, parts, w0 = make_setup(n_devices=n_dev, iid=True, seed=0,
                                     n_train=n_train, n_test=1000,
                                     device=self.dev)
        cfg = SimConfig(method="teasq", n_devices=n_dev, c_fraction=0.1,
                        gamma=10.0 / n_dev, epochs=1, batch_size=8,
                        p_s=0.25, p_q=8, seed=0,
                        wireless=WirelessConfig(bandwidth_hz=2e5),
                        cohort_size=cohort, cohort_channel_iters=6,
                        scheduler="batched", handler_mode="wave")
        sim = make_sim(data, parts, w0, cfg, device=self.dev)
        print(f"   setup: {n_dev} devices, {n_train} samples "
              f"({n_train // n_dev} each), cohort {cohort} "
              f"({time.perf_counter() - t0:.1f} s)")
        budget = 0.0

        def window(cap):
            """Steps of ``step`` virtual s until ``cap`` s of wall: the
            wall, the tasks completed and the last history."""
            nonlocal budget
            done0 = sim.stats.completions
            self.sync()
            t = time.perf_counter()
            while time.perf_counter() - t < cap:
                budget += step
                hist = sim.run(time_budget=budget, eval_every=10 ** 9)
                self.sync()
            return (time.perf_counter() - t, sim.stats.completions - done0,
                    hist)

        # 1. counted, nothing instrumented
        self.zero_counts()
        wall, tasks, hist = window(wall_cap * 2 / 3)
        launches = self.read_counts()
        st, last = sim.stats, hist[-1]
        rounds, flushes, counted_budget = last.round, st.flushes, budget
        b = launches["topk_quant"]
        print(f"   counted window, nothing instrumented: virtual budget "
              f"{budget:.2f} s (steps of {step} s until "
              f"{wall_cap * 2 / 3:.1f} s of wall): wall {wall:.3f} s, tasks "
              f"{tasks}, {wall * 1e3 / max(tasks, 1):.4f} ms per task, "
              f"rounds {rounds}, dispatches {st.dispatches}, flushes "
              f"{flushes} ({st.flushed_tasks} tasks) [{self.card()}]")
        print(f"   launches inside sim.run: {launches}; kernel B "
              f"{b / max(flushes, 1):.2f} per flush")

        # 2. instrumented: the layers' shares, and the channel's inputs
        spent = {"flush": 0.0, "channel": 0.0, "aggregate": 0.0, "eval": 0.0}
        kept = {}
        flush, channel, zero = sim.trainer.flush, E._channel, \
            E._zero_step_round
        srv = sim.server

        def timed(fn, what):
            def call(*a, **k):
                self.sync()
                t = time.perf_counter()
                out = fn(*a, **k)
                self.sync()
                spent[what] += time.perf_counter() - t
                return out
            return call

        def keep(fn, what):
            # the inputs of the call with the most rows, cloned before the
            # call (outside the channel's timing)
            def call(tree, *a, **k):
                rows = next(iter(tree.values())).shape[0]
                if rows > kept.get(what, (0,))[0]:
                    kept[what] = (rows, {n: v.clone() for n, v in
                                         tree.items()}, a, k)
                return fn(tree, *a, **k)
            return call

        # a wave aggregates in the stacked form, a lone arrival in the
        # sequential one
        sim.trainer.flush = timed(flush, "flush")
        srv._aggregate = timed(srv._aggregate, "aggregate")
        srv._aggregate_stacked = timed(srv._aggregate_stacked, "aggregate")
        sim.evaluate = timed(sim.evaluate, "eval")   # the tail log of a run
        E._channel = keep(timed(channel, "channel"), "channel")
        E._zero_step_round = keep(zero, "zero_step")
        try:
            wall_i, tasks_i, _ = window(wall_cap / 3)
        finally:
            # back to the untimed functions (instance attributes shadowed
            # the class's)
            E._channel, E._zero_step_round = channel, zero
            del sim.trainer.flush, sim.evaluate
            del srv._aggregate, srv._aggregate_stacked
        rest = 1 - (spent["flush"] + spent["aggregate"]
                    + spent["eval"]) / wall_i
        print(f"   instrumented window (host clock synchronized around each "
              f"flush, channel call, aggregation and evaluation): wall "
              f"{wall_i:.3f} s, tasks {tasks_i}, "
              f"{wall_i * 1e3 / max(tasks_i, 1):.4f} ms per task; flushes "
              f"{spent['flush']:.3f} s ({100 * spent['flush'] / wall_i:.1f}%"
              f" of the wall), of which the channel {spent['channel']:.3f} s"
              f" ({100 * spent['channel'] / wall_i:.1f}%); the Eqs. 6-10 "
              f"aggregations {spent['aggregate']:.3f} s "
              f"({100 * spent['aggregate'] / wall_i:.1f}%); the evaluations "
              f"{spent['eval']:.3f} s; the rest, the event loop on the host, "
              f"{100 * rest:.1f}% [{self.card()}]")
        print(f"   accuracy {last.accuracy:.4f} after the counted window, "
              f"metered bytes up {last.bytes_up}, down {last.bytes_down}")

        # 3. one more step, profiled
        busy = self.device_busy(lambda: sim.run(time_budget=budget + step,
                                                eval_every=10 ** 9))
        if busy is not None:
            print(f"   one more step of {step} virtual s under the profiler: "
                  f"the device busy {100 * busy:.1f}% of its wall (kernel "
                  f"time over wall; the profiler slows the host, so the "
                  f"busy share is a lower bound)")

        # the kept inputs against the plain version, exactly
        rows = self.wave_channel_check(kept)
        print(f"   kernel B's channel form on the run's own inputs "
              f"({', '.join(f'{w}: {r} rows' for w, r in rows.items())}): "
              f"bit-identical to the plain version (tolerance: exact)")
        self.expect(b > 0, "kernel B did not run inside sim.run")
        self.expect(rounds >= 1 and tasks > 0, f"{rounds} rounds, {tasks} "
                    f"tasks")
        self.expect(math.isfinite(last.accuracy)
                    and 0 <= last.accuracy <= 1, "accuracy not finite")
        self.expect(all(bool(torch.isfinite(v).all())
                        for v in sim.server.w.values()),
                    "weights not finite")
        self.kernels["topk_quant"].update({
            f"{key}_launches_in_sim_run": b,
            f"{key}_virtual_budget_s": counted_budget, f"{key}_wall_s": wall,
            f"{key}_tasks": tasks,
            f"{key}_ms_per_task": wall * 1e3 / max(tasks, 1),
            f"{key}_rounds": rounds, f"{key}_flushes": flushes,
            f"{key}_instrumented_ms_per_task": wall_i * 1e3 / max(tasks_i, 1),
            f"{key}_flush_share": spent["flush"] / wall_i,
            f"{key}_channel_share": spent["channel"] / wall_i,
            f"{key}_aggregate_share": spent["aggregate"] / wall_i,
            f"{key}_event_loop_share": rest,
            f"{key}_device_busy_share_profiled": busy,
            **{f"{key}_{w}_checked_rows": r for w, r in rows.items()}})
        return flushes

    def wave_channel_check(self, kept):
        """The inputs a wave run gave the channel (``kept["channel"]``)
        and ``_zero_step_round`` (``kept["zero_step"]``, where the run took
        it) through kernel B's channel form, against its plain version
        (once, and twice for the zero-step round): bit-identical.  Returns
        the rows checked of each."""
        torch = self.torch
        from repro_torch.fl import engine as E
        from repro_torch.kernels import topk_quant as B
        self.expect("channel" in kept, "the run made no channel call")
        out = {}
        for what, (rows, tree, a, k) in kept.items():
            names = sorted(tree)
            leaves = [tree[n] for n in names]
            p_s, p_q, iters = (list(a) + [k[n] for n in ("p_s", "p_q",
                                                        "iters") if n in k])
            want = B.threshold_channel_plain(leaves, p_s, p_q, iters)
            if what == "zero_step":
                want = B.threshold_channel_plain(want, p_s, p_q, iters)
                got = E._zero_step_round(tree, p_s=p_s, p_q=p_q,
                                         iters=iters)
            else:
                got = E._channel(tree, p_s, p_q, iters)
            for n, w in zip(names, want):
                g = got[n]
                view = torch.int16 if g.dtype == torch.bfloat16 else \
                    torch.int32
                self.expect(g.shape == w.shape and g.dtype == w.dtype
                            and torch.equal(g.view(view), w.view(view)),
                            f"{what} leaf {n} at {rows} rows differs from "
                            f"the plain version")
            out[what] = rows
        return out

    def device_busy(self, fn):
        """The share of ``fn``'s wall in which the card runs a kernel
        (torch.profiler's device time over the wall of the profiled call);
        None off the card."""
        torch = self.torch
        if self.dev.type != "cuda":
            return None
        from torch.profiler import ProfilerActivity, profile
        self.sync()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            self.sync()
            wall = time.perf_counter() - t0
        busy = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
        return busy / 1e6 / wall

    def wave_dispatch(self):
        n_dev = self.wave_fleet
        flushes = self.wave_run("wave_dispatch", n_dev, n_dev, 256, 0.25,
                                self.wave_walls[0])
        self.expect(flushes > 0, "no cohort flush")

    def wave_steps(self):
        n_dev = self.wave_fleet // 100
        self.wave_run("wave_steps", n_dev, 12 * n_dev, 32, 1.0,
                      self.wave_walls[1])

    # -- phase 19 -----------------------------------------------------------
    def wave_card_vs_cpu(self):
        from repro_torch.fl.protocols import make_setup, make_sim
        from repro_torch.fl.simulator import SimConfig
        from repro_torch.utils.tree import to_numpy
        n = 64
        data, parts, w0 = make_setup(n_devices=n, iid=True, seed=0,
                                     n_train=16 * n, n_test=320,
                                     device="cpu")
        w_np = to_numpy(w0)
        runs = {}
        for dev in (self.dev.type, "cpu"):
            _, _, w = make_setup(n_devices=n, iid=True, seed=0,
                                 n_train=16 * n, n_test=320, device=dev,
                                 init_params=w_np)
            cfg = SimConfig(method="teasq", n_devices=n, c_fraction=0.1,
                            epochs=1, batch_size=8, p_s=0.25, p_q=8, seed=0,
                            codec="packed", cohort_size=8,
                            cohort_channel_iters=6, scheduler="batched",
                            handler_mode="wave")
            sim = make_sim(data, parts, w, cfg, device=dev)
            runs[dev] = (sim, sim.run(time_budget=4.0, eval_every=1))
        (sc, hc), (sp, hp) = runs[self.dev.type], runs["cpu"]
        self.expect(len(hc) == len(hp), f"{len(hc)} vs {len(hp)} entries")
        for a, b in zip(hc, hp):
            for c in ("time", "round", "bytes_up", "bytes_down",
                      "max_model_bytes_up", "max_model_bytes_down"):
                self.expect(getattr(a, c) == getattr(b, c),
                            f"{c}: {getattr(a, c)} vs {getattr(b, c)}")
        for f in ("dispatches", "completions", "dropouts",
                  "transient_failures", "redispatched", "flushes",
                  "flushed_tasks"):
            self.expect(getattr(sc.stats, f) == getattr(sp.stats, f),
                        f"stats.{f}: {getattr(sc.stats, f)} vs "
                        f"{getattr(sp.stats, f)}")
        self.expect(bool((sc.stats.completed_per_device
                          == sp.stats.completed_per_device).all()),
                    "completed_per_device differs")
        d = max(abs(a.accuracy - b.accuracy) for a, b in zip(hc, hp))
        self.expect(d <= ACC_TOL, f"accuracy differs by {d} > {ACC_TOL}")
        print(f"   {n} devices, gate of {sc.server.cfg.max_parallel}, "
              f"cohort 8: {len(hc)} entries, {hc[-1].round} rounds, "
              f"{sc.stats.flushes} flushes; time, round and byte columns "
              f"and stats equal; max |accuracy diff| {d:.4f} (tolerance "
              f"{ACC_TOL})")


    # -- phase 20 -----------------------------------------------------------
    def fleet_config(self, n_dev):
        """The two jobs of phases 20-22 on one fleet of ``n_dev`` devices:
        TEASQ on the CNN with the cohort trainer (8, (0.25, 8), the packed
        wire) and dense fedasync on the MLP (serial trainer), batched
        scheduler in wave mode, adaptive assigner."""
        from repro_torch.fl.fleet import FleetConfig
        from repro_torch.fl.simulator import SimConfig
        common = dict(n_devices=n_dev, c_fraction=0.1, mu=0.01, alpha=0.6,
                      seed=0)
        return FleetConfig(
            tasks=[SimConfig(method="teasq", task="fmnist_cnn", p_s=0.25,
                             p_q=8, codec="packed", cohort_size=8,
                             **common),
                   SimConfig(method="fedasync", task="fmnist_mlp", p_s=1.0,
                             p_q=32, **common)],
            n_devices=n_dev, seed=0, scheduler="batched",
            handler_mode="wave", assigner="adaptive")

    def fleet_path(self):
        torch = self.torch
        from repro_torch.fl import engine as E
        from repro_torch.fl.fleet import build_fleet
        n_dev, n_train, n_test = self.fleet
        cfg = self.fleet_config(n_dev)
        t0 = time.perf_counter()
        fleet = build_fleet(cfg, n_train=n_train, n_test=n_test,
                            device=self.dev)
        w0s = [{k: v.clone() for k, v in rt.server.w.items()}
               for rt in fleet.runtimes]
        print(f"   setup: {n_dev} devices, {n_train}/{n_test} samples per "
              f"job, jobs {[c.task for c in cfg.tasks]} "
              f"({time.perf_counter() - t0:.1f} s)")
        # the inputs of the run's channel call with the most rows, cloned
        # on the device (no launch) for the check after the run
        kept, channel = {}, E._channel

        def keep(tree, *a, **k):
            rows = next(iter(tree.values())).shape[0]
            if rows > kept.get("channel", (0,))[0]:
                kept["channel"] = (rows, {n: v.clone() for n, v in
                                          tree.items()}, a, k)
            return channel(tree, *a, **k)

        E._channel = keep
        try:
            self.sync()
            self.zero_counts()
            t0 = time.perf_counter()
            hists = fleet.run(time_budget=1e9, max_rounds=5)
            self.sync()
            wall = time.perf_counter() - t0
            launches = self.read_counts()
        finally:
            E._channel = channel
        self._fleet_run = (cfg, w0s, fleet, hists)
        b = launches["topk_quant"]
        tasks = sum(rt.stats.completions for rt in fleet.runtimes)
        flushes = fleet.runtimes[0].stats.flushes
        for j, (rt, h) in enumerate(zip(fleet.runtimes, hists)):
            print(f"   job {j} ({rt.cfg.method} on {rt.cfg.task}): rounds "
                  f"{h[-1].round}, completions {rt.stats.completions}, "
                  f"dispatches {rt.stats.dispatches}, flushes "
                  f"{rt.stats.flushes}; {wall / max(h[-1].round, 1):.4f} s "
                  f"of the fleet's wall per round; accuracy "
                  f"{h[-1].accuracy:.4f}, bytes up {h[-1].bytes_up}")
        print(f"   fleet: wall {wall:.3f} s to virtual "
              f"{max(h[-1].time for h in hists):.3f} s, {tasks} tasks, "
              f"{wall * 1e3 / max(tasks, 1):.3f} ms per task; launches "
              f"inside MultiTaskEngine.run: {launches}; kernel B "
              f"{b / max(flushes, 1):.2f} per flush [{self.card()}]")
        rows = self.wave_channel_check(kept)
        print(f"   kernel B's channel form on the run's largest channel "
              f"input ({rows['channel']} rows): bit-identical to the plain "
              f"version (tolerance: exact)")
        self.expect(b > 0, "kernel B did not run inside MultiTaskEngine.run")
        self.expect(4 * flushes <= b <= 8 * flushes,
                    f"{b} launches of kernel B for {flushes} flushes (2 "
                    f"down and 2 up per flush group)")
        self.expect(all(h[-1].round >= 5 for h in hists),
                    f"rounds {[h[-1].round for h in hists]}, not 5 each")
        self.expect(all(math.isfinite(e.accuracy) and 0 <= e.accuracy <= 1
                        for h in hists for e in h),
                    "accuracy not finite in [0, 1]")
        self.expect(all(bool(torch.isfinite(v).all()) for rt in
                        fleet.runtimes for v in rt.server.w.values()),
                    "weights not finite")
        self.kernels["topk_quant"].update(
            fleet_launches_in_run=b, fleet_flushes=flushes,
            fleet_wall_s=wall, fleet_tasks=tasks,
            fleet_ms_per_task=wall * 1e3 / max(tasks, 1),
            fleet_wall_s_per_round=[wall / max(h[-1].round, 1)
                                    for h in hists],
            fleet_checked_rows=rows["channel"])

    # -- phase 21 -----------------------------------------------------------
    def resumed(self, make, cut, tmp, name):
        """``make()`` run with the arguments ``cut``, its ``state_dict``
        through ``save_blob`` into the directory ``tmp``, and a fresh
        ``make()`` restored from that file: (the never-serialized one, the
        restored one, the file's path)."""
        from repro_torch.checkpoint.io import load_blob, save_blob
        a = make()
        a.run(**cut)
        path = os.path.join(tmp, name)
        save_blob(path, a.state_dict())
        b = make()
        b.load_state(load_blob(path))
        return a, b, path

    def same_runs(self, what, a, b, ha, hb):
        """The time, round and byte columns, ``stats`` and the pending
        events equal; accuracy within ``BATCHED_ACC_TOL``.  Returns the
        largest |weight difference| and |accuracy difference|."""
        torch = self.torch
        self.expect(len(ha) == len(hb), f"{what}: {len(ha)} vs {len(hb)} "
                    f"entries")
        for x, y in zip(ha, hb):
            for c in COLUMNS:
                self.expect(getattr(x, c) == getattr(y, c),
                            f"{what} {c}: {getattr(x, c)} vs "
                            f"{getattr(y, c)}")
        for f in STATS:
            self.expect(getattr(a.stats, f) == getattr(b.stats, f),
                        f"{what} stats.{f}: {getattr(a.stats, f)} vs "
                        f"{getattr(b.stats, f)}")
        self.expect(bool((a.stats.completed_per_device
                          == b.stats.completed_per_device).all()),
                    f"{what}: completed_per_device differs")
        dw = max(float((a.server.w[k] - b.server.w[k]).abs().max())
                 for k in a.server.w)
        da = max(abs(x.accuracy - y.accuracy) for x, y in zip(ha, hb))
        self.expect(da <= BATCHED_ACC_TOL, f"{what}: accuracy differs by "
                    f"{da} > {BATCHED_ACC_TOL}")
        self.expect(all(bool(torch.isfinite(v).all())
                        for v in b.server.w.values()),
                    f"{what}: weights not finite")
        return dw, da

    def checkpoint_resume(self):
        import tempfile
        torch = self.torch
        from repro_torch.checkpoint.io import load_sim_params
        from repro_torch.core.dynamic import CompressionSchedule
        from repro_torch.fl.fleet import MultiTaskEngine
        from repro_torch.fl.protocols import make_sim
        from repro_torch.fl.simulator import SimConfig
        with tempfile.TemporaryDirectory() as tmp:
            # (a) phase 12's cohort engine on the heap scheduler, cut at 4
            # of its 8 rounds
            data, parts, w0 = self.full_setup()
            sched = CompressionSchedule(p_s0_idx=4, p_q0_idx=3, step_size=2)
            cfg = SimConfig(method="teasq", n_devices=len(parts),
                            c_fraction=0.1, mu=0.01, alpha=0.6, seed=0,
                            codec="packed", cohort_size=8, schedule=sched)
            t0 = time.perf_counter()
            a, b, path = self.resumed(
                lambda: make_sim(data, parts, w0, cfg, device=self.dev),
                dict(time_budget=1e9, max_rounds=4), tmp, "engine.msgpack")
            size = os.path.getsize(path)
            pend = len(b.trainer.pending)
            ha = a.run(time_budget=1e9, max_rounds=8)
            hb = b.run(time_budget=1e9, max_rounds=8)
            self.sync()
            dw, da = self.same_runs("engine", a, b, ha, hb)
            self.expect(pending_events(a) == pending_events(b),
                        "engine: pending events differ")
            self.expect(hb[-1].round >= 8, f"{hb[-1].round} rounds")
            print(f"   engine (phase 12's, heap, cohort 8): cut at round 4 "
                  f"({size} bytes, {pend} tasks in the cohort buffer), "
                  f"restored and run beside the never-serialized engine to "
                  f"round {hb[-1].round} ({time.perf_counter() - t0:.1f} s):"
                  f" {len(hb)} entries, time, round and byte columns, "
                  f"stats and pending events equal; largest |weight diff| "
                  f"{dw:.3e} ({'bit-identical' if dw == 0 else 'not bit-identical'}"
                  f"), max |accuracy diff| {da:.2e} (tolerance "
                  f"{BATCHED_ACC_TOL}) [{self.card()}]")
            self.kernels["topk_quant"].update(resume_engine_max_weight_diff=dw)
            # (b) phase 20's fleet, cut at half its virtual time
            cfg, w0s, fleet, hists = self._fleet_run
            datas = [rt.data for rt in fleet.runtimes]
            parts = [rt.partitions for rt in fleet.runtimes]
            half = max(h[-1].time for h in hists) / 2
            t0 = time.perf_counter()
            a, b, path = self.resumed(
                lambda: MultiTaskEngine(datas, parts, w0s, cfg,
                                        device=self.dev),
                dict(time_budget=half, max_rounds=5), tmp, "fleet.msgpack")
            cut_rounds = [rt.server.t for rt in a.runtimes]
            for j, rt in enumerate(a.runtimes):
                got = load_sim_params(path, rt.server.w, task=j,
                                      device="cpu")
                self.expect(all(torch.equal(got[k], v.cpu())
                                for k, v in rt.server.w.items()),
                            f"load_sim_params of job {j} differs from its "
                            f"weights at the cut")
            has = a.run(time_budget=1e9, max_rounds=5)
            hbs = b.run(time_budget=1e9, max_rounds=5)
            self.sync()
            diffs = [self.same_runs(f"fleet job {j}", ra, rb, ha, hb)
                     for j, (ra, rb, ha, hb) in enumerate(zip(
                         a.runtimes, b.runtimes, has, hbs))]
            self.expect(pending_events(a) == pending_events(b),
                        "fleet: pending events differ")
            dw = max(d[0] for d in diffs)
            print(f"   fleet (phase 20's): cut at virtual {half:.3f} s "
                  f"(rounds {cut_rounds}, {os.path.getsize(path)} bytes), "
                  f"restored and run beside the never-serialized fleet to "
                  f"rounds {[h[-1].round for h in hbs]} "
                  f"({time.perf_counter() - t0:.1f} s): columns, stats and "
                  f"pending events equal; largest |weight diff| {dw:.3e} "
                  f"({'bit-identical' if dw == 0 else 'not bit-identical'}),"
                  f" max |accuracy diff| {max(d[1] for d in diffs):.2e}; "
                  f"load_sim_params(task=j, device='cpu') equals each job's "
                  f"weights at the cut, bit for bit [{self.card()}]")
            self.kernels["topk_quant"].update(resume_fleet_max_weight_diff=dw)

    # -- phase 22 -----------------------------------------------------------
    def fleet_card_vs_cpu(self):
        from repro_torch.fl.fleet import build_fleet
        from repro_torch.utils.tree import to_numpy
        n = 12
        cfg = self.fleet_config(n)
        cpu = build_fleet(cfg, n_train=640, n_test=320, device="cpu")
        w_np = [to_numpy(rt.server.w) for rt in cpu.runtimes]
        card = build_fleet(cfg, n_train=640, n_test=320, device=self.dev,
                           init_params=w_np)
        hc = card.run(time_budget=4.0)
        hp = cpu.run(time_budget=4.0)
        worst = 0.0
        for j, (rc, rp, a_h, b_h) in enumerate(zip(
                card.runtimes, cpu.runtimes, hc, hp)):
            self.expect(len(a_h) == len(b_h), f"job {j}: {len(a_h)} vs "
                        f"{len(b_h)} entries")
            for x, y in zip(a_h, b_h):
                for c in COLUMNS:
                    self.expect(getattr(x, c) == getattr(y, c),
                                f"job {j} {c}: {getattr(x, c)} vs "
                                f"{getattr(y, c)}")
            for f in STATS:
                self.expect(getattr(rc.stats, f) == getattr(rp.stats, f),
                            f"job {j} stats.{f}: {getattr(rc.stats, f)} vs "
                            f"{getattr(rp.stats, f)}")
            self.expect(bool((rc.stats.completed_per_device
                              == rp.stats.completed_per_device).all()),
                        f"job {j}: completed_per_device differs")
            worst = max(worst, max(abs(x.accuracy - y.accuracy)
                                   for x, y in zip(a_h, b_h)))
        self.expect(worst <= ACC_TOL, f"accuracy differs by {worst} > "
                    f"{ACC_TOL}")
        self.expect(pending_events(card) == pending_events(cpu),
                    "pending events differ")
        print(f"   {n} devices, two jobs in wave mode: "
              f"{[len(h) for h in hc]} entries, rounds "
              f"{[h[-1].round for h in hc]}, job 0 {card.runtimes[0].stats.flushes} "
              f"flushes; time, round and byte columns, stats and pending "
              f"events equal; max |accuracy diff| {worst:.4f} (tolerance "
              f"{ACC_TOL})")


    # -- phase 23 -----------------------------------------------------------
    def kernel_c_jamba(self):
        """Kernel C at the shape Jamba's prefill gives it: N = 16 and 128
        heads per (batch, chunk), G = batch x chunks x heads cells."""
        torch = self.torch
        from repro_torch.kernels import ssd_scan as K
        cfg, shp = self.jamba_cfg, self.jamba_shape
        H, L, P, N = (cfg.ssm_heads, min(cfg.ssm_chunk, shp["prompt_len"]),
                      cfg.ssm_head_dim, cfg.ssm_state)
        G = shp["batch"] * (shp["prompt_len"] // L) * H
        worst = 0.0
        for dtype in (torch.float32, torch.bfloat16):
            xb, b, c, cum = self.ssd_cells(G, H, L, P, N, 11, dtype)
            got = K.ssd_intra_chunk(xb, b, c, cum, heads=H)
            want = K.ssd_intra_chunk_plain(xb, b, c, cum, heads=H)
            for name, g, w in zip(("y", "S", "a"), got, want):
                where = f"{name} (G={G}, heads={H}, N={N}, {dtype})"
                self.expect(bool(torch.isfinite(g).all()),
                            f"kernel C {where} not finite")
                err = float((g - w).abs().max())
                worst = max(worst, err)
                self.expect(torch.allclose(g, w, atol=SSD_TOL_FULL,
                                           rtol=SSD_TOL_FULL),
                            f"kernel C {where}: max abs err {err}")
        print(f"   {cfg.name}'s prefill shape (batch {shp['batch']} x "
              f"{shp['prompt_len']} tokens: G={G}, {H} heads, L={L}, P={P}, "
              f"N={N}), b and c in f32 and bf16: y, S and a within "
              f"{SSD_TOL_FULL} (atol = rtol) of the plain version, max abs "
              f"err {worst:.3g}")
        if self.dev.type == "cuda":
            t = self.time_c(G, H, L, P, N, 12)
            self.kernels["ssd_scan"]["jamba_shape"] = {
                "G": G, "heads": H, "L": L, "P": P, "N": N,
                "max_abs_err": worst, **t}
            self.kernels["ssd_scan"]["max_abs_err"] = max(
                self.kernels["ssd_scan"].get("max_abs_err", 0.0), worst)

    # -- phase 24 -----------------------------------------------------------
    def serve_qwen(self):
        np, torch = self.np, self.torch
        from repro_torch.models import attention as A
        from repro_torch.models import transformer as T
        cfg, shp = self.qwen_cfg, self.qwen_shape
        params = self.init_lm(cfg)
        run = self.serve_window(params, cfg, shp)
        # no kernel of the port is on the attention path
        self.expect(not any(run["launches"].values()),
                    f"kernel launches on the attention path: "
                    f"{run['launches']}")
        # one long prompt: past the flash threshold, against the plain
        # branch on the same device
        n = shp["long_prompt"]
        toks = torch.as_tensor(np.random.RandomState(2).randint(
            0, cfg.vocab, (1, n)), device=self.dev)
        # every call of either branch is counted, so the plain run is
        # known to have taken the plain branch in each of its layers
        branches = {"flash": 0, "plain": 0}
        saved = {"flash": A._flash_attention, "plain": A._plain_attention}

        def counted(name):
            def call(*a, **k):
                branches[name] += 1
                return saved[name](*a, **k)
            return call

        forward = A.attn_forward
        A._flash_attention, A._plain_attention = (counted("flash"),
                                                  counted("plain"))
        try:
            with torch.no_grad():
                ms_flash, (flash, _) = self.timed(
                    lambda: T.prefill(params, {"tokens": toks}, cfg), 1)
                in_flash = dict(branches)
                branches.update(flash=0, plain=0)
                A.attn_forward = lambda *a, **k: forward(
                    *a, **dict(k, flash_threshold=1 << 30))
                ms_plain, (plain, _) = self.timed(
                    lambda: T.prefill(params, {"tokens": toks}, cfg), 1)
                in_plain = dict(branches)
        finally:
            A.attn_forward = forward
            A._flash_attention = saved["flash"]
            A._plain_attention = saved["plain"]
        L = cfg.n_layers
        self.expect(in_flash == {"flash": L, "plain": 0}
                    and in_plain == {"flash": 0, "plain": L},
                    f"attention branches taken: {in_flash} in the flash "
                    f"prefill, {in_plain} in the plain one; expected "
                    f"{L} flash calls, then {L} plain ones")
        err = float((flash - plain).abs().max())
        self.expect(bool(torch.isfinite(flash).all()),
                    "long prefill logits not finite")
        self.expect(err <= FLASH_TOL, f"flash prefill logits differ from "
                    f"the plain branch's by {err} > {FLASH_TOL}")
        print(f"   prefill of 1 x {n} tokens: flash branch {ms_flash:.2f} ms,"
              f" plain branch {ms_plain:.2f} ms (each in all {L} layers); "
              f"logits within {err:.3g} (tolerance {FLASH_TOL}) "
              f"[{self.card()}]")
        run.update(long_prefill_flash_ms=ms_flash,
                   long_prefill_plain_ms=ms_plain, flash_vs_plain=err)
        self.lm["qwen"] = run

    # -- phase 25 -----------------------------------------------------------
    def serve_jamba(self):
        np, torch = self.np, self.torch
        from repro_torch.launch.serve import generate
        from repro_torch.models import transformer as T
        cfg, shp = self.jamba_cfg, self.jamba_shape
        card = self.dev.type == "cuda"
        if card:       # the earlier phases' weights are gone by now
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        full = get_full(cfg)
        print(f"   cut in depth to one group of {cfg.n_layers} layers "
              f"({cfg.attn_every - 1} Mamba, 1 attention); the full model "
              f"has {full.n_layers} layers in groups of {full.attn_every}")
        params = self.init_lm(cfg)
        prompts = np.random.RandomState(3).randint(
            0, cfg.vocab, (shp["batch"], shp["prompt_len"]))
        S, gen = shp["prompt_len"], shp["gen"]
        self.zero_counts()
        t0 = time.perf_counter()
        seqs = generate(params, cfg, prompts, gen)
        self.sync()
        wall = time.perf_counter() - t0
        launches = self.read_counts()
        per_prefill = (cfg.attn_every - 1) * (cfg.n_layers // cfg.attn_every)
        print(f"   generate: {shp['batch']} prompts x {S} tokens, {gen} "
              f"tokens each, in {wall:.3f} s; launches {launches} "
              f"[{self.card()}]")
        self.expect(launches["ssd_scan"] == (per_prefill if card else 0)
                    and launches["fused_pack"] == 0
                    and launches["topk_quant"] == 0,
                    f"kernel C launches inside generate: {launches} "
                    f"(expected {per_prefill} on the card, one per Mamba "
                    f"layer of the prefill)")
        out = seqs[:, S:].tolist()
        self.expect(all(0 <= t < cfg.vocab for r in out for t in r),
                    "tokens out of the vocabulary")
        solo = [generate(params, cfg, p[None], gen)[0, S:].tolist()
                for p in prompts]
        flips = self.near_ties(params, cfg, list(prompts), out, solo,
                               what="batch row")
        # prefill and one decode step of the batch, timed apart
        toks = torch.as_tensor(prompts, device=self.dev)
        ms_prefill, (logits, cache) = self.timed(
            lambda: T.prefill(params, {"tokens": toks}, cfg), 2)
        cache = T.extend_cache(cache, S + gen)
        tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        ms_decode, (logits, _) = self.timed(
            lambda: T.decode_step(params, tok, S, cfg, cache), 5)
        self.expect(bool(torch.isfinite(logits).all()),
                    "decode logits not finite")
        print(f"   prefill {ms_prefill:.2f} ms ({shp['batch']} x {S} "
              f"tokens), decode {ms_decode:.2f} ms per step "
              f"({shp['batch']} rows) [{self.card()}]")
        busy = {}
        if card:
            for name, fn, wall_ms in (
                    ("prefill", lambda: T.prefill(params, {"tokens": toks},
                                                  cfg), ms_prefill),
                    ("decode step", lambda: T.decode_step(params, tok, S,
                                                          cfg, cache),
                     ms_decode)):
                busy[name] = self.device_time(name, fn, wall_ms)
            peak = torch.cuda.max_memory_allocated()
            print(f"   peak memory allocated {peak / 1e9:.2f} GB")
            self.kernels["ssd_scan"]["launches"] = \
                self.kernels["ssd_scan"].get("launches", 0) + \
                launches["ssd_scan"]
            self.kernels["ssd_scan"].setdefault("launches_by_path", {})[
                "jamba_generate"] = launches["ssd_scan"]
        else:
            peak = None
        self.lm["jamba"] = {"launches": launches, "generate_s": wall,
                            "prefill_ms": ms_prefill,
                            "decode_ms": ms_decode, "flips": flips,
                            "busy": busy, "peak_bytes": peak}
        del params, cache
        if card:
            torch.cuda.empty_cache()

    # -- phase 26 -----------------------------------------------------------
    def lm_card_vs_cpu(self):
        np, torch = self.np, self.torch
        from repro_torch.configs.base import get_smoke_config
        from repro_torch.launch.serve import ContinuousBatcher, generate
        from repro_torch.models import transformer as T
        from repro_torch.utils.tree import tree_map
        rng = np.random.RandomState(6)
        for arch in LM_ARCHS:
            cfg = get_smoke_config(arch)
            p_cpu = T.init_model(cfg, torch.Generator().manual_seed(5), "cpu")
            p_dev = tree_map(lambda a: a.to(self.dev), p_cpu)
            toks = rng.randint(0, cfg.vocab, (2, 32))
            lg = {}
            for name, p in (("card", p_dev), ("cpu", p_cpu)):
                with torch.no_grad():
                    lg[name], _ = T.prefill(p, {"tokens": torch.as_tensor(
                        toks, device=p["embed"].device)}, cfg)
            d = float((lg["card"].cpu() - lg["cpu"]).abs().max())
            self.expect(d <= LOGIT_TOL, f"{arch}: prefill logits differ by "
                        f"{d}")
            g_dev = generate(p_dev, cfg, toks[:, :16], 8).cpu()
            g_cpu = generate(p_cpu, cfg, toks[:, :16], 8)
            self.expect(torch.equal(g_dev, g_cpu),
                        f"{arch}: greedy tokens differ:\n{g_dev[:, 16:]}\n"
                        f"{g_cpu[:, 16:]}")
            line = (f"   {cfg.name}: prefill logits (2 x 32 tokens) within "
                    f"{d:.3g}; greedy tokens of 2 x 8 equal")
            if not cfg.is_hybrid:
                reqs = [toks[i % 2, :12 + 2 * i] for i in range(3)]
                cb = ContinuousBatcher(p_dev, cfg, slots=2, cache_len=24)
                outs, _ = cb.run(reqs, 6)
                solo = [generate(p_dev, cfg, r[None], 6)[0, len(r):]
                        .tolist() for r in reqs]
                self.expect(outs == solo, f"{arch}: batcher {outs} != solo "
                            f"{solo}")
                line += "; batcher tokens (3 requests, 2 slots) equal solo"
            print(line)
        print(f"   tolerance {LOGIT_TOL} on the logits")

    # -- phase 27 -----------------------------------------------------------
    def ssm_lm_grads(self, weights, tokens, route):
        """The gradient of ``ssm_lm``'s loss on ``weights`` and ``tokens``,
        with kernel C's intra-chunk step taken by ``route``: "kernel" (the
        autograd Function, the kernel on the card), "plain" (its plain
        version), or "detached" (the kernel's outputs without a gradient:
        the port before kernel C had one)."""
        torch = self.torch
        from repro_torch.fl.tasks import get_task
        from repro_torch.kernels import ssd_scan as K
        from repro_torch.utils.tree import leaves, tree_map
        task = get_task("ssm_lm")
        params = tree_map(lambda a: a.clone().requires_grad_(True), weights)
        saved = K.ssd_intra_chunk
        if route == "plain":
            K.ssd_intra_chunk = K.ssd_intra_chunk_plain
        elif route == "detached":
            K.ssd_intra_chunk = lambda *a, **k: tuple(
                o.detach() for o in K._intra_chunk(*a, k.get("heads", 1)))
        try:
            loss = task.loss(params, {"images": tokens, "labels": None})
            return loss, torch.autograd.grad(loss, leaves(params))
        finally:
            K.ssd_intra_chunk = saved

    def kernel_c_grad(self):
        np, torch = self.np, self.torch
        from repro_torch.fl.tasks import LM_SEQ_LEN, get_task, make_lm_data
        from repro_torch.kernels import ssd_scan as K
        lm, full = get_task("ssm_lm").model_cfg, self.ssm_cfg
        worst = {}

        def cells(G, H, L, P, N, seed, tol, key):
            """Forward and gradient of kernel C (the autograd Function)
            against autograd through the plain version, on seeded cells
            and seeded cotangents."""
            xb, b, c, cum = self.ssd_cells(G, H, L, P, N, seed,
                                           torch.float32)
            rng = np.random.RandomState(seed + 1)
            cot = [torch.from_numpy(rng.randn(*s).astype(np.float32)).to(
                self.dev) for s in ((G, L, P), (G, N, P), (G, 1))]
            got = {}
            for name, fn in (("kernel", K.ssd_intra_chunk),
                             ("plain", K.ssd_intra_chunk_plain)):
                ins = [t.clone().requires_grad_(True)
                       for t in (xb, b, c, cum)]
                out = fn(*ins, heads=H)
                got[name] = [o.detach() for o in out] + list(
                    torch.autograd.grad(out, ins, cot))
            err = 0.0
            names = ("y", "S", "a", "d xb", "d b", "d c", "d cum")
            for n, g, w in zip(names, got["kernel"], got["plain"]):
                e = float((g - w).abs().max())
                err = max(err, e)
                self.expect(bool(torch.isfinite(g).all()) and
                            torch.allclose(g, w, atol=tol, rtol=tol),
                            f"kernel C {n} at G={G}, {H} heads, L={L}, "
                            f"P={P}, N={N}: max abs err {e}")
            worst[key] = err
            print(f"   {key}: G={G}, {H} heads, L={L}, P={P}, N={N}: y, "
                  f"S, a and the gradients of xb, b, c and cum within "
                  f"{tol} of autograd through the plain version; max abs "
                  f"err {err:.3g}")

        # ssm_lm's local step: 40 sequences of 16 tokens, chunk 8
        B = 40
        cells(B * (LM_SEQ_LEN // lm.ssm_chunk) * lm.ssm_heads, lm.ssm_heads,
              lm.ssm_chunk, lm.ssm_head_dim, lm.ssm_state, 11, SSD_TOL,
              "ssm_lm shape")
        # Mamba2-370M's admission prefill: one 512-token prompt
        cells(2 * full.ssm_heads, full.ssm_heads, full.ssm_chunk,
              full.ssm_head_dim, full.ssm_state, 12, SSD_TOL_FULL,
              "Mamba2 shape")
        # the whole loss of ssm_lm, kernel against plain; and the gradient
        # the port took before kernel C had one
        weights = get_task("ssm_lm").init_params(
            torch.Generator(device=self.dev).manual_seed(4), self.dev)
        tokens = torch.from_numpy(make_lm_data(B, 8, 9)["x_train"]).to(
            self.dev)
        grads = {r: self.ssm_lm_grads(weights, tokens, r)
                 for r in ("kernel", "plain", "detached")}
        self.expect(abs(float(grads["kernel"][0].detach()
                              - grads["plain"][0].detach()))
                    <= SSD_TOL, "ssm_lm loss: kernel against plain")
        err, rel_old = 0.0, 0.0
        for g, w, old in zip(grads["kernel"][1], grads["plain"][1],
                             grads["detached"][1]):
            e = float((g - w).abs().max())
            err = max(err, e)
            self.expect(torch.allclose(g, w, atol=SSD_TOL, rtol=SSD_TOL),
                        f"ssm_lm gradient: max abs err {e}")
            rel_old = max(rel_old, float((old - w).norm() / w.norm()))
        print(f"   ssm_lm's loss ({B} x {LM_SEQ_LEN} tokens): its gradient "
              f"through kernel C within {SSD_TOL} of autograd through the "
              f"plain version (max abs err {err:.3g}); the gradient "
              f"without kernel C's backward (its outputs detached, as "
              f"before the autograd Function) is off by up to "
              f"{rel_old:.1%} of a leaf's norm")
        self.expect(rel_old > 1e-2, "dropping kernel C's gradient changed "
                    "nothing: the check cannot see the fault")
        worst["ssm_lm loss"] = err
        self.kernels["ssd_scan"].update(grad_max_abs_err=worst,
                                        grad_detached_rel_err=rel_old)
        if self.dev.type == "cuda":
            # the forward's time at ssm_lm's local-step shape
            self.kernels["ssd_scan"]["ssm_lm_shape"] = self.time_c(
                B * (LM_SEQ_LEN // lm.ssm_chunk) * lm.ssm_heads,
                lm.ssm_heads, lm.ssm_chunk, lm.ssm_head_dim, lm.ssm_state,
                13)

    # -- phase 28 -----------------------------------------------------------
    def check_block_kernels(self, w, what):
        """Kernel A's packed stream of the tree ``w`` (nested or flat)
        against the host pipeline and the reference decode, and kernel B's
        block channel (one launch) against its plain version on every
        leaf: exact."""
        torch = self.torch
        from repro_torch.core.codecs import (DenseRefCodec,
                                             PackedBitstreamCodec)
        from repro_torch.kernels import ops, topk_quant
        from repro_torch.utils.tree import leaves
        wire = PackedBitstreamCodec(0.25, 8).encode(w)
        host = PackedBitstreamCodec(0.25, 8, fused=False).encode(w)
        self.expect(wire.payload == host.payload,
                    f"{what}: kernel A's stream != host pipeline")
        ref = DenseRefCodec(0.25, 8).roundtrip(w)[0]
        dec = PackedBitstreamCodec(0.25, 8).decode(wire)
        self.expect(all(torch.equal(a, b) for a, b in
                        zip(leaves(dec), leaves(ref))),
                    f"{what}: kernel A's decode != DenseRefCodec")
        xs = leaves(w)
        channel = ops.compress_roundtrip_leaves(xs)
        for i, (v, got) in enumerate(zip(xs, channel)):
            lp, sp = topk_quant.topk_quant_plain(
                topk_quant._pad_rows(v, topk_quant.DEFAULT_BLOCK))
            plain = topk_quant.dequant(lp, sp, 8, v.numel(), v.shape)
            self.expect(torch.equal(got, plain),
                        f"{what}: kernel B's block channel of leaf {i} != "
                        f"plain version")
        print(f"   {what}: kernel A's stream ({len(wire.payload)} bytes, "
              f"{len(xs)} leaves in jax.tree.leaves order) equals the host "
              f"pipeline and decodes like DenseRefCodec; kernel B's block "
              f"channel equals its plain version on every leaf (exact)")

    def lm_tasks(self):
        torch = self.torch
        from repro_torch.fl.protocols import make_setup, make_sim
        from repro_torch.fl.simulator import SimConfig
        from repro_torch.utils.tree import leaves, tree_map
        n_dev, n_train, n_test = self.fleet
        out = {}
        for name in LM_TASKS:
            t0 = time.perf_counter()
            data, parts, w0 = make_setup(n_devices=n_dev, iid=True, seed=0,
                                         n_train=n_train, n_test=n_test,
                                         task=name, device=self.dev)
            print(f"   {name}: {n_dev} devices, {n_train}/{n_test} "
                  f"sequences, {sum(v.numel() for v in leaves(w0))} params "
                  f"in {len(leaves(w0))} nested leaves "
                  f"({time.perf_counter() - t0:.1f} s)")
            for path, extra in (("serial", {}), ("cohort",
                                                 dict(cohort_size=8))):
                cfg = SimConfig(method="teasq", task=name, n_devices=n_dev,
                                c_fraction=0.1, mu=0.01, alpha=0.6,
                                p_s=0.25, p_q=8, seed=0, codec="packed",
                                **extra)
                sim = make_sim(data, parts, tree_map(torch.clone, w0), cfg,
                               device=self.dev)
                self.sync()
                self.zero_counts()
                t0 = time.perf_counter()
                hist = sim.run(time_budget=1e9, max_rounds=5)
                self.sync()
                wall = time.perf_counter() - t0
                launches = self.read_counts()
                rounds, st = hist[-1].round, sim.stats
                print(f"   {name} {path}: {rounds} rounds, {st.completions} "
                      f"completions, flushes {st.flushes}; {wall:.3f} s, "
                      f"{wall / max(rounds, 1):.4f} s per round; accuracy "
                      f"{hist[0].accuracy:.4f} -> {hist[-1].accuracy:.4f}; "
                      f"launches inside sim.run: {launches} "
                      f"[{self.card()}]")
                self.expect(rounds >= 5, f"{name} {path}: only {rounds} "
                            f"rounds")
                self.expect(all(math.isfinite(e.accuracy) and
                                0 <= e.accuracy <= 1 for e in hist),
                            f"{name} {path}: accuracy not finite in [0, 1]")
                self.expect(all(bool(torch.isfinite(v).all())
                                for v in leaves(sim.server.w)),
                            f"{name} {path}: weights not finite")
                card = self.dev.type == "cuda"
                if path == "cohort":
                    self.expect((launches["topk_quant"] > 0) == card,
                                f"{name} cohort: kernel B's launches "
                                f"inside sim.run: {launches}")
                if name == "ssm_lm":
                    self.expect((launches["ssd_scan"] > 0) == card,
                                f"ssm_lm {path}: kernel C's launches inside "
                                f"sim.run: {launches}")
                out[f"{name}_{path}"] = {
                    "rounds": rounds, "wall_s_per_round":
                        wall / max(rounds, 1),
                    "accuracy": hist[-1].accuracy, "launches": launches}
                self.lm_sims[(name, path)] = sim
            out[f"{name}_step"] = self.lm_step(name, w0, data, cfg)
        self.check_block_kernels(
            self.lm_sims[("transformer_lm", "serial")].server.w,
            "transformer_lm's trained tree")
        self.lm["lm_tasks"] = out
        for name in self.kernels:
            by = {k: v["launches"][name] for k, v in out.items()
                  if "launches" in v and v["launches"][name]}
            self.add_launches(name, by)

    def lm_step(self, name, w0, data, cfg):
        """One serial local SGD step of task ``name`` (loss and gradient
        of a minibatch of ``cfg.batch_size`` sequences), timed on a
        synchronized host clock, and its device busy share on the card."""
        torch = self.torch
        from repro_torch.fl.tasks import get_task
        from repro_torch.utils.tree import leaves, tree_map
        task = get_task(name)
        params = tree_map(lambda a: a.clone().requires_grad_(True), w0)
        x = torch.from_numpy(data["x_train"][:cfg.batch_size]).to(self.dev)

        def step():
            loss = task.loss(params, {"images": x, "labels": None})
            return torch.autograd.grad(loss, leaves(params))

        step()
        ms, _ = self.timed(step, 10)
        print(f"   {name}: one local step ({cfg.batch_size} x "
              f"{x.shape[1]} tokens, loss and gradient) {ms:.2f} ms "
              f"[{self.card()}]")
        busy = (self.device_time(f"{name} local step", step, ms)
                if self.dev.type == "cuda" else None)
        return {"ms": ms, "busy": busy}

    def add_launches(self, kernel, by_path):
        """Add a path's launches of ``kernel`` to the kernels line (its
        total and its ``launches_by_path``)."""
        k = self.kernels[kernel]
        k["launches"] = k.get("launches", 0) + sum(by_path.values())
        k.setdefault("launches_by_path", {}).update(by_path)

    # -- phase 29 -----------------------------------------------------------
    def fleet_specs(self, n_dev, cohort):
        """``benchmarks/engine_scale.py::fleet_specs``: the four
        heterogeneous jobs of the fleet acceptance run (the CNN, the
        transformer, the MoE and the SSM LM), each gate wider than its
        quarter share except the SSM job's."""
        from repro_torch.core.latency import WirelessConfig
        from repro_torch.fl.simulator import SimConfig
        common = dict(n_devices=n_dev, gamma=10.0 / n_dev, epochs=1,
                      batch_size=8, cohort_size=cohort,
                      cohort_channel_iters=6,
                      wireless=WirelessConfig(bandwidth_hz=2e5))
        return [
            SimConfig(method="teasq", task="fmnist_cnn", c_fraction=0.28,
                      p_s=0.25, p_q=8, **common),
            SimConfig(method="teastatic", task="transformer_lm",
                      c_fraction=0.5, p_s=0.25, p_q=8, **common),
            SimConfig(method="fedasync", task="moe_lm", c_fraction=0.28,
                      p_s=1.0, p_q=32, **common),
            SimConfig(method="teasq", task="ssm_lm", c_fraction=0.004,
                      p_s=0.25, p_q=8, **common),
        ]

    def fleet_run(self, assigner, budget, step, wall_cap):
        """The four-job fleet (one sample per device per job, as
        engine_scale's ``run_fleet_once``) with ``assigner``, run in steps
        of ``step`` virtual s: to ``budget`` when it is given, else until
        ``wall_cap`` s of wall.  Each job's flushes are wrapped to count
        the kernels' launches they make, and so are its evaluations
        (``_log``).  -> (the virtual s reached, wall s, per-job rows, the
        launches of the whole run)."""
        from repro_torch.core.latency import WirelessConfig
        from repro_torch.fl.fleet import FleetConfig, build_fleet
        n_dev, cohort = self.fleet4[:2]
        cfg = FleetConfig(tasks=self.fleet_specs(n_dev, cohort),
                          n_devices=n_dev, seed=0, scheduler="batched",
                          assigner=assigner,
                          wireless=WirelessConfig(bandwidth_hz=2e5))
        fleet = build_fleet(cfg, n_train=n_dev, n_test=200, device=self.dev)
        per_job = [dict.fromkeys(self.kernels, 0) for _ in fleet.runtimes]
        for rt, counts in zip(fleet.runtimes, per_job):
            rt.trainer.flush = self.counted(rt.trainer.flush, counts)
            rt._log = self.counted(rt._log, counts)
        self.sync()
        self.zero_counts()
        t, t0 = 0.0, time.perf_counter()
        while (t < budget - 1e-12) if budget else \
                (time.perf_counter() - t0 < wall_cap):
            t = min(t + step, budget) if budget else t + step
            hists = fleet.run(time_budget=t, eval_every=10 ** 9)
            self.sync()
        wall = time.perf_counter() - t0
        total = self.read_counts()
        rows = []
        for spec, rt, h, counts in zip(cfg.tasks, fleet.runtimes, hists,
                                       per_job):
            rows.append({"task": spec.task, "method": spec.method,
                         "completions": int(rt.stats.completions),
                         "rounds": h[-1].round, "launches": counts})
        return t, wall, rows, total

    def counted(self, fn, counts):
        """``fn`` with the kernels' launches it makes added to
        ``counts``."""
        def wrapped(*a, **k):
            before = self.read_counts()
            try:
                return fn(*a, **k)
            finally:
                for name, n in self.read_counts().items():
                    counts[name] += n - before[name]
        return wrapped

    def four_family_fleet(self):
        n_dev, cohort, wall_cap, step, budget = self.fleet4
        out = {}
        for assigner in ("weighted", "adaptive"):
            t, wall, rows, total = self.fleet_run(assigner, budget, step,
                                                  wall_cap)
            budget = t
            tasks = sum(r["completions"] for r in rows)
            print(f"   {assigner}: {n_dev} devices, cohort {cohort}, to "
                  f"virtual {t:.4f} s in {wall:.2f} s of wall; {tasks} "
                  f"tasks, {wall * 1e3 / max(tasks, 1):.4f} ms per task; "
                  f"launches inside MultiTaskEngine.run {total} "
                  f"[{self.card()}]")
            for r in rows:
                r["ms_per_task"] = wall * 1e3 / max(r["completions"], 1)
                print(f"     {r['method']} on {r['task']}: completions "
                      f"{r['completions']}, rounds {r['rounds']}, "
                      f"{r['ms_per_task']:.4f} ms of the fleet's wall per "
                      f"task of its own; launches in its flushes and "
                      f"evaluations {r['launches']}")
            self.expect(all(r["rounds"] >= 1 for r in rows),
                        f"{assigner}: a job made no round: "
                        f"{[r['rounds'] for r in rows]}")
            out[assigner] = {"budget_s": t, "wall_s": wall, "tasks": tasks,
                             "ms_per_task": wall * 1e3 / max(tasks, 1),
                             "jobs": rows, "launches": total}
        ratio = out["adaptive"]["tasks"] / max(out["weighted"]["tasks"], 1)
        how = (f"reached by the weighted run in {wall_cap} s of wall"
               if self.fleet4[4] is None else "given")
        print(f"   virtual budget {budget:.4f} s ({how}); adaptive/weighted "
              f"aggregate tasks {ratio:.3f} (the reference benchmark's bar "
              f"is 1.2; printed, not asserted)")
        out["ratio"] = ratio
        self.lm["fleet4"] = out
        self.add_launches("topk_quant", {
            "fleet4_" + a: out[a]["launches"]["topk_quant"]
            for a in ("weighted", "adaptive")})

    # -- phase 30 -----------------------------------------------------------
    def lm_card_vs_cpu_tasks(self):
        for name in LM_TASKS:
            for extra in ({}, dict(cohort_size=4)):
                n, rounds, d = self.compare_with_cpu(
                    "teasq", acc_tol=LM_ACC_TOL, task=name, codec="packed",
                    **extra)
                print(f"   {name} {'cohort 4' if extra else 'serial'}: {n} "
                      f"entries, {rounds} rounds: time, round and byte "
                      f"columns equal; max |accuracy diff| {d:.4f} "
                      f"(tolerance {LM_ACC_TOL})")

    # -- phase 31 -----------------------------------------------------------
    def fl_to_serve(self):
        import contextlib
        import io
        import tempfile
        torch = self.torch
        from repro_torch.checkpoint.io import save_blob
        from repro_torch.fl.fleet import FleetConfig, build_fleet
        from repro_torch.fl.simulator import SimConfig
        from repro_torch.launch import serve
        from repro_torch.utils.tree import leaves
        shp = dict(batch=4, requests=8, prompt_len=16, gen=16)
        argv = ["--batch", str(shp["batch"]), "--requests",
                str(shp["requests"]), "--prompt-len",
                str(shp["prompt_len"]), "--gen", str(shp["gen"])]
        if self.dev.type != "cuda":
            argv += ["--device", str(self.dev)]
        with tempfile.TemporaryDirectory() as tmp:
            for name in ("transformer_lm", "ssm_lm"):
                sim = self.lm_sims[(name, "serial")]
                path = os.path.join(tmp, f"{name}.msgpack")
                save_blob(path, sim.state_dict())
                self.zero_counts()
                buf = io.StringIO()
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(buf):
                    outs, lat = serve.main(["--from-sim", path, "--task",
                                            name] + argv)
                self.sync()
                wall = time.perf_counter() - t0
                launches = self.read_counts()
                print("   " + buf.getvalue().strip().replace("\n", "\n   "))
                params, cfg = serve.load_task_params(path, name,
                                                     device=self.dev)
                self.expect(all(torch.equal(a, b) for a, b in zip(
                    leaves(params), leaves(sim.server.w))),
                    f"{name}: served weights != the engine's")
                rng = self.np.random.RandomState(0)
                prompts = [rng.randint(0, cfg.vocab, shp["prompt_len"])
                           for _ in range(shp["requests"])]
                solo = [serve.generate(params, cfg, p[None], shp["gen"])[
                    0, len(p):].tolist() for p in prompts]
                flips = self.near_ties(params, cfg, prompts, outs, solo)
                print(f"   {name} from its engine blob "
                      f"({os.path.getsize(path)} bytes): {wall:.3f} s "
                      f"for main, launches {launches} [{self.card()}]")
                card = self.dev.type == "cuda"
                if name == "ssm_lm":
                    self.expect((launches["ssd_scan"] > 0) == card,
                                f"ssm_lm serving: kernel C's launches "
                                f"{launches}")
                    self.add_launches("ssd_scan", {
                        "ssm_lm_from_sim_serving": launches["ssd_scan"]})
                self.lm[f"serve_{name}"] = {"wall_s": wall, "flips": flips,
                                            "launches": launches}
            # a fleet blob: --job picks the job's weights
            common = dict(epochs=1, p_s=0.25, p_q=8)
            fleet = build_fleet(FleetConfig(tasks=[
                SimConfig(method="teasq", **common),
                SimConfig(method="fedasync", task="transformer_lm",
                          epochs=1),
                SimConfig(method="fedasync", task="moe_lm", epochs=1),
                SimConfig(method="teasq", task="ssm_lm", **common)],
                n_devices=16, seed=0, scheduler="batched",
                assigner="adaptive"), n_train=320, n_test=128,
                device=self.dev)
            fleet.run(time_budget=2.0)
            path = os.path.join(tmp, "fleet.msgpack")
            save_blob(path, fleet.state_dict())
            for job, name in ((1, "transformer_lm"), (2, "moe_lm"),
                              (3, "ssm_lm")):
                params, _ = serve.load_task_params(path, name, job=job,
                                                   device=self.dev)
                self.expect(all(torch.equal(a, b) for a, b in zip(
                    leaves(params),
                    leaves(fleet.runtimes[job].server.w))),
                    f"fleet blob job {job}: weights != the job's")
            print("   a four-family fleet's blob: --job 1, 2 and 3 load "
                  "their own job's weights (exact)")

    # -- phases 32 and 33 -----------------------------------------------------
    def serve_whisper(self):
        np, torch = self.np, self.torch
        from repro_torch.launch.serve import generate
        from repro_torch.models import transformer as T
        cfg, shp = self.whisper_cfg, self.whisper_shape
        params = self.init_lm(cfg)
        # param_count() leaves out the final and encoder norms
        n = sum(a.numel() for a in _leaves(params))
        self.expect(n == cfg.param_count() + 2 * cfg.d_model,
                    f"{n} parameters, param_count() says "
                    f"{cfg.param_count()}")
        rng = np.random.RandomState(7)
        B, S, gen = shp["batch"], shp["prompt_len"], shp["gen"]
        prompts = rng.randint(0, cfg.vocab, (B, S))
        frames = torch.from_numpy(rng.randn(B, cfg.enc_seq, cfg.d_model)
                                  .astype(np.float32)).to(self.dev)
        toks = torch.as_tensor(prompts, device=self.dev)
        batch = {"tokens": toks, "frames": frames}
        generate(params, cfg, prompts[:, :4], 2, frames=frames)   # warm
        self.zero_counts()
        t0 = time.perf_counter()
        seqs = generate(params, cfg, prompts, gen, frames=frames)
        self.sync()
        wall = time.perf_counter() - t0
        launches = self.read_counts()
        out = seqs[:, S:]
        self.expect(tuple(seqs.shape) == (B, S + gen) and
                    bool(((out >= 0) & (out < cfg.vocab)).all()),
                    f"generate gave {tuple(seqs.shape)}")
        with torch.no_grad():
            ms_enc, enc = self.timed(
                lambda: T._encoder(params, frames, cfg), 3)
            ms_prefill, (lp, cache) = self.timed(
                lambda: T.encdec_prefill(params, batch, cfg, S), 3)
            full, _ = T.forward(params, batch, cfg)
            cache = T.extend_cache(cache, S + gen)
            tok = lp[:, -1].argmax(-1).to(torch.int32)[:, None]
            ms_decode, (logits, _) = self.timed(
                lambda: T.decode_step(params, tok, S, cfg, cache), 10)
        d = float((lp[:, 0] - full[:, -1]).abs().max())
        self.expect(d <= LOGIT_TOL, f"encdec_prefill's last logits differ "
                    f"from forward's by {d}")
        self.expect(bool(torch.isfinite(logits).all()),
                    "decode logits not finite")
        print(f"   generate(frames=): {B} prompts x {S} tokens, {gen} "
              f"tokens each, in {wall:.3f} s; launches {launches}; "
              f"encoder {ms_enc:.2f} ms, encdec_prefill (encoder "
              f"included) {ms_prefill:.2f} ms, decode {ms_decode:.2f} ms "
              f"per step ({B} rows) [{self.card()}]")
        print(f"   encdec_prefill's last-position logits within {d:.3g} of "
              f"forward's (tolerance {LOGIT_TOL})")
        self.lm["whisper"] = {"generate_s": wall, "encoder_ms": ms_enc,
                              "prefill_ms": ms_prefill,
                              "decode_ms": ms_decode, "prefill_vs_forward": d}
        del params, cache, enc

    def serve_vlm(self):
        np, torch = self.np, self.torch
        from repro_torch.models import transformer as T
        cfg, shp = self.vlm_cfg, self.vlm_shape
        card = self.dev.type == "cuda"
        if card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        params = self.init_lm(cfg)
        # param_count() leaves out patch_proj and the final norm
        n = sum(a.numel() for a in _leaves(params))
        self.expect(n == cfg.param_count() + cfg.d_model ** 2 + cfg.d_model,
                    f"{n} parameters, param_count() says "
                    f"{cfg.param_count()}")
        rng = np.random.RandomState(8)
        B, S, gen = shp["batch"], shp["prompt_len"], shp["gen"]
        toks = torch.as_tensor(rng.randint(0, cfg.vocab, (B, S + gen)),
                               device=self.dev)
        patches = torch.from_numpy(rng.randn(B, cfg.n_patches, cfg.d_model)
                                   .astype(np.float32)).to(self.dev)
        batch = {"tokens": toks[:, :S], "patches": patches}
        with torch.no_grad():
            T.prefill(params, batch, cfg)                          # warm
            self.zero_counts()
            ms_prefill, (lp, cache) = self.timed(
                lambda: T.prefill(params, batch, cfg), 2)
            full, _ = T.forward(params, batch, cfg)
            d = float((lp[:, 0] - full[:, -1]).abs().max())
            del full
            cache = T.extend_cache(cache, cfg.n_patches + S + gen)
            self.sync()
            t0 = time.perf_counter()
            for i in range(gen):
                logits, cache = T.decode_step(
                    params, toks[:, S + i:S + i + 1], cfg.n_patches + S + i,
                    cfg, cache)
            self.sync()
            ms_decode = (time.perf_counter() - t0) / gen * 1e3
        launches = self.read_counts()
        self.expect(d <= LOGIT_TOL, f"prefill's last logits differ from "
                    f"forward's by {d}")
        self.expect(bool(torch.isfinite(logits).all()),
                    "decode logits not finite")
        peak = torch.cuda.max_memory_allocated() if card else None
        print(f"   prefill of {cfg.n_patches} patch embeddings + {S} text "
              f"tokens ({B} row): {ms_prefill:.2f} ms; {gen} decode_steps "
              f"at positions {cfg.n_patches + S}..: {ms_decode:.2f} ms per "
              f"step; launches {launches}"
              + (f"; peak memory {peak / 1e9:.2f} GB" if peak else "")
              + f" [{self.card()}]")
        print(f"   prefill's last-position logits within {d:.3g} of "
              f"forward's (tolerance {LOGIT_TOL})")
        self.lm["internvl2"] = {"prefill_ms": ms_prefill,
                                "decode_ms": ms_decode,
                                "prefill_vs_forward": d, "peak_bytes": peak}
        del params, cache
        if card:
            torch.cuda.empty_cache()

    # -- phase 34 -----------------------------------------------------------
    def encdec_vlm_card_vs_cpu(self):
        np, torch = self.np, self.torch
        from repro_torch.configs.base import get_smoke_config
        from repro_torch.launch.serve import generate
        from repro_torch.models import transformer as T
        from repro_torch.utils.tree import tree_map
        rng = np.random.RandomState(9)
        for arch in ("whisper_tiny", "internvl2_2b"):
            cfg = get_smoke_config(arch)
            p_cpu = T.init_model(cfg, torch.Generator().manual_seed(5), "cpu")
            p_dev = tree_map(lambda a: a.to(self.dev), p_cpu)
            side = ("frames", cfg.enc_seq) if cfg.is_encoder_decoder else \
                ("patches", cfg.n_patches)
            batch = {"tokens": rng.randint(0, cfg.vocab, (2, 24)),
                     side[0]: rng.randn(2, side[1], cfg.d_model).astype(
                         np.float32)}
            lg = {}
            for name, p in (("card", p_dev), ("cpu", p_cpu)):
                b = {k: torch.as_tensor(v, device=p["embed"].device)
                     for k, v in batch.items()}
                with torch.no_grad():
                    fwd, _ = T.forward(p, b, cfg)
                    if cfg.is_encoder_decoder:
                        pre, _ = T.encdec_prefill(p, b, cfg, 24)
                    else:
                        pre, _ = T.prefill(p, b, cfg)
                lg[name] = (fwd.cpu(), pre.cpu())
            d = max(float((a - b).abs().max())
                    for a, b in zip(lg["card"], lg["cpu"]))
            self.expect(d <= LOGIT_TOL, f"{arch}: logits differ by {d}")
            line = (f"   {cfg.name}: forward and prefill logits (2 x 24 "
                    f"tokens) within {d:.3g}")
            if cfg.is_encoder_decoder:
                g = [generate(p, cfg, batch["tokens"][:, :8], 8,
                              frames=batch["frames"]).cpu()
                     for p in (p_dev, p_cpu)]
                self.expect(torch.equal(*g), f"{arch}: greedy tokens "
                            f"differ:\n{g[0][:, 8:]}\n{g[1][:, 8:]}")
                line += "; greedy tokens of 2 x 8 equal"
            print(line)
        print(f"   tolerance {LOGIT_TOL} on the logits")

    # -- phases 35-39: the trainer --------------------------------------------
    def train_argv(self, arch, *extra):
        """``launch/train.py``'s command line for ``arch`` on this device
        (at the smoke config on a rehearsal)."""
        return (["--arch", arch] + (["--smoke"] if self.trainer_smoke
                                    else [])
                + ["--device", str(self.dev)] + [str(a) for a in extra])

    def spy_channel(self, keep):
        """Swap ``ops.threshold_channel_leaves`` (the federated round's
        compressor) for one that also keeps clones of its inputs and
        outputs in ``keep`` (``"first"`` call or ``"last"``); returns the
        function that puts the real one back."""
        from repro_torch.kernels import ops
        real = ops.threshold_channel_leaves
        seen = []

        def spy(rows, p_s, p_q, iters=12):
            out = real(rows, p_s, p_q, iters)
            if keep == "last" or not seen:
                seen[:] = [([r.clone() for r in rows],
                            [o.clone() for o in out], (p_s, p_q, iters))]
            return out

        ops.threshold_channel_leaves = spy

        def restore():
            ops.threshold_channel_leaves = real
            return seen[0] if seen else None
        return restore

    def channel_plan_launches(self, params, groups):
        """Kernel B's launches per application of the round's compressor
        to ``params``'s leaves as (groups, n) rows: one per cluster size
        (``channel_plan``)."""
        from repro_torch.kernels import topk_quant as B
        from repro_torch.utils.tree import leaves
        lens = [x.numel() for x in leaves(params)]
        return len(B.channel_plan(lens, [groups] * len(lens)))

    def quant_bounds(self, rows, p_s, p_q, iters):
        """Per leaf of the round's delta rows (G, n): one quantization step
        (the largest row scale over L) and the largest row threshold."""
        torch = self.torch
        from repro_torch.core.compression import approx_topk_threshold_rows
        L = 2 ** (p_q - 1) - 1
        out = []
        for r in rows:
            ax = r.abs()
            thr = approx_topk_threshold_rows(ax, p_s, iters)
            kept = torch.where(ax >= thr[:, None], ax, torch.zeros_like(ax))
            out.append((float(kept.max()) / L, float(thr.max())))
        return out

    def within_quantization(self, got, want, bounds, what):
        """``got`` against ``want`` (leaf lists) as the CPU tests hold a
        gather_q round: every element within the threshold plus a step of
        its leaf, at most 0.1% of them past one step or past 1e-5.
        Returns the largest difference."""
        worst = far = past = total = 0
        for g, w, (q, thr) in zip(got, want, bounds):
            err = (g.detach().cpu() - w.detach().cpu()).abs()
            e = float(err.max())
            self.expect(e <= (thr + q) * (1 + 1e-6) + 1e-7,
                        f"{what}: {e} past threshold {thr} + step {q}")
            past += int((err > q * (1 + 1e-6)).sum())
            far += int((err > 1e-5).sum())
            total += err.numel()
            worst = max(worst, e)
        self.expect(past <= 1e-3 * total and far <= 1e-3 * total,
                    f"{what}: {past} past a step, {far} past 1e-5 of "
                    f"{total}")
        return worst

    # -- phase 35 -----------------------------------------------------------
    def channel_trainer_rows(self):
        np, torch = self.np, self.torch
        from repro_torch.kernels import topk_quant as B
        from repro_torch.kernels.ops import threshold_channel_leaves
        from repro_torch.utils.tree import leaves
        rng = np.random.default_rng(35)
        card = self.dev.type == "cuda"

        def rows(shape):
            return torch.from_numpy(rng.standard_normal(
                shape, dtype=np.float32) * np.float32(1e-3)).to(self.dev)

        w = self.init_lm(self.smollm_cfg, 0)
        smollm = [rows((4, x.numel())) for x in leaves(w)]
        del w
        cases = [
            (f"{self.smollm_cfg.name}'s {len(smollm)} leaves as (4, n) "
             f"delta rows", smollm),
            (f"{self.ssm_cfg.name}'s embedding as (4, "
             f"{self.ssm_cfg.vocab * self.ssm_cfg.d_model})",
             [rows((4, self.ssm_cfg.vocab * self.ssm_cfg.d_model))]),
            (f"one row of {self.long_row}", [rows((1, self.long_row))])]
        out = {}
        for name, xs in cases:
            before = B.LAUNCHES
            got = threshold_channel_leaves(xs, 0.25, 8, 12)
            self.sync()
            per_call = B.LAUNCHES - before
            want = B.threshold_channel_plain(xs, 0.25, 8, 12)
            for g, p in zip(got, want):
                self.expect(torch.equal(g, p), f"{name}: kernel B's channel "
                            f"form differs from its plain version")
            self.expect((per_call > 0) == card, f"{name}: {per_call} "
                        f"launches")
            longest = max(x.shape[1] for x in xs)
            kept = sum(int((g != 0).sum()) for g in got)
            n = sum(x.numel() for x in xs)
            line = (f"   {name}: equal to the plain version ({n} values, "
                    f"rows up to {longest}, {kept / n:.4f} kept; "
                    f"{per_call} launches)")
            entry = {"values": n, "longest_row": longest,
                     "launches_per_call": per_call}
            if card:
                ms = time_cuda(lambda: threshold_channel_leaves(
                    xs, 0.25, 8, 12), iters=10, warmup=1)
                try:
                    dev_ms = kernel_device_ms(
                        lambda: threshold_channel_leaves(xs, 0.25, 8, 12),
                        "topk_quant", reps=5) * per_call
                except RuntimeError:      # a timing beside the check
                    dev_ms = None
                plain = time_cuda(lambda: B.threshold_channel_plain(
                    xs, 0.25, 8, 12), iters=3, warmup=1)
                # each value read once, its dequantized value written once;
                # 12 bisection steps and 5 operations of quantization each
                t_bytes = 8 * n / PEAK_BYTES_PER_S * 1e3
                t_ops = 17 * n / PEAK_F32_OPS_PER_S * 1e3
                bound = max(t_bytes, t_ops)
                entry.update(ms=ms, device_ms=dev_ms, plain_ms=plain,
                             bound_ms=bound, bound_by="bytes"
                             if t_bytes >= t_ops else "operations")
                on_card = ("not measured (the profiler recorded no "
                           "kernel)" if dev_ms is None else
                           f"{dev_ms:.3f} ms")
                line += (f": {ms:.3f} ms per call (events over 10), "
                         f"{on_card} on the card (profiler), plain "
                         f"{plain:.3f} ms; bound {bound:.4f} ms "
                         f"({8 * n} bytes) [{self.card()}]")
            print(line)
            out[name] = entry
            del xs, got, want
        print("   The kept fraction is counted in integers and converted "
              "once, in the kernel and in its plain version alike; the JAX "
              "package's mean sums f32 ones, inexact past 2^24 values, so "
              "at rows over 2^24 / p_s values the two packages may differ.")
        self.kernels["topk_quant"]["trainer_rows"] = out

    # -- phase 36 -----------------------------------------------------------
    def fed_smollm(self):
        np, torch = self.np, self.torch
        from repro_torch.core import fed_step as FS
        from repro_torch.data import make_token_batch
        from repro_torch.kernels import topk_quant as B
        from repro_torch.launch import train
        from repro_torch.models import transformer as T
        from repro_torch.utils.tree import leaves, tree_map
        cfg, shp = self.smollm_cfg, self.train_shapes["smollm"]
        card = self.dev.type == "cuda"
        if card:
            torch.cuda.empty_cache()
        w0 = self.init_lm(cfg, 0)
        argv = self.train_argv(
            "smollm-135m", "--mode", "fed", "--groups", 4, "--local-steps",
            2, "--batch", shp["batch"], "--seq", shp["seq"], "--steps",
            shp["rounds"], "--lr", shp["lr"])
        restore = self.spy_channel("first")
        try:
            self.sync()
            self.zero_counts()
            t0 = time.perf_counter()
            trained, hist = train.main(argv,
                                       params=tree_map(torch.clone, w0))
            self.sync()
            wall = time.perf_counter() - t0
            launches = self.read_counts()
        finally:
            first = restore()
        per_round = self.channel_plan_launches(w0, 4)
        losses = [h["local_loss"] for h in hist]
        ms = [h["s"] * 1e3 for h in hist]
        print(f"   train.main {' '.join(argv)}: {len(hist)} rounds in "
              f"{wall:.2f} s; ms per round {[round(m, 1) for m in ms]} "
              f"(the first includes the card's warm-up); "
              f"local_loss {[round(x, 4) for x in losses]}; launches "
              f"{launches} ({per_round} of B a round) [{self.card()}]")
        self.expect(launches["topk_quant"] == (per_round * len(hist)
                                               if card else 0),
                    f"kernel B's launches in the rounds: {launches}")
        # the first round's batch, before and after the rounds
        tok = make_token_batch(np.random.RandomState(0), shp["batch"],
                               shp["seq"], cfg.vocab)["tokens"]
        batch = {"tokens": torch.from_numpy(tok).to(self.dev)}
        with torch.no_grad():
            on_first = [float(T.lm_loss(w, batch, cfg)[0])
                        for w in (w0, trained)]
        del trained
        print(f"   the loss on the first round's batch: {on_first[0]:.4f} "
              f"-> {on_first[1]:.4f}")
        self.expect(losses[-1] < losses[0], f"local_loss did not fall: "
                    f"{losses}")
        self.expect(on_first[1] < on_first[0], f"the loss on the first "
                    f"batch did not fall: {on_first}")
        rows, outs, (p_s, p_q, iters) = first
        want = B.threshold_channel_plain(rows, p_s, p_q, iters)
        for g, p in zip(outs, want):
            self.expect(torch.equal(g, p), "the first round's combine "
                        "differs from its deltas through the plain version")
        print(f"   the first round's combine ({len(rows)} leaves of (4, n) "
              f"deltas, rows up to {max(r.shape[1] for r in rows)}) equals "
              f"the same deltas through threshold_channel_plain")
        del rows, outs, want, first

        # the three schedules from the same weights and the same batch
        stale = torch.zeros(4, dtype=torch.int32, device=self.dev)
        res = {}
        for sched in ("gather_q", "gather_f32", "psum"):
            fed = FS.FedConfig(n_groups=4, local_steps=2, lr=shp["lr"],
                               schedule=sched)
            step = FS.make_fed_train_step(
                lambda p, b: T.lm_loss(p, b, cfg)[0], fed)
            restore = self.spy_channel("last")
            try:
                res[sched] = step(w0, batch, stale)
            finally:
                seen = restore()
            if sched == "gather_q":
                bounds = self.quant_bounds(seen[0], p_s, p_q, iters)
                bounds = [(float(res[sched][1]["alpha_t"]) * q,
                           float(res[sched][1]["alpha_t"]) * t)
                          for q, t in bounds]
                del seen
        pq, pf, pp = (leaves(res[s][0]) for s in ("gather_q", "gather_f32",
                                                   "psum"))
        d_fp = max(float((a - b).abs().max()) for a, b in zip(pf, pp))
        self.expect(d_fp <= 1e-6, f"gather_f32 and psum differ by {d_fp}")
        # against f32, gather_q drops the values below each group's
        # threshold and rounds the rest: within a_t (threshold + step)
        d_qf = 0.0
        for a, b, (q, t) in zip(pq, pf, bounds):
            e = float((a - b).abs().max())
            self.expect(e <= (t + q) * (1 + 1e-5), f"gather_q off gather_f32 "
                        f"by {e} > a_t (threshold {t} + step {q})")
            d_qf = max(d_qf, e)
        print(f"   one round each from the same weights and batch: "
              f"gather_f32 and psum within {d_fp:.3g}; gather_q within "
              f"{d_qf:.3g} of gather_f32 (its compression error: at most "
              f"a_t times the threshold plus a step, per leaf)")
        out = {"rounds": len(hist), "ms_per_round": ms, "local_loss": losses,
               "first_batch_loss": on_first, "launches": launches,
               "b_launches_per_round": per_round}
        if card:
            from torch.profiler import ProfilerActivity, profile
            step = FS.make_fed_train_step(
                lambda p, b: T.lm_loss(p, b, cfg)[0],
                FS.FedConfig(n_groups=4, local_steps=2, lr=shp["lr"]))
            self.sync()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                step(w0, batch, stale)
                self.sync()
            dev = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
            busy = sum(e.self_device_time_total for e in dev) / 1e3
            chan = sum(e.self_device_time_total for e in dev
                       if "topk_quant" in e.key) / 1e3
            rest = sorted(ms[1:]) if len(ms) > 1 else ms
            med = rest[len(rest) // 2]
            print(f"   profiled round: {busy:.2f} ms of kernels on the card, "
                  f"kernel B's channel form {chan:.3f} ms of it "
                  f"({chan / max(busy, 1e-9):.1%}; {chan / med:.1%} of the "
                  f"median round's {med:.1f} ms of wall) [{self.card()}]")
            out.update(kernel_ms=busy, channel_device_ms=chan,
                       channel_share_of_kernels=chan / max(busy, 1e-9))
        self.train["fed_smollm"] = out
        self.add_launches("topk_quant", {"fed round, SmolLM-135M (36)":
                                         launches["topk_quant"]})

    # -- phase 37 -----------------------------------------------------------
    def fed_mamba(self):
        np, torch = self.np, self.torch
        from repro_torch.data import make_token_batch
        from repro_torch.kernels import ssd_scan as K
        from repro_torch.launch import train
        from repro_torch.models import transformer as T
        from repro_torch.utils.tree import leaves, paths, tree_map
        cfg, shp = self.ssm_cfg, self.train_shapes["mamba"]
        card = self.dev.type == "cuda"
        if card:
            torch.cuda.empty_cache()
        w0 = self.init_lm(cfg, 0)
        argv = self.train_argv(
            "mamba2-370m", "--mode", "fed", "--groups", 4, "--local-steps",
            1, "--batch", shp["batch"], "--seq", shp["seq"], "--steps",
            shp["rounds"])
        self.sync()
        self.zero_counts()
        t0 = time.perf_counter()
        _, hist = train.main(argv, params=tree_map(torch.clone, w0))
        self.sync()
        wall = time.perf_counter() - t0
        launches = self.read_counts()
        per_round = self.channel_plan_launches(w0, 4)
        ms = [h["s"] * 1e3 for h in hist]
        print(f"   train.main {' '.join(argv)}: {len(hist)} rounds in "
              f"{wall:.2f} s; ms per round {[round(m, 1) for m in ms]}; "
              f"local_loss {[round(h['local_loss'], 4) for h in hist]}; "
              f"launches {launches} (C: {cfg.n_layers} layers x 1 local "
              f"step a round, the 4 groups folded into one launch; B: "
              f"{per_round} a round) [{self.card()}]")
        self.expect(launches["ssd_scan"] == (cfg.n_layers * len(hist)
                                             if card else 0),
                    f"kernel C's launches in the rounds: {launches}")
        self.expect(launches["topk_quant"] == (per_round * len(hist)
                                               if card else 0),
                    f"kernel B's launches in the rounds: {launches}")
        self.expect(all(math.isfinite(h["local_loss"]) for h in hist),
                    "local_loss not finite")

        # the first round's local gradients under the group vmap, C's
        # outputs through its autograd Function against the plain version
        tok = make_token_batch(np.random.RandomState(0), shp["batch"],
                               shp["seq"], cfg.vocab)["tokens"]
        gtok = torch.from_numpy(tok).to(self.dev).reshape(
            4, shp["batch"] // 4, shp["seq"])
        grad = torch.func.vmap(torch.func.grad(
            lambda p, t: T.lm_loss(p, {"tokens": t}, cfg)[0]),
            in_dims=(None, 0))
        before = K.LAUNCHES
        g_kernel = grad(w0, gtok)
        used = K.LAUNCHES - before
        real = K.ssd_intra_chunk
        K.ssd_intra_chunk = K.ssd_intra_chunk_plain
        try:
            g_plain = grad(w0, gtok)
        finally:
            K.ssd_intra_chunk = real
        names = [".".join(k) for k in paths(w0)]
        per = []
        sq_d = sq_g = 0.0
        for name, a, b in zip(names, leaves(g_kernel), leaves(g_plain)):
            d = float(torch.linalg.vector_norm(a - b))
            g = float(torch.linalg.vector_norm(b))
            sq_d, sq_g = sq_d + d * d, sq_g + g * g
            per.append((d / max(g, 1e-30), float((a - b).abs().max()),
                        float(b.abs().max()), name))
        rel = math.sqrt(sq_d / max(sq_g, 1e-60))
        dmax = max(p[1] for p in per)
        self.expect(used == (cfg.n_layers if card else 0),
                    f"the kernel route launched C {used} times")
        print(f"   the first round's 4 group gradients: kernel C's route "
              f"({used} launches) against the plain version: largest "
              f"element difference {dmax:.3g} (tolerance {SSD_TOL}, "
              f"absolute and relative, as phase 27), {rel:.3g} of the "
              f"gradient's norm; the leaves furthest off, relative to "
              f"their own norm:")
        for r, d, gmax, name in sorted(per, reverse=True)[:4]:
            print(f"     {name}: {r:.3g} (largest element difference "
                  f"{d:.3g}, largest element {gmax:.3g})")
        for name, a, b in zip(names, leaves(g_kernel), leaves(g_plain)):
            self.expect(torch.allclose(a, b, atol=SSD_TOL, rtol=SSD_TOL),
                        f"C's gradient under the group vmap, {name}: off "
                        f"the plain version's by {float((a - b).abs().max())}")
        self.train["fed_mamba"] = {"rounds": len(hist), "ms_per_round": ms,
                                   "launches": launches,
                                   "grad_max_abs_err": dmax,
                                   "grad_rel_err": rel}
        self.kernels["ssd_scan"]["fed_grad_max_abs_err"] = dmax
        self.add_launches("topk_quant", {"fed round, Mamba2-370M (37)":
                                         launches["topk_quant"]})
        self.add_launches("ssd_scan", {"fed round, Mamba2-370M (37)":
                                       launches["ssd_scan"]})

    # -- phase 38 -----------------------------------------------------------
    def train_qwen(self):
        import tempfile
        np, torch = self.np, self.torch
        from repro_torch.checkpoint import load_pytree
        from repro_torch.data import make_token_batch
        from repro_torch.launch import train
        from repro_torch.models import transformer as T
        from repro_torch.utils.tree import leaves
        cfg, shp = self.qwen_cfg, self.train_shapes["qwen"]
        card = self.dev.type == "cuda"
        if card:
            torch.cuda.empty_cache()
        # the weights train.main draws from its seed, and its first batch:
        # the loss on that batch before and after the steps
        held = [self.init_lm(cfg, 0)]
        tok = make_token_batch(np.random.RandomState(0), shp["batch"],
                               shp["seq"], cfg.vocab)["tokens"]
        first = {"tokens": torch.from_numpy(tok).to(self.dev)}
        with torch.no_grad():
            before = float(T.lm_loss(held[0], first, cfg)[0])
        if card:
            torch.cuda.reset_peak_memory_stats()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "qwen.msgpack")
            argv = self.train_argv("qwen3-1.7b", "--mode", "plain",
                                   "--batch", shp["batch"], "--seq",
                                   shp["seq"], "--steps", shp["steps"],
                                   "--ckpt", path)
            self.sync()
            self.zero_counts()
            t0 = time.perf_counter()
            # the list lets go of the initial weights once the first step
            # has replaced them
            params, hist = train.main(argv, params=held.pop())
            self.sync()
            wall = time.perf_counter() - t0
            launches = self.read_counts()
            peak = torch.cuda.max_memory_allocated() / 1e9 if card else None
            losses = [h["loss"] for h in hist]
            ms = [h["s"] * 1e3 for h in hist]
            with torch.no_grad():
                after = float(T.lm_loss(params, first, cfg)[0])
            n = sum(x.numel() for x in leaves(params))
            print(f"   train.main {' '.join(argv[:-2])}: {n} parameters, "
                  f"{len(hist)} AdamW steps; ms per step "
                  f"{[round(m, 1) for m in ms]}; loss "
                  f"{[round(x, 4) for x in losses]}; on the first batch "
                  f"{before:.4f} -> {after:.4f}; peak memory "
                  f"{'not measured' if peak is None else f'{peak:.2f} GB'};"
                  f" {wall:.1f} s with the checkpoint; launches {launches} "
                  f"(no kernel of the port on this path) [{self.card()}]")
            self.expect(after < before, f"the loss on the first batch did "
                        f"not fall: {before} -> {after}")
            self.expect(all(math.isfinite(x) for x in losses),
                        f"losses not finite: {losses}")
            self.expect(sum(launches.values()) == 0, f"a kernel of the "
                        f"port ran: {launches}")
            t0 = time.perf_counter()
            back = load_pytree(path, params, device=self.dev)
            same = all(torch.equal(a, b) for a, b in
                       zip(leaves(back), leaves(params)))
            size = os.path.getsize(path)
            self.expect(same, "the checkpoint does not load back equal")
            print(f"   --ckpt: {size} bytes, loaded back equal in "
                  f"{time.perf_counter() - t0:.1f} s")
            del back, params
        self.train["qwen_plain"] = {"steps": len(hist), "ms_per_step": ms,
                                    "loss": losses, "first_batch_loss":
                                    [before, after], "peak_gb": peak}

    # -- phase 39 -----------------------------------------------------------
    def trainer_card_vs_cpu(self):
        torch = self.torch
        from repro_torch.configs.base import get_smoke_config
        from repro_torch.launch import train
        from repro_torch.models import transformer as T
        from repro_torch.utils.tree import leaves, tree_map
        cfg = get_smoke_config("smollm-135m")
        w = T.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
        for mode in ("fed", "plain"):
            got = {}
            for dev in (self.dev.type, "cpu"):
                restore = self.spy_channel("last")
                try:
                    got[dev] = train.main(
                        ["--arch", "smollm-135m", "--smoke", "--mode", mode,
                         "--steps", "3", "--batch", "8", "--seq", "32",
                         "--device", dev],
                        params=tree_map(lambda a: a.to(dev), w))
                finally:
                    seen = restore()
            key = "local_loss" if mode == "fed" else "loss"
            lc = [h[key] for h in got[self.dev.type][1]]
            lp = [h[key] for h in got["cpu"][1]]
            d = max(abs(a - b) for a, b in zip(lc, lp))
            self.expect(d <= 1e-4, f"{mode}: losses differ by {d}")
            line = (f"   SmolLM smoke, {mode} mode, 3 "
                    f"{'rounds' if mode == 'fed' else 'steps'}: losses "
                    f"within {d:.3g}")
            if mode == "fed":
                rows, _, (p_s, p_q, iters) = seen
                bounds = self.quant_bounds(rows, p_s, p_q, iters)
                worst = self.within_quantization(
                    leaves(got[self.dev.type][0]), leaves(got["cpu"][0]),
                    bounds, "fed params, card against CPU")
                line += (f"; params within {worst:.3g} (one step or a "
                         f"threshold flip, as the CPU tests hold gather_q)")
            print(line)
        self.zero_counts()
        for codec in ("dense", "threshold"):
            before = self.read_counts()["topk_quant"]
            n, rounds, d = self.compare_with_cpu("teasq", backend="legacy",
                                                 codec=codec)
            b = self.read_counts()["topk_quant"] - before
            print(f"   run_method('teasq', backend='legacy', codec="
                  f"{codec!r}), 8 devices: {n} entries, {rounds} rounds, "
                  f"time, round and byte columns equal; max |accuracy "
                  f"diff| {d:.4f}; kernel B's launches on the card {b}")
            if codec == "threshold":
                self.expect((b > 0) == (self.dev.type == "cuda"),
                            f"kernel B's launches in the legacy threshold "
                            f"run: {b}")
                self.add_launches("topk_quant", {
                    "legacy simulator, codec threshold (39)": b})

    # -- phases 40-43: the mesh slice -------------------------------------
    @contextlib.contextmanager
    def world(self):
        """A world of 1 (NCCL on the card, gloo on a CPU rehearsal) and its
        (1, 1) mesh, destroyed on the way out."""
        import torch.distributed as dist
        from repro_torch.launch.mesh import init_world, make_host_mesh
        backend = init_world("nccl" if self.dev.type == "cuda" else "gloo")
        try:
            mesh = make_host_mesh(1, 1)
            print(f"   world: 1 rank under {backend}, mesh (data 1, model 1)")
            yield mesh
        finally:
            dist.destroy_process_group()

    def max_ulp(self, a, b):
        """Largest distance of two f32 tensors in units in the last place."""
        torch = self.torch

        def order(x):
            i = x.detach().float().contiguous().view(torch.int32).to(
                torch.int64)
            return torch.where(i >= 0, i, -(2 ** 31) - i)
        return int((order(a) - order(b)).abs().max()) if a.numel() else 0

    def sharded_server(self):
        np, torch = self.np, self.torch
        from repro_torch.core import staleness as St
        from repro_torch.fl.protocols import make_setup, make_sim
        from repro_torch.fl.simulator import SimConfig
        n_dev, n_train, n_test = self.fleet
        data, parts, w0 = make_setup(n_devices=n_dev, iid=True, seed=0,
                                     n_train=n_train, n_test=n_test,
                                     device=self.dev)
        runs = {}
        det = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            with self.world():
                for server in ("single", "sharded"):
                    cfg = SimConfig(method="teasq", n_devices=n_dev,
                                    c_fraction=0.1, mu=0.01, alpha=0.6,
                                    p_s=0.25, p_q=8, seed=0, codec="packed",
                                    server=server)
                    sim = make_sim(data, parts, w0, cfg, device=self.dev)
                    self.sync()
                    t0 = time.perf_counter()
                    hist = sim.run(time_budget=1e9, max_rounds=5)
                    self.sync()
                    runs[server] = (hist, sim.server,
                                    time.perf_counter() - t0)
        finally:
            torch.backends.cudnn.deterministic = det
        (ha, sa, wall_a), (hb, sb, wall_b) = runs["single"], runs["sharded"]
        self.expect(type(sb).__name__ == "ShardedTeasqServer"
                    and sb.n_shards == 1 and sb.mesh is None,
                    f"the sharded server in a world of 1: {type(sb)}, "
                    f"{sb.n_shards} shards")
        cols = [[(e.time, e.round, e.bytes_up, e.bytes_down, e.accuracy)
                 for e in h] for h in (ha, hb)]
        self.expect(cols[0] == cols[1] and len(cols[0]) >= 5,
                    "the sharded run's columns differ from the single one's")
        same = all(torch.equal(sa.w[k], sb.w[k]) for k in sa.w)
        self.expect(same, "the sharded run's weights differ")
        print(f"   server='sharded' ({sb.n_shards} shard, no mesh): "
              f"{hb[-1].round} rounds in {wall_b:.2f} s against 'single' "
              f"{wall_a:.2f} s; columns, accuracy and weights equal, bit "
              f"for bit [{self.card()}]")
        # the flat column-block body on the card
        rng = np.random.RandomState(40)
        w = sb.w
        cache = [({k: v + torch.from_numpy((rng.randn(*v.shape) * 0.01)
                                           .astype(np.float32)).to(self.dev)
                   for k, v in w.items()}, int(rng.randint(0, 5)),
                  int(rng.randint(100, 700))) for _ in range(10)]
        want = St.aggregate_cache_stacked(w, cache, 6, 0.6, 0.5)
        ulps = {}
        for n in (2, 4):
            got = St.aggregate_cache_sharded_ref(w, cache, 6, 0.6, 0.5,
                                                 n_shards=n)
            ulps[n] = max(self.max_ulp(got[k], want[k]) for k in want)
            self.expect(ulps[n] <= 1, f"{n} shards: {ulps[n]} ulp from "
                        f"aggregate_cache_stacked")
        print(f"   aggregate_cache_sharded_ref on {self.dev.type} over the CNN "
              f"(cache of 10): {ulps} ulp from aggregate_cache_stacked "
              f"(tolerance: 1 ulp)")
        self.mesh["server"] = {"wall_single_s": wall_a,
                                "wall_sharded_s": wall_b,
                               "rounds": hb[-1].round, "ulps": ulps}

    def fed_mesh(self):
        np, torch = self.np, self.torch
        from repro_torch.core import fed_step as FS
        from repro_torch.data import make_token_batch
        from repro_torch.models import transformer as T
        from repro_torch.sharding.rules import Rules, use_rules
        from repro_torch.utils.tree import leaves
        cfg, shp = self.smollm_cfg, self.train_shapes["smollm"]
        card = self.dev.type == "cuda"
        if card:
            torch.cuda.empty_cache()
        w0 = self.init_lm(cfg, 0)
        tok = make_token_batch(np.random.RandomState(0), shp["batch"],
                               shp["seq"], cfg.vocab)["tokens"]
        batch = {"tokens": torch.from_numpy(tok).to(self.dev)}
        stale = torch.zeros(4, dtype=torch.int32, device=self.dev)
        per_round = self.channel_plan_launches(w0, 4)
        n_leaves = len(leaves(w0))
        out = {}

        def rounds(step, reps):
            ms, res = [], None
            for _ in range(reps):
                self.sync()
                t0 = time.perf_counter()
                res = step(w0, batch, stale)
                self.sync()
                ms.append((time.perf_counter() - t0) * 1e3)
            return ms, res

        with self.world() as mesh:
            for pq, reps in ((8, 3), (4, 1)):
                fed = FS.FedConfig(n_groups=4, local_steps=2, lr=shp["lr"],
                                   p_q=pq)
                step = FS.make_fed_train_step(
                    lambda p, b: T.lm_loss(p, b, cfg)[0], fed)
                restore = self.spy_channel("last")
                try:
                    ms_plain, (p_ref, m_ref) = rounds(step, 1)
                finally:
                    seen = restore()
                a_t = float(m_ref["alpha_t"])
                bounds = [(a_t * q, a_t * t) for q, t in self.quant_bounds(
                    seen[0], fed.p_s, fed.p_q, fed.threshold_iters)]
                if card and pq == 8:
                    self.time_wire(seen[0], fed)
                del seen
                self.zero_counts()
                with use_rules(Rules(mesh)):
                    ms_mesh, (p_m, m_m) = rounds(step, reps)
                launches = self.read_counts()
                self.expect(launches["topk_quant"] == (per_round * reps
                                                       if card else 0),
                            f"kernel B's launches in the mesh rounds: "
                            f"{launches}")
                got, want = leaves(p_m), leaves(p_ref)
                exact = all(torch.equal(g, w) for g, w in zip(got, want))
                worst = 0.0 if exact else self.within_quantization(
                    got, want, bounds, f"mesh round at p_q {pq}")
                wire = int(m_m["wire_bytes"])
                self.expect(abs(float(m_m["local_loss"])
                                - float(m_ref["local_loss"])) <= 1e-5,
                            "the mesh round's local_loss")
                rounded = [round(m, 1) for m in ms_mesh]
                same = ("bit for bit equal" if exact else
                        f"within {worst:.3g} (the gather_q rule)")
                print(f"   p_q {pq}: mesh round ms {rounded} (the first "
                      f"warms), no-mesh {ms_plain[0]:.1f} ms; params {same}"
                      f" to the no-mesh round's; kernel B launches "
                      f"{launches['topk_quant']} ({per_round} a round, with "
                      f"the wire); {wire} bytes on the fed all-gather "
                      f"[{self.card()}]")
                out[pq] = {"ms_mesh": ms_mesh, "ms_plain": ms_plain,
                           "exact": exact, "worst": worst, "wire": wire,
                           "launches": launches["topk_quant"]}
                del p_ref, p_m
        scales = 4 * 4 * n_leaves        # a f32 scale per (group, leaf)
        lv8, lv4 = out[8]["wire"] - scales, out[4]["wire"] - scales
        self.expect(lv4 == 4 * -(-(lv8 // 4) // 2),
                    f"the int4 wire: {lv4} level bytes against {lv8} at "
                    f"int8")
        print(f"   the wire's levels: {lv8} bytes at p_q 8, {lv4} at p_q 4 "
              f"(two a byte), beside {scales} bytes of scales")
        self.mesh["fed"] = out
        self.add_launches("topk_quant", {"fed round on a (1, 1) mesh (41)":
                                         out[8]["launches"]
                                         + out[4]["launches"]})

    def time_wire(self, rows, fed):
        """Kernel B's channel form on the round's delta rows with its wire
        (int8 levels and f32 scales beside the values) and without, by
        CUDA events, against the plain version and the byte bounds."""
        from repro_torch.kernels import ops
        from repro_torch.kernels import topk_quant as B
        args = (fed.p_s, fed.p_q, fed.threshold_iters)
        n = sum(r.numel() for r in rows)
        ms = {w: time_cuda(lambda w=w: ops.threshold_channel_leaves(
            rows, *args, wire=w), iters=10, warmup=2) for w in (False, True)}
        plain = time_cuda(lambda: B.threshold_channel_plain(rows, *args,
                                                            wire=True),
                          iters=2, warmup=1)
        # each value read once and written once (4 + 4 bytes), the wire
        # adds its level (1 byte) and a scale a row
        bound = {False: 8 * n / PEAK_BYTES_PER_S * 1e3,
                 True: (9 * n + 4 * sum(r.shape[0] for r in rows))
                 / PEAK_BYTES_PER_S * 1e3}
        print(f"   kernel B's channel form on the round's {len(rows)} delta "
              f"rows of (4, n), {n} values: {ms[True]:.3f} ms with the wire "
              f"(bound {bound[True]:.3f}), {ms[False]:.3f} ms without "
              f"(bound {bound[False]:.3f}); plain with the wire "
              f"{plain:.2f} ms [{self.card()}]")
        self.kernels["topk_quant"].update(
            channel_wire_ms=ms[True], channel_nowire_ms=ms[False],
            channel_wire_plain_ms=plain, channel_wire_bound_ms=bound[True])

    def ep_jamba(self):
        np, torch = self.np, self.torch
        from repro_torch.models import moe as MoE
        from repro_torch.models import transformer as T
        from repro_torch.sharding.rules import Rules, use_rules
        cfg, shp = self.jamba_cfg, self.jamba_shape
        card = self.dev.type == "cuda"
        if card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        params = self.init_lm(cfg)
        prompts = np.random.RandomState(3).randint(
            0, cfg.vocab, (shp["batch"], shp["prompt_len"]))
        toks = torch.as_tensor(prompts, device=self.dev)
        real, seen = MoE.moe_apply, []

        def spy(p, x, c):
            if not seen:
                seen.append((p, x.detach().clone()))
            return real(p, x, c)

        with torch.no_grad():
            ms_dense, (lg_dense, _) = self.timed(
                lambda: T.prefill(params, {"tokens": toks}, cfg), 2)
            with self.world() as mesh, use_rules(Rules(mesh)):
                MoE.moe_apply = spy
                try:
                    self.zero_counts()
                    lg_ep, _ = T.prefill(params, {"tokens": toks}, cfg)
                    self.sync()
                    launches = self.read_counts()
                finally:
                    MoE.moe_apply = real
                ms_ep, _ = self.timed(
                    lambda: T.prefill(params, {"tokens": toks}, cfg), 2)
                p, x = seen[0]
                y_ep, _ = MoE.moe_apply(p, x, cfg)
            y_dense, _ = MoE.moe_apply(p, x, cfg)
        B, S, D = x.shape
        n_tok, E, k = B * S, cfg.n_experts, cfg.moe_top_k
        cap = max(8, int(math.ceil(n_tok * k / E * cfg.capacity_factor)))
        _, e, _ = MoE._route(p["router"], x.reshape(n_tok, D), k)
        rank, _ = MoE._dispatch_ranks(e, E)
        dropped = (rank >= cap).reshape(n_tok, k)
        fit = ~dropped.any(dim=1)
        diff = (y_ep - y_dense).reshape(n_tok, D)
        err = float(diff[fit].abs().max())
        self.expect(err <= EP_TOL, f"EP against dense on tokens that fit: "
                    f"{err}")
        self.expect(launches["ssd_scan"] == (cfg.attn_every - 1 if card
                                             else 0),
                    f"kernel C in the EP prefill: {launches}")
        self.expect(bool(torch.isfinite(lg_ep).all()), "EP logits not finite")
        peak = torch.cuda.max_memory_allocated() if card else None
        print(f"   one MoE layer on the prefill's hidden states ({n_tok} "
              f"tokens, {E} experts, top-{k}, capacity {cap}): "
              f"{int(dropped.sum())} of {n_tok * k} slots dropped, "
              f"{int(fit.sum())} tokens with every slot kept, EP within "
              f"{err:.3g} of the dense route on them (tolerance {EP_TOL}); "
              f"expert work {E} x {cap} slots against {E} x {n_tok}")
        print(f"   prefill {shp['batch']} x {S}: EP {ms_ep:.2f} ms, dense "
              f"{ms_dense:.2f} ms (phase 25: "
              f"{self.lm.get('jamba', {}).get('prefill_ms', float('nan')):.2f}"
              f"); logits EP against dense max |diff| "
              f"{float((lg_ep - lg_dense).abs().max()):.3g}; launches "
              f"{launches}; peak "
              f"{'%.2f GB' % (peak / 1e9) if peak else 'n/a'} "
              f"[{self.card()}]")
        self.mesh["ep"] = {"ms_ep": ms_ep, "ms_dense": ms_dense,
                           "dropped": int(dropped.sum()), "capacity": cap,
                           "err": err}
        del params, p, x, lg_ep, lg_dense
        if card:
            torch.cuda.empty_cache()

    def seqshard_qwen(self):
        np, torch = self.np, self.torch
        from repro_torch.models import transformer as T
        from repro_torch.sharding.rules import Rules, use_rules
        cfg, shp = self.qwen_cfg, self.qwen_shape
        card = self.dev.type == "cuda"
        if card:
            torch.cuda.empty_cache()
        params = self.init_lm(cfg)
        B, S, gen = shp["slots"], shp["prompt_len"], shp["gen"]
        toks = torch.as_tensor(np.random.RandomState(43).randint(
            0, cfg.vocab, (B, S)), device=self.dev)

        def run(shard):
            with torch.no_grad():
                logits, cache = T.prefill(params, {"tokens": toks}, cfg)
                cache = T.extend_cache(cache, S + gen)
                t = logits[:, -1].argmax(-1)[:, None]
                outs, ms, picked = [], [], []
                for i in range(gen):
                    self.sync()
                    t0 = time.perf_counter()
                    lg, cache = T.decode_step(params, t, S + i, cfg, cache,
                                              seq_shard_kv=shard)
                    self.sync()
                    ms.append((time.perf_counter() - t0) * 1e3)
                    outs.append(lg[:, 0])
                    t = lg[:, 0].argmax(-1)[:, None]
                    picked.append(t[:, 0].tolist())
            return outs, ms, picked

        plain, ms_plain, tok_plain = run(False)
        with self.world() as mesh, use_rules(Rules(mesh)):
            shard, ms_shard, tok_shard = run(True)
        err = max(float((a - b).abs().max()) for a, b in zip(plain, shard))
        self.expect(err <= SEQSHARD_TOL, f"seqshard logits off by {err}")
        self.expect(tok_plain == tok_shard, "seqshard greedy tokens differ")
        med = lambda v: sorted(v)[len(v) // 2]  # noqa: E731
        print(f"   {B} rows, prefill {S}, {gen} greedy steps: logits within "
              f"{err:.3g} of plain decode (tolerance {SEQSHARD_TOL}), "
              f"tokens equal; ms per step seqshard median "
              f"{med(ms_shard):.2f} (first {ms_shard[0]:.2f}), plain median "
              f"{med(ms_plain):.2f} [{self.card()}]")
        self.mesh["seqshard"] = {"ms_shard": ms_shard, "ms_plain": ms_plain,
                                 "err": err}
        del params
        if card:
            torch.cuda.empty_cache()

    # -- the mesh slice on several cards (python3 chip_smoke.py --world 4) ---
    def world_server(self, mesh):
        """The sharded server over the whole world (and over 2 shards, each
        pair of ranks reducing the whole vector), NCCL: every rank within 1
        ulp of the stacked form on its own card, the ranks' weights
        equal."""
        np, torch = self.np, self.torch
        import torch.distributed as dist
        from repro_torch.core.server import (ServerConfig, TeasqServer,
                                             make_server)
        rng = np.random.RandomState(0)
        base = self.cnn_like(50)

        def tree():
            return {k: v + torch.from_numpy((rng.randn(*v.shape) * 0.01)
                                            .astype(np.float32)).to(self.dev)
                    for k, v in base.items()}
        w0 = tree()
        entries = [(tree(), max(0, i % 4 - 1), 10 + 3 * i) for i in range(8)]
        cfg = ServerConfig(10, gamma=0.3)                  # K = 3
        ctl = TeasqServer(w0, cfg)
        ctl.active = len(entries)
        ctl.receive_many(list(entries))
        world = dist.get_world_size()
        for shards in sorted({world, 2}):
            for wave in (False, True):
                srv = make_server("sharded", w0, cfg, shards=shards)
                srv.active = len(entries)
                if wave:
                    srv.receive_many(list(entries))
                else:
                    for e in entries:
                        srv.receive(*e)
                ulp = max(self.max_ulp(srv.w[k], ctl.w[k]) for k in w0)
                flat = torch.cat([srv.w[k].reshape(-1) for k in sorted(w0)])
                bits = flat.view(torch.int32).to(torch.int64)
                h = torch.stack([bits.sum(), (bits * torch.arange(
                    bits.numel(), device=bits.device)).sum()])
                lo, hi = h.clone(), h.clone()
                dist.all_reduce(lo, op=dist.ReduceOp.MIN)
                dist.all_reduce(hi, op=dist.ReduceOp.MAX)
                self.expect(srv.n_shards == shards and srv.t == ctl.t
                            and ulp <= 1 and torch.equal(lo, hi),
                            f"sharded server over {shards} ranks "
                            f"({'wave' if wave else 'serial'}): {ulp} ulp, "
                            f"ranks equal {torch.equal(lo, hi)}")
                print(f"   server over {shards} of {world} ranks "
                      f"({'wave' if wave else 'serial'}): {srv.t} rounds, "
                      f"{ulp} ulp from the stacked form, every rank's "
                      f"weights equal")

    def world_fed(self, mesh, cpu_mesh):
        """The federated round on the (2, 2) mesh: SmolLM's smoke config on
        the cards against the same world's gloo mesh on the CPU, every
        schedule; then SmolLM-135M at full width, ms per round and B's
        launches."""
        np, torch = self.np, self.torch
        import torch.distributed as dist
        from repro_torch.configs.base import get_smoke_config
        from repro_torch.core import fed_step as FS
        from repro_torch.data import make_token_batch
        from repro_torch.kernels import ops
        from repro_torch.models import transformer as T
        from repro_torch.sharding.rules import Rules, use_rules
        from repro_torch.utils.tree import leaves, tree_map
        cfg = get_smoke_config("smollm-135m")
        w_cpu = T.init_model(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
        w_dev = tree_map(lambda v: v.to(self.dev), w_cpu)
        tok = np.random.RandomState(0).randint(0, cfg.vocab, (8, 32))
        real, seen = ops.threshold_channel_leaves, []

        def spy(rows, *a, **kw):
            seen[:] = [[r.detach().clone() for r in rows]]
            return real(rows, *a, **kw)

        for sched in ("gather_q", "gather_f32", "psum"):
            fed = FS.FedConfig(n_groups=4, local_steps=1, lr=1e-2,
                               schedule=sched)
            step = FS.make_fed_train_step(
                lambda p, b: T.lm_loss(p, b, cfg)[0], fed)
            res = {}
            for m, w, dev in ((cpu_mesh, w_cpu, "cpu"),
                              (mesh, w_dev, self.dev)):
                batch = {"tokens": torch.from_numpy(tok).to(dev)}
                stale = torch.arange(4, device=dev)
                ops.threshold_channel_leaves = spy
                try:
                    with use_rules(Rules(m)):
                        res[str(dev)] = step(w, batch, stale)
                finally:
                    ops.threshold_channel_leaves = real
            (pc, mc), (pd, md) = res["cpu"], res[str(self.dev)]
            if sched == "gather_q":
                b = torch.tensor(self.quant_bounds(seen[0], fed.p_s, fed.p_q,
                                                   fed.threshold_iters),
                                 device=self.dev)
                dist.all_reduce(b, op=dist.ReduceOp.MAX)
                a_t = float(md["alpha_t"])
                worst = self.within_quantization(
                    leaves(pd), leaves(pc), [(a_t * q, a_t * t) for q, t in
                                             b.tolist()], "(2, 2) gather_q")
            else:
                worst = max(float((x.cpu() - y).abs().max())
                            for x, y in zip(leaves(pd), leaves(pc)))
                self.expect(worst <= 1e-5, f"(2, 2) {sched}: card off the "
                            f"CPU by {worst}")
            dl = abs(float(md["local_loss"]) - float(mc["local_loss"]))
            self.expect(dl <= 1e-4, f"(2, 2) {sched}: local_loss off by {dl}")
            print(f"   (2, 2) {sched} at the smoke config: {self.dev.type} "
                  f"within {worst:.3g} of the same world's gloo mesh on the "
                  f"CPU, local_loss within {dl:.3g}")
        # SmolLM-135M at full width
        full, shp = self.smollm_cfg, self.train_shapes["smollm"]
        w0 = self.init_lm(full, 0)
        tok = make_token_batch(np.random.RandomState(0), shp["batch"],
                               shp["seq"], full.vocab)["tokens"]
        batch = {"tokens": torch.from_numpy(tok).to(self.dev)}
        stale = torch.zeros(4, dtype=torch.int32, device=self.dev)
        step = FS.make_fed_train_step(
            lambda p, b: T.lm_loss(p, b, full)[0],
            FS.FedConfig(n_groups=4, local_steps=2, lr=shp["lr"]))
        ms, launches = [], []
        with use_rules(Rules(mesh)):
            for _ in range(3):
                self.zero_counts()
                self.sync()
                t0 = time.perf_counter()
                _, met = step(w0, batch, stale)
                self.sync()
                ms.append((time.perf_counter() - t0) * 1e3)
                launches.append(self.read_counts()["topk_quant"])
        card = self.dev.type == "cuda"
        self.expect(len(set(launches)) == 1 and (launches[0] > 0) == card,
                    f"kernel B's launches a round: {launches}")
        print(f"   {full.name} (2, 2), 4 groups x 2 steps, batch "
              f"{shp['batch']} x {shp['seq']}: ms per round "
              f"{[round(x, 1) for x in ms]} (the first warms); kernel B "
              f"{launches[0]} launches a round on each rank; "
              f"{int(met['wire_bytes'])} bytes a rank on the fed "
              f"all-gather; local_loss {float(met['local_loss']):.4f} "
              f"[{self.card()}]")

    def world_seqshard(self, mesh):
        """The sequence-sharded decode of Qwen3-1.7B on the (2, 2) mesh:
        each data rank's 2 rows of 4, the cache split over ``model``,
        against plain decode of the same rows on the same card."""
        np, torch = self.np, self.torch
        from repro_torch.models import transformer as T
        from repro_torch.sharding.rules import (Rules, axis_index,
                                                local_block, use_rules)
        cfg, shp = self.qwen_cfg, self.qwen_shape
        params = self.init_lm(cfg)
        d, n_data = axis_index(mesh, "data")
        B, S, gen = shp["slots"], shp["prompt_len"], shp["gen"]
        rows = B // n_data
        toks = torch.as_tensor(np.random.RandomState(43).randint(
            0, cfg.vocab, (B, S)), device=self.dev)[d * rows:(d + 1) * rows]
        with torch.no_grad():
            logits, cache = T.prefill(params, {"tokens": toks}, cfg)
            cache = T.extend_cache(cache, S + gen)
        first = logits[:, -1].argmax(-1)[:, None]
        blocks = {k: local_block(v, (None, None, "model", None, None),
                                 mesh).contiguous() for k, v in cache.items()}

        def run(c, shard):
            t, outs, ms, picked = first, [], [], []
            with torch.no_grad():
                for i in range(gen):
                    self.sync()
                    t0 = time.perf_counter()
                    lg, c = T.decode_step(params, t, S + i, cfg, c,
                                          seq_shard_kv=shard)
                    self.sync()
                    ms.append((time.perf_counter() - t0) * 1e3)
                    outs.append(lg[:, 0])
                    t = lg[:, 0].argmax(-1)[:, None]
                    picked.append(t[:, 0].tolist())
            return outs, ms, picked

        plain, ms_plain, tok_plain = run(cache, False)
        with use_rules(Rules(mesh)):
            shard, ms_shard, tok_shard = run(blocks, True)
        err = max(float((a - b).abs().max()) for a, b in zip(plain, shard))
        self.expect(err <= SEQSHARD_TOL and tok_plain == tok_shard,
                    f"(2, 2) seqshard: logits off by {err}, tokens equal "
                    f"{tok_plain == tok_shard}")
        med = lambda v: sorted(v)[len(v) // 2]  # noqa: E731
        print(f"   {cfg.name} (2, 2): {rows} rows a data rank, prefill {S}, "
              f"the cache's {S + gen} slots split over 2 model ranks; "
              f"{gen} greedy steps within {err:.3g} of plain decode, tokens "
              f"equal; ms per step seqshard median {med(ms_shard):.2f}, "
              f"plain median {med(ms_plain):.2f} [{self.card()}]")

def get_full(cfg):
    """The registry's full config of the architecture behind ``cfg``."""
    from repro_torch.configs.base import get_config
    return get_config(cfg.name.split("/")[0])


def pending_events(eng):
    """The pending (time, kind, device, job) events of an engine or a
    fleet, in order."""
    if eng._events is not None:
        return sorted((ev[0], ev[2], ev[3], ev[4] if len(ev) == 7 else 0)
                      for ev in eng._events)
    tab = eng.devices.events
    live = [int(k) for k in (tab.time < float("inf")).nonzero()[0]]
    return sorted((float(tab.time[k]), int(tab.kind[k]), k, int(tab.task[k]))
                  for k in live)

def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def profile_b(root: str) -> int:
    """Kernel B's block channel on the CNN's 8 leaves (seeded), with the
    port of the checkout at ``root`` (this one, or an earlier one unpacked
    beside it, to compare two trees on one card): CUDA events over 50
    calls of the wrapper in the form the main path uses (one
    ``topk_quant_leaves`` where the tree has it, else one ``topk_quant``
    per leaf), the profiler's device duration per launch of kernel B, the
    synchronized host wall of the whole channel, dequant included, and,
    for a tree that spreads rows over clusters, the device duration at 1,
    2, 4 and 8 CTAs a row."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import topk_quant as B
    s = Smoke()
    xs = [v for _, v in sorted(s.cnn_like(8).items())]
    if hasattr(B, "topk_quant_leaves"):
        call = lambda: B.topk_quant_leaves(xs)            # noqa: E731
        channel = lambda: ops.compress_roundtrip_leaves(xs)  # noqa: E731
    else:
        call = lambda: [B.topk_quant(x) for x in xs]      # noqa: E731
        channel = lambda: [ops.compress_roundtrip(x)      # noqa: E731
                           for x in xs]
    B.LAUNCHES = 0
    call()
    s.sync()
    per_call = B.LAUNCHES
    channel()
    wall, _ = s.timed(channel, 50)    # before the profiler, as in phase 6
    events = time_cuda(call)
    device = kernel_device_ms(call, "topk_quant")
    sweep = {}
    if hasattr(B, "slices_for"):
        # the CTAs per row at the default block (the wrapper takes 4): the
        # device duration of one launch each, its output checked
        levels, scales, _ = B.topk_quant_rows(xs, 0.25, 8, 16,
                                              B.DEFAULT_BLOCK)
        for slices in (1, 2, 4, 8):
            run, lv, sc = b_launch(xs, B.DEFAULT_BLOCK, 16, slices)
            run()
            s.expect(torch.equal(lv, levels) and torch.equal(sc, scales),
                     f"{slices} CTAs a row differ from the wrapper")
            sweep[slices] = kernel_device_ms(run, "topk_quant")
    print(json.dumps({"tree": root, "module": B.__file__,
                      "launches_per_call": per_call, "events_ms": events,
                      "device_ms_per_launch": device,
                      "device_ms_per_call": device * per_call,
                      "channel_wall_ms": wall,
                      "device_ms_by_ctas_per_row": sweep,
                      "card": nvidia_smi()}))
    return 0


def profile_channel(root: str) -> int:
    """Kernel B's channel form at SmolLM-135M's federated-round rows (each
    leaf as (4, n) rows of seeded normal values at scale 1e-3), with the
    port of the checkout at ``root``: CUDA events over 10 calls, without
    the wire and, where the port has it, with the wire (its output held
    bit for bit against the plain version)."""
    import inspect

    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import topk_quant as B
    from repro_torch.models import transformer as T
    from repro_torch.utils.tree import leaves
    build.library()
    w = T.init_model(get_config("smollm-135m"),
                     torch.Generator(device="cuda").manual_seed(0), "cuda")
    g = torch.Generator(device="cuda").manual_seed(1)
    rows = [torch.randn((4, x.numel()), generator=g, device="cuda") * 1e-3
            for x in leaves(w)]
    del w
    args = (0.25, 8, 12)
    out = {"tree": root, "values": sum(r.numel() for r in rows),
           "nowire_ms": time_cuda(lambda: ops.threshold_channel_leaves(
               rows, *args), iters=10, warmup=2)}
    if "wire" in inspect.signature(ops.threshold_channel_leaves).parameters:
        out["wire_ms"] = time_cuda(lambda: ops.threshold_channel_leaves(
            rows, *args, wire=True), iters=10, warmup=2)
        got = ops.threshold_channel_leaves(rows, *args, wire=True)
        want = B.threshold_channel_plain(rows, *args, wire=True)
        out["wire_equal_to_plain"] = all(
            torch.equal(a.view(torch.int32), b.view(torch.int32))
            for a, b in zip(got[0] + got[2], want[0] + want[2])) and all(
            torch.equal(a, b) for a, b in zip(got[1], want[1]))
    out["card"] = nvidia_smi()
    print(json.dumps(out), flush=True)
    return 0 if out.get("wire_equal_to_plain", True) else 1


def world_rank() -> int:
    """One rank of ``--world``: the mesh slice's phases on a (2, world/2)
    mesh, NCCL for the cards and gloo for the CPU comparison (gloo alone,
    at the smoke configs, where there is no card: a rehearsal)."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_world, make_host_mesh
    card = torch.cuda.is_available()
    init_world("cuda:nccl,cpu:gloo" if card else "gloo")
    rank, world = dist.get_rank(), dist.get_world_size()
    try:
        s = Smoke(f"cuda:{torch.cuda.current_device()}" if card else "cpu",
                  ssm_smoke=not card)
        if card:
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        mesh = make_host_mesh(2, world // 2)
        cpu_mesh = make_host_mesh(2, world // 2, device="cpu") if card \
            else mesh
        print(f"rank {rank} of {world}: {s.card()}, mesh (data 2, model "
              f"{world // 2}) under {dist.get_backend()}", flush=True)
        for name, fn in (("W1. the sharded server", lambda: s.world_server(
                mesh)), ("W2. the federated round", lambda: s.world_fed(
                    mesh, cpu_mesh)), ("W3. the sequence-sharded decode",
                                       lambda: s.world_seqshard(mesh))):
            s.phase(name, fn)
        return 1 if s.failures else 0
    finally:
        dist.destroy_process_group()


def world_main(n: int) -> int:
    """``--world N``: phases W1-W3 on N cards of this host, one process a
    card (``launch.mesh.spawn_world``), after building the kernels once."""
    import torch
    if torch.cuda.device_count() < n:
        die(f"--world {n} needs {n} cards; this machine has "
            f"{torch.cuda.device_count()}")
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import spawn_world
    build.library()
    print(nvidia_smi(), flush=True)
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    t0 = time.perf_counter()
    try:
        done = spawn_world([sys.executable, os.path.abspath(__file__),
                            "--world-rank"], n, timeout=1500, env=env)
    except RuntimeError as e:
        print(e)
        die(f"the world of {n} failed")
    for rank, d in enumerate(done):
        print(d.stdout if rank == 0 else d.stdout.splitlines()[0])
    print(f"world of {n}: every rank passed W1-W3 in "
          f"{time.perf_counter() - t0:.1f} s")
    return 0


def main() -> int:
    try:
        import torch
    except ImportError:
        die("PyTorch is not installed")
    rehearse = sys.argv[1:2] == ["--world-rank"]
    if not torch.cuda.is_available() and not rehearse:
        die("no CUDA device is available: this script runs on the card")
    root = ROOT
    profile = sys.argv[1:2] in (["--profile-b"], ["--profile-channel"])
    if profile and len(sys.argv) > 2:
        root = os.path.abspath(sys.argv[2])
    sys.path.insert(0, os.path.join(root, "src"))
    try:
        import repro_torch  # noqa: F401
    except ImportError:
        die(f"{root}/src/repro_torch not found: run from the root of a "
            f"checkout")
    if sys.argv[1:2] == ["--profile-b"]:
        return profile_b(root)
    if sys.argv[1:2] == ["--profile-channel"]:
        return profile_channel(root)
    if rehearse:
        return world_rank()
    if sys.argv[1:2] == ["--world"]:
        return world_main(int(sys.argv[2]))
    s = Smoke()
    phases = [
        ("1. device and build", s.device_and_build),
        ("2. kernel A (fused_pack) against its plain version", s.kernel_a),
        ("3. kernel B (topk_quant) against its plain version", s.kernel_b),
        ("4. main path: TEASQ on the paper's CNN, 100 devices, on cuda",
         s.main_path),
        ("5. the card against the CPU", s.card_vs_cpu),
        ("6. kernel times", s.timings),
        ("7. kernel C (ssd_scan) against its plain version", s.kernel_c),
        ("8. SSM serving: Mamba2-370M at full width, on cuda", s.serve_ssm),
        ("9. the card against the CPU, SSM serving", s.ssm_card_vs_cpu),
        ("10. kernel C time", s.timings_c),
        ("11. kernel B's channel form against its plain version",
         s.channel_b),
        ("12. cohort main path: TEASQ, cohort 8, 100 devices, on cuda",
         s.cohort_path),
        ("13. the card against the CPU, cohort path", s.cohort_card_vs_cpu),
        ("14. fedasync, port, asofed, fedavg and moon", s.protocols),
        ("15. kernel B's channel form, timed", s.timings_channel),
        ("16. batched scheduler, serial handlers, against the heap",
         s.batched_vs_heap),
        ("17. wave mode at full width, dispatch regime, 100,000 devices",
         s.wave_dispatch),
        ("18. wave mode with local steps, 1,000 devices", s.wave_steps),
        ("19. the card against the CPU, wave mode", s.wave_card_vs_cpu),
        ("20. the fleet at full width: CNN TEASQ and MLP fedasync, wave "
         "mode", s.fleet_path),
        ("21. checkpoint and resume, engine and fleet", s.checkpoint_resume),
        ("22. the card against the CPU, the fleet", s.fleet_card_vs_cpu),
        ("23. kernel C at Jamba's prefill shape (N = 16, 128 heads)",
         s.kernel_c_jamba),
        ("24. LM serving: Qwen3-1.7B at full width and depth, on cuda",
         s.serve_qwen),
        ("25. hybrid serving: Jamba v0.1 at full width, one group of 8 "
         "layers, on cuda", s.serve_jamba),
        ("26. the card against the CPU, the decoder-only families",
         s.lm_card_vs_cpu),
        ("27. kernel C's gradient against autograd through its plain "
         "version", s.kernel_c_grad),
        ("28. the LM tasks: TEASQ serial (packed) and cohort 8, 100 "
         "devices, on cuda", s.lm_tasks),
        ("29. the four-family fleet at 10,000 devices, weighted then "
         "adaptive", s.four_family_fleet),
        ("30. the card against the CPU, the LM tasks",
         s.lm_card_vs_cpu_tasks),
        ("31. FL -> serve: transformer_lm and ssm_lm from their "
         "checkpoints", s.fl_to_serve),
        ("32. Whisper-tiny at full width: generate(frames=)",
         s.serve_whisper),
        ("33. InternVL2-2B at full width and depth: patches + 512 tokens",
         s.serve_vlm),
        ("34. the card against the CPU, Whisper and InternVL2",
         s.encdec_vlm_card_vs_cpu),
        ("35. kernel B's channel form at the trainer's rows against its "
         "plain version", s.channel_trainer_rows),
        ("36. the federated round at full width: SmolLM-135M, on cuda",
         s.fed_smollm),
        ("37. the federated round at full width: Mamba2-370M, on cuda",
         s.fed_mamba),
        ("38. plain AdamW at full width: Qwen3-1.7B, on cuda", s.train_qwen),
        ("39. the card against the CPU, the trainer and the legacy "
         "simulator", s.trainer_card_vs_cpu),
        ("40. the sharded server in a world of 1, and the flat body",
         s.sharded_server),
        ("41. the federated round on a (1, 1) mesh: SmolLM-135M",
         s.fed_mesh),
        ("42. the expert-parallel MoE on Jamba's group", s.ep_jamba),
        ("43. the sequence-sharded decode: Qwen3-1.7B", s.seqshard_qwen),
    ]
    chosen = None
    if sys.argv[1:2] == ["--phases"]:
        chosen = {1} | {int(n) for n in sys.argv[2].split(",")}
    t0 = time.perf_counter()
    for name, fn in phases:
        number = int(name.split(".")[0])
        if chosen is not None and number not in chosen:
            continue
        if number == 6 and phases[3][0] in s.failures:
            continue                     # kernel times need the main path
        s.phase(name, fn)
        if number == 1 and s.failures:
            die("the kernels did not build")
    print(f"total {time.perf_counter() - t0:.1f} s")
    if s.failures:
        die("failed phases: " + "; ".join(s.failures))
    if chosen is not None:
        print(f"phases {sorted(chosen)} passed; the kernels line and the "
              f"result line come only from a run of every phase")
        return 0
    print(json.dumps({"kernels": [s.kernels["fused_pack"],
                                  s.kernels["topk_quant"],
                                  s.kernels["ssd_scan"]]}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

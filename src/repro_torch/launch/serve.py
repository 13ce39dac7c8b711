"""Serving front door: batched decode plus a continuous-batching loop.

The JAX package's ``launch/serve.py`` in PyTorch.  Two entry styles:

* architecture demo -- random weights for a registry config, one batched
  ``generate`` and a ``ContinuousBatcher`` run::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \
        --batch 4 --prompt-len 512 --gen 16

* FL -> serve bridge -- the trained global model of an LM task out of a
  simulator checkpoint blob (``FLEngine.state_dict()`` or a fleet's,
  written with ``checkpoint.io.save_blob``), served through the
  continuous-batching loop::

    PYTHONPATH=src python -m repro_torch.launch.serve --from-sim ckpt \
        --task transformer_lm --job 0 --batch 4 --requests 8 --gen 16

``ContinuousBatcher`` holds a fixed number of decode slots; each step it
admits queued requests into free slots (prefill one row, splice its cache
into the batched cache) and advances every active slot one token at its
own position, so short requests free their slot for the queue instead of
waiting for the longest sequence in the batch.  It serves the
decoder-only families; an encoder-decoder (frames) or a VLM (patches)
goes through ``generate`` or ``prefill``/``decode_step``, as in the JAX
package, whose batcher prefills tokens alone.

Everything runs on the device of the parameters; ``main`` puts them on
the card unless ``--device`` names another.
"""
from __future__ import annotations

import argparse
import collections
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import get_config, get_smoke_config
from repro_torch.models import transformer as T
from repro_torch.utils.tree import resolve_device

# the JAX package's batcher splices a hybrid's SSM leaves on the wrong
# axis, so it serves a hybrid only at attn_every == 2
_HYBRID_BATCHER = ("the continuous batcher takes a hybrid only at "
                   "attn_every == 2, as the JAX package's does: "
                   "ROADMAP.md Queue C (the reference's hybrid batcher "
                   "fault); serve it through generate")


def _sync(t: torch.Tensor) -> None:
    """Wait for the device work behind ``t``."""
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


@torch.no_grad()
def generate(params, cfg, prompts, gen: int, frames=None,
             temperature: float = 0.0,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """prompts: (B, S) -> (B, S+gen) int32, greedy or, with ``temperature``
    > 0, sampled with ``generator`` (a ``torch.Generator`` on the
    parameters' device).  An encoder-decoder takes its ``frames`` (B,
    enc_seq, d_model) and prefills through ``encdec_prefill``.  Runs on
    the parameters' device."""
    if cfg.n_patches:
        raise ValueError(f"{cfg.name} ({cfg.family}) prefills its patches "
                         "with the prompt: drive prefill and decode_step")
    dev = params["embed"].device
    prompts = torch.as_tensor(prompts, dtype=torch.int32, device=dev)
    B, S = prompts.shape
    if cfg.is_encoder_decoder:
        logits, cache = T.encdec_prefill(
            params, {"tokens": prompts,
                     "frames": torch.as_tensor(frames, device=dev)},
            cfg, cache_len=S)
    else:
        logits, cache = T.prefill(params, {"tokens": prompts}, cfg)
    cache = T.extend_cache(cache, S + gen)

    def sample(lg):
        if temperature <= 0:
            return lg.argmax(-1).to(torch.int32)
        probs = torch.softmax(lg / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
            torch.int32)

    out = [prompts]
    tok = sample(logits[:, -1])[:, None]
    for i in range(gen):
        out.append(tok)
        logits, cache = T.decode_step(params, tok, S + i, cfg, cache)
        tok = sample(logits[:, -1])[:, None]
    return torch.cat(out, dim=1)


# ----------------------------------------------------------------------
# Continuous batching
# ----------------------------------------------------------------------

class ContinuousBatcher:
    """Fixed-slot greedy decode loop with per-step request admission.

    ``submit`` queues a request; each ``step`` first admits queued
    requests into free slots (one-row prefill -> ``extend_cache`` -> splice
    into slot ``s`` of the stacked cache) and then advances every active
    slot one greedy token at its own position.  A slot frees the moment
    its request reaches ``gen`` tokens, so the queue drains continuously
    instead of in lock-step batches.  Greedy only: the tokens of a request
    admitted mid-flight match a solo ``generate`` of the same prompt.

    Decode is one batched ``decode_step`` over all slots with a ``(slots,)``
    position register: set to the prompt length at admission and advanced
    by one every step, for free slots too (their write slot is clamped to
    the cache, as XLA clamps it in the JAX package).  The next-token and
    position registers live on the device, so the loop never waits for
    them between steps."""

    def __init__(self, params, cfg, slots: int = 4, cache_len: int = 64):
        if cfg.is_encoder_decoder or cfg.n_patches:
            raise ValueError(
                f"{cfg.name} ({cfg.family}) needs "
                f"{'frames' if cfg.is_encoder_decoder else 'patches'} with "
                "its prompt, and the continuous batcher prefills tokens "
                "alone, as the JAX package's does: serve it through "
                "generate (encoder-decoder) or prefill/decode_step (VLM)")
        if cfg.is_hybrid and cfg.attn_every != 2:
            raise ValueError(f"{cfg.name} has attn_every = "
                             f"{cfg.attn_every}: {_HYBRID_BATCHER}")
        self.params = params
        self.cfg = cfg
        self.slots = int(slots)
        self.cache_len = int(cache_len)
        self.device = params["embed"].device
        self._queue: collections.deque = collections.deque()
        self._next_rid = 0
        self._rid = [-1] * self.slots            # request id per slot
        self._remaining = np.zeros(self.slots, np.int64)
        self._tok = torch.zeros((self.slots, 1), dtype=torch.int32,
                                device=self.device)
        self._pos = torch.zeros(self.slots, dtype=torch.int64,
                                device=self.device)
        self._cache = None                       # built on first admission
        self._trace: List[torch.Tensor] = []     # per-step (slots, 1) tokens
        self._host_trace: List[np.ndarray] = []  # the same, copied on demand
        self._first: Dict[int, int] = {}         # rid -> prefill argmax token
        self._slots_of: Dict[int, List[Tuple[int, int]]] = {}
        self._results: Dict[int, List[int]] = {}
        self.steps = 0                           # decode steps taken

    # -- request intake --------------------------------------------------
    def submit(self, prompt, gen: int) -> int:
        """Queue a request; returns its id.  ``prompt`` is a 1-D token
        array; ``gen`` >= 1 tokens will be generated."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if gen < 1:
            raise ValueError("gen must be >= 1")
        if prompt.size + gen > self.cache_len:
            raise ValueError(f"prompt ({prompt.size}) + gen ({gen}) exceeds "
                             f"cache_len ({self.cache_len})")
        rid = self._next_rid
        self._next_rid += 1
        self._queue.append((rid, prompt, int(gen)))
        return rid

    def result(self, rid: int) -> List[int]:
        """Generated tokens so far for request ``rid`` (length ``gen`` once
        the request has completed).  Token values come off the device
        lazily here; the decode loop itself never waits for them."""
        if rid in self._results:
            return list(self._results[rid])
        while len(self._host_trace) < len(self._trace):
            self._host_trace.append(
                self._trace[len(self._host_trace)].cpu().numpy())
        toks = [self._first[rid]]
        toks += [int(self._host_trace[k][s, 0]) for k, s in
                 self._slots_of[rid]]
        if rid not in self._rid:                 # completed: freeze
            self._results[rid] = toks
        return list(toks)

    def pending(self) -> bool:
        return bool(self._queue) or any(r >= 0 for r in self._rid)

    # -- the loop --------------------------------------------------------
    def _admit(self) -> List[int]:
        """Fill free slots from the queue.  Returns rids that completed at
        admission (gen == 1: the prefill token is the whole answer)."""
        done = []
        for s in range(self.slots):
            if self._rid[s] >= 0 or not self._queue:
                continue
            rid, prompt, gen = self._queue.popleft()
            logits, one = T.prefill(
                self.params, {"tokens": torch.as_tensor(
                    prompt[None, :], device=self.device)}, self.cfg)
            one = T.extend_cache(one, self.cache_len)
            first = int(logits[0, -1].argmax())
            self._first[rid] = first
            self._slots_of[rid] = []
            if gen == 1:
                done.append(rid)
                continue
            if self._cache is None:
                self._cache = T.batched_cache_zeros(one, self.slots)
            T.splice_cache_row(self._cache, one, s)
            # a new token register: the old one may be in the trace
            self._tok = self._tok.clone()
            self._tok[s, 0] = first
            self._pos[s] = prompt.size
            self._rid[s] = rid
            self._remaining[s] = gen - 1
        return done

    @torch.no_grad()
    def step(self) -> List[int]:
        """Admit from the queue, then advance every active slot one token.
        Returns the rids that completed this step."""
        done = self._admit()
        if not any(r >= 0 for r in self._rid):
            return done
        logits, self._cache = T.decode_step(self.params, self._tok,
                                            self._pos, self.cfg, self._cache)
        # a free slot decodes garbage harmlessly until it is re-admitted
        self._tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        self._pos = self._pos + 1
        self._trace.append(self._tok)
        k = self.steps
        self.steps += 1
        for s in range(self.slots):
            if self._rid[s] < 0:
                continue
            self._slots_of[self._rid[s]].append((k, s))
            self._remaining[s] -= 1
            if self._remaining[s] == 0:
                done.append(self._rid[s])
                self._rid[s] = -1
        return done

    def run(self, prompts, gen: int) -> Tuple[List[List[int]], List[float]]:
        """Drive a workload to completion: submit every prompt up front,
        step until the queue drains.  Returns (per-request token lists,
        per-request wall-clock completion latencies in seconds, both in
        submit order).  Latency stamps wait for the completing step's
        device work, so they measure computed tokens, not launches."""
        rids = [self.submit(p, gen) for p in prompts]
        t0 = time.perf_counter()
        lat: Dict[int, float] = {}
        while self.pending():
            finished = self.step()
            if finished:
                _sync(self._tok)
                now = time.perf_counter() - t0
                for rid in finished:
                    lat[rid] = now
        return [self.result(r) for r in rids], [lat[r] for r in rids]


# ----------------------------------------------------------------------
# FL -> serve bridge
# ----------------------------------------------------------------------

def load_task_params(path: str, task_name: str, job: int = 0, device=None):
    """Rebuild a trained LM's weights from a simulator checkpoint blob.

    Resolves ``task_name`` in the FL task registry for the weight tree's
    structure (``task.init_params`` on a seeded generator) and its
    transformer ``ModelConfig``, then reads the global weights out of the
    engine or fleet blob at ``path`` (``job`` picks the job inside a fleet
    blob), on ``device`` (the card unless another is named).  Returns
    ``(params, cfg)``."""
    from repro_torch.checkpoint.io import load_sim_params
    from repro_torch.fl.tasks import get_task
    task = get_task(task_name)
    if task.model_cfg is None:
        raise ValueError(f"task {task_name!r} is not an LM family -- "
                         "it has no transformer ModelConfig to serve")
    like = task.init_params(torch.Generator().manual_seed(0), "cpu")
    params = load_sim_params(path, like, task=job, device=device)
    return params, task.model_cfg


def serve_from_sim(path: str, task_name: str, job: int, batch: int,
                   requests: int, prompt_len: int, gen: int,
                   seed: int = 0, device=None
                   ) -> Tuple[List[List[int]], List[float]]:
    """Serve ``requests`` seeded prompts from the weights of job ``job``
    of the checkpoint at ``path`` through the continuous batcher; prints
    the throughput and returns (tokens, latencies) per request."""
    params, cfg = load_task_params(path, task_name, job, device)
    rng = np.random.RandomState(seed)
    prompts = [rng.randint(0, cfg.vocab, prompt_len).astype(np.int32)
               for _ in range(requests)]
    cb = ContinuousBatcher(params, cfg, slots=batch,
                           cache_len=prompt_len + gen)
    t0 = time.perf_counter()
    outs, lat = cb.run(prompts, gen)
    dt = time.perf_counter() - t0
    toks = sum(len(o) for o in outs)
    print(f"[serve] {cfg.name} from {path} on {params['embed'].device}: "
          f"{requests} requests x gen={gen} over {batch} slots in "
          f"{dt:.2f}s ({toks / dt:.1f} tok/s, p50 latency "
          f"{np.percentile(lat, 50) * 1e3:.0f} ms)")
    print("[serve] first request tokens:", outs[0])
    return outs, lat


def main(argv=None) -> Optional[Tuple[List[List[int]], List[float]]]:
    """The command line (see the module docstring); with ``--from-sim``
    returns what :func:`serve_from_sim` returns."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--from-sim", default=None, metavar="CKPT",
                    help="serve trained weights from an engine/fleet "
                         "checkpoint blob instead of random --arch init")
    ap.add_argument("--task", default="transformer_lm",
                    help="FL task registry name behind --from-sim")
    ap.add_argument("--job", type=int, default=0,
                    help="task slot inside a fleet checkpoint blob")
    ap.add_argument("--requests", type=int, default=8,
                    help="workload size for the continuous-batching loop")
    ap.add_argument("--batch", type=int, default=4,
                    help="rows of the batched generate, and decode slots "
                         "of the continuous batcher")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    if args.from_sim is not None:
        return serve_from_sim(args.from_sim, args.task, args.job,
                              args.batch, args.requests, args.prompt_len,
                              args.gen, args.seed, dev)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = T.init_model(cfg, gen, dev)
    rng = np.random.RandomState(args.seed)
    prompts = rng.randint(0, cfg.vocab, (args.batch, args.prompt_len))
    frames = None
    if cfg.is_encoder_decoder:
        frames = torch.from_numpy(rng.randn(
            args.batch, cfg.enc_seq, cfg.d_model).astype(np.float32))

    t0 = time.perf_counter()
    seqs = generate(params, cfg, prompts, args.gen, frames,
                    args.temperature, gen)
    _sync(seqs)
    dt = time.perf_counter() - t0
    print(f"[serve] {cfg.name} on {dev}: batch={args.batch} "
          f"prompt={args.prompt_len} gen={args.gen} in {dt:.2f}s "
          f"({args.batch * args.gen / dt:.1f} tok/s)")
    print("[serve] first sequence tail:", seqs[0, -8:].tolist())

    if args.requests > 0 and not (cfg.is_encoder_decoder or cfg.n_patches):
        reqs = [rng.randint(0, cfg.vocab, args.prompt_len)
                for _ in range(args.requests)]
        cb = ContinuousBatcher(params, cfg, slots=args.batch,
                               cache_len=args.prompt_len + args.gen)
        t0 = time.perf_counter()
        outs, lat = cb.run(reqs, args.gen)
        dt = time.perf_counter() - t0
        toks = sum(len(o) for o in outs)
        print(f"[serve] continuous batching: {args.requests} requests x "
              f"gen={args.gen} over {args.batch} slots in {dt:.2f}s "
              f"({toks / dt:.1f} tok/s, p50 latency "
              f"{np.percentile(lat, 50) * 1e3:.0f} ms)")
        print("[serve] first request tokens:", outs[0])
    return None


if __name__ == "__main__":
    main()

"""Inputs of a run, all drawn from ``--seed``.

The seed is spread by ``numpy.random.SeedSequence`` into one stream for
the weights (a ``torch.Generator`` on the run's device), one for the token
batches and one for the staleness of each round, so any whole number
serves as a seed and the same seed gives the same inputs.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

WEIGHTS, TOKENS, STALENESS = range(3)


def stream_seed(seed: int, which: int) -> int:
    """A 63-bit seed of stream ``which`` of ``seed``."""
    state = np.random.SeedSequence([abs(int(seed)), int(seed < 0),
                                    which]).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def weight_generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        stream_seed(seed, WEIGHTS))


def make_token_batch(rng: np.random.RandomState, batch: int, seq: int,
                     vocab: int) -> np.ndarray:
    """(batch, seq) int32 tokens: uniform ids whose second half repeats the
    first half plus one, so a sequence has structure to learn (the port's
    ``data/synthetic.py::make_token_batch``, written out again)."""
    base = rng.randint(0, vocab, size=(batch, seq), dtype=np.int64)
    half = seq // 2
    base[:, half:half * 2] = (base[:, :half] + 1) % vocab
    return base.astype(np.int32)


class RoundFeed:
    """The rounds' inputs in order: each ``next()`` gives one round's token
    batch (on ``device``) and its (G,) int32 staleness, uniform on 0 ..
    ``max_staleness`` rounds, as an asynchronous round sees its groups'
    updates arrive late."""

    def __init__(self, seed: int, traffic: Dict, vocab: int, device):
        self.tok = np.random.RandomState(
            stream_seed(seed, TOKENS) % 2 ** 32)
        self.stale = np.random.RandomState(
            stream_seed(seed, STALENESS) % 2 ** 32)
        self.batch, self.seq = traffic["batch"], traffic["seq"]
        self.groups = traffic["groups"]
        self.max_stale = traffic["max_staleness"]
        self.vocab, self.device = vocab, torch.device(device)

    def next_host(self):
        tokens = make_token_batch(self.tok, self.batch, self.seq, self.vocab)
        stale = self.stale.randint(0, self.max_stale + 1, size=self.groups)
        return tokens, stale.astype(np.int32)

    def next(self):
        tokens, stale = self.next_host()
        return (torch.from_numpy(tokens).to(self.device),
                torch.from_numpy(stale).to(self.device))

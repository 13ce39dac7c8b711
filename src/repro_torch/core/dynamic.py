"""Algorithm 5: dynamic data compression — greedy (p_s, p_q) search + decay.

Greedy profiling (lines 1-12): starting from no compression, alternately
increase the sparsification compression rate while the accuracy drop on a
profiling model stays within ``theta``, then step up quantization, backing
off sparsification when the combination overshoots.

Decay schedule (lines 13-18): start one notch *more* compressed than the
searched static point (p_{s,0}, p_{q,0}) and decay the compression every
``step_size`` rounds toward no compression — aggressive wire savings early,
full fidelity late.  (The paper's prose is ambiguous about decay direction;
Fig. 7/Table 5 — TEASQ faster than TEA-Fed early AND higher final accuracy
than TEAStatic — is only consistent with decaying *toward less compression*,
which is what we implement.)

Beyond the paper: :func:`greedy_search_per_tier` runs one budgeted search
per bandwidth tier (monotone: slower links end at least as compressed),
feeding the ``tier_aware`` per-device codec policy in
``repro_torch.fl.policies`` (``SimConfig.tier_points``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Sequence, Tuple

# candidate sets, ordered from least to most compressed (paper Set_s / Set_q)
DEFAULT_SET_S: Tuple[float, ...] = (1.0, 0.5, 0.25, 0.1, 0.05, 0.01)
DEFAULT_SET_Q: Tuple[int, ...] = (32, 16, 8, 4)


@dataclasses.dataclass
class CompressionSchedule:
    """Per-round (p_s, p_q) from the decayed dynamic schedule."""
    p_s0_idx: int
    p_q0_idx: int
    step_size: int
    set_s: Sequence[float] = DEFAULT_SET_S
    set_q: Sequence[int] = DEFAULT_SET_Q

    def at_round(self, t: int) -> Tuple[float, int]:
        decay = t // self.step_size
        si = max(0, self.p_s0_idx - decay)
        qi = max(0, self.p_q0_idx - decay)
        return self.set_s[si], self.set_q[qi]


def greedy_search(eval_acc: Callable[[float, int], float],
                  theta: float,
                  set_s: Sequence[float] = DEFAULT_SET_S,
                  set_q: Sequence[int] = DEFAULT_SET_Q,
                  ) -> Tuple[int, int, List[Tuple[float, int, float]]]:
    """Algorithm 5 lines 1-12.

    ``eval_acc(p_s, p_q)`` returns test accuracy of the profiling model after
    a compress->decompress round trip.  Returns (idx_s, idx_q) of the chosen
    static point plus the search trace.
    """
    base_acc = eval_acc(1.0, 32)
    floor = base_acc - theta
    trace: List[Tuple[float, int, float]] = []

    si, qi = 0, 0  # least compressed
    # lines 5-7: push sparsification alone as far as the budget allows
    while si + 1 < len(set_s):
        acc = eval_acc(set_s[si + 1], set_q[qi])
        trace.append((set_s[si + 1], set_q[qi], acc))
        if acc >= floor:
            si += 1
        else:
            break

    # lines 4-12: alternately push quantization, backing off sparsification
    while qi + 1 < len(set_q):
        acc = eval_acc(set_s[si], set_q[qi + 1])
        trace.append((set_s[si], set_q[qi + 1], acc))
        if acc >= floor:
            qi += 1
            # try to push sparsification further at the new quantization
            while si + 1 < len(set_s):
                acc = eval_acc(set_s[si + 1], set_q[qi])
                trace.append((set_s[si + 1], set_q[qi], acc))
                if acc >= floor:
                    si += 1
                else:
                    break
        else:
            # back off sparsification until the combo fits again (lines 9-11)
            backed = False
            si_save = si
            while si > 0:
                si -= 1
                acc = eval_acc(set_s[si], set_q[qi + 1])
                trace.append((set_s[si], set_q[qi + 1], acc))
                if acc >= floor:
                    qi += 1
                    backed = True
                    break
            if not backed:
                si = si_save   # quantization step unaffordable at any p_s
                break
    return si, qi, trace


def greedy_search_per_tier(eval_acc: Callable[[float, int], float],
                           theta: float,
                           bandwidth_scales: Sequence[float],
                           set_s: Sequence[float] = DEFAULT_SET_S,
                           set_q: Sequence[int] = DEFAULT_SET_Q,
                           ) -> Tuple[List[Tuple[int, int]],
                                      List[List[Tuple[float, int, float]]]]:
    """Per-tier extension of Algorithm 5 for heterogeneous fleets.

    Tier ``i`` (link scaling ``bandwidth_scales[i]``; < 1 = slower) gets its
    own greedy search with accuracy budget ``theta * max(1, 1/b_i)`` — a
    link with 1/4 the bandwidth buys its 4x wire saving with a
    proportionally larger accuracy allowance, which is the wire-cost/model-
    quality trade TimelyFL-style heterogeneity adaptation makes per device.
    Tiers are searched fastest-first with a monotone clamp: a slower tier is
    never *less* compressed than a faster one, so per-transfer wire bytes
    are non-increasing as links get slower (the property the ``tier_aware``
    codec policy and its tests rely on).

    Returns ``(points, traces)`` in input tier order, where ``points[i] =
    (si, qi)`` indexes ``set_s`` / ``set_q``.

    ``eval_acc`` is memoized per operating point across the tier searches
    (each profile eval is a full codec roundtrip + model eval — seconds on
    CPU — and every tier's search revisits the baseline and the shallow
    points), so N tiers cost roughly one search's worth of *distinct*
    evals, and all tiers judge a point by the same measured accuracy.
    """
    scales = [float(b) for b in bandwidth_scales]
    memo: dict = {}

    def cached_eval(p_s: float, p_q: int) -> float:
        key = (p_s, p_q)
        if key not in memo:
            memo[key] = eval_acc(p_s, p_q)
        return memo[key]

    order = sorted(range(len(scales)), key=lambda i: -scales[i])
    points: List[Tuple[int, int]] = [(0, 0)] * len(scales)
    traces: List[List[Tuple[float, int, float]]] = [[] for _ in scales]
    prev_s = prev_q = 0
    for i in order:
        tier_theta = theta * max(1.0, 1.0 / max(scales[i], 1e-9))
        si, qi, trace = greedy_search(cached_eval, tier_theta, set_s, set_q)
        si, qi = max(si, prev_s), max(qi, prev_q)
        points[i] = (si, qi)
        traces[i] = trace
        prev_s, prev_q = si, qi
    return points, traces


def make_schedule(si: int, qi: int, total_rounds: int,
                  set_s: Sequence[float] = DEFAULT_SET_S,
                  set_q: Sequence[int] = DEFAULT_SET_Q,
                  n_decay_steps: int = 4) -> CompressionSchedule:
    """Lines 13-18: start one notch more compressed than the static point,
    decay every ``total_rounds / n_decay_steps`` rounds."""
    s0 = min(si + 1, len(set_s) - 1)
    q0 = min(qi + 1, len(set_q) - 1)
    step = max(1, total_rounds // n_decay_steps)
    return CompressionSchedule(s0, q0, step, set_s, set_q)

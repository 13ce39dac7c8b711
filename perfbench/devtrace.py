"""The profiled window of a ``--trace 1`` run, read from the profiler's
raw (kineto) events.

* busy: the union of the device's activity intervals (kernels, copies,
  sets) inside the host's window;
* per kernel: launches and device seconds, by a short name;
* idle gaps: each stretch of the window in which the device ran nothing,
  named by what the host was doing when it ended: the innermost of the
  harness's own ``record_function`` spans and the outermost PyTorch
  operator around the launch that ended it.

The profiler is known to lose device records now and then (whole windows
with no device event, or fewer launches than were made), so the caller
holds the records of the port's kernels against the port's launch
counters before it trusts a share read from them.
"""
from __future__ import annotations

import bisect
import re
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

def short_name(name: str, width: int = 96) -> str:
    """A kernel's name without its return type, anonymous namespace and
    parameter list; a name in parentheses (an activity named by the call
    that launched it) as it is."""
    s = re.sub(r"^void\s+", "", name.strip())
    s = s.replace("(anonymous namespace)::", "")
    depth, cut = 0, len(s)
    for i, ch in enumerate(s):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and i > 0:
            cut = i
            break
    return s[:cut][:width]


@dataclass
class Window:
    """What one profiled window read."""
    window_s: float = 0.0
    busy_s: float = 0.0
    kernels: Dict[str, List[float]] = field(default_factory=dict)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)

    def launches(self, *parts: str) -> int:
        return int(sum(v[0] for k, v in self.kernels.items()
                       if any(p in k for p in parts)))

    def device_s(self, *parts: str) -> float:
        return sum(v[1] for k, v in self.kernels.items()
                   if any(p in k for p in parts))

    def device_ops(self, n: int = 10) -> List[List]:
        top = sorted(self.kernels.items(), key=lambda kv: -kv[1][1])[:n]
        return [[short_name(k), v[1]] for k, v in top]


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _covering(spans, t):
    """The spans of ``spans`` (start, end, name; sorted by start) that
    hold ``t``, outermost first."""
    i = bisect.bisect_right(spans, (t, float("inf"), ""))
    return [s for s in spans[:i] if s[1] >= t]


def _outermost(ops):
    """Of ``ops`` (start, end, name; sorted by start) those that no
    earlier one holds: disjoint, so a bisection finds the one at a
    time."""
    out = []
    for o in ops:
        if not out or o[0] >= out[-1][1]:
            out.append(o)
    return out


def _at(top, starts, t):
    i = bisect.bisect_right(starts, t) - 1
    return top[i][2] if i >= 0 and top[i][1] >= t else "no operator"


WINDOW_SPAN = "profiled window"
# the harness's own record_function spans (perfbench.runners)
SPANS = (WINDOW_SPAN, "batch copy", "round", "synchronize", "channel")
RUNTIME = re.compile(r"^cu[A-Z]|^cuda[A-Z]")


def _times(e):
    if hasattr(e, "start_ns"):
        return e.start_ns(), e.start_ns() + e.duration_ns()
    return e.start_us() * 1000, (e.start_us() + e.duration_us()) * 1000


def classify(e) -> str:
    """``kernel`` (any device activity), ``span`` (the harness's own
    spans, on the host), ``runtime`` (a call into CUDA's libraries),
    ``op`` (a host operator) or ``other``.  Read from the event's kind
    where this build of PyTorch records it, else from its device and
    name."""
    kind = e.activity_type() if hasattr(e, "activity_type") else None
    name = e.name()
    if kind is not None:
        if kind.startswith("cuda_"):      # the runtime's and the lower API's
            return "runtime"
        return {"kernel": "kernel", "gpu_memcpy": "kernel",
                "gpu_memset": "kernel", "user_annotation": "span",
                "cpu_op": "op"}.get(kind, "other")
    if str(e.device_type()).endswith("CUDA"):
        return "other" if name in SPANS else "kernel"
    if name in SPANS:
        return "span"
    return "runtime" if RUNTIME.match(name) else "op"


def read_window(events, n_gaps: int = 10) -> Window:
    """Read the raw events of a window: the host's span named
    :data:`WINDOW_SPAN`, which ends after the device has synchronized."""
    dev, launch_at, ops, spans = [], {}, [], []
    for e in events:
        kind = classify(e)
        start, end = _times(e)
        if kind == "kernel":
            dev.append((start, end, e.name(), e.correlation_id()))
        elif kind == "runtime":
            launch_at[e.correlation_id()] = (start, e.name())
        elif kind == "span":
            spans.append((start, end, e.name()))
        elif kind == "op":
            ops.append((start, end, e.name()))
    held = [s for s in spans if s[2] == WINDOW_SPAN]
    if len(held) != 1:
        raise RuntimeError(f"the profiled window's span was recorded "
                           f"{len(held)} times")
    t0_ns, t1_ns = held[0][0], held[0][1]
    w = Window(window_s=(t1_ns - t0_ns) / 1e9)
    # an activity the profiler left unnamed is named by the call that
    # launched it
    inside = [(max(s, t0_ns), min(e, t1_ns),
               n or f"({launch_at.get(c, (0, 'unknown call'))[1]})", c)
              for s, e, n, c in dev if e > t0_ns and s < t1_ns]
    for s, e, n, _ in inside:
        k = w.kernels.setdefault(n, [0, 0.0])
        k[0] += 1
        k[1] += (e - s) / 1e9
    merged = _merge([(s, e) for s, e, _, _ in inside])
    w.busy_s = sum(e - s for s, e in merged) / 1e9
    spans.sort()
    top = _outermost(sorted(ops))
    top_starts = [o[0] for o in top]
    starts = {}
    for s, _, _, c in inside:
        starts.setdefault(s, c)
    gaps: Dict[str, float] = {}
    edges = [t0_ns] + [x for iv in merged for x in iv] + [t1_ns]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        at = launch_at.get(starts.get(b), (b,))[0]
        span = _covering(spans, at)
        name = ((span[-1][2] if span else "outside the harness's spans")
                + " / " + _at(top, top_starts, at))
        gaps[name] = gaps.get(name, 0.0) + (b - a) / 1e9
    w.idle_gaps = sorted(gaps.items(), key=lambda kv: -kv[1])[:n_gaps]
    return w

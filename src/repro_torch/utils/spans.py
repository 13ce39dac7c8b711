"""Named spans of the federated round, recorded only while a profiler is.

``with span("fed.grad"):`` marks a stretch of the program.  While no
``torch.profiler.profile`` records, a span is one check of
``torch.autograd._profiler_enabled()`` and nothing else.  While one
records, a span

* opens a range named ``name`` in the profiler's trace, on its clock:
  a host-side range recorded as an operator is (``_RecordFunctionFast``).
  ``torch.profiler.record_function`` would record a user annotation,
  which the profiler mirrors onto the device's timeline as an activity
  spanning the kernels launched inside it, idle stretches included, and
  a reader of the device's records that does not know its kind takes it
  for work;
* keeps a :class:`Record`: its name, its parent span, its round, its host
  start and end by ``time.time_ns()`` (the clock of the profiler's
  events), and, where the round runs on a CUDA device, a pair of timing
  events on the current stream;
* counts how often each name opened in the round.

A record's parent is the innermost span open on its thread.  A span
opened on a thread with none open (the autograd engine's, running a
backward pass on the card) takes the innermost span open on the thread
that opened the round: the ``fed.grad`` that started the backward.

Records are kept only inside a round, the span named :data:`ROUND`;
:func:`rounds` returns the last :data:`KEEP` finished ones as
:class:`Round` trees.  Their events are read when asked for, so the
caller synchronizes the device first.  The tracer exports nothing of its
own: the spans reach any trace the profiler exports.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from typing import Deque, Dict, List, Optional

import torch

from repro_torch.utils.tree import leaves

__all__ = ["KEEP", "ROUND", "Record", "Round", "rounds", "span"]

ROUND = "fed.round"
# finished rounds kept for :func:`rounds`
KEEP = 8

_OFF = contextlib.nullcontext()
_local = threading.local()
_open: Dict[str, object] = {"round": None, "owner": None}
_done: Deque["Round"] = collections.deque(maxlen=KEEP)
_round_ids = itertools.count()


class Record:
    """One span's run: host stamps (ns) and, on a card, its events."""

    __slots__ = ("name", "parent", "round_id", "start_ns", "end_ns",
                 "events", "children")

    def __init__(self, name: str, parent: Optional["Record"],
                 round_id: int, events):
        self.name, self.parent, self.round_id = name, parent, round_id
        self.events = events
        self.children: List[Record] = []
        self.start_ns = self.end_ns = 0

    def device_ms(self) -> Optional[float]:
        """The device's ms from the span's start to its end on its
        stream; None without events."""
        if self.events is None:
            return None
        start, end = self.events
        return start.elapsed_time(end)

    def self_device_ms(self) -> Optional[float]:
        """:meth:`device_ms` less its children's; None where any lacks
        events."""
        total = self.device_ms()
        kids = [c.device_ms() for c in self.children]
        if total is None or None in kids:
            return None
        return total - sum(kids)


class Round:
    """The records of one finished round: ``root`` (the :data:`ROUND`
    span), ``counts`` (opens per name) and every record by name."""

    def __init__(self, root: Record):
        self.root = root
        self.by_name: Dict[str, List[Record]] = {}
        todo = [root]
        while todo:
            r = todo.pop()
            self.by_name.setdefault(r.name, []).append(r)
            todo.extend(r.children)
        self.counts = {k: len(v) for k, v in self.by_name.items()}

    def records(self, name: str) -> List[Record]:
        return self.by_name.get(name, [])

    def device_ms(self, name: str, own: bool = False) -> Optional[float]:
        """The summed device ms of the round's spans named ``name``
        (``own``: their self ms); None where there is none or one lacks
        events."""
        got = [r.self_device_ms() if own else r.device_ms()
               for r in self.records(name)]
        if not got or None in got:
            return None
        return sum(got)


def rounds() -> List[Round]:
    """The last :data:`KEEP` finished rounds, oldest first."""
    return list(_done)


def _stack() -> List[Record]:
    s = getattr(_local, "stack", None)
    if s is None:
        s = _local.stack = []
    return s


class _Span:
    __slots__ = ("name", "on", "rf", "rec")

    def __init__(self, name: str, on):
        self.name, self.on = name, on
        self.rf = self.rec = None

    def __enter__(self):
        try:
            rf = torch._C._profiler._RecordFunctionFast(self.name)
            rf.__enter__()
            self.rf = rf
        except Exception:       # the round runs on without the trace's span
            self.rf = None
        stack = _stack()
        rnd = _open["round"]
        if rnd is None and self.name != ROUND:
            return self
        if rnd is None:
            parent, rid = None, next(_round_ids)
            on = self.on
            if on is not None and not isinstance(on, torch.Tensor):
                on = leaves(on)[0]
            cuda = on is not None and on.is_cuda
        else:
            parent = (stack or _open["owner"])[-1]
            rid = rnd.round_id
            cuda = rnd.events is not None
        events = None
        if cuda:
            events = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        rec = self.rec = Record(self.name, parent, rid, events)
        if parent is None:
            _open["round"], _open["owner"] = rec, stack
        else:
            parent.children.append(rec)
        stack.append(rec)
        rec.start_ns = time.time_ns()
        if events is not None:
            events[0].record()
        return self

    def __exit__(self, *exc):
        rec = self.rec
        if rec is not None:
            if rec.events is not None:
                rec.events[1].record()
            rec.end_ns = time.time_ns()
            stack = _stack()
            if stack and stack[-1] is rec:
                stack.pop()
            if rec.parent is None:
                _open["round"] = _open["owner"] = None
                _done.append(Round(rec))
        if self.rf is not None:
            try:
                self.rf.__exit__(*exc)
            except Exception:
                pass
        return False


def span(name: str, on=None):
    """A context that marks ``name`` while a profiler records, and does
    nothing else otherwise.  ``on``: a tensor, or a tree of them, on the
    device a :data:`ROUND` span's work runs on (a CUDA device gives its
    records timing events); the spans inside a round take the round's."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return _Span(name, on)

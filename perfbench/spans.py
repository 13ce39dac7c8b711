"""The port's spans of its round (``repro_torch.utils.spans``) as the
per-layer metrics read them: the records of a ``--trace 1`` run's
profiled rounds, which the tracer keeps while the runner's profiler
records.  A run off the card, or a program without the tracer, gives
nothing to read."""
from __future__ import annotations

from typing import List, Optional


def profiled_rounds(res, spec) -> List:
    """The tracer's rounds of the run's profiled window, oldest first;
    empty where there are none to read."""
    if spec.device != "cuda" or not res.trace_rounds:
        return []
    try:
        from repro_torch.utils import spans
    except ImportError:
        return []
    got = spans.rounds()[-res.trace_rounds:]
    return got if len(got) == res.trace_rounds else []


def ms_per_round(res, spec, name: str, own: bool = False
                 ) -> Optional[float]:
    """The device ms a profiled round of the spans named ``name`` (``own``:
    their self ms, their children's left out); None where a round has no
    such span or one lacks device times."""
    rounds = profiled_rounds(res, spec)
    got = [r.device_ms(name, own=own) for r in rounds]
    if not got or None in got:
        return None
    return sum(got) / len(got)

"""The readers of the port's spans (``perfbench/spans.py`` and the five
``metrics/*_ms_per_round.py``) on made-up round records: device ms and
self ms a round, the mean over a window's profiled rounds, and nothing
to read off the card, with no records, or with a port that has no
tracer."""
import dataclasses
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from perfbench import harness, testing  # noqa: E402
from perfbench import spans as S  # noqa: E402
from perfbench.runners.fed_round import RoundResult  # noqa: E402
from repro_torch.utils import spans  # noqa: E402

READS = ("forward_ms_per_round", "recompute_ms_per_round",
         "backward_ms_per_round", "prox_ms_per_round", "combine_ms_per_round")
CELLS = [w["name"] for w in harness.load_benchmark()["workloads"]]


class Event:
    """A timing event at ``t`` ms."""

    def __init__(self, t):
        self.t = t

    def elapsed_time(self, end):
        return end.t - self.t


def _rec(name, parent, t0, t1, timed=True):
    r = spans.Record(name, parent, 0, (Event(t0), Event(t1)) if timed
                     else None)
    if parent is not None:
        parent.children.append(r)
    return r


def make_round(scale=1.0, timed=True):
    """A round of 2 local steps, each with its forward, 2 recomputes and
    the prox update, and the combine with its channel; times in ms."""
    s = scale
    root = _rec("fed.round", None, 0, 1000 * s, timed)
    t = 1.0 * s
    for _ in range(2):
        g = _rec("fed.grad", root, t, t + 400 * s, timed)
        _rec("lm.loss", g, t, t + 100 * s, timed)
        _rec("remat.recompute", g, t + 150 * s, t + 200 * s, timed)
        _rec("remat.recompute", g, t + 250 * s, t + 310 * s, timed)
        _rec("fed.prox", root, t + 400 * s, t + 405 * s, timed)
        t += 410 * s
    c = _rec("fed.combine", root, t, t + 30 * s, timed)
    _rec("fed.compress", c, t + 10 * s, t + 18 * s, timed)
    return spans.Round(root)


# per round at scale 1: each metric's ms
ONE = {"forward_ms_per_round": 200.0, "recompute_ms_per_round": 220.0,
       "backward_ms_per_round": 800.0 - 200.0 - 220.0,
       "prox_ms_per_round": 10.0, "combine_ms_per_round": 22.0}


def _read(metric, rounds, monkeypatch, trace_rounds=None, device="cuda"):
    monkeypatch.setattr(spans, "rounds", lambda: list(rounds))
    res = SimpleNamespace(trace_rounds=len(rounds) if trace_rounds is None
                          else trace_rounds)
    return harness.reader(metric).read(res, SimpleNamespace(device=device))


@pytest.mark.parametrize("metric", READS)
def test_a_reader_gives_its_spans_ms_a_round(metric, monkeypatch):
    got = _read(metric, [make_round()], monkeypatch)
    assert got == pytest.approx(ONE[metric])


@pytest.mark.parametrize("metric", READS)
def test_a_reader_averages_the_profiled_rounds_only(metric, monkeypatch):
    # an older round (not profiled in this window) at 10x is left out
    rounds = [make_round(10.0), make_round(1.0), make_round(3.0)]
    got = _read(metric, rounds, monkeypatch, trace_rounds=2)
    assert got == pytest.approx(2.0 * ONE[metric])


@pytest.mark.parametrize("metric", READS)
def test_a_reader_finds_nothing_to_read(metric, monkeypatch):
    assert _read(metric, [make_round()], monkeypatch, device="cpu") is None
    assert _read(metric, [], monkeypatch, trace_rounds=1) is None
    assert _read(metric, [make_round()], monkeypatch, trace_rounds=2) \
        is None
    assert _read(metric, [make_round()], monkeypatch, trace_rounds=0) \
        is None
    assert _read(metric, [make_round(timed=False)], monkeypatch) is None


def test_a_round_without_the_span_gives_nothing(monkeypatch):
    root = _rec("fed.round", None, 0, 10)
    _rec("fed.combine", root, 1, 9)
    got = _read("prox_ms_per_round", [spans.Round(root)], monkeypatch)
    assert got is None
    assert _read("combine_ms_per_round", [spans.Round(root)],
                 monkeypatch) == pytest.approx(8.0)


def test_a_port_without_the_tracer_gives_nothing(monkeypatch):
    import repro_torch.utils
    monkeypatch.setattr(spans, "rounds", lambda: [make_round()])
    monkeypatch.delattr(repro_torch.utils, "spans")
    monkeypatch.setitem(sys.modules, "repro_torch.utils.spans", None)
    res = SimpleNamespace(trace_rounds=1)
    assert S.profiled_rounds(res, SimpleNamespace(device="cuda")) == []
    for metric in READS:
        assert harness.reader(metric).read(
            res, SimpleNamespace(device="cuda")) is None


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_line_off_the_card_leaves_them_out(cell):
    bench = harness.load_benchmark()
    names = {m["name"] for m in harness.metrics_of(bench, cell, True)}
    assert set(READS) <= names
    for m in bench["per_layer"]:
        if m["name"] in READS:
            assert m["source"] == "program_span"
            assert m["moves"] == "train_tokens_per_s"
            assert m["workloads"] == CELLS
    spec = dataclasses.replace(testing.cpu_spec(cell), trace=True)
    res = RoundResult(rounds=1, trace_rounds=1, tokens_per_round=1)
    line = harness.result_line(bench, spec, res, {"platform": "cpu"})
    assert not set(READS) & set(line["metrics"])

"""The spans of the port's federated round (``repro_torch.utils.spans``)
on the CPU.

One round of each benchmark configuration's ``test_model`` (the cells'
``lm_loss`` options, ``gather_q``, G = 4, E = 1 for Mamba2 and 2 for
SmolLM, as the cells run it), once with no profiler and once under
``torch.profiler.profile``.  The profiled round holds one ``fed.round``
with every span under its parent and each name counted as often as the
round opens it; each record's host start lies on the profiler's clock;
a round with no profiler records nothing; the profiler leaves the params
bit for bit as they were; a round whose trace range fails to open runs
on.  The mesh branch, on a world of one, carries ``fed.combine`` and
``fed.compress`` at the same boundaries.
"""
import json
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs.base import ModelConfig
from repro_torch.core import fed_step as F
from repro_torch.launch.mesh import init_world, make_host_mesh
from repro_torch.models import transformer as T
from repro_torch.sharding.rules import Rules, param_blocks, use_rules
from repro_torch.utils import spans
from repro_torch.utils.tree import leaves

from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
# groups, sequences a group's step, sequence length
G, MB, SEQ = 4, 2, 64
# configuration -> the local steps of its cell
CONFIGS = {"mamba2-370m": 1, "smollm-135m": 2}
NAMES = {"fed.round", "fed.grad", "lm.loss", "remat.recompute", "fed.prox",
         "fed.combine", "fed.compress"}
PARENT = {"fed.grad": "fed.round", "fed.prox": "fed.round",
          "fed.combine": "fed.round", "lm.loss": "fed.grad",
          "remat.recompute": "fed.grad", "fed.compress": "fed.combine"}


def _setup(name):
    conf = json.loads((ROOT / "perfbench" / "configs" / f"{name}.json")
                      .read_text())
    cells = [json.loads(p.read_text()) for p in
             (ROOT / "perfbench" / "workloads").glob("*.json")]
    loss_opts = next(c for c in cells if c["config"] == name)["loss"]
    cfg = ModelConfig(**conf["test_model"])
    E = CONFIGS[name]
    step = F.make_fed_train_step(
        lambda p, b: T.lm_loss(p, b, cfg, **loss_opts)[0],
        F.FedConfig(n_groups=G, local_steps=E, lr=1e-2, schedule="gather_q"))
    params = T.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.randint(0, cfg.vocab, (G * E * MB, SEQ),
                           generator=torch.Generator().manual_seed(1))
    sm1 = SEQ - 1
    chunks = -(-sm1 // min(loss_opts["loss_chunk"], sm1))
    return cfg, E, step, params, {"tokens": tokens}, chunks


def _ids():
    return [id(r) for r in spans.rounds()]


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def run(request):
    cfg, E, step, params, batch, chunks = _setup(request.param)
    stale = torch.tensor([0, 1, 2, 3])
    before = _ids()
    plain, _ = step(params, batch, stale)
    unprofiled = _ids() == before
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced, _ = step(params, batch, stale)
    events = [(e.name(), e.start_ns())
              for e in prof.profiler.kineto_results.events()
              if e.name() in NAMES]
    return {"cfg": cfg, "E": E, "chunks": chunks, "plain": plain,
            "traced": traced, "round": spans.rounds()[-1],
            "unprofiled": unprofiled, "events": events,
            "step": step, "params": params, "batch": batch}


def test_a_profiled_round_records_each_span(run):
    r, E, cfg = run["round"], run["E"], run["cfg"]
    assert r.root.name == "fed.round" and r.root.parent is None
    assert set(r.counts) == NAMES
    assert r.counts["fed.round"] == r.counts["fed.combine"] == 1
    assert r.counts["fed.compress"] == 1
    for name in ("fed.grad", "lm.loss", "fed.prox"):
        assert r.counts[name] == E, (name, r.counts)
    assert r.counts["remat.recompute"] == E * (cfg.n_layers + run["chunks"])


def test_each_span_lies_under_its_parent(run):
    r = run["round"]
    for name, parent in PARENT.items():
        for rec in r.records(name):
            assert rec.parent is not None and rec.parent.name == parent
            assert rec in rec.parent.children
            assert rec.round_id == r.root.round_id
            assert rec.parent.start_ns <= rec.start_ns <= rec.end_ns \
                <= rec.parent.end_ns
    # the CPU has no device events: no device times to read
    assert r.device_ms("fed.round") is None
    assert r.device_ms("fed.grad", own=True) is None


def test_span_starts_lie_on_the_profilers_clock(run):
    r = run["round"]
    for name in NAMES:
        got = sorted(t for n, t in run["events"] if n == name)
        ours = sorted(rec.start_ns for rec in r.records(name))
        assert len(got) == len(ours) == r.counts[name], name
        for a, b in zip(got, ours):
            assert abs(a - b) < 10_000_000, (name, (a - b) / 1e6)


def test_without_a_profiler_nothing_is_recorded(run):
    assert run["unprofiled"]
    assert not torch.autograd._profiler_enabled()
    before = _ids()
    with spans.span("fed.round", torch.zeros(1)):
        with spans.span("fed.grad"):
            pass
    assert _ids() == before


def test_the_profiler_leaves_the_params_bit_identical(run):
    for a, b in zip(leaves(run["plain"]), leaves(run["traced"])):
        assert torch.equal(a, b)


def test_a_round_runs_on_when_its_trace_range_fails(run, monkeypatch):
    def fail(*a, **k):
        raise RuntimeError("no range")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", fail)
    with profile(activities=[ProfilerActivity.CPU]):
        again, _ = run["step"](run["params"], run["batch"],
                               torch.tensor([0, 1, 2, 3]))
    for a, b in zip(leaves(run["plain"]), leaves(again)):
        assert torch.equal(a, b)
    assert spans.rounds()[-1].counts == run["round"].counts


@pytest.fixture(scope="module")
def world_of_one():
    import torch.distributed as dist
    init_world("gloo")
    try:
        yield make_host_mesh(1, 1)
    finally:
        dist.destroy_process_group()


def test_the_mesh_round_carries_combine_and_compress(world_of_one):
    cfg, E, step, params, batch, chunks = _setup("smollm-135m")
    rules = Rules(world_of_one)
    stale = torch.tensor([0, 1, 2, 3])
    with use_rules(rules):
        blocks = param_blocks(params, rules)
        plain, _ = step(blocks, batch, stale)
        with profile(activities=[ProfilerActivity.CPU]):
            traced, _ = step(blocks, batch, stale)
    r = spans.rounds()[-1]
    assert set(r.counts) == NAMES
    assert r.counts["fed.combine"] == r.counts["fed.compress"] == 1
    assert r.counts["fed.grad"] == E
    for name, parent in PARENT.items():
        assert all(rec.parent.name == parent for rec in r.records(name))
    for a, b in zip(leaves(plain), leaves(traced)):
        assert torch.equal(a, b)


def test_a_span_on_another_thread_hangs_under_the_rounds_innermost(
        monkeypatch):
    """A backward pass on the card runs in the autograd engine's own
    thread (which the profiler's state reaches; a plain thread's does
    not, so the check is held on here): a span opened there, with none
    open on its thread, takes the span open on the round's thread as its
    parent."""
    import threading
    monkeypatch.setattr(torch.autograd, "_profiler_enabled", lambda: True)

    def backward_thread():
        with spans.span("remat.recompute"):
            with spans.span("lm.loss"):
                pass

    with spans.span("fed.round", torch.zeros(1)):
        with spans.span("fed.grad"):
            t = threading.Thread(target=backward_thread)
            t.start()
            t.join()
    r = spans.rounds()[-1]
    (rec,) = r.records("remat.recompute")
    assert rec.parent is r.records("fed.grad")[0]
    assert r.records("lm.loss")[0].parent is rec

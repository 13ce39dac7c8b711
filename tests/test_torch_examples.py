"""The port's example twins (``examples/torch_*.py``) against the JAX
package's examples, and an audit of the port's public names, on the CPU.

Each twin runs with ``--device cpu`` at its smallest settings beside the
reference example, all of them as subprocesses started together.  Their
deterministic lines must be equal: the quickstart's compression,
staleness and server lines; the compression demo's wire, ratio and packed
columns; the end-to-end example's rounds and uploads of the protocols
whose timelines do not depend on the Alg. 5 search; the serving demo's
shapes; the pod demo's wire line.  Weights differ (the reference draws
them from ``jax.random``), so losses, accuracies, samples and the kernel
column do not.  The reference's pod demo raises after its wire line
under jax 0.9 (ROADMAP.md, its mesh's ``Explicit`` axes); the twin runs
its 4 x 2 mesh as 8 gloo ranks.
"""
import ast
import importlib
import os
import pathlib
import re
import subprocess
import sys

import pytest

from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
           JAX_PLATFORMS="cpu", OMP_NUM_THREADS="2", PYTHONUNBUFFERED="1")
FL_ARGS = ["--budget", "2", "--devices", "6", "--samples", "300"]
RUNS = {
    "quickstart": (["torch_quickstart.py", "--device", "cpu", "--budget",
                    "2", "--samples", "200"], ["quickstart.py"]),
    "compression": (["torch_compression_kernel_demo.py", "--device", "cpu"],
                    ["compression_kernel_demo.py"]),
    "fl": (["torch_fl_end_to_end.py", "--device", "cpu"] + FL_ARGS,
           ["fl_end_to_end.py"] + FL_ARGS),
    "serve": (["torch_serve_batch.py", "--device", "cpu"],
              ["serve_batch.py"]),
    "multipod": (["torch_multipod_fed_round.py", "--device", "cpu"],
                 ["multipod_fed_round.py"]),
}
# the reference's quickstart trains for 40 virtual seconds after its
# three deterministic lines: only those are read
FIRST_LINES = {"quickstart": 3}

# public names of the JAX package with no same-named counterpart in the
# port's module: (module, name) -> (the port's name for it, why)
EXCEPTIONS = {
    ("repro.kernels.bitpack", "field_to_bits"):
        (None, "a jnp unpacker of the TPU path; kernel A takes its role"),
    ("repro.kernels.bitpack", "bits_to_field"):
        (None, "a jnp unpacker of the TPU path; kernel A takes its role"),
    ("repro.kernels.fused_pack", "pack_leaves_pallas"):
        ("repro_torch.kernels.fused_pack.pack_leaves",
         "one entry point dispatching on the tensors' device"),
    ("repro.kernels.fused_pack", "pack_leaves_host"):
        ("repro_torch.kernels.fused_pack.pack_leaves",
         "one entry point dispatching on the tensors' device"),
    ("repro.kernels.ssd_scan", "ssd_chunked_pallas"):
        ("repro_torch.kernels.ssd_scan.ssd_chunked_kernel",
         "kernel C's chunked SSD"),
    ("repro.launch.dryrun", "hlo_flops"):
        ("repro_torch.launch.dryrun.trace_step",
         "no HLO in the port: the meters of trace_step count FLOPs"),
    ("repro.launch.dryrun", "hlo_bytes"):
        ("repro_torch.launch.dryrun.trace_step",
         "no HLO in the port: the meters of trace_step count bytes"),
    ("repro.launch.dryrun", "collective_bytes"):
        ("repro_torch.launch.dryrun.ring_bytes",
         "no HLO in the port: the c10d ops are metered with these ring "
         "formulas"),
    ("repro.sharding.rules", "shard_map"):
        (None, "jax's shard_map version shim: a shard_map body is the "
               "rank's own code in the port"),
}
# modules of the JAX package with no counterpart module
MODULE_EXCEPTIONS = {
    "repro.kernels.ref": "the JAX package's jnp oracles; each kernel "
                         "module's plain version takes their role",
}


def _start(argv):
    return subprocess.Popen([sys.executable] + argv, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, cwd=ROOT,
                            env=ENV)


@pytest.fixture(scope="module")
def outputs():
    """Every twin and reference example, started together; -> {name:
    ((twin rc, stdout, stderr), (reference rc, stdout, stderr))}."""
    procs = {}
    for name, (twin, ref) in RUNS.items():
        procs[name] = (_start([os.path.join("examples", twin[0])]
                              + twin[1:]),
                       _start([os.path.join("examples", ref[0])] + ref[1:]))
    out = {}
    try:
        for name, (tp, rp) in procs.items():
            t = tp.communicate(timeout=600)
            if name in FIRST_LINES:
                lines = [rp.stdout.readline()
                         for _ in range(FIRST_LINES[name])]
                rp.kill()
                r = ("".join(lines), rp.communicate()[1])
            else:
                r = rp.communicate(timeout=600)
            out[name] = ((tp.returncode,) + t, (rp.returncode,) + r)
    finally:
        for pair in procs.values():
            for p in pair:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    return out


def _twin_lines(outputs, name):
    (rc, out, err), _ = outputs[name]
    assert rc == 0, err[-3000:]
    return out.strip().splitlines()


def _ref_lines(outputs, name):
    return outputs[name][1][1].strip().splitlines()


def test_quickstart_twin(outputs):
    got, want = _twin_lines(outputs, "quickstart"), _ref_lines(outputs,
                                                               "quickstart")
    assert got[:3] == want[:3]
    assert re.match(r"\[teasq\] \d+ rounds, acc [\d.]+ -> [\d.]+, "
                    r"uploaded \d+KB$", got[3])


def test_compression_demo_twin(outputs):
    got = _twin_lines(outputs, "compression")
    want = _ref_lines(outputs, "compression")
    assert outputs["compression"][1][0] == 0
    assert got[0] == want[0] and len(got) == len(want) == 6
    for g, w in zip(got[1:], want[1:]):
        # p_s, p_q, wire_KB, ratio, packed_KB
        assert g.split()[:5] == w.split()[:5]
        float(g.split()[5])


def test_fl_end_to_end_twin(outputs):
    got, want = _twin_lines(outputs, "fl"), _ref_lines(outputs, "fl")
    assert outputs["fl"][1][0] == 0

    def table(lines):
        i = lines.index("method      rounds  best_acc  upload_MB")
        return {ln.split()[0]: ln.split() for ln in lines[i + 1:]}

    tg, tw = table(got), table(want)
    assert list(tg) == list(tw) == ["fedavg", "fedasync", "tea",
                                    "teastatic", "teasq"]
    for method in ("fedavg", "fedasync", "tea", "teastatic"):
        # rounds and upload: the event timeline, independent of weights
        assert (tg[method][1], tg[method][3]) == \
            (tw[method][1], tw[method][3]), method


def test_fl_end_to_end_twin_has_every_flag():
    def flags(script):
        out = subprocess.run([sys.executable, script, "--help"],
                             capture_output=True, text=True, cwd=ROOT,
                             env=ENV, timeout=120)
        assert out.returncode == 0, out.stderr[-2000:]
        # each option's line of the help
        return set(re.findall(r"^\s+(?:-\w, )?(--[a-z][a-z-]*)",
                              out.stdout, re.M))

    want = flags("examples/fl_end_to_end.py")
    assert flags("examples/torch_fl_end_to_end.py") == want | {"--device"}


def test_serve_batch_twin(outputs):
    got, want = _twin_lines(outputs, "serve"), _ref_lines(outputs, "serve")
    assert outputs["serve"][1][0] == 0
    shape = re.compile(r"^(\[.{28}\] \d+x\d+ tokens) in ")
    assert [shape.match(g).group(1) for g in got] == \
        [shape.match(w).group(1) for w in want]


def test_multipod_twin(outputs):
    got, want = _twin_lines(outputs, "multipod"), _ref_lines(outputs,
                                                             "multipod")
    assert got[0] == want[0] and got[0].startswith("[wire] ")
    rounds = [re.match(r"\[round (\d)\] loss=([\d.]+) alpha_t=0\.424 "
                       r"\|delta\|=[\d.]+ \([\d.]+s on 8 devices\)$", ln)
              for ln in got[1:]]
    assert [int(m.group(1)) for m in rounds] == list(range(5))
    losses = [float(m.group(2)) for m in rounds]
    assert losses == sorted(losses, reverse=True)


def test_twins_need_the_card_unless_told():
    """Without ``--device`` a twin runs on the card, and raises where
    there is none."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "examples/torch_serve_batch.py"],
                         capture_output=True, text=True, cwd=ROOT, env=ENV,
                         timeout=120)
    assert out.returncode != 0
    assert "no CUDA device is available" in out.stderr


def test_public_names_have_counterparts():
    """Every public function or class defined in a module of
    ``src/repro/`` has a same-named counterpart in the port's module, but
    for the table above (each with the port's name for it and why)."""
    missing = []
    for f in sorted(pathlib.Path(ROOT, "src", "repro").rglob("*.py")):
        mod = ".".join(f.relative_to(pathlib.Path(ROOT, "src"))
                       .with_suffix("").parts)
        if mod.endswith("__init__"):
            continue
        if mod in MODULE_EXCEPTIONS:
            continue
        names = [n.name for n in ast.parse(f.read_text()).body
                 if isinstance(n, (ast.FunctionDef, ast.ClassDef))
                 and not n.name.startswith("_")]
        port = importlib.import_module(mod.replace("repro.", "repro_torch.",
                                                   1))
        missing += [(mod, n) for n in names if not hasattr(port, n)]
    assert sorted(missing) == sorted(EXCEPTIONS)
    for (mod, name), (twin, _) in EXCEPTIONS.items():
        if twin is not None:
            pmod, _, attr = twin.rpartition(".")
            assert hasattr(importlib.import_module(pmod), attr), twin
    for mod in MODULE_EXCEPTIONS:
        with pytest.raises(ImportError):
            importlib.import_module(mod.replace("repro.", "repro_torch.", 1))


def test_package_reexports():
    """The names the JAX package's ``__init__``s export, and the example
    twins' imports, resolve in the port's."""
    import repro.core as jc
    import repro.kernels as jk
    import repro_torch.core as tc
    import repro_torch.kernels as tk
    assert set(jc.__all__) - {"ServerConfig"} <= set(tc.__all__) | {
        "ServerConfig"}
    assert set(jk.__all__) - {"bits_to_field", "field_to_bits"} <= set(
        tk.__all__)
    from repro_torch.fl import tasks
    from repro_torch.kernels import ops
    for name in ("init_lm", "lm_forward", "lm_task_loss", "lm_accuracy",
                 "lm_cohort_loss"):
        assert callable(getattr(tasks, name))
    assert callable(ops.dequant) and callable(ops.topk_quant)

"""A cell's run on the CPU at its configuration's test sizes, with the
harness's look for a card skipped: the port's round agrees with the
reference; each fault planted underneath the timed path, and the
lower-precision control in the program's place, come out not correct.
Without a card, or without the port beside it, the run prints no
result.  Nothing the run loads is JAX or the JAX package."""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import check, harness, testing  # noqa: E402
from perfbench.runners import fed_round as D  # noqa: E402

CELLS = [w["name"] for w in harness.load_benchmark()["workloads"]]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("cell", CELLS)
def test_the_port_agrees_with_the_reference(cell):
    res, line = testing.cpu_run(cell)
    assert res.correct and line["correct"], res.found
    assert res.rounds >= 1 and res.failed == 0
    assert list(line)[-1] == "checks"
    assert set(line["metrics"]) == {"train_tokens_per_s", "setup_s"}


@pytest.mark.parametrize("fault", D.FAULTS)
@pytest.mark.parametrize("cell", CELLS)
def test_a_fault_in_the_round_comes_out_not_correct(cell, fault):
    res, line = testing.cpu_run(cell, fault=fault)
    assert not res.correct and not line["correct"], res.found


@pytest.mark.parametrize("cell", CELLS)
def test_the_tf32_control_comes_out_not_correct(cell):
    spec = testing.cpu_spec(cell)
    rounds = D.CHECKED_ROUNDS
    ref = D.reference_readings(spec, rounds)
    again = D.reference_readings(spec, rounds)
    ok, _ = check.judge(check.gaps(again, ref), spec.traffic["limits"])
    assert ok
    control = D.reference_readings(spec, rounds, mode="tf32")
    ok, checks = check.judge(check.gaps(control, ref),
                             spec.traffic["limits"])
    assert not ok, checks


def _run_py(cwd, env=None):
    return subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", CELLS[0],
         "--seed", "3000000017", "--seconds", "1", "--trace", "0"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=120)


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = _run_py(ROOT, env)
    assert p.returncode != 0 and p.stdout.strip() == "", p.stderr[-2000:]


def test_the_benchmark_alone_gives_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run_py(tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_nothing_the_run_loads_is_jax():
    """A run's whole import set, and a cell's run on the CPU, in a fresh
    process; the reference alone loads nothing of the port."""
    code = (
        "import sys; sys.path[:0] = [{root!r}, {src!r}]\n"
        "import torch; torch.set_num_threads(1)\n"
        "from perfbench import harness, testing\n"
        "import perfbench.reference.mamba2, perfbench.reference.llama\n"
        "import perfbench.reference.fed_round\n"
        "assert not [m for m in sys.modules\n"
        "            if m.split('.')[0] == 'repro_torch'], 'reference'\n"
        "bench = harness.load_benchmark()\n"
        "for w in bench['workloads']:\n"
        "    for t in (False, True):\n"
        "        for m in harness.metrics_of(bench, w['name'], t):\n"
        "            harness.reader(m['name'])\n"
        "testing.cpu_run(bench['workloads'][0]['name'])\n"
        "print(harness.jax_modules())\n"
    ).format(root=str(ROOT), src=str(ROOT / "src"))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300,
                       env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert p.returncode == 0, p.stderr[-3000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"


def test_top_level_names_are_compared_whole():
    names = ["repro_torch", "repro_torch.core.fed_step", "reprox", "jax_x",
             "repro", "repro.core", "jax", "jaxlib.xla_client", "flax"]
    assert harness.jax_modules(names) == [
        "flax", "jax", "jaxlib.xla_client", "repro", "repro.core"]


@pytest.mark.cuda
def test_a_cell_runs_correct_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    p = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", CELLS[0],
         "--seed", "2147483659", "--seconds", "2", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"

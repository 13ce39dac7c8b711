"""The benchmark of the PyTorch and CUDA port (``src/repro_torch``).

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once on the card and
prints one JSON line.  Everything that belongs to one configuration, one
cell or one per-layer metric sits in a file of its own, found by name:

* ``configs/<config>.json``: the model's sizes as run, and the name of its
  plain reference (``reference/<reference>.py``);
* ``workloads/<cell>.json``: the cell's traffic (the runner that runs it,
  the schedule, groups, local steps, batch, sequence length, staleness)
  and the limits of its correctness check;
* ``metrics/<metric>.py``: a reader of one per-layer metric, with its
  work count from ``work/``;
* ``runners/<runner>.py``: how a kind of cell is built, warmed, timed and
  checked.

Nothing here imports ``jax``, ``jaxlib`` or the JAX package ``repro``; the
reference imports nothing of ``repro_torch``.
"""

import os
import sys
from pathlib import Path


def use_checkout_caches(root: Path) -> None:
    """Keep every cache of a run inside the checkout ``root``, at fixed
    paths under ``build/perfbench/``: Triton's kernels, PyTorch's
    extension builds, and the interpreter's bytecode of each module it
    imports, the port's and its libraries' (whatever
    ``PYTHONDONTWRITEBYTECODE`` says), so that a run compiles no source
    that an earlier run in the checkout compiled.  Call it before
    ``torch`` is imported."""
    base = Path(root) / "build" / "perfbench"
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")
    sys.pycache_prefix = str(base / "pycache")
    sys.dont_write_bytecode = False

"""Run one cell of the benchmark once on the card:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  It prints one JSON line last on standard
output (see ``perfbench/harness.py``) and exits with another code than 0,
printing no result, where the card is missing or a module of JAX was
loaded.  The port's kernels build into ``build/`` of the checkout at the
first run; every other cache goes there too, the interpreter's bytecode
included (``perfbench.use_checkout_caches``).
"""
import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the script's own directory leaves the path: its modules are the
# package's, imported by their full names
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]

from perfbench import use_checkout_caches  # noqa: E402

use_checkout_caches(ROOT)

from perfbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))

"""The benchmark of ``cuttlefish_tpu_torch`` on one CUDA card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  Prints one JSON result as the last line
of standard output, and the numbers of the check beside their limits as
the last lines of standard error.  Exits non-zero, with no result, where
no CUDA card is present, where the program cannot be imported, or where
the process holds JAX or the JAX package after the window.
"""

import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

_HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(_HERE))
sys.path.insert(1, str(_HERE.parent))

from harness import bench  # noqa: E402

if __name__ == "__main__":
    bench.set_cache_dirs()
    sys.exit(bench.main(sys.argv[1:], T_START))

"""Readings that the check's limits are set from, on the card.

    python3 portbench/readings.py --workload <cell> --seeds 1,2,3 --seconds 2 \
        --cases sound,control,stale_answer,half_batch,altered_answer

Runs the cell's timed path in one process for each case and seed, with a
short window at the cell's own load, and prints one JSON line per run
with the check's numbers: ``sound`` as the program stands, ``control``
and the faults of ``harness/faults.py`` planted underneath.  The
benchmark's own runs never run this.
"""

import json
import sys
import time
from pathlib import Path

_HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(_HERE))
sys.path.insert(1, str(_HERE.parent))

from harness import bench, faults, spec  # noqa: E402

CASES = {"sound": None, "control": faults.control_bf16, **faults.FAULTS}


def main(argv) -> int:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--cases", default="sound")
    args = ap.parse_args(argv)
    bench.set_cache_dirs()
    b = spec.load_benchmark()
    cell = spec.cell(b, args.workload)
    for case in args.cases.split(","):
        make = CASES[case]
        for seed in (int(s) for s in args.seeds.split(",")):
            t0 = time.perf_counter()
            patches = [] if make is None else [make()]
            outcome = bench.run_cell(b, cell, seed, args.seconds, False, "cuda", t0, patches)
            correct, _ = bench.finish(outcome)
            line = {"workload": cell["name"], "case": case, "seed": seed, "correct": correct,
                    "textures": outcome.result["attempted"], "failed": outcome.result["failed"],
                    "numbers": outcome.numbers, "seconds": time.perf_counter() - t0}
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

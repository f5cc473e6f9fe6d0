"""The check must catch the control and every fault a cell can have.

Drives the whole of a run but the look for a card (``run_cell`` on the
CPU, the program's plain versions, small sizes) with the timed path
broken underneath (``harness/faults.py``), and sees ``correct`` come out
false; and true with nothing broken.  Uses each configuration's limits as
committed.  The card test runs the same at the cell's own size.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

import pytest

BENCH_DIR = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(BENCH_DIR))
sys.path.insert(1, str(BENCH_DIR.parent))

from harness import bench, faults, spec  # noqa: E402

BENCH = spec.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
# The CPU's sizes: a cell named here runs at its own; any other at 128.
SMALL = {"bc7_albedo_2048_fused": {"size": 256, "pool": 4}}
CASES = {"control": faults.control_bf16, **faults.FAULTS}


def _small(cell_name):
    return SMALL.get(cell_name, {"size": 128, "pool": 3})


def _case(cell_name, case):
    """The control or a fault, made for the cell's configuration."""
    return CASES[case](spec.config(BENCH, spec.cell(BENCH, cell_name)["config"]))


def _run(cell_name, patches, seed, device="cpu", seconds=8.0, small=True):
    cell = spec.cell(BENCH, cell_name)
    traffic = dict(spec.traffic(cell["traffic"]), **_small(cell_name)) if small else None
    outcome = bench.run_cell(BENCH, cell, seed, seconds, False, device, time.perf_counter(), patches, traffic)
    return bench.finish(outcome)


@pytest.fixture(autouse=True)
def _threads():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cell_name", CELLS)
def test_a_sound_run_is_correct(cell_name):
    correct, shown = _run(cell_name, [], 2**31 + 3)
    assert correct, shown
    # Each class of content that the traffic sends was judged: its quality
    # number reads.
    share = spec.traffic(spec.cell(BENCH, cell_name)["traffic"])["alpha_share"]
    for cls, sent in (("alpha", share > 0), ("opaque", share < 1)):
        assert bool(shown[f"fit_ratio_{cls}"]["value"]) == sent, shown


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("cell_name", CELLS)
def test_the_check_catches(cell_name, case):
    correct, shown = _run(cell_name, [_case(cell_name, case)], 2**31 + 5)
    assert not correct, shown


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["sound", *sorted(CASES)])
@pytest.mark.parametrize("cell_name", CELLS)
def test_on_the_card_at_the_cells_size(cell_name, case):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    patches = [] if case == "sound" else [_case(cell_name, case)]
    correct, shown = _run(cell_name, patches, 2**31 + 9, "cuda", 2.0, small=False)
    assert correct == (case == "sound"), shown

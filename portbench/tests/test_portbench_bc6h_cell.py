"""CPU tests of the BC6H sky-cube cell, ``bc6h_skybox_cube1024_fused``.

The port stores each unsigned mode-12 block with the ends its indices were
chosen for (``kernels/bc6h.py:_mend_mode12``), so the reference's index
gap marks no texel of the plain path's sky cubes, where it marked the
texels of the blocks whose delta the packer clamped from +256 to +255
(``test_portbench_reference.py::test_bc6h_gap_marks_only_the_clamped_mode12_blocks``
holds that every texel it marks is such a one). The configuration's
limits, set from readings at the cell's size on the card, pass a sound
run at 128x128 (but for the fit ratio, which reads higher at that size)
and catch an altered index.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

import numpy as np
import torch

BENCH_DIR = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(BENCH_DIR))
sys.path.insert(1, str(BENCH_DIR.parent))

from harness import bench, faults, spec  # noqa: E402
from harness.reference import bc6h as R6  # noqa: E402
from harness.reference import pyramid  # noqa: E402

from cuttlefish_tpu_torch.kernels.bc6h import encode_bc6h  # noqa: E402

BENCH = spec.load_benchmark()
CELL = "bc6h_skybox_cube1024_fused"


def _bytes(words: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(words.numpy().astype("<u4")).view(np.uint8).reshape(-1, 16))


def test_the_plain_paths_sky_cubes_mark_no_texel():
    """Seed 11's three 128x128 cubes through their full chains at quality
    4 (member 1 marked a texel while the packer clamped): every block
    decodes and no stored index is worse than the baseline's."""
    sky = spec.content_family("skybox")
    x = sky.make({"size": 128, "pool": 3, "faces": 6}, torch.Generator().manual_seed(11), "cpu")
    for member in range(3):
        chain = pyramid.chain(x[member], 8, "catmullrom", False)
        blocks = torch.cat([pyramid.tile(level)[..., :3].reshape(-1, 16, 3) for level in chain]).float()
        data = _bytes(encode_bc6h(blocks, quality=4))
        _, ok, _, _, worse = R6.analyse(data, blocks.double(), None)
        assert ok.all(), member
        assert int(worse.sum()) == 0, (member, torch.nonzero(worse).tolist())


def _run(patches):
    cell = spec.cell(BENCH, CELL)
    traffic = dict(spec.traffic(cell["traffic"]), size=128, pool=3)
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        outcome = bench.run_cell(BENCH, cell, 2**31 + 17, 2.0, False, "cpu", time.perf_counter(),
                                 patches, traffic)
    finally:
        torch.set_num_threads(n)
    return bench.finish(outcome)


def test_the_limits_pass_a_sound_run_and_fail_an_altered_index():
    """At 128x128 a sound run reads within every limit but the opaque fit
    ratio's, and an altered index fails ``worse_texels``.  The fit ratio's
    limit (0.65) is set at the cell's own size, where sound runs read
    0.58-0.61 and ``quality_high`` 0.70-0.71 on the card; the 128x128
    cubes' coarser blocks read 0.69-0.71 sound and 0.74-0.75 at High on
    the CPU, so no one limit serves both sizes, and here the ratio is only
    read."""
    _, shown = _run([])
    for name, v in shown.items():
        if name != "fit_ratio_opaque" and v["value"] is not None:
            assert v["value"] <= v["limit"], shown
    assert shown["worse_texels"]["value"] == 0 and shown["fit_ratio_opaque"]["value"] > 0, shown
    config = spec.config(BENCH, spec.cell(BENCH, CELL)["config"])
    correct, shown = _run([faults.altered_answer(config)])
    assert not correct, shown
    assert shown["worse_texels"]["value"] > shown["worse_texels"]["limit"], shown

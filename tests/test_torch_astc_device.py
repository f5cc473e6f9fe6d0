"""The ASTC kernel's device code against the plain version on the CPU.

``csrc/astc_encode.cu`` keeps its device functions plain C++ (the kernels
and launchers sit under ``__CUDACC__``), so ``chip_smoke.py`` builds it
with g++ and a counting float type to count the operations of each entry
(``astc_op_counter``).  That build must give the plain version's words, bit
for bit, on every entry: here on seeded blocks at 4x4 q4 (near-gray with
alpha: all four entries) and at 12x12 q2 (decimated grids, Gauss-Seidel).
"""

import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from test_torch_astc import astc_blocks

from cuttlefish_tpu_torch.kernels import _build, astc, astc_tables

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402


@pytest.fixture(scope="module")
def count_ops(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    return chip_smoke.astc_op_counter(str(_build.CSRC), str(tmp_path_factory.mktemp("astc")))


@pytest.mark.parametrize("case", [(4, 4, 4, "gray_alpha", 96), (12, 12, 2, "alpha", 24)],
                         ids=["4x4_q4", "12x12_q2"])
def test_device_code_equals_plain_version(count_ops, case):
    bw, bh, q, kind, n = case
    b = astc_blocks(n, bw * bh, kind, seed=9)
    gray, alpha = astc_tables.has_gray_blocks(b), astc_tables.has_alpha_blocks(b)
    stages = astc.stages(bw, bh, q, gray, alpha)
    assert stages == (["a", "b", "c", "d"] if q == 4 else ["a", "b"])
    for stage in stages:
        ops, words = count_ops(stage, b, bw, bh, q, gray, alpha)
        want = astc.stage_plain(stage, torch.from_numpy(b), bw, bh, q, gray, alpha)[0].numpy()
        assert np.array_equal(words, want), stage
        assert ops > 100 * bw * bh, stage

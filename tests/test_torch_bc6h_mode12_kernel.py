"""The BC6H hand kernel stores unsigned mode 12 as the plain version does.

On the blocks of ``fixtures/bc6h_mode12_overflow.npz`` (see
``test_torch_bc6h_mode12.py``: 293 whose mode-12 candidate overflows, 128
whose does not), the device code of ``csrc/bc6h_encode.cu`` gives the
plain version's words: here through the g++ build of its warp body
(``chip_smoke.py:bc_op_counter``), and, marked ``gpu``, on the card
(``python -m pytest tests/test_torch_bc6h_mode12_kernel.py -m gpu``).
No JAX here: the card's tests compare with the plain PyTorch version.
"""

import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from cuttlefish_tpu_torch.kernels import _build, bc6h, bc6h_cuda

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402

FIXTURE = Path(__file__).resolve().parent / "fixtures" / "bc6h_mode12_overflow.npz"
CASES = [(2, "value"), (4, "value"), (4, "code")]


@pytest.fixture(scope="module")
def blocks():
    return torch.from_numpy(np.load(FIXTURE)["blocks"].astype(np.float32))


@pytest.fixture(scope="module")
def count_bc(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    return chip_smoke.bc_op_counter(str(_build.CSRC), str(tmp_path_factory.mktemp("bc6h")))


@pytest.mark.parametrize("quality,metric", CASES)
def test_warp_body_equals_plain_version(count_bc, blocks, quality, metric):
    _, words = count_bc(f"bc6h_q{quality}{'_code' if metric == 'code' else ''}", blocks.numpy())
    want = bc6h.encode_bc6h_plain(blocks, quality, False, metric).numpy()
    assert np.array_equal(words, want)


@pytest.mark.gpu
@pytest.mark.parametrize("quality,metric", CASES)
def test_kernel_equals_plain_version_on_card(blocks, quality, metric):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x = blocks.cuda()
    before = bc6h_cuda.launches
    k = bc6h.encode_bc6h(x, quality, False, metric)
    torch.cuda.synchronize()
    assert bc6h_cuda.launches == before + 1
    want = bc6h.encode_bc6h_plain(blocks, quality, False, metric)
    assert torch.equal(k.cpu(), want)

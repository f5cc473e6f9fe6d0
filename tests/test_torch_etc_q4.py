"""The port's ETC1 and ETC2 RGB encoders at quality 4 (Highest) against
the TPU kernel body called eagerly (helpers and tolerances:
``tests/test_torch_etc.py``): the 31-offset neighbourhood with eight deep
fits, and for ETC2 the planar and T/H refinements."""

import pytest
import torch
from test_torch_etc import block_modes, eager_rgb, etc_blocks, rgb_psnr, same

from cuttlefish_tpu_torch.kernels import etc


@pytest.mark.parametrize("etc2", [False, True], ids=["etc1", "etc2"])
def test_plain_matches_tpu_kernel_q4(etc2):
    """>= 99 % identical blocks (100 % expected), PSNR within 0.05 dB; the
    ETC2 blocks take every mode."""
    blocks = etc_blocks()
    port = etc.encode_etc_rgb(torch.from_numpy(blocks), 4, etc2).numpy()
    ref = eager_rgb(blocks, 4, etc2)
    assert same(port, ref) >= 0.99, same(port, ref)
    assert abs(rgb_psnr(port, blocks, etc2) - rgb_psnr(ref, blocks, etc2)) <= 0.05
    modes = set(block_modes(port))
    assert modes == ({"I", "D", "T", "H", "P"} if etc2 else {"I", "D"}), modes

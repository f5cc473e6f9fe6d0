"""The port's ETC2 RGB encoder against the TPU kernel body called eagerly
(helpers and tolerances: ``tests/test_torch_etc.py``; quality 4 in
``tests/test_torch_etc_q4.py``): the planar, T and H modes beside ETC1's,
at uniform weights and at the Rec.709 x 3 weights of every sRGB texture."""

import numpy as np
import pytest
import torch
from test_torch_etc import SRGB, block_modes, eager_rgb, etc_blocks, rgb_psnr, same

from cuttlefish_tpu_torch.kernels import etc

_CASES = [(0, "one"), (2, "one"), (2, "srgb")]


@pytest.fixture(scope="module")
def blocks():
    return etc_blocks()


@pytest.mark.parametrize("case", _CASES, ids=lambda c: f"q{c[0]}-{c[1]}")
def test_plain_matches_tpu_kernel(case, blocks):
    """>= 99 % identical blocks (100 % expected), PSNR within 0.05 dB."""
    quality, weights = case
    chw = SRGB if weights == "srgb" else (1.0, 1.0, 1.0)
    port = etc.encode_etc_rgb(torch.from_numpy(blocks), quality, True, chw).numpy()
    ref = eager_rgb(blocks, quality, True, chw)
    assert same(port, ref) >= 0.99, same(port, ref)
    assert abs(rgb_psnr(port, blocks, True) - rgb_psnr(ref, blocks, True)) <= 0.05


@pytest.mark.parametrize("quality", [0, 2])
def test_every_mode_wins_some_blocks(quality, blocks):
    """Quality 0 has no individual mode; planar, T and H always compete."""
    modes = set(block_modes(etc.encode_etc_rgb(torch.from_numpy(blocks), quality, True).numpy()))
    want = {"D", "T", "H", "P"} | ({"I"} if quality else set())
    assert modes == want, modes


def test_etc2_is_not_worse_than_etc1(blocks):
    """ETC2 adds candidates to ETC1's sweep, so its error is never higher."""
    x = torch.from_numpy(blocks)
    p1 = rgb_psnr(etc.encode_etc_rgb(x, 2, False).numpy(), blocks, False)
    p2 = rgb_psnr(etc.encode_etc_rgb(x, 2, True).numpy(), blocks, True)
    assert p2 >= p1, (p1, p2)


def test_channel_weights_are_float32():
    """Weights reach the encoder as the float32 values of the converter's
    array, as the TPU kernel's static tuple holds them."""
    from cuttlefish_tpu_torch.kernels.bc import channel_weights

    w = np.array([0.2126, 0.7152, 0.0722], np.float32) * np.float32(3.0)
    assert channel_weights(w) == SRGB
    assert channel_weights(None) == (1.0, 1.0, 1.0)

"""The port's plain PyTorch BC7 encoder against the TPU kernel's algorithm.

The reference is bc7_pallas.py:encode_bc7_pallas run in interpret mode on
the CPU (the algorithm the hand kernel ports); the jnp path is a different
algorithm at q2 and is held only to the reference's own PSNR bar
(tests/test_pallas.py:89-99).
"""

import numpy as np
import pytest
import torch

from cuttlefish_tpu.decode import decode_bc7
from cuttlefish_tpu_torch.decode import decode_bc7 as port_decode_bc7
from cuttlefish_tpu_torch.kernels.bc7 import encode_bc7

# q0 and q2 at uniform weights, q1 at the perceptual weights (mode 1's
# partition screen is where the weights enter most).  One Pallas-interpret
# compile per case; q2's mode set includes q1's at uniform weights.
_CASES = [(0, False), (1, True), (2, False)]


def _psnr(dec, ref):
    mse = ((dec.astype(np.float64) - ref) ** 2).mean()
    return 10 * np.log10(255**2 / (mse + 1e-12))


def _bytes(words):
    return np.frombuffer(
        np.ascontiguousarray(np.asarray(words).astype("<u4")).tobytes(), np.uint8
    )


@pytest.fixture(scope="module")
def blocks():
    """256 blocks made as tests/test_pallas.py:22-29 makes them."""
    rng = np.random.default_rng(7)
    base = rng.random((256, 1, 4), np.float32)
    grad = rng.normal(0, 0.15, (256, 16, 4)).astype(np.float32)
    b = np.clip(base + grad, 0, 1)
    b[::3, :, 3] = np.clip(b[::3, :, 3] * 0.6 + 0.2, 0, 1)
    return b


@pytest.fixture(scope="module")
def encoded(blocks):
    """(quality, perceptual) -> (port words, Pallas-interpret words)."""
    from cuttlefish_tpu.kernels.bc7_pallas import encode_bc7_pallas

    out = {}
    for q, perc in _CASES:
        port = encode_bc7(torch.from_numpy(blocks), q, perc)
        assert port.dtype == torch.uint32 and tuple(port.shape) == (256, 4)
        ref = encode_bc7_pallas(blocks, quality=q, perceptual=perc, interpret=True)
        out[(q, perc)] = (port.numpy(), np.asarray(ref))
    return out


@pytest.mark.parametrize("case", _CASES, ids=lambda c: f"q{c[0]}{'p' if c[1] else ''}")
def test_plain_matches_tpu_kernel(case, blocks, encoded):
    """>= 99 % identical blocks (all so far) and PSNR within 0.05 dB."""
    port, ref = encoded[case]
    same = np.all(port == ref, axis=1).mean()
    assert same >= 0.99, same
    target = np.clip(np.round(blocks * 255), 0, 255)
    p_port = _psnr(decode_bc7(_bytes(port)), target)
    p_ref = _psnr(decode_bc7(_bytes(ref)), target)
    assert abs(p_port - p_ref) <= 0.05, (p_port, p_ref)


def test_q2_psnr_vs_jnp(blocks, encoded):
    """q2 against the jnp path: PSNR >= jnp - 0.1 dB."""
    from cuttlefish_tpu.kernels.bc7 import _encode_bc7_jnp

    target = np.clip(np.round(blocks * 255), 0, 255)
    port, _ = encoded[(2, False)]
    wj = np.asarray(_encode_bc7_jnp(blocks, quality=2))
    p_port = _psnr(decode_bc7(_bytes(port)), target)
    p_jnp = _psnr(decode_bc7(_bytes(wj)), target)
    assert p_port >= p_jnp - 0.1, (p_port, p_jnp)


@pytest.mark.parametrize("case", _CASES, ids=lambda c: f"q{c[0]}{'p' if c[1] else ''}")
def test_blocks_decode_in_both_decoders(case, encoded):
    """Every emitted block decodes through the reference decoder (no
    reserved mode 8), and the port's decoder gives the same pixels."""
    port, _ = encoded[case]
    raw = _bytes(port)
    assert np.all(raw.reshape(-1, 16)[:, 0] != 0)  # a mode bit is set
    dec = decode_bc7(raw)
    assert np.array_equal(port_decode_bc7(raw), dec)


def test_quality_ladder_and_modes(encoded):
    """q0 emits mode 6 only, q1 modes 6 and 1, q2 modes 6, 1, 5 and 4."""
    def modes(words):
        low = np.asarray(words)[:, 0]
        return {int(np.log2(int(w) & -int(w))) for w in low}

    assert modes(encoded[(0, False)][0]) == {6}
    assert modes(encoded[(1, True)][0]) == {1, 6}
    assert modes(encoded[(2, False)][0]) == {1, 4, 5, 6}


def test_quality_out_of_range_raises():
    x = torch.zeros((4, 16, 4))
    for q in (-1, 5, 7):
        with pytest.raises(ValueError, match="0-4"):
            encode_bc7(x, q)


def test_empty_and_out_of_range_inputs():
    assert tuple(encode_bc7(torch.zeros((0, 16, 4)), 2).shape) == (0, 4)
    # Values outside [0,1] are clipped as the TPU wrapper clips them.
    x = torch.from_numpy(np.random.default_rng(1).normal(0.5, 1.0, (8, 16, 4)).astype(np.float32))
    assert torch.equal(encode_bc7(x, 1), encode_bc7(x.clamp(0, 1), 1))

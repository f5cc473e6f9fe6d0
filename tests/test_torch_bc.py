"""The port's plain BC1/BC4 versions against the TPU kernels' algorithm.

The reference is ``bc_pallas.py:encode_bc1_pallas`` / ``encode_bc4_pallas``
in interpret mode on the CPU, on float blocks made as tests/test_pallas.py
makes them: BC1 punch-through on hard alpha, BC4 unsigned at quality
0/1/2 and BC4 signed at quality 2.  BC1 at quality 3 with the reference's
channel weights is in tests/test_torch_bc1_weights.py (a Pallas compile of
its own, so that the test workers share the compiles out); BC1 q2, BC2,
BC3 and BC5 are in tests/test_torch_s3tc.py.
"""

import numpy as np
import pytest
import torch

from cuttlefish_tpu import decode as jd
from cuttlefish_tpu_torch.kernels import bc

_N = 256


def _blocks(seed=7):
    rng = np.random.default_rng(seed)
    base = rng.random((_N, 1, 4), np.float32)
    grad = rng.normal(0, 0.15, (_N, 16, 4)).astype(np.float32)
    b = np.clip(base + grad, 0, 1)
    b[::3, :, 3] = np.clip(b[::3, :, 3] * 0.6 + 0.2, 0, 1)
    return b


def _bytes(words):
    return np.frombuffer(np.ascontiguousarray(np.asarray(words).astype("<u4")).tobytes(), np.uint8)


def _psnr(dec, ref, peak):
    mse = ((dec.astype(np.float64) - ref) ** 2).mean()
    return 10 * np.log10(peak**2 / (mse + 1e-20))


@pytest.fixture(scope="module")
def inputs():
    b = _blocks()
    hard = b.copy()
    hard[..., 3] = (np.random.default_rng(3).random((_N, 16)) > 0.3).astype(np.float32)
    hard[::4, :, 3] = 1.0  # some opaque blocks among them
    sv = np.random.default_rng(5).uniform(-1, 1, (_N, 16)).astype(np.float32)
    return {"rgba": b, "hard": hard, "signed": sv}


_CASES = ["bc1_punch_q2", "bc4_q0", "bc4_q1", "bc4_q2", "bc4s_q2"]


@pytest.fixture(scope="module")
def encoded(inputs):
    """case -> (source, port words, Pallas-interpret words)."""
    from cuttlefish_tpu.kernels import bc_pallas as P

    b, hard, sv = inputs["rgba"], inputs["hard"], inputs["signed"]
    a = np.ascontiguousarray(b[..., 3])
    out = {
        "bc1_punch_q2": (
            hard,
            bc.encode_bc1(torch.from_numpy(hard), 2, punch_through=True, allow_black=False),
            P.encode_bc1_pallas(hard, 2, True, False, (1.0, 1.0, 1.0)),
        ),
        "bc4s_q2": (sv, bc.encode_bc4(torch.from_numpy(sv), 2, signed=True), P.encode_bc4_pallas(sv, 2, True)),
    }
    for q in (0, 1, 2):
        out[f"bc4_q{q}"] = (a, bc.encode_bc4(torch.from_numpy(a), q), P.encode_bc4_pallas(a, q, False))
    return out


def _decode(case, words):
    raw = _bytes(words)
    if case.startswith("bc1"):
        return jd.decode_bc1(raw).astype(np.float64), 255.0
    return jd.decode_bc4(raw, signed=case.startswith("bc4s")), 2.0 if case.startswith("bc4s") else 1.0


@pytest.mark.parametrize("case", _CASES)
def test_plain_matches_tpu_kernel(case, encoded):
    """>= 99 % identical blocks (100 % so far) and PSNR within 0.05 dB."""
    src, port, ref = encoded[case]
    assert port.dtype == torch.uint32
    port, ref = port.numpy(), np.asarray(ref)
    assert port.shape == ref.shape == (_N, 2)
    same = np.all(port == ref, axis=1).mean()
    assert same >= 0.99, same
    dp, peak = _decode(case, port)
    dr, _ = _decode(case, ref)
    if case.startswith("bc1"):  # transparent texels decode to black, alpha 0
        target = np.where(src[..., 3:] >= 0.5, np.round(src * 255), 0.0)
        target[..., 3] = np.where(src[..., 3] >= 0.5, 255.0, 0.0)
    else:
        target = np.clip(src, -1.0, 1.0) if case.startswith("bc4s") else src
    assert abs(_psnr(dp, target, peak) - _psnr(dr, target, peak)) <= 0.05


def test_punch_through_keeps_the_alpha_mask(inputs, encoded):
    """Every texel with alpha < 0.5 decodes transparent, every other opaque."""
    src, port, _ = encoded["bc1_punch_q2"]
    dec = jd.decode_bc1(_bytes(port.numpy()))
    assert np.array_equal(dec[..., 3] == 0, src[..., 3] < 0.5)


def test_quality_and_device_are_checked():
    x = torch.zeros((2, 16, 4))
    with pytest.raises(ValueError, match="quality"):
        bc.encode_bc1(x, 5)
    with pytest.raises(ValueError, match="device"):
        bc.encode_bc4(torch.zeros((2, 16), device="meta"), 2)
    assert tuple(bc.encode_bc3(x[:0], 2).shape) == (0, 4)
    assert bc.ls_iters(9) == 10 and bc.ls_iters(-1) == 1

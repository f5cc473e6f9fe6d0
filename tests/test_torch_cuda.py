"""The hand-written BC7 kernel against its plain PyTorch version.

Tests marked ``gpu`` need a CUDA card and skip without one; run them on
the card with ``python -m pytest tests/test_torch_cuda.py -m gpu``.  The
others check, on any machine, that the wrapper never hands a CPU tensor
to the launcher and how the kernel is built.
"""

import numpy as np
import pytest
import torch

from cuttlefish_tpu_torch.decode import decode_bc7
from cuttlefish_tpu_torch.kernels import _build, bc7_cuda
from cuttlefish_tpu_torch.kernels.bc7 import _constants, encode_bc7, encode_bc7_plain


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


def _blocks(n, seed=7):
    rng = np.random.default_rng(seed)
    base = rng.random((n, 1, 4), np.float32)
    grad = rng.normal(0, 0.15, (n, 16, 4)).astype(np.float32)
    b = np.clip(base + grad, 0, 1)
    b[::3, :, 3] = np.clip(b[::3, :, 3] * 0.6 + 0.2, 0, 1)
    return b


def _psnr(words, blocks):
    raw = np.frombuffer(np.ascontiguousarray(words.astype("<u4")).tobytes(), np.uint8)
    dec = decode_bc7(raw).astype(np.float64)
    ref = np.clip(np.round(blocks * 255), 0, 255)
    return 10 * np.log10(255**2 / (((dec - ref) ** 2).mean() + 1e-12))


@pytest.mark.gpu
@pytest.mark.parametrize("quality,perceptual", [(0, False), (1, False), (2, False), (2, True)])
def test_kernel_matches_plain_on_card(cuda, quality, perceptual):
    """>= 99 % identical blocks and |dPSNR| <= 0.05 dB, on the card."""
    b = _blocks(4096)
    x = torch.from_numpy(b).to(cuda)
    before = bc7_cuda.launches
    k = encode_bc7(x, quality, perceptual)
    torch.cuda.synchronize()
    assert bc7_cuda.launches == before + 1
    p = encode_bc7_plain(x, quality, _constants(perceptual, cuda))
    k, p = k.cpu().numpy(), p.cpu().numpy()
    assert np.all(k == p, axis=1).mean() >= 0.99
    assert abs(_psnr(k, b) - _psnr(p, b)) <= 0.05


@pytest.mark.gpu
def test_kernel_ragged_batch_and_empty(cuda):
    """A batch that is not a multiple of the CTA size, and N = 0."""
    b = _blocks(129, seed=3)
    x = torch.from_numpy(b).to(cuda)
    k = encode_bc7(x, 2).cpu().numpy()
    p = encode_bc7_plain(x, 2, _constants(False, cuda)).cpu().numpy()
    assert np.all(k == p, axis=1).mean() >= 0.99
    assert tuple(encode_bc7(x[:0], 2).shape) == (0, 4)


@pytest.mark.gpu
def test_kernel_rejects_bad_input(cuda):
    x = torch.zeros((8, 16, 4), device=cuda)
    consts = _constants(False, cuda)
    with pytest.raises(TypeError):
        bc7_cuda.encode_bc7_cuda(x.half(), 2, consts)
    with pytest.raises(ValueError):
        bc7_cuda.encode_bc7_cuda(x[:, :8], 2, consts)
    with pytest.raises(ValueError):
        bc7_cuda.encode_bc7_cuda(x.transpose(0, 1), 2, consts)


def test_cpu_tensor_never_reaches_the_launcher(monkeypatch):
    def no_build():
        raise AssertionError("the CPU path must not build or load the kernel")

    monkeypatch.setattr(_build, "load", no_build)
    before = bc7_cuda.launches
    x = torch.zeros((4, 16, 4))
    with pytest.raises(ValueError, match="CUDA tensor"):
        bc7_cuda.encode_bc7_cuda(x, 2, _constants(False, x.device))
    encode_bc7(x, 2)  # the CPU runs the plain version
    assert bc7_cuda.launches == before


def test_build_flags_and_sources():
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "--fmad=false" in flags
    assert "fast_math" not in flags and "fast-math" not in flags
    srcs = [p.name for p in _build._sources()]
    assert srcs == ["bc7_encode.cu"]
    assert len(_build._digest()) == 16 and _build._digest() == _build._digest()

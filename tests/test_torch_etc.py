"""The port's ETC1 encoder against the TPU kernel that it ports.

The reference is the body of ``etc_pallas.py:_kernel_rgb`` called eagerly
on the CPU (``jax.disable_jit``, numpy arrays as its refs), with the
operands built as ``encode_etc_rgb_pallas`` builds them (``_run``: clip to
[0, 1], times 255, channels first).  ``tests/test_torch_etc_eac.py`` holds that
call equal to ``encode_etc_rgb_pallas(..., interpret=True)``.

The inputs are 256 seeded blocks through the u8 wire (``etc_blocks``):
flat, two-tone, planar gradients, 0/255-saturated, near-gray and random.
The helpers here serve the other ETC/EAC test files too.

Tolerances: >= 99 % identical blocks (100 % expected: the same arithmetic
in the same order) and decoded PSNR within 0.05 dB.
"""

import jax
import numpy as np
import pytest
import torch

from cuttlefish_tpu.decode import etc as jdec
from cuttlefish_tpu.kernels import etc_pallas
from cuttlefish_tpu_torch.decode import etc as pdec
from cuttlefish_tpu_torch.kernels import etc

ONE = (1.0, 1.0, 1.0)
# Rec.709 x 3, the weights every sRGB texture takes (convert/etc.py).
SRGB = tuple(float(w) for w in np.array([0.2126, 0.7152, 0.0722], np.float32) * np.float32(3.0))


def etc_blocks(n=256, seed=3):
    """[n,16,4] RGBA blocks in six kinds, through the u8 wire (the values
    the converter hands on)."""
    rng = np.random.default_rng(seed)
    k = n // 6
    b = np.clip(rng.random((n, 1, 4)) + rng.normal(0, 0.15, (n, 16, 4)), 0, 1)
    b[:k] = b[:k, :1]  # flat
    b[k : 2 * k, 8:] = b[k : 2 * k, :1]  # two-tone
    b[k : 2 * k, :8] = b[k : 2 * k, 15:16]
    y, x = np.mgrid[0:4, 0:4].reshape(2, 16) / 3.0
    g = rng.random((k, 3, 4))
    b[2 * k : 3 * k] = np.clip(  # planar gradients
        g[:, 0, None] + (g[:, 1, None] - 0.5) * x[None, :, None]
        + (g[:, 2, None] - 0.5) * y[None, :, None], 0, 1,
    )
    b[3 * k : 4 * k] = rng.random((k, 16, 4)) > 0.5  # 0/255-saturated
    b[4 * k : 5 * k] = np.clip(  # near-gray
        rng.random((k, 16, 1)) + rng.normal(0, 0.01, (k, 16, 4)), 0, 1
    )
    b[5 * k :] = rng.random((n - 5 * k, 16, 4))  # random
    return np.round(b * 255).astype(np.uint8).astype(np.float32) * np.float32(1 / 255)


def _channels255(b, nch):
    """_run's operand: clip(0, 1) * 255, [nch,16,N]."""
    x = np.clip(b[..., :nch].astype(np.float32), 0.0, 1.0) * np.float32(255.0)
    return np.ascontiguousarray(np.transpose(x, (2, 1, 0)))


def eager_rgb(b, quality, etc2, chw=ONE):
    """etc_pallas._kernel_rgb run eagerly -> [N,2] words."""
    out = np.zeros((2, b.shape[0]), np.uint32)
    with jax.disable_jit():
        etc_pallas._kernel_rgb(_channels255(b, 3), out, quality=quality, etc2=etc2, chw=chw)
    return out.T.copy()


def eager_rgba(b, quality, chw=ONE):
    """etc_pallas._kernel_rgba run eagerly -> [N,4] words."""
    out = np.zeros((4, b.shape[0]), np.uint32)
    with jax.disable_jit():
        etc_pallas._kernel_rgba(_channels255(b, 4), out, quality=quality, chw=chw)
    return out.T.copy()


def eager_eac(v, quality, kind):
    """_eac_alpha ("alpha") or _eac_r11 ("r11", "r11s") + _bswap, run
    eagerly on [N,16] values scaled as the wrappers scale them."""
    v = np.asarray(v, np.float32)
    with jax.disable_jit():
        if kind == "alpha":
            x = np.ascontiguousarray((np.clip(v, 0.0, 1.0) * np.float32(255.0)).T)
            hi, lo = etc_pallas._eac_alpha(x, quality)
        else:
            signed = kind == "r11s"
            scale = np.float32(1023.0 if signed else 2047.0)
            x = np.ascontiguousarray((np.clip(v, -1.0 if signed else 0.0, 1.0) * scale).T)
            hi, lo = etc_pallas._eac_r11(x, quality, signed)
        words = [np.asarray(etc_pallas._bswap(w)).reshape(-1) for w in (hi, lo)]
    return np.stack(words, axis=1)


def to_bytes(words):
    return np.frombuffer(np.ascontiguousarray(np.asarray(words).astype("<u4")).tobytes(), np.uint8)


def psnr(dec, target, peak):
    mse = ((np.asarray(dec, np.float64) - target) ** 2).mean()
    return 10 * np.log10(peak**2 / (mse + 1e-20))


def same(a, b):
    return float(np.all(np.asarray(a) == np.asarray(b), axis=1).mean())


def block_modes(words):
    """The mode of each ETC RGB block: I(ndividual), D(ifferential), T, H or
    P(lanar), from its differential bit and base overflows."""
    raw = to_bytes(words)
    out = []
    for i in range(raw.size // 8):
        blk = int.from_bytes(raw[8 * i : 8 * i + 8].tobytes(), "big")
        if not (blk >> 33) & 1:
            out.append("I")
            continue
        base = [((blk >> s) & 31) + (((blk >> (s - 3)) & 7) ^ 4) - 4 for s in (59, 51, 43)]
        over = [not 0 <= v <= 31 for v in base]
        out.append("T" if over[0] else "H" if over[1] else "P" if over[2] else "D")
    return out


def rgb_psnr(words, b, etc2):
    dec = jdec.decode_etc_rgb(to_bytes(words), etc2=etc2)
    return psnr(dec, np.round(b[..., :3] * 255), 255.0)


@pytest.fixture(scope="module")
def blocks():
    return etc_blocks()


@pytest.mark.parametrize("quality", [0, 1, 2, 3])
def test_plain_matches_tpu_kernel(quality, blocks):
    """ETC1 at quality 0-3 (4 in tests/test_torch_etc_q4.py): >= 99 %
    identical blocks (100 % expected), PSNR within 0.05 dB."""
    port = etc.encode_etc_rgb(torch.from_numpy(blocks), quality).numpy()
    ref = eager_rgb(blocks, quality, False)
    assert port.dtype == np.uint32 and port.shape == ref.shape == (256, 2)
    assert same(port, ref) >= 0.99, same(port, ref)
    assert abs(rgb_psnr(port, blocks, False) - rgb_psnr(ref, blocks, False)) <= 0.05


def test_quality_ladder_modes(blocks):
    """ETC1 emits individual and differential blocks only; quality 0 is
    differential only, from quality 1 individual mode wins some blocks."""
    x = torch.from_numpy(blocks)
    m0 = set(block_modes(etc.encode_etc_rgb(x, 0).numpy()))
    m1 = set(block_modes(etc.encode_etc_rgb(x, 1).numpy()))
    assert m0 == {"D"}
    assert m1 == {"D", "I"}


def test_higher_quality_is_not_worse(blocks):
    """The neighbourhood search only adds candidates: the error never
    rises from quality 1 to 2 to 4 on the test blocks."""
    x = torch.from_numpy(blocks)
    p = [rgb_psnr(etc.encode_etc_rgb(x, q).numpy(), blocks, False) for q in (1, 2, 4)]
    assert p[0] <= p[1] <= p[2], p


def test_port_decoder_equals_the_jax_packages(blocks):
    """The port's copy of the ETC decoder gives the JAX package's texels
    for ETC1 and ETC2 blocks of every mode."""
    x = torch.from_numpy(blocks)
    for etc2 in (False, True):
        raw = to_bytes(etc.encode_etc_rgb(x, 1, etc2).numpy())
        assert np.array_equal(pdec.decode_etc_rgb(raw, etc2), jdec.decode_etc_rgb(raw, etc2))


def test_dispatch_arguments():
    """Quality clamps to 0-4 as the JAX package's wrappers clamp it; N = 0
    gives an empty batch; an unsupported device raises."""
    x = torch.from_numpy(etc_blocks(12))
    assert np.array_equal(etc.encode_etc_rgb(x, 9).numpy(), etc.encode_etc_rgb(x, 4).numpy())
    assert np.array_equal(etc.encode_etc_rgb(x, -1).numpy(), etc.encode_etc_rgb(x, 0).numpy())
    assert tuple(etc.encode_etc_rgb(x[:0], 2).shape) == (0, 2)
    assert tuple(etc.encode_etc2_rgba(x[:0], 2).shape) == (0, 4)
    assert tuple(etc.encode_eac_alpha(x[:0, :, 3], 2).shape) == (0, 2)
    assert tuple(etc.encode_eac_r11(x[:0, :, 0], 2).shape) == (0, 2)
    assert tuple(etc.encode_eac_rg11(x[:0], 2).shape) == (0, 4)
    with pytest.raises(ValueError, match="unsupported device"):
        etc.encode_etc_rgb(x.to("meta"), 2)

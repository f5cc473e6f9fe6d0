"""The port's BC7 quality 3-4 against the TPU kernel that it ports.

The reference is the body of ``bc7_pallas.py:_kernel_hq`` called eagerly on
the CPU (``jax.disable_jit``, numpy arrays as its refs), with the operands
built as ``encode_bc7_pallas`` builds them.  That call equals
``encode_bc7_pallas(..., interpret=True)``, which one test asserts at one
small case; jitted, that call spends minutes compiling the kernel on a CPU
(about 200 s measured on an x86 host), so the test runs it op by op.  The ``jnp`` path, another
algorithm, is held to the reference's PSNR bar in
``tests/test_torch_bc7_hq_jnp.py``.

Tolerances: >= 99 % identical blocks (100 % expected: the same arithmetic
in the same order) and decoded PSNR within 0.05 dB.  No JAX encoder runs
for the slice test: the JAX package only reads the port's file back.
"""

import jax
import numpy as np
import pytest
import torch

import cuttlefish_tpu as ct
import cuttlefish_tpu_torch as cp
from cuttlefish_tpu.decode import decode_bc7
from cuttlefish_tpu.kernels import bc7_pallas
from cuttlefish_tpu.kernels import bc7_tables as T
from cuttlefish_tpu_torch.convert.blocks import extract_blocks
from cuttlefish_tpu_torch.convert.device import dequant_u8, wire_u8
from cuttlefish_tpu_torch.decode import decode_bc7 as port_decode_bc7
from cuttlefish_tpu_torch.kernels.bc7 import encode_bc7

_CASES = [(3, False), (4, False), (4, True)]
_DDS_HEADER = 148


def _ids(c):
    return f"q{c[0]}{'p' if c[1] else ''}"


def _psnr(dec, ref):
    mse = ((dec.astype(np.float64) - ref) ** 2).mean()
    return 10 * np.log10(255**2 / (mse + 1e-12))


def _bytes(words):
    return np.frombuffer(
        np.ascontiguousarray(np.asarray(words).astype("<u4")).tobytes(), np.uint8
    )


def _test_blocks():
    """128 blocks made as tests/test_torch_bc7.py:35-42 makes them, then
    flat, two-tone, three-tone and rotation-friendly ones (one colour
    channel varying on its own)."""
    rng = np.random.default_rng(7)
    base = rng.random((128, 1, 4), np.float32)
    grad = rng.normal(0, 0.15, (128, 16, 4)).astype(np.float32)
    b = np.clip(base + grad, 0, 1)
    b[::3, :, 3] = np.clip(b[::3, :, 3] * 0.6 + 0.2, 0, 1)
    extra = []
    cols = rng.random((24, 3, 4)).astype(np.float32)
    for i in range(8):
        extra.append(np.repeat(cols[i, :1], 16, axis=0))  # flat
        p2 = T.PARTITION2[(7 * i + 3) % 64]
        extra.append(cols[8 + i, :2][p2])  # two-tone
        p3 = T.PARTITION3[(5 * i + 1) % 64]
        extra.append(cols[16 + i][p3])  # three-tone
        rot = np.repeat(cols[i, 1:2], 16, axis=0).copy()
        rot[:, i % 3] = rng.random(16)  # one channel on its own
        extra.append(rot)
    return np.concatenate([b, np.stack(extra).astype(np.float32)])


def _eager_hq(blocks, quality, perceptual):
    """bc7_pallas._kernel_hq run eagerly, operands as encode_bc7_pallas
    (bc7_pallas.py:1178-1219) builds them."""
    chw = (0.55, 1.1, 0.35, 1.0) if perceptual else (1.0, 1.0, 1.0, 1.0)
    x = np.clip(blocks.astype(np.float32), 0.0, 1.0) * np.float32(255.0)
    x = np.ascontiguousarray(np.transpose(x, (2, 1, 0)))  # [4,16,N]
    part2 = T.PARTITION2.astype(np.float32)
    anchors = T.ANCHOR2[:, None].astype(np.float32)
    p3m = [(T.PARTITION3 == s).astype(np.float32) for s in range(3)]
    anch2 = T.ANCHOR3_2[:, None].astype(np.float32)
    anch3 = T.ANCHOR3_3[:, None].astype(np.float32)
    out = np.zeros((4, blocks.shape[0]), np.uint32)
    with jax.disable_jit():
        bc7_pallas._kernel_hq(
            x, part2, np.ascontiguousarray(part2.T), anchors,
            *p3m, *[np.ascontiguousarray(m.T) for m in p3m], anch2, anch3, out,
            quality=quality, chw=chw,
        )
    return out.T.copy()


def _slice_texture():
    """40x24 LDR RGBA + mips through the port on the CPU -> BC7 Highest."""
    rng = np.random.default_rng(11)
    y, x = np.mgrid[0:24, 0:40].astype(np.float32)
    arr = np.stack(
        [np.sin(x / 7.0), np.cos(y / 5.0), np.sin((x + y) / 9.0), np.cos(x / 11.0)], axis=-1
    ) * 0.4 + 0.5
    arr = np.clip(arr + rng.normal(0, 0.05, arr.shape), 0, 1).astype(np.float32)
    tex = cp.Texture(cp.Dimension.Dim2D, 40, 24, mip_levels=99, device="cpu")
    assert tex.set_image(cp.Image.from_array(arr, cp.ImageFormat.RGBAF))
    assert tex.generate_mipmaps()
    # Each mip's blocks as the converter sends them: tiled, the u8 wire.
    mips = [
        dequant_u8(torch.from_numpy(wire_u8(
            extract_blocks(tex.get_image(mip_level=m).rgbaf(), 4, 4)[0]
        ))).numpy()
        for m in range(tex.mip_levels)
    ]
    assert tex.convert(cp.TextureFormat.BC7, cp.TextureType.UNorm, cp.Quality.Highest)
    return tex, mips


@pytest.fixture(scope="module")
def blocks():
    return _test_blocks()


@pytest.fixture(scope="module")
def slice_tex():
    return _slice_texture()


@pytest.fixture(scope="module")
def encoded(blocks, slice_tex):
    """case -> (port words, eager TPU-kernel words) on the test blocks;
    plus "slice" -> eager q4 words of the slice texture's mips.  Every eager
    call takes the test blocks and the slice's together: one shape, so each
    JAX operation compiles once for all three cases."""
    _, mips = slice_tex
    n = blocks.shape[0]
    batch = np.concatenate([blocks, *mips])
    out = {}
    for q, perc in _CASES:
        port = encode_bc7(torch.from_numpy(blocks), q, perc)
        assert port.dtype == torch.uint32 and tuple(port.shape) == (n, 4)
        ref = _eager_hq(batch, q, perc)
        out[(q, perc)] = (port.numpy(), ref[:n])
        if (q, perc) == (4, False):
            out["slice"] = ref[n:]
    return out


def test_eager_body_is_the_interpret_kernel():
    """The shortcut is honest: the eager body equals the reference's own
    entry point in interpret mode (run op by op; 16 blocks, q3)."""
    b = _test_blocks()[::10][:16]
    with jax.disable_jit():
        ref = np.asarray(bc7_pallas.encode_bc7_pallas(b, quality=3, interpret=True))
    assert np.array_equal(ref, _eager_hq(b, 3, False))
    assert np.array_equal(encode_bc7(torch.from_numpy(b), 3).numpy(), ref)


@pytest.mark.parametrize("case", _CASES, ids=_ids)
def test_plain_matches_tpu_kernel(case, blocks, encoded):
    """>= 99 % identical blocks (100 % expected), PSNR within 0.05 dB."""
    port, ref = encoded[case]
    same = np.all(port == ref, axis=1).mean()
    assert same >= 0.99, same
    target = np.clip(np.round(blocks * 255), 0, 255)
    p_port = _psnr(decode_bc7(_bytes(port)), target)
    p_ref = _psnr(decode_bc7(_bytes(ref)), target)
    assert abs(p_port - p_ref) <= 0.05, (p_port, p_ref)


@pytest.mark.parametrize("case", _CASES, ids=_ids)
def test_blocks_decode_in_both_decoders(case, encoded):
    """Every block decodes through the reference decoder (no reserved mode
    8) and through the port's decoder to the same texels."""
    port, _ = encoded[case]
    raw = _bytes(port)
    assert np.all(raw.reshape(-1, 16)[:, 0] != 0)  # a mode bit is set
    assert np.array_equal(port_decode_bc7(raw), decode_bc7(raw))


def _modes(words):
    low = np.asarray(words)[:, 0]
    return {int(np.log2(int(w) & -int(w))) for w in low}


def test_mode_sets(encoded):
    """q3 searches modes 6, 5, 4, 1, 3 and 0 (no rotation); q4 adds 7 and
    2 and the rotations, and emits at least one of modes 0, 2, 3 and 7."""
    q3 = encoded[(3, False)][0]
    assert _modes(q3) <= {0, 1, 3, 4, 5, 6}
    assert {0, 3} & _modes(q3)
    for case in ((4, False), (4, True)):
        assert {0, 2, 3, 7} & _modes(encoded[case][0]), case
    # Mode 4/5 blocks carry their rotation in bits 6-7 (mode 5) or 5-6
    # (mode 4): rotation 0 at q3.
    low = q3[:, 0].astype(np.int64)
    m5 = (low & 0x3F) == 0x20
    m4 = (low & 0x1F) == 0x10
    assert not ((low[m5] >> 6) & 3).any() and not ((low[m4] >> 5) & 3).any()


def test_slice_bc7_highest_dds_reads_back_in_the_jax_package(slice_tex, encoded, tmp_path):
    """BC7 Highest 40x24 + mips -> DDS by the port, read by the JAX
    package's load_texture: same format, type, size and mips; each mip's
    payload is the eager TPU kernel's words for that mip's blocks."""
    tex, mips = slice_tex
    path = tmp_path / "slice.dds"
    assert tex.save(str(path)) is cp.SaveResult.Success
    loaded = ct.load_texture(str(path))
    assert loaded.format is ct.TextureFormat.BC7 and tex.format is cp.TextureFormat.BC7
    assert loaded.type is ct.TextureType.UNorm
    assert (loaded.width(), loaded.height(), loaded.mip_levels) == (40, 24, tex.mip_levels)
    ref = encoded["slice"]
    start = 0
    payload = 0
    for m, blocks in enumerate(mips):
        want = _bytes(ref[start : start + blocks.shape[0]]).tobytes()
        start += blocks.shape[0]
        assert loaded.data(mip_level=m) == tex.data(mip_level=m) == want, m
        payload += len(want)
    assert start == ref.shape[0]
    assert path.stat().st_size == _DDS_HEADER + payload

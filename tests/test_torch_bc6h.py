"""The port's BC6H encoder against the TPU kernel that it ports.

The reference is the body of ``bc6h_pallas.py:_kernel`` called eagerly on
the CPU (``jax.disable_jit``, numpy arrays as its refs), on the JAX
package's ``_to_proxy`` of the f16-wire input, with the operands built as
``encode_bc6h_pallas`` builds them.  One test asserts, at one small case,
that this call equals ``encode_bc6h_pallas(..., interpret=True)``.  The
``jnp`` path, another algorithm, is held to the reference's PSNR bar in
``tests/test_torch_bc6h_jnp.py``.

Tolerances: >= 99 % identical blocks (100 % expected: the same arithmetic
in the same order) and decoded PSNR within 0.05 dB.  No JAX encoder runs
for the slice tests: the JAX package only reads the port's files back.
"""

import jax
import numpy as np
import pytest
import torch

import cuttlefish_tpu as ct
import cuttlefish_tpu_torch as cp
from cuttlefish_tpu.decode.bc6h import decode_bc6h
from cuttlefish_tpu.kernels import bc6h_pallas
from cuttlefish_tpu.kernels.bc6h import _to_proxy
from cuttlefish_tpu.kernels.bc7_tables import ANCHOR2, PARTITION2
from cuttlefish_tpu.packfloat import half_bits_to_f32
from cuttlefish_tpu_torch.convert.blocks import extract_blocks
from cuttlefish_tpu_torch.decode import decode_bc6h as port_decode_bc6h
from cuttlefish_tpu_torch.kernels.bc6h import encode_bc6h

# (quality, signed, metric)
_CASES = [
    (0, False, "value"), (2, False, "value"), (4, False, "value"),
    (2, True, "value"), (4, True, "value"), (2, False, "code"),
]
_DDS_HEADER = 148


def _ids(c):
    return f"q{c[0]}{'s' if c[1] else 'u'}-{c[2]}"


def hdr_blocks(n, signed, seed=7):
    """HDR RGB blocks: exp(N(0, 1.5)) scales times texel noise and a
    per-block gradient, some blocks pushed into the half floats' denormal
    segment and some near their top; a sign pattern for signed; through the
    f16 wire (the values the converter hands on)."""
    rng = np.random.default_rng(seed)
    scale = np.exp(rng.normal(0, 1.5, (n, 1, 1)))
    col = rng.random((n, 1, 3)) * 0.8 + 0.2
    tex = 1.0 + rng.normal(0, 0.1, (n, 16, 3))
    grad = np.linspace(0.6, 1.4, 16)[None, :, None] ** rng.normal(0, 1, (n, 1, 3))
    b = scale * col * tex * grad
    b[::17] *= 2e-5
    b[5::23] *= 3e3
    if signed:
        b = b * np.where(rng.random((n, 16, 3)) < 0.3, -1.0, 1.0)
        b[::4] = np.abs(b[::4]) * np.where(rng.random((b[::4].shape[0], 1, 3)) < 0.5, -1.0, 1.0)
    b = np.clip(b, -60000.0, 60000.0)
    return b.astype(np.float16).astype(np.float32)


def _eager(blocks, quality, signed, metric):
    """bc6h_pallas._kernel run eagerly, operands as encode_bc6h_pallas
    (bc6h_pallas.py:694-722) builds them."""
    x = np.asarray(_to_proxy(blocks[..., :3].astype(np.float32), signed))
    x = np.ascontiguousarray(np.transpose(x, (2, 1, 0)))  # [3,16,N]
    part32 = PARTITION2[:32].astype(np.float32)
    anchors = ANCHOR2[:32, None].astype(np.float32)
    out = np.zeros((4, blocks.shape[0]), np.uint32)
    with jax.disable_jit():
        bc6h_pallas._kernel(
            x, part32, np.ascontiguousarray(part32.T), anchors, out,
            quality=quality, signed=signed, metric=metric,
        )
    return out.T.copy()


def _bytes(words):
    return np.frombuffer(
        np.ascontiguousarray(np.asarray(words).astype("<u4")).tobytes(), np.uint8
    )


def _psnr(words, src, signed):
    """tests/test_pallas.py:319-336's PSNR: linear values, peak max|src|."""
    dec = half_bits_to_f32(decode_bc6h(_bytes(words), signed=signed)).astype(np.float64)
    mx = np.abs(src).max()
    return 10 * np.log10(mx * mx / (((dec - src) ** 2).mean() + 1e-30))


def _hdr_image(signed):
    """40x24 HDR RGBA: a smooth exponent ramp over 2^-8 .. 2^8, texel noise,
    a sign pattern for signed; opaque alpha."""
    rng = np.random.default_rng(13)
    y, x = np.mgrid[0:24, 0:40].astype(np.float32)
    e = -8.0 + 16.0 * (x / 39.0) * (0.7 + 0.3 * np.cos(y / 7.0))
    rgb = np.stack([np.sin(x / 6.0), np.cos(y / 4.0), np.sin((x + y) / 8.0)], axis=-1) * 0.4 + 0.6
    rgb = rgb * np.exp2(e)[..., None] * (1.0 + rng.normal(0, 0.05, rgb.shape))
    if signed:
        rgb = rgb * np.where(np.sin(x / 3.0 + 1.0)[..., None] * np.ones(3) < -0.3, -1.0, 1.0)
    return np.concatenate([rgb, np.ones((24, 40, 1))], axis=-1).astype(np.float32)


def _slice_texture(signed):
    """The HDR image + mips through the port on the CPU -> BC6H q2 (UFloat,
    or Float when signed); each mip's RGB blocks through the f16 wire."""
    arr = _hdr_image(signed)
    tex = cp.Texture(cp.Dimension.Dim2D, 40, 24, mip_levels=99, device="cpu")
    assert tex.set_image(cp.Image.from_array(arr, cp.ImageFormat.RGBAF))
    assert tex.generate_mipmaps()
    mips = [
        extract_blocks(tex.get_image(mip_level=m).rgbaf(), 4, 4)[0]
        .astype(np.float16).astype(np.float32)[..., :3]
        for m in range(tex.mip_levels)
    ]
    typ = cp.TextureType.Float if signed else cp.TextureType.UFloat
    assert tex.convert(cp.TextureFormat.BC6H, typ, cp.Quality.Normal)
    return tex, mips


@pytest.fixture(scope="module")
def slices():
    return {s: _slice_texture(s) for s in (False, True)}


@pytest.fixture(scope="module")
def encoded(slices):
    """case -> (input, port words, eager TPU-kernel words); plus ("slice",
    signed) -> eager q2 words of that slice texture's mips.  Every eager call
    takes the test blocks and the slice's of its sign together: one shape
    (both slices have the same blocks), so each JAX operation compiles once
    for all six cases."""
    out = {}
    for q, signed, metric in _CASES:
        b = hdr_blocks(128, signed)
        port = encode_bc6h(torch.from_numpy(b), q, signed, metric)
        assert port.dtype == torch.uint32 and tuple(port.shape) == (128, 4)
        ref = _eager(np.concatenate([b, *slices[signed][1]]), q, signed, metric)
        out[(q, signed, metric)] = (b, port.numpy(), ref[:128])
        if (q, metric) == (2, "value"):
            out[("slice", signed)] = ref[128:]
    return out


def test_eager_body_is_the_interpret_kernel():
    """The shortcut is honest: the eager body equals the reference's own
    entry point in interpret mode (16 blocks, unsigned q2, value)."""
    b = hdr_blocks(16, False, seed=3)
    ref = np.asarray(bc6h_pallas.encode_bc6h_pallas(b, 2, False, interpret=True, metric="value"))
    assert np.array_equal(ref, _eager(b, 2, False, "value"))
    assert np.array_equal(encode_bc6h(torch.from_numpy(b), 2).numpy(), ref)


@pytest.mark.parametrize("case", _CASES, ids=_ids)
def test_plain_matches_tpu_kernel(case, encoded):
    """>= 99 % identical blocks (100 % expected), PSNR within 0.05 dB."""
    b, port, ref = encoded[case]
    same = np.all(port == ref, axis=1).mean()
    assert same >= 0.99, same
    signed = case[1]
    assert abs(_psnr(port, b, signed) - _psnr(ref, b, signed)) <= 0.05


@pytest.mark.parametrize("case", _CASES, ids=_ids)
def test_port_decoder_equals_the_jax_packages(case, encoded):
    """The port's copy of the BC6H decoder gives the JAX package's half
    bits for every block the port emits (one- and two-region modes)."""
    _, port, _ = encoded[case]
    raw = _bytes(port)
    assert np.array_equal(port_decode_bc6h(raw, signed=case[1]), decode_bc6h(raw, signed=case[1]))


def test_quality_ladder_uses_two_region_modes(encoded):
    """q0 emits mode 11 only; from q2 two-region modes and mode 12 win some
    blocks."""
    def headers(words):
        low = np.asarray(words)[:, 0]
        return {int(w) & 0x1F if int(w) & 0x3 in (2, 3) else int(w) & 0x3 for w in low}

    assert headers(encoded[(0, False, "value")][1]) == {0x03}
    h4 = headers(encoded[(4, False, "value")][1])
    assert h4 - {0x03, 0x07}, h4


@pytest.mark.parametrize("signed", [False, True], ids=["ufloat_dds", "float_ktx"])
def test_slice_reads_back_in_the_jax_package(signed, slices, encoded, tmp_path):
    """BC6H UFloat -> DDS and Float -> KTX, 40x24 + mips, written by the
    port and read by the JAX package's load_texture: same format, type,
    size and mips; each mip's payload is the eager TPU kernel's words for
    that mip's blocks; the DDS is 148 bytes of header plus the payload."""
    tex, mips = slices[signed]
    ext = "ktx" if signed else "dds"
    path = tmp_path / f"slice.{ext}"
    assert tex.save(str(path)) is cp.SaveResult.Success
    loaded = ct.load_texture(str(path))
    assert loaded.format is ct.TextureFormat.BC6H and tex.format is cp.TextureFormat.BC6H
    typ = ct.TextureType.Float if signed else ct.TextureType.UFloat
    assert loaded.type is typ and tex.type.name == typ.name
    assert (loaded.width(), loaded.height(), loaded.mip_levels) == (40, 24, tex.mip_levels)
    ref = encoded[("slice", signed)]
    start = payload = 0
    for m, blocks in enumerate(mips):
        want = _bytes(ref[start : start + blocks.shape[0]]).tobytes()
        start += blocks.shape[0]
        assert loaded.data(mip_level=m) == tex.data(mip_level=m) == want, m
        payload += len(want)
    assert start == ref.shape[0]
    if ext == "dds":
        assert path.stat().st_size == _DDS_HEADER + payload
    # The port reads its own file back and decodes it without JAX's help.
    back = cp.load_texture(str(path))
    dec = back.decode_image().rgbaf()
    assert dec.shape == (24, 40, 4) and np.isfinite(dec).all()


def test_bad_arguments_raise():
    x = torch.zeros((4, 16, 3))
    with pytest.raises(ValueError):
        encode_bc6h(x, 5)
    with pytest.raises(ValueError):
        encode_bc6h(x, 2, metric="log")
    assert tuple(encode_bc6h(x[:0], 2).shape) == (0, 4)

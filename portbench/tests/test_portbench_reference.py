"""CPU tests of the plain reference against the port's plain path at
small sizes: the BC7 and BC6H decoders, the mip chain, the DDS head, the
index gap and the plain fit.
The reference imports nothing of the port; these tests import both.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

BENCH_DIR = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(BENCH_DIR))
sys.path.insert(1, str(BENCH_DIR.parent))

from harness.reference import bc6h as R6  # noqa: E402
from harness.reference import bc7 as R7  # noqa: E402
from harness.reference import dds, pyramid  # noqa: E402

from cuttlefish_tpu_torch.convert.device import pyramid_blocks  # noqa: E402
from cuttlefish_tpu_torch.decode.bc6h import decode_bc6h  # noqa: E402
from cuttlefish_tpu_torch.decode.bc7 import decode_bc7  # noqa: E402
from cuttlefish_tpu_torch.formats import (  # noqa: E402
    ColorSpace,
    CubeFace,
    Dimension,
    FileType,
    Quality,
    TextureFormat,
    TextureType,
)
from cuttlefish_tpu_torch.image import Image, ImageFormat  # noqa: E402
from cuttlefish_tpu_torch.image.resample import resample_weights  # noqa: E402
from cuttlefish_tpu_torch.kernels.bc6h import encode_bc6h  # noqa: E402
from cuttlefish_tpu_torch.kernels.bc6h_tables import TWO_REGION_LAYOUT, TWO_REGION_MODES  # noqa: E402
from cuttlefish_tpu_torch.kernels.bc7 import channel_weights, encode_bc7  # noqa: E402
from cuttlefish_tpu_torch.texture import Texture  # noqa: E402

PERCEPTUAL = tuple(float(np.float32(w)) for w in channel_weights(True))


def _bytes(words: torch.Tensor) -> np.ndarray:
    return np.frombuffer(words.numpy().astype("<u4").tobytes(), np.uint8).reshape(-1, 16).copy()


def _mixed_blocks(n: int, seed: int) -> np.ndarray:
    """Smooth, noisy, two-colour and flat blocks, some with alpha."""
    rng = np.random.default_rng(seed)
    base = rng.random((n, 1, 4))
    ramp = np.linspace(0, 1, 16)[None, :, None] * rng.normal(0, 0.3, (n, 1, 4))
    two = (rng.random((n, 16, 1)) < 0.5) * rng.normal(0, 0.4, (n, 1, 4))
    noise = rng.normal(0, 0.05, (n, 16, 4))
    kind = np.arange(n) % 4
    x = base + np.where(kind[:, None, None] == 0, ramp, 0) + np.where(kind[:, None, None] == 1, two, 0)
    x = x + np.where(kind[:, None, None] == 2, noise, 0)
    x[kind % 2 == 0, :, 3] = 1.0
    return np.clip(x, 0, 1).astype(np.float32)


@pytest.mark.parametrize("quality", [0, 2, 3, 4])
@pytest.mark.parametrize("perceptual", [False, True])
def test_bc7_decoder_and_gap_against_the_port(quality, perceptual):
    x = _mixed_blocks(96, quality)
    data = _bytes(encode_bc7(torch.from_numpy(x), quality=quality, perceptual=perceptual))
    chw = PERCEPTUAL if perceptual else (1.0, 1.0, 1.0, 1.0)
    src = torch.from_numpy(x).double().clamp(0, 1) * 255
    dec, ok, gap, worse = R7.analyse(torch.from_numpy(data), src, chw)
    assert ok.all()
    np.testing.assert_array_equal(dec.numpy(), decode_bc7(data))
    # The port selects its indices at least as well as the baseline: no gap.
    assert float(gap.max()) < 1e-6 and not worse.any()


def test_bc7_reserved_blocks_are_not_valid_and_modes_all_decode():
    rng = np.random.default_rng(7)
    data = rng.integers(0, 256, (800, 16), dtype=np.uint8)
    data[:8] = 0  # reserved (no mode bit)
    dec, ok, _, _ = R7.analyse(torch.from_numpy(data))
    np.testing.assert_array_equal(ok.numpy(), data[:, 0] != 0)
    np.testing.assert_array_equal(dec.numpy(), decode_bc7(data))


def test_plain_fit_is_a_mode6_fit_the_encoder_beats():
    x = _mixed_blocks(96, 5)
    src = torch.from_numpy(x).double() * 255
    plain = R7.plain_fit_error(src, PERCEPTUAL)
    assert plain.shape == (96,) and bool((plain >= 0).all())
    # Flat blocks fit exactly up to the 8-bit endpoints' rounding.
    flat = torch.full((4, 16, 4), 127.0, dtype=torch.float64)
    assert float(R7.plain_fit_error(flat, PERCEPTUAL).max()) < 1.0
    # The port's searches fit better than one mode-6 line, and better the
    # wider they search.
    err = {}
    for q in (2, 4):
        data = _bytes(encode_bc7(torch.from_numpy(x), quality=q, perceptual=True))
        nums = R7.judge_blocks(torch.from_numpy(data), torch.from_numpy(x).double(), None,
                               {"channel_weights": PERCEPTUAL})
        assert nums["plain_sum"] == pytest.approx(float(plain.sum()))
        err[q] = nums["fit_sum"]
    assert err[4] < err[2] < float(plain.sum())


def test_resample_weights_are_the_ports():
    for n_in, n_out in [(2048, 1024), (7, 3), (1, 1), (5, 2), (3, 1)]:
        for name in pyramid.FILTERS:
            np.testing.assert_array_equal(
                pyramid.resample_weights(n_in, n_out, name), resample_weights(n_in, n_out, name)
            )


@pytest.mark.parametrize("srgb", [False, True])
def test_chain_matches_the_ports_fused_pyramid(srgb):
    rng = np.random.default_rng(11)
    x = rng.random((2, 40, 40, 4)).astype(np.float32)
    levels = pyramid.full_levels(40, 40)
    ours = pyramid.chain(torch.from_numpy(x), levels, "catmullrom", srgb)
    theirs = pyramid_blocks(torch.from_numpy(x), levels, "catmullrom", srgb, 4, 4)
    start = 0
    for k in range(levels):
        for face in range(2):
            blocks = pyramid.tile(ours[k][face : face + 1])[0]
            n = blocks.shape[0]
            # Blocks are level-major, face-minor in the port's batch.
            got = theirs[start + face * n : start + (face + 1) * n].double()
            assert float((got - blocks).abs().max()) < 2e-6
        start += 2 * n


def _texture(fmt, type_, cs, faces, size, seed):
    rng = np.random.default_rng(seed)
    dim = Dimension.Cube if faces == 6 else Dimension.Dim2D
    t = Texture(dim, size, size, 0, 1, cs, device="cpu")
    arrays = []
    for f in range(faces):
        a = rng.random((size, size, 4)).astype(np.float32)
        if type_ is TextureType.UFloat:
            a = a * 40.0
        arrays.append(a)
        t.set_image(Image.from_array(a, ImageFormat.RGBAF, cs), CubeFace(f) if faces == 6 else None)
    assert t.convert_with_mips(fmt, type_, Quality.Normal)
    result, data = t.save_to_bytes(FileType.DDS)
    return np.stack(arrays), data


@pytest.mark.parametrize(
    "fmt,type_,cs,faces",
    [
        (TextureFormat.BC7, TextureType.UNorm, ColorSpace.sRGB, 1),
        (TextureFormat.BC7, TextureType.UNorm, ColorSpace.sRGB, 6),
        (TextureFormat.BC6H, TextureType.UFloat, ColorSpace.Linear, 6),
    ],
    ids=["bc7_srgb", "bc7_srgb_cube", "bc6h_ufloat_cube"],
)
def test_dds_head_and_layout_are_the_ports(fmt, type_, cs, faces):
    size = 24
    _, data = _texture(fmt, type_, cs, faces, size, 1)
    levels = pyramid.full_levels(size, size)
    ref = {TextureFormat.BC7: R7, TextureFormat.BC6H: R6}[fmt]
    srgb = cs is ColorSpace.sRGB
    head = dds.head(ref.dds_format(type_.name, srgb), ref.DDS_ALPHA_MODE, size, size, levels, faces)
    assert data[:148] == head
    last = dds.layout(size, size, levels, faces)[-1]
    assert len(data) == last[2] + last[3]


def test_the_check_passes_the_plain_path_and_reads_its_error():
    import json

    from harness import check

    config = json.loads((BENCH_DIR / "configs" / "bc7_srgb_highest_dds.json").read_text())
    level0, data = _texture(TextureFormat.BC7, TextureType.UNorm, ColorSpace.sRGB, 1, 32, 2)
    nums = check.combine([check.judge_texture(config, level0, data, "cpu")])
    assert nums["head_bytes"] == 0 and nums["bad_blocks"] == 0
    assert nums["err_mean"] > 0
    # Random alpha: the texture is of the alpha class; no opaque one judged.
    assert nums["fit_ratio_alpha"] > 0 and nums["fit_ratio_opaque"] is None
    broken = bytearray(data)
    broken[10] ^= 0xFF
    nums = check.combine([check.judge_texture(config, level0, bytes(broken), "cpu")])
    assert nums["head_bytes"] == 1


def test_the_bc7_head_fields_are_the_ones_before_they_moved():
    """The DXGI format and alpha mode that dds.head took from its own
    tables before the reference modules gave them."""
    assert (R7.dds_format("UNorm", False), R7.dds_format("UNorm", True), R7.DDS_ALPHA_MODE) == (98, 99, 1)
    assert (R6.dds_format("UFloat", False), R6.DDS_ALPHA_MODE) == (95, 3)


def _hdr_blocks(n: int, seed: int) -> np.ndarray:
    """HDR blocks over five decades: ramps, two-colour blocks and near-flat
    ones, each with one channel varying more than the others."""
    rng = np.random.default_rng(seed)
    base = np.exp(rng.normal(0, 2.5, (n, 1, 3)))
    spread = np.exp(rng.normal(-3, 1.5, (n, 1, 3)))
    ramp = np.linspace(-1, 1, 16)[None, :, None] * spread * base
    two = (rng.random((n, 16, 1)) < 0.5) * rng.normal(0, 1, (n, 1, 3)) * spread * base * 2
    kind = np.arange(n) % 3
    x = base + np.where(kind[:, None, None] == 0, ramp, 0) + np.where(kind[:, None, None] == 1, two, 0)
    x = x * (1 + rng.normal(0, 0.002, (n, 16, 3)))
    return np.abs(x).astype(np.float32)


def test_bc6h_layouts_are_the_ports_probed_tables():
    """The spec's layouts, written out independently, against the tables
    the port probed bit by bit from a decoder."""
    fields = {"rw": 0, "rx": 1, "ry": 2, "rz": 3}
    for m in range(1, 11):
        mv, _, ep, delta, direct = TWO_REGION_MODES[m]
        assert R6.MODES[m][0] == mv and R6.MODES[m][2] == ep
        assert R6.MODES[m][3] == (None if direct else delta)
        theirs = sorted((bb, fields[f], c, fb) for bb, f, fb, c in TWO_REGION_LAYOUT[m])
        assert sorted(R6._layout(m)) == theirs, m


def test_bc6h_decoder_against_the_ports_on_every_mode_it_writes():
    x = _hdr_blocks(600, 2)
    data = _bytes(encode_bc6h(torch.from_numpy(x), quality=4))
    codes, ok, mode, *_ = R6.decode(torch.from_numpy(data))
    assert ok.all()
    assert set(mode.tolist()) == set(range(1, 13))  # modes 1-12: all that the encoder writes
    np.testing.assert_array_equal(codes.numpy(), decode_bc6h(data).astype(np.int64))
    # The values: the half floats the port's decoder gives.
    np.testing.assert_array_equal(
        R6.to_float(codes).numpy(), decode_bc6h(data).view(np.float16).astype(np.float64)
    )


def _pack(fields: list[tuple[int, int]]) -> np.ndarray:
    """(value, bits) fields from bit 0 up -> one block's 16 bytes."""
    v, pos = 0, 0
    for value, n in fields:
        v |= (value & ((1 << n) - 1)) << pos
        pos += n
    return np.frombuffer(v.to_bytes(16, "little"), np.uint8).copy()


def test_bc6h_modes_13_and_14_and_the_reserved_headers():
    """The one-region modes that the encoder never writes, built by hand
    from the spec: 12.8 (base bits 10-11 stored as 11, 10) and 16.4
    (bits 10-15 stored from 15 down), every index 15 (texel 0's 7), so
    each texel decodes to the second end."""
    idx = [(7, 3)] + [(15, 4)] * 15
    base13, d13 = [0x9AB, 0x123, 0x7FF], [5, -3, 0]
    f13 = [(0b01011, 5)] + [(b & 0x3FF, 10) for b in base13]
    for b, d in zip(base13, d13):
        f13 += [(d, 8), ((b >> 11) & 1, 1), ((b >> 10) & 1, 1)]
    base14, d14 = [0xBEEF, 0x1234, 0xFFF0], [7, -8, 1]
    f14 = [(0b01111, 5)] + [(b & 0x3FF, 10) for b in base14]
    for b, d in zip(base14, d14):
        f14 += [(d, 4)] + [((b >> k) & 1, 1) for k in range(15, 9, -1)]
    blocks = np.stack([_pack(f13 + idx), _pack(f14 + idx), _pack([(0b10011, 5)]), _pack([(0b11111, 5)])])
    codes, ok, mode, *_ = R6.decode(torch.from_numpy(blocks))
    assert mode.tolist() == [13, 14, 0, 0] and ok.tolist() == [True, True, False, False]

    def ends(base, delta, bits):
        e1 = [(b + d) & ((1 << bits) - 1) for b, d in zip(base, delta)]
        u = [e if bits >= 15 else (0 if e == 0 else 0xFFFF if e == (1 << bits) - 1
                                   else ((e << 16) + 0x8000) >> bits) for e in e1]
        return [(v * 31) >> 6 for v in u]

    assert codes[0, 5].tolist() == ends(base13, d13, 12)
    assert codes[1, 9].tolist() == ends(base14, d14, 16)
    assert int(codes[2:].abs().sum()) == 0


def test_bc6h_texel1_msb_flips_only_texel_1s_top_index_bit():
    x = _hdr_blocks(600, 2)
    data = _bytes(encode_bc6h(torch.from_numpy(x), quality=4))
    _, _, mode, _, idx, _, _ = R6.decode(torch.from_numpy(data))
    for m in range(1, 13):
        b = int(torch.nonzero(mode == m)[0, 0])
        block = int.from_bytes(data[b].tobytes(), "little") ^ (1 << R6.texel1_msb(int.from_bytes(data[b].tobytes(), "little")))
        flipped = np.frombuffer(block.to_bytes(16, "little"), np.uint8)[None].copy()
        _, _, m2, _, idx2, _, _ = R6.decode(torch.from_numpy(flipped))
        assert int(m2[0]) == m
        change = (idx2[0] - idx[b]).tolist()
        assert change[1] in ((8, -8) if m > 10 else (4, -4)) and change[:1] + change[2:] == [0] * 15


def test_bc6h_proxy_rounds_to_nearest_even_half():
    x = torch.tensor([0.0, -1.0, 1.0, 65504.0, 1e6, 2.0**-24, 2.0**-25, 3 * 2.0**-25, 1.0 + 2.0**-11,
                      1.0 + 3 * 2.0**-11, 6.1e-5], dtype=torch.float64)
    want = x.float().clamp(min=0).half().view(torch.int16).long().clamp(max=0x7BFF)
    assert R6.proxy(x).tolist() == want.tolist()
    rng = np.random.default_rng(3)
    y = torch.from_numpy(np.exp(rng.normal(0, 6, 10000)).astype(np.float32)).double()
    want = y.float().half().view(torch.int16).long().clamp(min=0, max=0x7BFF)
    assert torch.equal(R6.proxy(y), want)


def test_bc6h_gap_marks_only_the_clamped_mode12_blocks():
    """On the port's plain path at quality 4 the baseline reproduces every
    stored index, except in mode-12 blocks whose fit chose a delta of -256
    and whose anchor swap stored it as +255 (the packer's clamp of +256):
    there the indices were chosen for an end one step further out than the
    one stored.  Each marked texel lies in such a block, and taking the
    delta as +256 makes its stored index the baseline's."""
    from harness import spec

    sky = spec.content_family("skybox")
    x = sky.make({"size": 128, "pool": 3, "faces": 6}, torch.Generator().manual_seed(11), "cpu")
    chain = pyramid.chain(x[1], 8, "catmullrom", False)  # member 1 marks one texel
    blocks = torch.cat([pyramid.tile(level)[..., :3].reshape(-1, 16, 3) for level in chain]).float()
    data = torch.from_numpy(_bytes(encode_bc6h(blocks, quality=4)))
    _, ok, px, _, worse = R6.analyse(data, blocks.double(), None)
    assert ok.all()
    # This content marks a texel of such a block while the packer clamps.
    for b, t in torch.nonzero(worse).tolist():
        bits = R6.unpack_bits(data[b : b + 1])
        assert int(R6._mode_of(bits)[0]) == 12
        f = (bits.double() @ R6._field_matrix(12, bits.device)).long().reshape(4, 3)[:2]
        delta = f[1] - ((f[1] >> 8) & 1) * 512
        assert 255 in delta.tolist()
        e1 = (f[0] + torch.where(delta == 255, 256, delta)) & 0x7FF
        u = R6._unquantize(torch.stack([f[0], e1]), 11)
        w = torch.as_tensor(R6.T.WEIGHTS4).long()[:, None]
        pal = R6._finish((u[0] * (64 - w) + u[1] * w + 32) >> 6)
        idx = R6.decode(data[b : b + 1])[4][:, t : t + 1]
        g, _, _ = R6.index_gaps(px[b : b + 1, t : t + 1], pal[None, None], idx,
                                torch.zeros((1, 1), dtype=torch.bool), 16, R6.value_step(px[b : b + 1, t : t + 1]))
        assert float(g) == 0.0


def test_bc6h_judge_reads_a_plain_path_cube_and_the_plain_fit():
    import json

    from harness import check

    config = {"format": "BC6H", "type": "UFloat", "color_space": "Linear", "filter": "catmullrom",
              "reference": "bc6h", "hdr_metric": "value"}
    level0, data = _texture(TextureFormat.BC6H, TextureType.UFloat, ColorSpace.Linear, 6, 16, 4)
    level0[..., 3] = 1.0
    nums = check.combine([check.judge_texture(config, level0, data, "cpu")])
    assert nums["head_bytes"] == 0 and nums["bad_blocks"] == 0
    assert nums["err_mean"] > 0 and nums["worse_texels"] == 0
    assert nums["fit_ratio_alpha"] is None and nums["fit_ratio_opaque"] > 0
    # A flat block's plain fit is off by no more than its 10-bit ends'
    # rounding: half of 31 codes, a code 2^-9 at 3.0.
    flat = R6.proxy(torch.full((2, 16, 3), 3.0, dtype=torch.float64))
    assert 0 < float(R6.plain_fit_error(flat).max()) <= 48 * (15.5 * 2.0**-9) ** 2
    json.dumps(nums)

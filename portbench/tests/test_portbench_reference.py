"""CPU tests of the plain reference against the port's plain path at
small sizes: the decoder, the mip chain, the DDS head, the index gap and
the plain fit.
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

from harness.reference import bc7 as R7  # noqa: E402
from harness.reference import dds, pyramid  # noqa: E402

from cuttlefish_tpu_torch.convert.device import pyramid_blocks  # noqa: E402
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
    ],
    ids=["bc7_srgb", "bc7_srgb_cube"],
)
def test_dds_head_and_layout_are_the_ports(fmt, type_, cs, faces):
    size = 24
    _, data = _texture(fmt, type_, cs, faces, size, 1)
    levels = pyramid.full_levels(size, size)
    head = dds.head(fmt.name, type_.name, cs is ColorSpace.sRGB, size, size, levels, faces)
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

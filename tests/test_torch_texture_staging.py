"""``Texture.set_image``'s private copy of each face.

On a CPU texture the copy is plain NumPy memory holding exactly what
``image.convert(RGBAF)`` and ``change_color_space`` give; on a CUDA
texture it is page-locked memory of torch's caching host allocator, taken
back from the cache by the next texture of the same size.  Tests marked
``gpu`` need a CUDA card and skip without one; run them on the card with
``python -m pytest --noconftest -o addopts="" -m gpu
tests/test_torch_texture_staging.py``.
"""

import numpy as np
import pytest
import torch

import cuttlefish_tpu_torch as cp
from cuttlefish_tpu_torch.image.format import storage_dtype, storage_shape

F, T, Q = cp.TextureFormat, cp.TextureType, cp.Quality
IF, CS = cp.ImageFormat, cp.ColorSpace

FUSED = {"scan", "upload", "pyramid", "kernel", "fetch", "interleave", "fused"}
FORMATS = [f for f in IF if f is not IF.Invalid]
SPACES = [(src, dst) for src in (CS.Linear, CS.sRGB) for dst in (CS.Linear, CS.sRGB)]


def _array(fmt: IF, size: int, seed: int) -> np.ndarray:
    """Seeded storage of ``fmt``: integers over the format's range, floats
    over [-0.25, 1.5) with the sRGB curves' knees among them."""
    rng = np.random.default_rng(seed)
    shape, dtype = storage_shape(fmt, size, size), storage_dtype(fmt)
    if dtype.kind == "f":
        a = rng.uniform(-0.25, 1.5, shape).astype(dtype)
        a.flat[:4] = [0.04045, 0.0031308, 0.0, 1.0]
        return a
    top = {IF.RGB5: 32, IF.RGB565: 32}.get(fmt, np.iinfo(dtype).max)
    return rng.integers(np.iinfo(dtype).min if dtype.kind == "i" else 0, top, shape, dtype)


def _image(fmt: IF, space: CS, size: int = 8, seed: int = 5) -> cp.Image:
    return cp.Image.from_array(_array(fmt, size, seed), fmt, space)


def _texture(space: CS, device, size: int = 8, cube: bool = False) -> cp.Texture:
    dim = cp.Dimension.Cube if cube else cp.Dimension.Dim2D
    return cp.Texture(dim, size, size, 0, 1, space, device=device)


@pytest.mark.parametrize("src,dst", SPACES, ids=[f"{s.name}-{d.name}" for s, d in SPACES])
@pytest.mark.parametrize("fmt", FORMATS, ids=[f.name for f in FORMATS])
def test_stored_face_is_convert_then_change_color_space(fmt, src, dst):
    image = _image(fmt, src)
    tex = _texture(dst, "cpu")
    assert tex.set_image(image)
    want = image.convert(IF.RGBAF)
    assert want.change_color_space(dst)
    got = tex.get_image()
    assert got.format is IF.RGBAF and got.color_space is dst
    assert got.array.dtype == np.float32 and got.array.shape == want.array.shape
    assert got.array.tobytes() == want.array.tobytes()


PRIVATE = [(IF.RGBAF, CS.sRGB, CS.sRGB), (IF.RGBAF, CS.Linear, CS.sRGB), (IF.RGBA8, CS.sRGB, CS.sRGB)]


@pytest.mark.parametrize("fmt,src,dst", PRIVATE, ids=["RGBAF", "RGBAF-to-sRGB", "RGBA8"])
def test_the_copy_is_private(fmt, src, dst):
    image = _image(fmt, src)
    tex = _texture(dst, "cpu")
    assert tex.set_image(image)
    stored = tex.get_image().array
    before = stored.copy()
    assert not np.shares_memory(stored, image.array)
    image.array[...] = 0
    assert tex.get_image().array.tobytes() == before.tobytes()


@pytest.mark.parametrize("cube", [False, True], ids=["2d", "cube"])
def test_staging_stats_on_a_cpu_texture(cube):
    tex = _texture(CS.sRGB, "cpu", 16, cube)
    for f in range(6 if cube else 1):
        assert tex.set_image(_image(IF.RGBAF, CS.sRGB, 16, f), cp.CubeFace(f) if cube else None)
    assert tex.convert_with_mips(F.BC1_RGB, T.UNorm, Q.Lowest)
    stats = tex.last_convert_stats
    assert stats["staging"] == {"pinned_share": 0.0, "host_allocs": 0}
    assert set(stats["phases"]) == FUSED


def _refuse_pinning(monkeypatch) -> None:
    """Make every pinned allocation raise, as on a machine without one."""
    empty = torch.empty

    def refuse(*args, pin_memory=False, **kwargs):
        if pin_memory:
            raise RuntimeError("no pinned memory allocator")
        return empty(*args, **kwargs)

    monkeypatch.setattr(torch, "empty", refuse)


def test_a_pinning_failure_falls_back_to_plain_memory(monkeypatch):
    """A CUDA texture whose pinned allocation raises keeps a plain copy."""
    _refuse_pinning(monkeypatch)
    image = _image(IF.RGBAF, CS.sRGB)
    tex = _texture(CS.Linear, "cuda")
    assert tex.set_image(image)
    want = image.convert(IF.RGBAF)
    want.change_color_space(CS.Linear)
    assert tex.get_image().array.tobytes() == want.array.tobytes()


# -- on the card --------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", torch.cuda.current_device())


def _fused(tex: cp.Texture) -> list[bytes]:
    assert tex.convert_with_mips(F.BC7, T.UNorm, Q.Highest)
    return [tex.data(mip_level=k) for k in range(tex.mip_levels)]


@pytest.mark.gpu
@pytest.mark.parametrize("cube", [False, True], ids=["2d", "cube"])
def test_stored_faces_are_page_locked(cuda, cube):
    tex = _texture(CS.sRGB, cuda, 64, cube)
    for f in range(6 if cube else 1):
        assert tex.set_image(_image(IF.RGBA8, CS.sRGB, 64, f), cp.CubeFace(f) if cube else None)
        assert torch.from_numpy(tex.get_image(cp.CubeFace(f)).array).is_pinned()
    assert tex.convert_with_mips(F.BC1_RGB, T.UNorm, Q.Lowest)
    assert tex.last_convert_stats["staging"]["pinned_share"] == 1.0


@pytest.mark.gpu
def test_a_second_texture_takes_the_cached_block(cuda):
    image = _image(IF.RGBAF, CS.sRGB, 512)
    first = _texture(CS.sRGB, cuda, 512)
    assert first.set_image(image)
    assert first.convert_with_mips(F.BC1_RGB, T.UNorm, Q.Lowest)
    del first
    second = _texture(CS.sRGB, cuda, 512)
    assert second.set_image(image)
    assert second.convert_with_mips(F.BC1_RGB, T.UNorm, Q.Lowest)
    assert second.last_convert_stats["staging"] == {"pinned_share": 1.0, "host_allocs": 0}


@pytest.mark.gpu
def test_pinned_and_pageable_stores_give_the_same_words(cuda, monkeypatch):
    image = _image(IF.RGBAF, CS.sRGB, 256)
    pinned = _texture(CS.sRGB, cuda, 256)
    assert pinned.set_image(image)
    words = _fused(pinned)
    assert pinned.last_convert_stats["staging"]["pinned_share"] == 1.0

    _refuse_pinning(monkeypatch)
    pageable = _texture(CS.sRGB, cuda, 256)
    assert pageable.set_image(image)
    assert not torch.from_numpy(pageable.get_image().array).is_pinned()
    assert _fused(pageable) == words
    assert pageable.last_convert_stats["staging"]["pinned_share"] == 0.0


@pytest.mark.gpu
def test_a_later_change_to_the_callers_array_does_not_reach_the_words(cuda):
    image = _image(IF.RGBAF, CS.sRGB, 256)
    untouched = cp.Image.from_array(image.array.copy(), IF.RGBAF, CS.sRGB)
    tex = _texture(CS.sRGB, cuda, 256)
    assert tex.set_image(image)
    image.array[...] = 0.5
    control = _texture(CS.sRGB, cuda, 256)
    assert control.set_image(untouched)
    assert _fused(tex) == _fused(control)

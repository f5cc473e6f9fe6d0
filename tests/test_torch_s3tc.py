"""The port's BC1-BC5 path against the JAX package's TPU kernels.

Block level: the port's plain PyTorch version (``kernels/bc.py``) against
``encode_bc*_pallas`` in interpret mode, on float blocks made as
tests/test_pallas.py makes them.  Slice level: the port's ``Texture`` on
the CPU against ``cuttlefish_tpu.Texture`` with ``CUTTLEFISH_PALLAS=1``:
BC1_RGB -> DDS, BC3 + mips -> KTX and BC5 SNorm + mips -> KTX, held to
equal file bytes.

The reference runs in a child interpreter with two XLA CPU rewrites off:
the algebraic simplifier (it folds chains of constant products, such as a
palette weight times ``q * (1/255)``, into one product) and FMA
contraction (``--xla_cpu_max_isa=AVX``).  Both change the rounding of the
kernel as written, and the u8 wire puts many texels exactly half way
between two palette entries, where that rounding picks the index: with the
default flags 4 of BC3's 66 blocks and 1 of BC5's flip, with both off all
blocks are equal.  The block counts (64 for BC1, 128 for BC3 and BC5) are
the JAX package's bucket sizes for the slice-level textures, so each
Pallas program compiles once for both levels.  tests/test_torch_bc.py
holds more cases against the reference run with the default flags.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import cuttlefish_tpu as ct
import cuttlefish_tpu_torch as cp
from cuttlefish_tpu import decode as jd
from cuttlefish_tpu_torch import decode as pd
from cuttlefish_tpu_torch.kernels import bc

_ROOT = Path(__file__).resolve().parent.parent
_H, _W = 22, 30  # not a multiple of the block size
_REF_XLA_FLAGS = "--xla_disable_hlo_passes=algsimp --xla_cpu_max_isa=AVX"

# (format, type, mips, file type, signed source)
_SLICE = [
    ("BC1_RGB", "UNorm", 1, "DDS", False),
    ("BC3", "UNorm", 99, "KTX", False),
    ("BC5", "SNorm", 99, "KTX", True),
]
_CASES = ["bc1_q2", "bc3_q2", "bc5s_q2"]

_REFERENCE = r"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
import cuttlefish_tpu as ct
from cuttlefish_tpu.kernels import bc_pallas as P

inp = np.load(sys.argv[1])
one = (1.0, 1.0, 1.0)
out = {
    "bc1_q2": np.asarray(P.encode_bc1_pallas(inp["b64"], 2, False, True, one)),
    "bc3_q2": np.asarray(P.encode_bc3_pallas(inp["b128"], 2, one)),
    "bc5s_q2": np.asarray(P.encode_bc5_pallas(inp["s128"], 2, True)),
}
for fmt, typ, mips, ftype, src in (
    ("BC1_RGB", "UNorm", 1, "DDS", "unsigned"),
    ("BC3", "UNorm", 99, "KTX", "unsigned"),
    ("BC5", "SNorm", 99, "KTX", "signed"),
):
    arr = inp[src]
    tex = ct.Texture(ct.Dimension.Dim2D, arr.shape[1], arr.shape[0], mip_levels=mips)
    assert tex.set_image(ct.Image.from_array(arr, ct.ImageFormat.RGBAF))
    if mips > 1:
        assert tex.generate_mipmaps()
    assert tex.convert(getattr(ct.TextureFormat, fmt), getattr(ct.TextureType, typ), ct.Quality.Normal)
    res, data = tex.save_to_bytes(getattr(ct.FileType, ftype))
    assert res is ct.SaveResult.Success
    out[fmt] = np.frombuffer(data, np.uint8)
np.savez(sys.argv[2], **out)
"""


def _blocks(n, seed=7):
    rng = np.random.default_rng(seed)
    base = rng.random((n, 1, 4), np.float32)
    grad = rng.normal(0, 0.15, (n, 16, 4)).astype(np.float32)
    b = np.clip(base + grad, 0, 1)
    b[::3, :, 3] = np.clip(b[::3, :, 3] * 0.6 + 0.2, 0, 1)
    return b


def _source(signed):
    rng = np.random.default_rng(11)
    y, x = np.mgrid[0:_H, 0:_W].astype(np.float32)
    arr = np.stack(
        [np.sin(x / 7.0), np.cos(y / 5.0), np.sin((x + y) / 9.0), np.cos(x / 11.0)], axis=-1
    ) * 0.4 + 0.5
    arr = np.clip(arr + rng.normal(0, 0.05, arr.shape), 0, 1).astype(np.float32)
    return arr * 2 - 1 if signed else arr


def _bytes(words):
    return np.frombuffer(np.ascontiguousarray(np.asarray(words).astype("<u4")).tobytes(), np.uint8)


def _psnr(dec, ref, peak):
    mse = ((dec.astype(np.float64) - ref) ** 2).mean()
    return 10 * np.log10(peak**2 / (mse + 1e-20))


def _same(a, b):
    return float(np.all(np.asarray(a) == np.asarray(b), axis=-1).mean())


@pytest.fixture(scope="module")
def inputs():
    b64, b128 = _blocks(64), _blocks(128, seed=8)
    s128 = np.ascontiguousarray(b128 * 2 - 1).astype(np.float16).astype(np.float32)
    return {"b64": b64, "b128": b128, "s128": s128,
            "unsigned": _source(False), "signed": _source(True)}


@pytest.fixture(scope="module")
def reference(inputs, tmp_path_factory):
    """The JAX package's words and files, from the child interpreter."""
    tmp = tmp_path_factory.mktemp("s3tc_ref")
    np.savez(tmp / "in.npz", **inputs)
    env = dict(os.environ)
    env.update(XLA_FLAGS=_REF_XLA_FLAGS, CUTTLEFISH_PALLAS="1", JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(_ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]
    )
    proc = subprocess.run(
        [sys.executable, "-c", _REFERENCE, str(tmp / "in.npz"), str(tmp / "out.npz")],
        cwd=_ROOT, env=env, capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    with np.load(tmp / "out.npz") as out:
        return {k: out[k] for k in out.files}


@pytest.fixture(scope="module")
def encoded(inputs, reference):
    """case -> (source blocks, port words, Pallas-interpret words)."""
    b64, b128, s128 = (torch.from_numpy(inputs[k]) for k in ("b64", "b128", "s128"))
    return {
        "bc1_q2": (inputs["b64"], bc.encode_bc1(b64, 2), reference["bc1_q2"]),
        "bc3_q2": (inputs["b128"], bc.encode_bc3(b128, 2), reference["bc3_q2"]),
        "bc5s_q2": (inputs["s128"], bc.encode_bc5(s128, 2, True), reference["bc5s_q2"]),
    }


def _decoded(case, words):
    raw = _bytes(words)
    if case.startswith("bc1"):
        return jd.decode_bc1(raw, opaque=True)[..., :3], 255.0
    if case.startswith("bc3"):
        return jd.decode_bc3(raw), 255.0
    return jd.decode_bc5(raw, signed=True), 2.0


def _target(case, src):
    if case.startswith("bc1"):
        return np.round(src[..., :3] * 255)
    if case.startswith("bc3"):
        return np.round(src * 255)
    return src[..., :2]


@pytest.mark.parametrize("case", _CASES)
def test_plain_matches_tpu_kernel(case, encoded):
    """>= 99 % identical blocks (100 % so far) and PSNR within 0.05 dB."""
    src, port, ref = encoded[case]
    assert port.dtype == torch.uint32
    port = port.numpy()
    assert port.shape == np.asarray(ref).shape
    assert _same(port, ref) >= 0.99, _same(port, ref)
    target = _target(case, src)
    dp, peak = _decoded(case, port)
    dr, _ = _decoded(case, ref)
    assert abs(_psnr(dp, target, peak) - _psnr(dr, target, peak)) <= 0.05


def test_bc2_is_explicit_alpha_plus_bc3_colour(encoded):
    """BC2's colour words are BC3's (both run the BC1 tile without black);
    its alpha words are the 4-bit formula of bc_pallas.py:496-501."""
    src, bc3, _ = encoded["bc3_q2"]
    got = bc.encode_bc2(torch.from_numpy(src), 2).numpy().astype(np.uint64)
    assert np.array_equal(got[:, 2:], bc3.numpy()[:, 2:])
    a = np.round(np.clip(src[..., 3], 0, 1) * 15).astype(np.uint64)
    shifts = 4 * np.arange(8, dtype=np.uint64)
    assert np.array_equal(got[:, 0], (a[:, :8] << shifts).sum(axis=1))
    assert np.array_equal(got[:, 1], (a[:, 8:] << shifts).sum(axis=1))


# ---------------------------------------------------------------------------
# Slice level: Texture -> convert -> save, port vs the JAX package
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def slices(inputs, reference):
    """format -> (port texture, its file bytes, reference file bytes)."""
    out = {}
    for fmt, typ, mips, ftype, signed in _SLICE:
        tex = cp.Texture(cp.Dimension.Dim2D, _W, _H, mip_levels=mips, device="cpu")
        arr = inputs["signed" if signed else "unsigned"]
        assert tex.set_image(cp.Image.from_array(arr, cp.ImageFormat.RGBAF))
        if mips > 1:
            assert tex.generate_mipmaps()
        assert tex.convert(getattr(cp.TextureFormat, fmt), getattr(cp.TextureType, typ), cp.Quality.Normal)
        res, data = tex.save_to_bytes(getattr(cp.FileType, ftype))
        assert res is cp.SaveResult.Success
        out[fmt] = (tex, data, reference[fmt].tobytes())
    return out


@pytest.mark.parametrize("case", _SLICE, ids=lambda c: c[0])
def test_slice_file_matches_reference(case, slices):
    """Equal file bytes: the same header and every block of every mip."""
    fmt, _, mips, ftype, _ = case
    port, fp, fr = slices[fmt]
    assert port.mip_levels == (1 if mips == 1 else 5)
    ref = ct.load_texture(fr)
    assert ref.mip_levels == port.mip_levels
    bs = 8 if fmt == "BC1_RGB" else 16
    same = total = 0
    for m in range(port.mip_levels):
        a = np.frombuffer(port.data(mip_level=m), np.uint8).reshape(-1, bs)
        b = np.frombuffer(ref.data(mip_level=m), np.uint8).reshape(-1, bs)
        same += int(np.all(a == b, axis=1).sum())
        total += a.shape[0]
    assert (same, len(fp)) == (total, len(fr))
    assert fp == fr


@pytest.mark.parametrize("case", _SLICE, ids=lambda c: c[0])
def test_slice_blocks_decode_alike(case, slices):
    """Both packages' decoders give the same texels for both packages'
    bytes, and the port's file loads back with its own loader."""
    fmt, typ, _, ftype, signed = case
    port, fp, fr = slices[fmt]
    for data in (fp, fr):
        tex = ct.load_texture(data)
        for m in range(tex.mip_levels):
            raw = np.frombuffer(tex.data(mip_level=m), np.uint8)
            if fmt == "BC1_RGB":
                a, b = jd.decode_bc1(raw, opaque=True), pd.decode_bc1(raw, opaque=True)
            elif fmt == "BC3":
                a, b = jd.decode_bc3(raw), pd.decode_bc3(raw)
            else:
                a, b = jd.decode_bc5(raw, signed=signed), pd.decode_bc5(raw, signed=signed)
            assert np.array_equal(a, b)
    loaded = cp.load_texture(fp)
    assert loaded.format is getattr(cp.TextureFormat, fmt)
    assert loaded.type is getattr(cp.TextureType, typ)
    for m in range(port.mip_levels):
        assert loaded.data(mip_level=m) == port.data(mip_level=m)
    src = port.get_image(mip_level=0).rgbaf()
    dec = loaded.decode_image().rgbaf()
    ch = 2 if fmt == "BC5" else (3 if fmt == "BC1_RGB" else 4)
    peak = 2.0 if signed else 1.0
    assert _psnr(dec[..., :ch], src[..., :ch], peak) > 20.0  # noisy source: 26-28 dB

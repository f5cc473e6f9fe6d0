"""The port imports neither jax, triton nor the JAX package.

The test conftest imports jax, so the run-time check goes to a fresh
interpreter: it converts BC7 + mips -> DDS, BC1 -> DDS, BC3 + mips -> KTX,
HDR BC6H + mips -> DDS, ETC2 RGB, RGBA8 and punch-through (R8G8B8A1) + mips
-> KTX, EAC R11G11 SNorm + mips -> KTX and ASTC 4x4 + mips -> KTX on the
CPU, BC3 through the fused mip pipeline (``convert_with_mips``) -> KTX,
and ASTC 4x4 UFloat -> PVR, PVRTC1 RGBA 4bpp -> PVR and PVRTC2 RGBA 2bpp
-> KTX with mips, reads each file back, decodes it, scores the last three
with ``metrics.score_texture``, and lists the loaded modules.  A
static check scans every module of the port and chip_smoke.py for an
import of ``cuttlefish_tpu`` (other than ``cuttlefish_tpu_torch``), jax or
triton at any level.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

_ROOT = Path(__file__).resolve().parent.parent

_SCRIPT = r"""
import os, sys, tempfile
import numpy as np
import cuttlefish_tpu_torch as cp
from cuttlefish_tpu_torch.decode import (
    decode_astc, decode_bc1, decode_bc3, decode_bc6h_f32, decode_bc7, decode_eac_rg11,
    decode_etc2_a1, decode_etc2_rgba, decode_etc_rgb,
)

arr = np.random.default_rng(0).random((12, 20, 4)).astype(np.float32)
hdr = arr * np.float32(40.0)
out = tempfile.mkdtemp()
U = cp.TextureType.UNorm
cases = [
    (cp.TextureFormat.BC7, U, arr, 9, "t7.dds", decode_bc7),
    (cp.TextureFormat.BC1_RGB, U, arr, 1, "t1.dds", lambda raw: decode_bc1(raw, opaque=True)),
    (cp.TextureFormat.BC3, U, arr, 9, "t3.ktx", decode_bc3),
    (cp.TextureFormat.BC6H, cp.TextureType.UFloat, hdr, 9, "t6.dds", decode_bc6h_f32),
    (cp.TextureFormat.ETC2_R8G8B8, U, arr, 9, "e2.ktx", lambda raw: decode_etc_rgb(raw, True)),
    (cp.TextureFormat.ETC2_R8G8B8A8, U, arr, 9, "e2a.ktx", decode_etc2_rgba),
    (cp.TextureFormat.ETC2_R8G8B8A1, U, arr, 9, "e2p.ktx", decode_etc2_a1),
    (cp.TextureFormat.EAC_R11G11, cp.TextureType.SNorm, arr * 2 - 1, 9, "rg.ktx",
     lambda raw: decode_eac_rg11(raw, True)),
    (cp.TextureFormat.ASTC_4x4, U, arr, 9, "a4.ktx", lambda raw: decode_astc(raw, 4, 4)),
]
for fmt, typ, src, mips, name, dec in cases:
    tex = cp.Texture(cp.Dimension.Dim2D, 20, 12, mip_levels=mips, device="cpu")
    tex.set_image(cp.Image.from_array(src, cp.ImageFormat.RGBAF))
    if mips > 1:
        tex.generate_mipmaps()
    assert tex.convert(fmt, typ, cp.Quality.Normal)
    assert tex.last_convert_stats["launches"] == {}
    path = os.path.join(out, name)
    assert tex.save(path) is cp.SaveResult.Success
    loaded = cp.load_texture(path)
    assert loaded.format is fmt and loaded.type is typ
    assert loaded.mip_levels == tex.mip_levels
    for m in range(tex.mip_levels):
        assert loaded.data(mip_level=m) == tex.data(mip_level=m)
    assert dec(np.frombuffer(tex.data(), np.uint8)).shape[0] == 15
    assert loaded.decode_image().array.shape == (12, 20, 4)
tex = cp.Texture(cp.Dimension.Dim2D, 20, 12, device="cpu")
tex.set_image(cp.Image.from_array(arr, cp.ImageFormat.RGBAF))
assert tex.convert_with_mips(cp.TextureFormat.BC3, U, cp.Quality.Normal)
assert tex.mip_levels == 5 and tex.last_convert_stats["launches"] == {}
path = os.path.join(out, "fused3.ktx")
assert tex.save(path) is cp.SaveResult.Success
loaded = cp.load_texture(path)
assert loaded.format is cp.TextureFormat.BC3 and loaded.mip_levels == 5
for m in range(5):
    assert loaded.data(mip_level=m) == tex.data(mip_level=m)
assert decode_bc3(np.frombuffer(tex.data(), np.uint8)).shape[0] == 15
# ASTC UFloat, PVRTC1 and PVRTC2: convert, save, load, decode and score.
from cuttlefish_tpu_torch import metrics
sq = np.random.default_rng(1).random((32, 32, 4)).astype(np.float32)
for _ in range(4):
    sq = (sq + np.roll(sq, 1, 0) + np.roll(sq, -1, 0) + np.roll(sq, 1, 1) + np.roll(sq, -1, 1)) / 5
for fmt, typ, src, name in (
    (cp.TextureFormat.ASTC_4x4, cp.TextureType.UFloat, sq * np.float32(12.0), "ah.pvr"),
    (cp.TextureFormat.PVRTC1_RGBA_4BPP, U, sq, "p1.pvr"),
    (cp.TextureFormat.PVRTC2_RGBA_2BPP, U, sq, "p2.ktx"),
):
    src = src.astype(np.float32)
    src[..., 3] = np.clip(src[..., 3], 0.0, 1.0)
    tex = cp.Texture(cp.Dimension.Dim2D, 32, 32, mip_levels=6, device="cpu")
    tex.set_image(cp.Image.from_array(src, cp.ImageFormat.RGBAF))
    tex.generate_mipmaps()
    assert tex.convert(fmt, typ, cp.Quality.Normal)
    assert tex.last_convert_stats["launches"] == {}
    path = os.path.join(out, name)
    assert tex.save(path) is cp.SaveResult.Success
    loaded = cp.load_texture(path)
    assert loaded.format is fmt and loaded.mip_levels == 6
    for m in range(6):
        assert loaded.data(mip_level=m) == tex.data(mip_level=m)
    img = loaded.decode_image().array
    assert img.shape == (32, 32, 4) and np.isfinite(img).all()
    score = metrics.score_texture(tex, [src])
    if fmt is cp.TextureFormat.PVRTC2_RGBA_2BPP:
        # metrics.decode_surface has no PVRTC2 branch, as in the JAX package.
        assert score == {"psnr": None}
        dec = tex.decode_image().rgbaf()
        assert 10 * np.log10(1.0 / np.mean((dec - src) ** 2)) > 24
    elif typ is U:
        assert score["psnr"] > 20, score
    else:  # peak-1 PSNR of HDR values up to 12: finite, not a quality bar
        assert np.isfinite(score["psnr"]), score
bad = sorted(
    m for m in sys.modules
    if m.split(".")[0] in ("jax", "jaxlib", "triton", "cuttlefish_tpu")
)
print("LOADED", bad)
assert not bad, bad
"""


def test_port_main_path_imports_no_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(_ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]
    )
    proc = subprocess.run(
        [sys.executable, "-c", _SCRIPT],
        cwd=_ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LOADED []" in proc.stdout


_FORBIDDEN = ("cuttlefish_tpu", "jax", "jaxlib", "triton")


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module


def _port_files():
    return sorted((_ROOT / "cuttlefish_tpu_torch").rglob("*.py")) + [_ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(_ROOT)))
def test_no_module_of_the_port_imports_the_jax_package(path):
    bad = [
        (line, name) for line, name in _imports(path)
        if name.split(".")[0] in _FORBIDDEN
    ]
    assert not bad, bad

"""The port imports neither jax, triton nor the JAX package.

The test conftest imports jax, so the run-time check goes to a fresh
interpreter: it converts BC7 + mips -> DDS, BC1 -> DDS, BC3 + mips -> KTX,
HDR BC6H + mips -> DDS, ETC2 RGB, RGBA8 and punch-through (R8G8B8A1) + mips
-> KTX, EAC R11G11 SNorm + mips -> KTX and ASTC 4x4 + mips -> KTX on the
CPU, BC3 through the fused mip pipeline (``convert_with_mips``) -> KTX,
and ASTC 4x4 UFloat -> PVR, PVRTC1 RGBA 4bpp -> PVR and PVRTC2 RGBA 2bpp
-> KTX with mips, reads each file back, decodes it, scores the last three
with ``metrics.score_texture``, holds the port's BC4 to the native CPU
encoder's north-star bar (``northstar.py``), and lists the loaded modules; then
``python -m cuttlefish_tpu_torch`` converts a PNG to R8G8B8A8 + mips ->
KTX and prints that file's ``--texture-info``, each under ``-X importtime``,
which lists every module the interpreter loads.  Without a card a block
format through ``python -m cuttlefish_tpu_torch`` fails and writes no
file: nothing encodes on the CPU in its stead.  A
static check scans every module of the port and chip_smoke.py for an
import of ``cuttlefish_tpu`` (other than ``cuttlefish_tpu_torch``), jax or
triton at any level.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
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
# A north-star bar: the port's BC4 against the native CPU encoder.
from cuttlefish_tpu_torch import northstar
p_port, p_cpu = northstar.bc4(2, "cpu", threads=1)
assert p_port >= p_cpu - northstar.TIE_DB, (p_port, p_cpu)
bad = sorted(
    m for m in sys.modules
    if m.split(".")[0] in ("jax", "jaxlib", "triton", "cuttlefish_tpu")
)
print("LOADED", bad)
assert not bad, bad
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(_ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]
    )
    return env


def _start(argv, cwd, log):
    """Start ``python *argv`` with stdout and stderr to ``log``.out/.err,
    so several run side by side and no pipe fills."""
    with open(f"{log}.out", "w") as out, open(f"{log}.err", "w") as err:
        return subprocess.Popen(
            [sys.executable, *argv], cwd=cwd, env=_env(), stdout=out, stderr=err, text=True
        )


def _finish(proc, log):
    """Wait for ``proc`` -> (return code, stdout, stderr, the top-level
    names of every module that ``-X importtime`` saw imported)."""
    proc.wait(timeout=300)
    out, err = Path(f"{log}.out").read_text(), Path(f"{log}.err").read_text()
    loaded = {
        line.rsplit("|", 1)[1].strip().split(".")[0]
        for line in err.splitlines() if line.startswith("import time:")
    }
    return proc.returncode, out, err, loaded


def _python_m(args):
    return ["-X", "importtime", "-m", "cuttlefish_tpu_torch", *args]


@pytest.fixture(scope="module", autouse=True)
def interpreters(tmp_path_factory):
    """The four interpreters of this file's subprocess tests, started
    before its first test so they run side by side and beside the static
    scans: ``_SCRIPT``; ``python -m cuttlefish_tpu_torch`` on an R8G8B8A8 +
    mips -> KTX convert, on the ``--texture-info`` of a KTX that the port
    writes in this process, and on a BC7 convert.  -> (their directory,
    name -> ``_finish``'s result, waited for on first use)."""
    import cuttlefish_tpu_torch as cp
    from cuttlefish_tpu_torch import native

    tmp = tmp_path_factory.mktemp("interpreters")
    rgba = np.random.default_rng(3).integers(0, 256, (12, 20, 4), np.uint8)
    (tmp / "in.png").write_bytes(native.png_encode(rgba))
    tex = cp.Texture(cp.Dimension.Dim2D, 20, 12, device="cpu")
    assert tex.set_image(cp.Image.from_array(rgba.astype(np.float32) / 255, cp.ImageFormat.RGBAF))
    assert tex.generate_mipmaps() and tex.convert(cp.TextureFormat.R8G8B8A8)
    assert tex.save(tmp / "api.ktx") is cp.SaveResult.Success
    argv = {
        "script": (["-c", _SCRIPT], _ROOT),
        "convert": (_python_m(["-i", "in.png", "-f", "R8G8B8A8", "-m", "-o", "out.ktx"]), tmp),
        "info": (_python_m(["--texture-info", "api.ktx"]), tmp),
        "bc7": (_python_m(["-i", "in.png", "-f", "BC7", "-o", "out.dds"]), tmp),
    }
    procs = {name: _start(args, cwd, tmp / name) for name, (args, cwd) in argv.items()}
    done = {}

    def result(name):
        if name not in done:
            done[name] = _finish(procs[name], tmp / name)
        return done[name]

    try:
        yield tmp, result
    finally:
        for proc in procs.values():
            proc.kill()
            proc.wait()


def test_port_main_path_imports_no_jax(interpreters):
    import cuttlefish_tpu_torch as cp

    tmp, result = interpreters
    rc, stdout, stderr, _ = result("script")
    assert rc == 0, stdout + stderr
    assert "LOADED []" in stdout
    for name in ("convert", "info"):
        rc, stdout, stderr, loaded = result(name)
        assert rc == 0, stdout + stderr[-4000:]
        assert "cuttlefish_tpu_torch" in loaded and "torch" in loaded
        assert not loaded & set(_FORBIDDEN), sorted(loaded & set(_FORBIDDEN))
    written = cp.load_texture((tmp / "out.ktx").read_bytes())
    assert written.format is cp.TextureFormat.R8G8B8A8 and written.mip_levels == 5
    info = result("info")[1]
    assert "mip levels: 5" in info and "format:     R8G8B8A8" in info


def test_python_m_block_format_without_a_card_writes_nothing(interpreters):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the convert runs there")
    tmp, result = interpreters
    rc, _, _, _ = result("bc7")
    assert rc != 0
    assert not (tmp / "out.dds").exists()


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

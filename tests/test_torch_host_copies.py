"""The port's copies of the host layers agree with the JAX package's.

The port keeps its own copy of every host module it uses (formats, colour,
images and codecs, containers, standard converters, block tiling, the
S3TC, BC6H, ETC and ASTC decoders, the whole-surface decoder, the metrics,
the BC6H layout tables, the ASTC integer-sequence and partition tables, the
CLI and its `__main__`, the native CPU encoders' C++ sources and their ten
wrappers).  These tests hold the copies to the originals: the code is
the same apart from imports and docstrings (the sources byte for byte, the
wrappers apart from the build helper they call), enums match by name and value,
a PNG from the port's native codec loads alike through both packages, and
an uncompressed texture saves to the same bytes in every container.
"""

import ast
from pathlib import Path

import numpy as np
import pytest

import cuttlefish_tpu as ct
import cuttlefish_tpu_torch as cp
from cuttlefish_tpu import formats as jf
from cuttlefish_tpu.image import format as jif
from cuttlefish_tpu_torch import formats as pf
from cuttlefish_tpu_torch.image import format as pif

_ROOT = Path(__file__).resolve().parent.parent

# Copied with only their imports (and docstrings) changed.
_VERBATIM = [
    "formats.py", "color.py", "packfloat.py",
    "image/__init__.py", "image/format.py", "image/resample.py", "image/image.py",
    "image/codecs.py", "image/exr.py", "image/webp.py",
    "containers/__init__.py", "containers/dds.py", "containers/ktx.py",
    "containers/ktx2.py", "containers/pvr.py", "containers/load.py",
    "convert/blocks.py", "convert/standard.py", "decode/s3tc.py", "decode/bc6h.py",
    "decode/etc.py", "kernels/bc6h_tables.py", "decode/astc.py", "kernels/astc_ise.py",
    "kernels/astc_partition.py", "decode/surface.py", "metrics.py", "__main__.py",
]


class _Normalise(ast.NodeTransformer):
    """Drop docstrings (module, class, function); read
    ``cuttlefish_tpu_torch`` imports as ``cuttlefish_tpu`` ones, and the
    port's ETC, ASTC and PVRTC table modules as the JAX package's
    ``kernels.etc``, ``kernels.astc`` and ``kernels.pvrtc``, where the
    tables live beside the encoders."""

    def _drop_docstring(self, node):
        body = node.body
        if (
            body
            and isinstance(body[0], ast.Expr)
            and isinstance(body[0].value, ast.Constant)
            and isinstance(body[0].value.value, str)
        ):
            node.body = body[1:]
        return self.generic_visit(node)

    visit_Module = visit_ClassDef = _drop_docstring
    visit_FunctionDef = visit_AsyncFunctionDef = _drop_docstring

    def visit_ImportFrom(self, node):
        if node.module and node.module.startswith("cuttlefish_tpu_torch"):
            node.module = "cuttlefish_tpu" + node.module[len("cuttlefish_tpu_torch"):]
            if node.module == "cuttlefish_tpu.kernels.etc_tables":
                node.module = "cuttlefish_tpu.kernels.etc"
            if node.module == "cuttlefish_tpu.kernels.astc_tables":
                node.module = "cuttlefish_tpu.kernels.astc"
            if node.module == "cuttlefish_tpu.kernels.pvrtc_tables":
                node.module = "cuttlefish_tpu.kernels.pvrtc"
        return node


def _tree(path: Path) -> str:
    return ast.dump(_Normalise().visit(ast.parse(path.read_text())))


@pytest.mark.parametrize("rel", _VERBATIM)
def test_copy_is_the_original(rel):
    assert _tree(_ROOT / "cuttlefish_tpu_torch" / rel) == _tree(_ROOT / "cuttlefish_tpu" / rel)


class _NormaliseCli(_Normalise):
    """``_Normalise``, and also drop ``HELP``'s text, the ``device``
    parameter of ``run`` and the ``device=`` keyword of its ``Texture(...)``
    call: the port's CLI differs from the JAX package's there only."""

    def visit_Assign(self, node):
        if any(isinstance(t, ast.Name) and t.id == "HELP" for t in node.targets):
            node.value = ast.Constant("")
        return self.generic_visit(node)

    def visit_FunctionDef(self, node):
        if node.name == "run" and node.args.args[-1].arg == "device":
            node.args.args.pop()
            node.args.defaults.pop()
        return self._drop_docstring(node)

    def visit_Call(self, node):
        if isinstance(node.func, ast.Name) and node.func.id == "Texture":
            node.keywords = [k for k in node.keywords if k.arg != "device"]
        return self.generic_visit(node)


def test_cli_is_the_original():
    def tree(path):
        return ast.dump(_NormaliseCli().visit(ast.parse(path.read_text())))

    port = _ROOT / "cuttlefish_tpu_torch" / "cli.py"
    assert tree(port) == tree(_ROOT / "cuttlefish_tpu" / "cli.py")
    # The normaliser leaves the rest alone: the port's run takes device.
    assert "device=device" in port.read_text()


_ENCODER_FILES = ["bc1_cpu.cpp", "bc6h_cpu.cpp", "bc7_cpu.cpp", "etc2_cpu.cpp", "astc_cpu.cpp",
                  "bc6h_tables.inc", "astc_color_tables.inc"]
_ENCODERS = ["bc7_encode_cpu", "astc4x4_encode_cpu", "etc2_rgb_encode_cpu", "eac_a8_encode_cpu",
             "bc1_encode_cpu", "bc4_encode_cpu", "bc6h_encode_cpu", "eac_r11_encode_cpu",
             "astc_hdr_encode_cpu", "astc_sized_encode_cpu"]


@pytest.mark.parametrize("name", _ENCODER_FILES)
def test_encoder_source_is_the_original(name):
    rel = Path("native") / "src" / name
    port = (_ROOT / "cuttlefish_tpu_torch" / rel).read_bytes()
    assert port == (_ROOT / "cuttlefish_tpu" / rel).read_bytes()


class _NormaliseEncoder(_Normalise):
    """``_Normalise``, and read the port's encoder library (its build
    helper, handle, error and message) as the JAX package's one library."""

    _NAMES = {"_build_and_load_encoders": "_build_and_load", "_enc_lib": "_lib",
              "_enc_error": "_load_error"}

    def visit_Name(self, node):
        node.id = self._NAMES.get(node.id, node.id)
        return node

    def visit_Constant(self, node):
        if node.value == "native CPU encoders unavailable: ":
            node.value = "native codec unavailable: "
        return node


@pytest.mark.parametrize("name", _ENCODERS)
def test_encoder_wrapper_is_the_original(name):
    def function(pkg):
        tree = ast.parse((_ROOT / pkg / "native" / "__init__.py").read_text())
        (fn,) = [n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == name]
        return ast.dump(_NormaliseEncoder().visit(fn))

    assert function("cuttlefish_tpu_torch") == function("cuttlefish_tpu")


@pytest.mark.parametrize(
    "name",
    ["ColorSpace", "Dimension", "TextureFormat", "TextureType", "CubeFace", "Alpha",
     "MipReplacement", "Quality", "FileType", "SaveResult"],
)
def test_format_enums_match(name):
    a, b = getattr(jf, name), getattr(pf, name)
    assert [(m.name, m.value) for m in a] == [(m.name, m.value) for m in b]


def test_image_enums_match():
    for name in ("ImageFormat", "Channel"):
        a, b = getattr(jif, name), getattr(pif, name)
        assert [(m.name, m.value) for m in a] == [(m.name, m.value) for m in b]
    for name in ("ResizeFilter", "RotateAngle", "NormalOptions"):
        a, b = getattr(ct, name), getattr(cp, name)
        assert [(m.name, m.value) for m in a] == [(m.name, m.value) for m in b]


def test_png_from_the_port_loads_alike(tmp_path):
    from cuttlefish_tpu_torch import native

    assert native.available(), native.load_error()
    rgba = np.random.default_rng(2).integers(0, 256, (13, 17, 4), np.uint8)
    path = tmp_path / "t.png"
    path.write_bytes(native.png_encode(rgba))
    a, b = ct.Image(), cp.Image()
    assert a.load(str(path)) and b.load(str(path))
    assert a.format.name == b.format.name == "RGBA8"
    assert np.array_equal(a.array, b.array)
    assert np.array_equal(b.array, rgba)


@pytest.mark.parametrize("ftype", ["DDS", "KTX", "KTX2", "PVR"])
def test_uncompressed_container_bytes_match(ftype):
    arr = np.random.default_rng(4).random((12, 20, 4)).astype(np.float32)
    out = []
    for mod, kw in ((cp, {"device": "cpu"}), (ct, {})):
        tex = mod.Texture(mod.Dimension.Dim2D, 20, 12, mip_levels=9, **kw)
        assert tex.set_image(mod.Image.from_array(arr, mod.ImageFormat.RGBAF))
        assert tex.generate_mipmaps()
        assert tex.convert(mod.TextureFormat.R8G8B8A8, mod.TextureType.UNorm)
        result, data = tex.save_to_bytes(getattr(mod.FileType, ftype))
        assert result.name == "Success"
        out.append(data)
    assert out[0] == out[1]

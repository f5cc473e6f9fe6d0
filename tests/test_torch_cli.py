"""The port's CLI (``cuttlefish_tpu_torch.cli``) against the JAX package's.

Every case runs through the port's ``run(argv, device="cpu")`` and must
give the expected exit code: the reference's 97 ctest rows (``CASES`` of
``tests/test_cli_reference_parity.py``, read with ``ast`` so they are not
transcribed twice, on the same fixtures), and the scenarios of
``tests/test_cli.py`` that no ctest row covers.  Outputs go to a temporary
file instead of the null device.  A case that exits 0 with an
uncompressed format also runs through the JAX CLI: both files must be
byte-identical and both standard outputs equal.  A case that exits 0 with
a block format must load back through the port's ``load_texture`` with
the format, type and size its argv names.  Then ``-h``, ``--texture-info``
on port-written DDS, KTX and PVR files, and ``python -m
cuttlefish_tpu_torch -h`` in a fresh interpreter.
"""

import ast
import os
import shlex
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import cuttlefish_tpu_torch as cp
from cuttlefish_tpu import cli as jcli
from cuttlefish_tpu_torch import cli as pcli

_ROOT = Path(__file__).resolve().parent.parent


def _ctest_cases():
    tree = ast.parse((_ROOT / "tests" / "test_cli_reference_parity.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
            isinstance(t, ast.Name) and t.id == "CASES" for t in node.targets
        ):
            return ast.literal_eval(node.value)
    raise LookupError("CASES not found")


CTEST = _ctest_cases()

# The scenarios of tests/test_cli.py that no ctest row covers, on the
# fixtures below; @out@ is the case's output directory.
_CUBE = "-c +x f0.png -c -x f1.png -c +y f2.png -c -y f3.png -c +z f4.png -c -z f5.png"
_SYMBOLIC = ("nearestpo2", "width", "height", "min", "max", "min-nearestpo2", "max-nextpo2",
             "width-nearestpo2", "height-nextpo2")
EXTRA = [
    ("DeduceDdsFromExtension", 0, "-i t16.png -f R8G8B8A8 -o @out@/out.dds"),
    ("UnknownFlag", 1, "-i t16.png -f R8 -o @out@/out.dds --bogus"),
    ("Quiet", 0, "-q -i t16.png -f R8 -o @out@/out.dds"),
    ("Verbose", 0, "-v -i t16.png -f R8 -o @out@/out.dds"),
    ("InvalidTypeForFormat", 1, "-i t16.png -f BC1_RGB -t snorm -o @out@/out.dds"),
    ("CreateDir", 0, "-i t16.png -f R8 -o @out@/sub/dir/out.dds --create-dir"),
    ("FileFormatOverride", 0, "-i t16.png -f R8G8B8A8 -o @out@/weird.bin --file-format ktx"),
    ("UndeducibleFileType", 1, "-i t16.png -f R8 -o @out@/o.bin"),
    ("BC1Mipmaps", 0, "-i t16.png -f BC1_RGB -m -o @out@/out.dds"),
    ("BC7Lowest", 0, "-i t16.png -f BC7 -Q lowest -o @out@/out.dds"),
    ("QualityKeywordCase", 0, "-i t16.png -f BC1_RGB -Q LOWEST -o @out@/out.dds"),
    ("ETC2Ktx", 0, "-i t16.png -f ETC2_R8G8B8 -Q lowest -o @out@/o.ktx"),
    ("ASTCsRGBKtx", 0, "-i t16.png -f ASTC_4x4 --srgb -Q lowest -o @out@/o.ktx"),
    ("R5G6B5sRGBFallsBackLinear", 0, "-i t16.png -f R5G6B5 --srgb -o @out@/out.dds"),
    ("ResizeFixed", 0, "-i t16.png -r 8 8 -f R8 -o @out@/out.dds"),
    ("ResizeSymbolicCase", 0, "-i t20x12.png -r nextpo2 NEXTPO2 -f R8 -o @out@/out.dds"),
    ("ResizeBSpline", 0, "-i t16.png -r 8 8 b-spline -f R8 -o @out@/out.dds"),
    ("ResizeZero", 1, "-i t16.png -r 0 8 -f R8 -o @out@/out.dds"),
    ("Rotate270", 0, "-i t16.png --rotate 270 -f R8 -o @out@/out.dds"),
    ("RotateInvalid", 1, "-i t16.png --rotate 45 -f R8 -o @out@/out.dds"),
    ("FlipsSwizzleGrayscale", 0, "-i t16.png --flipx --flipy -g -s rrrx -f R8 -o @out@/out.dds"),
    ("SwizzleInvalidZ", 1, "-i t16.png -s rgbz -f R8 -o @out@/out.dds"),
    ("NormalmapGrayWrapHeight", 0, "-i gray16.png -n wrap 2.0 -f R8G8B8A8 -o @out@/out.dds"),
    ("PreMultiply", 0, "-i t16.png --pre-multiply -f R8G8B8A8 -o @out@/out.dds"),
    ("ArrayIndexed", 0, "-a 0 a0.png -a 1 a1.png -a 2 a2.png -f R8G8B8A8 -o @out@/o.ktx"),
    ("CubeBC1", 0, f"{_CUBE} -f BC1_RGB -Q lowest -o @out@/o.ktx"),
    ("CubeFaceKeywordCase", 0, "-c +X t16.png -c -X t16.png -c +Y t16.png -c -Y t16.png "
     "-c +Z t16.png -c -Z t16.png -f R8 -o @out@/o.ktx"),
    ("CubeOneFace", 1, "-c +x t16.png -f R8 -o @out@/o.ktx"),
    ("MixedInputs", 1, "-i t16.png -a 1 t16.png -f R8 -o @out@/o.dds"),
    ("ThreeD", 0, "-a 0 a0.png -a 1 a1.png -a 2 a2.png -a 3 a3.png -d 3 -f R8G8B8A8 "
     "-o @out@/o.ktx"),
    ("InputListArray", 0, "-I array list2.txt -f R8 -o @out@/o.ktx"),
    ("CustomMipOnce", 0, "-i t16.png -m -M 1 once m8.png -f R8G8B8A8 -o @out@/o.dds"),
    ("CustomMipOnceWithoutMipmap", 1, "-i t16.png -M 1 once m8.png -f R8 -o @out@/o.dds"),
    ("CustomMipLevel0", 1, "-i t16.png -m -M 0 once t16.png -f R8 -o @out@/o.dds"),
    ("UnicodeDds", 0, "-i 地.png -f R8G8B8A8 -o @out@/地.dds"),
    ("CustomMipListOnceContinue", 0,
     "-i t16.png -m --custom-mip-list mips.txt -f R8G8B8A8 -o @out@/o.dds"),
    ("CustomMipDefaultContinue", 0, "-i black8.png -f R8G8B8A8 -m -M 1 white4.png -o @out@/o.ktx"),
    ("AlphaInvalid", 1, "-i t16.png --alpha weird -f R8 -o @out@/o.dds"),
    ("DimensionInvalid", 1, "-i t16.png -d 4 -f R8 -o @out@/o.dds"),
    ("SwizzleNullChannel", 0, "-i t16.png -s rgbx -f R8G8B8A8 -o @out@/o.dds"),
    ("Jobs4", 0, "-j 4 -i t16.png -f R8 -o @out@/o.dds"),
    ("JobsBare", 0, "-j -i t16.png -f R8 -o @out@/o.dds"),
    *[(f"ResizeSymbolic-{s}", 0, f"-i t20x12.png -r {s} {s} -f R8 -o @out@/o.dds")
      for s in _SYMBOLIC],
    ("MipmapLevelsBox", 0, "-i t16.png -m 2 box -f R8G8B8A8 -o @out@/o.dds"),
    ("BC1APunchThrough", 0, "-i hard.png -f BC1_RGBA -Q lowest -o @out@/o.dds"),
    # The fused path on the device; an uncompressed format falls through to
    # host mips, as in the JAX CLI.
    ("DeviceMipsBC3", 0, "-i t16.png -f BC3 -m --device-mips -o @out@/o.ktx"),
    ("DeviceMipsUncompressed", 0, "-i t16.png -f R8G8B8A8 -m --device-mips -o @out@/o.ktx"),
    ("Ktx2Zlib", 0, "-i t16.png -f R8G8B8A8 -m -o @out@/o.ktx2 --supercompression zlib"),
    ("TextureInfoMissing", 2, "--texture-info missing.dds"),
]

CASES = CTEST + EXTRA


def _png(path, w, h, seed, gray=False):
    import PIL.Image

    rng = np.random.default_rng(seed)
    if gray:
        PIL.Image.fromarray((rng.random((h, w)) * 255).astype(np.uint8), "L").save(path)
    else:
        PIL.Image.fromarray((rng.random((h, w, 4)) * 255).astype(np.uint8), "RGBA").save(path)


@pytest.fixture(scope="module")
def fixture_dir(tmp_path_factory):
    """The fixtures of tests/test_cli_reference_parity.py (4x4 PNGs, 4x2
    array slices, the five list files), and those of tests/test_cli.py."""
    import PIL.Image

    d = tmp_path_factory.mktemp("torchclifix")
    _png(d / "texture.png", 4, 4, 0)
    _png(d / "地.png", 4, 4, 1)
    for i in range(3):
        _png(d / f"array {i}.png", 4, 2, 10 + i)
    for i, face in enumerate(["posx", "negx", "posy", "negy", "posz", "negz"]):
        _png(d / f"{face}.png", 4, 4, 20 + i)
    (d / "image.txt").write_text("texture.png\n")
    (d / "array.txt").write_text("array 0.png\narray 1.png\narray 2.png\n")
    cube = "negx.png\nposx.png\nnegy.png\nposy.png\nnegz.png\nposz.png\n"
    (d / "cube.txt").write_text(cube)
    (d / "cube-array.txt").write_text(cube * 2)
    (d / "custom-mip.txt").write_text("1 array 0.png\n2 0 +x once array 1.png\n")

    _png(d / "t16.png", 16, 16, 0)
    _png(d / "gray16.png", 16, 16, 0, gray=True)
    _png(d / "t20x12.png", 20, 12, 0)
    _png(d / "m8.png", 8, 8, 5)
    _png(d / "m4.png", 4, 4, 6)
    for i in range(4):
        _png(d / f"a{i}.png", 16, 16, i)
    for i in range(6):
        _png(d / f"f{i}.png", 16, 16, i)
    hard = (np.random.default_rng(7).random((16, 16, 4)) * 255).astype(np.uint8)
    hard[..., 3] = np.where(hard[..., 3] > 128, 255, 0)
    PIL.Image.fromarray(hard, "RGBA").save(d / "hard.png")
    PIL.Image.fromarray(np.zeros((8, 8, 4), np.uint8)).save(d / "black8.png")
    PIL.Image.fromarray(np.full((4, 4, 4), 255, np.uint8)).save(d / "white4.png")
    (d / "list2.txt").write_text("a0.png\na1.png\n")
    (d / "mips.txt").write_text("1 once m8.png\n2 continue m4.png\n")
    return d


def _argv(args: str, out: Path) -> list[str]:
    """argv of a case, the null device and @out@ pointing into ``out``."""
    return [
        a.replace("@null@", str(out / "null.out")).replace("@out@", str(out))
        for a in shlex.split(args)
    ]


def _run(cli, argv, capsys, **kw):
    rc = cli.run(argv, **kw)
    return rc, capsys.readouterr().out


@pytest.mark.parametrize("name,expected,args", CASES, ids=[c[0] for c in CASES])
def test_case(name, expected, args, fixture_dir, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(fixture_dir)
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    port_dir.mkdir()
    jax_dir.mkdir()
    argv = _argv(args, port_dir)
    rc, port_stdout = _run(pcli, argv, capsys, device="cpu")
    assert rc == expected
    if rc != 0:
        return
    parsed = pcli.parse(argv)
    capsys.readouterr()
    out = Path(parsed.output)
    assert out.is_file()
    if cp.block_width(parsed.fmt) == 1:
        jargv = _argv(args, jax_dir)
        jrc, jax_stdout = _run(jcli, jargv, capsys)
        assert jrc == 0
        jout = Path(jcli.parse(jargv).output)
        capsys.readouterr()
        assert out.read_bytes() == jout.read_bytes()
        assert port_stdout.replace(str(port_dir), "@out@") == jax_stdout.replace(
            str(jax_dir), "@out@")
        return
    loaded = cp.load_texture(str(out))
    # DDS has one BC1 code: BC1_RGBA reads back as BC1_RGB.
    dds_bc1 = parsed.fmt is cp.TextureFormat.BC1_RGBA and parsed.file_type is cp.FileType.DDS
    fmt = cp.TextureFormat.BC1_RGB if dds_bc1 else parsed.fmt
    assert loaded.format is fmt and loaded.type is parsed.type
    img = cp.Image(parsed.images[0])
    width = pcli._get_dimension(img.width, img.width, img.height, parsed.width)
    height = pcli._get_dimension(img.height, img.width, img.height, parsed.height)
    assert (loaded.width(), loaded.height()) == (width, height)
    assert loaded.faces == (6 if parsed.dimension is cp.Dimension.Cube else 1)
    full = cp.max_mipmap_levels(loaded.dimension, width, height, loaded.depth())
    levels = {0: 1, -1: full}.get(parsed.mip_levels, min(parsed.mip_levels, full))
    assert loaded.mip_levels == levels
    dec = loaded.decode_image().rgbaf()
    assert dec.shape == (height, width, 4) and np.isfinite(dec).all()


def _help_entries(text: str) -> dict[str, str]:
    """HELP's option entries: option spec -> the entry's text."""
    entries, key = {}, None
    for line in text.splitlines():
        body = line.lstrip()
        if body.startswith("-") and len(line) - len(body) in (2, 6):
            key = body.split()[0]
            entries[key] = line
        elif key is not None and line.startswith("   "):
            entries[key] += "\n" + line
        else:
            key = None
            entries[f"line {len(entries)}"] = line
    return entries


def test_help_is_the_reference_help(capsys):
    prc, pout = _run(pcli, ["-h"], capsys, device="cpu")
    jrc, jout = _run(jcli, ["-h"], capsys)
    assert prc == jrc == 1
    assert pout == pcli.HELP + "\n"
    p, j = _help_entries(pout), _help_entries(jout)
    assert list(p) == list(j)
    # Only the two entries that named the TPU say what the port does.
    changed = {k for k in p if p[k] != j[k]}
    assert changed == {"-j,", "--device-mips"}
    assert "TPU" not in pout


@pytest.mark.parametrize(
    "args,name",
    [
        ("-i texture.png -f BC7 -m -Q lowest", "bc7.dds"),
        (f"{_CUBE} -f BC1_RGB -m -Q lowest", "cube.ktx"),
        ('-a "array 0.png" -a "array 1.png" -a "array 2.png" -f ASTC_4x4 -Q lowest', "arr.pvr"),
    ],
)
def test_texture_info_matches(args, name, fixture_dir, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(fixture_dir)
    out = str(tmp_path / name)
    assert pcli.run(shlex.split(args) + ["-o", out], device="cpu") == 0
    capsys.readouterr()
    prc, pout = _run(pcli, ["--texture-info", out], capsys, device="cpu")
    jrc, jout = _run(jcli, ["--texture-info", out], capsys)
    assert prc == jrc == 0
    assert pout == jout and f"file:       {out}" in pout


@pytest.fixture(scope="module", autouse=True)
def python_m_help(tmp_path_factory):
    """``python -m cuttlefish_tpu_torch -h``, started before this file's
    first case so that it runs beside them -> a function that waits for
    it and returns (return code, stdout, stderr)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(_ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]
    )
    log = tmp_path_factory.mktemp("python_m_help")
    with open(log / "out", "w") as out, open(log / "err", "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "cuttlefish_tpu_torch", "-h"],
            cwd=_ROOT, env=env, stdout=out, stderr=err, text=True,
        )

    def result():
        proc.wait(timeout=120)
        return proc.returncode, (log / "out").read_text(), (log / "err").read_text()

    try:
        yield result
    finally:
        proc.kill()
        proc.wait()


def test_python_m_prints_the_help(python_m_help):
    rc, stdout, stderr = python_m_help()
    assert rc == 1, stderr
    assert stdout == pcli.HELP + "\n"

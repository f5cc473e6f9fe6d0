"""The ETC/EAC slice as a whole: the port's ``Texture`` on the CPU against
``cuttlefish_tpu.Texture``, 40x24 + mips -> KTX, held to equal file bytes:
ETC2_R8G8B8 and ETC1 at quality 1, EAC_R11G11 SNorm at quality 2
(``tests/test_torch_etc_slice_q2.py``: ETC2_R8G8B8 at quality 2).

On the CPU the JAX package encodes with its ``jnp`` path, which the test
holds equal to the TPU kernel body (called eagerly on the same wire
blocks).  The reference runs in a child interpreter with XLA's algebraic
simplifier and FMA contraction off, as ``tests/test_torch_s3tc.py`` runs
it: with XLA's default CPU rewrites the ``jnp`` path flips u8-wire ties on
2 of ETC1's 85 blocks at quality 1; with both off every block is equal.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from test_torch_etc import eager_rgb, to_bytes
from test_torch_etc_eac import _eager

import cuttlefish_tpu as ct
import cuttlefish_tpu_torch as cp
from cuttlefish_tpu_torch.convert.blocks import extract_blocks
from cuttlefish_tpu_torch.convert.device import wire_u8

_ROOT = Path(__file__).resolve().parent.parent
_H, _W = 24, 40
_REF_XLA_FLAGS = "--xla_disable_hlo_passes=algsimp --xla_cpu_max_isa=AVX"

# (format, type, quality, signed source)
_SLICE = [
    ("ETC2_R8G8B8", "UNorm", 1, False),
    ("ETC1", "UNorm", 1, False),
    ("EAC_R11G11", "SNorm", 2, True),
]

_REFERENCE = r"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
import cuttlefish_tpu as ct

inp = np.load(sys.argv[1])
out = {}
for case in sys.argv[3:]:
    fmt, typ, q, src = case.split(":")
    arr = inp[src]
    tex = ct.Texture(ct.Dimension.Dim2D, arr.shape[1], arr.shape[0], mip_levels=99)
    assert tex.set_image(ct.Image.from_array(arr, ct.ImageFormat.RGBAF))
    assert tex.generate_mipmaps()
    assert tex.convert(getattr(ct.TextureFormat, fmt), getattr(ct.TextureType, typ), ct.Quality(int(q)))
    res, data = tex.save_to_bytes(ct.FileType.KTX)
    assert res is ct.SaveResult.Success
    out[case] = np.frombuffer(data, np.uint8)
np.savez(sys.argv[2], **out)
"""


def source(signed):
    rng = np.random.default_rng(11)
    y, x = np.mgrid[0:_H, 0:_W].astype(np.float32)
    arr = np.stack(
        [np.sin(x / 7.0), np.cos(y / 5.0), np.sin((x + y) / 9.0), np.cos(x / 11.0)], axis=-1
    ) * 0.4 + 0.5
    arr = np.clip(arr + rng.normal(0, 0.05, arr.shape), 0, 1).astype(np.float32)
    return arr * 2 - 1 if signed else arr


def case_key(case):
    fmt, typ, q, signed = case
    return f"{fmt}:{typ}:{q}:{'signed' if signed else 'unsigned'}"


def reference_files(cases, tmp):
    """The JAX package's KTX bytes of each case, from a child interpreter."""
    np.savez(tmp / "in.npz", unsigned=source(False), signed=source(True))
    env = dict(os.environ)
    env.update(XLA_FLAGS=_REF_XLA_FLAGS, JAX_PLATFORMS="cpu")
    env.pop("CUTTLEFISH_PALLAS", None)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(_ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]
    )
    proc = subprocess.run(
        [sys.executable, "-c", _REFERENCE, str(tmp / "in.npz"), str(tmp / "out.npz"),
         *map(case_key, cases)],
        cwd=_ROOT, env=env, capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    with np.load(tmp / "out.npz") as out:
        return {k: out[k].tobytes() for k in out.files}


def port_file(case):
    """(port texture, its KTX bytes, each mip's wire blocks)."""
    fmt, typ, q, signed = case
    tex = cp.Texture(cp.Dimension.Dim2D, _W, _H, mip_levels=99, device="cpu")
    assert tex.set_image(cp.Image.from_array(source(signed), cp.ImageFormat.RGBAF))
    assert tex.generate_mipmaps()
    mips = [extract_blocks(tex.get_image(mip_level=m).rgbaf(), 4, 4)[0] for m in range(tex.mip_levels)]
    if signed:
        mips = [b.astype(np.float16).astype(np.float32) for b in mips]
    else:
        mips = [wire_u8(b).astype(np.float32) * np.float32(1 / 255) for b in mips]
    assert tex.convert(getattr(cp.TextureFormat, fmt), getattr(cp.TextureType, typ), cp.Quality(q))
    res, data = tex.save_to_bytes(cp.FileType.KTX)
    assert res is cp.SaveResult.Success
    return tex, data, mips


def check_equal_files(case, port, ref_bytes):
    tex, data, _ = port
    ref = ct.load_texture(ref_bytes)
    assert ref.mip_levels == tex.mip_levels == 6
    assert ref.format.name == tex.format.name == case[0]
    assert len(data) == len(ref_bytes)
    for m in range(tex.mip_levels):
        assert tex.data(mip_level=m) == ref.data(mip_level=m), m
    assert data == ref_bytes


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    ref = reference_files(_SLICE, tmp_path_factory.mktemp("etc_ref"))
    return {case_key(c): (port_file(c), ref[case_key(c)]) for c in _SLICE}


@pytest.mark.parametrize("case", _SLICE, ids=lambda c: f"{c[0]}-q{c[2]}")
def test_slice_file_matches_reference(case, files):
    """Equal file bytes: the same header and every block of every mip."""
    check_equal_files(case, *files[case_key(case)])


@pytest.mark.parametrize("case", [_SLICE[0], _SLICE[2]], ids=["ETC2_R8G8B8-q1", "EAC_R11G11-q2"])
def test_jnp_path_is_the_tpu_kernel_there(case, files):
    """The reference file's blocks are the TPU kernel body's words on the
    same wire blocks, mip by mip."""
    (tex, _, mips), ref_bytes = files[case_key(case)]
    ref = ct.load_texture(ref_bytes)
    blocks = np.concatenate(mips)  # one eager call for every mip
    if case[0] == "EAC_R11G11":
        words = _eager("rg11s", np.ascontiguousarray(blocks[..., :2]), case[2])
    else:
        words = eager_rgb(blocks, case[2], True)
    start = 0
    for m, mip in enumerate(mips):
        want = to_bytes(words[start : start + mip.shape[0]]).tobytes()
        start += mip.shape[0]
        assert ref.data(mip_level=m) == want, m


@pytest.mark.parametrize("case", _SLICE, ids=lambda c: f"{c[0]}-q{c[2]}")
def test_slice_loads_and_decodes_in_the_port(case, files):
    """The port reads its own file back and decodes it without JAX."""
    (tex, data, _), _ = files[case_key(case)]
    back = cp.load_texture(data)
    assert back.format is tex.format and back.type is tex.type
    assert back.mip_levels == tex.mip_levels
    dec = back.decode_image().rgbaf()
    src = tex.get_image(mip_level=0).rgbaf()
    ch = 2 if case[0] == "EAC_R11G11" else 3
    peak = 2.0 if case[3] else 1.0
    mse = ((dec[..., :ch].astype(np.float64) - src[..., :ch]) ** 2).mean()
    assert 10 * np.log10(peak**2 / mse) > 25.0  # noisy source

"""The ASTC slice as a whole: the port's ``Texture`` on the CPU against
``cuttlefish_tpu.Texture``, a 40x24 texture with alpha + mips ->
ASTC_4x4 at quality 2 -> KTX, held to equal file bytes.

The reference runs the TPU kernel in interpret mode (``CUTTLEFISH_PALLAS=1``)
in a child interpreter with XLA's algebraic simplifier and FMA contraction
off, as ``tests/test_torch_etc_slice.py`` runs its reference.  Both
packages scan the host blocks first (``refine_params``): the texture has
alpha and no near-gray block, so neither runs the CEM 0/4 fits.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from test_torch_etc_slice import _REF_XLA_FLAGS, source

import cuttlefish_tpu as ct
import cuttlefish_tpu_torch as cp

_ROOT = Path(__file__).resolve().parent.parent

_REFERENCE = r"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
import cuttlefish_tpu as ct

arr = np.load(sys.argv[1])
tex = ct.Texture(ct.Dimension.Dim2D, arr.shape[1], arr.shape[0], mip_levels=99)
assert tex.set_image(ct.Image.from_array(arr, ct.ImageFormat.RGBAF))
assert tex.generate_mipmaps()
assert tex.convert(ct.TextureFormat.ASTC_4x4, ct.TextureType.UNorm, ct.Quality.Normal)
res, data = tex.save_to_bytes(ct.FileType.KTX)
assert res is ct.SaveResult.Success
open(sys.argv[2], "wb").write(data)
"""


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("astc_ref")
    arr = source(False)
    np.save(tmp / "in.npy", arr)
    env = dict(os.environ)
    env.update(XLA_FLAGS=_REF_XLA_FLAGS, JAX_PLATFORMS="cpu", CUTTLEFISH_PALLAS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(_ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]
    )
    proc = subprocess.run(
        [sys.executable, "-c", _REFERENCE, str(tmp / "in.npy"), str(tmp / "out.ktx")],
        cwd=_ROOT, env=env, capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    tex = cp.Texture(cp.Dimension.Dim2D, arr.shape[1], arr.shape[0], mip_levels=99, device="cpu")
    assert tex.set_image(cp.Image.from_array(arr, cp.ImageFormat.RGBAF))
    assert tex.generate_mipmaps()
    assert tex.convert(cp.TextureFormat.ASTC_4x4, cp.TextureType.UNorm, cp.Quality.Normal)
    res, data = tex.save_to_bytes(cp.FileType.KTX)
    assert res is cp.SaveResult.Success
    return arr, tex, data, (tmp / "out.ktx").read_bytes()


def test_slice_file_matches_reference(files):
    """Equal file bytes: the same header and every block of every mip."""
    _, tex, data, ref_bytes = files
    ref = ct.load_texture(ref_bytes)
    assert ref.mip_levels == tex.mip_levels == 6
    assert ref.format.name == tex.format.name == "ASTC_4x4"
    for m in range(tex.mip_levels):
        assert tex.data(mip_level=m) == ref.data(mip_level=m), m
    assert data == ref_bytes


def test_slice_loads_and_decodes_in_the_port(files):
    """The port reads its own file back and decodes it without JAX."""
    arr, tex, data, _ = files
    back = cp.load_texture(data)
    assert back.format is cp.TextureFormat.ASTC_4x4 and back.type is cp.TextureType.UNorm
    assert back.mip_levels == tex.mip_levels
    dec = back.decode_image().rgbaf()
    assert dec.shape == arr.shape
    mse = ((dec.astype(np.float64) - arr) ** 2).mean()
    assert 10 * np.log10(1.0 / mse) > 25.0  # noisy source

"""The port imports neither jax nor triton on its main path.

The test conftest imports jax, so the check runs in a fresh interpreter.
"""

import os
import subprocess
import sys
from pathlib import Path

_ROOT = Path(__file__).resolve().parent.parent

_SCRIPT = r"""
import os, sys, tempfile
import numpy as np
import cuttlefish_tpu_torch as cp
from cuttlefish_tpu_torch.decode import decode_bc7

arr = np.random.default_rng(0).random((12, 20, 4)).astype(np.float32)
tex = cp.Texture(cp.Dimension.Dim2D, 20, 12, mip_levels=9, device="cpu")
tex.set_image(cp.Image.from_array(arr, cp.ImageFormat.RGBAF))
tex.generate_mipmaps()
assert tex.convert(cp.TextureFormat.BC7, cp.TextureType.UNorm, cp.Quality.Normal)
path = os.path.join(tempfile.mkdtemp(), "t.dds")
assert tex.save(path) is cp.SaveResult.Success
loaded = cp.load_texture(path)
assert loaded.data() == tex.data()
assert decode_bc7(np.frombuffer(tex.data(), np.uint8)).shape == (15, 16, 4)
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "triton"))
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

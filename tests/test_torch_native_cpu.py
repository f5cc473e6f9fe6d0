"""The port's native CPU encoders (``cuttlefish_tpu_torch/native``) against
the JAX package's (``cuttlefish_tpu/native``).

- Each of the ten ``*_encode_cpu`` writes the same bytes as the JAX
  package's on seeded blocks, at quality 2 and with every flag it has
  (``etc2``, ``channel``, ``alpha_ldr``, the sized block sizes), one
  thread each; and ``threads=0`` (every core) writes the words of
  ``threads=1``.
- The encoder library is built at the first encoder call and not before
  (an image codec call leaves it unbuilt), into the build directory as
  ``libcpuenc_<digest>.so`` with a digest over every ``.cpp`` and
  ``.inc`` it compiles, with the JAX package's ``g++`` flags.
- A failed build raises ``RuntimeError`` at the encoder's call, carrying
  the compiler's error.

The sources themselves are held byte for byte and the wrappers' code
statement for statement by ``tests/test_torch_host_copies.py``.
"""

import ast
import functools
import hashlib
import importlib.util
import os
import subprocess
from pathlib import Path

import numpy as np
import pytest

from cuttlefish_tpu import native as jn
from cuttlefish_tpu_torch import native as pn
from cuttlefish_tpu_torch.kernels._build import build_dir

_ROOT = Path(__file__).resolve().parent.parent


def _blocks(texels=16, scale=1.0, seed=0, n=256):
    """n blocks: four of the encoders' 64-block chunks unless fewer asked."""
    rng = np.random.default_rng(seed)
    return (rng.random((n, texels, 4)) * scale).astype(np.float32)


def _hdr(seed):
    b = _blocks(seed=seed)
    b[..., :3] *= 8.0
    b[..., 3] = 0.2 + 0.7 * b[..., 3]
    return b


# name -> (encoder name, input, keyword arguments)
_CASES = {
    "bc7": ("bc7_encode_cpu", _blocks(seed=1), {"quality": 2}),
    "astc4x4": ("astc4x4_encode_cpu", _blocks(seed=2), {"quality": 2}),
    "etc2_rgb": ("etc2_rgb_encode_cpu", _blocks(seed=3), {"quality": 2, "etc2": True}),
    "etc1_rgb": ("etc2_rgb_encode_cpu", _blocks(seed=3), {"quality": 2, "etc2": False}),
    "eac_a8": ("eac_a8_encode_cpu", _blocks(seed=4), {"quality": 2}),
    "bc1": ("bc1_encode_cpu", _blocks(seed=5), {"quality": 2}),
    "bc4_red": ("bc4_encode_cpu", _blocks(seed=6), {"quality": 2, "channel": 0}),
    "bc4_alpha": ("bc4_encode_cpu", _blocks(seed=6), {"quality": 2, "channel": 3}),
    "bc6h": ("bc6h_encode_cpu", _blocks(seed=7, scale=8.0)[..., :3], {"quality": 2}),
    "eac_r11": ("eac_r11_encode_cpu", _blocks(seed=8)[..., 0], {"quality": 2}),
    "astc_hdr": ("astc_hdr_encode_cpu", _hdr(9), {"quality": 2}),
    "astc_hdr_alpha_hdr": ("astc_hdr_encode_cpu", _hdr(9), {"quality": 2, "alpha_ldr": False}),
    "astc6x6": ("astc_sized_encode_cpu", _blocks(36, seed=10),
                {"block_w": 6, "block_h": 6, "quality": 2}),
    "astc12x12": ("astc_sized_encode_cpu", _blocks(144, seed=11, n=128),
                  {"block_w": 12, "block_h": 12, "quality": 2}),
}


@functools.lru_cache(maxsize=None)
def _one_thread(name):
    fn, x, kw = _CASES[name]
    return getattr(pn, fn)(x, threads=1, **kw)


@pytest.mark.parametrize("name", list(_CASES))
def test_words_equal_the_jax_package(name):
    fn, x, kw = _CASES[name]
    port = _one_thread(name)
    ref = getattr(jn, fn)(x, threads=1, **kw)
    assert port.dtype == ref.dtype and port.shape == ref.shape
    assert np.array_equal(port, ref)
    assert port.any()


@pytest.mark.parametrize("name", list(_CASES))
def test_every_core_writes_the_words_of_one(name):
    fn, x, kw = _CASES[name]
    assert np.array_equal(getattr(pn, fn)(x, threads=0, **kw), _one_thread(name))


def test_flags_are_the_jax_package():
    """The g++ command of the JAX package's build, its list literal read
    with ast: the same flags before and after the sources."""
    tree = ast.parse((_ROOT / "cuttlefish_tpu" / "native" / "__init__.py").read_text())
    (cmd,) = [n.args[0] for n in ast.walk(tree)
              if isinstance(n, ast.Call) and getattr(n.func, "attr", "") == "run"]
    elts = cmd.elts
    star = next(i for i, e in enumerate(elts) if isinstance(e, ast.Starred))
    before = [e.value for e in elts[:star]]
    after = [e.value for e in elts[star + 1:] if isinstance(e, ast.Constant)]
    assert pn._GXX == before
    assert pn._GXX_LIBS + ["-o"] == after


def test_built_at_the_first_encoder_call():
    """A fresh copy of the module (its own library handles): an image
    codec call leaves the encoders unbuilt; the first encoder call loads
    ``libcpuenc_<digest>.so`` from the build directory."""
    spec = importlib.util.spec_from_file_location(
        "fresh_native", _ROOT / "cuttlefish_tpu_torch" / "native" / "__init__.py")
    fresh = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fresh)
    fresh.png_encode(np.zeros((4, 4, 3), np.uint8))
    assert fresh._enc_lib is None and fresh._enc_error is None, "built before an encoder call"
    assert fresh.eac_r11_encode_cpu(np.full((3, 16), 0.5, np.float32), threads=1).any()
    assert fresh._enc_lib is not None, fresh._enc_error
    src = _ROOT / "cuttlefish_tpu_torch" / "native" / "src"
    h = hashlib.sha256()
    for name in pn._ENCODER_SOURCES + pn._ENCODER_TABLES:
        h.update((src / name).read_bytes())
    want = os.path.join(str(build_dir()), "native", f"libcpuenc_{h.hexdigest()[:16]}.so")
    assert fresh._enc_lib._name == want
    # Every .cpp and .inc beside the codecs' three is in the digest.
    encoder_files = {p.name for p in src.iterdir() if p.suffix in (".cpp", ".inc")}
    assert encoder_files - set(pn._SOURCES) == set(pn._ENCODER_SOURCES + pn._ENCODER_TABLES)


def test_a_failed_build_raises_at_the_call(tmp_path, monkeypatch):
    monkeypatch.setenv("CUTTLEFISH_TORCH_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(pn, "_GXX", [*pn._GXX, "-fno-such-option-here"])
    monkeypatch.setattr(pn, "_enc_lib", None)
    monkeypatch.setattr(pn, "_enc_error", None)
    with pytest.raises(RuntimeError, match="no-such-option-here"):
        pn.bc1_encode_cpu(_blocks(), threads=1)
    # The error stays: later calls raise it too, with no second build.
    with pytest.raises(RuntimeError, match="no-such-option-here"):
        pn.bc7_encode_cpu(_blocks(), threads=1)
    assert not list((tmp_path / "native").glob("libcpuenc_*.so"))


def test_one_broken_source_raises_its_compiler_error(tmp_path, monkeypatch):
    """One source of two fails to compile while the other still compiles:
    the call raises g++'s error for that source only after every compile
    has ended (none still writes into the build's temporary directory as
    it is removed), and leaves no file behind but the lock."""
    src = tmp_path / "pkg" / "src"
    src.mkdir(parents=True)
    good = (_ROOT / "cuttlefish_tpu_torch" / "native" / "src" / "bc1_cpu.cpp").read_text()
    (src / "bc1_cpu.cpp").write_text(good)
    (src / "broken_cpu.cpp").write_text(good[: len(good) // 2])
    monkeypatch.setenv("CUTTLEFISH_TORCH_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(pn, "_DIR", str(tmp_path / "pkg"))
    monkeypatch.setattr(pn, "_ENCODER_SOURCES", ("broken_cpu.cpp", "bc1_cpu.cpp"))
    monkeypatch.setattr(pn, "_ENCODER_TABLES", ())
    monkeypatch.setattr(pn, "_enc_lib", None)
    monkeypatch.setattr(pn, "_enc_error", None)
    started = []

    def popen(*args, **kwargs):
        started.append(real_popen(*args, **kwargs))
        return started[-1]

    real_popen = subprocess.Popen
    monkeypatch.setattr(subprocess, "Popen", popen)
    with pytest.raises(RuntimeError, match=r"broken_cpu\.cpp:\d+:\d+: error"):
        pn.bc1_encode_cpu(_blocks(), threads=1)
    assert len(started) == 2 and all(p.returncode is not None for p in started)
    assert sorted(p.name for p in (tmp_path / "build" / "native").iterdir()) == ["libcpuenc.lock"]

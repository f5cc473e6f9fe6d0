"""ETC2 punch-through alpha (ETC2_R8G8B8A1) of the port against the JAX
package, which encodes it on its ``jnp`` path only
(``cuttlefish_tpu/kernels/etc.py:encode_etc2_a1``; no TPU kernel): words
bit for bit, the ETC family's bar (``tests/test_pallas.py:248-304``), at
quality 0-2 here and 3-4 in ``tests/test_torch_etc_a1_q34.py``, on opaque
blocks (random and smooth), hard-alpha blocks (every third texel punched,
``tests/test_etc.py:110-120``) and two-cluster chroma blocks with punched
texels, which bias the T and H modes (``tests/test_gl_parity.py:193-205``);
and a ``Texture`` ETC2_R8G8B8A1 + mips -> KTX file equal to the JAX
package's byte for byte.

The reference runs in a child interpreter under the XLA flags of
``tests/test_torch_etc_slice.py`` (XLA's algebraic simplifier and FMA
contraction off), op by op (``jax.disable_jit``): jitted, the encoder
compiles for 112 s at quality 2 and 138 s at quality 3 on a CPU, op by op
its words take 15-18 s.  The child also runs quality 1 jitted, and the
op-by-op words must equal those.
"""

import contextlib
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import cuttlefish_tpu_torch as cp
from cuttlefish_tpu_torch.decode import decode_etc2_a1
from cuttlefish_tpu_torch.kernels import etc

_ROOT = Path(__file__).resolve().parent.parent
_REF_XLA_FLAGS = "--xla_disable_hlo_passes=algsimp --xla_cpu_max_isa=AVX"
_N = 48  # blocks of each kind
_H, _W = 24, 40

_REFERENCE = r"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
import cuttlefish_tpu as ct
from cuttlefish_tpu.kernels import etc

inp = np.load(sys.argv[1])
ones = np.ones(3, np.float32)
out = {}
for task in sys.argv[3:]:
    kind, q = task.split(":")
    q = int(q)
    if kind == "jit":
        out[task] = np.asarray(etc.encode_etc2_a1(inp["blocks"], quality=q, ch_weights=ones))
        continue
    with jax.disable_jit():
        if kind == "words":
            out[task] = np.asarray(etc.encode_etc2_a1(inp["blocks"], quality=q, ch_weights=ones))
            continue
        src = inp["image"]
        tex = ct.Texture(ct.Dimension.Dim2D, src.shape[1], src.shape[0], mip_levels=99)
        assert tex.set_image(ct.Image.from_array(src, ct.ImageFormat.RGBAF))
        assert tex.generate_mipmaps()
        assert tex.convert(ct.TextureFormat.ETC2_R8G8B8A1, ct.TextureType.UNorm, ct.Quality(q))
        res, data = tex.save_to_bytes(ct.FileType.KTX)
        assert res is ct.SaveResult.Success
        out[task] = np.frombuffer(data, np.uint8)
np.savez(sys.argv[2], **out)
"""


def block_sets(n=_N):
    """name -> [n,16,4] float32 blocks, made from a seed."""
    rng = np.random.default_rng(41)
    opaque = rng.random((n, 16, 4), np.float32)
    opaque[..., 3] = 1.0
    # Smooth blocks (planar), some flat.
    ramp = np.linspace(0.0, 1.0, 16, dtype=np.float32)[None, :, None]
    smooth = rng.random((n, 1, 4)).astype(np.float32) * 0.6 + ramp * (
        rng.random((n, 1, 4)).astype(np.float32) * 0.4 - 0.2)
    smooth[: n // 8] = smooth[: n // 8, :1]
    smooth = np.clip(smooth, 0.0, 1.0)
    smooth[..., 3] = 1.0
    hard = rng.random((n, 16, 4), np.float32)
    hard[..., 3] = 1.0
    hard[:, ::3, 3] = 0.0
    c1 = rng.random((n, 1, 3)).astype(np.float32)
    c2 = rng.random((n, 1, 3)).astype(np.float32)
    rgb = np.where(rng.random((n, 16, 1)) > 0.5, c1, c2).astype(np.float32)
    alpha = (rng.random((n, 16, 1)) > 0.25).astype(np.float32)
    th = np.concatenate([rgb, alpha], axis=-1)
    return {"opaque": opaque, "smooth": smooth, "hard": hard, "two_cluster": th}


def image():
    """A 40x24 RGBA source whose 0/1 alpha cuts through blocks."""
    rng = np.random.default_rng(12)
    y, x = np.mgrid[0:_H, 0:_W].astype(np.float32)
    arr = np.stack(
        [np.sin(x / 6.0), np.cos(y / 4.0), np.sin((x + y) / 8.0), np.ones_like(x)], axis=-1
    ) * 0.4 + 0.5
    arr = np.clip(arr + rng.normal(0, 0.04, arr.shape), 0, 1).astype(np.float32)
    arr[..., 3] = (np.sin(x / 2.5) * np.cos(y / 3.5) > -0.3).astype(np.float32)
    return arr


def reference(tasks, tmp):
    """The JAX package's output of each task ("words:q", "jit:q", "ktx:q")."""
    blocks = np.concatenate(list(block_sets().values()))
    np.savez(tmp / "in.npz", blocks=blocks, image=image())
    env = dict(os.environ)
    env.update(XLA_FLAGS=_REF_XLA_FLAGS, JAX_PLATFORMS="cpu")
    env.pop("CUTTLEFISH_PALLAS", None)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(_ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]
    )
    proc = subprocess.run(
        [sys.executable, "-c", _REFERENCE, str(tmp / "in.npz"), str(tmp / "out.npz"), *tasks],
        cwd=_ROOT, env=env, capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    with np.load(tmp / "out.npz") as out:
        return {k: out[k] for k in out.files}


@contextlib.contextmanager
def one_thread():
    """The port's torch ops on one thread: the suite runs workers side by
    side, and elementwise work on [16, N] tensors gains nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def port_words(quality):
    blocks = np.concatenate(list(block_sets().values()))
    with one_thread():
        return etc.encode_etc2_a1(torch.from_numpy(blocks), quality).numpy()


def mode_of(words):
    """Per block: 'punch' (opaque bit 0) or 'opaque', and the mode its
    differential overflows select: diff, T, H or planar."""
    raw = words.astype("<u4").view(np.uint8).reshape(-1, 8)
    out = []
    for row in raw:
        b = int.from_bytes(row.tobytes(), "big")
        op = "opaque" if (b >> 33) & 1 else "punch"
        r, g, bl = ((b >> 59) & 0x1F, (b >> 51) & 0x1F, (b >> 43) & 0x1F)
        dr, dg, db = ((((b >> s) & 0x7) ^ 4) - 4 for s in (56, 48, 40))
        if not 0 <= r + dr <= 31:
            out.append((op, "T"))
        elif not 0 <= g + dg <= 31:
            out.append((op, "H"))
        elif not 0 <= bl + db <= 31:
            out.append((op, "planar"))
        else:
            out.append((op, "diff"))
    return out


def check_words(port, ref, quality):
    assert port.dtype == np.uint32 and port.shape == ref.shape
    names = list(block_sets())
    same = np.all(port == ref, axis=1).reshape(len(names), -1)
    for name, row in zip(names, same):
        assert row.all(), f"q{quality} {name}: blocks {np.where(~row)[0].tolist()} differ"


def check_punched(words):
    """tests/test_etc.py:test_punch_through on the hard-alpha blocks:
    punched texels decode to alpha 0, the others to 255; opaque blocks
    decode opaque."""
    sets = list(block_sets())
    per = len(words) // len(sets)
    dec = decode_etc2_a1(words.astype("<u4").view(np.uint8).reshape(-1))
    hard = dec[sets.index("hard") * per:(sets.index("hard") + 1) * per]
    assert (hard[:, ::3, 3] == 0).all()
    keep = np.ones(16, bool)
    keep[::3] = False
    assert (hard[:, keep, 3] == 255).all()
    for name in ("opaque", "smooth"):
        i = sets.index(name)
        assert (dec[i * per:(i + 1) * per, :, 3] == 255).all()
    src = np.concatenate(list(block_sets().values()))
    assert np.array_equal(dec[..., 3] == 0, src[..., 3] < 0.5)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return reference(
        ["words:0", "words:1", "words:2", "jit:1", "ktx:2"], tmp_path_factory.mktemp("a1_ref")
    )


def test_op_by_op_reference_is_the_jitted_path(ref):
    assert np.array_equal(ref["words:1"], ref["jit:1"])


@pytest.mark.parametrize("quality", [0, 1, 2])
def test_words_equal_jnp_path(quality, ref):
    words = port_words(quality)
    check_words(words, ref[f"words:{quality}"], quality)
    check_punched(words)


def test_searches_reach_every_mode(ref):
    """The q2 blocks exercise what the encoder searches: opaque planar, T
    and H, and punch-through differential, T and H."""
    modes = set(mode_of(ref["words:2"]))
    for want in (("opaque", "planar"), ("opaque", "T"), ("opaque", "H"), ("punch", "diff"),
                 ("punch", "T"), ("punch", "H")):
        assert want in modes, want


def test_texture_file_equals_jax_package(ref):
    """ETC2_R8G8B8A1 + mips -> KTX at quality 2, byte for byte; level 0
    decodes to alpha 0 at the punched texels and 255 elsewhere."""
    src = image()
    tex = cp.Texture(cp.Dimension.Dim2D, _W, _H, mip_levels=99, device="cpu")
    assert tex.set_image(cp.Image.from_array(src, cp.ImageFormat.RGBAF))
    assert tex.generate_mipmaps()
    with one_thread():
        assert tex.convert(cp.TextureFormat.ETC2_R8G8B8A1, cp.TextureType.UNorm, cp.Quality(2))
    assert tex.last_convert_stats["launches"] == {}
    res, data = tex.save_to_bytes(cp.FileType.KTX)
    assert res is cp.SaveResult.Success
    want = ref["ktx:2"].tobytes()
    loaded = cp.load_texture(want)
    assert loaded.format is cp.TextureFormat.ETC2_R8G8B8A1 and loaded.mip_levels == 6
    for m in range(tex.mip_levels):
        assert tex.data(mip_level=m) == loaded.data(mip_level=m), m
    assert data == want
    alpha = tex.decode_image().array[..., 3]
    assert np.array_equal(alpha == 0, src[..., 3] < 0.5)
    assert np.all((alpha == 0) | (alpha == 1))

"""The port's device mesh (``cuttlefish_tpu_torch.parallel``) changes no byte.

Mirrors the JAX package's mesh tests on CPU meshes, where an entry may
repeat (the JAX conftest's 8 fake CPU devices): ``encode_many`` on BC1 and
BC7 under meshes of 1, 2, 4 and 8 entries, on a batch that no mesh of
more than one entry divides (``tests/test_bc.py:TestMeshInvariance``);
``convert_with_mips`` BC3 -> KTX under meshes of 4 and 8
(``tests/test_fused.py:test_mesh_shard_equivalence``); and two processes
joined by ``init_distributed`` over ``gloo``, each encoding its rank's
shard, whose all-gathered DDS equals the single-process one
(``tests/test_multiprocess.py``).

Each meshed output equals the port's unsplit run byte for byte, and is
also held to the JAX package's output on the same input: its TPU kernels
in interpret mode (``CUTTLEFISH_PALLAS=1``) in one child interpreter under
XLA's algebraic simplifier and FMA contraction off, as
``tests/test_torch_fused.py`` runs it, with that file's bar (the same
sizes and >= 99 % identical blocks).  The child starts with the first
test that asks for it and runs beside the port's cases.
"""

import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import cuttlefish_tpu_torch as cp
from cuttlefish_tpu_torch.convert import EncodeParams, create_converter
from cuttlefish_tpu_torch.parallel import Mesh, default_mesh, get_mesh, shard_blocks, use_mesh

_ROOT = Path(__file__).resolve().parent.parent
_REF_XLA_FLAGS = "--xla_disable_hlo_passes=algsimp --xla_cpu_max_isa=AVX"
F, T, Q = cp.TextureFormat, cp.TextureType, cp.Quality


def _surface():
    # 11 x 9 = 99 blocks: no mesh of 2, 4 or 8 entries divides it.
    return np.random.default_rng(9).random((36, 44, 4), np.float32)


def _blend():
    """tests/test_fused.py:_img(64, 48, seed=5)'s array."""
    rng = np.random.default_rng(5)
    c0 = rng.random((1, 1, 4)).astype(np.float32)
    c1 = rng.random((1, 1, 4)).astype(np.float32)
    t = rng.random((48, 64, 1)).astype(np.float32)
    arr = c0 * t + c1 * (1 - t)
    arr[..., 3] = 1.0
    return arr.astype(np.float32)


def _mp_array():
    """tests/test_multiprocess.py's 48x32 source."""
    return np.random.default_rng(7).random((32, 48, 4)).astype(np.float32)


# The JAX package's bytes of the inputs above (saved by the parent as
# .npy), one file each, in the order the tests want them: BC7 Low's
# compile, which the DDS and encode_many share, comes after the cheap ones.
_REFERENCE = r"""
import sys
from pathlib import Path
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
import cuttlefish_tpu as ct
from cuttlefish_tpu.convert import EncodeParams, create_converter

out = Path(sys.argv[1])
F, T, Q = ct.TextureFormat, ct.TextureType, ct.Quality


def save(name, data):
    np.save(out / f"{name}.tmp.npy", np.frombuffer(bytes(data), np.uint8))
    (out / f"{name}.tmp.npy").rename(out / f"{name}.npy")


def encode(fmt):
    conv = create_converter(F[fmt], T.UNorm)
    return conv.encode(np.load(out / "surface.npy"), EncodeParams(quality=Q.Low)).tobytes()


def texture(arr, fmt, fused, file_type):
    h, w = arr.shape[:2]
    tex = ct.Texture(ct.Dimension.Dim2D, w, h)
    assert tex.set_image(ct.Image.from_array(arr, ct.ImageFormat.RGBAF))
    convert = tex.convert_with_mips if fused else tex.convert
    assert convert(F[fmt], T.UNorm, quality=Q.Low)
    res, data = tex.save_to_bytes(file_type)
    assert res is ct.SaveResult.Success
    return data


save("BC1_RGB", encode("BC1_RGB"))
save("fused", texture(np.load(out / "blend.npy"), "BC3", True, ct.FileType.KTX))
save("dds", texture(np.load(out / "mp.npy"), "BC7", False, ct.FileType.DDS))
save("BC7", encode("BC7"))
"""


class _Child:
    """A child interpreter running ``source`` beside the tests; its output
    goes to a file, so no pipe fills while nobody reads it."""

    def __init__(self, source, *args, env=None):
        self.log = tempfile.TemporaryFile()
        self.proc = subprocess.Popen(
            [sys.executable, "-c", source, *map(str, args)],
            cwd=_ROOT, env=env or _env(), stdout=self.log, stderr=subprocess.STDOUT,
        )

    def wait_ok(self, timeout=180):
        self.proc.wait(timeout=timeout)
        self.log.seek(0)
        assert self.proc.returncode == 0, self.log.read().decode(errors="replace")[-4000:]

    def wait_for(self, path, timeout=600):
        """Wait until the child has written ``path`` (it renames each file
        into place when it is whole)."""
        deadline = time.monotonic() + timeout
        while not path.exists():
            if self.proc.poll() is not None or time.monotonic() > deadline:
                self.wait_ok(timeout=1)
                assert path.exists(), path
            time.sleep(0.05)

    def kill(self):
        self.proc.kill()
        self.proc.wait()


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(_ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]
    )
    return env


_WORKER = r"""
import sys
import numpy as np
import cuttlefish_tpu_torch as cp
from cuttlefish_tpu_torch.parallel import get_mesh, init_distributed, use_mesh

pid, port, src, out_path = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
mesh = init_distributed(f"127.0.0.1:{port}", num_processes=2, process_id=pid, device="cpu")
assert mesh.size == 2 and mesh.rank == pid and get_mesh() is mesh, mesh

arr = np.load(src)
tex = cp.Texture(cp.Dimension.Dim2D, 48, 32, device="cpu")
tex.set_image(cp.Image.from_array(arr, cp.ImageFormat.RGBAF))
with use_mesh(mesh):
    assert tex.convert(cp.TextureFormat.BC7, cp.TextureType.UNorm, quality=cp.Quality.Low)
res, data = tex.save_to_bytes(cp.FileType.DDS)
assert res is cp.SaveResult.Success
if pid == 0:
    with open(out_path, "wb") as f:
        f.write(data)
import torch.distributed as dist
dist.destroy_process_group()
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def children(tmp_path_factory):
    """The JAX reference child and the two ``gloo`` workers, started with
    the first test that asks for them.  ``jax(name)`` is the JAX package's
    bytes of ``name``; ``gloo()`` the DDS that process 0 wrote."""
    out = tmp_path_factory.mktemp("mesh_children")
    for name, arr in (("surface", _surface()), ("blend", _blend()), ("mp", _mp_array())):
        np.save(out / f"{name}.npy", arr)
    env = _env()
    env.update(XLA_FLAGS=_REF_XLA_FLAGS, JAX_PLATFORMS="cpu", CUTTLEFISH_PALLAS="1")
    reference = _Child(_REFERENCE, out, env=env)
    port = _free_port()
    workers = [_Child(_WORKER, pid, port, out / "mp.npy", out / "mp.dds") for pid in range(2)]

    class Results:
        @staticmethod
        def jax(name):
            path = out / f"{name}.npy"
            reference.wait_for(path)
            return np.load(path).tobytes()

        @staticmethod
        def gloo():
            for w in workers:
                w.wait_ok()
            return (out / "mp.dds").read_bytes()

    try:
        yield Results
    finally:
        for child in [reference, *workers]:
            child.kill()
            child.log.close()


def _held_to(port: bytes, ref: bytes, block: int):
    """tests/test_torch_fused.py's bar on raw block bytes: the same size
    and >= 99 % identical blocks."""
    a = np.frombuffer(port, np.uint8).reshape(-1, block)
    b = np.frombuffer(ref, np.uint8).reshape(-1, block)
    assert a.shape == b.shape
    assert np.all(a == b, axis=1).mean() >= 0.99


def _texture_held_to(port: bytes, ref: bytes):
    """The same bar on every level of two container files."""
    a, b = cp.load_texture(port), cp.load_texture(ref)
    assert a.format is b.format and a.mip_levels == b.mip_levels
    assert (a.width(), a.height()) == (b.width(), b.height())
    for m in range(a.mip_levels):
        _held_to(a.data(mip_level=m), b.data(mip_level=m), cp.block_size(a.format))


@pytest.mark.parametrize("entries", [4, 8])
def test_fused_pyramid_same_bytes_any_mesh(entries, children):
    def run(mesh):
        tex = cp.Texture(cp.Dimension.Dim2D, 64, 48, device="cpu")
        tex.set_image(cp.Image.from_array(_blend(), cp.ImageFormat.RGBAF))
        with use_mesh(mesh):
            assert tex.convert_with_mips(F.BC3, T.UNorm, quality=Q.Low)
        return tex.save_to_bytes(cp.FileType.KTX)[1]

    sharded = run(["cpu"] * entries)
    assert sharded == run(None)
    _texture_held_to(sharded, children.jax("fused"))


@pytest.fixture(scope="module")
def single():
    """Bytes of each format without a mesh."""
    params = EncodeParams(quality=Q.Low)
    return {
        fmt: create_converter(fmt, T.UNorm, "cpu").encode(_surface(), params)
        for fmt in (F.BC1_RGB, F.BC7)
    }


@pytest.mark.parametrize("entries", [1, 2, 4, 8])
@pytest.mark.parametrize("fmt", [F.BC1_RGB, F.BC7], ids=lambda f: f.name)
def test_encode_many_same_bytes_any_mesh(fmt, entries, single, children):
    conv = create_converter(fmt, T.UNorm, "cpu")
    with use_mesh(["cpu"] * entries) as mesh:
        assert mesh.size == entries and get_mesh() is mesh
        sharded = conv.encode(_surface(), EncodeParams(quality=Q.Low))
    assert get_mesh() is None
    assert np.array_equal(single[fmt], sharded)
    _held_to(sharded.tobytes(), children.jax(fmt.name), cp.block_size(fmt))


def test_two_process_gloo_mesh_writes_identical_dds(children):
    tex = cp.Texture(cp.Dimension.Dim2D, 48, 32, device="cpu")
    tex.set_image(cp.Image.from_array(_mp_array(), cp.ImageFormat.RGBAF))
    assert tex.convert(F.BC7, T.UNorm, quality=Q.Low)
    res, ref = tex.save_to_bytes(cp.FileType.DDS)
    assert res is cp.SaveResult.Success
    dds = children.gloo()
    assert dds == ref
    _texture_held_to(dds, children.jax("dds"))


def test_shards_are_padded_with_the_last_block_in_mesh_order():
    blocks = torch.arange(5 * 3, dtype=torch.float32).reshape(5, 3)
    shards = shard_blocks(blocks, Mesh((torch.device("cpu"),) * 4))
    assert [s.shape[0] for s in shards] == [2, 2, 2, 2]
    joined = torch.cat(shards)
    assert torch.equal(joined[:5], blocks)
    assert torch.equal(joined[5:], blocks[-1:].expand(3, 3))
    # One entry: the whole batch, unpadded.
    (whole,) = shard_blocks(blocks, Mesh((torch.device("cpu"),)))
    assert torch.equal(whole, blocks)


def test_default_mesh_is_the_visible_cards():
    n = torch.cuda.device_count()
    if n == 0:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            default_mesh()
    else:
        assert default_mesh().devices == tuple(torch.device("cuda", i) for i in range(n))
    with pytest.raises(ValueError):
        Mesh(())


@pytest.mark.parametrize(
    "device,mesh",
    [(None, ["cpu"] * 4), ("cuda", ["cuda:0", "cpu"]), ("cpu", ["cuda:0"]), ("cpu", ["cpu", "cuda:0"])],
    ids=["card-under-cpu", "card-under-mixed", "cpu-under-card", "cpu-under-mixed"],
)
def test_a_mesh_of_another_device_type_raises(device, mesh):
    """The converter names the device type; a mesh only splits the work.
    Both entry points raise before any work, card present or not."""
    conv = create_converter(F.BC1_RGB, T.UNorm, device)
    params = EncodeParams(quality=Q.Low)
    with use_mesh(mesh):
        with pytest.raises(ValueError, match="are not"):
            conv.encode(_surface(), params)
        with pytest.raises(ValueError, match="are not"):
            conv.encode_pyramid([_surface()], 3, "catmullrom", False, params)
        tex = cp.Texture(cp.Dimension.Dim2D, 44, 36, device=device)
        tex.set_image(cp.Image.from_array(_surface(), cp.ImageFormat.RGBAF))
        with pytest.raises(ValueError, match="are not"):
            tex.convert(F.BC1_RGB, T.UNorm, quality=Q.Low)
        assert tex.format is F.Unknown

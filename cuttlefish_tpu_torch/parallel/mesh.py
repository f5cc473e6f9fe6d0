"""Mesh management and the block split (counterpart of
``cuttlefish_tpu/parallel/mesh.py``).

A mesh is an ordered list of torch devices.  The block batch (axis 0) is
padded to a multiple of the mesh size with its last
block repeated (``_bucket`` of the JAX package's ``convert/device.py``),
cut into equal contiguous shards in mesh order, and shard i is encoded on
entry i's device.  The words come back in the same order and the padding
is trimmed, so a mesh changes no word.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import threading

import torch

INIT_TIMEOUT = datetime.timedelta(seconds=300)

_state = threading.local()


@dataclasses.dataclass(frozen=True)
class Mesh:
    """An ordered list of devices; shard i of the block batch goes to
    ``devices[i]``.  ``rank`` is ``None`` for a mesh of this process's own
    devices, which encodes every shard.  Under ``init_distributed`` entry r
    is rank r's device and ``rank`` this process's: it encodes its own
    shard only, and the shards are all-gathered."""

    devices: tuple[torch.device, ...]
    rank: int | None = None

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a mesh needs at least one device")

    @property
    def size(self) -> int:
        return len(self.devices)


def _as_mesh(mesh) -> Mesh | None:
    """A ``Mesh``, or one made from an iterable of devices (``torch.device``
    or names such as ``"cuda:0"``); ``None`` stays ``None``."""
    if mesh is None or isinstance(mesh, Mesh):
        return mesh
    return Mesh(tuple(torch.device(d) for d in mesh))


def init_distributed(
    coordinator_address: str, num_processes: int, process_id: int, device=None
) -> Mesh:
    """Join a process group and return (and activate) the mesh of its ranks.

    ``coordinator_address`` is ``host:port`` of rank 0 (a ``tcp://``
    rendezvous; the group gives up after ``INIT_TIMEOUT``).  ``device`` is
    this process's device: ``None`` is the CUDA card of index rank mod the
    visible cards (the ``nccl`` backend); a CPU device takes ``gloo``.  Each
    process then tiles the whole surface, encodes its rank's shard and
    all-gathers the words, so every process holds the whole texture and
    process 0 (or any) can write the container.
    """
    import torch.distributed as dist

    if device is None:
        if torch.cuda.device_count() == 0:
            raise RuntimeError("init_distributed: no CUDA device (pass device='cpu' for gloo)")
        device = torch.device("cuda", process_id % torch.cuda.device_count())
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        "nccl" if device.type == "cuda" else "gloo",
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes,
        rank=process_id,
        timeout=INIT_TIMEOUT,
    )
    names: list = [None] * num_processes
    dist.all_gather_object(names, str(device))
    mesh = Mesh(tuple(torch.device(n) for n in names), rank=process_id)
    set_mesh(mesh)
    return mesh


def default_mesh() -> Mesh:
    """A mesh of every visible CUDA device; raises without one."""
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("default_mesh: no CUDA device")
    return Mesh(tuple(torch.device("cuda", i) for i in range(n)))


def get_mesh() -> Mesh | None:
    return getattr(_state, "mesh", None)


def set_mesh(mesh) -> None:
    _state.mesh = _as_mesh(mesh)


@contextlib.contextmanager
def use_mesh(mesh):
    prev = get_mesh()
    set_mesh(mesh)
    try:
        yield get_mesh()
    finally:
        set_mesh(prev)


def shard_blocks(blocks: torch.Tensor, mesh: Mesh) -> list[torch.Tensor]:
    """Pad a [N, ...] block batch with its last block to a multiple of the
    mesh size and place each contiguous shard on its entry's device, in
    mesh order (under ``init_distributed``, this rank's shard only).  A
    one-entry mesh is the whole batch on its device, with no padding."""
    n = blocks.shape[0]
    per = -(-n // mesh.size)
    if per * mesh.size != n:
        pad = blocks[-1:].expand(per * mesh.size - n, *blocks.shape[1:])
        blocks = torch.cat([blocks, pad])
    entries = range(mesh.size) if mesh.rank is None else (mesh.rank,)
    return [blocks[i * per : (i + 1) * per].to(mesh.devices[i]) for i in entries]


def gather_words(words: list[torch.Tensor], mesh: Mesh) -> torch.Tensor:
    """The words of ``shard_blocks``' shards, concatenated in mesh order on
    the CPU (padding included).  Under ``init_distributed`` the equal-sized
    shards of every rank are all-gathered first (``_fetch_global`` of the
    JAX package's ``convert/device.py``)."""
    if mesh.rank is None:
        return torch.cat([w.cpu() for w in words]) if len(words) > 1 else words[0].cpu()
    import torch.distributed as dist

    (local,) = words
    # all_gather takes no uint32: the words travel as int64.
    local = local.to(torch.int64)
    if dist.get_backend() == "gloo":
        local = local.cpu()
    parts = [torch.empty_like(local) for _ in range(mesh.size)]
    dist.all_gather(parts, local)
    return torch.cat([p.cpu() for p in parts])

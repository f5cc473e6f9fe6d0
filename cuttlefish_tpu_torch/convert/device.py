"""Host <-> device block batching for the port's block converters.

Counterpart of ``cuttlefish_tpu/convert/device.py:BlockConverter``: remap
each surface (``prepare_surface``), tile it with ``extract_blocks``,
concatenate, send the blocks to the device on the converter's wire
(``transfer_dtype``: u8 for 8-bit-domain formats, f16 for signed ones),
widen them to float32 there, encode once, fetch, and interleave the words
into raster-order bytes.  PyTorch runs eagerly, so there is no power-of-two
bucket (an XLA jit-cache device).  The batch goes through the mesh
(``cuttlefish_tpu_torch.parallel``): the active one, else a mesh of the
converter's device alone.  It is padded to a multiple of the mesh size,
split into contiguous shards, each encoded on its entry's device, and the
words gathered in order and trimmed; a one-entry mesh pads and splits
nothing.

The fused mip pipeline (``BlockConverter.encode_pyramid``, the JAX
package's ``_FusedPyramid`` and ``_encode_pyramid``) sends level 0 to the
device once as float32 and builds the whole chain there: the optional
normal map, each level's separable resample (sRGB levels through linear),
and the block tiling, then one encode.  The resample weights are
``image/resample.py:resample_weights``; each output texel sums its
nonzero taps as elementwise products and adds (``_resample``), so no
matrix unit and no TF32 setting can reach them, and the CPU and the card
compute them alike.  On the card one hand-written kernel a level
(``kernels/pyramid_cuda.py``, ``csrc/pyramid.cu``) does the same
arithmetic; on the CPU the torch ops run (``pyramid_blocks_plain``).  Under
a mesh the pyramid is built on the converter's device and its block batch
split after it.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from cuttlefish_tpu_torch import profiling
from cuttlefish_tpu_torch.convert import Converter, EncodeParams
from cuttlefish_tpu_torch.convert.blocks import extract_blocks, interleave_block_bytes
from cuttlefish_tpu_torch.image.resample import resample_weights
from cuttlefish_tpu_torch.parallel import Mesh, gather_words, get_mesh, shard_blocks

# float32(1/255): dequantisation multiplies by it, as the JAX path does, so
# the kernel's later *255 sees the same float32 values.
_INV255 = 1.0 / 255.0


def wire_u8(blocks: np.ndarray) -> np.ndarray:
    """Host-side u8 wire format: round half up after clipping to [0,1]."""
    return (np.clip(blocks, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def dequant_u8(u8: torch.Tensor) -> torch.Tensor:
    """Inverse of ``wire_u8``, on the tensor's device."""
    return u8.to(torch.float32) * _INV255


def wire(blocks: np.ndarray, dtype: str) -> torch.Tensor:
    """Host blocks -> the CPU tensor that travels (``_wire`` of the JAX
    package): u8 as ``wire_u8``, f16 as ``astype(float16)``."""
    if dtype == "u8":
        return torch.from_numpy(wire_u8(blocks))
    if dtype == "f16":
        return torch.from_numpy(blocks.astype(np.float16))
    raise ValueError(f"unknown transfer dtype {dtype!r}")


def dequant(blocks: torch.Tensor) -> torch.Tensor:
    """Inverse of ``wire``, on the tensor's device."""
    if blocks.dtype == torch.uint8:
        return dequant_u8(blocks)
    return blocks.to(torch.float32)


class BlockConverter(Converter):
    """Base for block-compressed formats of the port.

    Subclasses implement ``encode_blocks([N, bh*bw, 4] float32 tensor on
    self.device, params) -> [N, words] uint32 tensor``.  ``device`` ``None``
    is the CUDA card; a CPU device runs the plain PyTorch versions.
    """

    block_w = 4
    block_h = 4
    transfer_dtype = "u8"  # "u8" | "f16"

    def __init__(self, device=None):
        self.device = torch.device("cuda" if device is None else device)

    def encode_blocks(self, blocks: torch.Tensor, params: EncodeParams):
        raise NotImplementedError

    def prepare_surface(self, surface: np.ndarray, params: EncodeParams) -> np.ndarray:
        """Hook for input-domain remaps (as in the JAX package)."""
        return surface

    def refine_params(self, host_blocks: np.ndarray, params: EncodeParams) -> EncodeParams:
        """Hook: inspect the host float blocks of the whole batch and return
        params with content-derived flags filled in (as in the JAX
        package; ASTC sets ``content_gray`` and ``content_alpha``)."""
        return params

    def encode(self, surface: np.ndarray, params: EncodeParams) -> np.ndarray:
        return self.encode_many([surface], params)[0]

    def encode_many(self, surfaces: list, params: EncodeParams) -> list[np.ndarray]:
        """One encode for every surface: blocks of all surfaces are
        concatenated on the batch axis and split back afterwards.

        Each phase is a span (``pipeline.tile``, ``upload``, ``kernel``,
        ``fetch``, ``interleave``; ``profiling``); on a CUDA device upload
        and kernel end in a synchronise, so each phase holds its own
        device time.  Upload places each shard of the mesh (``_mesh``) on
        its device and kernel encodes them all before it synchronises, so
        launches on different cards overlap.
        """
        mesh = self._mesh()
        with profiling.span("pipeline.tile"):
            all_blocks = []
            counts = []
            for surface in surfaces:
                surface = self.prepare_surface(np.asarray(surface, np.float32), params)
                blocks, _, _ = extract_blocks(surface, self.block_w, self.block_h)
                all_blocks.append(blocks)
                counts.append(blocks.shape[0])
            blocks = (
                np.concatenate(all_blocks) if len(all_blocks) > 1 else all_blocks[0]
            )
            params = self.refine_params(blocks, params)
            host = wire(blocks, self.transfer_dtype)
        n = host.shape[0]
        with profiling.span("pipeline.upload"):
            shards = [dequant(x) for x in shard_blocks(host, mesh)]
            _sync_devices(shards)
        with profiling.span("pipeline.kernel"):
            words = [self.encode_blocks(x, params) for x in shards]
            _sync_devices(words)
        with profiling.span("pipeline.fetch"):
            words = gather_words(words, mesh)[:n].numpy().astype(np.uint32)
        with profiling.span("pipeline.interleave"):
            out = []
            start = 0
            for c in counts:
                out.append(interleave_block_bytes(words[start : start + c]))
                start += c
        return out

    def encode_pyramid(
        self,
        surfaces0: list,
        levels: int,
        filter_name: str,
        srgb: bool,
        params: EncodeParams,
        normal_opts: tuple | None = None,
    ) -> list[list[np.ndarray]]:
        """The fused mip pipeline: level-0 [H,W,4] float32 surfaces in
        (depth, face) order -> bytes[level][surface] (mip-major, the order
        of ``Texture.convert``).

        Each phase is a span (``profiling``): ``pipeline.scan`` (the host
        tiling of level 0 for ``refine_params``, only where the converter
        overrides it: the words are the same either way), ``upload``,
        ``pyramid``, ``kernel``, ``fetch`` and ``interleave``; on a CUDA
        device upload, pyramid and kernel end in a synchronise.  The pyramid is built on the converter's device; kernel
        places the shards of the mesh (``_mesh``) on their devices.
        """
        mesh = self._mesh()
        s = len(surfaces0)
        h, w = surfaces0[0].shape[:2]
        surfaces0 = [np.asarray(sf, np.float32) for sf in surfaces0]
        with profiling.span("pipeline.scan"):
            if type(self).refine_params is not BlockConverter.refine_params:
                # Content flags from level 0 only, as the JAX package sets them.
                lvl0 = np.concatenate(
                    [extract_blocks(sf, self.block_w, self.block_h)[0] for sf in surfaces0]
                )
                params = self.refine_params(lvl0, params)
        with profiling.span("pipeline.upload"):
            x = torch.stack([torch.from_numpy(sf).to(self.device) for sf in surfaces0])
            self._sync()
        with profiling.span("pipeline.pyramid"):
            blocks = pyramid_blocks(
                x, levels, filter_name, srgb, self.block_w, self.block_h, normal_opts
            )
            self._sync()
        n = blocks.shape[0]
        with profiling.span("pipeline.kernel"):
            words = [self.encode_blocks(x, params) for x in shard_blocks(blocks, mesh)]
            _sync_devices(words)
        with profiling.span("pipeline.fetch"):
            words = gather_words(words, mesh)[:n].numpy().astype(np.uint32)
        with profiling.span("pipeline.interleave"):
            out: list[list[np.ndarray]] = []
            start = 0
            for hh, ww in mip_dims(h, w, levels):
                per = (-(-hh // self.block_h)) * (-(-ww // self.block_w))
                level_out = []
                for _ in range(s):
                    level_out.append(interleave_block_bytes(words[start : start + per]))
                    start += per
                out.append(level_out)
        return out

    def _mesh(self) -> Mesh:
        """The active mesh, else a mesh of this converter's device alone.

        The converter names the kind of device the work runs on, and a
        mesh only splits it: a mesh entry of another type (a CPU mesh
        under a card converter, or the reverse) raises rather than move
        the work there.
        """
        mesh = get_mesh() or Mesh((self.device,))
        other = sorted({str(d) for d in mesh.devices if d.type != self.device.type})
        if other:
            raise ValueError(
                f"mesh entries {other} are not {self.device.type} devices, as the "
                f"converter's device {self.device} is"
            )
        return mesh

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def _sync_devices(tensors: list[torch.Tensor]) -> None:
    """Wait for every CUDA device that holds one of ``tensors``."""
    for device in {t.device for t in tensors if t.device.type == "cuda"}:
        torch.cuda.synchronize(device)


# float32 reciprocals of the sRGB transforms' divisors: under jit XLA
# computes ``c / 12.92`` and ``/ 1.055`` as products with them.
_INV_12_92 = float(np.float32(1.0) / np.float32(12.92))
_INV_1_055 = float(np.float32(1.0) / np.float32(1.055))


def srgb_to_linear_rgba(rgba: torch.Tensor) -> torch.Tensor:
    """``color.srgb_to_linear_rgba`` on a tensor: piecewise sRGB EOTF on
    RGB, alpha untouched."""
    c = rgba[..., :3]
    rgb = torch.where(
        c <= 0.04045,
        c * _INV_12_92,
        ((torch.clamp(c, min=0.04045) + 0.055) * _INV_1_055) ** 2.4,
    )
    return torch.cat([rgb, rgba[..., 3:]], dim=-1)


def linear_to_srgb_rgba(rgba: torch.Tensor) -> torch.Tensor:
    """``color.linear_to_srgb_rgba`` on a tensor: piecewise sRGB OETF on
    RGB, alpha untouched."""
    c = rgba[..., :3]
    rgb = torch.where(
        c <= 0.0031308,
        c * 12.92,
        1.055 * torch.clamp(c, min=0.0031308) ** (1.0 / 2.4) - 0.055,
    )
    return torch.cat([rgb, rgba[..., 3:]], dim=-1)


def normal_map_device(h: torch.Tensor, options: int, height: float) -> torch.Tensor:
    """[S,H,W] heightfield (red channel, linear) -> [S,H,W,4] normal map
    (``cuttlefish_tpu/convert/device.py:_normal_map_device``).

    Central differences, one-sided at edges that do not wrap (distance 1),
    dy = south - north, z normalised, [-1,1] -> [0,1] unless KeepSign.
    ``options`` is the NormalOptions bitmask: KeepSign=1, WrapX=2, WrapY=4.
    """
    keep_sign, wrap_x, wrap_y = options & 1, options & 2, options & 4
    hh, ww = h.shape[-2], h.shape[-1]
    dist_y = np.full((hh, 1), 2.0, np.float32)
    if wrap_y:
        above = torch.roll(h, 1, dims=-2)
        below = torch.roll(h, -1, dims=-2)
    else:
        above = torch.cat([h[..., :1, :], h[..., :-1, :]], dim=-2)
        below = torch.cat([h[..., 1:, :], h[..., -1:, :]], dim=-2)
        dist_y[0] = dist_y[-1] = 1.0
    dy = (below - above) * torch.from_numpy(height / dist_y).to(h.device)
    dist_x = np.full((1, ww), 2.0, np.float32)
    if wrap_x:
        left = torch.roll(h, 1, dims=-1)
        right = torch.roll(h, -1, dims=-1)
    else:
        left = torch.cat([h[..., :, :1], h[..., :, :-1]], dim=-1)
        right = torch.cat([h[..., :, 1:], h[..., :, -1:]], dim=-1)
        dist_x[0, 0] = dist_x[0, -1] = 1.0
    dx = (left - right) * torch.from_numpy(height / dist_x).to(h.device)
    inv_len = torch.rsqrt(dx * dx + dy * dy + 1.0)
    xyz = torch.stack([dx * inv_len, dy * inv_len, inv_len], dim=-1)
    if not keep_sign:
        xyz = xyz * 0.5 + 0.5
    return torch.cat([xyz, torch.ones_like(inv_len)[..., None]], dim=-1)


def mip_dims(h: int, w: int, levels: int) -> list[tuple[int, int]]:
    return [(max(h >> k, 1), max(w >> k, 1)) for k in range(levels)]


@functools.lru_cache(maxsize=64)
def _taps(n_in: int, n_out: int, filter_name: str) -> tuple[np.ndarray, np.ndarray]:
    """The nonzero entries of each row of ``resample_weights(n_in, n_out)``
    (cast to float32, as the JAX package casts it), in ascending source
    order: (source index [n_out, K] int64, weight [n_out, K] float32),
    short rows padded with weight 0 at index 0."""
    wm = resample_weights(n_in, n_out, filter_name).astype(np.float32)
    nz = wm != 0
    k = max(int(nz.sum(1).max()), 1)
    idx = np.zeros((n_out, k), np.int64)
    wt = np.zeros((n_out, k), np.float32)
    for o in range(n_out):
        cols = np.flatnonzero(nz[o])
        idx[o, : cols.size] = cols
        wt[o, : cols.size] = wm[o, cols]
    idx.setflags(write=False)
    wt.setflags(write=False)
    return idx, wt


@functools.lru_cache(maxsize=64)
def _taps_device(
    n_in: int, n_out: int, filter_name: str, device: torch.device
) -> tuple[torch.Tensor, torch.Tensor]:
    """``_taps`` on ``device``, uploaded once: (source index [n_out, K]
    int32, weight [n_out, K] float32), contiguous."""
    idx, wt = _taps(n_in, n_out, filter_name)
    return (
        torch.tensor(idx, dtype=torch.int32, device=device),
        torch.tensor(wt, device=device),
    )


def _resample(x: torch.Tensor, n_out: int, filter_name: str, dim: int) -> torch.Tensor:
    """Resample [S,H,W,4] along ``dim`` (1: rows, 2: columns): each output
    texel is its taps' weighted sum, added in source order (the einsum
    ``oi,siwc->sowc`` of the JAX package without its zero terms)."""
    idx, wt = _taps(x.shape[dim], n_out, filter_name)
    idx = torch.tensor(idx, device=x.device)
    wt = torch.tensor(wt, device=x.device)
    shape = [1, 1, 1, 1]
    shape[dim] = n_out
    out = None
    for k in range(idx.shape[1]):
        term = x.index_select(dim, idx[:, k]) * wt[:, k].reshape(shape)
        out = term if out is None else out + term
    return out


def _tile(cur: torch.Tensor, block_w: int, block_h: int) -> torch.Tensor:
    """[S,H,W,4] -> [S*nby*nbx, bh*bw, 4] blocks, edge texels repeated
    into partial blocks (``extract_blocks`` per surface)."""
    s, hh, ww, c = cur.shape
    nby, nbx = -(-hh // block_h), -(-ww // block_w)
    if nby * block_h != hh:
        rows = torch.arange(nby * block_h, device=cur.device).clamp_(max=hh - 1)
        cur = cur.index_select(1, rows)
    if nbx * block_w != ww:
        cols = torch.arange(nbx * block_w, device=cur.device).clamp_(max=ww - 1)
        cur = cur.index_select(2, cols)
    return (
        cur.reshape(s, nby, block_h, nbx, block_w, c)
        .permute(0, 1, 3, 2, 4, 5)
        .reshape(s * nby * nbx, block_h * block_w, c)
    )


def pyramid_blocks(
    x: torch.Tensor,
    levels: int,
    filter_name: str,
    srgb: bool,
    block_w: int,
    block_h: int,
    normal_opts: tuple | None = None,
) -> torch.Tensor:
    """Level 0 [S,H,W,4] float32 (texture colour space) -> the block batch
    of every level of every surface, [N, bh*bw, 4] float32 on the same
    device, mip-major and surface-minor (``_FusedPyramid.fn`` of the JAX
    package up to its encode).

    On a CUDA tensor the hand kernel builds each level with one launch
    (``kernels/pyramid_cuda.py``), bit for bit the torch ops of
    ``pyramid_blocks_plain``, which run on any other device.
    """
    if x.device.type == "cuda":
        from cuttlefish_tpu_torch.kernels.pyramid_cuda import build_level

        return pyramid_blocks_levels(
            x, levels, filter_name, srgb, block_w, block_h, normal_opts, build_level
        )
    return pyramid_blocks_plain(x, levels, filter_name, srgb, block_w, block_h, normal_opts)


def _normal_level0(x: torch.Tensor, srgb: bool, normal_opts: tuple) -> torch.Tensor:
    """Level 0 taken as a heightfield -> its normal map; an sRGB
    heightfield is undone to linear for it and the map re-encoded."""
    opts, nm_height = normal_opts
    hf = srgb_to_linear_rgba(x) if srgb else x
    nm = normal_map_device(hf[..., 0], opts, nm_height)
    return linear_to_srgb_rgba(nm) if srgb else nm


def pyramid_blocks_plain(
    x: torch.Tensor,
    levels: int,
    filter_name: str,
    srgb: bool,
    block_w: int,
    block_h: int,
    normal_opts: tuple | None = None,
) -> torch.Tensor:
    """``pyramid_blocks`` as torch ops, on any device.

    ``normal_opts`` (NormalOptions bitmask, height): level 0 is taken as a
    heightfield and turned into a normal map first.  No clamp: filter
    overshoot survives as on the host path.
    """
    cur = x if normal_opts is None else _normal_level0(x, srgb, normal_opts)
    parts = []
    for k, (hh, ww) in enumerate(mip_dims(x.shape[1], x.shape[2], levels)):
        if k:
            src = srgb_to_linear_rgba(cur) if srgb else cur
            t2 = _resample(_resample(src, hh, filter_name, 1), ww, filter_name, 2)
            cur = linear_to_srgb_rgba(t2) if srgb else t2
        parts.append(_tile(cur, block_w, block_h))
    return torch.cat(parts) if len(parts) > 1 else parts[0]


def pyramid_blocks_levels(
    x: torch.Tensor,
    levels: int,
    filter_name: str,
    srgb: bool,
    block_w: int,
    block_h: int,
    normal_opts: tuple | None,
    build_level,
) -> torch.Tensor:
    """``pyramid_blocks`` by one ``build_level`` call a level (on the card
    ``kernels/pyramid_cuda.py:build_level``, one launch).

    ``build_level(src, lin, blocks, first, (h, w), taps, block_w, block_h,
    srgb)`` writes the level of size (h, w) of every surface into
    ``blocks`` from block ``first`` on, from ``src``, the level above in
    linear light, through ``taps`` (rows' and columns' ``_taps_device``), or
    for level 0 (``taps`` None) tiles ``src`` as stored; where ``lin`` is
    given it writes the level there in linear light, which the next level
    reads.  The normal map's level 0 stays torch ops.
    """
    if normal_opts is not None:
        x = _normal_level0(x, srgb, normal_opts)
    x = x.contiguous()
    s, h, w, _ = x.shape
    dims = mip_dims(h, w, levels)
    counts = [s * (-(-hh // block_h)) * (-(-ww // block_w)) for hh, ww in dims]
    blocks = torch.empty(
        (sum(counts), block_h * block_w, 4), dtype=torch.float32, device=x.device
    )
    src, first = x, 0
    for k, (hh, ww) in enumerate(dims):
        lin = None
        if k + 1 < levels and (k or srgb):
            lin = torch.empty((s, hh, ww, 4), dtype=torch.float32, device=x.device)
        taps = None
        if k:
            taps = (
                _taps_device(src.shape[1], hh, filter_name, x.device),
                _taps_device(src.shape[2], ww, filter_name, x.device),
            )
        build_level(src, lin, blocks, first, (hh, ww), taps, block_w, block_h, srgb)
        first += counts[k]
        if lin is not None:
            src = lin
    return blocks

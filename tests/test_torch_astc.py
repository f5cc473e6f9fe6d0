"""The port's ASTC LDR encoder at 4x4 against the TPU kernels that it ports.

The reference is the bodies of ``astc_pallas.py:_kernel_a`` .. ``_kernel_d``
called eagerly on the CPU (``jax.disable_jit``, numpy arrays as their
refs), with the operands built as ``encode_astc_pallas`` builds them and
their words merged as it merges them (``eager_encode``).
``pl.program_id`` has no grid outside a kernel: the eager call reads tile 0
of a one-tile flag array, set when the batch holds a near-gray block.
``tests/test_torch_astc_interpret.py`` holds the eager call to
``encode_astc_pallas(..., interpret=True)``.

The inputs are seeded blocks through the u8 wire (``astc_blocks``) in three
kinds: colour (opaque), alpha (the same with a varying alpha) and near-gray
(R = G = B within the near-gray spread, with and without alpha).  The
helpers here serve the other ASTC test files too.

Tolerance: 100 % identical words at 4x4 (the same arithmetic in the same
order).
"""

import contextlib

import jax
import numpy as np
import pytest
import torch

from cuttlefish_tpu.kernels import astc as jastc
from cuttlefish_tpu.kernels import astc_pallas as jp
from cuttlefish_tpu.kernels.astc_ise import quint_pack_table, trit_pack_table
from cuttlefish_tpu.kernels.astc_partition import partition_table, unique_partition_seeds
from cuttlefish_tpu_torch.kernels import astc


def astc_blocks(n=128, t=16, kind="color", seed=7):
    """[n,t,4] RGBA blocks through the u8 wire: flat, two-tone, gradients,
    saturated and random texels; ``kind`` "color" is opaque, "alpha" adds a
    varying alpha, "gray" / "gray_alpha" make R = G = B up to a spread
    below the near-gray bound."""
    rng = np.random.default_rng(seed)
    k = n // 5
    b = np.clip(rng.random((n, 1, 4)) + rng.normal(0, 0.12, (n, t, 4)), 0, 1)
    b[:k] = b[:k, :1]  # flat
    half = t // 2
    b[k : 2 * k, half:] = b[k : 2 * k, :1]  # two-tone
    b[k : 2 * k, :half] = b[k : 2 * k, t - 1 : t]
    ramp = np.linspace(0, 1, t)[None, :, None]
    g = rng.random((k, 2, 4))
    b[2 * k : 3 * k] = g[:, :1] + (g[:, 1:] - g[:, :1]) * ramp  # gradients
    b[3 * k : 4 * k] = rng.random((k, t, 4)) > 0.5  # saturated
    b[4 * k :] = rng.random((n - 4 * k, t, 4))  # random
    if kind in ("gray", "gray_alpha"):
        b[..., 1] = np.clip(b[..., 0] + rng.normal(0, 0.01, b.shape[:2]), 0, 1)
        b[..., 2] = np.clip(b[..., 0] + rng.normal(0, 0.01, b.shape[:2]), 0, 1)
        b[: n // 8, :, 1] = b[: n // 8, :, 0]  # exact gray
        b[: n // 8, :, 2] = b[: n // 8, :, 0]
    if kind in ("color", "gray"):
        b[..., 3] = 1.0
    return np.round(b * 255).astype(np.uint8).astype(np.float32) * np.float32(1 / 255)


@contextlib.contextmanager
def _tile_zero():
    """pl.program_id outside a kernel: tile 0 of a one-tile grid."""
    orig = jp.pl.program_id
    jp.pl.program_id = lambda axis: 0
    try:
        yield
    finally:
        jp.pl.program_id = orig


def _x(blocks):
    x = np.clip(blocks.astype(np.float32), 0.0, 1.0) * np.float32(255.0)
    return np.ascontiguousarray(np.transpose(x, (2, 1, 0)))


def _packs():
    return (trit_pack_table().reshape(1, -1).astype(np.float32),
            quint_pack_table().reshape(1, -1).astype(np.float32))


def _cluts(levels):
    return [np.stack(jastc._color_qlut(lv)).astype(np.float32) for lv in levels]


def _grids(bw, bh, lays):
    out = []
    for lay in lays:
        out += list(jp._prepared_grid(bw, bh, lay.gw, lay.gh))
    return out


def eager_stage(stage, blocks, bw, bh, quality, gray=True, alpha=True):
    """One kernel body run eagerly -> ([N,4] uint32 words, [N] error)."""
    n = blocks.shape[0]
    x = _x(blocks)
    out = np.zeros((4, n), np.uint32)
    err = np.zeros((1, n), np.float32)
    trit, quint = _packs()
    isgray = jastc.has_gray_blocks(blocks)
    flags = np.array([1 if isgray else 0], np.int32)
    with jax.disable_jit(), _tile_zero():
        if stage == "a":
            base, gray_t = jp._tasks_a(bw, bh, quality, gray, alpha)
            tasks = base + gray_t
            levels = tuple(sorted({l.clevels for l, _ in tasks if l.clevels != 256}))
            keys = tuple(sorted({(l.gw, l.gh) for l, _ in tasks
                                 if jp._prepared_grid(bw, bh, l.gw, l.gh) is not None}))
            grids = []
            for gw, gh in keys:
                grids += list(jp._prepared_grid(bw, bh, gw, gh))
            use_flags = bool(gray and gray_t)
            jp._kernel_a(x, *([flags] if use_flags else []), trit, quint, *_cluts(levels),
                         *grids, out, err, quality=quality, clut_levels=levels, bw=bw,
                         bh=bh, grid_keys=keys, gray=use_flags, alpha=alpha)
        elif stage == "b":
            lays = jp._layouts_b(bw, bh, quality, alpha)
            us2 = unique_partition_seeds(bw, bh, 2)
            pt = (partition_table(bw, bh, 2)[us2] == 1).astype(np.float32)
            smap = us2.astype(np.float32)[:, None]
            levels = tuple(sorted({l.clevels for l in lays if l.clevels != 256}))
            gidx = tuple(i for i, l in enumerate(lays)
                         if jp._prepared_grid(bw, bh, l.gw, l.gh) is not None)
            jp._kernel_b(x, pt, np.ascontiguousarray(pt.T), smap, trit, quint,
                         *_cluts(levels), *_grids(bw, bh, [lays[i] for i in gidx]), out, err,
                         quality=quality, bw=bw, bh=bh, clut_levels=levels,
                         grid_layidx=gidx, alpha=alpha)
        elif stage == "c":
            lay = jastc.layout_menu(bw, bh)[(8, 3)][0]
            us3 = unique_partition_seeds(bw, bh, 3)
            tab3 = partition_table(bw, bh, 3)[us3]
            p1 = (tab3 == 1).astype(np.float32)
            p2 = (tab3 == 2).astype(np.float32)
            levels = (lay.clevels,) if lay.clevels != 256 else ()
            has_grid = jp._prepared_grid(bw, bh, lay.gw, lay.gh) is not None
            jp._kernel_c(x, p1, p2, np.ascontiguousarray(p1.T), np.ascontiguousarray(p2.T),
                         us3.astype(np.float32)[:, None], trit, quint, *_cluts(levels),
                         *(_grids(bw, bh, [lay]) if has_grid else []), out, err,
                         quality=quality, bw=bw, bh=bh, clut_levels=levels, has_grid=has_grid)
        else:
            lays = jp._layouts_d(bw, bh)
            tab4 = partition_table(bw, bh, 4)
            pd = [(tab4 == j).astype(np.float32) for j in (1, 2, 3)]
            levels = tuple(sorted({l.clevels for l in lays if l.clevels != 256}))
            gidx = tuple(i for i, l in enumerate(lays)
                         if jp._prepared_grid(bw, bh, l.gw, l.gh) is not None)
            jp._kernel_d(x, flags, *pd, *(np.ascontiguousarray(p.T) for p in pd), trit, quint,
                         *_cluts(levels), *_grids(bw, bh, [lays[i] for i in gidx]), out, err,
                         quality=quality, bw=bw, bh=bh, clut_levels=levels, grid_layidx=gidx)
    return out.T.copy(), err[0].copy()


def eager_encode(blocks, bw, bh, quality, gray=True, alpha=True):
    """The four kernel bodies merged as encode_astc_pallas merges them."""
    words = err = None
    for stage in astc.stages(bw, bh, quality, gray, alpha):
        w, e = eager_stage(stage, blocks, bw, bh, quality, gray, alpha)
        if words is None:
            words, err = w, e
        else:
            take = e < err
            words = np.where(take[:, None], w, words)
            if stage != "d":
                err = np.where(take, e, err)
    return words


def flags_of(blocks):
    """The converter's content scans (AstcConverter.refine_params)."""
    return jastc.has_gray_blocks(blocks), jastc.has_alpha_blocks(blocks)


def port_encode(blocks, bw, bh, quality, gray=True, alpha=True):
    return astc.encode_astc(torch.from_numpy(blocks), bw, bh, quality, gray, alpha).numpy()


def same(a, b):
    return float(np.all(a == b, axis=1).mean())


def to_bytes(words):
    return np.frombuffer(np.ascontiguousarray(np.asarray(words).astype("<u4")).tobytes(), np.uint8)


def check_4x4(kind, quality):
    """100 % identical words on 80 seeded 4x4 blocks of ``kind``, with the
    gray/alpha gates that the converter's scans set for them."""
    b = astc_blocks(80, 16, kind, seed=11 + quality)
    gray, alpha = flags_of(b)
    assert gray == kind.startswith("gray") and alpha == kind.endswith("alpha")
    port = port_encode(b, 4, 4, quality, gray, alpha)
    ref = eager_encode(b, 4, 4, quality, gray, alpha)
    assert port.dtype == np.uint32 and port.shape == ref.shape
    assert same(port, ref) == 1.0, same(port, ref)


@pytest.mark.parametrize("quality", [0, 1, 2, 3, 4])
def test_plain_matches_tpu_kernel_4x4_color(quality):
    """Opaque colour blocks: void extent, CEM 8 and the 2-/3-partition
    kernels (``test_torch_astc_alpha.py`` and ``test_torch_astc_gray*.py``
    take the other kinds)."""
    check_4x4("color", quality)

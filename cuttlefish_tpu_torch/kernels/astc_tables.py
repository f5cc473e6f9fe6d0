"""Static tables of the ASTC LDR encoder (numpy only).

The part of ``cuttlefish_tpu/kernels/astc.py`` that the kernels of
``astc_pallas.py`` read when they are built, copied unchanged: the block-mode
field, the C.2.18 infill matrix, the layout menu (``Layout``,
``layout_menu``), the colour and weight quantisation LUTs, the quality plan
(``_PLAN``, ``plan_for``) and the host content scans (``has_gray_blocks``,
``has_alpha_blocks``), and for the HDR profile (``kernels/astc_hdr.py``)
its layout menu (``hdr_layout_menu``) and its grid's infill and
pseudo-inverse (``_prepared_np``).  From ``astc_pallas.py``, also unchanged:
``_prepared_grid`` (the decimated grid's infill, pseudo-inverse and
footprint) and the static task lists of its kernels (``_tasks_a``,
``_layouts_b``, ``_layouts_d``).  The encoders are
``kernels/astc.py`` (plain PyTorch version) and ``kernels/astc_cuda.py``.
"""

from __future__ import annotations

import functools

import numpy as np

from cuttlefish_tpu_torch.kernels.astc_ise import (
    color_unquant,
    ise_bits,
    range_info,
    weight_unquant,
)

# ---------------------------------------------------------------------------
# Static tables
# ---------------------------------------------------------------------------

# Weight range -> (R, H) block-mode fields.
_RH_FROM_WRANGE = {
    2: (0b010, 0), 3: (0b011, 0), 4: (0b100, 0), 5: (0b101, 0),
    6: (0b110, 0), 8: (0b111, 0),
    10: (0b010, 1), 12: (0b011, 1), 16: (0b100, 1), 20: (0b101, 1),
    24: (0b110, 1), 32: (0b111, 1),
}

_COLOR_LADDER = [
    256, 192, 160, 128, 96, 80, 64, 48, 40, 32, 24, 20, 16, 12, 10, 8, 6, 5,
    4, 3, 2,
]


def implied_color_range(n_vals: int, budget: int) -> int:
    for levels in _COLOR_LADDER:
        kind, b = range_info(levels, False)
        if ise_bits(n_vals, kind, b) <= budget:
            return levels
    raise ValueError("no color range fits")


def infill_weights(bw: int, bh: int, gw: int, gh: int) -> np.ndarray:
    """Spec C.2.18 bilinear infill as a [bw*bh, gw*gh] int matrix (/16)."""
    a = np.zeros((bw * bh, gw * gh), np.int32)
    ds = (1024 + bw // 2) // (bw - 1)
    dt = (1024 + bh // 2) // (bh - 1)
    for ty in range(bh):
        for tx in range(bw):
            cs = ds * tx
            ct = dt * ty
            gs = (cs * (gw - 1) + 32) >> 6
            gt = (ct * (gh - 1) + 32) >> 6
            js, fs = gs >> 4, gs & 0xF
            jt, ft = gt >> 4, gt & 0xF
            w11 = (fs * ft + 8) >> 4
            w01 = fs - w11
            w10 = ft - w11
            w00 = 16 - fs - ft + w11
            t = ty * bw + tx
            for jx, jy, w in ((js, jt, w00), (js + 1, jt, w01),
                              (js, jt + 1, w10), (js + 1, jt + 1, w11)):
                if w and jx < gw and jy < gh:
                    a[t, jy * gw + jx] += w
    return a


def block_mode_field(gw: int, gh: int, wlevels: int, dual: bool = False) -> int:
    """11-bit block mode for a weight grid (spec C.2.10, both halves).

    Primary rows cover (4-7)x(2-5) / (8-11)x(2-5) / (2-5)x(8-11);
    the extended rows (bits[1:0] == 00) add 12x(2-5) / (2-5)x12 /
    (6-9)x(6-9) / 6x10 / 10x6 — the grids large blocks need (their
    per-texel decode is identical; the field layout differs).  Extended
    (A+6)x(B+6) rows carry no D/H bits: no dual plane and only the h=0
    weight ranges (2..8 levels)."""
    r, h = _RH_FROM_WRANGE[wlevels]
    r0 = r & 1
    r21 = r >> 1
    if 4 <= gw <= 7 and 2 <= gh <= 5:
        b, a, cfg = gw - 4, gh - 2, 0b00
    elif 8 <= gw <= 11 and 2 <= gh <= 5:
        b, a, cfg = gw - 8, gh - 2, 0b01
    elif 2 <= gw <= 5 and 8 <= gh <= 11:
        b, a, cfg = gh - 8, gw - 2, 0b10
    else:
        # Extended rows: R0 = bit 4, R[2:1] = bits[3:2], bits[1:0] = 00.
        base = (r21 << 2) | (r0 << 4)
        if gw == 12 and 2 <= gh <= 5:
            return (int(dual) << 10) | (h << 9) | (0b00 << 7) | ((gh - 2) << 5) | base
        if gh == 12 and 2 <= gw <= 5:
            return (int(dual) << 10) | (h << 9) | (0b01 << 7) | ((gw - 2) << 5) | base
        if (gw, gh) == (6, 10):
            return (int(dual) << 10) | (h << 9) | (0b11 << 7) | (0b00 << 5) | base
        if (gw, gh) == (10, 6):
            return (int(dual) << 10) | (h << 9) | (0b11 << 7) | (0b01 << 5) | base
        if 6 <= gw <= 9 and 6 <= gh <= 9:
            if dual or h:
                raise ValueError("extended (A+6)x(B+6) rows have no D/H bits")
            return ((gh - 6) << 9) | (0b10 << 7) | ((gw - 6) << 5) | base
        raise ValueError(f"unsupported weight grid {gw}x{gh}")
    return (
        (int(dual) << 10) | (h << 9) | (b << 7) | (a << 5)
        | (r0 << 4) | (cfg << 2) | r21
    )

# ---------------------------------------------------------------------------
# Layouts
# ---------------------------------------------------------------------------


class Layout:
    """A fully-determined block configuration (everything static)."""

    def __init__(self, bw, bh, nparts, cem, gw, gh, wlevels, dual=False):
        self.bw, self.bh = bw, bh
        self.nparts, self.cem = nparts, cem
        self.gw, self.gh, self.wlevels = gw, gh, wlevels
        self.dual = dual
        wkind, wb = range_info(wlevels, True)
        self.nweights = gw * gh * (2 if dual else 1)
        self.wbits = ise_bits(self.nweights, wkind, wb)
        self.header = 17 if nparts == 1 else 29
        self.nvals = nparts * 2 * ((cem >> 2) + 1)
        self.clevels = implied_color_range(
            self.nvals, 128 - self.header - self.wbits - (2 if dual else 0)
        )
        block_mode_field(gw, gh, wlevels, dual)  # raises if grid unsupported

    def valid(self):
        return (
            24 <= self.wbits <= 96
            and self.nweights <= 64
            and self.gw <= self.bw
            and self.gh <= self.bh
            and self.nvals <= 18
            and self.clevels >= 8
            and not (self.dual and self.nparts > 3)
        )

    def __repr__(self):
        return (
            f"Layout({self.nparts}p cem{self.cem} grid{self.gw}x{self.gh} "
            f"w{self.wlevels} c{self.clevels}{' dp' if self.dual else ''})"
        )


def _try_layout(bw, bh, nparts, cem, gw, gh, wlevels, dual=False):
    try:
        lay = Layout(bw, bh, nparts, cem, gw, gh, wlevels, dual)
    except ValueError:
        return None
    return lay if lay.valid() else None


@functools.lru_cache(maxsize=64)
def layout_menu(bw: int, bh: int):
    """Candidate layouts per (cem, nparts), quality-ordered lists."""

    def grids():
        out = []
        for gw in range(2, 13):
            for gh in range(2, 13):
                if gw <= bw and gh <= bh and gw * gh <= 64:
                    try:
                        block_mode_field(gw, gh, 2)
                    except ValueError:
                        continue
                    out.append((gw, gh))
        return out

    gs = grids()
    full = max(gs, key=lambda g: (g[0] * g[1], min(g)))

    def best_for(nparts, cem, min_clevels, prefer_wlevels, dual=False):
        """Pick the layout with the largest weight budget whose implied
        color range stays >= min_clevels, preferring finer weight ranges."""
        cands = []
        for gw, gh in gs:
            for wl in (32, 24, 20, 16, 12, 10, 8, 6, 5, 4, 3, 2):
                lay = _try_layout(bw, bh, nparts, cem, gw, gh, wl, dual)
                if lay and lay.clevels >= min_clevels:
                    cands.append(lay)
        if not cands:
            return None
        # score: texel coverage of the grid, then weight precision
        def score(l):
            cover = min(1.0, (l.gw * l.gh) / (bw * bh))
            return (cover, l.wlevels if l.wlevels <= prefer_wlevels else 0, l.clevels)
        return max(cands, key=score)

    menu = {}
    # CEM 8 single partition: a ladder of weight-precision tradeoffs.
    menu[(8, 1)] = [
        lay for lay in (
            best_for(1, 8, 64, 12),    # full grid, fine-ish weights
            best_for(1, 8, 192, 16),   # near-8-bit colors
            best_for(1, 8, 40, 24),    # finest weights
        ) if lay
    ]
    if bw * bh >= 64:
        # Large blocks: the cover-dominated score collapses all three
        # picks onto the max-coverage extended grid (8x8 w2); keep the
        # finer-weight decimated alternatives in the menu explicitly —
        # smooth content prefers weight precision over grid coverage.
        extra = [
            _try_layout(bw, bh, 1, 8, 6, 5, 4),
            _try_layout(bw, bh, 1, 8, 5, 5, 6),
        ]
        seen = {(l.gw, l.gh, l.wlevels) for l in menu[(8, 1)]}
        for lay in extra:
            if lay and (lay.gw, lay.gh, lay.wlevels) not in seen:
                menu[(8, 1)].append(lay)
                seen.add((lay.gw, lay.gh, lay.wlevels))
        # dedup the best_for collapses
        uniq = []
        seen2 = set()
        for lay in menu[(8, 1)]:
            k = (lay.gw, lay.gh, lay.wlevels)
            if k not in seen2:
                uniq.append(lay)
                seen2.add(k)
        menu[(8, 1)] = uniq
    menu[(12, 1)] = [
        lay for lay in (
            best_for(1, 12, 64, 8),
            best_for(1, 12, 96, 12),
            best_for(1, 12, 256, 4),   # full-precision colors, coarse grid
        ) if lay
    ]
    # CEM 0 (luminance direct): 2 color values leave nearly the whole
    # budget for the weight grid — the win case is grayscale content,
    # where RGB-replicated decode makes 8-bit luma + a fine grid beat
    # every CEM 8 layout.  CEM 4 adds direct alpha (L0,L1,A0,A1).
    menu[(0, 1)] = [lay for lay in (best_for(1, 0, 256, 32),) if lay]
    menu[(4, 1)] = [lay for lay in (best_for(1, 4, 64, 16),) if lay]
    menu[(8, 2)] = [
        lay for lay in (
            best_for(2, 8, 20, 6),    # fine-ish weights
            best_for(2, 8, 40, 4),    # finer colors (astc_cpu.cpp layout E)
        ) if lay
    ]
    menu[(12, 2)] = [lay for lay in (best_for(2, 12, 12, 4),) if lay]
    # 3-partition CEM 8 (18 endpoint values — the ISE ceiling): astcenc
    # searches up to 4 partitions at its higher presets.
    menu[(8, 3)] = [lay for lay in (best_for(3, 8, 8, 4),) if lay]
    # 4-partition blocks: CEM 8 x 4 would need 24 endpoint values (> the
    # 18-value ISE cap, spec C.2.24), so only the luminance CEMs fit —
    # CEM 0 (8 values) and CEM 4 (16).  The win case is multi-region
    # grayscale(+alpha) content; astcenc searches 4 partitions at
    # THOROUGH+ (AstcConverter.cpp:174-195).
    menu[(0, 4)] = [lay for lay in (best_for(4, 0, 64, 12),) if lay]
    menu[(4, 4)] = [lay for lay in (best_for(4, 4, 8, 4),) if lay]
    # Dual-plane single partition: one plane for the CCS channel, one for
    # the rest (spec C.2.10; the astcenc analog is 1-plane-of-2 trials).
    menu[(12, "dp")] = [lay for lay in (best_for(1, 12, 16, 6, dual=True),) if lay]
    menu[(8, "dp")] = [lay for lay in (best_for(1, 8, 24, 8, dual=True),) if lay]
    # Deduplicate identical layouts.
    for k, lays in menu.items():
        seen, out = set(), []
        for l in lays:
            key = (l.gw, l.gh, l.wlevels)
            if key not in seen:
                seen.add(key)
                out.append(l)
        menu[k] = out
    return menu


@functools.lru_cache(maxsize=64)
def hdr_layout_menu(bw: int, bh: int):
    """CEM 11 / CEM 14 single-partition layouts (8-bit colors forced:
    the direct submode's fields are plain bytes)."""

    def best(cem):
        cands = []
        for gw in range(2, 12):
            for gh in range(2, 12):
                for wl in (24, 20, 16, 12, 10, 8, 6, 5, 4):
                    lay = _try_layout(bw, bh, 1, cem, gw, gh, wl)
                    if lay and lay.clevels == 256:
                        cands.append(lay)
        if not cands:
            return None
        return max(
            cands,
            key=lambda l: (min(1.0, (l.gw * l.gh) / (bw * bh)), l.wlevels),
        )

    return {11: best(11), 14: best(14)}


@functools.lru_cache(maxsize=256)
def _prepared_np(bw, bh, gw, gh):
    a = infill_weights(bw, bh, gw, gh)
    af = a.astype(np.float64) / 16.0
    pinv = np.linalg.pinv(af).astype(np.float32)
    return a, pinv


# ---------------------------------------------------------------------------
# Quantization helpers
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _color_qlut(levels: int):
    """256-entry byte -> (quantized value, dequantized byte) numpy LUTs."""
    unq = color_unquant(levels)
    bytes_ = np.arange(256)
    dist = np.abs(bytes_[:, None] - unq[None, :])
    q = np.argmin(dist, axis=1)
    return q.astype(np.int32), unq[q].astype(np.int32)


@functools.lru_cache(maxsize=None)
def _weight_qlut(levels: int):
    """65-entry w64 -> (quantized value, dequantized w64) numpy LUTs."""
    unq = weight_unquant(levels)
    w = np.arange(65)
    dist = np.abs(w[:, None] - unq[None, :])
    q = np.argmin(dist, axis=1)
    return q.astype(np.int32), unq[q].astype(np.int32)


@functools.lru_cache(maxsize=None)
def _weight_neighbors(levels: int):
    """Per quantized weight value: the neighbors one step up/down the
    UNQUANTIZED (w64) ladder.  ASTC quantized values are not stored in
    increasing unquant order, so +-1 on the raw value is meaningless —
    these tables give the true adjacent rungs for exact-error refinement."""
    unq = weight_unquant(levels)
    order = np.argsort(unq, kind="stable")  # ranks -> value
    rank_of = np.empty(levels, np.int64)
    rank_of[order] = np.arange(levels)
    up = order[np.minimum(rank_of + 1, levels - 1)]
    dn = order[np.maximum(rank_of - 1, 0)]
    return up.astype(np.int32), dn.astype(np.int32)


# quality -> fit depths, partition-seed depths, single-partition ladder
# depth and dual-plane CCS candidates.  How each depth was chosen is told
# beside the original (cuttlefish_tpu/kernels/astc.py:_PLAN).
_PLAN = {
    0: dict(iters=1, seeds2=0, seeds3=0, seeds4=0, cem8_layouts=1,
            cem12_layouts=1, cem0_layouts=1, cem4_layouts=1, dp_ccs=()),
    1: dict(iters=1, seeds2=1, seeds3=0, seeds4=0, cem8_layouts=1,
            cem12_layouts=1, cem0_layouts=1, cem4_layouts=1, dp_ccs=()),
    2: dict(iters=3, iters12=4, seeds2=6, seeds3=0, seeds4=0,
            cem8_layouts=3, cem12_layouts=3, cem0_layouts=1,
            cem4_layouts=1, dp_ccs=(3,), p2_layouts=2, keep2=1,
            p2_iters=2),
    # q3 keep2 follows q2 (distinct-pattern top-6, deep-fit 1): q3's
    # 2-partition search then equals q2's exactly, and the extra
    # 3/4-partition + (12,2) sweeps keep the ladder monotone for free.
    3: dict(iters=3, iters12=4, seeds2=6, seeds3=1, seeds4=1,
            cem8_layouts=3, cem12_layouts=3, cem0_layouts=1,
            cem4_layouts=1, dp_ccs=(3,), p2_layouts=2, keep2=1,
            p2_iters=2),
    4: dict(iters=4, iters12=5, seeds2=16, seeds3=6, keep3=3, seeds4=2,
            cem8_layouts=3, cem12_layouts=3, cem0_layouts=1,
            cem4_layouts=1, dp_ccs=(0, 1, 2, 3), p2_layouts=2, keep2=5,
            p2_iters=4),
}


GRAY_SPREAD = 16.0 / 255.0  # max RGB channel spread for a "near-gray" texel


def has_gray_blocks(blocks) -> bool:
    """Host-side scan: does any block consist entirely of near-gray texels?

    The luminance CEMs 0/4 can only win on such blocks (encoding a colored
    texel as replicated luminance has large error by construction), so a
    batch with none lets the encoder skip those fits.  ``blocks`` is host
    [N, T, 4] float RGBA in 0..1."""
    import numpy as np_

    rgb = np_.asarray(blocks, np_.float32)[..., :3]
    spread = rgb.max(axis=2) - rgb.min(axis=2)  # [N,T]
    return bool((spread.max(axis=1) < GRAY_SPREAD).any())


def has_alpha_blocks(blocks) -> bool:
    """Host-side scan: does any texel carry non-opaque alpha?

    A fully-opaque batch lets the encoder skip every CEM 12 fit (incl.
    dual-plane): CEM 8's implicit alpha decodes to exactly 255, and the
    extra endpoint pair only costs color precision, so CEM 12 cannot win
    (measured <=0.0002 dB across the opaque harness classes).  The same
    role as astcenc's Alpha::None swizzle path
    (Cuttlefish's lib/src/AstcConverter.cpp:140-149)."""
    import numpy as np_

    a = np_.asarray(blocks, np_.float32)[..., 3]
    return bool((a < 254.5 / 255.0).any())


def plan_for(quality: int, bw: int, bh: int) -> dict:
    """Per-block-size effective plan.  The partition-seed depths were
    tuned on 4x4 (where the CPU-reference quality bar exists,
    tests/test_cpu_reference.py); on larger blocks the deep 2-partition
    sweep bought <=0.08 dB lerp / <=0.31 dB two-pop for 2.7-4x kernel
    cost (measured 6x6/8x8 q2, round 4), so 6x6+ runs a shallower seed
    search with the same layout menu and refine depths."""
    plan = _PLAN[max(0, min(4, int(quality)))]
    if bw * bh > 16:
        plan = dict(
            plan,
            seeds2=min(plan["seeds2"], 2),
            keep2=1,
            p2_iters=min(plan.get("p2_iters", plan["iters"]), 2),
            seeds3=min(plan["seeds3"], 1),
            seeds4=min(plan["seeds4"], 1),
        )
    return plan


def _tasks_a(bw, bh, quality, gray=True, alpha=True):
    """Kernel-A work lists ``(base, gray_tasks)``: base = 1-partition CEM
    8/12 layouts (ccs None) plus one dual-plane fit per plan dp_ccs
    candidate; gray_tasks = the luminance CEM 0/4 layouts, run only for
    near-gray blocks (a per-block gate).  Mirrors the sweep order of
    cuttlefish_tpu/kernels/astc.py:_encode_astc_jnp.
    ``gray=False`` drops the gray tasks entirely (the caller detected no
    near-gray blocks in the batch)."""
    plan = plan_for(quality, bw, bh)
    menu = layout_menu(bw, bh)
    base = [
        (lay, None)
        for lay in menu[(8, 1)][: plan["cem8_layouts"]]
        + menu[(12, 1)][: plan["cem12_layouts"] if alpha else 0]
    ]
    if plan["dp_ccs"] and menu[(12, "dp")] and alpha:
        lay = menu[(12, "dp")][0]
        for ccs in plan["dp_ccs"]:
            base.append((lay, ccs))
    gray_tasks = (
        [
            (lay, None)
            for lay in menu[(0, 1)][: plan["cem0_layouts"]]
            + menu[(4, 1)][: plan["cem4_layouts"]]
        ]
        if gray
        else []
    )
    return base, gray_tasks


@functools.lru_cache(maxsize=256)
def _prepared_grid(bw, bh, gw, gh):
    """(a [T,G] f32 of C.2.18 16ths, pinv [G,T] f32), or None if the grid
    is the full texel grid (infill is the identity)."""
    if gw == bw and gh == bh:
        return None
    a = infill_weights(bw, bh, gw, gh).astype(np.float64)
    pinv = np.linalg.pinv(a / 16.0).astype(np.float32)
    # transposed footprint mask [G,T] for the Gauss-Seidel scores
    foot_t = (a > 0).astype(np.float32).T
    return a.astype(np.float32), pinv, np.ascontiguousarray(foot_t)


def _layouts_b(bw, bh, quality, alpha=True):
    plan = plan_for(quality, bw, bh)
    menu = layout_menu(bw, bh)
    lays = list(menu[(8, 2)][: plan.get("p2_layouts", 1)])
    if quality >= 3 and menu[(12, 2)] and alpha:
        lays.append(menu[(12, 2)][0])
    return lays


def _layouts_d(bw, bh):
    menu = layout_menu(bw, bh)
    return [menu[key][0] for key in ((0, 4), (4, 4)) if menu[key]]

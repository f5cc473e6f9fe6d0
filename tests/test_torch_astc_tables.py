"""The port's static ASTC tables equal the JAX package's, for all 14 block
sizes and qualities 0-4: the ISE ranges, bit layouts and pack tables,
the partition tables and their distinct seeds, the block-mode field, the
C.2.18 infill, the layout menu, the quality plan and the kernels' task
lists, the decimated grids' operands, the quantisation LUTs and the host
content scans.  The functions of ``kernels/astc_tables.py`` are also held
to their originals' code, docstrings aside.
"""

import ast
import inspect
import textwrap

import numpy as np
import pytest

from cuttlefish_tpu.kernels import astc as jastc
from cuttlefish_tpu.kernels import astc_ise as jise
from cuttlefish_tpu.kernels import astc_pallas as jp
from cuttlefish_tpu.kernels import astc_partition as jpart
from cuttlefish_tpu_torch.formats import TextureFormat
from cuttlefish_tpu_torch.kernels import astc_ise as pise
from cuttlefish_tpu_torch.kernels import astc_partition as ppart
from cuttlefish_tpu_torch.kernels import astc_tables as pt

SIZES = [
    tuple(int(v) for v in f.name[5:].split("x"))
    for f in TextureFormat if f.name.startswith("ASTC_")
]
WLEVELS = [2, 3, 4, 5, 6, 8, 10, 12, 16, 20, 24, 32]
CLEVELS = [6, 8, 10, 12, 16, 20, 24, 32, 40, 48, 64, 80, 96, 128, 160, 192, 256]


def _size_id(s):
    return f"{s[0]}x{s[1]}"


def _lay(lay):
    return None if lay is None else (
        lay.bw, lay.bh, lay.nparts, lay.cem, lay.gw, lay.gh, lay.wlevels, lay.dual,
        lay.nweights, lay.wbits, lay.header, lay.nvals, lay.clevels, repr(lay))


def test_fourteen_block_sizes():
    assert len(SIZES) == 14 and (4, 4) in SIZES and (12, 12) in SIZES


@pytest.mark.parametrize("levels", WLEVELS)
def test_weight_ranges_equal_reference(levels):
    assert pise.range_info(levels, True) == jise.range_info(levels, True)
    assert np.array_equal(pise.weight_unquant(levels), jise.weight_unquant(levels))
    pq, pu = pt._weight_qlut(levels)
    jq, ju = jastc._weight_qlut(levels)
    assert np.array_equal(pq, jq) and np.array_equal(pu, ju) and pq.dtype == jq.dtype
    for mine, ref in zip(pt._weight_neighbors(levels), jastc._weight_neighbors(levels)):
        assert np.array_equal(mine, ref)
    kind, b = jise.range_info(levels, True)
    for n in (1, 4, 7, 16, 31, 64):
        assert pise.ise_bits(n, kind, b) == jise.ise_bits(n, kind, b)
        assert pise.ise_sequence_layout(n, kind, b) == jise.ise_sequence_layout(n, kind, b)


@pytest.mark.parametrize("levels", CLEVELS)
def test_colour_ranges_equal_reference(levels):
    assert pise.range_info(levels, False) == jise.range_info(levels, False)
    assert np.array_equal(pise.color_unquant(levels), jise.color_unquant(levels))
    pq, pd = pt._color_qlut(levels)
    jq, jd = jastc._color_qlut(levels)
    assert np.array_equal(pq, jq) and np.array_equal(pd, jd) and pq.dtype == jq.dtype
    for budget in (20, 37, 52, 75, 99):
        for nvals in (2, 4, 8, 12, 16, 18):
            try:
                ref = jastc.implied_color_range(nvals, budget)
            except ValueError:
                with pytest.raises(ValueError):
                    pt.implied_color_range(nvals, budget)
                continue
            assert pt.implied_color_range(nvals, budget) == ref


def test_pack_tables_equal_reference():
    assert np.array_equal(pise.trit_pack_table(), jise.trit_pack_table())
    assert np.array_equal(pise.quint_pack_table(), jise.quint_pack_table())


@pytest.mark.parametrize("size", SIZES, ids=_size_id)
def test_partition_tables_equal_reference(size):
    bw, bh = size
    for nparts in (2, 3, 4):
        assert np.array_equal(ppart.partition_table(bw, bh, nparts),
                              jpart.partition_table(bw, bh, nparts))
        assert np.array_equal(ppart.unique_partition_seeds(bw, bh, nparts),
                              jpart.unique_partition_seeds(bw, bh, nparts))


@pytest.mark.parametrize("size", SIZES, ids=_size_id)
def test_layout_menu_and_grids_equal_reference(size):
    bw, bh = size
    mine, ref = pt.layout_menu(bw, bh), jastc.layout_menu(bw, bh)
    assert list(mine) == list(ref)
    for key in ref:
        assert [_lay(x) for x in mine[key]] == [_lay(x) for x in ref[key]], key
        for lay in ref[key]:
            assert pt.block_mode_field(lay.gw, lay.gh, lay.wlevels, lay.dual) == \
                jastc.block_mode_field(lay.gw, lay.gh, lay.wlevels, lay.dual)
            assert np.array_equal(pt.infill_weights(bw, bh, lay.gw, lay.gh),
                                  jastc.infill_weights(bw, bh, lay.gw, lay.gh))
            pg, jg = pt._prepared_grid(bw, bh, lay.gw, lay.gh), jp._prepared_grid(bw, bh, lay.gw, lay.gh)
            assert (pg is None) == (jg is None) == (lay.gw == bw and lay.gh == bh)
            for a, b in zip(pg or (), jg or ()):
                assert a.dtype == b.dtype == np.float32
                assert np.array_equal(a.view(np.uint32), b.view(np.uint32))


@pytest.mark.parametrize("size", SIZES, ids=_size_id)
def test_plans_and_task_lists_equal_reference(size):
    bw, bh = size
    for q in range(5):
        assert pt.plan_for(q, bw, bh) == jastc.plan_for(q, bw, bh)
        for gray in (False, True):
            for alpha in (False, True):
                pa, pg = pt._tasks_a(bw, bh, q, gray, alpha)
                ja, jg = jp._tasks_a(bw, bh, q, gray, alpha)
                assert [(_lay(l), c) for l, c in pa] == [(_lay(l), c) for l, c in ja]
                assert [(_lay(l), c) for l, c in pg] == [(_lay(l), c) for l, c in jg]
            assert [_lay(l) for l in pt._layouts_b(bw, bh, q, gray)] == \
                [_lay(l) for l in jp._layouts_b(bw, bh, q, gray)]
    assert [_lay(l) for l in pt._layouts_d(bw, bh)] == [_lay(l) for l in jp._layouts_d(bw, bh)]


def test_plan_table_and_gray_spread_equal_reference():
    assert pt._PLAN == jastc._PLAN
    assert pt.GRAY_SPREAD == jastc.GRAY_SPREAD


def test_content_scans_equal_reference():
    rng = np.random.default_rng(4)
    b = rng.random((32, 16, 4)).astype(np.float32)
    b[..., 3] = 1.0
    cases = [b.copy()]
    g = b.copy()
    g[3, :, 1] = g[3, :, 0]
    g[3, :, 2] = np.clip(g[3, :, 0] + np.float32(15.9 / 255), 0, 1)
    cases.append(g)
    a = b.copy()
    a[7, 5, 3] = np.float32(254.4 / 255)
    cases.append(a)
    a2 = b.copy()
    a2[7, 5, 3] = np.float32(254.6 / 255)
    cases.append(a2)
    for x in cases:
        assert pt.has_gray_blocks(x) == jastc.has_gray_blocks(x)
        assert pt.has_alpha_blocks(x) == jastc.has_alpha_blocks(x)
    assert [pt.has_gray_blocks(x) for x in cases] == [False, True, False, False]
    assert [pt.has_alpha_blocks(x) for x in cases] == [False, False, True, False]


def _code(obj):
    """The code of a function or class without docstrings or imports (the
    original imports ``infill_weights`` from the module the port's copy
    lives in)."""
    tree = ast.parse(textwrap.dedent(inspect.getsource(obj)))
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)) and body:
            if isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant):
                body = body[1:]
            node.body = [s for s in body if not isinstance(s, (ast.Import, ast.ImportFrom))]
    return ast.dump(tree)


_COPIED = [
    "implied_color_range", "infill_weights", "block_mode_field", "Layout", "_try_layout",
    "layout_menu", "_color_qlut", "_weight_qlut", "_weight_neighbors", "has_gray_blocks",
    "has_alpha_blocks", "plan_for", "_prepared_grid", "_tasks_a", "_layouts_b", "_layouts_d",
    "hdr_layout_menu", "_prepared_np",
]


@pytest.mark.parametrize("name", _COPIED)
def test_table_code_is_the_original(name):
    mine = getattr(pt, name)
    ref = getattr(jp if hasattr(jp, name) and not hasattr(jastc, name) else jastc, name)
    mine = getattr(mine, "__wrapped__", mine)
    ref = getattr(ref, "__wrapped__", ref)
    assert _code(mine) == _code(ref)


def test_no_table_function_left_out():
    defined = {n for n, v in vars(pt).items()
               if (inspect.isfunction(v) or inspect.isclass(v) or hasattr(v, "__wrapped__"))
               and getattr(v, "__module__", "") == pt.__name__}
    assert defined == set(_COPIED)

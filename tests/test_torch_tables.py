"""The port's BC7, BC6H, ETC/EAC and ASTC tables and constant operands
equal the reference's."""

import numpy as np
import pytest
import torch

from cuttlefish_tpu.kernels import bc7_tables as REF
from cuttlefish_tpu_torch.kernels import bc7_tables as PORT
from cuttlefish_tpu_torch.kernels.bc7 import bc7_constants, channel_weights

_TABLES = [
    "PARTITION2", "ANCHOR2", "WEIGHTS2", "WEIGHTS3", "WEIGHTS4",
    "PARTITION3", "ANCHOR3_2", "ANCHOR3_3",
]


@pytest.mark.parametrize("name", _TABLES)
def test_table_equals_reference(name):
    port, ref = getattr(PORT, name), getattr(REF, name)
    assert port.dtype == ref.dtype and port.shape == ref.shape
    assert np.array_equal(port, ref)


def test_no_table_left_out():
    ref = {k for k, v in vars(REF).items() if isinstance(v, np.ndarray)}
    assert ref == set(_TABLES)


@pytest.mark.parametrize("perceptual", [False, True])
def test_bc7_constants_match_pallas_operands(perceptual):
    """bc7_constants carries the operands bc7_pallas.py:1178-1192 builds:
    part2 = PARTITION2 as f32, anchors = ANCHOR2, chw as f32; the kernel's
    uint16 masks hold the same membership bit for bit."""
    chw = (0.55, 1.1, 0.35, 1.0) if perceptual else (1.0, 1.0, 1.0, 1.0)
    c = bc7_constants(REF.PARTITION2, REF.ANCHOR2, chw, torch.device("cpu"))
    assert c.part2.dtype == torch.float32
    assert np.array_equal(c.part2.numpy(), REF.PARTITION2.astype(np.float32))
    assert np.array_equal(c.anchor2.numpy(), REF.ANCHOR2)
    assert np.array_equal(c.anchors, REF.ANCHOR2)
    assert c.masks.dtype == np.uint16 and c.masks.shape == (64,)
    bits = (c.masks[:, None].astype(np.int64) >> np.arange(16)) & 1
    assert np.array_equal(bits, REF.PARTITION2)
    assert np.array_equal(np.float32(c.chw), np.float32(chw))
    assert np.array_equal(np.float32(channel_weights(perceptual)), np.float32(chw))
    # Texel 0 is in subset 0 and every anchor in subset 1, which the
    # kernel's index packing relies on.
    assert not (c.masks & 1).any()
    assert all((int(m) >> int(a)) & 1 for m, a in zip(c.masks, c.anchors))


@pytest.mark.parametrize("name", ["_BC1_4C_W", "_BC1_3C_W", "_BC4_8V_W", "_BC4_6V_W", "_LS_ITERS"])
def test_bc_tables_equal_pallas_kernel(name):
    """The port's BC1-BC5 weight tables and quality ladder are the Pallas
    kernel's (bc_pallas.py:27-32), value for value."""
    from cuttlefish_tpu.kernels import bc_pallas
    from cuttlefish_tpu_torch.kernels import bc

    assert getattr(bc, name) == getattr(bc_pallas, name)


@pytest.mark.parametrize("name", ["TWO_REGION_MODES", "TWO_REGION_LAYOUT"])
def test_bc6h_table_equals_reference(name):
    from cuttlefish_tpu.kernels import bc6h_tables as ref
    from cuttlefish_tpu_torch.kernels import bc6h_tables as port

    assert getattr(port, name) == getattr(ref, name)


def test_no_bc6h_table_left_out():
    from cuttlefish_tpu.kernels import bc6h_tables as ref
    from cuttlefish_tpu_torch.kernels import bc6h_tables as port

    tables = lambda m: {k for k in vars(m) if k.isupper()}  # noqa: E731
    assert tables(port) == tables(ref) == {"TWO_REGION_MODES", "TWO_REGION_LAYOUT"}


@pytest.mark.parametrize("name", ["_BC6H_ITERS", "_TWO_REGION_PLAN", "_PART_SEEDS"])
def test_bc6h_plans_equal_reference(name):
    """The quality plans the TPU kernel imports (bc6h.py:444-462)."""
    from cuttlefish_tpu.kernels import bc6h as ref
    from cuttlefish_tpu_torch.kernels import bc6h as port

    assert getattr(port, name) == getattr(ref, name)


def test_bc7_hq_plan_equals_pallas_kernel():
    from cuttlefish_tpu.kernels import bc7_pallas
    from cuttlefish_tpu_torch.kernels import bc7

    assert bc7._HQ_PLAN == bc7_pallas._HQ_PLAN


def test_bc6h_layout_table_round_trips():
    """The hand kernel's flat constant tables hold every mode's bits and
    every layout entry of TWO_REGION_LAYOUT, in order, then -1."""
    from cuttlefish_tpu.kernels.bc6h_tables import TWO_REGION_LAYOUT, TWO_REGION_MODES
    from cuttlefish_tpu_torch.kernels.bc6h import layout_table

    modes, layout = layout_table()
    assert modes.dtype == layout.dtype == np.int32
    assert modes.shape == (10, 6) and layout.shape == (10, 76)
    names = ["rw", "rx", "ry", "rz"]
    for m in range(1, 11):
        mv, _, epbits, dbits, direct = TWO_REGION_MODES[m]
        assert tuple(modes[m - 1]) == (mv, epbits, *dbits, int(direct))
        entries = [e for e in layout[m - 1] if e >= 0]
        assert all(e < 0 for e in layout[m - 1][len(entries):])
        decoded = [(e & 0xFF, names[(e >> 8) & 3], (e >> 12) & 15, (e >> 16) & 3) for e in entries]
        assert decoded == list(TWO_REGION_LAYOUT[m])


@pytest.mark.parametrize("perceptual", [False, True])
def test_bc7_constants_carry_the_3_subset_operands(perceptual):
    """The 3-subset masks and anchors the high-quality kernel takes
    (bc7_pallas.py:1216-1219): one membership per subset, every texel in
    exactly one subset, texel 0 in subset 0, each anchor in its subset."""
    chw = (0.55, 1.1, 0.35, 1.0) if perceptual else (1.0, 1.0, 1.0, 1.0)
    c = bc7_constants(REF.PARTITION2, REF.ANCHOR2, chw, torch.device("cpu"))
    for s in range(3):
        assert np.array_equal(c.part3[s].numpy(), (REF.PARTITION3 == s).astype(np.float32))
        bits = (c.masks3[:, s, None].astype(np.int64) >> np.arange(16)) & 1
        assert np.array_equal(bits, (REF.PARTITION3 == s).astype(np.int64))
    assert np.array_equal(c.anchors3, np.stack([REF.ANCHOR3_2, REF.ANCHOR3_3], axis=1))
    assert np.array_equal(c.anchor3.numpy(), np.stack([REF.ANCHOR3_2, REF.ANCHOR3_3]))
    assert np.all(c.masks3.astype(np.int64).sum(axis=1) == 0xFFFF)
    assert np.all(c.masks3[:, 0] & 1)
    for s in (1, 2):
        assert all((int(m) >> int(a)) & 1 for m, a in zip(c.masks3[:, s], c.anchors3[:, s - 1]))


_ETC_TABLES = [
    "_ETC1_MODS_NP", "_EAC_MODS_NP", "_COLMAJOR_NP", "_RASTER_OF_P_NP", "_ETC2_DIST_NP",
    "_ETC_A1_MODS_NP",
]


@pytest.mark.parametrize("name", _ETC_TABLES)
def test_etc_table_equals_reference(name):
    """The ETC/EAC spec tables the TPU kernels, the punch-through encoder
    and the decoders read (kernels/etc.py:35-77, :114, :374), dtype and
    value."""
    from cuttlefish_tpu.kernels import etc as ref
    from cuttlefish_tpu_torch.kernels import etc_tables as port

    a, b = getattr(port, name), getattr(ref, name)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b)


@pytest.mark.parametrize("name", ["_EAC_MULT_CANDS", "_ETC_OFFSETS"])
def test_etc_quality_ladder_equals_reference(name):
    from cuttlefish_tpu.kernels import etc as ref
    from cuttlefish_tpu_torch.kernels import etc_tables as port

    assert getattr(port, name) == getattr(ref, name)
    assert port._offset_cube(-1, 1) == ref._offset_cube(-1, 1)


def test_etc_planar_projection_equals_pallas_kernel():
    """The float64 projection of etc_pallas.py:_planar_proj, which the
    plain version multiplies by."""
    from cuttlefish_tpu.kernels import etc_pallas
    from cuttlefish_tpu_torch.kernels import etc

    assert np.array_equal(etc._planar_proj(), etc_pallas._planar_proj())


def test_a1_planar_projection_equals_jnp_path():
    """The float32 projection the jnp path's _planar_candidate computes
    under jit (kernels/etc.py:246-252), which the punch-through encoder
    multiplies by."""
    import jax
    import jax.numpy as jnp

    from cuttlefish_tpu.kernels import etc as ref
    from cuttlefish_tpu_torch.kernels import etc_tables as port

    def proj():
        x = ref._PLANAR_XW / 4.0
        y = ref._PLANAR_YW / 4.0
        basis = jnp.stack([(1.0 - x - y)[0], x[0], y[0]], axis=0)
        return jnp.linalg.inv(basis @ basis.T) @ basis

    want = np.asarray(jax.jit(proj)())
    assert port._A1_PLANAR_PROJ_NP.dtype == want.dtype == np.float32
    assert np.array_equal(port._A1_PLANAR_PROJ_NP, want)


def test_etc_kernel_tables_equal_reference():
    """The constant tables written into csrc/etc_encode.cu hold the spec
    tables' values: ETC1 and EAC modifiers, the EAC multiplier seed's
    factors, T/H distances, EAC multiplier candidates, and the planar
    projection rounded once to float32."""
    from pathlib import Path

    from cuttlefish_tpu.kernels import etc as ref
    from cuttlefish_tpu.kernels import etc_pallas

    src = (Path(__file__).resolve().parent.parent / "cuttlefish_tpu_torch/csrc/etc_encode.cu").read_text()

    def table(name, kind="int", parse=int):
        body = src.split(f"__constant__ {kind} {name}")[1].split("};")[0].split("= {", 1)[1]
        return [parse(v) for v in body.replace("{", " ").replace("}", " ").replace(",", " ").split()]

    assert table("c_etc1_mods") == ref._ETC1_MODS_NP.reshape(-1).tolist()
    assert table("c_eac_mods", "float") == ref._EAC_MODS_NP.reshape(-1).tolist()
    assert table("c_dist") == ref._ETC2_DIST_NP.tolist()
    assert table("c_eac_ncand") == [ref._EAC_MULT_CANDS[q] for q in range(5)]
    proj = table("c_planar_proj", "float", lambda v: float.fromhex(v.rstrip("f")))
    assert proj == etc_pallas._planar_proj().astype(np.float32).reshape(-1).tolist()
    # The multiplier seed's factors are float32(1) / each table's largest
    # positive modifier (column 7).
    inv = src.split("__constant__ float c_eac_inv")[1].split("};")[0].split("= {", 1)[1]
    denominators = [int(v.split("/")[1]) for v in inv.split(",") if v.strip()]
    assert denominators == ref._EAC_MODS_NP[:, 7].tolist()
    assert np.array_equal(ref._EAC_MODS_NP[:, 7], ref._EAC_MODS_NP[:, 4:].max(1))


def _astc_src():
    from pathlib import Path

    return (Path(__file__).resolve().parent.parent / "cuttlefish_tpu_torch/csrc/astc_encode.cu").read_text()


def test_astc_kernel_constant_tables_equal_reference():
    """csrc/astc_encode.cu's __constant__ trit/quint slots are the ISE bit
    layout of the reference (astc_ise.py:_TRIT_SLOTS, _QUINT_SLOTS), and
    its descriptor field enums name the wrapper's fields in its order."""
    from cuttlefish_tpu.kernels import astc_ise as ref
    from cuttlefish_tpu_torch.kernels import astc_cuda

    src = _astc_src()

    def table(name):
        body = src.split(f"__constant__ int {name}")[1].split("};")[0].split("= {", 1)[1]
        return [int(v) for v in body.replace(",", " ").split()]

    assert list(zip(table("c_trit_lo"), table("c_trit_w"))) == list(ref._TRIT_SLOTS)
    assert list(zip(table("c_quint_lo"), table("c_quint_w"))) == list(ref._QUINT_SLOTS)

    def enum(name, prefix):
        body = src.split(f"enum {name} {{")[1].split("};")[0]
        return [v.strip()[len(prefix):] for v in body.replace("\n", " ").split(",") if v.strip()]

    assert enum("Hdr", "H_") == list(astc_cuda.HDR)
    assert enum("LayF", "L_") == list(astc_cuda.LAY)


_ASTC_DESC_CASES = [(4, 4, 4, True, True), (4, 4, 2, False, False), (6, 6, 3, True, False),
                    (8, 8, 4, True, True), (10, 5, 1, False, True), (12, 12, 4, True, True)]


@pytest.mark.parametrize("case", _ASTC_DESC_CASES, ids=lambda c: "{}x{}_q{}_g{:d}a{:d}".format(*c))
def test_astc_descriptor_holds_reference_tables(case):
    """The descriptor that the ASTC kernel loops over (astc_cuda.descriptor)
    holds the JAX package's plan, its kernels' task lists (layout fields,
    ISE ranges, block modes), the colour and weight LUTs, each decimated
    grid's pseudo-inverse (float32 bits) and its infill as the non-zero
    terms of each texel's row (whose support is the reference footprint),
    the partition patterns as texel bitmasks with their seeds, and the
    trit and quint pack tables."""
    from cuttlefish_tpu.kernels import astc as jastc
    from cuttlefish_tpu.kernels import astc_ise as jise
    from cuttlefish_tpu.kernels import astc_pallas as jp
    from cuttlefish_tpu.kernels.astc_partition import partition_table, unique_partition_seeds
    from cuttlefish_tpu_torch.kernels import astc, astc_cuda

    bw, bh, q, gray, alpha = case
    d = astc_cuda.descriptor(bw, bh, q, gray, alpha)
    assert d.dtype == np.int32
    H, L = astc_cuda.H, astc_cuda.L
    t = bw * bh
    plan = jastc.plan_for(q, bw, bh)
    assert (d[H["T"]], d[H["BW"]], d[H["BH"]]) == (t, bw, bh)
    assert d[H["ITERS"]] == plan["iters"] and d[H["ITERS12"]] == plan.get("iters12", plan["iters"])
    assert d[H["P2ITERS"]] == plan.get("p2_iters", plan["iters"])
    assert d[H["TOPK2"]] == max(1, plan["seeds2"]) and d[H["TOPK4"]] == max(1, plan["seeds4"])
    assert np.float32(jastc.GRAY_SPREAD * 255.0).view(np.int32) == d[H["GRAY255"]]
    kinds = {"b": 0, "t": 1, "q": 2}

    def check_layout(off, lay):
        r = d[off:off + len(astc_cuda.LAY)]
        assert (r[L["NPARTS"]], r[L["CEM"]], r[L["GW"]], r[L["GH"]], r[L["G"]]) == (
            lay.nparts, lay.cem, lay.gw, lay.gh, lay.gw * lay.gh)
        assert (r[L["WLEVELS"]], r[L["CLEVELS"]], r[L["DUAL"]], r[L["WBITS"]], r[L["HEADER"]]) == (
            lay.wlevels, lay.clevels, int(lay.dual), lay.wbits, lay.header)
        assert r[L["MODE"]] == jastc.block_mode_field(lay.gw, lay.gh, lay.wlevels, lay.dual)
        ck, cb = jise.range_info(lay.clevels, False)
        wk, wb = jise.range_info(lay.wlevels, True)
        assert (r[L["CKIND"]], r[L["CB"]], r[L["WKIND"]], r[L["WB"]]) == (kinds[ck], cb, kinds[wk], wb)
        if lay.clevels != 256:
            cq, cd = jastc._color_qlut(lay.clevels)
            assert np.array_equal(d[r[L["OFF_CQ"]]:r[L["OFF_CQ"]] + 256], cq)
            assert np.array_equal(d[r[L["OFF_CD"]]:r[L["OFF_CD"]] + 256], cd)
        wl = lay.wlevels
        assert np.array_equal(d[r[L["OFF_UNQ"]]:r[L["OFF_UNQ"]] + wl], jise.weight_unquant(wl))
        up, dn = jastc._weight_neighbors(wl)
        assert np.array_equal(d[r[L["OFF_UP"]]:r[L["OFF_UP"]] + wl], up)
        assert np.array_equal(d[r[L["OFF_DN"]]:r[L["OFF_DN"]] + wl], dn)
        wq, wu = jastc._weight_qlut(wl)
        assert np.array_equal(d[r[L["OFF_WQ"]]:r[L["OFF_WQ"]] + 65], wq)
        assert np.array_equal(d[r[L["OFF_WU"]]:r[L["OFF_WU"]] + 65], wu)
        grid = jp._prepared_grid(bw, bh, lay.gw, lay.gh)
        assert (r[L["OFF_GRID"]] < 0) == (grid is None)
        if grid is not None:
            g, off = lay.gw * lay.gh, r[L["OFF_GRID"]]
            a, pinv, foot = grid
            assert np.array_equal(d[off:off + t * g], pinv.reshape(-1).view(np.int32))
            terms = d[off + t * g:off + t * g + 4 * t].reshape(t, 4)
            dense = np.zeros((t, g), np.int64)
            for k in range(4):  # j | weight << 8, weight 0 for none
                np.add.at(dense, (np.arange(t), terms[:, k] & 0xFF), terms[:, k] >> 8)
            assert np.array_equal(dense, a.astype(np.int64))
            assert np.array_equal(np.asarray(foot) > 0, (a > 0).T)

    base, gray_t = jp._tasks_a(bw, bh, q, gray, alpha)
    for key_n, key_off, tasks in (("NA", "OFF_A", base), ("NAG", "OFF_AG", gray_t)):
        assert d[H[key_n]] == len(tasks)
        for k, (lay, ccs) in enumerate(tasks):
            off, c = d[d[H[key_off]] + 2 * k], d[d[H[key_off]] + 2 * k + 1]
            assert c == (-1 if ccs is None else ccs)
            check_layout(off, lay)
    menu = jastc.layout_menu(bw, bh)
    for key_n, key_off, lays in (("NB", "OFF_B", jp._layouts_b(bw, bh, q, alpha)),
                                 ("NC", "OFF_C", menu[(8, 3)][:1]), ("ND", "OFF_D", jp._layouts_d(bw, bh))):
        assert d[H[key_n]] == len(lays)
        for k, lay in enumerate(lays):
            check_layout(d[d[H[key_off]] + k], lay)
    nw = (t + 31) // 32
    assert d[H["NW"]] == nw

    def bits(off, rows, parts):
        m = d[off:off + rows * parts * nw].view(np.uint32).reshape(rows, parts, nw)
        tt = np.arange(t)
        return (m[:, :, tt // 32] >> (tt % 32).astype(np.uint32)) & 1  # [rows, parts, T]

    st = astc.stages(bw, bh, q, gray, alpha)
    if "b" in st:
        us = unique_partition_seeds(bw, bh, 2)
        assert d[H["U2"]] == len(us)
        assert np.array_equal(d[d[H["OFF_S2"]]:d[H["OFF_S2"]] + len(us)], us)
        assert np.array_equal(bits(d[H["OFF_P2"]], len(us), 1)[:, 0], partition_table(bw, bh, 2)[us] == 1)
    if "c" in st:
        us = unique_partition_seeds(bw, bh, 3)
        assert d[H["U3"]] == len(us)
        assert np.array_equal(d[d[H["OFF_S3"]]:d[H["OFF_S3"]] + len(us)], us)
        m = bits(d[H["OFF_P3"]], len(us), 2)
        tab = partition_table(bw, bh, 3)[us]
        assert np.array_equal(m[:, 0], tab == 1) and np.array_equal(m[:, 1], tab == 2)
    if "d" in st:
        m = bits(d[H["OFF_P4"]], 1024, 3)
        tab = partition_table(bw, bh, 4)
        for j in range(3):
            assert np.array_equal(m[:, j], tab == j + 1)
    trit, quint = jise.trit_pack_table().reshape(-1), jise.quint_pack_table().reshape(-1)
    assert np.array_equal(d[d[H["OFF_TRIT"]]:d[H["OFF_TRIT"]] + trit.size], trit)
    assert np.array_equal(d[d[H["OFF_QUINT"]]:d[H["OFF_QUINT"]] + quint.size], quint)


_PVRTC_SIZES = [(2, 2), (4, 4), (8, 2), (2, 8), (16, 4), (32, 32)]


@pytest.mark.parametrize("nbx,nby", _PVRTC_SIZES)
def test_pvrtc_tables_equal_reference(nbx, nby):
    """morton_order, _MOD_W_4BPP and the owner and basis matrices of
    kernels/pvrtc_tables.py are the JAX package's kernels/pvrtc.py ones,
    for both block shapes and both border modes."""
    from cuttlefish_tpu.kernels import pvrtc as ref
    from cuttlefish_tpu_torch.kernels import pvrtc_tables as port

    assert port._MOD_W_4BPP.dtype == ref._MOD_W_4BPP.dtype
    assert np.array_equal(port._MOD_W_4BPP, ref._MOD_W_4BPP)
    assert np.array_equal(port.morton_order(nbx, nby), ref.morton_order(nbx, nby))
    for block, n in ((4, nby), (8, nbx), (4, nbx)):
        a, b = port._owner_matrix(n * block, block, n), ref._owner_matrix(n * block, block, n)
        assert a.dtype == b.dtype and np.array_equal(a, b)
        for wrap in (True, False):
            a = port._basis_matrix(n * block, block, n, wrap)
            b = ref._basis_matrix(n * block, block, n, wrap)
            assert a.dtype == b.dtype and np.array_equal(a, b)


def test_pvrtc_taps_hold_the_basis():
    """The upscale's row taps and the adjoint's column taps
    (kernels/pvrtc.py:_Taps) hold every nonzero of the basis matrices."""
    from cuttlefish_tpu_torch.kernels import pvrtc
    from cuttlefish_tpu_torch.kernels.pvrtc_tables import _basis_matrix, _owner_matrix

    for kind, block, n, wrap, lanes in (("basis", 4, 8, True, 1), ("basis", 8, 4, False, 1),
                                        ("owner", 4, 8, False, 4), ("owner", 8, 2, False, 4)):
        taps = pvrtc._taps(kind, n * block, block, n, wrap, "cpu", lanes)
        m = (_basis_matrix(n * block, block, n, wrap) if kind == "basis"
             else _owner_matrix(n * block, block, n).T)
        rows = np.zeros_like(m)
        for k in range(2):
            np.add.at(rows, (np.arange(m.shape[0]), taps.ridx[k].numpy()), taps.rw[k].numpy())
        assert np.array_equal(rows, m)
        cols = np.zeros_like(m)
        cidx, cw = taps.cidx.numpy(), taps.cw.numpy()
        for lane in range(lanes):
            for k in range(cidx.shape[1]):
                np.add.at(cols, (cidx[lane, k], np.arange(m.shape[1])), cw[lane, k])
                assert np.all(cw[lane, k] == 0) or np.all(cidx[lane, k][cw[lane, k] != 0] % lanes == lane)
        assert np.array_equal(cols, m)


_ASTC_BLOCKS = [(4, 4), (5, 4), (5, 5), (6, 5), (6, 6), (8, 5), (8, 6), (8, 8), (10, 5),
                (10, 6), (10, 8), (10, 10), (12, 10), (12, 12)]


@pytest.mark.parametrize("bw,bh", _ASTC_BLOCKS, ids=lambda v: str(v))
def test_hdr_layout_menu_equals_reference(bw, bh):
    """hdr_layout_menu (every block size, its CEM 11 and CEM 14 layouts) and
    the HDR grid's infill and pseudo-inverse (_prepared_np) are the JAX
    package's kernels/astc.py ones."""
    from cuttlefish_tpu.kernels import astc as ref
    from cuttlefish_tpu_torch.kernels import astc_tables as port

    a, b = port.hdr_layout_menu(bw, bh), ref.hdr_layout_menu(bw, bh)
    assert set(a) == set(b) == {11, 14}
    for cem in (11, 14):
        if b[cem] is None:
            assert a[cem] is None
            continue
        assert repr(a[cem]) == repr(b[cem])
        assert vars(a[cem]) == vars(b[cem])
        lay = a[cem]
        for x, y in zip(port._prepared_np(bw, bh, lay.gw, lay.gh),
                        ref._prepared_np(bw, bh, lay.gw, lay.gh)):
            assert x.dtype == y.dtype and np.array_equal(x, y)

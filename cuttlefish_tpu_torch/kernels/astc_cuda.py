"""ctypes wrapper of the hand-written ASTC LDR kernels (``csrc/astc_encode.cu``).

Pallas unrolls a Python loop over static ``Layout`` objects; the CUDA kernel
loops over a descriptor table instead.  ``descriptor`` builds that table on
the host, one int32 array per (block size, quality, gray, alpha): a header
of the plan's depths and of offsets, one record per layout (its fields,
ISE ranges and the offsets of its quantisation tables), the task lists of
the four kernels, the colour and weight LUTs, the trit/quint pack tables,
each decimated grid's pseudo-inverse (float32 bits) and the non-zero
terms of its C.2.18 infill (at most four a texel; a grid point's
footprint is the texels whose terms name it), and the partition patterns
as texel bitmasks (distinct 2- and 3-partition patterns with their seed
ids, all 1024 4-partition seeds).
It is uploaded once per device and configuration.

Four entries, one per TPU kernel: ``astc_a`` .. ``astc_d``.  Each checks
device, dtype, shape and contiguity, allocates its outputs with
``torch.empty``, launches on the current stream, raises on a non-zero
launch status and counts its launches in ``launches``.  The launcher also
reads the host copy of the descriptor's header: it picks the template
instance of the block's texel class, the group size and the dynamic shared
memory (``astc_a``: a CTA per 32 blocks, a warp per task; ``astc_b``,
``astc_c`` and ``astc_d``: a warp per group of blocks).  ``astc_b`` runs a
thread per block at 4x4 and a warp per group above, where it keeps its
blocks' texels in a device scratch tensor that the wrapper allocates.
``encode_astc_cuda`` runs the entries that ``encode_astc_pallas`` runs and
merges their words as it does.  The library is built on first use
(``kernels/_build.py``).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from cuttlefish_tpu_torch.kernels import _build
from cuttlefish_tpu_torch.kernels.astc import _GRAY_255, merge_stage, stages
from cuttlefish_tpu_torch.kernels.astc_ise import (
    quint_pack_table,
    range_info,
    trit_pack_table,
    weight_unquant,
)
from cuttlefish_tpu_torch.kernels.astc_partition import (
    partition_table,
    unique_partition_seeds,
)
from cuttlefish_tpu_torch.kernels.astc_tables import (
    _color_qlut,
    _layouts_b,
    _layouts_d,
    _prepared_grid,
    _tasks_a,
    _weight_neighbors,
    _weight_qlut,
    block_mode_field,
    layout_menu,
    plan_for,
)

launches = {"astc_a": 0, "astc_b": 0, "astc_c": 0, "astc_d": 0}

_bound = False
_P = ctypes.c_void_p
_I = ctypes.c_int

# Header fields of the descriptor (csrc/astc_encode.cu: enum Hdr).
HDR = (
    "T", "BW", "BH", "ITERS", "ITERS12", "P2ITERS", "TOPK2", "KEEP2", "TOPK3", "KEEP3",
    "TOPK4", "GRAY255", "NA", "OFF_A", "NAG", "OFF_AG", "NB", "OFF_B", "NC", "OFF_C", "ND",
    "OFF_D", "NW", "U2", "OFF_P2", "OFF_S2", "U3", "OFF_P3", "OFF_S3", "OFF_P4", "OFF_TRIT",
    "OFF_QUINT",
)
H = {name: i for i, name in enumerate(HDR)}
# Fields of a layout record (enum Lay).
LAY = (
    "NPARTS", "CEM", "GW", "GH", "G", "WLEVELS", "CLEVELS", "DUAL", "WBITS", "HEADER", "MODE",
    "CKIND", "CB", "WKIND", "WB", "OFF_CQ", "OFF_CD", "OFF_UNQ", "OFF_UP", "OFF_DN", "OFF_WQ",
    "OFF_WU", "OFF_GRID",
)
L = {name: i for i, name in enumerate(LAY)}
_KIND = {"b": 0, "t": 1, "q": 2}


def _f32_bits(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x, np.float32)).view(np.int32).reshape(-1)


def _masks(rows: np.ndarray, parts, nw: int) -> np.ndarray:
    """[R,T] partition ids -> [R, len(parts), nw] int32 texel bitmasks."""
    r, t_count = rows.shape
    out = np.zeros((r, len(parts), nw), np.uint32)
    for k, j in enumerate(parts):
        for t in range(t_count):
            out[:, k, t // 32] |= (rows[:, t] == j).astype(np.uint32) << np.uint32(t % 32)
    return out.view(np.int32)


def _infill_terms(a: np.ndarray) -> np.ndarray:
    """[T,G] infill weights (16ths) -> [T,4] int32 non-zero terms of each
    row, ``j | weight << 8`` in ascending j, padded with 0 (weight 0)."""
    out = np.zeros((a.shape[0], 4), np.int32)
    for t, row in enumerate(a.astype(np.int64)):
        nz = np.nonzero(row)[0]
        if len(nz) > 4 or a.shape[1] > 256:
            raise ValueError("an infill row has more than 4 terms or the grid 256 points")
        out[t, :len(nz)] = nz | (row[nz] << 8)
    return out


@functools.lru_cache(maxsize=None)
def descriptor(bw: int, bh: int, quality: int, gray: bool, alpha: bool) -> np.ndarray:
    """The kernel's int32 descriptor table (see the module docstring)."""
    t_count = bw * bh
    plan = plan_for(quality, bw, bh)
    blob: list[int] = [0] * len(HDR)
    hdr = blob  # the header is the blob's head

    def put(values) -> int:
        off = len(blob)
        blob.extend(int(v) for v in np.asarray(values).reshape(-1))
        return off

    tables: dict = {}

    def table(key, make):
        if key not in tables:
            tables[key] = put(make())
        return tables[key]

    grids: dict = {}

    def grid_off(lay) -> int:
        key = (lay.gw, lay.gh)
        prep = _prepared_grid(bw, bh, lay.gw, lay.gh)
        if prep is None:
            return -1
        if key not in grids:
            a, pinv, _ = prep
            off = put(_f32_bits(pinv))
            put(_infill_terms(a))
            grids[key] = off
        return grids[key]

    lays: dict = {}

    def lay_off(lay) -> int:
        key = (lay.nparts, lay.cem, lay.gw, lay.gh, lay.wlevels, lay.dual)
        if key in lays:
            return lays[key]
        ckind, cb = range_info(lay.clevels, False)
        wkind, wb = range_info(lay.wlevels, True)
        rec = [0] * len(LAY)
        rec[L["NPARTS"]], rec[L["CEM"]] = lay.nparts, lay.cem
        rec[L["GW"]], rec[L["GH"]], rec[L["G"]] = lay.gw, lay.gh, lay.gw * lay.gh
        rec[L["WLEVELS"]], rec[L["CLEVELS"]] = lay.wlevels, lay.clevels
        rec[L["DUAL"]], rec[L["WBITS"]], rec[L["HEADER"]] = int(lay.dual), lay.wbits, lay.header
        rec[L["MODE"]] = block_mode_field(lay.gw, lay.gh, lay.wlevels, lay.dual)
        rec[L["CKIND"]], rec[L["CB"]] = _KIND[ckind], cb
        rec[L["WKIND"]], rec[L["WB"]] = _KIND[wkind], wb
        if lay.clevels == 256:
            rec[L["OFF_CQ"]] = rec[L["OFF_CD"]] = -1
        else:
            rec[L["OFF_CQ"]] = table(("cq", lay.clevels), lambda: _color_qlut(lay.clevels)[0])
            rec[L["OFF_CD"]] = table(("cd", lay.clevels), lambda: _color_qlut(lay.clevels)[1])
        wl = lay.wlevels
        rec[L["OFF_UNQ"]] = table(("unq", wl), lambda: weight_unquant(wl))
        rec[L["OFF_UP"]] = table(("up", wl), lambda: _weight_neighbors(wl)[0])
        rec[L["OFF_DN"]] = table(("dn", wl), lambda: _weight_neighbors(wl)[1])
        rec[L["OFF_WQ"]] = table(("wq", wl), lambda: _weight_qlut(wl)[0])
        rec[L["OFF_WU"]] = table(("wu", wl), lambda: _weight_qlut(wl)[1])
        rec[L["OFF_GRID"]] = grid_off(lay)
        lays[key] = put(rec)
        return lays[key]

    hdr[H["T"]], hdr[H["BW"]], hdr[H["BH"]] = t_count, bw, bh
    hdr[H["ITERS"]] = plan["iters"]
    hdr[H["ITERS12"]] = plan.get("iters12", plan["iters"])
    hdr[H["P2ITERS"]] = plan.get("p2_iters", plan["iters"])
    topk2 = max(1, plan["seeds2"])
    topk3 = max(1, plan["seeds3"])
    hdr[H["TOPK2"]], hdr[H["KEEP2"]] = topk2, min(max(1, plan.get("keep2", 1)), topk2)
    hdr[H["TOPK3"]], hdr[H["KEEP3"]] = topk3, min(max(1, plan.get("keep3", 1)), topk3)
    hdr[H["TOPK4"]] = max(1, plan["seeds4"])
    hdr[H["GRAY255"]] = int(_f32_bits(_GRAY_255)[0])
    base, gray_tasks = _tasks_a(bw, bh, quality, gray, alpha)
    tasks_a = [(lay_off(lay), -1 if ccs is None else ccs) for lay, ccs in base]
    tasks_ag = [(lay_off(lay), -1) for lay, _ in gray_tasks]
    lays_b = [lay_off(lay) for lay in _layouts_b(bw, bh, quality, alpha)]
    menu = layout_menu(bw, bh)
    lays_c = [lay_off(menu[(8, 3)][0])] if menu[(8, 3)] else []
    lays_d = [lay_off(lay) for lay in _layouts_d(bw, bh)]
    hdr[H["NA"]], hdr[H["OFF_A"]] = len(tasks_a), put(tasks_a) if tasks_a else -1
    hdr[H["NAG"]], hdr[H["OFF_AG"]] = len(tasks_ag), put(tasks_ag) if tasks_ag else -1
    hdr[H["NB"]], hdr[H["OFF_B"]] = len(lays_b), put(lays_b) if lays_b else -1
    hdr[H["NC"]], hdr[H["OFF_C"]] = len(lays_c), put(lays_c) if lays_c else -1
    hdr[H["ND"]], hdr[H["OFF_D"]] = len(lays_d), put(lays_d) if lays_d else -1
    nw = (t_count + 31) // 32
    hdr[H["NW"]] = nw
    st = stages(bw, bh, quality, gray, alpha)
    if "b" in st:
        us2 = unique_partition_seeds(bw, bh, 2)
        hdr[H["U2"]] = len(us2)
        hdr[H["OFF_P2"]] = put(_masks(partition_table(bw, bh, 2)[us2], (1,), nw))
        hdr[H["OFF_S2"]] = put(us2)
    if "c" in st:
        us3 = unique_partition_seeds(bw, bh, 3)
        hdr[H["U3"]] = len(us3)
        hdr[H["OFF_P3"]] = put(_masks(partition_table(bw, bh, 3)[us3], (1, 2), nw))
        hdr[H["OFF_S3"]] = put(us3)
    if "d" in st:
        hdr[H["OFF_P4"]] = put(_masks(partition_table(bw, bh, 4), (1, 2, 3), nw))
    hdr[H["OFF_TRIT"]] = put(trit_pack_table().reshape(-1))
    hdr[H["OFF_QUINT"]] = put(quint_pack_table().reshape(-1))
    return np.asarray(blob, np.int64).astype(np.int32)


_device_desc: dict = {}


def _desc_on(device, key) -> torch.Tensor:
    k = (str(device), key)
    if k not in _device_desc:
        _device_desc[k] = torch.from_numpy(descriptor(*key)).to(device)
    return _device_desc[k]


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _lib() -> ctypes.CDLL:
    global _bound
    lib = _build.load("astc_encode")
    if not _bound:
        for name in launches:
            fn = getattr(lib, f"{name}_launch")
            fn.argtypes = [_P, _P, _P, _P, _P, _I, _P, _P]
            fn.restype = ctypes.c_int
        lib.astc_warp_plan.argtypes = [_I, _P, _P]
        lib.astc_warp_plan.restype = None
        _bound = True
    return lib


def warp_plan(stage, bw, bh, quality, gray=True, alpha=True) -> dict:
    """How entry ``"a"`` .. ``"d"`` launches for this configuration: blocks
    a warp (``group``; entry A: a CTA), warps a CTA (``warps``), dynamic
    shared memory a CTA (``smem_bytes``), of it the staged pattern masks
    (``mask_bytes``), and the device memory a block takes for its texels
    outside shared memory (``scratch_bytes``, 0 where they stay in shared
    memory); all 0 where the entry runs a thread per block (``"b"`` at
    4x4)."""
    if stage not in ("a", "b", "c", "d"):
        raise ValueError(f"no ASTC entry {stage!r}")
    out = (ctypes.c_int * 5)()
    host = descriptor(int(bw), int(bh), int(quality), bool(gray), bool(alpha))
    _lib().astc_warp_plan("abcd".index(stage), host.ctypes.data, out)
    return {"group": out[0], "smem_bytes": out[1], "mask_bytes": out[2],
            "scratch_bytes": out[3], "warps": out[4]}


def _check(blocks: torch.Tensor, t_count: int) -> None:
    if blocks.device.type != "cuda":
        raise ValueError(f"astc kernel needs a CUDA tensor, got {blocks.device}")
    if blocks.dtype != torch.float32:
        raise TypeError(f"astc kernel needs float32 input, got {blocks.dtype}")
    if blocks.dim() != 3 or blocks.shape[1] != t_count or blocks.shape[2] != 4:
        raise ValueError(f"astc kernel needs [N,{t_count},4], got {tuple(blocks.shape)}")
    if not blocks.is_contiguous():
        raise ValueError("astc kernel needs contiguous input")
    if blocks.shape[0] >= 2**31:
        raise ValueError("astc kernel takes fewer than 2**31 blocks")


def stage_cuda(stage, blocks, bw, bh, quality, gray=True, alpha=True):
    """One entry (``"a"`` .. ``"d"``) on [N, bw*bh, 4] float32 CUDA blocks
    -> ([N,4] uint32 words, [N] float32 error)."""
    bw, bh, quality = int(bw), int(bh), int(quality)
    _check(blocks, bw * bh)
    if not 0 <= quality <= 4:
        raise ValueError(f"astc kernel covers quality 0-4, got {quality}")
    n = blocks.shape[0]
    words = torch.empty((n, 4), dtype=torch.uint32, device=blocks.device)
    err = torch.empty((n,), dtype=torch.float32, device=blocks.device)
    if n == 0:
        return words, err
    key = (bw, bh, quality, bool(gray), bool(alpha))
    desc = _desc_on(blocks.device, key)
    host = descriptor(*key)  # cached: the pointer stays valid
    name = f"astc_{stage}"
    lib = _lib()
    per_block = warp_plan(stage, *key)["scratch_bytes"] if stage == "b" else 0
    scratch = torch.empty((n * per_block,), dtype=torch.uint8, device=blocks.device)
    with torch.cuda.device(blocks.device):
        stream = torch.cuda.current_stream(blocks.device).cuda_stream
        rc = getattr(lib, f"{name}_launch")(
            blocks.data_ptr(), desc.data_ptr(), host.ctypes.data, words.data_ptr(),
            err.data_ptr(), n, stream, scratch.data_ptr()
        )
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")
    launches[name] += 1
    return words, err


def encode_astc_cuda(blocks, bw, bh, quality, gray=True, alpha=True):
    """[N, bw*bh, 4] float32 CUDA blocks (0..1) -> ASTC [N,4] uint32 words:
    the entries of ``stages``, merged as ``encode_astc_pallas`` merges."""
    _check(blocks, int(bw) * int(bh))
    words = err = None
    for stage in stages(int(bw), int(bh), int(quality), gray, alpha):
        sw, se = stage_cuda(stage, blocks, bw, bh, quality, gray, alpha)
        sw = sw.view(torch.int32)  # torch.where has no uint32 kernel
        if words is None:
            words, err = sw, se
        else:
            words, err = merge_stage(stage, words, err, sw, se)
    return words.view(torch.uint32)

"""The ASTC kernel's device code against the plain version on the CPU.

``csrc/astc_encode.cu`` keeps its device functions plain C++ (the kernels
and launchers sit under ``__CUDACC__``), so ``chip_smoke.py`` builds it
with g++ and a counting float type to count the operations of each entry
(``astc_op_counter``).  That build must give the plain version's words, bit
for bit, on every entry: here on seeded blocks at 4x4 q4 (near-gray with
alpha: all four entries) and at 12x12 q2 (decimated grids, Gauss-Seidel).
Entries B, C and D run there as the card runs them, a warp per group of
blocks, with the warp's 32 lanes simulated one after another: their words
and errors must equal the plain version's at 4x4 and 8x8 q4 (block counts
that leave the last group short), on blocks whose screen estimates tie,
and the warp's merged top-k must be the sequential scan's.  B runs the
warp body above 4x4 (its texels in device memory) and a thread per block
at 4x4 (each CTA's 64 blocks staged at an odd stride, as the card stages
them, then its threads one after another): both at the qualities whose
plans differ, and at 4x4 q2 and q4 on near-gray alpha blocks.  Entry A runs as the
card runs it, a CTA per 32 blocks with a warp per task (``FOR_WARPS`` and
``FOR_LANES`` loops here): its words and errors must equal the plain
version's at 4x4, 8x8 and 12x12 on colour and partly near-gray blocks,
with a short last group, and on blocks whose candidates tie.
"""

import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from test_torch_astc import astc_blocks

from cuttlefish_tpu_torch.kernels import _build, astc, astc_tables

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402


@pytest.fixture(scope="module")
def count_ops(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    return chip_smoke.astc_op_counter(str(_build.CSRC), str(tmp_path_factory.mktemp("astc")))


@pytest.mark.parametrize("case", [(4, 4, 4, "gray_alpha", 96), (12, 12, 2, "alpha", 24)],
                         ids=["4x4_q4", "12x12_q2"])
def test_device_code_equals_plain_version(count_ops, case):
    bw, bh, q, kind, n = case
    b = astc_blocks(n, bw * bh, kind, seed=9)
    gray, alpha = astc_tables.has_gray_blocks(b), astc_tables.has_alpha_blocks(b)
    stages = astc.stages(bw, bh, q, gray, alpha)
    assert stages == (["a", "b", "c", "d"] if q == 4 else ["a", "b"])
    for stage in stages:
        ops, words, _ = count_ops(stage, b, bw, bh, q, gray, alpha)
        want = astc.stage_plain(stage, torch.from_numpy(b), bw, bh, q, gray, alpha)[0].numpy()
        assert np.array_equal(words, want), stage
        assert ops > 100 * bw * bh, stage


def _same_as_plain(count_ops, stage, b, bw, bh, q):
    gray, alpha = astc_tables.has_gray_blocks(b), astc_tables.has_alpha_blocks(b)
    assert stage in astc.stages(bw, bh, q, gray, alpha)
    _, words, err = count_ops(stage, b, bw, bh, q, gray, alpha)
    want_w, want_e = astc.stage_plain(stage, torch.from_numpy(b), bw, bh, q, gray, alpha)
    assert np.array_equal(words, want_w.numpy()), stage
    assert np.array_equal(err.view(np.uint32), want_e.numpy().view(np.uint32)), stage


# Near-gray alpha blocks; 37 and 21 blocks leave the last group of the
# warp (B at 8x8: 32 blocks; C: 10 at 4x4, D: 16; 8 at 8x8) short.
@pytest.mark.parametrize("stage", ["b", "c", "d"])
@pytest.mark.parametrize("case", [(4, 4, 37), (8, 8, 21)], ids=["4x4_q4", "8x8_q4"])
def test_warp_entries_equal_plain_version(count_ops, case, stage):
    bw, bh, n = case
    _same_as_plain(count_ops, stage, astc_blocks(n, bw * bh, "gray_alpha", seed=11), bw, bh, 4)


def _tie_blocks(t: int) -> np.ndarray:
    """Near-gray alpha blocks whose screen estimates tie: flat blocks (every
    valid pattern scores the same), two- and three-level blocks in stripes
    and checkerboards, one odd texel in a flat block, and a random block
    of repeated texels."""
    rng = np.random.default_rng(5)
    side = int(round(t ** 0.5))
    idx = np.arange(t)
    x, y = idx % side, idx // side
    levels = [0.0, 0.5, 1.0, 0.25]
    out = []
    for v in levels:
        out.append(np.full((t, 4), v))
        out.append(np.full((t, 4), v) * np.array([1, 1, 1, 0.5]))
    for mask in ((x + y) % 2, x % 2, (x >= side // 2).astype(int), (idx % 3)):
        lv = np.array([0.2, 0.8, 0.5])[mask]
        blk = np.repeat(lv[:, None], 4, axis=1)
        blk[:, 3] = 1.0 - lv
        out.append(blk)
    odd = np.full((t, 4), 0.4)
    odd[t // 2] = 0.9
    out.append(odd)
    rep = rng.choice([0.1, 0.6], size=(t,))
    out.append(np.repeat(rep[:, None], 4, axis=1))
    b = np.stack(out).astype(np.float32)
    return np.round(b * 255).astype(np.uint8).astype(np.float32) * np.float32(1 / 255)


@pytest.mark.parametrize("stage", ["b", "c", "d"])
@pytest.mark.parametrize("bw", [4, 8], ids=["4x4_q4", "8x8_q4"])
def test_warp_entries_on_tied_estimates(count_ops, bw, stage):
    _same_as_plain(count_ops, stage, _tie_blocks(bw * bw), bw, bw, 4)


# Entry B at the qualities whose plans differ (q1: top-1, no rerank; q2:
# top-6, keep 1, 2 layouts) at 4x4 (a thread per block) and above (a warp
# per 32 blocks, its texels in device memory); 37, 21 and 7 blocks leave
# the last group short.
@pytest.mark.parametrize("case", [(4, 1, 37), (4, 2, 37), (8, 2, 21), (12, 2, 7)],
                         ids=["4x4_q1", "4x4_q2", "8x8_q2", "12x12_q2"])
def test_entry_b_equals_plain_version(count_ops, case):
    bw, q, n = case
    _same_as_plain(count_ops, "b", astc_blocks(n, bw * bw, "alpha", seed=13), bw, bw, q)


@pytest.mark.parametrize("q", [1, 2], ids=["4x4_q1", "4x4_q2"])
def test_entry_b_on_tied_estimates_at_4x4(count_ops, q):
    """Entry B at 4x4 q1/q2 on blocks whose estimates tie: the lowest pattern
    first."""
    _same_as_plain(count_ops, "b", np.concatenate([_tie_blocks(16)] * 3), 4, 4, q)


# Entry B at 4x4 on near-gray alpha blocks: q4 (top 16, keep 5, three
# layouts) and q2 (top 6, keep 1); 37 and 65 blocks leave the last group
# short.
@pytest.mark.parametrize("case", [(4, 37), (2, 65)], ids=["q4_37", "q2_65"])
def test_entry_b_4x4_on_near_gray_alpha(count_ops, case):
    q, n = case
    _same_as_plain(count_ops, "b", astc_blocks(n, 16, "gray_alpha", seed=23), 4, 4, q)


def _mixed_blocks(n: int, t: int) -> np.ndarray:
    """Colour blocks with alpha, every third one near-gray: the gray tasks
    run on some lanes of a group only."""
    b = astc_blocks(n, t, "alpha", seed=17)
    b[::3] = astc_blocks(n, t, "gray_alpha", seed=19)[::3]
    return b


# Entry A's CTA body (a warp per task, the group's 32 blocks staged at an
# odd stride, the warps' bests merged in body_a's order) on colour blocks
# and on colour mixed with near-gray alpha blocks; 45 and 37 blocks leave
# the last group short.
@pytest.mark.parametrize("kind", ["color", "mixed"])
@pytest.mark.parametrize("case", [(4, 2, 45), (4, 4, 37), (8, 2, 37), (12, 2, 37)],
                         ids=["4x4_q2", "4x4_q4", "8x8_q2", "12x12_q2"])
def test_entry_a_equals_plain_version(count_ops, case, kind):
    bw, q, n = case
    t = bw * bw
    b = astc_blocks(n, t, "color", seed=15) if kind == "color" else _mixed_blocks(n, t)
    assert astc_tables.has_gray_blocks(b) == (kind == "mixed")
    _same_as_plain(count_ops, "a", b, bw, bw, q)


def test_entry_a_on_tied_errors(count_ops):
    """Flat and striped near-gray blocks, whose candidates tie: the first of
    least error in body_a's order, whichever warp ran it."""
    _same_as_plain(count_ops, "a", np.concatenate([_tie_blocks(16)] * 3), 4, 4, 4)


# (patterns, k, estimates drawn from): many ties, infinities (invalid
# patterns), -0.0 beside 0.0, fewer finite estimates than k, fewer
# patterns than k.
@pytest.mark.parametrize("case", [
    (632, 6, [1.5, 2.0, 2.0, np.inf]), (1024, 2, [0.0, -0.0, 3.0]),
    (1024, 16, [np.inf] * 30 + [7.0]), (812, 1, [4.0, 4.0, 9.0]),
    (40, 16, [np.inf]), (5, 6, [1.0, 2.0]), (924, 6, None),
], ids=["c_4x4", "zeros", "few_finite", "k1", "all_inf", "short", "distinct"])
def test_warp_topk_equals_sequential_scan(count_ops, case):
    u, k, pool = case
    rng = np.random.default_rng(u + k)
    v = (rng.standard_normal(u) if pool is None else rng.choice(pool, size=u)).astype(np.float32)
    got = np.zeros(k, np.int32)
    want = np.zeros(k, np.int32)
    count_ops.lib.astc_topk(v.ctypes.data, u, k, got.ctypes.data, want.ctypes.data)
    assert np.array_equal(got, want), (got, want)
    finite = [i for i in np.argsort(v, kind="stable")][:k]
    assert list(want[:min(k, u)]) == finite[:min(k, u)]

"""The BC kernels' device code against the plain versions on the CPU.

``chip_smoke.py`` bounds PERF rows 1-8 by the float operations of the
device code of ``csrc/bc7_encode.cu``, ``bc7_hq_encode.cu``,
``bc_encode.cu`` and ``bc6h_encode.cu``, counted by a g++ build with a
counting float type (``bc_op_counter``; BC6H and the BC4 body by what the
function needs, with the device code's count beside).  That build must give the plain
version's words bit for bit: here on seeded blocks (flat, two-tone,
gradients, random) through the wire each converter uses, for every row
the smoke run counts.  The BC7 q0-2, q3-4 and BC6H builds run the card's
warp bodies (a warp per 32 blocks, its lanes one after another), BC6H with
the half-bit proxy made in the kernel; the BC1-BC3 build runs the card's
CTA body (128 blocks staged in shared memory, then its threads one after
another), with the unit-weight instance and the weighted one; so do BC4
and BC5 (the CTA's values staged, BC5 a thread per block and channel).
"""

import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from cuttlefish_tpu_torch.convert.device import dequant, wire
from cuttlefish_tpu_torch.kernels import _build, bc, bc6h, bc7

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402


@pytest.fixture(scope="module")
def count_bc(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    return chip_smoke.bc_op_counter(str(_build.CSRC), str(tmp_path_factory.mktemp("bc")))


def _blocks(n: int, scale: float = 1.0) -> np.ndarray:
    rng = np.random.default_rng(3)
    b = np.clip(rng.random((n, 1, 4)) + rng.normal(0, 0.15, (n, 16, 4)), 0, 1)
    k = n // 4
    b[:k] = b[:k, :1]  # flat
    b[k:2 * k, 8:] = b[k:2 * k, :1]  # two-tone
    b[k:2 * k, :8] = b[k:2 * k, 15:]
    ramp = np.linspace(0, 1, 16)[None, :, None]
    b[2 * k:3 * k] = b[2 * k:3 * k, :1] * (1 - ramp) + b[2 * k:3 * k, 15:] * ramp  # gradients
    return (b * scale).astype(np.float32)


def _input(kind: str) -> torch.Tensor:
    if kind == "rgba":
        b = _blocks(40)
        b[..., 3] = 1.0
        return dequant(wire(b, "u8"))
    if kind == "alpha":
        return dequant(wire(_blocks(40), "u8"))
    if kind == "alpha1":
        return dequant(wire(_blocks(40), "u8"))[..., 3].contiguous()
    if kind == "signed":
        return dequant(wire(_blocks(40) * 2 - 1, "f16"))
    hdr = _blocks(24) * np.exp2(np.linspace(-12, 10, 24, dtype=np.float32))[:, None, None]
    return dequant(wire(hdr, "f16"))[..., :3].contiguous()


_CONSTS = bc7._constants(False, "cpu")
# row -> (input kind, plain version)
_ROWS = {
    "bc7_q2": ("rgba", lambda x: bc7.encode_bc7_plain(x, 2, _CONSTS)),
    "bc7_q3": ("rgba", lambda x: bc7.encode_bc7_plain(x, 3, _CONSTS)),
    "bc7_q4": ("alpha", lambda x: bc7.encode_bc7_plain(x, 4, _CONSTS)),
    "bc1_q2": ("rgba", lambda x: bc.encode_bc1_plain(x, 2)),
    "bc2_q2": ("alpha", lambda x: bc.encode_bc2_plain(x, 2)),
    "bc3_q2": ("alpha", lambda x: bc.encode_bc3_plain(x, 2)),
    "bc4_q2": ("alpha1", lambda x: bc.encode_bc4_plain(x, 2)),
    "bc5s_q2": ("signed", lambda x: bc.encode_bc5_plain(x, 2, True)),
    "bc6h_q2": ("hdr", lambda x: bc6h.encode_bc6h_plain(x, 2, False, "value")),
    "bc6h_q4": ("hdr", lambda x: bc6h.encode_bc6h_plain(x, 4, False, "value")),
}


@pytest.mark.parametrize("row", list(_ROWS))
def test_counting_build_equals_plain_version(count_bc, row):
    kind, plain = _ROWS[row]
    x = _input(kind)
    ops, words = count_bc(row, x.numpy())
    want = plain(x).numpy()
    assert words.dtype == want.dtype == np.uint32
    assert np.array_equal(words, want), row
    assert ops > 1000, row


@pytest.mark.parametrize("blocks", ["mixed", "ties"])
@pytest.mark.parametrize("quality,perceptual", [(0, False), (1, False), (2, False), (2, True)],
                         ids=["q0", "q1", "q2", "q2_perceptual"])
def test_bc7_warp_body_equals_plain_version(count_bc, quality, perceptual, blocks):
    """The BC7 q0-2 warp body (a warp per 32 blocks; mode 6, mode 1's
    screen, its two subset fits, then modes 1, 5 and 4 offered in order)
    gives the plain version's words on a group of 32 and a short one, and
    on blocks whose partition screens tie."""
    b = _HQ_BLOCKS[blocks]()
    x = dequant(wire(b, "u8"))
    consts = bc7._constants(perceptual, "cpu")
    _, words = count_bc(f"bc7_q{quality}", x.numpy(), chw=np.asarray(consts.chw, np.float32))
    want = bc7.encode_bc7_plain(x, quality, consts).numpy()
    assert np.array_equal(words, want), (quality, perceptual, blocks)


def _bc1_input(kind: str, n: int = 130) -> torch.Tensor:
    """n blocks through the u8 wire: a CTA of 128 and a short one.  "hard":
    alpha 0 or 1 (punch-through); "rgba": opaque; "alpha": smooth alpha."""
    b = _blocks(n)
    if kind == "hard":
        b[..., 3] = (np.random.default_rng(5).random((n, 16)) > 0.3).astype(np.float32)
    elif kind == "rgba":
        b[..., 3] = 1.0
    return dequant(wire(b, "u8"))


_SRGB = np.asarray(bc.channel_weights(np.float32([0.3, 0.59, 0.11]) * np.float32(3)), np.float32)
# case -> (counting row, input kind, channel weights or None, plain version)
_BC1_CASES = {
    **{f"bc1_q{q}_black": (f"bc1_q{q}", "rgba", None,
                           lambda x, q=q: bc.encode_bc1_plain(x, q)) for q in range(5)},
    "bc1_q2_punch": ("bc1_q2_punch", "hard", None,
                     lambda x: bc.encode_bc1_plain(x, 2, True, False)),
    "bc1_q2_srgb": ("bc1_q2", "rgba", _SRGB,
                    lambda x: bc.encode_bc1_plain(x, 2, chw=tuple(map(float, _SRGB)))),
    "bc2_q2": ("bc2_q2", "alpha", None, lambda x: bc.encode_bc2_plain(x, 2)),
    "bc3_q2": ("bc3_q2", "alpha", None, lambda x: bc.encode_bc3_plain(x, 2)),
}


@pytest.mark.parametrize("case", list(_BC1_CASES))
def test_bc1_cta_body_equals_plain_version(count_bc, case):
    """The BC1 colour body the card runs (its CTA's texels staged, unit
    weights without their products, black distances made once, the 565
    sweep texel-outer) gives the plain version's words at every quality,
    with punch-through, with sRGB weights (the weighted instance), and
    under BC2's and BC3's alpha, across a CTA edge."""
    row, kind, chw, plain = _BC1_CASES[case]
    x = _bc1_input(kind)
    _, words = count_bc(row, x.numpy(), chw=chw)
    want = plain(x).numpy()
    assert np.array_equal(words, want), case


def test_bc1_sweep_counts_fewer_operations(count_bc):
    """Sweeping texel-outer makes the unchanged channels' terms once for a
    channel's 8 candidates: what BC1 q2 counts above q1 stays under two
    thirds of the 48 sweep candidates' full palettes (each 16 texels x (4
    entries x (3 differences, 3 squares, 2 sums) + 3 compares + a sum)),
    plus 4 full palettes for q2's third round and its 3-colour half."""
    x = _bc1_input("rgba").numpy()
    q1, _ = count_bc("bc1_q1", x)
    q2, _ = count_bc("bc1_q2", x)
    palette = 16 * (4 * 8 + 3 + 1)
    assert q2 - q1 < (2 / 3) * 48 * palette + 4 * palette, (q1, q2)


def _bc4_values(n: int, signed: bool) -> torch.Tensor:
    """[n,16] values through the wire BC4 takes: alpha of the seeded blocks
    (u8), or their red as 2x - 1 (f16)."""
    if signed:
        return dequant(wire(_blocks(n) * 2 - 1, "f16"))[..., 0].contiguous()
    return dequant(wire(_blocks(n), "u8"))[..., 3].contiguous()


# case -> (counting row, input, plain version); 130 blocks: a CTA of 128
# and a short one.
_BC4_CASES = {
    **{f"bc4{'s' if sg else ''}_q{q}": (
        f"bc4{'s' if sg else ''}_q{q}", lambda sg=sg: _bc4_values(130, sg),
        lambda x, q=q, sg=sg: bc.encode_bc4_plain(x, q, sg))
       for q in (0, 2, 4) for sg in (False, True)},
    "bc5_q2": ("bc5_q2", lambda: _bc1_input("alpha"), lambda x: bc.encode_bc5_plain(x, 2)),
    "bc5s_q2": ("bc5s_q2", lambda: dequant(wire(_blocks(130) * 2 - 1, "f16")),
                lambda x: bc.encode_bc5_plain(x, 2, True)),
    "bc3_q2": ("bc3_q2", lambda: _bc1_input("alpha"), lambda x: bc.encode_bc3_plain(x, 2)),
}


@pytest.mark.parametrize("case", list(_BC4_CASES))
def test_bc4_cta_body_equals_plain_version(count_bc, case):
    """The BC4 body the card runs (a CTA's values staged in shared memory,
    the least squares without products by 1 or terms of weight 0; BC5 a
    thread per block and channel) gives the plain version's words at q0,
    q2 and q4, signed and unsigned, in BC5 and under BC3's colour, across
    a CTA edge."""
    row, make, plain = _BC4_CASES[case]
    x = make()
    _, words = count_bc(row, x.numpy())
    want = plain(x).numpy()
    nw = want.shape[1]
    assert np.array_equal(words[:, :nw], want), case


@pytest.mark.parametrize("case", ["bc4_q2", "bc4s_q2", "bc5s_q2", "bc3_q2", "bc4_q4", "bc4s_q4"])
def test_bc4_needed_count_ends_rounds_at_every_quality(count_bc, case):
    """The BC4 body's bound counts a mode's rounds up to the first
    candidate not taken, since every later round would make it again; the
    device code leaves there only from q3.  So at q2 the needed count is
    below the device code's (BC5 and BC3 through the same body), at q4
    equal to it, and the words are the same either way."""
    row, make, plain = _BC4_CASES[case]
    x = make().numpy()
    needed, words = count_bc(row, x)
    device, device_words = count_bc(row, x, device=True)
    assert np.array_equal(words, device_words), case
    nw = 2 if row.startswith("bc4") else 4
    assert np.array_equal(words[:, :nw], plain(torch.from_numpy(x)).numpy()), case
    if case.endswith("_q4"):
        assert needed == device, case
    else:
        assert needed < device, (case, needed, device)


def _bc4_tie_values(signed: bool) -> torch.Tensor:
    """[n,16] values whose BC4 searches tie: flat blocks (d0 == d1: every
    entry the same), blocks at the fixed extremes and one u8 step inside
    them, and blocks of values drawn from 15 points evenly spaced between
    two wire values, so that many texels lie midway between two palette
    entries."""
    lo_ext = -1.0 if signed else 0.0
    step = 1 / 127 if signed else 1 / 255
    out = [np.full(16, v) for v in (lo_ext, lo_ext + step, 0.5, 1 - step, 1.0)]
    out.append(np.tile([lo_ext, 1.0], 8))
    out.append(np.tile([lo_ext, lo_ext + step, 1 - step, 1.0], 4))
    rng = np.random.default_rng(7)
    for _ in range(40):
        a, b = np.sort(rng.integers(0, 128 if signed else 256, 2))
        lo, hi = lo_ext + a * step, lo_ext + b * step
        out.append(rng.choice(lo + (hi - lo) * np.arange(15) / 14, 16))
    return torch.from_numpy(np.stack(out).astype(np.float32))


@pytest.mark.parametrize("signed", [False, True], ids=["unsigned", "signed"])
@pytest.mark.parametrize("quality", [2, 4], ids=["q2", "q4"])
def test_bc4_body_on_flat_and_tied_blocks(count_bc, quality, signed):
    """Flat blocks (equal endpoints), the fixed extremes, and texels midway
    between palette entries: the first minimum in table order, as the
    plain version keeps it."""
    x = _bc4_tie_values(signed)
    row = f"bc4{'s' if signed else ''}_q{quality}"
    _, words = count_bc(row, x.numpy())
    want = bc.encode_bc4_plain(x, quality, signed).numpy()
    assert np.array_equal(words[:, :2], want), row


def _tie_blocks() -> np.ndarray:
    """Blocks whose partition screens or rotation screens tie: flat blocks
    (every partition scores the same), two- and three-level blocks in
    stripes, halves and checkerboards (several partitions split them
    alike), gray blocks whose alpha equals their gray (every rotation scores
    the same) or two of whose channels are equal, and one odd texel in a
    flat block."""
    idx = np.arange(16)
    x, y = idx % 4, idx // 4
    out = []
    for v in (0.0, 0.5, 1.0):
        out.append(np.full((16, 4), v))
    for mask in ((x + y) % 2, x % 2, y % 2, (x >= 2).astype(int), (y >= 2).astype(int),
                 idx % 3, (x + y) % 3):
        lv = np.array([0.2, 0.8, 0.5])[mask]
        blk = np.repeat(lv[:, None], 4, axis=1)
        blk[:, 3] = 1.0
        out.append(blk)
        gray = blk.copy()
        gray[:, 3] = lv  # alpha = gray: the four rotations tie
        out.append(gray)
        two = blk.copy()
        two[:, 2] = 1.0 - lv  # red = green
        two[:, 3] = 0.3 + 0.4 * lv
        out.append(two)
    odd = np.full((16, 4), 0.4)
    odd[5] = 0.9
    out.append(odd)
    b = np.stack(out).astype(np.float32)
    return np.round(b * 255).astype(np.float32) * np.float32(1 / 255)


_HQ_BLOCKS = {
    # 45 and 25 blocks: a group of 32 and one cut short, or one short group.
    "mixed": lambda: _blocks(45),
    "ties": _tie_blocks,
    "one": lambda: _blocks(8)[5:6],
}


@pytest.mark.parametrize("blocks", list(_HQ_BLOCKS))
@pytest.mark.parametrize("quality,perceptual", [(3, False), (4, False), (4, True)],
                         ids=["q3", "q4", "q4_perceptual"])
def test_bc7_hq_warp_body_equals_plain_version(count_bc, quality, perceptual, blocks):
    """The BC7 q3-4 warp body (a warp per 32 blocks, its lanes one after
    another) gives _encode_hq's words, for every group size the card sees."""
    b = _HQ_BLOCKS[blocks]()
    x = dequant(wire(b, "u8"))
    consts = bc7._constants(perceptual, "cpu")
    _, words = count_bc(f"bc7_q{quality}", x.numpy(), chw=np.asarray(consts.chw, np.float32))
    want = bc7.encode_bc7_plain(x, quality, consts).numpy()
    assert np.array_equal(words, want), (quality, perceptual, blocks)


def _hdr(n: int, signed: bool) -> torch.Tensor:
    """[n,16,3] HDR blocks through the f16 wire, 2^-14 .. 2^10 times the
    seeded blocks; signed: about a third of the values negative."""
    b = _blocks(n) * np.exp2(np.linspace(-14, 10, n, dtype=np.float32))[:, None, None]
    if signed:
        b = b * np.where(np.random.default_rng(4).random(b.shape) < 0.3, -1.0, 1.0)
    return dequant(wire(b.astype(np.float32), "f16"))[..., :3].contiguous()


# 45 blocks: a group of 32 and one of 13.
@pytest.mark.parametrize("metric", ["value", "code"])
@pytest.mark.parametrize("signed", [False, True], ids=["unsigned", "signed"])
@pytest.mark.parametrize("quality", [2, 4], ids=["q2", "q4"])
def test_bc6h_warp_body_equals_plain_version(count_bc, quality, signed, metric):
    x = _hdr(45, signed)
    row = f"bc6h{'s' if signed else ''}_q{quality}{'_code' if metric == 'code' else ''}"
    _, words = count_bc(row, x.numpy())
    want = bc6h.encode_bc6h_plain(x, quality, signed, metric).numpy()
    assert np.array_equal(words, want), row


@pytest.mark.parametrize("row", ["bc6h_q2", "bc6h_q4", "bc6hs_q4", "bc6h_q2_code"])
def test_bc6h_needed_count_makes_value_and_scale_once(count_bc, row):
    """The BC6H bound counts each texel's value and scale once, as the
    function needs them; the device code makes them at every read.  So
    under the value metric the needed count is below the device code's,
    by at least the second making of each texel's pair; under the code
    metric, which reads the proxy itself, the two are equal.  The words
    are the same either way."""
    x = _hdr(45, row.startswith("bc6hs")).numpy()
    needed, words = count_bc(row, x)
    device, device_words = count_bc(row, x, device=True)
    assert np.array_equal(words, device_words), row
    if row.endswith("_code"):
        assert needed == device, row
    else:
        # A pair costs at least 5 operations (|b|, the segment's floor and
        # min, the compare, a product): each texel's 48 pairs made twice.
        assert needed + 48 * 5 <= device, (row, needed, device)


def test_bc6h_in_kernel_proxy_equals_to_proxy(count_bc):
    """The kernel's float-to-half proxy against the plain version's torch
    ops on the values where rounding is delicate: +-0, subnormal halves and
    the ties between them, the smallest normal half, 65504 and the values
    about it that round down or to infinity, infinities, huge values, and
    negatives (0 when unsigned); then seeded values over the whole range."""
    f = np.float32
    tiny = [0.0, -0.0, 2.0**-26, 2.0**-25, 1.5 * 2.0**-25, 2.0**-24, 1.5 * 2.0**-24,
            2.5 * 2.0**-24, 3 * 2.0**-24, 1023.5 * 2.0**-24, 2.0**-14 - 2.0**-26, 2.0**-14,
            1.0, 1.0 + 2.0**-11, 1.0 + 3 * 2.0**-11, 65504.0, 65519.0, 65519.99, 65520.0, 65536.0,
            1e6, 3.0e38, np.inf]
    v = np.array(tiny + [-x for x in tiny], f)
    rng = np.random.default_rng(6)
    v = np.concatenate([v, (rng.standard_normal(4000) * np.exp2(rng.uniform(-30, 18, 4000)))
                        .astype(f)])
    for signed in (False, True):
        want = bc6h._to_proxy(torch.from_numpy(v), signed).numpy()
        got = count_bc.proxy(v, signed)
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32)), signed

"""Unsigned BC6H mode 12 stores the ends that its indices were chosen for.

Mode 12 keeps a second end as a 9-bit delta, -256..255, from the first.
The one-region fit clamps the delta to that range in its own orientation;
when texel 0's index is 8 or more, the anchor swap stores the ends the
other way round, and a delta of -256 would become +256.  The TPU kernel
(``bc6h_pallas.py:_kernel``) packs it as +255, a palette one 11-bit step
away from the one the indices and the error were computed for.  The
port's plain version (``kernels/bc6h.py:_mend_mode12``) and its hand
kernel instead give such an unsigned candidate the ends that can be
stored, and index it and measure its error for them.

The fixture (``fixtures/bc6h_mode12_overflow.npz``: [421,16,3] float16,
the values the encoder reads) holds 293 blocks whose quality-4 mode-12
candidate overflows and 128 whose candidate does not: every overflowing
block of nine 128x128 HDR sky cubes through their full CatmullRom chains
(the benchmark's sky content, seeds 11-13, members 0-2) and of 8,192
seeded HDR blocks (``test_torch_bc6h.py:hdr_blocks``, seed 21), then 12
other blocks of each cube and 20 of the seeded ones.

Held here against the TPU kernel, run eagerly as ``test_torch_bc6h.py``
runs it: its words wherever the final mode-12 candidate does not
overflow; every stored index the encoder's own choice for the ends
stored; the decoded PSNR within 0.01 dB.
"""

from pathlib import Path

import numpy as np
import pytest
import torch
from test_torch_bc6h import _bytes, _eager

from cuttlefish_tpu_torch.decode import decode_bc6h
from cuttlefish_tpu_torch.kernels import bc6h
from cuttlefish_tpu_torch.kernels.bc7 import _w64
from cuttlefish_tpu_torch.packfloat import half_bits_to_f32

FIXTURE = Path(__file__).resolve().parent / "fixtures" / "bc6h_mode12_overflow.npz"


@pytest.fixture(scope="module")
def blocks():
    return np.load(FIXTURE)["blocks"].astype(np.float32)


@pytest.fixture(scope="module")
def encoded(blocks):
    """(quality, metric) -> (the port's words, the TPU kernel's), each
    case encoded once."""
    done = {}

    def get(quality, metric):
        if (quality, metric) not in done:
            port = bc6h.encode_bc6h(torch.from_numpy(blocks), quality, False, metric).numpy()
            done[quality, metric] = port, _eager(blocks, quality, False, metric)
        return done[quality, metric]

    return get


def _texels(blocks, metric):
    """The encoder's proxy channels, selection-domain values and scales."""
    p = bc6h._to_proxy(torch.from_numpy(blocks), False).permute(2, 1, 0)
    px = [p[c].contiguous() for c in range(3)]
    if metric == "code":
        return px, px, [torch.ones_like(c) for c in px]
    return px, [bc6h._proxy_to_value(c) for c in px], [bc6h._proxy_scale(c) for c in px]


def _overflows(blocks, quality, metric):
    """The plain version's predicate on its final mode-12 candidate."""
    px, pxv, pxs = _texels(blocks, metric)
    q0, q1, idx, _ = bc6h._fit_mode(
        px, pxv, pxs, 11, False, bc6h._BC6H_ITERS[quality], delta_bits=9, code=metric == "code"
    )
    return bc6h._mode12_overflows(q0, q1, idx).numpy()


def _one_region(words):
    """Unsigned mode 11 / 12 fields of each block: (mode 11 or 12 or 0 for
    a two-region block, ends [N,2,3], indices [N,16])."""
    out_mode = np.zeros(len(words), np.int64)
    ends = np.zeros((len(words), 2, 3), np.int64)
    idx = np.zeros((len(words), 16), np.int64)
    for n, w in enumerate(words):
        block = int.from_bytes(_bytes(w).tobytes(), "little")
        head = block & 0x1F
        if head not in (0x03, 0x07):
            continue
        fields = [(block >> (5 + 10 * i)) & 0x3FF for i in range(6)]
        if head == 0x03:
            out_mode[n], ends[n] = 11, np.reshape(fields, (2, 3))
        else:
            out_mode[n] = 12
            for c in range(3):
                e0 = fields[c] | ((block >> (44 + 10 * c)) & 1) << 10
                d = (block >> (35 + 10 * c)) & 0x1FF
                d -= (d & 0x100) << 1
                ends[n, :, c] = e0, (e0 + d) & 0x7FF
        pos = 65
        for t in range(16):
            k = 3 if t == 0 else 4
            idx[n, t] = (block >> pos) & ((1 << k) - 1)
            pos += k
    return out_mode, ends, idx


@pytest.mark.parametrize("quality,metric", [(2, "value"), (4, "value"), (4, "code")])
def test_words_change_only_where_mode12_overflows(blocks, encoded, quality, metric):
    """The TPU kernel's words wherever the final mode-12 candidate does not
    overflow; some overflowing fixture blocks change."""
    port, ref = encoded(quality, metric)
    over = _overflows(blocks, quality, metric)
    changed = np.any(port != ref, axis=1)
    assert over.sum() >= 100 and (~over).sum() >= 100, over.sum()
    assert not np.any(changed & ~over), np.flatnonzero(changed & ~over)
    assert changed.sum() >= 1


def test_every_stored_index_is_the_encoders_choice(blocks, encoded):
    """In every one-region block the stored indices are those that the
    encoder's index rule picks for the ends the block holds, in one of
    the two orientations (the fit's; the anchor swap mirrors them); the
    port's decoder reads each texel at the entry those ends and indices
    give."""
    words, _ = encoded(4, "value")
    mode, ends, stored = _one_region(words)
    one = mode > 0
    assert (mode == 12).sum() >= 50, (mode == 12).sum()
    px, _, pxs = _texels(blocks[one], "value")
    bits = torch.from_numpy(np.where(mode[one] == 12, 11, 10))[None]
    q = torch.from_numpy(ends[one]).to(torch.int32)
    u = [[torch.where(bits == 11, bc6h._unquant(q[:, e, c][None], 11, False),
                      bc6h._unquant(q[:, e, c][None], 10, False))[0] for c in range(3)]
         for e in range(2)]
    fin = [[bc6h._finalize(u[e][c], False).to(torch.float32) for c in range(3)] for e in range(2)]
    pick = bc6h._nearest_index(px, pxs, u[0], u[1], fin[0], fin[1], 16, False)
    back = 15 - bc6h._nearest_index(px, pxs, u[1], u[0], fin[1], fin[0], 16, False)
    got = torch.from_numpy(stored[one]).T.to(pick.dtype)
    assert torch.all((pick == got).all(0) | (back == got).all(0))
    # The ends as read agree with the port's decoder, texel by texel.
    pal = bc6h._decoded(u[0], u[1], _w64(got, 16), False)
    dec = decode_bc6h(_bytes(words[one]), signed=False)
    want = np.stack([p.T.numpy() for p in pal], -1)
    assert np.array_equal(dec.astype(np.int64), want.astype(np.int64))


def test_decoded_psnr_is_within_a_hundredth_of_a_db(blocks, encoded):
    """The mend moves the fixture's decoded PSNR (linear values, peak
    max|src|) by less than 0.01 dB against the TPU kernel's words."""
    port, ref = encoded(4, "value")

    def psnr(words):
        dec = half_bits_to_f32(decode_bc6h(_bytes(words))).astype(np.float64)
        peak = np.abs(blocks).max()
        return 10 * np.log10(peak * peak / ((dec - blocks) ** 2).mean())

    assert abs(psnr(port) - psnr(ref)) < 0.01, (psnr(port), psnr(ref))

"""The hand-written kernels (BC7 q0-2 and q3-4, BC1-BC5, BC6H, ETC1/ETC2/
EAC, ASTC LDR) against their plain versions.

Tests marked ``gpu`` need a CUDA card and skip without one; run them on
the card with ``python -m pytest tests/test_torch_cuda.py -m gpu``.  The
others check, on any machine, that the wrapper never hands a CPU tensor
to the launcher and how the kernel is built.
"""

import numpy as np
import pytest
import torch

import cuttlefish_tpu_torch as cp
from cuttlefish_tpu_torch.convert import device as conv_device
from cuttlefish_tpu_torch.decode import decode_bc7
from cuttlefish_tpu_torch.kernels import (
    _build, astc, astc_cuda, astc_tables, bc, bc6h, bc6h_cuda, bc7_cuda, bc7_hq_cuda, bc_cuda, etc,
    etc_cuda, pyramid_cuda,
)
from cuttlefish_tpu_torch.kernels.bc7 import _constants, encode_bc7, encode_bc7_plain


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


def _blocks(n, seed=7):
    rng = np.random.default_rng(seed)
    base = rng.random((n, 1, 4), np.float32)
    grad = rng.normal(0, 0.15, (n, 16, 4)).astype(np.float32)
    b = np.clip(base + grad, 0, 1)
    b[::3, :, 3] = np.clip(b[::3, :, 3] * 0.6 + 0.2, 0, 1)
    return b


def _psnr(words, blocks):
    raw = np.frombuffer(np.ascontiguousarray(words.astype("<u4")).tobytes(), np.uint8)
    dec = decode_bc7(raw).astype(np.float64)
    ref = np.clip(np.round(blocks * 255), 0, 255)
    return 10 * np.log10(255**2 / (((dec - ref) ** 2).mean() + 1e-12))


@pytest.mark.gpu
@pytest.mark.parametrize("quality,perceptual", [(0, False), (1, False), (2, False), (2, True)])
def test_kernel_matches_plain_on_card(cuda, quality, perceptual):
    """>= 99 % identical blocks and |dPSNR| <= 0.05 dB, on the card."""
    b = _blocks(4096)
    x = torch.from_numpy(b).to(cuda)
    before = bc7_cuda.launches
    k = encode_bc7(x, quality, perceptual)
    torch.cuda.synchronize()
    assert bc7_cuda.launches == before + 1
    p = encode_bc7_plain(x, quality, _constants(perceptual, cuda))
    k, p = k.cpu().numpy(), p.cpu().numpy()
    assert np.all(k == p, axis=1).mean() >= 0.99
    assert abs(_psnr(k, b) - _psnr(p, b)) <= 0.05


@pytest.mark.gpu
@pytest.mark.parametrize("quality,perceptual", [(3, False), (4, False), (4, True)])
def test_hq_kernel_matches_plain_on_card(cuda, quality, perceptual):
    """BC7 q3-4: one bc7_hq launch, >= 99 % identical blocks and |dPSNR|
    <= 0.05 dB, on blocks with flat and two-tone ones among them."""
    b = _blocks(2048)
    b[::7] = b[::7, :1]  # flat
    b[3::11, 8:] = b[3::11, :1]  # two-tone
    x = torch.from_numpy(b).to(cuda)
    before = bc7_hq_cuda.launches
    k = encode_bc7(x, quality, perceptual)
    torch.cuda.synchronize()
    assert bc7_hq_cuda.launches == before + 1
    p = encode_bc7_plain(x, quality, _constants(perceptual, cuda))
    k, p = k.cpu().numpy(), p.cpu().numpy()
    assert np.all(k == p, axis=1).mean() >= 0.99
    assert abs(_psnr(k, b) - _psnr(p, b)) <= 0.05


@pytest.mark.gpu
@pytest.mark.parametrize("quality", [3, 4])
def test_hq_kernel_at_group_edges(cuda, quality):
    """BC7 q3-4 runs a warp per 32 blocks, 4 warps a CTA: counts that leave
    a warp or a CTA part-filled give the plain version's words, and a view
    off a 16-byte boundary is copied before the launch."""
    x = torch.from_numpy(_blocks(300, seed=4)).to(cuda)
    consts = _constants(False, cuda)
    for n in (1, 31, 33, 64, 65, 300):
        k = bc7_hq_cuda.encode_bc7_hq_cuda(x[:n].contiguous(), quality, consts)
        p = encode_bc7_plain(x[:n], quality, consts)
        assert torch.equal(k.view(torch.int32).cpu(), p.view(torch.int32).cpu()), n
    flat = torch.zeros(300 * 64 + 1, device=cuda)
    flat[1:] = x.reshape(-1)
    view = flat[1:].view(300, 16, 4)
    k = bc7_hq_cuda.encode_bc7_hq_cuda(view, quality, consts)
    p = encode_bc7_plain(x, quality, consts)
    assert torch.equal(k.view(torch.int32).cpu(), p.view(torch.int32).cpu())


def _hdr(n, signed, seed=9):
    rng = np.random.default_rng(seed)
    b = np.exp(rng.normal(0, 1.5, (n, 1, 1))) * (1 + rng.normal(0, 0.1, (n, 16, 3)))
    if signed:
        b = b * np.where(rng.random((n, 16, 3)) < 0.3, -1.0, 1.0)
    return b.astype(np.float16).astype(np.float32)  # the f16 wire


@pytest.mark.gpu
@pytest.mark.parametrize(
    "quality,signed,metric",
    [(0, False, "value"), (2, False, "value"), (4, False, "value"), (2, True, "value"),
     (4, True, "value"), (2, False, "code")],
)
def test_bc6h_kernel_matches_plain_on_card(cuda, quality, signed, metric):
    """BC6H: one bc6h launch, >= 99 % identical blocks (100 % expected)."""
    x = torch.from_numpy(_hdr(2048, signed)).to(cuda)
    before = bc6h_cuda.launches
    k = bc6h.encode_bc6h(x, quality, signed, metric)
    torch.cuda.synchronize()
    assert bc6h_cuda.launches == before + 1
    p = bc6h.encode_bc6h_plain(x, quality, signed, metric)
    k, p = k.cpu().numpy(), p.cpu().numpy()
    assert k.dtype == np.uint32 and k.shape == (2048, 4)
    assert np.all(k == p, axis=1).mean() >= 0.99


@pytest.mark.gpu
@pytest.mark.parametrize(
    "quality,signed,metric",
    [(2, False, "value"), (4, False, "value"), (2, True, "value"), (4, True, "value"),
     (2, False, "code"), (4, True, "code")],
)
def test_bc6h_warp_kernel_at_group_edges(cuda, quality, signed, metric):
    """BC6H runs a warp per 32 blocks, 4 warps a CTA, and makes the proxy
    itself: ragged batches (one block, a short last group, a part-filled
    CTA, and 300) and edge values (+-0, subnormal halves, 65504, values
    that round to infinity, negatives) give the plain version's words."""
    b = _hdr(300, signed)
    edge = np.float32([0.0, -0.0, 2.0**-24, 1.5 * 2.0**-24, 2.0**-14, 65504.0, 65520.0, 1e6,
                       -3.0, -65520.0, 0.5, -2.0**-20])
    b[7] = np.resize(edge, (16, 3))
    x = torch.from_numpy(b).to(cuda)
    for n in (1, 31, 33, 300):
        before = bc6h_cuda.launches
        k = bc6h.encode_bc6h(x[:n], quality, signed, metric)
        torch.cuda.synchronize()
        assert bc6h_cuda.launches == before + 1
        p = bc6h.encode_bc6h_plain(x[:n], quality, signed, metric)
        assert torch.equal(k.view(torch.int32).cpu(), p.view(torch.int32).cpu()), n


@pytest.mark.gpu
def test_new_kernels_reject_bad_input(cuda):
    x = torch.zeros((8, 16, 4), device=cuda)
    with pytest.raises(ValueError):
        bc7_hq_cuda.encode_bc7_hq_cuda(x, 2, _constants(False, cuda))
    with pytest.raises(TypeError):
        bc6h_cuda.encode_bc6h_cuda(x[..., :3].contiguous().half(), 2, False, "value")
    with pytest.raises(ValueError):
        bc6h_cuda.encode_bc6h_cuda(x, 2, False, "value")  # 4 channels
    with pytest.raises(ValueError):
        bc6h_cuda.encode_bc6h_cuda(x[..., :3], 2, False, "value")  # not contiguous
    assert tuple(bc6h.encode_bc6h(x[:0, :, :3].contiguous(), 2).shape) == (0, 4)
    assert tuple(encode_bc7(x[:0], 4).shape) == (0, 4)


@pytest.mark.gpu
def test_kernel_ragged_batch_and_empty(cuda):
    """A batch that is not a multiple of the CTA size, and N = 0."""
    b = _blocks(129, seed=3)
    x = torch.from_numpy(b).to(cuda)
    k = encode_bc7(x, 2).cpu().numpy()
    p = encode_bc7_plain(x, 2, _constants(False, cuda)).cpu().numpy()
    assert np.all(k == p, axis=1).mean() >= 0.99
    assert tuple(encode_bc7(x[:0], 2).shape) == (0, 4)


@pytest.mark.gpu
def test_kernel_rejects_bad_input(cuda):
    x = torch.zeros((8, 16, 4), device=cuda)
    consts = _constants(False, cuda)
    with pytest.raises(TypeError):
        bc7_cuda.encode_bc7_cuda(x.half(), 2, consts)
    with pytest.raises(ValueError):
        bc7_cuda.encode_bc7_cuda(x[:, :8], 2, consts)
    with pytest.raises(ValueError):
        bc7_cuda.encode_bc7_cuda(x.transpose(0, 1), 2, consts)


# (name, kernel call, plain call, input) for each BC1-BC5 entry on the card.
_SRGB = tuple(float(w) for w in np.float32([0.3, 0.59, 0.11]) * np.float32(3))
_BC_CASES = {
    "bc1_q2_black": (lambda x: bc.encode_bc1(x, 2), lambda x: bc.encode_bc1_plain(x, 2), "rgba"),
    "bc1_q2_punch": (
        lambda x: bc.encode_bc1(x, 2, True, False),
        lambda x: bc.encode_bc1_plain(x, 2, True, False),
        "hard",
    ),
    "bc1_q4_srgb": (
        lambda x: bc.encode_bc1(x, 4, ch_weights=_SRGB),
        lambda x: bc.encode_bc1_plain(x, 4, chw=_SRGB),
        "rgba",
    ),
    "bc2_q2": (lambda x: bc.encode_bc2(x, 2), lambda x: bc.encode_bc2_plain(x, 2), "rgba"),
    "bc3_q2": (lambda x: bc.encode_bc3(x, 2), lambda x: bc.encode_bc3_plain(x, 2), "rgba"),
    "bc4_q2": (lambda x: bc.encode_bc4(x, 2), lambda x: bc.encode_bc4_plain(x, 2), "red"),
    "bc4s_q2": (lambda x: bc.encode_bc4(x, 2, True), lambda x: bc.encode_bc4_plain(x, 2, True), "sred"),
    "bc5s_q2": (lambda x: bc.encode_bc5(x, 2, True), lambda x: bc.encode_bc5_plain(x, 2, True), "signed"),
    "bc5_q0": (lambda x: bc.encode_bc5(x, 0), lambda x: bc.encode_bc5_plain(x, 0), "rgba"),
}


def _bc_input(kind, n=4096):
    b = _blocks(n, seed=5)
    b = (np.round(b * 255) / 255).astype(np.float32)  # the u8 wire's values
    if kind == "hard":
        b[..., 3] = (np.random.default_rng(6).random((n, 16)) > 0.3).astype(np.float32)
    if kind == "red":
        return np.ascontiguousarray(b[..., 0])
    signed = (b * 2 - 1).astype(np.float16).astype(np.float32)  # the f16 wire
    if kind == "sred":
        return np.ascontiguousarray(signed[..., 0])
    return signed if kind == "signed" else b


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(_BC_CASES))
def test_bc_kernel_matches_plain_on_card(cuda, case):
    """Every BC1-BC5 entry: one launch, >= 99 % blocks identical to the
    plain version on the same card (100 % expected: same arithmetic)."""
    kernel, plain, kind = _BC_CASES[case]
    x = torch.from_numpy(_bc_input(kind)).to(cuda)
    name = case.split("_")[0].rstrip("s")
    before = dict(bc_cuda.launches)
    k = kernel(x)
    torch.cuda.synchronize()
    assert bc_cuda.launches[name] == before[name] + 1
    p = plain(x)
    k, p = k.cpu().numpy(), p.cpu().numpy()
    assert k.shape == p.shape and k.dtype == p.dtype == np.uint32
    assert np.all(k == p, axis=1).mean() >= 0.99


@pytest.mark.gpu
def test_bc_kernels_reject_bad_input(cuda):
    x = torch.zeros((8, 16, 4), device=cuda)
    with pytest.raises(TypeError):
        bc_cuda.encode_bc1_cuda(x.half(), 2, False, True, (1.0, 1.0, 1.0))
    with pytest.raises(ValueError):
        bc_cuda.encode_bc3_cuda(x[:, :8], 2, (1.0, 1.0, 1.0))
    with pytest.raises(ValueError):
        bc_cuda.encode_bc4_cuda(x[..., 0], 2, False)  # not contiguous
    with pytest.raises(ValueError):
        bc_cuda.encode_bc5_cuda(x[..., :1].contiguous(), 2, False)
    assert tuple(bc.encode_bc2(x[:0], 2).shape) == (0, 4)


# BC1 (every quality with black, punch-through, sRGB weights), BC2 and BC3
# at q2: (kernel call, plain call, input, launch counter).
_BC1_EDGE_CASES = {
    **{f"bc1_q{q}_black": (lambda x, q=q: bc.encode_bc1(x, q),
                           lambda x, q=q: bc.encode_bc1_plain(x, q), "rgba", "bc1") for q in range(5)},
    "bc1_q2_punch": (lambda x: bc.encode_bc1(x, 2, True, False),
                     lambda x: bc.encode_bc1_plain(x, 2, True, False), "hard", "bc1"),
    "bc1_q2_srgb": (lambda x: bc.encode_bc1(x, 2, ch_weights=_SRGB),
                    lambda x: bc.encode_bc1_plain(x, 2, chw=_SRGB), "rgba", "bc1"),
    "bc2_q2": (lambda x: bc.encode_bc2(x, 2), lambda x: bc.encode_bc2_plain(x, 2), "rgba", "bc2"),
    "bc3_q2": (lambda x: bc.encode_bc3(x, 2), lambda x: bc.encode_bc3_plain(x, 2), "rgba", "bc3"),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(_BC1_EDGE_CASES))
def test_bc1_staged_kernels_at_cta_edges(cuda, case):
    """BC1, BC2 and BC3 stage 128 blocks a CTA in shared memory: one block,
    part-filled warps and CTAs, and 300 = 2 x 128 + 44 give the plain
    version's words, one launch each, with the unit-weight instance and
    the weighted one (sRGB)."""
    kernel, plain, kind, name = _BC1_EDGE_CASES[case]
    x = torch.from_numpy(_bc_input(kind, 300)).to(cuda)
    for n in (1, 31, 33, 127, 129, 300):
        before = bc_cuda.launches[name]
        k = kernel(x[:n])
        torch.cuda.synchronize()
        assert bc_cuda.launches[name] == before + 1
        assert torch.equal(k.view(torch.int32).cpu(), plain(x[:n]).view(torch.int32).cpu()), n


# BC4 (unsigned, signed) at q2 and q4, BC5 (four channels, and two: the
# scalar staging) and BC3 at q2: (kernel call, plain call, input, launch
# counter).
_BC4_EDGE_CASES = {
    "bc4_q2": (lambda x: bc.encode_bc4(x, 2), lambda x: bc.encode_bc4_plain(x, 2), "red", "bc4"),
    "bc4s_q2": (lambda x: bc.encode_bc4(x, 2, True), lambda x: bc.encode_bc4_plain(x, 2, True),
                "sred", "bc4"),
    # q4: the rounds end at the first candidate not taken (q0-q2 run them all).
    "bc4_q4": (lambda x: bc.encode_bc4(x, 4), lambda x: bc.encode_bc4_plain(x, 4), "red", "bc4"),
    "bc4s_q4": (lambda x: bc.encode_bc4(x, 4, True), lambda x: bc.encode_bc4_plain(x, 4, True),
                "sred", "bc4"),
    "bc5_q2": (lambda x: bc.encode_bc5(x, 2), lambda x: bc.encode_bc5_plain(x, 2), "rgba", "bc5"),
    "bc5s_q2": (lambda x: bc.encode_bc5(x, 2, True), lambda x: bc.encode_bc5_plain(x, 2, True),
                "signed", "bc5"),
    "bc5_q2_two_channels": (lambda x: bc.encode_bc5(x[..., :2].contiguous(), 2),
                            lambda x: bc.encode_bc5_plain(x[..., :2].contiguous(), 2), "rgba", "bc5"),
    "bc3_q2": (lambda x: bc.encode_bc3(x, 2), lambda x: bc.encode_bc3_plain(x, 2), "rgba", "bc3"),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(_BC4_EDGE_CASES))
def test_bc4_bc5_kernels_at_cta_edges(cuda, case):
    """BC4 and BC5 stage 128 blocks a CTA in shared memory (BC5 a thread
    per block and channel), BC3 its alpha with BC1's texels: one block,
    part-filled CTAs and 257 = 2 x 128 + 1 give the plain version's words,
    one launch each."""
    kernel, plain, kind, name = _BC4_EDGE_CASES[case]
    x = torch.from_numpy(_bc_input(kind, 257)).to(cuda)
    for n in (1, 127, 129, 257):
        before = bc_cuda.launches[name]
        k = kernel(x[:n])
        torch.cuda.synchronize()
        assert bc_cuda.launches[name] == before + 1
        assert torch.equal(k.view(torch.int32).cpu(), plain(x[:n]).view(torch.int32).cpu()), n


@pytest.mark.gpu
@pytest.mark.parametrize("quality,perceptual", [(0, False), (1, True), (2, False), (2, True)])
def test_bc7_kernel_at_group_edges(cuda, quality, perceptual):
    """BC7 q0-2 runs a warp per 32 blocks, 4 warps a CTA: one block,
    part-filled warps and CTAs, and 300 blocks give the plain version's
    words, one launch each."""
    x = torch.from_numpy(_blocks(300, seed=4)).to(cuda)
    consts = _constants(perceptual, cuda)
    for n in (1, 31, 33, 127, 129, 300):
        before = bc7_cuda.launches
        k = bc7_cuda.encode_bc7_cuda(x[:n].contiguous(), quality, consts)
        torch.cuda.synchronize()
        assert bc7_cuda.launches == before + 1
        p = encode_bc7_plain(x[:n], quality, consts)
        assert torch.equal(k.view(torch.int32).cpu(), p.view(torch.int32).cpu()), n


# (name, kernel call, plain call, input) for each ETC/EAC entry on the card.
_SRGB709 = tuple(float(w) for w in np.array([0.2126, 0.7152, 0.0722], np.float32) * np.float32(3))
_ETC_CASES = {
    "etc_rgb_etc1_q2": (lambda x: etc.encode_etc_rgb(x, 2), lambda x: etc.encode_etc_rgb_plain(x, 2), "rgba"),
    "etc_rgb_etc2_q1_srgb": (
        lambda x: etc.encode_etc_rgb(x, 1, True, _SRGB709),
        lambda x: etc.encode_etc_rgb_plain(x, 1, True, _SRGB709),
        "rgba",
    ),
    "etc_rgb_etc2_q4": (
        lambda x: etc.encode_etc_rgb(x, 4, True), lambda x: etc.encode_etc_rgb_plain(x, 4, True), "rgba",
    ),
    "etc2_rgba_q2": (lambda x: etc.encode_etc2_rgba(x, 2), lambda x: etc.encode_etc2_rgba_plain(x, 2), "rgba"),
    "eac_alpha_q4": (lambda x: etc.encode_eac_alpha(x, 4), lambda x: etc.encode_eac_alpha_plain(x, 4), "red"),
    "eac_r11_q2": (lambda x: etc.encode_eac_r11(x, 2), lambda x: etc.encode_eac_r11_plain(x, 2), "red"),
    "eac_r11_signed_q4": (
        lambda x: etc.encode_eac_r11(x, 4, True), lambda x: etc.encode_eac_r11_plain(x, 4, True), "sred",
    ),
    "eac_rg11_signed_q2": (
        lambda x: etc.encode_eac_rg11(x, 2, True), lambda x: etc.encode_eac_rg11_plain(x, 2, True), "signed",
    ),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(_ETC_CASES))
def test_etc_kernel_matches_plain_on_card(cuda, case):
    """Every ETC/EAC entry: one launch of its own counter, >= 99 % blocks
    identical to the plain version on the same card (100 % expected)."""
    kernel, plain, kind = _ETC_CASES[case]
    x = torch.from_numpy(_bc_input(kind, 2048)).to(cuda)
    name = next(k for k in etc_cuda.launches if case.startswith(k + "_"))
    before = dict(etc_cuda.launches)
    k = kernel(x)
    torch.cuda.synchronize()
    assert etc_cuda.launches == {**before, name: before[name] + 1}
    p = plain(x)
    k, p = k.cpu().numpy(), p.cpu().numpy()
    assert k.shape == p.shape and k.dtype == p.dtype == np.uint32
    assert np.all(k == p, axis=1).mean() >= 0.99


@pytest.mark.gpu
@pytest.mark.parametrize("n", [0, 1, 127, 129, 300])
def test_etc_rgb_kernels_equal_plain_at_cta_edges(cuda, n):
    """The ETC RGB entry on 3 and 4 channels and the RGBA8 entry stage 128
    blocks a CTA: around one CTA and with a part-filled last CTA (300 =
    2 x 128 + 44) every block equals the plain version (ETC2 q4, RGBA8 q2),
    one launch each (none at n = 0)."""
    b = _bc_input("rgba", 300)[:n]
    for kind, x in (("etc_rgb", b[..., :3]), ("etc_rgb", b), ("etc2_rgba", b)):
        x = torch.from_numpy(np.ascontiguousarray(x)).to(cuda)
        before = etc_cuda.launches[kind]
        if kind == "etc_rgb":
            k, p = etc.encode_etc_rgb(x, 4, True), etc.encode_etc_rgb_plain(x, 4, True)
        else:
            k, p = etc.encode_etc2_rgba(x, 2), etc.encode_etc2_rgba_plain(x, 2)
        torch.cuda.synchronize()
        assert etc_cuda.launches[kind] == before + (n > 0)
        k, p = k.cpu().numpy(), p.cpu().numpy()
        assert k.shape == p.shape == (n, 2 if kind == "etc_rgb" else 4)
        assert np.array_equal(k, p), (kind, x.shape)


# (entry, kernel, plain, input) of each EAC entry, at each quality of the
# edge cases below.
_EAC_EDGE_CASES = {
    "eac_r11": (lambda x, q: etc.encode_eac_r11(x, q), lambda x, q: etc.encode_eac_r11_plain(x, q),
                "red"),
    "eac_r11_signed": (lambda x, q: etc.encode_eac_r11(x, q, True),
                       lambda x, q: etc.encode_eac_r11_plain(x, q, True), "sred"),
    "eac_rg11": (lambda x, q: etc.encode_eac_rg11(x, q), lambda x, q: etc.encode_eac_rg11_plain(x, q),
                 "rgba"),
    "eac_rg11_signed": (lambda x, q: etc.encode_eac_rg11(x, q, True),
                        lambda x, q: etc.encode_eac_rg11_plain(x, q, True), "signed"),
    "eac_alpha": (lambda x, q: etc.encode_eac_alpha(x, q), lambda x, q: etc.encode_eac_alpha_plain(x, q),
                  "red"),
}


@pytest.mark.gpu
@pytest.mark.parametrize("quality", [2, 4])
@pytest.mark.parametrize("case", sorted(_EAC_EDGE_CASES))
def test_eac_kernels_at_cta_edges(cuda, case, quality):
    """The EAC entries stage 128 blocks a CTA in shared memory (RG11 a
    thread per block and channel): one block, part-filled CTAs and 257 =
    2 x 128 + 1 give the plain version's words, one launch each."""
    kernel, plain, kind = _EAC_EDGE_CASES[case]
    x = torch.from_numpy(_bc_input(kind, 257)).to(cuda)
    name = next(k for k in etc_cuda.launches if case == k or case.startswith(k + "_"))
    for n in (1, 127, 129, 257):
        before = etc_cuda.launches[name]
        k = kernel(x[:n], quality)
        torch.cuda.synchronize()
        assert etc_cuda.launches[name] == before + 1
        assert torch.equal(k.cpu(), plain(x[:n], quality).cpu()), n


@pytest.mark.gpu
def test_etc_kernels_take_views_off_16_byte_boundaries(cuda):
    """The ETC/EAC entries read 16-byte vectors: a contiguous view that
    starts 4 bytes into its storage encodes as its aligned copy does."""
    b = torch.from_numpy(_bc_input("rgba", 129)).to(cuda)
    a = b[..., 3].contiguous()

    def off(t):
        store = torch.zeros(t.numel() + 1, device=cuda)
        store[1:] = t.flatten()
        view = store[1:].view(t.shape)
        assert view.is_contiguous() and view.data_ptr() % 16
        return view

    for kernel, plain, x in (
        (lambda t: etc.encode_etc_rgb(t, 2, True), lambda t: etc.encode_etc_rgb_plain(t, 2, True), b),
        (lambda t: etc.encode_etc2_rgba(t, 2), lambda t: etc.encode_etc2_rgba_plain(t, 2), b),
        (lambda t: etc.encode_eac_alpha(t, 2), lambda t: etc.encode_eac_alpha_plain(t, 2), a),
        (lambda t: etc.encode_eac_r11(t, 2), lambda t: etc.encode_eac_r11_plain(t, 2), a),
        (lambda t: etc.encode_eac_rg11(t, 2), lambda t: etc.encode_eac_rg11_plain(t, 2), b),
    ):
        got = kernel(off(x))
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), plain(x).cpu())


@pytest.mark.gpu
def test_etc_kernels_reject_bad_input(cuda):
    x = torch.zeros((8, 16, 4), device=cuda)
    one = (1.0, 1.0, 1.0)
    with pytest.raises(TypeError):
        etc_cuda.encode_etc_rgb_cuda(x.half(), 2, False, one)
    with pytest.raises(ValueError):
        etc_cuda.encode_etc_rgb_cuda(x[..., :2].contiguous(), 2, False, one)  # 2 channels
    with pytest.raises(ValueError):
        etc_cuda.encode_etc2_rgba_cuda(x[..., :3].contiguous(), 2, one)
    with pytest.raises(ValueError):
        etc_cuda.encode_eac_alpha_cuda(x[..., 3], 2)  # not contiguous
    with pytest.raises(ValueError):
        etc_cuda.encode_eac_r11_cuda(x[:, :8, 0].contiguous(), 2, False)
    with pytest.raises(ValueError):
        etc_cuda.encode_eac_rg11_cuda(x[..., :1].contiguous(), 2, False)
    with pytest.raises(ValueError):
        etc_cuda.encode_eac_r11_cuda(x[..., 0].contiguous(), 5, False)
    assert tuple(etc.encode_etc2_rgba(x[:0], 2).shape) == (0, 4)
    assert tuple(etc.encode_eac_rg11(x[:0], 2).shape) == (0, 4)


def _astc_input(bw, bh, kind, n):
    """Seeded blocks through the u8 wire: opaque colour, colour with alpha,
    near-gray (R = G = B up to a small spread) with alpha."""
    rng = np.random.default_rng(8)
    t = bw * bh
    b = np.clip(rng.random((n, 1, 4)) + rng.normal(0, 0.15, (n, t, 4)), 0, 1)
    b[::5] = b[::5, :1]  # flat
    if kind == "gray_alpha":
        b[..., 1] = np.clip(b[..., 0] + rng.normal(0, 0.01, (n, t)), 0, 1)
        b[..., 2] = b[..., 0]
    if kind == "color":
        b[..., 3] = 1.0
    return (np.round(b * 255) / 255).astype(np.float32)


# (block width, block height, quality, input kind) on the card: every entry,
# decimated grids and Gauss-Seidel (12x12).
_ASTC_CASES = [
    (4, 4, 0, "color"), (4, 4, 2, "alpha"), (4, 4, 4, "gray_alpha"), (6, 6, 2, "alpha"),
    (8, 8, 4, "gray_alpha"), (10, 5, 2, "color"), (12, 12, 2, "alpha"),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", _ASTC_CASES, ids=lambda c: f"{c[0]}x{c[1]}_q{c[2]}_{c[3]}")
def test_astc_kernel_matches_plain_on_card(cuda, case):
    """Each ASTC entry that the case runs: one launch of its own counter,
    >= 99 % blocks identical to the plain version's same stage (100 %
    expected), and the merged words alike."""
    bw, bh, q, kind = case
    b = _astc_input(bw, bh, kind, 1024)
    gray, alpha = astc_tables.has_gray_blocks(b), astc_tables.has_alpha_blocks(b)
    assert alpha == (kind != "color") and (gray or kind != "gray_alpha")
    x = torch.from_numpy(b).to(cuda)
    for stage in astc.stages(bw, bh, q, gray, alpha):
        before = dict(astc_cuda.launches)
        wk, ek = astc_cuda.stage_cuda(stage, x, bw, bh, q, gray, alpha)
        torch.cuda.synchronize()
        name = f"astc_{stage}"
        assert astc_cuda.launches == {**before, name: before[name] + 1}
        wp, ep = astc.stage_plain(stage, x, bw, bh, q, gray, alpha)
        wk, wp = wk.cpu().numpy(), wp.cpu().numpy()
        assert wk.shape == wp.shape == (1024, 4) and wk.dtype == wp.dtype == np.uint32
        assert np.all(wk == wp, axis=1).mean() >= 0.99, stage
    k = astc.encode_astc(x, bw, bh, q, gray, alpha).cpu().numpy()
    p = astc.encode_astc_plain(x, bw, bh, q, gray, alpha).cpu().numpy()
    assert np.all(k == p, axis=1).mean() >= 0.99


@pytest.mark.gpu
@pytest.mark.parametrize("bw", [4, 8, 12], ids=["4x4_q4", "8x8_q4", "12x12_q4"])
def test_astc_warp_entries_launch_shapes(cuda, bw):
    """Entries B (above 4x4), C and D run a warp per group of blocks, 4
    warps a CTA, with the pattern masks staged in dynamic shared memory (D
    at 12x12: above 48 KB; B with its texels in a device scratch).  A block
    count that leaves the last CTA part-filled, one block and none: words
    and errors equal the plain version's."""
    b = _astc_input(bw, bw, "gray_alpha", 600)
    gray, alpha = astc_tables.has_gray_blocks(b), astc_tables.has_alpha_blocks(b)
    assert astc.stages(bw, bw, 4, gray, alpha) == ["a", "b", "c", "d"]
    x = torch.from_numpy(b).to(cuda)
    if bw == 4:
        assert astc_cuda.warp_plan("b", bw, bw, 4, gray, alpha)["group"] == 0  # a thread per block
    for stage in ("b", "c", "d") if bw > 4 else ("c", "d"):
        plan = astc_cuda.warp_plan(stage, bw, bw, 4, gray, alpha)
        assert 1 <= plan["group"] <= 32 and plan["smem_bytes"] > plan["mask_bytes"] > 0
        assert (plan["scratch_bytes"] > 0) == (stage == "b")
        if bw == 12 and stage == "d":
            assert plan["smem_bytes"] > 48 * 1024
        n = 4 * plan["group"] * 2 + 3
        for m in (n, 1):
            wk, ek = astc_cuda.stage_cuda(stage, x[:m], bw, bw, 4, gray, alpha)
            torch.cuda.synchronize()
            wp, ep = astc.stage_plain(stage, x[:m], bw, bw, 4, gray, alpha)
            assert torch.equal(wk.view(torch.int32).cpu(), wp.view(torch.int32).cpu()), (stage, m)
            assert torch.equal(ek.cpu(), ep.cpu()), (stage, m)
        wk, ek = astc_cuda.stage_cuda(stage, x[:0], bw, bw, 4, gray, alpha)
        assert tuple(wk.shape) == (0, 4) and tuple(ek.shape) == (0,)


@pytest.mark.gpu
@pytest.mark.parametrize("case", [(4, 2, "color"), (4, 4, "gray_alpha"), (8, 2, "color"),
                                  (12, 2, "gray_alpha")],
                         ids=["4x4_q2", "4x4_q4_gray_alpha", "8x8_q2", "12x12_q2_gray_alpha"])
def test_astc_entry_a_at_group_edges(cuda, case):
    """Entry A runs a CTA per 32 blocks, a warp per task (the gray tasks on
    near-gray blocks only), its texels staged in shared memory (above 48 KB
    at 12x12): ragged batches give the plain version's words and errors."""
    bw, q, kind = case
    b = _astc_input(bw, bw, kind, 300)
    gray, alpha = astc_tables.has_gray_blocks(b), astc_tables.has_alpha_blocks(b)
    plan = astc_cuda.warp_plan("a", bw, bw, q, gray, alpha)
    assert plan["group"] == 32 and 1 <= plan["warps"] <= 8
    if bw == 12:
        assert plan["smem_bytes"] > 48 * 1024
    x = torch.from_numpy(b).to(cuda)
    for n in (1, 31, 33, 300):
        before = astc_cuda.launches["astc_a"]
        wk, ek = astc_cuda.stage_cuda("a", x[:n], bw, bw, q, gray, alpha)
        torch.cuda.synchronize()
        assert astc_cuda.launches["astc_a"] == before + 1
        wp, ep = astc.stage_plain("a", x[:n], bw, bw, q, gray, alpha)
        assert torch.equal(wk.view(torch.int32).cpu(), wp.view(torch.int32).cpu()), n
        assert torch.equal(ek.view(torch.int32).cpu(), ep.view(torch.int32).cpu()), n


@pytest.mark.gpu
@pytest.mark.parametrize("case", [(2, "alpha"), (4, "gray_alpha")], ids=["4x4_q2", "4x4_q4_gray_alpha"])
def test_astc_entry_b_4x4_at_group_edges(cuda, case):
    """Entry B at 4x4 runs a thread per block, 64 a CTA, the CTA's blocks
    staged in shared memory at an odd stride (no device scratch): one
    block, part-filled warps and CTAs give the plain version's words and
    errors, one launch each."""
    q, kind = case
    b = _astc_input(4, 4, kind, 65)
    gray, alpha = astc_tables.has_gray_blocks(b), astc_tables.has_alpha_blocks(b)
    assert "b" in astc.stages(4, 4, q, gray, alpha)
    plan = astc_cuda.warp_plan("b", 4, 4, q, gray, alpha)
    assert plan["group"] == 0 and plan["scratch_bytes"] == 0  # a thread per block
    x = torch.from_numpy(b).to(cuda)
    for n in (1, 31, 33, 65):
        before = astc_cuda.launches["astc_b"]
        wk, ek = astc_cuda.stage_cuda("b", x[:n], 4, 4, q, gray, alpha)
        torch.cuda.synchronize()
        assert astc_cuda.launches["astc_b"] == before + 1
        wp, ep = astc.stage_plain("b", x[:n], 4, 4, q, gray, alpha)
        assert torch.equal(wk.view(torch.int32).cpu(), wp.view(torch.int32).cpu()), n
        assert torch.equal(ek.view(torch.int32).cpu(), ep.view(torch.int32).cpu()), n


@pytest.mark.gpu
def test_astc_kernels_reject_bad_input(cuda):
    x = torch.zeros((8, 16, 4), device=cuda)
    with pytest.raises(TypeError):
        astc_cuda.stage_cuda("a", x.half(), 4, 4, 2)
    with pytest.raises(ValueError):
        astc_cuda.stage_cuda("b", x, 6, 6, 2)  # 16 texels, not 36
    with pytest.raises(ValueError):
        astc_cuda.stage_cuda("a", x.transpose(0, 1), 4, 4, 2)
    with pytest.raises(ValueError):
        astc_cuda.stage_cuda("a", x, 4, 4, 5)
    assert tuple(astc.encode_astc(x[:0], 4, 4, 2).shape) == (0, 4)
    assert tuple(astc_cuda.stage_cuda("d", x[:0], 4, 4, 4)[0].shape) == (0, 4)


def test_cpu_tensor_never_reaches_the_launcher(monkeypatch):
    def no_build(name):
        raise AssertionError("the CPU path must not build or load the kernel")

    monkeypatch.setattr(_build, "load", no_build)
    before = bc7_cuda.launches
    x = torch.zeros((4, 16, 4))
    with pytest.raises(ValueError, match="CUDA tensor"):
        bc7_cuda.encode_bc7_cuda(x, 2, _constants(False, x.device))
    encode_bc7(x, 2)  # the CPU runs the plain version
    assert bc7_cuda.launches == before
    counts = dict(bc_cuda.launches)
    with pytest.raises(ValueError, match="CUDA tensor"):
        bc_cuda.encode_bc1_cuda(x, 2, False, True, (1.0, 1.0, 1.0))
    with pytest.raises(ValueError, match="CUDA tensor"):
        bc_cuda.encode_bc4_cuda(x[..., 0].contiguous(), 2, False)
    bc.encode_bc1(x, 2)
    bc.encode_bc2(x, 2)
    bc.encode_bc3(x, 2)
    bc.encode_bc4(x[..., 0], 2)
    bc.encode_bc5(x, 2, True)
    assert bc_cuda.launches == counts
    hq, b6 = bc7_hq_cuda.launches, bc6h_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        bc7_hq_cuda.encode_bc7_hq_cuda(x, 4, _constants(False, x.device))
    with pytest.raises(ValueError, match="CUDA tensor"):
        bc6h_cuda.encode_bc6h_cuda(x[..., :3].contiguous(), 2, False, "value")
    encode_bc7(x, 3)
    bc6h.encode_bc6h(x[..., :3].contiguous(), 4, True)
    assert (bc7_hq_cuda.launches, bc6h_cuda.launches) == (hq, b6)
    counts = dict(etc_cuda.launches)
    with pytest.raises(ValueError, match="CUDA tensor"):
        etc_cuda.encode_etc_rgb_cuda(x, 2, True, (1.0, 1.0, 1.0))
    with pytest.raises(ValueError, match="CUDA tensor"):
        etc_cuda.encode_etc2_rgba_cuda(x, 2, (1.0, 1.0, 1.0))
    with pytest.raises(ValueError, match="CUDA tensor"):
        etc_cuda.encode_eac_alpha_cuda(x[..., 3].contiguous(), 2)
    with pytest.raises(ValueError, match="CUDA tensor"):
        etc_cuda.encode_eac_r11_cuda(x[..., 0].contiguous(), 2, False)
    with pytest.raises(ValueError, match="CUDA tensor"):
        etc_cuda.encode_eac_rg11_cuda(x, 2, True)
    etc.encode_etc_rgb(x, 1, True)
    etc.encode_etc2_rgba(x, 0)
    etc.encode_eac_alpha(x[..., 3], 2)
    etc.encode_eac_r11(x[..., 0], 2, True)
    etc.encode_eac_rg11(x, 2)
    assert etc_cuda.launches == counts
    counts = dict(astc_cuda.launches)
    for stage in "abcd":
        with pytest.raises(ValueError, match="CUDA tensor"):
            astc_cuda.stage_cuda(stage, x, 4, 4, 4)
    with pytest.raises(ValueError, match="CUDA tensor"):
        astc_cuda.encode_astc_cuda(x, 4, 4, 2)
    astc.encode_astc(x, 4, 4, 4)
    assert astc_cuda.launches == counts


# The benchmark's two cells' pyramids: (level 0 [S,H,W,4], levels, sRGB).
def _albedo_2048(device):
    """A 2048^2 sRGB RGBA surface rounded to 8 bits, alpha varying."""
    g = torch.Generator(device="cpu").manual_seed(24)
    y = torch.linspace(0, 1, 2048)[:, None, None]
    x = torch.linspace(0, 1, 2048)[None, :, None]
    base = 0.5 + 0.4 * torch.sin(torch.tensor([3.0, 5.0, 7.0, 2.0]) * 6.283 * (x + 0.7 * y))
    noise = torch.rand((2048, 2048, 4), generator=g) * 0.2
    return (torch.round((base * 0.8 + noise).clamp(0, 1) * 255) / 255)[None].to(device)


def _skybox_1024(device):
    """Six 1024^2 linear HDR faces: a sky gradient with 1 % noise, a sun of
    5,000 on face 1, alpha 1."""
    g = torch.Generator(device="cpu").manual_seed(24)
    y = torch.linspace(0, 1, 1024)[None, :, None, None]
    faces = (0.1 + 2.0 * y) * (1.0 + 0.01 * torch.randn((6, 1024, 1024, 4), generator=g))
    faces[1, 300:340, 500:540, :3] = 5000.0
    faces[..., 3] = 1.0
    return faces.to(device)


_CELLS = {
    "bc7_albedo_2048": (_albedo_2048, 12, True),
    "bc6h_skybox_cube1024": (_skybox_1024, 11, False),
}


@pytest.mark.gpu
@pytest.mark.parametrize("cell", list(_CELLS))
def test_pyramid_kernel_equals_torch_ops_on_card(cuda, cell):
    """The kernel's block batch is the torch ops' on the same CUDA tensor,
    bit for bit, one launch a level."""
    make, levels, srgb = _CELLS[cell]
    x = make(cuda)
    before = pyramid_cuda.launches
    got = conv_device.pyramid_blocks(x, levels, "catmullrom", srgb, 4, 4)
    torch.cuda.synchronize()
    assert pyramid_cuda.launches == before + levels
    want = conv_device.pyramid_blocks_plain(x, levels, "catmullrom", srgb, 4, 4)
    assert got.shape == want.shape
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("cell", list(_CELLS))
def test_fused_convert_counts_pyramid_launches_and_keeps_its_bytes(cuda, cell, monkeypatch):
    """convert_with_mips at the cell's size launches the pyramid kernel once
    a level, and writes the DDS bytes that the torch ops' pyramid gives."""
    make, levels, srgb = _CELLS[cell]
    x = make(torch.device("cpu")).numpy()
    cube = x.shape[0] == 6
    cs = cp.ColorSpace.sRGB if srgb else cp.ColorSpace.Linear
    fmt, typ = (cp.TextureFormat.BC6H, cp.TextureType.UFloat) if cube else (
        cp.TextureFormat.BC7, cp.TextureType.UNorm)

    def dds():
        tex = cp.Texture(cp.Dimension.Cube if cube else cp.Dimension.Dim2D, x.shape[2],
                         x.shape[1], 0, 1, cs, device=cuda)
        for f, face in enumerate(x):
            img = cp.Image.from_array(face, cp.ImageFormat.RGBAF, cs)
            assert tex.set_image(img, cp.CubeFace(f) if cube else None)
        assert tex.convert_with_mips(fmt, typ, cp.Quality.Highest)
        result, data = tex.save_to_bytes(cp.FileType.DDS)
        assert result is cp.SaveResult.Success
        return tex.last_convert_stats["launches"], data

    launches, data = dds()
    assert launches["pyramid"] == levels
    monkeypatch.setattr(conv_device, "pyramid_blocks", conv_device.pyramid_blocks_plain)
    plain_launches, plain_data = dds()
    assert "pyramid" not in plain_launches
    assert data == plain_data


def test_build_flags_and_sources():
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "--fmad=false" in flags
    assert "fast_math" not in flags and "fast-math" not in flags
    srcs = [p.name for p in _build._sources()]
    assert srcs == [
        "astc_encode.cu", "bc6h_encode.cu", "bc7_encode.cu", "bc7_hq_encode.cu", "bc_encode.cu",
        "etc_encode.cu", "pyramid.cu",
    ]
    # One library per source, keyed by its own hash.
    digests = {_build._digest(p) for p in _build._sources()}
    assert len(digests) == 7 and all(len(d) == 16 for d in digests)
    assert [p.name for p in map(_build._target, _build._sources())] == [
        "libastc_encode.so", "libbc6h_encode.so", "libbc7_encode.so", "libbc7_hq_encode.so",
        "libbc_encode.so", "libetc_encode.so", "libpyramid.so",
    ]


def test_shared_header_enters_the_build_hash(tmp_path, monkeypatch):
    """Both BC7 sources include csrc/bc7_common.cuh: a change to a header
    must change the library paths, so that no stale build is loaded."""
    for name in ("bc7_encode.cu", "bc7_hq_encode.cu"):
        assert '#include "bc7_common.cuh"' in (_build.CSRC / name).read_text()
    src = tmp_path / "k.cu"
    src.write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build._digest(src)
    (tmp_path / "h.cuh").write_text("// two\n")
    assert _build._digest(src) != before

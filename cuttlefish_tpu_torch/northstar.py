"""The north-star quality bars: the port's encoders against the native CPU
encoders (``native.*_encode_cpu``) on the JAX package's own test content.

The JAX package holds its encoders to independent CPU encoders of the same
algorithm class (``tests/test_cpu_reference.py``, ``tests/test_native.py``,
``tests/test_corpus.py``).  This module holds copies of that content (each
function names its original; ``tests/test_torch_cpu_reference.py`` holds
the copies to the originals) and computes each bar's two sides: the PSNR of
the port's public encoder, on the device asked for (a CPU tensor runs the
plain version, a CUDA tensor the hand kernel), and the PSNR of the CPU
encoder on the same blocks, both decoded with the port's decoders.  A bar
holds when the port's PSNR is at least the CPU encoder's minus ``TIE_DB``
(``EAC_A8_TOL`` and ``BC7_TOL`` where the reference uses those).

Every bar function takes ``device`` (the card unless the caller asks for
``"cpu"``) and ``threads`` (the CPU encoder's threads, 0: every core).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from cuttlefish_tpu_torch import native

# tests/test_cpu_reference.py:71 and tests/test_corpus.py:140.
TIE_DB = 0.05
# tests/test_cpu_reference.py:183 and tests/test_native.py:178.
EAC_A8_TOL = 1e-6
BC7_TOL = 1e-6

CLASSES = ["two_lerp", "two_pop", "gradient", "alpha_ramp", "noise"]

# tests/test_corpus.py:84: floors of decoded PSNR (peak 1) at quality 2.
FLOORS_Q2 = {
    ("bc7", "photo"): 41.0,
    ("bc7", "ui_atlas"): 47.5,
    ("bc7", "normal"): 33.4,
    ("astc", "photo"): 40.2,
    ("astc", "ui_atlas"): 47.3,
    ("astc", "normal"): 33.0,
    ("etc2", "photo"): 33.5,
    ("etc2", "ui_atlas"): 38.4,
    ("etc2", "normal"): 26.8,
}
# tests/fixtures/corpus/<image>.png, and (tests/test_corpus.py:146, :168
# and :191) the images of each vs-CPU bar.
CORPUS_IMAGES = ("photo", "ui_atlas", "normal")
CORPUS_VS_CPU = {"astc": ("photo", "ui_atlas", "normal"),
                 "etc2": ("photo", "ui_atlas", "normal"),
                 "bc7": ("photo", "normal")}
# tests/test_corpus.py:233 and :274: the HDR probe's floor (log PSNR).
HDR_PROBE_FLOOR = 30.0


# --- content: copies of the reference's helpers --------------------------


def content_blocks(name: str, n: int = 256, seed: int = 7) -> np.ndarray:
    """Named [N,16,4] float32 block batches (tools/quality_check.py classes)."""
    rng = np.random.default_rng(seed)
    if name == "two_lerp":
        c0 = rng.random((n, 1, 4), np.float32)
        c1 = rng.random((n, 1, 4), np.float32)
        t = rng.random((n, 16, 1), np.float32)
        out = c0 + (c1 - c0) * t
        out[..., 3] = 1.0
    elif name == "two_pop":
        pick = rng.random((n, 16, 1)) < 0.5
        ca = rng.random((n, 1, 4)).astype(np.float32)
        cb = rng.random((n, 1, 4)).astype(np.float32)
        out = np.where(pick, ca, cb).astype(np.float32)
        out += rng.normal(0, 0.02, out.shape).astype(np.float32)
        out[..., 3] = 1.0
    elif name == "gradient":
        y, x = np.mgrid[0:4, 0:4].astype(np.float32) / 4.0
        phase = rng.random((n, 1, 1, 3)).astype(np.float32)
        g = 0.5 + 0.5 * np.sin(
            3.0 * (x + y)[None, :, :, None] + phase * 6.28
        )
        out = np.concatenate(
            [g, np.ones((n, 4, 4, 1), np.float32)], axis=-1
        ).reshape(n, 16, 4)
    elif name == "alpha_ramp":
        c0 = rng.random((n, 1, 4), np.float32)
        c1 = rng.random((n, 1, 4), np.float32)
        t = rng.random((n, 16, 1), np.float32)
        out = c0 + (c1 - c0) * t
        out[..., 3] = (0.2 + 0.7 * rng.random((n, 16), np.float32))
    elif name == "noise":
        out = rng.random((n, 16, 4)).astype(np.float32)
        out[..., 3] = 1.0
    else:  # pragma: no cover
        raise ValueError(name)
    return np.clip(out, 0.0, 1.0).astype(np.float32)


def bc6h_content(name):
    """tests/test_cpu_reference.py:TestBc6hVsCpuReference._content."""
    rng = np.random.default_rng(13)
    if name == "lerp":
        c0 = rng.random((256, 1, 3), np.float32) * 8
        c1 = rng.random((256, 1, 3), np.float32) * 8
        t = rng.random((256, 16, 1), np.float32)
        return (c0 + (c1 - c0) * t).astype(np.float32)
    return (rng.random((256, 16, 3)) * 8).astype(np.float32)


def r11_content(content):
    """The values of tests/test_cpu_reference.py:
    test_eac_r11_psnr_not_below_cpu_reference."""
    rng = np.random.default_rng(17)
    if content == "ramp":
        v0 = rng.random((256, 1), np.float32)
        v1 = rng.random((256, 1), np.float32)
        t = rng.random((256, 16), np.float32)
        vals = (v0 + (v1 - v0) * t).astype(np.float32)
    else:
        vals = rng.random((256, 16)).astype(np.float32)
    return vals


def sized_content(name: str, bw: int, bh: int, n: int = 128) -> np.ndarray:
    """tests/test_cpu_reference.py:_sized_content."""
    rng = np.random.default_rng(23)
    T = bw * bh
    if name == "lerp":
        c0 = rng.random((n, 1, 4), np.float32)
        c1 = rng.random((n, 1, 4), np.float32)
        t = rng.random((n, T, 1), np.float32)
        out = np.clip(c0 + (c1 - c0) * t, 0, 1).astype(np.float32)
    else:  # two populations
        pick = rng.random((n, T, 1)) < 0.5
        out = np.where(
            pick, rng.random((n, 1, 4)), rng.random((n, 1, 4))
        ).astype(np.float32)
        out = np.clip(
            out + rng.normal(0, 0.02, out.shape), 0, 1
        ).astype(np.float32)
    out[..., 3] = 1.0
    return out


def bc7_content():
    """The blocks of tests/test_native.py:test_bc7_psnr_not_below_cpu_reference."""
    rng = np.random.default_rng(42)
    n = 256
    # Two-color-lerp blocks + noise: representative texture content.
    c0 = rng.random((n, 1, 4), np.float32)
    c1 = rng.random((n, 1, 4), np.float32)
    t = rng.random((n, 16, 1), np.float32)
    blocks = np.clip(
        c0 + (c1 - c0) * t
        + rng.normal(0, 0.02, (n, 16, 4)).astype(np.float32),
        0, 1,
    ).astype(np.float32)
    return blocks


def corpus_blocks(surface: np.ndarray, bw: int = 4, bh: int = 4) -> np.ndarray:
    """tests/test_corpus.py:_blocks."""
    h, w, c = surface.shape
    nby, nbx = h // bh, w // bw
    return (
        surface.reshape(nby, bh, nbx, bw, c)
        .transpose(0, 2, 1, 3, 4)
        .reshape(nby * nbx, bh * bw, c)
    )


def probe_blocks(hdr_probe: np.ndarray) -> np.ndarray:
    """[N,16,4] blocks of the HDR probe (RGB, alpha 1), as
    tests/test_corpus.py:test_bc6h_hdr_probe and test_astc_hdr_probe
    make them."""
    surface = np.concatenate(
        [hdr_probe, np.ones((*hdr_probe.shape[:2], 1), np.float32)], -1
    )
    return corpus_blocks(surface)


# --- measures: copies of the reference's PSNRs ---------------------------


def _psnr(dec: np.ndarray, ref: np.ndarray) -> float:
    """tests/test_cpu_reference.py:_psnr (peak 255)."""
    mse = ((dec.astype(np.float64) - ref.astype(np.float64)) ** 2).mean()
    return 10 * np.log10(255.0**2 / max(mse, 1e-12))


def _psnr1(dec: np.ndarray, ref: np.ndarray) -> float:
    """tests/test_corpus.py:_psnr (peak 1)."""
    mse = ((dec.astype(np.float64) - ref.astype(np.float64)) ** 2).mean()
    return 10 * np.log10(1.0 / max(mse, 1e-12))


def _log_psnr(dec, b):
    """tests/test_cpu_reference.py:TestBc6hVsCpuReference._log_psnr."""
    a = np.log2(np.maximum(dec[..., :3], 1e-6))
    r = np.log2(np.maximum(b, 1e-6))
    mse = ((a - r) ** 2).mean()
    span = r.max() - r.min()
    return 10 * np.log10(span * span / max(mse, 1e-12))


def _lin_psnr(dec, b):
    """tests/test_cpu_reference.py:TestBc6hVsCpuReference._lin_psnr."""
    mse = ((dec[..., :3] - b) ** 2).mean()
    peak = float(b.max())
    return 10 * np.log10(peak * peak / max(mse, 1e-12))


def _hdr_log_psnr(dec16, rgb):
    """tests/test_cpu_reference.py:TestAstcHdrVsCpuReference._log_psnr:
    the decoder's half bits, log-domain PSNR."""
    dec = (
        np.frombuffer(
            np.ascontiguousarray(dec16[..., :3]).astype("<u2").tobytes(),
            np.float16,
        )
        .reshape(rgb.shape)
        .astype(np.float64)
    )
    a = np.log2(np.maximum(dec, 1e-6))
    r = np.log2(np.maximum(rgb, 1e-6))
    mse = ((a - r) ** 2).mean()
    span = r.max() - r.min()
    return 10 * np.log10(span * span / max(mse, 1e-12))


def _raw(words) -> np.ndarray:
    """Words of the port ([N,k] uint32 tensor) or of a CPU encoder ([N,k]
    uint32 or uint8 array) -> flat little-endian bytes."""
    if isinstance(words, torch.Tensor):
        words = words.cpu().numpy()
    words = np.asarray(words)
    if words.dtype != np.uint8:
        words = words.astype("<u4")
    return np.ascontiguousarray(words).view(np.uint8).reshape(-1)


def _on(x: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


# --- the bars: (PSNR of the port, PSNR of the CPU encoder) ---------------


def astc4x4(content: str, quality: int, device="cuda", threads: int = 0):
    """tests/test_cpu_reference.py:128."""
    from cuttlefish_tpu_torch.decode.astc import decode_astc
    from cuttlefish_tpu_torch.kernels.astc import encode_astc

    blocks = content_blocks(content)
    ref = blocks * 255.0
    wt = encode_astc(_on(blocks, device), 4, 4, quality=quality)
    p_port = _psnr(decode_astc(_raw(wt), 4, 4), ref)
    wc = native.astc4x4_encode_cpu(blocks, quality=quality, threads=threads)
    p_cpu = _psnr(decode_astc(_raw(wc), 4, 4), ref)
    return p_port, p_cpu


def etc2_rgb(content: str, quality: int, device="cuda", threads: int = 0):
    """tests/test_cpu_reference.py:149."""
    from cuttlefish_tpu_torch.decode.etc import decode_etc_rgb
    from cuttlefish_tpu_torch.kernels.etc import encode_etc_rgb

    blocks = content_blocks(content)
    ref = blocks[..., :3] * 255.0
    wt = encode_etc_rgb(_on(blocks, device), quality=quality, etc2=True)
    p_port = _psnr(decode_etc_rgb(_raw(wt), etc2=True), ref)
    wc = native.etc2_rgb_encode_cpu(blocks, quality=quality, threads=threads)
    p_cpu = _psnr(decode_etc_rgb(_raw(wc), etc2=True), ref)
    return p_port, p_cpu


def bc1(content: str, quality: int, device="cuda", threads: int = 0):
    """tests/test_cpu_reference.py:194."""
    from cuttlefish_tpu_torch.decode.s3tc import decode_bc1
    from cuttlefish_tpu_torch.kernels.bc import encode_bc1

    blocks = content_blocks(content)
    ref = blocks[..., :3] * 255.0
    wt = encode_bc1(_on(blocks, device), quality=quality)
    p_port = _psnr(decode_bc1(_raw(wt))[..., :3], ref)
    wc = native.bc1_encode_cpu(blocks, quality=quality, threads=threads)
    p_cpu = _psnr(decode_bc1(_raw(wc))[..., :3], ref)
    return p_port, p_cpu


def eac_a8(quality: int, device="cuda", threads: int = 0):
    """tests/test_cpu_reference.py:166 (bar: ``EAC_A8_TOL``)."""
    from cuttlefish_tpu_torch.decode.etc import decode_eac_alpha
    from cuttlefish_tpu_torch.kernels.etc import encode_eac_alpha

    blocks = content_blocks("alpha_ramp")
    refa = blocks[..., 3] * 255.0
    wt = encode_eac_alpha(_on(blocks[..., 3], device), quality=quality)
    p_port = _psnr(decode_eac_alpha(_raw(wt)), refa)
    wc = native.eac_a8_encode_cpu(blocks, quality=quality, threads=threads)
    p_cpu = _psnr(decode_eac_alpha(_raw(wc)), refa)
    return p_port, p_cpu


def bc4(quality: int, device="cuda", threads: int = 0):
    """tests/test_cpu_reference.py:215."""
    from cuttlefish_tpu_torch.decode.s3tc import decode_bc4
    from cuttlefish_tpu_torch.kernels.bc import encode_bc4

    blocks = content_blocks("alpha_ramp")
    refa = blocks[..., 3] * 255.0
    wt = encode_bc4(_on(blocks[..., 3], device), quality=quality)
    p_port = _psnr(decode_bc4(_raw(wt)) * 255.0, refa)
    wc = native.bc4_encode_cpu(blocks, quality=quality, channel=3, threads=threads)
    p_cpu = _psnr(decode_bc4(_raw(wc)) * 255.0, refa)
    return p_port, p_cpu


def _bc6h_port(b, quality, metric, device):
    from cuttlefish_tpu_torch.decode.bc6h import decode_bc6h_f32
    from cuttlefish_tpu_torch.kernels.bc6h import encode_bc6h

    return decode_bc6h_f32(_raw(encode_bc6h(_on(b, device), quality, metric=metric)))


def _bc6h_cpu(b, quality, threads):
    from cuttlefish_tpu_torch.decode.bc6h import decode_bc6h_f32

    return decode_bc6h_f32(_raw(native.bc6h_encode_cpu(b, quality=quality, threads=threads)))


def bc6h_code(content: str, quality: int, device="cuda", threads: int = 0):
    """tests/test_cpu_reference.py:267: the code metric, log-domain PSNR."""
    b = bc6h_content(content)
    return (_log_psnr(_bc6h_port(b, quality, "code", device), b),
            _log_psnr(_bc6h_cpu(b, quality, threads), b))


def bc6h_value(quality: int, device="cuda", threads: int = 0):
    """tests/test_cpu_reference.py:283: the value metric, linear PSNR."""
    b = bc6h_content("lerp")
    return (_lin_psnr(_bc6h_port(b, quality, "value", device), b),
            _lin_psnr(_bc6h_cpu(b, quality, threads), b))


def bc6h_ladder(device="cuda", qualities=(0, 2, 4)) -> list[float]:
    """tests/test_cpu_reference.py:298: the code metric's log PSNR at each
    quality; the bar is a ladder that does not fall."""
    b = bc6h_content("lerp")
    return [_log_psnr(_bc6h_port(b, q, "code", device), b) for q in qualities]


def eac_r11(content: str, quality: int, device="cuda", threads: int = 0):
    """tests/test_cpu_reference.py:318 (peak 1)."""
    from cuttlefish_tpu_torch.decode.etc import decode_eac_r11
    from cuttlefish_tpu_torch.kernels.etc import encode_eac_r11

    vals = r11_content(content)
    dt = decode_eac_r11(_raw(encode_eac_r11(_on(vals, device), quality=quality)))
    dc = decode_eac_r11(_raw(native.eac_r11_encode_cpu(vals, quality=quality, threads=threads)))
    return (10 * np.log10(1.0 / max(((dt - vals) ** 2).mean(), 1e-12)),
            10 * np.log10(1.0 / max(((dc - vals) ** 2).mean(), 1e-12)))


def astc_sized(bw: int, bh: int, content: str, quality: int, device="cuda",
               threads: int = 0):
    """tests/test_cpu_reference.py:437."""
    from cuttlefish_tpu_torch.decode.astc import decode_astc
    from cuttlefish_tpu_torch.kernels.astc import encode_astc

    blocks = sized_content(content, bw, bh)
    ref = blocks * 255.0
    wt = encode_astc(_on(blocks, device), bw, bh, quality=quality)
    p_port = _psnr(decode_astc(_raw(wt), bw, bh), ref)
    wc = native.astc_sized_encode_cpu(blocks, bw, bh, quality=quality, threads=threads)
    p_cpu = _psnr(decode_astc(_raw(wc), bw, bh), ref)
    return p_port, p_cpu


def bc7(quality: int, device="cuda", threads: int = 0):
    """tests/test_native.py:150 (bar: ``BC7_TOL``)."""
    from cuttlefish_tpu_torch.decode.bc7 import decode_bc7
    from cuttlefish_tpu_torch.kernels.bc7 import encode_bc7

    blocks = bc7_content()
    ref = np.clip(np.round(blocks * 255), 0, 255)

    def psnr(words):
        dec = decode_bc7(_raw(words)).astype(np.float64)
        mse = ((dec - ref) ** 2).mean()
        return 10 * np.log10(255.0**2 / mse)

    return (psnr(encode_bc7(_on(blocks, device), quality)),
            psnr(native.bc7_encode_cpu(blocks, quality, threads=threads)))


_CORPUS_CPU = {
    "bc7": lambda b, threads: native.bc7_encode_cpu(b, 2, threads=threads),
    "astc": lambda b, threads: native.astc4x4_encode_cpu(b, quality=2, threads=threads),
    "etc2": lambda b, threads: native.etc2_rgb_encode_cpu(b, quality=2, threads=threads),
}


def corpus(family: str, blocks: np.ndarray, device="cuda", threads: int = 0, cpu: bool = True):
    """tests/test_corpus.py:_encode_decode and the PSNR of its floors and
    vs-CPU bars (peak 1; ETC2 on RGB) at quality 2 -> (the port's PSNR,
    the CPU encoder's on the same blocks, or None without ``cpu``).  Both
    sides' words are decoded in one pass, each distinct block once."""
    raws = [_corpus_port_raw(family, blocks, device)]
    if cpu:
        raws.append(_raw(_CORPUS_CPU[family](blocks, threads)))
    psnrs = _corpus_psnrs(family, blocks, raws)
    return psnrs[0], (psnrs[1] if cpu else None)


def _corpus_port_raw(family, blocks, device):
    from cuttlefish_tpu_torch.kernels.astc import encode_astc
    from cuttlefish_tpu_torch.kernels.bc7 import encode_bc7
    from cuttlefish_tpu_torch.kernels.etc import encode_etc_rgb

    x = _on(blocks, device)
    if family == "bc7":
        return _raw(encode_bc7(x, quality=2))
    if family == "astc":
        return _raw(encode_astc(x, 4, 4, quality=2))
    if family == "etc2":
        return _raw(encode_etc_rgb(x, quality=2, etc2=True))
    raise ValueError(family)


def _decode_unique(decode, raws, block_bytes):
    """``decode`` (a per-block loop) of each distinct block of ``raws``
    once, then spread back to each raw: an image's flat fills repeat one
    block many times, and two encoders often write the same block."""
    rows = [r.reshape(-1, block_bytes) for r in raws]
    uniq, inv = np.unique(np.concatenate(rows), axis=0, return_inverse=True)
    dec = decode(uniq.reshape(-1))[inv.reshape(-1)]
    return np.split(dec, np.cumsum([len(r) for r in rows])[:-1])


def _corpus_psnrs(family, blocks, raws):
    from cuttlefish_tpu_torch.decode.astc import decode_astc
    from cuttlefish_tpu_torch.decode.bc7 import decode_bc7
    from cuttlefish_tpu_torch.decode.etc import decode_etc_rgb

    if family == "bc7":
        return [_psnr1(d / 255.0, blocks) for d in _decode_unique(decode_bc7, raws, 16)]
    if family == "astc":
        decs = _decode_unique(lambda r: decode_astc(r, 4, 4), raws, 16)
        return [_psnr1(d / 255.0, blocks) for d in decs]
    decs = _decode_unique(lambda r: decode_etc_rgb(r, etc2=True), raws, 8)
    return [_psnr1(d / 255.0, blocks[..., :3]) for d in decs]


def bc6h_probe(probe: np.ndarray, device="cuda") -> tuple[float, float, float]:
    """tests/test_corpus.py:215 on ``probe_blocks``: the value metric's log
    PSNR at quality 2 (floor ``HDR_PROBE_FLOOR``) and the code metric's at
    2 and 4 (a ladder that does not fall)."""
    blocks = np.ascontiguousarray(probe[..., :3])

    def log_psnr(quality, metric):
        dec = _bc6h_port(blocks, quality, metric, device)
        a = np.log2(np.maximum(dec[..., :3], 1e-6))
        b = np.log2(np.maximum(blocks, 1e-6))
        mse = ((a - b) ** 2).mean()
        # range-normalized over the probe's ~11.8-stop span
        span = b.max() - b.min()
        return 10 * np.log10(span**2 / max(mse, 1e-12))

    return log_psnr(2, "value"), log_psnr(2, "code"), log_psnr(4, "code")


def astc_hdr_probe(blocks: np.ndarray, device="cuda", threads: int = 0):
    """tests/test_corpus.py:250 on ``probe_blocks``: ASTC 4x4 HDR at
    quality 2 (floor ``HDR_PROBE_FLOOR``, and the CPU encoder's bar)."""
    from cuttlefish_tpu_torch.decode.astc import decode_astc_hdr
    from cuttlefish_tpu_torch.kernels.astc_hdr import encode_astc_hdr

    rgb = blocks[..., :3]
    wt = encode_astc_hdr(_on(blocks, device), 4, 4, quality=2)
    p_port = _hdr_log_psnr(decode_astc_hdr(_raw(wt), 4, 4), rgb)
    wc = native.astc_hdr_encode_cpu(blocks, quality=2, threads=threads)
    p_cpu = _hdr_log_psnr(decode_astc_hdr(_raw(wc), 4, 4), rgb)
    return p_port, p_cpu


# --- every quality-2 bar, as chip_smoke.py phase 7 runs them -------------

_ASTC_AB = ("astc_a", "astc_b")
_CORPUS_KERNELS = {"bc7": ("bc7",), "astc": _ASTC_AB, "etc2": ("etc_rgb",)}


def bars_q2(device="cuda", threads: int = 0) -> dict:
    """The quality-2 bars on block batches: label -> (a function giving
    (the port's PSNR, the CPU encoder's), the tolerance, the hand kernels
    the port's side launches on a card)."""
    bars = {}
    for c in CLASSES:
        bars[f"astc4x4 {c}"] = (lambda c=c: astc4x4(c, 2, device, threads), TIE_DB, _ASTC_AB)
        bars[f"etc2_rgb {c}"] = (lambda c=c: etc2_rgb(c, 2, device, threads), TIE_DB,
                                 ("etc_rgb",))
        bars[f"bc1 {c}"] = (lambda c=c: bc1(c, 2, device, threads), TIE_DB, ("bc1",))
    bars["eac_a8 alpha_ramp"] = (lambda: eac_a8(2, device, threads), EAC_A8_TOL, ("eac_alpha",))
    bars["bc4 alpha_ramp"] = (lambda: bc4(2, device, threads), TIE_DB, ("bc4",))
    for c in ("lerp", "noise"):
        bars[f"bc6h code {c}"] = (lambda c=c: bc6h_code(c, 2, device, threads), TIE_DB, ("bc6h",))
    bars["bc6h value lerp"] = (lambda: bc6h_value(2, device, threads), TIE_DB, ("bc6h",))
    for c in ("ramp", "noise"):
        bars[f"eac_r11 {c}"] = (lambda c=c: eac_r11(c, 2, device, threads), TIE_DB, ("eac_r11",))
    for b in (6, 8, 10, 12):
        for c in ("lerp", "pop"):
            bars[f"astc{b}x{b} {c}"] = (lambda b=b, c=c: astc_sized(b, b, c, 2, device, threads),
                                        TIE_DB, _ASTC_AB)
    bars["bc7 test_native"] = (lambda: bc7(2, device, threads), BC7_TOL, ("bc7",))
    return bars


def run(device, threads: int, corpus_dir, call=None, out=print) -> list[str]:
    """Every quality-2 bar: ``bars_q2``, then BC7, ASTC and ETC2 on the
    three images of ``corpus_dir`` (the JAX package's tests/fixtures/corpus)
    with their floors, and the HDR probe through BC6H and ASTC HDR.
    ``call(label, fn, kernels)`` runs each bar (default ``fn()``:
    chip_smoke.py counts launches there); ``out`` takes a line a bar.
    -> the labels of the bars missed."""
    from cuttlefish_tpu_torch.image.image import Image

    call = call or (lambda label, fn, kernels: fn())
    misses = []

    def line(label, p_port, p_cpu, tol):
        margin = p_port - p_cpu
        if not margin >= -tol:
            misses.append(label)
        out(f"{label} q2: port {p_port:.4f} dB, CPU encoder {p_cpu:.4f} dB, margin "
            f"{margin:+.4f} dB (bar >= -{tol})")

    for label, (fn, tol, kernels) in bars_q2(device, threads).items():
        line(label, *call(label, fn, kernels), tol)
    for image in CORPUS_IMAGES:
        img = Image(os.path.join(corpus_dir, f"{image}.png"))
        if not img.valid:
            raise ValueError(f"corpus image {image} did not load")
        blocks = corpus_blocks(np.asarray(img.rgbaf(), np.float32))
        for family, kernels in _CORPUS_KERNELS.items():
            label = f"corpus {image} {family}"
            vs_cpu = image in CORPUS_VS_CPU[family]
            p_port, p_cpu = call(label, lambda: corpus(family, blocks, device, threads, vs_cpu),
                                 kernels)
            floor = FLOORS_Q2[(family, image)]
            if not p_port >= floor:
                misses.append(f"{label} floor")
            out(f"{label} q2: port {p_port:.4f} dB, floor {floor} dB")
            if vs_cpu:
                line(label, p_port, p_cpu, TIE_DB)
    probe = probe_blocks(np.load(os.path.join(corpus_dir, "hdr_probe.npy")))
    p2, pc2, pc4 = call("hdr probe bc6h", lambda: bc6h_probe(probe, device), ("bc6h",))
    if not (p2 >= HDR_PROBE_FLOOR and pc4 >= pc2 - 1e-9):
        misses.append("hdr probe bc6h")
    out(f"hdr probe bc6h: value q2 {p2:.4f} dB (floor {HDR_PROBE_FLOOR}), code q2 {pc2:.4f} dB, "
        f"code q4 {pc4:.4f} dB (a ladder that does not fall)")
    p_port, p_cpu = call("hdr probe astc_hdr",
                         lambda: astc_hdr_probe(probe, device, threads), ())
    if not p_port >= HDR_PROBE_FLOOR:
        misses.append("hdr probe astc_hdr floor")
    line("hdr probe astc_hdr (torch ops, no hand kernel)", p_port, p_cpu, TIE_DB)
    return misses


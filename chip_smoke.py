#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (cuttlefish_tpu_torch) on one GPU.

    python3 chip_smoke.py

Drives the port's paths once at the bench size, on 2048x2048 RGBA
surfaces made from a seed (the formula of bench.py:_test_surface, seed 0,
plus an alpha variant and a signed variant), through the hand-written CUDA
kernels, and reads every file back.  Phases, one line each; any failure
exits non-zero:

1. device: needs a CUDA device (no CPU fallback); prints the card's name
   and power limit (nvidia-smi), torch and CUDA versions; TF32 off.
2. build: one nvcc per csrc/*.cu for sm_90a, all started together, and the
   native codecs with g++; prints the seconds and what ptxas reports
   (registers, spills) for every kernel entry.
3. kernel vs plain: the 262,144 blocks of the surface through each kernel
   and through its plain PyTorch version on the card: >= 99 % identical
   blocks, |dPSNR| <= 0.05 dB on a decoded sample of 4,096 blocks.  BC7 q2;
   BC1 q0-q4 (with black), BC1 q2 punch-through on a hard-alpha surface,
   BC2, BC3, BC4 unsigned at q2; BC4 and BC5 signed at q2 on 2x-1 through
   the f16 wire.
4. paths: Texture(device=cuda).convert(...) then save, load_texture and a
   payload check, each with every launch counter set to 0 just before and
   read just after (the kernel must have launched, no plain version may
   have run): the main path BC7 q2 2048^2 + mips -> DDS; this slice's
   BC1_RGB 2048^2 -> DDS, BC1_RGB 512^2 -> DDS, BC3 2048^2 + mips -> KTX,
   BC5 SNorm 2048^2 + mips -> KTX; and BC1_RGBA, BC2, BC4 UNorm and BC4
   SNorm through the same converters.  Level-0 sample blocks must equal the
   plain version on the same wire input.
5. times: CUDA events, one warm-up, median of 7: each kernel alone and its
   plain version alone on the 262,144 blocks; each main-path convert (host
   clock, synchronised) median of 5 with its phases.

Then one JSON line of kernels (launches from the paths of phase 4; bound_ms
from this run's inputs: the larger of the bytes the function must move over
3.35 TB/s and the plain version's elementwise operations, counted per block
by a dispatch hook, over 67 TFLOP/s), and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

SIZE = 2048
SMALL = 512
QUALITY = 2
SAMPLE_STRIDE = 64  # 262,144 / 64 = 4,096 decoded blocks
MIN_SAME = 0.99
MAX_DPSNR = 0.05
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores, published


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def test_surface(size: int) -> np.ndarray:
    """bench.py:_test_surface, reproduced (no JAX import)."""
    rng = np.random.default_rng(0)
    y, x = np.mgrid[0:size, 0:size].astype(np.float32) / size
    surf = np.stack(
        [
            0.5 + 0.5 * np.sin(6.0 * x + 2.0 * y),
            0.5 + 0.5 * np.cos(4.0 * y + x),
            0.5 + 0.5 * np.sin(3.0 * (x + y)),
            np.ones_like(x),
        ],
        axis=-1,
    ).astype(np.float32)
    surf += rng.normal(0, 0.02, surf.shape).astype(np.float32)
    surf = np.clip(surf, 0.0, 1.0)
    surf[..., 3] = 1.0
    return surf


def alpha_surface(surf: np.ndarray) -> np.ndarray:
    """The test surface with a smooth, noisy alpha (BC2, BC3, BC4)."""
    size = surf.shape[0]
    rng = np.random.default_rng(1)
    y, x = np.mgrid[0:size, 0:size].astype(np.float32) / size
    out = surf.copy()
    a = 0.5 + 0.45 * np.cos(5.0 * x + 3.0 * y) + rng.normal(0, 0.02, x.shape)
    out[..., 3] = np.clip(a, 0.0, 1.0).astype(np.float32)
    return out


def hard_alpha_surface(surf: np.ndarray) -> np.ndarray:
    """The test surface with a 0/1 alpha pattern that cuts through blocks
    (BC1 punch-through)."""
    size = surf.shape[0]
    y, x = np.mgrid[0:size, 0:size].astype(np.float32) / size
    out = surf.copy()
    out[..., 3] = (np.sin(97.0 * x) * np.sin(61.0 * y) > -0.2).astype(np.float32)
    return out


def psnr(dec, target, peak) -> float:
    mse = ((np.asarray(dec, np.float64) - target) ** 2).mean()
    return float(10 * np.log10(peak**2 / (mse + 1e-20)))


def to_bytes(words: np.ndarray) -> np.ndarray:
    return np.frombuffer(np.ascontiguousarray(words.astype("<u4")).tobytes(), np.uint8)


def event_ms(torch, fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def ops_per_block(torch, fn, blocks) -> float:
    """Elementwise operations per block of a plain version: every aten op
    other than views, copies and allocation counts the larger of its input
    and output element counts (a reduction over 16 texels counts 16)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    skip = {
        "view", "_unsafe_view", "select", "slice", "permute", "t", "transpose",
        "expand", "unsqueeze", "squeeze", "alias", "detach", "clone", "copy_",
        "contiguous", "empty", "empty_like", "zeros", "zeros_like", "ones",
        "ones_like", "full", "full_like", "lift_fresh", "stack", "cat",
        "scalar_tensor", "_local_scalar_dense", "new_empty", "empty_strided",
        "_to_copy", "unbind",
    }

    def numel(x):
        if isinstance(x, torch.Tensor):
            return x.numel()
        if isinstance(x, (list, tuple)):
            return max([numel(v) for v in x] or [0])
        return 0

    class Counter(TorchDispatchMode):
        ops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func.overloadpacket.__name__.rstrip("_") not in skip:
                Counter.ops += max(numel(out), max([numel(a) for a in args] or [0]))
            return out

    with Counter():
        fn(blocks)
    return Counter.ops / blocks.shape[0]


def ptxas_lines(log_text: str) -> list[str]:
    keep = ("Compiling entry", "registers", "spill")
    return [ln.strip() for ln in log_text.splitlines() if any(k in ln for k in keep)]


def main() -> int:
    import torch

    # 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs a GPU", file=sys.stderr)
        return 2
    import cuttlefish_tpu_torch as cp
    from cuttlefish_tpu_torch import native
    from cuttlefish_tpu_torch.convert.blocks import extract_blocks
    from cuttlefish_tpu_torch.convert.device import dequant, wire
    from cuttlefish_tpu_torch.decode import (
        decode_bc1, decode_bc2, decode_bc3, decode_bc4, decode_bc5, decode_bc7,
    )
    from cuttlefish_tpu_torch.kernels import _build, bc, bc7_cuda, bc_cuda, launch_counts
    from cuttlefish_tpu_torch.kernels.bc7 import _constants, encode_bc7, encode_bc7_plain

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0].strip()
    print(card, flush=True)
    log("device", f"{torch.cuda.get_device_name(0)}; torch {torch.__version__}; "
        f"CUDA {torch.version.cuda}; capability {torch.cuda.get_device_capability(0)}; "
        f"count {torch.cuda.device_count()}; tf32 off")

    # 2. build
    t0 = time.perf_counter()
    for name in ("bc7_encode", "bc_encode"):
        _build.load(name)
    build_s = time.perf_counter() - t0
    for name, info in sorted(_build.build_info.items()):
        check(info["path"].startswith(str(_build.build_dir())), "library outside the build dir")
        log("build", f"{name}.cu -> {info['path']} (built={info['built']}, "
            f"{info['seconds']:.2f} s)")
        for line in ptxas_lines(info["log"]):
            log("build", f"ptxas {name}: {line}")
    log("build", f"nvcc {' '.join(_build.NVCC_FLAGS)}: {build_s:.2f} s for "
        f"{[p.name for p in _build._sources()]}, one nvcc each, in parallel")
    t0 = time.perf_counter()
    check(native.available(), f"native codecs did not build: {native.load_error()}")
    log("build", f"native codecs (g++) in {time.perf_counter() - t0:.2f} s")

    # 3. kernel vs plain on the card
    surf = test_surface(SIZE)
    asurf = alpha_surface(surf)
    hsurf = hard_alpha_surface(surf)
    ssurf = surf * 2.0 - 1.0
    host = {k: extract_blocks(v, 4, 4)[0] for k, v in
            (("rgba", surf), ("alpha", asurf), ("hard", hsurf), ("signed", ssurf))}
    n = host["rgba"].shape[0]
    check(n == 262144, f"expected 262144 blocks, got {n}")
    dev_in = {
        "rgba": torch.from_numpy(host["rgba"]).to(dev),
        "alpha": torch.from_numpy(host["alpha"]).to(dev),
        "hard": torch.from_numpy(host["hard"]).to(dev),
        "signed": dequant(wire(host["signed"], "f16").to(dev)),
    }
    dev_in["alpha1"] = dev_in["alpha"][..., 3].contiguous()  # BC4 unsigned: alpha
    dev_in["signed1"] = dev_in["signed"][..., 0].contiguous()  # BC4 signed: red
    sample = np.arange(0, n, SAMPLE_STRIDE)
    srgb = bc.channel_weights(np.float32([0.3, 0.59, 0.11]) * np.float32(3))
    consts = _constants(False, dev)

    def dec_rgb(raw):
        return decode_bc1(raw, opaque=True)[..., :3]

    # name -> (kernel, plain, input, decoder, target channels, peak)
    cases = {
        "bc7_q2": (lambda x: encode_bc7(x, 2),
                   lambda x: encode_bc7_plain(x, 2, _constants(False, x.device)),
                   "rgba", decode_bc7, slice(0, 4), 255.0),
        "bc2_q2": (lambda x: bc.encode_bc2(x, 2), lambda x: bc.encode_bc2_plain(x, 2),
                   "alpha", decode_bc2, slice(0, 4), 255.0),
        "bc3_q2": (lambda x: bc.encode_bc3(x, 2), lambda x: bc.encode_bc3_plain(x, 2),
                   "alpha", decode_bc3, slice(0, 4), 255.0),
        "bc4_q2": (lambda x: bc.encode_bc4(x, 2), lambda x: bc.encode_bc4_plain(x, 2),
                   "alpha1", decode_bc4, None, 1.0),
        "bc4s_q2": (lambda x: bc.encode_bc4(x, 2, True),
                    lambda x: bc.encode_bc4_plain(x, 2, True),
                    "signed1", lambda r: decode_bc4(r, signed=True), None, 2.0),
        "bc5s_q2": (lambda x: bc.encode_bc5(x, 2, True),
                    lambda x: bc.encode_bc5_plain(x, 2, True),
                    "signed", lambda r: decode_bc5(r, signed=True), slice(0, 2), 2.0),
        "bc1_q2_punch": (lambda x: bc.encode_bc1(x, 2, True, False),
                         lambda x: bc.encode_bc1_plain(x, 2, True, False),
                         "hard", decode_bc1, slice(0, 4), 255.0),
    }
    for q in range(5):
        cases[f"bc1_q{q}"] = (
            lambda x, q=q: bc.encode_bc1(x, q), lambda x, q=q: bc.encode_bc1_plain(x, q),
            "rgba", dec_rgb, slice(0, 3), 255.0,
        )
    cases["bc1_q2_srgb"] = (
        lambda x: bc.encode_bc1(x, 2, ch_weights=srgb),
        lambda x: bc.encode_bc1_plain(x, 2, chw=srgb), "rgba", dec_rgb, slice(0, 3), 255.0,
    )

    def target_of(kind, chans):
        """What the sample should decode to: 8-bit texels of the source for
        the colour formats, the float input for BC4 and BC5."""
        if kind in ("alpha1", "signed1", "signed"):
            vals = dev_in[kind].cpu().numpy()[sample].astype(np.float64)
            return vals if chans is None else vals[..., chans]
        src = host[kind][sample]
        t = np.clip(np.round(src * 255), 0, 255)
        if kind == "hard":  # transparent texels decode to black, alpha 0
            opaque = src[..., 3:] >= 0.5
            t = np.where(opaque, t, 0.0)
            t[..., 3] = np.where(opaque[..., 0], 255.0, 0.0)
        return t[..., chans]

    max_err = {}
    for name, (kernel, plain, kind, decode, chans, peak) in cases.items():
        x = dev_in[kind]
        k_np = kernel(x).cpu().numpy()
        p_np = plain(x).cpu().numpy()
        torch.cuda.synchronize()
        same = float(np.all(k_np == p_np, axis=1).mean())
        dk = np.asarray(decode(to_bytes(k_np[sample])), np.float64)
        dp = np.asarray(decode(to_bytes(p_np[sample])), np.float64)
        target = target_of(kind, chans)
        pk, pp = psnr(dk, target, peak), psnr(dp, target, peak)
        err = float(np.abs(dk - dp).max())
        max_err[name] = err
        log("kernel_vs_plain", f"{name}: {n} blocks identical {same * 100:.4f} % "
            f"(bar {MIN_SAME * 100:.0f} %); sample {sample.size} PSNR kernel {pk:.4f} dB "
            f"plain {pp:.4f} dB (|d| bar {MAX_DPSNR}); max |decoded kernel - plain| {err}")
        check(same >= MIN_SAME, f"{name}: kernel and plain version disagree on too many blocks")
        check(abs(pk - pp) <= MAX_DPSNR, f"{name}: kernel and plain PSNR differ")
        check(np.isfinite(pk), f"{name}: PSNR not finite")

    # 4. the paths, each with every launch counter at 0 just before
    plain_calls = {"n": 0}
    plain_names = ["encode_bc1_plain", "encode_bc2_plain", "encode_bc3_plain",
                   "encode_bc4_plain", "encode_bc5_plain"]
    originals = {nm: getattr(bc, nm) for nm in plain_names}

    def counting(fn):
        def wrapped(*a, **k):
            plain_calls["n"] += 1
            return fn(*a, **k)
        return wrapped

    TF, TT = cp.TextureFormat, cp.TextureType
    images = {k: cp.Image.from_array(v, cp.ImageFormat.RGBAF) for k, v in
              (("rgba", surf), ("alpha", asurf), ("hard", hsurf), ("signed", ssurf))}
    small = cp.Image.from_array(surf[:SMALL, :SMALL].copy(), cp.ImageFormat.RGBAF)
    # name -> (format, type, mips, file type, image, kernel, main path?)
    paths = {
        "bc7_2048_mips_dds": (TF.BC7, TT.UNorm, True, "dds", images["rgba"], "bc7", True),
        "bc1_2048_dds": (TF.BC1_RGB, TT.UNorm, False, "dds", images["rgba"], "bc1", True),
        "bc1_512_dds": (TF.BC1_RGB, TT.UNorm, False, "dds", small, "bc1", True),
        "bc3_2048_mips_ktx": (TF.BC3, TT.UNorm, True, "ktx", images["alpha"], "bc3", True),
        "bc5s_2048_mips_ktx": (TF.BC5, TT.SNorm, True, "ktx", images["signed"], "bc5", True),
        "bc1a_2048_mips_dds": (TF.BC1_RGBA, TT.UNorm, True, "dds", images["hard"], "bc1", False),
        "bc2_2048_mips_dds": (TF.BC2, TT.UNorm, True, "dds", images["alpha"], "bc2", False),
        "bc4_2048_mips_ktx": (TF.BC4, TT.UNorm, True, "ktx", images["alpha"], "bc4", False),
        "bc4s_2048_mips_ktx": (TF.BC4, TT.SNorm, True, "ktx", images["signed"], "bc4", False),
    }

    def make_texture(img, mips):
        w = img.width
        tex = cp.Texture(cp.Dimension.Dim2D, w, w, mip_levels=99 if mips else 1)
        check(tex.device == dev or tex.device.type == "cuda", "Texture did not default to cuda")
        check(tex.set_image(img), "set_image failed")
        if mips:
            check(tex.generate_mipmaps(), "generate_mipmaps failed")
        return tex

    # The plain reference of a path's level-0 sample: the same wire input.
    def plain_reference(fmt, typ, blocks):
        signed = typ is TT.SNorm
        x = dequant(wire(blocks, "f16" if signed else "u8").to(dev))
        if fmt is TF.BC7:
            return encode_bc7_plain(x, QUALITY, consts)
        if fmt in (TF.BC1_RGB, TF.BC1_RGBA):
            punch = fmt is TF.BC1_RGBA
            return originals["encode_bc1_plain"](x, QUALITY, punch, not punch)
        if fmt is TF.BC2:
            return originals["encode_bc2_plain"](x, QUALITY)
        if fmt is TF.BC3:
            return originals["encode_bc3_plain"](x, QUALITY)
        if fmt is TF.BC4:
            return originals["encode_bc4_plain"](x[..., 0].contiguous(), QUALITY, signed)
        return originals["encode_bc5_plain"](x, QUALITY, signed)

    path_launches = {k: 0 for k in launch_counts()}
    path_stats = {}
    with tempfile.TemporaryDirectory() as tmp:
        for pname, (fmt, typ, mips, ext, img, kname, _) in paths.items():
            tex = make_texture(img, mips)
            for nm in plain_names:
                setattr(bc, nm, counting(originals[nm]))
            bc7_cuda.reset_launches()
            bc_cuda.reset_launches()
            plain_calls["n"] = 0
            try:
                ok = tex.convert(fmt, typ, cp.Quality.Normal)
                torch.cuda.synchronize()
            finally:
                for nm in plain_names:
                    setattr(bc, nm, originals[nm])
            counts = launch_counts()
            check(ok, f"{pname}: Texture.convert returned False")
            check(counts[kname] > 0, f"{pname}: the path launched no {kname} kernel")
            check(plain_calls["n"] == 0, f"{pname}: a plain version ran on the card's path")
            stats = tex.last_convert_stats
            check(stats["launches"] == {k: v for k, v in counts.items() if v},
                  f"{pname}: convert stats disagree with the counters")
            for k, v in counts.items():
                path_launches[k] += v
            path = os.path.join(tmp, f"{pname}.{ext}")
            check(tex.save(path) is cp.SaveResult.Success, f"{pname}: save failed")
            size = os.path.getsize(path)
            loaded = cp.load_texture(path)
            # DDS has one BC1 code: BC1_RGBA reads back as BC1 of either kind.
            same_format = loaded.format is fmt or (
                fmt is TF.BC1_RGBA and loaded.format in (TF.BC1_RGB, TF.BC1_RGBA))
            check(same_format and loaded.type is typ and loaded.mip_levels == tex.mip_levels,
                  f"{pname}: loaded texture differs ({loaded.format}, {loaded.type})")
            for m in range(tex.mip_levels):
                check(loaded.data(mip_level=m) == tex.data(mip_level=m),
                      f"{pname}: payload of mip {m} differs")
            payload = sum(tex.data_size(mip_level=m) for m in range(tex.mip_levels))
            if ext == "dds":
                check(size == 148 + payload, f"{pname}: DDS size {size} != 148 + {payload}")
            # Level-0 sample: equal to the plain version on the same wire input.
            src0 = img.rgbaf()
            b0 = extract_blocks(src0, 4, 4)[0]
            bs = 8 if fmt in (TF.BC1_RGB, TF.BC1_RGBA, TF.BC4) else 16
            lvl0 = np.frombuffer(tex.data(), np.uint8).reshape(-1, bs)
            idx = np.arange(0, b0.shape[0], max(1, b0.shape[0] // 4096))
            ref = to_bytes(plain_reference(fmt, typ, b0[idx]).cpu().numpy()).reshape(-1, bs)
            same = float(np.all(lvl0[idx] == ref, axis=1).mean())
            dec = loaded.decode_image().rgbaf()
            ch = {TF.BC4: 1, TF.BC5: 2, TF.BC1_RGB: 3}.get(fmt, 4)
            if fmt is TF.BC1_RGBA:
                ch = 3
            finite = bool(np.isfinite(dec).all()) and dec.shape == src0.shape
            err_src = src0[..., :ch]
            if fmt is TF.BC1_RGBA:
                opaque = src0[..., 3:] >= 0.5
                err_src = np.where(opaque, src0[..., :3], 0.0)
            p0 = psnr(dec[..., :ch], err_src, 2.0 if typ is TT.SNorm else 1.0)
            path_stats[pname] = {"launches": {k: v for k, v in counts.items() if v},
                                 "bytes": size, "psnr": p0, "same": same}
            log("paths", f"{pname}: {tex.mip_levels} mips, {payload // bs} blocks, "
                f"{ext.upper()} {size} bytes read back; launches {stats['launches']}, "
                f"plain calls 0; level-0 PSNR {p0:.4f} dB; sample identical to plain "
                f"{same * 100:.2f} %; phases {json.dumps(stats['phases'])}")
            check(same >= MIN_SAME, f"{pname}: blocks disagree with the plain version")
            check(finite, f"{pname}: decoded texels not finite or of the wrong shape")
            check(p0 > 30.0, f"{pname}: PSNR too low")
            del tex, loaded

    # 5. times on the card
    kernel_rows = [
        ("bc7_encode_q0_2", "bc7", "bc7_q2", "cuttlefish_tpu_torch/csrc/bc7_encode.cu",
         "cuttlefish_tpu/kernels/bc7_pallas.py:1044", 256),
        ("bc1_encode", "bc1", "bc1_q2", "cuttlefish_tpu_torch/csrc/bc_encode.cu",
         "cuttlefish_tpu/kernels/bc_pallas.py:452", 192),
        ("bc2_encode", "bc2", "bc2_q2", "cuttlefish_tpu_torch/csrc/bc_encode.cu",
         "cuttlefish_tpu/kernels/bc_pallas.py:491", 256),
        ("bc3_encode", "bc3", "bc3_q2", "cuttlefish_tpu_torch/csrc/bc_encode.cu",
         "cuttlefish_tpu/kernels/bc_pallas.py:517", 256),
        ("bc4_encode", "bc4", "bc4_q2", "cuttlefish_tpu_torch/csrc/bc_encode.cu",
         "cuttlefish_tpu/kernels/bc_pallas.py:477", 64),
        ("bc5_encode", "bc5", "bc5s_q2", "cuttlefish_tpu_torch/csrc/bc_encode.cu",
         "cuttlefish_tpu/kernels/bc_pallas.py:539", 128),
    ]
    out_bytes = {"bc1": 8, "bc4": 8}
    rows = []
    for name, key, case, src, replaces, in_bytes in kernel_rows:
        kernel, plain, kind, *_ = cases[case]
        x = dev_in[kind]
        kernel_ms = event_ms(torch, lambda: kernel(x), 7)
        plain_ms = event_ms(torch, lambda: plain(x), 7)
        ops = ops_per_block(torch, plain, x[:1024].cpu())
        bytes_ = n * (in_bytes + out_bytes.get(key, 16))
        t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S * 1e3, n * ops / F32_OPS_PER_S * 1e3
        rows.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": path_launches[key], "max_abs_err": max_err[case],
            "ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None,
        })
        log("times", f"{card}: {name} ({case}, {n} blocks): kernel {kernel_ms:.4f} ms "
            f"({SIZE * SIZE / kernel_ms / 1e3:.1f} Mtexels/s); plain {plain_ms:.4f} ms; "
            f"bound {max(t_bytes, t_ops):.4f} ms ({rows[-1]['bound_by']}: "
            f"{bytes_ / 1e6:.1f} MB, {ops:.0f} ops/block)")

    for pname, (fmt, typ, mips, ext, img, kname, main_path) in paths.items():
        if not main_path:
            continue
        secs = []
        for _ in range(5):
            t = make_texture(img, mips)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            check(t.convert(fmt, typ, cp.Quality.Normal), f"{pname}: timed convert failed")
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            phases = t.last_convert_stats["phases"]
        log("times", f"{card}: convert {pname} median of 5 {statistics.median(secs):.4f} s "
            f"{[round(s, 4) for s in secs]}; last phases {json.dumps(phases)}")

    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        sys.exit(1)

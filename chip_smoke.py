#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (cuttlefish_tpu_torch) on one GPU.

    python3 chip_smoke.py

Drives the port's main path once at the bench size: a 2048x2048 RGBA
surface (the formula of bench.py:_test_surface, seed 0), mipmapped, encoded
to BC7 at quality 2 through the hand-written CUDA kernel, saved as DDS and
read back.  Phases, one line each; any failure exits non-zero:

1. device: needs a CUDA device (no CPU fallback); prints the card's name
   and power limit (nvidia-smi), torch and CUDA versions; TF32 off.
2. build: nvcc builds csrc/ for sm_90a; prints the seconds and what ptxas
   reports per kernel.
3. kernel vs plain: the 262,144 float blocks of the surface through the
   kernel and through the plain PyTorch version on the card: >= 99 %
   identical blocks, |dPSNR| <= 0.05 dB on a decoded sample of 4,096.
4. main path: Texture.convert(BC7, UNorm, Normal) with the launch counter
   reset just before; DDS size 148 + sum of mips, load_texture payload
   equal to the in-memory data, sampled level-0 blocks equal to the plain
   version on the same u8 input.
5. times: CUDA events, one warm-up, median of 7: kernel alone and plain
   version alone on the 262,144 blocks; whole convert (host clock) median
   of 5.

Then one JSON line of kernels, and as the last line
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
QUALITY = 2
SAMPLE_STRIDE = 64  # 262,144 / 64 = 4,096 decoded blocks
MIN_SAME = 0.99
MAX_DPSNR = 0.05


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


def psnr(dec, target) -> float:
    mse = ((dec.astype(np.float64) - target) ** 2).mean()
    return float(10 * np.log10(255**2 / (mse + 1e-12)))


def to_bytes(words: np.ndarray) -> np.ndarray:
    return np.frombuffer(
        np.ascontiguousarray(words.astype("<u4")).tobytes(), np.uint8
    )


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


def main() -> int:
    import torch

    # 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs a GPU", file=sys.stderr)
        return 2
    import cuttlefish_tpu_torch as cp
    from cuttlefish_tpu.convert.blocks import extract_blocks
    from cuttlefish_tpu_torch.convert.device import dequant_u8, wire_u8
    from cuttlefish_tpu_torch.decode import decode_bc7
    from cuttlefish_tpu_torch.kernels import _build, bc7_cuda
    from cuttlefish_tpu_torch.kernels.bc7 import _constants, encode_bc7, encode_bc7_plain

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0].strip()
    card = smi
    print(smi, flush=True)
    log("device", f"{torch.cuda.get_device_name(0)}; torch {torch.__version__}; "
        f"CUDA {torch.version.cuda}; capability {torch.cuda.get_device_capability(0)}; "
        f"count {torch.cuda.device_count()}; tf32 off")

    # 2. build
    t0 = time.perf_counter()
    _build.load()
    build_s = time.perf_counter() - t0
    info = _build.build_info
    check(info["path"].startswith(str(_build.build_dir())), "library outside the build dir")
    log("build", f"nvcc {' '.join(_build.NVCC_FLAGS)} "
        f"{[p.name for p in _build._sources()]} -> {info['path']} in {build_s:.2f} s "
        f"(built={info['built']})")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log("build", "ptxas: " + line.strip())

    # 3. kernel vs plain on the card
    surf = test_surface(SIZE)
    blocks_np, _, _ = extract_blocks(surf, 4, 4)
    n = blocks_np.shape[0]
    check(n == 262144, f"expected 262144 blocks, got {n}")
    blocks = torch.from_numpy(blocks_np).to(dev)
    consts = _constants(False, dev)
    k_words = encode_bc7(blocks, QUALITY)
    p_words = encode_bc7_plain(blocks, QUALITY, consts)
    torch.cuda.synchronize()
    k_np = k_words.cpu().numpy()
    p_np = p_words.cpu().numpy()
    same = float(np.all(k_np == p_np, axis=1).mean())
    sample = np.arange(0, n, SAMPLE_STRIDE)
    target = np.clip(np.round(blocks_np[sample] * 255), 0, 255)
    dk = decode_bc7(to_bytes(k_np[sample]))
    dp = decode_bc7(to_bytes(p_np[sample]))
    pk, pp = psnr(dk, target), psnr(dp, target)
    max_abs = int(np.abs(dk.astype(np.int32) - dp.astype(np.int32)).max())
    log("kernel_vs_plain", f"{n} blocks: identical {same * 100:.4f} % "
        f"(bar {MIN_SAME * 100:.0f} %); sample {sample.size} blocks PSNR kernel "
        f"{pk:.4f} dB plain {pp:.4f} dB (|d| bar {MAX_DPSNR}); "
        f"max |decoded kernel - plain| {max_abs} (u8 units)")
    check(same >= MIN_SAME, "kernel and plain version disagree on too many blocks")
    check(abs(pk - pp) <= MAX_DPSNR, "kernel and plain PSNR differ")
    del k_words, p_words

    # 4. the main path
    img = cp.Image.from_array(surf, cp.ImageFormat.RGBAF)

    def make_texture():
        tex = cp.Texture(cp.Dimension.Dim2D, SIZE, SIZE, device=dev)
        check(tex.set_image(img), "set_image failed")
        check(tex.generate_mipmaps(), "generate_mipmaps failed")
        return tex

    tex = make_texture()
    bc7_cuda.reset_launches()
    ok = tex.convert(cp.TextureFormat.BC7, cp.TextureType.UNorm, cp.Quality.Normal)
    torch.cuda.synchronize()
    launches = bc7_cuda.launches
    check(ok, "Texture.convert returned False")
    stats = tex.last_convert_stats
    check(launches > 0, "the main path launched no BC7 kernel")
    check(stats["bc7_launches"] == launches, "convert stats disagree with the counter")
    sizes = [tex.data_size(mip_level=m) for m in range(tex.mip_levels)]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "smoke.dds")
        check(tex.save(path) is cp.SaveResult.Success, "save failed")
        file_size = os.path.getsize(path)
        loaded = cp.load_texture(path)
    check(file_size == 148 + sum(sizes), f"DDS size {file_size} != 148 + {sum(sizes)}")
    check(loaded.format is cp.TextureFormat.BC7 and loaded.mip_levels == tex.mip_levels,
          "loaded texture differs in format or mips")
    for m in range(tex.mip_levels):
        check(loaded.data(mip_level=m) == tex.data(mip_level=m), f"payload of mip {m} differs")
    lvl0 = np.frombuffer(tex.data(), np.uint8).reshape(-1, 16)
    u8 = torch.from_numpy(wire_u8(blocks_np[sample])).to(dev)
    ref = to_bytes(encode_bc7_plain(dequant_u8(u8), QUALITY, consts).cpu().numpy())
    path_same = float(np.all(lvl0[sample] == ref.reshape(-1, 16), axis=1).mean())
    p_main = psnr(decode_bc7(lvl0[sample].reshape(-1)), target)
    log("main_path", f"{tex.mip_levels} mips, {sum(sizes) // 16} blocks, "
        f"DDS {file_size} bytes read back; BC7 launches {launches}; level-0 sample "
        f"PSNR {p_main:.4f} dB, identical to plain {path_same * 100:.2f} %; "
        f"stats {json.dumps(stats)}")
    check(path_same >= MIN_SAME, "main-path blocks disagree with the plain version")
    check(np.isfinite(p_main) and p_main > 30.0, "main-path PSNR too low")

    # 5. times on the card
    def kernel_run():
        encode_bc7(blocks, QUALITY)

    def plain_run():
        encode_bc7_plain(blocks, QUALITY, consts)

    kernel_ms = event_ms(torch, kernel_run, 7)
    plain_ms = event_ms(torch, plain_run, 7)
    convert_s = []
    for _ in range(5):
        t = make_texture()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        check(t.convert(cp.TextureFormat.BC7, cp.TextureType.UNorm, cp.Quality.Normal),
              "timed convert failed")
        torch.cuda.synchronize()
        convert_s.append(time.perf_counter() - t0)
        phases = t.last_convert_stats["phases"]
    conv = statistics.median(convert_s)
    texels = SIZE * SIZE
    log("times", f"{card}: kernel {kernel_ms:.4f} ms ({texels / kernel_ms / 1e3:.1f} "
        f"Mtexels/s); plain {plain_ms:.4f} ms ({texels / plain_ms / 1e3:.1f} Mtexels/s) "
        f"on {n} blocks q{QUALITY}")
    log("times", f"{card}: whole convert 2048^2 + mips {conv:.4f} s median of "
        f"{len(convert_s)} {[round(s, 4) for s in convert_s]}; last phases "
        f"{json.dumps(phases)}")

    print(json.dumps({"kernels": [{
        "name": "bc7_encode_q0_2",
        "route": "cuda",
        "source": "cuttlefish_tpu_torch/csrc/bc7_encode.cu",
        "replaces": "cuttlefish_tpu/kernels/bc7_pallas.py:1044",
        "launches": launches,
        "max_abs_err": max_abs,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}), flush=True)
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

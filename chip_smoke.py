#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (cuttlefish_tpu_torch) on one GPU.

    python3 chip_smoke.py [--parent SRC ...]

Drives the port's paths once at the bench size, on 2048x2048 RGBA
surfaces made from a seed (the formula of bench.py:_test_surface, seed 0,
plus an alpha variant, a signed variant and an HDR variant that spans the
half-float range, unsigned and signed), through the hand-written CUDA
kernels, and reads every file back.  Phases, one line each; any failure
exits non-zero:

1. device: needs a CUDA device (no CPU fallback); prints the card's name
   and power limit (nvidia-smi), torch and CUDA versions; TF32 off.
2. build: one nvcc per csrc/*.cu for sm_90a, all started together, and the
   native codecs with g++; prints the seconds and what ptxas reports
   (registers, spills) for every kernel entry, a line per BC1-BC5, BC7,
   BC6H, ASTC and ETC entry (registers, stack, spills, shared memory), the
   warps and dynamic shared memory a CTA of ASTC entry A, the dynamic
   shared memory and blocks a warp of ASTC entries B, C and D and the
   shared memory a CTA of the BC7 q3-4, BC6H and the five ETC and EAC
   entries.
   With --parent SRC, also that earlier tree's BC, ETC or ASTC csrc/*.cu
   (kept outside this package, its headers beside it, its wrapper module
   in the kernels/ beside csrc/) for phase 5.
3. kernel vs plain: the 262,144 blocks of the surface through each kernel
   and through its plain PyTorch version on the card: >= 99 % identical
   blocks, |dPSNR| <= 0.05 dB on a decoded sample of 4,096 blocks.  BC7 q0,
   q1 and q2 perceptual, q2, q3, q4 and q4 perceptual; BC1 q0-q4 (with
   black), BC1 q2 punch-through on a hard-alpha surface, BC2, BC3, BC4
   unsigned at q2 and q4, BC5 unsigned at q2 on the alpha surface through
   the u8 wire; BC4 signed at q2 and q4 and BC5 signed at q2 on 2x-1
   through the f16 wire;
   BC6H q0-q4 unsigned, q2 and q4 signed (value metric) and q2 code metric
   on the HDR surfaces through the f16 wire; ETC1 q0, q1, q2, q4, ETC2 q2,
   q4 and q2 with the Rec.709 x 3 sRGB weights, ETC2 RGBA8 q2 and q4 on the
   alpha surface, EAC A8 q2 and q4, R11 q0, q2, q4 and RG11 q2 and q4
   through the f16 wire, R11 and RG11 signed q2 on 2x-1 through the f16
   wire; ASTC LDR
   (the four entries merged) through the u8 wire: 4x4 q0, q2, q4 on the
   colour surface, q2 and q4 on the alpha surface, on a near-gray surface
   (R = G = B of the test surface) and on its alpha variant; 6x6 and 10x5
   q2 on the alpha surface, 8x8 and 12x12 q2 on the colour surface, 8x8 q4
   on the near-gray alpha surface (decoded with the port's decode_astc).
4. paths: Texture(device=cuda).convert(...) then save, load_texture and a
   payload check, each with every launch counter set to 0 just before and
   read just after (the kernel must have launched, no plain version may
   have run): BC7 q2 2048^2 + mips -> DDS; BC1_RGB 2048^2 -> DDS, BC1_RGB
   512^2 -> DDS, BC3 2048^2 + mips -> KTX, BC5 SNorm 2048^2 + mips -> KTX;
   BC1_RGBA, BC2, BC4 UNorm and BC4 SNorm through the same converters; and
   BC7 Highest 2048^2 + mips -> DDS and BC6H UFloat Highest 2048^2 + mips
   -> DDS, with BC7 High -> DDS and BC6H Float Normal -> KTX; and this
   slice's main paths ETC2 RGB 512^2 x 4 layers -> KTX (BASELINE config 3),
   ETC2 RGB 2048^2 + mips -> KTX, ETC2 RGB Highest 2048^2 -> KTX and ETC2
   RGBA8 2048^2 + mips -> KTX, with ETC1 2048^2 -> KTX, EAC R11 2048^2 +
   mips -> KTX and EAC RG11 SNorm 2048^2 + mips -> KTX; and this slice's
   ASTC_4x4 Normal 2048^2 + mips -> KTX (its main path), BASELINE config 5
   (a 256^2 sRGB cube of a normal map + mips, ASTC_4x4 -> KTX), ASTC_8x8
   and ASTC_12x12 Normal 2048^2 -> KTX and ASTC_4x4 Highest 2048^2 on the
   near-gray alpha surface -> KTX (all four ASTC entries).  Level-0 sample
   blocks must equal the plain version on the same wire input.  Then the fused mip pipeline
   (Texture.convert_with_mips): BC7 q2 2048^2 -> DDS (the main path), BC3
   q2 on the alpha surface -> KTX, BASELINE config 5 fused (a 256^2 sRGB
   cube, its normal map made on the card) -> ASTC_4x4 KTX and BC6H Float on
   2x-1 -> KTX: each kernel launched once (ASTC: once per entry), its
   pyramid on the card within 1e-5 of the CPU's and identical with TF32
   allowed, a strided sample of 4,096 of its blocks through the plain
   version >= 99 % identical (|dPSNR| <= 0.05 dB), and every level within
   the reference's bar of the host path (generate_mipmaps + convert on the
   card): mean |d| < 2 (u8) or < 0.05 (BC6H, its level 1 and 2 negatives
   kept).  And ETC2_R8G8B8A1 2048^2 + mips -> KTX on the hard-alpha surface
   (torch ops on the card: no kernel launches): level 0's strided sample
   >= 99 % identical to the CPU's words, punched texels alpha 0.  And the
   formats that run torch ops on the card (no kernel may launch):
   ASTC_4x4 UFloat q2 on the HDR surface 2048^2 + mips -> KTX, ASTC_8x8
   UFloat q2 on the HDR surface with the alpha surface's alpha 1024^2 ->
   KTX (CEM 14), PVRTC1 RGBA 4bpp q2 on the alpha surface 2048^2 + mips ->
   PVR and PVRTC2 RGBA 2bpp q4 on the hard-alpha surface 1024^2 -> KTX:
   level 0 against the same encode on the CPU (ASTC a strided sample of
   4,096 blocks, PVRTC every word) >= 99 % identical and |dPSNR| <= 0.05
   dB (HDR PSNR peak-relative), level 0 encoded again on the card with
   TF32 allowed must write the same words, and the decoded
   quality printed beside the JAX package's bar for the format.
5. times: CUDA events, one warm-up, median of 7 (of 3 where the warm-up
   took over a second): each kernel alone and its plain version alone on
   the 262,144 blocks (BC7 q3-4 and BC6H at q4, the main paths' quality,
   and at q3 and q2, BC6H also q4 signed and q2 with the code metric; ETC
   RGB and RGBA8 at q2 and q4, EAC A8 q2 and q4, R11 q0, q2, q4 and signed
   q2, RG11 q2, signed q2 and q4; ASTC entries A and B at 4x4, 8x8
   and 12x12 q2 on the colour surface, A at 8x8 and 12x12 q4 and B at 4x4
   q4 on the near-gray alpha surface, C and D at 4x4 q4 and 8x8 q4 on
   that surface); each main-path
   convert (host clock, synchronised) median of 5, and each of its phases'
   median over the same 5 (EAC R11 and RG11 SNorm + mips too; the four
   fused paths through convert_with_mips, ETC2_R8G8B8A1 + mips and the
   four ASTC UFloat and PVRTC paths).  The
   unit-weight ETC RGB and RGBA8 cases also
   print the bound with the products by the weights counted, which a
   product by 1 does not need.  With --parent, every case of the rows whose source it
   names goes through the earlier build too (the earlier tree's wrapper
   module, kernels/<name>_cuda.py, bound to it), timed in
   turns with this tree's (earlier, this, this, earlier), words identical
   (for astc_encode.cu: every ASTC entry case, words and errors).  The BC1,
   BC2, BC3 and BC7 q2 rows print their counted operations beside those of
   the earlier kernels on the same blocks, as do BC4, BC4 signed and BC5
   signed, and the EAC and RGBA8 cases those of 80dec2d's body
   (EARLIER_OPS).
6. the CLI and the device mesh: the reference's 97 ctest rows (CASES of
   tests/test_cli_reference_parity.py, read with ast) through
   cuttlefish_tpu_torch.cli.run on the card, on the same fixtures written
   with the port's PNG encoder, each with the reference's exit code; the
   2048^2 test surface as an 8-bit PNG -> BC7 Normal + 12 mips -> DDS, with
   host mips and with --device-mips, through run() (median of 3) and
   through python -m cuttlefish_tpu_torch in a subprocess (timed, start-up
   included): every file byte-identical to the others and to the same
   convert through the Texture API, bc7_kernel launched and no plain
   version run, level 0 within phase 4's bars (a strided sample of 4,096
   blocks >= 99 % identical to the plain version on the same input, above
   30 dB); the same converts under use_mesh([cuda:0, cuda:0]) and
   use_mesh(default_mesh()): the words of the unsplit run, a launch per
   entry; under use_mesh([cpu, cpu]) the card's convert raises, with no
   launch and no plain call; and the host-mips convert timed without a
   mesh and with the 2-entry one, in turns (median of 5 each).

Then one JSON line of kernels (launches from the paths of phases 4 and 6; bound_ms
from this run's inputs: the larger of the bytes the function must move over
3.35 TB/s and its operations over 67 TFLOP/s: for ETC RGB and RGBA8 the
float operations the function needs on those inputs, etc_rgb_ops (no
products by unit channel weights) and eac_ops, for the EAC entries, BC
and ASTC those of its device code on a sample of the blocks,
eac_op_counter (the search's exits taken as this run's data takes them,
each texel's side of the base once), bc_op_counter and astc_op_counter,
BC6H's with each texel's value and scale once and the BC4 body's (BC3,
BC4, BC5) with a mode's rounds ended at the first candidate not taken at
every quality, the device code's count printed beside: see NEEDED_WHY),
and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import contextlib
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


_T0 = time.perf_counter()


def log(phase, msg):
    print(f"[{phase} +{time.perf_counter() - _T0:.1f}s] {msg}", flush=True)


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


def hdr_surface(surf: np.ndarray) -> np.ndarray:
    """An HDR variant of the test surface: its colours scaled by 2^e, with
    e running smoothly from -22 to 15 across the surface, so that texels
    fall in every exponent segment of a half float (denormals included)
    below the largest finite one; opaque alpha."""
    size = surf.shape[0]
    rng = np.random.default_rng(2)
    y, x = np.mgrid[0:size, 0:size].astype(np.float32) / size
    e = -22.0 + 37.0 * (0.5 * x + 0.3 * y + 0.2 * (0.5 + 0.5 * np.sin(9.0 * x * y)))
    scale = np.exp2(e) * (1.0 + rng.normal(0, 0.03, x.shape))
    out = surf.copy()
    out[..., :3] = surf[..., :3] * scale[..., None].astype(np.float32) * 1.6
    out[..., 3] = 1.0
    return out.astype(np.float32)


def signed_hdr_surface(hdr: np.ndarray) -> np.ndarray:
    """The HDR surface with a sign pattern per channel (BC6H Float)."""
    size = hdr.shape[0]
    y, x = np.mgrid[0:size, 0:size].astype(np.float32) / size
    out = hdr.copy()
    for c in range(3):
        sign = np.where(np.sin(40.0 * x + 2.0 * c) * np.cos(30.0 * y - c) < -0.2, -1.0, 1.0)
        out[..., c] *= sign.astype(np.float32)
    return out


def psnr(dec, target, peak) -> float:
    mse = ((np.asarray(dec, np.float64) - target) ** 2).mean()
    return float(10 * np.log10(peak**2 / (mse + 1e-20)))


def to_bytes(words: np.ndarray) -> np.ndarray:
    return np.frombuffer(np.ascontiguousarray(words.astype("<u4")).tobytes(), np.uint8)


def event_ms(torch, fn, reps: int) -> float:
    """Median of `reps` timed calls after one warm-up; of 3 where the
    warm-up took more than a second."""
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    if time.perf_counter() - t0 > 1.0:
        reps = min(reps, 3)
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


# Float operations per block that the ETC/EAC functions need, counted from
# the loops of their hand kernel (csrc/etc_encode.cu) with every value that
# is fixed for one palette entry (a clamped base + modifier, a planar
# channel's slopes) made once, not per texel.  A fit sums the 8 members of
# its sub-block and builds the 2-bit indices of its winner alone; the plain
# version computes every texel under a sub-block mask and the indices of
# every candidate, about twice this.  A clamp counts 2 (max, min); integer
# work and the packing of the words are not counted.  With unit channel
# weights (every linear texture) a product by a weight is exact and not
# needed: 3 fewer at each texel-entry error, 1 fewer at each planar texel.
ETC_ENTRY = 9  # p_c = clamp(base_c + modifier): 3 add, 3 clamps


def etc_rgb_ops(quality: int, etc2: bool, weighted: bool) -> int:
    """Float operations of one block's ETC1 (ETC2) RGB sweep (rgb_words);
    weighted: the channel weights are not all 1."""
    pix = 11 if weighted else 8  # sum_c w_c * (x_c - p_c)^2: 3 sub, 3 squares, 3 w, 2 add
    planar_texel = 12 if weighted else 11  # w * (x - clamp(floor((a*x + b*y + 4*o + 2) * 0.25)))^2
    th_texel = 4 * pix + 3 + 1  # 4 entries, 3 compares, 1 add

    def nearest_sum(entries: int, texels: int) -> int:
        """Each texel's least error over `entries` palette entries, summed:
        the entries, then per texel one error per entry, the mins, one add."""
        return entries * ETC_ENTRY + texels * entries * (pix + 1)

    others = (1 if quality < 2 else 27 if quality < 4 else 31) - 1
    keep = 0 if quality < 2 else 4 if quality < 4 else 8
    fit = 8 * nearest_sum(4, 8) + 7  # 8 tables of 8 members, first least
    centre = fit + 7  # and the runner-up table
    restricted = nearest_sum(8, 8)  # the estimate of one offset
    bits = 4 * ETC_ENTRY + 8 * (4 * pix + 3)  # the winner's indices
    topk = keep * (others - 1)
    if keep:
        diff = (24 + 2 * centre + 1 + others * (9 + 2 * restricted + 1) + topk
                + keep * (9 + 2 * fit + 2))
        ind = 12 + centre + others * (9 + restricted) + topk + keep * (9 + fit + 1)
    else:
        diff, ind = 24 + 2 * fit + 1, 12 + fit
    flip = 54 + diff + 2 * bits + 1  # the sub-block means first
    if quality >= 1:
        flip += 2 * ind + 2 * bits + 2
    ops = 2 * flip - 1  # the first offer compares nothing
    if etc2:
        refine = quality >= 4
        chan = 3 + 16 * (planar_texel + 1)
        ops += 315 + (3 * (27 * chan + 26) if refine else 0) + 9 + 16 * (3 * planar_texel + 3)
        ops += 724  # the principal-axis split of T and H
        for pal, h in ((18, 0), (36, 1)):  # T, H
            cand = pal + 16 * th_texel + h
            ops += 48 + 16 * cand + 15 + (2 * 44 * (cand + 1) if refine else 0)
        ops += 3  # the planar, T and H offers
    return ops


def eac_ops(quality: int) -> int:
    """Float operations of one EAC alpha block (eac_alpha) when every (table,
    multiplier) candidate is evaluated in full, as RGBA8's alpha evaluates
    them.  A palette entry is clamp(base + mod * m); a texel's side of the
    base one compare, made once; a texel's error against a candidate five
    differences, four least absolute values (FMNMX takes |x| as an operand
    modifier), one square and one add; the indices take the winner's eight
    squares and seven compares a texel.  The EAC entries skip repeated
    multipliers and leave a candidate once its partial error reaches the
    best, so what they need depends on the data: their bound counts the
    device code on the run's blocks (eac_op_counter)."""
    ncand = (1, 2, 3, 5, 7)[quality]
    pal = 8 * 4
    cands = 16 * ncand
    search = 16 * 4 + 16 + cands * (pal + 16 * 11) + cands - 1
    return 37 + search + pal + 16 * 23


# The counting float type and the shim that lets g++ build the device code
# of a csrc/*.cu (the kernels and launchers sit under __CUDACC__).
COUNT_PRELUDE = r"""
#include <algorithm>
#include <math.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>
#include <vector>
#define __device__
#define __host__
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))
#define __constant__
#define __shared__
#define __launch_bounds__(x)
#define __restrict__
using std::abs;
using std::max;
using std::min;
static inline int __popc(unsigned x) { return __builtin_popcount(x); }
static inline float __int_as_float(int v) { float f; memcpy(&f, &v, 4); return f; }
static unsigned long long g_ops = 0;
struct CF {
  float v;
  CF() = default;
  constexpr CF(float x) : v(x) {}
  constexpr CF(double x) : v((float)x) {}
  constexpr CF(int x) : v((float)x) {}
  constexpr CF(unsigned x) : v((float)x) {}
  explicit operator int() const { return (int)v; }
  explicit operator unsigned() const { return (unsigned)v; }
  explicit operator double() const { return v; }
};
static inline bool unit(float a) { return a == 0.0f || a == 1.0f; }
static inline CF operator+(CF a, CF b) { g_ops += a.v != 0.0f && b.v != 0.0f; return CF(a.v + b.v); }
static inline CF operator-(CF a, CF b) { g_ops += b.v != 0.0f; return CF(a.v - b.v); }
static inline CF operator-(CF a) { ++g_ops; return CF(-a.v); }
static inline CF operator*(CF a, CF b) { g_ops += !unit(a.v) && !unit(b.v); return CF(a.v * b.v); }
static inline CF operator/(CF a, CF b) { ++g_ops; return CF(a.v / b.v); }
static inline CF& operator+=(CF& a, CF b) { return a = a + b; }
static inline CF& operator-=(CF& a, CF b) { return a = a - b; }
static inline CF& operator*=(CF& a, CF b) { return a = a * b; }
static inline CF& operator/=(CF& a, CF b) { return a = a / b; }
static inline bool operator<(CF a, CF b) { ++g_ops; return a.v < b.v; }
static inline bool operator>(CF a, CF b) { ++g_ops; return a.v > b.v; }
static inline bool operator<=(CF a, CF b) { ++g_ops; return a.v <= b.v; }
static inline bool operator>=(CF a, CF b) { ++g_ops; return a.v >= b.v; }
static inline bool operator==(CF a, CF b) { ++g_ops; return a.v == b.v; }
static inline bool operator!=(CF a, CF b) { ++g_ops; return a.v != b.v; }
static inline CF fminf(CF a, CF b) { ++g_ops; return CF(fminf(a.v, b.v)); }
static inline CF fmaxf(CF a, CF b) { ++g_ops; return CF(fmaxf(a.v, b.v)); }
static inline CF rintf(CF a) { ++g_ops; return CF(rintf(a.v)); }
static inline CF floorf(CF a) { ++g_ops; return CF(floorf(a.v)); }
static inline CF ceilf(CF a) { ++g_ops; return CF(ceilf(a.v)); }
static inline CF sqrtf(CF a) { ++g_ops; return CF(sqrtf(a.v)); }
static inline CF fabsf(CF a) { ++g_ops; return CF(fabsf(a.v)); }
// min(|a|, |b|), which csrc/etc_encode.cu takes from here off the card: one
// operation, as FMNMX takes |x| as an operand modifier.
#define ETCX_HAVE_FMIN_ABS
static inline float fmin_abs(float a, float b) { return fminf(fabsf(a), fabsf(b)); }
static inline CF fmin_abs(CF a, CF b) { ++g_ops; return CF(fmin_abs(a.v, b.v)); }
"""

# The EAC entries' device code (csrc/etc_encode.cu) under the counting
# float: count runs a CPU entry, which stages each CTA's blocks and runs its
# threads as the kernel does (kind 0: alpha [n,16]; 1: R11 [n,16]; 2: RG11
# [n,16,nch]).  The search makes a texel's side of the base (EAC_SIDE) once
# a candidate: with needed set those go uncounted (EAC_SIDE_COUNT), and
# count adds each texel's once.
EAC_SIDE_COUNT = r"""
static bool g_needed = false;
static inline bool eac_side(CF x, CF mid) {
  g_ops += !g_needed;
  return x.v >= mid.v;
}
#define EAC_SIDE(x, mid) eac_side(x, mid)
"""
EAC_COUNT_SRC = COUNT_PRELUDE + EAC_SIDE_COUNT + r"""
#define float CF
#include "etc_encode.cu"
#undef float
extern "C" unsigned long long count(const float* x, int n, int nch, int kind, int quality,
                                    int is_signed, int needed, uint32_t* out) {
  g_ops = 0;
  g_needed = needed != 0;
  if (kind == 0) etcx::eac_alpha_cpu((const CF*)x, out, n, quality);
  else if (kind == 1) etcx::eac_r11_cpu((const CF*)x, out, n, quality, is_signed);
  else etcx::eac_rg11_cpu((const CF*)x, out, n, nch, quality, is_signed);
  if (g_needed) g_ops += 16ull * n * (kind == 2 ? 2 : 1);
  return g_ops;
}
"""


def eac_op_counter(csrc: str, tmp: str):
    """-> count(kind, values, quality, signed, device=False): (float
    operations per block of the EAC entries' device code, its words as
    stored) on host values; kind "alpha" ([n,16] 0..1), "r11" ([n,16]) or
    "rg11" ([n,16,C]).  Each texel's side of the base counted once, as the
    function needs it, or with device=True once a candidate, as the device
    code makes it."""
    import ctypes

    src, so = os.path.join(tmp, "eac_count.cpp"), os.path.join(tmp, "libeac_count.so")
    with open(src, "w") as f:
        f.write(EAC_COUNT_SRC)
    subprocess.run(["g++", "-O1", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC", "-I",
                    csrc, "-o", so, src], check=True, capture_output=True, timeout=600)
    lib = ctypes.CDLL(so)
    i = ctypes.c_int
    lib.count.argtypes = [ctypes.c_void_p, i, i, i, i, i, i, ctypes.c_void_p]
    lib.count.restype = ctypes.c_ulonglong

    def count(kind, values, quality, signed, device=False):
        x = np.ascontiguousarray(values, np.float32)
        words = np.zeros((x.shape[0], 4 if kind == "rg11" else 2), np.uint32)
        nch = x.shape[2] if x.ndim == 3 else 1
        ops = lib.count(x.ctypes.data, x.shape[0], nch, ("alpha", "r11", "rg11").index(kind),
                        quality, int(signed), int(not device), words.ctypes.data)
        return ops / max(x.shape[0], 1), words

    return count


# Float operations of the hand kernels, counted by a g++ build of their
# device code with the counting float type above on a sample of the run's
# blocks.  Every float operation counts one (a comparison, min, max, rint,
# floor, sqrt, abs and a negation too), except a product with an exact 0 or
# 1 operand and a sum with an exact 0 operand: those are the kernels'
# mask products and the sums of their zeros, which the function does not
# need.  Integer work and the packing of the words are not counted; loads
# count what the kernel computes on them (ASTC and BC7: a clamp and a scale
# per value).
ASTC_COUNT_SRC = COUNT_PRELUDE + r"""
#define float CF
#include "astc_encode.cu"
#undef float
extern "C" unsigned long long astc_count(int stage, const float* blocks, const int* desc, int n,
                                         uint32_t* words, float* err) {
  g_ops = 0;
  astcx::encode_stage(stage, desc, (const CF*)blocks, n, words, (CF*)err);
  return g_ops;
}
// The warp's top-k of estimates v[0..U) (C's and D's screens) beside the
// sequential scan's: ids_warp, ids_seq get k pattern indices (-1: none).
extern "C" void astc_topk(const float* v, int U, int k, int* ids_warp, int* ids_seq) {
  uint64_t keys[32 * astcx::kMaxTopK];
  int cnt[32];
  CF vs[astcx::kMaxTopK];
  int c = 0;
  for (int i = 0; i < k; ++i) ids_warp[i] = ids_seq[i] = -1;
  astcx::warp_topk([&](int u) { return CF(v[u]); }, U, k, keys, cnt, ids_warp);
  for (int u = 0; u < U; ++u) astcx::topk_insert(vs, ids_seq, c, k, CF(v[u]), u);
}
"""


def astc_op_counter(csrc: str, tmp: str):
    """-> count(stage, host blocks [n,T,4] f32, bw, bh, q, gray, alpha):
    (float operations per block, the device code's words [n,4], its errors
    [n]); count.lib is the library (astc_topk)."""
    import ctypes

    from cuttlefish_tpu_torch.kernels import astc_cuda

    src, lib_path = os.path.join(tmp, "astc_count.cpp"), os.path.join(tmp, "libastc_count.so")
    with open(src, "w") as f:
        f.write(ASTC_COUNT_SRC)
    subprocess.run(["g++", "-O1", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC",
                    "-I", csrc, "-o", lib_path, src], check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(lib_path)
    lib.astc_count.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 2 + [ctypes.c_int] + [
        ctypes.c_void_p] * 2
    lib.astc_count.restype = ctypes.c_ulonglong
    lib.astc_topk.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 2

    def count(stage, blocks, bw, bh, q, gray, alpha):
        b = np.ascontiguousarray(blocks, np.float32)
        desc = np.ascontiguousarray(astc_cuda.descriptor(bw, bh, q, gray, alpha))
        words = np.zeros((b.shape[0], 4), np.uint32)
        err = np.zeros(b.shape[0], np.float32)
        ops = lib.astc_count("abcd".index(stage), b.ctypes.data, desc.ctypes.data, b.shape[0],
                             words.ctypes.data, err.ctypes.data)
        return ops / max(b.shape[0], 1), words, err

    count.lib = lib
    return count


def build_earlier(src: str, out_dir: str):
    """nvcc of an earlier tree's csrc/<name>.cu (its headers beside it)
    with this package's flags -> (that tree's wrapper module of <name>,
    kernels/<name>_cuda.py beside its csrc/, with its own binding, tables
    and launch counts, whose launches go to that build; the ptxas log)."""
    import ctypes
    import importlib.util
    import types

    from cuttlefish_tpu_torch.kernels import _build

    name = os.path.basename(src).removesuffix(".cu")
    so = os.path.join(out_dir, f"lib{name}_earlier.so")
    done = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, src],
                          capture_output=True, text=True, timeout=600)
    check(done.returncode == 0, f"nvcc {src} failed:\n{done.stderr[-3000:]}")
    lib = ctypes.CDLL(so)
    short = name.replace("_encode", "_cuda")
    wrapper = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(src))), "kernels",
                           short + ".py")
    check(os.path.isfile(wrapper), f"--parent {src}: no wrapper module {wrapper} beside it")
    spec = importlib.util.spec_from_file_location(f"cuttlefish_tpu_torch.kernels.{short}",
                                                  wrapper)
    twin = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(twin)
    twin._build = types.SimpleNamespace(load=lambda _name: lib)
    return twin, done.stdout + done.stderr


def launched(wrapper) -> int:
    """All launches a wrapper module has counted (an int or a dict of them)."""
    counts = wrapper.launches
    return counts if isinstance(counts, int) else sum(counts.values())


@contextlib.contextmanager
def routed_to(twin):
    """Within: the package's kernel calls of twin's source launch twin's
    build (kernels/bc.py, etc.py, ... import their wrapper module at each
    call)."""
    import cuttlefish_tpu_torch.kernels as pkg

    short = twin.__name__.rsplit(".", 1)[1]
    saved = getattr(pkg, short)
    setattr(pkg, short, twin)
    try:
        yield
    finally:
        setattr(pkg, short, saved)


def smem_bytes(entry_line: str) -> int:
    """Static shared memory of a ptxas_entries line."""
    return int(entry_line.rsplit("static shared memory", 1)[1].split("bytes")[0])


# Float operations per block of earlier kernels' device code on the same
# 1,024 blocks, counted by this script's bc_op_counter then (the commit),
# and what has left it since.
EARLIER_OPS = {
    "bc1_q2": (34805, "8f071ae", "each texel's distance to black made once a block, not per "
               "3-colour candidate; the sweep's two unchanged channels' terms made once per texel "
               "for a channel's 8 candidates, not per candidate"),
    "bc2_q2": (31830, "8f071ae", "the sweep's unchanged channels' terms, as BC1's"),
    "bc3_q2": (22986, "f476058", "the alpha's least squares make a texel's 1 - w once, not three "
               "times, and skip the texels at the fixed extremes"),
    "bc4_q2": (4865, "f476058", "as BC3's alpha"),
    "bc4s_q2": (4756, "f476058", "as BC3's alpha"),
    "bc5s_q2": (9574, "f476058", "as BC3's alpha, on both channels"),
    "bc7_q2": (26891, "8f071ae", "mode 1's subset-0 mask made from its bits, not as 1 - m"),
}
# The ETC/EAC rows whose code moved since: operations per block of the
# kernel's body as 80dec2d's eac_ops formula counted them (the input's clamp
# and scale included; RGBA8 with its RGB sweep), for every candidate in
# full; the EAC entries' counts now are what they need on the run's
# blocks, counted on their device code.
_EAC_SEARCH_WAS = ("a texel's error one square of the least of five distances (its side of the "
                   "base once), not the least of eight squares; the palette from a float table")
_EAC_EXITS_WAS = _EAC_SEARCH_WAS + "; repeated multipliers skipped, candidates left early"
EARLIER_OPS.update({
    "eac_alpha_q2": (20580, "80dec2d", _EAC_EXITS_WAS),
    "eac_alpha_q4": (47268, "80dec2d", _EAC_EXITS_WAS),
    "eac_r11_q0": (7526, "80dec2d", _EAC_EXITS_WAS),
    "eac_r11_q2": (21382, "80dec2d", _EAC_EXITS_WAS),
    "eac_r11_q4": (49094, "80dec2d", _EAC_EXITS_WAS),
    "eac_r11s_q2": (21382, "80dec2d", _EAC_EXITS_WAS),
    "eac_rg11_q2": (42764, "80dec2d", _EAC_EXITS_WAS),
    "eac_rg11s_q2": (42764, "80dec2d", _EAC_EXITS_WAS),
    "eac_rg11_q4": (98188, "80dec2d", _EAC_EXITS_WAS),
    "etc2_rgba_q2": (285632, "80dec2d", _EAC_SEARCH_WAS + " (the alpha)"),
    "etc2_rgba_q4": (539753, "80dec2d", _EAC_SEARCH_WAS + " (the alpha)"),
})

# The rows whose bound counts fewer operations than their device code
# makes (bc_op_counter's device=False), and why.
NEEDED_WHY = {
    "bc6h": "each texel's value and scale made once",
    "bc3": "the alpha's rounds end at the first candidate not taken",
    "bc4": "a mode's rounds end at the first candidate not taken",
    "bc5": "a mode's rounds end at the first candidate not taken",
}

# Code before a source's #include in its counting build.
BC_COUNT_PRE = {
    # BC6H makes a texel's value and scale where it reads them (TEXEL_FORM):
    # with g_once set those repeats go uncounted, and count adds each
    # texel's once.
    "bc6h_encode": r"""
static bool g_once = false;
template <class F>
static inline CF once_a_texel(F f) {
  const unsigned long long k = g_ops;
  const CF v = f();
  if (g_once) g_ops = k;
  return v;
}
#define TEXEL_FORM(v) once_a_texel([&]() { return CF(v); })
""",
    # The BC4 body ends a mode's rounds at the first candidate not taken
    # from q3 on (BC4_EXIT_FROM): count sets it to 0 for the rounds the
    # function needs at every quality, or to the kernel's 3.
    "bc_encode": r"""
static int g_bc4_exit_from = 3;
#define BC4_EXIT_FROM g_bc4_exit_from
""",
}

# The BC kernels' device code under the counting float, one library per
# source; each count() does what its __global__ kernel does around the
# device functions (loads, tables).  BC1/BC2/BC3 count the opaque q2
# variants of the main paths, BC4 unsigned and BC5 signed at q2.
BC_COUNT_SRC = {
    "bc7_encode": r"""
extern "C" void set_tables(const uint16_t* m2, const int* a2, const uint16_t*, const int*) {
  memcpy(bc7::c_part2, m2, sizeof bc7::c_part2);
  memcpy(bc7::c_anchor2, a2, sizeof bc7::c_anchor2);
}
// The warp body the card runs, its lanes one after another.
extern "C" unsigned long long count(const float* blocks, int n, int q, const float* chw,
                                    uint32_t* out) {
  g_ops = 0;
  const CF w[4] = {chw[0], chw[1], chw[2], chw[3]};
  bc7::bc7_cpu((const CF*)blocks, out, n, q, w);
  return g_ops;
}
""",
    "bc7_hq_encode": r"""
extern "C" void set_tables(const uint16_t* m2, const int* a2, const uint16_t* m3, const int* a3) {
  memcpy(bc7::c_part2, m2, sizeof bc7::c_part2);
  memcpy(bc7::c_anchor2, a2, sizeof bc7::c_anchor2);
  memcpy(bc7::c_part3, m3, sizeof bc7::c_part3);
  memcpy(bc7::c_anchor3, a3, sizeof bc7::c_anchor3);
}
// The warp body the card runs, its lanes one after another.
extern "C" unsigned long long count(const float* blocks, int n, int q, const float* chw,
                                    uint32_t* out) {
  g_ops = 0;
  const CF w[4] = {chw[0], chw[1], chw[2], chw[3]};
  bc7::bc7_hq_cpu((const CF*)blocks, out, n, q, w);
  return g_ops;
}
""",
    "bc_encode": r"""
// BC1 (kind 1: black allowed, or with punch-through), BC2 and BC3 through
// the CTA body the card runs (its texels staged, then its threads one after
// another); so do BC4 unsigned, BC5 signed, BC4 signed and BC5 unsigned
// (kinds 4, 5, 6, 7) at any quality.
// arg = kind | quality << 4 | punch-through << 8 | needed << 9 (the BC4
// body's rounds end at the first candidate not taken at every quality, not
// only from q3 as on the card); blocks [n,16,4] (BC4: [n,16]); out [n,4].
template <int KIND, int Q, bool PUNCH, bool UW>
static void cta(const float* blocks, int n, const CF* w, uint32_t* out) {
  constexpr int nw = KIND == 1 ? 2 : 4;
  std::vector<uint32_t> o((size_t)n * nw);
  bcx::bc_cpu<KIND, Q, PUNCH, KIND == 1 && !PUNCH, UW>((const CF*)blocks, o.data(), n, w);
  for (int i = 0; i < n; ++i)
    for (int j = 0; j < nw; ++j) out[4 * i + j] = o[nw * i + j];
}
template <int Q>
struct QualityTag {
  static constexpr int value = Q;
};
template <class F>
static void q_instance(int q, F f) {
  if (q == 0) f(QualityTag<0>());
  else if (q == 1) f(QualityTag<1>());
  else if (q == 2) f(QualityTag<2>());
  else if (q == 3) f(QualityTag<3>());
  else f(QualityTag<4>());
}
extern "C" unsigned long long count(const float* blocks, int n, int arg, const float* chw,
                                    uint32_t* out) {
  g_ops = 0;
  const CF w[3] = {chw[0], chw[1], chw[2]};
  const int kind = arg & 15, q = (arg >> 4) & 15, punch = (arg >> 8) & 1;
  g_bc4_exit_from = (arg >> 9) & 1 ? 0 : 3;
  const bool unit = chw[0] == 1.0f && chw[1] == 1.0f && chw[2] == 1.0f;
  if (kind == 1 && unit && !punch) {
    if (q == 0) cta<1, 0, false, true>(blocks, n, w, out);
    else if (q == 1) cta<1, 1, false, true>(blocks, n, w, out);
    else if (q == 2) cta<1, 2, false, true>(blocks, n, w, out);
    else if (q == 3) cta<1, 3, false, true>(blocks, n, w, out);
    else cta<1, 4, false, true>(blocks, n, w, out);
  } else if (kind == 1 && !unit && !punch && q == 2) {
    cta<1, 2, false, false>(blocks, n, w, out);
  } else if (kind == 1 && unit && punch && q == 2) {
    cta<1, 2, true, true>(blocks, n, w, out);
  } else if (kind == 2 && unit && q == 2) {
    cta<2, 2, false, true>(blocks, n, w, out);
  } else if (kind == 3 && unit && q == 2) {
    cta<3, 2, false, true>(blocks, n, w, out);
  } else if (kind >= 4 && kind <= 7) {
    q_instance(q, [&](auto qc) {
      constexpr int Q = decltype(qc)::value;
      if (kind == 4 || kind == 6) {
        std::vector<uint32_t> o((size_t)n * 2);
        if (kind == 4) bcx::bc4_cpu<Q, false>((const CF*)blocks, o.data(), n);
        else bcx::bc4_cpu<Q, true>((const CF*)blocks, o.data(), n);
        for (int i = 0; i < n; ++i)
          for (int j = 0; j < 4; ++j) out[4 * i + j] = j < 2 ? o[2 * i + j] : 0u;
      } else if (kind == 5) {
        bcx::bc5_cpu<Q, true>((const CF*)blocks, out, n, 4);
      } else {
        bcx::bc5_cpu<Q, false>((const CF*)blocks, out, n, 4);
      }
    });
  } else {
    abort();  // no such instance in this build
  }
  return g_ops;
}
""",
    "bc6h_encode": r"""
extern "C" void set_tables(const uint16_t* m, const int* a, const int* modes, const int* layout) {
  memcpy(bc6h::c_part32, m, sizeof bc6h::c_part32);
  memcpy(bc6h::c_anchor32, a, sizeof bc6h::c_anchor32);
  memcpy(bc6h::c_modes, modes, sizeof bc6h::c_modes);
  memcpy(bc6h::c_layout, layout, sizeof bc6h::c_layout);
}
// The warp body the card runs (the proxy made in it), its lanes one after
// another; blocks [n,16,3] as bc6h_cuda hands them on; arg = quality |
// signed << 3 | code metric << 4 | needed << 5 (each texel's value and
// scale counted once, not at every read).
extern "C" unsigned long long count(const float* blocks, int n, int arg, const float*,
                                    uint32_t* out) {
  const bool is_signed = (arg >> 3) & 1, code = (arg >> 4) & 1;
  g_ops = 0;
  g_once = (arg >> 5) & 1;
  bc6h::bc6h_cpu((const CF*)blocks, out, n, arg & 7, is_signed, code);
  if (g_once && !code) {
    for (long i = 0; i < 48L * n; ++i) {
      const unsigned long long k = g_ops;
      const CF p = is_signed ? bc6h::to_proxy<true>(CF(blocks[i]))
                             : bc6h::to_proxy<false>(CF(blocks[i]));
      g_ops = k;
      bc6h::proxy_to_value(p);
      bc6h::proxy_scale(p);
    }
  }
  return g_ops;
}
// The kernel's half-bit proxy of n values.
extern "C" void proxy(const float* in, int n, int is_signed, float* out) {
  for (int i = 0; i < n; ++i)
    out[i] = (is_signed ? bc6h::to_proxy<true>(CF(in[i])) : bc6h::to_proxy<false>(CF(in[i]))).v;
}
""",
}


def bc_op_counter(csrc: str, tmp: str):
    """-> count(row, host input, chw=None, device=False): (float operations
    per block, the device code's words [n, 4]) for the rows bc7_q0 .. bc7_q4,
    bc1_q0 .. bc1_q4 (black allowed), bc1_q2_punch, bc2_q2, bc3_q2, bc4_q0 ..
    bc4_q4, bc4s_q0 .. bc4s_q4 (signed), bc5_q2, bc5s_q2, and BC6H's
    bc6h[s]_q{2,4}[_code] (s: signed; _code: the code metric) (BC4: [n,16]
    values; BC6H: [n,16,3] RGB through the f16 wire; the others [n,16,4]
    RGBA); chw: other channel weights than the row's (BC7: the perceptual
    ones; BC1 at q2: any, through the weighted instance).  BC6H counts each
    texel's value and scale once, as the function needs them, or with
    device=True at every read, as its device code makes them; the BC4 body
    (bc3, bc4, bc5 rows) ends a mode's rounds at the first candidate not
    taken at every quality, or with device=True only from q3, as its device
    code does.  count.proxy(values, signed): the BC6H kernel's half-bit
    proxy of a float32 array."""
    import ctypes

    from cuttlefish_tpu_torch.kernels import bc, bc6h, bc7
    from cuttlefish_tpu_torch.kernels.bc7_tables import ANCHOR2, PARTITION2

    procs = {}
    for name, glue in BC_COUNT_SRC.items():
        src, so = os.path.join(tmp, f"{name}_count.cpp"), os.path.join(tmp, f"lib{name}_count.so")
        with open(src, "w") as f:
            f.write(COUNT_PRELUDE + BC_COUNT_PRE.get(name, "") + '#define float CF\n#include "'
                    + name + '.cu"\n#undef float\n' + glue)
        procs[name] = (subprocess.Popen(
            ["g++", "-O1", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC", "-I", csrc,
             "-o", so, src], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        _, err = proc.communicate(timeout=600)
        if proc.returncode:
            raise RuntimeError(f"g++ {name}_count.cpp failed:\n{err[-3000:]}")
        lib = ctypes.CDLL(so)
        lib.count.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                              ctypes.c_void_p]
        lib.count.restype = ctypes.c_ulonglong
        if name != "bc_encode":
            lib.set_tables.argtypes = [ctypes.c_void_p] * 4
            lib.set_tables.restype = None
        if name == "bc6h_encode":
            lib.proxy.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            lib.proxy.restype = None
        libs[name] = lib
    consts = bc7._constants(False, "cpu")
    tabs = [np.ascontiguousarray(consts.masks, np.uint16), np.ascontiguousarray(consts.anchors,
            np.int32), np.ascontiguousarray(consts.masks3, np.uint16),
            np.ascontiguousarray(consts.anchors3, np.int32)]
    for name in ("bc7_encode", "bc7_hq_encode"):
        libs[name].set_tables(*(t.ctypes.data for t in tabs))
    modes, layout = bc6h.layout_table()
    tabs6 = [np.ascontiguousarray(bc7._texel_bits(PARTITION2[:32]), np.uint16),
             np.ascontiguousarray(ANCHOR2[:32], np.int32),
             np.ascontiguousarray(modes, np.int32), np.ascontiguousarray(layout, np.int32)]
    libs["bc6h_encode"].set_tables(*(t.ctypes.data for t in tabs6))
    chw7 = np.ascontiguousarray(consts.chw, np.float32)
    chw1 = np.ascontiguousarray(bc.channel_weights(None), np.float32)
    rows = {"bc7_q0": ("bc7_encode", 0, chw7), "bc7_q1": ("bc7_encode", 1, chw7),
            "bc7_q2": ("bc7_encode", 2, chw7), "bc7_q3": ("bc7_hq_encode", 3, chw7),
            "bc7_q4": ("bc7_hq_encode", 4, chw7),
            "bc1_q2_punch": ("bc_encode", 1 | 2 << 4 | 1 << 8, chw1),
            "bc2_q2": ("bc_encode", 2 | 2 << 4, chw1), "bc3_q2": ("bc_encode", 3 | 2 << 4, chw1),
            "bc5s_q2": ("bc_encode", 5 | 2 << 4, chw1), "bc5_q2": ("bc_encode", 7 | 2 << 4, chw1)}
    for q in range(5):
        rows[f"bc1_q{q}"] = ("bc_encode", 1 | q << 4, chw1)
        rows[f"bc4_q{q}"] = ("bc_encode", 4 | q << 4, chw1)
        rows[f"bc4s_q{q}"] = ("bc_encode", 6 | q << 4, chw1)
    for q in (2, 4):
        for sgn in (0, 1):
            for code in (0, 1):
                rows[f"bc6h{'s' if sgn else ''}_q{q}{'_code' if code else ''}"] = (
                    "bc6h_encode", q | sgn << 3 | code << 4, chw1)

    def count(row, blocks, chw=None, device=False):
        name, arg, row_chw = rows[row]
        if name == "bc6h_encode" and not device:
            arg |= 1 << 5
        if name == "bc_encode" and not device:
            arg |= 1 << 9
        chw = row_chw if chw is None else np.ascontiguousarray(chw, np.float32)
        x = np.ascontiguousarray(blocks, np.float32)
        words = np.zeros((x.shape[0], 4), np.uint32)
        ops = libs[name].count(x.ctypes.data, x.shape[0], arg, chw.ctypes.data, words.ctypes.data)
        nw = 2 if row.startswith(("bc1", "bc4")) else 4
        return ops / max(x.shape[0], 1), words[:, :nw]

    def proxy(values, signed):
        x = np.ascontiguousarray(values, np.float32)
        out = np.zeros_like(x)
        libs["bc6h_encode"].proxy(x.ctypes.data, x.size, int(signed), out.ctypes.data)
        return out

    count.proxy = proxy
    return count


def ptxas_lines(log_text: str) -> list[str]:
    keep = ("Compiling entry", "registers", "spill")
    return [ln.strip() for ln in log_text.splitlines() if any(k in ln for k in keep)]


def ptxas_entries(log_text: str) -> list[str]:
    """One line per kernel entry of an nvcc -Xptxas -v log: its registers,
    stack frame, spills and static shared memory."""
    out, name, frame = [], None, None
    for ln in log_text.splitlines():
        if "Compiling entry function" in ln:
            name, frame = ln.split("'")[1], None
        elif name and frame is None and "bytes stack frame" in ln:
            frame = ln.split(":")[-1].strip()
        elif name and "Used" in ln and "registers" in ln:
            used = ln.split("Used", 1)[1].strip()
            smem = [p.strip() for p in used.split(",") if "smem" in p]
            out.append(f"{name}: {used.split(',')[0]}; {frame}; static shared memory "
                       f"{smem[0] if smem else '0 bytes smem'}")
            name = None
    return out


ROOT = os.path.dirname(os.path.abspath(__file__))


def ctest_cases() -> list:
    """The reference's 97 ctest rows, (name, exit code, argv string): the
    ``CASES`` of tests/test_cli_reference_parity.py, read without importing
    it."""
    import ast

    path = os.path.join(ROOT, "tests", "test_cli_reference_parity.py")
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "CASES" for t in node.targets):
            return ast.literal_eval(node.value)
    raise SmokeFailure(f"no CASES in {path}")


def ctest_fixtures(native, d: str) -> None:
    """The fixtures of tests/test_cli_reference_parity.py (4x4 RGBA PNGs,
    4x2 array slices, the five list files), written with the port's PNG
    encoder (the card's machine has no Pillow)."""
    def png(name, w, h, seed):
        rng = np.random.default_rng(seed)
        with open(os.path.join(d, name), "wb") as f:
            f.write(native.png_encode((rng.random((h, w, 4)) * 255).astype(np.uint8)))

    png("texture.png", 4, 4, 0)
    png("地.png", 4, 4, 1)
    for i in range(3):
        png(f"array {i}.png", 4, 2, 10 + i)
    for i, face in enumerate(["posx", "negx", "posy", "negy", "posz", "negz"]):
        png(f"{face}.png", 4, 4, 20 + i)
    cube = "negx.png\nposx.png\nnegy.png\nposy.png\nnegz.png\nposz.png\n"
    for name, text in (("image.txt", "texture.png\n"),
                       ("array.txt", "array 0.png\narray 1.png\narray 2.png\n"),
                       ("cube.txt", cube), ("cube-array.txt", cube * 2),
                       ("custom-mip.txt", "1 array 0.png\n2 0 +x once array 1.png\n")):
        with open(os.path.join(d, name), "w", encoding="utf-8") as f:
            f.write(text)


def read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def cli_mesh_phase(torch, cp, dev, card, surf, counted, bc7_plain, tmp) -> None:
    """Phase 6: the CLI (cuttlefish_tpu_torch.cli) and the device mesh
    (cuttlefish_tpu_torch.parallel) on the card.

    ``counted(label, fn)`` runs fn() with every launch counter at 0 and
    every plain version counting its calls, fails if a plain version ran,
    adds the launches to the kernels line's and returns (fn's result,
    {kernel: launches}).  ``bc7_plain(x)``: the plain BC7 q2 version on the
    float32 blocks x on the card.
    """
    import contextlib
    import io
    import shlex

    from cuttlefish_tpu_torch import cli, native
    from cuttlefish_tpu_torch.convert.blocks import extract_blocks
    from cuttlefish_tpu_torch.convert.device import dequant, wire
    from cuttlefish_tpu_torch.decode import decode_bc7
    from cuttlefish_tpu_torch.parallel import default_mesh, use_mesh

    TF, TT = cp.TextureFormat, cp.TextureType

    def quiet_run(argv):
        """cli.run(argv) on the card, its output kept out of the log."""
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(buf):
            rc = cli.run(argv)
        return rc, buf.getvalue()

    # The reference's ctest rows, in-process on the card.
    cases = ctest_cases()
    fix = os.path.join(tmp, "ctest")
    os.makedirs(fix)
    ctest_fixtures(native, fix)
    cwd = os.getcwd()
    os.chdir(fix)
    t0 = time.perf_counter()
    try:
        def replay():
            return [(name, want, quiet_run(
                [a.replace("@null@", os.devnull) for a in shlex.split(args)]))
                for name, want, args in cases]
        results, launches = counted("ctest", replay)
    finally:
        os.chdir(cwd)
    wrong = [(name, want, rc, out[-300:]) for name, want, (rc, out) in results if rc != want]
    log("cli", f"{len(cases)} reference ctest cases in-process on the card in "
        f"{time.perf_counter() - t0:.2f} s: {len(cases) - len(wrong)} gave the reference's "
        f"exit code ({sum(w == 0 for _, w, _ in cases)} conversions); launches {launches}, "
        f"plain calls 0")
    check(len(cases) == 97 and not wrong, f"ctest cases with another exit code: {wrong}")

    # The full-width CLI path: the 2048^2 test surface as an 8-bit PNG ->
    # BC7 Normal + 12 mips -> DDS, on host mips and with --device-mips; in
    # process (run) and through python -m cuttlefish_tpu_torch.
    u8 = (np.clip(surf, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    png = os.path.join(tmp, "surf.png")
    with open(png, "wb") as f:
        f.write(native.png_encode(u8))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    files = {}
    for mode, extra in (("host mips", []), ("--device-mips", ["--device-mips"])):
        out = os.path.join(tmp, f"cli_{len(files)}.dds")
        argv = ["-i", png, "-f", "BC7", "-m", "-o", out] + extra
        secs = []
        for i in range(3):
            t0 = time.perf_counter()
            if i == 0:
                (rc, text), launches = counted(f"cli {mode}", lambda: quiet_run(argv))
            else:
                rc, text = quiet_run(argv)
                torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            check(rc == 0, f"cli {mode}: exit code {rc}: {text[-2000:]}")
            if i == 0:
                first = read(out)
            check(read(out) == first, f"cli {mode}: run {i} wrote other bytes")
        check(launches.get("bc7", 0) > 0 and set(launches) == {"bc7"},
              f"cli {mode}: launches {launches}, want bc7_kernel")
        sub = os.path.join(tmp, f"cli_sub_{len(files)}.dds")
        sargv = [sys.executable, "-m", "cuttlefish_tpu_torch", "-i", png, "-f", "BC7", "-m",
                 "-o", sub] + extra
        t0 = time.perf_counter()
        proc = subprocess.run(sargv, cwd=ROOT, env=env, capture_output=True, text=True,
                              timeout=600)
        sub_s = time.perf_counter() - t0
        check(proc.returncode == 0, f"python -m cuttlefish_tpu_torch ({mode}): exit code "
              f"{proc.returncode}: {proc.stderr[-2000:]}")
        check(read(sub) == first,
              f"python -m cuttlefish_tpu_torch ({mode}) wrote other bytes than run()")
        files[mode] = (out, first, launches, statistics.median(secs), secs, sub_s)

    # The same converts through the Texture API, as the CLI makes them.
    def api_texture():
        img = cp.Image(png)
        orig = img.format
        img = cp.Texture.adjust_image_value_range(
            img.convert(cp.ImageFormat.RGBAF), TT.UNorm, orig)
        tex = cp.Texture(cp.Dimension.Dim2D, img.width, img.height)
        check(tex.set_image(img), "api: set_image failed")
        return tex

    def all_levels(tex):
        return b"".join(tex.data(mip_level=m) for m in range(tex.mip_levels))

    api_host = api_texture()
    check(api_host.generate_mipmaps(filter=cp.ResizeFilter.CatmullRom,
                                    mip_levels=0xFFFFFFFF), "api: generate_mipmaps failed")

    def convert_host():
        check(api_host.convert(TF.BC7, TT.UNorm, quality=cp.Quality.Normal,
                               alpha_type=cp.Alpha.Standard), "api: convert failed")
        return all_levels(api_host)

    def convert_fused():
        tex = api_texture()
        check(tex.convert_with_mips(TF.BC7, TT.UNorm, quality=cp.Quality.Normal,
                                    alpha_type=cp.Alpha.Standard, mip_levels=0xFFFFFFFF,
                                    filter=cp.ResizeFilter.CatmullRom),
              "api: convert_with_mips failed")
        return tex

    convert_host()
    for mode, tex in (("host mips", api_host), ("--device-mips", convert_fused())):
        path = os.path.join(tmp, f"api_{len(mode)}.dds")
        check(tex.save(path) is cp.SaveResult.Success, f"api {mode}: save failed")
        check(read(path) == files[mode][1], f"cli {mode}: the file differs from the Texture API's")

    # Level 0 of each CLI file within phase 4's bars: a strided sample of
    # 4,096 blocks >= 99 % identical to the plain version on the same
    # input (host mips: the u8 wire; fused: the float32 texels of level 0),
    # decoded finite and above 30 dB.
    b0 = extract_blocks(api_host.get_image().rgbaf(), 4, 4)[0]
    idx = np.arange(0, b0.shape[0], max(1, b0.shape[0] // 4096))
    refs = {
        "host mips": bc7_plain(dequant(wire(b0[idx], "u8").to(dev))),
        "--device-mips": bc7_plain(torch.from_numpy(b0[idx]).to(dev)),
    }
    target = np.clip(np.round(b0[idx].astype(np.float64) * 255), 0, 255)
    for mode, (out, data, launches, med, secs, sub_s) in files.items():
        ref = to_bytes(refs[mode].cpu().numpy()).reshape(-1, 16)
        loaded = cp.load_texture(out)
        check(loaded.format is TF.BC7 and loaded.mip_levels == SIZE.bit_length()
              and (loaded.width(), loaded.height()) == (SIZE, SIZE),
              f"cli {mode}: loaded {loaded.format} with {loaded.mip_levels} mips")
        raw = np.frombuffer(loaded.data(), np.uint8).reshape(-1, 16)[idx]
        same = float(np.all(raw == ref, axis=1).mean())
        dec = np.asarray(decode_bc7(raw.reshape(-1)), np.float64)
        p0 = psnr(dec, target, 255.0)
        log("cli", f"{card}: BC7 {SIZE}^2 + {SIZE.bit_length()} mips -> DDS, {mode}: "
            f"{len(data)} bytes; launches "
            f"{launches}, plain calls 0; run() median of 3 {med:.4f} s {[round(s, 4) for s in secs]}; "
            f"python -m cuttlefish_tpu_torch {sub_s:.4f} s (interpreter start and kernel load "
            f"included), same bytes; the Texture API's file: same bytes; level-0 sample "
            f"{idx.size} identical to plain {same * 100:.2f} %, PSNR {p0:.4f} dB")
        check(same >= MIN_SAME, f"cli {mode}: level 0 disagrees with the plain version")
        check(np.isfinite(dec).all() and dec.shape == target.shape and p0 > 30.0,
              f"cli {mode}: level 0 decodes to {p0:.4f} dB")

    # The mesh: BC7 q2 2048^2 + mips (host mips and fused) split over two
    # entries on one card and over default_mesh(): the words of the
    # unsplit run; then the host-mips convert timed without a mesh and with
    # two entries, in turns.
    two = [dev, dev]
    whole = files["host mips"][1][148:]
    for label, mesh in (("[cuda:0, cuda:0]", two), ("default_mesh()", default_mesh())):
        with use_mesh(mesh) as m:
            words, launches = counted(f"mesh {label}", convert_host)
            check(words == whole, f"mesh {label}: host-mips words differ from the unsplit run")
            check(launches == {"bc7": m.size}, f"mesh {label}: launches {launches}")
            tex, flaunches = counted(f"mesh {label} fused", convert_fused)
            check(all_levels(tex) == files["--device-mips"][1][148:],
                  f"mesh {label}: fused words differ from the unsplit run")
            check(flaunches == {"bc7": m.size}, f"mesh {label} fused: launches {flaunches}")
        log("mesh", f"{label} ({m.size} entries): BC7 2048^2 + mips, host mips and fused, "
            f"words identical to the unsplit run; launches {launches} and {flaunches}")

    # A CPU mesh under the card's Texture raises before any work: the work
    # never leaves the card, and nothing encodes on the CPU in its stead.
    def convert_under_cpu_mesh():
        with use_mesh(["cpu", "cpu"]):
            try:
                convert_host()
            except ValueError:
                return True
        return False

    raised, launches = counted("mesh [cpu, cpu]", convert_under_cpu_mesh)
    check(raised and not launches, f"mesh [cpu, cpu]: raised {raised}, launches {launches}")
    log("mesh", "[cpu, cpu] under the card's Texture: ValueError, no launch, no plain call")
    secs = {"none": [], "two": []}
    phases = {"none": [], "two": []}
    for i in range(10):
        key = "none" if i % 4 in (0, 3) else "two"
        with use_mesh(two if key == "two" else None):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            convert_host()
            torch.cuda.synchronize()
            secs[key].append(time.perf_counter() - t0)
            phases[key].append(api_host.last_convert_stats["phases"])
    for key, label in (("none", "no mesh"), ("two", "mesh [cuda:0, cuda:0]")):
        median = {k: round(statistics.median(p.get(k, 0.0) for p in phases[key]), 6)
                  for k in phases[key][-1]}
        log("times", f"{card}: convert bc7_2048_mips_dds, {label}, median of 5 "
            f"{statistics.median(secs[key]):.4f} s {[round(s, 4) for s in secs[key]]}; phases, "
            f"each its median of the 5 {json.dumps(median)}")


def main(argv: list[str]) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description="Smoke run of the port on one GPU.")
    ap.add_argument("--parent", action="append", default=[], metavar="SRC",
                    help="an earlier tree's csrc/*.cu of the BC, ETC or ASTC kernels, its "
                    "headers beside it and its kernels/ wrapper modules beside csrc/: phase 5 "
                    "times its cases in turns with this tree's")
    args = ap.parse_args(argv)

    # 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs a GPU", file=sys.stderr)
        return 2
    import cuttlefish_tpu_torch as cp
    from cuttlefish_tpu_torch import native
    from cuttlefish_tpu_torch.convert.blocks import extract_blocks
    from cuttlefish_tpu_torch.convert.device import dequant, pyramid_blocks, wire
    from cuttlefish_tpu_torch.convert.astc import AstcConverter
    from cuttlefish_tpu_torch.decode import (
        decode_astc, decode_bc1, decode_bc2, decode_bc3, decode_bc4, decode_bc5,
        decode_bc6h_f32, decode_bc7, decode_eac_alpha, decode_eac_r11, decode_eac_rg11,
        decode_etc2_a1, decode_etc2_rgba, decode_etc_rgb, decode_pvrtc1, decode_pvrtc2,
    )
    from cuttlefish_tpu_torch.decode.astc import decode_astc_hdr
    from cuttlefish_tpu_torch.kernels import (
        _build, astc, astc_cuda, astc_tables, bc, bc6h, bc6h_cuda, bc7, bc7_cuda, bc7_hq_cuda,
        bc_cuda, etc, etc_cuda, launch_counts, astc_hdr, pvrtc,
    )
    from cuttlefish_tpu_torch.kernels.pvrtc_tables import morton_order
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
    for name in ("bc7_encode", "bc7_hq_encode", "bc_encode", "bc6h_encode", "etc_encode",
                 "astc_encode"):
        _build.load(name)
    build_s = time.perf_counter() - t0
    for name, info in sorted(_build.build_info.items()):
        check(info["path"].startswith(str(_build.build_dir())), "library outside the build dir")
        log("build", f"{name}.cu -> {info['path']} (built={info['built']}, "
            f"{info['seconds']:.2f} s)")
        for line in ptxas_lines(info["log"]):
            log("build", f"ptxas {name}: {line}")
    for line in ptxas_entries(_build.build_info["bc7_encode"]["log"]):
        log("build", f"ptxas bc7_encode entry {line}")
    log("build", "bc7_kernel: 4 warps a CTA, 32 blocks a warp, its blocks' texels and phase "
        "results in static shared memory (above)")
    for line in ptxas_entries(_build.build_info["bc_encode"]["log"]):
        log("build", f"ptxas bc_encode entry {line}")
    log("build", "bc1_kernel, bc23_kernel: 128 threads a CTA, its blocks' texels in static shared "
        "memory (above)")
    for line in ptxas_entries(_build.build_info["bc7_hq_encode"]["log"]):
        log("build", f"ptxas bc7_hq_encode entry {line}")
    log("build", f"bc7_hq_kernel: 4 warps a CTA, 32 blocks a warp, {bc7_hq_cuda.shared_bytes()} "
        f"bytes of dynamic shared memory a CTA (its blocks' texels and phase results)")
    for line in ptxas_entries(_build.build_info["bc6h_encode"]["log"]):
        log("build", f"ptxas bc6h_encode entry {line}")
        if "bc6h_kernel" in line.split(":")[0]:
            log("build", f"bc6h_kernel: 4 warps a CTA, 32 blocks a warp, {smem_bytes(line)} bytes "
                f"of static shared memory a CTA (its blocks' half-bit proxies)")
    for line in ptxas_entries(_build.build_info["astc_encode"]["log"]):
        log("build", f"ptxas astc_encode entry {line}")
    for line in ptxas_entries(_build.build_info["etc_encode"]["log"]):
        log("build", f"ptxas etc_encode entry {line}")
        for entry, threads in (("etc_rgb_kernel", 128), ("etc2_rgba_kernel", 128),
                               ("eac_alpha_kernel", 128), ("eac_r11_kernel", 128),
                               ("eac_rg11_kernel", 256)):
            if entry in line.split(":")[0]:
                log("build", f"{entry}: {threads} threads a CTA over 128 blocks, "
                    f"{smem_bytes(line)} bytes of static shared memory a CTA (its blocks' texels)")
    parent_dir = tempfile.TemporaryDirectory()
    earlier = {}  # repo path of the source -> its earlier build's wrapper module
    for src in args.parent:
        t0 = time.perf_counter()
        twin, parent_log = build_earlier(src, parent_dir.name)
        earlier[f"cuttlefish_tpu_torch/csrc/{os.path.basename(src)}"] = twin
        log("build", f"{src} (earlier file, for phase 5) in {time.perf_counter() - t0:.2f} s")
        for line in ptxas_entries(parent_log):
            log("build", f"ptxas {src} entry {line}")
    for bw, bh in ((4, 4), (8, 8), (12, 12)):
        for q, gray in ((2, False), (4, True)):
            plan = astc_cuda.warp_plan("a", bw, bh, q, gray, True)
            log("build", f"astc_a {bw}x{bh} q{q}{' gray' if gray else ''} alpha: a CTA per "
                f"{plan['group']} blocks, {plan['warps']} warps (a warp per task), "
                f"{plan['smem_bytes']} bytes of dynamic shared memory a CTA")
        for stage, q in (("b", 2), ("b", 4), ("c", 4), ("d", 4)):
            plan = astc_cuda.warp_plan(stage, bw, bh, q, True, True)
            if not plan["group"]:
                log("build", f"astc_{stage} {bw}x{bh} q{q}: a thread per block, 64 a CTA, its "
                    f"blocks' texels in static shared memory (astc_b4x4_kernel above)")
                continue
            log("build", f"astc_{stage} {bw}x{bh} q{q} gray alpha: {plan['group']} blocks a warp, "
                f"4 warps a CTA, {plan['smem_bytes']} bytes of dynamic shared memory a CTA "
                f"({plan['mask_bytes']} of pattern masks); {plan['scratch_bytes']} bytes of device "
                f"scratch a block")
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
    hdr = hdr_surface(surf)
    shdr = signed_hdr_surface(hdr)
    host = {k: extract_blocks(v, 4, 4)[0] for k, v in
            (("rgba", surf), ("alpha", asurf), ("hard", hsurf), ("signed", ssurf),
             ("hdr", hdr), ("shdr", shdr))}
    n = host["rgba"].shape[0]
    check(n == 262144, f"expected 262144 blocks, got {n}")
    dev_in = {
        "rgba": torch.from_numpy(host["rgba"]).to(dev),
        "alpha": torch.from_numpy(host["alpha"]).to(dev),
        "hard": torch.from_numpy(host["hard"]).to(dev),
        "signed": dequant(wire(host["signed"], "f16").to(dev)),
        # BC6H: RGB of the f16 wire, as Bc6hConverter hands it on.
        "hdr": dequant(wire(host["hdr"], "f16").to(dev))[..., :3].contiguous(),
        "shdr": dequant(wire(host["shdr"], "f16").to(dev))[..., :3].contiguous(),
    }
    dev_in["alpha1"] = dev_in["alpha"][..., 3].contiguous()  # BC4 unsigned, EAC A8: alpha
    # BC5 unsigned: the alpha surface through the u8 wire, as Bc5Converter
    # hands it on.
    dev_in["alpha8"] = dequant(wire(host["alpha"], "u8").to(dev))
    dev_in["signed1"] = dev_in["signed"][..., 0].contiguous()  # BC4, EAC R11 signed: red
    # EAC R11/RG11 unsigned: the surface through the f16 wire, as
    # EacR11Converter hands it on.
    dev_in["rgba16"] = dequant(wire(host["rgba"], "f16").to(dev))
    dev_in["red16"] = dev_in["rgba16"][..., 0].contiguous()
    sample = np.arange(0, n, SAMPLE_STRIDE)
    srgb = bc.channel_weights(np.float32([0.3, 0.59, 0.11]) * np.float32(3))
    srgb709 = bc.channel_weights(np.float32([0.2126, 0.7152, 0.0722]) * np.float32(3))
    consts = _constants(False, dev)

    def dec_rgb(raw):
        return decode_bc1(raw, opaque=True)[..., :3]

    # name -> (kernel, plain, input, decoder, target channels, peak)
    cases = {}
    # BC7 q0-2: every instantiation of the q0-2 kernel, and the perceptual
    # weights (0.55, 1.1, 0.35, 1.0) that every sRGB texture takes.
    for q, perc in ((0, False), (1, True), (2, False), (2, True)):
        cases[f"bc7_q{q}{'p' if perc else ''}"] = (
            lambda x, q=q, p=perc: encode_bc7(x, q, p),
            lambda x, q=q, p=perc: encode_bc7_plain(x, q, _constants(p, x.device)),
            "rgba", decode_bc7, slice(0, 4), 255.0,
        )
    cases.update({
        "bc2_q2": (lambda x: bc.encode_bc2(x, 2), lambda x: bc.encode_bc2_plain(x, 2),
                   "alpha", decode_bc2, slice(0, 4), 255.0),
        "bc3_q2": (lambda x: bc.encode_bc3(x, 2), lambda x: bc.encode_bc3_plain(x, 2),
                   "alpha", decode_bc3, slice(0, 4), 255.0),
        "bc4_q2": (lambda x: bc.encode_bc4(x, 2), lambda x: bc.encode_bc4_plain(x, 2),
                   "alpha1", decode_bc4, None, 1.0),
        "bc4s_q2": (lambda x: bc.encode_bc4(x, 2, True),
                    lambda x: bc.encode_bc4_plain(x, 2, True),
                    "signed1", lambda r: decode_bc4(r, signed=True), None, 2.0),
        # q3-q4 take the other side of the rounds' exit (bc4_tile).
        "bc4_q4": (lambda x: bc.encode_bc4(x, 4), lambda x: bc.encode_bc4_plain(x, 4),
                   "alpha1", decode_bc4, None, 1.0),
        "bc4s_q4": (lambda x: bc.encode_bc4(x, 4, True),
                    lambda x: bc.encode_bc4_plain(x, 4, True),
                    "signed1", lambda r: decode_bc4(r, signed=True), None, 2.0),
        "bc5s_q2": (lambda x: bc.encode_bc5(x, 2, True),
                    lambda x: bc.encode_bc5_plain(x, 2, True),
                    "signed", lambda r: decode_bc5(r, signed=True), slice(0, 2), 2.0),
        "bc5_q2": (lambda x: bc.encode_bc5(x, 2), lambda x: bc.encode_bc5_plain(x, 2),
                   "alpha8", decode_bc5, slice(0, 2), 1.0),
        "bc1_q2_punch": (lambda x: bc.encode_bc1(x, 2, True, False),
                         lambda x: bc.encode_bc1_plain(x, 2, True, False),
                         "hard", decode_bc1, slice(0, 4), 255.0),
    })
    for q in range(5):
        cases[f"bc1_q{q}"] = (
            lambda x, q=q: bc.encode_bc1(x, q), lambda x, q=q: bc.encode_bc1_plain(x, q),
            "rgba", dec_rgb, slice(0, 3), 255.0,
        )
    cases["bc1_q2_srgb"] = (
        lambda x: bc.encode_bc1(x, 2, ch_weights=srgb),
        lambda x: bc.encode_bc1_plain(x, 2, chw=srgb), "rgba", dec_rgb, slice(0, 3), 255.0,
    )
    # This slice: BC7 q3-4 (the high-quality kernel) and BC6H.
    for q, perc in ((3, False), (4, False), (4, True)):
        cases[f"bc7_q{q}{'p' if perc else ''}"] = (
            lambda x, q=q, p=perc: encode_bc7(x, q, p),
            lambda x, q=q, p=perc: encode_bc7_plain(x, q, _constants(p, x.device)),
            "rgba", decode_bc7, slice(0, 4), 255.0,
        )
    bc6h_cases = [(f"bc6h_q{q}", q, False, "value") for q in range(5)] + [
        ("bc6hs_q2", 2, True, "value"), ("bc6hs_q4", 4, True, "value"),
        ("bc6h_q2_code", 2, False, "code"),
    ]
    for name, q, sgn, metric in bc6h_cases:
        cases[name] = (
            lambda x, q=q, s=sgn, m=metric: bc6h.encode_bc6h(x, q, s, m),
            lambda x, q=q, s=sgn, m=metric: bc6h.encode_bc6h_plain(x, q, s, m),
            "shdr" if sgn else "hdr",
            lambda r, s=sgn: decode_bc6h_f32(r, signed=s), slice(0, 3), None,
        )

    # This slice: ETC1/ETC2 RGB, ETC2 RGBA8 and EAC.  needed_ops: the float
    # operations per block that each needs on its own inputs (unit channel
    # weights but the Rec.709 case), its input's clamp and scale (3 per
    # value) included; weighted_ops: the unit-weight cases counted with the
    # weight products too, printed beside them.
    needed_ops, weighted_ops = {}, {}
    for q in (0, 1, 2, 4):
        cases[f"etc1_q{q}"] = (
            lambda x, q=q: etc.encode_etc_rgb(x, q), lambda x, q=q: etc.encode_etc_rgb_plain(x, q),
            "rgba", lambda r: decode_etc_rgb(r, False), slice(0, 3), 255.0,
        )
        needed_ops[f"etc1_q{q}"] = 3 * 48 + etc_rgb_ops(q, False, False)
        weighted_ops[f"etc1_q{q}"] = 3 * 48 + etc_rgb_ops(q, False, True)
    for q in (2, 4):
        cases[f"etc2_q{q}"] = (
            lambda x, q=q: etc.encode_etc_rgb(x, q, True),
            lambda x, q=q: etc.encode_etc_rgb_plain(x, q, True),
            "rgba", lambda r: decode_etc_rgb(r, True), slice(0, 3), 255.0,
        )
        cases[f"etc2_rgba_q{q}"] = (
            lambda x, q=q: etc.encode_etc2_rgba(x, q),
            lambda x, q=q: etc.encode_etc2_rgba_plain(x, q),
            "alpha", decode_etc2_rgba, slice(0, 4), 255.0,
        )
        for w, ops in ((False, needed_ops), (True, weighted_ops)):
            ops[f"etc2_q{q}"] = 3 * 48 + etc_rgb_ops(q, True, w)
            ops[f"etc2_rgba_q{q}"] = 3 * 64 + eac_ops(q) + etc_rgb_ops(q, True, w)
    cases["etc2_q2_srgb"] = (
        lambda x: etc.encode_etc_rgb(x, 2, True, srgb709),
        lambda x: etc.encode_etc_rgb_plain(x, 2, True, srgb709),
        "rgba", lambda r: decode_etc_rgb(r, True), slice(0, 3), 255.0,
    )
    needed_ops["etc2_q2_srgb"] = weighted_ops["etc2_q2"]
    # EAC: name -> (entry, quality, signed) of its device-code count
    # (eac_op_counter, phase 5).
    eac_counted = {}
    for q in (2, 4):
        cases[f"eac_alpha_q{q}"] = (
            lambda x, q=q: etc.encode_eac_alpha(x, q),
            lambda x, q=q: etc.encode_eac_alpha_plain(x, q),
            "alpha1", lambda r: decode_eac_alpha(r) / 255.0, None, 1.0,
        )
        eac_counted[f"eac_alpha_q{q}"] = ("alpha", q, False)
    for q in (0, 2, 4):
        cases[f"eac_r11_q{q}"] = (
            lambda x, q=q: etc.encode_eac_r11(x, q),
            lambda x, q=q: etc.encode_eac_r11_plain(x, q),
            "red16", decode_eac_r11, None, 1.0,
        )
        eac_counted[f"eac_r11_q{q}"] = ("r11", q, False)
    cases.update({
        "eac_r11s_q2": (lambda x: etc.encode_eac_r11(x, 2, True),
                        lambda x: etc.encode_eac_r11_plain(x, 2, True),
                        "signed1", lambda r: decode_eac_r11(r, signed=True), None, 2.0),
        "eac_rg11s_q2": (lambda x: etc.encode_eac_rg11(x, 2, True),
                         lambda x: etc.encode_eac_rg11_plain(x, 2, True),
                         "signed", lambda r: decode_eac_rg11(r, signed=True), slice(0, 2), 2.0),
        "eac_rg11_q2": (lambda x: etc.encode_eac_rg11(x, 2),
                        lambda x: etc.encode_eac_rg11_plain(x, 2),
                        "rgba16", decode_eac_rg11, slice(0, 2), 1.0),
        "eac_rg11_q4": (lambda x: etc.encode_eac_rg11(x, 4),
                        lambda x: etc.encode_eac_rg11_plain(x, 4),
                        "rgba16", decode_eac_rg11, slice(0, 2), 1.0),
    })
    eac_counted.update({"eac_r11s_q2": ("r11", 2, True), "eac_rg11s_q2": ("rg11", 2, True),
                        "eac_rg11_q2": ("rg11", 2, False), "eac_rg11_q4": ("rg11", 4, False)})

    def target_of(kind, chans):
        """What the sample should decode to: 8-bit texels of the source for
        the colour formats, the float input for BC4, BC5, BC6H and EAC."""
        if kind in ("alpha1", "alpha8", "signed1", "signed", "hdr", "shdr", "red16", "rgba16"):
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
        if peak is None:  # HDR: peak-relative, as tests/test_pallas.py:319-336
            peak = float(np.abs(target).max())
        pk, pp = psnr(dk, target, peak), psnr(dp, target, peak)
        err = float(np.abs(dk - dp).max())
        max_err[name] = err
        log("kernel_vs_plain", f"{name}: {n} blocks identical {same * 100:.4f} % "
            f"(bar {MIN_SAME * 100:.0f} %); sample {sample.size} PSNR kernel {pk:.4f} dB "
            f"plain {pp:.4f} dB (|d| bar {MAX_DPSNR}); max |decoded kernel - plain| {err}")
        check(same >= MIN_SAME, f"{name}: kernel and plain version disagree on too many blocks")
        check(abs(pk - pp) <= MAX_DPSNR, f"{name}: kernel and plain PSNR differ")
        check(np.isfinite(pk), f"{name}: PSNR not finite")

    # This slice: ASTC LDR, the four entries merged as the converter merges
    # them.  Inputs go through the u8 wire as AstcConverter hands them on,
    # with the gates its content scans set; near-gray surfaces: R = G = B
    # from the test surface, opaque and with the alpha surface's alpha.
    gsurf, gasurf = surf.copy(), asurf.copy()
    for g in (gsurf, gasurf):
        g[..., 1] = g[..., 0]
        g[..., 2] = g[..., 0]
    astc_surfaces = {"rgba": surf, "alpha": asurf, "gray": gsurf, "grayalpha": gasurf}
    astc_in = {}

    def astc_input(bw, bh, kind):
        """(wire values on the host, on the card, gray gate, alpha gate)."""
        if (bw, bh, kind) not in astc_in:
            hb = extract_blocks(astc_surfaces[kind], bw, bh)[0]
            x = dequant(wire(hb, "u8").to(dev))
            astc_in[bw, bh, kind] = (x.cpu().numpy(), x, astc_tables.has_gray_blocks(hb),
                                     astc_tables.has_alpha_blocks(hb))
        return astc_in[bw, bh, kind]

    # name -> (block width, block height, quality, surface)
    astc_cases = {
        "astc4_q0": (4, 4, 0, "rgba"), "astc4_q2": (4, 4, 2, "rgba"), "astc4_q4": (4, 4, 4, "rgba"),
        "astc4_q2_alpha": (4, 4, 2, "alpha"), "astc4_q4_alpha": (4, 4, 4, "alpha"),
        "astc4_q2_gray": (4, 4, 2, "gray"), "astc4_q4_gray": (4, 4, 4, "gray"),
        "astc4_q2_grayalpha": (4, 4, 2, "grayalpha"), "astc4_q4_grayalpha": (4, 4, 4, "grayalpha"),
        "astc6x6_q2": (6, 6, 2, "alpha"), "astc8x8_q2": (8, 8, 2, "rgba"),
        "astc10x5_q2": (10, 5, 2, "alpha"), "astc12x12_q2": (12, 12, 2, "rgba"),
        "astc8x8_q4": (8, 8, 4, "grayalpha"),
    }
    for name, (bw, bh, q, kind) in astc_cases.items():
        hw, x, gray, alpha = astc_input(bw, bh, kind)
        nb = x.shape[0]
        k_np = astc.encode_astc(x, bw, bh, q, gray, alpha).cpu().numpy()
        p_np = astc.encode_astc_plain(x, bw, bh, q, gray, alpha).cpu().numpy()
        torch.cuda.synchronize()
        same = float(np.all(k_np == p_np, axis=1).mean())
        samp = np.arange(0, nb, max(1, nb // 4096))
        # The decoder is a per-block Python loop: decode the kernel's
        # sample, and the plain version's only where its words differ.
        dk = decode_astc(to_bytes(k_np[samp]), bw, bh).astype(np.float64)
        dp = dk.copy()
        diff = np.where(~np.all(k_np[samp] == p_np[samp], axis=1))[0]
        if diff.size:
            dp[diff] = decode_astc(to_bytes(p_np[samp][diff]), bw, bh)
        target = np.round(hw[samp].astype(np.float64) * 255)
        pk, pp = psnr(dk, target, 255.0), psnr(dp, target, 255.0)
        err = float(np.abs(dk - dp).max())
        max_err[name] = err
        log("kernel_vs_plain", f"{name}: {bw}x{bh} q{q} on {kind} (gray {gray}, alpha {alpha}), "
            f"{nb} blocks identical {same * 100:.4f} % (bar {MIN_SAME * 100:.0f} %); sample "
            f"{samp.size} PSNR kernel {pk:.4f} dB plain {pp:.4f} dB (|d| bar {MAX_DPSNR}); "
            f"max |decoded kernel - plain| {err}")
        check(same >= MIN_SAME, f"{name}: kernel and plain version disagree on too many blocks")
        check(abs(pk - pp) <= MAX_DPSNR, f"{name}: kernel and plain PSNR differ")
        check(np.isfinite(pk), f"{name}: PSNR not finite")

    # 4. the paths, each with every launch counter at 0 just before
    plain_calls = {"n": 0}
    plain_fns = [(bc, "encode_bc1_plain"), (bc, "encode_bc2_plain"), (bc, "encode_bc3_plain"),
                 (bc, "encode_bc4_plain"), (bc, "encode_bc5_plain"),
                 (bc7, "encode_bc7_plain"), (bc6h, "encode_bc6h_plain"),
                 (etc, "encode_etc_rgb_plain"), (etc, "encode_etc2_rgba_plain"),
                 (etc, "encode_eac_alpha_plain"), (etc, "encode_eac_r11_plain"),
                 (etc, "encode_eac_rg11_plain"), (astc, "encode_astc_plain"),
                 (astc, "run_stage")]
    originals = {nm: getattr(mod, nm) for mod, nm in plain_fns}

    def counting(fn):
        def wrapped(*a, **k):
            plain_calls["n"] += 1
            return fn(*a, **k)
        return wrapped

    TF, TT = cp.TextureFormat, cp.TextureType
    images = {k: cp.Image.from_array(v, cp.ImageFormat.RGBAF) for k, v in
              (("rgba", surf), ("alpha", asurf), ("hard", hsurf), ("signed", ssurf),
               ("hdr", hdr), ("shdr", shdr))}
    small = cp.Image.from_array(surf[:SMALL, :SMALL].copy(), cp.ImageFormat.RGBAF)
    QN, QH, QX = cp.Quality.Normal, cp.Quality.High, cp.Quality.Highest
    # name -> (format, type, quality, mips, layers (0: not an array), file type, image,
    # kernel, timed?)
    paths = {
        "bc7_2048_mips_dds": (TF.BC7, TT.UNorm, QN, True, 0, "dds", images["rgba"], "bc7", True),
        "bc1_2048_dds": (TF.BC1_RGB, TT.UNorm, QN, False, 0, "dds", images["rgba"], "bc1", True),
        "bc1_512_dds": (TF.BC1_RGB, TT.UNorm, QN, False, 0, "dds", small, "bc1", True),
        "bc3_2048_mips_ktx": (TF.BC3, TT.UNorm, QN, True, 0, "ktx", images["alpha"], "bc3", True),
        "bc5s_2048_mips_ktx": (TF.BC5, TT.SNorm, QN, True, 0, "ktx", images["signed"], "bc5", True),
        "bc1a_2048_mips_dds": (TF.BC1_RGBA, TT.UNorm, QN, True, 0, "dds", images["hard"], "bc1",
                               False),
        "bc2_2048_mips_dds": (TF.BC2, TT.UNorm, QN, True, 0, "dds", images["alpha"], "bc2", False),
        "bc4_2048_mips_ktx": (TF.BC4, TT.UNorm, QN, True, 0, "ktx", images["alpha"], "bc4", False),
        "bc4s_2048_mips_ktx": (TF.BC4, TT.SNorm, QN, True, 0, "ktx", images["signed"], "bc4",
                               False),
        # This slice's main paths (BASELINE config 4), then its others.
        "bc7_q4_2048_mips_dds": (TF.BC7, TT.UNorm, QX, True, 0, "dds", images["rgba"], "bc7_hq",
                                 True),
        "bc6h_q4_2048_mips_dds": (TF.BC6H, TT.UFloat, QX, True, 0, "dds", images["hdr"], "bc6h",
                                  True),
        "bc7_q3_2048_mips_dds": (TF.BC7, TT.UNorm, QH, True, 0, "dds", images["rgba"], "bc7_hq",
                                 False),
        "bc6hs_q2_2048_mips_ktx": (TF.BC6H, TT.Float, QN, True, 0, "ktx", images["shdr"], "bc6h",
                                   False),
        # This slice's main paths: BASELINE config 3, a 512^2 2D array of 4
        # layers (bench.py:212-215), and ETC2 RGB/RGBA8 at 2048^2; then its
        # others.  No path launches eac_alpha: no converter calls it.
        "etc2_array_ktx": (TF.ETC2_R8G8B8, TT.UNorm, QN, False, 4, "ktx", small, "etc_rgb", True),
        "etc2_2048_mips_ktx": (TF.ETC2_R8G8B8, TT.UNorm, QN, True, 0, "ktx", images["rgba"],
                               "etc_rgb", True),
        "etc2_q4_2048_ktx": (TF.ETC2_R8G8B8, TT.UNorm, QX, False, 0, "ktx", images["rgba"],
                             "etc_rgb", True),
        "etc2_rgba_2048_mips_ktx": (TF.ETC2_R8G8B8A8, TT.UNorm, QN, True, 0, "ktx",
                                    images["alpha"], "etc2_rgba", True),
        "etc1_2048_ktx": (TF.ETC1, TT.UNorm, QN, False, 0, "ktx", images["rgba"], "etc_rgb", False),
        "eac_r11_2048_mips_ktx": (TF.EAC_R11, TT.UNorm, QN, True, 0, "ktx", images["rgba"],
                                  "eac_r11", True),
        "eac_rg11s_2048_mips_ktx": (TF.EAC_R11G11, TT.SNorm, QN, True, 0, "ktx", images["signed"],
                                    "eac_rg11", True),
    }
    etc_formats = (TF.ETC1, TF.ETC2_R8G8B8, TF.ETC2_R8G8B8A8, TF.EAC_R11, TF.EAC_R11G11)
    eac_formats = (TF.EAC_R11, TF.EAC_R11G11)

    def make_texture(img, mips, layers):
        w = img.width
        tex = cp.Texture(cp.Dimension.Dim2D, w, w, depth=layers, mip_levels=99 if mips else 1)
        check(tex.device == dev or tex.device.type == "cuda", "Texture did not default to cuda")
        for d in range(max(layers, 1)):
            check(tex.set_image(img, depth=d), "set_image failed")
        if mips:
            check(tex.generate_mipmaps(), "generate_mipmaps failed")
        return tex

    # The plain reference of a path's level-0 sample: the same wire input.
    def plain_reference(fmt, typ, quality, blocks):
        signed = typ in (TT.SNorm, TT.Float)
        f16 = signed or fmt is TF.BC6H or fmt in eac_formats
        x = dequant(wire(blocks, "f16" if f16 else "u8").to(dev))
        q = int(quality)
        if fmt in (TF.ETC1, TF.ETC2_R8G8B8):
            return originals["encode_etc_rgb_plain"](x, q, fmt is TF.ETC2_R8G8B8)
        if fmt is TF.ETC2_R8G8B8A8:
            return originals["encode_etc2_rgba_plain"](x, q)
        if fmt is TF.EAC_R11:
            return originals["encode_eac_r11_plain"](x[..., 0].contiguous(), q, signed)
        if fmt is TF.EAC_R11G11:
            return originals["encode_eac_rg11_plain"](x, q, signed)
        if fmt is TF.BC6H:
            return originals["encode_bc6h_plain"](x[..., :3].contiguous(), q, signed, "value")
        if fmt is TF.BC7:
            return originals["encode_bc7_plain"](x, q, consts)
        if fmt in (TF.BC1_RGB, TF.BC1_RGBA):
            punch = fmt is TF.BC1_RGBA
            return originals["encode_bc1_plain"](x, q, punch, not punch)
        if fmt is TF.BC2:
            return originals["encode_bc2_plain"](x, q)
        if fmt is TF.BC3:
            return originals["encode_bc3_plain"](x, q)
        if fmt is TF.BC4:
            return originals["encode_bc4_plain"](x[..., 0].contiguous(), q, signed)
        return originals["encode_bc5_plain"](x, q, signed)

    path_launches = {k: 0 for k in launch_counts()}
    path_stats = {}

    def counted(label, fn):
        """fn() with every launch counter at 0 just before and every plain
        version counting its calls; fails if a plain version ran, adds the
        launches to the kernels line's -> (fn's result, {kernel: launches}
        of the kernels that launched)."""
        for mod, nm in plain_fns:
            setattr(mod, nm, counting(originals[nm]))
        for wrapper in (bc7_cuda, bc7_hq_cuda, bc_cuda, bc6h_cuda, etc_cuda, astc_cuda):
            wrapper.reset_launches()
        plain_calls["n"] = 0
        try:
            result = fn()
            torch.cuda.synchronize()
        finally:
            for mod, nm in plain_fns:
                setattr(mod, nm, originals[nm])
        counts = launch_counts()
        check(plain_calls["n"] == 0, f"{label}: a plain version ran on the card's path")
        for k, v in counts.items():
            path_launches[k] += v
        return result, {k: v for k, v in counts.items() if v}

    def convert_counted(pname, tex, fmt, typ, quality, fused=None):
        """Texture.convert (with ``fused``, the keywords of
        Texture.convert_with_mips: that instead) under ``counted`` ->
        (launches of every kernel, convert stats)."""
        def convert():
            if fused is None:
                return tex.convert(fmt, typ, quality)
            return tex.convert_with_mips(fmt, typ, quality, **fused)
        ok, launched = counted(pname, convert)
        check(ok, f"{pname}: Texture.convert returned False")
        stats = tex.last_convert_stats
        check(stats["launches"] == launched, f"{pname}: convert stats disagree with the counters")
        return {k: launched.get(k, 0) for k in path_launches}, stats

    def fused_texture(arr, cube, mips=False, normal_map=None):
        """A texture of level 0 ``arr`` (an sRGB cube of six equal faces when
        ``cube``); ``mips``: the host path (``normal_map``: the normal map
        made on the host, then generate_mipmaps)."""
        img = cp.Image.from_array(arr, cp.ImageFormat.RGBAF)
        if normal_map is not None and mips:
            img = img.create_normal_map(normal_map, height=2.0)
        n = 99 if mips else 1
        if cube:
            tex = cp.Texture(cp.Dimension.Cube, img.width, img.height, mip_levels=n,
                             color_space=cp.ColorSpace.sRGB)
            for face in cp.CubeFace:
                check(tex.set_image(img, face=face), "set_image failed")
        else:
            tex = cp.Texture(cp.Dimension.Dim2D, img.width, img.height, mip_levels=n)
            check(tex.set_image(img), "set_image failed")
        if mips:
            check(tex.generate_mipmaps(), "generate_mipmaps failed")
        return tex

    def level_bytes(tex, m, bs):
        """[blocks, bs] bytes of mip m, its surfaces in (depth, face) order."""
        faces = list(cp.CubeFace) if tex.faces == 6 else [None]
        return np.concatenate([np.frombuffer(tex.data(face=f, mip_level=m), np.uint8)
                               for f in faces]).reshape(-1, bs)

    def fused_path(pname, fmt, typ, arr, cube, normal_map, ext, need, tmp):
        """One fused path: convert_with_mips with the launch counters, the
        file read back, the pyramid against the CPU's and under TF32, a
        sample of its blocks through the plain version, and every level
        against the host path (generate_mipmaps + convert on the card)."""
        quality = QN
        fused_kw = {} if normal_map is None else {"normal_map": normal_map,
                                                  "normal_height": 2.0}
        tex = fused_texture(arr, cube)
        AstcConverter.refine_params = spy_refine
        try:
            counts, stats = convert_counted(pname, tex, fmt, typ, quality, fused_kw)
        finally:
            AstcConverter.refine_params = refine
        launched = {k: v for k, v in counts.items() if v}
        check(all(k in launched for k in need) and all(v == 1 for v in launched.values())
              and set(launched) <= set(need) | {"astc_c", "astc_d"},
              f"{pname}: launches {launched}, want one of each of {need}")
        bs = 8 if fmt is TF.BC1_RGB else 16
        faces = list(cp.CubeFace) if cube else [None]
        path = os.path.join(tmp, f"{pname}.{ext}")
        check(tex.save(path) is cp.SaveResult.Success, f"{pname}: save failed")
        size = os.path.getsize(path)
        loaded = cp.load_texture(path)
        check(loaded.format is fmt and loaded.type is typ and loaded.mip_levels == tex.mip_levels
              and loaded.faces == tex.faces, f"{pname}: loaded texture differs")
        for m in range(tex.mip_levels):
            for f in faces:
                check(loaded.data(face=f, mip_level=m) == tex.data(face=f, mip_level=m),
                      f"{pname}: payload of mip {m} face {f} differs")
        payload = sum(tex.data_size(face=f, mip_level=m)
                      for m in range(tex.mip_levels) for f in faces)
        if ext == "dds":
            check(size == 148 + payload, f"{pname}: DDS size {size} != 148 + {payload}")

        # The pyramid: on the card as the convert built it, on the CPU, and
        # on the card with TF32 allowed for matmuls.
        x0 = np.stack([tex.get_image(face=f).rgbaf() for f in faces])
        levels, srgb = tex.mip_levels, cube
        nopts = None if normal_map is None else (int(normal_map), 2.0)
        xd = torch.from_numpy(x0).to(dev)
        pyr = pyramid_blocks(xd, levels, "catmullrom", srgb, 4, 4, nopts)
        pyr_cpu = pyramid_blocks(torch.from_numpy(x0), levels, "catmullrom", srgb, 4, 4, nopts)
        pyr_err = float((pyr.cpu() - pyr_cpu).abs().max())
        check(pyr.shape == pyr_cpu.shape and pyr_err <= 1e-5,
              f"{pname}: card and CPU pyramids differ by {pyr_err}")
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            pyr_tf32 = pyramid_blocks(xd, levels, "catmullrom", srgb, 4, 4, nopts)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        check(torch.equal(pyr_tf32.view(torch.int32), pyr.view(torch.int32)),
              f"{pname}: the pyramid changes when TF32 is allowed")
        words = np.concatenate([level_bytes(tex, m, bs) for m in range(levels)])
        check(words.shape[0] == pyr.shape[0], f"{pname}: {words.shape[0]} blocks written, "
              f"{pyr.shape[0]} in the pyramid")

        # A strided sample of the fused blocks through the plain version.
        idx = np.arange(0, words.shape[0], max(1, words.shape[0] // 4096))
        xs = pyr[torch.from_numpy(idx).to(dev)].contiguous()
        q = int(quality)
        if fmt is TF.BC7:
            ref = originals["encode_bc7_plain"](xs, q, consts)
        elif fmt is TF.BC3:
            ref = originals["encode_bc3_plain"](xs, q)
        elif fmt is TF.BC6H:
            ref = originals["encode_bc6h_plain"](xs[..., :3].contiguous(), q, True, "value")
        else:
            gray, alpha = gates["last"]
            ref = originals["encode_astc_plain"](xs, 4, 4, q, gray, alpha)
        ref = to_bytes(ref.cpu().numpy()).reshape(-1, bs)
        same = float(np.all(words[idx] == ref, axis=1).mean())
        xs_np = xs.cpu().numpy().astype(np.float64)
        if fmt is TF.BC6H:
            def dec(raw):
                return decode_bc6h_f32(raw.reshape(-1), signed=True)
            target, peak = xs_np[..., :3], float(np.abs(xs_np[..., :3]).max())
        else:
            def dec(raw):
                if fmt is TF.ASTC_4x4:
                    return decode_astc(raw.reshape(-1), 4, 4)
                return (decode_bc7 if fmt is TF.BC7 else decode_bc3)(raw.reshape(-1))
            target, peak = np.clip(np.round(xs_np * 255), 0, 255), 255.0
        dk = np.asarray(dec(words[idx]), np.float64)
        dp = dk.copy()
        diff = np.where(~np.all(words[idx] == ref, axis=1))[0]
        if diff.size:
            dp[diff] = dec(ref[diff])
        pk, pp = psnr(dk, target, peak), psnr(dp, target, peak)
        check(same >= MIN_SAME, f"{pname}: sample disagrees with the plain version")
        check(abs(pk - pp) <= MAX_DPSNR and np.isfinite(pk), f"{pname}: kernel and plain PSNR differ")

        # Every level against the host path, on a strided sample of at most
        # 4,096 blocks: mean |d| < 2 in u8 units (LDR), < 0.05 (BC6H), whose
        # levels 1 and 2 keep their negatives.
        host = fused_texture(arr, cube, mips=True, normal_map=normal_map)
        check(host.convert(fmt, typ, quality), f"{pname}: host-path convert failed")
        check(host.mip_levels == levels, f"{pname}: {host.mip_levels} host levels, {levels} fused")
        worst = 0.0
        for m in range(levels):
            a, b = level_bytes(tex, m, bs), level_bytes(host, m, bs)
            check(a.shape == b.shape, f"{pname}: level {m} sizes differ")
            li = np.arange(0, a.shape[0], max(1, a.shape[0] // 4096))
            da, db = dec(a[li]), dec(b[li])
            d = float(np.abs(np.asarray(da, np.float64) - db).mean())
            worst = max(worst, d)
            check(d < (0.05 if fmt is TF.BC6H else 2.0), f"{pname}: level {m} mean |d| {d}")
            if fmt is TF.BC6H and m in (1, 2):
                check((np.asarray(da) < -0.05).any(), f"{pname}: level {m} lost its negatives")
        del host
        log("paths", f"{pname}: {levels} mips x {len(faces)} faces, {words.shape[0]} blocks, "
            f"{ext.upper()} {size} bytes read back; launches {stats['launches']}, plain calls 0; "
            f"pyramid card vs CPU max |d| {pyr_err}, TF32 allowed: identical; sample "
            f"{idx.size} identical to plain {same * 100:.2f} %, PSNR kernel {pk:.4f} dB plain "
            f"{pp:.4f} dB; worst level mean |d| vs host path {worst:.4f}; phases "
            f"{json.dumps(stats['phases'])}")
        return {"launches": launched, "bytes": size, "psnr": pk, "same": same,
                "pyramid_err": pyr_err, "vs_host": worst}

    def a1_path(tmp):
        """ETC2 punch-through 2048^2 + mips -> KTX on the hard-alpha
        surface: torch ops on the card (no hand kernel; no kernel may
        launch, no plain version may run); level 0's strided sample equal
        to the same wire blocks encoded on the CPU; punched texels decode
        to alpha 0, the others to 255."""
        pname, fmt = "etc2a1_2048_mips_ktx", TF.ETC2_R8G8B8A1
        tex = make_texture(images["hard"], True, 0)
        counts, stats = convert_counted(pname, tex, fmt, TT.UNorm, QN)
        check(not any(counts.values()), f"{pname}: a kernel launched: {counts}")
        path = os.path.join(tmp, f"{pname}.ktx")
        check(tex.save(path) is cp.SaveResult.Success, f"{pname}: save failed")
        size = os.path.getsize(path)
        loaded = cp.load_texture(path)
        check(loaded.format is fmt and loaded.mip_levels == tex.mip_levels,
              f"{pname}: loaded texture differs")
        for m in range(tex.mip_levels):
            check(loaded.data(mip_level=m) == tex.data(mip_level=m),
                  f"{pname}: payload of mip {m} differs")
        b0 = extract_blocks(hsurf, 4, 4)[0]
        idx = np.arange(0, b0.shape[0], max(1, b0.shape[0] // 4096))
        cpu = etc.encode_etc2_a1(dequant(wire(b0[idx], "u8")), int(QN))
        ref = to_bytes(cpu.numpy()).reshape(-1, 8)
        raw = np.frombuffer(tex.data(), np.uint8).reshape(-1, 8)[idx]
        same = float(np.all(raw == ref, axis=1).mean())
        dec = decode_etc2_a1(raw.reshape(-1))
        punched = b0[idx][..., 3] < 0.5
        check(np.array_equal(dec[..., 3] == 0, punched) and (dec[..., 3][~punched] == 255).all(),
              f"{pname}: decoded alpha is not the source's 0/1 mask")
        opaque = ~punched[..., None]
        p0 = psnr(np.where(opaque, dec[..., :3] / 255.0, 0.0),
                  np.where(opaque, b0[idx][..., :3], 0.0), 1.0)
        log("paths", f"{pname}: {tex.mip_levels} mips, KTX {size} bytes read back; launches "
            f"{stats['launches']} (torch ops, no kernel), plain calls 0; level-0 sample "
            f"{idx.size} identical to the CPU {same * 100:.2f} %, PSNR {p0:.4f} dB, punched "
            f"texels alpha 0 and the rest 255; phases {json.dumps(stats['phases'])}")
        check(same >= MIN_SAME, f"{pname}: the card's blocks disagree with the CPU's")
        check(np.isfinite(p0) and p0 > 30.0, f"{pname}: PSNR too low")
        return {"launches": {}, "bytes": size, "psnr": p0, "same": same}

    # This slice: the formats the JAX package encodes with XLA programs and
    # no TPU kernel, ported as torch ops on the card (kernels/astc_hdr.py,
    # kernels/pvrtc.py).  name -> (format, type, quality, level 0, mips,
    # file, the JAX package's quality bar for the format).
    hdra = hdr[:1024, :1024].copy()
    hdra[..., 3] = asurf[:1024, :1024, 3]
    torch_ops_paths = {
        "astc4_hdr_2048_mips_ktx": (TF.ASTC_4x4, TT.UFloat, QN, hdr, True, "ktx",
                                    "median |log2 err| < 0.3 (tests/test_astc.py:343-357)"),
        "astc8_hdr_alpha_1024_ktx": (TF.ASTC_8x8, TT.UFloat, QN, hdra, False, "ktx",
                                     "median |log2 err| < 0.3 (tests/test_astc.py:343-357)"),
        "pvrtc1_4bpp_2048_mips_pvr": (TF.PVRTC1_RGBA_4BPP, TT.UNorm, QN, asurf, True, "pvr",
                                      "PSNR > 30 dB, 4bpp (tests/test_pvrtc.py:60-68)"),
        "pvrtc2_2bpp_1024_ktx": (TF.PVRTC2_RGBA_2BPP, TT.UNorm, QX, hsurf[:1024, :1024].copy(),
                                 False, "ktx", "PSNR > 24 dB, 2bpp (tests/test_pvrtc.py:124-137)"),
    }

    def with_tf32(fn):
        """fn() with TF32 allowed for matmuls.  The port raises nowhere for
        TF32, so any exception is a failure of the path."""
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            return fn()
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False

    def torch_ops_path(pname, fmt, typ, quality, arr, mips, ext, bar, tmp):
        """Texture(device=cuda).convert, save, load_texture, decode_image and
        a payload check; no kernel may launch and no plain version may run.
        Level 0 against the same encode on the CPU (ASTC: a strided sample of
        4,096 blocks; PVRTC, a whole-surface encode: every word): >= 99 %
        identical, |dPSNR| <= 0.05 dB (HDR PSNR peak-relative); level 0
        encoded once more on the card with TF32 allowed must write the same
        words."""
        img = cp.Image.from_array(arr, cp.ImageFormat.RGBAF)
        tex = make_texture(img, mips, 0)
        counts, stats = convert_counted(pname, tex, fmt, typ, quality)
        check(not any(counts.values()) and stats["launches"] == {},
              f"{pname}: a kernel launched: {counts}")
        path = os.path.join(tmp, f"{pname}.{ext}")
        check(tex.save(path) is cp.SaveResult.Success, f"{pname}: save failed")
        size = os.path.getsize(path)
        loaded = cp.load_texture(path)
        check(loaded.format is fmt and loaded.mip_levels == tex.mip_levels,
              f"{pname}: loaded texture differs ({loaded.format})")
        for m in range(tex.mip_levels):
            check(loaded.data(mip_level=m) == tex.data(mip_level=m),
                  f"{pname}: payload of mip {m} differs")
        q, raw0 = int(quality), np.frombuffer(tex.data(), np.uint8)
        if fmt.name.startswith("ASTC_"):
            bw, bh = (int(v) for v in fmt.name[5:].split("x"))
            b0 = extract_blocks(arr, bw, bh)[0]
            idx = np.arange(0, b0.shape[0], max(1, b0.shape[0] // 4096))
            raw = raw0.reshape(-1, 16)
            cpu = astc_hdr.encode_astc_hdr(dequant(wire(b0[idx], "f16")), bw, bh, q)
            ref = to_bytes(cpu.numpy()).reshape(-1, 16)
            same = float(np.all(raw[idx] == ref, axis=1).mean())
            target = b0[idx][..., :3].astype(np.float64)
            peak = float(np.abs(target).max())

            def dec(r):
                halfs = decode_astc_hdr(np.ascontiguousarray(r).reshape(-1), bw, bh)
                return np.asarray(halfs).astype(np.uint16).view(np.float16).astype(np.float64)

            dk = dec(raw[idx])
            dp = dk.copy()
            diff = np.where(~np.all(raw[idx] == ref, axis=1))[0]
            if diff.size:
                dp[diff] = dec(ref[diff])
            pk, pp = psnr(dk[..., :3], target, peak), psnr(dp[..., :3], target, peak)
            normal = target >= 2.0**-14
            quality_val = float(np.median(np.abs(
                np.log2(np.maximum(dk[..., :3][normal], 1e-6)) - np.log2(target[normal]))))
            check(quality_val < 0.3, f"{pname}: median |log2 err| {quality_val} over the bar")
            full = dequant(wire(b0, "f16").to(dev))
            w32 = with_tf32(lambda: astc_hdr.encode_astc_hdr(full, bw, bh, q))
            tf32 = "identical" if np.array_equal(to_bytes(w32.cpu().numpy()), raw0) else "DIFFERS"
            small_m = min(3, tex.mip_levels - 1)
            dimg = tex.decode_image(mip_level=small_m).rgbaf()
            check(dimg.shape[:2] == (tex.height(small_m), tex.width(small_m))
                  and np.isfinite(dimg).all(), f"{pname}: decode_image failed")
            decoded = (f"decode_image of level {small_m} ({dimg.shape[1]}x{dimg.shape[0]}) finite; "
                       f"level-0 sample {idx.size} blocks")
            quality_txt = f"median |log2 err| {quality_val:.4f} (JAX package's bar: {bar})"
        else:
            bpp2 = "2BPP" in fmt.name
            v2 = fmt.name.startswith("PVRTC2")
            bw, bh = (8, 4) if bpp2 else (4, 4)
            h, w = arr.shape[:2]
            perm = morton_order(w // bw, h // bh)
            stored = raw0.reshape(-1, 8)
            raster = np.empty_like(stored)
            raster[perm] = stored
            enc = pvrtc.encode_pvrtc2 if v2 else pvrtc.encode_pvrtc1
            cpu = to_bytes(enc(torch.from_numpy(arr), bpp2=bpp2, quality=q).numpy()).reshape(-1, 8)
            same = float(np.all(raster == cpu, axis=1).mean())
            decode = decode_pvrtc2 if v2 else decode_pvrtc1
            dk = decode(raster.reshape(-1), w, h, bpp2=bpp2)
            dp = decode(cpu.reshape(-1), w, h, bpp2=bpp2)
            pk, pp = psnr(dk, arr, 1.0), psnr(dp, arr, 1.0)
            surf_dev = torch.from_numpy(arr).to(dev)
            w32 = with_tf32(lambda: enc(surf_dev, bpp2=bpp2, quality=q))
            tf32 = ("identical" if np.array_equal(to_bytes(w32.cpu().numpy()).reshape(-1, 8), raster)
                    else "DIFFERS")
            dimg = loaded.decode_image().rgbaf()
            check(np.array_equal(dimg, dk), f"{pname}: decode_image of the file differs")
            decoded = f"decode_image of the file's level 0 ({w}x{h}) equal to its words' decode"
            quality_txt = f"PSNR {pk:.4f} dB (JAX package's bar: {bar})"
            check(np.isfinite(pk) and pk > 20.0, f"{pname}: PSNR too low")
        log("paths", f"{pname}: {tex.mip_levels} mips, {ext.upper()} {size} bytes read back; "
            f"launches {stats['launches']} (torch ops, no kernel), plain calls 0; level 0 card "
            f"vs CPU identical {same * 100:.2f} %, PSNR card {pk:.4f} dB CPU {pp:.4f} dB; TF32 "
            f"allowed: {tf32}; {decoded}; {quality_txt}; phases {json.dumps(stats['phases'])}")
        check(same >= MIN_SAME, f"{pname}: the card's words disagree with the CPU's")
        check(abs(pk - pp) <= MAX_DPSNR and np.isfinite(pk), f"{pname}: card and CPU PSNR differ")
        check(tf32 != "DIFFERS", f"{pname}: TF32 changed the words")
        return {"launches": {}, "bytes": size, "psnr": pk, "same": same, "tf32": tf32}

    with tempfile.TemporaryDirectory() as tmp:
        for pname, (fmt, typ, quality, mips, nlayers, ext, img, kname, _) in paths.items():
            tex = make_texture(img, mips, nlayers)
            layers = max(tex.depth(), 1)
            counts, stats = convert_counted(pname, tex, fmt, typ, quality)
            check(counts[kname] > 0, f"{pname}: the path launched no {kname} kernel")
            path = os.path.join(tmp, f"{pname}.{ext}")
            check(tex.save(path) is cp.SaveResult.Success, f"{pname}: save failed")
            size = os.path.getsize(path)
            loaded = cp.load_texture(path)
            # DDS has one BC1 code: BC1_RGBA reads back as BC1 of either kind.
            same_format = loaded.format is fmt or (
                fmt is TF.BC1_RGBA and loaded.format in (TF.BC1_RGB, TF.BC1_RGBA))
            check(same_format and loaded.type is typ and loaded.mip_levels == tex.mip_levels
                  and loaded.depth() == tex.depth(),
                  f"{pname}: loaded texture differs ({loaded.format}, {loaded.type})")
            for m in range(tex.mip_levels):
                for d in range(layers):
                    check(loaded.data(mip_level=m, depth=d) == tex.data(mip_level=m, depth=d),
                          f"{pname}: payload of mip {m} layer {d} differs")
            payload = sum(tex.data_size(mip_level=m, depth=d)
                          for m in range(tex.mip_levels) for d in range(layers))
            if ext == "dds":
                check(size == 148 + payload, f"{pname}: DDS size {size} != 148 + {payload}")
            # Level-0 sample: equal to the plain version on the same wire input.
            src0 = img.rgbaf()
            b0 = extract_blocks(src0, 4, 4)[0]
            bs = 8 if fmt in (TF.BC1_RGB, TF.BC1_RGBA, TF.BC4, TF.ETC1, TF.ETC2_R8G8B8,
                              TF.EAC_R11) else 16
            lvl0 = np.frombuffer(tex.data(), np.uint8).reshape(-1, bs)
            idx = np.arange(0, b0.shape[0], max(1, b0.shape[0] // 4096))
            ref = plain_reference(fmt, typ, quality, b0[idx]).cpu().numpy()
            ref = to_bytes(ref).reshape(-1, bs)
            same = float(np.all(lvl0[idx] == ref, axis=1).mean())
            if fmt is TF.BC6H:
                # The whole surface decodes one block at a time in Python:
                # decode the level-0 sample of the file read back instead.
                raw = np.frombuffer(loaded.data(), np.uint8).reshape(-1, bs)[idx]
                dec = decode_bc6h_f32(raw.reshape(-1), signed=typ is TT.Float)
                src_s = b0[idx][..., :3].astype(np.float16).astype(np.float32)
                finite = bool(np.isfinite(dec).all()) and dec.shape == src_s.shape
                p0 = psnr(dec, src_s, float(np.abs(src_s).max()))
            elif fmt in etc_formats:
                # ETC/EAC decode one block at a time in Python too: the
                # level-0 sample of the file read back, against its source.
                raw = np.frombuffer(loaded.data(), np.uint8).reshape(-1, bs)[idx].reshape(-1)
                src_s = b0[idx]
                if fmt in eac_formats:
                    signed = typ is TT.SNorm
                    ch = 1 if fmt is TF.EAC_R11 else 2
                    dec = (decode_eac_r11(raw, signed)[..., None] if ch == 1
                           else decode_eac_rg11(raw, signed))
                    src_s = np.clip(src_s[..., :ch], -1.0 if signed else 0.0, 1.0)
                    peak = 2.0 if signed else 1.0
                elif fmt is TF.ETC2_R8G8B8A8:
                    dec, peak = decode_etc2_rgba(raw) / 255.0, 1.0
                else:
                    dec = decode_etc_rgb(raw, fmt is TF.ETC2_R8G8B8) / 255.0
                    src_s, peak = src_s[..., :3], 1.0
                finite = bool(np.isfinite(dec).all()) and dec.shape == src_s.shape
                p0 = psnr(dec, src_s, peak)
            else:
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
            log("paths", f"{pname}: {tex.mip_levels} mips x {layers} layers, "
                f"{payload // bs} blocks, "
                f"{ext.upper()} {size} bytes read back; launches {stats['launches']}, "
                f"plain calls 0; level-0 PSNR {p0:.4f} dB; sample identical to plain "
                f"{same * 100:.2f} %; phases {json.dumps(stats['phases'])}")
            check(same >= MIN_SAME, f"{pname}: blocks disagree with the plain version")
            check(finite, f"{pname}: decoded texels not finite or of the wrong shape")
            # LDR: above 30 dB.  HDR: finite (peak-relative PSNR swings with
            # the range a surface spans).
            check(np.isfinite(p0) and (fmt is TF.BC6H or p0 > 30.0), f"{pname}: PSNR too low")
            del tex, loaded

        # This slice's paths: ASTC LDR -> KTX.  The main path at full size
        # (4x4 Normal 2048^2 + mips), BASELINE config 5 as bench.py:220-241
        # builds it (a 256^2 sRGB cube of a normal map, + mips), 8x8 and
        # 12x12 Normal 2048^2, and 4x4 Highest 2048^2 on the near-gray
        # alpha surface, which runs all four entries.
        nm256 = cp.Image.from_array(test_surface(256), cp.ImageFormat.RGBAF).create_normal_map(
            height=2.0)
        gray_img = cp.Image.from_array(gasurf, cp.ImageFormat.RGBAF)
        # name -> (format, quality, image, mips, sRGB cube, timed, entries it must launch)
        astc_ab = ("astc_a", "astc_b")
        astc_paths = {
            "astc4_2048_mips_ktx": (TF.ASTC_4x4, QN, images["rgba"], True, False, True, astc_ab),
            "astc4_cube_srgb_nm_ktx": (TF.ASTC_4x4, QN, nm256, True, True, True, astc_ab),
            "astc8x8_2048_ktx": (TF.ASTC_8x8, QN, images["rgba"], False, False, False, astc_ab),
            "astc12x12_2048_ktx": (TF.ASTC_12x12, QN, images["rgba"], False, False, True,
                                   astc_ab),
            "astc4_q4_grayalpha_2048_ktx": (TF.ASTC_4x4, QX, gray_img, False, False, True,
                                            ("astc_a", "astc_b", "astc_c", "astc_d")),
        }
        refine = AstcConverter.refine_params
        gates = {}

        def spy_refine(self, host_blocks, params):
            out = refine(self, host_blocks, params)
            gates["last"] = (out.content_gray, out.content_alpha)
            return out

        def make_astc_texture(img, mips, cube):
            if not cube:
                return make_texture(img, mips, 0)
            tex = cp.Texture(cp.Dimension.Cube, img.width, img.height, mip_levels=99 if mips else 1,
                             color_space=cp.ColorSpace.sRGB)
            for face in cp.CubeFace:
                check(tex.set_image(img, face=face), "set_image failed")
            if mips:
                check(tex.generate_mipmaps(), "generate_mipmaps failed")
            return tex

        for pname, (fmt, quality, img, mips, cube, _, need) in astc_paths.items():
            tex = make_astc_texture(img, mips, cube)
            bw, bh = (int(v) for v in fmt.name[5:].split("x"))
            faces = list(cp.CubeFace) if cube else [None]
            src0 = tex.get_image(face=faces[0]).rgbaf()
            AstcConverter.refine_params = spy_refine
            try:
                counts, stats = convert_counted(pname, tex, fmt, TT.UNorm, quality)
            finally:
                AstcConverter.refine_params = refine
            for k in need:
                check(counts[k] > 0, f"{pname}: the path launched no {k} kernel")
            path = os.path.join(tmp, f"{pname}.ktx")
            check(tex.save(path) is cp.SaveResult.Success, f"{pname}: save failed")
            size = os.path.getsize(path)
            loaded = cp.load_texture(path)
            check(loaded.format is fmt and loaded.type is TT.UNorm
                  and loaded.mip_levels == tex.mip_levels and loaded.faces == tex.faces,
                  f"{pname}: loaded texture differs ({loaded.format}, {loaded.type})")
            for m in range(tex.mip_levels):
                for f in faces:
                    check(loaded.data(face=f, mip_level=m) == tex.data(face=f, mip_level=m),
                          f"{pname}: payload of mip {m} face {f} differs")
            nblocks = sum(tex.data_size(face=f, mip_level=m) // 16
                          for m in range(tex.mip_levels) for f in faces)
            # Level-0 sample of the first face: equal to the plain version on
            # the same wire input under the gates the converter's scan set.
            b0 = extract_blocks(src0, bw, bh)[0]
            idx = np.arange(0, b0.shape[0], max(1, b0.shape[0] // 4096))
            x0 = dequant(wire(b0[idx], "u8").to(dev))
            gray, alpha = gates["last"]
            ref = originals["encode_astc_plain"](x0, bw, bh, int(quality), gray, alpha)
            ref = to_bytes(ref.cpu().numpy()).reshape(-1, 16)
            raw = np.frombuffer(loaded.data(face=faces[0]), np.uint8).reshape(-1, 16)[idx]
            same = float(np.all(raw == ref, axis=1).mean())
            dec = decode_astc(raw.reshape(-1), bw, bh) / 255.0
            finite = bool(np.isfinite(dec).all()) and dec.shape == b0[idx].shape
            p0 = psnr(dec, b0[idx], 1.0)
            path_stats[pname] = {"launches": {k: v for k, v in counts.items() if v},
                                 "bytes": size, "psnr": p0, "same": same}
            log("paths", f"{pname}: {tex.mip_levels} mips x {len(faces)} faces, {nblocks} "
                f"blocks, KTX {size} bytes read back; gates gray {gray} alpha {alpha}; launches "
                f"{stats['launches']}, plain calls 0; level-0 sample PSNR {p0:.4f} dB; sample "
                f"identical to plain {same * 100:.2f} %; phases {json.dumps(stats['phases'])}")
            check(same >= MIN_SAME, f"{pname}: blocks disagree with the plain version")
            check(finite, f"{pname}: decoded texels not finite or of the wrong shape")
            # 0.89-8 bits a texel: above 25 dB on the noisy test surface.
            check(np.isfinite(p0) and p0 > 25.0, f"{pname}: PSNR too low")
            del tex, loaded

        # This slice: the fused mip pipeline (Texture.convert_with_mips),
        # level 0 sent once and the chain, the normal map and the tiling
        # built on the card, then one encode; BC7 q2 (the bench headline's
        # format, this slice's main path), BC3 on the alpha surface (config
        # 2's fused row, bench.py:181-211), config 5 fused as bench.py:257-298
        # builds it, and BC6H Float on 2x-1.
        fused_paths = {
            # name -> (format, type, level 0, sRGB cube, normal map, file, kernels it launches)
            "bc7_2048_fused_dds": (TF.BC7, TT.UNorm, surf, False, None, "dds", ("bc7",)),
            "bc3_2048_fused_ktx": (TF.BC3, TT.UNorm, asurf, False, None, "ktx", ("bc3",)),
            "astc4_cube_srgb_nm_fused_ktx": (TF.ASTC_4x4, TT.UNorm, test_surface(256), True,
                                             cp.NormalOptions.Default, "ktx", astc_ab),
            "bc6hs_2048_fused_ktx": (TF.BC6H, TT.Float, ssurf, False, None, "ktx", ("bc6h",)),
        }
        for pname, spec in fused_paths.items():
            path_stats[pname] = fused_path(pname, *spec, tmp)
        path_stats["etc2a1_2048_mips_ktx"] = a1_path(tmp)
        for pname, spec in torch_ops_paths.items():
            path_stats[pname] = torch_ops_path(pname, *spec, tmp)

    # 5. times on the card
    # (row name, counter, case timed for the row, source, TPU kernel, input
    # bytes per block, other cases timed alongside: the row's other cases of
    # phase 3)
    kernel_rows = [
        ("bc7_encode_q0_2", "bc7", "bc7_q2", "cuttlefish_tpu_torch/csrc/bc7_encode.cu",
         "cuttlefish_tpu/kernels/bc7_pallas.py:1044", 256, ("bc7_q0", "bc7_q1p", "bc7_q2p")),
        ("bc7_hq_encode_q3_4", "bc7_hq", "bc7_q4", "cuttlefish_tpu_torch/csrc/bc7_hq_encode.cu",
         "cuttlefish_tpu/kernels/bc7_pallas.py:1085", 256, ("bc7_q3",)),
        ("bc1_encode", "bc1", "bc1_q2", "cuttlefish_tpu_torch/csrc/bc_encode.cu",
         "cuttlefish_tpu/kernels/bc_pallas.py:452", 192,
         ("bc1_q0", "bc1_q1", "bc1_q3", "bc1_q4", "bc1_q2_punch", "bc1_q2_srgb")),
        ("bc2_encode", "bc2", "bc2_q2", "cuttlefish_tpu_torch/csrc/bc_encode.cu",
         "cuttlefish_tpu/kernels/bc_pallas.py:491", 256, ()),
        ("bc3_encode", "bc3", "bc3_q2", "cuttlefish_tpu_torch/csrc/bc_encode.cu",
         "cuttlefish_tpu/kernels/bc_pallas.py:517", 256, ()),
        ("bc4_encode", "bc4", "bc4_q2", "cuttlefish_tpu_torch/csrc/bc_encode.cu",
         "cuttlefish_tpu/kernels/bc_pallas.py:477", 64, ("bc4s_q2", "bc4_q4", "bc4s_q4")),
        ("bc5_encode", "bc5", "bc5s_q2", "cuttlefish_tpu_torch/csrc/bc_encode.cu",
         "cuttlefish_tpu/kernels/bc_pallas.py:539", 128, ("bc5_q2",)),
        ("bc6h_encode", "bc6h", "bc6h_q4", "cuttlefish_tpu_torch/csrc/bc6h_encode.cu",
         "cuttlefish_tpu/kernels/bc6h_pallas.py:584", 192, ("bc6h_q2", "bc6hs_q4", "bc6h_q2_code")),
        # This slice: the five entries of csrc/etc_encode.cu.
        ("etc_rgb_encode", "etc_rgb", "etc2_q2", "cuttlefish_tpu_torch/csrc/etc_encode.cu",
         "cuttlefish_tpu/kernels/etc_pallas.py:1260", 256, ("etc2_q4", "etc1_q2", "etc2_q2_srgb")),
        ("etc2_rgba_encode", "etc2_rgba", "etc2_rgba_q2", "cuttlefish_tpu_torch/csrc/etc_encode.cu",
         "cuttlefish_tpu/kernels/etc_pallas.py:1276", 256, ("etc2_rgba_q4",)),
        ("eac_alpha_encode", "eac_alpha", "eac_alpha_q2", "cuttlefish_tpu_torch/csrc/etc_encode.cu",
         "cuttlefish_tpu/kernels/etc_pallas.py:1292", 64, ("eac_alpha_q4",)),
        ("eac_r11_encode", "eac_r11", "eac_r11_q2", "cuttlefish_tpu_torch/csrc/etc_encode.cu",
         "cuttlefish_tpu/kernels/etc_pallas.py:1066", 64, ("eac_r11_q4", "eac_r11s_q2", "eac_r11_q0")),
        ("eac_rg11_encode", "eac_rg11", "eac_rg11_q2", "cuttlefish_tpu_torch/csrc/etc_encode.cu",
         "cuttlefish_tpu/kernels/etc_pallas.py:1103", 128, ("eac_rg11s_q2", "eac_rg11_q4")),
    ]
    # Output bytes per block of the 2-word entries; the others write 16.
    out_bytes = {"bc1": 8, "bc4": 8, "etc_rgb": 8, "eac_alpha": 8, "eac_r11": 8}
    rows = []

    # BC: the float operations of the device code (bc_op_counter) on 1,024
    # of the run's blocks, whose words must be the plain version's there.
    # A case with other channel weights than its row's counts that row with
    # its weights.
    bc_samp = torch.arange(0, n, n // 1024, device=dev)
    count_as = {"bc1_q2_srgb": ("bc1_q2", srgb), "bc7_q1p": ("bc7_q1", _constants(True, dev).chw),
                "bc7_q2p": ("bc7_q2", _constants(True, dev).chw)}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        count_bc = bc_op_counter(str(_build.CSRC), tmp)
        count_eac = eac_op_counter(str(_build.CSRC), tmp)
        log("times", f"BC and EAC counting builds (g++) in {time.perf_counter() - t0:.1f} s")

    def time_case(case, key, in_bytes):
        """(kernel ms, plain ms, bound ms, bound_by) of one case."""
        kernel, plain, kind, *_ = cases[case]
        x = dev_in[kind]
        kernel_ms = event_ms(torch, lambda: kernel(x), 7)
        plain_ms = event_ms(torch, lambda: plain(x), 7)
        if case in needed_ops:
            ops, counted = needed_ops[case], "needed"
            if case in weighted_ops:
                counted += (f"; with the weight products {weighted_ops[case]}, bound "
                            f"{n * weighted_ops[case] / F32_OPS_PER_S * 1e3:.4f} ms")
            if case in EARLIER_OPS:
                ops0, commit, left = EARLIER_OPS[case]
                counted += f"; {commit}'s {ops0} ({ops / ops0 - 1:+.1%}: {left})"
        elif case in eac_counted:
            # What the EAC entry needs on this run's data, its exits taken
            # and each texel's side of the base made once: the device code's
            # operations on a sample of the blocks, whose words must be the
            # plain version's there.
            entry, q, sgn = eac_counted[case]
            xs = x[bc_samp].contiguous()
            want = plain(xs).cpu().numpy()
            hs = xs.cpu().numpy()
            ops, words = count_eac(entry, hs, q, sgn)
            device_ops, device_words = count_eac(entry, hs, q, sgn, device=True)
            check(np.array_equal(words, want) and np.array_equal(device_words, want),
                  f"{case}: the counting build's words differ from the plain version's")
            ops0, commit, left = EARLIER_OPS[case]
            counted = (f"needed (its exits taken, each texel's side of the base once), counted on "
                       f"{bc_samp.numel()} blocks; the device code's {device_ops:.0f}; {commit}'s "
                       f"{ops0} ({ops / ops0 - 1:+.1%}: {left})")
        else:
            xs = x[bc_samp].contiguous()
            row, chw = count_as.get(case, (case, None))
            want = plain(xs).cpu().numpy()
            ops, words = count_bc(row, xs.cpu().numpy(), chw)
            check(np.array_equal(words, want),
                  f"{case}: the counting build's words differ from the plain version's")
            device_ops = ops
            why = next((w for p, w in NEEDED_WHY.items() if case.startswith(p)), None)
            if why:
                device_ops, words = count_bc(row, xs.cpu().numpy(), chw, device=True)
                check(np.array_equal(words, want),
                      f"{case}: the device code's counting build's words differ from the plain "
                      f"version's")
                counted = (f"needed ({why}), counted on {bc_samp.numel()} blocks; the device "
                           f"code's {device_ops:.0f}")
            else:
                counted = f"device code's, counted on {bc_samp.numel()} blocks"
            if case in EARLIER_OPS:
                ops0, commit, left = EARLIER_OPS[case]
                counted += (f"; the device code of {commit} {ops0} ({device_ops / ops0 - 1:+.1%}: "
                            f"{left})")
        bytes_ = n * (in_bytes + out_bytes.get(key, 16))
        t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S * 1e3, n * ops / F32_OPS_PER_S * 1e3
        bound_by = "bytes" if t_bytes >= t_ops else "operations"
        log("times", f"{card}: {key} ({case}, {n} blocks): kernel {kernel_ms:.4f} ms "
            f"({SIZE * SIZE / kernel_ms / 1e3:.1f} Mtexels/s); plain {plain_ms:.4f} ms; "
            f"bound {max(t_bytes, t_ops):.4f} ms ({bound_by}: "
            f"{bytes_ / 1e6:.1f} MB, {ops:.0f} {counted} ops/block)")
        return kernel_ms, plain_ms, max(t_bytes, t_ops), bound_by

    for name, key, case, src, replaces, in_bytes, others in kernel_rows:
        kernel_ms, plain_ms, bound_ms, bound_by = time_case(case, key, in_bytes)
        rows.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": path_launches[key], "max_abs_err": max_err[case],
            "ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        })
        for other in others:
            time_case(other, key, in_bytes)

    # --parent: every case of the rows whose source was given, through the
    # earlier build in turns with this tree's (earlier, this, this,
    # earlier); the words must be the same.
    astc_src = "cuttlefish_tpu_torch/csrc/astc_encode.cu"
    sources = {row[3] for row in kernel_rows} | {astc_src}
    check(set(earlier) <= sources, f"--parent takes the sources of these rows: {sorted(sources)}")
    for _, _, case, src, _, _, others in kernel_rows:
        twin = earlier.get(src)
        for c in (case, *others) if twin else ():
            kernel, kind = cases[c][0], cases[c][2]
            x = dev_in[kind]

            def theirs():
                with routed_to(twin):
                    return kernel(x)

            before = launched(twin)
            same = np.array_equal(theirs().cpu().numpy(), kernel(x).cpu().numpy())
            check(launched(twin) > before, f"{c}: the earlier build did not launch")
            check(same, f"{c}: the earlier {os.path.basename(src)}'s words differ from this one's")
            p1 = event_ms(torch, theirs, 7)
            k1 = event_ms(torch, lambda: kernel(x), 7)
            k2 = event_ms(torch, lambda: kernel(x), 7)
            p2 = event_ms(torch, theirs, 7)
            log("times", f"{card}: {c} ({x.shape[0]} blocks): earlier file {p1:.4f} / {p2:.4f} ms, "
                f"this file {k1:.4f} / {k2:.4f} ms (turns: earlier, this, this, earlier), "
                f"{(p1 + p2) / (k1 + k2):.2f}x faster; words identical")

    # This slice: each ASTC entry alone, its plain version alone, and its
    # bound from the operations it needs on a sample of the same blocks
    # (astc_op_counter: the device code built with g++, which must also
    # give the kernel's words there).
    # (row name, entry, TPU kernel body, (block w, block h, quality, surface) timed for the
    # row, then the other shapes timed alongside)
    astc_rows = [
        ("astc_a_encode", "a", ":792", [(4, 4, 2, "rgba"), (8, 8, 2, "rgba"),
                                        (12, 12, 2, "rgba"), (8, 8, 4, "grayalpha"),
                                        (12, 12, 4, "grayalpha")]),
        ("astc_b_encode", "b", ":1005", [(4, 4, 2, "rgba"), (8, 8, 2, "rgba"),
                                         (12, 12, 2, "rgba"), (4, 4, 4, "grayalpha")]),
        ("astc_c_encode", "c", ":1151", [(4, 4, 4, "grayalpha"), (8, 8, 4, "grayalpha")]),
        ("astc_d_encode", "d", ":1269", [(4, 4, 4, "grayalpha"), (8, 8, 4, "grayalpha")]),
    ]
    with tempfile.TemporaryDirectory() as tmp:
        count_ops = astc_op_counter(str(_build.CSRC), tmp)
        for name, stage, line, shapes in astc_rows:
            for i, (bw, bh, q, kind) in enumerate(shapes):
                hw, x, gray, alpha = astc_input(bw, bh, kind)
                nb = x.shape[0]
                kernel_ms = event_ms(
                    torch, lambda: astc_cuda.stage_cuda(stage, x, bw, bh, q, gray, alpha), 7)
                plain_ms = event_ms(
                    torch, lambda: astc.stage_plain(stage, x, bw, bh, q, gray, alpha), 7)
                samp = np.arange(0, nb, max(1, nb // (1024 if bw * bh == 16 else 256)))
                t0 = time.perf_counter()
                ops, words, _ = count_ops(stage, hw[samp], bw, bh, q, gray, alpha)
                count_s = time.perf_counter() - t0
                xs = x[torch.from_numpy(samp).to(dev)].contiguous()
                kw = astc_cuda.stage_cuda(stage, xs, bw, bh, q, gray, alpha)[0]
                check(np.array_equal(words, kw.cpu().numpy()),
                      f"{name}: the counting build's words differ from the kernel's")
                bytes_ = nb * (bw * bh * 16 + 16 + 4)
                t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S * 1e3, nb * ops / F32_OPS_PER_S * 1e3
                bound_by = "bytes" if t_bytes >= t_ops else "operations"
                log("times", f"{card}: astc_{stage} ({bw}x{bh} q{q} on {kind}, {nb} blocks): "
                    f"kernel {kernel_ms:.4f} ms ({nb * bw * bh / kernel_ms / 1e3:.1f} "
                    f"Mtexels/s); plain {plain_ms:.4f} ms; bound {max(t_bytes, t_ops):.4f} ms "
                    f"({bound_by}: {bytes_ / 1e6:.1f} MB, {ops:.0f} needed ops/block, counted "
                    f"on {samp.size} blocks in {count_s:.1f} s)")
                twin = earlier.get(astc_src)
                if twin:
                    def theirs():
                        return twin.stage_cuda(stage, x, bw, bh, q, gray, alpha)

                    def ours():
                        return astc_cuda.stage_cuda(stage, x, bw, bh, q, gray, alpha)

                    before = launched(twin)
                    (tw, te), (ow, oe) = theirs(), ours()
                    check(launched(twin) > before, f"astc_{stage}: the earlier build did not launch")
                    check(torch.equal(tw.view(torch.int32), ow.view(torch.int32))
                          and torch.equal(te.view(torch.int32), oe.view(torch.int32)),
                          f"astc_{stage} {bw}x{bh} q{q}: the earlier astc_encode.cu's words or "
                          f"errors differ from this one's")
                    p1 = event_ms(torch, theirs, 7)
                    k1 = event_ms(torch, ours, 7)
                    k2 = event_ms(torch, ours, 7)
                    p2 = event_ms(torch, theirs, 7)
                    log("times", f"{card}: astc_{stage} ({bw}x{bh} q{q} on {kind}, {nb} blocks): "
                        f"earlier file {p1:.4f} / {p2:.4f} ms, this file {k1:.4f} / {k2:.4f} ms "
                        f"(turns: earlier, this, this, earlier), {(p1 + p2) / (k1 + k2):.2f}x "
                        f"faster; words and errors identical")
                if i == 0:
                    rows.append({
                        "name": name, "route": "cuda",
                        "source": astc_src,
                        "replaces": "cuttlefish_tpu/kernels/astc_pallas.py" + line,
                        "launches": path_launches[f"astc_{stage}"],
                        "max_abs_err": max_err["astc4_q4_grayalpha" if q == 4 else "astc4_q2"],
                        "ms": kernel_ms, "plain_ms": plain_ms,
                        "bound_ms": max(t_bytes, t_ops), "bound_by": bound_by,
                        "library_ms": None,
                    })

    parent_dir.cleanup()

    def time_convert(pname, make, fmt, typ, quality, fused=None):
        secs, phases = [], []
        for _ in range(5):
            t = make()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ok = (t.convert(fmt, typ, quality) if fused is None
                  else t.convert_with_mips(fmt, typ, quality, **fused))
            check(ok, f"{pname}: timed convert failed")
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            phases.append(t.last_convert_stats["phases"])
        median = {k: round(statistics.median(p.get(k, 0.0) for p in phases), 6)
                  for k in phases[-1]}
        log("times", f"{card}: convert {pname} median of 5 {statistics.median(secs):.4f} s "
            f"{[round(s, 4) for s in secs]}; phases, each its median of the 5 "
            f"{json.dumps(median)}")

    for pname, (fmt, typ, quality, mips, nlayers, ext, img, kname, timed) in paths.items():
        if timed:
            time_convert(pname, lambda: make_texture(img, mips, nlayers), fmt, typ, quality)
    for pname, (fmt, quality, img, mips, cube, timed, _) in astc_paths.items():
        if timed:
            time_convert(pname, lambda: make_astc_texture(img, mips, cube), fmt, TT.UNorm,
                         quality)

    # This slice: the fused paths through convert_with_mips, and ETC2
    # punch-through (generate_mipmaps outside the timed convert, as above).
    for pname, (fmt, typ, arr, cube, nmap, *_) in fused_paths.items():
        time_convert(pname, lambda: fused_texture(arr, cube), fmt, typ, QN,
                     fused={} if nmap is None else {"normal_map": nmap, "normal_height": 2.0})
    time_convert("etc2a1_2048_mips_ktx", lambda: make_texture(images["hard"], True, 0),
                 TF.ETC2_R8G8B8A1, TT.UNorm, QN)
    # This slice: ASTC UFloat and PVRTC1/2 (torch ops on the card).
    for pname, (fmt, typ, quality, arr, mips, *_) in torch_ops_paths.items():
        img = cp.Image.from_array(arr, cp.ImageFormat.RGBAF)
        time_convert(pname, lambda: make_texture(img, mips, 0), fmt, typ, quality)

    # 6. the CLI and the device mesh; their launches count in the kernels line.
    with tempfile.TemporaryDirectory() as tmp:
        cli_mesh_phase(torch, cp, dev, card, surf, counted,
                       lambda x: originals["encode_bc7_plain"](x, 2, consts), tmp)
    row_keys = {name: key for name, key, *_ in kernel_rows}
    row_keys.update({name: f"astc_{stage}" for name, stage, *_ in astc_rows})
    for row in rows:
        row["launches"] = path_launches[row_keys[row["name"]]]

    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main(sys.argv[1:]))
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        sys.exit(1)

"""Small-float bit packing: half (f16), UF11/UF10 (B10G11R11), RGB9E5.

TPU-native replacement for the reference's GLM packing calls
(`lib/src/StandardConverter.cpp:442,463`, packHalf at
`lib/src/HalfFloat.h:61-134`) and the hardware F16C/NEON paths.  Everything is
vectorized integer bit manipulation that works under numpy or jax.numpy (pass
``xp``), with round-to-nearest-even semantics matching IEEE conversions.

Copied from ``cuttlefish_tpu/packfloat.py`` with its imports pointed at
the port; its logic is unchanged.
"""

from __future__ import annotations

import numpy as np


def f32_to_half_bits(x, xp=np):
    """float32 -> IEEE binary16 bits (uint16), round-to-nearest-even."""
    if xp is np:
        return np.asarray(x, np.float32).astype(np.float16).view(np.uint16)
    return xp.asarray(x, xp.float32).astype("float16").view("uint16")


def half_bits_to_f32(bits, xp=np):
    """IEEE binary16 bits (uint16) -> float32."""
    if xp is np:
        return np.asarray(bits, np.uint16).view(np.float16).astype(np.float32)
    return xp.asarray(bits, "uint16").view("float16").astype(xp.float32)


def f32_to_ufloat_bits(x, man_bits: int, xp=np):
    """float32 -> unsigned small float (5 exponent bits, bias 15, no sign).

    Used for UF11 (man_bits=6) and UF10 (man_bits=5) of B10G11R11_UFloat.
    Negative/NaN inputs map to 0; infinities and overflow map to +inf.
    Round-to-nearest-even, with gradual underflow to denormals.
    """
    exp_bits = 5
    bias = 15
    x = xp.asarray(x, xp.float32)
    bits = x.view("uint32") if xp is not np else np.asarray(x).view(np.uint32)
    sign = bits >> 31
    exp = (bits >> 23) & xp.uint32(0xFF)
    man = bits & xp.uint32(0x7FFFFF)

    is_nan = (exp == 255) & (man != 0)
    is_inf = (exp == 255) & (man == 0)
    # Treat negative (including -0) and NaN as 0.
    zero_out = (sign == 1) | is_nan

    shift = 23 - man_bits
    max_exp_out = (1 << exp_bits) - 1  # all-ones = inf/nan

    # Normal path: rebias exponent.
    new_exp = exp.astype(xp.int32) - 127 + bias

    # Denormal handling: when new_exp <= 0, shift mantissa (with implicit 1)
    # right by (1 - new_exp) extra bits.
    implied = man | xp.uint32(1 << 23)
    denorm_shift = xp.clip(1 - new_exp, 0, 31).astype(xp.uint32)
    is_denorm = new_exp <= 0

    frac = xp.where(is_denorm, implied, man)
    total_shift = xp.where(
        is_denorm, xp.uint32(shift) + denorm_shift, xp.uint32(shift)
    )
    total_shift = xp.minimum(total_shift, xp.uint32(31))

    kept = frac >> total_shift
    # Round-to-nearest-even on the discarded bits.
    half = xp.uint32(1) << (total_shift - xp.uint32(1))
    rem = frac & ((xp.uint32(1) << total_shift) - xp.uint32(1))
    round_up = (rem > half) | ((rem == half) & ((kept & xp.uint32(1)) == 1))
    kept = kept + round_up.astype(xp.uint32)

    out_exp = xp.where(is_denorm, xp.int32(0), new_exp)
    # Rounding carry: normals hold mantissa-only, so kept == 2^man_bits bumps
    # the exponent; denormals hold the implicit bit too, so the same condition
    # promotes to the smallest normal (exp 1, mantissa 0).
    carry = kept == (1 << man_bits)
    out_exp = xp.where(carry & ~is_denorm, out_exp + 1, out_exp)
    out_exp = xp.where(carry & is_denorm, xp.int32(1), out_exp)
    kept = xp.where(carry, xp.uint32(0), kept)

    # Overflow to infinity.
    overflow = out_exp >= max_exp_out
    result = (
        xp.clip(out_exp, 0, max_exp_out).astype(xp.uint32) << man_bits
    ) | (kept & xp.uint32((1 << man_bits) - 1))
    result = xp.where(
        overflow | is_inf, xp.uint32(max_exp_out << man_bits), result
    )
    result = xp.where(zero_out, xp.uint32(0), result)
    return result.astype(xp.uint32)


def ufloat_bits_to_f32(bits, man_bits: int, xp=np):
    """Unsigned small float (5 exp bits, bias 15) -> float32."""
    bias = 15
    bits = xp.asarray(bits, xp.uint32)
    exp = (bits >> man_bits).astype(xp.int32) & 0x1F
    man = (bits & xp.uint32((1 << man_bits) - 1)).astype(xp.float32)
    scale = 2.0 ** (exp - bias).astype(xp.float32)
    denorm_scale = xp.float32(2.0 ** (1 - bias))
    value = xp.where(
        exp == 0,
        man / (1 << man_bits) * denorm_scale,
        (1.0 + man / (1 << man_bits)) * scale,
    )
    inf = xp.float32(np.inf)
    value = xp.where(
        (exp == 31), xp.where(man == 0, inf, xp.float32(np.nan)), value
    )
    return value.astype(xp.float32)


def pack_b10g11r11(rgb, xp=np):
    """(..., 3) float32 RGB -> packed uint32, R in bits 0-10, G 11-21, B 22-31.

    Matches the Vulkan/DXGI B10G11R11_UFLOAT layout the reference emits via
    glm::packF2x11_1x10 (`StandardConverter.cpp:442`).
    """
    rgb = xp.asarray(rgb, xp.float32)
    r = f32_to_ufloat_bits(rgb[..., 0], 6, xp)
    g = f32_to_ufloat_bits(rgb[..., 1], 6, xp)
    b = f32_to_ufloat_bits(rgb[..., 2], 5, xp)
    return r | (g << 11) | (b << 22)


def unpack_b10g11r11(packed, xp=np):
    """Packed uint32 -> (..., 3) float32 RGB."""
    packed = xp.asarray(packed, xp.uint32)
    r = ufloat_bits_to_f32(packed & xp.uint32(0x7FF), 6, xp)
    g = ufloat_bits_to_f32((packed >> 11) & xp.uint32(0x7FF), 6, xp)
    b = ufloat_bits_to_f32((packed >> 22) & xp.uint32(0x3FF), 5, xp)
    return xp.stack([r, g, b], axis=-1)


_RGB9E5_N = 9  # mantissa bits per channel
_RGB9E5_E = 5  # shared exponent bits
_RGB9E5_BIAS = 15
_RGB9E5_MAX = float(((1 << 9) - 1) / (1 << 9) * 2 ** ((1 << 5) - 1 - 15 - 0))  # 65408


def pack_rgb9e5(rgb, xp=np):
    """(..., 3) float32 RGB -> shared-exponent RGB9E5 uint32.

    Follows the GL_EXT_texture_shared_exponent algorithm (the reference uses
    glm::packF3x9_E1x5, `StandardConverter.cpp:463`).  Layout: R bits 0-8,
    G 9-17, B 18-26, E 27-31.
    """
    rgb = xp.asarray(rgb, xp.float32)
    n, bias = _RGB9E5_N, _RGB9E5_BIAS
    max_val = xp.float32(_RGB9E5_MAX)
    c = xp.clip(rgb, 0.0, max_val)
    c = xp.where(xp.isnan(c), xp.float32(0.0), c)
    maxc = xp.maximum(xp.maximum(c[..., 0], c[..., 1]), c[..., 2])

    # floor(log2(maxc)) via frexp-free bit inspection of float32.
    bits = maxc.view("uint32") if xp is not np else np.asarray(maxc).view(np.uint32)
    exp_f = (bits >> 23).astype(xp.int32) - 127
    exp_shared_p = xp.maximum(xp.int32(-bias - 1), exp_f) + 1 + bias
    scale = 2.0 ** (exp_shared_p - bias - n).astype(xp.float32)
    max_s = xp.floor(maxc / scale + 0.5)
    exp_shared = xp.where(max_s == (1 << n), exp_shared_p + 1, exp_shared_p)
    scale = 2.0 ** (exp_shared - bias - n).astype(xp.float32)

    def quant(ch):
        return xp.floor(ch / scale + 0.5).astype(xp.uint32)

    rs, gs, bs = quant(c[..., 0]), quant(c[..., 1]), quant(c[..., 2])
    return (
        rs | (gs << 9) | (bs << 18) | (exp_shared.astype(xp.uint32) << 27)
    )


def unpack_rgb9e5(packed, xp=np):
    """Shared-exponent RGB9E5 uint32 -> (..., 3) float32 RGB."""
    packed = xp.asarray(packed, xp.uint32)
    n, bias = _RGB9E5_N, _RGB9E5_BIAS
    r = (packed & xp.uint32(0x1FF)).astype(xp.float32)
    g = ((packed >> 9) & xp.uint32(0x1FF)).astype(xp.float32)
    b = ((packed >> 18) & xp.uint32(0x1FF)).astype(xp.float32)
    e = ((packed >> 27) & xp.uint32(0x1F)).astype(xp.int32)
    scale = 2.0 ** (e - bias - n).astype(xp.float32)
    return xp.stack([r * scale, g * scale, b * scale], axis=-1)

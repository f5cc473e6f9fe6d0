"""ETC1/ETC2/EAC spec tables and quality ladder: a copy of what the TPU
kernels (``cuttlefish_tpu/kernels/etc_pallas.py``) and the decoders read
from ``cuttlefish_tpu/kernels/etc.py``, as numpy and plain Python, so that
the port runs where JAX is not installed.

``_ETC_SHIFTS`` is not copied: ``etc_pallas.py`` imports it but never uses
it, and the punch-through (A1) encoder, whose ``jnp`` path the port's
``encode_etc2_a1`` follows, does not reach it either.  Two tables serve
that encoder alone: ``_ETC_A1_MODS_NP`` and ``_A1_PLANAR_PROJ_NP``.
"""

from __future__ import annotations

import numpy as np

# Intensity modifiers, indexed [table, pixel_index]: [a, b, -a, -b]
# (etc.py:35).
_ETC1_MODS_NP = np.array(
    [
        [2, 8, -2, -8],
        [5, 17, -5, -17],
        [9, 29, -9, -29],
        [13, 42, -13, -42],
        [18, 60, -18, -60],
        [24, 80, -24, -80],
        [33, 106, -33, -106],
        [47, 183, -47, -183],
    ],
    np.int32,
)

# Punch-through modifier set (opaque bit 0): index 0 -> +0, index 1 -> +b,
# index 2 -> transparent (handled by the caller), index 3 -> -b
# (etc.py:114).
_ETC_A1_MODS_NP = _ETC1_MODS_NP.copy()
_ETC_A1_MODS_NP[:, 0] = 0
_ETC_A1_MODS_NP[:, 2] = 0

# The float32 least-squares projection [3, 16] (O, H, V by texel) that the
# jnp path's ``_planar_candidate`` computes in float32 under jit
# (etc.py:246-252: ``inv(basis @ basis.T) @ basis``); it differs from the
# float64 projection of the TPU kernel by up to 4.5e-8.
_A1_PLANAR_PROJ_NP = np.array(
    [
        (0.2874999940395355, 0.21249999105930328, 0.13750000298023224, 0.0625,
         0.21249999105930328, 0.13750000298023224, 0.0624999962747097, -0.01249999925494194,
         0.13750000298023224, 0.0625, -0.012500000186264515, -0.08749999850988388,
         0.0624999962747097, -0.01250000111758709, -0.08749999850988388, -0.16250000894069672),
        (-0.012499998323619366, 0.11249999701976776, 0.23749999701976776, 0.36249998211860657,
         -0.08750000596046448, 0.037499986588954926, 0.16249999403953552, 0.2874999940395355,
         -0.16250000894069672, -0.03750001639127731, 0.08749997615814209, 0.2124999612569809,
         -0.23750002682209015, -0.11250002682209015, 0.012499965727329254, 0.13749995827674866),
        (-0.012500002980232239, -0.08750000596046448, -0.16249999403953552, -0.23749999701976776,
         0.11250001192092896, 0.037500008940696716, -0.037499986588954926, -0.11249998956918716,
         0.23750001192092896, 0.1625000238418579, 0.08750002086162567, 0.012500017881393433,
         0.36250004172325134, 0.2875000238418579, 0.21250003576278687, 0.13750001788139343),
    ],
    np.float32,
)

# EAC modifier table [16, 8] (indices 0-3 negative, 4-7 positive)
# (etc.py:51).
_EAC_MODS_NP = np.array(
    [
        [-3, -6, -9, -15, 2, 5, 8, 14],
        [-3, -7, -10, -13, 2, 6, 9, 12],
        [-2, -5, -8, -13, 1, 4, 7, 12],
        [-2, -4, -6, -13, 1, 3, 5, 12],
        [-3, -6, -8, -12, 2, 5, 7, 11],
        [-3, -7, -9, -11, 2, 6, 8, 10],
        [-4, -7, -8, -11, 3, 6, 7, 10],
        [-3, -5, -8, -11, 2, 4, 7, 10],
        [-2, -6, -8, -10, 1, 5, 7, 9],
        [-2, -5, -8, -10, 1, 4, 7, 9],
        [-2, -4, -8, -10, 1, 3, 7, 9],
        [-2, -5, -7, -10, 1, 4, 6, 9],
        [-3, -4, -7, -10, 2, 3, 6, 9],
        [-1, -2, -3, -10, 0, 1, 2, 9],
        [-4, -6, -8, -9, 3, 5, 7, 8],
        [-3, -5, -7, -9, 2, 4, 6, 8],
    ],
    np.int32,
)

# Raster (4*y+x) -> ETC column-major pixel number (4*x+y) (etc.py:75).
_COLMAJOR_NP = np.array([4 * (i % 4) + i // 4 for i in range(16)], np.int32)
# Inverse: ETC pixel number p -> raster index (etc.py:77).
_RASTER_OF_P_NP = np.argsort(_COLMAJOR_NP).astype(np.int32)

# ETC2 T/H distance table (etc.py:374).
_ETC2_DIST_NP = np.array([3, 6, 11, 16, 23, 32, 41, 64], np.int32)

# EAC multiplier candidates per quality (etc.py:1138).
_EAC_MULT_CANDS = {0: 1, 1: 2, 2: 3, 3: 5, 4: 7}


def _offset_cube(lo, hi):
    """etc.py:750: every (a, b, c) with lo <= a, b, c <= hi, a outermost."""
    return tuple(
        (a, b, c)
        for a in range(lo, hi + 1)
        for b in range(lo, hi + 1)
        for c in range(lo, hi + 1)
    )


# Base-colour quant-index neighbourhood per quality (etc.py:759).
_ETC_OFFSETS = {
    0: ("round", ((0, 0, 0),)),
    1: ("round", ((0, 0, 0),)),
    2: ("round", _offset_cube(-1, 1)),
    3: ("round", _offset_cube(-1, 1)),
    4: ("round", _offset_cube(-1, 1) + ((-2, -2, -2), (2, 2, 2),
                                        (-3, -3, -3), (3, 3, 3))),
}

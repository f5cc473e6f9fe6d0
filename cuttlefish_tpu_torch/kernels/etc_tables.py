"""ETC1/ETC2/EAC spec tables and quality ladder: a copy of what the TPU
kernels (``cuttlefish_tpu/kernels/etc_pallas.py``) and the decoders read
from ``cuttlefish_tpu/kernels/etc.py``, as numpy and plain Python, so that
the port runs where JAX is not installed.

``_ETC_SHIFTS`` is not copied: ``etc_pallas.py`` imports it but never uses
it; it belongs to the punch-through (A1) path, which has no TPU kernel.
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

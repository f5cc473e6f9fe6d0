"""The port's EAC encoders (A8, R11 and RG11, unsigned and signed) against
the TPU kernel bodies ``etc_pallas.py:_eac_alpha`` and ``_eac_r11`` called
eagerly (helpers and tolerances: ``tests/test_torch_etc.py``), on the
values the converters hand on: alpha through the u8 wire, R11/RG11
through the f16 wire (signed: ``2x - 1``).

``tests/test_torch_etc_interpret.py`` holds the eager call to the
reference's own entry points in interpret mode.  One test here pins the
one place where the two differ: XLA rewrites
the EAC multiplier seed ``span / max_pos[t]`` as ``span * (1 /
max_pos[t])``, so on a block whose ratio rounds the other way the eager
body and interpret mode disagree; the port follows interpret mode and the
JAX package's ``jnp`` path.
"""

import numpy as np
import pytest
import torch
from test_torch_etc import eager_eac, etc_blocks, psnr, same, to_bytes

from cuttlefish_tpu.decode import etc as jdec
from cuttlefish_tpu.kernels import etc as jetc
from cuttlefish_tpu.kernels import etc_pallas
from cuttlefish_tpu_torch.decode import etc as pdec
from cuttlefish_tpu_torch.kernels import etc

# (kind, quality): alpha A8; r11 / r11s unsigned / signed R11; rg11 / rg11s.
_CASES = [
    ("alpha", 0), ("alpha", 2), ("alpha", 4),
    ("r11", 2), ("r11", 4), ("r11s", 2), ("r11s", 4),
    ("rg11", 2), ("rg11s", 2),
]


def _values(kind):
    """The test blocks' values for `kind`: alpha of the u8 wire; red (and
    green) of the f16 wire, 2x - 1 when signed."""
    b = etc_blocks()
    if kind == "alpha":
        return np.ascontiguousarray(b[..., 3])
    v = b[..., :2] * 2 - 1 if kind.endswith("s") else b[..., :2]
    v = v.astype(np.float16).astype(np.float32)
    return np.ascontiguousarray(v if kind.startswith("rg") else v[..., 0])


def _port(kind, v, quality):
    x = torch.from_numpy(v)
    if kind == "alpha":
        return etc.encode_eac_alpha(x, quality).numpy()
    signed = kind.endswith("s")
    if kind.startswith("rg"):
        return etc.encode_eac_rg11(x, quality, signed).numpy()
    return etc.encode_eac_r11(x, quality, signed).numpy()


def _eager(kind, v, quality):
    if kind.startswith("rg"):
        k = "r11s" if kind.endswith("s") else "r11"
        return np.concatenate([eager_eac(v[..., c], quality, k) for c in (0, 1)], axis=1)
    return eager_eac(v, quality, kind)


def _decoded(kind, words):
    raw = to_bytes(words)
    if kind == "alpha":
        return jdec.decode_eac_alpha(raw).astype(np.float64), 255.0
    signed = kind.endswith("s")
    if kind.startswith("rg"):
        return jdec.decode_eac_rg11(raw, signed), 2.0 if signed else 1.0
    return jdec.decode_eac_r11(raw, signed), 2.0 if signed else 1.0


@pytest.mark.parametrize("case", _CASES, ids=lambda c: f"{c[0]}-q{c[1]}")
def test_plain_matches_tpu_kernel(case):
    """>= 99 % identical blocks (100 % expected), PSNR within 0.05 dB."""
    kind, quality = case
    v = _values(kind)
    port, ref = _port(kind, v, quality), _eager(kind, v, quality)
    assert port.dtype == np.uint32 and port.shape == ref.shape
    assert same(port, ref) >= 0.99, same(port, ref)
    dp, peak = _decoded(kind, port)
    dr, _ = _decoded(kind, ref)
    target = np.round(v * 255) if kind == "alpha" else v
    assert abs(psnr(dp, target, peak) - psnr(dr, target, peak)) <= 0.05


@pytest.mark.parametrize("kind", ["alpha", "r11", "r11s"])
def test_port_decoder_equals_the_jax_packages(kind):
    words = _port(kind, _values(kind), 2)
    raw = to_bytes(words)
    if kind == "alpha":
        assert np.array_equal(pdec.decode_eac_alpha(raw), jdec.decode_eac_alpha(raw))
    else:
        s = kind == "r11s"
        assert np.array_equal(pdec.decode_eac_r11(raw, s), jdec.decode_eac_r11(raw, s))


# Alpha blocks (u8) whose range is 182: span 91, and 91 / 14 = 6.5 exactly,
# while 91 * float32(1/14) rounds to 6.5000005; at quality 0 that picks
# table 0's only multiplier, 6 or 7.
_TIE_BLOCKS = np.array(
    [
        [8, 70, 49, 107, 171, 190, 167, 64, 11, 150, 137, 149, 8, 14, 100, 69],
        [5, 163, 145, 56, 85, 187, 61, 15, 141, 5, 144, 40, 122, 67, 48, 174],
        [2, 95, 138, 141, 176, 184, 55, 182, 83, 74, 49, 5, 10, 180, 5, 27],
    ],
    np.uint8,
)


def test_division_by_a_constant_follows_interpret_mode():
    """On blocks where span / max_pos lands on a rounding tie, the port
    equals interpret mode and the jnp path, and the eager body (true
    division) differs from all three."""
    vals = _TIE_BLOCKS.astype(np.float32) * np.float32(1 / 255)
    interp = np.asarray(etc_pallas.encode_eac_alpha_pallas(vals, 0, interpret=True))
    jnp_path = np.asarray(jetc._encode_eac_alpha_jnp(vals, 0))
    port = _port("alpha", vals, 0)
    assert np.array_equal(port, interp) and np.array_equal(port, jnp_path)
    assert not np.any(np.all(eager_eac(vals, 0, "alpha") == port, axis=1))
    # The seed constant is the float32 reciprocal, table by table.
    assert etc._EAC_INV_MAX_POS == tuple(
        float(np.float32(1) / np.float32(m)) for m in (14, 12, 12, 12, 11, 10, 10, 10, 9, 9, 9, 9, 9, 9, 8, 8)
    )

"""The comparison that decides ``correct``: the program's DDS bytes
against the plain reference, rebuilt from the level-0 inputs it was
handed.

For each texture judged, the reference builds its own float64 mip chain
(``reference/pyramid.py``), expects the DDS head and layout of
``reference/dds.py``, and decodes every block of every level and face
with its own decoder (``reference/<config's reference>.py``).  The
numbers, summed or taken over the textures judged:

- ``head_bytes``: bytes of the 148-byte head that differ from the
  expected one, plus the difference in file length;
- ``bad_blocks``: blocks the reference cannot decode;
- ``gap_mean``: the mean index gap of a texel (the decoder module's
  ``analyse``), in the configuration's weighted squared units: it reads
  the source the encoder saw;
- ``worse_texels``: texels whose stored index is worse than the
  baseline's beyond rounding: it reads one wrong index anywhere;
- ``err_mean``: mean absolute difference of every decoded channel from
  the reference's source, in the configuration's units;
- ``fit_ratio_alpha``, ``fit_ratio_opaque``: the decoded blocks' squared
  error (the configuration's channel weights) over that of the
  reference's own plain fit of the same source blocks, summed over the
  judged textures with alpha and over the opaque ones apart (the two
  classes sit at different ratios): it reads how good the encoder's
  endpoints and mode search are, where the index gap reads only the
  indices for the endpoints stored.  None where no texture of the class
  was judged; a class the window did not send has nothing to judge.

Each number has its limit in the configuration's file (``limits``); the
run is correct when none is exceeded.
"""

from __future__ import annotations

import importlib

import numpy as np
import torch

from harness.reference import dds, pyramid

NUMBERS = ("head_bytes", "bad_blocks", "gap_mean", "worse_texels", "err_mean",
           "fit_ratio_alpha", "fit_ratio_opaque")
CLASSES = ("alpha", "opaque")
CHUNK = 1 << 16


def reference(config: dict):
    """The configuration's reference module (``reference/<name>.py``):
    its decoder and index gap (``judge_blocks``), its DDS format fields
    (``dds_format``, ``DDS_ALPHA_MODE``) and the bit an altered answer
    flips (``texel1_msb``)."""
    return importlib.import_module(f"harness.reference.{config['reference']}")


def judge_texture(config: dict, level0: np.ndarray, data: bytes, device) -> dict:
    """Numbers of one texture: level0 [S,H,W,4] float32, data its DDS."""
    ref = reference(config)
    s, h, w = level0.shape[:3]
    levels = pyramid.full_levels(h, w)
    srgb = config["color_space"] == "sRGB"
    head = dds.head(ref.dds_format(config["type"], srgb), ref.DDS_ALPHA_MODE, h, w, levels, s)
    place = dds.layout(h, w, levels, s)
    size = place[-1][2] + place[-1][3]
    got = np.frombuffer(data[:148], np.uint8)
    want = np.frombuffer(head, np.uint8)
    wrong = int((got != want[: got.size]).sum()) + abs(len(data) - size)
    wrong += max(0, 148 - got.size)
    out = {"head_bytes": wrong, "bad_blocks": 0, "gap_sum": 0.0, "worse_texels": 0,
           "err_sum": 0.0, "fit_sum": 0.0, "plain_sum": 0.0, "texels": 0,
           "values": 0, "class": "alpha" if bool((level0[..., 3] < 1.0).any()) else "opaque"}
    if len(data) != size:
        out["bad_blocks"] = sum(p[3] // 16 for p in place)
        return out
    x0 = torch.from_numpy(level0).to(device)
    chain = pyramid.chain(x0, levels, config["filter"], srgb)
    bound = pyramid.rounding_bound(x0, levels, config["filter"])
    raw = torch.frombuffer(bytearray(data), dtype=torch.uint8).to(device)
    for face, k, off, n in place:
        blocks = raw[off : off + n].reshape(-1, 16)
        src = pyramid.tile(chain[k][face : face + 1])[0]
        err = pyramid.tile(bound[k][face : face + 1])[0]
        for a in range(0, blocks.shape[0], CHUNK):
            part = slice(a, a + CHUNK)
            nums = ref.judge_blocks(blocks[part], src[part], err[part], config)
            for key, value in nums.items():
                out[key] += value
    return out


def combine(per_texture: list[dict]) -> dict:
    """Numbers over the textures judged."""
    texels = sum(t["texels"] for t in per_texture)
    values = sum(t["values"] for t in per_texture)
    out = {
        "head_bytes": sum(t["head_bytes"] for t in per_texture),
        "bad_blocks": sum(t["bad_blocks"] for t in per_texture),
        "gap_mean": sum(t["gap_sum"] for t in per_texture) / max(texels, 1),
        "worse_texels": sum(t["worse_texels"] for t in per_texture),
        "err_mean": sum(t["err_sum"] for t in per_texture) / max(values, 1),
    }
    for cls in CLASSES:
        of = [t for t in per_texture if t["class"] == cls]
        plain = sum(t["plain_sum"] for t in of)
        # A class whose blocks are all flat has no error to compare (0/0).
        out[f"fit_ratio_{cls}"] = sum(t["fit_sum"] for t in of) / plain if of and plain > 0 else None
    return out


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """-> (correct, {name: {"value", "limit"}}) in NUMBERS order; a number
    that is None has nothing to judge."""
    shown = {k: {"value": numbers[k], "limit": limits[k]} for k in NUMBERS}
    return all(numbers[k] is None or numbers[k] <= limits[k] for k in NUMBERS), shown

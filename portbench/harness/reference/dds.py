"""The DDS file the configuration asks for, as the plain reference
expects it: its 148-byte head and where each face's levels lie.

A DDS file with the DX10 extension (Microsoft's DDS_HEADER and
DDS_HEADER_DXT10), laid out as the reference project writes it
(``lib/src/SaveDds.cpp``): flags CAPS | HEIGHT | WIDTH | PIXELFORMAT |
MIPMAPCOUNT | PITCH, the pitch one row of blocks, fourCC 'DX10', then the
data face by face, each face's levels from the largest down.
"""

from __future__ import annotations

import struct

# DXGI formats by (format, type, sRGB).
DXGI = {
    ("BC7", "UNorm", False): 98,
    ("BC7", "UNorm", True): 99,
}
# DXGI alpha modes (DDS_ALPHA_MODE_*): straight alpha where the format
# holds alpha.
ALPHA_MODE = {"BC7": 1}
BLOCK_BYTES = 16


def level_bytes(h: int, w: int) -> int:
    return -(-h // 4) * -(-w // 4) * BLOCK_BYTES


def head(fmt: str, type_: str, srgb: bool, h: int, w: int, levels: int, faces: int) -> bytes:
    flags = 0x1 | 0x2 | 0x4 | 0x1000 | 0x20000 | 0x8
    caps = 0x1000 | (0x400000 | 0x8 if levels > 1 else 0)
    caps2 = 0x200 | 0x400 | 0x800 | 0x1000 | 0x2000 | 0x4000 | 0x8000 if faces == 6 else 0
    header = struct.pack(
        "<7I11I8I5I",
        124, flags, h, w, -(-w // 4) * BLOCK_BYTES, 0, levels,
        *([0] * 11),
        32, 0x4, int.from_bytes(b"DX10", "little"), 0, 0, 0, 0, 0,
        caps, caps2, 0, 0, 0,
    )
    dx10 = struct.pack(
        "<5I", DXGI[(fmt, type_, srgb)], 3, 0x4 if faces == 6 else 0, 1, ALPHA_MODE[fmt]
    )
    return struct.pack("<I", 0x20534444) + header + dx10


def layout(h: int, w: int, levels: int, faces: int) -> list[tuple[int, int, int, int]]:
    """(face, level, byte offset, byte length) of every surface, in file
    order."""
    out = []
    pos = 148
    for face in range(faces):
        for k in range(levels):
            n = level_bytes(max(h >> k, 1), max(w >> k, 1))
            out.append((face, k, pos, n))
            pos += n
    return out

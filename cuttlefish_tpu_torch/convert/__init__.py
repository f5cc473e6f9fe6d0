"""Converter factory of the port (counterpart of
``cuttlefish_tpu/convert/__init__.py:create_converter``).

Uncompressed formats go to the reused host converters of
``cuttlefish_tpu.convert.standard``; BC7 goes to the port.  Every other
block format raises ``NotImplementedError`` until its slice is ported.
"""

from __future__ import annotations

from cuttlefish_tpu.convert import Converter, EncodeParams  # noqa: F401
from cuttlefish_tpu.formats import TextureFormat, TextureType, is_format_valid


def create_converter(
    fmt: TextureFormat, type_: TextureType, device="cpu"
) -> Converter | None:
    """Factory keyed on (format, type); None = invalid combination."""
    if not is_format_valid(fmt, type_):
        return None
    from cuttlefish_tpu.convert import standard

    std = standard.create_standard_converter(fmt, type_)
    if std is not None:
        return std
    if fmt is TextureFormat.BC7:
        from cuttlefish_tpu_torch.convert.s3tc import Bc7Converter

        return Bc7Converter(device)
    raise NotImplementedError(
        f"{fmt.name} is not in the PyTorch port yet: ported in a later PR"
    )

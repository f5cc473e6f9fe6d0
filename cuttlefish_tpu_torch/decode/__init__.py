"""Reference block decoders of the port (host numpy, no JAX).

BC1-BC5 (``s3tc.py``), BC6H (``bc6h.py``), BC7 (``bc7.py``), ETC1/ETC2/
EAC (``etc.py``), ASTC (``astc.py``) and PVRTC1/2 (``pvrtc.py``), copies of
the JAX package's decoders; ``surface.py`` decodes whole surfaces of every
format.
"""

from cuttlefish_tpu_torch.decode.astc import decode_astc  # noqa: F401
from cuttlefish_tpu_torch.decode.bc6h import decode_bc6h, decode_bc6h_f32  # noqa: F401
from cuttlefish_tpu_torch.decode.bc7 import decode_bc7  # noqa: F401
from cuttlefish_tpu_torch.decode.etc import (  # noqa: F401
    decode_eac_alpha,
    decode_eac_r11,
    decode_eac_rg11,
    decode_etc2_a1,
    decode_etc2_rgba,
    decode_etc_rgb,
)
from cuttlefish_tpu_torch.decode.pvrtc import decode_pvrtc1, decode_pvrtc2  # noqa: F401
from cuttlefish_tpu_torch.decode.s3tc import (  # noqa: F401
    decode_bc1,
    decode_bc2,
    decode_bc3,
    decode_bc4,
    decode_bc5,
)

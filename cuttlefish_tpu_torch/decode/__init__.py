"""Reference block decoders of the port (host numpy, no JAX)."""

from cuttlefish_tpu_torch.decode.bc7 import decode_bc7  # noqa: F401

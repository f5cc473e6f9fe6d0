"""Block encoders of the PyTorch/CUDA port.

Submodules are imported where they are used: ``bc7``, ``bc``, ``bc6h``,
``etc`` and ``astc`` (plain PyTorch versions and dispatch), ``bc7_cuda``,
``bc7_hq_cuda``, ``bc_cuda``, ``bc6h_cuda``, ``etc_cuda`` and ``astc_cuda``
(the hand kernels' wrappers), ``astc_hdr`` and ``pvrtc`` (torch ops of the
JAX package's XLA programs, on ``jnp_common``'s helpers),
``bc7_tables``, ``bc6h_tables``, ``etc_tables``, ``astc_tables``,
``astc_ise``, ``astc_partition`` and ``pvrtc_tables`` (spec tables) and
``_build`` (nvcc build of ``csrc/``).
"""


def launch_counts() -> dict[str, int]:
    """Kernel name -> launches so far, for every hand kernel of the port."""
    from cuttlefish_tpu_torch.kernels import (
        astc_cuda, bc6h_cuda, bc7_cuda, bc7_hq_cuda, bc_cuda, etc_cuda,
    )

    return {
        "bc7": bc7_cuda.launches,
        "bc7_hq": bc7_hq_cuda.launches,
        **bc_cuda.launches,
        "bc6h": bc6h_cuda.launches,
        **etc_cuda.launches,
        **astc_cuda.launches,
    }

"""Block encoders of the PyTorch/CUDA port.

Submodules are imported where they are used: ``bc7`` (plain PyTorch
version and dispatch), ``bc7_cuda`` (the hand kernel's wrapper),
``bc7_tables`` (spec tables) and ``_build`` (nvcc build of ``csrc/``).
"""

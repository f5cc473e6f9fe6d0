"""`python -m cuttlefish_tpu_torch` = the cuttlefish CLI, on the CUDA card."""

from cuttlefish_tpu_torch.cli import main

main()

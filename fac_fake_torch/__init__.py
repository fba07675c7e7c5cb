"""fac_fake_torch — the PyTorch/CUDA port of fac_fake_tpu for one NVIDIA H100.

Imports torch and numpy, never JAX or the JAX package. Entry points run on
the card unless the caller passes ``device="cpu"``. Hand-written kernels
live in ``csrc/`` and build on first use (`fac_fake_torch.kernels`).
"""

"""Blocks of the CViT variants (the port of `fac_fake_tpu/models/blocks/`)."""

"""Input preprocessing for the scoring path: uint8 crops → /255 → ImageNet
mean/std (`cvit_prediction.py:209-215`), the port of
`fac_fake_tpu/ops/preprocess.py normalize_imagenet`.

On the card this is kernel K2 (`csrc/normalize.cu`): one pass from the
uint8 NHWC crops to the model's compute dtype, written in NHWC memory and
returned as an NCHW-shaped ``channels_last`` tensor, so the first cuDNN
convolution reads it with no copy. On a CPU tensor the plain version below
runs. The JAX package let XLA fuse this op into the first conv's read.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from fac_fake_torch import kernels

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

_MEAN_STD = (ctypes.c_float * 6)(*IMAGENET_MEAN.tolist(), *IMAGENET_STD.tolist())


def normalize_imagenet_plain(crops_u8: torch.Tensor,
                             dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(B, H, W, 3) uint8 → (B, 3, H, W) ``channels_last`` in ``dtype``.
    JAX's order: divide by 255, subtract the mean, divide by the std, in
    fp32 (tensor divisors, so CUDA does not swap a division for a multiply
    by the reciprocal), then round to ``dtype``."""
    dev = crops_u8.device
    x = crops_u8.to(torch.float32) / torch.full((3,), 255.0, device=dev)
    x = (x - torch.from_numpy(IMAGENET_MEAN).to(dev)) / torch.from_numpy(IMAGENET_STD).to(dev)
    return x.to(dtype).permute(0, 3, 1, 2)


def normalize_imagenet(crops_u8: torch.Tensor,
                       dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """K2's wrapper. CPU tensors take the plain version; CUDA tensors launch
    the kernel or raise."""
    if not crops_u8.is_cuda:
        return normalize_imagenet_plain(crops_u8, dtype)
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"normalize_imagenet: no kernel for {dtype}")
    kernels.require_cuda(crops_u8, "normalize_imagenet", torch.uint8,
                         (None, None, None, 3))
    out = torch.empty(crops_u8.shape, dtype=dtype, device=crops_u8.device)
    err = kernels.lib("normalize").fac_normalize_imagenet(
        kernels.ptr(crops_u8), kernels.ptr(out),
        ctypes.c_longlong(crops_u8.numel()),
        ctypes.c_int(int(dtype == torch.bfloat16)), _MEAN_STD,
        kernels.stream_ptr(crops_u8.device))
    kernels.check(err, "normalize_imagenet")
    normalize_imagenet.launches += 1
    return out.permute(0, 3, 1, 2)


normalize_imagenet.launches = 0


"""Input preprocessing: uint8 crops → /255 → ImageNet mean/std
(`cvit_prediction.py:209-215`), the port of `fac_fake_tpu/ops/preprocess.py
normalize_imagenet`, and on the int8 paths the first int8 conv's quantize of
that input, in the same pass.

On the card all of it is kernel K2 (`csrc/normalize.cu`), one table-driven
pass over the uint8 bytes; the JAX package let XLA fuse the normalize (and
the first conv's quantize) into the first conv's read. Its entries:

  * `normalize_imagenet`: (B, H, W, 3) uint8 → the fp32 or bf16 normalized
    values, written in NHWC memory and returned as an NCHW-shaped
    ``channels_last`` tensor, so the first cuDNN convolution reads them with
    no copy;
  * `quantize_crops`: (B, H, W, 3) uint8 → the int8 (B, H, W, 4) input of a
    CViT stem's int8 walk: the normalized value (in fp32, or rounded to
    bf16) quantized with the first conv's ``x_scale``, channel 3 zero —
    what `quant3d.quantize_pad` makes of `normalize_imagenet`'s output;
  * `quantize_clips`: (..., 3) uint8 clips → int8 (..., 4), the raw bytes
    quantized with ``s_x`` — what `quant3d.quantize_pad` makes of the clips
    cast to fp32 (S3D's stem input, raw 0-255 values).

Every launch adds one to ``normalize_imagenet.launches`` (K2's count); the
int8 entries also count their own. On a CPU tensor each entry takes its
plain version below; the int8 entries' plain versions are the two-step
chains they replace.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from fac_fake_torch import kernels
from fac_fake_torch.ops.quant3d import quantize_pad_plain

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

_MEAN_STD = (ctypes.c_float * 6)(*IMAGENET_MEAN.tolist(), *IMAGENET_STD.tolist())
_DTYPES = (torch.float32, torch.bfloat16)
# K2's modes (`csrc/normalize.cu`): fp out by dtype, int8 out by the dtype
# the value is normalized in, and the raw bytes quantized
_FP_MODE = {torch.float32: 0, torch.bfloat16: 1}
_INT8_MODE = {torch.float32: 2, torch.bfloat16: 3}
_RAW_MODE = 4


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


def quantize_crops_plain(crops_u8: torch.Tensor, x_scale: torch.Tensor,
                         dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(B, H, W, 3) uint8 → int8 (B, H, W, 4): the normalize in ``dtype``,
    then the quantize pass."""
    return quantize_pad_plain(normalize_imagenet_plain(crops_u8, dtype).permute(0, 2, 3, 1),
                              x_scale)


def quantize_clips_plain(clips_u8: torch.Tensor, x_scale: torch.Tensor) -> torch.Tensor:
    """(..., 3) uint8 → int8 (..., 4): the cast to fp32, then the quantize
    pass."""
    return quantize_pad_plain(clips_u8.float(), x_scale)


def _launch(u8: torch.Tensor, out: torch.Tensor, mode: int, x_scale, what: str) -> None:
    """One K2 launch over ``u8``'s pixels into ``out``; nothing launches
    when they are empty."""
    if u8.numel() == 0:
        return
    err = kernels.lib("normalize").fac_normalize_imagenet(
        kernels.ptr(u8), kernels.ptr(out), ctypes.c_longlong(u8.numel() // 3), mode, _MEAN_STD,
        None if x_scale is None else kernels.ptr(x_scale), kernels.stream_ptr(u8.device))
    kernels.check(err, what)
    normalize_imagenet.launches += 1


def _require(u8: torch.Tensor, what: str, dim: int, dtype: torch.dtype = torch.float32,
             x_scale=None) -> None:
    if dtype not in _DTYPES:
        raise ValueError(f"{what}: no kernel for {dtype}")
    kernels.require_cuda(u8, what, torch.uint8, (None,) * (dim - 1) + (3,))
    if x_scale is not None:
        kernels.require_cuda(x_scale, f"{what} x_scale", torch.float32, ())


def normalize_imagenet(crops_u8: torch.Tensor,
                       dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """K2's fp entry. CPU tensors take the plain version; CUDA tensors
    launch the kernel or raise."""
    if not crops_u8.is_cuda:
        return normalize_imagenet_plain(crops_u8, dtype)
    _require(crops_u8, "normalize_imagenet", 4, dtype)
    out = torch.empty(crops_u8.shape, dtype=dtype, device=crops_u8.device)
    _launch(crops_u8, out, _FP_MODE[dtype], None, "normalize_imagenet")
    return out.permute(0, 3, 1, 2)


normalize_imagenet.launches = 0


def quantize_crops(crops_u8: torch.Tensor, x_scale: torch.Tensor,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """K2's int8 entry for a CViT stem: `quantize_crops_plain` in one
    launch. ``x_scale``: the first int8 conv's 0-d fp32 scale on the
    crops' device. CPU tensors take the plain version; CUDA tensors launch
    the kernel or raise."""
    if not crops_u8.is_cuda:
        return quantize_crops_plain(crops_u8, x_scale, dtype)
    _require(crops_u8, "quantize_crops", 4, dtype, x_scale)
    out = torch.empty((*crops_u8.shape[:-1], 4), dtype=torch.int8, device=crops_u8.device)
    _launch(crops_u8, out, _INT8_MODE[dtype], x_scale, "quantize_crops")
    if out.numel():
        quantize_crops.launches += 1
    return out


quantize_crops.launches = 0


def quantize_clips(clips_u8: torch.Tensor, x_scale: torch.Tensor) -> torch.Tensor:
    """K2's raw int8 entry (S3D's uint8 NDHWC clips, any number of leading
    dimensions): `quantize_clips_plain` in one launch. CPU tensors take the
    plain version; CUDA tensors launch the kernel or raise."""
    if not clips_u8.is_cuda:
        return quantize_clips_plain(clips_u8, x_scale)
    _require(clips_u8, "quantize_clips", clips_u8.dim(), x_scale=x_scale)
    out = torch.empty((*clips_u8.shape[:-1], 4), dtype=torch.int8, device=clips_u8.device)
    _launch(clips_u8, out, _RAW_MODE, x_scale, "quantize_clips")
    if out.numel():
        quantize_clips.launches += 1
    return out


quantize_clips.launches = 0

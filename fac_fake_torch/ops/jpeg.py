"""JPEG compression of the taken frames of a batch — kernel K10, the port of
`fac_fake_tpu/data/augment.py:415` `jpeg_compress` and of the step of
`augment_batch` that applies it under ``where(take)`` (:701-708), the S3D
train transform's ImageCompression (`S3D/deepfakes_dataset.py:34`).

Each frame (H, W, 3) float32 in [0, 1], H and W multiples of 16, at its own
``quality`` (libjpeg's scaling of the ITU-T T.81 Annex K tables,
`_jpeg_quality_table`): RGB → YCbCr (JFIF, ×255); luma in 8×8 blocks, and
Cb, Cr averaged over 2×2 pixels (4:2:0) in 8×8 blocks of the half-size
plane; each block ``coef = D·(block − 128)·Dᵀ`` with the orthonormal DCT
matrix D, quantized ``rint(coef / table) · table`` (half to even, as
``jnp.round``), ``D ᵀ·q·D + 128``; chroma upsampled by nearest 2×; back to RGB,
``/255`` and clipped to [0, 1]. JAX compresses every frame and selects; the
port compresses only the taken ones, in place, which gives the same result.

`jpeg_compress_plain` is that arithmetic in torch (8×8 einsums,
``torch.round``): the CPU path and the oracle. `jpeg_subset_` is the
augmentation's step: on a CPU tensor the plain version on the taken frames;
on a CUDA tensor one launch of K10 (`csrc/jpeg.cu`: a CTA a (frame, 16×16
MCU); the CTAs of untaken frames return at once; ``take`` and the quality
are read on the card) that adds one to ``jpeg_subset_.launches``, or it
raises.

Numbers: the kernel and its twin sum the DCT products in other orders, so a
coefficient within float32 noise of a rounding boundary (``k + 0.5`` in
units of its table entry) can round the other way and move its whole block.
`near_ties` finds those blocks by a float64 recomputation of
``coef / table`` (within 1e-4 of a boundary); outside them the two agree to
2e-5 on the [0, 1] scale (`JPEG_TOL`).
"""
from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

from fac_fake_torch import kernels
from fac_fake_torch.ops.augment import rgb_to_ycbcr, ycbcr_to_rgb

JPEG_TOL = 2e-5          # kernel vs twin, twin vs JAX, outside near-tie blocks
NEAR_TIE = 1e-4          # |coef/table − (k + 0.5)| below this: a near-tie block

# ITU-T T.81 Annex K base quantization tables
LUMA_Q = np.asarray([
    [16, 11, 10, 16, 24, 40, 51, 61],
    [12, 12, 14, 19, 26, 58, 60, 55],
    [14, 13, 16, 24, 40, 57, 69, 56],
    [14, 17, 22, 29, 51, 87, 80, 62],
    [18, 22, 37, 56, 68, 109, 103, 77],
    [24, 35, 55, 64, 81, 104, 113, 92],
    [49, 64, 78, 87, 103, 121, 120, 101],
    [72, 92, 95, 98, 112, 100, 103, 99]], np.float32)
CHROMA_Q = np.full((8, 8), 99, np.float32)
CHROMA_Q[:4, :4] = [[17, 18, 24, 47], [18, 21, 26, 66], [24, 26, 56, 99], [47, 66, 99, 99]]


@lru_cache(maxsize=8)
def dct8(device, dtype=torch.float32) -> torch.Tensor:
    """The orthonormal 8-point DCT matrix D[u, x], built as JAX's `_dct8`."""
    x = torch.arange(8, dtype=dtype)
    d = torch.cos((2.0 * x[None, :] + 1.0) * x[:, None] * (math.pi / 16.0))
    c = torch.where(torch.arange(8) == 0, torch.sqrt(torch.tensor(1.0 / 8.0, dtype=dtype)),
                    torch.sqrt(torch.tensor(2.0 / 8.0, dtype=dtype)))
    return (d * c[:, None]).to(device)


def quality_table(base: np.ndarray, quality: torch.Tensor) -> torch.Tensor:
    """libjpeg quality scaling (what cv2.imencode applies): (N,) qualities →
    (N, 8, 8) tables, in the quality's dtype."""
    q = torch.clamp(quality, 1.0, 100.0)[:, None, None]
    # tensor divisors: torch turns ``number / tensor`` into a reciprocal and a multiply
    scale = torch.where(q < 50.0, torch.full_like(q, 5000.0) / q, 200.0 - 2.0 * q)
    b = torch.from_numpy(base).to(quality.device, quality.dtype)
    hundred = torch.full((1,), 100.0, device=quality.device, dtype=quality.dtype)
    return torch.clamp(torch.floor((b * scale + 50.0) / hundred), 1.0, 255.0)


def _blocks(plane: torch.Tensor) -> torch.Tensor:
    """(N, H, W) → (N, H/8, W/8, 8, 8) blocks of ``plane − 128``."""
    n, h, w = plane.shape
    return (plane - 128.0).reshape(n, h // 8, 8, w // 8, 8).permute(0, 1, 3, 2, 4)


def _coefs(plane: torch.Tensor) -> torch.Tensor:
    d = dct8(plane.device, plane.dtype)
    return torch.einsum("ux,nhwxy,vy->nhwuv", d, _blocks(plane), d)


def _dct_quantize(plane: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """(N, H, W) in [0, 255] → its blockwise DCT-quantized reconstruction."""
    n, h, w = plane.shape
    d = dct8(plane.device, plane.dtype)
    t = table[:, None, None]
    coef = torch.round(_coefs(plane) / t) * t
    rec = torch.einsum("ux,nhwuv,vy->nhwxy", d, coef, d)
    return rec.permute(0, 1, 3, 2, 4).reshape(n, h, w) + 128.0


def _subsample(c: torch.Tensor) -> torch.Tensor:
    n, h, w = c.shape
    return c.reshape(n, h // 2, 2, w // 2, 2).mean(dim=(2, 4))


def _check_hw(h: int, w: int) -> None:
    if h % 16 or w % 16:
        raise ValueError(f"JPEG compression needs H and W multiples of 16, got {h}x{w}")


def jpeg_compress_plain(imgs: torch.Tensor, quality: torch.Tensor) -> torch.Tensor:
    """K10's plain version: (N, H, W, 3) float32 in [0, 1] and (N,) float
    qualities → the compressed frames, a new tensor."""
    _check_hw(imgs.shape[1], imgs.shape[2])
    y, cb, cr = rgb_to_ycbcr(imgs)
    lq = quality_table(LUMA_Q, quality.to(imgs.dtype))
    cq = quality_table(CHROMA_Q, quality.to(imgs.dtype))

    def chroma(c):
        rec = _dct_quantize(_subsample(c), cq)
        return rec.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)

    return ycbcr_to_rgb(_dct_quantize(y, lq), chroma(cb), chroma(cr))


def near_ties(imgs: torch.Tensor, quality: torch.Tensor) -> tuple:
    """The near-tie blocks of compressing ``imgs`` at ``quality``, by a
    float64 recomputation of ``coef / table``: (the (N, H, W) bool mask of
    their pixels — a luma block's 8×8, a chroma block's 16×16 —, their
    count, the count of all blocks, 6 an MCU)."""
    x = imgs.double()
    q = quality.double()
    y, cb, cr = rgb_to_ycbcr(x)

    def tie(plane, base):
        r = _coefs(plane) / quality_table(base, q)[:, None, None]
        return (torch.abs(r - torch.floor(r) - 0.5) < NEAR_TIE).any(-1).any(-1)

    ty, tb, tr = tie(y, LUMA_Q), tie(_subsample(cb), CHROMA_Q), tie(_subsample(cr), CHROMA_Q)
    mask = ty.repeat_interleave(8, 1).repeat_interleave(8, 2) \
        | (tb | tr).repeat_interleave(16, 1).repeat_interleave(16, 2)
    return mask, int(ty.sum() + tb.sum() + tr.sum()), ty.numel() + tb.numel() + tr.numel()


def jpeg_subset_plain_(x: torch.Tensor, take: torch.Tensor,
                       quality: torch.Tensor) -> torch.Tensor:
    """K10's plain version of the step: the taken frames of ``x`` replaced in
    place by `jpeg_compress_plain` of themselves."""
    idx = torch.nonzero(take).flatten()
    if idx.numel():
        x.index_copy_(0, idx, jpeg_compress_plain(x.index_select(0, idx),
                                                  quality.index_select(0, idx)))
    return x


def jpeg_subset_(x: torch.Tensor, take: torch.Tensor, quality: torch.Tensor) -> torch.Tensor:
    """K10 on ``x`` (N, H, W, 3) float32 in place: each frame whose bool
    ``take`` (N,) fired becomes its JPEG at ``quality`` (N,) float32; returns
    ``x``. CPU tensors take `jpeg_subset_plain_`; CUDA tensors launch the
    kernel or raise."""
    if not x.is_cuda:
        return jpeg_subset_plain_(x, take, quality)
    kernels.require_cuda(x, "jpeg_subset_", torch.float32, (None, None, None, 3))
    n, h, w, _ = x.shape
    kernels.require_cuda(take, "jpeg_subset_ take", torch.bool, (n,))
    kernels.require_cuda(quality, "jpeg_subset_ quality", torch.float32, (n,))
    _check_hw(h, w)
    if n == 0:
        return x
    err = kernels.lib("jpeg").fac_jpeg_subset(
        kernels.ptr(x), kernels.ptr(take), kernels.ptr(quality), n, h, w,
        kernels.stream_ptr(x.device))
    kernels.check(err, "jpeg")
    jpeg_subset_.launches += 1
    return x


jpeg_subset_.launches = 0

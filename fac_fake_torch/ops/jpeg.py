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

`jpeg_compress_plain` is that arithmetic in torch, every sum in one written
order (`_over_rows`, `_over_cols`, `_subsample`): the CPU path and the
oracle. `jpeg_subset_` is the augmentation's step: on a CPU tensor the plain
version on the taken frames; on a CUDA tensor one launch of K10
(`csrc/jpeg.cu` `jpeg_bands`: a persistent grid that finds the taken frames
on the card and walks their 16-row bands in chunks of at most 16 MCUs,
`band_chunks`) that adds one to ``jpeg_subset_.launches``, or it raises.

Frames are float32 or bfloat16. The bf16 mode is JAX's bf16 chain (:707,
``jpeg_compress`` on bf16 frames, ``.astype(bf16)``), whose steps the plain
version spells out (`ycbcr_bf16`, `_subsample`, `_blocks`): Y, Cb, Cr in
bf16 arithmetic (JAX's Python-float constants are weak-typed, so each is
rounded to bf16 and each product and sum is a bf16 op); the chroma 2×2
mean summed in fp32 and returned in bf16; ``block − 128`` in bf16; then the
DCTs, the quantization and ``_ycbcr_to_rgb`` in fp32, as JAX's fp32
``_dct8`` einsums promote them; the result rounded to bf16. K10's bf16 mode
does the same operations, so it equals the plain version bit for bit. JAX's
own bf16 values on XLA:CPU are not held to these roundings (XLA may keep a
fused bf16 chain in fp32), so the tests hold the bf16 plain version to JAX
within a measured bound (`tests/test_torch_bf16_kernels.py`).

Numbers: the kernel does the plain version's fp32 operations in its order,
so the two are equal bit for bit. It divides by a table entry or by 255 as
a reciprocal product and one residual step, which gives IEEE's quotient
for every float (`division_check` shows it on the card). JAX's einsums sum
in another order, so against JAX a coefficient within float32 noise of a
rounding boundary (``k + 0.5`` in units of its table entry) can round the
other way and move its whole block. `near_ties` finds those blocks by a
float64 recomputation of ``coef / table`` (within 1e-4 of a boundary);
outside them the two agree to 2e-5 on the [0, 1] scale (`JPEG_TOL`).
"""
from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

from fac_fake_torch import kernels
from fac_fake_torch.ops.augment import rgb_to_ycbcr, ycbcr_to_rgb

JPEG_TOL = 2e-5          # the plain version vs JAX or float64, outside near-tie blocks
NEAR_TIE = 1e-4          # |coef/table − (k + 0.5)| below this: a near-tie block
MAX_CHUNK_MCUS = 16      # K10's work item: a 16-row band of at most this many MCUs

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
    """(N, H, W) → (N, H/8, W/8, 8, 8) blocks of ``plane − 128`` (a bf16
    plane: the difference rounded to bf16, then fp32 for the DCT)."""
    n, h, w = plane.shape
    b = plane - 128.0
    if b.dtype == torch.bfloat16:
        b = b.float()
    return b.reshape(n, h // 8, 8, w // 8, 8).permute(0, 1, 3, 2, 4)


def _over_rows(m: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The contraction over a block's rows, ``out[..., i, j] = Σ_k m[i, k] ·
    b[..., k, j]``, summed k = 0 to 7 left to right, each product and each
    sum its own rounded op: K10's order."""
    acc = m[:, 0, None] * b[..., 0:1, :]
    for k in range(1, 8):
        acc = acc + m[:, k, None] * b[..., k:k + 1, :]
    return acc


def _over_cols(a: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """The contraction over a block's columns, ``out[..., i, j] = Σ_k
    a[..., i, k] · m[j, k]``, in the same order."""
    acc = a[..., 0:1] * m[:, 0]
    for k in range(1, 8):
        acc = acc + a[..., k:k + 1] * m[:, k]
    return acc


def _coefs(plane: torch.Tensor) -> torch.Tensor:
    """``D · block · Dᵀ``: over the rows, then over the columns."""
    blocks = _blocks(plane)
    d = dct8(blocks.device, blocks.dtype)
    return _over_cols(_over_rows(d, blocks), d)


def _dct_quantize(plane: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """(N, H, W) in [0, 255] → its blockwise DCT-quantized reconstruction."""
    n, h, w = plane.shape
    t = table[:, None, None]
    coef = _coefs(plane)
    dt = dct8(coef.device, coef.dtype).t()
    coef = torch.round(coef / t) * t
    rec = _over_cols(_over_rows(dt, coef), dt)       # Dᵀ · q · D, in the same order
    return rec.permute(0, 1, 3, 2, 4).reshape(n, h, w) + 128.0


def _subsample(c: torch.Tensor) -> torch.Tensor:
    """The mean of each 2×2 cell, ``((c00 + c01) + c10) + c11`` divided by a
    tensor 4 (K10's order); a bf16 plane's in fp32, rounded to bf16 (JAX's
    ``mean`` of bf16)."""
    if c.dtype == torch.bfloat16:
        return _subsample(c.float()).to(c.dtype)
    n, h, w = c.shape
    q = c.reshape(n, h // 2, 2, w // 2, 2)
    s = ((q[:, :, 0, :, 0] + q[:, :, 0, :, 1]) + q[:, :, 1, :, 0]) + q[:, :, 1, :, 1]
    return s / torch.full((1,), 4.0, device=c.device, dtype=c.dtype)


def band_chunks(h: int, w: int) -> tuple:
    """K10's work items a frame: (16-row bands, chunks a band, MCUs a
    chunk). Each band is cut across into the fewest chunks of at most
    MAX_CHUNK_MCUS MCUs, as even as they come; the last chunk has
    ``w / 16 − (chunks − 1) · mcus`` MCUs, at least one."""
    _check_hw(h, w)
    mcu_w = w // 16
    mcus = -(-mcu_w // -(-mcu_w // MAX_CHUNK_MCUS))
    return h // 16, -(-mcu_w // mcus), mcus


def _check_hw(h: int, w: int) -> None:
    if h % 16 or w % 16:
        raise ValueError(f"JPEG compression needs H and W multiples of 16, got {h}x{w}")


def ycbcr_bf16(img: torch.Tensor) -> tuple:
    """JAX's `_rgb_to_ycbcr` on bf16 frames: every constant rounded to bf16
    and every product and sum a bf16 op, left to right."""
    c = lambda v: torch.tensor(v, dtype=img.dtype, device=img.device)
    r, g, b = img[..., 0] * 255.0, img[..., 1] * 255.0, img[..., 2] * 255.0
    y = c(0.299) * r + c(0.587) * g + c(0.114) * b
    cb = c(-0.168736) * r - c(0.331264) * g + c(0.5) * b + 128.0
    cr = c(0.5) * r - c(0.418688) * g - c(0.081312) * b + 128.0
    return y, cb, cr


def jpeg_compress_plain(imgs: torch.Tensor, quality: torch.Tensor) -> torch.Tensor:
    """K10's plain version: (N, H, W, 3) float32 or bfloat16 in [0, 1] and
    (N,) float qualities → the compressed frames, a new tensor of ``imgs``'s
    dtype."""
    _check_hw(imgs.shape[1], imgs.shape[2])
    bf16 = imgs.dtype == torch.bfloat16
    y, cb, cr = (ycbcr_bf16 if bf16 else rgb_to_ycbcr)(imgs)
    q = quality.to(torch.float32 if bf16 else imgs.dtype)
    lq = quality_table(LUMA_Q, q)
    cq = quality_table(CHROMA_Q, q)

    def chroma(c):
        rec = _dct_quantize(_subsample(c), cq)
        return rec.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)

    return ycbcr_to_rgb(_dct_quantize(y, lq), chroma(cb), chroma(cr)).to(imgs.dtype)


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


def division_check(device) -> int:
    """K10's divisions (`csrc/jpeg.cu` ``quantize`` and ``unit``: a
    reciprocal product and one residual step) against the plain version's
    IEEE arithmetic on the card, over every float x (all 2^32 bit patterns):
    ``rint(x / t) · t`` for each table entry t = 1..255 and
    ``clamp(x / 255, 0, 1)``. Returns how many results differ in any bit (a
    NaN for a NaN counts as equal); 0 when K10 divides as the plain version
    does."""
    bad = torch.zeros(1, dtype=torch.int64, device=device)
    kernels.require_cuda(bad, "division_check")
    kernels.check(kernels.lib("jpeg").fac_jpeg_div_check(
        kernels.ptr(bad), kernels.stream_ptr(bad.device)), "jpeg div_check")
    return int(bad.item())


def jpeg_subset_(x: torch.Tensor, take: torch.Tensor, quality: torch.Tensor) -> torch.Tensor:
    """K10 on ``x`` (N, H, W, 3) float32 or bfloat16 in place: each frame
    whose bool ``take`` (N,) fired becomes its JPEG at ``quality`` (N,)
    float32; returns ``x``. CPU tensors take `jpeg_subset_plain_`; CUDA
    tensors (``x`` at a 16-byte aligned address, as every allocation is)
    launch the kernel or raise."""
    if not x.is_cuda:
        return jpeg_subset_plain_(x, take, quality)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"jpeg_subset_: no kernel for {x.dtype} (float32 or bfloat16)")
    kernels.require_cuda(x, "jpeg_subset_", None, (None, None, None, 3))
    n, h, w, _ = x.shape
    kernels.require_cuda(take, "jpeg_subset_ take", torch.bool, (n,))
    kernels.require_cuda(quality, "jpeg_subset_ quality", torch.float32, (n,))
    _, chunks, mcus = band_chunks(h, w)
    if x.data_ptr() % 16:
        # a row segment is 16 · 3 values an MCU: 192 B in fp32, 96 B in bf16,
        # so an aligned x aligns every segment in either dtype
        raise ValueError("jpeg_subset_: expected x at a 16-byte aligned address (its rows "
                         "move by bulk copies)")
    if n == 0:
        return x
    err = kernels.lib("jpeg").fac_jpeg_subset(
        kernels.ptr(x), kernels.ptr(take), kernels.ptr(quality),
        kernels.ptr(dct8(torch.device("cpu"))), n, h, w, chunks, mcus,
        int(x.dtype == torch.bfloat16), kernels.stream_ptr(x.device))
    kernels.check(err, "jpeg")
    jpeg_subset_.launches += 1
    jpeg_subset_.bf16_launches += x.dtype == torch.bfloat16
    return x


jpeg_subset_.launches = 0
jpeg_subset_.bf16_launches = 0

"""CLAHE on the luma channel — kernel K7, the port of `fac_fake_tpu/data/
augment.py:274` `clahe_luma` and of the step of `augment_batch` that runs it
on the CLAHE subset of a batch (:802-811, through `_subset_apply`,
:608-618).

`clahe_luma` takes a batch of (K, H, W, 3) float32 RGB images in [0, 1] and
equalizes each one's luma (JFIF YCbCr, `_rgb_to_ycbcr`) with cv2's CLAHE
math at ``clip_limit`` over a ``grid × grid`` tile grid: per-tile 256-bin
histograms of ``rint(clamp(y, 0, 255))``, clipped at
``max(floor(clip·tile_px/256), 1)`` with cv2's redistribution (the whole-256
batch, then the residual +1 at bins 0, step, 2·step, …), the cumulative sum
scaled to a LUT ``rint(cdf · fp32(255/tile_px))``, and each pixel's value the
bilinear blend of its four nearest tiles' LUTs (the JAX package's padded
block mapping: pixel i lies in band ``(i+py)//th`` at offset ``(i+py)%th``,
blending tiles ``clip(band−1)`` and ``clip(band)`` with weight
``offset/th``, zero in the edge bands), then back to RGB and clipped to
[0, 1]. Where a tile would be odd or smaller than 2 pixels, the grid is 1:
one LUT over the whole image, no blend (JAX's rule for small tiles).

`clahe_subset_` is the chain's step: in place, the first ``k_budget``
images whose ``take`` fired (in index order, as JAX's stable argsort picks
them) get `clahe_luma` of themselves, and every other image keeps its bits;
takers past the budget stay as they are, as in JAX. With ``k_budget = N``
it is JAX's ``where`` branch.

Every count and cumulative sum is an integer below 2²⁴, so exact in fp32 and
in int32; the LUT entries are integers ≤ 255. JAX gathers those entries with
a bf16 one-hot matmul on the TPU, which is exact for them; the plain version
here gathers them, so it computes JAX's values.

Images are float32 or bfloat16. A bf16 image is JAX's bf16 chain (:805-809):
CLAHE runs on ``sub.astype(float32)`` and the result is rounded back to
bf16 (round to nearest even); the plain version does exactly that, and K7's
bf16 mode loads bf16, computes the fp32 mode's values and rounds at the
store. Non-takers keep their bits in either dtype.

On the card both entries are one launch of K7 (`csrc/clahe.cu`: a
thread-block cluster a budget slot that finds its taker on the card, reads
the image once and writes it once), and add one to ``clahe_luma.launches``
(a bf16 launch also to ``clahe_luma.bf16_launches``); they are bit-equal to
`clahe_subset_plain_` and `clahe_luma_plain`. A CPU tensor takes the plain
version.
"""
from __future__ import annotations

import ctypes
import math
from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

from fac_fake_torch import kernels


def clahe_grid(h: int, w: int, grid: int = 8) -> int:
    """The grid that `clahe_luma` runs at for (h, w) images: ``grid``, or 1
    where its tiles would be odd or under 2 pixels. A grid above 1 must
    divide both sides."""
    th, tw = h // grid, w // grid
    if grid > 1 and (th < 2 or tw < 2 or th % 2 or tw % 2):
        return 1
    if h != grid * th or w != grid * tw:
        raise ValueError(f"CLAHE: a {grid}x{grid} grid does not divide {h}x{w} images")
    return grid


def _clip_limit(tile_px: int, clip_limit: float) -> int:
    return max(int(math.floor(clip_limit * tile_px / 256.0)), 1)


def rgb_to_ycbcr(img: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """[0, 1] RGB (..., 3) → Y, Cb, Cr each in [0, 255] (JFIF full range)."""
    r, g, b = img[..., 0] * 255.0, img[..., 1] * 255.0, img[..., 2] * 255.0
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0
    cr = 0.5 * r - 0.418688 * g - 0.081312 * b + 128.0
    return y, cb, cr


def ycbcr_to_rgb(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor) -> torch.Tensor:
    r = y + 1.402 * (cr - 128.0)
    g = y - 0.344136 * (cb - 128.0) - 0.714136 * (cr - 128.0)
    b = y + 1.772 * (cb - 128.0)
    # a tensor divisor: CUDA turns a division by a Python number into a
    # multiply by its reciprocal, JAX and K7 divide
    d255 = torch.full((1,), 255.0, device=y.device)
    return torch.clamp(torch.stack([r, g, b], dim=-1) / d255, 0.0, 1.0)


@lru_cache(maxsize=16)
def _blend_tables(h: int, w: int, grid: int):
    """Per row: the two tile rows a pixel blends and its weight ``wy``; per
    column the same (numpy, fp32 as JAX builds them)."""
    def axis(n):
        t = n // grid
        p = t // 2
        i = np.arange(n)
        band, off = (i + p) // t, (i + p) % t
        t0 = np.clip(band - 1, 0, grid - 1)
        t1 = np.clip(band, 0, grid - 1)
        wt = np.where((band >= 1) & (band <= grid - 1),
                      np.arange(t, dtype=np.float32)[off] / np.float32(t), np.float32(0))
        return t0, t1, wt.astype(np.float32)
    return axis(h), axis(w)


_DTYPES = (torch.float32, torch.bfloat16)


def clahe_luma_plain(imgs: torch.Tensor, clip_limit: float = 2.0,
                     grid: int = 8) -> torch.Tensor:
    """K7's plain version: (K, H, W, 3) float32 or bfloat16 in [0, 1] → the
    same shape and dtype (bf16: the fp32 CLAHE of ``imgs.float()``, rounded
    back)."""
    if imgs.dtype == torch.bfloat16:
        return clahe_luma_plain(imgs.float(), clip_limit, grid).to(imgs.dtype)
    k, h, w, _ = imgs.shape
    dev = imgs.device
    g = clahe_grid(h, w, grid)
    th, tw = h // g, w // g
    tile_px = th * tw
    y, cb, cr = rgb_to_ycbcr(imgs)
    bins = torch.round(torch.clamp(y, 0.0, 255.0)).long()               # (K, H, W)
    rows = torch.arange(h, device=dev) // th
    cols = torch.arange(w, device=dev) // tw
    tile = rows[:, None] * g + cols[None, :]                            # (H, W)
    flat = (torch.arange(k, device=dev)[:, None, None] * (g * g) + tile) * 256 + bins
    hist = torch.bincount(flat.reshape(-1), minlength=k * g * g * 256)
    hist = hist.reshape(k, g * g, 256).float()

    limit = float(_clip_limit(tile_px, clip_limit))
    clipped = torch.clamp(hist, max=limit)
    excess = (hist - clipped).sum(dim=-1, keepdim=True)
    batch = torch.floor(excess / torch.full((1,), 256.0, device=dev))
    resid = excess - batch * 256.0
    step = torch.clamp(torch.floor(torch.full((1,), 256.0, device=dev)
                                   / torch.clamp(resid, min=1.0)), min=1.0)
    b = torch.arange(256, dtype=torch.float32, device=dev)
    resid_cum = torch.where(resid > 0, torch.minimum(torch.floor(b / step) + 1.0, resid),
                            torch.zeros((), device=dev))
    cdf = torch.cumsum(clipped, dim=-1) + batch * (b + 1.0) + resid_cum
    lut = torch.round(cdf * (255.0 / tile_px)).reshape(k, g * g * 256)

    def at(tiles):                            # (H, W) tile ids → (K, H, W) LUT values
        return torch.gather(lut, 1, (tiles * 256 + bins).reshape(k, -1)).reshape(k, h, w)

    if g == 1:
        return ycbcr_to_rgb(at(torch.zeros_like(tile)), cb, cr)
    (y0, y1, wy), (x0, x1, wx) = (tuple(torch.from_numpy(a).to(dev) for a in t)
                                  for t in _blend_tables(h, w, g))
    v0, v1 = at(y0[:, None] * g + x0[None, :]), at(y0[:, None] * g + x1[None, :])
    v2, v3 = at(y1[:, None] * g + x0[None, :]), at(y1[:, None] * g + x1[None, :])
    wy, wx = wy[:, None], wx[None, :]
    out = (v0 * (1 - wy) * (1 - wx) + v1 * (1 - wy) * wx
           + v2 * wy * (1 - wx) + v3 * wy * wx)
    return ycbcr_to_rgb(out, cb, cr)


def clahe_subset_plain_(x: torch.Tensor, take: torch.Tensor, k_budget: int,
                        clip_limit: float = 2.0, grid: int = 8) -> torch.Tensor:
    """K7's plain version: JAX's `_subset_apply` over `clahe_luma_plain`,
    written back into ``x`` with ``index_copy_``."""
    idx = torch.argsort((~take).to(torch.uint8), stable=True)[:k_budget]
    sub = x.index_select(0, idx)
    keep = take.index_select(0, idx)[:, None, None, None]
    return x.index_copy_(0, idx, torch.where(keep, clahe_luma_plain(sub, clip_limit, grid), sub))


def _k7(src: torch.Tensor, dst: torch.Tensor, take, k_budget: int, clip_limit: float,
        grid: int) -> None:
    """One launch of K7 over ``k_budget`` slots (``take`` None: slot s takes
    image s), from ``src`` into ``dst`` (the same tensor in place)."""
    n, h, w, _ = src.shape
    g = clahe_grid(h, w, grid)
    tile_px = (h // g) * (w // g)
    bf16 = src.dtype == torch.bfloat16
    err = kernels.lib("clahe").fac_clahe_subset(
        kernels.ptr(src), kernels.ptr(dst), None if take is None else kernels.ptr(take), n,
        k_budget, h, w, g, _clip_limit(tile_px, clip_limit), ctypes.c_float(255.0 / tile_px),
        int(bf16), kernels.stream_ptr(src.device))
    kernels.check(err, "clahe")
    clahe_luma.launches += 1
    clahe_luma.bf16_launches += bf16


def _require(x: torch.Tensor, what: str) -> None:
    if x.dtype not in _DTYPES:
        raise ValueError(f"{what}: no kernel for {x.dtype} (float32 or bfloat16)")
    kernels.require_cuda(x, what, None, (None, None, None, 3))


def clahe_subset_(x: torch.Tensor, take: torch.Tensor, k_budget: int, clip_limit: float = 2.0,
                  grid: int = 8) -> torch.Tensor:
    """K7 on ``x`` (N, H, W, 3) float32 or bfloat16 in place: `clahe_luma` of
    each of the first ``k_budget`` images whose bool ``take`` (N,) fired;
    returns ``x``. CPU tensors take `clahe_subset_plain_`; CUDA tensors
    launch the kernel or raise."""
    if not x.is_cuda:
        return clahe_subset_plain_(x, take, k_budget, clip_limit, grid)
    _require(x, "clahe_subset_")
    kernels.require_cuda(take, "clahe_subset_ take", torch.bool, (x.shape[0],))
    k_budget = min(k_budget, x.shape[0])
    if k_budget > 0:
        _k7(x, x, take, k_budget, clip_limit, grid)
    return x


def clahe_luma(imgs: torch.Tensor, clip_limit: float = 2.0, grid: int = 8) -> torch.Tensor:
    """K7 on the whole batch, into a new tensor. CPU tensors take
    `clahe_luma_plain`; CUDA tensors launch the kernel or raise."""
    if not imgs.is_cuda:
        return clahe_luma_plain(imgs, clip_limit, grid)
    _require(imgs, "clahe_luma")
    out = torch.empty_like(imgs)
    if imgs.shape[0] > 0:
        _k7(imgs, out, None, imgs.shape[0], clip_limit, grid)
    return out


clahe_luma.launches = 0
clahe_luma.bf16_launches = 0

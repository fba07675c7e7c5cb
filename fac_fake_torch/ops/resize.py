"""`cv2.resize(..., interpolation=cv2.INTER_AREA)` on uint8 HWC, without cv2.

The scoring path resizes twice with INTER_AREA: each frame to the detector's
128-px tile scale (`detect/extractor.py make_tiles`) and each face crop to
224² (`infer/predictor.py gather_crops`). The machine with the card has no
cv2, so the port reproduces OpenCV's three INTER_AREA code paths
(`modules/imgproc/src/resize.cpp`) in numpy, on the host:

* **integer downscale** on both axes (`resizeAreaFast`): the mean of each
  ``sx × sy`` block, ``sum · (1/area)`` rounded half to even — except 2×2,
  whose SIMD path rounds ``(sum + 2) >> 2``;
* **fractional downscale** (`resizeArea`): area-coverage weights from
  `computeResizeAreaTab`, accumulated in float32 in OpenCV's order (along x
  per source row, then rows into each output row), rounded half to even;
* **upscale on either axis** (the bilinear path with INTER_AREA's own
  coefficients): 11-bit fixed-point weights, an exact integer horizontal
  pass and the SIMD vertical pass ``((S0>>4)·b0 >> 16) + ((S1>>4)·b1 >> 16)``
  rounded by ``+2 >> 2``, applied to every pixel.

`tests/test_torch_ops.py` holds the result equal to cv2's, pixel for pixel,
at the sizes the path sees and at random sizes.

The MTCNN cascade resamples on the device instead, bilinearly, as the JAX
package does: `resize_bilinear` (its image pyramid) and
`crop_resize_bilinear` (its 24² and 48² stage patches), below.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

_COEF_BITS = 11
_COEF_SCALE = 1 << _COEF_BITS


def resize_area(img: np.ndarray, dsize: Tuple[int, int]) -> np.ndarray:
    """img (H, W, C) or (H, W) uint8; dsize = (width, height) as cv2 takes it."""
    src = np.asarray(img)
    if src.dtype != np.uint8:
        raise TypeError(f"resize_area takes uint8, got {src.dtype}")
    gray = src.ndim == 2
    if gray:
        src = src[:, :, None]
    h, w = src.shape[:2]
    dw, dh = int(dsize[0]), int(dsize[1])
    if dw <= 0 or dh <= 0 or h <= 0 or w <= 0:
        raise ValueError(f"bad resize {w}x{h} -> {dw}x{dh}")
    if (dw, dh) == (w, h):
        out = src.copy()
    else:
        inv_x, inv_y = dw / w, dh / h
        scale_x, scale_y = 1.0 / inv_x, 1.0 / inv_y
        if scale_x >= 1 and scale_y >= 1:
            ix, iy = int(round(scale_x)), int(round(scale_y))
            if (abs(scale_x - ix) < np.finfo(np.float64).eps
                    and abs(scale_y - iy) < np.finfo(np.float64).eps):
                out = _area_fast(src, ix, iy, dw, dh)
            else:
                out = _area(src, scale_x, scale_y, dw, dh)
        else:
            out = _linear_area_coeffs(src, scale_x, scale_y, inv_x, inv_y,
                                      dw, dh)
    return out[:, :, 0] if gray else out


def _area_fast(src, sx: int, sy: int, dw: int, dh: int) -> np.ndarray:
    c = src.shape[2]
    blocks = src[:dh * sy, :dw * sx].reshape(dh, sy, dw, sx, c)
    total = blocks.sum(axis=(1, 3), dtype=np.int64)
    if sx == 2 and sy == 2:
        return ((total + 2) >> 2).astype(np.uint8)
    scale = np.float32(1.0) / np.float32(sx * sy)
    vals = np.rint(total.astype(np.float32) * scale)
    return np.clip(vals, 0, 255).astype(np.uint8)


def _area_tab(ssize: int, dsize: int, scale: float):
    """`computeResizeAreaTab` as a padded (dsize, K) table of source indices
    and float32 weights (zero weight pads the ragged rows)."""
    rows = []
    for dx in range(dsize):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, ssize - fsx1)
        sx1, sx2 = math.ceil(fsx1), math.floor(fsx2)
        sx2 = min(sx2, ssize - 1)
        sx1 = min(sx1, sx2)
        ent = []
        if sx1 - fsx1 > 1e-3:
            ent.append((sx1 - 1, np.float32((sx1 - fsx1) / cell)))
        for s in range(sx1, sx2):
            ent.append((s, np.float32(1.0 / cell)))
        if fsx2 - sx2 > 1e-3:
            ent.append((sx2, np.float32(min(min(fsx2 - sx2, 1.0), cell) / cell)))
        rows.append(ent)
    k = max(len(r) for r in rows)
    idx = np.zeros((dsize, k), np.int64)
    wt = np.zeros((dsize, k), np.float32)
    for d, ent in enumerate(rows):
        for j, (s, a) in enumerate(ent):
            idx[d, j], wt[d, j] = s, a
    return idx, wt


def _area(src, scale_x: float, scale_y: float, dw: int, dh: int) -> np.ndarray:
    h, w, _ = src.shape
    xi, xw = _area_tab(w, dw, scale_x)
    yi, yw = _area_tab(h, dh, scale_y)
    # x pass per source row: buf[dx] += S[sx]·alpha, in table order. Done
    # on the (W, H, C) transpose, so each step gathers whole rows (3-4×
    # faster than gathering columns, same values)
    st = np.ascontiguousarray(src.transpose(1, 0, 2))
    buf = np.zeros((dw, h, src.shape[2]), np.float32)
    for j in range(xi.shape[1]):
        buf = buf + st[xi[:, j]] * xw[:, j, None, None]
    buf = np.ascontiguousarray(buf.transpose(1, 0, 2))
    # y pass: sum = beta0·buf[sy0]; sum += beta_j·buf[sy_j]
    out = buf[yi[:, 0]] * yw[:, 0, None, None]
    for j in range(1, yi.shape[1]):
        out = out + buf[yi[:, j]] * yw[:, j, None, None]
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def _linear_coeffs(ssize: int, dsize: int, scale: float, inv: float):
    """Source index and 11-bit fixed-point weights per output position, from
    INTER_AREA's bilinear coefficients."""
    d = np.arange(dsize)
    s0 = np.floor(d * scale).astype(np.int64)
    f = ((d + 1) - (s0 + 1) * inv).astype(np.float32)
    f = np.where(f <= 0, np.float32(0), f - np.floor(f)).astype(np.float32)
    # clamp at the far edge the way the coefficient loop does
    edge = s0 >= ssize - 1
    f = np.where(edge, np.float32(0), f)
    s0 = np.minimum(s0, ssize - 1)
    s1 = np.minimum(s0 + 1, ssize - 1)
    a0 = np.rint((np.float32(1) - f) * np.float32(_COEF_SCALE)).astype(np.int64)
    a1 = np.rint(f * np.float32(_COEF_SCALE)).astype(np.int64)
    return s0, s1, a0, a1


def _linear_area_coeffs(src, scale_x, scale_y, inv_x, inv_y,
                        dw: int, dh: int) -> np.ndarray:
    h, w, _ = src.shape
    x0, x1, ax0, ax1 = _linear_coeffs(w, dw, scale_x, inv_x)
    y0, y1, by0, by1 = _linear_coeffs(h, dh, scale_y, inv_y)
    s = src.astype(np.int64)
    rows = s[:, x0, :] * ax0[None, :, None] + s[:, x1, :] * ax1[None, :, None]
    r0 = rows[y0] >> 4
    r1 = rows[y1] >> 4
    v = ((r0 * by0[:, None, None]) >> 16) + ((r1 * by1[:, None, None]) >> 16)
    return np.clip((v + 2) >> 2, 0, 255).astype(np.uint8)


# --- bilinear resampling on the device (the MTCNN cascade's) -----------------
#
# The port of `fac_fake_tpu/ops/resize.py` `_interp_matrix`,
# `crop_resize_bilinear` and `resize_bilinear`. JAX builds each axis's
# (out, src) weight matrix and multiplies by it; every row holds two
# non-zero weights, so the same values come from two taps gathered with the
# same weights, without the matrices' zeros. Sample centres are half-pixel,
# ``start + (o + 0.5)·(stop − start)/out − 0.5``, clipped into
# ``[0, src − 1]``: a box partly out of the frame edge-clamps (unlike
# `F.interpolate` / `grid_sample`). fp32 on the caller's device; every
# divisor is a tensor, since CUDA divides by a host scalar as a multiply by
# its reciprocal.


def _taps(out_size: int, start: torch.Tensor, stop: torch.Tensor, src_size: int):
    """Per row of ``start``/``stop`` (…,): the two source indices (…, out)
    of each output sample and their weights, JAX's ``_interp_matrix`` rows."""
    dev = start.device
    scale = (stop - start) / torch.tensor(float(out_size), device=dev)
    o = torch.arange(out_size, dtype=torch.float32, device=dev) + 0.5
    centers = (start[..., None] + o * scale[..., None]) - 0.5
    centers = torch.clamp(centers, 0.0, src_size - 1.0)
    lo = torch.floor(centers)
    frac = centers - lo
    lo = torch.where(torch.isnan(lo), 0.0, lo)   # a NaN box: NaN weights, as JAX's
    hi = torch.clamp(lo + 1, max=src_size - 1.0)
    return lo.long(), hi.long(), 1.0 - frac, frac


def _sample(at, ty, tx) -> torch.Tensor:
    """The y pass, then the x pass, as JAX's two products: ``at(yi, xi)``
    gathers the pixels at y taps (…, oh) and x taps (…, ow) as (…, oh, ow, C)."""
    ylo, yhi, wy_lo, wy_hi = ty
    xlo, xhi, wx_lo, wx_hi = tx
    wyl, wyh = wy_lo[..., :, None, None], wy_hi[..., :, None, None]
    col_lo = at(ylo, xlo) * wyl + at(yhi, xlo) * wyh
    col_hi = at(ylo, xhi) * wyl + at(yhi, xhi) * wyh
    return col_lo * wx_lo[..., None, :, None] + col_hi * wx_hi[..., None, :, None]


def crop_resize_bilinear(frame: torch.Tensor, boxes: torch.Tensor,
                         out_hw: Tuple[int, int] = (224, 224)) -> torch.Tensor:
    """frame (H, W, C), boxes (N, 4) [ymin, xmin, ymax, xmax] in pixels →
    (N, out_h, out_w, C) fp32."""
    h, w, _ = frame.shape
    b = boxes.to(torch.float32)
    ty = _taps(out_hw[0], b[:, 0], b[:, 2], h)
    tx = _taps(out_hw[1], b[:, 1], b[:, 3], w)
    fr = frame.to(torch.float32)
    return _sample(lambda yi, xi: fr[yi[:, :, None], xi[:, None, :]], ty, tx)


def resize_bilinear(images: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """(B, H, W, C) → (B, oh, ow, C) fp32, the whole image resampled."""
    _, h, w, _ = images.shape
    zero = torch.zeros((), dtype=torch.float32, device=images.device)
    ty = _taps(out_hw[0], zero, zero + h, h)
    tx = _taps(out_hw[1], zero, zero + w, w)
    x = images.to(torch.float32)
    return _sample(lambda yi, xi: x[:, yi[:, None], xi[None, :]], ty, tx)

"""Greedy hard NMS over a padded candidate set: kernel K8 and its plain version.

The port of `fac_fake_tpu/detect/mtcnn.py` `hard_nms` (with `_iou`), the
MTCNN cascade's NMS: a fixed-length scan of ``max_out`` steps over ``N``
candidates with a validity mask. Each step takes the argmax of the live
scores (`jnp.argmax` order: NaN first, then the largest, ties to the lower
index), records it with ``keep = score > -inf``, and sets the seed and every
box whose IoU with it is above ``iou_thresh`` to -inf. IoU uses +1 areas and
a ``union`` or ``min`` denominator, in IEEE fp32 in JAX's order. Once no
live score is left, each step records index 0, not kept.

`hard_nms` takes one call, boxes (N, 4) x1y1x2y2, or G independent calls of
equal N, boxes (G, N, 4); a frame's per-scale pyramid calls are one launch.
For CUDA tensors it launches K8 (`csrc/hard_nms.cu`, one CTA a call) or
raises; `hard_nms_plain`, the scan step by step in PyTorch, is the CPU path
and the oracle, bit-equal to the kernel.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Tuple

import torch

from fac_fake_torch import kernels

MODES = ("union", "min")
# K8 holds a call in one CTA: at most 512 threads, 8 candidates a thread
MAX_CANDIDATES = 512 * 8
# the video scorer detects on a thread pool: the count is kept under a lock
_count_lock = threading.Lock()


def _check(boxes, scores, valid, mode: str, max_out: int) -> None:
    if mode not in MODES:
        raise ValueError(f"hard_nms mode {mode!r}: expected one of {MODES}")
    if max_out < 0:
        raise ValueError(f"hard_nms max_out {max_out} < 0")
    if boxes.dim() not in (2, 3) or boxes.shape[-1] != 4 or boxes.shape[-2] < 1:
        raise ValueError(f"hard_nms boxes: expected (N, 4) or (G, N, 4) with N >= 1, "
                         f"got {tuple(boxes.shape)}")
    if scores.shape != boxes.shape[:-1] or valid.shape != boxes.shape[:-1]:
        raise ValueError(f"hard_nms scores {tuple(scores.shape)} / valid "
                         f"{tuple(valid.shape)} do not match boxes {tuple(boxes.shape)}")


def _argmax(s: torch.Tensor) -> torch.Tensor:
    """Per row, `jnp.argmax`'s index: the first NaN, else the first maximum."""
    nan = torch.isnan(s)
    first_nan = nan.to(torch.uint8).argmax(dim=1)
    first_max = torch.where(nan, float("-inf"), s).argmax(dim=1)
    return torch.where(nan.any(dim=1), first_nan, first_max)


def hard_nms_plain(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
                   iou_thresh: float = 0.7, mode: str = "union",
                   max_out: int = 32) -> Tuple[torch.Tensor, torch.Tensor]:
    """K8's plain version: JAX's scan, step by step. Returns idx (…, max_out)
    int64 and keep (…, max_out) bool, with the leading G of batched calls."""
    _check(boxes, scores, valid, mode, max_out)
    single = boxes.dim() == 2
    if single:
        boxes, scores, valid = boxes[None], scores[None], valid[None]
    g, n = scores.shape
    dev = boxes.device
    neg_inf = torch.tensor(float("-inf"), device=dev)
    zero = torch.zeros((), device=dev)
    eps = torch.tensor(1e-12, dtype=torch.float32, device=dev)
    thr = torch.tensor(iou_thresh, dtype=torch.float32, device=dev)
    x1, y1, x2, y2 = boxes.unbind(-1)
    areas = ((x2 - x1) + 1) * ((y2 - y1) + 1)
    rows = torch.arange(g, device=dev)
    cols = torch.arange(n, device=dev)
    s = torch.where(valid, scores, neg_inf)
    idx = torch.empty((g, max_out), dtype=torch.long, device=dev)
    keep = torch.empty((g, max_out), dtype=torch.bool, device=dev)
    for step in range(max_out):
        i = _argmax(s)
        idx[:, step] = i
        keep[:, step] = s[rows, i] > neg_inf
        b = boxes[rows, i][:, :, None]                       # (g, 4, 1): the seeds
        ix1 = torch.maximum(b[:, 0], x1)
        iy1 = torch.maximum(b[:, 1], y1)
        ix2 = torch.minimum(b[:, 2], x2)
        iy2 = torch.minimum(b[:, 3], y2)
        inter = torch.maximum(zero, (ix2 - ix1) + 1) * torch.maximum(zero, (iy2 - iy1) + 1)
        area1 = areas[rows, i][:, None]
        denom = torch.minimum(area1, areas) if mode == "min" else (area1 + areas) - inter
        sup = (inter / torch.maximum(denom, eps) > thr) | (cols[None] == i[:, None])
        s = torch.where(sup, neg_inf, s)
    return (idx[0], keep[0]) if single else (idx, keep)


def hard_nms(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
             iou_thresh: float = 0.7, mode: str = "union",
             max_out: int = 32) -> Tuple[torch.Tensor, torch.Tensor]:
    """K8's wrapper: the plain version for CPU tensors; for CUDA tensors one
    kernel launch (one CTA a call) or an exception. boxes (N, 4) or
    (G, N, 4) fp32, scores fp32 and valid bool of the leading shape."""
    if not boxes.is_cuda:
        return hard_nms_plain(boxes, scores, valid, iou_thresh, mode, max_out)
    _check(boxes, scores, valid, mode, max_out)
    lead = boxes.shape[:-1]
    g, n = (1, lead[0]) if len(lead) == 1 else lead
    kernels.require_cuda(boxes, "hard_nms boxes", torch.float32)
    kernels.require_cuda(scores, "hard_nms scores", torch.float32)
    kernels.require_cuda(valid, "hard_nms valid", torch.bool)
    if n > MAX_CANDIDATES:
        raise ValueError(f"hard_nms: {n} candidates do not fit one CTA "
                         f"(at most {MAX_CANDIDATES})")
    idx = torch.empty((*lead[:-1], max_out), dtype=torch.long, device=boxes.device)
    keep = torch.empty((*lead[:-1], max_out), dtype=torch.bool, device=boxes.device)
    err = kernels.lib("hard_nms").fac_hard_nms(
        kernels.ptr(boxes), kernels.ptr(scores), kernels.ptr(valid), g, n, max_out,
        ctypes.c_float(iou_thresh), int(mode == "min"), kernels.ptr(idx), kernels.ptr(keep),
        kernels.stream_ptr(boxes.device))
    kernels.check(err, "hard_nms")
    with _count_lock:
        hard_nms.launches += 1
    return idx, keep


hard_nms.launches = 0

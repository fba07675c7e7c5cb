"""Face extraction: frames → tiles → batched BlazeFace → frame-space
detections → face crops. The port of `fac_fake_tpu/detect/extractor.py`.

  * tiling (`_tile_frames`, `helpers_face_extract_1.py:139-208`): square
    ``min(H, W)`` windows, 3 across for landscape, 1 for portrait; one
    INTER_AREA resize per frame (`ops/resize.py`, on the host);
  * detection + anchor decode as one batch over frames × tiles;
  * tile→frame affine, per-frame weighted NMS over all tiles' anchors and
    the 2×-top margin (`_add_margin_to_detections`, `:280-299`): kernel K1
    (`csrc/frame_detections.cu`) on the card, one launch per chunk of
    frames, with `frame_detections_plain` as its plain version;
  * crop pixels are sliced from the original frames on the host.
"""
from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from fac_fake_torch import kernels
from fac_fake_torch.detect.blazeface import (IOU_THRESH, NUM_ANCHORS, BlazeFace,
                                             weighted_nms_plain)
from fac_fake_torch.ops.resize import resize_area

MAX_FACES = 8
MARGIN = 0.2
# K1 holds a frame in one CTA: 512 threads keep 6 anchors each in registers,
# and the anchors' 68-byte rows fill 204 KiB of its shared memory
K1_MAX_ANCHORS = 512 * 6


def tile_geometry(h: int, w: int) -> Tuple[int, int, List[Tuple[int, int]]]:
    """split_size, num_tiles, [(y_off, x_off)] — `_tile_frames:187-191`."""
    split = min(h, w)
    x_step = (w - split) // 2
    num_h = 3 if w > h else 1
    offsets = [(0, x_step * i) for i in range(num_h)]
    return split, num_h, offsets


def make_tiles(frames: np.ndarray, target: int = 128) -> Tuple[np.ndarray, int, np.ndarray]:
    """(F, H, W, 3) uint8 → (F·T, 128, 128, 3) uint8 + split_size + offsets.
    One INTER_AREA resize per frame, then the T overlapping tiles are crops
    of the resized frame (as the JAX package does)."""
    f, h, w, _ = frames.shape
    split, num_t, offsets = tile_geometry(h, w)
    scale = target / split
    rh = max(target, int(round(h * scale)))
    rw = max(target, int(round(w * scale)))
    tiles = np.empty((f * num_t, target, target, 3), np.uint8)
    i = 0
    for fi in range(f):
        small = resize_area(frames[fi], (rw, rh))
        for (y, x) in offsets:
            ys = min(int(round(y * scale)), rh - target)
            xs = min(int(round(x * scale)), rw - target)
            tiles[i] = small[ys:ys + target, xs:xs + target]
            i += 1
    return tiles, split, np.asarray(offsets, np.float32)


def _col_offsets(offsets: torch.Tensor, n: int) -> torch.Tensor:
    """(T, 2) [y, x] tile offsets → (N, 16) per anchor and coordinate column:
    box columns even = y, odd = x; keypoint columns even = x, odd = y."""
    a = n // offsets.shape[0]
    y = offsets[:, 0].repeat_interleave(a)[:, None]
    x = offsets[:, 1].repeat_interleave(a)[:, None]
    col = torch.arange(16, device=offsets.device)
    is_y = torch.where(col < 4, col % 2 == 0, col % 2 == 1)
    return torch.where(is_y, y, x)


def frame_detections_plain(dets: torch.Tensor, valid: torch.Tensor, split: float = 1.0,
                           offsets: Optional[torch.Tensor] = None,
                           frame_hw: Tuple[float, float] = (0.0, 0.0),
                           max_out: int = MAX_FACES, iou_thresh: float = IOU_THRESH,
                           margin: Optional[float] = MARGIN):
    """K1's plain version. dets (F, T·A, 17) tile detections, valid (F, T·A)
    → faces (F, max_out, 17) in frame coordinates and mask (F, max_out).
    ``margin=None`` skips the margin clamp (plain weighted NMS)."""
    n = dets.shape[1]
    if offsets is None:
        offsets = torch.zeros((1, 2), dtype=torch.float32, device=dets.device)
    coords = dets[..., :16] * split + _col_offsets(offsets, n)
    faces, mask = weighted_nms_plain(coords, dets[..., 16], valid, max_out, iou_thresh)
    if margin is not None:
        fh, fw = frame_hw
        off = torch.round(margin * (faces[..., 2] - faces[..., 0]))
        faces = faces.clone()
        faces[..., 0] = torch.clamp(faces[..., 0] - off * 2, min=0.0)
        faces[..., 1] = torch.clamp(faces[..., 1] - off, min=0.0)
        faces[..., 2] = torch.clamp(faces[..., 2] + off, max=fh)
        faces[..., 3] = torch.clamp(faces[..., 3] + off, max=fw)
    return faces, mask


def frame_detections(dets: torch.Tensor, valid: torch.Tensor, split: float = 1.0,
                     offsets: Optional[torch.Tensor] = None,
                     frame_hw: Tuple[float, float] = (0.0, 0.0),
                     max_out: int = MAX_FACES, iou_thresh: float = IOU_THRESH,
                     margin: Optional[float] = MARGIN):
    """K1's wrapper: the plain version for CPU tensors; for CUDA tensors one
    kernel launch (one CTA per frame) or an exception."""
    if not dets.is_cuda:
        return frame_detections_plain(dets, valid, split, offsets, frame_hw,
                                      max_out, iou_thresh, margin)
    f, n, _ = dets.shape
    if offsets is None:
        offsets = torch.zeros((1, 2), dtype=torch.float32, device=dets.device)
    t = offsets.shape[0]
    kernels.require_cuda(dets, "frame_detections dets", torch.float32, (None, None, 17))
    kernels.require_cuda(valid, "frame_detections valid", torch.bool, (f, n))
    kernels.require_cuda(offsets, "frame_detections offsets", torch.float32, (None, 2))
    if n % t or n > K1_MAX_ANCHORS:
        raise ValueError(f"frame_detections: {n} anchors over {t} tiles does not "
                         f"fit one CTA (at most {K1_MAX_ANCHORS} anchors a frame)")
    faces = torch.empty((f, max_out, 17), dtype=torch.float32, device=dets.device)
    mask = torch.empty((f, max_out), dtype=torch.bool, device=dets.device)
    fh, fw = frame_hw
    err = kernels.lib("frame_detections").fac_frame_detections(
        kernels.ptr(dets), kernels.ptr(valid), kernels.ptr(offsets),
        ctypes.c_float(split), ctypes.c_float(fh), ctypes.c_float(fw),
        f, t, n // t, max_out, ctypes.c_float(iou_thresh),
        ctypes.c_float(0.0 if margin is None else margin), int(margin is not None),
        kernels.ptr(faces), kernels.ptr(mask), kernels.stream_ptr(dets.device))
    kernels.check(err, "frame_detections")
    frame_detections.launches += 1
    return faces, mask


frame_detections.launches = 0


def _frame_detections(dets, valid, split: float, offsets, frame_hw,
                      num_tiles: int, margin: float = MARGIN):
    """The JAX signature: (F·T, 896, 17) tile detections → per-frame
    (F, MAX_FACES, 17) in frame coordinates with margins, plus the mask."""
    dets = torch.as_tensor(dets)
    valid = torch.as_tensor(valid, device=dets.device)
    f = dets.shape[0] // num_tiles
    offsets = torch.as_tensor(np.asarray(offsets, np.float32), device=dets.device)
    return frame_detections(
        dets.reshape(f, num_tiles * NUM_ANCHORS, 17).contiguous(),
        valid.reshape(f, num_tiles * NUM_ANCHORS).contiguous(),
        float(split), offsets, (float(frame_hw[0]), float(frame_hw[1])),
        MAX_FACES, IOU_THRESH, margin)


class FaceExtractor:
    """frames → face crops with BlazeFace (the packaged weights unless a
    detector is given)."""

    def __init__(self, detector: Optional[BlazeFace] = None):
        self.detector = detector or BlazeFace.from_packaged_assets()

    def process_frames(self, frames: np.ndarray, idxs: Optional[Sequence[int]] = None):
        """Returns the reference's list-of-frame-dict structure
        (video_idx omitted): frame_idx, frame_w/h, faces, scores, boxes."""
        f, h, w, _ = frames.shape
        idxs = list(range(f)) if idxs is None else idxs
        tiles, split, offsets = make_tiles(frames)
        dets, valid = self.detector.predict_on_batch(tiles, apply_nms=False)
        faces, mask = _frame_detections(dets, valid, split, offsets, (h, w), len(offsets))
        faces = faces.cpu().numpy()
        mask = mask.cpu().numpy()

        out = []
        for i in range(f):
            crops, scores, boxes = [], [], []
            for j in range(MAX_FACES):
                if not mask[i, j]:
                    continue
                ymin, xmin, ymax, xmax = faces[i, j, :4].astype(int)
                crop = frames[i, ymin:ymax, xmin:xmax]
                if crop.size:
                    crops.append(crop)
                    scores.append(float(faces[i, j, 16]))
                    boxes.append((int(ymin), int(xmin), int(ymax), int(xmax)))
            out.append({"frame_idx": idxs[i], "frame_w": w, "frame_h": h,
                        "faces": crops, "scores": scores, "boxes": boxes})
        return out

"""Detector-agreement harness: bound what a face-detector swap does — the
port of `fac_fake_tpu/detect/agreement.py`.

The reference's predict path runs dlib/face_recognition
(`cvit_prediction.py:106-121,189`) while its preprocessing path ships
BlazeFace (`:124-147`) and MTCNN (`:86-102`). Over identical sampled frames
this reports per-video box counts, best-match IoU between the two
detectors' boxes, the fraction of each detector's boxes the other matches,
and the end-to-end score delta through the SAME CViT.

On the card BlazeFace's per-frame NMS is kernel K1 and MTCNN's four NMS
calls a frame are kernel K8. The repository holds no pretrained MTCNN
weights, so the default cascade is seeded: agreement against it measures
the harness and the BlazeFace side. Pass a cascade from
`detect/mtcnn.load_mtcnn_npz` to measure the real one.

The reports read frames through any ``reader`` with ``frame_count`` and
``stream_frames_at_indices`` (default the cv2 `VideoReader`).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Optional, Sequence

import numpy as np

from fac_fake_torch.core.device import DeviceLike


def box_iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """IoU of every box pair. Boxes are (N, 4) [x1, y1, x2, y2]."""
    a = np.asarray(a, np.float32).reshape(-1, 4)
    b = np.asarray(b, np.float32).reshape(-1, 4)
    if a.shape[0] == 0 or b.shape[0] == 0:
        return np.zeros((a.shape[0], b.shape[0]), np.float32)
    x1 = np.maximum(a[:, None, 0], b[None, :, 0])
    y1 = np.maximum(a[:, None, 1], b[None, :, 1])
    x2 = np.minimum(a[:, None, 2], b[None, :, 2])
    y2 = np.minimum(a[:, None, 3], b[None, :, 3])
    inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
    area_a = np.clip(a[:, 2] - a[:, 0], 0, None) * np.clip(a[:, 3] - a[:, 1], 0, None)
    area_b = np.clip(b[:, 2] - b[:, 0], 0, None) * np.clip(b[:, 3] - b[:, 1], 0, None)
    union = area_a[:, None] + area_b[None, :] - inter
    return np.where(union > 0, inter / union, 0.0).astype(np.float32)


def greedy_match(iou: np.ndarray, thr: float = 0.0) -> List[tuple]:
    """One-to-one matching, highest IoU first: [(i, j, iou), ...]."""
    iou = np.asarray(iou)
    pairs = []
    used_i: set = set()
    used_j: set = set()
    order = np.dstack(np.unravel_index(np.argsort(iou, axis=None)[::-1], iou.shape))[0]
    for i, j in order:
        v = float(iou[i, j])
        if v <= thr:
            break
        if i in used_i or j in used_j:
            continue
        used_i.add(int(i))
        used_j.add(int(j))
        pairs.append((int(i), int(j), v))
    return pairs


def frame_agreement(boxes_a, boxes_b, iou_thr: float = 0.5) -> Dict:
    """Per-frame agreement between two box sets (each (N, 4) x1y1x2y2)."""
    iou = box_iou_matrix(boxes_a, boxes_b)
    pairs = greedy_match(iou, thr=iou_thr)
    return {
        "n_a": int(iou.shape[0]),
        "n_b": int(iou.shape[1]),
        "n_matched": len(pairs),
        "matched_ious": [p[2] for p in pairs],
    }


def aggregate(frames: Sequence[Dict]) -> Dict:
    """Fold per-frame agreement dicts into one video-level record. Undefined
    statistics are None, never NaN, so the report is strict JSON."""
    n_a = sum(f["n_a"] for f in frames)
    n_b = sum(f["n_b"] for f in frames)
    matched = sum(f["n_matched"] for f in frames)
    ious = [v for f in frames for v in f["matched_ious"]]
    return {
        "frames": len(frames),
        "boxes_a": n_a,
        "boxes_b": n_b,
        "matched": matched,
        "recall_a_by_b": matched / n_a if n_a else None,
        "recall_b_by_a": matched / n_b if n_b else None,
        "mean_iou": float(np.mean(ious)) if ious else None,
        "median_iou": float(np.median(ious)) if ious else None,
    }


# ---------------------------------------------------------------------------
# detector adapters: frames (F, H, W, 3) uint8 → list of (N, 4) x1y1x2y2
# ---------------------------------------------------------------------------

def blazeface_boxes_fn(extractor=None, device: DeviceLike = None) -> Callable:
    """The predict path's BlazeFace: tiling, the detector, K1's weighted NMS
    and margins — the boxes the scorer crops (`detect/extractor.py`)."""
    from fac_fake_torch.detect.blazeface import BlazeFace
    from fac_fake_torch.detect.extractor import FaceExtractor
    extractor = extractor or FaceExtractor(BlazeFace.from_packaged_assets(device))

    def fn(frames: np.ndarray) -> List[np.ndarray]:
        out = []
        for fd in extractor.process_frames(frames):
            # extractor boxes are (ymin, xmin, ymax, xmax)
            out.append(np.asarray([(x1, y1, x2, y2) for (y1, x1, y2, x2) in fd["boxes"]],
                                  np.float32).reshape(-1, 4))
        return out
    return fn


def mtcnn_boxes_fn(mtcnn=None, state_dict: Optional[Mapping] = None,
                   device: DeviceLike = None) -> Callable:
    """The MTCNN cascade (`detect/mtcnn.py`, K8 four times a frame); a seeded
    cascade unless ``mtcnn`` or a ``state_dict`` is given."""
    from fac_fake_torch.detect.mtcnn import MTCNN
    mtcnn = mtcnn or MTCNN(state_dict, device=device)

    def fn(frames: np.ndarray) -> List[np.ndarray]:
        out = []
        for frame in frames:
            boxes, _probs, _lmk, valid = mtcnn.detect(frame)
            out.append(np.asarray(boxes, np.float32)[np.asarray(valid, bool)].reshape(-1, 4))
        return out
    return fn


def video_agreement(frames: np.ndarray, det_a: Callable, det_b: Callable,
                    iou_thr: float = 0.5) -> Dict:
    """Agreement of two detectors over one video's sampled frames."""
    boxes_a = det_a(frames)
    boxes_b = det_b(frames)
    per_frame = [frame_agreement(a, b, iou_thr) for a, b in zip(boxes_a, boxes_b)]
    return aggregate(per_frame)


def _sampled_frames(reader, path: str, frames_per_video: int):
    """``frames_per_video`` evenly spaced frames of ``path``, or None when
    it has none or none decodes (a truncated file: the video is skipped)."""
    from fac_fake_torch.data.video import evenly_spaced_indices, read_frames_at_indices
    n = reader.frame_count(path)
    if n <= 0:
        return None
    decoded = read_frames_at_indices(reader, path,
                                     evenly_spaced_indices(n, min(frames_per_video, n)))
    return None if decoded is None else decoded[0]


def mask_geometry_report(video_paths: Sequence[str], frames_per_video: int = 8,
                         landmarks_fn: Optional[Callable] = None, reader=None,
                         device: DeviceLike = None) -> Dict:
    """Drive the mask geometry (`data/masking.py mask_regions` /
    `apply_face_mask`, reference `get_masked_face_simple.py:48-101`) with a
    real landmark source — by default the packaged BlazeFace's keypoints on
    ``device`` (`landmarks_from_blazeface`, its NMS through K1) — and report
    what the geometry produces over real frames.

    Per frame: landmark hit, geometric sanity (eyes above mouth, left eye
    left of right eye), the 8 regions' total area fraction, and the masked
    fraction of a deterministic 4-region black mask.
    """
    import os
    from fac_fake_torch.data.masking import (apply_face_mask, landmarks_from_blazeface,
                                             mask_regions)
    from fac_fake_torch.data.video import VideoReader

    if landmarks_fn is None:
        from fac_fake_torch.detect.blazeface import BlazeFace
        det = BlazeFace.from_packaged_assets(device)
        landmarks_fn = lambda img: landmarks_from_blazeface(det, img)  # noqa: E731

    reader = reader or VideoReader()
    videos = {}
    for path in video_paths:
        frames = _sampled_frames(reader, path, frames_per_video)
        if frames is None:
            continue
        hits, sane, area_fracs, masked_fracs = 0, 0, [], []
        for frame in frames:
            lm = landmarks_fn(frame)
            if lm is None:
                continue
            hits += 1
            h, w = frame.shape[:2]
            lm = np.asarray(lm, np.float32)
            # l_eye, r_eye, nose, mouth_l, mouth_r (masking.py order)
            if (lm[0][0] < lm[1][0]
                    and max(lm[0][1], lm[1][1]) < min(lm[3][1], lm[4][1])):
                sane += 1
            regions = mask_regions(h, w, lm)
            area = sum(max(y1 - y0, 0) * max(x1 - x0, 0) for y0, y1, x0, x1 in regions)
            area_fracs.append(area / float(h * w))
            masked = apply_face_mask(frame, lm, [0, 1, 2, 3], "black")
            masked_fracs.append(float(np.mean(np.all(masked == 0, axis=-1))
                                      - np.mean(np.all(frame == 0, axis=-1))))
        videos[os.path.basename(path)] = {
            "frames": len(frames),
            "landmark_hits": hits,
            "geometry_sane": sane,
            "mean_region_area_frac": float(np.mean(area_fracs)) if area_fracs else None,
            "mean_masked_frac_4regions": float(np.mean(masked_fracs)) if masked_fracs else None,
        }
    tot_frames = sum(v["frames"] for v in videos.values())
    tot_hits = sum(v["landmark_hits"] for v in videos.values())
    tot_sane = sum(v["geometry_sane"] for v in videos.values())
    return {
        "videos": videos,
        "totals": {
            "frames": tot_frames,
            "landmark_hit_rate": tot_hits / tot_frames if tot_frames else None,
            "geometry_sane_rate": tot_sane / tot_hits if tot_hits else None,
        },
    }


def agreement_report(video_paths: Sequence[str], det_a: Callable, det_b: Callable,
                     frames_per_video: int = 8, scorers: Optional[tuple] = None,
                     iou_thr: float = 0.5, reader=None) -> Dict:
    """Full harness over a list of videos. ``scorers``, when given, is a pair
    of `VideoScorer`s (one per detector config) that also record the
    end-to-end score delta through the same CViT weights."""
    import os
    from fac_fake_torch.data.video import VideoReader
    reader = reader or VideoReader()
    videos = {}
    for path in video_paths:
        frames = _sampled_frames(reader, path, frames_per_video)
        if frames is None:
            continue
        rec = video_agreement(frames, det_a, det_b, iou_thr)
        if scorers is not None:
            sa, sb = scorers
            rec["score_a"] = float(sa.score_video(path))
            rec["score_b"] = float(sb.score_video(path))
            rec["score_delta"] = rec["score_a"] - rec["score_b"]
        videos[os.path.basename(path)] = rec
    totals = {
        "videos": len(videos),
        "boxes_a": sum(v["boxes_a"] for v in videos.values()),
        "boxes_b": sum(v["boxes_b"] for v in videos.values()),
        "matched": sum(v["matched"] for v in videos.values()),
    }
    ious = [v["mean_iou"] for v in videos.values()
            if v["mean_iou"] is not None and np.isfinite(v["mean_iou"])]
    totals["mean_iou"] = float(np.mean(ious)) if ious else None
    totals["recall_a_by_b"] = (totals["matched"] / totals["boxes_a"]
                               if totals["boxes_a"] else None)
    totals["recall_b_by_a"] = (totals["matched"] / totals["boxes_b"]
                               if totals["boxes_b"] else None)
    return {"videos": videos, "totals": totals}

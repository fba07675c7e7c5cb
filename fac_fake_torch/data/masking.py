"""Face-region masking augmentation for the S3D workload — the port of
`fac_fake_tpu/data/masking.py`, on the host in numpy, with the JAX
package's numpy draws, so that a mask at a fixed ``rng`` is JAX's bit for
bit.

Re-designs `S3D/face_mask/get_masked_face_simple.py`: the face splits into 8
rectangular regions around the eyes/mouth derived from 5-point landmarks; a
random subset of `mask_number` regions is filled with black or N(0,1) noise.
Landmarks are cached per image id as `{tempdir}/{img_id}.lmv{N}.npy`
(`get_masked_face_simple.py:22-40` — the reference's temp-cache scheme, plus
a geometry-schema version tag so adapter fixes invalidate old entries).

Landmark source: the reference uses a CPU MTCNN; here the port's BlazeFace
(`detect/blazeface.py`, on the card unless the caller names the CPU; its
frame-detection step is kernel K1) supplies keypoints (`landmarks_from_blazeface`: image-ordered eyes,
mouth corners at ±0.4× the inter-ocular distance around BlazeFace's
mouth-center keypoint — augmentation-level fidelity; the region geometry
`:48-72` is exact given landmarks, and `landmarks_from_mtcnn` supplies true
corners once cascade weights are imported; its NMS is kernel K8). The
BlazeFace adapter shrinks a frame to 128² with the port's own INTER_AREA
(`ops/resize.py resize_area`), so masking needs no cv2; only
`mask_faces_in_folder`, which reads and writes image files, imports it.
"""
from __future__ import annotations

import math
import os
import tempfile
import threading
from typing import List, Optional, Sequence

import numpy as np

from fac_fake_torch.core.device import DeviceLike
from fac_fake_torch.ops.resize import resize_area


def default_tempdir() -> str:
    """The landmark cache's default directory, under the process's temp dir."""
    return os.path.join(tempfile.gettempdir(), "fac_landmarks")


def landmarks_from_blazeface(detector, img_rgb: np.ndarray) -> Optional[np.ndarray]:
    """Returns 5-point landmarks [(x,y)×(l_eye, r_eye, nose, mouth_l, mouth_r)]
    in pixel coords (image order: l_eye.x < r_eye.x), or None if no face.

    BlazeFace keypoint 0 is the SUBJECT's right eye — the left one in image
    coordinates, which is what the mask geometry's "left eye" means
    (`mask_regions` builds the left-of-left-eye region from lm[0]); verified
    against real detections (round 5 — the pre-fix adapter had the eyes
    swapped AND offset the mouth corners by ±15% of the *frame* width, a
    half-frame-wide "mouth" on landscape video; the mask-geometry harness's
    0% sanity rate caught both, `tools/detector_agreement.py --masks`).
    Mouth corners are approximated at ±0.4× the inter-ocular distance
    (anthropometric mouth width ≈ 0.8× interocular) around BlazeFace's
    mouth-center keypoint — MTCNN provides true corners when its weights
    exist (`landmarks_from_mtcnn`)."""
    h, w = img_rgb.shape[:2]
    tile = resize_area(img_rgb, (128, 128))
    faces, mask = detector.predict_on_batch(tile[None])
    faces = faces[0].cpu().numpy()
    mask = mask[0].cpu().numpy()
    if not mask.any():
        return None
    kp = faces[0, 4:16].reshape(6, 2)  # (x, y) normalized to the 128 tile
    kp = kp * np.array([w, h])
    eye_l, eye_r, nose, mouth = kp[0], kp[1], kp[2], kp[3]
    if eye_l[0] > eye_r[0]:            # guard: keep image order regardless
        eye_l, eye_r = eye_r, eye_l
    dx = 0.4 * float(np.linalg.norm(eye_r - eye_l))
    return np.array([eye_l, eye_r, nose,
                     [mouth[0] - dx, mouth[1]], [mouth[0] + dx, mouth[1]]])


def landmarks_from_mtcnn(detector, img_rgb: np.ndarray) -> Optional[np.ndarray]:
    """True 5-point landmarks from the MTCNN cascade (`detect/mtcnn.py`) —
    the reference's landmark source (`get_masked_face_simple.py:35-44`,
    thresholds [0.65, 0.75, 0.75]). Same output contract as the BlazeFace
    path but with real mouth corners (no ±15 % approximation)."""
    return detector.landmarks(img_rgb)


def interpolate_68_from_5(lm5: np.ndarray, h: int, w: int) -> np.ndarray:
    """Synthesize the 68-point entries the region geometry consumes (eye
    corners/lids 36-47, mouth 48/50/52/54/57) from 5-point landmarks.

    EXPERIMENTAL SUBSTITUTE: the reference derives these from a
    face_alignment 2D-FAN network (`get_masked_face.py:21-43`), which is
    not installable in this environment (zero egress). The synthesized
    offsets follow classical facial-proportion canons (Farkas-style
    anthropometry) on a face-filling crop:
      * eye half-width ``ew = 0.06·w`` → palpebral fissure ≈ 0.12 of the
        crop ≈ 1/5 of the face when the face spans ~60-70 % of the crop
        (the artists' "rule of fifths"; Farkas: fissure ≈ 31 mm vs
        bizygomatic ≈ 137 mm ≈ 0.22);
      * eye half-height ``eh = 0.025·h`` → fissure height/length ≈ 0.42,
        within the 1/3-1/2 canonical band;
      * lip offsets ``0.04·h`` ≈ half the canonical mouth height
        (~1/8 of lower-face height).
    These place the *masked rectangles* at augmentation-level fidelity —
    the region geometry downstream is exact given landmarks — but are NOT a
    landmark-accuracy claim; if face_alignment appears, swap the source and
    keep `mask_regions_68` unchanged. The variant stays opt-in via
    ``data.mask_method = black68|noise68`` (PARITY.md S7 row)."""
    out = np.zeros((68, 2), np.float32)
    le, re, nose, ml, mr = lm5
    ew, eh = 0.06 * w, 0.025 * h
    # left eye: 36 outer, 39 inner, 37/38 top, 40/41 bottom
    out[36] = le - [ew, 0]
    out[39] = le + [ew, 0]
    out[37] = out[38] = le - [0, eh]
    out[40] = out[41] = le + [0, eh]
    # right eye: 42 inner, 45 outer, 43/44 top, 46/47 bottom
    out[42] = re - [ew, 0]
    out[45] = re + [ew, 0]
    out[43] = out[44] = re - [0, eh]
    out[46] = out[47] = re + [0, eh]
    out[30] = nose
    mc = (np.asarray(ml) + np.asarray(mr)) / 2.0
    out[48], out[54] = ml, mr                       # mouth corners
    out[50] = out[52] = mc - [0, 0.04 * h]          # top lip
    out[57] = mc + [0, 0.04 * h]                    # bottom lip
    return out


def mask_regions_68(h: int, w: int, preds: np.ndarray) -> List[tuple]:
    """The 8 rectangles as (y0, y1, x0, x1) from 68-point landmarks —
    geometry from `get_masked_face.py:24-43` (eye boxes padded by 10 % of
    their own extent, mouth by 10 % of its width)."""
    lel = math.ceil(preds[36, 0] - (preds[39, 0] - preds[36, 0]) * 0.1)
    le_top_raw = min(preds[37, 1], preds[38, 1])
    le_bot_raw = max(preds[41, 1], preds[40, 1])
    let = math.ceil(le_top_raw - (le_bot_raw - le_top_raw) * 0.1)
    leb = math.ceil(le_bot_raw + (le_bot_raw - le_top_raw) * 0.1)
    re_top_raw = min(preds[43, 1], preds[44, 1])
    re_bot_raw = max(preds[47, 1], preds[46, 1])
    ret_ = math.ceil(re_top_raw - (re_bot_raw - re_top_raw) * 0.1)
    rer = math.ceil(preds[45, 0] + (preds[45, 0] - preds[42, 0]) * 0.1)
    reb = math.ceil(re_bot_raw + (re_bot_raw - re_top_raw) * 0.1)
    mw = preds[54, 0] - preds[48, 0]
    ml = math.ceil(preds[48, 0] - mw * 0.1)
    mr = math.ceil(preds[54, 0] + mw * 0.1)
    mb = math.ceil(preds[57, 1] +
                   (preds[57, 1] - min(preds[50, 1], preds[52, 1])) * 0.1)
    top_eyes = min(let, ret_)
    clip = lambda v, hi: int(max(0, min(v, hi)))
    lel, rer, ml, mr = (clip(v, w) for v in (lel, rer, ml, mr))
    leb, reb, mb, top_eyes = (clip(v, h) for v in (leb, reb, mb, top_eyes))
    return [
        (0, leb, 0, lel),          # left of left eye
        (0, top_eyes, lel, rer),   # above the eyes
        (0, reb, rer, w),          # right of right eye
        (leb, mb, 0, ml),          # left cheek
        (reb, mb, mr, w),          # right cheek
        (mb, h, 0, ml),            # lower left
        (mb, h, ml, mr),           # chin
        (mb, h, mr, w),            # lower right
    ]


MASK68_COUNT = 3  # the 68-landmark variant always masks 3 regions
                  # (`get_masked_face.py:47,56` "超参数：3")


def apply_face_mask_68(img: np.ndarray, preds68: Optional[np.ndarray],
                       random_list: Sequence[int], method: str = "black",
                       rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """68-landmark masking variant (`get_masked_face.py`): 3 random regions,
    black fill or additive N(0,1) noise."""
    if preds68 is None:
        return img
    h, w = img.shape[:2]
    regions = mask_regions_68(h, w, preds68)
    if method.startswith("black"):
        out = img.copy()
        for i in random_list[:MASK68_COUNT]:
            y0, y1, x0, x1 = regions[i]
            if y1 > y0 and x1 > x0:
                out[y0:y1, x0:x1] = 0
        return out
    rng = rng or np.random.default_rng()
    out = img.astype(np.float64) / 255.0
    for i in random_list[:MASK68_COUNT]:
        y0, y1, x0, x1 = regions[i]
        if y1 > y0 and x1 > x0:
            out[y0:y1, x0:x1] += rng.normal(0, 1, (y1 - y0, x1 - x0, img.shape[2]))
            out = np.clip(out, 0, 1)
    return np.uint8(out * 255)


def mask_regions(h: int, w: int, lm: np.ndarray) -> List[tuple]:
    """The 8 rectangles as (y0, y1, x0, x1) — geometry from
    `get_masked_face_simple.py:48-72`."""
    eyes_w, eyes_h = w * 0.2, h * 0.16
    mouth_w = lm[4][0] - lm[3][0]
    mouth_h = h * 0.16
    lel = max(math.ceil(lm[0][0] - eyes_w / 2), 0)
    let = max(math.ceil(lm[0][1] - eyes_h / 2), 0)
    leb = min(math.ceil(lm[0][1] + eyes_h / 2), h)
    ret_ = max(math.ceil(lm[1][1] - eyes_h / 2), 0)
    rer = min(math.ceil(lm[1][0] + eyes_w / 2), w)
    reb = min(math.ceil(lm[1][1] + eyes_h / 2), h)
    ml = max(math.ceil(lm[3][0] - mouth_w / 10), 0)
    mr = min(math.ceil(lm[4][0] + mouth_w / 10), w)
    mb = min(math.ceil(lm[3][1] + mouth_h / 2), h)
    top_eyes = min(let, ret_)
    return [
        (0, leb, 0, lel),          # left of left eye
        (0, top_eyes, lel, rer),   # above the eyes
        (0, reb, rer, w),          # right of right eye
        (leb, mb, 0, ml),          # left cheek
        (reb, mb, mr, w),          # right cheek
        (mb, h, 0, ml),            # lower left
        (mb, h, ml, mr),           # chin
        (mb, h, mr, w),            # lower right
    ]


def apply_face_mask(img: np.ndarray, landmarks: Optional[np.ndarray],
                    random_list: Sequence[int], method: str = "black",
                    mask_number: int = 4,
                    rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Fill `mask_number` randomly chosen regions with black or N(0,1) noise
    (`get_masked_face_simple.py:74-101`)."""
    if method not in ("black", "noise"):
        raise ValueError(f"mask method must be black|noise, got {method}")
    if landmarks is None:
        return img
    h, w = img.shape[:2]
    regions = mask_regions(h, w, landmarks)
    if method == "black":
        out = img.copy()
        for i in random_list[:mask_number]:
            y0, y1, x0, x1 = regions[i]
            if y1 > y0 and x1 > x0:
                out[y0:y1, x0:x1] = 0
        return out
    rng = rng or np.random.default_rng()
    out = img.astype(np.float64) / 255.0
    for i in random_list[:mask_number]:
        y0, y1, x0, x1 = regions[i]
        if y1 > y0 and x1 > x0:
            out[y0:y1, x0:x1] += rng.normal(0, 1, (y1 - y0, x1 - x0, img.shape[2]))
            out = np.clip(out, 0, 1)
    return np.uint8(out * 255)


# Landmark-geometry schema version, part of every cache filename: bumping it
# orphans entries written under older adapter semantics (v2 = the round-5
# eye-order + mouth-width fix — pre-fix caches held swapped eyes and
# ±15%-of-frame mouth corners, and reusing them by bare img_id would silently
# re-poison the mask geometry the fix repaired).
_LANDMARK_SCHEMA = 2


class LandmarkCache:
    """tempdir .npy landmark cache (`get_masked_face_simple.py:22-40`);
    entries are keyed `{img_id}.lmv{_LANDMARK_SCHEMA}.npy` so stale-geometry
    files from older code versions are never read back. The default detector
    is the port's packaged BlazeFace on ``device`` (the card unless the
    caller names the CPU), made at first use; the clip loader's threads
    share it."""

    def __init__(self, tempdir: str, detector=None, device: DeviceLike = None):
        self.tempdir = tempdir
        os.makedirs(tempdir, exist_ok=True)
        self._detector = detector
        self._device = device
        self._lock = threading.Lock()

    @property
    def detector(self):
        with self._lock:
            if self._detector is None:
                from fac_fake_torch.detect.blazeface import BlazeFace
                self._detector = BlazeFace.from_packaged_assets(self._device)
            return self._detector

    def get(self, img_rgb: np.ndarray, img_id: str) -> Optional[np.ndarray]:
        path = os.path.join(self.tempdir,
                            f"{img_id}.lmv{_LANDMARK_SCHEMA}.npy")
        if os.path.exists(path):
            try:
                return np.load(path)
            except (OSError, ValueError, EOFError):   # a torn or foreign file: detect again
                os.remove(path)
        det = self.detector
        if hasattr(det, "landmarks"):  # MTCNN cascade (true 5-point)
            lm = landmarks_from_mtcnn(det, img_rgb)
        else:
            lm = landmarks_from_blazeface(det, img_rgb)
        if lm is not None:
            np.save(path, lm)
        return lm

    def cleanup(self):
        """Temp landmark-cache cleanup (`S3D-train.py:434-438`)."""
        for f in os.listdir(self.tempdir):
            if f.endswith(".npy"):
                os.remove(os.path.join(self.tempdir, f))


def mask_faces_in_folder(src_dir: str, out_dir: str, method: str = "black",
                         mask_number: int = 4, tempdir: Optional[str] = None,
                         seed: int = 0, device: DeviceLike = None) -> int:
    """Batch/folder masking (`face_mask/get_masked_facees*.py` equivalents):
    mask every image in `src_dir`, writing to `out_dir`. Returns count."""
    import cv2
    cache = LandmarkCache(tempdir or default_tempdir(), device=device)
    rng = np.random.default_rng(seed)
    os.makedirs(out_dir, exist_ok=True)
    n = 0
    for name in sorted(os.listdir(src_dir)):
        if not name.lower().endswith((".png", ".jpg", ".jpeg")):
            continue
        img = cv2.imread(os.path.join(src_dir, name), cv2.IMREAD_COLOR)
        if img is None:
            continue
        rgb = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
        lm = cache.get(rgb, os.path.splitext(name)[0])
        order = rng.permutation(8).tolist()
        masked = apply_face_mask(rgb, lm, order, method, mask_number, rng)
        cv2.imwrite(os.path.join(out_dir, name),
                    cv2.cvtColor(masked, cv2.COLOR_RGB2BGR))
        n += 1
    return n

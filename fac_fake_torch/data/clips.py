"""S3D clip dataset: per-video face-crop folders → (B, T, H, W, 3) batches —
the port of `fac_fake_tpu/data/clips.py`.

  * snippet policies: ``first_n`` (the first 20 crops, `S3D-train.py:133-148`)
    and ``strided`` (every 10th of the first 200, `S3D-train-GPUs.py:178-193`);
  * labels: 0 = real, 1 = fake (`S3D-train.py:46-68`);
  * face-region masking per frame (`deepfakes_dataset.py:85-95`,
    `data/masking.py`): ``black``/``noise`` over ``mask_number`` of the 8
    regions, or ``black68``/``noise68`` over 3, the landmarks from the
    port's BlazeFace through the landmark cache; the region order is drawn
    once a clip from the clip's generator (for every clip, masked or not, as
    the JAX package does, so that a caller sharing the generator sees the
    same stream);
  * optional grayscale (`deepfakes_dataset.py:102-104`);
  * class rebalancing pos_weight = #real/#fake (`S3D-train.py:264-273`);
  * deterministic shuffle, seed 4 (`S3D/utils.py:54-58`).

Per-process sharding of the batches is ROADMAP queue 1 item 12.
`cv2` is imported only inside `load_clip`. Clips are NDHWC uint8.
"""
from __future__ import annotations

import json
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from fac_fake_torch.core.device import DeviceLike
from fac_fake_torch.data import masking
from fac_fake_torch.data.video import first_n_indices, strided_indices
from fac_fake_torch.utils.s3d import shuffle_dataset

IMG_EXTS = (".png", ".jpg", ".jpeg")


def discover_video_folders(root: str, metadata: Optional[str] = None
                           ) -> List[Tuple[str, int, str]]:
    """Walk ``root`` for per-video crop folders. Labels come from a
    metadata.json ({video: {'label': 'REAL'|'FAKE'}}) or, failing that, from
    'fake'/'manipulated' appearing in the path. Returns (dir, label, video_id)."""
    meta: Dict[str, dict] = {}
    if metadata and os.path.isfile(metadata):
        with open(metadata) as f:
            meta = json.load(f)
    out = []
    for dirpath, _, filenames in os.walk(root):
        if not any(f.lower().endswith(IMG_EXTS) for f in filenames):
            continue
        vid = os.path.basename(dirpath)
        key = vid if vid in meta else vid + ".mp4"
        if key in meta:
            label = 1 if str(meta[key].get("label", "")).upper() == "FAKE" else 0
        else:
            low = dirpath.lower()
            label = 1 if "fake" in low or "manipulated" in low else 0
        out.append((dirpath, label, vid))
    return sorted(out)


MASK_METHODS = ("none", "black", "noise", "black68", "noise68")


class ClipDataset:
    """``device`` is the landmark detector's (masking only): the card unless
    the caller names the CPU."""

    def __init__(self, samples: Sequence[Tuple[str, int, str]],
                 frames_per_video: int = 20, image_size: int = 224,
                 snippet: str = "first_n", mask_method: str = "none", mask_number: int = 4,
                 gray: bool = False, landmark_tempdir: Optional[str] = None,
                 device: DeviceLike = None):
        if mask_method not in MASK_METHODS:
            raise ValueError(f"mask_method must be one of {MASK_METHODS}, got {mask_method!r}")
        self.samples = shuffle_dataset(list(samples))
        self.frames_per_video = frames_per_video
        self.image_size = image_size
        self.snippet = snippet
        self.mask_method = mask_method
        self.mask_number = mask_number
        self.gray = gray
        self.landmarks = None
        if mask_method != "none":
            self.landmarks = masking.LandmarkCache(
                landmark_tempdir or masking.default_tempdir(), device=device)

    def __len__(self):
        return len(self.samples)

    def pos_weight(self) -> float:
        """BCE pos_weight = #real/#fake (`S3D-train.py:264-273`)."""
        labels = np.array([s[1] for s in self.samples])
        fake = max(int((labels == 1).sum()), 1)
        real = max(int((labels == 0).sum()), 1)
        return real / fake

    def mask_frame(self, img: np.ndarray, img_id: str, region_order: List[int],
                   rng: np.random.Generator) -> np.ndarray:
        """One frame masked by ``mask_method`` (JAX `data/clips.py:112-126`)."""
        if self.mask_method == "none":
            return img
        lm = self.landmarks.get(img, img_id)
        if self.mask_method in ("black", "noise"):
            return masking.apply_face_mask(img, lm, region_order, self.mask_method,
                                           self.mask_number, rng)
        p68 = None if lm is None else masking.interpolate_68_from_5(lm, *img.shape[:2])
        return masking.apply_face_mask_68(img, p68, region_order, self.mask_method, rng)

    def load_clip(self, idx: int, rng: Optional[np.random.Generator] = None
                  ) -> Optional[np.ndarray]:
        """(T, H, W, 3) uint8 RGB clip, or None if the video has too few
        crops (`S3D-test.py:183-184` skips those)."""
        import cv2
        folder, _, vid = self.samples[idx]
        files = sorted(f for f in os.listdir(folder) if f.lower().endswith(IMG_EXTS))
        if self.snippet == "strided":
            sel = [files[i] for i in strided_indices(len(files)) if i < len(files)]
        else:
            sel = [files[i] for i in first_n_indices(len(files), self.frames_per_video)]
        if len(sel) < self.frames_per_video:
            return None
        sel = sel[: self.frames_per_video]

        rng = rng or np.random.default_rng()
        region_order = rng.permutation(8).tolist()   # drawn for every clip
        frames = []
        for j, fname in enumerate(sel):
            img = cv2.imread(os.path.join(folder, fname), cv2.IMREAD_COLOR)
            img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
            if img.shape[:2] != (self.image_size, self.image_size):
                img = cv2.resize(img, (self.image_size, self.image_size))
            img = self.mask_frame(img, f"{vid}_{j}", region_order, rng)
            if self.gray:
                g = cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)
                img = np.stack([g] * 3, axis=-1)
            frames.append(img)
        return np.stack(frames)

    def batches(self, batch_size: int, shuffle: bool = True, seed: int = 0,
                epoch: int = 0, drop_last: bool = True,
                num_workers: int = 4) -> Iterator[Dict[str, np.ndarray]]:
        """Batches of ``{"image": (B, T, H, W, 3) uint8, "label", "mask"}``,
        in the JAX package's order; a last incomplete batch is dropped, or,
        with ``drop_last=False``, padded with zero clips whose ``mask`` is 0."""
        order = np.arange(len(self.samples))
        if shuffle:
            np.random.RandomState(seed + epoch).shuffle(order)

        # one child generator per sample: numpy Generators are not
        # thread-safe, and the pool calls load_clip concurrently
        def load(i):
            rng = np.random.default_rng([seed, epoch, int(i)])
            return self.load_clip(int(i), rng), self.samples[int(i)][1]

        pool = ThreadPoolExecutor(max_workers=num_workers)
        try:
            buf_clips, buf_labels = [], []
            for clip, label in pool.map(load, order):
                if clip is None:
                    continue
                buf_clips.append(clip)
                buf_labels.append(label)
                if len(buf_clips) == batch_size:
                    yield {"image": np.stack(buf_clips),
                           "label": np.asarray(buf_labels, np.int32),
                           "mask": np.ones(batch_size, np.float32)}
                    buf_clips, buf_labels = [], []
            if buf_clips and not drop_last:
                pad = batch_size - len(buf_clips)
                mask = np.ones(batch_size, np.float32)
                mask[len(buf_clips):] = 0
                yield {"image": np.stack(buf_clips + [np.zeros_like(buf_clips[0])] * pad),
                       "label": np.asarray(buf_labels + [0] * pad, np.int32), "mask": mask}
        finally:
            # a consumer that stops early leaves loads queued: drop them
            pool.shutdown(wait=False, cancel_futures=True)

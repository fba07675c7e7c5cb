"""Offline face-crop dataset construction — the port of
`fac_fake_tpu/data/preprocess.py`.

Re-designs the reference's preprocessing scripts:
  * `CViT-main/preprocessing/extractfaces.py` — DFDC part walking with
    part-number split routing (`:44-55`), one-fake-per-original dedup
    (`filter_unique_files`, `:138-147`), per-video BlazeFace extraction of 10
    random frames → best face → 224² JPEG q75 crops (`:100-135`);
  * `extractfaces_ff.py` — the flat-folder FF++ variant;
  * `shufft_image.py` — the 85/15 shuffled split copy;
  * the sx two-stage pipeline (`detect_faces.py` + `extract_crops.py`) as
    one detector call per video: per-video folders of PNG crops.

The per-video work (read → detect → best face → INTER_AREA resize,
`video_face_crops` and `video_crop_folder_crops`) returns named uint8 RGB
crops and needs no cv2 when its reader is an in-memory one; detection runs
on the detector's device (the card unless the caller names the CPU), its
per-frame NMS through kernel K1. Only the writer imports cv2.

A video that cannot be read is skipped with a message, as the reference
skips it; an error of detection, of a kernel or of the card propagates.
"""
from __future__ import annotations

import json
import os
import random
import shutil
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from fac_fake_torch.core.device import DeviceLike

Crops = List[Tuple[str, np.ndarray]]


class UnreadableVideo(Exception):
    """Reading a video failed; the extract loops skip it."""


def dfdc_part_split(part: int) -> str:
    """Part-number ranges → split (`extractfaces.py:44-55` routing)."""
    if part < 40:
        return "train"
    if part < 45:
        return "validation"
    return "test"


def filter_unique_fakes(metadata: Dict[str, dict]) -> List[str]:
    """Keep one fake per original plus all reals (`extractfaces.py:138-147`)."""
    seen = set()
    out = []
    for name, entry in sorted(metadata.items()):
        if str(entry.get("label", "")).upper() == "FAKE":
            orig = entry.get("original")
            if orig in seen:
                continue
            seen.add(orig)
        out.append(name)
    return out


def default_detector(device: DeviceLike = None):
    """The packaged BlazeFace on ``device`` (the card unless named)."""
    from fac_fake_torch.detect.blazeface import BlazeFace
    return BlazeFace.from_packaged_assets(device)


def _reading(read):
    """``read`` as a `FaceExtractor.video_read_fn` whose failures become
    `UnreadableVideo` (reading runs no detector, kernel or card work)."""
    def fn(path):
        try:
            return read(path)
        except Exception as e:
            raise UnreadableVideo(str(e)) from e
    return fn


def _resized(named, size: int, stats: Optional[dict]) -> Crops:
    from fac_fake_torch.ops.resize import resize_area
    t0 = time.perf_counter()
    out = [(name, resize_area(face, (size, size))) for name, face in named if face.size]
    if stats is not None:
        stats["crops_s"] += time.perf_counter() - t0
    return out


def video_face_crops(video_path: str, num_frames: int = 10, size: int = 224,
                     detector=None, seed: Optional[int] = None, reader=None,
                     stats: Optional[dict] = None) -> Optional[Crops]:
    """The per-video work of `extract_faces_from_video`: ``num_frames``
    random frames (drawn with replacement, so an index can repeat) → the
    best face of each → ``size``² crops, as ``[(frame_idx, crop)]``; None
    when no frame could be read. ``reader``: any object with
    ``frame_count`` and ``stream_frames_at_indices`` (default the cv2
    `VideoReader`); ``stats``: a `detect.extractor.new_stage_stats` dict."""
    from fac_fake_torch.data import video
    from fac_fake_torch.detect.extractor import FaceExtractor

    reader = reader or video.VideoReader()
    extractor = FaceExtractor(
        detector, _reading(lambda p: video.read_random_frames(reader, p, num_frames, seed=seed)),
        stats)
    frames = extractor.process_video(video_path)
    if not frames:
        return None
    extractor.keep_only_best_face(frames)
    return _resized([(str(fd["frame_idx"]), face) for fd in frames for face in fd["faces"]],
                    size, stats)


def video_crop_folder_crops(video_path: str, frames_per_video: int = 30, size: int = 224,
                            detector=None, reader=None,
                            stats: Optional[dict] = None) -> Optional[Crops]:
    """The per-video work of `extract_video_crop_folders`: ``frames_per_video``
    evenly spaced frames → the best face of each → ``size``² crops named
    ``{frame}_{face}``; None when no frame could be read."""
    from fac_fake_torch.data import video
    from fac_fake_torch.detect.extractor import FaceExtractor

    reader = reader or video.VideoReader()

    def read(path):
        n = reader.frame_count(path)
        idxs = video.evenly_spaced_indices(n, min(frames_per_video, n))
        return video.read_frames_at_indices(reader, path, list(idxs))

    result = _reading(read)(video_path)
    if result is None:
        return None
    frames, read_idxs = result
    extractor = FaceExtractor(detector, stage_stats=stats)
    data = extractor.process_frames(frames, read_idxs)
    extractor.keep_only_best_face(data)
    return _resized([(f"{fd['frame_idx']}_{j}", face) for fd in data
                     for j, face in enumerate(fd["faces"])], size, stats)


def write_crops(crops: Crops, out_dir: str, ext: str, quality: int = 75) -> None:
    """``{name}.{ext}`` for each RGB crop under ``out_dir``: JPEG at
    ``quality`` (``ext`` "jpg") or PNG, through cv2."""
    import cv2
    params = [cv2.IMWRITE_JPEG_QUALITY, quality] if ext == "jpg" else []
    for name, crop in crops:
        cv2.imwrite(os.path.join(out_dir, f"{name}.{ext}"),
                    cv2.cvtColor(crop, cv2.COLOR_RGB2BGR), params)


def extract_faces_from_video(video_path: str, out_dir: str, prefix: str,
                             num_frames: int = 10, size: int = 224,
                             quality: int = 75, detector=None,
                             seed: Optional[int] = None, reader=None,
                             device: DeviceLike = None) -> int:
    """BlazeFace over ``num_frames`` random frames → best face per frame →
    ``size``² JPEG q``quality`` crops ``{prefix}_{frame_idx}.jpg`` (a repeated
    index writes its file again). Returns the number of crops written."""
    crops = video_face_crops(video_path, num_frames, size, detector or default_detector(device),
                             seed, reader)
    if crops is None:
        return 0
    os.makedirs(out_dir, exist_ok=True)
    write_crops([(f"{prefix}_{idx}", crop) for idx, crop in crops], out_dir, "jpg", quality)
    return len(crops)


def extract_dfdc(parts_root: str, out_root: str, num_frames: int = 10,
                 size: int = 224, detector=None, verbose: bool = True, reader=None,
                 device: DeviceLike = None):
    """Walk dfdc_train_part_* dirs, route splits, dedup fakes, extract."""
    from fac_fake_torch.data.video import VideoReader
    detector = detector or default_detector(device)
    reader = reader or VideoReader()
    for d in sorted(os.listdir(parts_root)):
        if not d.startswith("dfdc_train_part_"):
            continue
        part = int(d.rsplit("_", 1)[1])
        split = dfdc_part_split(part)
        part_dir = os.path.join(parts_root, d)
        meta_path = os.path.join(part_dir, "metadata.json")
        if not os.path.isfile(meta_path):
            continue
        with open(meta_path) as f:
            metadata = json.load(f)
        for name in filter_unique_fakes(metadata):
            label = "fake" if str(metadata[name]["label"]).upper() == "FAKE" else "real"
            out_dir = os.path.join(out_root, split, label)
            try:
                n = extract_faces_from_video(
                    os.path.join(part_dir, name), out_dir, prefix=os.path.splitext(name)[0],
                    num_frames=num_frames, size=size, detector=detector, reader=reader)
            except UnreadableVideo as e:     # per-video fault tolerance (:91-95)
                print(f"skip {name}: {e}")
                continue
            if verbose:
                print(f"{split}/{label}/{name}: {n} crops")


def extract_flat(videos_dir: str, out_dir: str, label: str,
                 num_frames: int = 10, size: int = 224, detector=None, reader=None,
                 device: DeviceLike = None):
    """FF++-style flat folder of mp4s, one label (`extractfaces_ff.py`)."""
    from fac_fake_torch.data.video import VideoReader
    detector = detector or default_detector(device)
    reader = reader or VideoReader()
    target = os.path.join(out_dir, label)
    for name in sorted(os.listdir(videos_dir)):
        if not name.endswith(".mp4"):
            continue
        try:
            extract_faces_from_video(os.path.join(videos_dir, name), target,
                                     prefix=os.path.splitext(name)[0], num_frames=num_frames,
                                     size=size, detector=detector, reader=reader)
        except UnreadableVideo as e:
            print(f"skip {name}: {e}")


def extract_video_crop_folders(videos_dir: str, out_root: str,
                               frames_per_video: int = 30, size: int = 224,
                               detector=None, reader=None, device: DeviceLike = None):
    """sx-pipeline equivalent: per-video crop FOLDERS of PNGs for the S3D
    clip dataset (`detect_faces.py` + `extract_crops.py`, single pass)."""
    from fac_fake_torch.data.video import VideoReader
    detector = detector or default_detector(device)
    reader = reader or VideoReader()
    for name in sorted(os.listdir(videos_dir)):
        if not name.endswith(".mp4"):
            continue
        out_dir = os.path.join(out_root, os.path.splitext(name)[0])
        try:
            crops = video_crop_folder_crops(os.path.join(videos_dir, name), frames_per_video,
                                            size, detector, reader)
        except UnreadableVideo as e:
            print(f"skip {name}: {e}")
            continue
        if crops is None:
            continue
        os.makedirs(out_dir, exist_ok=True)
        write_crops(crops, out_dir, "png")


def shuffle_split(src_dir: str, out_a: str, out_b: str,
                  fraction: float = 0.85, seed: int = 0):
    """85/15 shuffled copy (`shufft_image.py:10-46`)."""
    files = sorted(os.listdir(src_dir))
    random.Random(seed).shuffle(files)
    cut = int(len(files) * fraction)
    for dst, chunk in ((out_a, files[:cut]), (out_b, files[cut:])):
        os.makedirs(dst, exist_ok=True)
        for f in chunk:
            shutil.copy2(os.path.join(src_dir, f), os.path.join(dst, f))


def build_metadata_for_folder(videos_dir: str, label: str, out_path: str):
    """metadata.json with a constant label (`figure/video_to_label.py`)."""
    meta = {name: {"label": label.upper()}
            for name in sorted(os.listdir(videos_dir)) if name.endswith(".mp4")}
    with open(out_path, "w") as f:
        json.dump(meta, f, indent=1)
    return meta

"""Video forgery scorer: videos → frames → face crops → batched CViT (or
ResVitKan) → prob. The port of `fac_fake_tpu/infer/predictor.py`
(`cvit_prediction.py:153-255`).

  * the reference's ≤32-crop chunk loop (0:32/32:64/64:90, forced by the
    batch-indexed pos-embedding) is ONE padded forward over ``batch_crops``
    rows with pos rows ``arange(capacity) % 32``; ``UPPER_BOUND`` 90 caps
    the count;
  * crops go to the card as uint8 and kernel K2 normalizes them there
    (`CViT.forward_crops`, `ResVitKan.forward_crops`); under int8, K2 turns
    them into the stem's int8 input in the same pass; a ResVitKan's KAN
    head runs kernel K9 twice a forward; only CViTs fold BN and quantize;
  * detection is BlazeFace with kernel K1 for the per-frame NMS, or under
    ``infer.detector="mtcnn"`` the MTCNN cascade (`detect/mtcnn.py`, kernel
    K8 for its NMS) with plain box crops (`face_mtcnn`, `:86-102`); ≤ 5
    faces per frame and 29 per video (`face_face_rec`'s caps,
    `:106-121,194`);
  * aggregation is `aggregate_probs`;
  * ``infer.quantize="int8"|"int8_full"``: int8 post-training quantization
    (`compat/quantize.py`), calibrated lazily on the first scored batch of
    ≥ 8 crops (`quantize_int8`); the quantized layers run kernels K3 and K4.

The per-video host work (decode, tile and crop resizes) overlaps across
videos on a thread pool; PyTorch releases the GIL in its kernels.
"""
from __future__ import annotations

import csv
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor, as_completed
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from fac_fake_torch.core.config import Config, torch_dtype
from fac_fake_torch.core.device import DeviceLike, resolve_device
from fac_fake_torch.infer.aggregate import aggregate_probs
from fac_fake_torch.ops.preprocess import normalize_imagenet
from fac_fake_torch.ops.resize import resize_area

CHUNK = 32          # reference transformer batch cap (legacy pos rows)
UPPER_BOUND = 90    # crops beyond 90 are dropped (`cvit_prediction.py:236`)
MAX_CROPS = 29      # per-video crop cap (`cvit_prediction.py:194`)


class VideoScorer:
    def __init__(self, model, cfg: Optional[Config] = None, detector=None,
                 reader=None, fold_bn: bool = True, device: DeviceLike = None):
        """``model``: a CViT or a ResVitKan (``resvitkan``, ``resvit``;
        `models.build_model`) with its weights loaded; ``reskan``, whose
        forward takes no pos rows, is refused. ``detector``/``reader``:
        optional stand-ins for the detector and the cv2 `VideoReader` (any
        object with ``predict_on_batch``, BlazeFace's interface, or under
        ``infer.detector="mtcnn"`` with ``detect``, MTCNN's / with
        ``frame_count`` and ``stream_frames_at_indices``)."""
        self.cfg = cfg or Config()
        if not hasattr(model, "forward_crops"):
            raise ValueError(
                f"{type(model).__name__} cannot score videos: its forward takes no legacy "
                "pos rows (pos_indices), which the scorer passes for the reference's "
                "32-row chunks; the JAX VideoScorer cannot score it either (its forward "
                "raises a TypeError on pos_indices)")
        if self.cfg.infer.quantize in ("int8", "int8_full") and not hasattr(model, "stems"):
            raise ValueError(
                f"infer.quantize={self.cfg.infer.quantize!r}: {type(model).__name__} has no "
                "foldable stem to quantize (int8 serving quantizes CViT stems)")
        self.device = resolve_device(device)
        model = model.to(self.device).eval()
        if fold_bn and hasattr(model, "stem_spec"):
            # inference reparameterization, exact up to rounding
            from fac_fake_torch.compat.fold import fold_cvit
            model = fold_cvit(model)
        self.model = model.to(memory_format=torch.channels_last)
        self.legacy = getattr(model, "pos_mode", "legacy") == "legacy"
        self.dtype = torch_dtype(self.cfg.model.dtype)
        if self.cfg.infer.quantize not in ("none", "int8", "int8_full"):
            raise ValueError(f"infer.quantize {self.cfg.infer.quantize!r}: "
                             "expected none, int8 or int8_full")
        if self.cfg.infer.detector == "face_recognition":
            raise NotImplementedError(
                "detector 'face_recognition': its library (dlib's face_recognition) "
                "is not in this repository; use blazeface or mtcnn")
        if self.cfg.infer.detector not in ("blazeface", "mtcnn"):
            raise ValueError(f"infer.detector {self.cfg.infer.detector!r}: expected "
                             "blazeface or mtcnn")
        self._detector = detector
        self._reader = reader
        self._lazy_lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self.capacity = self.cfg.infer.batch_crops
        # int8 PTQ: calibrated lazily on the first real crop batch
        self._quant_pending = self.cfg.infer.quantize in ("int8", "int8_full")
        self.stage_stats: Optional[dict] = None
        self.video_latencies: List[float] = []
        #: face crops gathered per video path (after the 29-crop cap)
        self.crop_counts: Dict[str, int] = {}

    def quantize_int8(self, calib_crops_u8: np.ndarray) -> int:
        """Post-training int8 quantization of the folded model on a
        calibration crop batch (`compat/quantize.py`): every stem's convs
        (18 on the flagship ``cvit_repbn8``, 17 on ``cvit``), and
        under ``infer.quantize="int8_full"`` the patch embedding,
        transformer and head fc1. Returns the number of quantized convs;
        0 when the model was already quantized. ``infer.quantize`` set to
        int8 does this with the first scored batch of ≥ 8 crops."""
        from fac_fake_torch.compat.quantize import quantize_cvit
        with self._lazy_lock:
            already = any(op[0] == "qconv" for op in self.model.stem_ops()) \
                or self.model.quant_dense
            if not self._quant_pending and already:
                # racing callers, or a second explicit call: quantize_cvit on
                # the rewritten model would find no fp weights to quantize
                return 0
            x = torch.from_numpy(np.ascontiguousarray(calib_crops_u8)).to(self.device)
            self.model = quantize_cvit(self.model, normalize_imagenet(x, torch.float32),
                                       transformer=self.cfg.infer.quantize == "int8_full")
            self._quant_pending = False
            return sum(op[0] == "qconv" for op in self.model.stem_ops())

    def _maybe_quantize(self, crops_u8: np.ndarray) -> None:
        if self._quant_pending and crops_u8.shape[0] >= 8:
            self.quantize_int8(crops_u8)

    # --- lazily built host-side helpers -------------------------------
    @property
    def detector(self):
        """Built per ``infer.detector`` on the scorer's device: the packaged
        BlazeFace, or the MTCNN cascade from ``infer.mtcnn_weights`` (an
        ``.npz`` of `cli/import_mtcnn.py`; empty: seeded nets) with
        ``infer.mtcnn_thresholds``."""
        if self._detector is None:
            with self._lazy_lock:
                if self._detector is None:
                    if self.cfg.infer.detector == "mtcnn":
                        from fac_fake_torch.detect.mtcnn import MTCNN, load_mtcnn_npz
                        weights = self.cfg.infer.mtcnn_weights
                        self._detector = MTCNN(
                            load_mtcnn_npz(weights) if weights else None,
                            thresholds=self.cfg.infer.mtcnn_thresholds, device=self.device)
                    else:
                        from fac_fake_torch.detect.blazeface import BlazeFace
                        self._detector = BlazeFace.from_packaged_assets(self.device)
        return self._detector

    @property
    def reader(self):
        if self._reader is None:
            with self._lazy_lock:
                if self._reader is None:
                    from fac_fake_torch.data.video import VideoReader
                    self._reader = VideoReader()
        return self._reader

    # --- crop gathering ------------------------------------------------
    # streaming decode group: 16 frames usually carry ≥ 16 faces, so the
    # 29-crop cap exits after ~2 chunks instead of decoding every frame
    GATHER_CHUNK = 16

    def gather_crops(self, video_path: str) -> np.ndarray:
        """Sample frames with the reference policy and collect up to 29 face
        crops (≤ 5 per frame), 224×224 uint8 RGB. Decode and detection are
        interleaved in GATHER_CHUNK-frame groups and stop at the cap."""
        from fac_fake_torch.data.video import ChunkPrefetcher, predict_indices
        from fac_fake_torch.detect.extractor import FaceExtractor

        size = self.cfg.data.image_size
        n = self.reader.frame_count(video_path)
        if n <= 0:
            return np.zeros((0, size, size, 3), np.uint8)
        idxs = predict_indices(n, self.cfg.data.sample_fraction,
                               self.cfg.data.frame_jump)
        boxed = self.cfg.infer.detector == "mtcnn"
        extractor = None if boxed else FaceExtractor(self.detector)
        crops: List[np.ndarray] = []
        stream = ChunkPrefetcher(
            lambda stop: self.reader.stream_frames_at_indices(
                video_path, idxs, self.GATHER_CHUNK, stop=stop))
        detect_s = 0.0
        try:
            for frames, _ in stream:
                t0 = time.perf_counter()
                if boxed:
                    self._boxed_crops_into(crops, frames, size)
                else:
                    for fd in extractor.process_frames(frames):
                        for face in fd["faces"][: self.cfg.data.max_faces_per_frame]:
                            if len(crops) >= MAX_CROPS:
                                break
                            crops.append(resize_area(face, (size, size)))
                detect_s += time.perf_counter() - t0
                if len(crops) >= MAX_CROPS:
                    break
        finally:
            joined = stream.close()
            # producer-side decode seconds and frames are final only if the
            # worker joined; otherwise they are left out of the stats
            if joined:
                self._stats_add(decode_s=stream.decode_s, frames=stream.frames)
            self._stats_add(detect_s=detect_s)
        with self._stats_lock:
            self.crop_counts[video_path] = len(crops)
        if not crops:
            return np.zeros((0, size, size, 3), np.uint8)
        return np.stack(crops)

    def _boxed_crops_into(self, crops: List[np.ndarray], frames, size: int) -> None:
        """A box detector's crops (the reference's `face_mtcnn` loop,
        `cvit_prediction.py:86-102`): ≤ 5 faces a frame, ≤ 29 a video, the
        box corners truncated by ``int``, a plain crop with its top and left
        clipped at 0, INTER_AREA to ``size``². Appends into ``crops`` so the
        streaming caller can stop at the cap."""
        max_pf = min(5, self.cfg.data.max_faces_per_frame)
        for frame in frames:
            if len(crops) >= MAX_CROPS:
                break
            boxes, _, _, valid = self.detector.detect(frame)
            rects = [(int(y1), int(y2), int(x1), int(x2))
                     for (x1, y1, x2, y2), v in zip(boxes, valid) if v]
            for (y1, y2, x1, x2) in rects[:max_pf]:
                if len(crops) >= MAX_CROPS:
                    break
                face = frame[max(y1, 0):y2, max(x1, 0):x2]
                if face.size:
                    crops.append(resize_area(face, (size, size)))

    # --- scoring ---------------------------------------------------------
    @torch.inference_mode()
    def _forward(self, crops_u8: np.ndarray, pos_idx: torch.Tensor) -> torch.Tensor:
        # uint8 to the card; there K2 normalizes them (or, for a stem with an
        # int8 walk, makes the walk's int8 input in the same pass)
        x = torch.from_numpy(crops_u8).to(self.device, non_blocking=True)
        return self.model.forward_crops(x, self.dtype,
                                        pos_indices=pos_idx if self.legacy else None)

    def score_crops(self, crops_u8: np.ndarray) -> float:
        """Score a stack of uint8 RGB 224² crops (B, 224, 224, 3), padded to
        ``batch_crops`` rows with pos rows ``arange(capacity) % 32``."""
        n = int(crops_u8.shape[0])
        if n == 0:
            return float(self.cfg.infer.no_face_score)
        self._maybe_quantize(crops_u8)
        cap = self.capacity
        padded = np.zeros((cap, *crops_u8.shape[1:]), np.uint8)
        padded[: min(n, cap)] = crops_u8[:cap]
        t0 = time.perf_counter()
        pos = torch.arange(cap, device=self.device) % CHUNK
        logits = self._forward(padded, pos)
        prob = float(aggregate_probs(logits, min(n, cap, UPPER_BOUND)))
        self._stats_add(score_s=time.perf_counter() - t0)
        return prob

    def score_video(self, video_path: str) -> float:
        t0 = time.perf_counter()
        prob = self.score_crops(self.gather_crops(video_path))
        with self._stats_lock:
            self.video_latencies.append(time.perf_counter() - t0)
        return prob

    def latency_stats(self) -> dict:
        """p50/p90 end-to-end per-video latency. Empty until a video ran."""
        lats = sorted(self.video_latencies)
        if not lats:
            return {}
        return {"p50_s": lats[len(lats) // 2],
                "p90_s": lats[int(len(lats) * 0.9)],
                "count": len(lats)}

    def enable_stage_stats(self) -> dict:
        """Opt-in per-stage timers: accumulated decode / detect / score
        seconds and frames decoded across later gather/score calls. Decode
        runs beside detection (`ChunkPrefetcher`), so the shares are
        component costs, not additive wall-clock."""
        with self._stats_lock:
            self.stage_stats = {"decode_s": 0.0, "detect_s": 0.0,
                                "score_s": 0.0, "frames": 0}
        return self.stage_stats

    def _stats_add(self, **deltas) -> None:
        with self._stats_lock:
            if self.stage_stats is None:
                return
            for k, v in deltas.items():
                self.stage_stats[k] += v

    @staticmethod
    def default_workers() -> int:
        return max(1, min(4, os.cpu_count() or 1))

    def score_videos(self, paths: Sequence[str],
                     num_workers: Optional[int] = None) -> List[float]:
        """Per-video scoring, host work overlapped across videos."""
        with ThreadPoolExecutor(max_workers=num_workers or self.default_workers()) as ex:
            return list(ex.map(self.score_video, paths))

    # --- batched multi-video scoring (throughput path) --------------------
    VIDEO_SLOT = 32     # ≥ the 29-crop cap; pos rows = rows within the slot
    FLUSH_VIDEOS = 8    # videos per batched forward

    def score_crop_stacks(self, stacks: Sequence[np.ndarray]) -> List[float]:
        """Score several videos' crop stacks in ONE forward: V slots of 32
        rows, pos rows ``tile(arange(32), V)`` (the reference's single-chunk
        rows), aggregation per slot. Equal to `score_crops` per video."""
        if not stacks:
            return []
        self._maybe_quantize(stacks[0])
        slot = self.VIDEO_SLOT
        v = len(stacks)
        packed = np.zeros((v, slot, *stacks[0].shape[1:]), np.uint8)
        counts = np.zeros((v,), np.int64)
        for k, crops in enumerate(stacks):
            n = min(crops.shape[0], slot)
            packed[k, :n] = crops[:n]
            counts[k] = n
        t0 = time.perf_counter()
        pos = torch.arange(slot, device=self.device).repeat(v)
        logits = self._forward(packed.reshape(v * slot, *packed.shape[2:]), pos)
        probs = aggregate_probs(logits.reshape(v, slot, -1),
                                torch.from_numpy(counts).to(self.device))
        out = [float(p) for p in probs.cpu()]
        self._stats_add(score_s=time.perf_counter() - t0)
        return out

    def score_videos_batched(self, paths: Sequence[str],
                             num_workers: Optional[int] = None) -> List[float]:
        """Batch crops of many videos into one forward per FLUSH_VIDEOS
        gathered videos; scores equal per-video scoring. Each video's latency
        runs from the start of its gather to the moment its score exists."""
        results: List[float] = [self.cfg.infer.no_face_score] * len(paths)
        starts: dict = {}
        pending: List[tuple] = []

        def gather(i: int, path: str):
            starts[i] = time.perf_counter()
            return i, self.gather_crops(path)

        def flush():
            probs = self.score_crop_stacks([c for _, c in pending])
            now = time.perf_counter()
            with self._stats_lock:
                for (i, _), p in zip(pending, probs):
                    results[i] = p
                    self.video_latencies.append(now - starts[i])
            pending.clear()

        with ThreadPoolExecutor(max_workers=num_workers or self.default_workers()) as ex:
            futs = [ex.submit(gather, i, p) for i, p in enumerate(paths)]
            for fut in as_completed(futs):
                i, crops = fut.result()
                if crops.shape[0] == 0:
                    with self._stats_lock:
                        self.video_latencies.append(time.perf_counter() - starts[i])
                    continue
                pending.append((i, crops))
                if len(pending) >= self.FLUSH_VIDEOS:
                    flush()
        if pending:
            flush()
        return results

    def predict_to_csv(self, video_dir: str, save_csv: str,
                       num_workers: Optional[int] = None, batched: bool = False):
        """Directory scan + CSV dump, schema ``filename,label``
        (`cvit_prediction.py:342-343`). Returns [(filename, prob), ...]."""
        filenames = sorted(f for f in os.listdir(video_dir) if f.endswith(".mp4"))
        paths = [os.path.join(video_dir, f) for f in filenames]
        preds = (self.score_videos_batched(paths, num_workers) if batched
                 else self.score_videos(paths, num_workers))
        rows = list(zip(filenames, preds))
        write_predictions_csv(save_csv, rows)
        return rows


def write_predictions_csv(save_csv: str, rows: Sequence[tuple]) -> None:
    """The ``filename,label`` CSV of (file name, fake-probability) rows
    (`cvit_prediction.py:342-343`), which `evaluate/metrics.py` reads."""
    os.makedirs(os.path.dirname(save_csv) or ".", exist_ok=True)
    with open(save_csv, "w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(["filename", "label"])
        w.writerows(rows)

"""S3D checkpoint evaluator — the port of `fac_fake_tpu/evaluate/s3d_eval.py`.

Per video: a strided snippet → (1, T, H, W, 3) forward → sigmoid →
`custom_video_round`; the reference's intentional degradation (JPEG
compression + Gaussian noise, both p=1, `S3D-test.py:65-73`) on every
frame unless ``degrade=False``; metrics accuracy / F1 / BCE, and ROC dumps
with an ``out_prefix``.

Inputs are raw 0–255 floats (no ImageNet normalize). The public surface
keeps the JAX layout, (B, T, H, W, 3) uint8; the model sees (B, 3, T, H, W)
in ``channels_last_3d`` memory, which is the same memory. ``cv2`` is
imported only inside `degrade_frame`.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from fac_fake_torch.core.device import DeviceLike, resolve_device
from fac_fake_torch.evaluate.metrics import accuracy, f1
from fac_fake_torch.utils.s3d import custom_video_round


def degrade_frame(img_rgb: np.ndarray, rng: np.random.Generator,
                  quality_range=(40, 60), noise_var=(10.0, 40.0)) -> np.ndarray:
    """ImageCompression + GaussNoise, both p=1 (`S3D-test.py:65-73`); draws
    ``rng.integers``, then ``uniform``, then ``normal``, as JAX does."""
    import cv2
    q = int(rng.integers(quality_range[0], quality_range[1] + 1))
    _, enc = cv2.imencode(".jpg", cv2.cvtColor(img_rgb, cv2.COLOR_RGB2BGR),
                          [cv2.IMWRITE_JPEG_QUALITY, q])
    img = cv2.cvtColor(cv2.imdecode(enc, cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)
    var = rng.uniform(*noise_var)
    noisy = img.astype(np.float32) + rng.normal(0, np.sqrt(var), img.shape)
    return np.clip(noisy, 0, 255).astype(np.uint8)


class S3DEvaluator:
    """S3D scoring and evaluation (`S3D-test.py:260-286`).

    ``quantize="int8"`` scores through the int8 engine
    (`compat/quantize_s3d.py`, kernels K5 and K6 on the card), calibrated
    on the first two clips of the first batch it scores. The model moves to
    ``device``: the card unless the caller names the CPU.
    """

    def __init__(self, model, degrade: bool = True, seed: int = 0,
                 quantize: str = "none", device: DeviceLike = None):
        if quantize not in ("none", "int8"):
            raise ValueError(f"quantize must be none|int8, got {quantize!r}")
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.degrade = degrade
        self.seed = seed
        self.quantize = quantize
        self.engine = None

    @torch.no_grad()
    def _probs(self, clips_u8: np.ndarray) -> np.ndarray:
        """(B, T, H, W, 3) uint8 → (B, num_class) probabilities."""
        x = torch.from_numpy(np.ascontiguousarray(clips_u8)).to(self.device)
        x = x.float().permute(0, 4, 1, 2, 3)          # channels_last_3d, no copy
        if self.quantize == "int8":
            if self.engine is None:
                from fac_fake_torch.compat.quantize_s3d import quantize_s3d
                self.engine = quantize_s3d(self.model, x[:2])
            logits = self.engine(x)
        else:
            logits = self.model(x)
        return torch.sigmoid(logits).cpu().numpy()

    def predict_batch(self, clips_u8: np.ndarray) -> np.ndarray:
        """Batched serving forward: (B, T, H, W, 3) uint8 → (B,) video
        fake-probabilities (no degradation: serving scores clean clips)."""
        return self._probs(clips_u8).reshape(clips_u8.shape[0], -1).mean(-1)

    def predict_video(self, clip_u8: np.ndarray,
                      rng: Optional[np.random.Generator] = None) -> float:
        """clip (T, H, W, 3) uint8 → video fake-probability."""
        rng = rng or np.random.default_rng(self.seed)
        if self.degrade:
            clip_u8 = np.stack([degrade_frame(f, rng) for f in clip_u8])
        probs = self._probs(clip_u8[None])
        return custom_video_round(probs.reshape(-1).tolist())

    def evaluate(self, dataset, out_prefix: Optional[str] = None,
                 model_name: str = "s3d") -> Dict[str, float]:
        """Score every clip of ``dataset`` (a `ClipDataset`, or any object
        with ``samples`` and ``load_clip(i, rng)``); one generator feeds
        both the clip loads and the degradation, as in JAX."""
        rng = np.random.default_rng(self.seed)
        labels, scores = [], []
        for i in range(len(dataset.samples)):
            clip = dataset.load_clip(i, rng)
            if clip is None:  # too few crops: skipped (`S3D-test.py:183-184`)
                continue
            labels.append(dataset.samples[i][1])
            scores.append(self.predict_video(clip, rng))
        if not labels:
            return {"accuracy": float("nan"), "f1": float("nan"),
                    "bce": float("nan"), "count": 0}
        labels_a = np.asarray(labels)
        scores_a = np.asarray(scores)
        preds = (scores_a > 0.5).astype(int)
        eps = 1e-7
        bce = float(-np.mean(labels_a * np.log(scores_a + eps)
                             + (1 - labels_a) * np.log(1 - scores_a + eps)))
        out = {"accuracy": accuracy(labels_a, preds),
               "f1": f1(labels_a, preds), "bce": bce, "count": len(labels)}
        if out_prefix:
            from fac_fake_torch.evaluate.metrics import save_roc_curve
            try:
                out["auc"] = float(save_roc_curve(labels_a, scores_a, out_prefix, model_name))
            except ValueError:
                out["auc"] = float("nan")
        return out

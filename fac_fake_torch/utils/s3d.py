"""S3D utility functions — the port of `fac_fake_tpu/utils/s3d.py`
(reference `S3D/utils.py`)."""
from __future__ import annotations

import random
from typing import Sequence

import numpy as np
from torch import nn


def custom_round(values: Sequence[float], threshold: float = 0.5) -> np.ndarray:
    """Per-snippet rounding (`utils.py:25-32`)."""
    return np.asarray([1 if v > threshold else 0 for v in values])


def custom_video_round(preds: Sequence[float]) -> float:
    """Video score: the first snippet prob > 0.5 wins, else the mean
    (`utils.py:34-38`)."""
    for p in preds:
        if p > 0.5:
            return float(p)
    return float(np.mean(preds))


def shuffle_dataset(dataset: list, seed: int = 4) -> list:
    """Deterministic in-place shuffle, seed 4 (`utils.py:54-58`)."""
    random.Random(seed).shuffle(dataset)
    return dataset


def get_n_params(model: nn.Module) -> int:
    """Parameter count of a module (`utils.py:60-67`)."""
    return sum(p.numel() for p in model.parameters())

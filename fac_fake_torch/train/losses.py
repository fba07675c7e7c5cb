"""Training losses — the port of `fac_fake_tpu/train/losses.py`.

  * `cross_entropy` — the CViT criterion (`cvit_train.py:77`
    nn.CrossEntropyLoss);
  * `bce_weighted` — S3D's single-logit BCE with torch ``pos_weight``
    (`S3D-train.py:264-273`).

With a ``mask`` (1 for a real row, 0 for a padded one) each is the masked
mean ``sum(l·m) / max(sum(m), 1)``, as in JAX; without, the plain mean.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def _reduce(losses: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    if mask is None:
        return losses.mean()
    m = mask.reshape(-1).to(losses.dtype)
    return (losses * m).sum() / m.sum().clamp(min=1.0)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    losses = F.cross_entropy(logits.float(), labels.long(), reduction="none")
    return _reduce(losses, mask)


def bce_weighted(logits: torch.Tensor, labels: torch.Tensor, pos_weight: float = 1.0,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``-[pw·y·log σ(x) + (1−y)·log(1−σ(x))]``."""
    x = logits.reshape(-1).float()
    y = labels.reshape(-1).float()
    losses = -(pos_weight * y * F.logsigmoid(x) + (1.0 - y) * F.logsigmoid(-x))
    return _reduce(losses, mask)


def make_loss(name: str, **kw):
    if name == "cross_entropy":
        return lambda logits, labels, mask=None: cross_entropy(logits, labels, mask)
    if name == "bce_weighted":
        pw = kw.get("pos_weight", 1.0)
        return lambda logits, labels, mask=None: bce_weighted(logits, labels, pw, mask)
    raise KeyError(f"unknown loss {name}")

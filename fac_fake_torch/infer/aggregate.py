"""Video-level probability aggregation — the port of
`fac_fake_tpu/infer/aggregate.py`, bit-faithful to the reference.

`cvit_prediction.py:258-281`: sigmoid (not softmax) over the 2 logits per
crop; column means f_c (fake, col 0) and r_c (real, col 1); the video score
is f_c when fake wins else |1 − r_c|; videos with fewer than 3 crops score
0.5 (`len(y_pred) > 2`).
"""
from __future__ import annotations

import torch

NO_FACE_SCORE = 0.5


def aggregate_probs(logits: torch.Tensor, count) -> torch.Tensor:
    """logits: (..., capacity, 2) padded crop logits; count: number of real
    rows, a scalar or one per leading index. Returns the video
    fake-probabilities, shaped like ``count``."""
    cap = logits.shape[-2]
    count = torch.as_tensor(count, device=logits.device)
    mask = (torch.arange(cap, device=logits.device) < count[..., None]).to(torch.float32)
    probs = torch.sigmoid(logits.to(torch.float32))
    denom = torch.clamp(count.to(torch.float32), min=1.0)
    f_c = torch.sum(probs[..., 0] * mask, dim=-1) / denom
    r_c = torch.sum(probs[..., 1] * mask, dim=-1) / denom
    score = torch.where(f_c > r_c, f_c, torch.abs(1.0 - r_c))
    return torch.where(count > 2, score, torch.full_like(score, NO_FACE_SCORE))


def real_or_fake(prob: float) -> str:
    """Decision rule: prob < 0.5 → REAL, ≥ 0.5 → FAKE
    (`CViT-main/README.md:28-30`)."""
    return "REAL" if prob < 0.5 else "FAKE"

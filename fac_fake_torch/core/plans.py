"""S3D plan-YAML compatibility layer — the port of `fac_fake_tpu/core/plans.py`.

The reference drives its experiment grid with YAML "plans"
(`S3D/configs/*.yaml`, schema at `plan1.yaml:1-17`: training.{lr,
weight-decay, bs, gamma, step-size, rebalancing_fake/real, frames-per-video,
mask-method, mask-number, picture-color, aug} + model.{image-size, SRM-net}).
Scoring reads the model family, its input size and SRM input, and
``frames-per-video``; this module loads those into the typed Config tree,
keeping the plan-name → model-family convention (`S3D-test.py:333-351`:
plan* → s3d, mplan* → msca_s3d, caplan* → ca_s3d). The training and
augmentation fields come with S3D training. ``yaml`` is imported inside
`load_plan`.
"""
from __future__ import annotations

import os
from typing import Optional

from fac_fake_torch.core.config import Config


def model_for_plan(plan_name: str) -> str:
    base = os.path.basename(plan_name).split(".")[0]
    if base.startswith("caplan"):
        return "ca_s3d"
    if base.startswith("mplan"):
        return "msca_s3d"
    return "s3d"


def load_plan(path: str, cfg: Optional[Config] = None) -> Config:
    import yaml

    with open(path) as f:
        plan = yaml.safe_load(f)
    cfg = cfg or Config()
    t = plan.get("training", {})
    m = plan.get("model", {})

    cfg.model.name = model_for_plan(path)
    cfg.model.num_class = 1
    cfg.model.image_size = int(m.get("image-size", 224))
    cfg.model.srm_net = str(m.get("SRM-net", "no")).lower() in ("yes", "true")
    cfg.data.frames_per_video = int(t.get("frames-per-video", 20))
    return cfg

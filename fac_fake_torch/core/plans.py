"""S3D plan-YAML compatibility layer — the port of `fac_fake_tpu/core/plans.py`.

The reference drives its experiment grid with YAML "plans"
(`S3D/configs/*.yaml`, schema at `plan1.yaml:1-17`: training.{lr,
weight-decay, bs, gamma, step-size, rebalancing_fake/real, frames-per-video,
mask-method, mask-number, picture-color, aug} + model.{image-size, SRM-net}).
This module loads that schema into the typed Config tree as the JAX
package does: the model family by the plan-name convention
(`S3D-test.py:333-351`: plan* → s3d, mplan* → msca_s3d, caplan* → ca_s3d),
the training fields (loss ``bce_weighted``, the cosine schedule, which
S3D-train.py uses although the plans carry a step size), the masking and
colour fields, the S3D train transform's augment set and its probabilities
(`S3D/deepfakes_dataset.py:32-48`), and the class rebalancing. ``yaml`` is
imported inside `load_plan`.
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

    cfg.train.loss = "bce_weighted"
    cfg.train.optim.lr = float(t.get("lr", 1e-3))
    cfg.train.optim.weight_decay = float(t.get("weight-decay", 1e-7))
    cfg.train.optim.schedule = "cosine"   # S3D-train.py:204-205
    cfg.train.optim.step_gamma = float(t.get("gamma", 0.1))
    cfg.train.optim.step_size = int(t.get("step-size", 15))

    cfg.data.batch_size = int(t.get("bs", 8))
    cfg.data.frames_per_video = int(t.get("frames-per-video", 20))
    cfg.data.mask_method = str(t.get("mask-method", "none")).strip("'\"")
    cfg.data.mask_number = int(t.get("mask-number", 6))
    cfg.data.picture_color = str(t.get("picture-color", "rgb")).strip("'\"")
    a = cfg.data.augment
    a.enabled = str(t.get("aug", "no")).lower() in ("yes", "true")
    a.to_gray = cfg.data.picture_color == "gray"
    # the S3D train transform (`deepfakes_dataset.py:32-48`):
    # ImageCompression(60-100, p=.2), hflip, GaussNoise(p=.3), GaussianBlur,
    # OneOf(brightness-contrast, FancyPCA, HSV, p=.4), ToGray(p=.2),
    # ShiftScaleRotate(shift .1, scale .2, rot 5°, p=.5); no outer p, and no
    # CLAHE, rot90, transpose, vflip, sharpen or emboss
    a.image_compression = a.gaussian_blur = a.fancy_pca = a.color_oneof = True
    if cfg.data.picture_color != "gray":
        a.to_gray_prob = 0.2
    a.clahe = a.rot90 = a.transpose = a.vflip = False
    a.sharpen = a.emboss = a.sharpen_oneof = False
    a.compose_prob = 1.0
    a.noise_prob = 0.3
    a.affine_prob = 0.5
    a.shift_limit = 0.1
    a.scale_limit = 0.2
    a.rotation_deg = 5.0

    # rebalancing: pos_weight = real / fake (S3D-train.py:264-273)
    cfg.train.rebalance_pos_weight = True
    cfg.train.rebalance_fake = float(t.get("rebalancing_fake", 1.0))
    cfg.train.rebalance_real = float(t.get("rebalancing_real", 1.0))
    return cfg

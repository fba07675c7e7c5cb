"""Typed configuration tree with YAML overlays.

The port's own copy of `fac_fake_tpu/core/config.py` (the port imports
nothing of the JAX package): same fields, same defaults, so one YAML
overlay or ``a.b.c=value`` override means the same thing to both packages.
``yaml`` is imported only inside `load_yaml`.

Replaces the reference's scattered flag systems — optparse constants in
``cvit_train.py:35-60``, hard-coded paths in ``cvit_prediction.py:47-53`` and
the S3D YAML plan grid (``S3D/configs/*.yaml``, schema at ``plan1.yaml:1-17``)
— with one dataclass tree. Every field has a typed default; YAML/dict overlays
and ``a.b.c=value`` dotted CLI overrides update it in place.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, fields, is_dataclass
from typing import Any, List, Optional, Tuple


# ---------------------------------------------------------------------------
# overlay machinery
# ---------------------------------------------------------------------------

def _coerce(value: Any, typ: Any) -> Any:
    """Best-effort coercion of YAML/CLI scalars into the declared field type."""
    if value is None:
        return None
    origin = getattr(typ, "__origin__", None)
    if origin is not None:
        args = [a for a in typ.__args__ if a is not type(None)]
        if origin is tuple:
            inner = args[0] if args else Any
            return tuple(_coerce(v, inner) for v in value)
        if origin is list:
            inner = args[0] if args else Any
            return [_coerce(v, inner) for v in value]
        if len(args) == 1:  # Optional[T]
            return _coerce(value, args[0])
        return value
    if typ is bool and isinstance(value, str):
        return value.lower() in ("1", "true", "yes", "y")
    if typ in (int, float, str) and not isinstance(value, typ):
        return typ(value)
    return value


def apply_overrides(cfg: Any, overrides: dict) -> Any:
    """Recursively apply a nested dict of overrides to a dataclass tree."""
    for key, value in overrides.items():
        if not hasattr(cfg, key):
            raise KeyError(f"unknown config field {type(cfg).__name__}.{key}")
        current = getattr(cfg, key)
        if is_dataclass(current) and isinstance(value, dict):
            apply_overrides(current, value)
        else:
            ftype = {f.name: f.type for f in fields(cfg)}[key]
            setattr(cfg, key, _coerce(value, ftype))
    return cfg


def apply_dotted(cfg: Any, dotted: List[str]) -> Any:
    """Apply ``a.b.c=value`` style overrides (CLI)."""
    import ast

    for item in dotted:
        path, _, raw = item.partition("=")
        try:
            value = ast.literal_eval(raw)
        except (ValueError, SyntaxError):
            value = raw
        node: dict = {}
        leaf = node
        parts = path.split(".")
        for p in parts[:-1]:
            leaf[p] = {}
            leaf = leaf[p]
        leaf[parts[-1]] = value
        apply_overrides(cfg, node)
    return cfg


DTYPES = ("float32", "bfloat16")


def torch_dtype(name: str, field: str = "model.dtype"):
    """A compute dtype's name in a config (``model.dtype``, or
    ``data.augment.compute_dtype`` once "auto" is resolved) as a torch
    dtype; ``field`` names it in the error for any other name."""
    import torch
    if name not in DTYPES:
        raise ValueError(f"{field}={name!r}: one of {DTYPES}")
    return getattr(torch, name)


def load_yaml(cfg: Any, path: str) -> Any:
    import yaml

    with open(path) as f:
        data = yaml.safe_load(f) or {}
    return apply_overrides(cfg, data)


def to_dict(cfg: Any) -> dict:
    return dataclasses.asdict(cfg)


# ---------------------------------------------------------------------------
# config tree
# ---------------------------------------------------------------------------

@dataclass
class MeshConfig:
    """Device mesh. Axes: data (batch), model (tensor parallel).

    Supersedes the reference's gloo process group
    (``S3D-train-GPUs.py:196-214``): sharding is declared, XLA inserts the
    collectives over ICI.
    """
    data: int = -1          # -1: all remaining devices
    model: int = 1
    axis_names: Tuple[str, str] = ("data", "model")


@dataclass
class ModelConfig:
    name: str = "cvit"             # registry key: cvit, cvit_repbn8, reskan, ...
    image_size: int = 224
    patch_size: int = 7
    num_classes: int = 2
    channels: int = 512
    dim: int = 1024
    depth: int = 6
    heads: int = 8
    mlp_dim: int = 2048
    # `legacy`: reference's 32-row batch-indexed pos-embedding
    # (cvit.py:154,174-175); `patch`: standard per-position embedding.
    pos_embedding_mode: str = "legacy"
    # S3D-family knobs (S3D/model.py:7-16, configs/plan*.yaml)
    srm_net: bool = False
    num_class: int = 1
    # compute dtype: float32 | bfloat16 (params always fp32)
    dtype: str = "float32"


@dataclass
class AugmentConfig:
    """On-device augmentation pipeline (replaces albumentations strong_aug,
    ``CViT-main/helpers/augmentation.py:9-26``).

    Defaults model the reference CViT train distribution faithfully:
    ``Aug()`` wraps ``strong_aug(p=0.9)`` (``augmentation.py:47-50``), i.e. an
    outer Compose coin at 0.9, with per-op probabilities rot90/transpose/
    GaussNoise/SSR/HSV = 0.2, flips = 0.5, and the
    ``OneOf([CLAHE, Sharpen, Emboss, RandomBrightnessContrast], p=0.2)``
    group (each member effectively ~5%)."""
    enabled: bool = True
    # dtype the batched pipeline computes in. "auto": follow the model dtype
    # (the Trainer upgrades it to bfloat16 alongside a bf16 model — the chain
    # is HBM-bandwidth-bound, so halving the element size halves its cost);
    # "float32" pins full precision (tests, golden comparisons). Sub-pixel
    # exact ops (CLAHE LUTs, JPEG DCT) always run their math in fp32 on
    # their gathered subsets regardless.
    compute_dtype: str = "auto"
    prob: float = 0.5
    # outer Compose(p=…) coin — strong_aug is built with p=0.9
    # (`augmentation.py:49`); the S3D transform has no outer p (plans set 1.0)
    compose_prob: float = 0.9
    hflip: bool = True
    vflip: bool = True
    rot90: bool = True
    transpose: bool = True
    gauss_noise: bool = True
    sharpen: bool = True
    emboss: bool = True
    brightness_contrast: bool = True
    hue_saturation: bool = True
    color_jitter: bool = True
    rotation_deg: float = 17.0
    to_gray: bool = False
    clahe: bool = True             # strong_aug CLAHE(clip_limit=2) (`helpers/augmentation.py:20`)
    clahe_clip_limit: float = 2.0
    # per-op apply probabilities (strong_aug values; `augmentation.py:11-26`)
    rot90_prob: float = 0.2
    transpose_prob: float = 0.2
    hflip_prob: float = 0.5
    vflip_prob: float = 0.5
    noise_prob: float = 0.2        # OneOf([GaussNoise], p=.2); S3D: GaussNoise(p=.3)
    hsv_prob: float = 0.2
    # ShiftScaleRotate: p and the albumentations limits (strong_aug uses the
    # defaults shift=.0625/scale=.1; the S3D transform sets .1/.2 —
    # `deepfakes_dataset.py:46`)
    affine_prob: float = 0.5
    shift_limit: float = 0.0625
    scale_limit: float = 0.1
    # OneOf([CLAHE, Sharpen, Emboss, RandomBrightnessContrast], p=.2)
    # (`augmentation.py:19-24`) — members' default p=.5 normalize to a
    # uniform 1/4 pick; a member whose flag is disabled no-ops its pick
    sharpen_oneof: bool = True
    sharpen_oneof_prob: float = 0.2
    # S3D train transform: ImageCompression(quality_lower=60, quality_upper=100,
    # p=0.2) (`S3D/deepfakes_dataset.py:34`) — on-device block-DCT JPEG
    image_compression: bool = False
    compression_quality: Tuple[int, int] = (60, 100)
    compression_prob: float = 0.2
    # S3D train transform extras (`deepfakes_dataset.py:36,44-45`):
    # GaussianBlur(blur_limit=(1,3), p=.05), FancyPCA (inside the p=.4
    # OneOf with brightness/HSV), ToGray(p=.2) as a random aug
    gaussian_blur: bool = False
    blur_prob: float = 0.05
    fancy_pca: bool = False
    to_gray_prob: float = 0.0
    # mutually-exclusive color ops: OneOf([BrightnessContrast, FancyPCA,
    # HSV], p=.4) instead of independent coins (S3D transform semantics)
    color_oneof: bool = False
    color_oneof_prob: float = 0.4


@dataclass
class DataConfig:
    train_dir: str = ""
    val_dir: str = ""
    test_dir: str = ""
    batch_size: int = 32
    eval_batch_size: int = 32
    num_workers: int = 4
    shuffle_seed: int = 4          # reference: shuffle_dataset seed 4 (S3D/utils.py:54-58)
    frames_per_video: int = 20     # S3D clips
    image_size: int = 224
    # frame sampling policy for video scoring: fraction + jump
    # (cvit_prediction.py:165-177 samples 10% of frames, seek step 5)
    sample_fraction: float = 0.1
    frame_jump: int = 5
    max_faces_per_frame: int = 5   # cvit_prediction.py:110-118
    max_faces_per_video: int = 30  # face_tensor cap (cvit_prediction.py:158)
    mask_method: str = "none"      # none | black | noise (S3D face masking)
    mask_number: int = 4
    picture_color: str = "rgb"     # rgb | gray
    # input scaling: imagenet (/255 + mean/std, CViT — cvit_prediction.py:41-45)
    # or raw255 (raw 0-255 floats, S3D — deepfakes_dataset.py:111)
    normalize: str = "imagenet"
    augment: AugmentConfig = field(default_factory=AugmentConfig)


@dataclass
class OptimConfig:
    name: str = "adam"
    lr: float = 1e-4
    weight_decay: float = 1e-7
    # schedules: plateau (ReduceLROnPlateau, cvit_train.py:81), step
    # (ResKan_train.py:84), cosine (S3D-train.py:204-205), const
    schedule: str = "plateau"
    plateau_factor: float = 0.5
    plateau_patience: int = 3
    step_size: int = 15
    step_gamma: float = 0.1
    cosine_lrf: float = 0.1
    scale_lr_by_data_parallel: bool = False  # reference: lr × world_size (S3D-train-GPUs.py:220)


@dataclass
class TrainConfig:
    epochs: int = 50
    loss: str = "cross_entropy"    # cross_entropy | bce_weighted
    rebalance_pos_weight: bool = True  # BCEWithLogits pos_weight=real/fake (S3D-train.py:264-273)
    rebalance_fake: float = 1.0    # plan rebalancing_fake (class-count scales)
    rebalance_real: float = 1.0    # plan rebalancing_real
    patience: int = 0              # early stop on val loss; 0 = off
    checkpoint_dir: str = "checkpoints"
    checkpoint_every: int = 10     # epochs (S3D-train.py:426-429)
    resume: str = ""
    seed: int = 0
    log_every: int = 20            # batches (cvit_train.py:149-153)
    # microbatches per optimizer step (1 = off). Runs an in-jit lax.scan
    # over microbatches and applies ONE Adam update from the mask-count-
    # weighted mean gradient — the big-batch gradient for BN-free models
    # (BN normalizes per microbatch, same caveat as torch grad accum) at
    # 1/N the activation memory. TPU-native extension (no reference
    # analogue): effective batches beyond HBM on one chip.
    grad_accum_steps: int = 1
    # rematerialization policy for the loss forward inside the train step:
    # "none" (XLA picks what to save), "dots" (save only matmul/conv
    # outputs — jax dots_with_no_batch_dims_saveable), "nothing" (recompute
    # everything in the backward, minimum activation memory). Trades HBM
    # residency for recompute FLOPs; measurements in PARITY.md.
    remat: str = "none"
    tensorboard_dir: str = ""
    optim: OptimConfig = field(default_factory=OptimConfig)


@dataclass
class InferConfig:
    weights: str = ""
    video_dir: str = ""
    metadata: str = ""
    save_csv: str = "predictions.csv"
    detector: str = "blazeface"    # blazeface | face_recognition | mtcnn
    # MTCNN predict-path preset; masking uses [0.65,0.75,0.75], sx
    # preprocessing [0.85,0.95,0.95] (SURVEY §L2)
    mtcnn_thresholds: Tuple[float, float, float] = (0.6, 0.7, 0.7)
    # converted facenet_pytorch cascade weights (.npz from
    # cli.import_mtcnn); empty = architecture-only random init
    mtcnn_weights: str = ""
    # parity: replicate reference chunk boundaries 0:32/32:64/64:90 and the
    # per-chunk pos-embedding row assignment (cvit_prediction.py:224-238)
    parity_chunking: bool = True
    batch_crops: int = 96          # padded crop capacity per video (3 × 32)
    no_face_score: float = 0.5
    # "int8": post-training-quantized stem (TPU MXU 2× int8 rate), PTQ
    # calibrated on the first scored crop batch — see compat/quantize.py.
    # "int8_full" additionally quantizes the patch embedding + transformer
    # Dense matmuls (where the FLOPs are). Scores shift within quantization
    # noise; "none" keeps exact bf16.
    quantize: str = "none"


@dataclass
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    infer: InferConfig = field(default_factory=InferConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)


def default_config() -> Config:
    return Config()

"""Grad-CAM for CViT-family models — the port of
`fac_fake_tpu/evaluate/gradcam.py` (the reference's `figure/utils.py`
hooks and CAM aggregation, `figure/gradcam_cnn.py`,
`figure/gradcam_transformer.py`).

The CAM is one gradient through the head: the stems' features (or the
patch tokens) come from a forward under ``torch.no_grad``, become a leaf
that requires grad, and go through `CViT.forward`'s ``features_override``
(``embed_override``) in eval mode. So no kernel lies on the backward path:
K2 (the normalize of uint8 crops) runs before the leaf. The CAM is fp32 and
unquantized, as JAX's is: an int8 or bf16 model, or a model that is not a
`CViT` (JAX has no ``stem_features`` there), is refused.

``images``: uint8 NHWC (B, H, W, 3) crops, ImageNet-normalized by K2 on
the card (its plain version on the CPU), or the normalized NCHW fp32
input (float64 for a float64 copy of the model). A legacy-pos model takes
at most 32 images (its (32, 1, dim) positions). Without ``target_class``
each image explains its own argmax.

`show_cam_on_image` and `center_crop_img` import cv2 when called.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from fac_fake_torch.models.cvit import CViT

# fp32, and float64 (a reference: the tests hold CAMs that cancel to a small
# part of their terms in float64)
_FLOATS = (torch.float32, torch.float64)


def _check(model) -> None:
    if not isinstance(model, CViT):
        raise ValueError(f"Grad-CAM needs a CViT (its stem_features and patch_tokens), "
                         f"not a {type(model).__name__}")
    if model.quant_dense or any(p.dtype not in _FLOATS for p in model.parameters()) \
            or any(type(m).__name__.startswith("Quant") for m in model.modules()):
        raise ValueError("Grad-CAM runs an fp32, unquantized model, as JAX's does: "
                         "score the int8 or bf16 model's fp32 original instead")


def _features(model: CViT, images: torch.Tensor) -> torch.Tensor:
    if images.dtype == torch.uint8:
        return model.stem_features_crops(images, torch.float32)
    if images.dtype not in _FLOATS:
        raise ValueError(f"Grad-CAM input: uint8 crops or fp32 images, not {images.dtype}")
    return model.stem_features(images)


def _explained(logits: torch.Tensor, target_class: Optional[int]) -> torch.Tensor:
    """The sum over the batch of each image's logit of its explained class."""
    cls = (logits.argmax(-1) if target_class is None
           else torch.full((logits.shape[0],), target_class, device=logits.device))
    return logits.gather(1, cls[:, None]).sum()


def _cam_of(model: CViT, leaf: torch.Tensor, target_class: Optional[int],
            override: str) -> tuple:
    """(the explained logits' gradient at ``leaf``, ``leaf``) through the
    head alone, ``leaf`` standing in by ``override``, the model in eval."""
    was = model.training
    model.eval()
    try:
        with torch.enable_grad():
            leaf = leaf.detach().requires_grad_(True)
            logits = model(None, **{override: leaf})
            grads, = torch.autograd.grad(_explained(logits, target_class), leaf)
    finally:
        model.train(was)
    return grads, leaf.detach()


def minmax(cam: torch.Tensor) -> np.ndarray:
    """Each CAM to [0, 1] over its own range (JAX's ``max(mx - mn, 1e-8)``)."""
    mx = cam.amax(dim=(1, 2), keepdim=True)
    mn = cam.amin(dim=(1, 2), keepdim=True)
    return ((cam - mn) / torch.clamp(mx - mn, min=1e-8)).cpu().numpy()


def gradcam_raw(model: CViT, images: torch.Tensor,
                target_class: Optional[int] = None) -> torch.Tensor:
    """The CAM before its min-max, (B, h, w) over the stems' feature grid on
    ``images``' device: ReLU(Σ_c w_c · A_c), w the spatial mean of the
    explained logit's gradient (`figure/utils.py`)."""
    _check(model)
    with torch.no_grad():
        feats = _features(model, images)
    grads, feats = _cam_of(model, feats, target_class, "features_override")
    weights = grads.mean(dim=(2, 3), keepdim=True)
    return torch.relu((weights * feats).sum(dim=1))


def gradcam_tokens_raw(model: CViT, images: torch.Tensor,
                       target_class: Optional[int] = None) -> torch.Tensor:
    """The transformer-mode CAM before its min-max: the gradient at the patch
    tokens (no cls token: the hook sits before it), weights the mean over
    the tokens, the (B, n) CAM row-major on a round(√n) grid."""
    _check(model)
    with torch.no_grad():
        toks = model.patch_tokens(_features(model, images))
    grads, toks = _cam_of(model, toks, target_class, "embed_override")
    b, n, _ = toks.shape
    g = int(round(n ** 0.5))
    weights = grads.mean(dim=1, keepdim=True)
    return torch.relu((weights * toks).sum(dim=-1)).reshape(b, g, g)


def gradcam(model: CViT, images: torch.Tensor,
            target_class: Optional[int] = None) -> np.ndarray:
    """Per-image CAMs (B, h, w) in [0, 1] over the post-stem feature grid
    (JAX `gradcam`)."""
    return minmax(gradcam_raw(model, images, target_class))


def gradcam_tokens(model: CViT, images: torch.Tensor,
                   target_class: Optional[int] = None) -> np.ndarray:
    """Per-image patch-token CAMs (B, g, g) in [0, 1] (JAX `gradcam_tokens`;
    base ``cvit`` has one patch, so its CAM is one 0)."""
    return minmax(gradcam_tokens_raw(model, images, target_class))


def show_cam_on_image(img01: np.ndarray, cam: np.ndarray,
                      alpha: float = 0.5) -> np.ndarray:
    """Heatmap overlay (`figure/utils.py:183-208`): resize CAM to the image,
    JET colormap, blend. img01: (H, W, 3) float [0,1]."""
    import cv2
    h, w = img01.shape[:2]
    cam_up = cv2.resize(cam.astype(np.float32), (w, h))
    heat = cv2.applyColorMap(np.uint8(255 * cam_up), cv2.COLORMAP_JET)
    heat = cv2.cvtColor(heat, cv2.COLOR_BGR2RGB).astype(np.float32) / 255.0
    out = alpha * heat + (1 - alpha) * img01
    return np.uint8(255 * out / out.max())


def center_crop_img(img: np.ndarray, size: int) -> np.ndarray:
    """`figure/utils.py:211-235`."""
    import cv2
    h, w = img.shape[:2]
    if w < h:
        nw, nh = size, int(size * h / w)
    else:
        nh, nw = size, int(size * w / h)
    img = cv2.resize(img, (nw, nh))
    y0, x0 = (nh - size) // 2, (nw - size) // 2
    return img[y0:y0 + size, x0:x0 + size]

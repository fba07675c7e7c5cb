"""Batched training augmentation on the card — the port of
`fac_fake_tpu/data/augment.py` `augment_batch` (:621-865): the CViT chain and
the S3D train transform.

The reference's strong_aug (`CViT-main/helpers/augmentation.py:9-26`) at its
probabilities: an outer Compose(p=.9) coin a image, shared by every op;
rot90, transpose (p .2) and the flips (.5) composed into one dihedral element
a image and applied in one select (`apply_dihedral`); GaussNoise (.2); the
OneOf([CLAHE, Sharpen, Emboss, BrightnessContrast], p=.2) group, whose
kernel members run as one depthwise 3×3 conv with a per-image kernel and
bias (`conv3x3_per_image`); CLAHE on its subset in place, one launch of
kernel K7 (`ops/augment.py clahe_subset_`); HSV on a fixed-size gathered
subset of the batch (`subset_apply`); and the ShiftScaleRotate affine with
per-batch parameters as five matmuls (`batch_affine_matmul`).
``sharpen_oneof=False`` is the legacy mode of independent coins (emboss then
runs as its own pass after the fused conv).

The S3D train transform (`S3D/deepfakes_dataset.py:32-48`, set by
`core/plans.py load_plan`) adds, in JAX's order: ImageCompression first, in
place on its taken frames, one launch of kernel K10 (`ops/jpeg.py
jpeg_subset_`); the OneOf(brightness-contrast, FancyPCA, HSV, p=.4) group in
place of independent colour coins; GaussianBlur (k 3 at p .5, cv2's taps)
and FancyPCA (each image's fp32 RGB covariance, ``torch.linalg.eigh``, a
shift along the eigenvectors by N(0, .1)-weighted eigenvalues) inside the
fused depthwise conv, as kernel and bias; the random ToGray (p .2) and the
deterministic gray plan. Clips (B, T, H, W, 3) are flattened to frames,
each drawn on its own, as the reference augments frame by frame.

Every draw comes from one `torch.Generator` on the batch's device, in a fixed
order (`draw`; the S3D draws only where their options are on, so the CViT
chain's stream is unchanged); the numbers are not `jax.random`'s, so the
tests compare each op at fixed parameters and the coins by their rates.
TPU-only tuning (the bf16 one-hot CLAHE matmul, `_gather_rows`) is not
carried over.

Images are NHWC in [0, 1], in ``compute_dtype``: float32 (``auto`` here;
the trainer resolves it from the model's dtype) or bfloat16, JAX's bf16
chain: the batch ``bf16(u8) / 255`` in bf16; the noise, the per-image 3×3
kernel and bias, the gray weights and the affine matrices cast to the
images' dtype; FancyPCA's covariance, HSV and CLAHE (K7's bf16 mode) in
fp32 on their images, cast back; the JPEG step K10's bf16 mode.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from fac_fake_torch.core.config import AugmentConfig, torch_dtype
from fac_fake_torch.ops import augment as ops_augment
from fac_fake_torch.ops import jpeg as ops_jpeg


def check_config(cfg: AugmentConfig) -> torch.dtype:
    """The chain's dtype; raises for an unknown one (``auto``: float32; the
    trainer resolves ``auto`` from the model's dtype before it calls the
    chain)."""
    name = "float32" if cfg.compute_dtype == "auto" else cfg.compute_dtype
    return torch_dtype(name, "augment.compute_dtype")


# --- the dihedral group (rot90 × transpose × flips in one select) ------------
# elements (swap, flip_y, flip_x) → s·4 + fy·2 + fx: transpose first, then
# the row flip, then the column flip

def _dihedral_apply(e: int, m: np.ndarray) -> np.ndarray:
    if e & 4:
        m = m.T
    if e & 2:
        m = m[::-1]
    if e & 1:
        m = m[:, ::-1]
    return m


def _dihedral_cayley() -> np.ndarray:
    """CAYLEY[a, b] = the element a ∘ b (b first), found on a probe grid."""
    probe = np.arange(16).reshape(4, 4)
    table = np.zeros((8, 8), np.int64)
    for a in range(8):
        for b in range(8):
            target = _dihedral_apply(a, _dihedral_apply(b, probe))
            (table[a, b],) = [c for c in range(8)
                              if np.array_equal(_dihedral_apply(c, probe), target)]
    return table


CAYLEY = _dihedral_cayley()
ROT90_ELEM = np.asarray([0, 6, 3, 5], np.int64)      # np.rot90(m, k) as an element
assert all(np.array_equal(_dihedral_apply(int(e), np.arange(16).reshape(4, 4)),
                          np.rot90(np.arange(16).reshape(4, 4), k))
           for k, e in enumerate(ROT90_ELEM))


def apply_dihedral(imgs: torch.Tensor, elem: torch.Tensor, reach=tuple(range(8))) -> torch.Tensor:
    """(B, H, W, C) × an element a image (B,) → the transformed batch.
    ``reach`` lists the elements ``elem`` can take; only their views are
    made, so a flip-only chain never transposes."""
    reach = tuple(sorted(set(reach) | {0}))
    out = imgs
    for e in reach[1:]:
        v = imgs.transpose(1, 2) if e & 4 else imgs
        dims = [d for bit, d in ((2, 1), (1, 2)) if e & bit]
        v = torch.flip(v, dims) if dims else v
        out = torch.where((elem == e)[:, None, None, None], v, out)
    return out


# --- the depthwise conv stage ---------------------------------------------------

IDENT3 = torch.tensor([[0, 0, 0], [0, 1, 0], [0, 0, 0]], dtype=torch.float32)
GAUSS3 = torch.outer(torch.tensor([0.25, 0.5, 0.25]), torch.tensor([0.25, 0.5, 0.25]))  # cv2 k=3
_LAP = torch.tensor([[-1, -1, -1], [-1, 8, -1], [-1, -1, -1]], dtype=torch.float32)
_EMBOSS = torch.tensor([[-1, 0, 0], [0, 1, 0], [0, 0, 1]], dtype=torch.float32)
_EMBOSS_SGN = torch.tensor([[-1, 0, 0], [0, 0, 0], [0, 0, 1]], dtype=torch.float32)


def sharpen_kernel(alpha: torch.Tensor, lightness: torch.Tensor) -> torch.Tensor:
    """albumentations Sharpen as one kernel a image: (B,) → (B, 3, 3)."""
    ident, lap = IDENT3.to(alpha.device), _LAP.to(alpha.device)
    a, li = alpha[:, None, None], lightness[:, None, None]
    return a * (lap + li * ident) + (1.0 - a) * ident


def emboss_kernel(alpha: torch.Tensor, strength: torch.Tensor) -> torch.Tensor:
    """albumentations Emboss as one kernel a image: alpha·emboss + (1−alpha)·I."""
    dev = alpha.device
    a, s = alpha[:, None, None], strength[:, None, None]
    return a * (_EMBOSS.to(dev) + s * _EMBOSS_SGN.to(dev)) + (1.0 - a) * IDENT3.to(dev)


def conv3x3_per_image(x: torch.Tensor, kern: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) × (B, 3, 3) → the depthwise 3×3 conv with each image's
    kernel (cast to ``x``'s dtype) on every channel, zero padding: nine
    weighted shifted adds in JAX's order."""
    h, w = x.shape[1], x.shape[2]
    kern = kern.to(x.dtype)
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    out = torch.zeros_like(x)
    for dy in range(3):
        for dx in range(3):
            out = out + kern[:, dy, dx, None, None, None] * xp[:, dy:dy + h, dx:dx + w, :]
    return out


# --- colour -----------------------------------------------------------------------

def rgb_to_hsv(img: torch.Tensor) -> torch.Tensor:
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    mx = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    d = mx - mn + 1e-12
    h = torch.where(mx == r, (g - b) / d % 6.0,
                    torch.where(mx == g, (b - r) / d + 2.0, (r - g) / d + 4.0)) / 6.0
    s = d / (mx + 1e-12)
    return torch.stack([h, s, mx], dim=-1)


def hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    h, s, v = hsv[..., 0] % 1.0, hsv[..., 1], hsv[..., 2]
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1 - s)
    q = v * (1 - f * s)
    t = v * (1 - (1 - f) * s)
    i = (i.long() % 6)[..., None]
    pick = lambda *c: torch.stack(c, dim=-1).gather(-1, i)[..., 0]
    return torch.stack([pick(v, q, p, p, t, v), pick(t, v, v, q, p, p),
                        pick(p, p, t, v, v, q)], dim=-1)


# --- geometry: the affine as matmuls ----------------------------------------------

def _shift_matrix(n: int, shifts: torch.Tensor) -> torch.Tensor:
    """(rows, n, n) bilinear 1-D translations: out[v] = in[v + t_r], zero fill."""
    ar = torch.arange(n, dtype=torch.float32, device=shifts.device)
    src = ar[None, :, None] + shifts[:, None, None]
    return torch.clamp(1.0 - torch.abs(ar[None, None, :] - src), 0.0, 1.0)


def _scale_matrix(n: int, scale: torch.Tensor) -> torch.Tensor:
    """(n, n) bilinear centre-anchored zoom by 1/scale."""
    c = (n - 1) / 2.0
    ar = torch.arange(n, dtype=torch.float32, device=scale.device)
    src = (ar[:, None] - c) / scale + c
    return torch.clamp(1.0 - torch.abs(ar[None, :] - src), 0.0, 1.0)


def batch_affine_matmul(imgs: torch.Tensor, angle: torch.Tensor, scale: torch.Tensor,
                        tx: torch.Tensor, ty: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) rotated by ``angle`` (three shears), zoomed by 1/scale and
    shifted by (tx, ty), the parameters shared by the batch."""
    _, h, w, _ = imgs.shape
    dev = imgs.device
    a = -torch.tan(angle / 2.0)
    s = torch.sin(angle)
    rows = torch.arange(h, dtype=torch.float32, device=dev) - (h - 1) / 2.0
    cols = torch.arange(w, dtype=torch.float32, device=dev) - (w - 1) / 2.0
    dt = imgs.dtype                     # the matrices in the images' dtype, as JAX's
    x = torch.einsum("hvw,bhwc->bhvc", _shift_matrix(w, a * rows - tx).to(dt), imgs)  # shear x
    x = torch.einsum("wvh,bhwc->bvwc", _shift_matrix(h, s * cols - ty).to(dt), x)     # shear y
    x = torch.einsum("hvw,bhwc->bhvc", _shift_matrix(w, a * rows).to(dt), x)          # shear x
    x = torch.einsum("vh,bhwc->bvwc", _scale_matrix(h, scale).to(dt), x)              # zoom y
    return torch.einsum("uw,bhwc->bhuc", _scale_matrix(w, scale).to(dt), x)           # zoom x


# --- subsets ------------------------------------------------------------------------

def subset_budget(n: int, p: float) -> int:
    """Fixed gather size for an op firing with probability p: mean + 4σ of
    Binomial(n, p), up to a multiple of 8. Takers beyond it (P ≲ 1e-7) stay
    untransformed."""
    mu = n * p
    k = int(mu + 4.0 * (mu * max(1.0 - p, 0.0)) ** 0.5) + 1
    return min(n, max(8, (k + 7) // 8 * 8))


def subset_apply(x: torch.Tensor, take: torch.Tensor, k_budget: int, fn, *extras) -> torch.Tensor:
    """``fn`` on the ≤ k_budget images whose ``take`` fired: a stable sort
    gathers the takers to the front, ``fn`` transforms the fixed-size
    sub-batch and its rows go back; every other image keeps its bits."""
    idx = torch.argsort((~take).to(torch.uint8), stable=True)[:k_budget]
    sub = x.index_select(0, idx)
    new = fn(sub, *(e.index_select(0, idx) for e in extras))
    keep = take.index_select(0, idx)[:, None, None, None]
    return x.index_copy(0, idx, torch.where(keep, new, sub))


def _on(cfg: AugmentConfig):
    """(sharpen OneOf exclusive, emboss in the fused conv, blur in the fused conv)."""
    exclusive = cfg.sharpen_oneof and not cfg.color_oneof
    return (exclusive, cfg.emboss and (exclusive or not cfg.sharpen),
            cfg.gaussian_blur and not (cfg.sharpen or cfg.emboss))


def _gray(x: torch.Tensor) -> torch.Tensor:
    """ToGray's luma; its weights rounded to ``x``'s dtype, as JAX's weak
    Python floats are."""
    c = lambda v: torch.tensor(v, dtype=x.dtype, device=x.device)
    return c(0.299) * x[..., 0] + c(0.587) * x[..., 1] + c(0.114) * x[..., 2]


def draw(n: int, hw: tuple, cfg: AugmentConfig, gen: torch.Generator,
         device) -> Dict[str, torch.Tensor]:
    """Every coin and parameter of one batch's chain, in a fixed order."""
    u = lambda shape=(n,), lo=0.0, hi=1.0: lo + (hi - lo) * torch.rand(
        shape, generator=gen, device=device)
    d: Dict[str, torch.Tensor] = {}
    outer = u() < cfg.compose_prob
    coin = lambda p=cfg.prob: (u() < p) & outer
    d["outer"] = outer
    if cfg.color_oneof:     # OneOf([BrightnessContrast, FancyPCA, HSV], p=.4)
        group = (u() < cfg.color_oneof_prob) & outer
        pick = torch.randint(0, 3, (n,), generator=gen, device=device)
        for i, name in enumerate(("take_bc", "take_pca", "take_hsv")):
            d[name] = group & (pick == i)
    else:
        d["take_hsv"], d["take_bc"] = coin(cfg.hsv_prob), coin()
        if cfg.fancy_pca:
            d["take_pca"] = coin()
    exclusive = _on(cfg)[0]
    if exclusive:
        group = (u() < cfg.sharpen_oneof_prob) & outer
        pick = torch.randint(0, 4, (n,), generator=gen, device=device)
        for i, name in enumerate(("take_clahe", "take_sharpen", "take_emboss", "take_bc")):
            d[name] = group & (pick == i)
    else:
        d["take_clahe"], d["take_sharpen"], d["take_emboss"] = coin(), coin(), coin()
    if cfg.image_compression:
        lo, hi = (float(v) for v in cfg.compression_quality)
        d["quality"] = torch.floor(u(lo=lo, hi=hi))
        d["take_jpeg"] = (u() < cfg.compression_prob) & outer
    if cfg.rot90 or cfg.transpose or cfg.hflip or cfg.vflip:
        elem = torch.zeros((n,), dtype=torch.long, device=device)
        if cfg.rot90:
            k4 = torch.randint(0, 4, (n,), generator=gen, device=device)
            rot = torch.from_numpy(ROT90_ELEM).to(device)[k4]
            elem = torch.where(coin(cfg.rot90_prob), rot, elem)
        cayley = torch.from_numpy(CAYLEY).to(device)
        for flag, e_op, p in ((cfg.transpose, 4, cfg.transpose_prob),
                              (cfg.hflip, 1, cfg.hflip_prob), (cfg.vflip, 2, cfg.vflip_prob)):
            if flag:
                elem = torch.where(coin(p), cayley[e_op][elem], elem)
        d["elem"] = elem
    if cfg.gauss_noise:
        d["sigma"] = u(lo=0.01, hi=0.05)
        d["noise"] = torch.randn((n, *hw, 3), generator=gen, device=device)
        d["take_noise"] = coin(cfg.noise_prob)
    if cfg.gaussian_blur:   # GaussianBlur(blur_limit=(1, 3)): kernel 3 half the time
        d["take_blur"] = (u() < cfg.blur_prob) & (u() < 0.5) & outer
    if cfg.sharpen:
        d["sharpen_alpha"], d["lightness"] = u(lo=0.2, hi=0.5), u(lo=0.5, hi=1.0)
    if cfg.emboss:
        d["emboss_alpha"], d["strength"] = u(lo=0.2, hi=0.5), u(lo=0.2, hi=0.7)
    if cfg.fancy_pca:
        d["pca_alphas"] = 0.1 * torch.randn((n, 3), generator=gen, device=device)
    if cfg.brightness_contrast:
        d["contrast"], d["brightness"] = u(lo=-0.2, hi=0.2), u(lo=-0.2, hi=0.2)
    if cfg.hue_saturation or cfg.color_jitter:
        d["dh"] = u(lo=-0.05, hi=0.05)
        d["dsat"], d["dv"] = u(lo=-0.15, hi=0.15), u(lo=-0.15, hi=0.15)
    if cfg.to_gray_prob > 0:
        d["take_gray"] = (u() < cfg.to_gray_prob) & outer
    if cfg.rotation_deg > 0:
        d["angle"] = u((), -1.0, 1.0) * (cfg.rotation_deg * math.pi / 180.0)
        d["scale"] = u((), 1.0 - cfg.scale_limit, 1.0 + cfg.scale_limit)
        d["shift"] = u((2,), -cfg.shift_limit, cfg.shift_limit) * hw[0]
        d["take_affine"] = coin(cfg.affine_prob)
    return d


def fancy_pca_delta(x: torch.Tensor, alphas: torch.Tensor) -> torch.Tensor:
    """albumentations FancyPCA(alpha=.1) as a per-image RGB bias: (B, H, W, 3)
    and (B, 3) N(0, .1) draws → (B, 3), ``evecs @ (alphas · evals)`` of each
    image's fp32 pixel covariance."""
    px = x.reshape(x.shape[0], -1, 3).float()
    centered = px - px.mean(dim=1, keepdim=True)
    cov = torch.einsum("npc,npd->ncd", centered, centered) \
        / torch.full((1,), float(px.shape[1]), device=x.device)
    evals, evecs = torch.linalg.eigh(cov)
    return torch.einsum("ncd,nd->nc", evecs, alphas * evals)


def _dihedral_reach(cfg: AugmentConfig, h: int, w: int) -> tuple:
    reach = {0}
    if cfg.rot90:
        reach = {int(e) for e in ROT90_ELEM}
    for flag, e_op in ((cfg.transpose, 4), (cfg.hflip, 1), (cfg.vflip, 2)):
        if flag:
            reach |= {int(CAYLEY[e_op, e]) for e in reach}
    if h != w and any(e & 4 for e in reach):
        raise ValueError("rot90/transpose need square images")
    return tuple(sorted(reach))


def apply_draws(x: torch.Tensor, d: Dict[str, torch.Tensor], cfg: AugmentConfig,
                owned: bool = False) -> torch.Tensor:
    """The chain on (B, H, W, 3) ``x`` (fp32 or bf16) with the draws ``d``; ``x``
    itself is not written unless ``owned`` (the caller gives it up, and the
    in-place kernels may work on it)."""
    x_in = x
    n, h, w = x.shape[0], x.shape[1], x.shape[2]
    col = lambda t: t[:, None, None, None]
    exclusive, emboss_in_conv, blur_in_conv = _on(cfg)
    if cfg.image_compression:
        # K10 works in place, on a contiguous tensor of this chain's own
        if not owned or not x.is_contiguous():
            x = x.clone(memory_format=torch.contiguous_format)
        x = ops_jpeg.jpeg_subset_(x, d["take_jpeg"], d["quality"])
    if "elem" in d:
        x = apply_dihedral(x, d["elem"], _dihedral_reach(cfg, h, w))
    if cfg.gauss_noise:
        noise = col(d["sigma"].to(x.dtype)) * d["noise"].to(x.dtype)
        noisy = torch.clamp(x + noise, 0.0, 1.0)
        x = torch.where(col(d["take_noise"]), noisy, x)

    # the fused depthwise conv: kernel = scale_bc · (blur | sharpen | emboss | I),
    # bias = bc + pca
    kern = IDENT3.to(x.device).expand(n, 3, 3)
    take_conv = torch.zeros((n,), dtype=torch.bool, device=x.device)
    if blur_in_conv:
        kern = torch.where(d["take_blur"][:, None, None], GAUSS3.to(x.device), kern)
        take_conv = take_conv | d["take_blur"]
    if cfg.sharpen:
        kern = torch.where(d["take_sharpen"][:, None, None],
                           sharpen_kernel(d["sharpen_alpha"], d["lightness"]), kern)
        take_conv = take_conv | d["take_sharpen"]
    if emboss_in_conv:
        kern = torch.where(d["take_emboss"][:, None, None],
                           emboss_kernel(d["emboss_alpha"], d["strength"]), kern)
        take_conv = take_conv | d["take_emboss"]
    bias = torch.zeros((n, 3), device=x.device)
    if cfg.fancy_pca:
        bias = bias + torch.where(d["take_pca"][:, None],
                                  fancy_pca_delta(x, d["pca_alphas"]), torch.zeros_like(bias))
        take_conv = take_conv | d["take_pca"]
    if cfg.brightness_contrast:
        a, b, tb = d["contrast"], d["brightness"], d["take_bc"]
        scale = torch.where(tb, 1.0 + a, torch.ones_like(a))
        kern = kern * scale[:, None, None]
        bias = scale[:, None] * bias + torch.where(tb, b - 0.5 * a, torch.zeros_like(b))[:, None]
        take_conv = take_conv | tb
    if blur_in_conv or cfg.sharpen or emboss_in_conv or cfg.fancy_pca or cfg.brightness_contrast:
        conv = conv3x3_per_image(x, kern) + bias.to(x.dtype)[:, None, None, :]
        x = torch.where(col(take_conv), torch.clamp(conv, 0.0, 1.0), x)
    # legacy-mode stragglers that co-fire with sharpen (never in the
    # reference's shipped OneOf pipelines): their own passes
    if cfg.gaussian_blur and not blur_in_conv:
        blurred = conv3x3_per_image(x, GAUSS3.to(x.device).expand(n, 3, 3))
        x = torch.where(col(d["take_blur"]), torch.clamp(blurred, 0.0, 1.0), x)
    if cfg.emboss and not emboss_in_conv:
        emb = conv3x3_per_image(x, emboss_kernel(d["emboss_alpha"], d["strength"]))
        x = torch.where(col(d["take_emboss"]), torch.clamp(emb, 0.0, 1.0), x)

    if cfg.clahe:
        # JAX's subset of takers, or its where branch as a budget of n; K7
        # works in place, on a contiguous tensor of this chain's own
        p = cfg.compose_prob * (cfg.sharpen_oneof_prob / 4.0 if exclusive else cfg.prob)
        kb = subset_budget(n, p)
        if (x is x_in and not owned) or not x.is_contiguous():
            x = x.clone(memory_format=torch.contiguous_format)
        x = ops_augment.clahe_subset_(x, d["take_clahe"], kb if kb <= n // 2 and n >= 16 else n,
                                      cfg.clahe_clip_limit)

    if cfg.hue_saturation or cfg.color_jitter:
        def hsv_fn(sub, sdh, sds, sdv):      # in fp32 on its images, cast back
            hsv = rgb_to_hsv(sub.float())
            shifted = hsv_to_rgb(torch.stack(
                [hsv[..., 0] + sdh[:, None, None],
                 torch.clamp(hsv[..., 1] + sds[:, None, None], 0.0, 1.0),
                 torch.clamp(hsv[..., 2] + sdv[:, None, None], 0.0, 1.0)], dim=-1))
            return torch.clamp(shifted, 0.0, 1.0).to(sub.dtype)

        p = cfg.color_oneof_prob / 3.0 if cfg.color_oneof else cfg.hsv_prob
        kb = subset_budget(n, cfg.compose_prob * p)
        extras = (d["dh"], d["dsat"], d["dv"])
        if kb <= n // 2 and n >= 16:
            x = subset_apply(x, d["take_hsv"], kb, hsv_fn, *extras)
        else:
            x = torch.where(col(d["take_hsv"]), hsv_fn(x, *extras), x)

    if cfg.to_gray_prob > 0:        # ToGray(p=.2), a random aug
        x = torch.where(col(d["take_gray"]), _gray(x)[..., None], x)
    if cfg.to_gray:                 # the gray plan: every frame
        x = _gray(x)[..., None].expand(-1, -1, -1, 3)

    if cfg.rotation_deg > 0:
        warped = torch.clamp(batch_affine_matmul(x, d["angle"], d["scale"], d["shift"][0],
                                                 d["shift"][1]), 0.0, 1.0)
        x = torch.where(col(d["take_affine"]), warped, x)
    return x


def augment_batch(batch_u8: torch.Tensor, cfg: AugmentConfig,
                  gen: torch.Generator) -> torch.Tensor:
    """uint8 (B, H, W, 3) (or clips (B, T, H, W, 3), drawn a frame) → the
    augmented batch in [0, 1] in ``cfg.compute_dtype`` (``auto``: float32),
    on the batch's device; ``gen`` lies there too."""
    dt = check_config(cfg)
    # a tensor divisor, as JAX divides (CUDA multiplies by the reciprocal of a
    # Python number)
    imgs = batch_u8.to(dt) / torch.full((1,), 255.0, device=batch_u8.device, dtype=dt)
    if not cfg.enabled:
        return imgs
    shape = imgs.shape
    flat = imgs.reshape(-1, *shape[-3:])
    d = draw(flat.shape[0], tuple(shape[-3:-1]), cfg, gen, flat.device)
    return apply_draws(flat, d, cfg, owned=True).reshape(shape)

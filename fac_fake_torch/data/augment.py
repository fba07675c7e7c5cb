"""Batched training augmentation on the card — the port of the CViT chain of
`fac_fake_tpu/data/augment.py` (`augment_batch`, :621-865).

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

Every draw comes from one `torch.Generator` on the batch's device, in a fixed
order (`draw`); the numbers are not `jax.random`'s, so the tests compare each
op at fixed parameters and the coins by their rates. Nothing waits on the
host. The S3D transform's extras (JPEG compression, Gaussian blur, FancyPCA,
to-gray, the colour OneOf) and the bf16 chain raise; TPU-only tuning (the
bf16 one-hot CLAHE matmul, `_gather_rows`) is not carried over.

Images are float32 NHWC in [0, 1].
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from fac_fake_torch.core.config import AugmentConfig
from fac_fake_torch.ops import augment as ops_augment

# options of the JAX chain that the port runs elsewhere or later
_LATER = (("image_compression", "ROADMAP queue 1 item 13 (S3D training)"),
          ("gaussian_blur", "ROADMAP queue 1 item 13 (S3D training)"),
          ("fancy_pca", "ROADMAP queue 1 item 13 (S3D training)"),
          ("to_gray", "ROADMAP queue 1 item 13 (S3D training)"),
          ("color_oneof", "ROADMAP queue 1 item 13 (S3D training)"))


def check_config(cfg: AugmentConfig) -> None:
    for name, item in _LATER:
        if getattr(cfg, name):
            raise NotImplementedError(f"augment.{name} belongs to the S3D train transform: {item}")
    if cfg.to_gray_prob > 0:
        raise NotImplementedError("augment.to_gray_prob belongs to the S3D train transform: "
                                  "ROADMAP queue 1 item 13 (S3D training)")
    if cfg.compute_dtype not in ("auto", "float32"):
        raise NotImplementedError(f"augment.compute_dtype={cfg.compute_dtype!r}: bf16 training "
                                  "is ROADMAP queue 1 item 11")


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
    kernel on every channel, zero padding: nine weighted shifted adds in
    JAX's order."""
    h, w = x.shape[1], x.shape[2]
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
    x = torch.einsum("hvw,bhwc->bhvc", _shift_matrix(w, a * rows - tx), imgs)   # shear x
    x = torch.einsum("wvh,bhwc->bvwc", _shift_matrix(h, s * cols - ty), x)      # shear y
    x = torch.einsum("hvw,bhwc->bhvc", _shift_matrix(w, a * rows), x)           # shear x
    x = torch.einsum("vh,bhwc->bvwc", _scale_matrix(h, scale), x)               # zoom y
    return torch.einsum("uw,bhwc->bhuc", _scale_matrix(w, scale), x)            # zoom x


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
    exclusive = cfg.sharpen_oneof
    return exclusive, cfg.emboss and (exclusive or not cfg.sharpen)


def draw(n: int, hw: tuple, cfg: AugmentConfig, gen: torch.Generator,
         device) -> Dict[str, torch.Tensor]:
    """Every coin and parameter of one batch's chain, in a fixed order."""
    u = lambda shape=(n,), lo=0.0, hi=1.0: lo + (hi - lo) * torch.rand(
        shape, generator=gen, device=device)
    d: Dict[str, torch.Tensor] = {}
    outer = u() < cfg.compose_prob
    coin = lambda p=cfg.prob: (u() < p) & outer
    d["outer"] = outer
    d["take_hsv"], d["take_bc"] = coin(cfg.hsv_prob), coin()
    exclusive, _ = _on(cfg)
    if exclusive:
        group = (u() < cfg.sharpen_oneof_prob) & outer
        pick = torch.randint(0, 4, (n,), generator=gen, device=device)
        for i, name in enumerate(("take_clahe", "take_sharpen", "take_emboss", "take_bc")):
            d[name] = group & (pick == i)
    else:
        d["take_clahe"], d["take_sharpen"], d["take_emboss"] = coin(), coin(), coin()
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
    if cfg.sharpen:
        d["sharpen_alpha"], d["lightness"] = u(lo=0.2, hi=0.5), u(lo=0.5, hi=1.0)
    if cfg.emboss:
        d["emboss_alpha"], d["strength"] = u(lo=0.2, hi=0.5), u(lo=0.2, hi=0.7)
    if cfg.brightness_contrast:
        d["contrast"], d["brightness"] = u(lo=-0.2, hi=0.2), u(lo=-0.2, hi=0.2)
    if cfg.hue_saturation or cfg.color_jitter:
        d["dh"] = u(lo=-0.05, hi=0.05)
        d["dsat"], d["dv"] = u(lo=-0.15, hi=0.15), u(lo=-0.15, hi=0.15)
    if cfg.rotation_deg > 0:
        d["angle"] = u((), -1.0, 1.0) * (cfg.rotation_deg * math.pi / 180.0)
        d["scale"] = u((), 1.0 - cfg.scale_limit, 1.0 + cfg.scale_limit)
        d["shift"] = u((2,), -cfg.shift_limit, cfg.shift_limit) * hw[0]
        d["take_affine"] = coin(cfg.affine_prob)
    return d


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


def apply_draws(x: torch.Tensor, d: Dict[str, torch.Tensor], cfg: AugmentConfig) -> torch.Tensor:
    """The chain on (B, H, W, 3) float32 ``x`` with the draws ``d``; ``x``
    itself is not written."""
    x_in = x
    n, h, w = x.shape[0], x.shape[1], x.shape[2]
    col = lambda t: t[:, None, None, None]
    exclusive, emboss_in_conv = _on(cfg)
    if "elem" in d:
        x = apply_dihedral(x, d["elem"], _dihedral_reach(cfg, h, w))
    if cfg.gauss_noise:
        noisy = torch.clamp(x + col(d["sigma"]) * d["noise"], 0.0, 1.0)
        x = torch.where(col(d["take_noise"]), noisy, x)

    # the fused depthwise conv: kernel = scale_bc · (sharpen | emboss | I), bias = bc
    kern = IDENT3.to(x.device).expand(n, 3, 3)
    take_conv = torch.zeros((n,), dtype=torch.bool, device=x.device)
    if cfg.sharpen:
        kern = torch.where(d["take_sharpen"][:, None, None],
                           sharpen_kernel(d["sharpen_alpha"], d["lightness"]), kern)
        take_conv = take_conv | d["take_sharpen"]
    if emboss_in_conv:
        kern = torch.where(d["take_emboss"][:, None, None],
                           emboss_kernel(d["emboss_alpha"], d["strength"]), kern)
        take_conv = take_conv | d["take_emboss"]
    bias = torch.zeros((n, 3), device=x.device)
    if cfg.brightness_contrast:
        a, b, tb = d["contrast"], d["brightness"], d["take_bc"]
        scale = torch.where(tb, 1.0 + a, torch.ones_like(a))
        kern = kern * scale[:, None, None]
        bias = scale[:, None] * bias + torch.where(tb, b - 0.5 * a, torch.zeros_like(b))[:, None]
        take_conv = take_conv | tb
    if cfg.sharpen or emboss_in_conv or cfg.brightness_contrast:
        conv = conv3x3_per_image(x, kern) + bias[:, None, None, :]
        x = torch.where(col(take_conv), torch.clamp(conv, 0.0, 1.0), x)
    if cfg.emboss and not emboss_in_conv:        # legacy mode: co-fires with sharpen
        emb = conv3x3_per_image(x, emboss_kernel(d["emboss_alpha"], d["strength"]))
        x = torch.where(col(d["take_emboss"]), torch.clamp(emb, 0.0, 1.0), x)

    if cfg.clahe:
        # JAX's subset of takers, or its where branch as a budget of n; K7
        # works in place, on a contiguous tensor of this chain's own
        p = cfg.compose_prob * (cfg.sharpen_oneof_prob / 4.0 if exclusive else cfg.prob)
        kb = subset_budget(n, p)
        if x is x_in or not x.is_contiguous():
            x = x.clone(memory_format=torch.contiguous_format)
        x = ops_augment.clahe_subset_(x, d["take_clahe"], kb if kb <= n // 2 and n >= 16 else n,
                                      cfg.clahe_clip_limit)

    if cfg.hue_saturation or cfg.color_jitter:
        def hsv_fn(sub, sdh, sds, sdv):
            hsv = rgb_to_hsv(sub)
            shifted = hsv_to_rgb(torch.stack(
                [hsv[..., 0] + sdh[:, None, None],
                 torch.clamp(hsv[..., 1] + sds[:, None, None], 0.0, 1.0),
                 torch.clamp(hsv[..., 2] + sdv[:, None, None], 0.0, 1.0)], dim=-1))
            return torch.clamp(shifted, 0.0, 1.0)

        kb = subset_budget(n, cfg.compose_prob * cfg.hsv_prob)
        extras = (d["dh"], d["dsat"], d["dv"])
        if kb <= n // 2 and n >= 16:
            x = subset_apply(x, d["take_hsv"], kb, hsv_fn, *extras)
        else:
            x = torch.where(col(d["take_hsv"]), hsv_fn(x, *extras), x)

    if cfg.rotation_deg > 0:
        warped = torch.clamp(batch_affine_matmul(x, d["angle"], d["scale"], d["shift"][0],
                                                 d["shift"][1]), 0.0, 1.0)
        x = torch.where(col(d["take_affine"]), warped, x)
    return x


def augment_batch(batch_u8: torch.Tensor, cfg: AugmentConfig,
                  gen: torch.Generator) -> torch.Tensor:
    """uint8 (B, H, W, 3) (or clips (B, T, H, W, 3), drawn a frame) → the
    augmented float32 batch in [0, 1], on the batch's device; ``gen`` lies
    there too."""
    check_config(cfg)
    # a tensor divisor, as JAX divides (CUDA multiplies by the reciprocal of a
    # Python number)
    imgs = batch_u8.float() / torch.full((1,), 255.0, device=batch_u8.device)
    if not cfg.enabled:
        return imgs
    shape = imgs.shape
    flat = imgs.reshape(-1, *shape[-3:])
    d = draw(flat.shape[0], tuple(shape[-3:-1]), cfg, gen, flat.device)
    return apply_draws(flat, d, cfg).reshape(shape)

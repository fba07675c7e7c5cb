"""The bf16 modes of kernels K7 (CLAHE) and K10 (JPEG) through their plain
versions (`fac_fake_torch/ops/augment.py clahe_luma_plain`, `ops/jpeg.py
jpeg_compress_plain`), and the bf16 augmentation chain
(`fac_fake_torch/data/augment.py`), against the JAX package's bf16 chain on
the CPU. JAX's bf16 arithmetic on XLA:CPU is not held to one rounding a
bf16 op (XLA may keep a fused chain in fp32), so each comparison states a
bound measured in ulps of bf16 (2^-8 on [0.5, 1)). Inputs are made with
numpy from a seed."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_augment import _clahe_inputs
from test_torch_s3d_augment import QUALITIES, _frames

torch.set_num_threads(2)

ULP = 2.0 ** -8          # a bf16 ulp on [0.5, 1)


def _bf16(x):
    """An fp32 numpy batch as the bf16 tensor and JAX array of its values."""
    t = torch.from_numpy(x).to(torch.bfloat16)
    return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


@pytest.mark.parametrize("case", list(_clahe_inputs()))
def test_k7_bf16_plain_matches_jax(case):
    """K7's bf16 plain version against JAX's bf16 chain step
    (`clahe_luma(sub.astype(float32)).astype(bf16)`, data/augment.py:805-809):
    both take the fp32 CLAHE of the same bf16 values (held to 1e-5 in
    `test_clahe_plain_matches_jax`) and round it to bf16, so they agree but
    where that rounding meets a tie: at most one bf16 ulp, on at most 0.1% of
    the values (measured: none differ)."""
    from fac_fake_tpu.data.augment import clahe_luma as jax_clahe
    from fac_fake_torch.ops.augment import clahe_luma_plain

    x = _clahe_inputs()[case].astype(np.uint8).astype(np.float32) / np.float32(255.0)
    xt, xj = _bf16(x)
    ref = np.stack([np.asarray(jax_clahe(im.astype(jnp.float32)).astype(jnp.bfloat16)
                               .astype(jnp.float32)) for im in xj])
    got = clahe_luma_plain(xt)
    assert got.dtype == torch.bfloat16
    diff = np.abs(got.float().numpy() - ref)
    assert diff.max() <= ULP and (diff > 0).mean() <= 1e-3, (diff.max(), (diff > 0).mean())


@pytest.mark.parametrize("kind", ["noise", "smooth", "flat"])
@pytest.mark.parametrize("quality", QUALITIES + ("seeded",))
def test_k10_bf16_plain_matches_jax(kind, quality):
    """K10's bf16 plain version (JAX's bf16 JPEG steps spelled out: YCbCr in
    bf16 arithmetic, the chroma mean and block − 128 rounded to bf16, the
    DCTs in fp32, the result rounded to bf16) against JAX's jitted
    `jpeg_compress` on the same bf16 frames cast back (:707): within 3 bf16
    ulps, and more than one ulp on at most 1% of the pixels (8 frames of 64²;
    measured: at most 2.5 ulps, on 0.39% of the pixels at quality 60 on noise,
    a block whose coefficient rounds the other way where JAX's fused chain
    kept fp32; none on flat frames)."""
    from fac_fake_tpu.data.augment import jpeg_compress
    from fac_fake_torch.ops import jpeg as oj

    x = _frames(kind, n=8, h=64, w=64)
    q = (np.floor(np.random.default_rng(1).uniform(60, 100, len(x))) if quality == "seeded"
         else np.full(len(x), quality)).astype(np.float32)
    xt, xj = _bf16(x)
    ref = np.asarray(jax.jit(jax.vmap(lambda a, b: jpeg_compress(a, b).astype(jnp.bfloat16)))(
        xj, jnp.asarray(q)).astype(jnp.float32))
    got = oj.jpeg_compress_plain(xt, torch.from_numpy(q))
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - ref).max(-1)
    assert err.max() <= 3 * ULP and (err > ULP).mean() <= 0.01, (err.max(), (err > ULP).mean())
    if kind == "flat":
        assert err.max() == 0


def test_k10_bf16_plain_spells_out_the_bf16_steps():
    """The bf16 plain version's luma is JAX's `_rgb_to_ycbcr` on bf16 frames
    evaluated one rounded bf16 op at a time (eager JAX), bit for bit, and its
    result is the fp32 JPEG of those rounded planes rounded to bf16: an fp32
    frame's plain version differs."""
    from fac_fake_tpu.data.augment import _rgb_to_ycbcr
    from fac_fake_torch.ops import jpeg as oj

    x = _frames("noise", n=2, h=32, w=32, seed=5)
    xt, xj = _bf16(x)
    for got, ref in zip(oj.ycbcr_bf16(xt), _rgb_to_ycbcr(xj)):
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref.astype(jnp.float32)))
    q = torch.full((2,), 50.0)
    b = oj.jpeg_compress_plain(xt, q)
    f = oj.jpeg_compress_plain(xt.float(), q)
    assert b.dtype == torch.bfloat16 and not torch.equal(b, f.to(torch.bfloat16))


def _jax_strong_aug_draws(key, n, cfg):
    """JAX `augment_batch`'s draws for strong_aug (color_oneof off, the
    sharpen OneOf on, no FancyPCA, JPEG or blur), replayed from its key
    schedule (data/augment.py:660-830), as the port's `draw` names them."""
    from fac_fake_tpu.data.augment import _CAYLEY, _ROT90_ELEM, draw_sharpen_oneof
    ks = jax.random.split(key, 34)
    u = lambda k, shape=(n,), lo=0.0, hi=1.0: jax.random.uniform(k, shape, minval=lo, maxval=hi)
    outer = u(ks[0]) < cfg.compose_prob
    coin = lambda k, p=cfg.prob: (u(k) < p) & outer
    d = {"outer": outer, "take_hsv": coin(ks[4], cfg.hsv_prob)}
    d["take_clahe"], d["take_sharpen"], d["take_emboss"], d["take_bc"] = \
        draw_sharpen_oneof(ks[6], cfg, outer)
    elem = jnp.zeros((n,), jnp.int32)
    k4 = jax.random.randint(ks[12], (n,), 0, 4)
    elem = jnp.where(coin(ks[13], cfg.rot90_prob), jnp.take(jnp.asarray(_ROT90_ELEM), k4), elem)
    for e_op, kc, p in ((4, 14, cfg.transpose_prob), (1, 15, cfg.hflip_prob),
                        (2, 16, cfg.vflip_prob)):
        elem = jnp.where(coin(ks[kc], p), jnp.take(jnp.asarray(_CAYLEY)[e_op], elem), elem)
    d["elem"] = elem
    d["sharpen_alpha"], d["lightness"] = u(ks[25], lo=0.2, hi=0.5), u(ks[22], lo=0.5, hi=1.0)
    d["emboss_alpha"], d["strength"] = u(ks[26], lo=0.2, hi=0.5), u(ks[23], lo=0.2, hi=0.7)
    d["contrast"], d["brightness"] = u(ks[27], lo=-0.2, hi=0.2), u(ks[28], lo=-0.2, hi=0.2)
    d["dh"], d["dsat"] = u(ks[29], lo=-0.05, hi=0.05), u(ks[30], lo=-0.15, hi=0.15)
    d["dv"] = u(ks[31], lo=-0.15, hi=0.15)
    k1, k2, k3, k4 = jax.random.split(ks[33], 4)
    d["angle"] = u(k1, (), -1.0, 1.0) * cfg.rotation_deg * jnp.pi / 180.0
    d["scale"] = u(k2, (), 1.0 - cfg.scale_limit, 1.0 + cfg.scale_limit)
    d["take_affine"] = (u(k4) < cfg.affine_prob) & outer
    out = {k: torch.from_numpy(np.array(v)) for k, v in d.items()}
    out["elem"] = out["elem"].long()
    return out, k3


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bf16_chain_matches_jax_on_planned_draws(seed):
    """The port's bf16 strong_aug chain (`apply_draws` on ``bf16(u8)/255``)
    against JAX's bf16 `augment_batch` with the noise off, on JAX's own
    draws replayed for the port (32 images of 64², every op firing
    somewhere, CLAHE and HSV on their subsets): within 3 bf16 ulps, and any
    difference on at most 1% of the values (measured over the three seeds:
    bit-equal; a one-ulp difference ahead of CLAHE would move a pixel's luma
    bin and its tile's LUT by a level, which the 1% allows), and the same
    images left untouched. The port's chain on the same draws in fp32 is
    printed beside it (how far bf16 moves the chain: 0.035-0.066)."""
    from fac_fake_tpu.core.config import AugmentConfig as JaxAugmentConfig
    from fac_fake_tpu.data.augment import augment_batch as jax_augment
    from fac_fake_torch.core.config import AugmentConfig
    from fac_fake_torch.data.augment import apply_draws

    n, hw = 32, 64
    u8 = np.random.default_rng(seed).integers(0, 256, (n, hw, hw, 3), dtype=np.uint8)
    jcfg = JaxAugmentConfig(gauss_noise=False, compute_dtype="bfloat16")
    key = jax.random.key(seed)
    ref = np.asarray(jax_augment(key, jnp.asarray(u8), jcfg).astype(jnp.float32))
    d, k3 = _jax_strong_aug_draws(key, n, jcfg)
    d["shift"] = torch.from_numpy(np.array(jax.random.uniform(
        k3, (2,), minval=-jcfg.shift_limit, maxval=jcfg.shift_limit) * hw))
    cfg = AugmentConfig(gauss_noise=False)
    x = torch.from_numpy(u8).to(torch.bfloat16) / torch.full((1,), 255.0, dtype=torch.bfloat16)
    got = apply_draws(x, d, cfg).float().numpy()
    f32 = apply_draws(torch.from_numpy(u8).float() / 255.0, d, cfg).numpy()
    err = np.abs(got - ref)
    print(f"seed {seed}: bf16 port vs JAX max {err.max():.4g}, beyond 3 ulps "
          f"{(err > 3 * ULP).mean():.4%}; bf16 vs the port's fp32 chain max "
          f"{np.abs(got - f32).max():.4g}")
    assert err.max() <= 3 * ULP and (err > 0).mean() <= 0.01, (err.max(), (err > 0).mean())
    x01 = u8.astype(np.float32) / 255.0
    same = lambda a: np.all(np.abs(a - x01) <= ULP, axis=(1, 2, 3))
    np.testing.assert_array_equal(same(got), same(ref))

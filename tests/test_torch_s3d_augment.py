"""The S3D train transform in the port (`fac_fake_torch/data/augment.py`,
`ops/jpeg.py`) against the JAX package on the CPU: K10's plain version
`jpeg_compress_plain` against JAX's `jpeg_compress` by the near-tie rule, its
quality tables, the in-place step on the taken frames, Gaussian blur and
FancyPCA at fixed parameters, the random and the deterministic gray, the
coins of plan1_2's transform by their rates, and the chain's own invariants.
Inputs are made with numpy from a seed; each comparison states its
tolerance."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

QUALITIES = (1, 50, 60, 99, 100)


def _frames(kind, n=4, h=32, w=48, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "noise":
        u8 = rng.integers(0, 256, (n, h, w, 3))
    elif kind == "smooth":
        yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w), indexing="ij")
        base = rng.uniform(0, 255, (n, 1, 1, 3)) * (0.5 + 0.5 * np.sin(
            3 * yy + 2 * xx + rng.uniform(0, 6, (n, 1, 1)))[..., None])
        u8 = np.clip(base + rng.normal(0, 3, base.shape), 0, 255).round()
    else:
        u8 = np.full((n, h, w, 3), 128)
    return (u8.astype(np.float32) / np.float32(255.0)).astype(np.float32)


@pytest.mark.parametrize("kind", ["noise", "smooth", "flat"])
@pytest.mark.parametrize("quality", QUALITIES + ("seeded",))
def test_jpeg_plain_matches_jax(kind, quality):
    """`jpeg_compress_plain` against JAX's vmapped `jpeg_compress`: within
    JPEG_TOL (2e-5) outside the near-tie blocks (a coefficient within 1e-4 of
    a rounding boundary by a float64 recomputation of coef / table), and on a
    flat frame over every block; 8 frames of 64², 768 blocks, of which the
    near-tie ones at most 3% (64 coefficients a block, each in the
    2e-4-wide window with probability 2e-4 where its rounding is a coin, put
    1.27% of such blocks there, and a few hundred blocks spread that)."""
    from fac_fake_tpu.data.augment import jpeg_compress
    from fac_fake_torch.ops import jpeg as oj

    x = _frames(kind, n=8, h=64, w=64)
    q = (np.floor(np.random.default_rng(1).uniform(60, 100, len(x))) if quality == "seeded"
         else np.full(len(x), quality)).astype(np.float32)
    ref = np.asarray(jax.jit(jax.vmap(jpeg_compress))(jnp.asarray(x), jnp.asarray(q)))
    got = oj.jpeg_compress_plain(torch.from_numpy(x), torch.from_numpy(q)).numpy()
    mask, ties, blocks = oj.near_ties(torch.from_numpy(x), torch.from_numpy(q))
    err = np.abs(got - ref).max(-1)
    assert err[~mask.numpy()].max() <= oj.JPEG_TOL
    assert ties <= 0.03 * blocks, (ties, blocks)
    if kind == "flat":
        assert ties == 0 and err.max() <= oj.JPEG_TOL


def test_jpeg_quality_tables_equal_jax():
    """libjpeg's scaling of both Annex K tables at every quality 1-100 (and
    past the clip at 0 and 101), bit-equal."""
    from fac_fake_tpu.data.augment import _JPEG_CHROMA_Q, _JPEG_LUMA_Q, _jpeg_quality_table
    from fac_fake_torch.ops import jpeg as oj

    q = np.arange(0, 102, dtype=np.float32)
    for base, jbase in ((oj.LUMA_Q, _JPEG_LUMA_Q), (oj.CHROMA_Q, _JPEG_CHROMA_Q)):
        np.testing.assert_array_equal(base, np.asarray(jbase))
        ref = np.stack([np.asarray(_jpeg_quality_table(jbase, jnp.float32(v))) for v in q])
        np.testing.assert_array_equal(oj.quality_table(base, torch.from_numpy(q)).numpy(), ref)


def test_jpeg_step_on_the_taken_frames_in_place():
    """The chain's step (`jpeg_subset_` on CPU tensors, its plain version):
    taken frames become `jpeg_compress_plain` of themselves, the others keep
    their bits; H or W not a multiple of 16 raises."""
    from fac_fake_torch.ops import jpeg as oj

    x = torch.from_numpy(_frames("noise", n=6))
    take = torch.tensor([True, False, False, True, True, False])
    q = torch.tensor([60.0, 70.0, 80.0, 90.0, 99.0, 100.0])
    y = x.clone()
    assert oj.jpeg_subset_(y, take, q) is y
    assert torch.equal(y[~take], x[~take])
    assert torch.equal(y[take], oj.jpeg_compress_plain(x[take], q[take]))
    none = x.clone()
    assert torch.equal(oj.jpeg_subset_(none, torch.zeros(6, dtype=torch.bool), q), x)
    with pytest.raises(ValueError, match="multiples of 16"):
        oj.jpeg_compress_plain(torch.zeros((1, 24, 32, 3)), torch.ones(1))


def test_gaussian_blur_matches_jax():
    """GaussianBlur's kernel (cv2's k=3 taps) through the fused depthwise
    conv, with and without brightness-contrast folded in, against JAX's
    `_conv3x3_per_image`: within 1e-6."""
    from fac_fake_tpu.data.augment import _GAUSS3, _conv3x3_per_image
    from fac_fake_torch.data.augment import GAUSS3, conv3x3_per_image

    np.testing.assert_array_equal(GAUSS3.numpy(), np.asarray(_GAUSS3))
    x = _frames("noise", n=3)
    scale = np.array([1.0, 0.85, 1.15], np.float32)[:, None, None]
    kern = np.broadcast_to(np.asarray(_GAUSS3), (3, 3, 3)) * scale
    ref = np.asarray(_conv3x3_per_image(jnp.asarray(x), jnp.asarray(kern)))
    got = conv3x3_per_image(torch.from_numpy(x), torch.from_numpy(np.ascontiguousarray(kern)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)


def test_fancy_pca_matches_jax():
    """FancyPCA's per-image bias at fixed N(0, .1) alphas: each image's fp32
    RGB covariance and ``eigh`` as JAX's `augment_batch` computes them
    (:765-777), each eigenvector's sign aligned to JAX's (``eigh`` leaves it
    free, so the port's alphas take the sign that maps its eigenvector on
    JAX's): within 1e-6; the eigenvalues within 1e-5 of their scale (a few
    ulps: LAPACK and XLA solve the 3x3 problems apart)."""
    from fac_fake_torch.data.augment import fancy_pca_delta

    x = _frames("smooth", n=5, seed=3)
    alphas = (0.1 * np.random.default_rng(4).standard_normal((5, 3))).astype(np.float32)
    flatpx = jnp.asarray(x).reshape(5, -1, 3)
    centered = flatpx - flatpx.mean(axis=1, keepdims=True)
    cov = jnp.einsum("npc,npd->ncd", centered, centered) / flatpx.shape[1]
    evals, evecs = jnp.linalg.eigh(cov)
    ref = np.asarray(jnp.einsum("ncd,nd->nc", evecs, jnp.asarray(alphas) * evals))

    xt = torch.from_numpy(x)
    px = xt.reshape(5, -1, 3)
    c = px - px.mean(dim=1, keepdim=True)
    t_evals, t_evecs = torch.linalg.eigh(torch.einsum("npc,npd->ncd", c, c) / px.shape[1])
    np.testing.assert_allclose(t_evals.numpy(), np.asarray(evals), rtol=0,
                               atol=1e-5 * float(np.abs(np.asarray(evals)).max()))
    sign = np.sign(np.einsum("ncd,ncd->nd", t_evecs.numpy(), np.asarray(evecs)))
    assert np.all(sign != 0)
    got = fancy_pca_delta(xt, torch.from_numpy((alphas * sign).astype(np.float32)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)


def test_to_gray_random_and_planned_match_jax():
    """ToGray(p=.2) on its takers and the gray plan on every frame: the
    reference's luma weights, as JAX's `augment_batch` (:837-844), exact; the
    other frames keep their bits."""
    from fac_fake_torch.core.config import AugmentConfig
    from fac_fake_torch.data import augment as aug

    x = _frames("noise", n=4)
    gray = 0.299 * jnp.asarray(x)[..., 0] + 0.587 * jnp.asarray(x)[..., 1] \
        + 0.114 * jnp.asarray(x)[..., 2]
    take = np.array([True, False, True, False])
    ref = np.asarray(jnp.where(jnp.asarray(take)[:, None, None, None], gray[..., None],
                               jnp.asarray(x)))
    off = dict(enabled=True, hflip=False, vflip=False, rot90=False, transpose=False,
               gauss_noise=False, sharpen=False, emboss=False, brightness_contrast=False,
               hue_saturation=False, color_jitter=False, rotation_deg=0.0, clahe=False,
               sharpen_oneof=False)
    cfg = AugmentConfig(to_gray_prob=0.2, **off)
    d = {"take_gray": torch.from_numpy(take)}
    got = aug.apply_draws(torch.from_numpy(x), d, cfg)
    np.testing.assert_array_equal(got.numpy(), ref)
    planned = aug.apply_draws(torch.from_numpy(x), {}, AugmentConfig(to_gray=True, **off))
    np.testing.assert_array_equal(planned.numpy(),
                                  np.broadcast_to(np.asarray(gray)[..., None], x.shape))


def _plan_cfg():
    from fac_fake_torch.core.plans import load_plan
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return load_plan(os.path.join(root, "configs", "plan1_2.yaml")).data.augment


def test_s3d_coin_rates_within_binomial_bounds():
    """plan1_2's transform drawn for 40,000 frames: each coin's rate within
    5σ of its probability (ImageCompression .2, GaussianBlur .05·.5, the
    colour OneOf .4 split three ways and exclusive, ToGray .2, GaussNoise
    .3, hflip .5, ShiftScaleRotate .5); the qualities whole numbers in
    [60, 99], each within 5σ of 1/40."""
    from fac_fake_torch.data.augment import draw

    cfg = _plan_cfg()
    n = 40000
    d = draw(n, (2, 2), cfg, torch.Generator().manual_seed(0), "cpu")

    def near(k, p):
        r = float(d[k].float().mean())
        assert abs(r - p) <= 5 * (p * (1 - p) / n) ** 0.5, (k, r, p)

    for k, p in (("take_jpeg", 0.2), ("take_blur", 0.025), ("take_bc", 0.4 / 3),
                 ("take_pca", 0.4 / 3), ("take_hsv", 0.4 / 3), ("take_gray", 0.2),
                 ("take_noise", 0.3), ("take_affine", 0.5)):
        near(k, p)
    assert not bool((d["take_bc"] & d["take_pca"]).any() | (d["take_pca"] & d["take_hsv"]).any()
                    | (d["take_bc"] & d["take_hsv"]).any())
    assert float((d["elem"] == 1).float().mean()) == pytest.approx(0.5, abs=5 * (0.25 / n) ** 0.5)
    q = d["quality"]
    assert torch.equal(q, torch.floor(q)) and float(q.min()) == 60 and float(q.max()) == 99
    counts = torch.bincount(q.long() - 60, minlength=40).float() / n
    assert float((counts - 1 / 40).abs().max()) <= 5 * (1 / 40 * 39 / 40 / n) ** 0.5


def test_s3d_chain_keeps_its_input_runs_k10_once_and_draws_a_frame():
    """`augment_batch` under plan1_2's transform: one call of the JPEG step
    (through ``ops.jpeg.jpeg_subset_``, as on the card, where it is one
    launch of K10); `apply_draws` leaves its input alone and gives the same
    output twice, and with ``owned`` (as `augment_batch` calls it) the same
    output again, the JPEG step then working in place on the input, with no
    copy; a (B, T, H, W, 3) clip batch is its flattened frames drawn a
    frame; the output is in [0, 1]."""
    import dataclasses
    from fac_fake_torch.data import augment as aug
    from fac_fake_torch.ops import jpeg as oj

    cfg = _plan_cfg()
    u8 = torch.from_numpy(np.random.default_rng(5).integers(0, 256, (2, 4, 32, 32, 3),
                                                            dtype=np.uint8))
    calls = []
    real = oj.jpeg_subset_
    oj.jpeg_subset_ = lambda x, take, q: (calls.append(int(take.sum())), real(x, take, q))[1]
    try:
        clips = aug.augment_batch(u8, cfg, torch.Generator().manual_seed(7))
        frames = aug.augment_batch(u8.reshape(8, 32, 32, 3), cfg,
                                   torch.Generator().manual_seed(7))
    finally:
        oj.jpeg_subset_ = real
    assert len(calls) == 2
    assert torch.equal(clips.reshape(frames.shape), frames)
    assert float(clips.min()) >= 0 and float(clips.max()) <= 1
    x = u8.reshape(8, 32, 32, 3).float() / 255.0
    x0 = x.clone()
    d = aug.draw(8, (32, 32), cfg, torch.Generator().manual_seed(8), "cpu")
    d["take_jpeg"] = torch.ones(8, dtype=torch.bool)        # every frame through the step
    a, b = aug.apply_draws(x, d, cfg), aug.apply_draws(x, d, cfg)
    assert torch.equal(x, x0) and torch.equal(a, b) and not torch.equal(a, x0)
    assert torch.equal(aug.apply_draws(x.clone(), d, cfg, owned=True), a)
    only = dataclasses.replace(cfg, hflip=False, vflip=False, rot90=False, transpose=False,
                               gauss_noise=False, sharpen=False, emboss=False,
                               brightness_contrast=False, fancy_pca=False, gaussian_blur=False,
                               hue_saturation=False, color_jitter=False, to_gray_prob=0.0,
                               rotation_deg=0.0, clahe=False, sharpen_oneof=False,
                               color_oneof=False)
    jpeg = aug.apply_draws(x, d, only, owned=True)
    assert jpeg.data_ptr() == x.data_ptr() and not torch.equal(jpeg, x0)

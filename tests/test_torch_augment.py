"""The port's augmentation chain (`fac_fake_torch/data/augment.py`) and the
plain version of kernel K7 (`fac_fake_torch/ops/augment.py
clahe_luma_plain`) against the JAX package's on the CPU: each op at fixed
parameters within 1e-5, CLAHE on uint8-derived images (every changed
luma bin counted), the coins by their rates at a fixed seed, the Compose
coin's gating and the subset gather. The port's draws come from a
`torch.Generator` and are not `jax.random`'s, so the chain is compared op by
op and coin by coin, not draw by draw."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)


def _imgs(shape, seed=0):
    return (np.random.default_rng(seed).integers(0, 256, shape).astype(np.float32)
            / np.float32(255.0))


def test_dihedral_elements_match_jax():
    """Each of the 8 elements, one image each, equal to JAX's select."""
    from fac_fake_tpu.data.augment import _apply_dihedral
    from fac_fake_torch.data.augment import CAYLEY, apply_dihedral
    from fac_fake_tpu.data.augment import _CAYLEY

    np.testing.assert_array_equal(CAYLEY, _CAYLEY)
    x = _imgs((8, 6, 6, 3))
    elem = np.arange(8)
    ref = np.asarray(_apply_dihedral(jnp.asarray(x), jnp.asarray(elem, jnp.int32)))
    got = apply_dihedral(torch.from_numpy(x), torch.from_numpy(elem)).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("angle,scale,tx,ty", [(0.2, 1.07, 3.5, -2.0), (-0.29, 0.93, 0.0, 1.25)])
def test_batch_affine_matmul_matches_jax(angle, scale, tx, ty):
    from fac_fake_tpu.data.augment import batch_affine_matmul as jax_affine
    from fac_fake_torch.data.augment import batch_affine_matmul

    x = _imgs((2, 32, 32, 3), 1)
    ref = np.asarray(jax_affine(jnp.asarray(x), jnp.float32(angle), jnp.float32(scale),
                                jnp.float32(tx), jnp.float32(ty)))
    t = lambda v: torch.tensor(v, dtype=torch.float32)
    got = batch_affine_matmul(torch.from_numpy(x), t(angle), t(scale), t(tx), t(ty)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_depthwise_conv_with_sharpen_emboss_and_bc_kernels_matches_jax():
    """`conv3x3_per_image` with a sharpen, an emboss, a brightness-contrast
    scaled identity and an identity kernel, one an image."""
    from fac_fake_tpu.data.augment import (_conv3x3_per_image, _emboss_kernel,
                                           _sharpen_kernel, _IDENT3)
    from fac_fake_torch.data.augment import (IDENT3, conv3x3_per_image, emboss_kernel,
                                             sharpen_kernel)

    a = np.array([0.3, 0.45], np.float32)
    b = np.array([0.7, 0.25], np.float32)
    jk = jnp.stack([_sharpen_kernel(jnp.asarray(a[0]), jnp.asarray(b[0])),
                    _emboss_kernel(jnp.asarray(a[1]), jnp.asarray(b[1])),
                    _IDENT3 * 1.15, _IDENT3])
    tk = torch.cat([sharpen_kernel(torch.from_numpy(a[:1]), torch.from_numpy(b[:1])),
                    emboss_kernel(torch.from_numpy(a[1:]), torch.from_numpy(b[1:])),
                    (IDENT3 * 1.15)[None], IDENT3[None]])
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=0, atol=1e-7)
    x = _imgs((4, 12, 10, 3), 2)
    ref = np.asarray(_conv3x3_per_image(jnp.asarray(x), jk))
    np.testing.assert_allclose(conv3x3_per_image(torch.from_numpy(x), tk).numpy(), ref,
                               rtol=0, atol=1e-5)


def test_hsv_round_trip_matches_jax():
    from fac_fake_tpu.data.augment import _hsv_to_rgb_vec, _rgb_to_hsv_vec
    from fac_fake_torch.data.augment import hsv_to_rgb, rgb_to_hsv

    x = _imgs((2, 9, 9, 3), 3)
    x[0, 0, :3] = [[0.5, 0.5, 0.5], [1.0, 0.0, 0.0], [0.0, 1.0, 1.0]]   # gray, pure hues
    hsv = np.asarray(_rgb_to_hsv_vec(jnp.asarray(x)))
    np.testing.assert_allclose(rgb_to_hsv(torch.from_numpy(x)).numpy(), hsv, rtol=0, atol=1e-5)
    shifted = hsv + np.array([0.04, -0.1, 0.1], np.float32)
    shifted[..., 1:] = np.clip(shifted[..., 1:], 0, 1)
    ref = np.asarray(_hsv_to_rgb_vec(jnp.asarray(shifted)))
    np.testing.assert_allclose(hsv_to_rgb(torch.from_numpy(shifted)).numpy(), ref,
                               rtol=0, atol=1e-5)


def _clahe_inputs():
    rng = np.random.default_rng(4)
    every = (np.arange(64 * 64 * 3) % 256).reshape(1, 64, 64, 3)
    return {
        "seeded": rng.integers(0, 256, (3, 64, 64, 3)),
        "flat": np.full((1, 64, 64, 3), 127),                      # all clipped, residual
        "every_byte": every,
        "dark_gradient": np.clip(np.linspace(0, 40, 64)[None, :, None, None]
                                 + rng.normal(0, 3, (1, 64, 64, 3)), 0, 255).astype(int),
        "grid1_odd_tiles": rng.integers(0, 256, (2, 40, 40, 3)),   # 5-px tiles
        "grid1_tiny": rng.integers(0, 256, (2, 8, 8, 3)),          # 1-px tiles
        "full_size": rng.integers(0, 256, (1, 224, 224, 3)),
    }


@pytest.mark.parametrize("case", list(_clahe_inputs()))
def test_clahe_plain_matches_jax(case):
    """K7's plain version against JAX's `clahe_luma` on uint8-derived images
    (the trainer's inputs): within 1e-5; every pixel whose luma bin or LUT
    value would differ is counted (none does)."""
    from fac_fake_tpu.data.augment import clahe_luma as jax_clahe
    from fac_fake_torch.ops.augment import clahe_grid, clahe_luma, clahe_luma_plain

    x = (_clahe_inputs()[case].astype(np.uint8).astype(np.float32) / np.float32(255.0))
    ref = np.stack([np.asarray(jax_clahe(jnp.asarray(im))) for im in x])
    got = clahe_luma_plain(torch.from_numpy(x)).numpy()
    assert torch.equal(clahe_luma(torch.from_numpy(x)), torch.from_numpy(got))  # CPU: plain
    flipped = int((np.abs(got - ref) > 0.5 / 255).any(-1).sum())
    print(f"{case}: grid {clahe_grid(*x.shape[1:3])}, max abs {np.abs(got - ref).max():.3g}, "
          f"{flipped} pixels off by half a level or more")
    assert flipped == 0
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    if case == "flat":
        assert not np.array_equal(got, x)   # equalization moved it


_TAKE_PATTERNS = {              # (takers, budget) of 16 images
    "no_takers": ((), 4),
    "fewer_than_budget": ((3, 11), 4),
    "more_than_budget": ((0, 2, 5, 6, 9, 13, 15), 4),       # 9, 13, 15 stay untouched
    "all_at_budget_n": (tuple(range(16)), 16),              # JAX's where branch
}


@pytest.mark.parametrize("hw", [32, 40, 8])                 # grid 8; grid 1 (5-px, 1-px tiles)
@pytest.mark.parametrize("pattern", list(_TAKE_PATTERNS))
def test_clahe_subset_matches_jax(pattern, hw):
    """`clahe_subset_` on CPU tensors (its plain version) against JAX's
    `_subset_apply` over a vmapped `clahe_luma`, bit for bit, in place."""
    import jax
    from fac_fake_tpu.data.augment import _subset_apply
    from fac_fake_tpu.data.augment import clahe_luma as jax_clahe
    from fac_fake_torch.ops.augment import clahe_subset_

    takers, kb = _TAKE_PATTERNS[pattern]
    x = _imgs((16, hw, hw, 3), 9)
    take = np.zeros(16, bool)
    take[list(takers)] = True
    eq = jax.vmap(lambda im: jax_clahe(im, 2.0))
    ref = np.asarray(_subset_apply(jnp.asarray(x), jnp.asarray(take), kb, eq))
    if kb == 16:
        where = jnp.where(jnp.asarray(take)[:, None, None, None], eq(jnp.asarray(x)), x)
        np.testing.assert_array_equal(ref, np.asarray(where))
    xt = torch.from_numpy(x.copy())
    out = clahe_subset_(xt, torch.from_numpy(take), kb)
    assert out is xt
    np.testing.assert_array_equal(out.numpy(), ref)
    done = np.flatnonzero(take)[:kb]
    rest = np.setdiff1d(np.arange(16), done)
    np.testing.assert_array_equal(out.numpy()[rest], x[rest])   # non-takers and extra takers
    assert not np.array_equal(out.numpy()[done], x[done]) or len(done) == 0


# sha256 of `apply_draws`' output (first 16 hex digits) on the CPU, taken
# before the CLAHE step became one in-place call of `clahe_subset_`
_APPLY_DRAWS_DIGESTS = {True: "f6084469eaecb29c", False: "27353968c828fbf6"}


@pytest.mark.parametrize("oneof", [True, False])
def test_apply_draws_keeps_its_input_and_its_output(oneof):
    """strong_aug at batch 32 with 10 CLAHE takers: the OneOf chain runs
    the subset of 8 (2 takers past it), the legacy chain JAX's where branch
    (a budget of 32). The caller's tensor is not written, and the output is
    the one pinned above. The affine's coins are all off: its einsums round
    as the CPU's BLAS does, and where() then keeps the input's bits."""
    import hashlib

    from fac_fake_torch.core.config import AugmentConfig
    from fac_fake_torch.data.augment import apply_draws, draw

    cfg = AugmentConfig(sharpen_oneof=oneof)
    x = torch.from_numpy(_imgs((32, 32, 32, 3), 8))
    d = draw(32, (32, 32), cfg, torch.Generator().manual_seed(5), "cpu")
    d["take_clahe"] = torch.zeros(32, dtype=torch.bool)
    d["take_clahe"][[1, 4, 5, 9, 12, 17, 20, 26, 28, 31]] = True
    d["take_affine"] = torch.zeros(32, dtype=torch.bool)
    before = x.clone()
    out = apply_draws(x, d, cfg)
    assert torch.equal(x, before)
    assert hashlib.sha256(out.numpy().tobytes()).hexdigest()[:16] == _APPLY_DRAWS_DIGESTS[oneof]


def test_clahe_grid_rule():
    from fac_fake_torch.ops.augment import clahe_grid
    assert clahe_grid(224, 224) == 8 and clahe_grid(64, 64) == 8
    assert clahe_grid(40, 40) == 1 and clahe_grid(8, 8) == 1
    with pytest.raises(ValueError, match="divide"):
        clahe_grid(68, 64)


def test_subset_budget_matches_jax():
    from fac_fake_tpu.data.augment import _subset_budget
    from fac_fake_torch.data.augment import subset_budget
    for n in (8, 16, 32, 96, 256):
        for p in (0.045, 0.18, 0.45, 0.9):
            assert subset_budget(n, p) == _subset_budget(n, p)
    assert subset_budget(32, 0.9 * 0.2 / 4) == 8          # the trainer's CLAHE subset


def test_subset_apply_leaves_non_takers_bit_unchanged():
    from fac_fake_torch.data.augment import subset_apply
    x = torch.from_numpy(_imgs((32, 4, 4, 3), 5))
    take = torch.zeros(32, dtype=torch.bool)
    take[[3, 17, 30]] = True
    out = subset_apply(x, take, 8, lambda s: 1.0 - s)
    assert torch.equal(out[~take], x[~take])
    assert torch.equal(out[take], 1.0 - x[take])
    # over budget: the first takers in order are transformed, the rest kept
    take[:] = True
    out = subset_apply(x, take, 8, lambda s: 1.0 - s)
    assert torch.equal(out[:8], 1.0 - x[:8]) and torch.equal(out[8:], x[8:])


def test_coin_rates_within_binomial_bounds():
    """One draw of the default chain's coins for 20000 images at a fixed
    seed: each rate within 5σ of the reference's probability."""
    from fac_fake_torch.core.config import AugmentConfig
    from fac_fake_torch.data.augment import draw

    n = 20000
    cfg = AugmentConfig()
    d = draw(n, (8, 8), cfg, torch.Generator().manual_seed(0), "cpu")
    want = {"outer": 0.9, "take_hsv": 0.9 * 0.2, "take_noise": 0.9 * 0.2,
            "take_affine": 0.9 * 0.5, "take_clahe": 0.9 * 0.2 / 4, "take_sharpen": 0.9 * 0.2 / 4,
            "take_emboss": 0.9 * 0.2 / 4, "take_bc": 0.9 * 0.2 / 4}
    for k, p in want.items():
        rate = float(d[k].float().mean())
        assert abs(rate - p) <= 5 * (p * (1 - p) / n) ** 0.5, (k, rate, p)
    # the OneOf group's members are exclusive
    assert int((d["take_clahe"].int() + d["take_sharpen"].int() + d["take_emboss"].int()
                + d["take_bc"].int()).max()) == 1
    # the dihedral element's distribution, enumerated from the four coins,
    # rot90's k and the Cayley table
    import itertools
    from fac_fake_torch.data.augment import CAYLEY, ROT90_ELEM
    want_elem = np.zeros(8)
    want_elem[0] += 0.1                                    # the Compose coin missed
    for rot, tr_, hf, vf in itertools.product((0, 1), repeat=4):
        for k in range(4):
            e = int(ROT90_ELEM[k]) if rot else 0
            pr = 0.9 * (0.2 / 4 if rot else 0.8) * (0.2 if tr_ else 0.8) * 0.5 * 0.5
            for flag, op in ((tr_, 4), (hf, 1), (vf, 2)):
                e = int(CAYLEY[op, e]) if flag else e
            want_elem[e] += pr / (1 if rot else 4)
    assert abs(want_elem.sum() - 1) < 1e-12
    for e in range(8):
        rate = float((d["elem"] == e).float().mean())
        p = want_elem[e]
        assert abs(rate - p) <= 5 * (p * (1 - p) / n) ** 0.5, (e, rate, p)
    legacy = AugmentConfig(sharpen_oneof=False)
    d = draw(n, (8, 8), legacy, torch.Generator().manual_seed(1), "cpu")
    for k in ("take_clahe", "take_sharpen", "take_emboss", "take_bc"):
        p = 0.9 * 0.5
        assert abs(float(d[k].float().mean()) - p) <= 5 * (p * (1 - p) / n) ** 0.5, k


def test_compose_prob_gates_everything():
    """compose_prob 0: the batch comes back as its uint8 values / 255, bit
    for bit, whatever the per-op probabilities; compose_prob 1 with every
    op certain changes every image."""
    from fac_fake_torch.core.config import AugmentConfig
    from fac_fake_torch.data.augment import augment_batch

    u8 = torch.from_numpy(np.random.default_rng(6).integers(0, 256, (16, 32, 32, 3),
                                                            dtype=np.uint8))
    plain = u8.float() / torch.full((1,), 255.0)
    probs = dict(prob=1.0, rot90_prob=1.0, transpose_prob=1.0, hflip_prob=1.0, vflip_prob=1.0,
                 noise_prob=1.0, hsv_prob=1.0, affine_prob=1.0, sharpen_oneof_prob=1.0)
    out = augment_batch(u8, AugmentConfig(compose_prob=0.0, **probs),
                        torch.Generator().manual_seed(0))
    assert torch.equal(out, plain)
    out = augment_batch(u8, AugmentConfig(compose_prob=1.0, **probs),
                        torch.Generator().manual_seed(0))
    assert bool((out != plain).flatten(1).any(1).all())
    assert out.dtype == torch.float32 and float(out.min()) >= 0 and float(out.max()) <= 1


@pytest.mark.parametrize("oneof", [True, False])
def test_augment_batch_is_seeded_and_in_range(oneof):
    """The default chain (and the legacy independent-coin mode): the same
    generator seed gives the same batch, another seed another; values in
    [0, 1]; clips (B, T, H, W, 3) draw a frame."""
    from fac_fake_torch.core.config import AugmentConfig
    from fac_fake_torch.data.augment import augment_batch

    cfg = AugmentConfig(sharpen_oneof=oneof)
    u8 = torch.from_numpy(np.random.default_rng(7).integers(0, 256, (32, 32, 32, 3),
                                                            dtype=np.uint8))
    a = augment_batch(u8, cfg, torch.Generator().manual_seed(3))
    b = augment_batch(u8, cfg, torch.Generator().manual_seed(3))
    c = augment_batch(u8, cfg, torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.shape == u8.shape and float(a.min()) >= 0 and float(a.max()) <= 1
    clips = augment_batch(u8.reshape(4, 8, 32, 32, 3), cfg, torch.Generator().manual_seed(3))
    assert torch.equal(clips.reshape(a.shape), a)


@pytest.mark.parametrize("field,value", [("image_compression", True), ("gaussian_blur", True),
                                         ("fancy_pca", True), ("to_gray", True),
                                         ("to_gray_prob", 0.2), ("color_oneof", True)])
def test_s3d_transform_extras_raise(field, value):
    from fac_fake_torch.core.config import AugmentConfig
    from fac_fake_torch.data.augment import augment_batch
    with pytest.raises(NotImplementedError, match="item 13"):
        augment_batch(torch.zeros((2, 8, 8, 3), dtype=torch.uint8),
                      AugmentConfig(**{field: value}), torch.Generator())

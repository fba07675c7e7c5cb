"""The port's BlazeFace and K1's plain version against the JAX package on the
CPU, on the packaged weights and on planted detections."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)


def _tiles(seed, n=6):
    """Seeded 128² tiles: smooth blobs on noise, so the detector fires on
    some anchors (real weights) and not on others."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:128, 0:128]
    out = rng.integers(0, 256, (n, 128, 128, 3)).astype(np.float32)
    for i in range(n):
        cy, cx, r = rng.uniform(30, 98), rng.uniform(30, 98), rng.uniform(15, 40)
        blob = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * r * r))[..., None]
        out[i] = out[i] * (1 - blob) + blob * rng.uniform(80, 220, 3)
    return np.clip(out, 0, 255).astype(np.uint8)


def planted(seed, f, t, ties=True):
    """(F·T, 896, 17) tile dets in [0, 1] units: three overlapping clusters
    per tile with scores ≥ 0.75, exact score ties, one zero-area box."""
    rng = np.random.default_rng(seed)
    dets = rng.uniform(0.0, 0.8, (f * t, 896, 17)).astype(np.float32)
    dets[..., 2:4] = dets[..., 0:2] + 0.15
    dets[..., 16] = rng.uniform(0.0, 0.7, (f * t, 896))
    for k in range(f * t):
        for c in range(3):
            y, x = rng.uniform(0.05, 0.6, 2)
            for j in range(5):
                a = 40 * c + 7 * j
                jit = rng.normal(0, 0.01, 2)
                dets[k, a, :4] = [y + jit[0], x + jit[1], y + 0.3 + jit[0], x + 0.3 + jit[1]]
                dets[k, a, 16] = 0.9 if (ties and j < 2) else rng.uniform(0.75, 0.95)
        dets[k, 500, :4] = [0.5, 0.5, 0.5, 0.5]
        dets[k, 500, 16] = 0.97
    return dets, dets[..., 16] >= 0.75


def test_raw_detections_match_jax_on_packaged_weights():
    from fac_fake_tpu.detect.blazeface import BlazeFace as JaxBlazeFace
    from fac_fake_torch.detect.blazeface import BlazeFace

    x = _tiles(0)
    jd, jv = JaxBlazeFace.from_packaged_assets().predict_on_batch(x, apply_nms=False)
    td, tv = BlazeFace.from_packaged_assets(device="cpu").predict_on_batch(x, apply_nms=False)
    jd, jv = np.asarray(jd), np.asarray(jv)
    assert td.shape == (6, 896, 17) and tv.shape == (6, 896)
    np.testing.assert_allclose(td.numpy(), jd, rtol=1e-4, atol=1e-4)  # fp32 convs
    assert np.array_equal(tv.numpy(), jv)
    assert jv.any() and not jv.all()
    # NMS on, per image (K1's wrapper with no affine or margin)
    jf, jm = JaxBlazeFace.from_packaged_assets().predict_on_batch(x)
    tf_, tm = BlazeFace.from_packaged_assets(device="cpu").predict_on_batch(x)
    jf, jm = np.asarray(jf), np.asarray(jm)
    assert np.array_equal(tm.numpy(), jm)
    np.testing.assert_allclose(tf_.numpy()[jm], jf[jm], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("t,hw", [(3, (1080, 1920)), (1, (1920, 1080))])
def test_frame_detections_plain_matches_jax(t, hw):
    """Landscape (T=3) and portrait (T=1): mask exact, faces within 1e-5
    relative / 1e-3 px (fp32 sums in JAX, fp64 in the port)."""
    from fac_fake_tpu.detect import extractor as jex
    from fac_fake_torch.detect import extractor as tex

    f = 5
    dets, valid = planted(t, f, t)
    split = float(min(hw))
    _, _, offs = tex.tile_geometry(*hw)
    offs = np.asarray(offs, np.float32)
    jf, jm = jex._frame_detections(jnp.asarray(dets), jnp.asarray(valid), jnp.float32(split),
                                   jnp.asarray(offs), jnp.asarray(hw, jnp.float32), t)
    tf_, tm = tex._frame_detections(torch.from_numpy(dets), torch.from_numpy(valid),
                                    split, offs, hw, t)
    jf, jm = np.asarray(jf), np.asarray(jm)
    assert tf_.shape == (f, 8, 17)
    assert np.array_equal(tm.numpy(), jm)
    assert jm.sum() >= 4 * f
    np.testing.assert_allclose(tf_.numpy()[jm], jf[jm], rtol=1e-5, atol=1e-3)
    # the zero-area box is never in its own cluster: it is emitted verbatim
    zero = jf[..., 0] == jf[..., 2]
    assert (zero & jm).any()


def test_weighted_nms_single_image_matches_jax():
    from fac_fake_tpu.detect.blazeface import weighted_nms as jax_nms
    from fac_fake_torch.detect.blazeface import weighted_nms

    dets, valid = planted(7, 1, 1)
    dets, valid = dets[0], valid[0]
    jf, jm = jax_nms(jnp.asarray(dets), jnp.asarray(valid))
    tf_, tm = weighted_nms(torch.from_numpy(dets), torch.from_numpy(valid))
    jf, jm = np.asarray(jf), np.asarray(jm)
    assert np.array_equal(tm.numpy(), jm)
    np.testing.assert_allclose(tf_.numpy()[jm], jf[jm], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("steps", [0, 1, 3])
def test_frame_detections_plain_steps_are_a_prefix(steps):
    """The scan's first k steps are the first k rows of a longer run, down to
    no step at all ((F, 0, 17) faces and (F, 0) mask, as K1 writes them)."""
    from fac_fake_torch.detect import extractor as tex

    dets, valid = planted(3, 4, 3)
    d = torch.from_numpy(dets).reshape(4, 3 * 896, 17)
    v = torch.from_numpy(valid).reshape(4, 3 * 896)
    offs = torch.tensor([[0.0, 0.0], [0.0, 420.0], [0.0, 840.0]])
    args = (1080.0, offs, (1080.0, 1920.0))
    f8, m8 = tex.frame_detections(d, v, *args, max_out=8)
    fk, mk = tex.frame_detections(d, v, *args, max_out=steps)
    assert fk.shape == (4, steps, 17) and mk.shape == (4, steps) and mk.dtype == torch.bool
    assert torch.equal(fk, f8[:, :steps]) and torch.equal(mk, m8[:, :steps])


def test_kernel_wrappers_raise_on_bad_cuda_input_not_fall_back():
    """A CUDA tensor never takes the plain path: the wrappers check it and
    launch or raise. Here (no card) a non-CUDA tensor the CUDA checks would
    refuse shows the check fires before any launch."""
    from fac_fake_torch import kernels

    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.require_cuda(torch.zeros(2, 17), "dets", torch.float32)


def test_blazeface_defaults_to_cuda_and_raises_without_it():
    from fac_fake_torch.detect.blazeface import BlazeFace

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BlazeFace.from_packaged_assets()

"""Face-region masking in the port (`fac_fake_torch/data/masking.py`, the
masking in `data/clips.py`) against the JAX package on the CPU: the region
geometry, the masks at a fixed ``rng`` bit for bit (black, noise, and the
68-landmark variants), the BlazeFace adapter, `LandmarkCache`'s tag and its
stale-file path, and `ClipDataset`'s masking, ``pos_weight`` and padded last
batch on a cv2-written crop tree. Inputs are made with numpy from a seed."""
import os

import cv2
import numpy as np
import pytest
import torch

torch.set_num_threads(2)


def _landmarks(rng, h=64, w=64):
    """Plausible 5-point landmarks (eyes, nose, mouth corners) in a face crop."""
    ey, my = rng.uniform(0.3, 0.4) * h, rng.uniform(0.65, 0.75) * h
    return np.array([[rng.uniform(0.25, 0.35) * w, ey], [rng.uniform(0.65, 0.75) * w, ey + 1],
                     [0.5 * w, 0.5 * h], [rng.uniform(0.3, 0.4) * w, my],
                     [rng.uniform(0.6, 0.7) * w, my]])


@pytest.mark.parametrize("method,n", [("black", 4), ("black", 6), ("noise", 4),
                                      ("black68", 3), ("noise68", 3)])
def test_masks_equal_jax_at_a_fixed_rng(method, n):
    """Masks of seeded images at seeded landmarks and region orders, from
    generators seeded alike: equal to JAX's bit for bit, and so are the
    regions and the 68-point interpolation; no landmarks, no mask."""
    from fac_fake_tpu.data import masking as jm
    from fac_fake_torch.data import masking as tm

    rng = np.random.default_rng(hash((method, n)) % 1000)
    for _ in range(4):
        img = rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
        lm = _landmarks(rng)
        order = rng.permutation(8).tolist()
        seed = int(rng.integers(1 << 30))
        if method.endswith("68"):
            p68 = tm.interpolate_68_from_5(lm, 64, 64)
            np.testing.assert_array_equal(p68, jm.interpolate_68_from_5(lm, 64, 64))
            assert tm.mask_regions_68(64, 64, p68) == jm.mask_regions_68(64, 64, p68)
            got = tm.apply_face_mask_68(img, p68, order, method, np.random.default_rng(seed))
            ref = jm.apply_face_mask_68(img, p68, order, method, np.random.default_rng(seed))
        else:
            assert tm.mask_regions(64, 64, lm) == jm.mask_regions(64, 64, lm)
            got = tm.apply_face_mask(img, lm, order, method, n, np.random.default_rng(seed))
            ref = jm.apply_face_mask(img, lm, order, method, n, np.random.default_rng(seed))
        assert got.dtype == np.uint8 and not np.array_equal(got, img)
        np.testing.assert_array_equal(got, ref)
    assert tm.apply_face_mask(img, None, order, "black", n) is img
    with pytest.raises(ValueError, match="black|noise"):
        tm.apply_face_mask(img, lm, order, "blur", n)


class _Stub:
    """A detector that returns one face at fixed 128-tile keypoints, the
    subject's eyes in either order, and counts its calls."""

    def __init__(self, swap=False, found=True, as_torch=True):
        self.calls, self.swap, self.found, self.as_torch = 0, swap, found, as_torch

    def predict_on_batch(self, tiles):
        self.calls += 1
        assert tiles.shape == (1, 128, 128, 3) and tiles.dtype == np.uint8
        faces = np.zeros((1, 8, 17), np.float32)
        eyes = [[0.62, 0.40], [0.38, 0.41]] if self.swap else [[0.38, 0.40], [0.62, 0.41]]
        faces[0, 0, 4:16] = np.array(eyes + [[0.5, 0.55], [0.5, 0.72], [0.2, 0.6],
                                             [0.8, 0.6]], np.float32).ravel()
        mask = np.zeros((1, 8), bool)
        mask[0, 0] = self.found
        return (torch.from_numpy(faces), torch.from_numpy(mask)) if self.as_torch \
            else (faces, mask)


@pytest.mark.parametrize("swap", [False, True])
def test_blazeface_adapter_matches_jax(swap):
    """`landmarks_from_blazeface` with a stub detector (the tile is the
    port's INTER_AREA resize, which equals cv2's): the eyes in image order,
    the mouth corners ±0.4 × the inter-ocular distance around the mouth
    keypoint, equal to JAX's; no face, None."""
    from fac_fake_tpu.data import masking as jm
    from fac_fake_torch.data import masking as tm

    img = np.random.default_rng(2).integers(0, 256, (224, 160, 3), dtype=np.uint8)
    got = tm.landmarks_from_blazeface(_Stub(swap), img)
    ref = jm.landmarks_from_blazeface(_Stub(swap, as_torch=False), img)
    np.testing.assert_array_equal(got, ref)
    assert got[0, 0] < got[1, 0]
    assert tm.landmarks_from_blazeface(_Stub(found=False), img) is None


def test_landmark_cache_tag_and_stale_files(tmp_path):
    """`LandmarkCache` keys entries ``{id}.lmv2.npy``: a hit is read without
    detecting; an entry of the old schema (``.lmv1``) is never read; a torn
    file is removed and detected again; a frame with no face writes
    nothing; `cleanup` removes the entries."""
    from fac_fake_torch.data import masking as tm

    det = _Stub()
    cache = tm.LandmarkCache(str(tmp_path), detector=det)
    img = np.zeros((64, 64, 3), np.uint8)
    np.save(tmp_path / "a.lmv1.npy", np.full((5, 2), -1.0))
    lm = cache.get(img, "a")
    assert det.calls == 1 and lm[0, 0] >= 0
    assert sorted(os.listdir(tmp_path)) == ["a.lmv1.npy", "a.lmv2.npy"]
    np.testing.assert_array_equal(cache.get(img, "a"), lm)
    assert det.calls == 1
    (tmp_path / "b.lmv2.npy").write_bytes(b"torn")
    np.testing.assert_array_equal(cache.get(img, "b"), lm)
    assert det.calls == 2 and np.load(tmp_path / "b.lmv2.npy").shape == (5, 2)
    assert tm.LandmarkCache(str(tmp_path), detector=_Stub(found=False)).get(img, "c") is None
    assert not (tmp_path / "c.lmv2.npy").exists()
    cache.cleanup()
    assert os.listdir(tmp_path) == []


@pytest.fixture(scope="module")
def crop_tree(tmp_path_factory):
    """Five per-video folders of 24 png crops at 32², labels from the path
    (three fake, two real)."""
    root = tmp_path_factory.mktemp("mask_clips")
    rng = np.random.default_rng(17)
    for label, vid in (("fake", "v0"), ("real", "v1"), ("fake", "v2"), ("real", "v3"),
                       ("fake", "v4")):
        d = root / label / vid
        d.mkdir(parents=True)
        base = rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)
        for i in range(24):
            img = np.clip(base.astype(int) + rng.integers(-20, 21, base.shape), 0, 255)
            cv2.imwrite(str(d / f"{i:04d}.png"), img.astype(np.uint8))
    return str(root)


@pytest.mark.parametrize("method", ["black", "noise", "noise68"])
def test_clip_dataset_masking_pos_weight_and_padded_batch_equal_jax(crop_tree, tmp_path, method):
    """`ClipDataset` with masking on the cv2-written tree, both packages'
    landmark caches on the same stub detector: each clip bit-equal to JAX's
    from generators seeded alike (the region order a clip, the noise a
    frame), the generators left alike; ``pos_weight`` (#real/#fake) JAX's;
    ``batches(drop_last=False)``: JAX's batches, the last padded with zero
    clips whose ``mask`` is 0."""
    from fac_fake_tpu.data.clips import ClipDataset as JaxClips
    from fac_fake_tpu.data.masking import LandmarkCache as JaxCache
    from fac_fake_torch.data.clips import ClipDataset, discover_video_folders
    from fac_fake_torch.data.masking import LandmarkCache

    samples = discover_video_folders(crop_tree)
    kw = dict(frames_per_video=16, image_size=32, mask_method=method, mask_number=5)
    ours = ClipDataset(samples, landmark_tempdir=str(tmp_path / "t"), device="cpu", **kw)
    ref = JaxClips(samples, landmark_tempdir=str(tmp_path / "j"), **kw)
    ours.landmarks = LandmarkCache(str(tmp_path / "t"), detector=_Stub())
    ref._lm_cache = JaxCache(str(tmp_path / "j"), detector=_Stub(as_torch=False))
    assert ours.samples == ref.samples and ours.pos_weight() == ref.pos_weight() == 2 / 3
    r1, r2 = np.random.default_rng(3), np.random.default_rng(3)
    for i in range(len(ours)):
        a, b = ours.load_clip(i, r1), ref.load_clip(i, r2)
        assert a.shape == (16, 32, 32, 3)
        np.testing.assert_array_equal(a, b)
    assert r1.random() == r2.random()
    clean = ClipDataset(samples, frames_per_video=16, image_size=32).load_clip(
        0, np.random.default_rng(3))
    assert not np.array_equal(clean, ours.load_clip(0, np.random.default_rng(3)))
    got = list(ours.batches(2, shuffle=False, drop_last=False, num_workers=2))
    want = list(ref.batches(2, shuffle=False, drop_last=False, num_workers=2))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        for k in ("image", "label", "mask"):
            np.testing.assert_array_equal(g[k], w[k])
    np.testing.assert_array_equal(got[-1]["mask"], [1.0, 0.0])
    assert not got[-1]["image"][1].any()
    assert len(list(ours.batches(2, shuffle=False, num_workers=2))) == 2    # drop_last

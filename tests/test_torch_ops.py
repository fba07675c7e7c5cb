"""Port ops against the JAX package and cv2: normalize (K2's plain path),
aggregation, and the cv2-free INTER_AREA resize."""
import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)


def test_normalize_imagenet_matches_jax():
    from fac_fake_tpu.ops.preprocess import normalize_imagenet as jax_norm
    from fac_fake_torch.ops.preprocess import normalize_imagenet

    crops = np.random.default_rng(0).integers(0, 256, (3, 224, 224, 3), dtype=np.uint8)
    ref = np.asarray(jax_norm(jnp.asarray(crops)))
    got = normalize_imagenet(torch.from_numpy(crops))
    # NCHW shape over NHWC memory, so the first conv reads it with no copy
    assert got.shape == (3, 3, 224, 224)
    assert got.is_contiguous(memory_format=torch.channels_last)
    # same fp32 operation order as JAX: tolerance 1e-6
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref, rtol=0, atol=1e-6)
    # bf16 is the fp32 result rounded to nearest even
    bf = normalize_imagenet(torch.from_numpy(crops), torch.bfloat16)
    assert torch.equal(bf, got.to(torch.bfloat16))


@pytest.mark.parametrize("count", [0, 2, 3, 40, 120])
def test_aggregate_probs_matches_jax(count):
    from fac_fake_tpu.infer.aggregate import aggregate_probs as jax_agg
    from fac_fake_torch.infer.aggregate import aggregate_probs

    cap = max(128, count)
    logits = np.random.default_rng(count).normal(0, 2, (cap, 2)).astype(np.float32)
    c = min(count, 90)
    ref = float(jax_agg(jnp.asarray(logits), jnp.asarray(c)))
    got = float(aggregate_probs(torch.from_numpy(logits), c))
    assert abs(got - ref) <= 1e-6   # fp32 sums in another order
    if count <= 2:
        assert got == 0.5
    # batched over videos: one score per leading index
    two = aggregate_probs(torch.from_numpy(np.stack([logits, logits])), torch.tensor([c, c]))
    assert two.shape == (2,) and abs(float(two[1]) - ref) <= 1e-6


# (src h, src w) -> (dst w, dst h): 1080p→128 tiles, faces of 90-600 px→224,
# integer and fractional downscales, upscales and mixed
RESIZE_CASES = [
    ((1080, 1920), (228, 128)), ((1920, 1080), (128, 228)), ((720, 1280), (228, 128)),
    ((100, 100), (128, 128)), ((90, 90), (224, 224)), ((448, 448), (224, 224)),
    ((672, 448), (224, 224)), ((600, 600), (224, 224)), ((300, 250), (224, 224)),
    ((150, 400), (224, 224)), ((113, 97), (224, 224)), ((250, 224), (224, 224)),
    ((224, 224), (224, 224)),
]


@pytest.mark.parametrize("src,dst", RESIZE_CASES)
def test_resize_area_equals_cv2(src, dst):
    from fac_fake_torch.ops.resize import resize_area

    img = np.random.default_rng(sum(src)).integers(0, 256, (*src, 3), dtype=np.uint8)
    got = resize_area(img, dst)
    ref = cv2.resize(img, dst, interpolation=cv2.INTER_AREA)
    assert got.shape == ref.shape and got.dtype == np.uint8
    # pixel-for-pixel equality (no LSB allowance needed on these sizes)
    assert int(np.count_nonzero(got != ref)) == 0


def test_resize_area_random_sizes_equal_cv2():
    from fac_fake_torch.ops.resize import resize_area

    rng = np.random.default_rng(5)
    for trial in range(40):
        h, w = (int(v) for v in rng.integers(8, 400, 2))
        dh, dw = (int(v) for v in rng.integers(4, 300, 2))
        if trial % 3 == 0:
            dh, dw = max(1, h // 2), max(1, w // 2)
        shape = (h, w, 3) if trial % 4 else (h, w)
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        got = resize_area(img, (dw, dh))
        ref = cv2.resize(img, (dw, dh), interpolation=cv2.INTER_AREA)
        assert int(np.count_nonzero(got != ref)) == 0, ((h, w), (dw, dh))

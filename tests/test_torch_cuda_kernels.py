"""The hand-written CUDA kernels against their plain PyTorch versions, on the
card. Marked ``cuda``: each test skips without a card. On the card, run

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

(``--noconftest``: the suite's conftest configures JAX, which the machine
with the card does not have)."""
import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("shape", [(96, 224, 224, 3), (1, 5, 7, 3)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_normalize_equals_plain(dev, shape, dtype):
    from fac_fake_torch.ops import preprocess as pp

    u8 = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, shape, dtype=np.uint8)).to(dev)
    before = pp.normalize_imagenet.launches
    got = pp.normalize_imagenet(u8, dtype)
    ref = pp.normalize_imagenet_plain(u8, dtype)
    torch.cuda.synchronize()
    assert pp.normalize_imagenet.launches == before + 1
    assert got.shape == ref.shape and got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, ref)   # same IEEE fp32 operations: bit equal


def test_k2_misaligned_input_takes_the_scalar_path(dev):
    from fac_fake_torch.ops import preprocess as pp

    flat = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, 1 + 4 * 6 * 3, dtype=np.uint8)).to(dev)
    u8 = flat[1:].view(1, 4, 6, 3)            # data pointer off by one byte
    assert torch.equal(pp.normalize_imagenet(u8), pp.normalize_imagenet_plain(u8))


def test_k2_refuses_non_contiguous(dev):
    from fac_fake_torch.ops import preprocess as pp

    u8 = torch.zeros((2, 8, 8, 3), dtype=torch.uint8, device=dev)[:, ::2]
    with pytest.raises(ValueError, match="contiguous"):
        pp.normalize_imagenet(u8)


@pytest.mark.parametrize("t,margin", [(3, 0.2), (1, 0.2), (1, None)])
def test_k1_frame_detections_equals_plain(dev, t, margin):
    from fac_fake_torch.detect import extractor as ex

    rng = np.random.default_rng(t)
    f = 16
    dets = rng.uniform(0, 0.8, (f, t * 896, 17)).astype(np.float32)
    dets[..., 2:4] = dets[..., 0:2] + 0.15
    dets[..., 16] = rng.uniform(0.5, 1.0, (f, t * 896))
    dets[:, 0:3, 16] = 0.9                    # exact ties
    dets[:, 9, :4] = 0.5                      # zero area
    dets[:, 9, 16] = 0.99
    d = torch.from_numpy(dets).to(dev)
    v = d[..., 16] >= 0.75
    offsets = torch.tensor([[0.0, 420.0 * i] for i in range(t)], device=dev)
    args = (1080.0, offsets, (1080.0, 1920.0), 8, 0.3, margin)
    before = ex.frame_detections.launches
    kf, km = ex.frame_detections(d, v, *args)
    pf, pm = ex.frame_detections_plain(d, v, *args)
    torch.cuda.synchronize()
    assert ex.frame_detections.launches == before + 1
    assert torch.equal(km, pm) and bool(km.any())
    torch.testing.assert_close(kf[km], pf[km], rtol=1e-5, atol=1e-3)

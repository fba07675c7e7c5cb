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


def _quant_inputs(rng, x_shape, n_out, k_in, dev, dtype):
    """Activations with exact .5 quantization ties and values past ±127
    quanta (x_scale = 2^-4), int8 weights, per-channel scales and bias."""
    s = 0.0625
    x = rng.standard_normal(x_shape).astype(np.float32) * 3.0
    ties = rng.random(x_shape) < 0.125
    x[ties] = (rng.integers(-200, 200, int(ties.sum())) + 0.5) * s
    wq = rng.integers(-127, 128, (n_out, k_in)).astype(np.int8)
    w_scale = rng.uniform(0.001, 0.05, n_out).astype(np.float32)
    bias = rng.standard_normal(n_out).astype(np.float32)
    t = lambda a: torch.from_numpy(a).to(dev)
    return (t(x).to(dtype), t(wq), t(w_scale), torch.tensor(s, device=dev), t(bias))


# every distinct conv of the folded base stem, (H, Cin, Cout), and two ragged ones
STEM_CONVS = [(224, 3, 32), (224, 32, 32), (112, 32, 64), (112, 64, 64), (56, 64, 128),
              (56, 128, 128), (28, 128, 256), (28, 256, 256), (14, 256, 512),
              (14, 512, 512), ((7, 9), 3, 8), ((6, 5), 16, 40)]


@pytest.mark.parametrize("hw,cin,cout", STEM_CONVS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3_quant_conv_equals_plain(dev, hw, cin, cout, dtype):
    from fac_fake_torch.ops import quant as q

    h, w = (hw, hw) if isinstance(hw, int) else hw
    rng = np.random.default_rng(cin * 1000 + cout)
    x, wq, w_scale, x_scale, bias = _quant_inputs(rng, (2, h, w, cin), cout, 9 * cin, dev, dtype)
    x = x.permute(0, 3, 1, 2)                                   # NCHW, channels_last
    kq = wq.reshape(cout, 3, 3, cin).permute(0, 3, 1, 2)        # OIHW in O-HW-I memory
    before = q.quant_conv3x3.launches
    got = q.quant_conv3x3(x, kq, w_scale, x_scale, bias)
    ref = q.quant_conv3x3_plain(x, kq, w_scale, x_scale, bias)
    torch.cuda.synchronize()
    assert q.quant_conv3x3.launches == before + 1
    assert got.dtype == dtype and got.shape == (2, cout, h, w)
    assert got.is_contiguous(memory_format=torch.channels_last)
    # exact int32 sums; quantize and epilogue are the same IEEE operations
    assert torch.equal(got, ref)


# (rows, out, in) of the int8_full path at batch 96 and 256, and tiny ones
DENSE_SHAPES = [(96, 1024, 25088), (192, 3072, 1024), (192, 1024, 1024), (192, 2048, 1024),
                (192, 1024, 2048), (96, 2048, 1024), (256, 1024, 1024), (5, 24, 40),
                (1, 8, 27)]


@pytest.mark.parametrize("m,n,k", DENSE_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k4_quant_dense_equals_plain(dev, m, n, k, dtype):
    from fac_fake_torch.ops import quant as q

    rng = np.random.default_rng(m + n + k)
    x, wq, w_scale, x_scale, bias = _quant_inputs(rng, (m, k), n, k, dev, dtype)
    for b in (bias, None):
        before = q.quant_dense.launches
        got = q.quant_dense(x, wq, w_scale, x_scale, b)
        ref = q.quant_dense_plain(x, wq, w_scale, x_scale, b)
        torch.cuda.synchronize()
        assert q.quant_dense.launches == before + 1
        assert got.dtype == dtype and got.shape == (m, n)
        assert torch.equal(got, ref)


def test_k4_takes_a_3d_input_through_quant_linear(dev):
    from fac_fake_torch.models.layers import QuantLinear
    from fac_fake_torch.ops import quant as q

    rng = np.random.default_rng(5)
    x, wq, w_scale, x_scale, bias = _quant_inputs(rng, (96, 2, 1024), 3072, 1024, dev,
                                                  torch.float32)
    lin = QuantLinear(1024, 3072, bias=False).to(dev)
    lin.load_state_dict({"kernel_q": wq, "w_scale": w_scale, "x_scale": x_scale})
    before = q.quant_dense.launches
    got = lin(x)
    assert q.quant_dense.launches == before + 1 and got.shape == (96, 2, 3072)
    assert torch.equal(got, q.quant_dense_plain(x, wq, w_scale, x_scale))


def test_int8_full_video_scorer_runs_k3_and_k4_on_the_card(dev):
    """A quantized `VideoScorer` on the card launches K3 and K4 and scores
    as the same quantized model does on the CPU."""
    import copy

    from fac_fake_torch.core.config import Config
    from fac_fake_torch.infer.predictor import VideoScorer
    from fac_fake_torch.models import init_weights
    from fac_fake_torch.models.cvit import CViT
    from fac_fake_torch.ops import quant as q

    spec = ()
    for _ in range(5):
        spec += (("conv", 8), ("bn", 8), ("relu",), ("pool",))
    cfg = Config()
    cfg.infer.quantize = "int8_full"
    scorer = VideoScorer(init_weights(CViT(spec, dim=64, depth=1, heads=2, mlp_dim=64), 0),
                         cfg, device=dev)
    crops = np.random.default_rng(6).integers(0, 256, (12, 224, 224, 3), dtype=np.uint8)
    k3, k4 = q.quant_conv3x3.launches, q.quant_dense.launches
    prob = scorer.score_crops(crops)
    assert q.quant_conv3x3.launches == k3 + 5 and q.quant_dense.launches == k4 + 6
    cpu = VideoScorer(copy.deepcopy(scorer.model).cpu(), cfg, fold_bn=False, device="cpu")
    cpu._quant_pending = False
    assert abs(cpu.score_crops(crops) - prob) <= 1e-3


# ---- K5 and K6 (S3D int8) -------------------------------------------------------

# (kernel, stride, padding, cin, cout, (T, H, W)): the int8 conv geometries of a
# ca_s3d forward at 224² (cut to batch 1-2 and, for the stem, fewer frames),
# a concat30 stem, and ragged ones
CONV3D_GEOMS = [
    ((1, 7, 7), (1, 2, 2), (0, 3, 3), 3, 64, (4, 224, 224)),
    ((1, 7, 7), (1, 2, 2), (0, 3, 3), 30, 64, (2, 64, 64)),
    ((7, 1, 1), (2, 1, 1), (3, 0, 0), 64, 64, (20, 56, 56)),
    ((1, 1, 1), (1, 1, 1), (0, 0, 0), 64, 64, (10, 56, 56)),
    ((1, 3, 3), (1, 1, 1), (0, 1, 1), 64, 192, (10, 56, 56)),
    ((3, 1, 1), (1, 1, 1), (1, 0, 0), 192, 192, (10, 56, 56)),
    ((1, 1, 1), (1, 1, 1), (0, 0, 0), 192, 16, (10, 28, 28)),
    ((1, 3, 3), (1, 1, 1), (0, 1, 1), 16, 32, (10, 28, 28)),
    ((1, 1, 1), (1, 1, 1), (0, 0, 0), 832, 384, (2, 7, 7)),
    ((1, 3, 3), (1, 1, 1), (0, 1, 1), 192, 384, (2, 7, 7)),
    ((3, 1, 1), (1, 1, 1), (1, 0, 0), 48, 128, (5, 14, 14)),
    ((1, 3, 3), (1, 1, 1), (0, 1, 1), 24, 40, (3, 5, 7)),
    ((7, 1, 1), (2, 1, 1), (3, 0, 0), 16, 8, (5, 3, 2)),
]


def _conv3d_inputs(rng, dev, kernel, cin, cout, thw, b=2):
    from fac_fake_torch.ops.quant import pad16
    cp = pad16(cin)
    x, _, _, x_scale, bias = _quant_inputs(rng, (b, *thw, cin), cout, 1, dev, torch.float32)
    wq = torch.zeros((cout, *kernel, cp), dtype=torch.int8)
    wq[..., :cin] = torch.from_numpy(rng.integers(-127, 128, (cout, *kernel, cin), dtype=np.int8))
    s = torch.from_numpy(rng.uniform(1e-5, 1e-3, cout).astype(np.float32)).to(dev)
    return x, x_scale, wq.to(dev), s, bias


@pytest.mark.parametrize("kernel,stride,padding,cin,cout,thw", CONV3D_GEOMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k5_quantize_and_int8_conv3d_equal_plain(dev, kernel, stride, padding, cin, cout, thw,
                                                 dtype):
    from fac_fake_torch.ops import quant3d as q3

    rng = np.random.default_rng(cin * 1000 + cout + thw[1])
    x, x_scale, wq, s, bias = _conv3d_inputs(rng, dev, kernel, cin, cout, thw)
    xd = x.to(dtype)
    before = (q3.quantize_pad.launches, q3.int8_conv3d.launches)
    xq = q3.quantize_pad(xd, x_scale)
    assert torch.equal(xq, q3.quantize_pad_plain(xd, x_scale))
    for relu in (True, False):
        got = q3.int8_conv3d(xq, wq, s, bias, stride, padding, relu, dtype)
        ref = q3.int8_conv3d_plain(xq, wq, s, bias, stride, padding, relu, dtype)
        torch.cuda.synchronize()
        assert got.dtype == dtype and got.shape == ref.shape
        assert torch.equal(got, ref)   # exact int32 sums; the same IEEE epilogue
    assert (q3.quantize_pad.launches, q3.int8_conv3d.launches) == (before[0] + 1, before[1] + 2)
    # into a channel slice of a wider output, as an Inception branch writes
    out = torch.full((*ref.shape[:-1], cout + 24), 3.0, dtype=dtype, device=dev)
    q3.int8_conv3d(xq, wq, s, bias, stride, padding, False, dtype, out, 8)
    torch.cuda.synchronize()
    assert torch.equal(out[..., 8:8 + cout], ref)
    assert (out[..., :8] == 3).all() and (out[..., 8 + cout:] == 3).all()


@pytest.mark.parametrize("shape", [(2, 10, 28, 28, 192), (2, 5, 14, 14, 480),
                                   (2, 2, 7, 7, 832), (1, 3, 5, 4, 16), (1, 1, 1, 1, 32)])
def test_k6_max_pool3d_i8_equals_plain(dev, shape):
    from fac_fake_torch.ops import quant3d as q3

    xq = torch.from_numpy(np.random.default_rng(shape[-1]).integers(
        -127, 128, shape, dtype=np.int8)).to(dev)
    before = q3.max_pool3d_i8.launches
    got = q3.max_pool3d_i8(xq)
    torch.cuda.synchronize()
    assert q3.max_pool3d_i8.launches == before + 1
    assert torch.equal(got, q3.max_pool3d_i8_plain(xq))


def test_k5_k6_refuse_what_they_do_not_take(dev):
    from fac_fake_torch.ops import quant3d as q3

    with pytest.raises(ValueError, match="padded to 16"):
        q3.max_pool3d_i8(torch.zeros((1, 2, 2, 2, 8), dtype=torch.int8, device=dev))
    xq = torch.zeros((1, 2, 4, 4, 16), dtype=torch.int8, device=dev)
    wq = torch.zeros((8, 1, 1, 1, 16), dtype=torch.int8, device=dev)
    s = torch.ones(8, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        q3.int8_conv3d(xq[:, :, ::2], wq, s, s, (1, 1, 1), (0, 0, 0), True, torch.float32)
    with pytest.raises(ValueError, match="outside"):
        q3.int8_conv3d(xq, wq, s, s, (1, 1, 1), (0, 0, 0), True, torch.float32,
                       torch.zeros((1, 2, 4, 4, 12), device=dev), 8)


def test_s3d_int8_engine_runs_k5_and_k6_on_the_card(dev):
    """A small ca_s3d-like engine on the card launches K5 and K6 and gives
    the logits of the same engine on the CPU (plain versions)."""
    import copy

    from fac_fake_torch.compat.quantize_s3d import quantize_s3d
    from fac_fake_torch.models import init_weights
    from fac_fake_torch.models.s3d.model import S3DNet
    from fac_fake_torch.ops import quant3d as q3

    spec = (("sep", 16, 7, 2, 3, "relu", True), ("pool", (1, 3, 3), (1, 2, 2), (0, 1, 1)),
            ("basic", 16, 1, 1, 0, "relu"), ("mix", "3b", "relu", True),
            ("ctx", 1.0 / 16.0, "avg"), ("pool", (3, 3, 3), (2, 2, 2), (1, 1, 1)),
            ("mix", "3c", "relu", True), ("pool", (2, 2, 2), (2, 2, 2), (0, 0, 0)))
    m = init_weights(S3DNet(spec, 1).to(dev), 0).eval().to(memory_format=torch.channels_last_3d)
    x = torch.from_numpy(np.random.default_rng(7).uniform(0, 255, (2, 20, 32, 32, 3))
                         .astype(np.float32)).to(dev).permute(0, 4, 1, 2, 3)
    eng = quantize_s3d(m, x)
    k5, k6 = q3.int8_conv3d.launches, q3.max_pool3d_i8.launches
    with torch.no_grad():
        got = eng(x)
    assert q3.int8_conv3d.launches == k5 + 3 + 16 and q3.max_pool3d_i8.launches == k6 + 2
    with torch.no_grad():
        cpu = copy.deepcopy(eng).cpu()(x.cpu())
    assert float((got.cpu() - cpu).abs().max()) <= 1e-3

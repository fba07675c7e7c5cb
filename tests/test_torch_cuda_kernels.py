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
    s = torch.tensor(0.02, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        pp.quantize_crops(u8, s)
    with pytest.raises(ValueError, match="contiguous"):
        pp.quantize_clips(u8, s)


# K2's five modes: fp32, bf16 (`normalize_imagenet`), int8 of the fp32 or bf16
# normalize (`quantize_crops`), int8 of the raw bytes (`quantize_clips`)
K2_MODES = ["fp32", "bf16", "int8_fp32", "int8_bf16", "raw"]
# ragged pixel counts: 35, 429, 513 (one whole 512-pixel step and one pixel),
# 512, and 96 crops of 224² (9408 whole steps)
K2_SHAPES = [(1, 5, 7, 3), (3, 11, 13, 3), (1, 1, 513, 3), (2, 16, 16, 3), (96, 224, 224, 3)]


def _k2(pp, mode, u8, s):
    """(kernel, plain) of one K2 mode on ``u8``; ``s``: the int8 modes' scale."""
    dt = torch.bfloat16 if "bf16" in mode else torch.float32
    if mode in ("fp32", "bf16"):
        return pp.normalize_imagenet(u8, dt), pp.normalize_imagenet_plain(u8, dt)
    if mode == "raw":
        return pp.quantize_clips(u8, s), pp.quantize_clips_plain(u8, s)
    return pp.quantize_crops(u8, s, dt), pp.quantize_crops_plain(u8, s, dt)


def _k2_scale(mode, dev):
    # about the calibrated scales (2.64 / 127 normalized, 255 / 127 raw), a
    # little below them, so that the largest values clip to ±127
    return torch.tensor(2.0 if mode == "raw" else 0.019, device=dev)


@pytest.mark.parametrize("shape", K2_SHAPES)
@pytest.mark.parametrize("mode", K2_MODES)
def test_k2_modes_equal_plain(dev, shape, mode):
    from fac_fake_torch.ops import preprocess as pp

    u8 = torch.from_numpy(np.random.default_rng(2).integers(
        0, 256, shape, dtype=np.uint8)).to(dev)
    launches = pp.normalize_imagenet.launches
    got, ref = _k2(pp, mode, u8, _k2_scale(mode, dev))
    torch.cuda.synchronize()
    assert pp.normalize_imagenet.launches == launches + 1
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert torch.equal(got, ref)
    if got.dtype == torch.int8:
        assert got.is_contiguous() and not got[..., 3].any()


@pytest.mark.parametrize("mode", K2_MODES)
@pytest.mark.parametrize("scale", [0.019, 2.0 ** -6, 2.0, 1.0])
def test_k2_every_byte_of_every_channel_equals_plain(dev, mode, scale):
    """An image of all 256 byte values in each channel; the scales make the
    ±127 clip and exact .5 quotients (2⁻⁶ on bf16 values, 2 on raw bytes)
    happen."""
    from fac_fake_torch.ops import preprocess as pp

    b = np.arange(256)
    img = np.stack([b, (b + 85) % 256, (b + 170) % 256], -1).astype(np.uint8)
    u8 = torch.from_numpy(img.reshape(1, 16, 16, 3)).to(dev)
    got, ref = _k2(pp, mode, u8, torch.tensor(scale, device=dev))
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_fp_modes_equal_the_two_division_arithmetic(dev, dtype):
    """fp32: x / 255, then (x − mean) / std, each an IEEE fp32 operation
    (numpy on the host); bf16: that rounded to nearest even."""
    from fac_fake_torch.ops import preprocess as pp

    u8 = np.random.default_rng(3).integers(0, 256, (4, 31, 29, 3), dtype=np.uint8)
    x = u8.astype(np.float32) / np.float32(255.0)
    want = torch.from_numpy((x - pp.IMAGENET_MEAN) / pp.IMAGENET_STD).to(dtype)
    got = pp.normalize_imagenet(torch.from_numpy(u8).to(dev), dtype)
    assert torch.equal(got.permute(0, 2, 3, 1).cpu(), want)


@pytest.mark.parametrize("mode", ["int8_fp32", "int8_bf16", "raw"])
def test_k2_int8_modes_take_a_misaligned_input(dev, mode):
    from fac_fake_torch.ops import preprocess as pp

    flat = torch.from_numpy(np.random.default_rng(4).integers(
        0, 256, 5 + 3 * 700, dtype=np.uint8)).to(dev)
    u8 = flat[5:].view(1, 7, 100, 3)          # data pointer off by five bytes
    got, ref = _k2(pp, mode, u8, _k2_scale(mode, dev))
    assert torch.equal(got, ref)


def test_k2_int8_entries_count_their_launches_and_check_the_scale(dev):
    from fac_fake_torch.ops import preprocess as pp

    u8 = torch.zeros((2, 4, 4, 3), dtype=torch.uint8, device=dev)
    s = torch.tensor(0.02, device=dev)
    k2, crops, clips = (pp.normalize_imagenet.launches, pp.quantize_crops.launches,
                        pp.quantize_clips.launches)
    pp.quantize_crops(u8, s, torch.bfloat16)
    pp.quantize_clips(u8[None], s)
    assert (pp.normalize_imagenet.launches, pp.quantize_crops.launches,
            pp.quantize_clips.launches) == (k2 + 2, crops + 1, clips + 1)
    with pytest.raises(ValueError, match="x_scale"):
        pp.quantize_crops(u8, s.reshape(1))
    with pytest.raises(ValueError, match="no kernel"):
        pp.quantize_crops(u8, s, torch.float16)


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


def _k1_frame(rng, kind, t=3):
    """One frame's (T·896, 17) dets and validity: planted clusters, or one
    edge case: no valid anchor; valid NaN scores; a zero-area seed above a
    cluster (picked at every step); a cluster whose members lie in several
    warps of K1's CTA (anchor a is thread a % 512)."""
    n = t * 896
    d = rng.uniform(0, 0.8, (n, 17)).astype(np.float32)
    d[:, 2:4] = d[:, 0:2] + 0.15
    d[:, 16] = rng.uniform(0.0, 0.7, n)
    for c, a0 in enumerate((40, 300)):          # two clusters, 5 members each
        y, x = rng.uniform(0.05, 0.6, 2)
        for j in range(5):
            a = a0 + 7 * j
            jy, jx = rng.normal(0, 0.01, 2)
            d[a, :4] = [y + jy, x + jx, y + 0.3 + jy, x + 0.3 + jx]
            d[a, 16] = 0.9 if j < 2 else rng.uniform(0.75, 0.95)
    v = d[:, 16] >= 0.75
    if kind == "no_valid":
        v[:] = False
    elif kind == "nan":
        d[[41, n - 2], 16] = np.nan
        v[[41, n - 2]] = True
        d[[5, 6], 16] = np.nan                   # invalid: their score is not read
        v[[5, 6]] = False
    elif kind == "zero_area":
        d[500, :4] = [0.5, 0.5, 0.5, 0.5]
        d[500, 16] = 0.99
        v[500] = True
    elif kind == "across_warps":
        y, x = 0.2, 0.3
        for j, a in enumerate(a for a in (7, 45, 200, 511, 545, 1500, n - 1) if a < n):
            d[a, :4] = [y + 0.002 * j, x, y + 0.3, x + 0.3 - 0.001 * j]
            d[a, 16] = 0.8 + 0.02 * j
            v[a] = True
    return d, v


@pytest.mark.parametrize("kind", ["planted", "no_valid", "nan", "zero_area", "across_warps"])
def test_k1_edge_frames_equal_plain(dev, kind):
    """One frame (F = 1) of each kind: masks equal, and every row (masked
    or not, NaN where both are NaN) within the smoke's tolerance."""
    from fac_fake_torch.detect import extractor as ex

    d, v = _k1_frame(np.random.default_rng(11), kind)
    dets = torch.from_numpy(d[None]).to(dev)
    valid = torch.from_numpy(v[None]).to(dev)
    offsets = torch.tensor([[0.0, 420.0 * i] for i in range(3)], device=dev)
    args = (1080.0, offsets, (1080.0, 1920.0), 8, 0.3, 0.2)
    kf, km = ex.frame_detections(dets, valid, *args)
    pf, pm = ex.frame_detections_plain(dets, valid, *args)
    torch.cuda.synchronize()
    assert torch.equal(km, pm)
    torch.testing.assert_close(kf, pf, rtol=1e-5, atol=1e-3, equal_nan=True)
    if kind == "zero_area":                      # picked again: its row at every step
        assert torch.equal(kf[0, :, 0], torch.full_like(kf[0, :, 0], kf[0, 0, 0]))
    if kind in ("no_valid", "nan"):
        assert not bool(km.any())
    if kind == "across_warps":
        assert bool(km[0, 0])


@pytest.mark.parametrize("t", [1, 3])
def test_k1_33_frames_of_every_kind_equal_plain(dev, t):
    """33 frames (more than one chunk), 8, 3 and no steps."""
    from fac_fake_torch.detect import extractor as ex

    rng = np.random.default_rng(12 + t)
    kinds = ["planted", "no_valid", "nan", "zero_area", "across_warps"]
    frames = [_k1_frame(rng, kinds[i % len(kinds)], t) for i in range(33)]
    dets = torch.from_numpy(np.stack([d for d, _ in frames])).to(dev)
    valid = torch.from_numpy(np.stack([v for _, v in frames])).to(dev)
    offsets = torch.tensor([[0.0, 420.0 * i] for i in range(t)], device=dev)
    for steps, margin in ((8, 0.2), (8, None), (3, 0.2), (0, 0.2)):
        args = (1080.0, offsets, (1080.0, 1920.0), steps, 0.3, margin)
        kf, km = ex.frame_detections(dets, valid, *args)
        pf, pm = ex.frame_detections_plain(dets, valid, *args)
        torch.cuda.synchronize()
        assert kf.shape == (33, steps, 17) and torch.equal(km, pm)
        assert steps == 0 or bool(km.any())
        torch.testing.assert_close(kf, pf, rtol=1e-5, atol=1e-3, equal_nan=True)


def test_k1_refuses_more_anchors_than_a_cta_holds(dev):
    from fac_fake_torch.detect import extractor as ex

    n = ex.K1_MAX_ANCHORS + 4
    dets = torch.zeros((1, n, 17), device=dev)
    valid = torch.zeros((1, n), dtype=torch.bool, device=dev)
    with pytest.raises(ValueError, match="does not fit one CTA"):
        ex.frame_detections(dets, valid, offsets=torch.zeros((4, 2), device=dev))
    faces, mask = ex.frame_detections(dets[:, :ex.K1_MAX_ANCHORS], valid[:, :ex.K1_MAX_ANCHORS])
    torch.cuda.synchronize()
    assert faces.shape == (1, 8, 17) and not bool(mask.any())


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


# every distinct conv of the folded base stem, (H, Cin, Cout), and ragged ones;
# at batch 2 the last two fill the card with two-warpgroup tiles (as the
# stem's convs do at batch 96) whose rows end in no whole tile; then the
# variant zoo's new ones: cvit_ggca_sla's 512-channel convs at 28² and
# cvit_ggca_add_glu's 256- and 512-channel convs at 56² (no pool before them)
STEM_CONVS = [(224, 3, 32), (224, 32, 32), (112, 32, 64), (112, 64, 64), (56, 64, 128),
              (56, 128, 128), (28, 128, 256), (28, 256, 256), (14, 256, 512),
              (14, 512, 512), ((7, 9), 3, 8), ((6, 5), 16, 40), ((97, 91), 32, 40),
              ((89, 99), 128, 72), (28, 256, 512), (28, 512, 512), (56, 128, 256),
              (56, 256, 256), (56, 256, 512), (56, 512, 512)]


@pytest.mark.parametrize("hw,cin,cout", STEM_CONVS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3_quant_conv_equals_plain(dev, hw, cin, cout, dtype):
    from fac_fake_torch.ops import quant as q
    from fac_fake_torch.ops import quant3d as q3

    h, w = (hw, hw) if isinstance(hw, int) else hw
    rng = np.random.default_rng(cin * 1000 + cout)
    x, wq, w_scale, x_scale, bias = _quant_inputs(rng, (2, h, w, cin), cout, 9 * cin, dev, dtype)
    x = x.permute(0, 3, 1, 2)                                   # NCHW, channels_last
    kq = wq.reshape(cout, 3, 3, cin).permute(0, 3, 1, 2)        # OIHW in O-HW-I memory
    before = (q.int8_conv3x3.launches, q3.quantize_pad.launches)
    got = q.quant_conv3x3(x, kq, w_scale, x_scale, bias)
    ref = q.quant_conv3x3_plain(x, kq, w_scale, x_scale, bias)
    torch.cuda.synchronize()
    assert (q.int8_conv3x3.launches, q3.quantize_pad.launches) == (before[0] + 1, before[1] + 1)
    assert got.dtype == dtype and got.shape == (2, cout, h, w)
    assert got.is_contiguous(memory_format=torch.channels_last)
    # exact int32 sums; quantize and epilogue are the same IEEE operations
    assert torch.equal(got, ref)


@pytest.mark.parametrize("hw,cin,cout", STEM_CONVS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3_fused_epilogue_equals_plain(dev, hw, cin, cout, dtype):
    """K3 as the stem's int8 walk runs it: an int8 NHWC input (the 4-channel
    quantize of the image for Cin = 3), the ReLU in the epilogue, fp out or
    the next conv's int8 input (``q_scale``, channels padded to 16 with
    zeros), equal to quantize_pad_plain(int8_conv3x3_plain(...))."""
    from fac_fake_torch.ops import quant as q
    from fac_fake_torch.ops import quant3d as q3

    h, w = (hw, hw) if isinstance(hw, int) else hw
    rng = np.random.default_rng(cin * 100 + cout + h)
    x, wq, w_scale, x_scale, bias = _quant_inputs(rng, (2, h, w, cin), cout, 9 * cin, dev, dtype)
    kq = wq.reshape(cout, 3, 3, cin).permute(0, 3, 1, 2)
    s, w_k = x_scale * w_scale, q.conv3x3_rows(kq)
    xq = q3.quantize_pad(x, x_scale)
    assert xq.shape[-1] == q3.quant_channels(cin)
    for relu in (True, False):
        y = q.int8_conv3x3_plain(xq, kq, s, bias, relu, dtype)
        q_scale = (y.float().abs().amax() / 150.0).reshape(())   # some values clip at ±127
        before = q.int8_conv3x3.launches
        got = q.int8_conv3x3(xq, kq, s, bias, relu, dtype, w_k=w_k)
        got_q = q.int8_conv3x3(xq, kq, s, bias, relu, dtype, q_scale, w_k)
        torch.cuda.synchronize()
        assert q.int8_conv3x3.launches == before + 2
        assert got.dtype == dtype and torch.equal(got, y)
        assert got_q.dtype == torch.int8 and got_q.shape == (2, h, w, q3.pad16(cout))
        assert torch.equal(got_q, q3.quantize_pad_plain(y, q_scale))


# (rows, out, in) of the int8_full path at batch 96 and 256, and tiny ones;
# then the zoo's at batch 96: cvit_ggca_sla's 16 patches and 17 tokens a
# crop, cvit_ggca_add_glu's 64 and 65
DENSE_SHAPES = [(96, 1024, 25088), (192, 3072, 1024), (192, 1024, 1024), (192, 2048, 1024),
                (192, 1024, 2048), (96, 2048, 1024), (256, 1024, 1024), (5, 24, 40),
                (1, 8, 27), (96 * 16, 1024, 25088), (96 * 17, 3072, 1024),
                (96 * 17, 1024, 2048), (96 * 64, 1024, 25088), (96 * 65, 3072, 1024),
                (96 * 65, 1024, 2048)]


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


# rows 1, 5, 96, 192, 200 (one wgmma N each, 200 in a 256-row tile); K no
# multiple of 128 (and 40, 27 none of 16); N ragged against the 128-channel
# CTA; the cluster split 1 to 8
K4_WGMMA_SHAPES = [(1, 200, 1000), (5, 24, 40), (96, 1000, 1100), (192, 130, 27),
                   (200, 1000, 1100), (192, 1024, 2000), (96, 1030, 25088)]


@pytest.mark.parametrize("m,n,k", K4_WGMMA_SHAPES)
def test_k4_wgmma_rows_ragged_and_split_twice(dev, m, n, k):
    """Each shape twice in a row: a cluster split that left reduction state
    behind would show in the second call."""
    from fac_fake_torch.ops import quant as q

    rng = np.random.default_rng(m * 7 + n + k)
    x, wq, w_scale, x_scale, bias = _quant_inputs(rng, (m, k), n, k, dev, torch.bfloat16)
    ref = q.quant_dense_plain(x, wq, w_scale, x_scale, bias)
    for _ in range(2):
        got = q.quant_dense(x, wq, w_scale, x_scale, bias)
        torch.cuda.synchronize()
        assert torch.equal(got, ref), (m, n, k, q.dense_splits(m, n, k))


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
    from fac_fake_torch.ops import preprocess as pp
    from fac_fake_torch.ops import quant as q
    from fac_fake_torch.ops import quant3d as q3

    spec = ()
    for _ in range(5):
        spec += (("conv", 8), ("bn", 8), ("relu",), ("pool",))
    cfg = Config()
    cfg.infer.quantize = "int8_full"
    scorer = VideoScorer(init_weights(CViT(spec, dim=64, depth=1, heads=2, mlp_dim=64), 0),
                         cfg, device=dev)
    crops = np.random.default_rng(6).integers(0, 256, (12, 224, 224, 3), dtype=np.uint8)
    # the int8 walk: 5 K3 launches, the first conv's input made by K2's int8
    # entry (no quantize pass), the next four convs' inputs quantized and
    # pooled (int8) in K3's epilogue
    k3, k4 = q.int8_conv3x3.launches, q.quant_dense.launches
    quantized, entries = q3.quantize_pad.launches, pp.quantize_crops.launches
    prob = scorer.score_crops(crops)
    assert q.int8_conv3x3.launches == k3 + 5 and q.quant_dense.launches == k4 + 6
    assert q3.quantize_pad.launches == quantized
    assert pp.quantize_crops.launches == entries + 1
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


@pytest.mark.parametrize("kernel,stride,padding,cin,cout,thw", CONV3D_GEOMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k5_fused_quantize_epilogue_equals_plain(dev, kernel, stride, padding, cin, cout, thw,
                                                 dtype):
    """K5 with ``q_scale``: the next conv's int8 input, channels padded to 16
    with zeros, equal to quantize_pad_plain(int8_conv3d_plain(...))."""
    from fac_fake_torch.ops import quant3d as q3
    from fac_fake_torch.ops.quant import pad16

    rng = np.random.default_rng(cin * 100 + cout + thw[2])
    x, x_scale, wq, s, bias = _conv3d_inputs(rng, dev, kernel, cin, cout, thw)
    xq = q3.quantize_pad(x.to(dtype), x_scale)
    for relu in (True, False):
        y = q3.int8_conv3d_plain(xq, wq, s, bias, stride, padding, relu, dtype)
        q_scale = (y.float().abs().amax() / 150.0).reshape(())   # some values clip at ±127
        before = q3.int8_conv3d.launches
        got = q3.int8_conv3d(xq, wq, s, bias, stride, padding, relu, dtype, q_scale=q_scale)
        torch.cuda.synchronize()
        assert q3.int8_conv3d.launches == before + 1
        assert got.dtype == torch.int8 and got.shape == (*y.shape[:-1], pad16(cout))
        assert torch.equal(got, q3.quantize_pad_plain(y, q_scale))


@pytest.mark.parametrize("kernel,stride,padding,cin,cout,thw", CONV3D_GEOMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k5_relu6_epilogue_equals_plain(dev, kernel, stride, padding, cin, cout, thw, dtype):
    """K5 with the msca family's ReLU6 (``clip(acc·s + b, 0, 6)`` after the
    rounding to the walk's dtype): into a new tensor, into a channel slice,
    and quantized for the next conv, each bit-equal to the plain version;
    the scales set so that values fall below 0, between 0 and 6 and above
    6 in every case. A ReLU6 launch counts in ``relu6_launches`` too."""
    from fac_fake_torch.ops import quant3d as q3
    from fac_fake_torch.ops.quant import pad16

    rng = np.random.default_rng(cin * 10 + cout + thw[0])
    x, x_scale, wq, _, _ = _conv3d_inputs(rng, dev, kernel, cin, cout, thw)
    xq = q3.quantize_pad(x.to(dtype), x_scale)
    acc = q3.int_conv3d_plain(xq, q3._kernel_for(xq, wq), stride, padding).float()
    spread = acc.reshape(-1, cout).std(0).clamp_min(1.0)
    s = (5.0 / spread).contiguous()
    bias = torch.from_numpy(rng.normal(2.0, 3.0, cout).astype(np.float32)).to(dev)
    ref = q3.int8_conv3d_plain(xq, wq, s, bias, stride, padding, q3.ACT_RELU6, dtype)
    assert (ref == 0).any() and (ref == 6).any() and ((ref > 0) & (ref < 6)).any()
    assert torch.equal(ref, torch.clamp(q3.int8_conv3d_plain(
        xq, wq, s, bias, stride, padding, q3.ACT_NONE, dtype), 0.0, 6.0))
    before = (q3.int8_conv3d.launches, q3.int8_conv3d.relu6_launches)
    got = q3.int8_conv3d(xq, wq, s, bias, stride, padding, q3.ACT_RELU6, dtype)
    out = torch.full((*ref.shape[:-1], cout + 24), 9.0, dtype=dtype, device=dev)
    q3.int8_conv3d(xq, wq, s, bias, stride, padding, q3.ACT_RELU6, dtype, out, 8)
    q_scale = torch.tensor(8.0 / 127.0, device=dev)     # past 6: ReLU alone would show
    fused = q3.int8_conv3d(xq, wq, s, bias, stride, padding, q3.ACT_RELU6, dtype,
                           q_scale=q_scale)
    relu = q3.int8_conv3d(xq, wq, s, bias, stride, padding, q3.ACT_RELU, dtype)
    torch.cuda.synchronize()
    assert (q3.int8_conv3d.launches, q3.int8_conv3d.relu6_launches) == \
        (before[0] + 4, before[1] + 3)
    assert got.dtype == dtype and torch.equal(got, ref)
    assert torch.equal(out[..., 8:8 + cout], ref)
    assert (out[..., :8] == 9).all() and (out[..., 8 + cout:] == 9).all()
    assert fused.shape == (*ref.shape[:-1], pad16(cout))
    assert torch.equal(fused, q3.quantize_pad_plain(ref, q_scale))
    assert torch.equal(relu, q3.int8_conv3d_plain(xq, wq, s, bias, stride, padding,
                                                  q3.ACT_RELU, dtype))
    assert bool((relu > 6).any())
    with pytest.raises(ValueError, match="act"):
        q3.int8_conv3d(xq, wq, s, bias, stride, padding, 3, dtype)


def test_k5_stem_reads_four_channels(dev):
    """The 3-channel stem input is quantized to 4 channels, and K5's (1,7,7)
    stride-2 conv over it gives the int32 sums of the 16-channel layout."""
    from fac_fake_torch.ops import quant3d as q3

    rng = np.random.default_rng(11)
    x, x_scale, wq, s, bias = _conv3d_inputs(rng, dev, (1, 7, 7), 3, 64, (3, 31, 29))
    xq = q3.quantize_pad(x, x_scale)
    assert xq.shape[-1] == 4 and not xq[..., 3].any()
    x16 = torch.nn.functional.pad(xq, (0, 12))
    for dtype in (torch.float32, torch.bfloat16):
        got = q3.int8_conv3d(xq, wq, s, bias, (1, 2, 2), (0, 3, 3), True, dtype)
        torch.cuda.synchronize()
        assert torch.equal(got, q3.int8_conv3d_plain(x16, wq, s, bias, (1, 2, 2), (0, 3, 3),
                                                     True, dtype))


def test_k4_k5_libraries_run_on_wgmma(dev):
    """The built K4 and K5 libraries (K5's is K3's too) hold integer wgmma
    (IGMMA) and no mma.sync (IMMA): the old route is gone, and no library
    of K3's own is left to build."""
    import shutil
    import subprocess

    from fac_fake_torch import kernels

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    for name in ("quant_dense", "quant_conv3d"):
        sass = subprocess.run([tool, "-sass", str(kernels.build([name])[name])],
                              capture_output=True, text=True, check=True).stdout
        assert "IGMMA" in sass, name
        assert "IMMA" not in sass.replace("IGMMA", ""), name
    assert "quant_conv" not in kernels.SOURCES
    assert not [p for p in ("quant_mma.cuh", "quant_conv.cu") if (kernels.CSRC / p).exists()]


# the 9 pools of a ca_s3d int8 forward at batch 2 (6 distinct shapes; 480 and
# 528 channels end in a short chunk of 6 and 1 groups of 16); H not a
# multiple of K6's 7-row band; T = 1 and 2; W over two column tiles (70
# columns at 4 groups a chunk, 40 at 8); a chunk of 3 groups (48 channels)
K6_SHAPES = [(2, 10, 28, 28, 192), (2, 10, 28, 28, 256), (2, 5, 14, 14, 480),
             (2, 5, 14, 14, 512), (2, 5, 14, 14, 528), (2, 2, 7, 7, 832),
             (2, 3, 1, 9, 64), (2, 2, 2, 5, 32), (1, 3, 13, 6, 48), (1, 1, 13, 40, 208),
             (2, 1, 7, 7, 64), (1, 2, 5, 70, 64), (1, 3, 5, 4, 16), (1, 1, 1, 1, 32)]


@pytest.mark.parametrize("shape", K6_SHAPES)
def test_k6_max_pool3d_i8_equals_plain(dev, shape):
    from fac_fake_torch.ops import quant3d as q3

    xq = torch.from_numpy(np.random.default_rng(shape[-1]).integers(
        -127, 128, shape, dtype=np.int8)).to(dev)
    before = q3.max_pool3d_i8.launches
    got = q3.max_pool3d_i8(xq)
    torch.cuda.synchronize()
    assert q3.max_pool3d_i8.launches == before + 1
    assert torch.equal(got, q3.max_pool3d_i8_plain(xq))


@pytest.mark.parametrize("shape", [(2, 10, 28, 28, 192), (1, 2, 13, 9, 48), (1, 1, 1, 3, 16)])
def test_k6_all_negative_with_minus_127_borders(dev, shape):
    """Every value negative and the border planes, rows and columns at -127:
    a window at an edge must give -127 or its inner values, never 0 (what a
    zero fill would give) nor the identity -128."""
    from fac_fake_torch.ops import quant3d as q3

    x = np.random.default_rng(3).integers(-127, 0, shape, dtype=np.int8)
    for axis in (1, 2, 3):
        idx = [slice(None)] * 5
        for edge in (0, -1):
            idx[axis] = edge
            x[tuple(idx)] = -127
    xq = torch.from_numpy(x).to(dev)
    got = q3.max_pool3d_i8(xq)
    torch.cuda.synchronize()
    assert torch.equal(got, q3.max_pool3d_i8_plain(xq))
    assert int(got.max()) < 0 and int(got.min()) >= -127


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


def test_s3d_int8_engine_takes_uint8_clips_through_k2(dev):
    """uint8 clips: K2's raw entry makes the stem conv's int8 input, one
    quantize pass fewer, and the logits are those of the fp32 clips."""
    from fac_fake_torch.compat.quantize_s3d import quantize_s3d
    from fac_fake_torch.models import init_weights
    from fac_fake_torch.models.s3d.model import S3DNet
    from fac_fake_torch.ops import preprocess as pp
    from fac_fake_torch.ops import quant3d as q3

    spec = (("sep", 16, 7, 2, 3, "relu", True), ("pool", (1, 3, 3), (1, 2, 2), (0, 1, 1)),
            ("mix", "3b", "relu", True), ("pool", (2, 2, 2), (2, 2, 2), (0, 0, 0)))
    m = init_weights(S3DNet(spec, 1).to(dev), 0).eval().to(memory_format=torch.channels_last_3d)
    u8 = torch.from_numpy(np.random.default_rng(8).integers(
        0, 256, (2, 8, 32, 32, 3), dtype=np.uint8)).to(dev).permute(0, 4, 1, 2, 3)
    eng = quantize_s3d(m, u8.float())
    with torch.no_grad():
        quantized, raw = q3.quantize_pad.launches, pp.quantize_clips.launches
        fp = eng(u8.float())
        assert (q3.quantize_pad.launches, pp.quantize_clips.launches) == (quantized + 2, raw)
        got = eng(u8)
        assert (q3.quantize_pad.launches, pp.quantize_clips.launches) == (quantized + 3,
                                                                          raw + 1)
    assert torch.equal(got, fp)


# K7: CLAHE on the luma (ops/augment.py, csrc/clahe.cu), bit-equal to its
# plain version: the trainer's subset (8, 224²), a whole batch, a flat image
# (every bin clipped, the residual spread), every byte value, an image of
# odd tiles and one of 1-pixel tiles (grid 1)
def _k7_images(case, rng):
    if case == "flat":
        return np.full((2, 224, 224, 3), 131, np.uint8)
    if case == "every_byte":
        return (np.arange(224 * 224 * 3) % 256).reshape(1, 224, 224, 3).astype(np.uint8)
    shape = {"seeded8": (8, 224, 224, 3), "seeded32": (32, 224, 224, 3),
             "grid1_odd": (3, 120, 120, 3), "grid1_tiny": (5, 8, 8, 3),
             "small_grid8": (2, 32, 32, 3)}[case]
    return rng.integers(0, 256, shape, dtype=np.uint8)


@pytest.mark.parametrize("case", ["seeded8", "seeded32", "flat", "every_byte", "grid1_odd",
                                  "grid1_tiny", "small_grid8"])
def test_k7_clahe_equals_plain(dev, case):
    from fac_fake_torch.ops import augment as aug

    u8 = _k7_images(case, np.random.default_rng(7))
    x = (torch.from_numpy(u8).to(dev).float() / torch.full((1,), 255.0, device=dev)).contiguous()
    before = aug.clahe_luma.launches
    got = aug.clahe_luma(x)
    ref = aug.clahe_luma_plain(x)
    torch.cuda.synchronize()
    assert aug.clahe_luma.launches == before + 1
    assert torch.equal(got, ref), float((got - ref).abs().max())


def test_k7_refuses_what_it_does_not_take(dev):
    from fac_fake_torch.ops import augment as aug

    x = torch.rand((2, 16, 16, 3), device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        aug.clahe_luma(x[:, ::2].contiguous().transpose(1, 2))
    with pytest.raises(ValueError, match="float32"):
        aug.clahe_luma(x.half())
    with pytest.raises(ValueError, match="shape"):
        aug.clahe_luma(torch.rand((2, 16, 16, 4), device=dev))
    before = aug.clahe_luma.launches
    assert aug.clahe_luma(x[:0]).shape == (0, 16, 16, 3)
    assert aug.clahe_luma.launches == before


# K7's subset entry, the chain's step: in place, the first k_budget takers in
# index order, bit-equal to its plain version (JAX's _subset_apply written
# back); (images, takers, budget) of each case
_K7_SUBSETS = {
    "trainer": ((32, 224, 224, 3), 8, 8),           # the train step's budget, full
    "over_budget": ((32, 224, 224, 3), 12, 8),      # 4 takers left untouched
    "few_takers": ((32, 224, 224, 3), 3, 8),        # 5 slots find no taker
    "budget_n": ((32, 224, 224, 3), 13, 32),        # JAX's where branch
    "grid1": ((16, 120, 120, 3), 5, 8),             # 15-px tiles: one CTA a slot
    "grid1_tiny": ((16, 8, 8, 3), 9, 16),           # 1-px tiles
    "flat": ((16, 224, 224, 3), 6, 8),              # every bin clipped, the residual spread
    "streamed": ((4, 448, 448, 3), 3, 4),           # bands beyond shared memory: read twice
    "odd_width": ((8, 30, 30, 3), 4, 8),            # rows not 16-byte multiples: read twice
}


@pytest.mark.parametrize("case", list(_K7_SUBSETS))
def test_k7_subset_equals_plain(dev, case):
    from fac_fake_torch.ops import augment as aug

    shape, takers, budget = _K7_SUBSETS[case]
    rng = np.random.default_rng(11)
    u8 = (np.full(shape, 131, np.uint8) if case == "flat"
          else rng.integers(0, 256, shape, dtype=np.uint8))
    x = torch.from_numpy(u8).to(dev).float() / torch.full((1,), 255.0, device=dev)
    take = torch.zeros(shape[0], dtype=torch.bool)
    take[torch.from_numpy(rng.choice(shape[0], takers, replace=False))] = True
    take = take.to(dev)
    before = aug.clahe_luma.launches
    got = aug.clahe_subset_(x.clone(), take, budget)
    ref = aug.clahe_subset_plain_(x.clone(), take, budget)
    torch.cuda.synchronize()
    assert aug.clahe_luma.launches == before + 1
    assert torch.equal(got, ref), float((got - ref).abs().max())
    done = torch.nonzero(take).flatten()[:budget]
    changed = torch.zeros(shape[0], dtype=torch.bool, device=dev)
    changed[done] = True
    assert torch.equal(got[~changed], x[~changed])       # untaken and over-budget: their bits
    assert torch.equal(got[changed], aug.clahe_luma_plain(x[changed]))


# K7's bf16 mode (JAX's bf16 chain: CLAHE of the images in fp32, rounded
# back): bit-equal to its plain version; its bands are half the bytes, so
# these cases add one beyond shared memory in bf16 and rows of 44 x 6 B
_K7_BF16_SUBSETS = dict(_K7_SUBSETS, bf16_streamed=((2, 640, 640, 3), 2, 2),
                        bf16_odd_width=((4, 44, 44, 3), 3, 4))


def _bf16_01(u8, dev):
    return (torch.from_numpy(u8).to(dev).to(torch.bfloat16)
            / torch.full((1,), 255.0, device=dev, dtype=torch.bfloat16)).contiguous()


@pytest.mark.parametrize("case", ["seeded8", "seeded32", "flat", "every_byte", "grid1_odd",
                                  "grid1_tiny", "small_grid8"])
def test_k7_bf16_clahe_equals_plain(dev, case):
    from fac_fake_torch.ops import augment as aug

    x = _bf16_01(_k7_images(case, np.random.default_rng(7)), dev)
    before = aug.clahe_luma.bf16_launches
    got = aug.clahe_luma(x)
    ref = aug.clahe_luma_plain(x)
    torch.cuda.synchronize()
    assert aug.clahe_luma.bf16_launches == before + 1
    assert got.dtype == ref.dtype == torch.bfloat16
    assert torch.equal(got, ref), float((got.float() - ref.float()).abs().max())


@pytest.mark.parametrize("case", list(_K7_BF16_SUBSETS))
def test_k7_bf16_subset_equals_plain(dev, case):
    from fac_fake_torch.ops import augment as aug

    shape, takers, budget = _K7_BF16_SUBSETS[case]
    rng = np.random.default_rng(12)
    u8 = (np.full(shape, 131, np.uint8) if case == "flat"
          else rng.integers(0, 256, shape, dtype=np.uint8))
    x = _bf16_01(u8, dev)
    take = torch.zeros(shape[0], dtype=torch.bool)
    take[torch.from_numpy(rng.choice(shape[0], takers, replace=False))] = True
    take = take.to(dev)
    before = aug.clahe_luma.bf16_launches
    got = aug.clahe_subset_(x.clone(), take, budget)
    ref = aug.clahe_subset_plain_(x.clone(), take, budget)
    torch.cuda.synchronize()
    assert aug.clahe_luma.bf16_launches == before + 1
    assert torch.equal(got, ref), float((got.float() - ref.float()).abs().max())
    changed = torch.zeros(shape[0], dtype=torch.bool, device=dev)
    changed[torch.nonzero(take).flatten()[:budget]] = True
    assert torch.equal(got[~changed], x[~changed])
    assert torch.equal(got[changed],
                       aug.clahe_luma_plain(x[changed].float()).to(torch.bfloat16))


def test_k7_subset_refuses_what_it_does_not_take(dev):
    from fac_fake_torch.ops import augment as aug

    x = torch.rand((4, 16, 16, 3), device=dev)
    take = torch.ones(4, dtype=torch.bool, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        aug.clahe_subset_(x.transpose(1, 2), take, 2)
    with pytest.raises(ValueError, match="CUDA"):
        aug.clahe_subset_(x, take.cpu(), 2)
    with pytest.raises(ValueError, match="float32"):
        aug.clahe_subset_(x.half(), take, 2)
    with pytest.raises(ValueError, match="bool"):
        aug.clahe_subset_(x, take.to(torch.uint8), 2)
    with pytest.raises(ValueError, match="shape"):
        aug.clahe_subset_(x, take[:3], 2)
    before = aug.clahe_luma.launches
    assert aug.clahe_subset_(x, take, 0) is x
    assert aug.clahe_luma.launches == before


def test_train_step_on_the_card_runs_k7_and_k2(dev):
    """A tiny CViT's train step with the strong_aug chain at batch 32 runs
    K7 once (on its subset of 8); an eval step runs K2 once."""
    from fac_fake_torch.core.config import Config
    from fac_fake_torch.models import init_weights
    from fac_fake_torch.models.cvit import CViT
    from fac_fake_torch.ops import augment as aug
    from fac_fake_torch.ops import preprocess as pp
    from fac_fake_torch.train.trainer import Trainer

    spec = ()
    for _ in range(5):
        spec += (("conv", 8), ("bn", 8), ("relu",), ("pool",))
    m = init_weights(CViT(spec, image_size=32, patch_size=1, dim=32, depth=1, heads=2,
                          mlp_dim=32).to(dev), 0)
    cfg = Config()
    cfg.data.image_size = 32
    tr = Trainer(m, cfg)
    rng = np.random.default_rng(0)
    b = {"image": torch.from_numpy(rng.integers(0, 256, (32, 32, 32, 3), dtype=np.uint8)).to(dev),
         "label": torch.from_numpy(rng.integers(0, 2, 32)).to(dev),
         "mask": torch.ones(32, device=dev)}
    k7, k2 = aug.clahe_luma.launches, pp.normalize_imagenet.launches
    met = tr.train_step(b, torch.Generator(device=dev).manual_seed(0))
    ev = tr.eval_step(b)
    torch.cuda.synchronize()
    assert aug.clahe_luma.launches == k7 + 1 and pp.normalize_imagenet.launches == k2 + 1
    assert np.isfinite(float(met["loss"])) and np.isfinite(float(ev["loss"]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["cvit_ggca_add_odconv", "cvit_ggca_sla"])
def test_k7_in_a_zoo_train_step_equals_plain(dev, name, dtype):
    """One train step of a zoo entry at its published widths (the
    registry's defaults), batch 32 of seeded 224² crops, the strong_aug chain
    on, at ``model.dtype``: the chain calls K7 once, in its ``dtype`` mode,
    and that call's output is bit-equal to its plain version on the same
    input, takers and budget; untaken images keep their bits."""
    from fac_fake_torch.core.config import Config
    from fac_fake_torch.models import build_model
    from fac_fake_torch.ops import augment as aug
    from fac_fake_torch.train.trainer import Trainer

    cfg = Config()
    cfg.model.name = name
    cfg.model.dtype = dtype
    tr = Trainer(build_model(cfg.model, device=dev, seed=0), cfg)
    rng = np.random.default_rng(19)
    b = {"image": torch.from_numpy(rng.integers(0, 256, (32, 224, 224, 3), dtype=np.uint8)).to(dev),
         "label": torch.from_numpy(rng.integers(0, 2, 32)).to(dev),
         "mask": torch.ones(32, device=dev)}
    calls, real = [], aug.clahe_subset_

    def recording(x, take, k_budget, *a, **k):
        x0 = x.clone()
        out = real(x, take, k_budget, *a, **k)
        calls.append((x0, take.clone(), k_budget, out.clone()))
        return out

    k7, k7_bf16 = aug.clahe_luma.launches, aug.clahe_luma.bf16_launches
    aug.clahe_subset_ = recording
    try:
        met = tr.train_step(b, torch.Generator(device=dev).manual_seed(3))
    finally:
        aug.clahe_subset_ = real
    torch.cuda.synchronize()
    assert len(calls) == 1 and np.isfinite(float(met["loss"]))
    x0, take, budget, got = calls[0]
    want_dtype = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    assert x0.shape == (32, 224, 224, 3) and x0.dtype == want_dtype and budget == 8
    assert aug.clahe_luma.launches == k7 + 1
    assert aug.clahe_luma.bf16_launches == k7_bf16 + (dtype == "bfloat16")
    ref = aug.clahe_subset_plain_(x0.clone(), take, budget)
    assert torch.equal(got, ref), float((got.float() - ref.float()).abs().max())
    done = torch.zeros(32, dtype=torch.bool, device=dev)
    done[torch.nonzero(take).flatten()[:budget]] = True
    assert torch.equal(got[~done], x0[~done])


def _cell_boxes(rng, n, frac):
    """n x1y1x2y2 boxes like the cascade's: 12-px P-net cells on a stride-2
    grid (overlapping neighbours), integer or jittered by fractions."""
    x = rng.integers(0, 40, n) * 2.0
    y = rng.integers(0, 30, n) * 2.0
    side = rng.integers(10, 24, n).astype(np.float64)
    b = np.stack([x, y, x + side, y + side], axis=1)
    if frac:
        b = b + rng.uniform(-1.5, 1.5, b.shape)
    return b.astype(np.float32)


def k8_cases(seed=0):
    """K8's cases, name -> (boxes (N, 4) or (G, N, 4) fp32, scores, valid,
    iou_thresh, mode, max_out): the cascade's four call shapes (a frame's 12
    pyramid calls of 128 → 128 at 0.5, 1536 → 64 and 64 → 64 at 0.7 union,
    64 → 32 at 0.7 min), integer and fractional boxes; exact score ties; NaN
    scores and a NaN box; zero-area and inverted boxes; ±inf scores; none
    valid; max_out above the live count; max_out 0; one candidate; 4096."""
    rng = np.random.default_rng(seed)
    out = {}

    def scored(b, p_valid=0.7, ties=False):
        s = rng.uniform(0.0, 1.0, b.shape[:-1]).astype(np.float32)
        if ties:
            s = np.round(s * 4) / 4          # five distinct values
        v = rng.random(b.shape[:-1]) < p_valid
        return s, v

    b = np.stack([_cell_boxes(rng, 128, False) for _ in range(12)])
    out["pyramid_12x128_int"] = (b, *scored(b), 0.5, "union", 128)
    b = np.stack([_cell_boxes(rng, 128, True) for _ in range(12)])
    s, v = scored(b, 0.4)
    s[:, 100:] = -1.0                        # a small level's padding: -1.0, invalid
    v[:, 100:] = False
    out["pyramid_12x128_frac"] = (b, s, v, 0.5, "union", 128)
    b = _cell_boxes(rng, 1536, True)
    out["stage1_1536_64"] = (b, *scored(b), 0.7, "union", 64)
    b = _cell_boxes(rng, 64, False)
    out["rnet_64_64"] = (b, *scored(b, 1.0), 0.7, "union", 64)
    b = _cell_boxes(rng, 64, True)
    out["onet_64_32_min"] = (b, *scored(b, 0.9), 0.7, "min", 32)
    b = _cell_boxes(rng, 128, False)
    out["ties_union"] = (b, *scored(b, 1.0, ties=True), 0.3, "union", 128)
    out["ties_min"] = (b, *scored(b, 1.0, ties=True), 0.5, "min", 64)
    b = _cell_boxes(rng, 64, True)
    s, v = scored(b, 1.0)
    s[[3, 17, 40]] = np.nan                  # valid NaN scores: first, not kept, suppressing
    b[9] = [np.nan, 2.0, 20.0, 30.0]         # a NaN box
    s[9] = 0.99
    s[50], v[50] = np.nan, False             # an invalid NaN: never read
    out["nan"] = (b, s, v, 0.5, "union", 64)
    b = _cell_boxes(rng, 64, False)
    s, v = scored(b, 1.0)
    b[5] = [10.0, 10.0, 9.0, 9.0]            # zero area with the +1
    b[6] = [30.0, 30.0, 20.0, 35.0]          # inverted: a negative area
    b[7] = [4.0, 4.0, 4.0, 4.0]              # a one-pixel box
    s[[5, 6, 7]] = [0.999, 0.998, 0.997]
    out["zero_area_inverted"] = (b, s, v, 0.5, "union", 64)
    out["zero_area_inverted_min"] = (b, s, v, 0.5, "min", 64)
    s2 = s.copy()
    s2[[0, 1, 2]] = [np.inf, -np.inf, np.inf]
    out["inf_scores"] = (b, s2, v, 0.5, "union", 64)
    out["all_invalid"] = (b, s, np.zeros_like(v), 0.7, "union", 32)
    v3 = np.zeros_like(v)
    v3[[4, 30, 31, 60]] = True
    out["max_out_above_live"] = (b, s, v3, 0.7, "union", 64)
    out["max_out_0"] = (b, s, v, 0.7, "union", 0)
    out["one_candidate"] = (b[:1], s[:1], v[:1], 0.7, "union", 4)
    b = _cell_boxes(rng, 4096, True)
    out["n_4096"] = (b, *scored(b), 0.7, "union", 96)
    out.update(k8_tile_cases(rng))
    return out


def _disjoint_boxes(n):
    """n 10-px boxes 20 px apart on a grid of 16 columns: no two overlap."""
    c = np.arange(n)
    x, y = (c % 16) * 20.0, (c // 16) * 20.0
    return np.stack([x, y, x + 10.0, y + 10.0], axis=1).astype(np.float32)


def k8_tile_cases(rng):
    """Cases at the edges of K8's 32-candidate tiles: live counts of 31, 32
    and 33 (all surviving); 1024 live with max_out 4; NaN scores and exact
    ties straddling the first tile boundary; one box that suppresses every
    later one; exactly max_out survivors (the better of each overlapping
    pair), the last past the second tile; a
    G-batched call with one call of no live candidate and one all live."""
    out = {}
    for n_live in (31, 32, 33):
        b = _disjoint_boxes(64)[rng.permutation(64)]
        s = rng.uniform(0.0, 1.0, 64).astype(np.float32)
        v = np.zeros(64, bool)
        v[rng.permutation(64)[:n_live]] = True
        out[f"live_{n_live}"] = (b, s, v, 0.7, "union", 40)
    b = _cell_boxes(rng, 1024, True)
    out["live_1024_max_out_4"] = (b, rng.uniform(0.0, 1.0, 1024).astype(np.float32),
                                  np.ones(1024, bool), 0.7, "union", 4)
    b = _cell_boxes(rng, 128, False)
    s = np.round(rng.uniform(0.0, 1.0, 128) * 4).astype(np.float32) / 4   # exact ties
    order = rng.permutation(128)
    s[order[:28]] = np.nan                  # sorted positions 0-27: NaN
    s[order[28:38]] = 2.0                   # 28-37: one tied score across the boundary
    out["nan_and_ties_across_a_tile"] = (b, s, np.ones(128, bool), 0.5, "union", 128)
    b = _cell_boxes(rng, 256, False)
    s = rng.uniform(0.0, 1.0, 256).astype(np.float32)
    b[37], s[37] = [0.0, 0.0, 200.0, 200.0], 2.0   # holds every other box: min IoU 1
    out["one_box_suppresses_all"] = (b, s, np.ones(256, bool), 0.7, "min", 64)
    d = _disjoint_boxes(48)
    b = np.concatenate([d, d + np.float32(1.0)])  # each cell twice: IoU 0.70 > 0.5
    s = rng.uniform(0.0, 1.0, 96).astype(np.float32)
    out["exactly_max_out_survivors"] = (b, s, np.ones(96, bool), 0.5, "union", 48)
    b = np.stack([_cell_boxes(rng, 128, True) for _ in range(3)])
    s = rng.uniform(0.0, 1.0, (3, 128)).astype(np.float32)
    v = np.ones((3, 128), bool)
    v[0] = False                            # call 0: no live candidate
    v[2] = rng.random(128) < 0.3            # call 2: a few
    out["batched_none_and_all_live"] = (b, s, v, 0.7, "union", 64)
    return out


@pytest.mark.parametrize("case", list(k8_cases()))
def test_k8_hard_nms_equals_plain(dev, case):
    from fac_fake_torch.ops import nms

    boxes, scores, valid, thr, mode, max_out = k8_cases()[case]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    before = nms.hard_nms.launches
    idx, keep = nms.hard_nms(t(boxes), t(scores), t(valid), thr, mode, max_out)
    pidx, pkeep = nms.hard_nms_plain(t(boxes), t(scores), t(valid), thr, mode, max_out)
    torch.cuda.synchronize()
    assert nms.hard_nms.launches == before + 1
    assert idx.shape == pidx.shape == (*boxes.shape[:-2], max_out)
    assert idx.dtype == torch.long and keep.dtype == torch.bool
    assert torch.equal(idx, pidx) and torch.equal(keep, pkeep)


def test_k8_refuses_what_it_does_not_take(dev):
    from fac_fake_torch.ops import nms

    b = torch.rand((2, 8, 4), device=dev)
    s = torch.rand((2, 8), device=dev)
    v = torch.ones((2, 8), dtype=torch.bool, device=dev)
    with pytest.raises(ValueError, match="float32"):
        nms.hard_nms(b.double(), s, v)
    with pytest.raises(ValueError, match="bool"):
        nms.hard_nms(b, s, v.to(torch.uint8))
    with pytest.raises(ValueError, match="CUDA"):
        nms.hard_nms(b, s.cpu(), v)
    with pytest.raises(ValueError, match="contiguous"):
        nms.hard_nms(b.transpose(0, 1).contiguous().transpose(0, 1), s, v)
    with pytest.raises(ValueError, match="do not match"):
        nms.hard_nms(b, s[:, :7], v)
    with pytest.raises(ValueError, match="mode"):
        nms.hard_nms(b, s, v, mode="max")
    big = nms.MAX_CANDIDATES + 1
    with pytest.raises(ValueError, match="one CTA"):
        nms.hard_nms(torch.zeros((big, 4), device=dev), torch.zeros(big, device=dev),
                     torch.zeros(big, dtype=torch.bool, device=dev))


# K9: (B, in) of the KAN heads on the main path -- resvitkan at capacity 96
# and at 8 x 32 rows (2048 -> 64 -> 2), reskan's (512 -> 64 -> 2) -- and a
# ragged shape
K9_SHAPES = [(96, 2048), (96, 64), (256, 2048), (256, 64), (96, 512), (3, 37)]


# K9 grids on which the full recursion gives NaN (0/0, inf - inf)
K9_NAN_GRIDS = ("repeated", "nonfinite")


def k9_grid(case, n_in, seed=0, grid_size=5, order=3):
    """(in, grid_size + 2·order + 1) fp32 knots: the default grid; a sorted
    per-feature perturbation of it (non-uniform, as after a refit); the
    default with feature 1's knots 4 and 5 equal (a repeated knot); knots
    0.25 apart with knot 5 at +0 on even features and -0 on odd ones
    ("zero_knot"); the default with feature 1's knots 4 and 5 swapped
    (unsorted); the default with feature 1's knot 6 at +inf, feature 2's
    knot 0 at -inf and feature 3's knot 3 NaN ("nonfinite"); knots 1e-30
    apart around 0 ("tiny")."""
    from fac_fake_torch.models.blocks.kan import default_grid

    g = default_grid(n_in, grid_size, order)
    n_knots = g.shape[1]
    if case == "nonuniform":
        h = 2.0 / grid_size
        jitter = np.random.default_rng(seed).uniform(-0.45 * h, 0.45 * h, g.shape)
        g = np.sort(g + jitter.astype(np.float32), axis=1)
    elif case == "repeated":
        g = g.copy()
        g[1 % n_in, 5] = g[1 % n_in, 4]
    elif case == "zero_knot":
        g = np.tile((np.arange(n_knots, dtype=np.float32) - 5) * np.float32(0.25), (n_in, 1))
        g[1::2, 5] = -0.0
    elif case == "swapped":
        g = g.copy()
        g[1 % n_in, [4, 5]] = g[1 % n_in, [5, 4]]
    elif case == "nonfinite":
        g = g.copy()
        g[1 % n_in, 6], g[2 % n_in, 0], g[3 % n_in, 3] = np.inf, -np.inf, np.nan
    elif case == "tiny":
        g = np.tile(((np.arange(n_knots) - 5.5) * 1e-30).astype(np.float32), (n_in, 1))
    return g


def k9_x(grid, rows, seed=0, extreme=False):
    """Seeded x over the grid's span and 0.3 beyond it, with planted rows
    (as far as ``rows`` reaches): each knot exactly, below the first, at the
    last, one ulp past it, +0.0, -0.0; with ``extreme``, then ±1e38, ±inf and
    NaN."""
    rng = np.random.default_rng(seed)
    n_in, n_knots = grid.shape
    with np.errstate(invalid="ignore", over="ignore"):
        lo, hi = grid[:, 0] - 0.3, grid[:, -1] + 0.3
        x = (lo + (hi - lo) * rng.random((rows, n_in))).astype(np.float32)
    x[~np.isfinite(x)] = 0.5                # a non-finite knot's feature
    planted = [grid[:, j] for j in range(n_knots)] + [
        grid[:, 0] - 0.5, grid[:, -1], np.nextafter(grid[:, -1], np.float32(np.inf)),
        np.zeros(n_in), np.full(n_in, -0.0)]
    if extreme:
        planted += [np.full(n_in, v) for v in (1e38, -1e38, np.inf, -np.inf, np.nan)]
    for r, p in enumerate(planted[:rows]):
        x[r] = p
    return x


def k9_same_bits(a, b) -> bool:
    """Bit-equal, with NaN equal only where both are NaN."""
    nan = torch.isnan(a)
    if not torch.equal(nan, torch.isnan(b)):
        return False
    ints = torch.int32 if a.dtype == torch.float32 else torch.int16
    return torch.equal(a[~nan].view(ints), b[~nan].view(ints))


K9_GRIDS = ["default", "nonuniform", "repeated", "zero_knot", "swapped", "nonfinite", "tiny"]


@pytest.mark.parametrize("shape", K9_SHAPES)
@pytest.mark.parametrize("grid_case", K9_GRIDS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k9_kan_bases_equals_plain(dev, shape, grid_case, dtype):
    from fac_fake_torch.ops import kan

    g = k9_grid(grid_case, shape[1])
    x = torch.from_numpy(k9_x(g, shape[0])).to(dev, dtype)
    grid = torch.from_numpy(g).to(dev, dtype)
    before = kan.kan_bases.launches
    got = kan.kan_bases(x, grid, 3)
    ref = kan.kan_bases_plain(x, grid, 3)
    torch.cuda.synchronize()
    assert kan.kan_bases.launches == before + 1
    assert got.shape == ref.shape == (*shape, 8) and got.is_contiguous()
    assert k9_same_bits(got, ref)
    assert bool(torch.isnan(got).any()) == (grid_case in K9_NAN_GRIDS)


@pytest.mark.parametrize("grid_case", K9_GRIDS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k9_extreme_x_equals_plain(dev, grid_case, dtype):
    """x at ±1e38, ±inf and NaN (outside the fast path's range: the full
    recursion) beside in-range rows, on every grid: bit-equal, NaN where the
    plain version has it."""
    from fac_fake_torch.ops import kan

    g = k9_grid(grid_case, 64)
    x = torch.from_numpy(k9_x(g, 96, extreme=True)).to(dev, dtype)
    grid = torch.from_numpy(g).to(dev, dtype)
    got = kan.kan_bases(x, grid, 3)
    ref = kan.kan_bases_plain(x, grid, 3)
    torch.cuda.synchronize()
    assert bool(torch.isnan(ref).any())
    assert k9_same_bits(got, ref)


@pytest.mark.parametrize("grid_size,order", [(5, 0), (5, 1), (5, 2), (4, 3), (3, 5), (9, 3),
                                             (1, 5)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k9_other_orders_and_grids_equal_plain(dev, grid_size, order, dtype):
    """Orders 0-5 and grids up to K9's 16 knots: the scalar stores (bases not
    filling 16 bytes) and the kernel past the heads' (12 knots, order 3)."""
    from fac_fake_torch.ops import kan

    g = k9_grid("nonuniform", 70, 1, grid_size, order)
    x = torch.from_numpy(k9_x(g, 33, 1)).to(dev, dtype)
    grid = torch.from_numpy(g).to(dev, dtype)
    got = kan.kan_bases(x, grid, order)
    assert got.shape == (33, 70, grid_size + order)
    assert k9_same_bits(got, kan.kan_bases_plain(x, grid, order))


def test_k9_refuses_what_it_does_not_take(dev):
    from fac_fake_torch.ops import kan

    x = torch.rand((4, 6), device=dev)
    grid = torch.from_numpy(k9_grid("default", 6)).to(dev)
    with pytest.raises(ValueError, match="no kernel"):
        kan.kan_bases(x.double(), grid.double(), 3)
    with pytest.raises(ValueError, match="bfloat16"):
        kan.kan_bases(x, grid.bfloat16(), 3)
    with pytest.raises(ValueError, match="contiguous"):
        kan.kan_bases(x.t().contiguous().t(), grid, 3)
    with pytest.raises(ValueError, match="CUDA"):
        kan.kan_bases(x, grid.cpu(), 3)
    with pytest.raises(ValueError, match="caps"):
        kan.kan_bases(x, torch.zeros((6, 17), device=dev), 3)
    with pytest.raises(ValueError, match="caps"):
        kan.kan_bases(x, torch.zeros((6, 16), device=dev), 6)


def test_k9_refuses_a_grad_tracked_input(dev):
    """K9 has no backward: a CUDA ``x`` that requires grad raises while grad
    mode is on, and launches under ``no_grad`` or ``inference_mode``; the
    `Trainer` refuses the KAN models on the card as on the CPU."""
    from fac_fake_torch.core.config import Config, ModelConfig
    from fac_fake_torch.models import build_model
    from fac_fake_torch.ops import kan
    from fac_fake_torch.train.trainer import Trainer

    x = torch.rand((4, 6), device=dev, requires_grad=True)
    grid = torch.from_numpy(k9_grid("default", 6)).to(dev)
    before = kan.kan_bases.launches
    with pytest.raises(RuntimeError, match="no backward"):
        kan.kan_bases(x, grid, 3)
    assert kan.kan_bases.launches == before
    with torch.no_grad():
        got = kan.kan_bases(x, grid, 3)
    with torch.inference_mode():
        got_inf = kan.kan_bases(x.detach(), grid, 3)
    assert kan.kan_bases.launches == before + 2
    ref = kan.kan_bases_plain(x.detach(), grid, 3)
    assert k9_same_bits(got, ref) and k9_same_bits(got_inf, ref)
    m = build_model(ModelConfig(name="resvitkan", image_size=64, patch_size=2, dim=64, depth=1,
                                heads=2, mlp_dim=128), device=dev, seed=0)
    with pytest.raises(ValueError, match="KANLinear"):
        Trainer(m, Config(), device=dev)


def test_resvitkan_forward_runs_k9_twice_and_matches_the_cpu(dev):
    """A reduced ``resvitkan`` from uint8 crops on the card: 1 K2 launch, 2
    K9 launches (2048-wide head reduced to mlp 128: (B, 128) then (B, 64)),
    logits within 1e-3 of the same module on the CPU (TF32 off)."""
    import copy

    from fac_fake_torch.core.config import ModelConfig
    from fac_fake_torch.models import build_model
    from fac_fake_torch.ops import kan
    from fac_fake_torch.ops import preprocess as pp

    m = build_model(ModelConfig(name="resvitkan", image_size=64, patch_size=2, dim=64, depth=1,
                                heads=2, mlp_dim=128), device=dev, seed=0)
    u8 = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (40, 64, 64, 3), dtype=np.uint8))
    pos = torch.arange(40) % 32
    k9, k2 = kan.kan_bases.launches, pp.normalize_imagenet.launches
    with torch.inference_mode():
        got = m.forward_crops(u8.to(dev), torch.float32, pos.to(dev)).cpu()
        torch.cuda.synchronize()
        assert kan.kan_bases.launches == k9 + 2 and pp.normalize_imagenet.launches == k2 + 1
        ref = copy.deepcopy(m).cpu().forward_crops(u8, torch.float32, pos)
    assert torch.isfinite(got).all()
    assert float((got - ref).abs().max()) <= 1e-3


# ---- K10: the S3D transform's JPEG step --------------------------------------------

def _k10_frames(kind, n, rng, hw=(224, 224)):
    if kind == "flat":
        u8 = np.full((n, *hw, 3), 77, np.uint8)
    elif kind == "every_byte":
        u8 = (np.arange(n * hw[0] * hw[1] * 3) % 256).reshape(n, *hw, 3).astype(np.uint8)
    else:
        u8 = rng.integers(0, 256, (n, *hw, 3), dtype=np.uint8)
    return u8


@pytest.mark.parametrize("kind", ["seeded", "flat", "every_byte"])
@pytest.mark.parametrize("quality", [1, 50, 60, 99, 100, "seeded"])
@pytest.mark.parametrize("take", ["none", "all", "seeded"])
def test_k10_jpeg_equals_plain(dev, kind, quality, take):
    """K10 in place against `jpeg_subset_plain_` on copies of the same
    frames: untaken frames keep their bits, taken ones equal bit for bit
    (the kernel does the plain version's fp32 operations in its order; the
    flat frame's luma DC at quality 50, 8 · (77 − 128) / 16 = −25.5, is an
    exact tie that both round half to even); one launch."""
    from fac_fake_torch.ops import jpeg as oj

    rng = np.random.default_rng(5)
    n = 8
    x = torch.from_numpy(_k10_frames(kind, n, rng)).to(dev).float() \
        / torch.full((1,), 255.0, device=dev)
    q = (np.floor(rng.uniform(60, 100, n)) if quality == "seeded"
         else np.full(n, quality)).astype(np.float32)
    q = torch.from_numpy(q).to(dev)
    t = {"none": np.zeros(n, bool), "all": np.ones(n, bool),
         "seeded": rng.random(n) < 0.3}[take]
    t = torch.from_numpy(t).to(dev)
    before = oj.jpeg_subset_.launches
    got = oj.jpeg_subset_(x.clone(), t, q)
    ref = oj.jpeg_subset_plain_(x.clone(), t, q)
    torch.cuda.synchronize()
    assert oj.jpeg_subset_.launches == before + 1
    assert torch.equal(got[~t], x[~t])
    assert torch.equal(got[t], ref[t])


@pytest.mark.parametrize("shape, taken", [
    ((3, 64, 1920, 3), "all"),        # 8 chunks of 15 MCUs a band
    ((5, 48, 80, 3), "seeded"),       # one chunk of 5 MCUs, less than a whole chunk
    ((2, 32, 272, 3), "all"),         # 17 MCUs: chunks of 9 and 8
    ((6, 32, 32, 3), "last"),         # only the last frame
    ((1, 224, 224, 3), "all"),        # N = 1
])
def test_k10_geometries_equal_plain(dev, shape, taken):
    """K10's work items over frames wider than a chunk, a ragged last chunk,
    one frame, and only the last frame taken: bit-equal to the plain
    version, untaken frames unchanged."""
    from fac_fake_torch.ops import jpeg as oj

    rng = np.random.default_rng(6)
    n = shape[0]
    x = torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).to(dev).float() \
        / torch.full((1,), 255.0, device=dev)
    q = torch.from_numpy(np.floor(rng.uniform(1, 100, n)).astype(np.float32)).to(dev)
    t = {"all": np.ones(n, bool), "seeded": rng.random(n) < 0.5,
         "last": np.arange(n) == n - 1}[taken]
    t[-1 if taken == "last" else rng.integers(n)] = True      # at least one taken
    t = torch.from_numpy(t).to(dev)
    got = oj.jpeg_subset_(x.clone(), t, q)
    ref = oj.jpeg_subset_plain_(x.clone(), t, q)
    torch.cuda.synchronize()
    assert torch.equal(got[~t], x[~t])
    assert torch.equal(got[t], ref[t])
    assert not torch.equal(got[t], x[t])


@pytest.mark.parametrize("kind", ["seeded", "flat", "every_byte"])
@pytest.mark.parametrize("quality", [1, 50, 60, 99, 100, "seeded"])
@pytest.mark.parametrize("take", ["none", "all", "seeded"])
def test_k10_bf16_jpeg_equals_plain(dev, kind, quality, take):
    """K10's bf16 mode (JAX's bf16 JPEG steps: YCbCr in bf16 arithmetic, the
    chroma mean and block − 128 rounded to bf16, the DCTs in fp32, the store
    rounded to bf16) against `jpeg_subset_plain_` on bf16 frames: bit for
    bit, untaken frames unchanged; one launch."""
    from fac_fake_torch.ops import jpeg as oj

    rng = np.random.default_rng(5)
    n = 8
    x = _bf16_01(_k10_frames(kind, n, rng), dev)
    q = (np.floor(rng.uniform(60, 100, n)) if quality == "seeded"
         else np.full(n, quality)).astype(np.float32)
    q = torch.from_numpy(q).to(dev)
    t = {"none": np.zeros(n, bool), "all": np.ones(n, bool),
         "seeded": rng.random(n) < 0.3}[take]
    t = torch.from_numpy(t).to(dev)
    before = oj.jpeg_subset_.bf16_launches
    got = oj.jpeg_subset_(x.clone(), t, q)
    ref = oj.jpeg_subset_plain_(x.clone(), t, q)
    torch.cuda.synchronize()
    assert oj.jpeg_subset_.bf16_launches == before + 1
    assert got.dtype == torch.bfloat16
    assert torch.equal(got[~t], x[~t])
    assert torch.equal(got[t], ref[t])


@pytest.mark.parametrize("shape, taken", [
    ((3, 64, 1920, 3), "all"), ((5, 48, 80, 3), "seeded"), ((2, 32, 272, 3), "all"),
    ((6, 32, 32, 3), "last"), ((1, 224, 224, 3), "all")])
def test_k10_bf16_geometries_equal_plain(dev, shape, taken):
    """K10's bf16 mode over the work-item geometries of the fp32 test: bf16
    row segments are 96 B an MCU, still 16-byte aligned."""
    from fac_fake_torch.ops import jpeg as oj

    rng = np.random.default_rng(6)
    n = shape[0]
    x = _bf16_01(rng.integers(0, 256, shape, dtype=np.uint8), dev)
    q = torch.from_numpy(np.floor(rng.uniform(1, 100, n)).astype(np.float32)).to(dev)
    t = {"all": np.ones(n, bool), "seeded": rng.random(n) < 0.5,
         "last": np.arange(n) == n - 1}[taken]
    t[-1 if taken == "last" else rng.integers(n)] = True
    t = torch.from_numpy(t).to(dev)
    got = oj.jpeg_subset_(x.clone(), t, q)
    ref = oj.jpeg_subset_plain_(x.clone(), t, q)
    torch.cuda.synchronize()
    assert torch.equal(got[~t], x[~t])
    assert torch.equal(got[t], ref[t])
    assert not torch.equal(got[t], x[t])


def test_k10_division_is_ieee(dev):
    """K10's quantization and its / 255 (a reciprocal product and one
    residual step) give the IEEE results for every float and every divisor
    1..255."""
    from fac_fake_torch.ops import jpeg as oj

    assert oj.division_check(dev) == 0


def test_k10_refuses_what_it_does_not_take(dev):
    from fac_fake_torch.ops import jpeg as oj

    x = torch.rand((2, 32, 32, 3), device=dev)
    take = torch.ones(2, dtype=torch.bool, device=dev)
    q = torch.full((2,), 80.0, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        oj.jpeg_subset_(x.transpose(1, 2), take, q)
    with pytest.raises(ValueError, match="float32"):
        oj.jpeg_subset_(x.half(), take, q)
    with pytest.raises(ValueError, match="CUDA"):
        oj.jpeg_subset_(x, take.cpu(), q)
    with pytest.raises(ValueError, match="bool"):
        oj.jpeg_subset_(x, take.to(torch.uint8), q)
    with pytest.raises(ValueError, match="float32"):
        oj.jpeg_subset_(x, take, q.double())
    with pytest.raises(ValueError, match="multiples of 16"):
        oj.jpeg_subset_(torch.rand((2, 24, 32, 3), device=dev), take, q)
    shifted = torch.rand(1 + 2 * 32 * 32 * 3, device=dev)[1:].view(2, 32, 32, 3)
    with pytest.raises(ValueError, match="16-byte aligned"):
        oj.jpeg_subset_(shifted, take, q)
    before = oj.jpeg_subset_.launches
    assert oj.jpeg_subset_(x[:0], take[:0], q[:0]).shape == (0, 32, 32, 3)
    assert oj.jpeg_subset_.launches == before


def test_s3d_train_step_on_the_card_runs_k10(dev):
    """A ``ca_s3d`` train step at 32², 16 frames, batch 2 under plan1_2's
    transform runs K10 once; with the transform off, never; the eval step
    (raw255) runs no K2."""
    import os
    from fac_fake_torch.core.plans import load_plan
    from fac_fake_torch.models import build_model
    from fac_fake_torch.ops import jpeg as oj
    from fac_fake_torch.ops import preprocess as pp
    from fac_fake_torch.train.trainer import Trainer

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = load_plan(os.path.join(root, "configs", "plan1_2.yaml"))
    cfg.data.normalize = "raw255"
    cfg.model.image_size = 32
    tr = Trainer(build_model(cfg.model, device=dev), cfg, loss_kwargs={"pos_weight": 0.3})
    rng = np.random.default_rng(0)
    b = {"image": torch.from_numpy(rng.integers(0, 256, (2, 16, 32, 32, 3),
                                                dtype=np.uint8)).to(dev),
         "label": torch.tensor([0, 1], device=dev), "mask": torch.ones(2, device=dev)}
    k10, k2 = oj.jpeg_subset_.launches, pp.normalize_imagenet.launches
    met = tr.train_step(b, torch.Generator(device=dev).manual_seed(0))
    tr.cfg.data.augment.enabled = False
    tr.train_step(b, torch.Generator(device=dev).manual_seed(0))
    ev = tr.eval_step(b)
    torch.cuda.synchronize()
    assert oj.jpeg_subset_.launches == k10 + 1 and pp.normalize_imagenet.launches == k2
    assert np.isfinite(float(met["loss"])) and np.isfinite(float(ev["loss"]))

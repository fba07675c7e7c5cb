"""The port's int8 serving path against the JAX package on the CPU: the
quantized layers, the exact integer products, `quantize_cvit`, logits from
JAX-quantized variables carried across, and `VideoScorer` with
``infer.quantize`` set. Inputs are made from numpy seeds; JAX runs on the
CPU as in `tests/test_quantize.py`."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

torch.set_num_threads(2)


def _flat(variables):
    return {"/".join(k): np.asarray(v) for k, v in traverse_util.flatten_dict(variables).items()}


def _spec():
    spec = ()
    for ch in (8, 16):
        spec += (("conv", ch), ("bn", ch), ("relu",),
                 ("conv", ch), ("bn", ch), ("relu",), ("pool",))
    return spec


# the tiny CViT of tests/test_quantize.py:12-19 and the transformer=True one
# of :161-202, on 32×32 inputs
TINY = dict(patch_size=1, dim=32, depth=1, heads=2, mlp_dim=32)
TINY_TR = dict(patch_size=1, dim=32, depth=2, heads=2, mlp_dim=64)


def _jax_folded(kw, pos_mode, seed):
    from fac_fake_tpu.compat.fold import fold_cvit
    from fac_fake_tpu.models.cvit import CViT
    jm = CViT(stem_spec=_spec(), pos_mode=pos_mode, **kw)
    rng = np.random.default_rng(seed)
    x0 = (rng.standard_normal((4, 32, 32, 3)) * 0.5).astype(np.float32)
    v = jm.init(jax.random.key(seed), jnp.asarray(x0[:1]))
    fm, fv = fold_cvit(jm, v)
    return fm, fv, x0, rng


def _port(spec, kw, pos_mode, flat, quant_dense=False):
    from fac_fake_torch.compat.weights import cvit_state_dict_from_flax
    from fac_fake_torch.models.cvit import CViT
    m = CViT(spec, image_size=32, pos_mode=pos_mode, quant_dense=quant_dense, **kw)
    m.load_state_dict(cvit_state_dict_from_flax(flat), strict=True)
    return m.eval()


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


# ---- (a) the layers -------------------------------------------------------

@pytest.mark.parametrize("cin,cout,hw", [(3, 8, (9, 7)), (16, 24, (6, 6))])
def test_quant_conv3x3_matches_jax_layer(cin, cout, hw):
    from fac_fake_tpu.models.layers import QuantConv3x3 as JaxQConv
    from fac_fake_torch.compat.weights import t_conv
    from fac_fake_torch.models.layers import QuantConv3x3

    rng = np.random.default_rng(cin)
    x = rng.standard_normal((2, *hw, cin)).astype(np.float32)
    p = {"kernel_q": rng.integers(-127, 128, (3, 3, cin, cout)).astype(np.int8),
         "w_scale": rng.uniform(0.01, 0.1, (cout,)).astype(np.float32),
         "x_scale": np.float32(0.03),
         "bias": rng.standard_normal((cout,)).astype(np.float32)}
    ref = np.asarray(JaxQConv(cout, dtype=jnp.float32).apply(
        {"params": {k: jnp.asarray(v) for k, v in p.items()}}, jnp.asarray(x)))
    m = QuantConv3x3(cin, cout)
    m.load_state_dict({"kernel_q": torch.from_numpy(np.ascontiguousarray(t_conv(p["kernel_q"]))),
                       "w_scale": torch.from_numpy(p["w_scale"]),
                       "x_scale": torch.tensor(p["x_scale"]),
                       "bias": torch.from_numpy(p["bias"])})
    got = m(_nchw(x))
    assert got.dtype == torch.float32 and got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("shape,bias", [((5, 40), True), ((2, 3, 40), True), ((2, 3, 40), False)])
def test_quant_linear_matches_jax_layer(shape, bias):
    from fac_fake_tpu.models.layers import QuantDense
    from fac_fake_torch.models.layers import QuantLinear

    rng = np.random.default_rng(len(shape))
    x = rng.standard_normal(shape).astype(np.float32)
    p = {"kernel_q": rng.integers(-127, 128, (40, 24)).astype(np.int8),
         "w_scale": rng.uniform(0.01, 0.1, (24,)).astype(np.float32),
         "x_scale": np.float32(0.02)}
    if bias:
        p["bias"] = rng.standard_normal((24,)).astype(np.float32)
    ref = np.asarray(QuantDense(24, use_bias=bias, dtype=jnp.float32).apply(
        {"params": {k: jnp.asarray(v) for k, v in p.items()}}, jnp.asarray(x)))
    m = QuantLinear(40, 24, bias=bias)
    sd = {"kernel_q": torch.from_numpy(np.ascontiguousarray(p["kernel_q"].T)),
          "w_scale": torch.from_numpy(p["w_scale"]), "x_scale": torch.tensor(p["x_scale"])}
    if bias:
        sd["bias"] = torch.from_numpy(p["bias"])
    m.load_state_dict(sd, strict=True)
    got = m(torch.from_numpy(x))
    assert got.shape == shape[:-1] + (24,)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-4)


# ---- (b) the exact integer products ---------------------------------------

def test_plain_int_conv_equals_numpy_int64():
    """Sums up to 9·512·127² ≈ 7.4e7, above fp32's exact 2^24."""
    from fac_fake_torch.ops.quant import int_conv3x3_plain

    rng = np.random.default_rng(0)
    xq = rng.choice(np.array([-127, 127, -1, 0, 5], np.int8), (2, 4, 5, 512))
    xq[0] = 127
    wq = rng.integers(-127, 128, (6, 512, 3, 3)).astype(np.int8)
    wq[0] = 127
    got = int_conv3x3_plain(torch.from_numpy(xq), torch.from_numpy(wq)).numpy()
    xp = np.pad(xq.astype(np.int64), ((0, 0), (1, 1), (1, 1), (0, 0)))
    ref = np.zeros((2, 4, 5, 6), np.int64)
    for dy in range(3):
        for dx in range(3):
            ref += np.einsum("bhwc,oc->bhwo", xp[:, dy:dy + 4, dx:dx + 5],
                             wq[:, :, dy, dx].astype(np.int64))
    assert got.dtype == np.int32 and int(np.abs(ref).max()) > 2 ** 24
    assert np.array_equal(got, ref)


def test_plain_int_matmul_equals_numpy_int64():
    """K = 25088, the patch embedding's depth: sums up to 4.0e8."""
    from fac_fake_torch.ops.quant import int_matmul_plain

    rng = np.random.default_rng(1)
    xq = rng.integers(-127, 128, (3, 25088)).astype(np.int8)
    xq[0] = -127
    wq = rng.integers(-127, 128, (5, 25088)).astype(np.int8)
    wq[0] = 127
    got = int_matmul_plain(torch.from_numpy(xq), torch.from_numpy(wq)).numpy()
    ref = xq.astype(np.int64) @ wq.astype(np.int64).T
    assert got.dtype == np.int32 and int(np.abs(ref).max()) > 2 ** 24
    assert np.array_equal(got, ref)


def test_dense_splits_cover_k_for_the_path_shapes():
    """K4's split of K over the CTAs of one cluster: (rows, out, in) of the
    int8_full path at batch 96, a K that is no multiple of 16, and rows
    past one 256-row tile. Every split has k-tiles, together all of them;
    the row tile is the narrowest wgmma N that holds the rows."""
    from fac_fake_torch.ops.quant import (DENSE_BK, DENSE_MAX_SPLITS, dense_rows_tile,
                                          dense_splits, pad16)

    want = {(96, 1024, 25088): 8, (192, 3072, 1024): 4, (192, 1024, 1024): 8,
            (192, 2048, 1024): 4, (192, 1024, 2048): 8, (96, 2048, 1024): 4, (5, 24, 40): 1,
            (200, 1000, 1100): 5, (512, 3072, 1024): 2}
    for (m, n, k), splits in want.items():
        assert dense_splits(m, n, k) == splits, (m, n, k)
        k_tiles = -(-pad16(k) // DENSE_BK)
        per = -(-k_tiles // splits)
        assert 1 <= splits <= DENSE_MAX_SPLITS
        assert splits == 1 or splits * -(-n // 128) * -(-m // dense_rows_tile(m)) <= 96
        assert per * splits >= k_tiles > per * (splits - 1)
    assert [dense_rows_tile(m) for m in (1, 5, 96, 192, 200, 512)] == [16, 16, 96, 192, 256, 256]


# ---- (c) quantize_cvit ------------------------------------------------------

@pytest.mark.parametrize("kw,transformer", [(TINY, False), (TINY_TR, True)])
def test_quantize_cvit_matches_jax(kw, transformer):
    from fac_fake_tpu.compat.quantize import quantize_cvit as jax_quantize
    from fac_fake_torch.compat.quantize import quantize_cvit
    from fac_fake_torch.compat.weights import cvit_state_dict_from_flax

    fm, fv, x0, _ = _jax_folded(kw, "patch", 7)
    qm, qv = jax_quantize(fm, fv, jnp.asarray(x0), transformer=transformer)
    tm = _port(fm.stem_spec, kw, "patch", _flat(fv))
    tq = quantize_cvit(tm, _nchw(x0), transformer=transformer)
    assert tq.stem_spec == qm.stem_spec and tq.quant_dense == qm.quant_dense == transformer
    want = cvit_state_dict_from_flax(_flat(qv))
    got = tq.state_dict()
    assert sorted(got) == sorted(want)
    n_int8 = 0
    for k, w in want.items():
        if w.dtype == torch.int8:
            assert got[k].dtype == torch.int8 and torch.equal(got[k], w), k
            n_int8 += 1
        elif k.endswith(("x_scale", "w_scale")):
            np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=1e-6, atol=0, err_msg=k)
        else:
            np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=1e-6, atol=1e-7,
                                       err_msg=k)
    assert n_int8 == 4 + (4 * kw["depth"] + 2 if transformer else 0)


# ---- (d) logits of JAX-quantized variables carried across --------------------

@pytest.mark.parametrize("pos_mode", ["patch", "legacy"])
def test_logits_of_jax_quantized_variables_match_jax(pos_mode):
    from fac_fake_tpu.compat.quantize import quantize_cvit as jax_quantize

    fm, fv, x0, rng = _jax_folded(TINY_TR, pos_mode, 11)
    qm, qv = jax_quantize(fm, fv, jnp.asarray(x0), transformer=True)
    tq = _port(qm.stem_spec, TINY_TR, pos_mode, _flat(qv), quant_dense=True)
    assert tq.features[0].kernel_q.dtype == torch.int8
    xe = (rng.standard_normal((6, 32, 32, 3)) * 0.5).astype(np.float32)
    kw = {}
    if pos_mode == "legacy":
        kw["pos_indices"] = np.array([3, 0, 31, 7, 7, 12])
    ref = np.asarray(qm.apply(qv, jnp.asarray(xe), train=False,
                              **{k: jnp.asarray(v) for k, v in kw.items()}))
    with torch.no_grad():
        got = tq(_nchw(xe), **{k: torch.from_numpy(v) for k, v in kw.items()}).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3)   # PARITY.md logit bar


# ---- (e) VideoScorer -------------------------------------------------------

@pytest.mark.parametrize("quantize,pos_mode", [("int8", "patch"), ("int8_full", "legacy")])
def test_video_scorer_int8_calibrates_and_matches_jax(quantize, pos_mode):
    from fac_fake_tpu.core.config import Config as JaxConfig
    from fac_fake_tpu.infer.predictor import VideoScorer as JaxScorer
    from fac_fake_tpu.models.cvit import CViT as JaxCViT
    from fac_fake_torch.core.config import Config
    from fac_fake_torch.infer.predictor import VideoScorer

    jm = JaxCViT(stem_spec=_spec(), pos_mode=pos_mode, **TINY)
    v = jm.init(jax.random.key(0), jnp.zeros((1, 32, 32, 3)))
    tm = _port(_spec(), TINY, pos_mode, _flat(v))
    rng = np.random.default_rng(3)
    crops = rng.integers(0, 255, (12, 32, 32, 3), dtype=np.uint8)
    other = rng.integers(0, 255, (20, 32, 32, 3), dtype=np.uint8)

    def cfg(c):
        c.data.image_size = 32
        c.infer.batch_crops = 32
        c.infer.quantize = quantize
        return c

    js = JaxScorer(jm, v, cfg(JaxConfig()))
    ts = VideoScorer(tm, cfg(Config()), device="cpu")
    assert ts._quant_pending
    assert ts.score_crops(crops[:4]) == ts.score_crops(crops[:4])   # < 8 crops: no calibration
    assert ts._quant_pending
    got = ts.score_crops(crops)                                     # calibrates on this batch
    assert not ts._quant_pending
    assert sum(op[0] == "qconv" for op in ts.model.stem_spec) == 4
    assert ts.model.quant_dense == (quantize == "int8_full")
    assert abs(got - js.score_crops(crops)) <= 1e-3
    assert ts.score_crops(crops) == got                             # quantized once
    assert ts.quantize_int8(crops) == 0
    stacks = ts.score_crop_stacks([crops, other])
    np.testing.assert_allclose(stacks, [got, ts.score_crops(other)], rtol=0, atol=1e-6)


def test_video_scorer_int8_calibrates_on_the_first_stack():
    from fac_fake_torch.core.config import Config
    from fac_fake_torch.infer.predictor import VideoScorer
    from fac_fake_torch.models import init_weights
    from fac_fake_torch.models.cvit import CViT

    tm = init_weights(CViT(_spec(), image_size=32, pos_mode="patch", **TINY), 1).eval()
    c = Config()
    c.infer.quantize = "int8_full"
    ts = VideoScorer(tm, c, device="cpu")
    rng = np.random.default_rng(4)
    stacks = [rng.integers(0, 255, (n, 32, 32, 3), dtype=np.uint8) for n in (9, 2)]
    probs = ts.score_crop_stacks(stacks)
    assert not ts._quant_pending and ts.model.quant_dense
    assert probs[1] == 0.5 and 0.0 <= probs[0] <= 1.0


# ---- (f) an unfolded stem ------------------------------------------------------

def test_quantize_requires_folded_stem():
    from fac_fake_torch.compat.quantize import quantize_cvit
    from fac_fake_torch.models import init_weights
    from fac_fake_torch.models.cvit import CViT

    tm = init_weights(CViT(_spec(), image_size=32, pos_mode="patch", **TINY), 0).eval()
    with pytest.raises(ValueError, match="folded"):
        quantize_cvit(tm, torch.zeros((2, 3, 32, 32)))

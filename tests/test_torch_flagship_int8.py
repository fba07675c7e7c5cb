"""int8 serving of the flagship ``cvit_repbn8`` against the JAX package on
the CPU, at narrow flagship-shaped widths (`test_torch_flagship.py`'s
``small`` stems): `quantize_cvit`'s qparams for both stems and the denses,
logits from JAX-quantized variables carried across, `VideoScorer` with
``infer.quantize`` set, and what one quantized forward runs. The JAX side's
weights are its own init with its DEConvs at He scale, as in
`test_torch_flagship.py`; inputs are made with numpy from seeds."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_flagship import HW, SMALL, flagship_variables, flat, jax_small, nchw, port_small

torch.set_num_threads(2)


def _jax_folded(pos_mode, seed):
    from fac_fake_tpu.compat.fold import fold_cvit
    jm = jax_small(pos_mode)
    v = flagship_variables(jm, HW, seed)
    rng = np.random.default_rng(seed)
    x0 = (rng.standard_normal((6, HW, HW, 3)) * 0.5).astype(np.float32)
    fm, fv = fold_cvit(jm, v)
    return jm, v, fm, fv, x0, rng


def _port_of(fm, variables, pos_mode, quant_dense=False):
    from fac_fake_torch.compat.weights import cvit_state_dict_from_flax
    from fac_fake_torch.models.cvit import CViT
    m = CViT(fm.stem_spec, image_size=HW, stem2_spec=fm.stem2_spec, use_ggca=True,
             ffn_norm="linearnorm", pos_mode=pos_mode, quant_dense=quant_dense, **SMALL)
    m.load_state_dict(cvit_state_dict_from_flax(flat(variables), variant="cvit_repbn8"),
                      strict=True)
    return m.eval()


@pytest.mark.parametrize("transformer", [False, True], ids=["int8", "int8_full"])
def test_quantize_cvit_matches_jax_on_both_stems(transformer):
    """From the same folded weights: ``kernel_q`` bit-equal, ``x_scale`` and
    ``w_scale`` within 1e-6 relative, for the 18 convs of both stems (the
    second calibrated from the first's fp output) and, under int8_full, the
    6 denses."""
    from fac_fake_tpu.compat.quantize import quantize_cvit as jax_quantize
    from fac_fake_torch.compat.quantize import quantize_cvit
    from fac_fake_torch.compat.weights import cvit_state_dict_from_flax

    _, _, fm, fv, x0, _ = _jax_folded("patch", 7)
    qm, qv = jax_quantize(fm, fv, jnp.asarray(x0), transformer=transformer)
    tq = quantize_cvit(_port_of(fm, fv, "patch"), nchw(x0), transformer=transformer)
    assert (tq.config["stem_spec"], tq.config["stem2_spec"]) == (qm.stem_spec, qm.stem2_spec)
    assert tq.quant_dense == qm.quant_dense == transformer
    want = cvit_state_dict_from_flax(flat(qv), variant="cvit_repbn8")
    got = tq.state_dict()
    assert sorted(k for k in got if not k.endswith("num_batches_tracked")) == sorted(want)
    n_int8 = {"features1": 0, "features2": 0, "dense": 0}
    for k, w in want.items():
        if w.dtype == torch.int8:
            assert got[k].dtype == torch.int8 and torch.equal(got[k], w), k
            n_int8[k.split(".")[0] if k.startswith("features") else "dense"] += 1
        elif k.endswith(("x_scale", "w_scale")):
            np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=1e-6, atol=0, err_msg=k)
        else:
            np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=1e-6, atol=1e-7,
                                       err_msg=k)
    assert n_int8 == {"features1": 14, "features2": 4, "dense": 6 if transformer else 0}


@pytest.mark.parametrize("transformer,pos_mode", [(False, "patch"), (True, "legacy")],
                         ids=["int8", "int8_full"])
def test_logits_of_jax_quantized_flagship_match_jax(transformer, pos_mode):
    """JAX's quantized variables carried across: logits within 1e-3, the
    JAX package's logit bar (PARITY.md)."""
    from fac_fake_tpu.compat.quantize import quantize_cvit as jax_quantize

    _, _, fm, fv, x0, rng = _jax_folded(pos_mode, 11)
    qm, qv = jax_quantize(fm, fv, jnp.asarray(x0), transformer=transformer)
    tq = _port_of(qm, qv, pos_mode, quant_dense=transformer)
    assert tq.features2[0].kernel_q.dtype == torch.int8
    xe = (rng.standard_normal((6, HW, HW, 3)) * 0.5).astype(np.float32)
    kw = {"pos_indices": np.array([3, 0, 31, 7, 7, 12])} if pos_mode == "legacy" else {}
    ref = np.asarray(qm.apply(qv, jnp.asarray(xe), train=False,
                              **{k: jnp.asarray(v) for k, v in kw.items()}))
    with torch.no_grad():
        got = tq(nchw(xe), **{k: torch.from_numpy(v) for k, v in kw.items()}).numpy()
    assert np.isfinite(ref).all()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3)


@pytest.mark.parametrize("quantize,pos_mode", [("int8", "patch"), ("int8_full", "legacy")])
def test_video_scorer_flagship_int8_calibrates_and_matches_jax(quantize, pos_mode):
    """A CPU `VideoScorer` with the flagship folds it, calibrates on its
    first batch of ≥ 8 crops, quantizes the 18 convs of both stems and
    scores within 1e-3 of JAX's `VideoScorer` on the same weights."""
    from fac_fake_tpu.core.config import Config as JaxConfig
    from fac_fake_tpu.infer.predictor import VideoScorer as JaxScorer
    from fac_fake_torch.compat.weights import cvit_state_dict_from_flax
    from fac_fake_torch.core.config import Config
    from fac_fake_torch.infer.predictor import VideoScorer

    jm = jax_small(pos_mode)
    v = flagship_variables(jm, HW, 0)
    tm = port_small(cvit_state_dict_from_flax(flat(v), variant="cvit_repbn8"), pos_mode)
    rng = np.random.default_rng(3)
    crops = rng.integers(0, 255, (12, HW, HW, 3), dtype=np.uint8)

    def cfg(c):
        c.data.image_size = HW
        c.infer.batch_crops = 32
        c.infer.quantize = quantize
        return c

    js = JaxScorer(jm, v, cfg(JaxConfig()))
    ts = VideoScorer(tm, cfg(Config()), device="cpu")
    got = ts.score_crops(crops)                                     # calibrates on this batch
    assert not ts._quant_pending
    assert sum(op[0] == "qconv" for op in ts.model.stem_ops()) == 18
    assert ts.model.quant_dense == (quantize == "int8_full")
    assert abs(got - js.score_crops(crops)) <= 1e-3
    assert ts.quantize_int8(crops) == 0


def test_quantized_flagship_forward_runs_the_planned_walk():
    """One `forward_crops` of the quantized flagship from uint8 crops runs,
    over its two stems: 1 K2 int8 entry, no K2 fp launch, 18 K3 launches
    (16 quantizing for the next conv, 1 of them with no ReLU between: the
    56² conv → deconv), 1 quantize pass (the second stem's fp input), 3
    int8 pools, 2 fp pools and no fp ReLU; on the CPU, the plain versions
    that each launch stands for. `CViT.walk_counts` plans the same."""
    from torch import nn
    from fac_fake_torch.compat.fold import fold_cvit
    from fac_fake_torch.compat.quantize import quantize_cvit
    from fac_fake_torch.models import init_weights
    from fac_fake_torch.ops import preprocess as pp
    from fac_fake_torch.ops import quant as q
    from fac_fake_torch.ops import quant3d as q3

    model = fold_cvit(init_weights(port_small(), 8))
    u8 = torch.from_numpy(np.random.default_rng(8).integers(0, 256, (4, HW, HW, 3),
                                                            dtype=np.uint8))
    qm = quantize_cvit(model, pp.normalize_imagenet(u8), transformer=True)
    want = {"convs": 18, "fused": 16, "no_relu_fused": 1, "quantize": 1, "k2_int8": 1,
            "k2_fp": 0, "int8_pools": 3, "fp_pools": 2, "fp_relus": 0}
    assert qm.walk_counts() == want
    ran = dict.fromkeys(want, 0)
    orig = (q.int8_conv3x3, q3.quantize_pad, pp.quantize_crops, pp.normalize_imagenet,
            q.max_pool2x2_i8)

    def conv(xq, kernel_q, s, bias, relu, dtype, q_scale=None, w_k=None):
        ran["convs"] += 1
        ran["fused"] += q_scale is not None
        ran["no_relu_fused"] += q_scale is not None and not relu
        return orig[0](xq, kernel_q, s, bias, relu, dtype, q_scale, w_k)

    def count(kind, fn):
        def run(*args, **kw):
            ran[kind] += 1
            return fn(*args, **kw)
        return run

    hooks = [mod.register_forward_hook(lambda *_, kind=kind: ran.__setitem__(kind, ran[kind] + 1))
             for _, _, stem in qm.stems() for mod in stem
             for kind in [{nn.ReLU: "fp_relus", nn.MaxPool2d: "fp_pools"}.get(type(mod))] if kind]
    q.int8_conv3x3, q3.quantize_pad = conv, count("quantize", orig[1])
    pp.quantize_crops, pp.normalize_imagenet = count("k2_int8", orig[2]), count("k2_fp", orig[3])
    q.max_pool2x2_i8 = count("int8_pools", orig[4])
    try:
        with torch.no_grad():
            logits = qm.forward_crops(u8, torch.float32, torch.arange(4))
    finally:
        q.int8_conv3x3, q3.quantize_pad, pp.quantize_crops, pp.normalize_imagenet, \
            q.max_pool2x2_i8 = orig
        for h in hooks:
            h.remove()
    assert ran == want and torch.isfinite(logits).all()

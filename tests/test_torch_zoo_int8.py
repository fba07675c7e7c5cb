"""int8_full serving of the zoo entries whose walks are new, against the JAX
package on the CPU: ``cvit_ggca_sla`` (two all-int8 stems, 256- and
512-channel convs with no pool between them, stem 2 from a quantize pass),
``cvit_ggca_add_glu`` (one all-int8 stem of 17 convs, two pools) and
``cvit_ggca_add_wtconv`` (one conv from K2's int8 entry, dequantized to fp
for WTConv and the fp rest of the stem). The stems are the published ones;
sla and glu take 32² crops and patch 1 (the same 16 and 64 patches that 224²
crops and patch 7 give them, at dim 1024), wtconv 64² and patch 2.

The JAX side's weights are `zoo_variables`, folded by JAX's `fold_cvit` and
quantized by its `quantize_cvit`; a folded wtconv stem keeps a BN after
each WTConv, which JAX's `quantize_cvit` refuses (it refuses any stem that
holds a BN), so its int8_full variables are made from JAX's own parts,
`quantize_stem` and `_quantize_dense` on the inputs its capture forward
sows, as `quantize_cvit` calls them (`jax_int8_full`).
"""
import copy
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from test_torch_flagship import flat
from test_torch_zoo_entries import ENTRIES, nchw, variant, zoo_variables

torch.set_num_threads(2)

LOGIT_TOL = 1e-3
# a code may differ from JAX's only where JAX's x / s_x lies this close to a
# .5 tie, relative to the point's largest |x / s_x| (the fp blocks before a
# point, GGCA, SLA, GLU, WTConv and the fp convs, sum in other orders: 1e-6
# of their values), and the port's x / s_x, where it is formed apart, within
# the same of JAX's
TIE_REL = 1e-5
Z3 = ("cvit_ggca_sla", "cvit_ggca_add_glu", "cvit_ggca_add_wtconv")
DIMS = {"cvit_ggca_sla": (32, 1, 1024), "cvit_ggca_add_glu": (32, 1, 1024),
        "cvit_ggca_add_wtconv": (64, 2, 64)}
# one forward from uint8 crops: `CViT.walk_counts`, and what the wrappers count
WALKS = {
    "cvit_ggca_sla": dict(convs=17, fused=15, no_relu_fused=0, quantize=1, k2_int8=1, k2_fp=0,
                          int8_pools=3, fp_pools=0, fp_relus=0),
    "cvit_ggca_add_glu": dict(convs=17, fused=16, no_relu_fused=0, quantize=0, k2_int8=1,
                              k2_fp=0, int8_pools=2, fp_pools=0, fp_relus=0),
    "cvit_ggca_add_wtconv": dict(convs=1, fused=0, no_relu_fused=0, quantize=0, k2_int8=1,
                                 k2_fp=0, int8_pools=0, fp_pools=5, fp_relus=16),
}
_STEMS = (("stem", "stem_spec"), ("stem2", "stem2_spec"), ("stem3", "stem3_spec"))


def dims(name):
    hw, p, dim = DIMS[name]
    return hw, dict(patch_size=p, dim=dim, depth=1, heads=2, mlp_dim=64)


def jax_int8_full(fm, fv, x0):
    """JAX's int8_full model and variables of the folded ``fm``: its
    `quantize_cvit`, or for a stem that holds a BN its parts by hand."""
    from fac_fake_tpu.compat import quantize as jq
    x0 = jnp.asarray(x0)
    stems = [(n, f) for n, f in _STEMS if getattr(fm, f) is not None]
    if not any(op[0] == "bn" for _, f in stems for op in getattr(fm, f)):
        return jq.quantize_cvit(fm, fv, x0, transformer=True)
    assert len(stems) == 1
    _, inter = fm.apply(fv, x0, mutable=["intermediates"],
                        pos_indices=jnp.arange(x0.shape[0]) % 32)
    sows = inter["intermediates"]
    spec, stem_params, _ = jq.quantize_stem(fm.stem_spec, fv["params"]["stem"], x0)
    params = dict(fv["params"], stem=stem_params)
    params["patch_to_embedding"] = jq._quantize_dense(params["patch_to_embedding"],
                                                      sows["pe_input"][0])
    tr = {k: dict(v) for k, v in params["transformer"].items()}
    for lname, lp in tr.items():
        pairs = ((("to_qkv", "qkv_in"), ("to_out", "out_in")) if "to_qkv" in lp else
                 (("fc1", "fc1_in"), ("fc2", "fc2_in")) if "fc1" in lp else ())
        for layer, sow in pairs:
            lp[layer] = jq._quantize_dense(lp[layer], sows["transformer"][lname][sow][0])
    params["transformer"] = tr
    params["mlp_head"] = dict(params["mlp_head"], fc1=jq._quantize_dense(
        params["mlp_head"]["fc1"], sows["mlp_head"]["fc1_in"][0]))
    return dataclasses.replace(fm, stem_spec=spec, quant_dense=True), dict(fv, params=params)


@functools.lru_cache(maxsize=None)
def setup(name):
    """((JAX folded model, variables), JAX int8_full model and variables,
    the port's quantized model from the same folded weights, crop side);
    the calibration batch is seeded by the entry."""
    from fac_fake_tpu.compat.fold import fold_cvit as jax_fold
    from fac_fake_tpu.core.config import ModelConfig as JaxModelConfig
    from fac_fake_tpu.models import build_model as jax_build
    from fac_fake_torch.compat.fold import fold_cvit
    from fac_fake_torch.compat.quantize import quantize_cvit
    from fac_fake_torch.compat.weights import cvit_state_dict_from_flax
    from fac_fake_torch.core.config import ModelConfig
    from fac_fake_torch.models import build_model
    hw, d = dims(name)
    jm = jax_build(JaxModelConfig(name=name, **d))
    v = zoo_variables(jm, hw, ENTRIES.index(name))
    rng = np.random.default_rng(ENTRIES.index(name))
    x0 = (rng.standard_normal((6, hw, hw, 3)) * 0.5).astype(np.float32)
    fm, fv = jax_fold(jm, v)
    qm, qv = jax_int8_full(fm, fv, x0)
    tm = build_model(ModelConfig(name=name, image_size=hw, **d), device="cpu")
    tm.load_state_dict(cvit_state_dict_from_flax(flat(v), variant(name)), strict=True)
    tq = quantize_cvit(fold_cvit(tm), nchw(x0), transformer=True)
    return (fm, fv), qm, qv, tq, hw


@pytest.mark.parametrize("name", Z3)
def test_int8_full_qparams_and_plan_match_jax(name):
    """From the same folded weights: the quantized specs and JAX's
    `_plan_stem` the same, ``kernel_q`` equal but where JAX's folded w / s_w
    lies within TIE_REL of a .5 tie (the folds round ``k · γ/√(σ²+ε)``, and
    XLA's jitted quantize its ``w / s_w``, apart from the port's in the last
    bit: one code of sla's 2.4 M in a 512 → 512 conv),
    ``x_scale`` and ``w_scale`` within 1e-6 relative, the other leaves
    within 1e-6; the planned walk of one forward from the crops (`CViT.walk_counts`) as
    WALKS, its K3 launches JAX's quantized convs."""
    from fac_fake_tpu.compat.quantize import _plan_stem as jax_plan
    from fac_fake_torch.compat.quantize import _plan_stem
    from fac_fake_torch.compat.weights import cvit_state_dict_from_flax
    (fm, fv), qm, qv, tq, _ = setup(name)
    folded = cvit_state_dict_from_flax(flat(fv), variant(name))
    q_convs = 0
    for (_, f), (field, _, _) in zip(_STEMS, tq.stems()):
        assert f == field
        assert _plan_stem(getattr(fm, f)) == jax_plan(getattr(fm, f))
        assert tq.config[f] == getattr(qm, f)
        q_convs += len(jax_plan(getattr(fm, f))[1])
    assert tq.walk_counts() == WALKS[name] and WALKS[name]["convs"] == q_convs
    want = cvit_state_dict_from_flax(flat(qv), variant(name))
    got = tq.state_dict()
    assert sorted(k for k in got if not k.endswith("num_batches_tracked")) == sorted(want)
    for k, w in want.items():
        if w.dtype == torch.int8:
            assert got[k].dtype == torch.int8, k
            flip = (got[k] != w).numpy()
            if flip.any():
                base = k[:-len("kernel_q")]
                s_w = want[base + "w_scale"].reshape((-1,) + (1,) * (w.dim() - 1))
                jv = (folded[base + "weight"] / s_w).numpy()
                tie = np.abs(np.abs(jv - np.floor(jv)) - 0.5) <= TIE_REL * np.abs(jv).max()
                assert not (flip & ~tie).any() and (got[k] - w).abs().max() <= 1, k
        elif k.endswith(("x_scale", "w_scale")):
            np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=1e-6, atol=0, err_msg=k)
        else:
            np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=1e-6, atol=1e-7,
                                       err_msg=k)


def jax_points(qm, qv, x):
    """JAX's int8_full forward, eager, recording each `QuantConv3x3` and
    `QuantDense` call's x / s_x and codes as the layer forms them; and its
    logits."""
    from fac_fake_tpu.models.layers import QuantConv3x3, QuantDense
    points = {"conv": [], "dense": []}

    def record(next_fun, args, kwargs, context):
        mod = context.module
        if context.method_name == "__call__" and isinstance(mod, (QuantConv3x3, QuantDense)):
            s = mod.get_variable("params", "x_scale")
            val = args[0].astype(jnp.float32) / s
            codes = jnp.clip(jnp.round(val), -127, 127).astype(jnp.int8)
            kind = "conv" if isinstance(mod, QuantConv3x3) else "dense"
            points[kind].append((np.asarray(val), np.asarray(codes)))
        return next_fun(*args, **kwargs)

    with nn.intercept_methods(record):
        logits = np.asarray(qm.apply(qv, jnp.asarray(x)))
    return logits, points


def lockstep_logits(model, x, points):
    """The port's int8_full forward on ``x`` in lock-step with JAX's
    ``points``: each K3 conv's int8 input (its codes at the real channels)
    and each K4 dense's codes equal JAX's but where JAX's x / s_x lies
    within TIE_REL of a .5 tie, and JAX's codes go on; a dense's x / s_x
    within TIE_REL of JAX's. Returns the logits and the flipped codes."""
    from fac_fake_torch.ops import quant as q
    from fac_fake_torch.ops.quant3d import quantize_plain
    conv_pts, dense_pts = iter(points["conv"]), iter(points["dense"])
    flips = []

    def agree(got, jv, jc, what):
        unit = TIE_REL * float(np.abs(jv).max())
        flip = got != jc
        tie = np.abs(np.abs(jv - np.floor(jv)) - 0.5) <= unit
        assert not (flip & ~tie).any(), (what, np.argwhere(flip & ~tie)[:4])
        flips.extend(jv[flip].tolist())

    real_conv, real_dense = q.int8_conv3x3, q.quant_dense

    def conv(xq, kernel_q, s, bias, relu, dtype, q_scale=None, w_k=None):
        jv, jc = next(conv_pts)
        cin = kernel_q.shape[1]
        agree(xq[..., :cin].numpy(), jv, jc, f"conv {tuple(xq.shape)}")
        carried = torch.zeros_like(xq)
        carried[..., :cin] = torch.from_numpy(jc.copy())
        return real_conv(carried, kernel_q, s, bias, relu, dtype, q_scale, w_k)

    def dense(x_, kernel_q, w_scale, x_scale, bias=None):
        jv, jc = next(dense_pts)
        x2 = x_.reshape(-1, x_.shape[-1])
        val = (x2.float() / x_scale).numpy()
        assert np.abs(val - jv.reshape(val.shape)).max() <= TIE_REL * np.abs(jv).max()
        agree(quantize_plain(x2, x_scale).numpy(), jv.reshape(val.shape),
              jc.reshape(val.shape), f"dense {tuple(x2.shape)}")
        acc = q.int_matmul_plain(torch.from_numpy(jc.reshape(val.shape).copy()), kernel_q)
        y = q.dequant_plain(acc, x_scale, w_scale, bias, x_.dtype)
        return y.reshape(*x_.shape[:-1], kernel_q.shape[0])

    conv.launches = dense.launches = 0
    with pytest.MonkeyPatch.context() as mp, torch.no_grad():
        mp.setattr(q, "int8_conv3x3", conv)
        mp.setattr(q, "quant_dense", dense)
        logits = model(nchw(x)).numpy()
    assert next(conv_pts, None) is None and next(dense_pts, None) is None
    return logits, flips


@pytest.mark.parametrize("name", Z3)
def test_int8_full_logits_in_lockstep_with_jax(name):
    """JAX's quantized variables carried across: the port's walk through the
    plain K2/K3/K4 steps with JAX's quantize points in lock-step (a flipped
    code only at a .5 tie, JAX's codes carried on), logits within 1e-3; and
    without the lock-step (the port's own codes all the way) within 1e-3
    where no code flipped."""
    from fac_fake_torch.compat.weights import cvit_state_dict_from_flax
    _, qm, qv, tq, hw = setup(name)
    rng = np.random.default_rng(ENTRIES.index(name) + 50)
    carried = copy.deepcopy(tq)
    carried.load_state_dict(cvit_state_dict_from_flax(flat(qv), variant(name)), strict=True)
    x = (rng.standard_normal((2, hw, hw, 3)) * 0.5).astype(np.float32)
    ref, points = jax_points(qm, qv, x)
    n_conv = sum(op[0] == "qconv" for op in carried.stem_ops())
    assert len(points["conv"]) == n_conv and len(points["dense"]) == 6
    got, flips = lockstep_logits(carried, x, points)
    assert np.isfinite(ref).all()
    np.testing.assert_allclose(got, ref, rtol=0, atol=LOGIT_TOL)
    if not flips:
        with torch.no_grad():
            np.testing.assert_allclose(carried(nchw(x)).numpy(), ref, rtol=0, atol=LOGIT_TOL)


@pytest.mark.parametrize("name", Z3)
def test_int8_full_forward_runs_the_planned_walk(name):
    """One `forward_crops` of the quantized model from uint8 crops runs, on
    the CPU, the plain versions of what `CViT.walk_counts` plans (WALKS):
    K3 convs, their fused edges, quantize passes, K2's int8 entry and fp
    launch, int8 and fp pools and fp ReLUs; and 6 K4 denses."""
    from torch import nn as tnn
    from fac_fake_torch.ops import preprocess as pp
    from fac_fake_torch.ops import quant as q
    from fac_fake_torch.ops import quant3d as q3
    _, _, _, tq, hw = setup(name)
    rng = np.random.default_rng(ENTRIES.index(name) + 60)
    u8 = torch.from_numpy(rng.integers(0, 256, (3, hw, hw, 3), dtype=np.uint8))
    want = WALKS[name]
    ran = dict.fromkeys(list(want) + ["dense"], 0)
    orig = (q.int8_conv3x3, q3.quantize_pad, pp.quantize_crops, pp.normalize_imagenet,
            q.max_pool2x2_i8, q.quant_dense)

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
             for _, _, stem in tq.stems() for mod in stem
             for kind in [{tnn.ReLU: "fp_relus", tnn.MaxPool2d: "fp_pools"}.get(type(mod))]
             if kind]
    with pytest.MonkeyPatch.context() as mp, torch.no_grad():
        mp.setattr(q, "int8_conv3x3", conv)
        mp.setattr(q3, "quantize_pad", count("quantize", orig[1]))
        mp.setattr(pp, "quantize_crops", count("k2_int8", orig[2]))
        mp.setattr(pp, "normalize_imagenet", count("k2_fp", orig[3]))
        mp.setattr(q, "max_pool2x2_i8", count("int8_pools", orig[4]))
        mp.setattr(q, "quant_dense", count("dense", orig[5]))
        logits = tq.forward_crops(u8, torch.float32, torch.arange(3))
    for h in hooks:
        h.remove()
    assert ran == dict(want, dense=6) and torch.isfinite(logits).all()

"""The variant zoo's blocks and stem ops against the JAX package's modules
on the CPU: each of the ten block files of `fac_fake_torch/models/blocks/`
the zoo added, at narrow widths and small maps. The JAX module's seeded
variables (every parameter moved off its initial value, BatchNorm stats
drawn) reach the port through its own key map (`compat/weights.py
cvit_torch_key`, the paths a CViT gives them) and load with
``strict=True``; the same seeded numpy input goes through both, held to
1e-5 × max|JAX| + 1e-6 in fp32."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

torch.set_num_threads(2)

TOL_REL, TOL_ABS = 1e-5, 1e-6


def perturbed(variables, seed):
    """JAX variables with every parameter moved by N(0, 0.1) (so zero and
    constant initial values, such as SLA's positional encoding or UFFC's
    lambda, take part) and BatchNorm stats drawn (mean N(0, 0.1), var
    U(0.5, 2))."""
    rng = np.random.default_rng(seed)
    flat = traverse_util.flatten_dict(variables)
    for k, v in flat.items():
        shape = np.shape(v)
        if k[0] == "batch_stats":
            new = rng.normal(0, 0.1, shape) if k[-1] == "mean" else rng.uniform(0.5, 2.0, shape)
        else:
            new = np.asarray(v) + rng.normal(0, 0.1, shape)
        flat[k] = jnp.asarray(new, jnp.float32)
    return traverse_util.unflatten_dict(flat)


def port_state(variables, prefix):
    """The port's state dict of a module whose flax variables sit under
    ``prefix`` in a CViT (``("stem", "l0")`` for a stem op, ``("mdfa",)``
    for a slot block), through the port's key map, with the module's own
    torch prefix (``features.0.``, ``mdfa.``) taken off."""
    from fac_fake_torch.compat.weights import cvit_torch_key
    out = {}
    for k, v in traverse_util.flatten_dict(variables).items():
        key, tf = cvit_torch_key([k[0], *prefix, *k[1:]], "single")
        head = "features.0." if prefix[0] == "stem" else f"{prefix[0].replace('_tok', '')}."
        assert key.startswith(head), key
        out[key[len(head):]] = torch.from_numpy(np.array(tf(np.asarray(v, np.float32)),
                                                         order="C"))
    return out


def held(got, ref):
    got = np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    assert np.isfinite(ref).all()
    err = float(np.abs(got - ref).max())
    bound = TOL_REL * float(np.abs(ref).max()) + TOL_ABS
    assert err <= bound, (err, bound)
    return err


def nhwc(rng, shape):
    return (rng.standard_normal(shape) * 1.5).astype(np.float32)


def to_nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def to_nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


# (id, JAX module factory, port module factory, input shape NHWC, flax prefix)
def _cases():
    from fac_fake_tpu.models.blocks import (attention2d, inception_dw, moga, odconv, scconv,
                                            smfa, uffc, wtconv)
    from fac_fake_torch.models.blocks import attention2d as tattention2d
    from fac_fake_torch.models.blocks import inception_dw as tinception_dw
    from fac_fake_torch.models.blocks import moga as tmoga
    from fac_fake_torch.models.blocks import odconv as todconv
    from fac_fake_torch.models.blocks import scconv as tscconv
    from fac_fake_torch.models.blocks import smfa as tsmfa
    from fac_fake_torch.models.blocks import uffc as tuffc
    from fac_fake_torch.models.blocks import wtconv as twtconv
    return {
        "scconv": (lambda: scconv.ScConv(32), lambda: tscconv.ScConv(32), (2, 8, 8, 32),
                   ("stem", "l0")),
        "wtconv_even": (lambda: wtconv.WTConv2d(16), lambda: twtconv.WTConv2d(16),
                        (2, 10, 10, 16), ("stem", "l0")),
        "wtconv_odd": (lambda: wtconv.WTConv2d(16), lambda: twtconv.WTConv2d(16),
                       (2, 9, 7, 16), ("stem", "l0")),
        "inception_dw": (lambda: inception_dw.InceptionDWConv2d(32),
                         lambda: tinception_dw.InceptionDWConv2d(32), (2, 12, 12, 32),
                         ("stem", "l0")),
        "odconv_stem_op": (lambda: odconv.ODConv2d(16, 16, 3), lambda: todconv.ODConv2d(16, 16, 3),
                           (3, 8, 8, 16), ("stem", "l0")),
        "odconv_block": (lambda: odconv.ODConv2d(24, 24, 3), lambda: todconv.ODConv2d(24, 24, 3),
                         (2, 6, 6, 24), ("odconv",)),
        "mdfa": (lambda: attention2d.MDFA(16), lambda: tattention2d.MDFA(16, 16), (2, 20, 20, 16),
                 ("mdfa",)),
        "mdfa_tokens": (lambda: attention2d.MDFA(2), lambda: tattention2d.MDFA(2, 2),
                        (2, 32, 32, 2), ("mdfa_tok",)),
        "bfm": (lambda: attention2d.BFM(16), lambda: tattention2d.BFM(16), (2, 10, 10, 16),
                ("bfm",)),
        "bfm_tokens": (lambda: attention2d.BFM(2), lambda: tattention2d.BFM(2), (2, 32, 32, 2),
                       ("bfm_tok",)),
        "moga": (lambda: moga.MultiOrderGatedAggregation(16),
                 lambda: tmoga.MultiOrderGatedAggregation(16), (2, 12, 12, 16), ("moga",)),
        "smfa_16": (lambda: smfa.SMFA(16), lambda: tsmfa.SMFA(16), (2, 16, 16, 16), ("smfa",)),
        "smfa_14": (lambda: smfa.SMFA(8), lambda: tsmfa.SMFA(8), (2, 14, 14, 8), ("smfa",)),
        "uffc": (lambda: uffc.FourierUnitModified(8, image_size=14),
                 lambda: tuffc.FourierUnitModified(8, 14), (2, 14, 14, 8), ("uffc",)),
    }


MAP_CASES = ["scconv", "wtconv_even", "wtconv_odd", "inception_dw", "odconv_stem_op",
             "odconv_block", "mdfa", "mdfa_tokens", "bfm", "bfm_tokens", "moga", "smfa_16",
             "smfa_14", "uffc"]


@pytest.mark.parametrize("case", MAP_CASES)
def test_map_block_matches_jax(case):
    """A block or stem op on an NHWC map (NCHW in the port): scconv,
    wtconv (an even and an odd map: the transform's pad and crop),
    inception_dw, odconv (a stem op, batch 3: the per-sample kernels, and a
    slot block), MDFA and BFM (also on the token block's 2-channel 32² map),
    MOGA, SMFA (pooled to 2² and to 1²) and UFFC."""
    make_jax, make_port, shape, prefix = _cases()[case]
    seed = MAP_CASES.index(case)
    rng = np.random.default_rng(seed)
    x = nhwc(rng, shape)
    jm = make_jax()
    args = (jnp.asarray(x),) * (2 if case.startswith("bfm") else 1)
    v = perturbed(jm.init(jax.random.key(seed), *args), seed)
    ref = np.asarray(jm.apply(v, *args))
    tm = make_port()
    tm.load_state_dict(port_state(v, prefix), strict=True)
    tm.eval()
    xt = to_nchw(x)
    with torch.no_grad():
        got = tm(xt, xt) if case.startswith("bfm") else tm(xt)
    held(to_nhwc(got), ref)


@pytest.mark.parametrize("case", ["sla", "glu"])
def test_token_block_matches_jax(case):
    """The embedding-space blocks on (B, N, C) tokens: SLA over 64 tokens of
    16 features (a 8 × 8 map for its depthwise conv on V; both contraction
    orders' selector takes Kᵀ V here), ConvolutionalGLU on 16 tokens as a
    4 × 4 map."""
    from fac_fake_tpu.models.blocks import glu, sla
    from fac_fake_torch.models.blocks import glu as tglu
    from fac_fake_torch.models.blocks import sla as tsla
    rng = np.random.default_rng(20 + (case == "glu"))
    if case == "sla":
        x = rng.standard_normal((2, 64, 16)).astype(np.float32)
        jm, tm, extra = sla.SimplifiedLinearAttention(16), tsla.SimplifiedLinearAttention(16), ()
    else:
        x = rng.standard_normal((2, 16, 48)).astype(np.float32)
        jm, tm, extra = glu.ConvolutionalGLU(48), tglu.ConvolutionalGLU(48), (4, 4)
    v = perturbed(jm.init(jax.random.key(3), jnp.asarray(x), *extra), 3)
    ref = np.asarray(jm.apply(v, jnp.asarray(x), *extra))
    tm.load_state_dict(port_state(v, (case,)), strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), *extra).numpy()
    held(got, ref)


def test_wavelet_transform_pair_matches_jax():
    """The Haar analysis and synthesis alone: the bands in the port's
    (B, C, 4, h, w) order equal JAX's (B, h, w, C, 4), and the inverse of
    the bands gives the map back (db1 is orthonormal)."""
    from fac_fake_tpu.models.blocks import wtconv
    from fac_fake_torch.models.blocks import wtconv as twtconv
    x = nhwc(np.random.default_rng(5), (2, 8, 6, 3))
    ref = np.asarray(wtconv.wavelet_transform(jnp.asarray(x)))          # (B, h, w, C, 4)
    got = twtconv.wavelet_transform(to_nchw(x))                          # (B, C, 4, h, w)
    held(got.permute(0, 3, 4, 1, 2).numpy(), ref)
    back = np.asarray(wtconv.inverse_wavelet_transform(jnp.asarray(ref)))
    held(to_nhwc(twtconv.inverse_wavelet_transform(got)), back)
    np.testing.assert_allclose(back, x, rtol=0, atol=1e-5)


def test_flat_export_layouts_load():
    """The layouts the JAX package's `export_cvit` writes where its inverse
    transforms have no case (a flat per-channel scale, ODConv's flax
    (kn, k, k, I, O) candidates) load into the port's reference-shaped
    parameters, reshaped and transposed."""
    from fac_fake_torch.models.blocks.moga import ElementScale
    from fac_fake_torch.models.blocks.odconv import ODConv2d
    s = ElementScale(6)
    s.load_state_dict({"scale": torch.arange(6.0)}, strict=True)
    assert s.scale.shape == (1, 6, 1, 1) and s.scale.flatten().tolist() == list(range(6))
    od = ODConv2d(16, 24, 3)
    want = torch.randn(4, 24, 16, 3, 3)
    sd = {k: v for k, v in od.state_dict().items()}
    sd["weight"] = want.permute(0, 3, 4, 2, 1).contiguous()       # (kn, k, k, I, O)
    od.load_state_dict(sd, strict=True)
    assert torch.equal(od.weight.data, want)

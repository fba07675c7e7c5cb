"""The port's S3D int8 engine against the JAX package on the CPU: the plain
versions of K5 (quantize, exact int32 3D conv, epilogue) and K6 (int8
max-pool) against JAX's ``_quantize_in``, ``_conv3d(int8=True)`` and
``_max_pool3d_i8`` at each geometry of a ca_s3d forward; the folded fp32
walk; the calibrated qparams; int8 logits. Inputs are made from numpy
seeds; JAX runs on the CPU as in `tests/test_quantize_s3d.py`."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

P133 = ("pool", (1, 3, 3), (1, 2, 2), (0, 1, 1))
P333 = ("pool", (3, 3, 3), (2, 2, 2), (1, 1, 1))
P222 = ("pool", (2, 2, 2), (2, 2, 2), (0, 0, 0))

# every quantized op kind of s3d/ca_s3d; the ctx block comes after the last
# quantized conv, so that its fp rounding (which differs between the two
# frameworks in the last bit) cannot move a value across a quantization step
SPEC = (
    ("sep", 16, 7, 2, 3, "relu", True),
    P133,
    ("basic", 16, 1, 1, 0, "relu"),
    ("sep", 24, 3, 1, 1, "relu", True),
    ("mix", "3b", "relu", True),
    P333,
    ("mix", "3c", "relu", True),
    ("ctx", 1.0 / 16.0, "avg"),
    P222,
)

# (kernel, stride, padding, cin, cout, (T, H, W)): the conv geometries of a
# ca_s3d int8 forward (the stem's (1,7,7) on 3 and, with concat30, 30
# channels), at odd sizes so every border is exercised
GEOMS = [
    ((1, 7, 7), (1, 2, 2), (0, 3, 3), 3, 8, (3, 13, 11)),
    ((1, 7, 7), (1, 2, 2), (0, 3, 3), 30, 16, (2, 9, 10)),
    ((7, 1, 1), (2, 1, 1), (3, 0, 0), 16, 16, (9, 5, 4)),
    ((1, 1, 1), (1, 1, 1), (0, 0, 0), 48, 24, (3, 5, 6)),
    ((1, 3, 3), (1, 1, 1), (0, 1, 1), 16, 32, (3, 7, 5)),
    ((3, 1, 1), (1, 1, 1), (1, 0, 0), 32, 32, (5, 4, 3)),
]


def _int8_input(rng, shape, s=0.0625):
    """fp32 activations with exact .5 quantization ties and values past
    ±127 quanta."""
    x = rng.standard_normal(shape).astype(np.float32) * 3.0
    ties = rng.random(shape) < 0.125
    x[ties] = (rng.integers(-200, 200, int(ties.sum())) + 0.5) * s
    return x, np.float32(s)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_pad_plain_equals_jax(dtype):
    from fac_fake_tpu.compat.quantize_s3d import _quantize_in
    from fac_fake_torch.ops.quant3d import quantize_pad, quantize_pad_plain

    x, s = _int8_input(np.random.default_rng(1), (2, 3, 5, 4, 30))
    xj = jnp.asarray(x, jnp.dtype(dtype))
    ref = np.asarray(_quantize_in(xj, jnp.float32(s)))
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(getattr(torch, dtype))
    got = quantize_pad_plain(xt, torch.tensor(s))
    assert got.dtype == torch.int8 and got.shape == (2, 3, 5, 4, 32)
    np.testing.assert_array_equal(got[..., :30].numpy(), ref)
    assert not got[..., 30:].any()
    assert torch.equal(quantize_pad(xt, torch.tensor(s)), got)   # CPU: the plain version


@pytest.mark.parametrize("kernel,stride,padding,cin,cout,thw", GEOMS)
def test_int8_conv3d_plain_equals_jax(kernel, stride, padding, cin, cout, thw):
    from fac_fake_tpu.compat.quantize_s3d import _conv3d
    from fac_fake_torch.ops import quant3d as q3
    from fac_fake_torch.ops.quant import pad16

    rng = np.random.default_rng(cin * 100 + cout)
    xq = rng.integers(-127, 128, (2, *thw, cin)).astype(np.int8)
    wq = rng.integers(-127, 128, (*kernel, cin, cout)).astype(np.int8)   # DHWIO
    s = rng.uniform(1e-4, 1e-2, cout).astype(np.float32)
    b = rng.standard_normal(cout).astype(np.float32)
    acc = _conv3d(jnp.asarray(xq), jnp.asarray(wq), stride, padding, int8=True)
    assert acc.dtype == jnp.int32

    cp = pad16(cin)
    xt = torch.nn.functional.pad(torch.from_numpy(xq), (0, cp - cin))
    wt = torch.nn.functional.pad(torch.from_numpy(np.ascontiguousarray(
        wq.transpose(4, 0, 1, 2, 3))), (0, cp - cin))
    got = q3.int_conv3d_plain(xt, wt, stride, padding)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(acc))

    # the epilogue, in JAX's order: (acc · s + b) → dtype → ReLU
    st, bt = torch.from_numpy(s), torch.from_numpy(b)
    for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        ref = jax.nn.relu((acc.astype(jnp.float32) * s + b).astype(jdt))
        y = q3.int8_conv3d(xt, wt, st, bt, stride, padding, True, dt)
        assert y.dtype == dt and y.shape == tuple(ref.shape)
        np.testing.assert_array_equal(y.float().numpy(), np.asarray(ref.astype(jnp.float32)))
        # into a channel slice of a wider output, as an Inception branch writes
        out = torch.full((*y.shape[:-1], cout + 8), 7.0, dtype=dt)
        assert q3.int8_conv3d(xt, wt, st, bt, stride, padding, True, dt, out, 4) is out
        assert torch.equal(out[..., 4:4 + cout], y)
        assert (out[..., :4] == 7).all() and (out[..., 4 + cout:] == 7).all()


def test_max_pool3d_i8_plain_equals_jax():
    from fac_fake_tpu.compat.quantize_s3d import _max_pool3d_i8
    from fac_fake_torch.ops import quant3d as q3

    rng = np.random.default_rng(3)
    xq = rng.integers(-127, 128, (2, 4, 5, 3, 16)).astype(np.int8)
    xq[0, :, 0, 0, :] = -127                     # a border of minima
    ref = np.asarray(_max_pool3d_i8(jnp.asarray(xq), (3, 3, 3), (1, 1, 1), (1, 1, 1)))
    got = q3.max_pool3d_i8(torch.from_numpy(xq))
    assert got.dtype == torch.int8 and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), ref)


# ---- the engine ------------------------------------------------------------------

def _randomize_stats(tree, seed):
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _randomize_stats(v, int(rng.integers(1 << 30)))
        elif k == "var":
            out[k] = jnp.asarray(rng.uniform(0.5, 2.0, v.shape), jnp.float32)
        else:
            out[k] = jnp.asarray(rng.normal(0.0, 0.5, v.shape), jnp.float32)
    return out


@pytest.fixture(scope="module")
def engines():
    """JAX S3DNet (randomized BN statistics) and its JAX int8 engine; the
    port model from `export_s3d` and the port's own engine, both calibrated
    on the same batch."""
    from fac_fake_tpu.compat.quantize_s3d import quantize_s3d as jax_quantize
    from fac_fake_tpu.compat.torch_export import export_s3d
    from fac_fake_tpu.models.s3d.model import S3DNet as JaxS3D
    from fac_fake_torch.compat.quantize_s3d import quantize_s3d
    from fac_fake_torch.models.s3d.model import S3DNet

    rng = np.random.default_rng(0)
    b = 4
    clips = (rng.uniform(0.0, 1.0, (b, 20, 32, 32, 3))
             * np.linspace(30.0, 255.0, b).reshape(b, 1, 1, 1, 1)).astype(np.float32)
    jm = JaxS3D(spec=SPEC, num_class=1)
    v = jax.jit(jm.init)(jax.random.key(0), jnp.asarray(clips[:1]))
    v = {"params": v["params"], "batch_stats": _randomize_stats(v["batch_stats"], 7)}
    jeng = jax_quantize(jm, v, jnp.asarray(clips))
    tm = S3DNet(SPEC, 1).eval()
    tm.load_state_dict({k: torch.from_numpy(np.array(a))
                        for k, a in export_s3d(v, SPEC).items()}, strict=True)
    x = torch.from_numpy(clips).permute(0, 4, 1, 2, 3)
    return jm, v, jeng, tm, quantize_s3d(tm, x), clips, x


def test_folded_fp_walk_matches_jax(engines):
    jm, v, jeng, tm, teng, clips, x = engines
    ref = np.asarray(jax.jit(jeng.folded_fp_forward)(v, jnp.asarray(clips)))
    np.testing.assert_allclose(teng.folded_fp_forward(tm, x).numpy(), ref, rtol=1e-4, atol=1e-4)
    with torch.no_grad():
        np.testing.assert_allclose(tm(x).numpy(), ref, rtol=1e-4, atol=1e-4)


def test_qparams_match_jax(engines):
    """Same keys; ``w_q`` bit-equal; ``s_x``, ``s``, ``b`` within 1e-6
    relative (the activations that set ``s_x`` come from fp32 convs whose
    sums differ between the frameworks in the last bits); one shared
    ``s_x`` a mix; every conv of a mix and of a sep in K5's layout."""
    jm, v, jeng, tm, teng, clips, x = engines
    jq, tq = jeng.qparams, teng.qparams
    assert set(tq) == set(jq) and len(tq) == 2 * 2 + 1 + 2 * 8
    for key, e in tq.items():
        wj = np.asarray(jq[key]["w_q"])                     # (kt, kh, kw, I, O)
        cin = wj.shape[3]
        assert e["w_q"].dtype == torch.int8 and e["w_q"].shape[-1] % 16 == 0
        assert not e["w_q"][..., cin:].any()
        np.testing.assert_array_equal(e["w_q"][..., :cin].permute(1, 2, 3, 4, 0).numpy(), wj)
        for name in ("s_x", "s", "b"):
            np.testing.assert_allclose(e[name].numpy(), np.asarray(jq[key][name]),
                                       rtol=1e-6, atol=0)
    for mix in ("l4", "l6"):
        sx = {float(tq[f"{mix}/{b}"]["s_x"]) for b in ("b0", "b1a", "b2a", "b3")}
        assert len(sx) == 1, sx


def _carry_qparams(teng, jq):
    """The JAX engine's qparams into the port engine's buffers."""
    with torch.no_grad():
        for key, qc in teng.qconvs.items():
            w = np.asarray(jq[key]["w_q"]).transpose(4, 0, 1, 2, 3)
            qc.w_q.zero_()[..., :w.shape[-1]] = torch.from_numpy(np.ascontiguousarray(w))
            for name in ("s", "b", "s_x"):
                getattr(qc, name).copy_(torch.from_numpy(np.array(jq[key][name])))


def test_int8_logits_match_jax_engine(engines):
    """With the JAX engine's qparams carried over, the port's int8 walk
    (quantize once a mix, int8 pool, branch slices, epilogues) gives JAX's
    int8 logits within 1e-3. With its own calibration the scales differ in
    the last bits, which moves a few values across a quantization step:
    the logits then stay within 2% of the fp logits' spread of JAX's."""
    import copy
    jm, v, jeng, tm, teng, clips, x = engines
    ref = np.asarray(jeng(jnp.asarray(clips))).ravel()
    with torch.no_grad():
        own = teng(x).numpy().ravel()
        carried = copy.deepcopy(teng)
        _carry_qparams(carried, jeng.qparams)
        got = carried(x).numpy().ravel()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3)
    fp = np.asarray(jax.jit(jm.apply)(v, jnp.asarray(clips))).ravel()
    assert np.abs(own - ref).max() <= 0.02 * (fp.max() - fp.min()), (own, ref)


def test_srm_bank_stays_fp_and_relu6_is_refused():
    from fac_fake_torch.compat.quantize_s3d import quantize_s3d
    from fac_fake_torch.models import init_weights
    from fac_fake_torch.models.s3d.model import S3DNet

    spec = (("sep", 16, 7, 2, 3, "relu", True), P133, P333, P222)
    m = init_weights(S3DNet(spec, 1, srm="concat30"), 0).eval()
    x = torch.from_numpy(np.random.default_rng(4).uniform(0, 255, (2, 3, 20, 16, 16))
                         .astype(np.float32))
    eng = quantize_s3d(m, x)
    assert set(eng.qparams) == {"l0/s", "l0/t"}
    assert eng.qparams["l0/s"]["w_q"].shape == (16, 1, 7, 7, 32)   # 30 channels → 32
    with torch.no_grad():
        np.testing.assert_allclose(eng.folded_fp_forward(m, x).numpy(), m(x).numpy(),
                                   rtol=1e-4, atol=1e-4)
    m6 = S3DNet((("basic", 8, 1, 1, 0, "relu6"),), 1)
    with pytest.raises(NotImplementedError, match="relu6"):
        quantize_s3d(m6, x)

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


@pytest.mark.parametrize("kernel,stride,padding,cin,cout,thw", GEOMS)
def test_fused_int8_conv3d_plain_equals_jax_conv_then_quantize(kernel, stride, padding, cin,
                                                               cout, thw):
    """K5 with ``q_scale``: JAX's ``_conv3d(int8=True)``, its epilogue in the
    walk's dtype, the ReLU, then ``_quantize_in`` at the next conv's scale,
    exactly; the channels padded to 16 with zeros. The 3-channel input is
    quantized to 4 channels and read against the 16-channel kernel."""
    from fac_fake_tpu.compat.quantize_s3d import _conv3d, _quantize_in
    from fac_fake_torch.ops import quant3d as q3
    from fac_fake_torch.ops.quant import pad16

    rng = np.random.default_rng(cin * 10 + cout)
    x, sx = _int8_input(rng, (2, *thw, cin))
    wq = rng.integers(-127, 128, (*kernel, cin, cout)).astype(np.int8)   # DHWIO
    s = rng.uniform(1e-3, 1e-2, cout).astype(np.float32)
    b = rng.standard_normal(cout).astype(np.float32)
    xj = _quantize_in(jnp.asarray(x), jnp.float32(sx))
    acc = _conv3d(xj, jnp.asarray(wq), stride, padding, int8=True)
    xt = q3.quantize_pad(torch.from_numpy(x), torch.tensor(sx))
    assert xt.shape[-1] == (4 if cin == 3 else pad16(cin))
    wt = torch.nn.functional.pad(torch.from_numpy(np.ascontiguousarray(
        wq.transpose(4, 0, 1, 2, 3))), (0, pad16(cin) - cin))
    for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        y = jax.nn.relu((acc.astype(jnp.float32) * s + b).astype(jdt))
        q_scale = np.float32(float(jnp.abs(y.astype(jnp.float32)).max()) / 150.0)   # some clip
        ref = np.asarray(_quantize_in(y, jnp.float32(q_scale)))
        got = q3.int8_conv3d(xt, wt, torch.from_numpy(s), torch.from_numpy(b), stride, padding,
                             True, dt, q_scale=torch.tensor(q_scale))
        assert got.dtype == torch.int8 and got.shape == (*ref.shape[:-1], pad16(cout))
        np.testing.assert_array_equal(got[..., :cout].numpy(), ref)
        assert not got[..., cout:].any()
        assert (np.abs(ref) == 127).any() and (ref == 0).any()


def test_stem_rows_layout_gives_the_sixteen_channel_sums():
    """K5's stem layout: each (dt, dy) row of 8 input pixels x 4 channels
    (32 bytes) against `stem_rows`'s 32-byte weight rows gives the int32
    sums of the 16-channel conv, the eighth pixel's weights being zero."""
    from fac_fake_torch.ops import quant3d as q3

    rng = np.random.default_rng(12)
    n, (t, h, w) = 8, (2, 11, 9)
    x16 = np.zeros((2, t, h, w, 16), np.int8)
    x16[..., :3] = rng.integers(-127, 128, (2, t, h, w, 3))
    w16 = np.zeros((n, 1, 7, 7, 16), np.int8)
    w16[..., :3] = rng.integers(-127, 128, (n, 1, 7, 7, 3))
    ref = q3.int_conv3d_plain(torch.from_numpy(x16), torch.from_numpy(w16), (1, 2, 2),
                              (0, 3, 3)).numpy()
    # the plain version on the 4-channel input, the kernel cut to 4 channels
    x4 = torch.from_numpy(np.ascontiguousarray(x16[..., :4]))
    assert np.array_equal(q3.int_conv3d_plain(x4, torch.from_numpy(w16)[..., :4], (1, 2, 2),
                                              (0, 3, 3)).numpy(), ref)
    rows = q3.stem_rows(torch.from_numpy(w16)).numpy().astype(np.int64)     # (n, 1, 7, 32)
    assert rows.shape == (n, 1, 7, 32) and not rows[..., 28:].any()
    xp = np.pad(x16[..., :4].astype(np.int64), ((0, 0), (0, 0), (3, 3), (3, 4), (0, 0)))
    ho, wo = ref.shape[2:4]
    got = np.zeros_like(ref, dtype=np.int64)
    for dy in range(7):
        for o in range(wo):
            chunk = xp[:, :, 2 * np.arange(ho) + dy, 2 * o:2 * o + 8].reshape(2, t, ho, 32)
            got[:, :, :, o] += chunk @ rows[:, 0, dy].T
    assert np.array_equal(got, ref)


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
    sums differ between the frameworks in the last bits), the stem conv's
    ``s_x`` exactly (its input is the clip); one shared ``s_x`` a mix;
    every conv of a mix and of a sep in K5's layout."""
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
    # the stem conv's input is the clip itself: its scale is JAX's, bit for bit
    assert np.float32(tq["l0/s"]["s_x"].item()) == np.float32(jq["l0/s"]["s_x"])


def _carry_qparams(teng, jq):
    """The JAX engine's qparams into the port engine's buffers."""
    from fac_fake_torch.ops import quant3d as q3

    with torch.no_grad():
        for key, qc in teng.qconvs.items():
            w = np.asarray(jq[key]["w_q"]).transpose(4, 0, 1, 2, 3)
            qc.w_q.zero_()[..., :w.shape[-1]] = torch.from_numpy(np.ascontiguousarray(w))
            if qc.w_rows is not None:                      # the stem's K5 layout of w_q
                qc.w_rows.copy_(q3.stem_rows(qc.w_q))
            for name in ("s", "b", "s_x"):
                getattr(qc, name).copy_(torch.from_numpy(np.array(jq[key][name])))


# A quantize point's x/s_x in the two walks differs in the last bits: the
# epilogue ``acc·s + b`` is rounded once more or less (XLA:CPU fuses it under
# `jit`; eager JAX gives the port's values), and an fp block (GCNet context,
# MSCAN-half, iFormer) sums in another order. Where JAX's x/s_x sits on a .5
# tie, such a difference flips the code, and the flip then moves every value
# downstream. So the lock-step comparison below feeds the port JAX's output
# of each fp block (held to the port's within FP_BLOCK_REL of its largest
# value), holds each port x/s_x to JAX's within VALUE_ULPS ulps of the
# point's largest |x/s_x| (the epilogue's rounding scales with its terms,
# not with a sum that cancels near zero), admits a differing code only where
# JAX's x/s_x lies within TIE_ULPS of those ulps of a .5 tie, and carries
# JAX's code on from there. Measured (torch 2.13 CPU, jax 0.9.0): at most 2
# such ulps at every point of the ca_s3d and msca test specs, fp blocks
# 4.8e-7 of their largest value apart, and one flipped code (ca_s3d's l3/s:
# JAX's x/s_x 71.5 exactly, the port's one ulp below).
VALUE_ULPS = 4
TIE_ULPS = 4
FP_BLOCK_REL = 1e-5


def jax_quantize_points(jeng, variables, clips):
    """JAX's int8 walk, jitted as the engine runs it, recording each
    `_quantize_in` as (s_x, x / s_x, codes) and each fp block's output, in
    walk order; and the logits (the recording changes no value: the logits
    equal the engine's, bit for bit)."""
    import fac_fake_tpu.compat.quantize_s3d as jq
    import fac_fake_tpu.models.s3d.blocks as jb

    names = ("ContextBlock3d", "MSCANHalf", "IFormerBlock")

    def walk(v, qp, c):
        rec, blocks, real = [], [], jq._quantize_in
        classes = {n: getattr(jb, n) for n in names}

        def recording(x, s_x):
            codes = real(x, s_x)
            rec.append((s_x, x.astype(jnp.float32) / s_x, codes))
            return codes

        def recorded(cls):
            class Recorded(cls):
                def apply(self, *a, **k):
                    out = cls.apply(self, *a, **k)
                    blocks.append(out)
                    return out
            return Recorded

        jq._quantize_in = recording
        for n, cls in classes.items():
            setattr(jb, n, recorded(cls))
        try:
            return jeng._int8_forward(v, qp, c), rec, blocks
        finally:
            jq._quantize_in = real
            for n, cls in classes.items():
                setattr(jb, n, cls)

    logits, rec, blocks = jax.jit(walk)(variables, jeng.qparams, jnp.asarray(clips))
    points = [(np.float32(s), np.asarray(v), np.asarray(c)) for s, v, c in rec]
    return np.asarray(logits).ravel(), points, [np.asarray(b) for b in blocks]


def lockstep_logits(teng, x, points, blocks):
    """The port's int8 walk on ``x`` (the engine carrying JAX's qparams) in
    lock-step with JAX's recorded ``points`` and fp ``blocks``: every
    quantize the port makes uses one of JAX's scales bit for bit (the point
    of the same scale and shape), its x/s_x is within VALUE_ULPS of JAX's,
    its codes equal JAX's but where JAX's x/s_x is within TIE_ULPS of a .5
    tie (both in ulps of the point's largest |x/s_x|), and JAX's codes go
    on; each fp block's output is within FP_BLOCK_REL of JAX's, and JAX's
    goes on. Returns the logits, and each flipped code as (point, JAX's
    x/s_x, the port's, JAX's code, the port's)."""
    from fac_fake_torch.ops import quant3d as q3

    real, used, flips = q3.quantize_plain, set(), []

    def carrying(x_, s_x):
        codes = real(x_, s_x).numpy()
        val = (x_.float() / s_x).numpy()
        s = np.float32(s_x.item())
        match = [j for j, (sj, _, cj) in enumerate(points)
                 if sj == s and cj.shape == codes.shape and j not in used]
        assert match, f"a quantize at scale {s!r}, shape {codes.shape}: no such point in JAX"
        j = match[0]
        used.add(j)
        jv, jc = points[j][1], points[j][2]
        unit = np.spacing(np.abs(jv).max())
        far = np.abs(val - jv) > VALUE_ULPS * unit
        assert not far.any(), (j, int(far.sum()), float(np.abs(val - jv).max()))
        flip = codes != jc
        tie = np.abs(np.abs(jv - np.floor(jv)) - np.float32(0.5)) <= TIE_ULPS * unit
        assert not (flip & ~tie).any(), (j, np.argwhere(flip & ~tie)[:4])
        flips.extend((j, jv[i], val[i], jc[i], codes[i]) for i in map(tuple, np.argwhere(flip)))
        return torch.from_numpy(jc.copy())

    order = iter(range(len(blocks)))

    def block_forward(real_forward):
        def forward(x_):
            j = next(order)
            got, ref = real_forward(x_).permute(0, 2, 3, 4, 1).numpy(), blocks[j]
            err = float(np.abs(got - ref).max())
            assert err <= FP_BLOCK_REL * float(np.abs(ref).max()), (j, err)
            return torch.from_numpy(ref.copy()).permute(0, 4, 1, 2, 3)
        return forward

    with pytest.MonkeyPatch.context() as mp, torch.no_grad():
        mp.setattr(q3, "quantize_plain", carrying)
        for mod in teng.fp.values():
            mp.setattr(mod, "forward", block_forward(mod.forward))
        logits = teng(x).numpy().ravel()
    assert len(used) == len(points) and next(order, None) is None, (len(used), len(points))
    return logits, flips


def test_int8_logits_match_jax_engine(engines):
    """With the JAX engine's qparams carried over, the port's int8 walk
    (quantize once a mix, int8 pool, branch slices, epilogues) steps with
    JAX's quantize point by point (`lockstep_logits`: the same scales, x/s_x
    within VALUE_ULPS, codes equal but at .5 ties, where JAX's are carried
    on) and gives JAX's int8 logits within 1e-3. With its own calibration
    the scales differ in the last bits, which moves a few values across a
    quantization step: the logits then stay within 2% of the fp logits'
    spread of JAX's."""
    import copy
    jm, v, jeng, tm, teng, clips, x = engines
    ref = np.asarray(jeng(jnp.asarray(clips))).ravel()
    rec, points, blocks = jax_quantize_points(jeng, v, clips)
    np.testing.assert_array_equal(rec, ref)
    carried = copy.deepcopy(teng)
    _carry_qparams(carried, jeng.qparams)
    got, flips = lockstep_logits(carried, x, points, blocks)
    assert len(points) == 15, len(points)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3)
    with torch.no_grad():
        own = teng(x).numpy().ravel()
        if not flips:
            np.testing.assert_allclose(carried(x).numpy().ravel(), ref, rtol=0, atol=1e-3)
    fp = np.asarray(jax.jit(jm.apply)(v, jnp.asarray(clips))).ravel()
    assert np.abs(own - ref).max() <= 0.02 * (fp.max() - fp.min()), (own, ref)


def test_int8_walk_with_fused_edges_equals_the_unfused_walk(engines, monkeypatch):
    """The int8 walk quantizes a conv's output in its epilogue where the next
    conv alone reads it (11 edges in this spec: sep → sep, basic → sep, and
    four in each mix). Run instead as the conv's fp output and a separate
    quantize pass, the logits are bit-equal; the quantize passes are then
    the 4 the walk keeps (the stem input, one a mix, the pooled l2 input...)
    plus those 11."""
    from fac_fake_torch.ops import quant3d as q3

    *_, teng, clips, x = engines
    conv, quantize = q3.int8_conv3d, q3.quantize_pad
    seen = {"fused": 0, "quantize": 0}

    def count_quantize(x_, s_x):
        seen["quantize"] += 1
        return quantize(x_, s_x)

    def counting(xq, w_q, s, b, stride, padding, relu, dtype, out=None, c0=0, q_scale=None,
                 w_rows=None):
        seen["fused"] += q_scale is not None
        return conv(xq, w_q, s, b, stride, padding, relu, dtype, out, c0, q_scale, w_rows)

    def unfused(xq, w_q, s, b, stride, padding, relu, dtype, out=None, c0=0, q_scale=None,
                w_rows=None):
        y = conv(xq, w_q, s, b, stride, padding, relu, dtype, out, c0, w_rows=w_rows)
        return y if q_scale is None else count_quantize(y, q_scale)

    monkeypatch.setattr(q3, "quantize_pad", count_quantize)
    monkeypatch.setattr(q3, "int8_conv3d", counting)
    with torch.no_grad():
        fused = teng(x)
    assert seen == {"fused": 11, "quantize": 4}, seen
    monkeypatch.setattr(q3, "int8_conv3d", unfused)
    with torch.no_grad():
        separate = teng(x)
    assert seen == {"fused": 11, "quantize": 4 + 4 + 11}, seen
    assert torch.equal(fused, separate)


def test_srm_bank_stays_fp_and_relu6_is_refused():
    """The concat30 SRM bank stays fp in front of the first quantized conv.
    (The name is kept from when ReLU6 convs were refused: they now quantize
    with ReLU6 in K5's epilogue, and an unknown activation is refused.)"""
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
    # ReLU6 convs, once refused, now quantize with K5's ReLU6 epilogue
    from fac_fake_torch.ops import quant3d as q3
    m6 = init_weights(S3DNet((("basic", 8, 1, 1, 0, "relu6"),), 1), 0).eval()
    eng6 = quantize_s3d(m6, x)
    assert eng6.qconvs["l0"].act == q3.ACT_RELU6
    with pytest.raises(ValueError, match="relu7"):
        q3.act_mode("relu7")

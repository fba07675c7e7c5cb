"""The port's S3D int8 engine on the msca family against the JAX package on
the CPU: K5's ReLU6 epilogue (its plain version against JAX's ``_act``), a
small msca spec (a relu6 stem sep, a basic, MSCAN-half, a light and a full
iFormer, a V2 and a V1 mix) with no SRM bank and with the residual SRM,
at batch 4 with JAX's qparams carried over (the folded fp walk, the
qparams, the int8 walk in lock-step with JAX's, the walk's counts), and
`S3DEvaluator` / ``cli/evaluate.py s3d --quantize int8`` on every msca
registry entry. Inputs are made from numpy seeds."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_quantize_s3d import (P133, P222, P333, TIE_ULPS, _carry_qparams,
                                     _randomize_stats, jax_quantize_points, lockstep_logits)
from test_torch_s3d_eval import crop_tree  # noqa: F401  (a fixture)

torch.set_num_threads(2)

SPEC = (
    ("sep", 16, 7, 2, 3, "relu6", True),
    P133,
    ("mscan_half", 1),
    ("basic", 32, 1, 1, 0, "relu6"),
    ("sep", 64, 3, 1, 1, "relu6", True),
    ("iformer", 0.25, 1, True),
    ("iformer", 0.25, 1, False),
    ("basic", 64, 1, 1, 0, "relu6"),
    P333,
    ("mix", "m5b", "relu6", False),      # V2: no spatial BN or act in the seps
    ("mix", "3b", "relu6", True),        # V1
    P222,
)
# what one int8 forward of SPEC runs: 6 + 2·8 convs, 11 of them quantizing
# for the next conv (l0/s, l3's input from l2, l3/s, four a mix), 20 with
# ReLU6 (all but the V2 mix's 2 spatial convs)
COUNTS = {"conv": 22, "fused": 11, "relu6": 20, "pool": 2, "fp_modules": 3}
MSCA_NAMES = ["msca_s3d", "msca_s3d_srm", "msca_s3d_v2", "msca_s3d_srm_v2"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fused", [False, True])
def test_int8_conv3d_plain_relu6_equals_jax(dtype, fused):
    """K5's plain version with ReLU6: JAX's ``(acc·s + b).astype(dt)`` then
    ``_act("relu6")`` exactly, also a direct clip to [0, 6]; into a channel
    slice, or quantized for the next conv."""
    from fac_fake_tpu.compat.quantize_s3d import _act, _conv3d, _quantize_in
    from fac_fake_torch.ops import quant3d as q3

    rng = np.random.default_rng(16)
    kernel, stride, padding, cin, cout = (1, 3, 3), (1, 1, 1), (0, 1, 1), 24, 40
    xq = rng.integers(-127, 128, (2, 3, 7, 5, cin)).astype(np.int8)
    wq = rng.integers(-127, 128, (*kernel, cin, cout)).astype(np.int8)     # DHWIO
    s = rng.uniform(1e-4, 2e-3, cout).astype(np.float32)
    b = rng.normal(2.0, 4.0, cout).astype(np.float32)
    jdt = jnp.dtype(dtype)
    acc = _conv3d(jnp.asarray(xq), jnp.asarray(wq), stride, padding, int8=True)
    y = _act("relu6")((acc.astype(jnp.float32) * s + b).astype(jdt))
    yf = np.asarray(y.astype(jnp.float32))
    assert (yf == 0).any() and (yf == 6).any() and ((yf > 0) & (yf < 6)).any()
    xt = torch.nn.functional.pad(torch.from_numpy(xq), (0, q3.pad16(cin) - cin))
    wt = torch.nn.functional.pad(torch.from_numpy(np.ascontiguousarray(
        wq.transpose(4, 0, 1, 2, 3))), (0, q3.pad16(cin) - cin))
    dt = getattr(torch, dtype)
    st, bt = torch.from_numpy(s), torch.from_numpy(b)
    direct = torch.clamp((q3.int_conv3d_plain(xt, wt, stride, padding).float() * st
                          + bt).to(dt), 0.0, 6.0)
    if fused:
        q_scale = np.float32(9.0 / 127.0)     # past 6: a ReLU without the clip shows
        ref = np.asarray(_quantize_in(y, jnp.float32(q_scale)))
        got = q3.int8_conv3d(xt, wt, st, bt, stride, padding, q3.ACT_RELU6, dt,
                             q_scale=torch.tensor(q_scale))
        np.testing.assert_array_equal(got[..., :cout].numpy(), ref)
        assert not got[..., cout:].any() and got.shape[-1] == 48
        assert torch.equal(got, q3.quantize_pad(direct, torch.tensor(q_scale)))
    else:
        out = torch.full((*direct.shape[:-1], cout + 8), 7.0, dtype=dt)
        assert q3.int8_conv3d(xt, wt, st, bt, stride, padding, q3.ACT_RELU6, dt, out,
                              4) is out
        np.testing.assert_array_equal(out[..., 4:4 + cout].float().numpy(), yf)
        assert torch.equal(out[..., 4:4 + cout], direct)
        assert (out[..., :4] == 7).all() and (out[..., 4 + cout:] == 7).all()
        relu = q3.int8_conv3d(xt, wt, st, bt, stride, padding, q3.ACT_RELU, dt)
        assert (relu.float() > 6).any()      # ReLU alone does not clip


@pytest.fixture(scope="module", params=["none", "residual3"])
def msca(request):
    """The JAX S3DNet of SPEC (randomized BN statistics) and its int8 engine;
    the port's model from `export_s3d` and its engine, both calibrated on the
    same batch of 4."""
    from fac_fake_tpu.compat.quantize_s3d import quantize_s3d as jax_quantize
    from fac_fake_tpu.compat.torch_export import export_s3d
    from fac_fake_tpu.models.s3d.model import S3DNet as JaxS3D
    from fac_fake_torch.compat.quantize_s3d import quantize_s3d
    from fac_fake_torch.models.s3d.model import S3DNet

    srm = request.param
    rng = np.random.default_rng(0)
    b = 4
    clips = (rng.uniform(0.0, 1.0, (b, 20, 32, 32, 3))
             * np.linspace(30.0, 255.0, b).reshape(b, 1, 1, 1, 1)).astype(np.float32)
    jm = JaxS3D(spec=SPEC, num_class=1, srm=srm)
    v = jax.jit(jm.init)(jax.random.key(0), jnp.asarray(clips[:1]))
    v = {"params": v["params"], "batch_stats": _randomize_stats(v["batch_stats"], 7)}
    jeng = jax_quantize(jm, v, jnp.asarray(clips))
    tm = S3DNet(SPEC, 1, srm=srm).eval()
    tm.load_state_dict({k: torch.from_numpy(np.array(a))
                        for k, a in export_s3d(v, SPEC).items()}, strict=True)
    x = torch.from_numpy(clips).permute(0, 4, 1, 2, 3)
    teng, inputs = port_calibration(tm, x)
    return srm, jm, v, jeng, tm, teng, clips, x, inputs


def port_calibration(tm, x):
    """The port's engine of ``tm`` calibrated on ``x``, and each conv's
    calibration input (NDHWC, the fp32 activation the conv reads; the
    pooled input for a mix's ``b3``), keyed as the engine keys its convs."""
    from fac_fake_torch.compat import quantize_s3d as tq

    inputs, real = [], tq.QConv3d.calibrate.__func__

    def recording(cls, w, b, x_, s_x, geom, act):
        inputs.append(x_.clone())
        return real(cls, w, b, x_, s_x, geom, act)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tq.QConv3d, "calibrate", classmethod(recording))
        teng = tq.quantize_s3d(tm, x)
    assert len(inputs) == len(teng.qconvs)
    return teng, dict(zip(teng.qconvs, inputs))


def jax_calibration(jeng, variables, clips):
    """JAX's calibration pass, jitted as `quantize_s3d` runs it, recording
    each conv's input (the fp32 activation its ``s_x`` is the max of, or the
    pooled input of a mix's ``b3``) and its ``s_w`` by the engine's own
    expression: {key: (input, s_w)}; and the qparams (equal to the engine's,
    bit for bit)."""
    import fac_fake_tpu.compat.quantize_s3d as jq

    order = []

    def calibrate(v, c):
        rec, real, build = [], jq._conv3d, {}

        def recording(x, w, strides, padding, int8=False):
            rec.append((x, jnp.maximum(jnp.max(jnp.abs(w), axis=(0, 1, 2, 3)) / 127.0,
                                       1e-12)))
            return real(x, w, strides, padding, int8)

        jq._conv3d = recording
        try:
            jeng._walk(v, c, build=build, qp=None)
        finally:
            jq._conv3d = real
        order.extend(build)
        return build, rec[:len(build)]         # the head's conv comes last

    build, rec = jax.jit(calibrate)(variables, jnp.asarray(clips))
    points = {k: (np.asarray(a), np.asarray(s_w)) for k, (a, s_w) in zip(order, rec)}
    return {k: {n: np.asarray(t) for n, t in e.items()} for k, e in build.items()}, points


def _port_qparams_to_jax(teng, jq):
    """The port engine's qparams in JAX's layout (``w_q`` (kt, kh, kw, I, O),
    the padded input channels cut), for JAX's engine to run with."""
    out = {}
    for key, qc in teng.qconvs.items():
        cin = np.asarray(jq[key]["w_q"]).shape[3]
        out[key] = {"w_q": jnp.asarray(qc.w_q[..., :cin].permute(1, 2, 3, 4, 0).numpy()),
                    **{n: jnp.asarray(getattr(qc, n).numpy()) for n in ("s", "b", "s_x")}}
    return out


def test_msca_folded_fp_walk_matches_jax(msca):
    """The folded fp32 walk (MSCAN-half and iFormer through the model's own
    blocks, the residual SRM in front) against JAX's and the model, 1e-4."""
    srm, jm, v, jeng, tm, teng, clips, x, inputs = msca
    ref = np.asarray(jax.jit(jeng.folded_fp_forward)(v, jnp.asarray(clips)))
    np.testing.assert_allclose(teng.folded_fp_forward(tm, x).numpy(), ref, rtol=1e-4, atol=1e-4)
    with torch.no_grad():
        np.testing.assert_allclose(tm(x).numpy(), ref, rtol=1e-4, atol=1e-4)


def test_msca_qparams_match_jax(msca):
    """JAX's keys; ``w_q`` equal to JAX's but where the port's folded w/s_w
    lies within TIE_ULPS ulps of 127 of a .5 tie (the fold rounds in another
    order under JAX's `jit`: one code of the 22 convs' flips, l10/b1b/s,
    where the port's w/s_w is -87.5 exactly); ``s_w`` within TIE_ULPS ulps of
    JAX's and ``b`` within 1e-6 relative; each ``s_x`` exactly max|a|/127 of
    the port's own calibration activation ``a`` (a mix's four convs share
    their input's), and each ``a`` within the fp walk's 1e-4 of JAX's at the
    same point; ``s`` exactly the port's ``s_x·s_w``; the stem's ``s_x``
    equal to JAX's (its input is the clip, or with the residual SRM the same
    fp32 conv's output); each conv's epilogue act: ReLU6, none on the V2
    mix's spatial convs.

    ``s_x`` is a max over activations that come after the fp blocks and
    many fp32 convs, and is not held to JAX's ``s_x`` in the last bits: the
    two sides' activations round apart by a host's summation order (8.4e-7
    at ``l9/b1b/t``; both are held to float64 by
    `test_msca_input_scales_near_float64`)."""
    from fac_fake_torch.compat.quantize_s3d import folded_convs
    from fac_fake_torch.ops import quant3d as q3

    srm, jm, v, jeng, tm, teng, clips, x, inputs = msca
    jq, tq = jeng.qparams, teng.qparams
    assert set(tq) == set(jq) and len(tq) == COUNTS["conv"]
    build, points = jax_calibration(jeng, v, clips)
    assert set(points) == set(jq)
    for key, e in build.items():
        for name, t in e.items():
            np.testing.assert_array_equal(t, np.asarray(jq[key][name]))
    folded, flips = folded_convs(tm), 0
    for key, e in tq.items():
        wj = np.asarray(jq[key]["w_q"])                     # (kt, kh, kw, I, O)
        wt = e["w_q"][..., :wj.shape[3]].permute(1, 2, 3, 4, 0).numpy()
        w = folded[key][0].detach().permute(2, 3, 4, 1, 0).numpy()
        s_w = np.maximum(np.abs(w).max(axis=(0, 1, 2, 3)) / np.float32(127), np.float32(1e-12))
        val = w / s_w
        tie = np.abs(np.abs(val - np.floor(val)) - np.float32(0.5)) \
            <= TIE_ULPS * np.spacing(np.float32(127))
        flip = wt != wj
        assert not (flip & ~tie).any(), (key, np.argwhere(flip & ~tie)[:4])
        assert (np.abs(wt.astype(int) - wj) <= 1).all()
        flips += int(flip.sum())
        a_ref, s_w_ref = points[key]
        assert (np.abs(s_w - s_w_ref) <= TIE_ULPS * np.spacing(s_w_ref)).all(), key
        a = inputs[key].numpy()
        np.testing.assert_allclose(a, a_ref, rtol=1e-4, atol=1e-4, err_msg=key)
        # a mix's b3 reads the pooled input; its scale is the mix input's
        src = key[:-2] + "b0" if key.endswith("/b3") else key
        amax = np.maximum(np.abs(inputs[src].numpy()).max(), np.float32(1e-8))
        s_x = e["s_x"].numpy()
        assert s_x.dtype == np.float32 and s_x == amax / np.float32(127), key
        np.testing.assert_array_equal(e["s"].numpy(), s_x * s_w, err_msg=key)
        np.testing.assert_allclose(e["b"].numpy(), np.asarray(jq[key]["b"]), rtol=1e-6, atol=0)
        v2_spatial = key.startswith("l9/") and key.endswith("b/s")
        assert teng.qconvs[key].act == (q3.ACT_NONE if v2_spatial else q3.ACT_RELU6), key
    assert np.float32(tq["l0/s"]["s_x"].item()) == np.float32(jq["l0/s"]["s_x"])
    assert flips <= 4, flips


def _conv_modules(model):
    """Each conv of the int8 walk, keyed as `folded_convs` keys it, as the
    model's own `Conv3d` (its input is the walk's calibration activation:
    the BN after it is what the walk folds)."""
    out = {}
    for i, op in enumerate(model.spec):
        m, key = model.base[i], f"l{i}"
        seps = []
        if op[0] == "sep":
            seps.append((key, m))
        elif op[0] == "basic":
            out[key] = m.conv
        elif op[0] == "mix":
            out.update({f"{key}/b0": m.branch0[0].conv, f"{key}/b1a": m.branch1[0].conv,
                        f"{key}/b2a": m.branch2[0].conv, f"{key}/b3": m.branch3[1].conv})
            seps += [(f"{key}/b1b", m.branch1[1]), (f"{key}/b2b", m.branch2[1])]
        for k, sep in seps:
            out[k + "/s"], out[k + "/t"] = sep.conv_s, sep.conv_t
    return out


def test_msca_input_scales_near_float64(msca):
    """Each ``s_x``, the port's and JAX's, within 4e-6 (relative) of max|a|/127
    of the float64 activation ``a`` at its conv (the port's model run in
    float64 on the same clips: folding is exact algebra); a mix's four convs
    share their input's. Measured (torch 2.13 CPU, jax 0.9.0): at most 7.3e-7
    for the port (``l9/b1b/t``, all of it from ``l9/b1b/s``'s 864-term fp32
    sums) and 6.2e-7 for JAX (``l10/b1b/t``), so the two sides' ``s_x`` part
    by up to 8.4e-7: host rounding, which `test_msca_qparams_match_jax` no
    longer holds them to."""
    srm, jm, v, jeng, tm, teng, clips, x, inputs = msca
    m64 = copy.deepcopy(tm).double()
    convs = _conv_modules(m64)
    assert set(convs) == set(teng.qconvs)
    amax = {}
    hooks = [c.register_forward_pre_hook(lambda mod, args, k=k: amax.__setitem__(
        k, float(args[0].abs().amax()))) for k, c in convs.items()]
    with torch.no_grad():
        m64(x.double())
    for h in hooks:
        h.remove()
    errs = {"port": [], "jax": []}
    for key in convs:
        src = key[:-2] + "b0" if key.endswith("/b3") else key
        want = max(amax[src], 1e-8) / 127.0
        for side, got in (("port", teng.qconvs[key].s_x.item()),
                          ("jax", float(np.asarray(jeng.qparams[key]["s_x"])))):
            errs[side].append((abs(got - want) / want, key))
            assert abs(got - want) <= 4e-6 * want, (side, key, got, want)
    worst = {side: max(e) for side, e in errs.items()}
    print(f"{srm}: s_x from float64's, worst {worst}; l9/b1b/t: float64 "
          f"{max(amax['l9/b1b/t'], 1e-8) / 127.0!r}, port {teng.qconvs['l9/b1b/t'].s_x.item()!r}, "
          f"JAX {float(np.asarray(jeng.qparams['l9/b1b/t']['s_x']))!r}")


def test_msca_int8_logits_match_jax_engine(msca):
    """With JAX's qparams carried over, the port's int8 walk steps with JAX's
    (`lockstep_logits`: every quantize at JAX's scale, x/s_x within a few
    ulps, codes equal but at .5 ties; each fp block within 1e-5 of JAX's)
    and gives JAX's int8 logits within 1e-3. With its own calibration, the
    same against JAX's engine run with the port's qparams carried the other
    way, and the port's own forward within 2% of the fp logits' spread of
    those logits (the lock-step carries JAX's code at a .5 tie; the own
    forward does not)."""
    srm, jm, v, jeng, tm, teng, clips, x, inputs = msca
    ref = np.asarray(jeng(jnp.asarray(clips))).ravel()
    rec, points, blocks = jax_quantize_points(jeng, v, clips)
    np.testing.assert_array_equal(rec, ref)
    counts = teng.walk_counts(uint8=False)
    assert len(points) == counts["quantize"] + counts["fused"] == 16
    assert len(blocks) == COUNTS["fp_modules"]
    carried = copy.deepcopy(teng)
    _carry_qparams(carried, jeng.qparams)
    got, flips = lockstep_logits(carried, x, points, blocks)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3)

    jeng_own = copy.copy(jeng)
    jeng_own.qparams = _port_qparams_to_jax(teng, jeng.qparams)
    ref_own, points, blocks = jax_quantize_points(jeng_own, v, clips)
    assert len(points) == 16 and len(blocks) == COUNTS["fp_modules"]
    got, flips = lockstep_logits(teng, x, points, blocks)
    np.testing.assert_allclose(got, ref_own, rtol=0, atol=1e-3)
    with torch.no_grad():
        own = teng(x).numpy().ravel()
    fp = np.asarray(jax.jit(jm.apply)(v, jnp.asarray(clips))).ravel()
    assert np.abs(own - ref_own).max() <= 0.02 * (fp.max() - fp.min()), (own, ref_own, fp)


def _counting(monkeypatch):
    """K5, K5's quantize pass, K6 and K2's raw entry rebound to count their
    calls as the kernels' wrappers count launches (the plain versions count
    none)."""
    from fac_fake_torch.ops import preprocess as pp
    from fac_fake_torch.ops import quant3d as q3

    seen = dict(conv=0, fused=0, relu6=0, quantize=0, raw=0, pool=0)
    conv, quantize, pool, raw = q3.int8_conv3d, q3.quantize_pad, q3.max_pool3d_i8, \
        pp.quantize_clips

    def counting_conv(xq, w_q, s, b, stride, padding, act, dtype, out=None, c0=0,
                      q_scale=None, w_rows=None):
        seen["conv"] += 1
        seen["fused"] += q_scale is not None
        seen["relu6"] += act == q3.ACT_RELU6
        return conv(xq, w_q, s, b, stride, padding, act, dtype, out, c0, q_scale, w_rows)

    def count(name, fn):
        def counted(*a):
            seen[name] += 1
            return fn(*a)
        return counted

    monkeypatch.setattr(q3, "int8_conv3d", counting_conv)
    monkeypatch.setattr(q3, "quantize_pad", count("quantize", quantize))
    monkeypatch.setattr(q3, "max_pool3d_i8", count("pool", pool))
    monkeypatch.setattr(pp, "quantize_clips", count("raw", raw))
    return seen


def test_msca_walk_counts(msca, monkeypatch):
    """One int8 forward runs what `walk_counts` says, from float clips and
    from uint8 clips (with no SRM bank, K2's raw entry then makes the stem
    conv's input); the uint8 forward equals the float one on the same
    bytes."""
    srm, jm, v, jeng, tm, teng, clips, x, inputs = msca
    u8 = torch.from_numpy(np.round(clips).astype(np.uint8)).permute(0, 4, 1, 2, 3)
    seen = _counting(monkeypatch)
    with torch.no_grad():
        from_float = teng(u8.float())
        want = teng.walk_counts(uint8=False)
        assert {k: seen[k] for k in seen} == {k: want[k] for k in seen}, (seen, want)
        assert {k: want[k] for k in COUNTS} == COUNTS
        assert want["quantize"] == 5 and want["raw"] == 0
        for k in seen:
            seen[k] = 0
        from_u8 = teng(u8)
        want = teng.walk_counts(uint8=True)
        assert {k: seen[k] for k in seen} == {k: want[k] for k in seen}, (seen, want)
        assert (want["quantize"], want["raw"]) == ((4, 1) if srm == "none" else (5, 0))
    assert torch.equal(from_u8, from_float)


@pytest.mark.parametrize("name", MSCA_NAMES)
def test_msca_registry_entries_score_in_int8(name, monkeypatch):
    """`S3DEvaluator(quantize="int8")` scores each msca registry entry at
    full width (32², 16 frames, the S3D head's least, for the CPU; the
    residual SRM on the ``_srm`` entries): probabilities in [0, 1], the
    walk's counts (22 K5 convs, 2 K6 pools, 4 quantize passes from K2's raw
    entry, 5 with the SRM bank in front)."""
    from fac_fake_torch.core.config import ModelConfig
    from fac_fake_torch.evaluate.s3d_eval import S3DEvaluator
    from fac_fake_torch.models import build_model

    srm = "srm" in name
    m = build_model(ModelConfig(name=name, image_size=32, num_class=1, srm_net=srm),
                    device="cpu", seed=3)
    assert m.srm == ("residual3" if srm else "none")
    clips = np.random.default_rng(4).integers(0, 256, (2, 16, 32, 32, 3), dtype=np.uint8)
    ev = S3DEvaluator(m, degrade=False, quantize="int8", device="cpu")
    seen = _counting(monkeypatch)
    p = ev.predict_batch(clips)
    assert p.shape == (2,) and np.isfinite(p).all() and ((p >= 0) & (p <= 1)).all()
    want = ev.engine.walk_counts()
    assert seen == {k: want[k] for k in seen}, (seen, want)
    assert (want["conv"], want["fused"], want["relu6"], want["pool"]) == (22, 11, 20, 2)
    assert (want["quantize"], want["raw"]) == ((5, 0) if srm else (4, 1))
    fp = S3DEvaluator(m, degrade=False, device="cpu").predict_batch(clips)
    print(f"{name}: int8 {p} fp32 {fp}")


@pytest.mark.parametrize("name", MSCA_NAMES)
def test_cli_evaluate_msca_int8_on_cpu(name, crop_tree, tmp_path, monkeypatch, capsys):
    """``cli/evaluate.py s3d --model <msca name> --quantize int8 --device
    cpu`` over a crop tree; the config's image size cut to the crops' 32²
    for the CPU."""
    import fac_fake_torch.core.config as config
    from fac_fake_torch.cli.evaluate import main

    real = config.Config

    def small():
        cfg = real()
        cfg.model.image_size = 32
        return cfg

    monkeypatch.setattr(config, "Config", small)
    out = main(["s3d", "--clips-root", crop_tree, "--model", name, "--quantize", "int8",
                "--no-degrade", "--device", "cpu", "--out-prefix", str(tmp_path / "ev")])
    assert out["count"] == 3 and 0.0 <= out["accuracy"] <= 1.0 and np.isfinite(out["bce"])
    assert "'count': 3" in capsys.readouterr().out

"""The port's MTCNN (`fac_fake_torch/detect/mtcnn.py`), its bilinear
resamplers and K8's plain version against the JAX package on the CPU.

The JAX cascade runs as its own tests run it (jit on the CPU), its nets from
seeded JAX variables that `mtcnn_state_dict_from_flax` carries over. Two
measured facts shape the bars:

* XLA:CPU's jitted resample products (`fac_fake_tpu/ops/resize.py`) are up
  to ~2e-3 off the float64 value of their own interpolation matrices (0-255
  scale), the port's gathers ~3e-5. So a resample is held within 1e-4 of
  that float64 value, and to JAX within JAX's own distance from it + 1e-4.
* The seeded nets' P-net probabilities lie in ~0.35-0.6 over 10³ cells,
  with top-k neighbours as close as 5e-7 (measured). A 1e-6 difference in a
  pyramid level then reorders candidates. So the cascade is held stage by
  stage: every stage of the port, fed JAX's input to it, gives JAX's output
  (bit-equal for the top-k, the NMS and the box arithmetic, within 1e-5 for
  the nets). Where the whole `detect` differs, the first stage at which the
  two chains part must be such a decision, its inputs within those bars: a
  near-tie decided by the last bits, which the test prints.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_mtcnn import _sd, _torch_onet, _torch_pnet, _torch_rnet
from tests.test_torch_cuda_kernels import k8_cases

torch.set_num_threads(2)

THRESHOLDS = [(0.0, 0.0, 0.0), (0.6, 0.7, 0.7), (0.85, 0.95, 0.95), (0.65, 0.75, 0.75)]
RESAMPLE_TOL = 1e-4      # 0-255 scale, against the float64 value
NET_TOL = 1e-5


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


@pytest.fixture(scope="module")
def pair():
    """(caps) -> (JAX MTCNN, the port's MTCNN with the same weights)."""
    from fac_fake_tpu.detect.mtcnn import MTCNN as JaxMTCNN
    from fac_fake_torch.compat.weights import mtcnn_state_dict_from_flax
    from fac_fake_torch.detect.mtcnn import MTCNN

    from fac_fake_tpu.detect.mtcnn import ONet, PNet, RNet
    # JAX's own seeded init, jitted (eager, it compiles op by op: ~20 s on a CPU)
    k = jax.random.key(0)
    variables = {name: jax.jit(net().init)(k, jnp.zeros((1, hw, hw, 3)))
                 for name, net, hw in (("pnet", PNet, 12), ("rnet", RNet, 24),
                                       ("onet", ONet, 48))}
    sd = mtcnn_state_dict_from_flax(_np_tree(variables))
    made = {}

    def get(caps):
        if caps not in made:
            made[caps] = (JaxMTCNN(variables, caps=caps), MTCNN(sd, caps=caps, device="cpu"))
        return made[caps]
    return get


# --- the nets ------------------------------------------------------------------

@pytest.mark.parametrize("net,shape", [("pnet", (2, 37, 51)), ("pnet", (1, 13, 12)),
                                       ("pnet", (1, 12, 12)), ("rnet", (3, 24, 24)),
                                       ("onet", (3, 48, 48))])
def test_nets_match_jax(pair, net, shape):
    """Odd P-net sizes make the ceil-mode pool pad its last window."""
    jd, td = pair((32, 16, 8))
    x = np.random.default_rng(sum(shape)).standard_normal((*shape, 3)).astype(np.float32)
    want = getattr(jd, net).apply(jd.variables[net], jnp.asarray(x))
    with torch.no_grad():
        got = getattr(td, net)(torch.from_numpy(x).permute(0, 3, 1, 2))
    for w, g in zip(want, got):
        g = g.numpy()
        if g.ndim == 4:
            g = g.transpose(0, 2, 3, 1)
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=NET_TOL)


def test_facenet_state_dict_loads_strict_and_matches_replicas():
    from fac_fake_torch.detect.mtcnn import MTCNN

    torch.manual_seed(3)
    tp, tr, to = _torch_pnet(), _torch_rnet(), _torch_onet()
    sd = {k: torch.from_numpy(v) for k, v in
          {**_sd("pnet", tp), **_sd("rnet", tr), **_sd("onet", to)}.items()}
    mt = MTCNN(sd, device="cpu")      # load_state_dict(strict=True)
    rng = np.random.default_rng(4)
    for ref, net, shape in ((tp, mt.pnet, (2, 3, 33, 29)), (tr, mt.rnet, (3, 3, 24, 24)),
                            (to, mt.onet, (3, 3, 48, 48))):
        x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        with torch.no_grad():
            for w, g in zip(ref(x), net(x)):
                torch.testing.assert_close(g, w, rtol=0, atol=1e-6)
    with pytest.raises(RuntimeError, match="Unexpected key"):
        MTCNN({**sd, "pnet.extra": torch.zeros(1)}, device="cpu")


# --- the geometry --------------------------------------------------------------

@pytest.mark.parametrize("hw", [(1080, 1920), (120, 160)])
def test_pyramid_scales_equal(hw):
    from fac_fake_tpu.detect.mtcnn import pyramid_scales as jax_scales
    from fac_fake_torch.detect.mtcnn import pyramid_scales

    assert pyramid_scales(*hw) == jax_scales(*hw)
    if hw == (1080, 1920):
        assert len(pyramid_scales(*hw)) == 12


@pytest.mark.parametrize("hw,k,thresh", [((31, 43), 32, 0.0), ((31, 43), 128, 0.5),
                                         ((3, 2), 32, 0.0), ((5, 7), 16, 0.9)])
def test_decode_pnet_boxes_equal(hw, k, thresh):
    """Top-k with the -1.0 ties of the cells below the threshold (in index
    order), exact score ties, and small levels padded to k."""
    from fac_fake_tpu.detect.mtcnn import decode_pnet_boxes as jax_decode
    from fac_fake_torch.detect.mtcnn import decode_pnet_boxes

    rng = np.random.default_rng(hw[0] * k)
    probs = rng.uniform(0, 1, hw).astype(np.float32)
    probs.ravel()[::5] = 0.75                   # exact ties
    reg = rng.standard_normal((*hw, 4)).astype(np.float32)
    scale = 0.6 * 0.709 ** 2
    want = jax_decode(jnp.asarray(probs), jnp.asarray(reg), scale, jnp.float32(thresh), k)
    got = decode_pnet_boxes(torch.from_numpy(probs), torch.from_numpy(reg), scale, thresh, k)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_bbreg_rerec_fix_equal():
    from fac_fake_tpu.detect import mtcnn as J
    from fac_fake_torch.detect import mtcnn as T

    rng = np.random.default_rng(7)
    boxes = rng.uniform(-20, 200, (64, 4)).astype(np.float32)
    boxes[:, 2:] += boxes[:, :2]
    reg = rng.uniform(-0.3, 0.3, (64, 4)).astype(np.float32)
    jb, tb = jnp.asarray(boxes), torch.from_numpy(boxes)
    jr, tr = jnp.asarray(reg), torch.from_numpy(reg)
    np.testing.assert_array_equal(T.bbreg(tb, tr).numpy(), np.asarray(J.bbreg(jb, jr)))
    np.testing.assert_array_equal(T.rerec(tb).numpy(), np.asarray(J.rerec(jb)))
    np.testing.assert_array_equal(T._fix(tb * 1.37).numpy(), np.asarray(J._fix(jb * 1.37)))


def _f64_resample(img, yxyx, out_hw):
    """The float64 value of JAX's own products: its interpolation matrices
    (`_interp_matrix`, fp32) applied in float64."""
    from fac_fake_tpu.ops.resize import _interp_matrix
    h, w = img.shape[:2]
    out = []
    for b in yxyx:
        ry = np.asarray(_interp_matrix(out_hw[0], jnp.float32(b[0]), jnp.float32(b[2]), h))
        rx = np.asarray(_interp_matrix(out_hw[1], jnp.float32(b[1]), jnp.float32(b[3]), w))
        tmp = np.einsum("oh,hwc->owc", ry.astype(np.float64), img.astype(np.float64))
        out.append(np.einsum("pw,owc->opc", rx.astype(np.float64), tmp))
    return np.stack(out)


def _hold_resample(got, want_jax, exact, scale=1.0):
    """``got`` within RESAMPLE_TOL of the float64 value, and of JAX's output
    within JAX's own distance from it plus RESAMPLE_TOL (0-255 scale)."""
    got, want_jax, exact = got * scale, want_jax * scale, exact * scale
    assert np.abs(got - exact).max() <= RESAMPLE_TOL, np.abs(got - exact).max()
    jax_err = np.abs(want_jax - exact).max()
    assert np.abs(got - want_jax).max() <= jax_err + RESAMPLE_TOL


@pytest.mark.parametrize("hw,out_hw", [((120, 160), (73, 97)), ((100, 100), (43, 43)),
                                       ((60, 80), (90, 130))])
def test_resize_bilinear_matches_jax(hw, out_hw):
    from fac_fake_tpu.ops.resize import resize_bilinear as jax_resize
    from fac_fake_torch.ops.resize import resize_bilinear

    img = np.random.default_rng(hw[0]).integers(0, 256, (*hw, 3)).astype(np.float32)
    got = resize_bilinear(torch.from_numpy(img)[None], out_hw)[0].numpy()
    want = np.asarray(jax_resize(jnp.asarray(img)[None], out_hw))[0]
    exact = _f64_resample(img, [(0.0, 0.0, float(hw[0]), float(hw[1]))], out_hw)[0]
    _hold_resample(got, want, exact)


def test_crop_resize_and_patches_match_jax_out_of_frame():
    from fac_fake_tpu.detect.mtcnn import _extract_patches as jax_patches
    from fac_fake_tpu.ops.resize import crop_resize_bilinear as jax_crop
    from fac_fake_torch.detect.mtcnn import _extract_patches
    from fac_fake_torch.ops.resize import crop_resize_bilinear

    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (120, 160, 3)).astype(np.float32)
    boxes = np.array([[-10.0, -10.0, 30.0, 30.0],     # partly out of frame
                      [10.0, 10.0, 50.0, 50.0],
                      [5.5, 3.2, 40.7, 80.1],         # fractional
                      [140.0, 100.0, 190.0, 150.0],   # past the right and bottom
                      [-40.0, -30.0, -5.0, -2.0]],    # wholly outside: edge-clamped
                     np.float32)
    yxyx = np.stack([boxes[:, 1], boxes[:, 0], boxes[:, 3] + 1, boxes[:, 2] + 1], -1)
    exact24 = _f64_resample(img, yxyx, (24, 24))
    got = crop_resize_bilinear(torch.from_numpy(img), torch.from_numpy(yxyx), (24, 24)).numpy()
    want = np.asarray(jax_crop(jnp.asarray(img), jnp.asarray(yxyx), (24, 24)))
    _hold_resample(got, want, exact24)
    for size in (24, 48):
        got = _extract_patches(torch.from_numpy(img), torch.from_numpy(boxes), size).numpy()
        want = np.asarray(jax_patches(jnp.asarray(img), jnp.asarray(boxes), size))
        exact = (_f64_resample(img, yxyx, (size, size)) - 127.5) * 0.0078125
        _hold_resample(got, want, exact, scale=128.0)


# --- K8's plain version ----------------------------------------------------------

@pytest.mark.parametrize("case", list(k8_cases()))
def test_hard_nms_plain_equals_jax(case):
    """Bit-equal idx and keep, every slot, padded ones too."""
    from fac_fake_tpu.detect.mtcnn import hard_nms as jax_nms
    from fac_fake_torch.ops.nms import hard_nms

    boxes, scores, valid, thr, mode, max_out = k8_cases()[case]
    idx, keep = hard_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                         torch.from_numpy(valid), thr, mode, max_out)
    calls = [(boxes, scores, valid)] if boxes.ndim == 2 else list(zip(boxes, scores, valid))
    idx, keep = idx.reshape(len(calls), max_out), keep.reshape(len(calls), max_out)
    for g, (b, s, v) in enumerate(calls):
        ji, jk = jax_nms(jnp.asarray(b), jnp.asarray(s), jnp.asarray(v), thr, mode, max_out)
        np.testing.assert_array_equal(idx[g].numpy(), np.asarray(ji))
        np.testing.assert_array_equal(keep[g].numpy(), np.asarray(jk))


# --- the cascade, stage by stage --------------------------------------------------

_JITTED = {}


def _jitted(fn):
    key = getattr(fn, "__self__", fn).__class__.__name__
    if key not in _JITTED:
        _JITTED[key] = jax.jit(fn)
    return _JITTED[key]


def _jax_stages(jd, th, caps):
    """JAX's `MTCNN._build.run` cut into stages, each a function of the
    previous stages' numpy outputs (state dict) -> its own outputs."""
    from fac_fake_tpu.detect import mtcnn as J
    from fac_fake_tpu.ops.resize import resize_bilinear
    v = jd.variables
    k1, k2, k3 = caps
    t0, t1, t2 = (jnp.float32(t) for t in th)
    a = jnp.asarray
    # the nets jitted (a continuous stage, held to NET_TOL): eager flax
    # compiles op by op at every pyramid shape
    pnet_apply, rnet_apply, onet_apply = (_jitted(getattr(jd, n).apply) for n in
                                          ("pnet", "rnet", "onet"))

    def pyramid(st):
        img = a(st["img"])
        h, w = img.shape[:2]
        return {"ims": [np.asarray((resize_bilinear(img[None], (int(h * s + 1), int(w * s + 1)))
                                    - 127.5) * 0.0078125) for s in st["scales"]]}

    def pnet(st):
        outs = [pnet_apply(v["pnet"], a(im)) for im in st["ims"]]
        return {"pnet": [(np.asarray(r[0]), np.asarray(p[0, :, :, 1])) for r, p in outs]}

    def decode(st):
        return {"cands": [tuple(np.asarray(x) for x in J.decode_pnet_boxes(a(p), a(r), s, t0, k1))
                          for (r, p), s in zip(st["pnet"], st["scales"])]}

    def nms1(st):
        parts = []
        for b, sc, rg, va in st["cands"]:
            idx, keep = J.hard_nms(a(b), a(sc), a(va), 0.5, "union", k1)
            b, sc, rg = a(b)[idx], a(sc)[idx], a(rg)[idx]
            parts.append((b, jnp.where(keep, sc, -1.0), rg, keep & (sc >= t0)))
        return {k: np.asarray(jnp.concatenate(x)) for k, x in
                zip(("boxes1", "scores1", "regs1", "valid1"), zip(*parts))}

    def nms2(st):
        idx, keep = J.hard_nms(a(st["boxes1"]), a(st["scores1"]), a(st["valid1"]), 0.7, "union", k2)
        boxes = J._fix(J.rerec(J.bbreg(a(st["boxes1"])[idx], a(st["regs1"])[idx])))
        return {"boxes2": np.asarray(boxes), "valid2": np.asarray(keep & a(st["valid1"])[idx])}

    def patch24(st):
        return {"p24": np.asarray(J._extract_patches(a(st["img"]), a(st["boxes2"]), 24))}

    def rnet(st):
        reg, probs = rnet_apply(v["rnet"], a(st["p24"]))
        return {"r_reg": np.asarray(reg), "r_prob": np.asarray(probs)}

    def nms3(st):
        scores = a(st["r_prob"])[:, 1]
        valid = a(st["valid2"]) & (scores > t1)
        idx, keep = J.hard_nms(a(st["boxes2"]), scores, valid, 0.7, "union", k2)
        boxes = J._fix(J.rerec(J.bbreg(a(st["boxes2"])[idx], a(st["r_reg"])[idx])))
        return {"boxes3": np.asarray(boxes), "valid3": np.asarray(keep & valid[idx])}

    def patch48(st):
        return {"p48": np.asarray(J._extract_patches(a(st["img"]), a(st["boxes3"]), 48))}

    def onet(st):
        reg, lmk, probs = onet_apply(v["onet"], a(st["p48"]))
        return {"o_reg": np.asarray(reg), "o_lmk": np.asarray(lmk), "o_prob": np.asarray(probs)}

    def out(st):
        boxes, lmk, scores = a(st["boxes3"]), a(st["o_lmk"]), a(st["o_prob"])[:, 1]
        valid = a(st["valid3"]) & (scores > t2)
        bw, bh = boxes[:, 2] - boxes[:, 0] + 1, boxes[:, 3] - boxes[:, 1] + 1
        px = bw[:, None] * lmk[:, 0:5] + boxes[:, 0:1] - 1
        py = bh[:, None] * lmk[:, 5:10] + boxes[:, 1:2] - 1
        boxes = J.bbreg(boxes, a(st["o_reg"]))
        idx, keep = J.hard_nms(boxes, scores, valid, 0.7, "min", k3)
        return {"out": tuple(np.asarray(x) for x in (boxes[idx], scores[idx],
                jnp.stack([px[idx], py[idx]], -1), keep & valid[idx])), "idx3": np.asarray(idx)}

    return [pyramid, pnet, decode, nms1, nms2, patch24, rnet, nms3, patch48, onet, out]


def _port_stages(td, th, caps):
    """The same stages through the port's functions (`MTCNN.run`'s code)."""
    from fac_fake_torch.detect import mtcnn as T
    from fac_fake_torch.ops import nms
    from fac_fake_torch.ops.resize import resize_bilinear
    k1, k2, k3 = caps
    t0, t1, t2 = (torch.tensor(t, dtype=torch.float32) for t in th)
    a = lambda x: torch.from_numpy(np.array(x))
    nchw = lambda x: a(x).permute(0, 3, 1, 2)

    def pyramid(st):
        img = a(st["img"])
        h, w = img.shape[:2]
        return {"ims": [((resize_bilinear(img[None], (int(h * s + 1), int(w * s + 1))) - 127.5)
                         * 0.0078125).numpy() for s in st["scales"]]}

    def pnet(st):
        outs = [td.pnet(nchw(im)) for im in st["ims"]]
        return {"pnet": [(r[0].permute(1, 2, 0).numpy(), p[0, 1].numpy()) for r, p in outs]}

    def decode(st):
        return {"cands": [tuple(x.numpy() for x in T.decode_pnet_boxes(a(p), a(r), s, t0, k1))
                          for (r, p), s in zip(st["pnet"], st["scales"])]}

    def nms1(st):
        b, sc, rg, va = (torch.stack([a(c[i]) for c in st["cands"]]) for i in range(4))
        idx, keep = nms.hard_nms(b, sc, va, 0.5, "union", k1)
        s1 = torch.gather(sc, 1, idx)
        gb = lambda x: torch.gather(x, 1, idx[..., None].expand(-1, -1, 4)).reshape(-1, 4).numpy()
        return {"boxes1": gb(b), "scores1": torch.where(keep, s1, -1.0).reshape(-1).numpy(),
                "regs1": gb(rg), "valid1": (keep & (s1 >= t0)).reshape(-1).numpy()}

    def nms2(st):
        idx, keep = nms.hard_nms(a(st["boxes1"]), a(st["scores1"]), a(st["valid1"]), 0.7,
                                 "union", k2)
        boxes = T._fix(T.rerec(T.bbreg(a(st["boxes1"])[idx], a(st["regs1"])[idx])))
        return {"boxes2": boxes.numpy(), "valid2": (keep & a(st["valid1"])[idx]).numpy()}

    def patch24(st):
        return {"p24": T._extract_patches(a(st["img"]), a(st["boxes2"]), 24).numpy()}

    def rnet(st):
        reg, probs = td.rnet(nchw(st["p24"]))
        return {"r_reg": reg.numpy(), "r_prob": probs.numpy()}

    def nms3(st):
        scores = a(st["r_prob"])[:, 1]
        valid = a(st["valid2"]) & (scores > t1)
        idx, keep = nms.hard_nms(a(st["boxes2"]), scores, valid, 0.7, "union", k2)
        boxes = T._fix(T.rerec(T.bbreg(a(st["boxes2"])[idx], a(st["r_reg"])[idx])))
        return {"boxes3": boxes.numpy(), "valid3": (keep & valid[idx]).numpy()}

    def patch48(st):
        return {"p48": T._extract_patches(a(st["img"]), a(st["boxes3"]), 48).numpy()}

    def onet(st):
        reg, lmk, probs = td.onet(nchw(st["p48"]))
        return {"o_reg": reg.numpy(), "o_lmk": lmk.numpy(), "o_prob": probs.numpy()}

    def out(st):
        boxes, lmk, scores = a(st["boxes3"]), a(st["o_lmk"]), a(st["o_prob"])[:, 1]
        valid = a(st["valid3"]) & (scores > t2)
        bw, bh = (boxes[:, 2] - boxes[:, 0]) + 1, (boxes[:, 3] - boxes[:, 1]) + 1
        px = (bw[:, None] * lmk[:, 0:5] + boxes[:, 0:1]) - 1
        py = (bh[:, None] * lmk[:, 5:10] + boxes[:, 1:2]) - 1
        boxes = T.bbreg(boxes, a(st["o_reg"]))
        idx, keep = nms.hard_nms(boxes, scores, valid, 0.7, "min", k3)
        return {"out": tuple(x.numpy() for x in (boxes[idx], scores[idx],
                torch.stack([px[idx], py[idx]], -1), keep & valid[idx])), "idx3": idx.numpy()}

    return [pyramid, pnet, decode, nms1, nms2, patch24, rnet, nms3, patch48, onet, out]


# The stages that decide (top-k, NMS, thresholds, truncation) and their
# discrete outputs: the chosen cells and boxes, and the validity masks. On
# equal inputs every leaf of theirs is bit-equal; the others compute and are
# held to their bars.
DISCRETE = {
    "decode": lambda st: [c[0] for c in st["cands"]] + [c[3] for c in st["cands"]],
    "nms1": lambda st: [st["boxes1"], st["valid1"]],
    "nms2": lambda st: [st["boxes2"], st["valid2"]],
    "nms3": lambda st: [st["boxes3"], st["valid3"]],
    "out": lambda st: [st["idx3"], st["out"][3]],
}


def _leaves(x):
    if isinstance(x, dict):
        return [l for k in sorted(x) for l in _leaves(x[k])]
    if isinstance(x, (list, tuple)):
        return [l for v in x for l in _leaves(v)]
    return [np.asarray(x)]


def _max_diff(got, want):
    worst = 0.0
    for g, w in zip(_leaves(got), _leaves(want)):
        assert g.shape == w.shape
        d = np.abs(g.astype(np.float64) - w.astype(np.float64))
        d[np.isnan(g) & np.isnan(w)] = 0.0
        worst = max(worst, float(np.nan_to_num(d, nan=np.inf).max(initial=0.0)))
    return worst


def _exact_stage(name, st):
    """The float64 value of a resample stage on JAX's inputs, normalized as
    the cascade normalizes it."""
    norm = lambda x: (x - 127.5) * 0.0078125
    img = st["img"]
    if name == "pyramid":
        h, w = img.shape[:2]
        return [norm(_f64_resample(img, [(0.0, 0.0, float(h), float(w))],
                                   (int(h * s + 1), int(w * s + 1)))) for s in st["scales"]]
    b = st["boxes2" if name == "patch24" else "boxes3"]
    yxyx = np.stack([b[:, 1], b[:, 0], b[:, 3] + 1, b[:, 2] + 1], -1)
    size = 24 if name == "patch24" else 48
    return norm(_f64_resample(img, yxyx, (size, size)))


def _hold_stage(name, fed, jout, js):
    """The port's stage on JAX's inputs against JAX's outputs."""
    if name in DISCRETE:
        for g, w in zip(_leaves(fed), _leaves(jout)):
            np.testing.assert_array_equal(g, w)
    elif name in ("pyramid", "patch24", "patch48"):
        exact = _exact_stage(name, js)
        key = {"pyramid": "ims", "patch24": "p24", "patch48": "p48"}[name]
        for g, w, e in zip(_leaves(fed[key]), _leaves(jout[key]), _leaves(exact)):
            _hold_resample(g, w, e, scale=128.0)
    else:
        assert _max_diff(fed, jout) <= NET_TOL, name


def _hold_detect(got, want):
    """The issue's bars on the valid rows: masks equal, boxes within 1e-3 px,
    probs within 1e-5, landmarks within 1e-3."""
    m = want[3]
    np.testing.assert_array_equal(got[3], m)
    np.testing.assert_allclose(got[0][m], want[0][m], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got[1][m], want[1][m], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[2][m], want[2][m], rtol=0, atol=1e-3)


def _detect_close(got, want):
    try:
        _hold_detect(got, want)
    except AssertionError:
        return False
    return True


@pytest.mark.parametrize("hw,caps", [((120, 160), (32, 16, 8)), ((100, 100), (32, 16, 8)),
                                     ((120, 160), (128, 64, 32)), ((100, 100), (128, 64, 32))])
def test_detect_matches_jax_stage_by_stage(pair, hw, caps):
    from fac_fake_torch.detect.mtcnn import pyramid_scales

    jd, td = pair(caps)
    img = np.random.default_rng(hw[0]).integers(0, 255, (*hw, 3), dtype=np.uint8)
    for th in THRESHOLDS:
        jd.thresholds = td.thresholds = th
        want, got = jd.detect(img), td.detect(img)
        assert [g.shape for g in got] == [w.shape for w in want]
        assert got[0].shape == (caps[2], 4) and got[2].shape == (caps[2], 5, 2)
        start = {"img": img.astype(np.float32), "scales": pyramid_scales(*hw)}
        js, ts = dict(start), dict(start)
        parted = None
        for jf, tf_ in zip(_jax_stages(jd, th, caps), _port_stages(td, th, caps)):
            name = jf.__name__
            jout = jf(js)
            with torch.no_grad():
                fed = tf_(js)      # the port's stage on JAX's inputs
                tout = tf_(ts)     # on its own inputs
            _hold_stage(name, fed, jout, js)
            if parted is None and name in DISCRETE and any(
                    not np.array_equal(a, b) for a, b in
                    zip(DISCRETE[name](tout), DISCRETE[name](jout))):
                parted = name
            js.update(jout)
            ts.update(tout)
        for g, t in zip(got, ts["out"]):       # the staged port chain is `detect`
            np.testing.assert_array_equal(g, t)
        if parted is None:
            _hold_detect(got, js["out"])           # JAX's stages, end to end
            if not _detect_close(got, want):
                # JAX's jitted cascade and its own stages part: XLA fuses the
                # resamples differently under one jit, and a near-tie flips
                assert not _detect_close(js["out"], want), (hw, caps, th)
                print(f"\n{hw} caps {caps} thresholds {th}: JAX's jitted detect parts "
                      f"from its own stages; the port equals the stages")
        else:
            # a near-tie: the chains' decisions agreed up to this stage, its
            # inputs were within the bars, and on equal inputs it is exact
            print(f"\n{hw} caps {caps} thresholds {th}: the chains part at {parted}; "
                  f"valid {int(got[3].sum())} vs JAX {int(want[3].sum())}")
    jd.thresholds = td.thresholds = (0.6, 0.7, 0.7)


def test_landmarks_api(pair):
    jd, td = pair((32, 16, 8))
    img = np.random.default_rng(1).integers(0, 255, (100, 100, 3), dtype=np.uint8)
    jd.thresholds = td.thresholds = (0.0, 0.0, 0.0)
    try:
        lm = td.landmarks(img)
        _, probs, points, valid = td.detect(img)
        assert lm is not None and lm.shape == (5, 2)
        np.testing.assert_array_equal(lm, points[np.argmax(np.where(valid, probs, -1))])
        jd.thresholds = td.thresholds = (0.99, 0.99, 0.99)
        assert td.landmarks(img) is None and jd.landmarks(img) is None
    finally:
        jd.thresholds = td.thresholds = (0.6, 0.7, 0.7)
    assert len(td.detect_batch(np.stack([img, img]))) == 2


# --- the npz, shared by both packages, and the importer --------------------------

def test_npz_serves_both_packages(pair, tmp_path):
    from fac_fake_tpu.detect.mtcnn import MTCNN as JaxMTCNN
    from fac_fake_tpu.detect.mtcnn import load_mtcnn_npz as jax_load
    from fac_fake_tpu.detect.mtcnn import save_mtcnn_npz as jax_save
    from fac_fake_torch.detect.mtcnn import MTCNN, load_mtcnn_npz, save_mtcnn_npz

    jd, td = pair((32, 16, 8))
    img = np.random.default_rng(2).integers(0, 255, (96, 128, 3), dtype=np.uint8)
    jax_save(jd.variables, str(tmp_path / "jax.npz"))
    from_jax = MTCNN(load_mtcnn_npz(str(tmp_path / "jax.npz")), caps=(32, 16, 8),
                     thresholds=(0.0, 0.0, 0.0), device="cpu")
    save_mtcnn_npz(from_jax.state_dict(), str(tmp_path / "port.npz"))
    with np.load(tmp_path / "jax.npz") as a, np.load(tmp_path / "port.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
    td.thresholds = (0.0, 0.0, 0.0)
    try:
        for g, w in zip(from_jax.detect(img), td.detect(img)):
            np.testing.assert_array_equal(g, w)
    finally:
        td.thresholds = (0.6, 0.7, 0.7)
    j1 = JaxMTCNN(variables=jax_load(str(tmp_path / "port.npz")), caps=(32, 16, 8),
                  thresholds=(0.0, 0.0, 0.0)).detect(img)
    j2 = JaxMTCNN(variables=jd.variables, caps=(32, 16, 8), thresholds=(0.0, 0.0, 0.0)).detect(img)
    for g, w in zip(j1, j2):
        np.testing.assert_array_equal(g, w)


def test_validate_rejects_wrong_shapes(pair):
    from fac_fake_torch.detect.mtcnn import validate_mtcnn_variables

    jd, _ = pair((32, 16, 8))
    v = _np_tree(jd.variables)
    assert validate_mtcnn_variables(v) is v
    bad = {**v, "pnet": {"params": {**v["pnet"]["params"],
                                    "conv1": {"kernel": np.zeros((3, 3, 3, 11), np.float32),
                                              "bias": np.zeros((11,), np.float32)}}}}
    with pytest.raises(ValueError, match="conv1"):
        validate_mtcnn_variables(bad)
    with pytest.raises(ValueError, match="missing"):
        validate_mtcnn_variables({k: x for k, x in v.items() if k != "onet"})


@pytest.mark.parametrize("form", ["per_net", "combined"])
def test_import_cli(tmp_path, form):
    """`python -m fac_fake_torch.cli.import_mtcnn` on facenet_pytorch's
    on-disk forms; the npz detects as a direct load of the state_dict and
    equals JAX's importer's output."""
    from fac_fake_tpu.cli.import_mtcnn import main as jax_main
    from fac_fake_torch.detect.mtcnn import MTCNN, load_mtcnn_npz

    torch.manual_seed(3)
    nets = {"pnet": _torch_pnet(), "rnet": _torch_rnet(), "onet": _torch_onet()}
    sd = {f"{n}.{k}": v for n, net in nets.items() for k, v in net.state_dict().items()}
    if form == "per_net":
        for n, net in nets.items():
            torch.save(net.state_dict(), str(tmp_path / f"{n}.pt"))
        args = [x for n in nets for x in (f"--{n}", str(tmp_path / f"{n}.pt"))]
    else:
        torch.save(sd, str(tmp_path / "mtcnn.pt"))
        args = ["--pt", str(tmp_path / "mtcnn.pt")]
    out = str(tmp_path / "cascade.npz")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-m", "fac_fake_torch.cli.import_mtcnn", out, *args],
                         cwd=root, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "wrote" in res.stdout
    img = np.random.default_rng(0).integers(0, 255, (96, 128, 3), dtype=np.uint8)
    th = (0.0, 0.0, 0.0)
    got = MTCNN(load_mtcnn_npz(out), thresholds=th, device="cpu").detect(img)
    want = MTCNN(sd, thresholds=th, device="cpu").detect(img)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    jax_main([str(tmp_path / "jax.npz"), *args])
    with np.load(out) as a, np.load(tmp_path / "jax.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])


def test_import_cli_refuses_missing_nets(tmp_path):
    from fac_fake_torch.cli.import_mtcnn import main

    with pytest.raises(SystemExit, match="missing"):
        main([str(tmp_path / "out.npz"), "--pnet", "only_one.pt"])


# --- the route through VideoScorer ----------------------------------------------------

class Reader:
    """In-memory reader: ``n`` seeded 100x140 frames a video."""

    def __init__(self, n=60):
        self.n = n

    def frame_count(self, path):
        return self.n

    def stream_frames_at_indices(self, path, idxs, chunk=16, stop=None):
        seed = sum(map(ord, path))
        for s in range(0, len(idxs), chunk):
            fr = [np.random.default_rng([seed, i]).integers(0, 256, (100, 140, 3), dtype=np.uint8)
                  for i in idxs[s:s + chunk]]
            yield np.stack(fr), list(idxs[s:s + chunk])


def _tiny_port_cvit():
    from fac_fake_torch.models.cvit import CViT
    spec = ()
    for _ in range(5):
        spec += (("conv", 8), ("bn", 8), ("relu",), ("pool",))
    return CViT(spec, dim=64, depth=1, heads=2, mlp_dim=64)


def test_gather_crops_with_mtcnn_equal_jax(pair, tmp_path):
    """JAX's scorer with its MTCNN, and the port's scorer over
    JAX's detections of the same frames: the same crops (cv2's INTER_AREA
    against the port's, at most 1 LSB). The port's own route from the same
    npz and thresholds: an MTCNN with those weights, whose detections crop
    as the route's rule says (≤ 5 a frame, ≤ 29 a video, int() corners, the
    top and left clipped at 0)."""
    from fac_fake_tpu.core.config import Config as JaxConfig
    from fac_fake_tpu.detect.mtcnn import MTCNN as JaxMTCNN
    from fac_fake_tpu.detect.mtcnn import save_mtcnn_npz
    from fac_fake_tpu.infer.predictor import VideoScorer as JaxScorer
    from fac_fake_torch.core.config import Config
    from fac_fake_torch.data.video import predict_indices
    from fac_fake_torch.detect.mtcnn import MTCNN
    from fac_fake_torch.infer.predictor import VideoScorer
    from fac_fake_torch.ops.resize import resize_area
    from helpers import tiny_cvit

    jd, td = pair((128, 64, 32))
    save_mtcnn_npz(jd.variables, str(tmp_path / "m.npz"))
    th = (0.0, 0.0, 0.0)
    jm = tiny_cvit()
    jcfg, tcfg = JaxConfig(), Config()
    for c in (jcfg, tcfg):
        c.infer.detector = "mtcnn"
        c.infer.mtcnn_weights = str(tmp_path / "m.npz")
        c.infer.mtcnn_thresholds = th
    js = JaxScorer(jm, jm.init(jax.random.key(0), jnp.zeros((1, 224, 224, 3))), jcfg,
                   detector=JaxMTCNN(jd.variables, thresholds=th), reader=Reader())
    a = js.gather_crops("vid_m.mp4")

    class JaxDetections:
        def detect(self, frame):
            return js.detector.detect(frame)

    ts = VideoScorer(_tiny_port_cvit(), tcfg, detector=JaxDetections(), reader=Reader(),
                     device="cpu")
    b = ts.gather_crops("vid_m.mp4")
    assert a.shape == b.shape and a.shape[0] == 29
    assert int(np.abs(a.astype(int) - b.astype(int)).max()) <= 1

    own = VideoScorer(_tiny_port_cvit(), tcfg, reader=Reader(), device="cpu")
    det = own.detector
    assert isinstance(det, MTCNN) and det.thresholds == th
    for k, v in td.state_dict().items():
        assert torch.equal(det.state_dict()[k], v)
    got = own.gather_crops("vid_m.mp4")
    want = []
    for frames, _ in Reader().stream_frames_at_indices("vid_m.mp4", predict_indices(60)):
        for fr in frames:
            boxes, _, _, valid = det.detect(fr)
            for x1, y1, x2, y2 in [tuple(int(c) for c in bx) for bx, v in zip(boxes, valid)
                                   if v][:5]:
                face = fr[max(y1, 0):y2, max(x1, 0):x2]
                if face.size and len(want) < 29:
                    want.append(resize_area(face, (224, 224)))
    assert len(want) > 0
    np.testing.assert_array_equal(got, np.stack(want))


def test_gather_crops_caps_with_a_stub_detector():
    """`tests/test_infer_pipeline.py`'s cap test on the port: one face a
    frame from a stub MTCNN, 29 crops, the stream stopped early."""
    from fac_fake_torch.core.config import Config
    from fac_fake_torch.infer.predictor import VideoScorer

    emitted = []

    class FakeReader:
        def frame_count(self, path):
            return 907                      # samples 90 indices

        def stream_frames_at_indices(self, path, idxs, chunk=16, stop=None):
            for lo in range(0, len(idxs), chunk):
                if stop is not None and stop():
                    return
                group = idxs[lo:lo + chunk]
                emitted.extend(group)
                yield np.zeros((len(group), 64, 64, 3), np.uint8), group

    class FakeDetector:
        def detect(self, frame):
            return ([(5.0, 5.0, 60.0, 60.0)], [0.9], None, [True])

    cfg = Config()
    cfg.infer.detector = "mtcnn"
    ts = VideoScorer(_tiny_port_cvit(), cfg, detector=FakeDetector(), reader=FakeReader(),
                     device="cpu")
    crops = ts.gather_crops("whatever.mp4")
    assert crops.shape == (29, 224, 224, 3)
    assert len(emitted) <= 64, len(emitted)


def test_face_recognition_detector_is_refused():
    from fac_fake_torch.core.config import Config
    from fac_fake_torch.infer.predictor import VideoScorer

    cfg = Config()
    cfg.infer.detector = "face_recognition"
    with pytest.raises(NotImplementedError, match="face_recognition"):
        VideoScorer(_tiny_port_cvit(), cfg, device="cpu")

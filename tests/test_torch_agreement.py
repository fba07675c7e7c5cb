"""The port's detector-agreement harness (`fac_fake_torch/detect/agreement.py`,
`cli/detector_agreement.py`) against the JAX package on the CPU: the pure
functions exactly on seeded boxes; the reports on stub detectors, stub
landmarks and stub scorers over a cv2-written video, giving the same dicts;
BlazeFace's adapter on the packaged weights within 1 px of JAX's; MTCNN's
adapter against JAX's cascade stages on seeded nets carried across; the
CLI's JSON equal to the JAX tool's and strict."""
import json
import os
import runpy
import sys

import numpy as np
import pytest
import torch

from tests.test_torch_mtcnn import DISCRETE, _jax_stages, _port_stages

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _boxes(rng, n):
    xy = rng.uniform(0, 80, (n, 2))
    wh = rng.uniform(-2, 40, (n, 2))               # a few inverted boxes
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def test_pure_functions_equal_jax():
    from fac_fake_tpu.detect import agreement as ja
    from fac_fake_torch.detect import agreement as ta
    rng = np.random.default_rng(0)
    frames = []
    for trial in range(40):
        a = _boxes(rng, int(rng.integers(0, 7)))
        b = np.concatenate([a[: int(rng.integers(0, len(a) + 1))] + rng.normal(0, 3, (1, 4)),
                            _boxes(rng, int(rng.integers(0, 4)))]).astype(np.float32)
        if trial % 5 == 0:
            b = np.concatenate([b, a[:1], a[:1]]).astype(np.float32)   # exact ties
        iou = ta.box_iou_matrix(a, b)
        want = ja.box_iou_matrix(a, b)
        assert iou.dtype == want.dtype and iou.shape == want.shape
        np.testing.assert_array_equal(iou, want)
        for thr in (0.0, 0.3, 0.5):
            assert ta.greedy_match(iou, thr) == ja.greedy_match(want, thr)
            fa = ta.frame_agreement(a, b, thr)
            assert fa == ja.frame_agreement(a, b, thr)
            frames.append(fa)
    for k in (0, 1, 7, len(frames)):
        assert ta.aggregate(frames[:k]) == ja.aggregate(frames[:k])


def _video(path, n=24, hw=(72, 120)):
    import cv2
    rng = np.random.default_rng(len(path))
    wr = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 10, hw[::-1])
    for i in range(n):
        wr.write(rng.integers(1, 255, (*hw, 3), dtype=np.uint8))
    wr.release()
    return path


@pytest.fixture(scope="module")
def videos(tmp_path_factory):
    d = tmp_path_factory.mktemp("agree")
    paths = [_video(str(d / f"v{i}.mp4"), n=24 + 5 * i) for i in range(2)]
    cut = str(d / "cut.mp4")
    with open(cut, "wb") as f:
        f.write(open(paths[0], "rb").read()[:2000])
    return paths + [cut, str(d / "missing.mp4")]


def _stub_a(frames):
    """Boxes from the frames' content: a deterministic function of pixels."""
    out = []
    for fr in frames:
        m = float(fr.mean())
        out.append(np.array([[m / 4, m / 5, m / 4 + 30, m / 5 + 24],
                             [5, 5, 25, 35]], np.float32)[: 1 + int(m) % 2])
    return out


def _stub_b(frames):
    out = []
    for k, fr in enumerate(frames):
        m = float(fr[::2].mean())
        out.append(np.array([[m / 4 + k % 3, m / 5, m / 4 + 28, m / 5 + 25]],
                            np.float32)[: int(k % 4 != 0)])
    return out


class _Scorer:
    def __init__(self, off):
        self.off = off

    def score_video(self, path):
        return (len(os.path.basename(path)) * 0.07 + self.off) % 1.0


def test_reports_on_stubs_equal_jax(videos):
    from fac_fake_tpu.detect import agreement as ja
    from fac_fake_torch.detect import agreement as ta
    frames = np.random.default_rng(1).integers(0, 255, (5, 40, 60, 3), dtype=np.uint8)
    assert ta.video_agreement(frames, _stub_a, _stub_b, 0.3) == \
        ja.video_agreement(frames, _stub_a, _stub_b, 0.3)
    for fpv, scorers, thr in ((8, None, 0.5), (3, (_Scorer(0.1), _Scorer(0.4)), 0.2)):
        got = ta.agreement_report(videos, _stub_a, _stub_b, fpv, scorers, thr)
        want = ja.agreement_report(videos, _stub_a, _stub_b, fpv, scorers, thr)
        assert got == want
        assert got["totals"]["videos"] == 2             # truncated and missing skipped
        json.loads(json.dumps(got, allow_nan=False))

    def landmarks():
        calls = []

        def lms(img):
            calls.append(img.shape)
            if len(calls) % 4 == 0:
                return None
            h, w = img.shape[:2]
            return np.array([[0.3 * w, 0.35 * h], [0.7 * w, 0.35 * h], [0.5 * w, 0.55 * h],
                             [0.37 * w, 0.75 * h], [0.63 * w, 0.75 * h]])
        return lms

    got = ta.mask_geometry_report(videos, 6, landmarks())
    assert got == ja.mask_geometry_report(videos, 6, landmarks())
    assert got["totals"]["frames"] == 12
    assert got["totals"]["landmark_hit_rate"] == pytest.approx(9 / 12)


def test_blazeface_boxes_within_one_pixel_of_jax():
    """Packaged weights on frames where the detector fires (the seeded blob
    tiles of `tests/test_torch_blazeface.py`, put side by side as 128 x 384
    landscape frames): the same faces, every box edge within 1 px."""
    from fac_fake_tpu.detect import agreement as ja
    from fac_fake_tpu.detect.blazeface import BlazeFace as JaxBlazeFace
    from fac_fake_tpu.detect.extractor import FaceExtractor as JaxExtractor
    from fac_fake_torch.detect import agreement as ta
    from test_torch_blazeface import _tiles

    frames = np.concatenate([np.concatenate([t[0::3], t[1::3], t[2::3]], axis=2)
                             for t in (_tiles(s, n=6) for s in (0, 1, 4, 5))])  # (8, 128, 384, 3)
    want = ja.blazeface_boxes_fn(JaxExtractor(None, JaxBlazeFace.from_packaged_assets()))(frames)
    got = ta.blazeface_boxes_fn(device="cpu")(frames)
    assert [len(g) for g in got] == [len(w) for w in want] and sum(len(w) for w in want) > 0
    for g, w in zip(got, want):
        assert g.dtype == np.float32 and np.abs(g - w).max(initial=0.0) <= 1.0


def _seeded_cascade(caps):
    """JAX's MTCNN and the port's on the same seeded nets: numpy-seeded
    variables in JAX's layout, carried across by `mtcnn_state_dict_from_flax`
    (a JAX init of the three nets costs some 13 s on a CPU)."""
    from fac_fake_tpu.detect.mtcnn import MTCNN as JaxMTCNN
    from fac_fake_torch.compat.weights import mtcnn_state_dict_from_flax
    from fac_fake_torch.detect.mtcnn import MTCNN, _flax_shapes

    rng = np.random.default_rng(11)
    tree = {}
    for key, shape in _flax_shapes().items():
        net, _, layer, leaf = key.split("/")
        if leaf == "kernel":
            v = rng.normal(0, 1 / np.sqrt(np.prod(shape[:-1])), shape)
        elif leaf == "alpha":
            v = np.full(shape, 0.25)
        else:
            v = rng.normal(0, 0.05, shape)
        tree.setdefault(net, {"params": {}})["params"].setdefault(layer, {})[leaf] = \
            v.astype(np.float32)
    return (JaxMTCNN(tree, caps=caps),
            MTCNN(mtcnn_state_dict_from_flax(tree), caps=caps, device="cpu"))


def test_mtcnn_boxes_equal_jax_stages():
    """`mtcnn_boxes_fn` is MTCNN's valid boxes: held to JAX's cascade cut into
    stages (`tests/test_torch_mtcnn.py`), or where the two chains part on a
    near-tie, to the port's own staged chain."""
    from fac_fake_torch.detect import agreement as ta
    from fac_fake_torch.detect.mtcnn import pyramid_scales

    caps, th, hw = (32, 16, 8), (0.0, 0.0, 0.0), (60, 80)
    jd, td = _seeded_cascade(caps)
    jd.thresholds = td.thresholds = th
    frames = np.random.default_rng(7).integers(0, 255, (2, *hw, 3), dtype=np.uint8)
    got = ta.mtcnn_boxes_fn(td)(frames)
    assert len(got) == 2
    st = {"img": frames[0].astype(np.float32), "scales": pyramid_scales(*hw)}
    js, ts = dict(st), dict(st)
    parted = False
    for jf, tf_ in zip(_jax_stages(jd, th, caps), _port_stages(td, th, caps)):
        js.update(jf(js))
        with torch.no_grad():
            ts.update(tf_(ts))
        name = jf.__name__
        parted = parted or (name in DISCRETE and any(
            not np.array_equal(a, b) for a, b in zip(DISCRETE[name](ts), DISCRETE[name](js))))
    g = got[0]
    np.testing.assert_array_equal(g, ts["out"][0][ts["out"][3]])   # the port's cascade
    assert len(g) > 0
    if parted:                          # a near-tie decided by the last bits
        print(f"\nthe chains part on a near-tie: {len(g)} boxes vs JAX's "
              f"{int(js['out'][3].sum())}")
    else:
        boxes, _, _, valid = js["out"]
        assert g.shape == boxes[valid].shape
        np.testing.assert_allclose(g, boxes[valid], rtol=0, atol=1e-3)
    b1 = td.detect(frames[1])
    np.testing.assert_array_equal(got[1], b1[0][b1[3]])


def _empty_boxes(frames):
    return [np.zeros((0, 4), np.float32) for _ in frames]


def test_cli_json_equals_the_jax_tool_and_is_strict(videos, monkeypatch, capsys):
    """Both CLIs with the same stub detectors: the same printed report; with
    detectors that find nothing, every undefined statistic is null."""
    from fac_fake_tpu.detect import agreement as ja
    from fac_fake_torch.cli import detector_agreement as tcli
    from fac_fake_torch.detect import agreement as ta

    def strict(text):
        return json.loads(text, parse_constant=lambda c: pytest.fail(f"non-strict JSON {c}"))

    for a, b in ((_stub_a, _stub_b), (_empty_boxes, _empty_boxes)):
        for mod in (ja, ta):
            monkeypatch.setattr(mod, "blazeface_boxes_fn", lambda *x, a=a, **k: a)
            monkeypatch.setattr(mod, "mtcnn_boxes_fn", lambda *x, b=b, **k: b)
        argv = [*videos, "--frames", "5", "--iou", "0.3"]
        monkeypatch.setattr(sys, "argv", ["detector_agreement.py", *argv])
        runpy.run_path(os.path.join(REPO, "tools", "detector_agreement.py"), run_name="__main__")
        want = capsys.readouterr().out
        rep = tcli.main([*argv, "--device", "cpu"])
        got = capsys.readouterr().out
        assert got == want and strict(got) == rep
    assert rep["totals"]["mean_iou"] is None and rep["totals"]["recall_a_by_b"] is None
    assert all(v["mean_iou"] is None for v in rep["videos"].values())

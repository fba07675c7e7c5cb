"""The port's S3D scoring path against the JAX package on the CPU:
`S3DEvaluator` (``predict_batch`` in fp32 and int8, ``predict_video`` with
the degradation, ``evaluate`` over a folder tree of crops written with cv2),
`ClipDataset.load_clip`, ``f1`` against scikit-learn, and
``python -m fac_fake_torch.cli.evaluate s3d --device cpu``."""
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

P133 = ("pool", (1, 3, 3), (1, 2, 2), (0, 1, 1))
P333 = ("pool", (3, 3, 3), (2, 2, 2), (1, 1, 1))
P222 = ("pool", (2, 2, 2), (2, 2, 2), (0, 0, 0))
SPEC = (("sep", 16, 7, 2, 3, "relu", True), P133, ("basic", 16, 1, 1, 0, "relu"),
        ("sep", 24, 3, 1, 1, "relu", True), ("mix", "3b", "relu", True), P333,
        ("mix", "3c", "relu", True), ("ctx", 1.0 / 16.0, "avg"), P222)


@pytest.fixture(scope="module")
def models():
    """A JAX S3DNet with its variables (fc bias set so that the scores
    straddle 0.5) and the port's copy through `export_s3d`."""
    from fac_fake_tpu.compat.torch_export import export_s3d
    from fac_fake_tpu.models.s3d.model import S3DNet as JaxS3D
    from fac_fake_torch.models.s3d.model import S3DNet

    jm = JaxS3D(spec=SPEC, num_class=1)
    v = jax.jit(jm.init)(jax.random.key(0), jnp.zeros((1, 20, 32, 32, 3)))
    rng = np.random.default_rng(5)
    stats = jax.tree.map(lambda a: jnp.asarray(rng.uniform(0.5, 1.5, a.shape), jnp.float32),
                         v["batch_stats"])
    v = {"params": v["params"], "batch_stats": stats}
    clips = np.random.default_rng(6).integers(0, 256, (8, 20, 32, 32, 3), dtype=np.uint8)
    logits = np.asarray(jax.jit(jm.apply)(v, jnp.asarray(clips, jnp.float32)))
    fc = dict(v["params"]["fc"])
    fc["bias"] = fc["bias"] - float(np.median(logits))
    v = {"params": {**v["params"], "fc": fc}, "batch_stats": stats}
    tm = S3DNet(SPEC, 1)
    tm.load_state_dict({k: torch.from_numpy(np.array(a))
                        for k, a in export_s3d(v, SPEC).items()}, strict=True)
    return jm, v, tm.to(memory_format=torch.channels_last_3d), clips


def _evaluators(models, **kw):
    from fac_fake_tpu.evaluate.s3d_eval import S3DEvaluator as JaxEvaluator
    from fac_fake_torch.evaluate.s3d_eval import S3DEvaluator

    jm, v, tm, _ = models
    return JaxEvaluator(jm, v, **kw), S3DEvaluator(tm, device="cpu", **kw)


def test_predict_batch_matches_jax(models):
    """fp32: scores within 1e-5. int8: with the JAX engine's qparams carried
    over, within 1e-3. Each side calibrating on its own (on the first two
    clips), the scales differ in the last bits (see
    `tests/test_torch_quantize_s3d.py`) and move a few values across a
    quantization step; on this small network int8 moves the scores by up to
    0.17 from fp32, and the two calibrations stay within 0.05 of each other."""
    from test_torch_quantize_s3d import _carry_qparams

    clips = models[3]
    je, te = _evaluators(models, degrade=False)
    ref = je.predict_batch(clips)
    assert 0.0 < ref.min() < 0.5 < ref.max() < 1.0
    np.testing.assert_allclose(te.predict_batch(clips), ref, rtol=0, atol=1e-5)
    jq, tq = _evaluators(models, degrade=False, quantize="int8")
    ref8 = jq.predict_batch(clips)
    own = tq.predict_batch(clips)
    assert tq.engine is not None and len(tq.engine.qparams) == 21
    np.testing.assert_allclose(own, ref8, rtol=0, atol=0.05)
    _carry_qparams(tq.engine, jq._engine.qparams)
    np.testing.assert_allclose(tq.predict_batch(clips), ref8, rtol=0, atol=1e-3)


def test_predict_video_with_degradation_matches_jax(models):
    clip = models[3][2]
    je, te = _evaluators(models, degrade=True, seed=3)
    ref = je.predict_video(clip, np.random.default_rng(9))
    assert abs(te.predict_video(clip, np.random.default_rng(9)) - ref) <= 1e-5
    assert abs(te.predict_video(clip) - je.predict_video(clip)) <= 1e-5   # seed's generator


def test_degrade_frame_equals_jax():
    from fac_fake_tpu.evaluate.s3d_eval import degrade_frame as jax_degrade
    from fac_fake_torch.evaluate.s3d_eval import degrade_frame

    img = np.random.default_rng(1).integers(0, 256, (32, 32, 3), dtype=np.uint8)
    np.testing.assert_array_equal(degrade_frame(img, np.random.default_rng(2)),
                                  jax_degrade(img, np.random.default_rng(2)))


@pytest.fixture(scope="module")
def crop_tree(tmp_path_factory):
    """Per-video folders of 32×32 png crops: three with 191 crops (enough
    for the strided snippet), one with 30 (skipped by it); labels from the
    path."""
    root = tmp_path_factory.mktemp("clips")
    rng = np.random.default_rng(11)
    for label, vid, n in (("fake", "vid_a", 191), ("real", "vid_b", 191),
                          ("fake", "vid_c", 191), ("real", "vid_d", 30)):
        d = root / label / vid
        d.mkdir(parents=True)
        base = rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)
        for i in range(n):
            img = np.clip(base.astype(int) + rng.integers(-20, 21, base.shape), 0, 255)
            cv2.imwrite(str(d / f"{i:04d}.png"), img.astype(np.uint8))
    return str(root)


@pytest.mark.parametrize("snippet,gray", [("strided", False), ("first_n", True)])
def test_clip_dataset_load_clip_equals_jax(crop_tree, snippet, gray):
    from fac_fake_tpu.data.clips import ClipDataset as JaxClips
    from fac_fake_tpu.data.clips import discover_video_folders as jax_discover
    from fac_fake_torch.data.clips import ClipDataset, discover_video_folders

    samples = discover_video_folders(crop_tree)
    assert samples == jax_discover(crop_tree) and len(samples) == 4
    assert [s[1] for s in samples] == [1, 1, 0, 0]
    ours = ClipDataset(samples, image_size=32, snippet=snippet, gray=gray)
    ref = JaxClips(samples, image_size=32, snippet=snippet, gray=gray)
    assert ours.samples == ref.samples
    r1, r2 = np.random.default_rng(0), np.random.default_rng(0)
    for i in range(len(ours)):
        a, b = ours.load_clip(i, r1), ref.load_clip(i, r2)
        assert (a is None) == (b is None)
        if a is not None:
            assert a.shape == (20, 32, 32, 3)
            np.testing.assert_array_equal(a, b)
    assert r1.random() == r2.random()   # the generators were drawn alike
    got = list(ours.batches(2, num_workers=2))
    want = list(ref.batches(2, num_workers=2))
    assert len(got) == len(want) == (1 if snippet == "strided" else 2)
    for g, w in zip(got, want):
        for k in ("image", "label", "mask"):
            np.testing.assert_array_equal(g[k], w[k])
    with pytest.raises(ValueError, match="mask_method"):
        ClipDataset(samples, mask_method="blur")


def test_evaluate_matches_jax(models, crop_tree):
    from fac_fake_tpu.data.clips import ClipDataset as JaxClips
    from fac_fake_torch.data.clips import ClipDataset, discover_video_folders

    samples = discover_video_folders(crop_tree)
    je, te = _evaluators(models, degrade=True, seed=0)
    ref = je.evaluate(JaxClips(samples, image_size=32, snippet="strided"))
    got = te.evaluate(ClipDataset(samples, image_size=32, snippet="strided"))
    assert got["count"] == ref["count"] == 3
    assert got["accuracy"] == ref["accuracy"] and got["f1"] == ref["f1"]
    assert abs(got["bce"] - ref["bce"]) <= 1e-5


@pytest.mark.parametrize("labels,preds", [
    ([0, 1, 1, 0, 1], [0, 1, 0, 1, 1]),
    ([1, 1, 1], [1, 1, 1]),
    ([0, 0, 1], [0, 0, 0]),
    ([0, 0, 0], [0, 0, 0]),
    ([0, 0, 0], [1, 0, 1]),
])
def test_f1_equals_sklearn(labels, preds):
    import warnings

    from sklearn.metrics import f1_score

    from fac_fake_torch.evaluate.metrics import accuracy, f1
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")        # sklearn warns on 0/0 and returns 0.0
        ref = float(f1_score(labels, preds))
    assert f1(labels, preds) == ref
    assert accuracy(labels, preds) == float(np.mean(np.equal(labels, preds)))


@pytest.mark.parametrize("name,body", [
    ("caplan1.yaml", "training:\n  frames-per-video: 16\nmodel:\n  image-size: 32\n"),
    ("plan3.yaml", "training:\n  lr: 0.01\nmodel:\n  SRM-net: 'yes'\n"),
    ("mplan2.yaml", "model:\n  image-size: 64\n  SRM-net: no\n"),
])
def test_load_plan_matches_jax(tmp_path, name, body):
    """Every field JAX's `load_plan` sets (the model family, input size, SRM
    input and frames that scoring reads, and the training, masking and
    augmentation fields), on plans that leave fields to their defaults."""
    import dataclasses
    from fac_fake_tpu.core.plans import load_plan as jax_load_plan
    from fac_fake_torch.core.plans import load_plan

    plan = tmp_path / name
    plan.write_text(body)
    got, want = load_plan(str(plan)), jax_load_plan(str(plan))
    for sect, field in (("model", "name"), ("model", "num_class"), ("model", "image_size"),
                        ("model", "srm_net"), ("data", "frames_per_video")):
        assert getattr(getattr(got, sect), field) == getattr(getattr(want, sect), field)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_cli_evaluate_s3d_on_cpu(crop_tree, tmp_path, capsys):
    from fac_fake_torch.cli.evaluate import main

    plan = tmp_path / "caplan1.yaml"
    plan.write_text("training:\n  frames-per-video: 20\nmodel:\n  image-size: 32\n")
    out = main(["s3d", "--clips-root", crop_tree, "--plan", str(plan), "--device", "cpu",
                "--out-prefix", str(tmp_path / "ev")])
    assert out["count"] == 3 and set(out) == {"accuracy", "f1", "bce", "count", "auc"}
    assert 0.0 <= out["accuracy"] <= 1.0 and np.isfinite(out["bce"])
    assert os.path.isfile(tmp_path / "ev_fpr.txt")
    assert "'count': 3" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="orbax"):
        main(["s3d", "--clips-root", crop_tree, "--device", "cpu",
              "--checkpoint", str(tmp_path)])

"""The port's CSV evaluation, history plots and their CLIs
(`fac_fake_torch/evaluate/metrics.py`, `evaluate/plots.py`,
`cli/evaluate.py csv|plots`, `cli/predict.py --metadata`) against the JAX
package on the CPU. The CSVs and metadata are made with numpy from a seed
and cover tied scores, exact-0.5 no-face rows, names with and without
``.mp4``, unjoined names, one class only and no joined row. Counts and
accuracies equal JAX's; AUCs within 1e-12 (the port's Mann-Whitney U
against scikit-learn's trapezoid)."""
import json
import os
import pickle

import numpy as np
import pytest
from sklearn import metrics as skm

AUC_TOL = 1e-12


def _write(tmp_path, tag, names, probs, meta):
    from fac_fake_torch.infer.predictor import write_predictions_csv
    csv_path, meta_path = str(tmp_path / f"{tag}.csv"), str(tmp_path / f"{tag}.json")
    write_predictions_csv(csv_path, list(zip(names, probs)))
    with open(meta_path, "w") as fh:
        json.dump(meta, fh)
    return csv_path, meta_path


def _cases(seed=0):
    """{tag: (names, probs, metadata)}: every case JAX's join and drop take."""
    rng = np.random.default_rng(seed)
    n = 40
    names = [f"v{i:03d}" + (".mp4" if i % 3 else "") for i in range(n)]
    probs = rng.integers(0, 9, n) / 8.0           # ties, and exact 0.5 rows
    labels = rng.integers(0, 2, n)
    meta = {}
    for i, nm in enumerate(names):
        if i % 7 == 6:
            continue                              # unjoined: not in the metadata
        key = nm if i % 2 else (nm if nm.endswith(".mp4") else nm + ".mp4")
        meta[key] = {"label": "FAKE" if labels[i] else ("REAL" if i % 4 else "real")}
    meta["not_in_csv.mp4"] = {"label": "FAKE"}
    one = {k: {"label": "REAL"} for k in meta}
    return {"mixed": (names, probs, meta),
            "one_class": (names, probs, one),
            "none_joined": (names, probs, {"other.mp4": {"label": "FAKE"}}),
            "all_no_face": (names, np.full(n, 0.5), meta)}


def _same(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        if isinstance(w, float) and np.isnan(w):
            assert np.isnan(got[k]), k
        elif k == "auc":
            assert abs(got[k] - w) <= AUC_TOL, (got[k], w)
        else:
            assert got[k] == w, (k, got[k], w)


@pytest.mark.parametrize("tag", ["mixed", "one_class", "none_joined", "all_no_face"])
def test_evaluate_prediction_csv_equals_jax(tmp_path, tag):
    from fac_fake_tpu.evaluate.metrics import evaluate_prediction_csv as jax_eval
    from fac_fake_torch.evaluate.metrics import evaluate_prediction_csv
    csv_path, meta_path = _write(tmp_path, tag, *_cases()[tag])
    want = jax_eval(csv_path, meta_path)
    _same(evaluate_prediction_csv(csv_path, meta_path), want)
    _same(evaluate_prediction_csv(csv_path, meta_path, drop_no_face=False),
          jax_eval(csv_path, meta_path, drop_no_face=False))
    if tag == "mixed":
        assert 0 < want["count"] < 40 and np.isfinite(want["auc"])


def test_legacy_int_accuracy_equals_jax(tmp_path):
    """Integer labels (the inverted block: prob < 0.5 is 1), over every
    row of the CSV, joined or not."""
    from fac_fake_tpu.evaluate.metrics import legacy_int_accuracy as jax_legacy
    from fac_fake_torch.evaluate.metrics import legacy_int_accuracy
    rng = np.random.default_rng(1)
    names = [f"clip_{i}.mp4" for i in range(30)]
    meta = {nm: int(rng.integers(0, 2)) for nm in names[:25]}
    csv_path, meta_path = _write(tmp_path, "legacy", names, rng.random(30), meta)
    assert legacy_int_accuracy(csv_path, meta_path) == jax_legacy(csv_path, meta_path)
    empty, meta_path = _write(tmp_path, "empty", [], [], meta)
    assert legacy_int_accuracy(empty, meta_path) == jax_legacy(empty, meta_path) == 0.0


def test_auc_score_equals_sklearn_on_ties():
    from fac_fake_torch.evaluate.metrics import auc_score
    rng = np.random.default_rng(2)
    for _ in range(300):
        n = int(rng.integers(2, 80))
        y = rng.integers(0, 2, n)
        if y.min() == y.max():
            continue
        s = rng.integers(0, int(rng.integers(1, 6)), n) / 4.0
        fpr, tpr, _ = skm.roc_curve(y, s)
        assert abs(auc_score(y, s) - skm.auc(fpr, tpr)) <= AUC_TOL
    with pytest.raises(ValueError, match="both classes"):
        auc_score([1, 1], [0.2, 0.3])


def test_cli_csv_prints_jax_lines(tmp_path, capsys):
    from fac_fake_tpu.cli import evaluate as jax_cli
    from fac_fake_torch.cli import evaluate as port_cli
    csv_path, meta_path = _write(tmp_path, "cli", *_cases()["mixed"])
    _, legacy_meta = _write(tmp_path, "cli_int", [], [], {
        nm: i % 2 for i, nm in enumerate(_cases()["mixed"][0])})
    for args in (["csv", "--csv", csv_path, "--metadata", meta_path],
                 ["csv", "--csv", csv_path, "--metadata", legacy_meta, "--legacy-int-labels"]):
        jax_cli.main(args)
        want = capsys.readouterr().out
        port_cli.main(args)
        assert capsys.readouterr().out == want and want.strip()


def test_cli_predict_metadata_prints_jax_line(tmp_path, capsys, monkeypatch):
    """`cli/predict.py --metadata` evaluates the CSV it wrote (the scores
    stubbed: the join and the line are what is tested) and prints JAX's
    line for that CSV."""
    from fac_fake_tpu.evaluate.metrics import evaluate_prediction_csv as jax_eval
    from fac_fake_torch.cli import predict
    from fac_fake_torch.infer.predictor import VideoScorer
    names, probs, meta = _cases()["mixed"]
    vids = tmp_path / "videos"
    vids.mkdir()
    files = sorted(n if n.endswith(".mp4") else n + ".mp4" for n in names)
    for f in files:
        (vids / f).touch()
    stub = dict(zip(files, probs))
    monkeypatch.setattr(VideoScorer, "score_videos",
                        lambda self, paths, workers=None: [stub[os.path.basename(p)]
                                                           for p in paths])
    meta_path = str(tmp_path / "meta.json")
    with open(meta_path, "w") as fh:
        json.dump(meta, fh)
    out_csv = str(tmp_path / "pred.csv")
    predict.main(["--videos", str(vids), "--save-csv", out_csv, "--metadata", meta_path,
                  "--device", "cpu", "--set", "model.image_size=32", "model.patch_size=1",
                  "model.dim=32", "model.depth=1", "model.heads=2", "model.mlp_dim=32"])
    want = jax_eval(out_csv, meta_path)
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert last == (f"accuracy: {want['accuracy'] * 100:.2f}%  AUC: {want['auc']:.4f} "
                    f"({want['count']} scored)")


def test_history_and_plots(tmp_path, capsys):
    """`load_history` equals JAX's on a history the port's
    `Trainer.save_history` wrote; `cli/evaluate.py plots` writes its PNG."""
    from fac_fake_tpu.evaluate.plots import load_history as jax_load
    from fac_fake_torch.cli import evaluate as port_cli
    from fac_fake_torch.evaluate.plots import load_history
    from fac_fake_torch.train.trainer import Trainer
    rng = np.random.default_rng(3)
    paths = []
    for i in range(2):
        h = {k: rng.random(4).tolist() for k in ("train_loss", "train_acc", "val_loss",
                                                 "val_acc", "lr")}
        h["wall_seconds"] = 1.0
        paths.append(str(tmp_path / f"h{i}.pkl"))
        Trainer.save_history(h, paths[-1])
        assert load_history(paths[-1]) == jax_load(paths[-1])
        with open(paths[-1], "rb") as f:
            assert pickle.load(f)[0] == h["train_loss"]
    out = str(tmp_path / "curves.png")
    assert port_cli.main(["plots", "--history", *paths, "--labels", "a", "b",
                          "--out", out]) == out
    assert capsys.readouterr().out.strip() == out
    with open(out, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
